"""PyTorch port, FSDP (a config's parameters, gradients and AdamW moments
cut over `data` as well as `model`, each superblock's weights gathered
over `data` in the forward and their gradients reduce-scattered back)
against the JAX package, the port's one process and the port's
data-parallel step, on the CPU at reduced size: llama4 (8 experts, top 1,
a shared expert, MoE every second layer) with `fsdp=True` put back (the
reduced configs drop it), and qwen, mamba2 and whisper with `fsdp=True`
(the dense rule; the SSM's in_proj and out_proj; the encoder's stack on
stub frames).

The ranks are spawned gloo worlds (tests/_torch_fsdp_ranks.py on the
shared harness, a `FileStore` under the test's temporary directory): a
world of 4 runs llama4 at (2, 1) on ranks 0-1 beside qwen, mamba2 and
whisper at (2, 1) on ranks 2-3, then llama4 at (2, 2), saves llama4's
(2, 2) state and restores it at (1, 2); a second world of 4 runs the
training driver at (2, 2) with `--fsdp --grads-out`. The test process
runs the JAX unsharded step op by op beside them.

Tolerances:

* against the JAX unsharded step op by op (`jax.disable_jit()`, ROADMAP
  R8): tests/test_torch_train.py's bounds (loss 2⁻¹⁰ relative, each
  gradient leaf within 2⁻⁵ of its norm, the parameters after AdamW within
  2·lr);
* against the port's one-process fp32 step: tests/test_torch_parallel.py's
  (loss 1e-5 relative, each gradient leaf within 2⁻⁶ of its norm), the
  driver's `--grads-out` leaves too;
* against the port's data-parallel step of the same config with `fsdp`
  off at the same mesh: the gradient pieces bit for bit (the same forward
  on the same gathered bits, and each element the sum of the same two
  addends over the data axis);
* the clip norm: the same bits on every rank; shapes: `param_specs`'s;
  a restored checkpoint: the same bits.
"""
import dataclasses
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import reduced_config as j_reduced  # noqa: E402
from repro.data.pipeline import SyntheticLM as JSynthetic  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro_torch.configs import get_config, reduced_config  # noqa: E402
from repro_torch.core import precision as TP  # noqa: E402
from repro_torch.launch import train as trn  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.parallel import sharding as S  # noqa: E402
from repro_torch.parallel.mesh import MeshSpec  # noqa: E402
from repro_torch.train.train_state import param_specs  # noqa: E402

import _torch_fsdp_ranks as R  # noqa: E402
from test_torch_moe_parallel import _jax_step, _join, _spawn  # noqa: E402
from test_torch_parallel import _one_process, _order, _rel  # noqa: E402

torch.set_num_threads(2)
LLAMA4 = "llama4-maverick-400b-a17b"
ARCHS = {"llama4": LLAMA4, "qwen": "qwen2.5-14b", "mamba2": "mamba2-2.7b",
         "whisper": "whisper-tiny", "gemma2": "gemma2-9b"}
REL_GRAD, REL_LOSS = 2.0 ** -5, 2.0 ** -10
REL_FP32_LOSS, REL_FP32_GRAD = 1e-5, 2.0 ** -6
SCHED = dict(peak_lr=1e-3, warmup_steps=2, total_steps=10)
MESHES = ((2, 1), (2, 2))
# (name, mesh) of every FSDP step held to its data-parallel twin
BIT_CASES = [("llama4", (2, 1)), ("llama4", (2, 2)), ("qwen", (2, 1)),
             ("mamba2", (2, 1)), ("whisper", (2, 1)), ("gemma2", (2, 1))]
RANKS = {("llama4", (2, 1)): (0, 1), ("qwen", (2, 1)): (2, 3),
         ("mamba2", (2, 1)): (2, 3), ("whisper", (2, 1)): (2, 3),
         ("gemma2", (2, 1)): (2, 3)}
DRIVER = ["--arch", LLAMA4, "--reduced", "--device", "cpu", "--steps", "2",
          "--batch", "4", "--seq", "16", "--seed", "0"]


def _cfg(name, fsdp=True):
    cfg = reduced_config(ARCHS[name], layers_per_period=2)
    return dataclasses.replace(cfg, fsdp=fsdp)


def _job():
    job = {"cfgs": {}, "arch": {}, "params": {}, "batch": {},
           "sched": SCHED}
    for name, arch in ARCHS.items():
        jcfg = j_reduced(arch, layers_per_period=2)
        job["cfgs"][name], job["cfgs"][name + "_dp"] = (
            _cfg(name), _cfg(name, fsdp=False))
        job["arch"][name] = job["arch"][name + "_dp"] = name
        job["params"][name] = jax.tree.map(
            np.asarray, JM.init_params(jax.random.key(3), jcfg))
        batch = JSynthetic(jcfg.vocab_size, 16, 4, seed=1).batch_at(0)
        if jcfg.frontend_tokens:     # the encoder's stack on stub frames
            batch["frontend"] = np.random.default_rng(6).standard_normal(
                (4, jcfg.frontend_tokens, jcfg.d_model)).astype(np.float32)
        job["batch"][name] = batch
    return job


def _jax_ref(job):
    """llama4's JAX unsharded step op by op (accum 1), in the port's leaf
    order."""
    cfg = j_reduced(LLAMA4, layers_per_period=2)
    jp = jax.tree.map(jnp.asarray, job["params"]["llama4"])
    order = _order(job["cfgs"]["llama4"], job["params"]["llama4"])
    loss, g, after, lr = _jax_step(cfg, jp, job["batch"]["llama4"], 1)
    return {"loss": loss, "grads": order(jax.tree.map(np.asarray, g)),
            "after": order(jax.tree.map(np.asarray, after)), "lr": lr}


def _driver_one_process(out_dir):
    """The training driver in this process under the fp32 policy, its
    first step's gradients to `out_dir`: what it printed."""
    import contextlib
    import io
    buf = io.StringIO()
    with TP.use_policy(TP.PrecisionPolicy(input_format="fp32")), \
            contextlib.redirect_stdout(buf):
        trn.main(DRIVER + ["--grads-out", out_dir])
    return buf.getvalue()


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    base = str(tmp_path_factory.mktemp("fsdp"))
    job = _job()
    grads_dir = os.path.join(base, "driver_grads")
    ctx = [_spawn(R.train_world, os.path.join(base, "train"), 4, job),
           _spawn(R.launcher_world, os.path.join(base, "driver"), 4,
                  {"argv": DRIVER + ["--fsdp", "--model-parallel", "2",
                                     "--grads-out", grads_dir]})]
    # the JAX step op by op in this process, beside the worlds (its
    # primitives were compiled here by `_job`'s draws)
    jax_ref = _jax_ref(job)
    refs = {accum: _one_process(job["cfgs"]["llama4"],
                                job["params"]["llama4"],
                                job["batch"]["llama4"], accum)
            for accum in (1, 2)}
    one_dir = os.path.join(base, "one_grads")
    one_out = _driver_one_process(one_dir)
    for c in ctx:
        _join(c)
    tdir = os.path.join(base, "train")
    ranks = [torch.load(os.path.join(tdir, f"rank{r}.pt"))
             for r in range(4)]
    driver = [torch.load(os.path.join(base, "driver", f"rank{r}.pt"))
              for r in range(4)]
    return {"job": job, "jax": jax_ref, "fp32": refs, "ranks": ranks,
            "root": tdir, "driver": driver, "grads_dir": grads_dir,
            "one_out": one_out, "one_dir": one_dir}


def _ranks_of(name, mesh):
    return RANKS.get((name, mesh), range(4))


def _got(worlds, name, mesh, fmt="bf16", accum=1, rank=None):
    r = _ranks_of(name, mesh)[0] if rank is None else rank
    return worlds["ranks"][r][mesh][(name, fmt, accum)]


# ---------------------------------------------------------------------------
# the rules: which dim the data axes cut, and who counts a piece once
# ---------------------------------------------------------------------------

def test_data_dim_reads_the_rules():
    """`sharding.data_dim` on llama4's specs at (2, 2): the embedding's
    d_model columns, the head's rows, a superblock slice's K of wq and N
    of wo, an expert stack's D, the router's rows; nothing for the norms;
    nothing anywhere at data 1; a dim cut by data together with another
    axis raises."""
    cfg = get_config(LLAMA4)
    meta = TM.init_params(dataclasses.replace(cfg, num_layers=2),
                          device="meta", dtype=torch.float32)
    mesh = MeshSpec(("data", "model"), (2, 2))
    sp = S.param_specs(cfg, meta, mesh)
    assert S.data_dim(sp["embed"], mesh) == 1
    assert S.data_dim(sp["lm_head"], mesh) == 0
    attn, moe = sp["layers"][0]["attn"], sp["layers"][1]["moe"]
    assert S.data_dim(attn["wq"], mesh) == 1
    assert S.data_dim(attn["wq"], mesh, sliced=True) == 0
    assert S.data_dim(attn["wo"], mesh, sliced=True) == 1
    assert S.data_dim(moe["wg"], mesh, sliced=True) == 1      # (E, D, F)
    assert S.data_dim(moe["wd"], mesh, sliced=True) == 2      # (E, F, D)
    assert S.data_dim(moe["router"], mesh, sliced=True) == 0
    assert S.data_dim(sp["layers"][0]["norm1"]["w"], mesh) is None
    one = MeshSpec(("data", "model"), (1, 2))
    assert S.data_dim(S.param_specs(cfg, meta, one)["embed"], one) is None
    with pytest.raises(ValueError, match="more than one dim"):
        S.data_dim(S.P(("data", "model"), None), mesh)


@pytest.mark.parametrize("mesh", [(2, 1), (2, 2), (1, 2), (4, 2)])
@pytest.mark.parametrize("name", sorted(ARCHS))
def test_clip_counts_every_element_once(name, mesh):
    """`sharding.counts_once`: over the ranks of the mesh, the pieces
    that enter the clip's sum cover each leaf exactly once, whether the
    leaf is cut on `model`, on `data`, on both or on neither."""
    cfg = _cfg(name)
    meta = TM.init_params(cfg, device="meta", dtype=torch.float32)
    spec = MeshSpec(("data", "model"), mesh)
    specs = S.spec_leaves(S.param_specs(cfg, meta, spec), meta)
    for x, sp in zip(TM.tree_leaves(meta), specs):
        covered = 0
        for d in range(mesh[0]):
            for m in range(mesh[1]):
                coords = {"data": d, "model": m}
                if S.counts_once(sp, spec, coords):
                    covered += S.shard_leaf(x, sp, spec, coords).numel()
        assert covered == x.numel(), (sp, tuple(x.shape))


@pytest.mark.parametrize("coords", [(0, 0), (0, 1), (1, 0), (1, 1)])
def test_init_params_on_a_data_mesh_are_the_one_process_shards(
        monkeypatch, coords):
    """`init_params(mesh=)` (the training driver's draw) at (2, 2) under
    FSDP gives each rank `shard_tree` of the one-process tree bit for
    bit: every matrix cut over `data` and `model`, drawn a slice at a
    time."""
    cfg = _cfg("llama4")
    whole = TM.init_params(cfg, seed=3, device="cpu", dtype=torch.float32)
    mesh = MeshSpec(("data", "model"), (2, 2))
    c = dict(zip(("data", "model"), coords))
    monkeypatch.setattr(S, "mesh_coords", lambda _: c)
    got = TM.init_params(cfg, seed=3, device="cpu", dtype=torch.float32,
                         mesh=mesh)
    want = S.shard_tree(whole, S.param_specs(cfg, whole, mesh), mesh, c)
    for a, b in zip(TM.tree_leaves(got), TM.tree_leaves(want)):
        assert a.shape == b.shape and torch.equal(a, b)


def test_check_parallel_admits_fsdp_for_training_only():
    """FSDP trains at any mesh, and since serving took the data axis
    (ROADMAP 7b) it serves there too, its leaves gathered a layer at a
    time (tests/test_torch_serve_data.py); only a paged pool where the
    data axis does not divide the batch stays refused by name."""
    TM.check_parallel(get_config(LLAMA4), 2, 2)
    TM.check_parallel(get_config(LLAMA4), 1, 4)
    TM.check_parallel(get_config(LLAMA4), 2, 2, serving=True, batch=2,
                      kv_layout="paged")
    with pytest.raises(ValueError, match="data axis"):
        TM.check_parallel(get_config(LLAMA4), 2, 2, serving=True, batch=3,
                          kv_layout="paged")


# ---------------------------------------------------------------------------
# the FSDP steps
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mesh", MESHES)
def test_fsdp_step_matches_jax(worlds, mesh):
    """llama4's FSDP step (bf16 policy, the `cuda` backend's SA GEMM
    Function) against the JAX unsharded step op by op on the same weights
    and global batch: loss, every gathered gradient leaf, the parameters
    after AdamW. (Accumulation is held to one process below, and to the
    JAX package without FSDP in tests/test_torch_moe_parallel.py.)"""
    got, want = _got(worlds, "llama4", mesh), worlds["jax"]
    assert abs(got["loss"] - want["loss"]) <= REL_LOSS * abs(want["loss"])
    rel = _rel(got["grads"], want["grads"])
    assert len(rel) == len(want["grads"]) and max(rel) <= REL_GRAD, rel
    for a, b in zip(got["after"], want["after"]):
        np.testing.assert_allclose(a.numpy(), b, rtol=0,
                                   atol=2 * want["lr"])


@pytest.mark.parametrize("accum", [1, 2])
@pytest.mark.parametrize("mesh", MESHES)
def test_fsdp_step_matches_one_process_fp32(worlds, mesh, accum):
    """Under the fp32 policy llama4's FSDP step's loss is the port's
    one-process step's within 1e-5 relative and its gathered gradients
    within 2⁻⁶ of each leaf's norm."""
    got, want = _got(worlds, "llama4", mesh, "fp32", accum), \
        worlds["fp32"][accum]
    assert abs(got["loss"] - want["loss"]) <= REL_FP32_LOSS * abs(
        want["loss"])
    rel = _rel(got["grads"], want["grads"])
    assert len(rel) == len(want["grads"]) and max(rel) <= REL_FP32_GRAD, rel


@pytest.mark.parametrize("name,mesh", BIT_CASES)
def test_fsdp_gradients_are_the_data_parallel_shards(worlds, name, mesh):
    """On every rank the gradient pieces `on_grads` sees under FSDP have
    the bits of the data-parallel step's gradients (the same config with
    `fsdp` off, at the same mesh) cut to the rank's piece, and the loss
    the same bits."""
    for r in _ranks_of(name, mesh):
        got = _got(worlds, name, mesh, rank=r)
        assert all(got["same_as_dp"]) and len(got["same_as_dp"]) == len(
            got["grads"])
        assert got["loss"] == got["dp_loss"]


@pytest.mark.parametrize("name,mesh", BIT_CASES)
def test_every_rank_gets_the_same_clip_norm(worlds, name, mesh):
    """The clip's global norm: one value, bit for bit, on every rank of
    the mesh (so every rank scales its pieces alike), and the norm of the
    whole gradient tree (each element counted once) within 1e-6."""
    norms = {_got(worlds, name, mesh, rank=r)["grad_norm"]
             for r in _ranks_of(name, mesh)}
    assert len(norms) == 1
    whole = np.sqrt(sum(float((g.double() ** 2).sum())
                        for g in _got(worlds, name, mesh)["grads"]))
    assert abs(norms.pop() - whole) <= 1e-6 * whole


@pytest.mark.parametrize("name,mesh", BIT_CASES)
def test_each_rank_keeps_its_piece_only(worlds, name, mesh):
    """Each rank's parameter, gradient, μ and ν pieces have the shapes
    `param_specs` gives at the mesh: every leaf the data axis cuts holds
    1/data of its model piece on the rank, and none is replicated over
    `data` that the rules cut."""
    from repro_torch.models.convert import params_from_numpy
    job = worlds["job"]
    cfg = job["cfgs"][name]
    spec = MeshSpec(("data", "model"), mesh)
    tree = params_from_numpy(job["params"][name], "cpu", dtype=torch.float32)
    meta = TM.init_params(cfg, device="meta", dtype=torch.float32)

    def pieces(m):
        sp = S.spec_leaves(S.param_specs(cfg, meta, m), tree)
        return sp, [tuple(S.shard_leaf(x, s, m, {"data": 0, "model": 0}
                                       ).shape)
                    for x, s in zip(TM.tree_leaves(tree), sp)]
    specs, want = pieces(spec)
    _, model_piece = pieces(MeshSpec(("data", "model"), (1, mesh[1])))
    cut = [S.data_dim(sp, spec) is not None for sp in specs]
    assert any(cut)
    for w, mp, c in zip(want, model_piece, cut):
        assert np.prod(w) * (mesh[0] if c else 1) == np.prod(mp)
    for r in _ranks_of(name, mesh):
        for kind, got in _got(worlds, name, mesh, rank=r)["shapes"].items():
            assert got == want, kind


@pytest.mark.parametrize("target", ["1x1", "1x2"])
def test_fsdp_checkpoint_restores_at_another_mesh(worlds, target):
    """llama4's state saved at (2, 2) under FSDP (each leaf gathered whole
    over both axes) restores bit for bit in one process and at (1, 2), and
    holds the (2, 2) step's parameters."""
    from repro_torch.train import checkpoint as CKPT
    job, root = worlds["job"], worlds["root"]
    whole, _, step = CKPT.restore(os.path.join(root, "ckpt"),
                                  R._zero_state(job, job["cfgs"]["llama4"],
                                                None))
    whole = [x.detach() for x in TM.tree_leaves(whole)]
    assert step == 1
    after = _got(worlds, "llama4", (2, 2))["after"]
    for a, b in zip(TM.tree_leaves(whole[1:1 + len(after)]), after):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    if target == "1x2":
        for r in range(4):
            step, leaves = worlds["ranks"][r]["restored_1x2"]
            assert step == 1 and len(leaves) == len(whole)
            for a, b in zip(leaves, whole):
                assert a.dtype == b.dtype and torch.equal(a, b)


# ---------------------------------------------------------------------------
# the training driver under FSDP
# ---------------------------------------------------------------------------

def _rank_fields(text):
    line = next(ln for ln in text.splitlines() if ln.startswith("[rank "))
    return dict(kv.split("=", 1) for kv in line.split()[2:])


def test_driver_grads_out_gives_whole_leaves(worlds):
    """`launch.train --fsdp --model-parallel 2 --grads-out` at (2, 2):
    `read_grads` gives every leaf whole, within the fp32 bounds of a
    one-process run's leaves, and the first step's loss within 1e-5."""
    cfg = dataclasses.replace(reduced_config(LLAMA4), fsdp=True)
    specs = {}
    S.tree_map_with_path(
        lambda p, sp: specs.__setitem__(".".join(map(str, p)), sp),
        param_specs(cfg, MeshSpec(("data", "model"), (2, 2))),
        is_leaf=lambda x: isinstance(x, S.P))
    assert any(S.data_dim(sp, MeshSpec(("data", "model"), (2, 2)))
               is not None for sp in specs.values())
    for path, sp in specs.items():
        one = trn.read_grads(worlds["one_dir"], path, S.P())
        got = trn.read_grads(worlds["grads_dir"], path, sp)
        assert got.shape == one.shape, path
        rel = float(np.linalg.norm(got - one) / (np.linalg.norm(one)
                                                 + 1e-30))
        assert rel <= REL_FP32_GRAD, (path, rel)
    loss = [json.load(open(os.path.join(d, "loss.json")))["loss"]
            for d in (worlds["grads_dir"], worlds["one_dir"])]
    assert abs(loss[0] - loss[1]) <= REL_FP32_LOSS * abs(loss[1])


def test_driver_ranks_keep_a_quarter_and_one_clip_norm(worlds):
    """Each rank of the driver's (2, 2) world prints its parameters', μ's
    and ν's bytes: the pieces `param_specs` gives it (drawn by
    `init_params(mesh=)`: no rank keeps a leaf the rules cut), and each
    step's clip norm, the same bits on every rank."""
    cfg = dataclasses.replace(reduced_config(LLAMA4), fsdp=True)
    spec = MeshSpec(("data", "model"), (2, 2))
    meta = TM.init_params(cfg, device="meta", dtype=torch.float32)
    sp = S.spec_leaves(S.param_specs(cfg, meta, spec), meta)
    piece = sum(S.shard_leaf(x, s, spec, {"data": 0, "model": 0}).numel()
                for x, s in zip(TM.tree_leaves(meta), sp))
    whole = sum(x.numel() for x in TM.tree_leaves(meta))
    fields = [_rank_fields(out) for out in worlds["driver"]]
    assert [int(f["state_bytes"]) for f in fields] == [3 * 4 * piece] * 4
    # the reduced vocabulary of 503 stays whole over `model` (the
    # divisibility guard), so a rank holds more than a quarter
    assert piece < whole / 2
    norms = {f["grad_norm"] for f in fields}
    assert len(norms) == 1 and len(norms.pop().split(",")) == 2
    assert worlds["driver"][0].startswith(
        "[mesh] backend=gloo world=4 data=2 model=2")
