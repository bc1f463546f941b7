"""PyTorch port, data and tensor parallelism (`repro_torch.parallel`,
the sharded train step, reshard-on-load, the launcher under a mesh)
against the JAX package on the CPU.

The ranks are spawned gloo worlds (tests/_torch_parallel_ranks.py, a
`FileStore` under the test's temporary directory): one world of 4 runs
the meshes (1, 2) and (2, 1) side by side on ranks 0-1 and 2-3, then
(2, 2) and (1, 4); a world of 2 runs the launcher. Tolerances:

* sharding rules, int8 compression: equal (the same rules; the same fp32
  operations, with a MAX and an integer SUM across ranks);
* bf16 compression: within one bf16 ulp of the sum a term (the ranks'
  bf16 partial sums round in another order than JAX's);
* sharded step against the JAX unsharded step: test_torch_train.py's
  bounds (loss 2⁻¹⁰ relative, each gradient leaf within 2⁻⁵ of its norm,
  parameters after the step within 2·lr);
* against the port's own one-process step under the fp32 policy: the
  loss within 1e-5 relative, each gradient leaf within 2⁻⁶ of its norm.
  The row-parallel sums, the vocabulary-parallel logsumexp and the data
  all-reduce add fp32 in other orders, and the CPU's fp32 GEMM sums a row
  in an order that depends on the row count (a data rank's rows are
  fewer); the residual stream and the cotangents reaching the masters are
  bf16 whatever the policy (both frameworks), so such a last-bit
  difference flips a bf16 rounding (2⁻⁸) that the backward carries
  through the layers: the leaves part by up to 0.0090 of their norm
  (pure data parallelism 0.0024), far below what a missing or doubled
  collective gives (order 1);
* replicated leaves after the step: the same bits on every rank of the
  model axis; a checkpoint restored at another mesh: the same bits.
"""
import os
import pickle
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch.multiprocessing as tmp_mp  # noqa: E402

from repro.configs import ARCH_NAMES  # noqa: E402
from repro.configs import get_config as j_get_config  # noqa: E402
from repro.configs import reduced_config as j_reduced  # noqa: E402
from repro.core import precision as JP  # noqa: E402
from repro.data.pipeline import SyntheticLM as JSynthetic  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.parallel import compression as JC  # noqa: E402
from repro.parallel import sharding as JS  # noqa: E402
from repro.train import optimizer as JO  # noqa: E402
from repro_torch.configs import get_config, reduced_config  # noqa: E402
from repro_torch.core import precision as TP  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.parallel import sharding as S  # noqa: E402
from repro_torch.parallel.mesh import (MeshSpec,  # noqa: E402
                                       make_production_mesh)
from repro_torch.train import optimizer as TO  # noqa: E402
from repro_torch.train.step import make_train_step  # noqa: E402
from repro_torch.train.train_state import TrainState  # noqa: E402

import _torch_parallel_ranks as R  # noqa: E402

REL_GRAD, REL_LOSS = 2.0 ** -5, 2.0 ** -10
REL_FP32_LOSS, REL_FP32_GRAD = 1e-5, 2.0 ** -6
ARCHS = ("qwen2.5-14b", "phi3-medium-14b")
MESHES = ((1, 2), (2, 1), (2, 2), (1, 4))
SCHED = dict(peak_lr=1e-3, warmup_steps=2, total_steps=10)


# ---------------------------------------------------------------------------
# the sharding rules against the JAX package's, every arch at full size
# ---------------------------------------------------------------------------

STAND_INS = {"16x16": make_production_mesh(),
             "2x16x16": make_production_mesh(multi_pod=True),
             "4x2": MeshSpec(("data", "model"), (4, 2)),
             "1x4": MeshSpec(("data", "model"), (1, 4))}


def _jax_mesh(spec):
    """What the JAX rules read of a mesh: its axis names and shape."""
    return types.SimpleNamespace(axis_names=spec.axis_names,
                                 devices=np.empty(spec.shape))


def _jax_specs(tree):
    from jax.sharding import PartitionSpec
    leaves, _ = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, PartitionSpec))
    return {JS._path_str(p): tuple(s) for p, s in leaves}


def _port_specs(tree):
    out = {}
    S.tree_map_with_path(lambda p, s: out.__setitem__(
        "/".join(map(str, p)), tuple(s)), tree,
        is_leaf=lambda x: isinstance(x, S.P))
    return out


@pytest.mark.parametrize("mesh", sorted(STAND_INS))
@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_sharding_rules_equal_jax(arch, mesh):
    """param_specs, cache_specs (dense rings and paged pools, a batch the
    DP axes divide and one they do not), data_specs and
    handoff_frag_specs of the full-size abstract trees, equal to the JAX
    package's on the stand-in mesh."""
    spec = STAND_INS[mesh]
    jm = _jax_mesh(spec)
    jcfg, tcfg = j_get_config(arch), get_config(arch)
    jp = jax.eval_shape(lambda: JM.init_params(jax.random.key(0), jcfg))
    tp = TM.init_params(tcfg, device="meta", dtype=torch.float32)
    assert _port_specs(S.param_specs(tcfg, tp, spec)) == _jax_specs(
        JS.param_specs(jcfg, jp, jm))
    for batch in (32, 3):
        for paged in (None, (33, 16)):
            jc = JM.init_cache(jcfg, batch, 64, abstract=True, paged=paged)
            tc = TM.init_cache(tcfg, batch, 64, device="meta", paged=paged)
            assert _port_specs(S.cache_specs(tcfg, tc, spec, batch)) == \
                _jax_specs(JS.cache_specs(jcfg, jc, jm, batch))
    jf = JM.init_cache(jcfg, 1, 64, abstract=True)
    tf = TM.init_cache(tcfg, 1, 64, device="meta")
    assert _port_specs(S.handoff_frag_specs(tcfg, tf, spec)) == \
        _jax_specs(JS.handoff_frag_specs(jcfg, jf, jm))
    for shape in ((32, 128), (3, 128)):
        assert tuple(S.data_specs(spec, shape)) == tuple(
            JS.data_specs(jm, shape))


def test_refusals():
    """What the mesh still refuses, with a reason: a paged pool when
    serving where the data axis does not divide the batch (it names the
    ring layout, whose rows split over `data`). Serving over a data axis
    that divides the batch, and the ring at batch 1, are admitted (ROADMAP
    7b, tests/test_torch_serve_data.py). Every family trains at any mesh
    (the MoE family in tests/test_torch_moe_parallel.py, the SSM, hybrid
    and frontend families in tests/test_torch_family_parallel.py), FSDP
    over a data axis above 1 too (llama4, tests/test_torch_fsdp.py)."""
    from repro_torch.models.model import check_parallel
    qwen = get_config("qwen2.5-14b")
    with pytest.raises(ValueError, match="--kv ring"):
        check_parallel(qwen, 2, 2, serving=True, batch=1, kv_layout="paged")
    check_parallel(qwen, 2, 2, serving=True, batch=4, kv_layout="paged")
    check_parallel(qwen, 2, 2, serving=True, batch=1, kv_layout="ring")
    check_parallel(get_config("llama4-maverick-400b-a17b"), 2, 2)
    check_parallel(qwen, 4, 2)


# ---------------------------------------------------------------------------
# the spawned worlds, run once for the module
# ---------------------------------------------------------------------------

def _np_params(arch):
    cfg = j_reduced(arch, layers_per_period=2)
    jp = JM.init_params(jax.random.key(3), cfg)
    if cfg.qkv_bias:   # nonzero biases: the column shards' epilogue
        jp["layers"] = tuple(
            {**lay, "attn": {**lay["attn"], **{
                b: jax.random.normal(jax.random.key(i), lay["attn"][b].shape)
                * 0.1 for i, b in enumerate(("bq", "bk", "bv"))}}}
            for lay in jp["layers"])
    return cfg, jp, jax.tree.map(np.asarray, jp)


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("tp"))
    rng = np.random.default_rng(5)
    job = {"cfgs": {}, "params": {}, "batch": {}, "sched": SCHED,
           "comp": {k: rng.standard_normal((4, 33)).astype(np.float32)
                    * (10.0 if k.startswith("grads") else 0.01)
                    for k in ("grads", "resid", "grads2", "resid2")}}
    jax_side = {}
    for arch in ARCHS:
        cfg, jp, npp = _np_params(arch)
        job["cfgs"][arch] = reduced_config(arch, layers_per_period=2)
        job["params"][arch] = npp
        job["batch"][arch] = JSynthetic(cfg.vocab_size, 16, 4,
                                        seed=1).batch_at(0)
        jax_side[arch] = (cfg, jp)
    with open(os.path.join(root, "job.pkl"), "wb") as f:
        pickle.dump(job, f)
    ctx = [tmp_mp.start_processes(R.sharded_world, args=(4, root), nprocs=4,
                                  join=False, start_method="spawn")]
    lroot = os.path.join(root, "launcher")
    os.makedirs(lroot)
    argv = ["--arch", "qwen2.5-14b", "--reduced", "--device", "cpu",
            "--steps", "2", "--batch", "4", "--seq", "16",
            "--model-parallel", "2"]
    ctx.append(tmp_mp.start_processes(R.launcher_world, args=(2, lroot,
                                                              argv),
                                      nprocs=2, join=False,
                                      start_method="spawn"))
    refs = _references(job, jax_side)
    for c in ctx:
        while not c.join():
            pass
    res = {shape: torch.load(os.path.join(
        root, f"steps_{shape[0]}x{shape[1]}.pt")) for shape in MESHES}
    return job, refs, res, root, lroot


def _references(job, jax_side):
    """The JAX unsharded step (loss, gradients, parameters after AdamW)
    and the port's one-process step under the fp32 policy, per (arch,
    accum), while the ranks run."""
    refs = {}
    for arch, (cfg, jp) in jax_side.items():
        batch = job["batch"][arch]
        toks, labs = (jnp.asarray(batch[k]) for k in ("tokens", "labels"))
        for accum in (1, 2):
            mb = toks.shape[0] // accum
            with JP.use_policy(JP.PrecisionPolicy(backend="xla")):
                vg = jax.jit(jax.value_and_grad(
                    lambda p, t, l: JM.lm_loss(p, cfg, t, l), has_aux=True))
                g_acc, l_acc = None, 0.0
                for i in range(accum):
                    (loss, _), g = vg(jp, toks.reshape(mb, accum, -1)[:, i],
                                      labs.reshape(mb, accum, -1)[:, i])
                    g_acc = g if g_acc is None else jax.tree.map(
                        jnp.add, g_acc, g)
                    l_acc = l_acc + loss
            g = jax.tree.map(lambda x: x / accum, g_acc)
            jopt = JO.AdamW(schedule=JO.warmup_cosine(**SCHED))
            st = JO.AdamWState(count=jnp.zeros((), jnp.int32),
                               mu=jax.tree.map(jnp.zeros_like, jp),
                               nu=jax.tree.map(jnp.zeros_like, jp))
            after, _, jm = jopt.update(g, st, jp)
            tcfg = job["cfgs"][arch]
            order = _order(tcfg, job["params"][arch])
            refs[(arch, accum, "jax")] = {
                "loss": float(l_acc / accum),
                "grads": order(jax.tree.map(np.asarray, g)),
                "after": order(jax.tree.map(np.asarray, after)),
                "lr": float(jm["lr"])}
            refs[(arch, accum, "fp32")] = _one_process(
                tcfg, job["params"][arch], batch, accum)
    return refs


def _order(tcfg, np_params):
    """numpy leaves of a JAX-structured tree in the port's leaf order."""
    def order(tree):
        t = params_from_numpy(tree, "cpu", dtype=torch.float32)
        return [x.numpy() for x in TM.tree_leaves(t)]
    return order


def _one_process(cfg, np_params, batch, accum, fmt="fp32"):
    params = params_from_numpy(np_params, "cpu", dtype=torch.float32)
    for p in TM.tree_leaves(params):
        p.requires_grad_(True)
    opt = TO.AdamW(schedule=TO.warmup_cosine(**SCHED))
    state = TrainState(step=torch.zeros((), dtype=torch.int32),
                       params=params, opt_state=opt.init(params))
    got = {}

    def on_grads(loss, nll, grads):
        got["loss"] = float(loss)
        got["grads"] = [g.detach().clone().numpy()
                        for g in TM.tree_leaves(grads)]

    with TP.use_policy(TP.PrecisionPolicy(input_format=fmt,
                                          backend="cuda")):
        state, _ = make_train_step(cfg, opt, accum, on_grads=on_grads)(
            state, {k: torch.from_numpy(v) for k, v in batch.items()})
    got["after"] = [p.detach().numpy() for p in TM.tree_leaves(state.params)]
    return got


def _rel(got, want):
    return [float(np.linalg.norm(np.asarray(g) - w)
                  / (np.linalg.norm(w) + 1e-30)) for g, w in zip(got, want)]


@pytest.mark.parametrize("accum", [1, 2])
@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_step_matches_jax(worlds, arch, mesh, accum):
    """The sharded step (bf16 policy, the `cuda` backend's SA GEMM
    Function) against the JAX unsharded step on the same weights and
    global batch: loss, every gathered gradient leaf, the parameters
    after AdamW. (1, 4) pads the 2 KV heads to 4 (half a head a rank's
    columns)."""
    _, refs, res, _, _ = worlds
    got, want = res[mesh][(arch, accum, "bf16")], refs[(arch, accum, "jax")]
    assert abs(got["loss"] - want["loss"]) <= REL_LOSS * abs(want["loss"])
    rel = _rel(got["grads"], want["grads"])
    assert len(rel) == len(want["grads"]) and max(rel) <= REL_GRAD, rel
    for a, b in zip(got["after"], want["after"]):
        np.testing.assert_allclose(a.numpy(), b, rtol=0,
                                   atol=2 * want["lr"])


@pytest.mark.parametrize("accum", [1, 2])
@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_step_matches_one_process_fp32(worlds, arch, mesh, accum):
    """Under the fp32 policy the sharded step's loss is the port's
    one-process step's within 1e-5 relative and its gathered gradients
    within 2⁻⁶ of each leaf's norm (the module's docstring)."""
    _, refs, res, _, _ = worlds
    got, want = res[mesh][(arch, accum, "fp32")], refs[(arch, accum, "fp32")]
    assert abs(got["loss"] - want["loss"]) <= REL_FP32_LOSS * abs(
        want["loss"])
    rel = _rel(got["grads"], want["grads"])
    assert len(rel) == len(want["grads"]) and max(rel) <= REL_FP32_GRAD, rel


@pytest.mark.parametrize("mesh", MESHES)
def test_replicated_leaves_bit_identical(worlds, mesh):
    """Every replicated leaf (norms, and what the divisibility guard
    replicates: the reduced vocabulary of 503) holds the same bits on
    every rank of the model axis after the step."""
    _, _, res, _, _ = worlds
    assert all(r["same"] for r in res[mesh].values())


@pytest.mark.parametrize("target", ["1x1", "2x2"])
def test_checkpoint_restores_at_another_mesh(worlds, target):
    """A checkpoint saved at (1, 2) (full leaves, gathered) restores bit
    for bit in one process and at (2, 2) (each rank cutting its shards),
    and holds the (1, 2) step's parameters."""
    from repro_torch.train import checkpoint as CKPT
    job, _, res, root, _ = worlds
    ckpt = os.path.join(root, "ckpt")
    whole, _, step = CKPT.restore(ckpt, R.target_state(job))
    whole = [x.detach() for x in TM.tree_leaves(whole)]
    assert step == 1
    after = res[(1, 2)][("qwen2.5-14b", 1, "bf16")]["after"]
    params = TM.tree_leaves(whole[1:1 + len(after)])
    for a, b in zip(params, after):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    if target == "2x2":
        got = torch.load(os.path.join(root, "restored_2x2.pt"))
        assert got["step"] == 1 and len(got["leaves"]) == len(whole)
        for a, b in zip(got["leaves"], whole):
            assert a.dtype == b.dtype and torch.equal(a, b)


def test_compressed_psum_int8_bit_exact_against_jax(worlds):
    """int8 `compressed_psum` over 4 ranks (MAX of the scale, int32 SUM,
    error feedback) against the JAX package's under
    `jax.vmap(axis_name="data")`: the sums and every rank's residual bit
    for bit; `none` is the plain sum."""
    job, _, _, root, _ = worlds
    c = job["comp"]
    got = [torch.load(os.path.join(root, f"comp_{r}.pt")) for r in range(4)]

    def jax_side(codec):
        def f(g, g2, r, r2):
            s, res = JC.compressed_psum({"a": g, "b": {"c": g2}}, "data",
                                        codec, {"a": r, "b": {"c": r2}})
            return s["a"], s["b"]["c"], res["a"], res["b"]["c"]
        return [np.asarray(x) for x in jax.vmap(f, axis_name="data")(
            *(jnp.asarray(c[k]) for k in ("grads", "grads2", "resid",
                                          "resid2")))]
    sa, sb, ra, rb = jax_side("int8")
    for r in range(4):
        (tsa, tsb), (tra, trb) = got[r]["int8"]
        for t, j in ((tsa, sa[r]), (tsb, sb[r]), (tra, ra[r]),
                     (trb, rb[r])):
            np.testing.assert_array_equal(t.numpy().view(np.uint32),
                                          j.view(np.uint32))
    want = (c["grads"] + c["resid"]).sum(0)
    np.testing.assert_allclose(got[0]["none"][0][0].numpy(), want,
                               rtol=1e-6, atol=1e-6)


def test_compressed_psum_bf16_within_an_ulp_a_term(worlds):
    """bf16 `compressed_psum`: the sum within one bf16 ulp of the sum a
    term of JAX's, the residual (what bf16 dropped) equal."""
    job, _, _, root, _ = worlds
    c = job["comp"]
    got = [torch.load(os.path.join(root, f"comp_{r}.pt")) for r in range(4)]

    def f(g, r):
        s, res = JC.compressed_psum({"a": g}, "data", "bf16", {"a": r})
        return s["a"], res["a"]
    js, jr = (np.asarray(x) for x in jax.vmap(f, axis_name="data")(
        jnp.asarray(c["grads"]), jnp.asarray(c["resid"])))
    x = c["grads"] + c["resid"]
    ulp = np.abs(x).sum(0) * 2.0 ** -7 + 4 * 2.0 ** -7 * np.abs(js[0])
    for r in range(4):
        (tsa, _), (tra, _) = got[r]["bf16"]
        assert (np.abs(tsa.numpy() - js[r]) <= ulp).all()
        np.testing.assert_array_equal(tra.numpy(), jr[r])


@pytest.mark.parametrize("codec", ["int8", "bf16"])
def test_compress_tree_matches_jax(codec):
    """`compress_tree` and `decompress_tree` (one process, no reduction):
    the payloads, the residuals and the round trip equal the JAX
    package's bit for bit."""
    from repro_torch.parallel import compression as TC
    rng = np.random.default_rng(7)
    tree = {"a": rng.standard_normal((5, 33)).astype(np.float32) * 3,
            "b": {"c": rng.standard_normal(17).astype(np.float32) * 1e-3}}
    jp, jr = JC.compress_tree(jax.tree.map(jnp.asarray, tree), codec)
    tp_, tr = TC.compress_tree(
        {"a": torch.from_numpy(tree["a"]),
         "b": {"c": torch.from_numpy(tree["b"]["c"])}}, codec)
    jd = JC.decompress_tree(jp, codec)
    td = TC.decompress_tree(tp_, codec)

    def bits(x):
        x = np.asarray(x.float() if isinstance(x, torch.Tensor) else x)
        return x.astype(np.float32).view(np.uint32)
    for key in (("a",), ("b", "c")):
        def at(t):
            for k in key:
                t = t[k]
            return t
        np.testing.assert_array_equal(bits(at(tr)), bits(at(jr)))
        np.testing.assert_array_equal(bits(at(td)), bits(at(jd)))
        if codec == "int8":
            (q, sc), (jq, jsc) = at(tp_), at(jp)
            np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
            assert float(sc) == float(jsc)


def test_launcher_two_steps_in_a_world_of_two(worlds):
    """`python -m repro_torch.launch.train --model-parallel 2` in a
    spawned world of 2: the backend line first (gloo on the CPU), rank 0
    a JSON line a step with a finite loss, the other rank none, and each
    rank's peak memory and step times."""
    import json
    _, _, _, _, lroot = worlds
    out0 = open(os.path.join(lroot, "launcher_0.txt")).read().splitlines()
    out1 = open(os.path.join(lroot, "launcher_1.txt")).read().splitlines()
    assert out0[0].startswith("[mesh] backend=gloo world=2 data=1 model=2")
    steps = [json.loads(ln) for ln in out0 if ln.startswith("{")]
    assert [s["step"] for s in steps] == [1, 2]
    assert all(np.isfinite(s["loss"]) for s in steps)
    assert not any(ln.startswith("{") for ln in out1)
    assert any(ln.startswith("[rank 1] peak_mem_gib=") for ln in out1)
