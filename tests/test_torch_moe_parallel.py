"""PyTorch port, the MoE family (granite-moe-3b, llama4-maverick) on a
("data", "model") mesh against the JAX package and the port's one process
on the CPU, at reduced size (granite: 8 experts, top 2; llama4: 8
experts, top 1, a shared expert, MoE every second layer).

The ranks are spawned gloo worlds (tests/_torch_moe_parallel_ranks.py, a
`FileStore` under the test's temporary directory): a world of 4 runs the
MoE layer alone at (1, 2), (1, 4) and (1, 3) and a stand-in of reduced
granite with 6 experts at (1, 4), then the sharded train steps at (1, 2)
and (2, 1) side by side, (2, 2) and (1, 4), the load-balance loss at
(2, 1) and a checkpoint saved at (1, 2) and restored at (2, 2); a world
of 2 serves both archs at (1, 2) through the driver and the engine on a
(1, 1) mesh. The layouts: EP where the `model` axis divides the 8
experts (2 and 4), tensor parallelism inside each expert for the 6-expert
stand-in at 4 (6 % 4 ≠ 0, d_ff 128 % 4 = 0), everything whole at 3.

Tolerances:

* the MoE layer alone, fed the same x on every rank (fp32 policy, exact
  and approx): the combine bit-identical to one process (the replicated
  router on the same x); the output within 2⁻¹⁶ of its largest magnitude
  (the ranks' fp32 partials, or an expert's row-parallel chains, sum in
  another order; approx truncates 3 bits, 2⁻²⁰ relative, below that);
  the same bits on every rank;
* the sharded step against the JAX unsharded step on the global batch,
  run op by op (`jax.disable_jit()`, ROADMAP R8: routing near-ties part
  the JAX package's compiled run from its own op-by-op one):
  tests/test_torch_train.py's bounds (loss 2⁻¹⁰ relative, each gradient
  leaf within 2⁻⁵ of its norm, the parameters after AdamW within 2·lr);
  against the port's one-process fp32 step: tests/test_torch_parallel.py's
  (loss 1e-5 relative, leaves 2⁻⁶ of their norm);
* `load_balance` over a data axis: JAX's global value within 1e-6
  relative (fp32 policy);
* streams: one digest on every rank, the JAX engine's on the same weights
  under the fp32 policy (prompt seed 1), as tests/test_torch_serve_parallel.py
  holds the dense family;
* replicated leaves after the step, restored checkpoints, a rank's drawn
  shards: the same bits.
"""
import dataclasses
import os
import pickle
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch.multiprocessing as tmp_mp  # noqa: E402

from repro.configs import reduced_config as j_reduced  # noqa: E402
from repro.core import PrecisionPolicy, use_policy  # noqa: E402
from repro.data.pipeline import SyntheticLM as JSynthetic  # noqa: E402
from repro.launch import serve as jdrv  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.train import optimizer as JO  # noqa: E402
from repro_torch.configs import get_config, reduced_config  # noqa: E402
from repro_torch.core import precision as TP  # noqa: E402
from repro_torch.launch import serve as drv  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models import moe as TMOE  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.parallel import sharding as S  # noqa: E402
from repro_torch.parallel.mesh import MeshSpec  # noqa: E402

import _torch_moe_parallel_ranks as R  # noqa: E402
from test_torch_parallel import _one_process, _order, _rel  # noqa: E402

torch.set_num_threads(2)
GRANITE, LLAMA4 = "granite-moe-3b-a800m", "llama4-maverick-400b-a17b"
ARCHS = (GRANITE, LLAMA4)
MESHES = ((1, 2), (2, 1), (2, 2), (1, 4))
REL_GRAD, REL_LOSS = 2.0 ** -5, 2.0 ** -10
REL_FP32_LOSS, REL_FP32_GRAD = 1e-5, 2.0 ** -6
REL_FFN = 2.0 ** -16
REL_LB = 1e-6
SCHED = dict(peak_lr=1e-3, warmup_steps=2, total_steps=10)
WORLD_TIMEOUT_S = 300
# the driver's stream (tests/test_torch_serve_parallel.py's): seed 1 on
# 8-token pages, granite's with a shared 8-token system prompt; llama4's
# without it: that prompt holds a token whose top-1 gap is within the
# router logits' spread between the JAX package's compiled and op-by-op
# runs (ROADMAP R8), so the compiled JAX engine's stream parts from its
# own op-by-op forward there
STREAM = ["--reduced", "--device", "cpu", "--batch", "2", "--requests",
          "5", "--max-new", "4", "--prompt-lens", "6,10", "--rate", "0",
          "--seed", "1", "--page-size", "8"]
PREFIX = {GRANITE: ["--prefix-mix", "0.8", "--prefix-len", "8"],
          LLAMA4: []}
RUNS = {"paged": [], "ring": ["--kv", "ring"],
        "disagg": ["--disagg", "--prefill-workers", "2"]}
ENGINE_STREAM = dict(n=5, rate=0.0, prompt_lens=[6, 10], max_new=4, seed=1)
FP32_J = PrecisionPolicy(input_format="fp32")
FP32_T = TP.PrecisionPolicy(input_format="fp32")


def _argv(arch, *extra):
    return ["--arch", arch] + STREAM + PREFIX[arch] + list(extra)


def _layer_case(arch, **kw):
    """(port cfg, the first MoE layer's numpy leaves drawn by the JAX
    package, x) for the layer-alone runs."""
    jcfg = dataclasses.replace(j_reduced(arch), **kw)
    tcfg = dataclasses.replace(reduced_config(arch), **kw)
    jp = JM.init_params(jax.random.key(1), jcfg)
    layer = jp["layers"][jcfg.moe_every - 1]["moe"]
    p = {k: np.asarray(v[0]) for k, v in layer.items()}
    x = np.random.default_rng(7).standard_normal((2, 12, 64)).astype(
        np.float32)
    return tcfg, p, x


def _serve_weights(arch):
    cfg = dataclasses.replace(j_reduced(arch), remat=False)
    jp = JM.init_params(jax.random.key(1), cfg)
    return (dataclasses.replace(reduced_config(arch), remat=False),
            jax.tree.map(np.asarray, jp))


def _spawn(fn, root, world, job):
    os.makedirs(root)
    with open(os.path.join(root, "job.pkl"), "wb") as f:
        pickle.dump(job, f)
    return tmp_mp.start_processes(fn, args=(world, root), nprocs=world,
                                  join=False, start_method="spawn")


def _join(ctx):
    deadline = time.monotonic() + WORLD_TIMEOUT_S
    while not ctx.join(timeout=5):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            raise AssertionError("a spawned world did not finish")


def _lb_tokens(vocab):
    """4 rows of 16 tokens whose two halves (a data rank's rows each at
    (2, 1)) come from disjoint stretches of the vocabulary, so they route
    differently."""
    rng = np.random.default_rng(11)
    return np.concatenate([rng.integers(0, 40, (2, 16)),
                           rng.integers(vocab - 60, vocab, (2, 16))]
                          ).astype(np.int32)


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    base = str(tmp_path_factory.mktemp("moe_tp"))
    layer = {"granite": _layer_case(GRANITE), "llama4": _layer_case(LLAMA4),
             "granite_e6": _layer_case(GRANITE, num_experts=6)}
    job = {"cfgs": {}, "params": {}, "batch": {}, "sched": SCHED,
           "layer": layer, "ckpt_arch": GRANITE}
    for arch in ARCHS:
        cfg = j_reduced(arch, layers_per_period=2)
        jp = JM.init_params(jax.random.key(3), cfg)
        job["cfgs"][arch] = reduced_config(arch, layers_per_period=2)
        job["params"][arch] = jax.tree.map(np.asarray, jp)
        job["batch"][arch] = JSynthetic(cfg.vocab_size, 16, 4,
                                        seed=1).batch_at(0)
    job["lb_tokens"] = _lb_tokens(job["cfgs"][GRANITE].vocab_size)
    weights = {arch: _serve_weights(arch) for arch in ARCHS}
    sjob = {"weights": weights, "stream": ENGINE_STREAM,
            "runs": {arch: {name: _argv(arch, *extra, "--model-parallel",
                                        "2")
                            for name, extra in RUNS.items()}
                     for arch in ARCHS}}
    ctx = [_spawn(R.train_world, os.path.join(base, "train"), 4, job),
           _spawn(R.serve_world, os.path.join(base, "serve"), 2, sjob)]
    # the JAX steps op by op (their primitives compiled anew at each
    # shape: the dearest part) in processes of their own beside the ranks
    jdir = os.path.join(base, "jax")
    ctx.append(_spawn(_jax_refs, jdir, len(JAX_TASKS), job))
    refs = _references(job, weights)
    for c in ctx:
        _join(c)
    for i in range(len(JAX_TASKS)):
        with open(os.path.join(jdir, f"{i}.pkl"), "rb") as f:
            refs.update(pickle.load(f))
    tdir = os.path.join(base, "train")
    res = {shape: torch.load(os.path.join(tdir, f"steps_{shape[0]}x"
                                                f"{shape[1]}.pt"))
           for shape in MESHES}
    layers = {(case, shape): torch.load(os.path.join(
        tdir, f"layer_{case}_{shape[0]}x{shape[1]}.pt"))
        for case, shape, _ in R.LAYER_MESHES}
    served = [torch.load(os.path.join(base, "serve", f"rank{r}.pt"))
              for r in range(2)]
    return {"job": job, "refs": refs, "res": res, "layers": layers,
            "served": served, "root": tdir}


def _jax_step(cfg, jp, batch, accum):
    """The JAX unsharded step op by op: loss, gradients, the parameters
    after AdamW, the learning rate."""
    toks, labs = (jnp.asarray(batch[k]) for k in ("tokens", "labels"))
    mb = toks.shape[0] // accum
    with use_policy(PrecisionPolicy(backend="xla")), jax.disable_jit():
        vg = jax.value_and_grad(lambda p, t, l: JM.lm_loss(p, cfg, t, l),
                                has_aux=True)
        g_acc, l_acc = None, 0.0
        for i in range(accum):
            (loss, _), g = vg(jp, toks.reshape(mb, accum, -1)[:, i],
                              labs.reshape(mb, accum, -1)[:, i])
            g_acc = g if g_acc is None else jax.tree.map(jnp.add, g_acc, g)
            l_acc = l_acc + loss
    g = jax.tree.map(lambda x: x / accum, g_acc)
    jopt = JO.AdamW(schedule=JO.warmup_cosine(**SCHED))
    st = JO.AdamWState(count=jnp.zeros((), jnp.int32),
                       mu=jax.tree.map(jnp.zeros_like, jp),
                       nu=jax.tree.map(jnp.zeros_like, jp))
    after, _, jm = jopt.update(g, st, jp)
    return float(l_acc / accum), g, after, float(jm["lr"])


def _jax_load_balance(cfg, jp, tokens):
    with use_policy(FP32_J), jax.disable_jit():
        _, _, aux = JM.forward(jp, cfg, jnp.asarray(tokens))
    return float(aux["load_balance"])


# the spawned JAX processes: (arch, its accums, whether it also takes the
# load-balance values)
JAX_TASKS = ((GRANITE, (1,), False), (GRANITE, (2,), True),
             (LLAMA4, (1, 2), False))


def _jax_refs(rank: int, n: int, root: str):
    """A spawned process (JAX_TASKS[rank]): the JAX unsharded steps op by
    op at its accums, in the port's leaf order (and the load-balance
    values where it takes them), pickled to `<root>/<rank>.pkl`."""
    with open(os.path.join(root, "job.pkl"), "rb") as f:
        job = pickle.load(f)
    arch, accums, lb = JAX_TASKS[rank]
    cfg = j_reduced(arch, layers_per_period=2)
    jp = jax.tree.map(jnp.asarray, job["params"][arch])
    order = _order(job["cfgs"][arch], job["params"][arch])
    out = {}
    for accum in accums:
        loss, g, after, lr = _jax_step(cfg, jp, job["batch"][arch], accum)
        out[(arch, accum, "jax")] = {
            "loss": loss, "grads": order(jax.tree.map(np.asarray, g)),
            "after": order(jax.tree.map(np.asarray, after)), "lr": lr}
    if lb:
        toks = job["lb_tokens"]
        out["lb"] = (_jax_load_balance(cfg, jp, toks),
                     [_jax_load_balance(cfg, jp, toks[:2]),
                      _jax_load_balance(cfg, jp, toks[2:])])
    with open(os.path.join(root, f"{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)


def _references(job, weights):
    """While the ranks and the JAX steps run: the port's one-process fp32
    steps, the MoE layer in one process, and the JAX and one-process
    serve digests."""
    refs = {}
    for arch in ARCHS:
        for accum in (1, 2):
            refs[(arch, accum, "fp32")] = _one_process(
                job["cfgs"][arch], job["params"][arch], job["batch"][arch],
                accum)
    for case, (tcfg, p, x) in job["layer"].items():
        tp_ = {k: torch.from_numpy(v.copy()) for k, v in p.items()}
        for dropless in (True, False):
            for mode in ("exact", "approx"):
                with TP.use_policy(TP.PrecisionPolicy(input_format="fp32",
                                                      mode=mode)):
                    y, _ = TMOE.moe_ffn(torch.from_numpy(x), tp_, tcfg,
                                        tcfg.act, dropless=dropless,
                                        with_aux=False)
                    c, _ = TMOE.router(torch.from_numpy(x), tp_["router"],
                                       tcfg.experts_per_token, False)
                refs[("layer", case, dropless, mode)] = (y.detach(), c)
    for arch, (tcfg, np_params) in weights.items():
        with use_policy(FP32_J):
            want = jdrv.main([a for a in _argv(arch)
                              if a not in ("--device", "cpu")])
        with TP.use_policy(FP32_T):
            one = drv.main(_argv(arch),
                           params=params_from_numpy(np_params, "cpu"))
        refs[("digest", arch)] = (want["stream_digest"],
                                  one["stream_digest"],
                                  R.engine_digest(tcfg, np_params,
                                                  ENGINE_STREAM))
    return refs


# ---------------------------------------------------------------------------
# (a) the MoE layer alone
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["exact", "approx"])
@pytest.mark.parametrize("dropless", [True, False],
                         ids=["dropless", "capacity"])
@pytest.mark.parametrize("case,shape", [(c, s) for c, s, _ in
                                        R.LAYER_MESHES])
def test_moe_layer_on_the_mesh_matches_one_process(worlds, case, shape,
                                                   dropless, mode):
    """The MoE layer fed the same x on every rank of the mesh: the combine
    the one-process bits, the output within 2⁻¹⁶ of its largest
    magnitude of the one-process output, the same bits on every rank.
    (1, 2) and (1, 4) run EP, the 6-expert stand-in at (1, 4) TP inside
    each expert, (1, 3) the whole layer on every rank."""
    got = worlds["layers"][(case, shape)][(dropless, mode)]
    want, combine = worlds["refs"][("layer", case, dropless, mode)]
    assert got["same"]
    assert torch.equal(R._bits(got["combine"]), R._bits(combine))
    err = float((got["out"] - want).abs().max())
    assert err <= REL_FFN * float(want.abs().max())
    if shape == (1, 3):          # replicated: the one-process arithmetic
        assert torch.equal(R._bits(got["out"]), R._bits(want))


def test_layouts_are_the_sharding_rules():
    """The stand-ins cover the three layouts `param_specs` gives the
    expert stacks: EP, TP inside each expert, whole."""
    def layout(arch, tp, **kw):
        cfg = dataclasses.replace(reduced_config(arch), **kw)
        p = TM.init_params(cfg, device="meta", dtype=torch.float32)
        sp = S.param_specs(cfg, p, MeshSpec(("data", "model"), (1, tp)))
        return tuple(sp["layers"][cfg.moe_every - 1]["moe"]["wg"])
    assert layout(GRANITE, 2) == (None, "model", None, None)
    assert layout(GRANITE, 4, num_experts=6) == (None, None, None, "model")
    assert layout(GRANITE, 3) == (None, None, None, None)
    assert layout(LLAMA4, 4) == (None, "model", None, None)


def test_fsdp_entries_of_size_one_cut_nothing():
    """llama4's FSDP specs at data 1 name `data` on leaves the `model` axis
    does not cut (its router, P(None, "data", None)): given the mesh,
    `is_sharded` counts them replicated, so the clip counts their squares
    once and `--grads-out` writes them whole; an expert stack is cut."""
    cfg = get_config(LLAMA4)
    p = TM.init_params(dataclasses.replace(cfg, num_layers=2),
                       device="meta", dtype=torch.float32)
    mesh = MeshSpec(("data", "model"), (1, 2))
    sp = S.param_specs(cfg, p, mesh)["layers"][1]["moe"]
    assert tuple(sp["router"]) == (None, "data", None)
    assert not S.is_sharded(sp["router"], mesh)
    assert S.is_sharded(sp["wg"], mesh)
    # at data 2 the same entry cuts the router
    assert S.is_sharded(sp["router"], MeshSpec(("data", "model"), (2, 2)))


# ---------------------------------------------------------------------------
# (b) the sharded train step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("accum", [1, 2])
@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_sharded_step_matches_jax(worlds, arch, mesh, accum):
    """The sharded step (bf16 policy, the `cuda` backend's SA GEMM
    Function) against the JAX unsharded step on the same weights and
    global batch, op by op: loss, every gathered gradient leaf, the
    parameters after AdamW."""
    got = worlds["res"][mesh][(arch, accum, "bf16")]
    want = worlds["refs"][(arch, accum, "jax")]
    assert abs(got["loss"] - want["loss"]) <= REL_LOSS * abs(want["loss"])
    rel = _rel(got["grads"], want["grads"])
    assert len(rel) == len(want["grads"]) and max(rel) <= REL_GRAD, rel
    for a, b in zip(got["after"], want["after"]):
        np.testing.assert_allclose(a.numpy(), b, rtol=0,
                                   atol=2 * want["lr"])


@pytest.mark.parametrize("accum", [1, 2])
@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_sharded_step_matches_one_process_fp32(worlds, arch, mesh,
                                                   accum):
    """Under the fp32 policy the sharded step's loss is the port's
    one-process step's within 1e-5 relative and its gathered gradients
    within 2⁻⁶ of each leaf's norm."""
    got = worlds["res"][mesh][(arch, accum, "fp32")]
    want = worlds["refs"][(arch, accum, "fp32")]
    assert abs(got["loss"] - want["loss"]) <= REL_FP32_LOSS * abs(
        want["loss"])
    rel = _rel(got["grads"], want["grads"])
    assert len(rel) == len(want["grads"]) and max(rel) <= REL_FP32_GRAD, rel


@pytest.mark.parametrize("mesh", MESHES)
def test_moe_replicated_leaves_bit_identical(worlds, mesh):
    """The router, the norms and every leaf the divisibility guard
    replicates hold the same bits on every rank of the model axis after
    the step (the combine's gradient summed over the ranks' experts, the
    aux losses' not summed again)."""
    assert all(r["same"] for k, r in worlds["res"][mesh].items()
               if k != "load_balance")


# ---------------------------------------------------------------------------
# (c) the load-balance loss over the global batch
# ---------------------------------------------------------------------------

def test_load_balance_is_taken_over_the_global_batch(worlds):
    """At (2, 1), on a batch whose halves (one a data rank) route
    differently: `load_balance` is the JAX package's value on the whole
    batch within 1e-6 relative, and the mean of the halves' values is
    not."""
    got, rows = worlds["res"][(2, 1)]["load_balance"]
    whole, halves = worlds["refs"]["lb"]
    assert rows == 2
    assert abs(got - whole) <= REL_LB * whole
    assert abs(np.mean(halves) - whole) > REL_LB * whole


def test_capacity_dispatch_of_a_row_is_the_same_split_over_data(
        monkeypatch):
    """The capacity dispatch takes each expert's top C tokens within each
    batch row: the batch whole and its halves (each a data rank's rows)
    route every row's tokens alike, and the outputs agree within 2⁻¹⁶."""
    cfg, p, _ = _layer_case(GRANITE)
    p = {k: torch.from_numpy(v.copy()) for k, v in p.items()}
    x = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (4, 16, 64)).astype(np.float32))
    seen = []
    orig = TMOE._top_k

    def top_k(v, k):
        out = orig(v, k)
        seen.append(out[1])
        return out
    monkeypatch.setattr(TMOE, "_top_k", top_k)
    with TP.use_policy(FP32_T):
        whole, _ = TMOE.moe_ffn(x, p, cfg, cfg.act)
        halves = [TMOE.moe_ffn(x[i:i + 2], p, cfg, cfg.act)[0]
                  for i in (0, 2)]
    # each call routes (top k of each token), then dispatches (top C)
    w_route, w_disp, h0r, h0d, h1r, h1d = seen
    assert torch.equal(w_route, torch.cat([h0r, h1r]))
    assert torch.equal(w_disp, torch.cat([h0d, h1d]))
    split = torch.cat(halves)
    assert float((split - whole).abs().max()) <= REL_FFN * float(
        whole.abs().max())


# ---------------------------------------------------------------------------
# (d) a rank's shards drawn on the mesh
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,tp,kw", [
    (GRANITE, 2, {}), (GRANITE, 4, {"num_experts": 6}), (LLAMA4, 2, {}),
    (LLAMA4, 4, {})], ids=["granite-ep2", "granite-e6-tp4", "llama4-ep2",
                           "llama4-ep4"])
def test_moe_init_params_on_a_mesh_are_the_one_process_shards(
        monkeypatch, arch, tp, kw):
    """`init_params(mesh=)` gives each rank `shard_tree` of the one-process
    tree bit for bit: the expert stacks (4-D leaves, drawn an expert at a
    time) cut by experts under EP and by columns or rows inside each
    expert otherwise."""
    cfg = dataclasses.replace(reduced_config(arch), **kw)
    whole = TM.init_params(cfg, seed=3, device="cpu")
    mesh = MeshSpec(("data", "model"), (1, tp))
    specs = S.param_specs(cfg, whole, mesh)
    for r in range(tp):
        coords = {"data": 0, "model": r}
        monkeypatch.setattr(S, "mesh_coords", lambda _, c=coords: c)
        got = TM.init_params(cfg, seed=3, device="cpu", mesh=mesh)
        want = S.shard_tree(whole, specs, mesh, coords)
        for a, b in zip(TM.tree_leaves(got), TM.tree_leaves(want)):
            assert a.shape == b.shape and torch.equal(a, b)


# ---------------------------------------------------------------------------
# (e) serving on the model axis
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("run", sorted(RUNS))
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_stream_equals_jax_on_every_rank(worlds, arch, run):
    """The driver at (1, 2): both ranks one digest, the JAX driver's on the
    same weights and the port's one-process run's; paged, `--kv ring` and
    `--disagg` alike; every request complete, no page leaked."""
    want, one, _ = worlds["refs"][("digest", arch)]
    ranks = [r[(arch, run)] for r in worlds["served"]]
    assert all("error" not in r for r in ranks), ranks
    assert {r["digest"] for r in ranks} == {want} == {one}
    s = ranks[0]["summary"]
    assert s["requests"] == 5 and s["generated_tokens"] == 20
    assert s["nonfinite_logits"] == 0
    assert s["disagg"] is (run == "disagg")
    if run != "ring":
        assert s["pages_leaked"] == 0


@pytest.mark.parametrize("arch", ARCHS)
def test_one_rank_mesh_gives_the_one_process_digest(worlds, arch):
    """The engine under a (1, 1) mesh: the one-process digest bit for
    bit."""
    got = worlds["served"][0]["one_rank"][arch]
    assert got == worlds["refs"][("digest", arch)][2]


@pytest.mark.parametrize("case", ["fsdp-data2", "serve-data2"])
def test_moe_refusals(case):
    """Still refused by name: serving a paged pool over a data axis that
    does not divide the batch; serving over one that does is admitted
    (ROADMAP 7b). Training MoE over a data axis is admitted, and FSDP at
    data 1 and above (llama4's leaves cut over `data` too,
    tests/test_torch_fsdp.py)."""
    if case == "fsdp-data2":
        TM.check_parallel(get_config(LLAMA4), 2, 2)
        TM.check_parallel(get_config(LLAMA4), 2, 1)
    else:
        with pytest.raises(ValueError, match="data axis"):
            TM.check_parallel(get_config(GRANITE), 2, 2, serving=True,
                              batch=3, kv_layout="paged")
        TM.check_parallel(get_config(GRANITE), 2, 2, serving=True,
                          batch=2, kv_layout="paged")
        TM.check_parallel(get_config(GRANITE), 2, 2)


def test_gemm_calls_count_a_rank_s_experts():
    """A rank's SA GEMMs a decode step: E/tp experts under EP, all E
    otherwise (granite at 16 layers: 1041 at (1, 2), 2001 in one process;
    llama4's superblock: 208 and 400)."""
    g = dataclasses.replace(get_config(GRANITE), num_layers=16)
    ll = dataclasses.replace(get_config(LLAMA4), num_layers=2)
    assert (TM.gemm_calls(g, tp=2), TM.gemm_calls(g)) == (1041, 2001)
    assert (TM.gemm_calls(ll, tp=2), TM.gemm_calls(ll)) == (208, 400)
    assert TM.gemm_calls(g, tp=16) == TM.gemm_calls(g)     # 40 % 16 ≠ 0


def test_expert_layout_is_the_one_rule():
    """`sharding.expert_layout` decides EP, TP inside each expert or whole
    for the rules, the MoE layer and the GEMM count alike: granite's 40
    experts split whole over 2 and 8 ranks, by d_ff over 16 (the JAX
    production mesh's model axis), neither over 3."""
    g = get_config(GRANITE)
    assert [S.expert_layout(g, tp) for tp in (1, 2, 8, 16, 3)] == [
        "whole", "ep", "ep", "tp", "whole"]
    for tp in (2, 8, 16):
        sp = S.param_specs(g, TM.init_params(
            dataclasses.replace(g, num_layers=1), device="meta",
            dtype=torch.float32), MeshSpec(("data", "model"), (1, tp)))
        wg = tuple(sp["layers"][0]["moe"]["wg"])
        assert (wg[1] == "model") == (S.expert_layout(g, tp) == "ep")
        assert (wg[3] == "model") == (S.expert_layout(g, tp) == "tp")


def test_routing_gate_tells_a_near_tie_from_a_fault():
    """chip_smoke's gate on free routing at the first MoE layer where a
    served prompt's routing parts from one process: a token whose top-2
    set differs passes only where its one-process margin is within twice
    the spread of the two sides' router probabilities (a near tie traded
    by arithmetic), and the spread itself only within R1's bound."""
    import importlib.util
    import pathlib

    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    one = torch.tensor([[[0.40, 0.30, 0.2999, 0.0001],
                         [0.70, 0.20, 0.06, 0.04]]])
    diff = torch.tensor([[True, False]])
    # experts 1 and 2 trade places by 1.5e-4 at a margin of 1e-4
    tie = one.clone()
    tie[0, 0, 1:3] = torch.tensor([0.29995, 0.30005])
    got, problems = cs._routing_gate(torch, one, tie, diff, 2, "tie")
    assert not problems and got["margin_over_2spread"] <= 1
    # the same probabilities on both sides, yet another expert: a fault
    _, problems = cs._routing_gate(torch, one, one.clone(), diff, 2, "x")
    assert len(problems) == 1 and "routed otherwise" in problems[0]
    # a margin past twice the spread: a fault
    far = tie.clone()
    far[0, 1, 0] -= 0.0001
    _, problems = cs._routing_gate(torch, one, far, torch.tensor(
        [[False, True]]), 2, "x")
    assert len(problems) == 1 and "routed otherwise" in problems[0]
    # probabilities that part by more than R1's bound
    wide = one.clone()
    wide[0, 1, 0] -= 0.1
    _, problems = cs._routing_gate(torch, one, wide, diff, 2, "x")
    assert any("above R1's" in p for p in problems)


# ---------------------------------------------------------------------------
# (f) checkpoints
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("target", ["1x1", "2x2"])
def test_moe_checkpoint_restores_at_another_mesh(worlds, target):
    """A granite checkpoint saved at (1, 2) (expert stacks gathered whole)
    restores bit for bit in one process and at (2, 2), and holds the
    (1, 2) step's parameters."""
    from repro_torch.train import checkpoint as CKPT
    job, root = worlds["job"], worlds["root"]
    whole, _, step = CKPT.restore(os.path.join(root, "ckpt"),
                                  R._state_of(job, GRANITE))
    whole = [x.detach() for x in TM.tree_leaves(whole)]
    assert step == 1
    after = worlds["res"][(1, 2)][(GRANITE, 1, "bf16")]["after"]
    params = TM.tree_leaves(whole[1:1 + len(after)])
    for a, b in zip(params, after):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    if target == "2x2":
        got = torch.load(os.path.join(root, "restored_2x2.pt"))
        assert got["step"] == 1 and len(got["leaves"]) == len(whole)
        for a, b in zip(got["leaves"], whole):
            assert a.dtype == b.dtype and torch.equal(a, b)
