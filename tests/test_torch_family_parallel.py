"""PyTorch port, the SSM, hybrid and frontend families (mamba2-2.7b,
hymba-1.5b, whisper-tiny, pixtral-12b) on a ("data", "model") mesh
against the JAX package and the port's one process on the CPU, at
reduced size.

The configs: reduced mamba2 and pixtral at 2 layers; reduced hymba cut
to one global and one local layer (its 16-layer period would make every
step 8 times dearer), and a stand-in of it (`hymba_h5`: 10 heads over 5
KV heads, 64-wide SSM heads, so H = 2 and in_proj's 290 columns) which a
`model` axis of 4 divides neither in in_proj nor in H and whose 5 KV
heads it pads to 8, as it does full hymba's 6482 columns, 50 heads and 5
KV heads; whisper with its 6 heads over 6 KV heads (3 a rank at 2,
1.5 a rank's columns at 4, padded to 8 under a cache) and a vocabulary
of 3500 padded to 4096, whose padding columns sit on the last rank of
4 as full whisper's 51865 → 53248 do.

The ranks are one spawned gloo world of 4
(tests/_torch_family_parallel_ranks.py, on the shared harness of
tests/_torch_parallel_ranks.py): the steps at (1, 2) on ranks 0-1
(mamba2, hymba) and 2-3 (whisper, pixtral) side by side, every arch at
(1, 4), mamba2 at (2, 2), a checkpoint of mamba2's (1, 2) step; then
the serve runs at (1, 2) and (1, 4), the mixer alone, whisper's logit
columns at (1, 4), and the engine on a (1, 1) mesh. The
JAX references run in spawned processes of their own beside the world.

Tolerances (those of tests/test_torch_parallel.py and
tests/test_torch_moe_parallel.py):

* the sharded step against the JAX unsharded step on the global batch,
  run op by op (`jax.disable_jit()`: the compiled JAX step parts from
  its own op-by-op run by 1-2.4 % of the worst gradient leaf's norm in
  every family with attention, because XLA's fusions move roundings of
  the bf16 residual stream; hymba_h5's dt_bias by 0.06, ROADMAP R12):
  loss 2⁻¹⁰ relative, each gradient leaf within 2⁻⁵ of its norm, the
  parameters after AdamW within 2·lr; against the port's one-process
  fp32 step: loss 1e-5 relative, leaves 2⁻⁶ of their norm;
* the mixer alone (fp32 policy): in_proj's gathered output and the
  state the one-process bits (column pieces carry the whole GEMM's
  bits; the conv and the SSD run whole on every rank), the output within
  R1's bound (2⁻⁵ of its largest magnitude; out_proj's row chains sum in
  another order), the same bits on every rank;
* streams (fp32 policy): one stream on every rank, the port's
  one-process stream (paged, ring, `generate()`, the serve launcher), which for
  mamba2 and hymba is the JAX engine's and for whisper the JAX
  `generate()`'s on the same weights (pixtral's is held to the port's one
  process: the JAX engine's VLM `generate()` is not greedy decoding of
  its own forward, ROADMAP F8);
* replicated leaves after the step, a restored checkpoint, a rank's
  drawn shards: the same bits.
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
from repro.core import precision as JP  # noqa: E402
from repro.data.pipeline import SyntheticLM as JSynthetic  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.serve.engine import ServeEngine as JEngine  # noqa: E402
from repro.serve.scheduler import SlotScheduler as JSched  # noqa: E402
from repro.train import optimizer as JO  # noqa: E402
from repro_torch.configs import get_config, reduced_config  # noqa: E402
from repro_torch.core import precision as TP  # noqa: E402
from repro_torch.launch import serve as drv  # noqa: E402
from repro_torch.launch import train as trn  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models import ssm as TS  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.models.layers import padded_kvh  # noqa: E402
from repro_torch.parallel import sharding as S  # noqa: E402
from repro_torch.parallel.mesh import MeshSpec  # noqa: E402
from repro_torch.serve.engine import ServeEngine  # noqa: E402

import _torch_family_parallel_ranks as R  # noqa: E402
from _torch_parallel_ranks import engine_streams  # noqa: E402
from test_torch_parallel import _one_process, _order, _rel  # noqa: E402

torch.set_num_threads(2)
MAMBA2, HYMBA = "mamba2-2.7b", "hymba-1.5b"
WHISPER, PIXTRAL = "whisper-tiny", "pixtral-12b"
GLOBAL_LOCAL = dict(attn_pattern=("global", "local"), num_layers=2)
# key: (arch, the reduced config's changes)
CASES = {"mamba2": (MAMBA2, {}),
         "hymba": (HYMBA, GLOBAL_LOCAL),
         "hymba_h5": (HYMBA, dict(GLOBAL_LOCAL, num_heads=10,
                                  num_kv_heads=5, ssm_head_dim=64)),
         "whisper": (WHISPER, dict(num_heads=6, num_kv_heads=6,
                                   vocab_size=3500)),
         "pixtral": (PIXTRAL, {})}
STEPS = ([(a, (1, 2)) for archs in R.PAIR_ARCHS.values() for a in archs]
         + [(a, s) for s, archs in R.QUAD_ARCHS.items() for a in archs])
REL_GRAD, REL_LOSS = 2.0 ** -5, 2.0 ** -10
REL_FP32_LOSS, REL_FP32_GRAD = 1e-5, 2.0 ** -6
R1 = 2.0 ** -5
SCHED = dict(peak_lr=1e-3, warmup_steps=2, total_steps=10)
WORLD_TIMEOUT_S = 300
FP32_J = PrecisionPolicy(input_format="fp32")
FP32_T = TP.PrecisionPolicy(input_format="fp32")
# the serve launcher's runs (prompt seed 1): mamba2's continuous stream,
# pixtral's static waves
DRIVER = {"mamba2": ["--arch", MAMBA2, "--layers-per-period", "2"],
          "pixtral": ["--arch", PIXTRAL, "--layers-per-period", "2"]}
DRIVER_ARGS = ["--reduced", "--device", "cpu", "--batch", "2",
               "--requests", "4", "--max-new", "4", "--prompt-lens", "6,12",
               "--max-seq-len", "32", "--rate", "0", "--seed", "1"]


def _cfgs(key):
    arch, kw = CASES[key]
    return (dataclasses.replace(j_reduced(arch, layers_per_period=2), **kw),
            dataclasses.replace(reduced_config(arch, layers_per_period=2),
                                **kw))


def _job():
    rng = np.random.default_rng(5)
    job = {"cfgs": {}, "jcfgs": {}, "params": {}, "batch": {},
           "sched": SCHED, "prompts": {}, "generate": {}, "mixer": {},
           "runs": {k: {"run": v + DRIVER_ARGS} for k, v in DRIVER.items()}}
    for key in CASES:
        jcfg, tcfg = _cfgs(key)
        jp = JM.init_params(jax.random.key(3), jcfg)
        job["jcfgs"][key], job["cfgs"][key] = jcfg, tcfg
        job["params"][key] = jax.tree.map(np.asarray, jp)
        batch = JSynthetic(jcfg.vocab_size, 16, 4, seed=1).batch_at(0)
        if jcfg.frontend_tokens:
            fe = (4, jcfg.frontend_tokens, jcfg.d_model)
            batch["frontend"] = rng.standard_normal(fe).astype(np.float32)
            toks = rng.integers(0, jcfg.vocab_size, (2, 12)).astype(np.int32)
            job["generate"][key] = (toks, rng.standard_normal(
                (2,) + fe[1:]).astype(np.float32), 7)
        else:
            prng = np.random.default_rng(1)
            job["prompts"][key] = [
                (prng.integers(0, jcfg.vocab_size, n).tolist(), b)
                for n, b in ((12, 8), (6, 3), (12, 5))]
        job["batch"][key] = batch
        if key in ("mamba2", "hymba_h5"):
            layer = jp["layers"][0]["ssm"]
            P, N = tcfg.ssm_head_dim, tcfg.ssm_state
            job["mixer"][key] = (
                tcfg, {k: np.asarray(v[0]) for k, v in layer.items()},
                rng.standard_normal((2, 12, tcfg.d_model)).astype(
                    np.float32),
                rng.standard_normal((2, tcfg.n_ssm_heads, P, N)).astype(
                    np.float32) * 0.1,
                rng.standard_normal((2, 3, tcfg.d_inner + 2 * N)).astype(
                    np.float32))
    return job


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


# ---------------------------------------------------------------------------
# the JAX references, in spawned processes beside the world
# ---------------------------------------------------------------------------

def _jax_step(cfg, jp, batch, accum):
    """The JAX unsharded step op by op: loss, gradients, the parameters
    after AdamW, the learning rate."""
    toks, labs = (jnp.asarray(batch[k]) for k in ("tokens", "labels"))
    fe = batch.get("frontend")
    mb = toks.shape[0] // accum

    def loss_fn(p, t, l, f):
        return JM.lm_loss(p, cfg, t, l, frontend_embeds=f)

    with JP.use_policy(JP.PrecisionPolicy(backend="xla")), \
            jax.disable_jit():
        vg = jax.value_and_grad(loss_fn, has_aux=True)
        g_acc, l_acc = None, 0.0
        for i in range(accum):
            f = None if fe is None else jnp.asarray(
                fe.reshape(mb, accum, *fe.shape[1:])[:, i])
            (loss, _), g = vg(jp, toks.reshape(mb, accum, -1)[:, i],
                              labs.reshape(mb, accum, -1)[:, i], f)
            g_acc = g if g_acc is None else jax.tree.map(jnp.add, g_acc, g)
            l_acc = l_acc + loss
    g = jax.tree.map(lambda x: x / accum, g_acc)
    jopt = JO.AdamW(schedule=JO.warmup_cosine(**SCHED))
    st = JO.AdamWState(count=jnp.zeros((), jnp.int32),
                       mu=jax.tree.map(jnp.zeros_like, jp),
                       nu=jax.tree.map(jnp.zeros_like, jp))
    after, _, jm = jopt.update(g, st, jp)
    return float(l_acc / accum), g, after, float(jm["lr"])


def _jax_serve(job, key):
    """The JAX engine's stream on the job's prompts (paged), or its
    `generate(frontend=)` on the job's rows, under the fp32 policy."""
    cfg = job["jcfgs"][key]
    jp = jax.tree.map(jnp.asarray, job["params"][key])
    with use_policy(FP32_J):
        if key in job["generate"]:
            toks, fe, n = job["generate"][key]
            eng = JEngine(cfg, jp, batch=2, cache_len=32, eos_id=-1,
                          sync_every=3)
            return np.asarray(eng.generate(jnp.asarray(toks), n,
                                           frontend=jnp.asarray(fe)))
        eng = JEngine(cfg, jp, batch=2, cache_len=32, eos_id=-1,
                      sync_every=2, kv_layout="paged", page_size=8)
        sched = JSched(2, eos_id=-1)
        for p, n in job["prompts"][key]:
            sched.submit(p, max_new_tokens=n)
        eng.serve(sched)
        return {r.rid: list(r.tokens) for r in sched.finished}


# each spawned process: its steps (arch key, accums), then its serves;
# split so that each takes about as long as the others (op by op, a
# reduced step with attention takes 15-40 s on two threads)
JAX_TASKS = ((("hymba_h5", (1, 2)), ("mamba2", (1, 2))),
             (("hymba", (1, 2)), ("pixtral", (1, 2))),
             (("whisper", (1, 2)), ("serve", ("mamba2", "hymba", "whisper"))))


def _jax_refs(rank: int, n: int, root: str):
    with open(os.path.join(root, "job.pkl"), "rb") as f:
        job = pickle.load(f)
    out = {}
    for key, what in JAX_TASKS[rank]:
        if key == "serve":
            for k in what:
                out[("jax_serve", k)] = _jax_serve(job, k)
            continue
        jp = jax.tree.map(jnp.asarray, job["params"][key])
        order = _order(job["cfgs"][key], job["params"][key])
        for accum in what:
            loss, g, after, lr = _jax_step(job["jcfgs"][key], jp,
                                           job["batch"][key], accum)
            out[(key, accum, "jax")] = {
                "loss": loss, "grads": order(jax.tree.map(np.asarray, g)),
                "after": order(jax.tree.map(np.asarray, after)), "lr": lr}
    with open(os.path.join(root, f"{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)


def _references(job):
    """While the world and the JAX processes run: the port's one-process
    fp32 steps, streams, `generate()`s, driver runs and mixers."""
    refs = {}
    for key in CASES:
        cfg, np_params = job["cfgs"][key], job["params"][key]
        for accum in (1, 2):
            refs[(key, accum, "fp32")] = _one_process(
                cfg, np_params, job["batch"][key], accum)
        params = params_from_numpy(np_params, "cpu")
        if key in job["generate"]:
            toks, fe, n = job["generate"][key]
            with TP.use_policy(FP32_T):
                eng = ServeEngine(cfg, params, batch=2, cache_len=32,
                                  eos_id=-1, sync_every=3, device="cpu")
                refs[("generate", key)] = eng.generate(
                    torch.from_numpy(toks), n, frontend=torch.from_numpy(fe))
        else:
            refs[("engine", key)] = {
                k: v[0] for k, v in engine_streams(
                    cfg, params, None, ("paged", "ring"),
                    prompts=job["prompts"][key], cache_len=32).items()}
        if key in job["runs"]:
            with TP.use_policy(FP32_T):
                refs[("driver", key)] = drv.main(job["runs"][key]["run"],
                                                 params=params)
    for key, (cfg, p, x, state, tail) in job["mixer"].items():
        p = {k: torch.from_numpy(v.copy()) for k, v in p.items()}
        with TP.use_policy(FP32_T):
            for name, xs, st, tl in (
                    ("chunked", torch.from_numpy(x), None, None),
                    ("decode", torch.from_numpy(x[:, :1]),
                     torch.from_numpy(state), torch.from_numpy(tail))):
                proj = TS.sa_dot(xs.reshape(-1, cfg.d_model), p["in_proj"])
                y, (new_state, _) = TS.mamba2_block(xs, p, cfg, state=st,
                                                    conv_cache=tl)
                refs[("mixer", key, name)] = (proj, y, new_state)
    return refs


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    base = str(tmp_path_factory.mktemp("family_tp"))
    job = _job()
    ctx = [_spawn(R.train_world, os.path.join(base, "world"), 4, job)]
    jdir = os.path.join(base, "jax")
    ctx.append(_spawn(_jax_refs, jdir, len(JAX_TASKS), job))
    refs = _references(job)
    for c in ctx:
        _join(c)
    for i in range(len(JAX_TASKS)):
        with open(os.path.join(jdir, f"{i}.pkl"), "rb") as f:
            refs.update(pickle.load(f))
    wdir = os.path.join(base, "world")
    ranks = [torch.load(os.path.join(wdir, f"rank{r}.pt"))
             for r in range(4)]
    return {"job": job, "refs": refs, "ranks": ranks, "root": wdir}


def _step_of(worlds, key, shape, accum, fmt):
    # the mesh's first rank saved it (ranks 2-3 hold the second pair)
    first = 2 if shape == (1, 2) and key in R.PAIR_ARCHS[(2, 3)] else 0
    return worlds["ranks"][first]["steps"][(key, shape, accum, fmt)]


# ---------------------------------------------------------------------------
# (a) the sharded train step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("accum", [1, 2])
@pytest.mark.parametrize("key,shape", STEPS)
def test_family_sharded_step_matches_jax(worlds, key, shape, accum):
    """The sharded step (bf16 policy, the `cuda` backend's SA GEMM
    Function; whisper and pixtral with their stub frontends) against the
    JAX unsharded step op by op on the same weights and global batch:
    loss, every gathered gradient leaf, the parameters after AdamW."""
    got = _step_of(worlds, key, shape, accum, "bf16")
    want = worlds["refs"][(key, accum, "jax")]
    assert abs(got["loss"] - want["loss"]) <= REL_LOSS * abs(want["loss"])
    rel = _rel(got["grads"], want["grads"])
    assert len(rel) == len(want["grads"]) and max(rel) <= REL_GRAD, rel
    for a, b in zip(got["after"], want["after"]):
        np.testing.assert_allclose(a.numpy(), b, rtol=0,
                                   atol=2 * want["lr"])


@pytest.mark.parametrize("accum", [1, 2])
@pytest.mark.parametrize("key,shape", STEPS)
def test_family_sharded_step_matches_one_process_fp32(worlds, key, shape,
                                                      accum):
    """Under the fp32 policy the sharded step's loss is the port's
    one-process step's within 1e-5 relative and its gathered gradients
    within 2⁻⁶ of each leaf's norm."""
    got = _step_of(worlds, key, shape, accum, "fp32")
    want = worlds["refs"][(key, accum, "fp32")]
    assert abs(got["loss"] - want["loss"]) <= REL_FP32_LOSS * abs(
        want["loss"])
    rel = _rel(got["grads"], want["grads"])
    assert len(rel) == len(want["grads"]) and max(rel) <= REL_FP32_GRAD, rel


@pytest.mark.parametrize("key,shape", STEPS)
def test_family_replicated_leaves_bit_identical(worlds, key, shape):
    """Every replicated leaf (norms, the reduced vocabulary of 503, what
    the guard leaves whole: hymba_h5's in_proj, A_log and dt_bias at 4)
    holds the same bits on every rank of the model axis after the step."""
    for accum in (1, 2):
        for fmt in ("bf16", "fp32"):
            assert _step_of(worlds, key, shape, accum, fmt)["same"]


def test_family_checkpoint_restores_in_one_process(worlds):
    """mamba2's checkpoint saved at (1, 2) (the mixer's pieces gathered
    whole) restores in one process and holds the (1, 2) step's
    parameters bit for bit."""
    from repro_torch.train import checkpoint as CKPT
    from repro_torch.train import optimizer as TO
    from repro_torch.train.train_state import TrainState
    job = worlds["job"]
    params = params_from_numpy(job["params"]["mamba2"], "cpu",
                               dtype=torch.float32)
    opt = TO.AdamW(schedule=TO.constant_lr(1e-3))
    target_state = TrainState(step=torch.zeros((), dtype=torch.int32),
                              params=params, opt_state=opt.init(params))
    whole, _, step = CKPT.restore(os.path.join(worlds["root"], "ckpt"),
                                  target_state)
    leaves = [x.detach() for x in TM.tree_leaves(whole)]
    assert step == 1
    after = _step_of(worlds, "mamba2", (1, 2), 1, "bf16")["after"]
    assert len(after) == len(TM.tree_leaves(whole.params))
    for a, b in zip(TM.tree_leaves(leaves[1:1 + len(after)]), after):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))


# ---------------------------------------------------------------------------
# (b) the Mamba2 mixer alone, and the layouts
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["chunked", "decode"])
@pytest.mark.parametrize("key,shape", [("mamba2", (1, 2)),
                                       ("mamba2", (1, 4)),
                                       ("hymba_h5", (1, 4))])
def test_mixer_on_the_mesh_matches_one_process(worlds, key, shape, name):
    """The mixer on the rank's pieces (the chunked scan from a zero state,
    and a decode step from a state and conv tail): in_proj's gathered
    output and the new state the one-process bits, the output within R1's
    bound, every rank the same bits."""
    ranks = [0, 1] if shape == (1, 2) else [0, 1, 2, 3]
    proj, y, state = worlds["refs"][("mixer", key, name)]
    for r in ranks:
        got = worlds["ranks"][r]["mixer"][(key, shape)][name]
        assert got["same"]
        assert torch.equal(R._bits(got["in_proj"]), R._bits(proj))
        assert torch.equal(R._bits(got["state"]), R._bits(state))
        err = float((got["out"] - y).abs().max())
        assert err <= R1 * float(y.abs().max())


def test_mixer_pieces_follow_the_sharding_rules(worlds):
    """What a rank of (1, 4) holds of the mixer: mamba2's in_proj cut by
    columns (296 / 4) and A_log by heads (8 / 4); hymba_h5's in_proj
    (290 columns) and A_log, dt_bias (2 heads) whole, its conv_w, D_skip,
    norm_w and out_proj cut."""
    m = worlds["ranks"][1]["mixer"][("mamba2", (1, 4))]["cut"]
    h = worlds["ranks"][1]["mixer"][("hymba_h5", (1, 4))]["cut"]
    assert m["in_proj"] == (64, 74) and m["A_log"] == (2,)
    assert h["in_proj"] == (64, 290) and h["A_log"] == (2,)
    assert h["dt_bias"] == (2,) and h["conv_w"] == (4, 40)
    assert h["D_skip"] == (32,) and h["out_proj"] == (32, 64)


@pytest.mark.parametrize("key,shape", [("mamba2", (1, 2)),
                                       ("mamba2", (1, 4)),
                                       ("hymba", (1, 4))])
def test_ssm_cache_is_whole_on_every_rank(worlds, key, shape):
    """The engine's pool on a rank: the SSM state (n_super, B, H, P, N)
    and conv tail (n_super, B, 3, din + 2N) whole (the gather layout),
    where `cache_specs` (the JAX package's rule) cuts the state on P and
    the tail on its channels; hymba's KV pools hold the rank's share of
    its padded KV heads."""
    cfg = worlds["job"]["cfgs"][key]
    tp = shape[1]
    got = worlds["ranks"][0]["serve"][(key, shape)]["cache"]
    whole = TM.init_cache(cfg, 2, 32, dtype=torch.float32, device="meta",
                          paged=(9, 8))
    want = {}
    S.tree_map_with_path(lambda p, x: want.__setitem__(
        "/".join(map(str, p)), tuple(x.shape)), whole)
    specs = S.cache_specs(cfg, whole, MeshSpec(("data", "model"),
                                               (1, tp)), 2)
    cut = {}
    S.tree_map_with_path(lambda p, sp: cut.__setitem__(
        "/".join(map(str, p)), tuple(sp)), specs,
        is_leaf=lambda x: isinstance(x, S.P))
    for path, shp in got.items():
        if "/ssm/" in path:
            assert shp == want[path]
            assert "model" in cut[path]          # the JAX rule's cut
        elif path.endswith("/k"):
            assert shp[-2] == padded_kvh(cfg.num_kv_heads, tp) // tp


def test_hymba_h5_pads_five_kv_heads_to_eight(worlds):
    """hymba_h5 at (1, 4): every rank's pools hold 2 of 8 padded KV heads,
    and `param_specs` leaves in_proj, A_log and dt_bias whole."""
    cfg = worlds["job"]["cfgs"]["hymba_h5"]
    assert padded_kvh(cfg.num_kv_heads, 4) == 8
    p = TM.init_params(cfg, device="meta", dtype=torch.float32)
    sp = S.param_specs(cfg, p, MeshSpec(("data", "model"), (1, 4)))
    ssm = sp["layers"][0]["ssm"]
    assert not S.is_sharded(ssm["in_proj"], MeshSpec(("data", "model"),
                                                     (1, 4)))
    assert tuple(ssm["A_log"]) == tuple(ssm["dt_bias"]) == (None, None)
    for r in range(4):
        got = worlds["ranks"][r]["serve"][("hymba_h5", (1, 4))]["cache"]
        assert {shp[-2] for path, shp in got.items()
                if path.endswith("/k")} == {2}
        assert got["0/ssm/0"][2:] == (2, 64, 16)


# ---------------------------------------------------------------------------
# (c) serving on the model axis
# ---------------------------------------------------------------------------

SSM_SERVES = [("mamba2", (1, 2)), ("mamba2", (1, 4)), ("hymba", (1, 2)),
              ("hymba", (1, 4)), ("hymba_h5", (1, 4))]


def _serve_ranks(worlds, key, shape):
    if shape == (1, 4):
        return [0, 1, 2, 3]
    return [2, 3] if key in R.PAIR_ARCHS[(2, 3)] else [0, 1]


@pytest.mark.parametrize("layout", ["paged", "ring"])
@pytest.mark.parametrize("key,shape", SSM_SERVES)
def test_ssm_stream_on_the_mesh_equals_one_process(worlds, key, shape,
                                                   layout):
    """Three requests over two slots (a refill) on the mesh: every rank
    the one-process stream, paged (hymba's pools, local rings and SSM
    rows; mamba2 on rows) and ring alike, no non-finite logit."""
    want = worlds["refs"][("engine", key)][layout]
    for r in _serve_ranks(worlds, key, shape):
        streams, leaked, nonfinite = worlds["ranks"][r]["serve"][
            (key, shape)]["engine"][layout]
        assert streams == want and nonfinite == 0
        assert leaked in (0, None)


@pytest.mark.parametrize("key", ["mamba2", "hymba"])
def test_ssm_one_process_stream_is_the_jax_engine_s(worlds, key):
    """The one-process stream the mesh is held to is the JAX engine's on
    the same weights (paged, fp32 policy)."""
    assert worlds["refs"][("engine", key)]["paged"] == \
        worlds["refs"][("jax_serve", key)]


@pytest.mark.parametrize("key", ["mamba2", "hymba"])
def test_one_rank_mesh_gives_the_one_process_stream(worlds, key):
    got = worlds["ranks"][0]["one_rank"][key]["engine"]
    for layout in ("paged", "ring"):
        assert got[layout][0] == worlds["refs"][("engine", key)][layout]


@pytest.mark.parametrize("key,shape", [("whisper", (1, 2)),
                                       ("whisper", (1, 4)),
                                       ("pixtral", (1, 2)),
                                       ("pixtral", (1, 4))])
def test_frontend_generate_on_the_mesh(worlds, key, shape):
    """`generate(frontend=)` on the mesh: every rank the one-process
    tokens (whisper's frames re-encoded every step over the rank's heads,
    its cross-attention over the rank's heads of the encoder's K and V;
    pixtral's ring of patches and prompt on the rank's heads), no
    non-finite logit; whisper's are the JAX engine's."""
    want = worlds["refs"][("generate", key)]
    for r in _serve_ranks(worlds, key, shape):
        got = worlds["ranks"][r]["serve"][(key, shape)]
        assert torch.equal(got["generate"], want) and got["nonfinite"] == 0
    if key == "whisper":
        assert want.numpy().tolist() == \
            worlds["refs"][("jax_serve", "whisper")].tolist()


@pytest.mark.parametrize("key", ["mamba2", "pixtral"])
def test_driver_on_the_mesh_gives_the_one_process_digest(worlds, key):
    """`launch.serve.main --model-parallel 4` on each rank's shards:
    mamba2's continuous stream and pixtral's static waves (the same
    seeded patches on every rank) give the one-process driver's digest;
    each reports its per-token decode time (the static waves: a wave's
    decode time over its lock-step steps)."""
    want = worlds["refs"][("driver", key)]
    assert want["decode_itl_p50_ms"] > 0
    for r in range(4):
        got = worlds["ranks"][r]["serve"][(key, (1, 4))]["driver"]["run"]
        assert "error" not in got, got
        assert got["digest"] == want["stream_digest"]
        assert got["summary"]["requests"] == 4
        assert got["summary"]["nonfinite_logits"] == 0
        assert got["summary"]["decode_itl_p50_ms"] > 0


def test_whisper_padding_logits_masked_on_the_last_rank(worlds):
    """whisper's vocabulary of 3500 padded to 4096 over 4 ranks: only the
    last rank's columns 3500-4095 (its local 428-1023) are -inf, every
    other logit finite."""
    for r in range(4):
        c = worlds["ranks"][r]["columns"]
        assert c["rank"] == r and c["n"] == 1024 and c["finite_elsewhere"]
        want = list(range(3500 - 3072, 1024)) if r == 3 else []
        assert c["masked"] == want


# ---------------------------------------------------------------------------
# (d) no world: the rules, the shards, the refusals, the launchers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("key,tp", [("mamba2", 2), ("mamba2", 4),
                                    ("hymba_h5", 4), ("whisper", 4),
                                    ("pixtral", 2)])
def test_family_init_params_on_a_mesh_are_the_one_process_shards(
        monkeypatch, key, tp):
    """`init_params(mesh=)` gives each rank `shard_tree` of the one-process
    tree bit for bit: the mixer's leaves cut or whole by the guard, the
    encoder's and cross-attention's matrices, the padded vocabulary."""
    cfg = _cfgs(key)[1]
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


@pytest.mark.parametrize("arch", [MAMBA2, HYMBA, WHISPER, PIXTRAL])
def test_check_parallel_admits_the_families(arch):
    """Tensor parallelism at 2 and 4 is admitted for training and
    serving, and serving over a data axis too (ROADMAP 7b); a paged pool
    where the data axis does not divide the batch stays refused, except
    for mamba2, which has no KV to page (its engine serves on rows)."""
    cfg = get_config(arch)
    for tp in (2, 4):
        TM.check_parallel(cfg, tp)
        TM.check_parallel(cfg, tp, serving=True)
        TM.check_parallel(cfg, tp, 2)
        TM.check_parallel(cfg, tp, 2, serving=True, batch=2,
                          kv_layout="paged")
    if arch == MAMBA2:
        TM.check_parallel(cfg, 2, 2, serving=True, batch=1,
                          kv_layout="paged")
    else:
        with pytest.raises(ValueError, match="data axis"):
            TM.check_parallel(cfg, 2, 2, serving=True, batch=1,
                              kv_layout="paged")


@pytest.mark.parametrize("arch,calls", [(MAMBA2, 5), (HYMBA, 19),
                                        (WHISPER, 49), (PIXTRAL, 15)])
def test_gemm_calls_of_a_rank_are_the_one_process_count(arch, calls):
    """Every GEMM of these families runs on the rank's piece (or whole
    where the guard leaves it), so a rank's count at 2 and 4 is one
    process's: 2 layers a stack (whisper: 2 decoder and 4 encoder
    layers)."""
    cfg = dataclasses.replace(get_config(arch), num_layers=2)
    assert TM.gemm_calls(cfg) == calls
    assert TM.gemm_calls(cfg, tp=2) == TM.gemm_calls(cfg, tp=4) == calls


def test_train_driver_feeds_frontends_and_zero_grads_without():
    """The training driver with `--frontend` trains whisper on seeded stub
    frames (finite losses); without it the encoder and cross-attention,
    which the loss does not reach, get zero gradients (as jax.grad gives
    them) and the step still runs."""
    argv = ["--arch", WHISPER, "--reduced", "--device", "cpu", "--steps",
            "2", "--batch", "2", "--seq", "16"]
    with_fe, _ = trn.run(reduced_config(WHISPER), trn.parse_args(
        argv + ["--frontend"]))
    without, hist = trn.run(reduced_config(WHISPER), trn.parse_args(argv))
    assert all(np.isfinite(h["loss"]) for h in hist)
    enc = TM.tree_leaves(without.params["encoder"])
    first = TM.init_params(reduced_config(WHISPER), seed=0, device="cpu",
                           dtype=torch.float32)
    # AdamW's decay alone moves a weight with a zero gradient
    for a, b in zip(enc, TM.tree_leaves(first["encoder"])):
        assert torch.allclose(a.detach(), b, rtol=1e-2, atol=1e-6)
    moved = max(float((a.detach() - b).abs().max()) for a, b in zip(
        TM.tree_leaves(with_fe.params["encoder"]),
        TM.tree_leaves(first["encoder"])))
    assert moved > 1e-5


def test_train_routing_gate_fails_a_planted_wrong_expert():
    """chip_smoke's gate on a training run's free routing (steps 1-2 of
    granite on the mesh against one process): a step that routes alike
    reads None; a token routed to another expert at a near tie (its
    probabilities traded within twice their spread) passes; a planted
    wrong expert where both sides' probabilities agree fails, as does a
    spread past R1's bound."""
    import importlib.util
    import pathlib

    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    probs = torch.tensor([[[0.40, 0.30, 0.2999, 0.0001],
                           [0.70, 0.20, 0.06, 0.04]]])
    idx = torch.tensor([[[0, 1], [0, 1]]])
    one = [[(idx, probs)], [(idx, probs)]]
    got, problems = cs._train_routing_gate(torch, one, one, 2, "same")
    assert got == [None, None] and not problems
    # step 2: expert 2 for expert 1 at a near tie, the probabilities
    # traded by 1.5e-4 at a margin of 1e-4
    tie = probs.clone()
    tie[0, 0, 1:3] = torch.tensor([0.29995, 0.30005])
    near = [[(idx, probs)], [(torch.tensor([[[0, 2], [0, 1]]]), tie)]]
    got, problems = cs._train_routing_gate(torch, one, near, 2, "tie")
    assert not problems and got[0] is None and got[1]["tokens"] == 1
    # a planted wrong expert: token 1 sent to expert 3, the same
    # probabilities on both sides
    wrong = [[(torch.tensor([[[0, 1], [0, 3]]]), probs.clone())],
             [(idx, probs)]]
    got, problems = cs._train_routing_gate(torch, one, wrong, 2, "x")
    assert len(problems) == 1 and "routed otherwise" in problems[0]
    assert got[0]["call"] == 0 and got[0]["tokens"] == 1
    # probabilities that part past R1's bound
    wide = probs.clone()
    wide[0, 1, 0] -= 0.1
    far = [[(torch.tensor([[[0, 1], [0, 2]]]), wide)], [(idx, probs)]]
    _, problems = cs._train_routing_gate(torch, one, far, 2, "x")
    assert any("above R1's" in p for p in problems)
    # a mesh run that recorded another number of router calls
    _, problems = cs._train_routing_gate(torch, one, [[], [(idx, probs)]],
                                         2, "x")
    assert any("router calls" in p for p in problems)
