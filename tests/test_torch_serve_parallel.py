"""PyTorch port, serving under the `model` axis of a ("data", "model")
mesh (tensor parallelism; the dense family) against the JAX package and
the port's one-process engine on the CPU.

Padded KV caches in one process (`init_cache(kv_pad_to=)`): the leaves
equal the JAX package's; the forward over a padded cache equals the JAX
forward over its padded cache at tests/test_torch_model.py's bounds
(logits within 2⁻⁵·max|logit|, K/V within 2⁻⁵·max|K|), the padded heads'
rows exactly zero; the engine's padded stream is the unpadded one.

The tensor-parallel runs are spawned gloo worlds
(tests/_torch_serve_parallel_ranks.py, a `FileStore` under the test's
temporary directory): a world of 2 serves reduced qwen2.5-14b at (1, 2)
(its 2 KV heads aligned: one a rank) through the driver, unified,
`--disagg`, `--kv ring`, then on a stream arriving at a rate with each
rank reading a clock of its own, then the page handoff; a world of 4
serves it at (1, 4) (2 KV heads padded to 4) and runs the handoff there;
the world of 2 then serves reduced gemma3 (local rings beside the pools)
at (1, 2). Every rank's stream must be the same, and equal to the JAX
engine's on the same weights under the fp32 policy at prompt seed 1
(ROADMAP R1: the row-parallel sums reassociate fp32, which parts streams
only at near-tie argmaxes, as the port's one-process stream parts from
the JAX engine's). The handoff (the scatter and bind of a whole fragment
put through `reshard_handoff` into each rank's pool piece) equals the
JAX engine's unsharded `_insert_impl` bit for bit: the assertions of
tests/test_sharded.py's handoff test, without a JAX mesh of 8 devices.
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
from repro.launch import serve as jdrv  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.serve.engine import ServeEngine as JEngine  # noqa: E402
from repro.serve.scheduler import SlotScheduler as JSched  # noqa: E402
from repro_torch.configs import get_config, reduced_config  # noqa: E402
from repro_torch.core import precision as TP  # noqa: E402
from repro_torch.launch import serve as drv  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models.convert import (cache_from_numpy,  # noqa: E402
                                        params_from_numpy)
from repro_torch.parallel import sharding as S  # noqa: E402
from repro_torch.parallel.mesh import MeshSpec  # noqa: E402
from repro_torch.serve.engine import ServeEngine  # noqa: E402
from repro_torch.serve.scheduler import SlotScheduler  # noqa: E402

import _torch_serve_parallel_ranks as R  # noqa: E402

torch.set_num_threads(2)
REL = 2.0 ** -5
FP32_J = PrecisionPolicy(input_format="fp32")
FP32_T = TP.PrecisionPolicy(input_format="fp32")
QWEN, GEMMA3, PHI3 = "qwen2.5-14b", "gemma3-12b", "phi3-medium-14b"
# the driver's stream (tests/test_torch_disagg.py's): seed 1, a shared
# 8-token system prompt on 8-token pages
DRV = ["--arch", QWEN, "--reduced", "--device", "cpu", "--batch", "2",
       "--requests", "5", "--max-new", "4", "--prompt-lens", "6,10",
       "--rate", "0", "--seed", "1", "--prefix-mix", "0.8", "--prefix-len",
       "8", "--page-size", "8"]


def _cfg(arch):
    return dataclasses.replace(j_reduced(arch), remat=False)


def _weights(arch):
    jp = JM.init_params(jax.random.key(1), _cfg(arch))
    return jp, jax.tree.map(np.asarray, jp)


def _prompts(cfg, lens, seed=1):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab_size, n).tolist() for n in lens]


# ---------------------------------------------------------------------------
# (a) padded caches: the JAX package's leaves, and a rank's share of them
# ---------------------------------------------------------------------------

def _shapes(tree):
    out = []
    S.tree_map_with_path(lambda p, x: out.append(
        ("/".join(map(str, p)), tuple(x.shape), str(x.dtype).split(".")[-1])),
        tree)
    return sorted(out)


@pytest.mark.parametrize("paged", [None, (9, 8)])
@pytest.mark.parametrize("arch", [QWEN, PHI3, GEMMA3])
def test_padded_cache_leaves_equal_jax(arch, paged):
    """`init_cache(kv_pad_to=4)`: every leaf's path, shape and type are
    the JAX package's (2 KV heads padded to 4; gemma3's local rings
    beside the pools), and `kv_shards=4` gives the shapes `shard_leaf`
    cuts from it by `cache_specs` on a (1, 4) mesh."""
    jc = JM.init_cache(_cfg(arch), 2, 32, dtype=jnp.float32, paged=paged,
                       kv_pad_to=4)
    tcfg = reduced_config(arch)
    tc = TM.init_cache(tcfg, 2, 32, dtype=torch.float32, device="cpu",
                       paged=paged, kv_pad_to=4)
    want = []
    jax.tree_util.tree_map_with_path(
        lambda p, x: want.append((_jpath(p), tuple(x.shape),
                                  str(x.dtype))), jc)
    assert _shapes(tc) == sorted(want)
    assert {c["kv"].k.shape[-2] for c in tc} == {4}
    mesh = MeshSpec(("data", "model"), (1, 4))
    specs = S.cache_specs(tcfg, tc, mesh, 2)
    for r in range(4):
        cut = S.shard_tree(tc, specs, mesh, {"data": 0, "model": r})
        mine = TM.init_cache(tcfg, 2, 32, dtype=torch.float32,
                             device="cpu", paged=paged, kv_pad_to=4,
                             kv_shards=4)
        assert _shapes(mine) == _shapes(cut)


def _jpath(p):
    return "/".join(str(getattr(k, "key", getattr(k, "idx",
                                                  getattr(k, "name", k))))
                    for k in p)


# ---------------------------------------------------------------------------
# (b) the forward over a padded cache against the JAX package's
# ---------------------------------------------------------------------------

def _check_logits(ref, got, vocab):
    ref, got = np.asarray(ref), got.numpy()
    r, g = ref[..., :vocab], got[..., :vocab]
    bound = REL * np.abs(r).max()
    assert np.abs(r - g).max() <= bound
    top2 = np.sort(r, axis=-1)[..., -2:]
    decided = (top2[..., 1] - top2[..., 0]) > 2 * bound
    assert (r.argmax(-1) == g.argmax(-1))[decided].all()


@pytest.mark.parametrize("layout", ["paged", "ring"])
@pytest.mark.parametrize("arch", [QWEN, GEMMA3])
def test_forward_over_padded_cache_matches_jax(arch, layout):
    """A batch-1 prompt prefilled into a padded dense fragment, spliced
    into slot 1 of a padded pool (or ring), then two decode steps of both
    slots: each step's logits and the cache's K/V against the JAX
    package's, the padded heads' rows exactly zero."""
    cfg = _cfg(arch)
    tcfg = dataclasses.replace(reduced_config(arch), remat=False)
    jp, npp = _weights(arch)
    tp = params_from_numpy(npp, "cpu")
    prompt = _prompts(cfg, (11,))[0]
    psz, seq = 8, 32
    paged = (9, psz) if layout == "paged" else None
    with use_policy(FP32_J):
        _, jfrag, _ = JM.forward(
            jp, cfg, jnp.asarray(prompt, jnp.int32)[None], last_only=True,
            cache=JM.init_cache(cfg, 1, 16 if paged else seq,
                                dtype=jnp.float32, kv_pad_to=4))
        jc = JM.init_cache(cfg, 2, seq, dtype=jnp.float32, paged=paged,
                           kv_pad_to=4)
        row = np.full((seq // psz,), -1, np.int32)
        row[:2] = [1, 2]
        jc = JEngine._insert_impl(jc, jfrag, 1,
                                  jnp.asarray(row) if paged else None,
                                  jnp.asarray(0, jnp.int32))
    tc = cache_from_numpy(jax.tree.map(np.asarray, jc), "cpu")
    pos = np.array([0, len(prompt)], np.int32)
    for step, tok in enumerate(([[3], [5]], [[7], [11]])):
        with use_policy(FP32_J):
            jl, jc, _ = JM.forward(jp, cfg, jnp.asarray(tok, jnp.int32),
                                   cache=jc, pos=jnp.asarray(pos + step))
        with TP.use_policy(FP32_T):
            tl, tc, _ = TM.forward(tp, tcfg, torch.tensor(tok,
                                                           dtype=torch.int32),
                                   cache=tc,
                                   pos=torch.from_numpy(pos + step),
                                   page_size=psz)
        _check_logits(jl, tl, cfg.vocab_size)
    kvh = cfg.num_kv_heads
    for j in range(cfg.stack_period):
        jkv, tkv = jc[j]["kv"], tc[j]["kv"]
        assert np.array_equal(np.asarray(jkv.positions), tkv.positions)
        for a, b in ((jkv.k, tkv.k), (jkv.v, tkv.v)):
            a = np.asarray(a)
            assert b.shape[-2] == 4
            assert np.abs(a - b.numpy()).max() <= REL * np.abs(a).max()
            assert not b[..., kvh:, :].any()


# ---------------------------------------------------------------------------
# (c) one process: a padded pool serves the unpadded stream
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("layout", ["paged", "ring"])
@pytest.mark.parametrize("arch", [QWEN, PHI3])
def test_padded_engine_serves_the_unpadded_stream(arch, layout):
    cfg = dataclasses.replace(reduced_config(arch), remat=False)
    params = TM.init_params(cfg, seed=0, device="cpu")
    prompts = _prompts(cfg, (12, 6, 14), seed=1)
    out = []
    for pad in (1, 4):
        eng = ServeEngine(cfg, params, batch=2, cache_len=32, eos_id=-1,
                          sync_every=2, kv_layout=layout, page_size=8,
                          device="cpu")
        # the caches a (1, 4) mesh's engine builds, whole in one process
        eng._heads = lambda pad=pad: {"kv_pad_to": pad, "kv_shards": 1}
        sched = SlotScheduler(2, eos_id=-1)
        for p, n in zip(prompts, (6, 3, 5)):
            sched.submit(p, max_new_tokens=n)
        eng.serve(sched)
        cache = eng.new_pool() if layout == "paged" else eng.new_cache()
        out.append((drv.stream_digest(sched.finished),
                    cache[0]["kv"].k.shape[-2]))
    assert out[0][0] == out[1][0]
    assert (out[0][1], out[1][1]) == (2, 4)


# ---------------------------------------------------------------------------
# the spawned worlds, run once for the module
# ---------------------------------------------------------------------------

WORLD_TIMEOUT_S = 240


def _handoff_case(cfg, jp, tp_size, seed):
    """A pool with recycled positions and a real prefill fragment, both
    padded to the axis, and the JAX engine's unsharded insert of it."""
    rng = np.random.default_rng(seed)
    psz, seq, n_pages = 8, 32, 12
    pool = JM.init_cache(cfg, 2, seq, dtype=jnp.float32,
                         paged=(n_pages, psz), kv_pad_to=tp_size)
    pool = jax.tree.map(
        lambda x: (jnp.asarray(rng.integers(0, 50, x.shape), x.dtype)
                   if x.dtype == jnp.int32 and x.ndim == 3
                   and x.shape[1] == n_pages else x), pool)
    prompt = jnp.asarray(_prompts(cfg, (19,), seed=seed)[0], jnp.int32)
    with use_policy(FP32_J):
        _, frag, _ = JM.forward(jp, cfg, prompt[None], last_only=True,
                                cache=JM.init_cache(cfg, 1, 24,
                                                    dtype=jnp.float32,
                                                    kv_pad_to=tp_size))
    row = np.full((seq // psz,), -1, np.int32)
    row[:3] = [2, 3, 4]
    ref = JEngine._insert_impl(pool, frag, 1, jnp.asarray(row),
                               jnp.asarray(0, jnp.int32))
    job = {"pool": jax.tree.map(np.asarray, pool),
           "frag": jax.tree.map(np.asarray, frag), "row": row, "slot": 1}
    return job, [np.asarray(x) for x in jax.tree.leaves(ref)]


def _spawn(root, world, job):
    os.makedirs(root)
    with open(os.path.join(root, "job.pkl"), "wb") as f:
        pickle.dump(job, f)
    return tmp_mp.start_processes(R.serve_world, args=(world, root),
                                  nprocs=world, join=False,
                                  start_method="spawn")


def _join(ctx):
    deadline = time.monotonic() + WORLD_TIMEOUT_S
    while not ctx.join(timeout=5):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            raise AssertionError("a spawned world did not finish")


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    base = str(tmp_path_factory.mktemp("tp_serve"))
    qcfg, gcfg = _cfg(QWEN), _cfg(GEMMA3)
    jq, nq = _weights(QWEN)
    jg, ng = _weights(GEMMA3)
    tq = reduced_config(QWEN)
    moe = ["--arch", "granite-moe-3b-a800m"] + DRV[2:]
    runs2 = {"unified": DRV, "disagg": DRV + ["--disagg",
                                              "--prefill-workers", "2"],
             "ring": DRV + ["--kv", "ring"],
             "data2": DRV + ["--model-parallel", "1"],
             "replicas": DRV + ["--model-parallel", "2", "--decode-replicas",
                                "2"],
             "spec_warmup": DRV + ["--model-parallel", "2", "--spec-warmup",
                                   "2"],
             "moe": moe + ["--model-parallel", "1"]}
    for k in ("unified", "disagg", "ring"):
        runs2[k] = runs2[k] + ["--model-parallel", "2"]
    runs4 = {"unified": DRV + ["--model-parallel", "4"],
             "disagg": DRV + ["--model-parallel", "4", "--disagg"]}
    handoff, refs = {}, {}
    for n in (2, 4):
        handoff[(1, n)], refs[n] = _handoff_case(qcfg, jq, n, seed=n)
    gprompts = _prompts(gcfg, (12, 6, 14), seed=1)
    gen_prompts = _prompts(qcfg, (7, 7), seed=1)
    gbudgets = (8, 3, 5)
    # two worlds side by side (6 ranks, as many as test_torch_parallel's)
    ctx = [
        _spawn(os.path.join(base, "qwen2"), 2,
               {"cfg": tq, "params": nq, "runs": runs2, "clocked": True,
                "whole_weights": ("data2",), "own_weights": ("moe",),
                "handoff": {(1, 2): handoff[(1, 2)]},
                "generate": (gen_prompts, 5),
                "engine": {"cfg": dataclasses.replace(
                    reduced_config(GEMMA3), remat=False), "params": ng,
                    "prompts": gprompts, "budgets": gbudgets}}),
        _spawn(os.path.join(base, "qwen4"), 4,
               {"cfg": tq, "params": nq, "runs": runs4,
                "handoff": {(1, 4): handoff[(1, 4)]}})]
    # the JAX side and the port's one process, while the ranks serve
    with use_policy(FP32_J):
        want = jdrv.main([a for a in DRV if a not in ("--device", "cpu")])
        jsched = JSched(2, eos_id=-1)
        jeng = JEngine(gcfg, jg, batch=2, cache_len=32, eos_id=-1,
                       sync_every=2, page_size=8)
        for p, n in zip(gprompts, gbudgets):
            jsched.submit(p, max_new_tokens=n)
        jeng.serve(jsched)
    gemma_ref = {r.rid: list(r.tokens) for r in jsched.finished}
    tparams = params_from_numpy(nq, "cpu")
    with TP.use_policy(FP32_T):
        one = drv.main(DRV, params=tparams)
        # granite's stream in one process, on the weights of `--seed`
        one_moe = drv.main(moe)
        clocked = _one_process_clocked(tq, tparams)
        generated = ServeEngine(tq, tparams, batch=2, cache_len=24,
                                eos_id=-1, sync_every=2,
                                device="cpu").generate(
            torch.tensor(gen_prompts), 5)
    for c in ctx:
        _join(c)
    res = {name: [torch.load(os.path.join(base, name, f"rank{r}.pt"))
                  for r in range(n)]
           for name, n in (("qwen2", 2), ("qwen4", 4))}
    return {"res": res, "jax_digest": want["stream_digest"],
            "one": one, "one_moe": one_moe, "refs": refs,
            "gemma_ref": gemma_ref,
            "clocked": clocked, "generated": generated}


def _one_process_clocked(cfg, params):
    """The clocked stream in one process on rank 0's clock."""
    ticks = [0.0]

    def clock():
        ticks[0] += 0.003
        return ticks[0]

    eng = ServeEngine(cfg, params, batch=2, cache_len=24, eos_id=-1,
                      sync_every=2, page_size=8, device="cpu")
    sched = SlotScheduler(2, eos_id=-1)
    drv.build_requests(sched, cfg, 6, 40.0, [6, 10], 4, seed=1)
    eng.serve(sched, clock=clock)
    return {"streams": {r.rid: list(r.tokens) for r in sched.finished},
            "times": {r.rid: (r.slot, r.t_admitted, r.t_first_token,
                              r.t_done) for r in sched.finished}}


# ---------------------------------------------------------------------------
# (d), (e), (i): the driver on the mesh
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("world,run", [("qwen2", "unified"),
                                       ("qwen2", "disagg"),
                                       ("qwen2", "ring"),
                                       ("qwen4", "unified"),
                                       ("qwen4", "disagg")])
def test_tp_stream_equals_jax_on_every_rank(worlds, world, run):
    """Every rank's digest is the same and equals the JAX driver's (and
    the port's one-process run's) on the same weights: aligned heads at
    (1, 2), 2 KV heads padded to 4 at (1, 4); `--disagg` and `--kv ring`
    give the unified digest."""
    ranks = [r["runs"][run] for r in worlds["res"][world]]
    digests = {r["digest"] for r in ranks}
    assert digests == {worlds["jax_digest"]} == {
        worlds["one"]["stream_digest"]}
    s = ranks[0]["summary"]
    assert s["requests"] == 5 and s["generated_tokens"] == 20
    assert s["nonfinite_logits"] == 0
    if run != "ring":
        assert s["pages_leaked"] == 0 and s["prefix_hits"] >= 1
    assert s["disagg"] is (run == "disagg")


def test_gemma3_on_the_mesh_equals_jax_engine(worlds):
    """Reduced gemma3 at (1, 2): the local rings beside the pools on the
    rank's KV heads; both ranks' paged and ring streams are the JAX
    engine's."""
    for rank in worlds["res"]["qwen2"]:
        for layout in ("paged", "ring"):
            streams, leaked, nonfinite = rank["engine"][layout]
            assert streams == worlds["gemma_ref"], layout
            assert nonfinite == 0 and (layout == "ring" or leaked == 0)


def test_launcher_lines_in_a_world_of_two(worlds):
    """The launcher in a world of 2 on the CPU: rank 0 prints the `[mesh]`
    line first and the `[continuous]` summary with the digest; each rank
    ends with one whole `[rank r]` line, every kernel call a plain call
    on the CPU."""
    for r, rank in enumerate(worlds["res"]["qwen2"]):
        lines = rank["runs"]["unified"]["stdout"].splitlines()
        mine = [ln for ln in lines if ln.startswith("[rank ")]
        assert len(mine) == 1 and mine[0].startswith(f"[rank {r}] ")
        fields = dict(kv.split("=", 1) for kv in mine[0].split()[2:])
        assert fields["stream_digest"] == worlds["jax_digest"]
        assert fields["peak_mem_gib"] == "n/a"
        assert int(fields["sa_matmul_launches"]) == 0
        assert int(fields["plain_calls"]) > 0
        summary = [ln for ln in lines if ln.startswith("[continuous] ")]
        if r == 0:
            assert lines[0] == ("[mesh] backend=gloo world=2 data=1 "
                                "model=2 device=cpu")
            assert len(summary) == 1
            assert f"stream_digest={worlds['jax_digest']}" in summary[0]
        else:
            assert not summary and not any(ln.startswith("[mesh]")
                                           for ln in lines)


def test_generate_on_the_mesh_is_the_one_process_batch(worlds):
    """`generate()` (one batched prefill into rings of the rank's heads,
    then chunked decode) at (1, 2): every rank's tokens are the
    one-process engine's."""
    for rank in worlds["res"]["qwen2"]:
        assert torch.equal(rank["generate"], worlds["generated"])
    assert worlds["generated"].shape == (2, 5)


# ---------------------------------------------------------------------------
# (f) one clock for every rank
# ---------------------------------------------------------------------------

def test_ranks_admit_alike_at_a_rate(worlds):
    """A stream arriving at 40 requests a second, each rank reading a
    clock of its own speed: every rank admits each request to the same
    slot at the same tick (rank 0's clock), and the streams and times are
    the one-process engine's on rank 0's clock."""
    ranks = [r["clocked"] for r in worlds["res"]["qwen2"]]
    assert ranks[0] == ranks[1]
    assert ranks[0]["times"] == worlds["clocked"]["times"]
    assert ranks[0]["streams"] == worlds["clocked"]["streams"]
    # the arrivals spread over the run: admissions at distinct ticks
    assert len({t[1] for t in ranks[0]["times"].values()}) > 2


# ---------------------------------------------------------------------------
# (g) the two-pool handoff on the rank's heads
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("world", ["qwen2", "qwen4"])
def test_handoff_reshard_bit_identical(worlds, world):
    """A whole fragment through `reshard_handoff` keeps this rank's heads;
    scattered and bound into each
    rank's pool piece and gathered by `cache_specs`, the pool equals the
    JAX engine's unsharded `_insert_impl` bit for bit, padded heads
    included (at (1, 4))."""
    n = 2 if world == "qwen2" else 4
    ref = worlds["refs"][n]
    for rank in worlds["res"][world]:
        h = rank["handoff"]
        assert set(h["frag_heads"]) == {1}
        assert len(h["pool"]) == len(ref)
        for a, b in zip(h["pool"], ref):
            assert np.array_equal(a.numpy().view(np.uint32)
                                  if a.dtype == torch.float32
                                  else a.numpy(),
                                  b.view(np.uint32)
                                  if b.dtype == np.float32 else b)


def test_reshard_handoff_is_the_identity_without_a_mesh():
    cfg = reduced_config(QWEN)
    frag = TM.init_cache(cfg, 1, 8, dtype=torch.float32, device="cpu")
    assert S.reshard_handoff(frag, None, cfg) is frag


# ---------------------------------------------------------------------------
# (h) refusals
# ---------------------------------------------------------------------------

def test_refusals_on_the_mesh(worlds):
    """Under a mesh the driver refuses by name `--decode-replicas` and
    `--spec-warmup`. A data axis above 1 is served (the dense and the MoE
    family alike, at (2, 1), each data rank its own slot from its own
    range of pages): the dense stream is the JAX driver's digest, the MoE
    stream the one-process driver's on the same `--seed` weights."""
    for rank in worlds["res"]["qwen2"]:
        runs = rank["runs"]
        assert "error" not in runs["data2"], runs["data2"]
        assert runs["data2"]["digest"] == worlds["jax_digest"]
        assert "error" not in runs["moe"], runs["moe"]
        assert runs["moe"]["digest"] == worlds["one_moe"]["stream_digest"]
        assert runs["moe"]["summary"]["pages_leaked"] == 0
        assert "--decode-replicas" in runs["replicas"]["error"]
        assert "--spec-warmup" in runs["spec_warmup"]["error"]


def test_serving_refuses_a_data_axis():
    """Serving over a data axis passes at (2, 2); a paged pool where the
    data axis does not divide the batch is refused by name, pointing to
    the ring layout, whose rows split over `data`."""
    TM.check_parallel(get_config(QWEN), 2, 2, serving=True, batch=4,
                      kv_layout="paged")
    TM.check_parallel(get_config(QWEN), 2, 2, serving=True, batch=3,
                      kv_layout="ring")
    with pytest.raises(ValueError, match="data axis"):
        TM.check_parallel(get_config(QWEN), 2, 2, serving=True, batch=3,
                          kv_layout="paged")
    TM.check_parallel(get_config(QWEN), 4, 1, serving=True)


def test_model_parallel_needs_a_launcher(monkeypatch):
    for var in ("WORLD_SIZE", "MASTER_ADDR", "RANK"):
        monkeypatch.delenv(var, raising=False)
    with pytest.raises(ValueError, match="world of ranks"):
        drv.main(DRV + ["--model-parallel", "2"])


def test_autotune_decode_is_refused_on_the_cpu_and_under_a_mesh():
    """`--autotune-decode` times the card's kernels: refused on the CPU
    before any mesh, and by name under one (`_serve_mesh`)."""
    with pytest.raises(ValueError, match="autotune"):
        drv.main(DRV + ["--autotune-decode"])


def test_init_params_on_a_mesh_are_the_one_process_shards(monkeypatch):
    """`init_params(mesh=)` draws the same numbers in the same order and
    keeps the rank's piece of each: `shard_tree` of the one-process tree,
    bit for bit, on every rank of a (1, 4) stand-in mesh (each rank's
    coordinates what `mesh_coords` would read on it)."""
    cfg = reduced_config(PHI3)
    whole = TM.init_params(cfg, seed=3, device="cpu")
    mesh = MeshSpec(("data", "model"), (1, 4))
    specs = S.param_specs(cfg, whole, mesh)
    for r in range(4):
        coords = {"data": 0, "model": r}
        monkeypatch.setattr(S, "mesh_coords", lambda _, c=coords: c)
        got = TM.init_params(cfg, seed=3, device="cpu", mesh=mesh)
        want = S.shard_tree(whole, specs, mesh, coords)
        for a, b in zip(TM.tree_leaves(got), TM.tree_leaves(want)):
            assert a.shape == b.shape and torch.equal(a, b)
