"""PyTorch port, serving over the `data` axis of a ("data", "model") mesh
against the JAX package and the port's one-process engine on the CPU.

Two spawned gloo worlds (tests/_torch_serve_data_ranks.py, a `FileStore`
under the test's temporary directory), side by side:

* a world of 2 at (data 2, model 1): the driver's stream (reduced
  qwen2.5-14b, seed 1, a shared system prompt on 8-token pages) unified,
  `--disagg` and `--kv ring`, each rank serving its own slot from its own
  range of pages; the batch-1 ring (`--batch 1 --kv ring`: every ring's
  rows split over `data`, the ranks' partial attentions folded by their
  log-sum-exps); a paged pool at batch 1, refused by name; reduced gemma3
  at batch 1 on rings (its local rings split too);
* a world of 4 at (2, 2): the driver's stream unified, `--disagg` and
  `--kv ring`; mamba2, hymba, granite and reduced llama4 with `cfg.fsdp`
  (its leaves cut over `data` and gathered a layer at a time) through the
  engine, whisper's and pixtral's `generate()`; sampled decoding (qwen
  through `serve`, unified, two-pool and on rings, and `generate()`);
  the page handoff.

The driver's streams are held to the JAX driver's digest under the fp32
policy (prompt seed 1, as tests/test_torch_serve_parallel.py: every row's
arithmetic is independent of the batch, so the data axis moves no
token); the batch-1 ring to the JAX engine's stream by R1's rule (the
fold adds fp32 in another order: tokens equal up to the first step whose
JAX top-two margin is within twice 2⁻⁵·max|logit|); the other families
to the port's one-process streams. In the test process: each rank's
cache leaves against `shard_leaf` of the one-process cache under
`cache_specs`, and the per-shard page allocator against the JAX
package's `PageAllocator`.
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
from repro.serve.scheduler import PageAllocator as JAlloc  # noqa: E402
from repro.serve.scheduler import SlotScheduler as JSched  # noqa: E402
from repro_torch.configs import reduced_config  # noqa: E402
from repro_torch.core import precision as TP  # noqa: E402
from repro_torch.launch import serve as drv  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.parallel import sharding as S  # noqa: E402
from repro_torch.parallel.mesh import MeshSpec  # noqa: E402
from repro_torch.serve.scheduler import (ShardedPageAllocator,  # noqa: E402
                                         SlotScheduler)

import _torch_serve_data_ranks as R  # noqa: E402
from _torch_parallel_ranks import engine_streams  # noqa: E402

torch.set_num_threads(2)
REL = 2.0 ** -5
FP32_J = PrecisionPolicy(input_format="fp32")
FP32_T = TP.PrecisionPolicy(input_format="fp32")
QWEN, GEMMA3 = "qwen2.5-14b", "gemma3-12b"
MAMBA2, HYMBA = "mamba2-2.7b", "hymba-1.5b"
GRANITE, LLAMA4 = "granite-moe-3b-a800m", "llama4-maverick-400b-a17b"
WHISPER, PIXTRAL = "whisper-tiny", "pixtral-12b"
# the driver's stream (tests/test_torch_serve_parallel.py's)
DRV = ["--arch", QWEN, "--reduced", "--device", "cpu", "--batch", "2",
       "--requests", "5", "--max-new", "4", "--prompt-lens", "6,10",
       "--rate", "0", "--seed", "1", "--prefix-mix", "0.8", "--prefix-len",
       "8", "--page-size", "8"]
# the batch-1 ring: two 40-token prompts one after another, a ring of 64
# rows split over `data`
B1 = ["--arch", QWEN, "--reduced", "--device", "cpu", "--batch", "1",
      "--requests", "2", "--max-new", "8", "--prompt-lens", "40",
      "--cache-len", "64", "--rate", "0", "--seed", "1", "--kv", "ring"]
WORLD_TIMEOUT_S = 300
# the engine runs of the world of 4: (arch, layouts, cfg overrides)
ENGINES = {"mamba2": (MAMBA2, ("ring",), {}),
           "hymba": (HYMBA, ("paged", "ring"), {}),
           "granite": (GRANITE, ("paged",), {}),
           "llama4_fsdp": (LLAMA4, ("paged",), {"fsdp": True})}
GENERATE = (WHISPER, PIXTRAL)
# sampled serving of qwen at (2, 2): (layouts, two-pool)
SAMPLED = {"qwen_sampled": (("paged", "ring"), False),
           "qwen_sampled_disagg": (("paged",), True)}
SAMPLE_SEED = 7


def _cfgs(arch, **kw):
    return (dataclasses.replace(j_reduced(arch), remat=False, **kw),
            dataclasses.replace(reduced_config(arch), remat=False, **kw))


def _weights(arch, seed=1):
    jcfg = dataclasses.replace(j_reduced(arch), remat=False)
    jp = JM.init_params(jax.random.key(seed), jcfg)
    return jp, jax.tree.map(np.asarray, jp)


def _prompts(cfg, lens, seed=1):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab_size, n).tolist() for n in lens]


def _spawn(root, world, job):
    os.makedirs(root)
    with open(os.path.join(root, "job.pkl"), "wb") as f:
        pickle.dump(job, f)
    return tmp_mp.start_processes(R.data_world, args=(world, root),
                                  nprocs=world, join=False,
                                  start_method="spawn")


def _join(ctx):
    deadline = time.monotonic() + WORLD_TIMEOUT_S
    while not ctx.join(timeout=5):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            raise AssertionError("a spawned world did not finish")


def _handoff_case(cfg, jp):
    """A (2, 2) handoff: a 12-page pool of 8-token pages (6 a data shard)
    with recycled positions, a real 19-token prefill fragment, spliced
    into slot 1 on pages 8-10 (slot 1's shard, the second) by the JAX
    engine's unsharded insert."""
    rng = np.random.default_rng(4)
    psz, seq, n_pages = 8, 64, 12
    pool = JM.init_cache(cfg, 2, seq, dtype=jnp.float32,
                         paged=(n_pages, psz))
    pool = jax.tree.map(
        lambda x: (jnp.asarray(rng.integers(0, 50, x.shape), x.dtype)
                   if x.dtype == jnp.int32 and x.ndim == 3
                   and x.shape[1] == n_pages else x), pool)
    prompt = jnp.asarray(_prompts(cfg, (19,), seed=4)[0], jnp.int32)
    with use_policy(FP32_J):
        _, frag, _ = JM.forward(jp, cfg, prompt[None], last_only=True,
                                cache=JM.init_cache(cfg, 1, 24,
                                                    dtype=jnp.float32))
    row = np.full((seq // psz,), -1, np.int32)
    row[:3] = [8, 9, 10]
    ref = JEngine._insert_impl(pool, frag, 1, jnp.asarray(row),
                               jnp.asarray(0, jnp.int32))
    job = {"pool": jax.tree.map(np.asarray, pool),
           "frag": jax.tree.map(np.asarray, frag), "row": row, "slot": 1,
           "psz": psz, "seq": seq, "pool_pages": n_pages}
    return job, [np.asarray(x) for x in jax.tree.leaves(ref)]


def _jax_b1(cfg, jp):
    """The batch-1 ring stream of the JAX engine (B1's requests) and, for
    R1's rule, each request's logits teacher-forced on its stream."""
    a = drv.parse_args(B1)
    plens = [int(x) for x in a.prompt_lens.split(",")]
    with use_policy(FP32_J):
        sched = JSched(1, eos_id=-1)
        jdrv.build_requests(sched, cfg, a.requests, a.rate, plens,
                            a.max_new, a.seed)
        JEngine(cfg, jp, batch=1, cache_len=a.cache_len, eos_id=-1,
                sync_every=a.sync_every, kv_layout="ring").serve(sched)
        out = {}
        for r in sched.finished:
            toks = jnp.asarray(list(r.prompt) + list(r.tokens), jnp.int32)
            logits, _, _ = JM.forward(jp, cfg, toks[None])
            rows = np.asarray(logits[0, len(r.prompt) - 1:-1,
                                     :cfg.vocab_size])
            out[r.rid] = (list(map(int, r.tokens)), rows)
    return out


@pytest.fixture(scope="module")
def data_worlds(tmp_path_factory):
    base = str(tmp_path_factory.mktemp("dp_serve"))
    qcfg, tq = _cfgs(QWEN)
    jq, nq = _weights(QWEN)
    runs = {"unified": DRV, "disagg": DRV + ["--disagg",
                                             "--prefill-workers", "2"],
            "ring": DRV + ["--kv", "ring"]}
    runs2 = {k: v + ["--model-parallel", "1"] for k, v in runs.items()}
    runs2 |= {"b1_ring": B1 + ["--model-parallel", "1"],
              "b1_paged": [a for a in B1 if a not in ("--kv", "ring")]
              + ["--kv", "paged", "--model-parallel", "1"]}
    runs4 = {k: v + ["--model-parallel", "2"] for k, v in runs.items()}
    # gemma3's batch-1 rings (its local rings of 8 rows split too)
    gcfg, tg = _cfgs(GEMMA3)
    _, ng = _weights(GEMMA3)
    gprompts = _prompts(gcfg, (12, 6), seed=1)
    engines2 = {"gemma3_b1": {"cfg": tg, "params": ng, "layouts": ("ring",),
                              "prompts": gprompts, "budgets": (6, 5),
                              "batch": 1}}
    engines4, prompts = {}, {}
    for key, (arch, layouts, kw) in ENGINES.items():
        jcfg, tcfg = _cfgs(arch, **kw)
        _, npar = _weights(arch)
        prompts[key] = [(p, b) for p, b in zip(
            _prompts(jcfg, (12, 6, 12), seed=1), (8, 3, 5))]
        engines4[key] = {"cfg": tcfg, "params": npar, "layouts": layouts,
                         "prompts": [p for p, _ in prompts[key]],
                         "budgets": [b for _, b in prompts[key]]}
    qprompts = [(p, b) for p, b in zip(_prompts(qcfg, (12, 6, 12), seed=1),
                                       (8, 3, 5))]
    for key, (layouts, disagg) in SAMPLED.items():
        prompts[key] = qprompts
        engines4[key] = {"cfg": tq, "params": nq, "layouts": layouts,
                         "prompts": [p for p, _ in qprompts],
                         "budgets": [b for _, b in qprompts],
                         "sample_seed": SAMPLE_SEED, "disagg": disagg}
    gen = {}
    rng = np.random.default_rng(5)
    for arch in GENERATE:
        jcfg, tcfg = _cfgs(arch)
        _, npar = _weights(arch)
        gen[arch] = {"cfg": tcfg, "params": npar, "cache_len": 24, "n": 7,
                     "prompts": rng.integers(0, jcfg.vocab_size,
                                             (2, 12)).tolist(),
                     "frontend": rng.standard_normal(
                         (2, jcfg.frontend_tokens, jcfg.d_model)).astype(
                             np.float32)}
    gen["sampled"] = {"cfg": tq, "params": nq, "cache_len": 24, "n": 7,
                      "prompts": rng.integers(0, qcfg.vocab_size,
                                              (2, 12)).tolist(),
                      "frontend": None, "sample_seed": SAMPLE_SEED}
    handoff, handoff_ref = _handoff_case(qcfg, jq)
    ctx = [_spawn(os.path.join(base, "d2"), 2,
                  {"cfg": tq, "params": nq, "model": 1, "runs": runs2,
                   "engines": engines2}),
           _spawn(os.path.join(base, "d4"), 4,
                  {"cfg": tq, "params": nq, "model": 2, "runs": runs4,
                   "engines": engines4, "generate": gen,
                   "handoff": handoff})]
    # the JAX side and the port's one process, while the ranks serve
    with use_policy(FP32_J):
        want = jdrv.main([a for a in DRV if a not in ("--device", "cpu")])
    b1_ref = _jax_b1(qcfg, jq)
    one = {}
    with TP.use_policy(FP32_T):
        tparams = params_from_numpy(nq, "cpu")
        one["driver"] = drv.main(DRV, params=tparams)
        one["gemma3_b1"] = engine_streams(
            tg, params_from_numpy(ng, "cpu"), None, ("ring",),
            prompts=list(zip(gprompts, (6, 5))), cache_len=32, batch=1)
        for key, e in engines4.items():
            one[key] = engine_streams(
                e["cfg"], params_from_numpy(e["params"], "cpu"), None,
                e["layouts"], prompts=prompts[key], cache_len=32,
                sample_seed=e.get("sample_seed"), disagg=e.get("disagg"))
        for key, g in gen.items():
            from repro_torch.serve.engine import ServeEngine
            seed = g.get("sample_seed")
            one[key] = ServeEngine(
                g["cfg"], params_from_numpy(g["params"], "cpu"), batch=2,
                cache_len=g["cache_len"], eos_id=-1, sync_every=2,
                kv_layout="ring", device="cpu").generate(
                torch.tensor(g["prompts"]), g["n"],
                frontend=(None if g["frontend"] is None
                          else torch.from_numpy(g["frontend"])),
                greedy=seed is None,
                rng=None if seed is None
                else torch.Generator().manual_seed(seed))
    for c in ctx:
        _join(c)
    res = {name: [torch.load(os.path.join(base, name, f"rank{r}.pt"))
                  for r in range(n)] for name, n in (("d2", 2), ("d4", 4))}
    return {"res": res, "jax_digest": want["stream_digest"], "one": one,
            "b1_ref": b1_ref, "handoff_ref": handoff_ref}


# ---------------------------------------------------------------------------
# the driver's streams
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("world,run", [(w, r) for w in ("d2", "d4")
                                       for r in ("unified", "disagg",
                                                 "ring")])
def test_data_axis_stream_equals_jax_on_every_rank(data_worlds, world, run):
    """At (2, 1) and (2, 2) every rank's digest equals the JAX driver's
    (and the port's one-process run's): each data rank serves its own
    slot, a paged pool from its own range of pages, and every rank's
    scheduler sees the whole batch's tokens. The summary is global and the
    same on every rank: every request served, no page leaked, the two
    shards' pages each used."""
    ranks = [r["runs"][run] for r in data_worlds["res"][world]]
    assert all("error" not in r for r in ranks), ranks[0]
    assert {r["digest"] for r in ranks} == {data_worlds["jax_digest"]} == {
        data_worlds["one"]["driver"]["stream_digest"]}
    assert len({tuple(sorted(r["summary"].items())) for r in ranks}) == 1
    s = ranks[0]["summary"]
    assert s["requests"] == 5 and s["generated_tokens"] == 20
    assert s["nonfinite_logits"] == 0
    assert s["kv_layout"] == ("ring" if run == "ring" else "paged")
    if run != "ring":
        assert s["pages_leaked"] == 0
    assert s["disagg"] is (run == "disagg")


def test_rank_lines_name_the_data_shard(data_worlds):
    """Each rank's closing line gives its data coordinate, its slot and
    its range of the pool's global page ids (the trash page first)."""
    for world, mp in (("d2", 1), ("d4", 2)):
        for r, rank in enumerate(data_worlds["res"][world]):
            lines = rank["runs"]["unified"]["stdout"].splitlines()
            mine = [ln for ln in lines if ln.startswith(f"[rank {r}] ")]
            assert len(mine) == 1
            fields = dict(kv.split("=", 1) for kv in mine[0].split()[2:])
            d = r // mp
            assert fields["data"] == str(d)
            assert fields["slots"] == f"{d}-{d}"
            lo, hi = (int(x) for x in fields["pages"].split(":")[0].split(
                "-"))
            assert hi - lo + 1 == (hi + 1) // (d + 1) and lo == d * (
                hi - lo + 1)
            if r == 0:
                assert lines[0] == (f"[mesh] backend=gloo world={2 * mp} "
                                    f"data=2 model={mp} device=cpu")


def test_batch_one_ring_holds_r1_against_jax(data_worlds):
    """The batch-1 ring at (2, 1): both ranks one stream (the fold gives
    every rank the same bits), held to the JAX engine's batch-1 ring by
    R1's rule: each request's tokens equal up to the first step whose JAX
    top-two margin is within twice 2⁻⁵·max|logit|."""
    ranks = [r["runs"]["b1_ring"] for r in data_worlds["res"]["d2"]]
    assert all("error" not in r for r in ranks), ranks[0]
    assert ranks[0]["streams"] == ranks[1]["streams"]
    assert ranks[0]["summary"]["nonfinite_logits"] == 0
    compared = 0
    for rid, (ref, logits) in data_worlds["b1_ref"].items():
        got = ranks[0]["streams"][rid]
        assert len(got) == len(ref) == 8
        bound = REL * np.abs(logits).max()
        for t, row in enumerate(logits):
            top2 = np.sort(row)[-2:]
            if top2[1] - top2[0] <= 2 * bound:
                break
            assert got[t] == ref[t], (rid, t)
            compared += 1
    assert compared > 0


def test_paged_pool_at_batch_one_is_refused_by_name(data_worlds):
    for rank in data_worlds["res"]["d2"]:
        err = rank["runs"]["b1_paged"]["error"]
        assert "--kv ring" in err and "data axis" in err


def test_gemma3_batch_one_rings_on_the_data_axis(data_worlds):
    """Reduced gemma3 at batch 1 on rings at (2, 1): its global and local
    rings both split over `data`; every rank the one-process stream."""
    want = data_worlds["one"]["gemma3_b1"]["ring"]
    for rank in data_worlds["res"]["d2"]:
        got = rank["gemma3_b1"]["ring"]
        assert got[0] == want[0] and got[2] == 0


# ---------------------------------------------------------------------------
# the families at (2, 2)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("key,layout", [(k, lay) for k, (_, lays, _) in
                                        ENGINES.items() for lay in lays])
def test_family_stream_at_2x2_equals_one_process(data_worlds, key, layout):
    """mamba2 (rows), hymba (pools, local rings and SSM rows), granite
    (the dropless dispatch on the rank's experts) and reduced llama4 with
    `cfg.fsdp` (its leaves cut over `data` and `model`, gathered over
    `data` a superblock at a time, every data rank running every prefill)
    at (2, 2): three requests over two slots, each data rank its own
    slot; every rank the one-process stream, no leak, no non-finite
    logit."""
    want = data_worlds["one"][key][layout]
    for rank in data_worlds["res"]["d4"]:
        streams, leaked, nonfinite, _ = rank[key][layout]
        assert streams == want[0] and nonfinite == 0
        assert leaked in (0, None)


@pytest.mark.parametrize("arch", GENERATE)
def test_frontend_generate_at_2x2_equals_one_process(data_worlds, arch):
    """whisper's and pixtral's `generate()` at (2, 2): each data rank
    prefills and decodes its own row (and frontend), the tokens gathered
    over `data`: every rank the one-process batch."""
    want = data_worlds["one"][arch]
    for rank in data_worlds["res"]["d4"]:
        assert torch.equal(rank[arch]["tokens"], want)
        assert rank[arch]["nonfinite"] == 0


@pytest.mark.parametrize("layout", SAMPLED["qwen_sampled"][0])
def test_sampled_stream_at_2x2_equals_one_process(data_worlds, layout):
    """Sampled decoding (`serve(greedy=False)`, one seeded generator) at
    (2, 2), unified and on rings: each data rank draws the uniforms of
    the whole batch and keeps its own slots', and a rank that does not run
    a request's prefill draws that pick's uniform too, so every rank gives
    the one-process stream."""
    want = data_worlds["one"]["qwen_sampled"][layout]
    assert all(len(t) for t in want[0].values())
    for rank in data_worlds["res"]["d4"]:
        streams, leaked, nonfinite, _ = rank["qwen_sampled"][layout]
        assert streams == want[0] and nonfinite == 0
        assert leaked in (0, None)


def test_sampled_two_pool_stream_at_2x2_is_one_stream(data_worlds):
    """Under the two-pool loop a ready request binds a free slot of its
    own shard, not always the slot one process binds it to, and a sampled
    token depends on its slot's uniform: the stream is another sample.
    Every rank gives the same one, each request its whole budget, no
    page leaked."""
    want = data_worlds["one"]["qwen_sampled_disagg"]["paged"][0]
    got = [rank["qwen_sampled_disagg"]["paged"]
           for rank in data_worlds["res"]["d4"]]
    assert all(g[0] == got[0][0] for g in got)
    assert {rid: len(t) for rid, t in got[0][0].items()} == {
        rid: len(t) for rid, t in want.items()} == {0: 8, 1: 3, 2: 5}
    assert all(g[1] == 0 and g[2] == 0 for g in got)


def test_sampled_generate_at_2x2_equals_one_process(data_worlds):
    """`generate(greedy=False)` at (2, 2): every rank the one-process
    batch."""
    want = data_worlds["one"]["sampled"]
    for rank in data_worlds["res"]["d4"]:
        assert torch.equal(rank["sampled"]["tokens"], want)
        assert rank["sampled"]["nonfinite"] == 0


# ---------------------------------------------------------------------------
# the handoff on the data-sharded pool (tests/test_sharded.py's assertions)
# ---------------------------------------------------------------------------

def test_handoff_on_the_data_sharded_pool(data_worlds):
    """ok_pool: the pool's page dim over `data`, the block table
    replicated (each rank's `new_pool()` the shapes of its piece);
    ok_frag: the fragment's token dim not over `data`, its heads over
    `model`; ok_equal: the engine's splice on each rank (the scatter on
    the data rank of the slot's shard, the bind on every rank), gathered
    whole, is the JAX engine's unsharded insert bit for bit, each shard's
    trash page apart (the stated deviation: the scatter wipes the
    positions of the shard's own trash page, page 6, where the JAX insert
    wipes page 0; no decode reads either); ok_bind: slot 1's block-table
    row maps pages 8-10."""
    ref = data_worlds["handoff_ref"]
    live = [p for p in range(12) if p not in (0, 6)]
    owners = []
    for rank in data_worlds["res"]["d4"]:
        h = rank["handoff"]
        assert h["pool_k_spec"][1] == "data" and h["same_shapes"]
        assert h["pool_bt_spec"] == (None, None, None)
        assert "data" not in h["frag_k_spec"] and "model" in h[
            "frag_k_spec"]
        assert len(h["pool"]) == len(ref)
        for a, b in zip(h["pool"], ref):
            a = a.numpy()
            if a.shape[1] == 12:           # a pool leaf: pages on dim 1
                a, b = a[:, live], b[:, live]
            assert np.array_equal(a.view(np.uint32) if a.dtype == np.float32
                                  else a, b.view(np.uint32)
                                  if b.dtype == np.float32 else b)
        bt = [x for x in h["pool"] if x.dtype == torch.int32
              and x.ndim == 3 and x.shape[1] == 2][0]
        assert bt[0, 1, :3].tolist() == [8, 9, 10]
        owners.append(h["owner"])
    assert owners == [False, False, True, True]


# ---------------------------------------------------------------------------
# in the test process: the cache layout and the allocator
# ---------------------------------------------------------------------------

def _cut(tree, specs, mesh, coords, keep_model_whole=False):
    """`shard_tree`, with the SSM leaves whole over `model` (the port's
    stated deviation: the mixer's gather layout). The encoder-decoder's
    `cross` leaves are cut as `cache_specs` cuts them (ROADMAP F10)."""
    def cut(path, x, sp):
        if keep_model_whole and "ssm" in path:
            sp = S.P(*(None if e == "model" else e for e in sp))
        return S.shard_leaf(x, sp, mesh, coords)
    return S.tree_map_with_path(cut, tree, specs)


@pytest.mark.parametrize("arch,paged,batch", [
    (QWEN, (12, 8), 2), (QWEN, None, 2), (QWEN, None, 1), (GEMMA3, (12, 8), 4),
    (GEMMA3, None, 1), (HYMBA, (12, 8), 2), (MAMBA2, None, 1),
    (WHISPER, None, 2), (WHISPER, None, 1)])
def test_rank_cache_is_the_cache_specs_piece(arch, paged, batch):
    """`init_cache(data_shards=2, kv_shards=2)` on every rank of a (2, 2)
    mesh: each leaf is `shard_leaf` of the one-process cache under
    `cache_specs` (shapes, types and fills), the SSM states whole over
    `model` (the stated deviation). Where the data axis divides the
    batch, a rank's slots and its shard of the pages beside the whole
    block table; where it does not, its block of every ring's rows."""
    cfg = reduced_config(arch)
    mesh = MeshSpec(("data", "model"), (2, 2))
    whole = TM.init_cache(cfg, batch, 32, dtype=torch.float32,
                          device="cpu", paged=paged, kv_pad_to=2)
    specs = S.cache_specs(cfg, whole, mesh, batch)
    for d in range(2):
        for m in range(2):
            want = _cut(whole, specs, mesh, {"data": d, "model": m},
                        keep_model_whole=True)
            got = TM.init_cache(cfg, batch, 32, dtype=torch.float32,
                                device="cpu", paged=paged, kv_pad_to=2,
                                kv_shards=2, data_shards=2)
            wl, gl = TM.tree_leaves(want), TM.tree_leaves(got)
            assert len(wl) == len(gl)
            for a, b in zip(wl, gl):
                assert a.shape == b.shape and a.dtype == b.dtype
                assert torch.equal(a, b)


def _trace(alloc, ops):
    """The ids an allocator hands out over `ops` ((kind, arg) pairs:
    alloc `arg` pages, free the arg-th live lease, register the newest
    lease as a fresh prompt's pages (its whole pages and a 2-row tail)
    then look the prompt up), and its counts after each."""
    live, out, n = [], [], 0
    for kind, arg in ops:
        if kind == "alloc":
            got = alloc.alloc(arg)
            out.append(("alloc", got))
            if got is not None:
                live.append([got, False])
        elif kind == "free" and live:
            alloc.free(live.pop(arg % len(live))[0])
        elif kind == "prefix" and live and not live[-1][1]:
            pages, live[-1][1] = live[-1][0], True
            n += 1
            prompt = list(range(100 * n, 100 * n + 4 * len(pages) - 2))
            alloc.prefix_register(prompt, pages, "premium")
            out.append(("lookup", alloc.prefix_lookup(prompt, "premium")))
        out.append((alloc.leased, alloc.free_pages, alloc.cached))
    return out


def _ops(seed):
    rng = np.random.default_rng(seed)
    return [(["alloc", "free", "prefix"][rng.integers(0, 3)],
             int(rng.integers(1, 4))) for _ in range(60)]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_one_shard_allocator_is_the_jax_allocator(seed):
    """`ShardedPageAllocator` over one shard hands out the JAX package's
    `PageAllocator`'s ids, leases, free and cached counts, prefix hits and
    copy-on-write donors, op for op."""
    kw = dict(max_request_pages=3, prefix_caching=True, fingerprint="t")
    one = ShardedPageAllocator(1, 12, 4, 2, **kw)
    assert _trace(one.view(0), _ops(seed)) == _trace(JAlloc(12, 4, **kw),
                                                     _ops(seed))
    assert one.peak_in_use == one.view(0).allocator.peak_in_use


@pytest.mark.parametrize("seed", [0, 1])
def test_each_shard_is_a_jax_allocator_over_its_range(seed):
    """Over two shards of a 16-page pool, each shard's trace is a JAX
    `PageAllocator`'s over 8 pages with its ids moved to the shard's range
    [8·i, 8·i + 8) (page 8·i its trash page, never handed out); a
    retirement and a prefix registration route by the page ids; the pool's
    counts are the shards' summed."""
    kw = dict(max_request_pages=3, prefix_caching=True, fingerprint="t")
    pool = ShardedPageAllocator(2, 16, 4, 4, **kw)
    assert [pool.shard_of_slot(s) for s in range(4)] == [0, 0, 1, 1]
    for i in range(2):
        ops = _ops(seed + 10 * i)
        got = _trace(pool.view(i), ops)
        ref = _trace(JAlloc(8, 4, **kw), ops)

        def moved(entry, base=8 * i):
            if entry[0] == "alloc":
                return ("alloc", None if entry[1] is None
                        else [p + base for p in entry[1]])
            if entry[0] == "lookup":
                pages, shared, donor = entry[1]
                return ("lookup", ([p + base for p in pages], shared,
                                   None if donor is None else donor + base))
            return entry

        assert got == [moved(e) for e in ref]
        ids = [p for e in got if e[0] == "alloc" and e[1] for p in e[1]]
        assert all(8 * i < p < 8 * i + 8 for p in ids)
    assert pool.leased == sum(s.allocator.leased for s in pool.shards)
    assert pool.capacity == 14 and pool.peak_by_shard == [
        s.allocator.peak_in_use for s in pool.shards]


def test_scheduler_admits_from_the_slot_s_shard():
    """The unified path takes a slot's pages from its own shard; the
    prefill pool stages in the shard with the fewest ready requests, then
    the most pages, and a slot binds only a request staged in its shard;
    every retirement returns the pages to their shard."""
    sched = SlotScheduler(4, eos_id=-1,
                          pages=ShardedPageAllocator(2, 16, 4, 4))
    for n in (5, 5, 5):
        sched.submit(list(range(n)), max_new_tokens=3)
    a = sched.admit(3, 0.0)
    assert a.shard == 1 and all(8 < p < 16 for p in a.pages)
    b = sched.begin_prefill(0.0)       # shard 0: the most pages
    sched.finish_prefill(b, 7, 0.0)
    c = sched.begin_prefill(0.0)       # shard 1: no staged request
    sched.finish_prefill(c, 7, 0.0)
    assert (b.shard, c.shard) == (0, 1)
    assert all(p < 8 for p in b.pages) and all(p > 8 for p in c.pages)
    assert sched.admit_ready(2, 0.0) is c
    assert sched.admit_ready(1, 0.0) is b
    for slot in (1, 2, 3):
        sched.reject(slot, 0.0)
    assert sched.pages.leased == 0 and sched.pages.leaked == 0


def test_a_page_block_counts_only_where_no_shard_takes_the_request():
    """`page_blocks` counts a request that waits for pages. On a sharded
    pool, one that a slot's shard refuses but a shard with a free slot
    takes is not counted (the unified loop tries that slot next), nor one
    the prefill pool stages in a later shard of its order; one that no
    shard takes now is counted once."""
    sched = SlotScheduler(4, eos_id=-1,
                          pages=ShardedPageAllocator(2, 8, 4, 4))
    for n in (10, 10, 10, 10):
        sched.submit(list(range(n)), max_new_tokens=2)
    a = sched.admit(0, 0.0)             # 3 of shard 0's 3 free pages
    assert a.shard == 0
    assert sched.admit(1, 0.0) is None  # shard 0 full; slot 2 is free
    assert sched.page_blocks == 0
    b = sched.admit(2, 0.0)
    assert b.shard == 1 and sched.page_blocks == 0
    assert sched.admit(3, 0.0) is None  # no shard has the pages
    assert sched.page_blocks == 1
    assert sched.admit(3, 0.0) is None  # the same request: once
    assert sched.page_blocks == 1
    two = SlotScheduler(4, eos_id=-1,
                        pages=ShardedPageAllocator(2, 8, 4, 4))
    for n in (10, 10, 10):
        two.submit(list(range(n)), max_new_tokens=2)
    c = two.begin_prefill(0.0)
    two.finish_prefill(c, 7, 0.0)
    d = two.begin_prefill(0.0)
    assert {c.shard, d.shard} == {0, 1} and two.page_blocks == 0
    two.finish_prefill(d, 7, 0.0)
    assert two.begin_prefill(0.0) is None and two.page_blocks == 1


def test_check_parallel_refuses_only_a_paged_pool_off_the_batch():
    cfg = reduced_config(QWEN)
    TM.check_parallel(cfg, 2, 2, serving=True, batch=4, kv_layout="paged")
    TM.check_parallel(cfg, 1, 2, serving=True, batch=1, kv_layout="ring")
    TM.check_parallel(reduced_config(MAMBA2), 1, 2, serving=True, batch=1,
                      kv_layout="paged")
    with pytest.raises(ValueError, match="--kv ring"):
        TM.check_parallel(cfg, 1, 2, serving=True, batch=3,
                          kv_layout="paged")
