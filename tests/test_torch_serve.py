"""PyTorch port: the copied scheduler's unit cases, the port's serve engine
against the JAX engine, and the port's serve driver.

The engine comparison runs under `PrecisionPolicy(input_format="fp32")`
(as tests/test_decode_kernel.py's serve-level case does): token streams
must be identical and no page may leak. The port's weights are the JAX
weights carried over by `params_from_numpy`.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# the parity tests need the JAX package; the card's machine has no JAX and
# runs tests/test_torch_gpu.py instead
pytest.importorskip("jax")

import jax  # noqa: E402

from repro.configs import reduced_config  # noqa: E402
from repro.core import PrecisionPolicy, use_policy  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.serve.engine import ServeEngine as JEngine  # noqa: E402
from repro.serve.scheduler import SlotScheduler as JSched  # noqa: E402
from repro_torch.core import precision as TP  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import serve as drv  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.serve.engine import ServeEngine  # noqa: E402
from repro_torch.serve.scheduler import (PageAllocator,  # noqa: E402
                                         ReplicaRouter, SlotScheduler)

torch.set_num_threads(2)


# ---------------------------------------------------------------------------
# the copied scheduler: the reference's pure host-side unit cases
# ---------------------------------------------------------------------------

def _bookkeeping():
    sched = SlotScheduler(2, eos_id=99)
    r0 = sched.submit([1, 2, 3], max_new_tokens=5)
    r1 = sched.submit([4, 5], max_new_tokens=2)
    r2 = sched.submit([6], max_new_tokens=3, arrival_time=0.0)
    assert sched.free_slots() == [0, 1]
    assert sched.admit(0, now=0.0) is r0 and sched.admit(1, now=0.0) is r1
    sched.start(0, first_token=10, now=0.1)
    sched.start(1, first_token=11, now=0.1)
    assert sched.positions().tolist() == [3, 2]
    chunk = np.array([[20, 30], [21, 99], [99, 31]], np.int32)
    sched.observe(chunk, now=0.5)
    assert r1.tokens == [11, 30] and r1.finish_reason == "length"
    assert r0.tokens == [10, 20, 21, 99] and r0.finish_reason == "eos"
    assert sched.free_slots() == [0, 1] and sched.num_active() == 0
    assert sched.admit(0, now=1.0) is r2 and sched.refills == 1
    sched.start(0, first_token=99, now=1.1)
    assert r2.finish_reason == "eos" and r2.n_generated == 1
    assert sched.drained()
    s = sched.summary()
    assert s["generated_tokens"] == 4 + 2 + 1
    assert s["eos_finishes"] == 2 and s["slot_refills"] == 1


def _fifo_among_arrived():
    sched = SlotScheduler(1, eos_id=-1)
    late = sched.submit([1], 1, arrival_time=10.0)
    early = sched.submit([2], 1, arrival_time=0.0)
    assert sched.next_arrival() == 0.0
    assert sched.admit(0, now=0.0) is early
    assert sched.admit(0, now=0.0) is None
    sched.start(0, first_token=5, now=0.0)
    assert sched.admit(0, now=10.0) is late


def _pool_exhaustion():
    pa = PageAllocator(4, page_size=8, max_request_pages=3)
    sched = SlotScheduler(2, eos_id=99, pages=pa)
    r0 = sched.submit([1] * 10, max_new_tokens=6)
    r1 = sched.submit([2] * 10, max_new_tokens=6)
    assert sched.admit(0, now=0.0) is r0 and len(r0.pages) == 2
    assert pa.free_pages == 1
    assert sched.admit(1, now=0.0) is None
    assert sched.page_blocks == 1 and sched.pending[0] is r1
    sched.start(0, first_token=99, now=0.1)
    assert r0.finish_reason == "eos" and pa.free_pages == 3
    assert sched.drain_freed() == [0]
    assert sched.admit(1, now=0.2) is r1 and len(r1.pages) == 2
    assert pa.free_pages == 1


def _allocator_pure():
    pa = PageAllocator(6, page_size=4, max_request_pages=3,
                       min_request_tokens=6)
    assert pa.capacity == 5 and pa.free_pages == 5
    assert pa.pages_needed(1) == 2
    assert pa.pages_needed(9) == 3
    assert pa.fits_ever(12) and not pa.fits_ever(13)
    a = pa.alloc(3)
    assert a == [1, 2, 3] and pa.in_use == 3 and pa.peak_in_use == 3
    assert pa.alloc(3) is None
    b = pa.alloc(2)
    assert b == [4, 5] and pa.free_pages == 0
    pa.free(a)
    assert pa.free_pages == 3 and pa.peak_in_use == 5
    with pytest.raises(AssertionError):
        pa.free([0])
    with pytest.raises(AssertionError):
        pa.free([1])


def _refcounts_and_prefix_index():
    pa = PageAllocator(8, page_size=4, prefix_caching=True, fingerprint="t")
    prompt = list(range(10))
    pages = pa.alloc(3)
    assert pages == [1, 2, 3] and pa.leased == 3 and pa.peak_in_use == 3
    assert pa.prefix_register(prompt, pages, "premium") == 3
    assert pa.prefix_lookup(prompt, "bulk") == ([], 0, None)
    hit, shared, donor = pa.prefix_lookup(prompt, "premium")
    assert hit == [1, 2] and shared == 9 and donor == 3
    pa.free(pages)
    assert pa.leased == 0 and pa.cached == 3 and pa.leaked == 0
    assert pa.free_pages == 4 and pa.in_use == 3
    pa.retain(hit + [donor])
    assert pa.leased == 3 and pa.cached == 0
    fresh = pa.alloc(1)
    assert fresh == [4] and pa.leased == 4 and pa.peak_in_use == 4
    pa.cow_fork(donor)
    assert pa.cow_forks == 1 and pa.cached == 1 and pa.leased == 3
    pa.free(hit + fresh)
    assert pa.leased == 0 and pa.cached == 3 and pa.leaked == 0
    pa.retain([1])
    assert pa.allocatable({1}) == pa.free_pages == 4
    pa.free([1])
    assert pa.allocatable() == 7
    big = pa.alloc(6)
    assert big is not None and pa.prefix_evictions == 1
    assert pa.prefix_lookup(prompt, "premium") == ([], 0, None)
    pa.free(big)
    assert pa.leaked == 0 and pa.free_pages == 7
    with pytest.raises(AssertionError):
        pa.free([1])
    with pytest.raises(AssertionError):
        pa.retain([1])


def _two_pool():
    sched = SlotScheduler(2, eos_id=-1)
    r0 = sched.submit([1, 2, 3], max_new_tokens=4, arrival_time=0.0)
    r1 = sched.submit([4, 5], max_new_tokens=3, arrival_time=5.0)
    r2 = sched.submit([6, 7], max_new_tokens=1, arrival_time=5.0)
    assert sched.begin_prefill(0.0) is r0
    assert sched.begin_prefill(0.0) is None
    assert sched.finish_prefill(r0, 42, 0.1) is True
    assert sched.ready_depth() == 1 and not sched.drained()
    assert sched.admit_ready(0, 0.2) is r0 and r0.slot == 0
    assert sched.admit_ready(1, 0.2) is None
    assert sched.begin_prefill(6.0) is r1
    assert sched.begin_prefill(6.0) is r2
    assert "ready_depth_p50" in sched.summary()


def _replica_router():
    with pytest.raises(ValueError):
        ReplicaRouter(0)
    r = ReplicaRouter(3)
    assert r.route(4, 4) == 0
    assert r.route(2, 2) == 1
    assert r.route(1, 1) == 2
    assert r.route(1, 1) == 2
    assert r.outstanding == [8, 4, 4]
    r.complete(0, 4, 4)
    assert r.route(1, 1) == 0
    with pytest.raises(AssertionError):
        r.complete(1, 100, 100)


@pytest.mark.parametrize("case", [
    _bookkeeping, _fifo_among_arrived, _pool_exhaustion, _allocator_pure,
    _refcounts_and_prefix_index, _two_pool, _replica_router],
    ids=lambda f: f.__name__.strip("_"))
def test_scheduler_unit_cases(case):
    case()


# ---------------------------------------------------------------------------
# the engine against the JAX engine
# ---------------------------------------------------------------------------

FP32_J = PrecisionPolicy(input_format="fp32")


@pytest.fixture(scope="module")
def setup():
    cfg = dataclasses.replace(reduced_config("qwen2.5-14b"), remat=False)
    with use_policy(FP32_J):
        jp = JM.init_params(jax.random.key(0), cfg)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    return cfg, jp, tp


def _streams(engine_cls, sched_cls, cfg, params, prompts, budgets,
             eos_id=-1, sync_every=2, finished=None,
             kv_layout="paged", **kw):
    eng = engine_cls(cfg, params, batch=2, cache_len=32, eos_id=eos_id,
                     sync_every=sync_every, kv_layout=kv_layout,
                     page_size=8, **kw)
    sched = sched_cls(2, eos_id=eos_id)
    for p, n in zip(prompts, budgets):
        sched.submit(p, max_new_tokens=n)
    summary = eng.serve(sched)
    if finished is not None:
        finished.extend(sched.finished)
    return {r.rid: r.tokens for r in sched.finished}, summary


@pytest.mark.parametrize("seed,lens,budgets", [
    (23, (5, 9, 7), (6, 3, 4)),
    (5, (16, 3, 11, 8), (2, 7, 5, 3)),
])
def test_engine_matches_jax_engine(setup, seed, lens, budgets):
    cfg, jp, tp = setup
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist() for n in lens]
    with use_policy(FP32_J):
        ref, _ = _streams(JEngine, JSched, cfg, jp, prompts, budgets)
    with TP.use_policy(TP.PrecisionPolicy(input_format="fp32")):
        got, summary = _streams(ServeEngine, SlotScheduler, cfg, tp, prompts,
                                budgets)
    assert got == ref
    assert [len(got[i]) for i in sorted(got)] == list(budgets)
    assert summary["pages_leaked"] == 0
    assert summary["decode_attn"] == "fused"
    assert summary["nonfinite_logits"] == 0


def _probe_prompts(cfg, seed=23, lens=(5, 9, 7)):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab_size, n).tolist() for n in lens]


def test_engine_bf16_pool_matches_jax_engine(setup):
    """A bf16 KV pool (`cache_dtype`) in both engines, on the
    `test_engine_matches_jax_engine` stream: identical tokens, no page
    leaked."""
    import jax.numpy as jnp

    cfg, jp, tp = setup
    prompts, budgets = _probe_prompts(cfg), (6, 3, 4)
    with use_policy(FP32_J):
        ref, _ = _streams(JEngine, JSched, cfg, jp, prompts, budgets,
                          cache_dtype=jnp.bfloat16)
    with TP.use_policy(TP.PrecisionPolicy(input_format="fp32")):
        got, summary = _streams(ServeEngine, SlotScheduler, cfg, tp, prompts,
                                budgets, cache_dtype=torch.bfloat16)
    assert got == ref
    assert [len(got[i]) for i in sorted(got)] == list(budgets)
    assert summary["pages_leaked"] == 0


def test_engine_eos_frees_slot_mid_chunk(setup):
    """EOS at the engine level. The EOS id is taken from a probe stream
    (no EOS) at a token whose first occurrence in that stream is at index
    2 and which no other stream emits; with it, the port engine's streams
    equal the JAX engine's, the request stops there in the middle of a
    4-step decode chunk, its slot is refilled, and no page leaks."""
    cfg, jp, tp = setup
    prompts, budgets = _probe_prompts(cfg), (6, 3, 4)
    fp32 = TP.PrecisionPolicy(input_format="fp32")
    with TP.use_policy(fp32):
        probe, _ = _streams(ServeEngine, SlotScheduler, cfg, tp, prompts,
                            budgets)
    # the first token of stream 0 that first occurs at index >= 2 and
    # appears in no other stream
    others = {t for rid, toks in probe.items() if rid != 0 for t in toks}
    idx, eos = next((i, t) for i, t in enumerate(probe[0])
                    if i >= 2 and t not in probe[0][:i] and t not in others)
    sync = 4
    assert idx < budgets[0] - 1 and idx % sync != 0   # mid-chunk
    with use_policy(FP32_J):
        ref, _ = _streams(JEngine, JSched, cfg, jp, prompts, budgets,
                          eos_id=eos, sync_every=sync)
    done = []
    with TP.use_policy(fp32):
        got, summary = _streams(ServeEngine, SlotScheduler, cfg, tp, prompts,
                                budgets, eos_id=eos, sync_every=sync,
                                finished=done)
    assert got == ref
    r0 = next(r for r in done if r.rid == 0)
    assert r0.finish_reason == "eos" and r0.tokens == probe[0][:idx + 1]
    # every other stream runs to its budget, unchanged
    assert all(got[rid] == probe[rid] for rid in got if rid != 0)
    # the third request took the slot the EOS freed
    assert next(r for r in done if r.rid == 2).slot == r0.slot
    assert summary["pages_leaked"] == 0
    assert summary["eos_finishes"] == 1


def test_engine_prefix_cache_hits_keep_tokens(setup, monkeypatch):
    """A shared system prompt: later admissions map cached pages and
    prefill only their suffix; tokens equal the no-sharing run."""
    cfg, _, tp = setup
    rng = np.random.default_rng(7)
    system = rng.integers(0, cfg.vocab_size, 16).tolist()
    prompts = [system + rng.integers(0, cfg.vocab_size, n).tolist()
               for n in (3, 5, 4)]
    out = {}
    for flag in ("1", "0"):
        monkeypatch.setenv("REPRO_PREFIX_CACHE", flag)
        with TP.use_policy(TP.PrecisionPolicy(input_format="fp32")):
            out[flag], summary = _streams(ServeEngine, SlotScheduler, cfg,
                                          tp, prompts, (4, 4, 4))
        assert summary["pages_leaked"] == 0
        if flag == "1":
            assert summary["prefix_hits"] >= 1
    assert out["1"] == out["0"]


@pytest.mark.parametrize("pattern", [("local", "global"), ("local",)],
                         ids=["local-global", "local-only"])
def test_engine_serves_local_window_patterns(pattern):
    """A dense config with a local:global layer pattern, or with local
    layers only (a paged cache with no pool leaf), served with prompts
    longer than the window of 8: the port's paged stream equals its ring
    stream and the JAX engine's (fp32 policy, weights from key 1)."""
    cfg = dataclasses.replace(reduced_config("qwen2.5-14b"), remat=False,
                              attn_pattern=pattern, window=8,
                              num_layers=2 * len(pattern))
    with use_policy(FP32_J):
        jp = JM.init_params(jax.random.key(1), cfg)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    prompts = _probe_prompts(cfg, seed=1, lens=(12, 6, 14))
    budgets = (5, 3, 4)
    with use_policy(FP32_J):
        ref, _ = _streams(JEngine, JSched, cfg, jp, prompts, budgets)
    with TP.use_policy(TP.PrecisionPolicy(input_format="fp32")):
        got, summary = _streams(ServeEngine, SlotScheduler, cfg, tp,
                                prompts, budgets)
        ring, _ = _streams(ServeEngine, SlotScheduler, cfg, tp, prompts,
                           budgets, kv_layout="ring")
    assert got == ref == ring
    assert summary["pages_leaked"] == 0
    assert "prefix_hits" not in summary       # the window turns it off


# ---------------------------------------------------------------------------
# the driver
# ---------------------------------------------------------------------------

ARGS = ["--arch", "qwen2.5-14b", "--reduced", "--device", "cpu", "--batch",
        "2", "--requests", "4", "--max-new", "5", "--prompt-lens", "6,10",
        "--rate", "0"]


def test_driver_prints_summary_with_digest(capsys):
    ops.reset_counts()
    summary = drv.main(ARGS)
    line = [ln for ln in capsys.readouterr().out.splitlines()
            if ln.startswith("[continuous] ")]
    assert len(line) == 1
    fields = dict(kv.split("=", 1) for kv in line[0].split()[1:])
    assert fields["stream_digest"] == summary["stream_digest"]
    assert len(summary["stream_digest"]) == 16
    assert summary["requests"] == 4 and summary["generated_tokens"] == 20
    assert summary["pages_leaked"] == 0
    # on the CPU every kernel call went to its plain version
    c = ops.counts()
    assert all(v["launches"] == 0 for v in c.values())
    assert c["sa_matmul"]["plain_calls"] > 0
    assert c["paged_decode"]["plain_calls"] > 0
    # the stream is a pure function of the seed
    assert drv.main(ARGS)["stream_digest"] == summary["stream_digest"]


def test_driver_digest_is_the_jax_drivers():
    """`stream_digest` hashes the rid-ordered token streams exactly as the
    JAX driver does (launch/serve.py there)."""
    import hashlib

    class R:
        def __init__(self, rid, tokens):
            self.rid, self.tokens = rid, tokens

    rs = [R(1, [4, 5]), R(0, [7])]
    want = hashlib.sha1(b"0:7,1:4-5").hexdigest()[:16]
    assert drv.stream_digest(rs) == want


def test_driver_needs_a_card_or_device_cpu():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a CUDA device")
    with pytest.raises(RuntimeError, match="--device cpu"):
        drv.main([a for a in ARGS if a not in ("--device", "cpu")])
