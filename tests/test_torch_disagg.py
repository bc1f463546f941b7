"""PyTorch port: disaggregated two-pool serving and engine replicas
against the JAX package, and the host side of the dense decode view.

Mirrors tests/test_disagg.py: the two-pool engine's streams equal the
unified engine's (on a staggered stream, with prefix-cache hits, composed
with bucketing), a one-token budget retires at prefill, the knob comes
from REPRO_DISAGG as from the keyword, and a ring engine serves unified.
The port's disagg streams, and the driver's `--disagg` and
`--decode-replicas 2` digests, equal the JAX engine's and driver's on the
same weights. Reduced qwen2.5-14b under `PrecisionPolicy(input_format=
"fp32")`; the engine tests carry the JAX weights of key 0 over with
`params_from_numpy`, the driver tests those of seed 1 (as
tests/test_torch_ring.py).

On the card the `gather` path and the ring decode through the paged
decode kernel over a dense view (`dense_pool_view`): its identity block
table, and a ring slot's split equal to a pool slot's, are checked here;
the kernel's bits against the pool's are tests/test_torch_gpu.py's.
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
from repro.launch import serve as jdrv  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.serve.engine import ServeEngine as JEngine  # noqa: E402
from repro.serve.scheduler import SlotScheduler as JSched  # noqa: E402
from repro_torch.core import precision as TP  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import sa_decode_attention as DA  # noqa: E402
from repro_torch.launch import serve as drv  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.serve.engine import ServeEngine  # noqa: E402
from repro_torch.serve.scheduler import SlotScheduler  # noqa: E402

torch.set_num_threads(2)

FP32_J = PrecisionPolicy(input_format="fp32")
FP32_T = TP.PrecisionPolicy(input_format="fp32")


@pytest.fixture(scope="module")
def setup():
    cfg = dataclasses.replace(reduced_config("qwen2.5-14b"), remat=False)
    with use_policy(FP32_J):
        jp = JM.init_params(jax.random.key(0), cfg)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    return cfg, jp, tp


def _prompts(cfg, lens, seed=1):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab_size, n).tolist() for n in lens]


def _serve(engine_cls, sched_cls, policy_ctx, cfg, params, prompts, budgets,
           arrivals=None, *, cache_len=64, page_size=8, **engine_kw):
    with policy_ctx:
        eng = engine_cls(cfg, params, batch=2, cache_len=cache_len,
                         eos_id=-1, sync_every=4, page_size=page_size,
                         **engine_kw)
        sched = sched_cls(2, eos_id=-1)
        for i, (p, n) in enumerate(zip(prompts, budgets)):
            sched.submit(p, max_new_tokens=n,
                         arrival_time=arrivals[i] if arrivals else 0.0)
        summary = eng.serve(sched, greedy=True)
    return sched, summary


def _port(cfg, tp, prompts, budgets, arrivals=None, **kw):
    return _serve(ServeEngine, SlotScheduler, TP.use_policy(FP32_T), cfg, tp,
                  prompts, budgets, arrivals, kv_layout=kw.pop(
                      "kv_layout", "paged"), **kw)


def _jax(cfg, jp, prompts, budgets, arrivals=None, **kw):
    return _serve(JEngine, JSched, use_policy(FP32_J), cfg, jp, prompts,
                  budgets, arrivals, kv_layout="paged", **kw)


def _tokens(sched):
    return {r.rid: r.tokens for r in sched.finished}


# the staggered mixed-length stream of tests/test_disagg.py
STAGGERED = dict(lens=[5, 9, 13, 6, 11, 7], budgets=[12, 6, 9, 5, 10, 8],
                 arrivals=[0.0, 0.0, 0.1, 0.1, 0.2, 0.2])


def test_disagg_matches_unified(setup):
    """The two-pool engine's streams equal the unified engine's token for
    token on a staggered stream; no page leaks through the handoff; only
    the two-pool run reports the ready queue's depth."""
    cfg, _, tp = setup
    prompts = _prompts(cfg, STAGGERED["lens"])
    budgets, arrivals = STAGGERED["budgets"], STAGGERED["arrivals"]
    on_s, on = _port(cfg, tp, prompts, budgets, arrivals, disagg=True,
                     prefill_workers=2)
    off_s, off = _port(cfg, tp, prompts, budgets, arrivals, disagg=False)
    assert _tokens(on_s) == _tokens(off_s)
    assert len(on_s.finished) == len(prompts)
    assert [len(_tokens(on_s)[i]) for i in range(6)] == budgets
    assert on["disagg"] is True and off["disagg"] is False
    assert on["pages_leaked"] == 0 and off["pages_leaked"] == 0
    assert "ready_depth_p50" in on and "ready_depth_p50" not in off
    assert {"prefill_busy_s", "decode_busy_s", "handoff_s",
            "decode_stall_s"} <= set(on) & set(off)
    assert on["nonfinite_logits"] == 0


def test_disagg_matches_jax_engine(setup):
    """The port's two-pool streams equal the JAX engine's two-pool streams
    on the same converted weights."""
    cfg, jp, tp = setup
    prompts = _prompts(cfg, STAGGERED["lens"][:4])
    budgets, arrivals = STAGGERED["budgets"][:4], STAGGERED["arrivals"][:4]
    got_s, got = _port(cfg, tp, prompts, budgets, arrivals, disagg=True,
                       prefill_workers=2)
    want_s, want = _jax(cfg, jp, prompts, budgets, arrivals, disagg=True,
                        prefill_workers=2)
    assert _tokens(got_s) == _tokens(want_s)
    assert got["disagg"] is want["disagg"] is True
    assert got["pages_leaked"] == want["pages_leaked"] == 0


def test_disagg_prefix_cache_parity(setup):
    """Prefix-cache hits survive the split: the prefill worker maps the
    cached pages (copy-on-write tail included) before staging and
    registers the fresh run before the request reaches the ready queue;
    the tokens and the hit count are the unified engine's."""
    cfg, _, tp = setup
    rng = np.random.default_rng(9)
    system = rng.integers(0, cfg.vocab_size, 16).tolist()
    prompts = [system + t for t in _prompts(cfg, [5, 7, 9], seed=10)]
    on_s, on = _port(cfg, tp, prompts, [6, 6, 6], disagg=True, cache_len=96)
    off_s, off = _port(cfg, tp, prompts, [6, 6, 6], disagg=False,
                       cache_len=96)
    assert _tokens(on_s) == _tokens(off_s)
    assert on["prefix_hits"] >= 1
    assert on["prefix_hits"] == off["prefix_hits"]
    assert on["pages_leaked"] == 0


def test_disagg_first_token_finishes_at_prefill(setup):
    """A one-token budget retires inside finish_prefill: it never reaches
    the ready queue or a decode slot, and its pages come home."""
    cfg, _, tp = setup
    sched, summary = _port(cfg, tp, _prompts(cfg, [6, 8, 7], seed=4),
                           [1, 8, 1], disagg=True)
    by_rid = {r.rid: r for r in sched.finished}
    assert len(by_rid) == 3
    for rid in (0, 2):
        assert by_rid[rid].n_generated == 1
        assert by_rid[rid].slot == -1          # never bound to a slot
        assert by_rid[rid].finish_reason == "length"
    assert by_rid[1].n_generated == 8
    assert summary["pages_leaked"] == 0


def test_disagg_composes_with_bucketing(setup):
    """Both knobs at once give the plain engine's streams: the staged
    fragment is bucket-padded, its overflow pages go to the trash page and
    the handoff binds only the allocated run."""
    cfg, _, tp = setup
    prompts = _prompts(cfg, [5, 9, 13, 7], seed=8)
    budgets = [8, 6, 7, 5]
    on_s, on = _port(cfg, tp, prompts, budgets, disagg=True,
                     bucket_prompts=True)
    off_s, _ = _port(cfg, tp, prompts, budgets)
    assert _tokens(on_s) == _tokens(off_s)
    assert on["pages_leaked"] == 0 and on["disagg"] is True


@pytest.mark.parametrize("env,kw,want", [
    ("1", {}, True), ("0", {"disagg": True}, True),
    ("1", {"disagg": False}, False)])
def test_disagg_from_env_or_keyword(setup, monkeypatch, env, kw, want):
    """REPRO_DISAGG sets the default; the keyword overrides it."""
    cfg, _, tp = setup
    monkeypatch.setenv("REPRO_DISAGG", env)
    eng = ServeEngine(cfg, tp, batch=2, cache_len=16, kv_layout="paged",
                      **kw)
    assert eng.disagg_on() is want


def test_ring_engine_stays_unified(setup):
    """Disaggregation is sound only for the paged layout: a ring engine
    asked for it serves unified, without a word, with the same tokens."""
    cfg, _, tp = setup
    prompts = _prompts(cfg, [5, 9, 7], seed=2)
    budgets = [4, 5, 3]
    ring_s, ring = _port(cfg, tp, prompts, budgets, kv_layout="ring",
                         cache_len=24, disagg=True)
    plain_s, _ = _port(cfg, tp, prompts, budgets, kv_layout="ring",
                       cache_len=24)
    assert ring["disagg"] is False and "ready_depth_p50" not in ring
    assert _tokens(ring_s) == _tokens(plain_s)


# ---------------------------------------------------------------------------
# the driver: --disagg, --prefill-workers, --decode-replicas
# ---------------------------------------------------------------------------

# seed 1's stream with a shared 8-token system prompt on 8-token pages: 4
# prefix hits in each engine. (Port-vs-JAX token parity holds away from
# near-tie argmaxes, ROADMAP R1: with a 16-token prompt the unified
# streams of the two packages already part at one.)
DRV = ["--arch", "qwen2.5-14b", "--reduced", "--batch", "2", "--requests",
       "5", "--max-new", "4", "--prompt-lens", "6,10", "--rate", "0",
       "--seed", "1", "--prefix-mix", "0.8", "--prefix-len", "8",
       "--page-size", "8"]


@pytest.fixture(scope="module")
def driver_weights():
    with use_policy(FP32_J):
        jp = JM.init_params(jax.random.key(1), reduced_config("qwen2.5-14b"))
    return params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")


@pytest.mark.parametrize("extra", [
    ["--disagg", "--prefill-workers", "2"],
    ["--decode-replicas", "2"],
    ["--decode-replicas", "2", "--disagg"]])
def test_driver_matches_jax_driver(driver_weights, capsys, extra):
    """`--disagg` and `--decode-replicas 2` print their summary lines; each
    digest is the JAX driver's for the same arguments, and the port's own
    unified run's."""
    with use_policy(FP32_J):
        want = jdrv.main(DRV + extra)
    capsys.readouterr()
    with TP.use_policy(FP32_T):
        got = drv.main(DRV + ["--device", "cpu"] + extra,
                       params=driver_weights)
        out = capsys.readouterr().out
        unified = drv.main(DRV + ["--device", "cpu"], params=driver_weights)
    tag = ("[replicas x2] " if "--decode-replicas" in extra
           else "[continuous] ")
    line = [ln for ln in out.splitlines() if ln.startswith(tag)]
    assert len(line) == 1
    fields = dict(kv.split("=", 1) for kv in line[0][len(tag):].split())
    assert fields["stream_digest"] == got["stream_digest"]
    assert got["stream_digest"] == want["stream_digest"]
    assert got["stream_digest"] == unified["stream_digest"]
    assert got["requests"] == 5 and got["generated_tokens"] == 20
    assert got["pages_leaked"] == 0
    assert got["disagg"] is ("--disagg" in extra)
    if "--decode-replicas" not in extra:
        assert got["prefix_hits"] == want["prefix_hits"] >= 1
    if "--decode-replicas" in extra:
        assert got["replicas"] == 2
        assert got["wall_s_parallel"] <= got["wall_s_serial"]
    if "--disagg" in extra:
        assert got["ready_depth_p50"] is not None


def test_driver_replicas_return_their_schedulers(driver_weights):
    """`main(..., return_state=True)` with replicas returns the aggregate
    and the replicas' schedulers; the requests keep their global rids."""
    with TP.use_policy(FP32_T):
        summary, scheds = drv.main(DRV + ["--device", "cpu",
                                          "--decode-replicas", "2"],
                                   return_state=True, params=driver_weights)
    assert len(scheds) == 2 and all(s.finished for s in scheds)
    rids = sorted(r.rid for s in scheds for r in s.finished)
    assert rids == list(range(5))
    assert summary["stream_digest"] == drv.stream_digest(
        [r for s in scheds for r in s.finished])


# ---------------------------------------------------------------------------
# the dense decode view (ROADMAP F5): the host side
# ---------------------------------------------------------------------------

def test_dense_pool_view_is_an_identity_table_without_a_copy():
    """Dense rows (B, S, KVH, hd) become pages of `page_size` rows with
    `table[b, j] = b·S/psz + j`, sharing the rows' storage; given the
    gathered view's source table, an entry is -1 wherever the source entry
    was <= 0 (unmapped, or the trash page)."""
    B, S, psz = 3, 32, 8
    k = torch.randn(B, S, 2, 64)
    v = torch.randn(B, S, 2, 64)
    pos = torch.arange(B * S, dtype=torch.int32).reshape(B, S)
    kp, vp, pp, table = DA.dense_pool_view(k, v, pos, psz)
    assert kp.shape == (B * S // psz, psz, 2, 64) and pp.shape == (12, psz)
    assert kp.data_ptr() == k.data_ptr() and pp.data_ptr() == pos.data_ptr()
    assert table.dtype == torch.int32
    assert table.tolist() == [[0, 1, 2, 3], [4, 5, 6, 7], [8, 9, 10, 11]]
    for b in range(B):
        for i in range(S):
            pid = int(table[b, i // psz])
            assert torch.equal(kp[pid, i % psz], k[b, i])
            assert torch.equal(vp[pid, i % psz], v[b, i])
            assert int(pp[pid, i % psz]) == int(pos[b, i])
    src = torch.tensor([[3, 0, 7, -1], [5, 6, -1, -1], [-1, -1, -1, -1]],
                       dtype=torch.int32)
    _, _, _, t2 = DA.dense_pool_view(k, v, pos, psz, src)
    assert t2.tolist() == [[0, -1, 2, -1], [4, 5, -1, -1], [-1] * 4]
    with pytest.raises(ValueError, match="multiple of the page size"):
        DA.dense_pool_view(k, v, pos, 12)


@pytest.mark.parametrize("cache_len,psz", [(144, 16), (176, 16), (150, 16),
                                           (64, 8), (2000, 16),
                                           (100000, 16)])
def test_ring_view_splits_as_the_pool_slot(cache_len, psz):
    """A ring of `ring_len` = round_up(cache_len, psz) rows, viewed in
    `psz`-row pages, has the split (`split_plan`, hence the order of sums)
    of a pool slot of the engine's `max_seq_len` at the same page size."""
    eng_len = -(-cache_len // psz) * psz
    B, KVH, g, hd = 2, 8, 5, 128
    q = torch.zeros(B, 1, KVH * g, hd)
    k = torch.zeros(B, eng_len, KVH, 1).expand(B, eng_len, KVH, hd)
    kp, vp, pp, table = DA.dense_pool_view(
        k.contiguous(), k.contiguous(),
        torch.full((B, eng_len), -1, dtype=torch.int32), psz)
    pool = torch.zeros(1, psz, KVH, hd)
    bt = torch.full((B, eng_len // psz), -1, dtype=torch.int32)
    assert DA.launch_plan(q, kp, vp, table) == DA.launch_plan(q, pool, pool,
                                                              bt)


def test_engine_ring_len(setup):
    """On the CPU the ring keeps `cache_len` rows (nothing changes there);
    the rounding to whole pages is the card's."""
    cfg, _, tp = setup
    eng = ServeEngine(cfg, tp, batch=2, cache_len=21, kv_layout="ring",
                      page_size=8)
    assert eng.ring_len == 21
    assert eng.new_cache()[0]["kv"].k.shape[2] == 21
    assert eng.max_seq_len == 24


@pytest.mark.parametrize("layout", ["ring", "paged"])
def test_cpu_dense_decode_runs_decode_attention(setup, monkeypatch, layout):
    """On the CPU the ring and the `gather` path attend with
    `decode_attention` over their dense rows, as before: the decode
    kernel's plain version never runs and its kernel never launches."""
    cfg, _, tp = setup
    monkeypatch.setenv("REPRO_DECODE_ATTN", "gather")
    calls = []
    real = TL.decode_attention

    def spy(*a, **kw):
        calls.append(1)
        return real(*a, **kw)

    monkeypatch.setattr(TL, "decode_attention", spy)
    ops.reset_counts()
    sched, summary = _port(cfg, tp, _prompts(cfg, [5, 7], seed=3), [3, 3],
                           kv_layout=layout, cache_len=16)
    c = ops.counts()["paged_decode"]
    assert c == {"launches": 0, "plain_calls": 0}
    assert len(calls) > 0
    assert all(r.n_generated == 3 for r in sched.finished)


def test_plain_version_over_a_dense_view_is_decode_attention():
    """The wrapper over a dense view (`min_page=0`: page 0 is slot 0's
    first page, not a trash page) runs, on the CPU, the plain version over
    the same rows: `decode_attention` of the dense rows, bit for bit; with
    the default `min_page=1` page 0 would be masked."""
    g = torch.Generator().manual_seed(5)
    B, S, KVH, grp, hd, psz = 2, 16, 2, 2, 64, 8
    q = torch.randn(B, 1, KVH * grp, hd, generator=g)
    k = torch.randn(B, S, KVH, hd, generator=g)
    v = torch.randn(B, S, KVH, hd, generator=g)
    pos = torch.tensor([S - 1, 9], dtype=torch.int32)
    kvp = torch.arange(S, dtype=torch.int32).repeat(B, 1)
    kvp[1, 10:] = -1
    with TP.use_policy(TP.PrecisionPolicy()):
        want = TL.decode_attention(q, k, v, kvp, pos)
        kp, vp, pp, table = DA.dense_pool_view(k, v, kvp, psz)
        got = ops.paged_decode_attention(q, kp, vp, pp, table, pos,
                                         min_page=0)
        masked = ops.paged_decode_attention(q, kp, vp, pp, table, pos)
    assert torch.equal(got, want)
    assert not torch.equal(masked[0], want[0])
