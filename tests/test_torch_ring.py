"""PyTorch port: the ring KV layout and static-batch `generate()` against
the JAX engine.

`kv_layout="ring"` gives each slot a dense ring of `cache_len` rows; an
admission copies its prefill fragment over the slot's row and a freed
row is masked (positions -1). Under `PrecisionPolicy(input_format=
"fp32")` on reduced qwen2.5-14b with the JAX weights (as
tests/test_torch_serve.py), the port's ring streams must equal the JAX
engine's ring streams and the port's own paged streams token for token;
`generate()` must equal the JAX `generate()` and the ring serve of the
same requests.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# the parity tests need the JAX package; the card's machine has no JAX and
# runs tests/test_torch_gpu.py instead
pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import reduced_config  # noqa: E402
from repro.core import PrecisionPolicy, use_policy  # noqa: E402
from repro.launch import serve as jdrv  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.serve.engine import ServeEngine as JEngine  # noqa: E402
from repro.serve.scheduler import SlotScheduler as JSched  # noqa: E402
from repro_torch.core import precision as TP  # noqa: E402
from repro_torch.launch import serve as drv  # noqa: E402
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


def _prompts(cfg, lens, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab_size, n).tolist() for n in lens]


def _serve(engine_cls, sched_cls, cfg, params, layout, prompts, budgets,
           eos_id=-1, arrivals=None, clock=None, sync_every=2,
           cache_len=64, **kw):
    eng = engine_cls(cfg, params, batch=2, cache_len=cache_len,
                     eos_id=eos_id, sync_every=sync_every, kv_layout=layout,
                     **kw)
    sched = sched_cls(2, eos_id=eos_id)
    for i, (p, n) in enumerate(zip(prompts, budgets)):
        sched.submit(p, max_new_tokens=n,
                     arrival_time=arrivals[i] if arrivals else 0.0)
    summary = eng.serve(sched, **({"clock": clock} if clock else {}))
    return {r.rid: r for r in sched.finished}, summary


def _eos_case(cfg, tp):
    """An EOS id taken from a probe stream (no EOS) at a token whose first
    occurrence in stream 0 is at index 2 and which no other stream emits
    (tests/test_torch_serve.py's EOS test): with sync_every 4 it fires
    mid-chunk."""
    prompts, budgets = _prompts(cfg, (5, 9, 7), 23), (6, 3, 4)
    with TP.use_policy(FP32_T):
        probe, _ = _serve(ServeEngine, SlotScheduler, cfg, tp, "ring",
                          prompts, budgets, sync_every=4)
    others = {t for rid, r in probe.items() if rid != 0 for t in r.tokens}
    toks = probe[0].tokens
    idx, eos = next((i, t) for i, t in enumerate(toks)
                    if i >= 2 and t not in toks[:i] and t not in others)
    assert idx % 4 != 0 and idx < budgets[0] - 1
    return dict(prompts=prompts, budgets=budgets, eos_id=eos, sync_every=4)


def _case(name, cfg, tp):
    if name == "refill":
        return dict(prompts=_prompts(cfg, (5, 9, 7, 11), 1),
                    budgets=(20, 4, 6, 5))
    if name == "staggered":
        return dict(prompts=_prompts(cfg, (6, 6, 8), 11), budgets=(3, 3, 4),
                    arrivals=(5.0, 9.0, 9.5), clock=lambda: 0.0)
    return _eos_case(cfg, tp)


CASES = ["refill", "staggered", "eos_mid_chunk"]


@pytest.mark.parametrize("name", CASES)
def test_ring_matches_jax_ring(setup, name):
    cfg, jp, tp = setup
    c = _case(name, cfg, tp)
    prompts, budgets = c.pop("prompts"), c.pop("budgets")
    with use_policy(FP32_J):
        ref, _ = _serve(JEngine, JSched, cfg, jp, "ring", prompts, budgets,
                        **c)
    with TP.use_policy(FP32_T):
        got, summary = _serve(ServeEngine, SlotScheduler, cfg, tp, "ring",
                              prompts, budgets, **c)
    assert ({rid: r.tokens for rid, r in got.items()}
            == {rid: r.tokens for rid, r in ref.items()})
    assert ({rid: r.finish_reason for rid, r in got.items()}
            == {rid: r.finish_reason for rid, r in ref.items()})
    assert summary["nonfinite_logits"] == 0
    # the ring layout has no allocator and no paged decode-attention path
    assert "pages_leaked" not in summary and "decode_attn" not in summary
    if name == "refill":
        assert summary["slot_refills"] >= 2
    if name == "staggered":
        assert all(r.ttft == 0.0 for r in got.values())
    if name == "eos_mid_chunk":
        assert got[0].finish_reason == "eos"
        assert got[2].slot == got[0].slot     # the freed slot was refilled


@pytest.mark.parametrize("impl", ["gather", "fused"])
@pytest.mark.parametrize("name", CASES)
def test_ring_matches_paged(setup, monkeypatch, name, impl):
    """The port's ring streams equal its paged streams: under
    REPRO_DECODE_ATTN=gather both attend over the same dense rows in the
    same order; under `fused` the paged path runs the decode kernel's
    plain version (tokens, not bits, are compared)."""
    cfg, _, tp = setup
    monkeypatch.setenv("REPRO_DECODE_ATTN", impl)
    c = _case(name, cfg, tp)
    prompts, budgets = c.pop("prompts"), c.pop("budgets")
    out = {}
    with TP.use_policy(FP32_T):
        for layout in ("ring", "paged"):
            kw = {"page_size": 16} if layout == "paged" else {}
            out[layout], summary = _serve(ServeEngine, SlotScheduler, cfg,
                                          tp, layout, prompts, budgets,
                                          **c, **kw)
    assert summary["pages_leaked"] == 0
    assert ({rid: r.tokens for rid, r in out["ring"].items()}
            == {rid: r.tokens for rid, r in out["paged"].items()})


def test_ring_rejects_a_request_that_would_wrap(setup):
    """prompt + budget beyond `cache_len` would wrap the global-attention
    ring: the request is retired as rejected while the rest of the batch
    keeps serving, as in the JAX engine."""
    cfg, jp, tp = setup
    prompts = _prompts(cfg, (12, 6), 13)
    with use_policy(FP32_J):
        ref, _ = _serve(JEngine, JSched, cfg, jp, "ring", prompts, (8, 4),
                        cache_len=16)
    with TP.use_policy(FP32_T):
        got, summary = _serve(ServeEngine, SlotScheduler, cfg, tp, "ring",
                              prompts, (8, 4), cache_len=16)
    assert got[0].finish_reason == "rejected" and got[0].tokens == []
    assert got[1].tokens == ref[1].tokens and len(got[1].tokens) == 4
    assert summary["rejected"] == 1 and summary["requests"] == 2


def test_ring_insert_and_clear_in_place(setup):
    """`_insert_impl` copies a fragment over the slot's whole ring row
    (positions included) and `_clear_slot_impl` masks the row; the other
    slot's row is untouched."""
    cfg, _, _ = setup
    cache = TM.init_cache(cfg, 2, 8, dtype=torch.float32, device="cpu")
    for c in cache:
        kv = c["kv"]
        kv.k.fill_(7.0)
        kv.positions.copy_(torch.arange(8, dtype=torch.int32))
    frag = TM.init_cache(cfg, 1, 8, dtype=torch.float32, device="cpu")
    for c in frag:
        c["kv"].k[:, 0, :3] = 1.0
        c["kv"].positions[:, 0, :3] = torch.arange(3, dtype=torch.int32)
    ServeEngine._insert_impl(cache, frag, 1)
    for c in cache:
        kv = c["kv"]
        assert kv.positions[:, 1].tolist() == [[0, 1, 2] + [-1] * 5]
        assert bool((kv.k[:, 1, :3] == 1.0).all())
        assert bool((kv.k[:, 1, 3:] == 0.0).all())
        assert bool((kv.k[:, 0] == 7.0).all())
    ServeEngine._clear_slot_impl(cache, 0)
    for c in cache:
        assert c["kv"].positions[:, 0].tolist() == [[-1] * 8]
        assert c["kv"].positions[:, 1].tolist() == [[0, 1, 2] + [-1] * 5]


def test_engine_takes_the_layout_from_repro_kv(setup, monkeypatch):
    cfg, _, tp = setup
    monkeypatch.setenv("REPRO_KV", "ring")
    assert ServeEngine(cfg, tp, batch=2, cache_len=16).kv_layout == "ring"
    monkeypatch.setenv("REPRO_KV", "bogus")
    with pytest.raises(ValueError, match="ring"):
        ServeEngine(cfg, tp, batch=2, cache_len=16)


@pytest.mark.parametrize("eos", [False, True], ids=["budget", "eos"])
def test_generate_matches_jax_generate_and_serve(setup, eos):
    """Static-batch `generate()` equals the JAX `generate()` (the same
    columns; with an EOS both stop at the same chunk) and, without EOS,
    the ring serve of the same lock-step requests."""
    cfg, jp, tp = setup
    prompts = _prompts(cfg, (8, 8), 5)
    eos_id = -1
    if eos:
        with TP.use_policy(FP32_T):
            probe = ServeEngine(cfg, tp, batch=2, cache_len=32, eos_id=-1,
                                sync_every=3).generate(prompts, 9)
        eos_id = int(probe[1, 4])        # fires in the second chunk
    with use_policy(FP32_J):
        jeng = JEngine(cfg, jp, batch=2, cache_len=32, eos_id=eos_id,
                       sync_every=3)
        want = np.asarray(jeng.generate(jnp.asarray(prompts, jnp.int32), 9))
    with TP.use_policy(FP32_T):
        eng = ServeEngine(cfg, tp, batch=2, cache_len=32, eos_id=eos_id,
                          sync_every=3)
        got = eng.generate(torch.tensor(prompts), 9)
        stats = eng.last_stats
        served, _ = _serve(ServeEngine, SlotScheduler, cfg, tp, "ring",
                           prompts, (9, 9), sync_every=3, cache_len=32)
    assert got.dtype == torch.int32 and got.device.type == "cpu"
    assert got.numpy().tolist() == want.tolist()
    assert set(stats) == {"prefill_s", "decode_s", "decode_tokens",
                          "nonfinite_logits"}
    assert stats["decode_tokens"] == (got.shape[1] - 1) * 2
    assert stats["nonfinite_logits"] == 0
    if eos:
        assert got.shape[1] == 7          # 1 + two 3-step chunks
    else:
        assert got.shape[1] == 9
        for rid in (0, 1):
            assert served[rid].tokens == got[rid].tolist()


def test_generate_refuses_a_batch_of_another_size(setup):
    cfg, _, tp = setup
    with TP.use_policy(FP32_T):
        eng = ServeEngine(cfg, tp, batch=2, cache_len=16)
        with pytest.raises(AssertionError):
            eng.generate([[1, 2, 3]], 2)


ARGS = ["--arch", "qwen2.5-14b", "--reduced", "--batch", "2", "--requests",
        "4", "--max-new", "5", "--prompt-lens", "6,10", "--rate", "0",
        "--seed", "1"]


def test_driver_kv_ring(monkeypatch):
    """`--kv ring` serves the stream: its digest is the JAX driver's
    `--kv ring` digest on the JAX weights (seed 1, see
    tests/test_torch_tiers.py's driver test), and the port's paged
    driver's under REPRO_DECODE_ATTN=gather."""
    cfg = reduced_config("qwen2.5-14b")
    with use_policy(FP32_J):
        want = jdrv.main(ARGS + ["--kv", "ring"])
        jp = JM.init_params(jax.random.key(1), cfg)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    monkeypatch.setenv("REPRO_DECODE_ATTN", "gather")
    with TP.use_policy(FP32_T):
        ring = drv.main(ARGS + ["--device", "cpu", "--kv", "ring"],
                        params=tp)
        paged = drv.main(ARGS + ["--device", "cpu"], params=tp)
    assert ring["stream_digest"] == want["stream_digest"]
    assert ring["stream_digest"] == paged["stream_digest"]
    assert ring["requests"] == 4 and ring["generated_tokens"] == 20
    assert "pages_total" not in ring and paged["pages_leaked"] == 0
