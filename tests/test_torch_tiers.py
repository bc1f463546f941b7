"""PyTorch port: the bulk quality tier (DESIGN.md §6) against the JAX
engine — approximate decode chunks, the chunk-mode rule, the divergence
probe, `macs_per_token`, the per-tier energy summary and the driver's
`--tier-mix`.

Everything runs under `PrecisionPolicy(input_format="fp32")` on reduced
qwen2.5-14b with the JAX weights carried over by `params_from_numpy`, as
tests/test_torch_serve.py does. Token streams and the scheduler's tier
accounting must be identical. The probe's logits are held to the JAX
engine's within PROBE_TOL = 2⁻⁵ of their largest magnitude, the model
parity tests' bound (tests/test_torch_model.py: the residual stream is
bf16, so a last-bit fp32 difference of the summation order, ROADMAP R1,
can flip a bf16 rounding); the two probes' `max_abs_diff` differ by at
most the same amount; and both probes stay within DESIGN.md §6's bound
(max_ulp ≤ 2¹², kl_mean < 1e-4).
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
from repro.core import energy as JE  # noqa: E402
from repro.launch import serve as jdrv  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.serve.engine import ServeEngine as JEngine  # noqa: E402
from repro.serve.scheduler import SlotScheduler as JSched  # noqa: E402
from repro_torch.core import energy as TE  # noqa: E402
from repro_torch.core import precision as TP  # noqa: E402
from repro_torch.kernels import fp_emu as FE  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import serve as drv  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.serve.engine import ServeEngine  # noqa: E402
from repro_torch.serve.scheduler import SlotScheduler  # noqa: E402

torch.set_num_threads(2)

FP32_J = PrecisionPolicy(input_format="fp32")
FP32_T = TP.PrecisionPolicy(input_format="fp32")
# port probe logits against the JAX probe's, relative to the largest logit
PROBE_TOL = 2.0 ** -5


@pytest.fixture(scope="module")
def setup():
    cfg = dataclasses.replace(reduced_config("qwen2.5-14b"), remat=False)
    with use_policy(FP32_J):
        jp = JM.init_params(jax.random.key(0), cfg)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    return cfg, jp, tp


def _tier_stream(engine_cls, sched_cls, cfg, params, tiers, seed=5,
                 budget=6, **kw):
    """One request per tier in `tiers` (4-token prompts from `seed`)
    through a batch-2 engine; returns (scheduler, summary)."""
    eng = engine_cls(cfg, params, batch=2, cache_len=24, eos_id=-1,
                     sync_every=2, **kw)
    sched = sched_cls(2, eos_id=-1)
    rng = np.random.default_rng(seed)
    for tier in tiers:
        sched.submit(rng.integers(0, cfg.vocab_size, 4).tolist(),
                     max_new_tokens=budget, tier=tier)
    return sched, eng.serve(sched)


def _both(setup, tiers, **kw):
    cfg, jp, tp = setup
    with use_policy(FP32_J):
        js, jsum = _tier_stream(JEngine, JSched, cfg, jp, tiers, **kw)
    with TP.use_policy(FP32_T):
        ts, tsum = _tier_stream(ServeEngine, SlotScheduler, cfg, tp, tiers,
                                **kw)
    return (js, jsum), (ts, tsum)


TIER_KEYS = ("chunks_exact", "chunks_approx", "tier_requests",
             "tier_mode_tokens", "tier_affine_picks")


@pytest.mark.parametrize("tiers", [
    ["premium", "bulk", "premium", "bulk"],
    ["bulk", "bulk", "premium", "bulk", "premium"],
    ["bulk", "bulk", "bulk"],
], ids=["alternating", "bulk_first", "all_bulk"])
def test_tiered_stream_matches_jax_engine(setup, tiers):
    """Equal tokens per request and equal tier accounting: the chunk-mode
    rule (approx only when every active slot is bulk), tier-affine
    admission and the per-(tier, mode) token counts."""
    (js, jsum), (ts, tsum) = _both(setup, tiers)
    assert ({r.rid: r.tokens for r in ts.finished}
            == {r.rid: r.tokens for r in js.finished})
    for key in TIER_KEYS:
        assert tsum.get(key) == jsum.get(key), key
    assert tsum["chunks_approx"] > 0
    assert "premium/approx" not in tsum["tier_mode_tokens"]
    assert tsum["pages_leaked"] == 0 and tsum["nonfinite_logits"] == 0


def test_all_premium_stream_reports_no_chunk_modes(setup):
    """As in the JAX engine, `chunks_*` appear only where an approximate
    chunk ran, and the tier section only where a tier other than premium
    was used."""
    (_, jsum), (_, tsum) = _both(setup, ["premium"] * 3)
    for key in TIER_KEYS:
        assert key not in tsum and key not in jsum, key


def test_premium_tokens_identical_under_mixed_stream(setup):
    """A premium request's tokens do not depend on bulk traffic sharing
    the engine (greedy decode, rows independent of the batch)."""
    cfg, _, tp = setup
    tiers = ["premium", "bulk", "premium", "bulk"]
    with TP.use_policy(FP32_T):
        mixed, _ = _tier_stream(ServeEngine, SlotScheduler, cfg, tp, tiers)
        allprem, _ = _tier_stream(ServeEngine, SlotScheduler, cfg, tp,
                                  ["premium"] * 4)
    for rm, rp, tier in zip(sorted(mixed.finished, key=lambda r: r.rid),
                            sorted(allprem.finished, key=lambda r: r.rid),
                            tiers):
        assert rm.prompt == rp.prompt
        if tier == "premium":
            assert rm.tokens == rp.tokens


def test_bulk_chunks_run_the_approx_datapath(setup, monkeypatch):
    """The chunk's mode reaches the GEMMs: under the `cuda` backend (its
    plain version on the CPU) every decode GEMM of an all-bulk chunk runs
    `mode="approx"` and every prefill GEMM `exact`; under `emulate` the
    same holds for the skewed datapath (`core/precision.py` passes the
    mode through `ops.skewed_datapath_matmul` to fp_emu)."""
    cfg, _, tp = setup
    seen = {}
    for backend, mod, fn in (("cuda", None, "sa_matmul"),
                             ("emulate", FE, "fma_emu_matmul_ref")):
        modes = []
        if mod is None:
            real = ops._mm.sa_matmul_ref

            def spy(a, w, *args, _real=real, _m=modes, **kw):
                _m.append((a.shape[0], kw.get("mode", "exact")))
                return _real(a, w, *args, **kw)
            monkeypatch.setattr(ops._mm, "sa_matmul_ref", spy)
        else:
            real = getattr(mod, fn)

            def spy(a, w, fmt_name="bf16", mode="exact", _real=real,
                    _m=modes):
                _m.append((a.shape[0], mode))
                return _real(a, w, fmt_name, mode)
            monkeypatch.setattr(mod, fn, spy)
        pol = TP.PrecisionPolicy(backend=backend,
                                 input_format="fp32" if backend == "cuda"
                                 else "bf16")
        with TP.use_policy(pol):
            _, summary = _tier_stream(ServeEngine, SlotScheduler, cfg, tp,
                                      ["bulk", "bulk"], budget=3)
        monkeypatch.undo()
        assert summary["chunks_approx"] >= 1 and summary.get(
            "chunks_exact") == 0
        seen[backend] = modes
    # the decode GEMMs (M = the batch, 2) of the one all-bulk chunk run
    # approx; the only exact ones at M = 2 are the warm-up chunk's, which
    # runs before serving; prefill (M = 4, and 1 for the lm_head) is exact
    per_step = 7 * cfg.num_layers + 1
    for backend, modes in seen.items():
        assert modes.count((2, "approx")) == 2 * per_step, backend
        assert modes.count((2, "exact")) == 2 * per_step, backend
        assert {m for rows, m in modes if rows in (1, 4)} == {"exact"}


def _jax_probe_logits(engine, prompt, steps):
    """The JAX probe's two passes (`repro.serve.engine.divergence_probe`'s
    `run_mode`), returning their logits."""
    import dataclasses as dc

    from repro.core.precision import current_policy
    from repro.train.step import make_prefill_step

    T = len(prompt)
    cache0 = engine.new_cache(batch=1)
    with use_policy(dc.replace(current_policy(), mode="exact")):
        logits, cache0 = jax.jit(make_prefill_step(engine.cfg))(
            engine.params, jnp.asarray(prompt, jnp.int32)[None], cache0,
            None)
    first = int(np.asarray(jnp.argmax(logits[0, -1])))

    def run_mode(mode, tokens):
        def step(params, tok, cache, pos, frontend, _inner=engine._serve_step):
            return _inner(params, tok, cache, pos, frontend)
        step = jax.jit(step)
        out, cache, tok = [], cache0, first
        with use_policy(dc.replace(current_policy(), mode=mode)):
            for s in range(steps):
                if tokens is not None:
                    tok = tokens[s]
                logits, cache = step(engine.params,
                                     jnp.asarray([[tok]], jnp.int32), cache,
                                     jnp.asarray([T + s], jnp.int32), None)
                row = np.asarray(logits[0, -1], np.float32)
                out.append(row)
                tok = int(row.argmax())
        return np.stack(out)

    le = run_mode("exact", None)
    la = run_mode("approx", [first] + [int(r.argmax()) for r in le[:-1]])
    return le, la


def test_divergence_probe_matches_jax_probe(setup):
    cfg, jp, tp = setup
    prompt = np.random.default_rng(9).integers(0, cfg.vocab_size, 4).tolist()
    steps = 4
    with use_policy(FP32_J):
        jeng = JEngine(cfg, jp, batch=2, cache_len=24, eos_id=-1,
                       sync_every=2)
        jprobe = jeng.divergence_probe(prompt, steps=steps)
        jle, jla = _jax_probe_logits(jeng, prompt, steps)
    with TP.use_policy(FP32_T):
        teng = ServeEngine(cfg, tp, batch=2, cache_len=24, eos_id=-1,
                           sync_every=2)
        tprobe = teng.divergence_probe(prompt, steps=steps)
        tle, tla = teng._probe_logits(prompt, steps)
    assert set(tprobe) == set(jprobe) == {"steps", "max_ulp", "kl_mean",
                                          "max_abs_diff"}
    assert tprobe["steps"] == jprobe["steps"] == steps
    # both passes of both probes agree: the exact pass (greedy, the
    # teacher) and the approximate one (teacher-forced from the same
    # post-prefill cache)
    for got, want in ((tle, jle), (tla, jla)):
        assert got.shape == want.shape == (steps, cfg.vocab_size)
        scale = float(np.abs(want).max())
        assert float(np.abs(got - want).max()) <= PROBE_TOL * scale
    assert [int(r.argmax()) for r in tle] == [int(r.argmax()) for r in jle]
    # the two modes differ, and both stay within DESIGN.md §6's bound
    for probe in (tprobe, jprobe):
        assert 0 < probe["max_ulp"] <= 4096
        assert probe["kl_mean"] < 1e-4
    assert abs(tprobe["max_abs_diff"] - jprobe["max_abs_diff"]) <= (
        PROBE_TOL * float(np.abs(jle).max()))


def test_divergence_probe_passes_are_fresh_decodes(setup):
    """Both passes start from the post-prefill cache: the exact pass is a
    greedy decode from a fresh prefill, and the approximate pass is the
    approximate decode of the exact pass's tokens from a fresh prefill,
    bit for bit (the decode step writes the cache in place, so the probe
    copies the post-prefill cache before the exact pass)."""
    cfg, _, tp = setup
    prompt, steps = [5, 6, 7, 8, 9], 6
    with TP.use_policy(FP32_T):
        eng = ServeEngine(cfg, tp, batch=2, cache_len=24, eos_id=-1)
        le, la = eng._probe_logits(prompt, steps)
        teacher = None
        for mode, want in (("exact", le), ("approx", la)):
            cache = eng.new_cache(batch=1)
            logits, cache = eng._prefill_for(0)(
                tp, torch.tensor([prompt], dtype=torch.int32), cache)
            tok = int(torch.argmax(logits[0, -1]))
            if teacher is None:
                teacher = [tok] + [int(r.argmax()) for r in le[:-1]]
            pol = dataclasses.replace(FP32_T, mode=mode)
            with TP.use_policy(pol):
                for i in range(steps):
                    logits, cache = eng._serve_step(
                        tp, torch.tensor([[teacher[i]]], dtype=torch.int32),
                        cache, torch.tensor([len(prompt) + i],
                                            dtype=torch.int32))
                    assert np.array_equal(logits[0, -1].numpy(), want[i])
    assert not np.array_equal(le, la)


def test_divergence_probe_on_a_padded_vocabulary(setup):
    """Where the vocabulary is padded (here 2100 → 4096 columns) the
    padding logits are -inf in both passes; the probe compares the real
    vocabulary, so every value is finite, and its logits are the JAX
    probe's over the same columns."""
    cfg = dataclasses.replace(setup[0], vocab_size=2100)
    assert cfg.padded_vocab > cfg.vocab_size
    with use_policy(FP32_J):
        jp = JM.init_params(jax.random.key(1), cfg)
        jeng = JEngine(cfg, jp, batch=2, cache_len=24, eos_id=-1)
        jle, jla = _jax_probe_logits(jeng, [3, 1, 4, 1], 3)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    with TP.use_policy(FP32_T):
        eng = ServeEngine(cfg, tp, batch=2, cache_len=24, eos_id=-1)
        probe = eng.divergence_probe([3, 1, 4, 1], steps=3)
        tle, tla = eng._probe_logits([3, 1, 4, 1], 3)
    assert all(np.isfinite(v) for v in probe.values())
    assert probe["max_ulp"] > 0
    V = cfg.vocab_size
    for got, want in ((tle, jle[:, :V]), (tla, jla[:, :V])):
        scale = float(np.abs(want).max())
        assert float(np.abs(got - want).max()) <= PROBE_TOL * scale


@pytest.mark.parametrize("vocab,lpp", [(None, 1), (2100, 2)],
                         ids=["reduced", "padded_vocab_two_layers"])
def test_macs_per_token_matches_jax_engine(setup, vocab, lpp):
    """The port's parameter tree has the JAX tree's elements: the padded
    vocabulary's embedding and lm_head, the QKV biases, every layer."""
    cfg = dataclasses.replace(
        reduced_config("qwen2.5-14b", layers_per_period=lpp), remat=False)
    if vocab:
        cfg = dataclasses.replace(cfg, vocab_size=vocab)
    with use_policy(FP32_J):
        jp = JM.init_params(jax.random.key(0), cfg)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    want = JEngine(cfg, jp, batch=2, cache_len=24).macs_per_token()
    assert ServeEngine(cfg, tp, batch=2, cache_len=24).macs_per_token() \
        == want
    # and the port's own initializer draws the same tree
    from repro_torch.models import model as TM
    own = ServeEngine(cfg, TM.init_params(cfg, seed=0, device="cpu"),
                      batch=2, cache_len=24)
    assert own.macs_per_token() == want


@pytest.mark.parametrize("counts", [
    {("premium", "exact"): 90, ("bulk", "approx"): 30, ("bulk", "exact"): 10},
    {("premium", "exact"): 5}, {}])
def test_tier_energy_summary_matches_jax(counts):
    assert TE.tier_energy_summary(counts, 10 ** 6) == \
        JE.tier_energy_summary(counts, 10 ** 6)


def test_tier_energy_of_a_served_stream_matches_jax(setup):
    (js, _), (ts, _) = _both(setup, ["bulk", "premium", "bulk", "bulk"])
    cfg, jp, tp = setup
    macs = ServeEngine(cfg, tp, batch=2, cache_len=24).macs_per_token()
    got = TE.tier_energy_summary(ts.tier_mode_tokens, macs)
    want = JE.tier_energy_summary(js.tier_mode_tokens, macs)
    assert got == want and got["energy_saving"] > 0


DRV = ["--arch", "qwen2.5-14b", "--reduced", "--batch", "2", "--requests",
       "4", "--max-new", "5", "--prompt-lens", "6,10", "--rate", "0",
       "--tier-mix", "0.5", "--seed", "1"]


def test_driver_tier_mix_matches_jax_driver(capsys):
    """`--tier-mix 0.5`: the port's driver serves the JAX driver's stream
    on the JAX driver's weights with the same digest and tier accounting,
    and adds the `energy_*` and `divergence_*` keys and the `[divergence]`
    line.

    Seed 1: the streams of seeds 0, 2 and 3 part between the two drivers
    at a near-tie argmax even when every request is premium (seed 0:
    request 0's first token, a top-2 gap of 0.0042 against a port-JAX
    logit difference of 0.0096, inside the 2⁻⁵ bound), which is R1's
    summation order, not the tier."""
    cfg = reduced_config("qwen2.5-14b")
    with use_policy(FP32_J):
        want = jdrv.main(DRV)
        jp = JM.init_params(jax.random.key(1), cfg)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    capsys.readouterr()
    with TP.use_policy(FP32_T):
        got = drv.main(DRV + ["--device", "cpu"], params=tp)
    out = capsys.readouterr().out
    assert got["stream_digest"] == want["stream_digest"]
    for key in TIER_KEYS:
        assert got.get(key) == want.get(key), key
    assert got["chunks_approx"] > 0
    energy = {k for k in got if k.startswith("energy_")}
    assert energy == {k for k in want if k.startswith("energy_")} != set()
    for k in energy:
        assert got[k] == want[k], k
    div = {k for k in got if k.startswith("divergence_")}
    assert div == {"divergence_steps", "divergence_max_ulp",
                   "divergence_kl_mean", "divergence_max_abs_diff"}
    assert got["divergence_steps"] == want["divergence_steps"] == 5
    assert got["divergence_max_ulp"] > 0
    lines = [ln for ln in out.splitlines() if ln.startswith("[divergence] ")]
    assert len(lines) == 1 and "max_ulp=" in lines[0]
    line = [ln for ln in out.splitlines() if ln.startswith("[continuous] ")]
    assert len(line) == 1 and "energy_energy_saving=" in line[0]


def test_mode_counts_split_and_reset():
    """`ops.mode_counts()` reads each kernel's launches by mode and
    `reset_counts()` clears them (on the CPU every call is a plain call,
    so the serving tests above leave them at 0)."""
    ops.reset_counts()
    assert ops.mode_counts() == {
        name: {"exact": 0, "approx": 0}
        for name in ("sa_matmul", "paged_decode", "prefill_attention",
                     "fp_emu")}
    ops._mm.MODE_LAUNCHES["approx"] += 3
    FE.MODE_LAUNCHES["exact"] += 1
    c = ops.mode_counts()
    assert c["sa_matmul"]["approx"] == 3 and c["fp_emu"]["exact"] == 1
    ops.reset_counts()
    assert all(v == 0 for m in ops.mode_counts().values()
               for v in m.values())
