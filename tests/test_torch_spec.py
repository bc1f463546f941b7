"""PyTorch port: self-speculative decoding against the JAX package.

The config is the reference's spec tests' (tests/test_serve.py): reduced
qwen2.5-14b with two layers a period, so two superblocks, under
`PrecisionPolicy(input_format="fp32")`. The JAX weights are carried over by
`params_from_numpy`. Greedy spec streams must equal the plain streams of
the same engine, and the port's streams and `spec_accept_hist` must equal
the JAX engine's.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import reduced_config  # noqa: E402
from repro.core import PrecisionPolicy, use_policy  # noqa: E402
from repro.launch import serve as jdrv  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.serve.engine import ServeEngine as JEngine  # noqa: E402
from repro.serve.scheduler import SlotScheduler as JSched  # noqa: E402
from repro.train import step as JS  # noqa: E402
from repro_torch.core import optflags  # noqa: E402
from repro_torch.core import precision as TP  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import serve as drv  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models.convert import (cache_from_numpy,  # noqa: E402
                                        params_from_numpy)
from repro_torch.serve.engine import ServeEngine  # noqa: E402
from repro_torch.serve.scheduler import SlotScheduler  # noqa: E402
from repro_torch.train import step as TS  # noqa: E402

torch.set_num_threads(2)
FP32_J = PrecisionPolicy(input_format="fp32")
FP32_T = TP.PrecisionPolicy(input_format="fp32")
# port vs JAX on one fp32 attention sub-layer or forward: the GEMMs' fp32
# sums may be ordered differently (ROADMAP R1), the residual stream is bf16
REL = 2.0 ** -5


@pytest.fixture(scope="module")
def setup():
    cfg = dataclasses.replace(
        reduced_config("qwen2.5-14b", layers_per_period=2), remat=False)
    with use_policy(FP32_J):
        jp = JM.init_params(jax.random.key(0), cfg)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    return cfg, jp, tp


def _prompts(cfg, lens, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab_size, n).tolist() for n in lens]


def _serve(engine_cls, sched_cls, pol_ctx, cfg, params, prompts, budgets, *,
           eos_id=-1, spec_k=0, draft_layers=None, kv_layout="paged",
           sync_every=4):
    with pol_ctx:
        eng = engine_cls(cfg, params, batch=2, cache_len=64, eos_id=eos_id,
                         sync_every=sync_every, kv_layout=kv_layout,
                         spec_k=spec_k, spec_draft_layers=draft_layers)
        sched = sched_cls(2, eos_id=eos_id)
        for p, n in zip(prompts, budgets):
            sched.submit(p, max_new_tokens=n)
        summary = eng.serve(sched)
    return eng, sched, summary


def _both(cfg, jp, tp, prompts, budgets, **kw):
    """(port engine, scheduler, summary), and the JAX scheduler."""
    _, jsched, _ = _serve(JEngine, JSched, use_policy(FP32_J), cfg, jp,
                          prompts, budgets, **kw)
    eng, sched, summary = _serve(ServeEngine, SlotScheduler,
                                 TP.use_policy(FP32_T), cfg, tp, prompts,
                                 budgets, **kw)
    return eng, sched, summary, jsched


def _by_rid(sched):
    return {r.rid: r.tokens for r in sched.finished}


# ---------------------------------------------------------------------------
# the reference's spec tests (tests/test_serve.py), held to the JAX engine
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kv_layout", ["paged", "ring"])
@pytest.mark.parametrize("draft_layers", [1, 2])
def test_spec_greedy_identical_to_plain(setup, kv_layout, draft_layers):
    """Greedy spec decoding emits the plain chunked decode's tokens
    whatever the draft depth; draft_layers=2 (the whole stack) accepts
    every draft. The port's streams and accept histogram equal the JAX
    engine's."""
    cfg, jp, tp = setup
    prompts = _prompts(cfg, [5, 9, 7], seed=17)
    budgets = [10, 12, 8]          # 3 requests / 2 slots: refill mid-serve
    _, plain, _ = _serve(ServeEngine, SlotScheduler, TP.use_policy(FP32_T),
                         cfg, tp, prompts, budgets, kv_layout=kv_layout)
    eng, spec, summary, jspec = _both(cfg, jp, tp, prompts, budgets,
                                      kv_layout=kv_layout, spec_k=4,
                                      draft_layers=draft_layers)
    assert eng.spec_decoding_on()
    assert _by_rid(spec) == _by_rid(plain) == _by_rid(jspec)
    assert spec.spec_accept_hist == jspec.spec_accept_hist
    assert spec.spec_drafted == jspec.spec_drafted > 0
    assert summary["spec_k"] == 4
    assert summary["spec_draft_layers"] == draft_layers
    assert summary["spec_iters"] > 0
    if draft_layers == 2:          # draft stack == verify stack
        assert summary["spec_accept_rate"] == 1.0
    if kv_layout == "paged":
        assert summary["pages_leaked"] == 0


def test_spec_staggered_slots_mixed_accept_lengths(setup):
    """Slots at different depths resolve their own accept lengths; a real
    early exit gives a mix of lengths, full rejection included."""
    cfg, jp, tp = setup
    prompts = _prompts(cfg, [4, 11, 6, 9], seed=23)
    budgets = [12, 10, 8, 12]
    _, plain, _ = _serve(ServeEngine, SlotScheduler, TP.use_policy(FP32_T),
                         cfg, tp, prompts, budgets)
    _, spec, _, jspec = _both(cfg, jp, tp, prompts, budgets, spec_k=4,
                              draft_layers=1)
    assert _by_rid(spec) == _by_rid(plain) == _by_rid(jspec)
    assert spec.spec_accept_hist == jspec.spec_accept_hist
    assert len(spec.spec_accept_hist) >= 2


def test_spec_reject_all_falls_back_to_one_token(setup):
    """A reject-all iteration still emits the verify's first row."""
    cfg, jp, tp = setup
    prompts = _prompts(cfg, [6, 8], seed=29)
    _, plain, _ = _serve(ServeEngine, SlotScheduler, TP.use_policy(FP32_T),
                         cfg, tp, prompts, [8, 8])
    _, spec, summary, jspec = _both(cfg, jp, tp, prompts, [8, 8], spec_k=4,
                                    draft_layers=1)
    assert spec.spec_accept_hist.get(0, 0) > 0
    assert spec.spec_accept_hist == jspec.spec_accept_hist
    assert _by_rid(spec) == _by_rid(plain) == _by_rid(jspec)
    assert summary["spec_accept_rate"] < 1.0
    assert summary["generated_tokens"] == 16


def test_spec_eos_mid_draft_truncates_and_frees(setup):
    """EOS inside an accepted draft block: the tokens after it are
    dropped, the request retires with 'eos' and no page leaks. The EOS is
    the third token of the request's plain stream, as in the reference's
    test."""
    cfg, jp, tp = setup
    prompts = _prompts(cfg, [6, 8], seed=31)
    _, probe, _ = _serve(ServeEngine, SlotScheduler, TP.use_policy(FP32_T),
                         cfg, tp, prompts, [10, 10])
    eos = _by_rid(probe)[1][2]
    assert eos not in _by_rid(probe)[1][:2]
    _, plain, _ = _serve(ServeEngine, SlotScheduler, TP.use_policy(FP32_T),
                         cfg, tp, prompts, [12, 12], eos_id=eos)
    _, spec, summary, jspec = _both(cfg, jp, tp, prompts, [12, 12],
                                    eos_id=eos, spec_k=4, draft_layers=2)
    spec_by = {r.rid: r for r in spec.finished}
    assert _by_rid(spec) == _by_rid(plain) == _by_rid(jspec)
    assert spec_by[1].finish_reason == "eos"
    assert spec_by[1].tokens[-1] == eos
    assert spec_by[1].n_generated == 3
    assert summary["pages_leaked"] == 0


def test_spec_chunk_jit_key_includes_spec_k(setup):
    """The chunk cache keys on spec_k beside (steps, greedy, mode), 0 for
    the plain chunk: the JAX engine's key set exactly."""
    cfg, _, tp = setup
    engine = ServeEngine(cfg, tp, batch=2, cache_len=64, eos_id=-1,
                         spec_k=4)
    plain = engine._chunk_fn(1, True)
    spec = engine._spec_chunk_fn(1, True, "exact", 4)
    assert plain is not spec
    assert set(engine._chunks) == {(1, True, "exact", 0),
                                   (1, True, "exact", 4)}


def test_spec_gating_auto_disables(setup, monkeypatch):
    """spec_k=0, a single-superblock stack, a ring shorter than the
    verify block and the REPRO_SPEC_DECODE kill switch all turn it off;
    the default draft depth is half the stack."""
    cfg2, _, tp2 = setup
    cfg1 = dataclasses.replace(reduced_config("qwen2.5-14b"), remat=False)
    tp1 = TM.init_params(cfg1, seed=0, device="cpu")
    assert not ServeEngine(cfg2, tp2, batch=2, cache_len=64,
                           spec_k=0).spec_decoding_on()
    assert not ServeEngine(cfg1, tp1, batch=2, cache_len=64,
                           spec_k=4).spec_decoding_on()
    assert not ServeEngine(cfg2, tp2, batch=2, cache_len=4, kv_layout="ring",
                           spec_k=4).spec_decoding_on()
    on = ServeEngine(cfg2, tp2, batch=2, cache_len=64, spec_k=4)
    assert on.spec_decoding_on() and on.spec_draft_layers == 1
    monkeypatch.setenv("REPRO_SPEC_DECODE", "0")
    assert not on.spec_decoding_on()


def test_spec_k_from_env(setup, monkeypatch):
    """REPRO_SPEC_K arms the engine when the constructor leaves spec_k
    unset; a negative value fails fast."""
    cfg, _, tp = setup
    monkeypatch.setenv("REPRO_SPEC_K", "3")
    eng = ServeEngine(cfg, tp, batch=2, cache_len=64)
    assert eng.spec_k == 3 and eng.spec_decoding_on()
    monkeypatch.setenv("REPRO_SPEC_K", "-1")
    with pytest.raises(ValueError, match="REPRO_SPEC_K"):
        optflags.spec_k()
    with pytest.raises(ValueError, match="REPRO_SPEC_K"):
        ServeEngine(cfg, tp, batch=2, cache_len=64)


def test_spec_sampled_stream_is_seed_pure(setup):
    """Sampling under spec draws the verify's targets from the explicit
    generator: the same seed gives the same stream."""
    cfg, _, tp = setup
    prompts = _prompts(cfg, [5, 7], seed=3)
    out = []
    for _ in range(2):
        with TP.use_policy(FP32_T):
            eng = ServeEngine(cfg, tp, batch=2, cache_len=64, eos_id=-1,
                              sync_every=4, spec_k=2)
            sched = SlotScheduler(2, eos_id=-1)
            for p in prompts:
                sched.submit(p, max_new_tokens=6)
            eng.serve(sched, greedy=False,
                      rng=torch.Generator().manual_seed(5))
        out.append(_by_rid(sched))
    assert out[0] == out[1]
    assert all(len(t) == 6 for t in out[0].values())


# ---------------------------------------------------------------------------
# the layer and the steps against the JAX package
# ---------------------------------------------------------------------------

def _jax_pool(cfg, jp, prompts, n_pages=9, psz=8, max_seq=32):
    """A JAX paged pool with each prompt prefilled into its slot through
    the reference engine's `_insert_impl`."""
    pool = JM.init_cache(cfg, len(prompts), max_seq, dtype=jnp.float32,
                         paged=(n_pages, psz))
    nxt = 1
    for slot, prompt in enumerate(prompts):
        cap = -(-len(prompt) // psz) * psz
        with use_policy(FP32_J):
            _, frag, _ = JM.forward(
                jp, cfg, jnp.asarray(prompt, jnp.int32)[None],
                cache=JM.init_cache(cfg, 1, cap, dtype=jnp.float32),
                last_only=True)
        npg = cap // psz
        row = np.full((max_seq // psz,), -1, np.int32)
        row[:npg] = np.arange(nxt, nxt + npg)
        nxt += npg
        pool = JEngine._insert_impl(pool, frag, slot, jnp.asarray(row),
                                    jnp.asarray(0, jnp.int32))
    return pool


def _jax_ring(cfg, jp, prompts, S=32):
    ring = JM.init_cache(cfg, len(prompts), S, dtype=jnp.float32)
    for slot, prompt in enumerate(prompts):
        with use_policy(FP32_J):
            _, one, _ = JM.forward(
                jp, cfg, jnp.asarray(prompt, jnp.int32)[None],
                cache=JM.init_cache(cfg, 1, S, dtype=jnp.float32),
                last_only=True)
        ring = JEngine._insert_impl(ring, one, slot)
    return ring


def _caches(cfg, jp, layout, prompts):
    jc = (_jax_pool(cfg, jp, prompts) if layout == "paged"
          else _jax_ring(cfg, jp, prompts))
    return jc, cache_from_numpy(jax.tree.map(np.asarray, jc), "cpu")


def _close(ref, got, rel=REL):
    ref = np.asarray(ref)
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert np.abs(ref - got).max() <= rel * np.abs(ref).max()


def _check_logits(ref, got, vocab):
    """Within the forward bound, and the same argmax wherever the top two
    logits are further apart than twice the bound (a near tie may flip:
    the residual stream is bf16, R1)."""
    r, g = np.asarray(ref)[..., :vocab], got[..., :vocab].numpy()
    bound = REL * np.abs(r).max()
    assert np.abs(r - g).max() <= bound
    top2 = np.sort(r, axis=-1)[..., -2:]
    decided = (top2[..., 1] - top2[..., 0]) > 2 * bound
    assert (r.argmax(-1) == g.argmax(-1))[decided].all()


def _same_cache(cfg, jc, tc):
    for j in range(cfg.stack_period):
        jkv, tkv = jc[j]["kv"], tc[j]["kv"]
        for field in jkv._fields:
            ref = np.asarray(getattr(jkv, field))
            got = getattr(tkv, field).numpy()
            if ref.dtype == np.int32:
                assert np.array_equal(ref, got), field
            else:
                _close(ref, got)


@pytest.mark.parametrize("layout,impl", [("paged", "fused"),
                                         ("paged", "gather"),
                                         ("ring", "gather")])
def test_decode_multi_attention_block_matches_jax(setup, monkeypatch,
                                                  layout, impl):
    """`attention_block(decode_multi=True)` at T = 3 against the
    reference's: each of the T rows writes its K/V at pos + t (slot 1's
    last row falls past its mapped pages, onto the trash page) and
    attends as the decode step at that position."""
    cfg, jp, tp = setup
    monkeypatch.setenv("REPRO_DECODE_ATTN", impl)
    prompts = _prompts(cfg, [11, 14], seed=2)
    jc, tc = _caches(cfg, jp, layout, prompts)
    T = 3
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, T, cfg.d_model)).astype(np.float32)
    pos = np.array([len(p) for p in prompts], np.int32)
    positions = pos[:, None] + np.arange(T, dtype=np.int32)
    p0 = jax.tree.map(lambda a: a[0], jp["layers"][0])
    t0 = TM.tree_map(lambda a: a[0], tp["layers"][0])
    jkv = jax.tree.map(lambda a: a[0], jc[0]["kv"])
    tkv = type(tc[0]["kv"])(*(a[0] for a in tc[0]["kv"]))
    meta = cfg.layer_kind(0)
    with use_policy(FP32_J):
        jo, jnew = JL.attention_block(
            jnp.asarray(x), p0["attn"], cfg, meta, jnp.asarray(positions),
            cache=jkv, pos=jnp.asarray(pos), decode_multi=True)
    with TP.use_policy(FP32_T):
        to, tnew = TL.attention_block(
            torch.from_numpy(x), t0["attn"], cfg, meta,
            torch.from_numpy(positions), cache=tkv, decode_multi=True)
    assert tnew is tkv                      # written in place
    assert tuple(to.shape) == (2, T, cfg.d_model)
    _close(jo, to, 1e-4)
    for field in jnew._fields:
        ref = np.asarray(getattr(jnew, field))
        got = getattr(tnew, field).numpy()
        if ref.dtype == np.int32:
            assert np.array_equal(ref, got), field
        else:
            _close(ref, got, 1e-4)


@pytest.mark.parametrize("layout", ["paged", "ring"])
def test_draft_and_verify_steps_match_jax(setup, layout):
    """`make_draft_step` (the first superblock) and `make_verify_step`
    (the whole stack, decode_multi) against the reference's steps on the
    same caches: logits within the forward bound, every position and block
    table equal, K/V within the bound."""
    cfg, jp, tp = setup
    prompts = _prompts(cfg, [11, 6], seed=5)
    pos = np.array([len(p) for p in prompts], np.int32)
    tok = np.array([[7], [19]], np.int32)
    block = np.array([[7, 3, 9, 4], [19, 2, 2, 8]], np.int32)
    for name, jstep, tstep, toks in (
            ("draft", JS.make_draft_step(cfg, 1),
             TS.make_draft_step(cfg, 1), tok),
            ("verify", JS.make_verify_step(cfg), TS.make_verify_step(cfg),
             block)):
        jc, tc = _caches(cfg, jp, layout, prompts)
        with use_policy(FP32_J):
            jl, jnew = jstep(jp, jnp.asarray(toks), jc, jnp.asarray(pos))
        with TP.use_policy(FP32_T):
            tl, tnew = tstep(tp, torch.from_numpy(toks), tc,
                             torch.from_numpy(pos))
        assert tuple(tl.shape) == (2, toks.shape[1], cfg.padded_vocab), name
        _check_logits(jl, tl, cfg.vocab_size)
        _same_cache(cfg, jnew, tnew)


def test_draft_writes_only_its_superblocks(setup):
    """The early-exit draft runs the first superblock of the full params
    and cache: its KV writes land there and superblock 1 is untouched."""
    cfg, jp, tp = setup
    _, tc = _caches(cfg, jp, "paged", _prompts(cfg, [11, 6], seed=5))
    before = TM.tree_map(torch.clone, tc)
    with TP.use_policy(FP32_T):
        TS.make_draft_step(cfg, 1)(tp, torch.tensor([[7], [19]]), tc,
                                   torch.tensor([11, 6]))
    for j in range(cfg.stack_period):
        for new, old in zip(tc[j]["kv"], before[j]["kv"]):
            assert torch.equal(new[1], old[1])
        assert not torch.equal(tc[j]["kv"].k[0], before[j]["kv"].k[0])


@pytest.mark.parametrize("layout", ["paged", "ring"])
@pytest.mark.parametrize("impl", ["fused", "gather"])
@pytest.mark.parametrize("fmt", ["fp32", "bf16"])
def test_verify_rows_equal_sequential_decode_bit_for_bit(setup, monkeypatch,
                                                         layout, impl, fmt):
    """The exactness argument on the port's CPU path: verify row t's
    logits equal the t-th of k+1 sequential decode steps bit for bit, and
    the two leave the same cache. The slots map different pages, so a
    block table repeated in the wrong order (`Tensor.repeat` for
    `jnp.repeat`) would read the other slot's pages."""
    cfg, _, tp = setup
    monkeypatch.setenv("REPRO_DECODE_ATTN", impl)
    g = torch.Generator().manual_seed(0)
    pre = torch.randint(0, cfg.vocab_size, (2, 6), generator=g,
                        dtype=torch.int32)
    block = torch.randint(0, cfg.vocab_size, (2, 4), generator=g,
                          dtype=torch.int32)
    with TP.use_policy(TP.PrecisionPolicy(input_format=fmt)):
        eng = ServeEngine(cfg, tp, batch=2, cache_len=32, kv_layout=layout,
                          page_size=8)
        if layout == "paged":
            cache = eng.new_pool()
            for c in cache:
                c["kv"].block_table[:, 0, :4] = torch.arange(1, 5)
                c["kv"].block_table[:, 1, :4] = torch.arange(5, 9)
        else:
            cache = eng.new_cache()
        step = TS.make_serve_step(cfg)
        zero = torch.zeros((2,), dtype=torch.int32)
        for t in range(6):
            _, cache = step(tp, pre[:, t:t + 1], cache, zero + t)
        pos = zero + 6
        folded = TM.tree_map(torch.clone, cache)
        vl, folded = TS.make_verify_step(cfg)(tp, block, folded, pos)
        rows = []
        for t in range(4):
            lg, cache = step(tp, block[:, t:t + 1], cache, pos + t)
            rows.append(lg[:, 0])
    assert torch.equal(vl, torch.stack(rows, 1))
    for a, b in zip(TM.tree_leaves(folded), TM.tree_leaves(cache)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("mode", ["exact", "approx"])
def test_spec_chunk_matches_jax_chunk(setup, mode):
    """One spec chunk (2 iterations, k = 3) from the same post-prefill
    pool in each engine, in exact and approx mode: the same targets and
    accept lengths; the approx chunk's GEMMs run `mode="approx"`."""
    cfg, jp, tp = setup
    prompts = _prompts(cfg, [11, 6], seed=6)
    jc, tc = _caches(cfg, jp, "paged", prompts)
    pos = np.array([len(p) for p in prompts], np.int32)
    tok = np.array([7, 19], np.int32)
    jeng = JEngine(cfg, jp, batch=2, cache_len=32, spec_k=3,
                   spec_draft_layers=1)
    with use_policy(FP32_J):
        out = jeng._spec_chunk_fn(2, True, mode, 3)(
            jp, jnp.asarray(tok), jc, jnp.asarray(pos), None,
            jax.random.key(0))
    jtoks, jaccs = np.asarray(out[4]), np.asarray(out[5])
    teng = ServeEngine(cfg, tp, batch=2, cache_len=32, spec_k=3,
                       spec_draft_layers=1)
    modes = []
    real = ops._mm.sa_matmul_ref

    def spy(a, w, *args, **kw):
        modes.append(kw.get("mode", "exact"))
        return real(a, w, *args, **kw)

    ops._mm.sa_matmul_ref = spy
    try:
        with TP.use_policy(TP.PrecisionPolicy(input_format="fp32",
                                              backend="cuda")):
            tok_o, _, pos_o, _, toks, accs = teng._spec_chunk_fn(
                2, True, mode, 3)(tp, torch.from_numpy(tok), tc,
                                  torch.from_numpy(pos), None, None)
    finally:
        ops._mm.sa_matmul_ref = real
    assert tuple(toks.shape) == (2, 2, 4) and tuple(accs.shape) == (2, 2)
    assert np.array_equal(toks.numpy(), jtoks)
    assert np.array_equal(accs.numpy(), jaccs)
    assert np.array_equal(pos_o.numpy(), np.asarray(out[2]))
    assert np.array_equal(tok_o.numpy(), np.asarray(out[0]))
    # 2 iterations x (3 one-superblock drafts + 1 full verify)
    per_sb = 7 * cfg.stack_period
    assert len(modes) == 2 * (3 * (per_sb + 1) + 2 * per_sb + 1)
    assert set(modes) == {mode}


def test_spec_timing_probe_reports_both_phases(setup):
    cfg, _, tp = setup
    with TP.use_policy(FP32_T):
        eng = ServeEngine(cfg, tp, batch=2, cache_len=64, spec_k=2)
        got = eng.spec_timing_probe(reps=1)
    assert set(got) == {"draft_s", "verify_s"}
    assert all(v > 0 for v in got.values())


# ---------------------------------------------------------------------------
# the driver
# ---------------------------------------------------------------------------

DRV = ["--arch", "qwen2.5-14b", "--reduced", "--layers-per-period", "2",
       "--batch", "2", "--requests", "4", "--max-new", "6",
       "--prompt-lens", "6,10", "--rate", "0", "--sync-every", "4",
       "--seed", "1"]


def test_driver_spec_k_matches_plain_and_jax_driver(capsys, monkeypatch):
    """`--spec-k 4`: the digest equals `REPRO_SPEC_DECODE=0`'s, and the
    JAX driver's on its weights, with the same accept accounting; the
    `[spec]` line scales the probe's split by `spec_iters`."""
    with use_policy(FP32_J):
        want = jdrv.main(DRV + ["--spec-k", "4"])
        jp = JM.init_params(jax.random.key(1), reduced_config(
            "qwen2.5-14b", layers_per_period=2))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    capsys.readouterr()
    with TP.use_policy(FP32_T):
        got = drv.main(DRV + ["--device", "cpu", "--spec-k", "4"], params=tp)
        out = capsys.readouterr().out
        monkeypatch.setenv("REPRO_SPEC_DECODE", "0")
        plain = drv.main(DRV + ["--device", "cpu", "--spec-k", "4"],
                         params=tp)
    assert got["stream_digest"] == plain["stream_digest"]
    assert got["stream_digest"] == want["stream_digest"]
    for key in ("spec_k", "spec_draft_layers", "spec_iters", "spec_drafted",
                "spec_accepted", "spec_accept_rate"):
        assert got[key] == want[key], key
    assert sum(got["spec_accept_hist"].values()) * 4 == got["spec_drafted"]
    assert "spec_k" not in plain
    assert got["spec_draft_s"] > 0 and got["spec_verify_s"] > 0
    lines = [ln for ln in out.splitlines() if ln.startswith("[spec] ")]
    assert len(lines) == 1 and "draft_layers=1/2" in lines[0]


def test_spec_warmup_is_seed_pure():
    """`--spec-warmup`: the same seed trains the same weights twice, bit
    for bit, and the weights move."""
    cfg = reduced_config("qwen2.5-14b", layers_per_period=2)
    runs = []
    for _ in range(2):
        params = TM.init_params(cfg, seed=0, device="cpu",
                                dtype=torch.float32)
        runs.append(drv.spec_warmup_train(cfg, params, 3, seed=0))
    init = TM.init_params(cfg, seed=0, device="cpu", dtype=torch.float32)
    a, b = TM.tree_leaves(runs[0]), TM.tree_leaves(runs[1])
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not all(torch.equal(x, y)
                   for x, y in zip(a, TM.tree_leaves(init)))


def test_driver_spec_warmup_serves(capsys):
    summary = drv.main(DRV + ["--device", "cpu", "--spec-k", "2",
                              "--spec-warmup", "2", "--requests", "2"])
    out = capsys.readouterr().out
    assert summary["spec_k"] == 2 and summary["requests"] == 2
    assert any(ln.startswith("[spec-warmup] steps=2") for ln in
               out.splitlines())
