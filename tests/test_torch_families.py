"""PyTorch port: the phi3, gemma2 and gemma3 families against the JAX
package on the same numpy inputs (reduced configs, weights drawn by the JAX
package from key 1 and carried over by `params_from_numpy`).

What these families add to the dense decoder: a tied lm_head that reads
the embedding table transposed (gemma2, gemma3), GeGLU, the embedding
scale, attention and final softcaps (gemma2), and local-window layers,
whose dense rings of `window` rows live beside the page pools in the
paged layout (gemma2 1:1, gemma3 5:1). phi3 is a plain dense decoder at
g = 4.

Tolerances are tests/test_torch_model.py's: logits within 2⁻⁵·max|logit|
(the residual stream is bf16 in both frameworks, so an fp32 last-bit
difference can flip a bf16 rounding), K/V rows a forward wrote within
2⁻⁵·max|K|; integer state, untouched rows and the splices (pure data
movement) bit for bit. Token streams are compared under the fp32 policy
at seed 1 (R1: away from near-tie argmaxes).
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
from repro.models import model as JM  # noqa: E402
from repro.serve.engine import ServeEngine as JEngine  # noqa: E402
from repro.serve.scheduler import SlotScheduler as JSched  # noqa: E402
from repro_torch.core import precision as TP  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models.convert import (cache_from_numpy,  # noqa: E402
                                        params_from_numpy)
from repro_torch.models.layers import KVCache, PagedKVCache  # noqa: E402
from repro_torch.serve.engine import ServeEngine  # noqa: E402
from repro_torch.serve.scheduler import SlotScheduler  # noqa: E402

torch.set_num_threads(2)
REL = 2.0 ** -5
ARCHS = ("phi3-medium-14b", "gemma2-9b", "gemma3-12b")
FP32_J = PrecisionPolicy(input_format="fp32")


def _cfg(arch, **kw):
    return dataclasses.replace(reduced_config(arch), remat=False, **kw)


def _weights(cfg):
    jp = JM.init_params(jax.random.key(1), cfg)
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")


@pytest.fixture(scope="module")
def families():
    return {arch: (_cfg(arch), *_weights(_cfg(arch))) for arch in ARCHS}


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _check_logits(ref, got, vocab):
    ref, got = _np(ref), _np(got)
    assert np.isneginf(got[..., vocab:]).all()
    r, g = ref[..., :vocab], got[..., :vocab]
    bound = REL * np.abs(r).max()
    assert np.abs(r - g).max() <= bound
    top2 = np.sort(r, axis=-1)[..., -2:]
    decided = (top2[..., 1] - top2[..., 0]) > 2 * bound
    assert (r.argmax(-1) == g.argmax(-1))[decided].all()


def _prompts(cfg, lens, seed=1):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab_size, n).tolist() for n in lens]


# ---------------------------------------------------------------------------
# the model: parameters, prefill, a paged decode step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_tree_matches_jax(arch):
    """The port's tree has the JAX tree's keys and shapes; a tied config
    has no `lm_head`."""
    cfg = _cfg(arch)
    tp = TM.init_params(cfg, seed=0, device="cpu")
    jshape = jax.eval_shape(lambda k: JM.init_params(k, cfg),
                            jax.random.key(0))
    flat = jax.tree_util.tree_flatten_with_path
    jflat = {jax.tree_util.keystr(p): x.shape for p, x in flat(jshape)[0]}
    tflat = {jax.tree_util.keystr(p): tuple(x.shape) for p, x in
             flat(tp)[0]}
    assert jflat == tflat
    assert ("lm_head" in tp) == (not cfg.tie_embeddings)


@pytest.mark.parametrize("fmt", ["fp32", "bf16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_logits_match_jax(families, arch, fmt):
    """Prompts longer than the reduced window of 8: the local layers' masks
    and rings bite, the tied head reads embedᵀ."""
    cfg, jp, tp = families[arch]
    toks = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 13)).astype(np.int32)
    with use_policy(PrecisionPolicy(input_format=fmt)):
        jl, jc, _ = JM.forward(jp, cfg, jnp.asarray(toks), last_only=True,
                               cache=JM.init_cache(cfg, 2, 16,
                                                   dtype=jnp.float32))
    with TP.use_policy(TP.PrecisionPolicy(input_format=fmt)):
        tl, tc, _ = TM.forward(tp, cfg, torch.from_numpy(toks),
                               last_only=True,
                               cache=TM.init_cache(cfg, 2, 16,
                                                   dtype=torch.float32,
                                                   device="cpu"))
    _check_logits(jl, tl, cfg.vocab_size)
    for j in range(cfg.stack_period):
        jkv, tkv = jc[j]["kv"], tc[j]["kv"]
        assert tuple(tkv.k.shape) == jkv.k.shape
        assert np.array_equal(np.asarray(jkv.positions), tkv.positions)
        assert np.abs(np.asarray(jkv.k) - tkv.k.numpy()).max() <= (
            REL * np.abs(np.asarray(jkv.k)).max())


def _jax_pool(cfg, jp, prompts, n_pages=13, psz=4, max_seq=32):
    """A JAX paged cache (pools and local rings) with each prompt
    prefilled through a fragment floored at the window and spliced into
    its slot by the reference engine's `_insert_impl`."""
    pool = JM.init_cache(cfg, len(prompts), max_seq, dtype=jnp.float32,
                         paged=(n_pages, psz))
    nxt = 1
    for slot, prompt in enumerate(prompts):
        cap = -(-max(len(prompt), cfg.window) // psz) * psz
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


@pytest.mark.parametrize("arch", ("gemma2-9b", "gemma3-12b"))
def test_paged_decode_step_matches_jax(families, arch):
    """One decode step over a mixed cache (pool leaves for the global
    layers, dense rings of `window` rows for the local ones) carried over
    from JAX: every row the step did not write, the positions and the
    block tables stay bit-equal to JAX's, the written K/V rows within
    2⁻⁵·max|K|, the logits within 2⁻⁵·max."""
    cfg, jp, tp = families[arch]
    prompts = _prompts(cfg, (11, 6), seed=2)
    pool = _jax_pool(cfg, jp, prompts)
    kinds = {type(pool[j]["kv"]).__name__ for j in range(cfg.stack_period)}
    assert kinds == {"KVCache", "PagedKVCache"}
    t_pool = cache_from_numpy(jax.tree.map(np.asarray, pool), "cpu")
    before = jax.tree.map(np.asarray, pool)
    tok = np.array([[5], [17]], np.int32)
    pos = np.array([len(p) for p in prompts], np.int32)
    with use_policy(FP32_J):
        jl, jc, _ = JM.forward(jp, cfg, jnp.asarray(tok), cache=pool,
                               pos=jnp.asarray(pos))
    with TP.use_policy(TP.PrecisionPolicy(input_format="fp32")):
        tl, tc, _ = TM.forward(tp, cfg, torch.from_numpy(tok),
                               cache=t_pool, pos=torch.from_numpy(pos))
    _check_logits(jl, tl, cfg.vocab_size)
    for j in range(cfg.stack_period):
        jkv, tkv, b = jc[j]["kv"], tc[j]["kv"], before[j]["kv"]
        assert type(tkv).__name__ == type(jkv).__name__
        for field in jkv._fields:
            a, g = np.asarray(getattr(jkv, field)), getattr(tkv, field).numpy()
            if field in ("positions", "block_table"):
                assert np.array_equal(a, g), field
                continue
            untouched = np.asarray(getattr(b, field)) == a
            assert np.array_equal(a[untouched], g[untouched]), field
            assert np.abs(a - g).max() <= REL * np.abs(a).max(), field


# ---------------------------------------------------------------------------
# the engine's splices on mixed trees
# ---------------------------------------------------------------------------

def _filled(kv, rng, positions):
    """A cache leaf group with random floats, positions from
    `positions(shape)` and its block table (if any) as it was."""
    out = {}
    for name, f in zip(kv._fields, kv):
        if name == "block_table":
            out[name] = f
        elif name == "positions":
            out[name] = jnp.asarray(positions(f.shape), f.dtype)
        else:
            out[name] = jnp.asarray(rng.standard_normal(f.shape), f.dtype)
    return type(kv)(**out)


@pytest.fixture(scope="module")
def mixed():
    """A gemma3 paged cache (5 local rings and 1 pool a superblock) with
    random rings and recycled pool pages holding stale positions, and a
    fragment floored at the window with random K/V, in JAX's types."""
    cfg = _cfg("gemma3-12b")
    rng = np.random.default_rng(3)
    n_pages, psz, P = 9, 4, 4
    pool = JM.init_cache(cfg, 2, P * psz, dtype=jnp.float32,
                         paged=(n_pages, psz))
    pool = tuple({"kv": _filled(c["kv"], rng,
                                lambda s: rng.integers(0, 50, s))}
                 for c in pool)
    frag = JM.init_cache(cfg, 1, cfg.window, dtype=jnp.float32)
    frag = tuple({"kv": _filled(c["kv"], rng, lambda s: np.broadcast_to(
        np.arange(s[-1]), s))} for c in frag)
    return cfg, pool, frag


def _torch(tree):
    return cache_from_numpy(jax.tree.map(np.asarray, tree), "cpu")


def _assert_equal_trees(ref, got):
    for j, (rc, gc) in enumerate(zip(ref, got)):
        assert type(gc["kv"]).__name__ == type(rc["kv"]).__name__
        for field in rc["kv"]._fields:
            a = np.asarray(getattr(rc["kv"], field))
            b = getattr(gc["kv"], field).numpy()
            assert np.array_equal(a, b), (j, field)


@pytest.mark.parametrize("keep", [0, 1])
@pytest.mark.parametrize("splice", ["scatter", "bind", "insert"])
def test_splices_on_mixed_trees_match_jax_bit_exact(mixed, splice, keep):
    """`_scatter_impl` writes the pools and passes the rings, `_bind_impl`
    maps the pools' block tables and passes the rings, `_insert_impl` does
    both and row-splices every ring into the slot: pure data movement,
    bit-exact against the JAX engine's."""
    cfg, pool, frag = mixed
    row = np.array([3, 5, 2, -1], np.int32)
    t_pool, t_frag = _torch(pool), _torch(frag)
    if splice == "scatter":
        ref = JEngine._scatter_impl(pool, frag, jnp.asarray(row),
                                    jnp.asarray(keep, jnp.int32))
        got = ServeEngine._scatter_impl(t_pool, t_frag,
                                        torch.from_numpy(row), keep)
    elif splice == "bind":
        ref = JEngine._bind_impl(pool, jnp.asarray(row), 1)
        got = ServeEngine._bind_impl(t_pool, torch.from_numpy(row), 1)
    else:
        ref = JEngine._insert_impl(pool, frag, 1, jnp.asarray(row),
                                   jnp.asarray(keep, jnp.int32))
        got = ServeEngine._insert_impl(t_pool, t_frag, 1,
                                       torch.from_numpy(row), keep)
    _assert_equal_trees(ref, got)


def test_prefix_load_and_clear_pass_mixed_trees(mixed):
    """Prefix caching is off where a stack has local rings, but the
    prefix load and the slot clear run on a mixed tree: the load fills the
    fragment's pool-backed leaves from pages (its rings untouched, as in
    the JAX engine), the clear unmaps the pools' slot and masks the rings'
    slot row."""
    cfg, pool, frag = mixed
    src = np.array([3, 5], np.int32)
    ref = JEngine._load_prefix_impl(frag, pool, jnp.asarray(src), 6)
    got = ServeEngine._load_prefix_impl(_torch(frag), _torch(pool),
                                        torch.from_numpy(src), 6)
    _assert_equal_trees(ref, got)
    cleared = ServeEngine._clear_slot_impl(_torch(pool), 1)
    for c in cleared:
        kv = c["kv"]
        if isinstance(kv, PagedKVCache):
            assert (kv.block_table[:, 1] == -1).all()
        else:
            assert isinstance(kv, KVCache)
            assert (kv.positions[:, 1] == -1).all()
            assert (kv.positions[:, 0] >= 0).all()


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

def _serve(engine_cls, sched_cls, cfg, params, prompts, budgets, layout,
           **kw):
    eng = engine_cls(cfg, params, batch=2, cache_len=32, eos_id=-1,
                     sync_every=2, kv_layout=layout, page_size=8, **kw)
    sched = sched_cls(2, eos_id=-1)
    for p, n in zip(prompts, budgets):
        sched.submit(p, max_new_tokens=n)
    summary = eng.serve(sched)
    return {r.rid: r.tokens for r in sched.finished}, summary


@pytest.fixture(scope="module")
def gemma3_streams(families):
    """gemma3's stream (prompts of 6-14 tokens against the window of 8,
    three requests over two slots: a refill) through the JAX engine and
    the port's paged and ring engines, under the fp32 policy."""
    cfg, jp, tp = families["gemma3-12b"]
    prompts = _prompts(cfg, (12, 6, 14), seed=2)
    budgets = (8, 3, 5)
    with use_policy(FP32_J):
        ref, _ = _serve(JEngine, JSched, cfg, jp, prompts, budgets, "paged")
    out = {}
    with TP.use_policy(TP.PrecisionPolicy(input_format="fp32")):
        for layout in ("paged", "ring"):
            out[layout] = _serve(ServeEngine, SlotScheduler, cfg, tp,
                                 prompts, budgets, layout)
    return ref, out, budgets


def test_gemma3_serve_matches_jax_engine(gemma3_streams):
    ref, out, budgets = gemma3_streams
    got, summary = out["paged"]
    assert got == ref
    assert [len(got[i]) for i in sorted(got)] == list(budgets)
    assert summary["pages_leaked"] == 0
    assert summary["nonfinite_logits"] == 0
    assert "prefix_hits" not in summary       # the window turns it off


def test_gemma3_paged_serve_equals_ring_serve(gemma3_streams):
    _, out, _ = gemma3_streams
    assert out["paged"][0] == out["ring"][0]


@pytest.mark.parametrize("arch", ("phi3-medium-14b", "gemma2-9b"))
def test_serve_paged_equals_ring(families, arch):
    """phi3 (no window) and gemma2 (1:1 local:global, softcaps) through
    the port's paged and ring engines: one token stream."""
    cfg, _, tp = families[arch]
    prompts = _prompts(cfg, (12, 6, 14), seed=2)
    with TP.use_policy(TP.PrecisionPolicy(input_format="fp32")):
        paged, s = _serve(ServeEngine, SlotScheduler, cfg, tp, prompts,
                          (6, 3, 4), "paged")
        ring, _ = _serve(ServeEngine, SlotScheduler, cfg, tp, prompts,
                         (6, 3, 4), "ring")
    assert paged == ring
    assert s["pages_leaked"] == 0 and s["nonfinite_logits"] == 0


def test_local_only_pattern_serves_like_jax():
    """Every layer local (window 8 < max_seq_len): the paged cache holds no
    pool leaf at all, and the engine still serves, paged equal to ring and
    to the JAX engine."""
    cfg = _cfg("gemma3-12b", attn_pattern=("local",), num_layers=2)
    jp, tp = _weights(cfg)
    pool = TM.init_cache(cfg, 2, 32, dtype=torch.float32, device="cpu",
                         paged=(9, 8))
    assert all(isinstance(c["kv"], KVCache) for c in pool)
    # seed 1 (R1): the prompts of seed 2 part from the JAX engine at a
    # near tie (top two logits 4e-4 apart, under the 2⁻⁵·max bound)
    prompts = _prompts(cfg, (12, 6, 14), seed=1)
    with use_policy(FP32_J):
        ref, _ = _serve(JEngine, JSched, cfg, jp, prompts, (5, 3, 4),
                        "paged")
    with TP.use_policy(TP.PrecisionPolicy(input_format="fp32")):
        paged, s = _serve(ServeEngine, SlotScheduler, cfg, tp, prompts,
                          (5, 3, 4), "paged")
        ring, _ = _serve(ServeEngine, SlotScheduler, cfg, tp, prompts,
                         (5, 3, 4), "ring")
    assert paged == ring == ref
    assert s["pages_leaked"] == 0


def test_gemma3_generate_and_probe_over_local_rings(families):
    """`generate()` (every leaf a dense ring: local rings of `window` rows
    beside global rings of `cache_len`) equals the JAX `generate()` and
    the port's ring serve of the same lock-step requests; the divergence
    probe (a batch-1 ring) runs past the window with finite readings."""
    cfg, jp, tp = families["gemma3-12b"]
    prompts = _prompts(cfg, (12, 12), seed=1)
    with use_policy(FP32_J):
        jeng = JEngine(cfg, jp, batch=2, cache_len=32, eos_id=-1,
                       sync_every=3)
        want = np.asarray(jeng.generate(jnp.asarray(prompts, jnp.int32), 9))
    with TP.use_policy(TP.PrecisionPolicy(input_format="fp32")):
        eng = ServeEngine(cfg, tp, batch=2, cache_len=32, eos_id=-1,
                          sync_every=3, kv_layout="ring")
        cache = eng.new_cache()
        assert {c["kv"].k.shape[2] for c in cache} == {cfg.window, 32}
        got = eng.generate(torch.tensor(prompts), 9)
        served, _ = _serve(ServeEngine, SlotScheduler, cfg, tp, prompts,
                           (9, 9), "ring")
        probe = eng.divergence_probe(prompts[0], steps=6)
    assert got.numpy().tolist() == want.tolist()
    assert [served[r] for r in (0, 1)] == got.numpy().tolist()
    assert probe["steps"] == 6
    assert np.isfinite([probe["kl_mean"], probe["max_abs_diff"]]).all()


@pytest.fixture(scope="module")
def gemma3_two_superblocks():
    """Reduced gemma3 with two superblocks (12 layers: a draft of one to
    exit from), the JAX package's weights from key 1 and the port's
    copy."""
    cfg = _cfg("gemma3-12b", num_layers=12)
    return (cfg, *_weights(cfg))


F6_SEEDS = (1, 3, 4, 5, 6)


@pytest.fixture(scope="module")
def f6_jax_streams(gemma3_two_superblocks):
    """Per prompt seed: the JAX engine's plain and spec (k = 4) streams of
    one 13-token prompt decoding 12 tokens, under the fp32 policy (one
    engine each, so each compiles once)."""
    cfg, jp, _ = gemma3_two_superblocks
    out = {}
    with use_policy(FP32_J):
        engines = [JEngine(cfg, jp, batch=2, cache_len=32, eos_id=-1,
                           sync_every=2, kv_layout="paged", page_size=8,
                           max_seq_len=32, spec_k=k) for k in (0, 4)]
        for seed in F6_SEEDS:
            streams = []
            for eng in engines:
                sched = JSched(2, eos_id=-1)
                sched.submit(_prompts(cfg, (13,), seed=seed)[0],
                             max_new_tokens=12)
                eng.serve(sched)
                streams.append({r.rid: r.tokens for r in sched.finished})
            out[seed] = tuple(streams)
    return out


@pytest.mark.parametrize("seed", F6_SEEDS)
def test_spec_under_local_windows_equals_the_plain_stream(
        gemma3_two_superblocks, f6_jax_streams, seed):
    """ROADMAP F6: spec decoding (k = 4) over local rings of window 8. A
    13-token prompt decodes 12 tokens, so every verify's writes wrap the
    rings. The JAX engine's spec stream differs from its plain stream on
    this data (its rings keep `window` rows, and a verify overwrites rows
    still inside live windows); the port's, over rings of window + k
    rounded up to a page (16 rows), equals the JAX engine's plain stream
    in the paged and the ring layout. Under the fp32 policy (R1)."""
    cfg, _, tp = gemma3_two_superblocks
    plain, jspec = f6_jax_streams[seed]
    assert jspec != plain
    prompts = _prompts(cfg, (13,), seed=seed)
    with TP.use_policy(TP.PrecisionPolicy(input_format="fp32")):
        for layout in ("paged", "ring"):
            got, s = _serve(ServeEngine, SlotScheduler, cfg, tp, prompts,
                            (12,), layout, max_seq_len=32, spec_k=4)
            assert s["spec_iters"] > 0 and s["nonfinite_logits"] == 0
            assert got == plain, layout


def test_spec_rings_grow_by_spec_k_and_the_plain_rings_do_not(
        gemma3_two_superblocks):
    """The local rings under spec: window + spec_k rounded up to a page in
    the pool, the fragment and the ring layout alike; without spec (k = 0,
    or the kill switch) `window` rows, as in the JAX engine. The global
    layers are untouched."""
    cfg, _, tp = gemma3_two_superblocks
    local = [j for j in range(cfg.stack_period)
             if cfg.layer_kind(j)["attn"] == "local"]
    glob = [j for j in range(cfg.stack_period) if j not in local]

    def rows(cache):
        return ({c["kv"].k.shape[2] for j, c in enumerate(cache)
                 if j in local},
                {type(c["kv"]).__name__ for j, c in enumerate(cache)
                 if j in glob})

    for k, want in ((4, 16), (3, 16), (0, 8)):
        eng = ServeEngine(cfg, tp, batch=2, cache_len=32, page_size=8,
                          max_seq_len=32, spec_k=k)
        assert eng._local_rows() == (want if k else None)
        assert rows(eng.new_pool()) == ({want}, {"PagedKVCache"})
        assert rows(eng.new_frag(5)) == ({want}, {"KVCache"})
        assert rows(eng.new_cache()) == ({want}, {"KVCache"})
        assert eng._frag_floor == 8


def test_spec_kill_switch_keeps_window_rings(gemma3_two_superblocks,
                                             monkeypatch):
    cfg, _, tp = gemma3_two_superblocks
    monkeypatch.setenv("REPRO_SPEC_DECODE", "0")
    eng = ServeEngine(cfg, tp, batch=2, cache_len=32, page_size=8,
                      max_seq_len=32, spec_k=4)
    assert not eng.spec_decoding_on() and eng._local_rows() is None


@pytest.mark.parametrize("layout", ["paged", "ring"])
@pytest.mark.parametrize("arch", ARCHS + ("qwen2.5-14b",))
def test_engine_gates_match_jax(families, arch, layout, monkeypatch):
    """Prefix caching, disagg, bucketing, spec (k = 3, and k = 8 against
    the window of 8) and the allocator's floor equal the JAX engine's for
    each arch and layout, with the window below and above max_seq_len."""
    monkeypatch.setenv("REPRO_PREFIX_CACHE", "1")
    cfg = _cfg(arch, num_layers=2 * _cfg(arch).stack_period)
    tp = TM.init_params(cfg, seed=0, device="cpu")
    for max_seq in (32, 8):
        for spec_k in (3, 8):
            kw = dict(batch=2, cache_len=32, kv_layout=layout, page_size=8,
                      max_seq_len=max_seq, spec_k=spec_k, disagg=True,
                      bucket_prompts=True)
            j = JEngine(cfg, None, **kw)
            t = ServeEngine(cfg, tp, **kw)
            for gate in ("prefix_caching_on", "disagg_on", "bucketing_on",
                         "spec_decoding_on"):
                assert bool(getattr(t, gate)()) == bool(
                    getattr(j, gate)()), (gate, max_seq, spec_k)
            assert t._frag_floor == j._frag_floor
            assert (t.new_allocator().min_request_tokens
                    == j.new_allocator().min_request_tokens)


def test_convert_carries_tied_and_mixed_trees_key_for_key(families):
    """A tied parameter tree (no `lm_head`) and a mixed cache tree (pool
    leaves beside dense rings) carry across key for key and value for
    value."""
    cfg, jp, tp = families["gemma2-9b"]
    assert "lm_head" not in jp and "lm_head" not in tp
    flat = jax.tree_util.tree_flatten_with_path
    jf = {jax.tree_util.keystr(p): np.asarray(x) for p, x in flat(jp)[0]}
    tf = {jax.tree_util.keystr(p): x.numpy() for p, x in flat(tp)[0]}
    assert jf.keys() == tf.keys()
    assert all(np.array_equal(jf[k], tf[k]) for k in jf)
    cache = JM.init_cache(cfg, 2, 32, dtype=jnp.float32, paged=(5, 8))
    t_cache = _torch(cache)
    for jc, tc in zip(cache, t_cache):
        assert type(tc["kv"]).__name__ == type(jc["kv"]).__name__
        for field in jc["kv"]._fields:
            assert np.array_equal(np.asarray(getattr(jc["kv"], field)),
                                  getattr(tc["kv"], field).numpy())


def test_driver_serves_gemma3_on_the_cpu(capsys):
    """The driver's CPU smoke of a new family (README): every request
    completes and every kernel call on the CPU is a plain one."""
    from repro_torch.launch import serve as drv

    ops.reset_counts()
    summary = drv.main(["--arch", "gemma3-12b", "--reduced", "--device",
                        "cpu", "--batch", "2", "--requests", "4",
                        "--max-new", "8", "--prompt-lens", "6,12",
                        "--max-seq-len", "32", "--rate", "0"])
    assert summary["requests"] == 4 and summary["generated_tokens"] == 32
    assert summary["pages_leaked"] == 0 and "prefix_hits" not in summary
    assert summary["nonfinite_logits"] == 0
    assert all(c["launches"] == 0 for c in ops.counts().values())
