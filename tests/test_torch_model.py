"""PyTorch port: the model forward and one paged decode step against the
JAX package on the same weights (carried over by `params_from_numpy`).

Tolerance: the residual stream is bf16 (model.py's compute dtype) in both
frameworks, and their rmsnorm/rope/softmax differ in the last fp32 bit, so
a value just at a bf16 rounding boundary may round one ulp (2⁻⁸ relative)
differently and carry that through the layers. Logits are held to
2⁻⁵·max|logit| (measured ≈ 2⁻⁷ on these configs), the greedy token to
equality wherever the top-2 gap exceeds twice that bound, and cached K/V
to 2⁻⁵·max|K|. Integer state (positions, block tables) and pure data
movement (the page scatter) are bit-exact.

Under an FP8 input policy the same last-bit differences flip an FP8
rounding instead: one ulp is 2⁻³ (E4M3) or 2⁻² (E5M2) of the operand,
not 2⁻⁸, so the prefill logits and K/V are held to 2⁻³ (E4M3) and 2⁻²
(E5M2) of their largest magnitude (2⁻⁵ fails on this 2-layer config;
rows with no flip upstream agree bit for bit, since FP8 products sum
exactly in fp32).
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
from repro_torch.configs import get_config as t_get_config  # noqa: E402
from repro_torch.configs import reduced_config as t_reduced  # noqa: E402
from repro_torch.core import precision as TP  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models.convert import (cache_from_numpy,  # noqa: E402
                                        params_from_numpy)
from repro_torch.serve.engine import ServeEngine as TEngine  # noqa: E402

torch.set_num_threads(2)
REL = 2.0 ** -5
REL_FP8 = {"fp8_e4m3": 2.0 ** -3, "fp8_e5m2": 2.0 ** -2}


@pytest.fixture(scope="module")
def setup():
    cfg = dataclasses.replace(
        reduced_config("qwen2.5-14b", layers_per_period=2), remat=False)
    jp = JM.init_params(jax.random.key(1), cfg)
    # a nonzero QKV bias exercises the fused epilogue's bias path
    jp["layers"] = tuple(
        {**lay, "attn": {**lay["attn"], **{
            b: jax.random.normal(jax.random.key(i), lay["attn"][b].shape)
            * 0.1 for i, b in enumerate(("bq", "bk", "bv"))}}}
        for lay in jp["layers"])
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    return cfg, jp, tp


def _np(x):
    return np.asarray(x) if not isinstance(x, torch.Tensor) else x.numpy()


def _check_logits(ref, got, vocab, rel=REL):
    ref, got = _np(ref), _np(got)
    assert np.isneginf(ref[..., vocab:]).all()
    assert np.isneginf(got[..., vocab:]).all()
    r, g = ref[..., :vocab], got[..., :vocab]
    bound = rel * np.abs(r).max()
    assert np.abs(r - g).max() <= bound
    top2 = np.sort(r, axis=-1)[..., -2:]
    decided = (top2[..., 1] - top2[..., 0]) > 2 * bound
    assert (r.argmax(-1) == g.argmax(-1))[decided].all()


def _check_kv(ref, got, rel=REL):
    ref, got = _np(ref), _np(got)
    assert np.abs(ref - got).max() <= rel * np.abs(ref).max()


@pytest.mark.parametrize(
    "fmt", ["bf16", "fp32", "fp8_e4m3", "fp8_e5m2", "emulate"])
def test_prefill_forward_matches_jax(setup, fmt):
    """`emulate` is bf16 inputs through the skewed datapath on both sides
    (JAX: `chained_fma` behind a callback; the port: fp_emu's plain
    version)."""
    cfg, jp, tp = setup
    toks = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 13)).astype(np.int32)
    pol = (dict(backend="emulate") if fmt == "emulate"
           else dict(input_format=fmt))
    with use_policy(PrecisionPolicy(**pol)):
        jl, jc, _ = JM.forward(jp, cfg, jnp.asarray(toks), last_only=True,
                               cache=JM.init_cache(cfg, 2, 16,
                                                   dtype=jnp.float32))
    with TP.use_policy(TP.PrecisionPolicy(**pol)):
        tl, tc, _ = TM.forward(tp, cfg, torch.from_numpy(toks),
                               last_only=True,
                               cache=TM.init_cache(cfg, 2, 16,
                                                   dtype=torch.float32,
                                                   device="cpu"))
    assert tuple(tl.shape) == (2, 1, cfg.padded_vocab)
    rel = REL_FP8.get(fmt, REL)
    _check_logits(jl, tl, cfg.vocab_size, rel)
    for j in range(cfg.stack_period):
        jkv, tkv = jc[j]["kv"], tc[j]["kv"]
        assert np.array_equal(np.asarray(jkv.positions), tkv.positions)
        _check_kv(jkv.k, tkv.k, rel)
        _check_kv(jkv.v, tkv.v, rel)


def test_full_forward_matches_jax(setup):
    """No cache, every position's logits (not just the last)."""
    cfg, jp, tp = setup
    toks = np.random.default_rng(1).integers(
        0, cfg.vocab_size, (1, 9)).astype(np.int32)
    jl, _, _ = JM.forward(jp, cfg, jnp.asarray(toks))
    tl, _, _ = TM.forward(tp, cfg, torch.from_numpy(toks))
    _check_logits(jl, tl, cfg.vocab_size)


def _jax_pool(cfg, jp, prompts, policy, n_pages=9, psz=8, max_seq=32):
    """A JAX paged pool with each prompt prefilled through a dense fragment
    and spliced into its slot by the reference engine's `_insert_impl`."""
    pool = JM.init_cache(cfg, len(prompts), max_seq, dtype=jnp.float32,
                         paged=(n_pages, psz))
    nxt = 1
    for slot, prompt in enumerate(prompts):
        cap = -(-len(prompt) // psz) * psz
        with use_policy(policy):
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


@pytest.mark.parametrize("impl", ["fused", "gather"])
def test_paged_decode_step_matches_jax(setup, impl, monkeypatch):
    cfg, jp, tp = setup
    monkeypatch.setenv("REPRO_DECODE_ATTN", impl)
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist() for n in (11, 6)]
    pol = PrecisionPolicy()
    pool = _jax_pool(cfg, jp, prompts, pol)
    t_pool = cache_from_numpy(jax.tree.map(np.asarray, pool), "cpu")
    tok = np.array([[5], [17]], np.int32)
    pos = np.array([len(p) for p in prompts], np.int32)
    with use_policy(pol):
        jl, jc, _ = JM.forward(jp, cfg, jnp.asarray(tok), cache=pool,
                               pos=jnp.asarray(pos))
    with TP.use_policy(TP.PrecisionPolicy()):
        tl, tc, _ = TM.forward(tp, cfg, torch.from_numpy(tok), cache=t_pool,
                               pos=torch.from_numpy(pos))
    assert tc is t_pool                       # the pool is updated in place
    _check_logits(jl, tl, cfg.vocab_size)
    for j in range(cfg.stack_period):
        jkv, tkv = jc[j]["kv"], tc[j]["kv"]
        assert np.array_equal(np.asarray(jkv.positions), tkv.positions)
        assert np.array_equal(np.asarray(jkv.block_table), tkv.block_table)
        _check_kv(jkv.k, tkv.k)
        _check_kv(jkv.v, tkv.v)


@pytest.mark.parametrize("keep", [0, 1])
def test_scatter_bind_matches_jax_bit_exact(setup, keep):
    """The page scatter (with the recycled-page position wipe and kept
    shared pages redirected to the trash page) and the block-table bind
    are pure data movement: bit-exact against the reference engine."""
    cfg, _, _ = setup
    rng = np.random.default_rng(3)
    n_pages, psz, P = 7, 4, 4
    pool = JM.init_cache(cfg, 2, P * psz, dtype=jnp.float32,
                         paged=(n_pages, psz))
    # recycled pages: stale positions from an earlier owner
    pool = jax.tree.map(
        lambda x: (jnp.asarray(rng.integers(0, 50, x.shape), x.dtype)
                   if x.dtype == jnp.int32 and x.ndim == 3
                   and x.shape[1] == n_pages else x), pool)
    frag = JM.init_cache(cfg, 1, 2 * psz, dtype=jnp.float32)
    frag = jax.tree.map(
        lambda x: jnp.asarray(rng.standard_normal(x.shape), x.dtype)
        if x.dtype == jnp.float32 else
        jnp.asarray(np.broadcast_to(np.arange(x.shape[-1]), x.shape),
                    x.dtype), frag)
    row = np.array([3, 5, 2, -1], np.int32)
    t_pool = cache_from_numpy(jax.tree.map(np.asarray, pool), "cpu")
    t_frag = cache_from_numpy(jax.tree.map(np.asarray, frag), "cpu")
    ref = JEngine._insert_impl(pool, frag, 1, jnp.asarray(row),
                               jnp.asarray(keep, jnp.int32))
    got = TEngine._insert_impl(t_pool, t_frag, 1, torch.from_numpy(row),
                               keep)
    for j in range(cfg.stack_period):
        for field in ("k", "v", "positions", "block_table"):
            a = np.asarray(getattr(ref[j]["kv"], field))
            b = getattr(got[j]["kv"], field).numpy()
            assert np.array_equal(a, b), field


def test_init_params_matches_jax_tree():
    """Same key names, stacked superblock axis and shapes as the JAX
    tree; the port's own draws follow the same distributions."""
    cfg = t_reduced("qwen2.5-14b", layers_per_period=3)
    tp = TM.init_params(cfg, seed=0, device="cpu")
    jshape = jax.eval_shape(lambda k: JM.init_params(k, cfg),
                            jax.random.key(0))
    jflat = {jax.tree_util.keystr(p): x.shape for p, x in
             jax.tree_util.tree_flatten_with_path(jshape)[0]}
    tflat = {jax.tree_util.keystr(p): tuple(x.shape) for p, x in
             jax.tree_util.tree_flatten_with_path(tp)[0]}
    assert jflat == tflat
    wq = tp["layers"][0]["attn"]["wq"]
    assert wq.dtype == torch.float32
    assert abs(float(wq.std()) * cfg.d_model ** 0.5 - 1.0) < 0.05
    assert float(tp["layers"][0]["attn"]["bq"].abs().max()) == 0.0
    again = TM.init_params(cfg, seed=0, device="cpu")
    assert torch.equal(again["embed"], tp["embed"])


def test_entry_points_need_a_card_or_an_explicit_cpu():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a CUDA device")
    cfg = t_reduced("qwen2.5-14b")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TM.init_params(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TM.init_cache(cfg, 1, 8)


def test_unported_families_raise():
    """Every family builds now; what the port still refuses: continuous
    serving of a frontend arch (`serve()` is text-only, as in the JAX
    engine; `generate()` serves them). A cache with padded KV heads (the
    mesh's `pad_kv_heads`), refused until the serving slice under a mesh,
    now decodes: the unpadded output, the padded heads' rows written as
    zeros."""
    from repro_torch.serve.scheduler import SlotScheduler
    from repro_torch.models import layers as TL

    for name in ("whisper-tiny", "pixtral-12b"):
        cfg = t_reduced(name)
        eng = TEngine(cfg, TM.init_params(cfg, device="cpu"), batch=1,
                      cache_len=16)
        sched = SlotScheduler(1)
        sched.submit([1, 2], max_new_tokens=2)
        with pytest.raises(ValueError, match="text-only"):
            eng.serve(sched)
    cfg = t_reduced("qwen2.5-14b")
    tp = TM.init_params(cfg, device="cpu")
    cache = TM.init_cache(cfg, 1, 8, dtype=torch.float32, device="cpu")[0]
    kv = cache["kv"]
    padded = type(kv)(*(torch.cat([t, t], dim=-2) for t in kv[:2]),
                      kv.positions.clone())
    p0 = TM.tree_map(lambda w: w[0], tp["layers"][0]["attn"])
    x = torch.randn((1, 1, cfg.d_model), generator=torch.Generator()
                    .manual_seed(0))
    outs = [TL.attention_block(x, p0, cfg, {"attn": "global"},
                               torch.zeros((1, 1), dtype=torch.int32),
                               cache=TM.tree_map(lambda t: t[0], c))[0]
            for c in (kv, padded)]
    assert torch.equal(outs[0], outs[1])
    kvh = cfg.num_kv_heads
    assert torch.equal(padded.k[0, 0, 0, :kvh], kv.k[0, 0, 0])
    assert not padded.k[0, 0, 0, kvh:].any()
    assert not padded.v[0, 0, 0, kvh:].any()
    assert t_get_config("qwen2.5-14b").padded_vocab == 153600
