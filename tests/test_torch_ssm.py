"""PyTorch port: the SSM (mamba2-2.7b) and hybrid (hymba-1.5b) families
against the JAX package on the same numpy inputs (reduced configs: chunk
8, window 8; weights drawn by the JAX package and carried over by
`params_from_numpy`).

What they add to the decoder: the Mamba2 mixer (models/ssm.py: in_proj,
a causal depthwise conv with a 3-row tail, the chunked SSD scan and its
O(1) decode step, the gated RMSNorm, out_proj), a per-slot fp32 state
and conv tail in the cache, hymba's parallel heads (the mean of the
attention's and the mixer's RMSNorms) beside local-window rings, and the
engine's handling of both: mamba2 served on rows (the ring layout), and
prefix caching, disagg, bucketing and spec off.

Tolerances, each with its reason:

* The SSD functions, the conv and the mixer's state and tail under
  either policy: 2⁻¹⁶ of the output's largest magnitude (the same fp32
  cumsums, exps, products and einsums of the same rounded operands,
  associated another way: XLA's cumsum is a parallel scan, and it fuses
  the conv's products and sums into FMAs). `_segsum`'s -inf pattern bit
  for bit.
* The mixer's output: 2⁻¹⁶ under the fp32 policy; under the bf16 policy
  out_proj rounds the gated norm's fp32 output to bf16, so a last-bit
  difference there flips a bf16 rounding (2⁻⁸ of one input) and moves
  its token's row: 2⁻⁸ of the largest magnitude.
* The splices: bit for bit (data movement).
* Logits: 2⁻⁵·max|logit|, the greedy token equal where the top-2 gap
  exceeds twice that (tests/test_torch_families.py: the residual stream
  is bf16 in both frameworks, so a last-bit fp32 difference can flip a
  bf16 rounding). Token streams under the fp32 policy at prompt seed 1
  (R1: away from near-tie argmaxes).
* A forward's caches: layer 0's state, tail and K (its inputs are the
  embeddings, the same in both) within 2⁻¹⁶; a deeper layer's inputs
  carry the bf16 flips of every residual before it (R1; on reduced hymba
  ~0.3 % of the largest magnitude a layer, 4.4 % at the 16th), so each
  layer's within 2⁻³.
* Gradients: tests/test_torch_train.py's, the loss within 2⁻¹⁰ relative,
  each leaf within 2⁻⁵ of its norm.
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
from repro.data.pipeline import SyntheticLM as JSynthetic  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.models import ssm as JS  # noqa: E402
from repro.serve.engine import ServeEngine as JEngine  # noqa: E402
from repro.serve.scheduler import SlotScheduler as JSched  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import precision as TP  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import sa_matmul as MM  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models import ssm as TS  # noqa: E402
from repro_torch.models.convert import (cache_from_numpy,  # noqa: E402
                                        params_from_numpy)
from repro_torch.serve.engine import ServeEngine  # noqa: E402
from repro_torch.serve.scheduler import SlotScheduler  # noqa: E402
from repro_torch.train.step import make_grad_fn  # noqa: E402

torch.set_num_threads(2)
REL = 2.0 ** -5
REL_SSD = 2.0 ** -16
REL_GRAD, REL_LOSS = 2.0 ** -5, 2.0 ** -10
MAMBA2, HYMBA = "mamba2-2.7b", "hymba-1.5b"
ARCHS = (MAMBA2, HYMBA)
FP32_J = PrecisionPolicy(input_format="fp32")
FP32_T = TP.PrecisionPolicy(input_format="fp32")


def _cfg(arch, **kw):
    return dataclasses.replace(reduced_config(arch), remat=False, **kw)


@pytest.fixture(scope="module")
def models():
    """Each reduced config with the JAX package's weights (key 1) and the
    port's copy of them."""
    out = {}
    for arch in ARCHS:
        cfg = _cfg(arch)
        jp = JM.init_params(jax.random.key(1), cfg)
        out[arch] = (cfg, jp, params_from_numpy(
            jax.tree.map(np.asarray, jp), "cpu"))
    return out


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float32).numpy()
    return np.asarray(x, dtype=np.float32)


def _close(ref, got, rel=REL_SSD):
    ref, got = _np(ref), _np(got)
    assert ref.shape == got.shape
    assert np.abs(ref - got).max() <= rel * max(np.abs(ref).max(), 1e-30)


def _check_logits(ref, got, vocab):
    ref, got = _np(ref), _np(got)
    assert np.isneginf(got[..., vocab:]).all()
    r, g = ref[..., :vocab], got[..., :vocab]
    bound = REL * np.abs(r).max()
    assert np.abs(r - g).max() <= bound
    top2 = np.sort(r, axis=-1)[..., -2:]
    decided = (top2[..., 1] - top2[..., 0]) > 2 * bound
    assert (r.argmax(-1) == g.argmax(-1))[decided].all()


def _x(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _policies(fmt):
    return (use_policy(PrecisionPolicy(input_format=fmt)),
            TP.use_policy(TP.PrecisionPolicy(input_format=fmt)))


# ---------------------------------------------------------------------------
# the SSD functions
# ---------------------------------------------------------------------------

def _ssd_inputs(B=2, T=13, H=3, P=4, N=5, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, T, H, P)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((B, T, H)))).astype(np.float32)
    A = (-np.exp(rng.standard_normal(H) * 0.3)).astype(np.float32)
    Bm = rng.standard_normal((B, T, N)).astype(np.float32)
    Cm = rng.standard_normal((B, T, N)).astype(np.float32)
    S0 = rng.standard_normal((B, H, P, N)).astype(np.float32)
    return x, dt, A, Bm, Cm, S0


def test_segsum_matches_jax():
    """The cumsum-difference form, -inf above the diagonal."""
    a = _x((2, 3, 9), 1)
    want = np.asarray(JS._segsum(jnp.asarray(a)))
    got = TS._segsum(torch.from_numpy(a)).numpy()
    inf = np.isneginf(want)
    assert np.array_equal(inf, np.isneginf(got))
    assert inf[..., 0, 1:].all() and not inf[..., 1:, 0].any()
    _close(np.where(inf, 0, want), np.where(inf, 0, got))


@pytest.mark.parametrize("initial", [False, True])
@pytest.mark.parametrize("fmt", ["fp32", "bf16"])
def test_ssd_chunked_matches_jax(fmt, initial):
    """T = 13 over chunks of 4 (a zero-padded tail), from zeros or from a
    given state: y and the final state."""
    x, dt, A, Bm, Cm, S0 = _ssd_inputs()
    jpol, tpol = _policies(fmt)
    with jpol:
        jy, jS = JS.ssd_chunked(
            *map(jnp.asarray, (x, dt, A, Bm, Cm)), chunk=4,
            initial_state=jnp.asarray(S0) if initial else None)
    with tpol:
        ty, tS = TS.ssd_chunked(
            *map(torch.from_numpy, (x, dt, A, Bm, Cm)), chunk=4,
            initial_state=torch.from_numpy(S0) if initial else None)
    assert tS.dtype == torch.float32
    _close(jy, ty)
    _close(jS, tS)


@pytest.mark.parametrize("fmt", ["fp32", "bf16"])
def test_ssd_decode_step_matches_jax(fmt):
    x, dt, A, Bm, Cm, S0 = _ssd_inputs(T=1)
    args = (x[:, 0], dt[:, 0], A, Bm[:, 0], Cm[:, 0])
    jpol, tpol = _policies(fmt)
    with jpol:
        jS, jy = JS.ssd_decode_step(jnp.asarray(S0),
                                    *map(jnp.asarray, args))
    with tpol:
        tS, ty = TS.ssd_decode_step(torch.from_numpy(S0),
                                    *map(torch.from_numpy, args))
    _close(jS, tS)
    _close(jy, ty)


@pytest.mark.parametrize("tail", [None, "fp32", "bf16"])
def test_causal_conv_matches_jax(tail):
    """Without a tail (zero padding) and after one (a cache of either
    type, promoted as JAX promotes it); the weight in bf16 as the
    superblock cast leaves it."""
    x, w = _x((2, 5, 7), 2), _x((4, 7), 3)
    c = None if tail is None else _x((2, 3, 7), 4)
    jdt = {"fp32": jnp.float32, "bf16": jnp.bfloat16}.get(tail)
    tdt = {"fp32": torch.float32, "bf16": torch.bfloat16}.get(tail)
    jy, jt = JS._causal_conv(jnp.asarray(x), jnp.asarray(w, jnp.bfloat16),
                             None if c is None else jnp.asarray(c, jdt))
    ty, tt = TS._causal_conv(torch.from_numpy(x),
                             torch.from_numpy(w).to(torch.bfloat16),
                             None if c is None else torch.from_numpy(c).to(tdt))
    assert ty.dtype == torch.float32 and tt.dtype == torch.float32
    _close(jy, ty)
    assert np.array_equal(np.asarray(jt), tt.numpy())     # data movement


def _layer0(cfg, jp, tp, j=0):
    """Superblock 0's mixer parameters in both frameworks, the matrices
    cast to bf16 as the forward's superblock cast leaves them."""
    jm = jax.tree.map(lambda a: a[0].astype(jnp.bfloat16) if a.ndim >= 3
                      else a[0], jp["layers"][j]["ssm"])
    tm = TM.tree_map(lambda a: a[0].to(torch.bfloat16) if a.ndim >= 3
                     else a[0], tp["layers"][j]["ssm"])
    return jm, tm


@pytest.mark.parametrize("phase", ["prefill", "decode"])
@pytest.mark.parametrize("fmt", ["fp32", "bf16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_mamba2_block_matches_jax(models, arch, fmt, phase):
    """The whole mixer on a bf16 input: a 13-token prefill (two chunks of
    8, a padded tail) from a zero state, and a decode step from a random
    state and conv tail; the output, the new state and the tail."""
    cfg, jp, tp = models[arch]
    jm, tm = _layer0(cfg, jp, tp)
    T = 13 if phase == "prefill" else 1
    x = _x((2, T, cfg.d_model), 5)
    state = conv = None
    if phase == "decode":
        state = _x((2, cfg.n_ssm_heads, cfg.ssm_head_dim, cfg.ssm_state), 6)
        conv = _x((2, 3, cfg.d_inner + 2 * cfg.ssm_state), 7)
    jpol, tpol = _policies(fmt)
    with jpol:
        jy, (jS, jt) = JS.mamba2_block(
            jnp.asarray(x, jnp.bfloat16), jm, cfg,
            state=None if state is None else jnp.asarray(state),
            conv_cache=None if conv is None else jnp.asarray(conv))
    with tpol:
        ty, (tS, tt) = TS.mamba2_block(
            torch.from_numpy(x).to(torch.bfloat16), tm, cfg,
            state=None if state is None else torch.from_numpy(state),
            conv_cache=None if conv is None else torch.from_numpy(conv))
    assert ty.dtype == torch.float32 and tS.dtype == torch.float32
    _close(jy, ty, REL_SSD if fmt == "fp32" else 2.0 ** -8)
    _close(jS, tS)
    _close(jt, tt)


# ---------------------------------------------------------------------------
# parameters and their conversion
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_tree_matches_jax(arch):
    """The port's tree has the JAX tree's keys and shapes: an SSM layer
    `norm1` and `ssm` only, a hybrid layer `attn`, `ssm`, `attn_norm`,
    `ssm_norm`, `ffn` and both norms."""
    cfg = _cfg(arch)
    tp = TM.init_params(cfg, seed=0, device="cpu")
    jshape = jax.eval_shape(lambda k: JM.init_params(k, cfg),
                            jax.random.key(0))
    flat = jax.tree_util.tree_flatten_with_path
    jflat = {jax.tree_util.keystr(p): x.shape for p, x in flat(jshape)[0]}
    tflat = {jax.tree_util.keystr(p): tuple(x.shape) for p, x in
             flat(tp)[0]}
    assert jflat == tflat
    layer = set(tp["layers"][0])
    assert layer == ({"norm1", "ssm"} if arch == MAMBA2 else
                     {"norm1", "norm2", "attn", "ssm", "attn_norm",
                      "ssm_norm", "ffn"})


VECTORS = ("norm1", "norm2", "attn_norm", "ssm_norm", "final_norm",
           "dt_bias", "A_log", "D_skip", "norm_w", "bq", "bk", "bv")


def _typed_leaves(tree):
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {jax.tree_util.keystr(p): x.dtype for p, x in flat}


def test_params_from_numpy_keeps_stacked_vectors_fp32():
    """With the matrix type bf16: every stacked norm, bias and SSM vector
    (2-D under `layers`) stays fp32, and `embed`, the matrices and
    `conv_w` (3-D under `layers`) go to bf16."""
    np_tree = {"embed": np.ones((8, 4), np.float32),
               "final_norm": {"w": np.ones((4,), np.float32)},
               "layers": ({"norm1": {"w": np.ones((2, 4), np.float32)},
                           "attn": {"wq": np.ones((2, 4, 4), np.float32),
                                    "bq": np.zeros((2, 4), np.float32)}},)}
    t = params_from_numpy(np_tree, "cpu", dtype=torch.bfloat16)
    assert t["layers"][0]["norm1"]["w"].dtype == torch.float32
    assert t["layers"][0]["attn"]["bq"].dtype == torch.float32
    assert t["layers"][0]["attn"]["wq"].dtype == torch.bfloat16
    assert t["embed"].dtype == torch.bfloat16
    assert t["final_norm"]["w"].dtype == torch.float32
    cfg = _cfg(MAMBA2)
    jp = jax.tree.map(np.asarray, JM.init_params(jax.random.key(1), cfg))
    tp = params_from_numpy(jp, "cpu", dtype=torch.bfloat16)
    for path, dt in _typed_leaves(tp).items():
        vector = any(f"'{v}'" in path for v in VECTORS)
        assert dt == (torch.float32 if vector else torch.bfloat16), path
    assert tp["layers"][0]["ssm"]["conv_w"].dtype == torch.bfloat16


@pytest.mark.parametrize("arch", ("qwen2.5-14b", "gemma2-9b",
                                  "granite-moe-3b-a800m", MAMBA2, HYMBA))
def test_init_params_and_convert_give_the_same_types(arch):
    """Leaf for leaf, `init_params` and `params_from_numpy` store the same
    types, with the matrix type bf16 (the card's) and fp32."""
    cfg = _cfg(arch)
    jp = jax.tree.map(np.asarray, JM.init_params(jax.random.key(1), cfg))
    for dt in (torch.bfloat16, torch.float32):
        made = _typed_leaves(TM.init_params(cfg, device="cpu", dtype=dt))
        conv = _typed_leaves(params_from_numpy(jp, "cpu", dtype=dt))
        assert made == conv, dt


def test_ragged_matrix_is_stored_with_aligned_rows():
    """hymba's in_proj (1600 × 6482: N not a multiple of 8) is a view of a
    buffer whose rows are 6488 long, in `init_params` and in
    `params_from_numpy`; `_aligned` hands the view to the kernel without a
    copy, and the product equals the contiguous weight's."""
    full = get_config(HYMBA)
    n = 2 * full.d_inner + 2 * full.ssm_state + full.n_ssm_heads
    assert n == 6482
    w = TM.matrix_storage((2, full.d_model, n), torch.bfloat16, "cpu")
    assert tuple(w.shape) == (2, 1600, 6482)
    assert w.stride() == (1600 * 6488, 6488, 1)
    # a reduced hymba widened so its in_proj is ragged (2·144 + 32 + 9)
    cfg = _cfg(HYMBA, d_model=72)
    tp = TM.init_params(cfg, seed=0, device="cpu")
    jp = jax.tree.map(np.asarray, JM.init_params(jax.random.key(1), cfg))
    cp = params_from_numpy(jp, "cpu")
    for params in (tp, cp):
        ip = params["layers"][0]["ssm"]["in_proj"]
        assert tuple(ip.shape) == (1, 72, 329) and ip.stride(1) == 336
        st, ld = MM._aligned(ip[0], ip[0].stride(0))
        assert st.data_ptr() == ip.data_ptr() and ld == 336
    w = cp["layers"][0]["ssm"]["in_proj"][0]
    assert np.array_equal(w.numpy(), jp["layers"][0]["ssm"]["in_proj"][0])
    a = torch.from_numpy(_x((5, 72), 8))
    assert torch.equal(TP.sa_dot(a, w), TP.sa_dot(a, w.contiguous()))
    with TP.use_policy(FP32_T):
        toks = torch.from_numpy(np.random.default_rng(2).integers(
            0, cfg.vocab_size, (2, 9)).astype(np.int32))
        want, _, _ = TM.forward(TM.tree_map(torch.Tensor.contiguous, cp),
                                cfg, toks)
        got, _, _ = TM.forward(cp, cfg, toks)
    assert torch.equal(got, want)


def test_convert_carries_hybrid_cache_trees(models):
    """A paged hymba cache (a pool for the global layer, rings for the
    local ones, the ssm tuples everywhere) carries across leaf for leaf,
    the ssm entries as plain tuples."""
    cfg, _, _ = models[HYMBA]
    cache = JM.init_cache(cfg, 2, 32, dtype=jnp.float32, paged=(5, 8))
    t_cache = cache_from_numpy(jax.tree.map(np.asarray, cache), "cpu")
    for jc, tc in zip(cache, t_cache):
        assert type(tc["kv"]).__name__ == type(jc["kv"]).__name__
        assert type(tc["ssm"]) is tuple and len(tc["ssm"]) == 2
        for a, b in zip(jc["ssm"], tc["ssm"]):
            assert np.array_equal(np.asarray(a), b.numpy())


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fmt", ["fp32", "bf16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_logits_and_cache_match_jax(models, arch, fmt):
    """A 13-token prefill into a cache (two SSD chunks, hymba's local
    rings past the window of 8): the logits, every layer's state and conv
    tail, and hymba's K/V."""
    cfg, jp, tp = models[arch]
    toks = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 13)).astype(np.int32)
    jpol, tpol = _policies(fmt)
    with jpol:
        jl, jc, _ = JM.forward(jp, cfg, jnp.asarray(toks), last_only=True,
                               cache=JM.init_cache(cfg, 2, 16,
                                                   dtype=jnp.float32))
    with tpol:
        tl, tc, _ = TM.forward(tp, cfg, torch.from_numpy(toks),
                               last_only=True,
                               cache=TM.init_cache(cfg, 2, 16,
                                                   dtype=torch.float32,
                                                   device="cpu"))
    _check_logits(jl, tl, cfg.vocab_size)
    for j in range(cfg.stack_period):
        rel = REL_SSD if j == 0 else 2.0 ** -3
        assert set(tc[j]) == set(jc[j])
        for a, b in zip(jc[j]["ssm"], tc[j]["ssm"]):
            assert b.dtype == torch.float32
            _close(a, b, rel)
        if "kv" in jc[j]:
            assert np.array_equal(np.asarray(jc[j]["kv"].positions),
                                  tc[j]["kv"].positions)
            _close(jc[j]["kv"].k, tc[j]["kv"].k, rel)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_then_decode_equals_full_forward(models, arch):
    """tests/test_decode.py's contract: a prefill of 10 tokens then 3
    decode steps gives each position's logits as the full forward over
    all 13 does (the state and the conv tail survive the cache)."""
    cfg, _, tp = models[arch]
    toks = torch.from_numpy(np.random.default_rng(4).integers(
        0, cfg.vocab_size, (2, 13)).astype(np.int32))
    with TP.use_policy(FP32_T):
        full, _, _ = TM.forward(tp, cfg, toks)
        cache = TM.init_cache(cfg, 2, 16, dtype=torch.float32, device="cpu")
        pre, cache, _ = TM.forward(tp, cfg, toks[:, :10], cache=cache)
        steps = [pre]
        for t in range(10, 13):
            lg, cache, _ = TM.forward(tp, cfg, toks[:, t:t + 1],
                                      cache=cache, pos=t)
            steps.append(lg)
    got = torch.cat(steps, dim=1)[..., :cfg.vocab_size]
    want = full[..., :cfg.vocab_size]
    assert float((got - want).abs().max()) <= 1e-4 * max(
        1.0, float(want.abs().max()))


# ROADMAP S6: the prefill-then-decode gap under the bf16 policy over
# mamba2's 64 layers, the port's against the JAX package's own
S6_LAYERS, S6_RATIO = 64, 2.0


def _prefill_decode_gap(forward, init_cache, params, cfg, toks, pos_of):
    """max over the last 4 rows of |prefill(10) + 3 decode steps − full
    forward| / max|logit|, over the real vocabulary."""
    V = cfg.vocab_size
    full, _, _ = forward(params, cfg, toks)
    cache = init_cache()
    pre, cache, _ = forward(params, cfg, toks[:, :10], cache=cache)
    steps = [pre]
    for t in range(10, 13):
        lg, cache, _ = forward(params, cfg, toks[:, t:t + 1], cache=cache,
                               pos=pos_of(t))
        steps.append(lg)
    got = np.concatenate([_np(x) for x in steps], axis=1)[..., :V]
    want = _np(full)[..., :V]
    return float(np.abs(got - want).max() / np.abs(want).max())


def test_bf16_prefill_then_decode_gap_is_the_references_own():
    """ROADMAP S6: under the bf16 policy, at reduced width and mamba2's 64
    layers, a prefill of 10 tokens then 3 decode steps parts from the full
    forward by a few % of max|logit| in the JAX package itself (the
    chunked scan and the recurrent step sum in two fp32 orders, and each
    of 64 bf16 residuals can flip a rounding). The port's gap is of the
    same size: within a factor S6_RATIO of the JAX package's, both way
    above fp32's 1e-4 (measured on the CPU: 3.40 % against 3.01 %; the
    card read 2.1-3.3 % at full width)."""
    cfg = _cfg(MAMBA2, num_layers=S6_LAYERS)
    jp = JM.init_params(jax.random.key(1), cfg)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    toks = np.random.default_rng(4).integers(
        0, cfg.vocab_size, (2, 13)).astype(np.int32)
    jpol, tpol = _policies("bf16")
    with jpol:
        jgap = _prefill_decode_gap(
            JM.forward, lambda: JM.init_cache(cfg, 2, 16, dtype=jnp.float32),
            jp, cfg, jnp.asarray(toks), jnp.int32)
    with tpol:
        tgap = _prefill_decode_gap(
            TM.forward, lambda: TM.init_cache(cfg, 2, 16,
                                              dtype=torch.float32,
                                              device="cpu"),
            tp, cfg, torch.from_numpy(toks), int)
    assert 1e-2 < jgap and 1e-2 < tgap
    assert 1 / S6_RATIO <= tgap / jgap <= S6_RATIO, (tgap, jgap)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_multi_is_refused(models, arch):
    """A recurrent state cannot roll back a rejected draft: the forward
    refuses the speculative verify, as the JAX package's does."""
    cfg, jp, tp = models[arch]
    cache = TM.init_cache(cfg, 1, 16, dtype=torch.float32, device="cpu")
    with pytest.raises(ValueError, match="roll back"):
        TM.forward(tp, cfg, torch.zeros((1, 3), dtype=torch.int32),
                   cache=cache, pos=0, decode_multi=True)
    with pytest.raises(ValueError, match="roll back"):
        JM.forward(jp, cfg, jnp.zeros((1, 3), jnp.int32),
                   cache=JM.init_cache(cfg, 1, 16, dtype=jnp.float32),
                   pos=0, decode_multi=True)


def test_decode_step_gemm_count():
    """A decode step runs 2 SA GEMMs an SSM layer and 9 a hybrid layer
    (4 attention, 3 FFN, in_proj and out_proj), plus the lm_head: 129 for
    mamba2-2.7b and 289 for hymba-1.5b; on the CPU each a plain call."""
    assert TM.gemm_calls(get_config(MAMBA2)) == 129
    assert TM.gemm_calls(get_config(HYMBA)) == 289
    for arch in ARCHS:
        cfg = _cfg(arch)
        tp = TM.init_params(cfg, seed=0, device="cpu")
        eng = ServeEngine(cfg, tp, batch=2, cache_len=32, page_size=8)
        ops.reset_counts()
        with TP.use_policy(FP32_T):
            eng._serve_step(tp, torch.zeros((2, 1), dtype=torch.int32),
                            eng.new_cache(),
                            torch.zeros((2,), dtype=torch.int32))
        assert ops.counts()["sa_matmul"]["plain_calls"] == TM.gemm_calls(cfg)


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

def _prompts(cfg, lens, seed=1):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab_size, n).tolist() for n in lens]


def _serve(engine_cls, sched_cls, cfg, params, prompts, budgets, layout,
           **kw):
    eng = engine_cls(cfg, params, batch=2, cache_len=32, eos_id=-1,
                     sync_every=2, kv_layout=layout, page_size=8, **kw)
    sched = sched_cls(2, eos_id=-1)
    for p, n in zip(prompts, budgets):
        sched.submit(p, max_new_tokens=n)
    summary = eng.serve(sched)
    return {r.rid: r.tokens for r in sched.finished}, summary, eng


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_matches_jax_engine_paged_equals_ring(models, arch):
    """Three requests over two slots (a refill: the slot's state comes
    from the new prompt, not the old request or the warm-up) through the
    JAX engine and the port's engines asked for paged and ring, under the
    fp32 policy: one stream. mamba2 asked for paged serves on rows, as
    the JAX engine does; hymba's paged cache is a pool, local rings and
    the ssm rows."""
    cfg, jp, tp = models[arch]
    prompts = _prompts(cfg, (12, 6, 12))
    budgets = (8, 3, 5)
    with use_policy(FP32_J):
        ref, _, jeng = _serve(JEngine, JSched, cfg, jp, prompts, budgets,
                              "paged")
    with TP.use_policy(FP32_T):
        paged, s, teng = _serve(ServeEngine, SlotScheduler, cfg, tp,
                                prompts, budgets, "paged")
        ring, _, _ = _serve(ServeEngine, SlotScheduler, cfg, tp, prompts,
                            budgets, "ring")
    assert teng.kv_layout == jeng.kv_layout == (
        "ring" if arch == MAMBA2 else "paged")
    assert paged == ref == ring
    assert [len(paged[i]) for i in sorted(paged)] == list(budgets)
    assert s["nonfinite_logits"] == 0 and "prefix_hits" not in s
    assert s.get("pages_leaked", 0) == 0


def test_long_request_on_ssm_rows_is_not_rejected(models):
    """mamba2 has no ring to wrap: a request past `cache_len` is served,
    not rejected (the JAX engine's `_must_reject`)."""
    cfg, jp, tp = models[MAMBA2]
    prompts = _prompts(cfg, (30,), seed=3)
    with use_policy(FP32_J):
        ref, _, _ = _serve(JEngine, JSched, cfg, jp, prompts, (6,), "ring")
    with TP.use_policy(FP32_T):
        got, s, _ = _serve(ServeEngine, SlotScheduler, cfg, tp, prompts,
                           (6,), "ring")
    assert s["rejected"] == 0 and got == ref and len(got[0]) == 6


@pytest.mark.parametrize("arch", ARCHS)
def test_generate_matches_jax(models, arch):
    """`generate()` on a static batch of rows equals the JAX engine's, and
    the divergence probe reads finite numbers."""
    cfg, jp, tp = models[arch]
    prompts = _prompts(cfg, (12, 12))
    with use_policy(FP32_J):
        jeng = JEngine(cfg, jp, batch=2, cache_len=32, eos_id=-1,
                       sync_every=3)
        want = np.asarray(jeng.generate(jnp.asarray(prompts, jnp.int32), 7))
    with TP.use_policy(FP32_T):
        eng = ServeEngine(cfg, tp, batch=2, cache_len=32, eos_id=-1,
                          sync_every=3)
        got = eng.generate(torch.tensor(prompts), 7)
        probe = eng.divergence_probe(prompts[0], steps=4)
    assert got.numpy().tolist() == want.tolist()
    assert eng.last_stats["nonfinite_logits"] == 0
    assert np.isfinite([probe["kl_mean"], probe["max_abs_diff"]]).all()
    assert eng.macs_per_token() == jeng.macs_per_token()


@pytest.mark.parametrize("layout", ["paged", "ring"])
@pytest.mark.parametrize("arch", ARCHS)
def test_engine_gates_match_jax(arch, layout, monkeypatch):
    """The layout taken, prefix caching, disagg, bucketing, spec and the
    fragment floor equal the JAX engine's for each layout asked, with the
    window below and above max_seq_len: every gate off."""
    monkeypatch.setenv("REPRO_PREFIX_CACHE", "1")
    cfg = _cfg(arch, num_layers=2 * _cfg(arch).stack_period)
    tp = TM.init_params(cfg, seed=0, device="cpu")
    for max_seq in (32, 8):
        kw = dict(batch=2, cache_len=32, kv_layout=layout, page_size=8,
                  max_seq_len=max_seq, spec_k=3, disagg=True,
                  bucket_prompts=True)
        j = JEngine(cfg, None, **kw)
        t = ServeEngine(cfg, tp, **kw)
        assert t.kv_layout == j.kv_layout
        for gate in ("prefix_caching_on", "disagg_on", "bucketing_on",
                     "spec_decoding_on"):
            assert not getattr(t, gate)() and not getattr(j, gate)(), gate
        assert t._frag_floor == j._frag_floor


@pytest.fixture(scope="module")
def hybrid_tree():
    """A hymba paged cache (a pool for the global layer, 15 local rings,
    ssm rows everywhere) holding random values and stale positions, and a
    fragment floored at the window, in JAX's types."""
    cfg = _cfg(HYMBA)
    rng = np.random.default_rng(3)

    def fill(tree, positions):
        def one(path, x):
            name = jax.tree_util.keystr(path)
            if "block_table" in name:
                return x
            if "positions" in name:
                return jnp.asarray(positions(x.shape), x.dtype)
            return jnp.asarray(rng.standard_normal(x.shape), x.dtype)
        return jax.tree_util.tree_map_with_path(one, tree)

    pool = fill(JM.init_cache(cfg, 2, 16, dtype=jnp.float32, paged=(9, 4)),
                lambda s: rng.integers(0, 50, s))
    frag = fill(JM.init_cache(cfg, 1, cfg.window, dtype=jnp.float32),
                lambda s: np.broadcast_to(np.arange(s[-1]), s))
    return cfg, pool, frag


def _torch(tree):
    return cache_from_numpy(jax.tree.map(np.asarray, tree), "cpu")


def _assert_equal_trees(ref, got):
    flat = jax.tree_util.tree_flatten_with_path
    r = {jax.tree_util.keystr(p): np.asarray(x) for p, x in flat(ref)[0]}
    g = {jax.tree_util.keystr(p): x.numpy() for p, x in flat(got)[0]}
    assert r.keys() == g.keys()
    for k in r:
        assert np.array_equal(r[k], g[k]), k


@pytest.mark.parametrize("splice", ["scatter", "bind", "insert"])
def test_splices_on_hybrid_trees_match_jax_bit_exact(hybrid_tree, splice):
    """`_scatter_impl` and `_bind_impl` pass the ssm rows (and the rings)
    through; `_insert_impl` also row-copies the fragment's state and conv
    tail into the slot: pure data movement, bit-exact against the JAX
    engine's."""
    cfg, pool, frag = hybrid_tree
    row = np.array([3, 5, 2, -1], np.int32)
    t_pool, t_frag = _torch(pool), _torch(frag)
    if splice == "scatter":
        ref = JEngine._scatter_impl(pool, frag, jnp.asarray(row),
                                    jnp.asarray(0, jnp.int32))
        got = ServeEngine._scatter_impl(t_pool, t_frag,
                                        torch.from_numpy(row), 0)
    elif splice == "bind":
        ref = JEngine._bind_impl(pool, jnp.asarray(row), 1)
        got = ServeEngine._bind_impl(t_pool, torch.from_numpy(row), 1)
    else:
        ref = JEngine._insert_impl(pool, frag, 1, jnp.asarray(row),
                                   jnp.asarray(0, jnp.int32))
        got = ServeEngine._insert_impl(t_pool, t_frag, 1,
                                       torch.from_numpy(row), 0)
        assert torch.equal(got[0]["ssm"][0][:, 1], t_frag[0]["ssm"][0][:, 0])
    _assert_equal_trees(ref, got)


def test_ssm_rows_splice_into_a_ring_slot_and_survive_clear():
    """The ring layout's insert copies a mamba2 fragment's state and tail
    over the slot's row (the JAX engine's dynamic-update-slice), and a
    cleared slot keeps them (the next admission overwrites the row)."""
    cfg = _cfg(MAMBA2, num_layers=2)
    rng = np.random.default_rng(5)
    cache = jax.tree.map(lambda x: jnp.asarray(
        rng.standard_normal(x.shape), x.dtype),
        JM.init_cache(cfg, 2, 16, dtype=jnp.float32))
    frag = jax.tree.map(lambda x: jnp.asarray(
        rng.standard_normal(x.shape), x.dtype),
        JM.init_cache(cfg, 1, 16, dtype=jnp.float32))
    ref = JEngine._insert_impl(cache, frag, 1)
    got = ServeEngine._insert_impl(_torch(cache), _torch(frag), 1)
    _assert_equal_trees(ref, got)
    kept = [t.clone() for t in got[0]["ssm"]]
    ServeEngine._clear_slot_impl(got, 1)
    assert all(torch.equal(a, b) for a, b in zip(kept, got[0]["ssm"]))
    assert "kv" not in got[0]


# ---------------------------------------------------------------------------
# the drivers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_driver_serves_on_the_cpu(arch, capsys):
    """The driver's CPU smoke (README): asked for the paged layout, mamba2
    serves on rows and says so; every request completes, every kernel
    call on the CPU is a plain one."""
    from repro_torch.launch import serve as drv

    ops.reset_counts()
    summary = drv.main(["--arch", arch, "--reduced", "--device", "cpu",
                        "--batch", "2", "--requests", "4", "--max-new", "6",
                        "--prompt-lens", "6,12", "--max-seq-len", "32",
                        "--kv", "paged", "--rate", "0"])
    assert summary["requests"] == 4 and summary["generated_tokens"] == 24
    assert summary["kv_layout"] == ("ring" if arch == MAMBA2 else "paged")
    assert summary["nonfinite_logits"] == 0 and "prefix_hits" not in summary
    assert all(c["launches"] == 0 for c in ops.counts().values())
    assert f"[engine] kv_layout={summary['kv_layout']} prefix_cache=False " \
           f"disagg=False bucketing=False spec=False" in capsys.readouterr().out


def test_train_driver_trains_mamba2_on_the_cpu():
    from repro_torch.launch import train as drv

    cfg = _cfg(MAMBA2)
    args = drv.parse_args(["--arch", MAMBA2, "--reduced", "--device", "cpu",
                           "--steps", "3", "--batch", "2", "--seq", "16"])
    state, hist = drv.run(cfg, args)
    assert len(hist) == 3
    assert all(np.isfinite([h["loss"], h["grad_norm"]]).all() for h in hist)
    assert int(state.step) == 3


# ---------------------------------------------------------------------------
# training: the loss and its gradients
# ---------------------------------------------------------------------------

def _paths(tree, prefix=()):
    if isinstance(tree, dict):
        return {p: x for k, v in tree.items()
                for p, x in _paths(v, prefix + (k,)).items()}
    if isinstance(tree, (tuple, list)):
        return {p: x for i, v in enumerate(tree)
                for p, x in _paths(v, prefix + (i,)).items()}
    x = tree.detach().numpy() if isinstance(tree, torch.Tensor) else tree
    return {prefix: np.asarray(x)}


@pytest.fixture(scope="module")
def mamba2_grads():
    """(cfg, numpy params, batch, (loss, nll, gradient leaves)) of the JAX
    package's value_and_grad(lm_loss) on reduced mamba2 (remat on, two
    layers, T = 20: two SSD chunks and a padded tail)."""
    cfg = dataclasses.replace(_cfg(MAMBA2), remat=True, num_layers=2)
    jp = JM.init_params(jax.random.key(3), cfg)
    batch = JSynthetic(cfg.vocab_size, 20, 4, seed=1).batch_at(0)
    toks, labs = (jnp.asarray(batch[k]) for k in ("tokens", "labels"))
    with use_policy(PrecisionPolicy(backend="xla")):
        (loss, nll), g = jax.jit(jax.value_and_grad(
            lambda p, t, l: JM.lm_loss(p, cfg, t, l), has_aux=True))(
            jp, toks, labs)
    return cfg, jax.tree.map(np.asarray, jp), batch, (
        float(loss), float(nll), _paths(jax.tree.map(np.asarray, g)))


@pytest.mark.parametrize("port_backend", ["torch", "cuda"])
def test_lm_loss_and_grads_match_jax(mamba2_grads, port_backend):
    """Loss, nll and every gradient leaf (in_proj, conv_w, dt_bias, A_log,
    D_skip, norm_w, out_proj, the norms, embed and lm_head) against
    jax.value_and_grad(lm_loss); the port's `cuda` backend runs
    SAMatmulFn's plain version on the CPU."""
    cfg, np_params, batch, (j_loss, j_nll, jg) = mamba2_grads
    params = params_from_numpy(np_params, "cpu", dtype=torch.float32)
    for p in TM.tree_leaves(params):
        p.requires_grad_(True)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    ops.reset_counts()
    with TP.use_policy(TP.PrecisionPolicy(backend=port_backend)):
        t_loss, t_nll, grads = make_grad_fn(cfg)(params, tb)
    bwd = ops.counts()["sa_matmul_bwd"]["plain_calls"]
    assert (bwd > 0) == (port_backend == "cuda")
    for want, got in ((j_loss, t_loss), (j_nll, t_nll)):
        assert abs(float(got) - want) <= REL_LOSS * abs(want)
    tg = _paths(grads)
    assert set(jg) == set(tg)
    rel = {p: float(np.linalg.norm(tg[p] - jg[p])
                    / (np.linalg.norm(jg[p]) + 1e-30)) for p in jg}
    assert max(rel.values()) <= REL_GRAD, sorted(
        rel.items(), key=lambda kv: -kv[1])[:3]
    assert all(np.abs(jg[p]).max() > 0 for p in jg
               if p[-1] in ("A_log", "dt_bias", "conv_w"))
