"""Bit-exact models of the chained FP multiply-add datapath in a SA column.

The port's copy of the JAX package's `repro/core/chained_fma.py` (numpy
only), on the port's own `fpformats.decompose`. It is the oracle of the
fp_emu kernel (`kernels/fp_emu.py`); tests/test_torch_datapath.py holds
the copy equal to the original bit for bit.

This is the paper's §III, reproduced at the integer-field level:

* ``baseline_*``  — the state-of-the-art 2-stage pipeline of Fig. 3(b): each PE
  receives a *normalized* partial ``(s, e, m)``, aligns, adds, LZA-normalizes
  and forwards the corrected exponent ``e_i = ê_i − L_i``. The dependence of
  PE *i+1*'s exponent-compute on PE *i*'s LZA output is what serializes the
  column (2 cycles / PE — modeled in :mod:`repro_torch.core.systolic`).

* ``skewed_*``    — the proposed pipeline of Fig. 5/6: each PE forwards the
  *unnormalized* pair ``(ê_i, S_i)`` plus the LZA count ``L_i`` one stage
  later. The next PE computes *speculative* values ``d'_{i+1} = |e_M − ê_i|``
  and fixes them with the forwarded ``L_i``:

      d = d' + L_prev              if e_M ≥ ê_prev          (paper, §III.B)
      d = L_prev − d'              if e_M < ê_prev   (sign ⇒ shift direction)

  and the normalization of the incoming sum is *retimed* into the alignment
  shifter (one net shift, left or right — Fig. 6).

The central claim of the paper is that the speculation is **exact** — no
rollback, identical arithmetic results. The JAX package's tests prove
``skewed ≡ baseline`` bit-for-bit with hypothesis.

* ``approx_*``    — the cheaper datapath variant of the *approximate
  normalization* FMA (arxiv 2408.11997), modeled on top of the skewed
  interface: the per-PE LZA/normalization shifter is **coarsened** to a
  shift quantum of ``APPROX_COARSE`` bits (only the high bits of the LZA
  count are examined, the fine shifter stages are removed). The forwarded
  count ``L`` is rounded down to a multiple of the quantum, so up to
  ``APPROX_COARSE − 1`` leading zeros stay unnormalized in the wide
  accumulator ("normalization debt"). The value semantics stay exact —
  exponent fix and net shift both consume the same coarsened ``L`` — but
  alignment truncation cuts up to ``APPROX_COARSE − 1`` bits higher per
  step, so results may differ from the exact pipelines **only below the
  guard-bit threshold** (debt ≤ GUARD with the default quantum). The final
  normalization at the column-end rounding stage stays exact, as in the
  real design. This is the arithmetic behind the serve engine's "bulk"
  quality tier (the JAX package's serve/scheduler.py).

Number representation (unbiased exponents, value-anchored):

  normalized    value = (−1)^s · m · 2^(e − P),  msb(m) = P
  unnormalized  value = (−1)^s · S · 2^(ê − Q),  Q = P + 1, msb(S) ≤ Q,
                ê = max(e_M, e_in) + 1,  L = Q − msb(S) ≥ 0,  e = ê − L

``P = ACC_MSB = 26`` gives a 24-bit FP32 significand + ``GUARD = 3`` guard
bits: the "double-width reduction" contract of §II (Bfloat16 in, FP32 down the
column), with truncating alignment (no per-PE rounding) and a single
round-to-nearest-even at the column south end (§II: "rounding is performed
only once, at the South end of each column").
"""
from __future__ import annotations

import dataclasses

import numpy as np

from .fpformats import FPFormat, BF16, get_format, decompose

# Accumulator geometry: 24-bit significand (FP32) + guard bits.
GUARD = 3
ACC_MSB = 23 + GUARD          # P: msb position of a normalized significand
_Q = ACC_MSB + 1              # anchor of unnormalized sums
E_ZERO = -(1 << 20)           # exponent of an exact zero (never wins a max)
_MAXSH = 62                   # clamp shifts (int64-safe; >= register width)

# Approximate-normalization shift quantum (arxiv 2408.11997 model): the LZA
# count is truncated to multiples of this, so normalization debt is bounded
# by APPROX_COARSE − 1 = GUARD bits — per-step truncation error stays inside
# the guard band of the wide accumulator. Power of two (kernel-foldable).
APPROX_COARSE = GUARD + 1


def _msb(x: np.ndarray) -> np.ndarray:
    """Vectorized index of the most significant set bit (-1 for 0)."""
    x = np.asarray(x, dtype=np.int64)
    # exact for x < 2^53: frexp exponent of float64 gives bit-length
    return np.frexp(x.astype(np.float64))[1] - 1


def _shr(x: np.ndarray, n: np.ndarray) -> np.ndarray:
    """Truncating right shift with clamped (always >= 0) shift amount."""
    return np.asarray(x, np.int64) >> np.minimum(np.maximum(n, 0), _MAXSH)


def _shl(x: np.ndarray, n: np.ndarray) -> np.ndarray:
    return np.asarray(x, np.int64) << np.minimum(np.maximum(n, 0), _MAXSH)


def _net_shift(x: np.ndarray, left: np.ndarray) -> np.ndarray:
    """One bidirectional shifter: shift left by `left` (right if negative).

    This is the retimed normalize+align unit of Fig. 6 — the previous PE's
    normalization (≤ L_prev left shifts) and this PE's alignment (right
    shifts) collapse into a single net shift, "as only one of these options
    may occur".
    """
    return np.where(left >= 0, _shl(x, left), _shr(x, -left))


@dataclasses.dataclass
class Normalized:
    """A normalized partial sum (baseline inter-PE interface)."""

    s: np.ndarray  # sign bit
    e: np.ndarray  # unbiased exponent, anchor P (E_ZERO if zero)
    m: np.ndarray  # significand, msb at P (0 if zero)


@dataclasses.dataclass
class Unnormalized:
    """The skewed inter-PE interface: (ê, S) now, L one stage later."""

    s: np.ndarray
    ehat: np.ndarray  # speculative exponent ê (anchor Q = P+1)
    S: np.ndarray     # unnormalized sum, msb ≤ Q
    L: np.ndarray     # LZA count of *this* PE (consumed by next PE's stage 2)


def make_zero(shape) -> Normalized:
    z = np.zeros(shape, dtype=np.int64)
    return Normalized(s=z.copy(), e=np.full(shape, E_ZERO, np.int64), m=z.copy())


def make_zero_unnorm(shape) -> Unnormalized:
    z = np.zeros(shape, dtype=np.int64)
    return Unnormalized(s=z.copy(), ehat=np.full(shape, E_ZERO, np.int64),
                        S=z.copy(), L=z.copy())


# ---------------------------------------------------------------------------
# Stage 1 (both pipelines): the multiplier — exact in the wide accumulator
# ---------------------------------------------------------------------------

def multiply(a: np.ndarray, b: np.ndarray, fmt: FPFormat = BF16) -> Normalized:
    """Exact product of two reduced-precision operands, normalized to P.

    Product of two `man_bits+1`-wide significands is ≤ 2(man_bits+1) bits,
    which fits the P+1 = 27-bit accumulator exactly for every format in
    Fig. 1 — multiplication never rounds (§II: fused, no intermediate
    normalization *of the chain*; the product's own 1-bit normalize is free).
    """
    fmt = get_format(fmt)
    sa, ea, ma = decompose(a, fmt)
    sb, eb, mb = decompose(b, fmt)
    ea = ea.astype(np.int64) - fmt.bias
    eb = eb.astype(np.int64) - fmt.bias
    mm = ma.astype(np.int64) * mb.astype(np.int64)
    msb = _msb(mm)
    e = ea + eb - 2 * fmt.man_bits + msb   # = ea+eb or ea+eb+1
    m = _shl(mm, ACC_MSB - msb)
    zero = mm == 0
    return Normalized(
        s=(sa ^ sb).astype(np.int64),
        e=np.where(zero, E_ZERO, e),
        m=np.where(zero, 0, m),
    )


def _signed_add(s1, m1, s2, m2):
    v = np.where(s1 == 1, -m1, m1) + np.where(s2 == 1, -m2, m2)
    return (v < 0).astype(np.int64), np.abs(v)


# ---------------------------------------------------------------------------
# Baseline PE (Fig. 3(b)): normalize-then-align, corrected exponent forwarded
# ---------------------------------------------------------------------------

def baseline_pe(prod: Normalized, acc: Normalized) -> Normalized:
    """One PE of the reference pipeline. Interface: normalized partials."""
    # exponent compute: ê = max + 1 (anchor Q), d = |e_M − e_{i-1}|
    e_max = np.maximum(prod.e, acc.e)
    d = np.abs(prod.e - acc.e)
    mp = np.where(prod.e >= acc.e, prod.m, _shr(prod.m, d))   # align product
    ma = np.where(acc.e >= prod.e, acc.m, _shr(acc.m, d))     # align partial
    s, S = _signed_add(prod.s, mp, acc.s, ma)
    # LZA + normalize + exponent correction e = ê − L (the stage-2 output on
    # which the *next* PE's stage 1 depends — the serialization of Fig. 4).
    msb = _msb(S)
    L = _Q - msb
    e = (e_max + 1) - L                       # = ê − L
    m = _net_shift(S, L - 1)                  # msb → P (right shift iff carry)
    zero = S == 0
    return Normalized(s=np.where(zero, 0, s),
                      e=np.where(zero, E_ZERO, e),
                      m=np.where(zero, 0, m))


# ---------------------------------------------------------------------------
# Skewed PE (Fig. 5/6): speculative exponent + fix, retimed normalization
# ---------------------------------------------------------------------------

def skewed_pe(prod: Normalized, acc: Unnormalized, *,
              coarse: int = 1) -> Unnormalized:
    """One PE of the proposed pipeline.

    Stage 1 computes speculative ``e' = max(e_M, ê_prev)`` and
    ``d' = |e_M − ê_prev|`` from the *unnormalized* ê of the previous PE
    (its L is not yet available). Stage 2's fix unit receives ``L_prev``
    and corrects, per the paper's case analysis; the incoming sum's
    normalization is folded into the same net shift (Fig. 6).

    ``coarse > 1`` selects the approximate-normalization variant: the LZA
    count this PE forwards is rounded down to a multiple of ``coarse``
    (coarse LZA, quantized shifter — arxiv 2408.11997), leaving up to
    ``coarse − 1`` leading zeros unnormalized in the wide accumulator.
    Because the next PE's exponent fix and net shift consume the same
    coarsened ``L``, the represented value stays consistent; only the
    alignment truncation cutoff rises by the debt.
    """
    ge = prod.e >= acc.ehat            # speculative compare (stage 1)
    d_spec = np.abs(prod.e - acc.ehat)  # d' (stage 1)

    # --- stage-2 fix (uses L_prev, forwarded from the previous PE) --------
    # true normalized exponent of the incoming partial: e_prev = ê − L.
    # paper:  e_M ≥ ê_prev  ⇒ d = d' + L_prev  (product dominates)
    #         e_M <  ê_prev ⇒ d = L_prev − d'  (sign gives the direction)
    d_fix = np.where(ge, d_spec + acc.L, acc.L - d_spec)
    # d_fix > 0  ⇒ product dominates (e_M > e_prev): partial shifts right
    # d_fix <= 0 ⇒ partial dominates: product shifts right by −d_fix
    prod_dom = d_fix > 0
    e_prev = acc.ehat - acc.L
    e_max = np.where(prod_dom, prod.e, e_prev)
    is_zero_prev = acc.S == 0
    e_max = np.where(is_zero_prev, prod.e, e_max)

    # retimed normalize∥align: net left shift of the incoming sum is
    # (L_prev − 1) − max(d_fix, 0) — a single bidirectional shifter.
    acc_net_left = (acc.L - 1) - np.maximum(d_fix, 0)
    Sa = _net_shift(acc.S, acc_net_left)
    mp = _shr(prod.m, np.maximum(-d_fix, 0))
    mp = np.where(prod.e == E_ZERO, 0, mp)
    Sa = np.where(is_zero_prev, 0, Sa)

    s, S = _signed_add(prod.s, mp, acc.s, Sa)
    msb = _msb(S)
    L = _Q - msb
    if coarse > 1:
        L = (L // coarse) * coarse   # coarse LZA: keep only high count bits
    zero = S == 0
    return Unnormalized(
        s=np.where(zero, 0, s),
        ehat=np.where(zero, E_ZERO, e_max + 1),
        S=np.where(zero, 0, S),
        L=np.where(zero, 0, L),
    )


def approx_pe(prod: Normalized, acc: Unnormalized,
              coarse: int = APPROX_COARSE) -> Unnormalized:
    """Approximate-normalization PE (2408.11997): skewed interface with a
    coarse LZA — see :func:`skewed_pe` (``coarse`` > 1)."""
    return skewed_pe(prod, acc, coarse=coarse)


def skewed_finalize(acc: Unnormalized) -> Normalized:
    """The deferred last normalization (§III.B: "the correction for the
    exponent of the last PE ... will happen during the rounding stage at the
    end of the column")."""
    msb = _msb(acc.S)
    L = _Q - msb
    zero = acc.S == 0
    return Normalized(
        s=np.where(zero, 0, acc.s),
        e=np.where(zero, E_ZERO, acc.ehat - L),
        m=np.where(zero, 0, _net_shift(acc.S, L - 1)),
    )


# ---------------------------------------------------------------------------
# Column-end rounding (once per column, §II) and chain runners
# ---------------------------------------------------------------------------

def round_to_f32(r: Normalized) -> np.ndarray:
    """RNE from the P+1-bit accumulator to float32 (the south-edge rounder)."""
    g = GUARD
    low = r.m & ((1 << g) - 1)
    keep = r.m >> g                              # 24-bit significand
    half = 1 << (g - 1)
    round_up = (low > half) | ((low == half) & ((keep & 1) == 1))
    keep = keep + round_up.astype(np.int64)
    # mantissa overflow after rounding: renormalize
    ovf = keep >> 24 != 0
    keep = np.where(ovf, keep >> 1, keep)
    e = r.e + ovf.astype(np.int64)
    # bit-exact f32 construction; FTZ below the normal range, Inf above
    # (matches the fp_emu kernel's output contract exactly).
    e32 = e + 127
    frac = (keep & 0x7FFFFF).astype(np.uint32)
    sgn = (r.s.astype(np.uint32) & 1) << 31
    bits = sgn | (np.clip(e32, 0, 255).astype(np.uint32) << 23) | frac
    bits = np.where(e32 >= 255, sgn | np.uint32(0x7F800000), bits)
    bits = np.where((r.m == 0) | (e32 <= 0), sgn, bits)
    return bits.view(np.float32) if bits.shape else np.uint32(bits).view(np.float32)


def baseline_chain(a: np.ndarray, w: np.ndarray, fmt=BF16) -> np.ndarray:
    """Reference column: psum_i = psum_{i−1} + a_i·w_i, K on axis 0."""
    acc = make_zero(a.shape[1:])
    for k in range(a.shape[0]):
        acc = baseline_pe(multiply(a[k], w[k], fmt), acc)
    return round_to_f32(acc)


def skewed_chain(a: np.ndarray, w: np.ndarray, fmt=BF16) -> np.ndarray:
    """Proposed column, identical arithmetic via the speculative interface."""
    acc = make_zero_unnorm(a.shape[1:])
    for k in range(a.shape[0]):
        acc = skewed_pe(multiply(a[k], w[k], fmt), acc)
    return round_to_f32(skewed_finalize(acc))


def approx_chain(a: np.ndarray, w: np.ndarray, fmt=BF16,
                 coarse: int = APPROX_COARSE) -> np.ndarray:
    """Approximate-normalization column (the "bulk" tier datapath): skewed
    interface, coarse LZA; final normalization at the rounding stage stays
    exact."""
    acc = make_zero_unnorm(a.shape[1:])
    for k in range(a.shape[0]):
        acc = skewed_pe(multiply(a[k], w[k], fmt), acc, coarse=coarse)
    return round_to_f32(skewed_finalize(acc))


_CHAINS = {"baseline": baseline_chain, "skewed": skewed_chain,
           "approx": approx_chain}


def matmul_emulated(a: np.ndarray, w: np.ndarray, fmt=BF16,
                    pipeline: str = "skewed") -> np.ndarray:
    """(M,K) @ (K,N) through the bit-exact SA column model (slow; tests)."""
    a = np.asarray(a, np.float32)
    w = np.asarray(w, np.float32)
    M, K = a.shape
    K2, N = w.shape
    assert K == K2
    if pipeline not in _CHAINS:
        raise ValueError(f"unknown pipeline {pipeline!r}; have {sorted(_CHAINS)}")
    ab = np.broadcast_to(a.T[:, :, None], (K, M, N))       # a[k, m] per (m,n)
    wb = np.broadcast_to(w[:, None, :], (K, M, N))
    return _CHAINS[pipeline](ab, wb, fmt)
