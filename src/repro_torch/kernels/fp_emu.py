"""The paper's skewed integer datapath: plain version and the hand-written
Hopper kernel.

Replaces the TPU kernel `repro/kernels/fp_emu.py` `_fma_emu_kernel`: an
(M, K) @ (K, N) product where each output walks K through the skewed PE
chain of §III.B (speculative exponent forward, the one-stage-late LZA
count, the fix `d = d' ± L`, the retimed normalize∥align net shift,
truncating alignment in a 27-bit accumulator), then one RNE rounding to
fp32 at the column end (FTZ keeping the sign, saturate to Inf).
``mode="approx"`` coarsens the forwarded LZA count to a multiple of
`APPROX_COARSE` (the bulk tier's datapath). It is the on-device twin of
`repro_torch.core.chained_fma` (`matmul_emulated`, pipelines `skewed` and
`approx`), bit for bit.

Inputs are values on the format's grid (`PrecisionPolicy.cast_in`), in
fp32, bf16 or fp16 containers. Formats whose significand product does not
fit the accumulator (fp32: 24 × 24 bits) are refused (ROADMAP R5: the TPU
kernel's int32 product overflows there).

The kernel (`csrc/fp_emu.cu`) runs one thread per output; K stays serial,
because truncating alignment does not associate. A PE step is some 60
dependent integer instructions, so the kernel is bound by instruction
issue when many outputs are in flight, and by the latency of the K chain
at decode (M = 2).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.chained_fma import ACC_MSB, APPROX_COARSE, E_ZERO, GUARD
from repro_torch.core.fpformats import get_format

LAUNCHES = 0       # kernel launches through `fma_emu_matmul_cuda`
PLAIN_CALLS = 0    # calls of the plain version `fma_emu_matmul_ref`

MODES = ("exact", "approx")
_Q = ACC_MSB + 1
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}

# int32 operations of one PE step, counted in csrc/fp_emu.cu's K loop:
# multiplier 11 (two masks, multiply, xor, shift, max, clz, subtract, two
# adds, select), the shift of the product into the accumulator 4, the
# speculative compare and fix 8, the exponent select 5, the net shift of
# the incoming sum 11, the product's alignment 6, the signed add 5, the
# LZA 5 and the state update 5: 60. chip_smoke.py's bound counts the SASS
# of the loop instead where `cuobjdump` is present, and uses this count
# where it is not.
OPS_PER_STEP = 60


def check_format(fmt_name: str):
    """The format, if the product of two of its significands fits the
    27-bit accumulator (`2·(man_bits + 1) ≤ ACC_MSB + 1`); else ValueError."""
    fmt = get_format(fmt_name)
    if 2 * (fmt.man_bits + 1) > _Q:
        raise ValueError(
            f"the skewed datapath takes formats whose significand product "
            f"fits its {_Q}-bit accumulator; {fmt.name} "
            f"({fmt.man_bits + 1}-bit significands) does not")
    return fmt


def _check_args(a, w, fmt_name, mode):
    if mode not in MODES:
        raise ValueError(f"mode={mode!r}; want 'exact' or 'approx'")
    fmt = check_format(fmt_name)
    if a.ndim != 2 or w.ndim != 2 or a.shape[1] != w.shape[0]:
        raise ValueError(f"fma_emu_matmul takes (M, K) @ (K, N), got "
                         f"{tuple(a.shape)} @ {tuple(w.shape)}")
    return fmt


def _msb(x: torch.Tensor) -> torch.Tensor:
    """floor(log2(x)) for int32 x > 0 (exact: float64 holds 31 bits)."""
    return (torch.frexp(x.to(torch.float64))[1] - 1).to(torch.int32)


def _clip(n):
    return n.clamp(0, 31)


def _shr(x, n):
    return x >> _clip(n)


def _shl(x, n):
    return x << _clip(n)


def _net_shift(x, left):
    """The retimed bidirectional normalize∥align shifter of Fig. 6."""
    return torch.where(left >= 0, _shl(x, left), _shr(x, -left))


def _fields(x: torch.Tensor, man_bits: int):
    """(s, e_unbiased, mantissa-with-hidden) as int32 of values on the
    format's grid (the fraction is truncated, which is then exact)."""
    bits = x.to(torch.float32).contiguous().view(torch.int32)
    s = (bits >> 31) & 1
    e32 = (bits >> 23) & 0xFF
    frac = (bits >> (23 - man_bits)) & ((1 << man_bits) - 1)
    m = torch.where(e32 > 0, frac | (1 << man_bits), 0)
    e = torch.where(m == 0, E_ZERO, e32 - 127)
    return s, e, m


def fma_emu_matmul_ref(a: torch.Tensor, w: torch.Tensor,
                       fmt_name: str = "bf16", mode: str = "exact"
                       ) -> torch.Tensor:
    """Plain version: int32 torch ops over the (M, N) outputs, a loop over
    K, the TPU kernel's algebra line for line. Returns (M, N) fp32."""
    global PLAIN_CALLS
    PLAIN_CALLS += 1
    fmt = _check_args(a, w, fmt_name, mode)
    mb = fmt.man_bits
    approx = mode == "approx"
    M, K = a.shape
    N = w.shape[1]
    fa = _fields(a, mb)
    fw = _fields(w, mb)
    i32 = dict(dtype=torch.int32, device=a.device)
    s_p = torch.zeros((M, N), **i32)
    ehat = torch.full((M, N), E_ZERO, **i32)
    S = torch.zeros((M, N), **i32)
    L = torch.zeros((M, N), **i32)
    for k in range(K):
        sa, ea, ma = (f[:, k:k + 1] for f in fa)              # (M, 1)
        sb, eb, mbk = (f[k:k + 1, :] for f in fw)             # (1, N)
        # stage 1: multiplier (exact in the wide register)
        mm = ma * mbk                                         # (M, N)
        pm_msb = _msb(torch.clamp_min(mm, 1))
        e_m = ea + eb - 2 * mb + pm_msb
        m_m = _shl(mm, ACC_MSB - pm_msb)
        s_m = sa ^ sb
        e_m = torch.where(mm == 0, E_ZERO, e_m)
        # stage 1: speculative exponent compute (uses ê, not e)
        ge = e_m >= ehat
        d_spec = (e_m - ehat).abs()
        # stage 2: fix with the forwarded L of the previous PE
        d_fix = torch.where(ge, d_spec + L, L - d_spec)
        prod_dom = d_fix > 0
        zero_prev = S == 0
        e_max = torch.where(prod_dom, e_m, ehat - L)
        e_max = torch.where(zero_prev, e_m, e_max)
        # retimed normalize ∥ align: one net shift of the incoming sum
        acc_net_left = (L - 1) - torch.clamp_min(d_fix, 0)
        Sa = torch.where(zero_prev, 0, _net_shift(S, acc_net_left))
        mp = torch.where(e_m == E_ZERO, 0,
                         _shr(m_m, torch.clamp_min(-d_fix, 0)))
        # adder + LZA
        v = torch.where(s_m == 1, -mp, mp) + torch.where(s_p == 1, -Sa, Sa)
        s_o = (v < 0).to(torch.int32)
        S_o = v.abs()
        L_o = _Q - _msb(torch.clamp_min(S_o, 1))
        if approx:
            L_o = L_o & ~(APPROX_COARSE - 1)
        z = S_o == 0
        s_p = torch.where(z, 0, s_o)
        ehat = torch.where(z, E_ZERO, e_max + 1)
        S = S_o
        L = torch.where(z, 0, L_o)

    # column end: deferred final normalization + the single rounding stage
    Ln = _Q - _msb(torch.clamp_min(S, 1))
    e = ehat - Ln
    m = _net_shift(S, Ln - 1)
    low = m & ((1 << GUARD) - 1)
    keep = m >> GUARD
    half = 1 << (GUARD - 1)
    up = (low > half) | ((low == half) & ((keep & 1) == 1))
    keep = keep + up.to(torch.int32)
    ovf = (keep >> 24) != 0
    keep = torch.where(ovf, keep >> 1, keep)
    e = e + ovf.to(torch.int32)
    # bit-exact fp32 construction: FTZ below the normal range (keeping the
    # sign), saturate to Inf above it
    e32 = e + 127
    sgn = s_p << 31
    bits = sgn | (e32.clamp(0, 255) << 23) | (keep & 0x7FFFFF)
    bits = torch.where(e32 >= 255, sgn | 0x7F800000, bits)
    bits = torch.where((S == 0) | (e32 <= 0), sgn, bits)
    return bits.to(torch.int32).view(torch.float32)


def rows_per_block(m: int) -> int:
    """Output rows per block of the kernel: 1, 2, 4 or 8 (32 columns
    each), the least power of two that covers M, at most 8."""
    tm = 1
    while tm < min(m, 8):
        tm *= 2
    return tm


def fma_emu_matmul_cuda(a: torch.Tensor, w: torch.Tensor,
                        fmt_name: str = "bf16", mode: str = "exact"
                        ) -> torch.Tensor:
    """Launch the skewed-datapath kernel: a (M, K) and w (K, N) on one CUDA
    device in fp32, bf16 or fp16 containers → (M, N) fp32."""
    global LAUNCHES
    from .build import check, function

    fmt = _check_args(a, w, fmt_name, mode)
    for t in (a, w):
        if not t.is_cuda or t.device != a.device:
            raise ValueError("fma_emu_matmul_cuda needs both operands on "
                             "one CUDA device")
        if t.dtype not in _DTYPE_CODE:
            raise ValueError(f"fma_emu_matmul_cuda takes fp32, bf16 or "
                             f"fp16 containers, got {t.dtype}")
    a, w = a.contiguous(), w.contiguous()
    M, K = a.shape
    N = w.shape[1]
    out = torch.empty((M, N), dtype=torch.float32, device=a.device)
    if M == 0 or N == 0:
        return out
    fn = function("fp_emu", "fp_emu_launch",
                  [ctypes.c_void_p] * 3 + [ctypes.c_int] * 8
                  + [ctypes.c_void_p])
    err = fn(a.data_ptr(), w.data_ptr(), out.data_ptr(), M, N, K,
             _DTYPE_CODE[a.dtype], _DTYPE_CODE[w.dtype], fmt.man_bits,
             int(mode == "approx"), rows_per_block(M),
             torch.cuda.current_stream(a.device).cuda_stream)
    check(err, "fp_emu")
    LAUNCHES += 1
    return out
