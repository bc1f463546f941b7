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

The kernel (`csrc/fp_emu.cu`) walks each output's K chain in one thread;
K stays serial, because truncating alignment does not associate. It
carries the sum normalized by its LZA count (T = S << (L + 4)) and e_t = ê
− L, so a PE step's dependent path is two shift amounts, two aligning
shifts, an add, abs and the LZA; the product and the operands' fields are
off the chain. A GEMM is bound by K times that path's latency where few
outputs are in flight (decode) and by instruction issue where many are
(prefill); `launch_plan` picks, from (M, N), how many chains a thread
interleaves and how the warps spread over the SMs.

A meta tensor takes the kernel's meta route: the same checks and plan as
a CUDA tensor, then a meta output and a record for the cost counters
(`core/tally.py`) in place of the launch; the launch counters do not
move.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core import tally

from repro_torch.core.chained_fma import ACC_MSB, APPROX_COARSE, E_ZERO, GUARD
from repro_torch.core.fpformats import get_format

LAUNCHES = 0       # kernel launches through `fma_emu_matmul_cuda`
PLAIN_CALLS = 0    # calls of the plain version `fma_emu_matmul_ref`

MODES = ("exact", "approx")
MODE_LAUNCHES = {m: 0 for m in MODES}   # the launches by mode
_Q = ACC_MSB + 1
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}

# The launch plan's model of the card (csrc/fp_emu.cu), from chip_smoke.py
# readings on an H100 SXM (PERF.md §6): SMS SMs, four warp schedulers
# each issuing one instruction a cycle; CHAIN_CYCLES, a PE step's
# dependent path (the chain probe, `chain_cycles`: 50.8); SASS a PE step of
# the interleaved kernel by rows a thread (its K loop: 34.75, 28.5, 25.8);
# PC_BLOCKS, the producer/consumer blocks an SM up to which that kernel
# beat the interleaved one (wk at M = 1-16, wq, wo, wd at M = 2; not wg at
# M = 2 nor wk at M = 17). OPS_PER_STEP is the source's count of one PE
# step: `product` 6 (multiply, two exponent adds, the high bit, two sign
# xors) and `pe_chain` 24 (hi and the sign 2, g, p and the signs' sum 5,
# the cap 1, the two shift amounts 4, e_max 2, the two aligning shifts 2,
# the add 3, abs 1, the LZA 1, the normalizing shift 1, sign and exponent
# tag 2); chip_smoke.py prints it beside the SASS it counts.
OPS_PER_STEP = 30
SMS = 132
SCHEDULERS = 4
CHAIN_CYCLES = 51
SASS_A_STEP = {1: 35, 2: 29, 4: 26}
PC_BLOCKS = 4
ROWS = tuple(SASS_A_STEP)  # chains a thread of `ilp` (kernel template)
ILP_WARPS = 4             # warps a block of `ilp`
PC_WARPS = 3              # warps a block of `pc`: a consumer, two producers
KERNELS = ("pc", "ilp")


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


def launch_plan(m: int, n: int, sms: int = SMS) -> dict:
    """How the kernel covers an (m, n) output, 32 columns a warp (`strips`
    of them): the `kernel`, `rows` chains a thread, `warps` a block and the
    `grid` (strip groups, row groups).

    * `pc` (producer/consumer) where few chains are in flight, its blocks
      (one row of 32 outputs each) at most PC_BLOCKS an SM (decode): each
      block's two producer warps compute every step's product ahead into
      shared memory and its consumer warp runs only the chain, so the
      chain's latency, not one warp's in-order issue, sets the pace; rows
      1, warps PC_WARPS, grid (strips, m).
    * `ilp` elsewhere (prefill): each thread interleaves `rows` chains of
      one column, sharing W's field, in blocks of ILP_WARPS warps (one a
      scheduler); rows minimize a step's modelled time, the largest of the
      chain's latency, one warp's issue (rows × SASS_A_STEP[rows]) and the
      card's (all warps' over sms × SCHEDULERS), ties to fewer rows.

    Every plan gives every output the same bits: an output is one chain,
    walked k = 0..K-1 in one thread."""
    strips = -(-n // 32)
    if strips * m <= PC_BLOCKS * sms:
        return {"kernel": "pc", "rows": 1, "warps": PC_WARPS,
                "strips": strips, "grid": (strips, m)}
    best = None
    for rows, ops in SASS_A_STEP.items():
        if rows > max(m, 1):
            break
        per_warp = rows * ops
        t = max(CHAIN_CYCLES, per_warp,
                strips * -(-m // rows) * per_warp / (sms * SCHEDULERS))
        if best is None or t < best[0]:
            best = (t, rows)
    rows = best[1]
    return {"kernel": "ilp", "rows": rows, "warps": ILP_WARPS,
            "strips": strips,
            "grid": (-(-strips // ILP_WARPS), -(-m // rows))}


def _launch(a: torch.Tensor, w: torch.Tensor, fmt_name: str, mode: str,
            plan: dict | None = None) -> torch.Tensor:
    """One launch of the skewed-datapath kernel → (M, N) fp32. `plan`
    forces a launch plan's `kernel` and, for `ilp`, its `rows` (tests and
    sweeps); by default `launch_plan(M, N)`."""
    from .build import check, function

    fmt = _check_args(a, w, fmt_name, mode)
    for t in (a, w):
        if not (t.is_cuda or t.is_meta) or t.device != a.device:
            raise ValueError("fma_emu_matmul_cuda needs both operands on "
                             "one CUDA device (or the meta device)")
        if t.dtype not in _DTYPE_CODE:
            raise ValueError(f"fma_emu_matmul_cuda takes fp32, bf16 or "
                             f"fp16 containers, got {t.dtype}")
    a, w = a.contiguous(), w.contiguous()
    M, K = a.shape
    N = w.shape[1]
    out = torch.empty((M, N), dtype=torch.float32, device=a.device)
    if M == 0 or N == 0:
        return out
    if K == 0:           # no PE: every column ends on a zero sum, +0
        return out.zero_()
    plan = plan or launch_plan(M, N)
    pc = plan.get("kernel") == "pc"
    if plan.get("kernel") not in KERNELS or not pc and plan.get(
            "rows") not in ROWS:
        raise ValueError(f"fp_emu plan {plan}: kernel in {KERNELS}; for ilp "
                         f"rows in {ROWS}")
    if a.is_meta:
        tally.kernel("fp_emu", route=plan["kernel"], flops=2 * M * N * K,
                     nbytes=(a.numel() * a.element_size()
                             + w.numel() * w.element_size() + 4 * M * N))
        return out
    fn = function("fp_emu", "fp_emu_launch",
                  [ctypes.c_void_p] * 3 + [ctypes.c_int] * 9
                  + [ctypes.c_void_p])
    err = fn(a.data_ptr(), w.data_ptr(), out.data_ptr(), M, N, K,
             _DTYPE_CODE[a.dtype], _DTYPE_CODE[w.dtype], fmt.man_bits,
             int(mode == "approx"), int(pc), plan.get("rows", 1),
             torch.cuda.current_stream(a.device).cuda_stream)
    check(err, "fp_emu")
    return out


def fma_emu_matmul_cuda(a: torch.Tensor, w: torch.Tensor,
                        fmt_name: str = "bf16", mode: str = "exact"
                        ) -> torch.Tensor:
    """Launch the skewed-datapath kernel on `launch_plan(M, N)`: a (M, K)
    and w (K, N) on one CUDA device in fp32, bf16 or fp16 containers →
    (M, N) fp32."""
    global LAUNCHES
    out = _launch(a, w, fmt_name, mode)
    if not out.is_meta:
        LAUNCHES += 1
        MODE_LAUNCHES[mode] += 1
    return out


def chain_cycles(steps: int = 8192, device: str = "cuda") -> float:
    """SM cycles of one PE step's dependent path on the card: the kernel
    library's chain probe (`fp_emu_chain_probe_launch`), one thread
    walking `steps` exact-mode steps of one output with a bf16 product (1.5
    × 1.25) that the compiler holds outside the loop. K times this, at the
    SM clock, is the least time an output's serial chain can take."""
    from .build import check, function

    c = ACC_MSB - 2 * get_format("bf16").man_bits
    fields = torch.tensor([0xC0 << c, 0, 0, 0xA0, 0, 0], dtype=torch.int32,
                          device=device)
    cycles = torch.zeros(2, dtype=torch.int64, device=device)
    fn = function("fp_emu", "fp_emu_chain_probe_launch",
                  [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_void_p])
    stream = torch.cuda.current_stream(device).cuda_stream
    for _ in range(2):   # the first launch loads the module
        check(fn(fields.data_ptr(), steps, cycles.data_ptr(), stream),
              "fp_emu chain probe")
    return float(cycles[0]) / steps
