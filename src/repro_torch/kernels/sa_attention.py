"""Prefill flash attention under the SA contract: plain version and the
hand-written Hopper kernel.

Replaces the TPU kernel `repro/kernels/sa_attention.py` `_attn_kernel`
(forward-only flash attention: online max and normalizer, unnormalized
fp32 accumulator, one normalization with a 1e-30 floor; causal, window,
softcap, `q_offset`, GQA through h // g).

The contract is the JAX package's `models/layers.blockwise_attention`
(forward), not the literal TPU kernel: q and k are cast in (bf16 under the
default policy) before the fp32 q·k, and the unnormalized probabilities P
and v are cast in before the fp32 P·V. The TPU kernel feeds raw fp32
operands and has no approx path; the serve engine's prefill runs `exact`,
so the kernel takes `exact` only and raises on `approx`.

Layout at both functions: q (B, T, H, hd), k and v (B, S, KVH, hd) →
(B, T, H, hd), the layer's own.

The kernel (`csrc/sa_attention.cu`) has two routes, chosen by the policy's
input format and counted apart in `ROUTE_LAUNCHES`; a failed build or
launch of either raises:

* `mma` (bf16, fp16): q·k and P·V on the tensor cores (`mma.sync` m16n8k16,
  fp32 accumulate), whose 16-bit operands are exactly the contract's
  cast-in q, k, P and v. A warp owns 16 query rows of one head; 64-key
  tiles of fp32 K and V arrive by cp.async while the previous tile
  computes and are converted once per block into swizzled 16-bit tiles;
  K and V already in the policy's 16-bit type (a 16-bit cache) are copied
  by cp.async straight into those tiles, two deep, with no fp32 copy and
  no conversion (the same bits the conversion would give).
  At serving lengths (T ≤ 128) neither the flops (0.17 µs at 989 TFLOP/s)
  nor the bytes (1.9 µs at 3.35 TB/s) bound a call: latency does, the
  loads and the 16-bit conversion of each block's key tiles, so a block
  keeps its loads in flight together and shares each converted tile among
  its 8 warps (`launch_plan`). The tensor cores' truncating accumulation
  is charged in `softmax_error_terms` (`tensor_cores`). At head dim 256
  (gemma2, gemma3) a warp's 16 × 256 output takes 128 registers a
  thread, so each warp keeps its q rows in shared memory (cast in once,
  read by ldmatrix each k-step) and the key tile is 32 keys
  (`key_tile`): no spill, and one block within an SM's shared memory.
* `simt` (fp32): fp32 FMA chains (fp32 has no exact tensor-core type),
  one block per (16-query tile, head, batch row).

Both read q, k, v through their strides (the last dimension contiguous)
and write out (B, T, H, hd) contiguous: the layer's `attention_block`
hands its rotated q view over as it is, and `attn_out` reshapes the
result without a copy. Causal tiles past a block's last query are
skipped.

A meta tensor takes the kernel's meta route: the same checks and plan as
a CUDA tensor, then a meta output and a record for the cost counters
(`core/tally.py`) in place of the launch; the launch counters do not
move.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.core import tally

LAUNCHES = 0       # kernel launches through `sa_attention_cuda`
PLAIN_CALLS = 0    # calls of the plain version `flash_attention_ref`
ROUTE_LAUNCHES = {"mma": 0, "simt": 0}   # the launches by route
# the launches by policy mode: `approx` stays 0 (the kernel raises on it)
MODE_LAUNCHES = {"exact": 0, "approx": 0}

_INPUT_FORMATS = ("fp32", "bf16", "fp16")
_KV_DTYPES = (torch.float32, torch.bfloat16, torch.float16)
_TYPE_16 = {"bf16": torch.bfloat16, "fp16": torch.float16}


def _div_block(n, target):  # largest divisor of n that is <= target
    b = min(target, n)
    while n % b:
        b -= 1
    return b


def scores(q_i, k_j, q_pos, kv_pos, causal, window, cap, scale, policy):
    """Raw and masked, capped scores of one (q block, kv block) tile, the
    JAX package's `layers._scores`: (B, KVH, g, bq, bkv) fp32 each."""
    from repro_torch.core.precision import sa_einsum

    s_raw = sa_einsum("bqhgd,bkhd->bhgqk", q_i, k_j, policy).float()
    s = s_raw * scale
    if cap:
        s = cap * torch.tanh(s / cap)
    ok = torch.ones((q_pos.shape[0], kv_pos.shape[0]), dtype=torch.bool,
                    device=q_i.device)
    if causal:
        ok &= q_pos[:, None] >= kv_pos[None, :]
    if window:
        ok &= q_pos[:, None] - kv_pos[None, :] < window
    return s_raw, s + torch.where(ok, 0.0, float("-inf"))


def flash_forward(q, k, v, *, causal, window, cap, q_offset, bq, bkv, scale,
                  policy):
    """The online-softmax forward of the JAX package's `_flash_fwd_impl`:
    grouped q (B, T, KVH, g, hd), k/v (B, S, KVH, hd) → out (B, KVH, g, T,
    hd) in q's dtype and the log-sum-exp lse (B, KVH, g, T), with the
    (bq, bkv) tiling and every contraction under the SA contract."""
    from repro_torch.core.precision import sa_einsum

    B, T, KVH, g, hd = q.shape
    S = k.shape[1]
    nq, nkv = T // bq, S // bkv
    dev = q.device
    blocks, lses = [], []
    for iq in range(nq):
        q_i = q[:, iq * bq:(iq + 1) * bq]
        q_pos = q_offset + iq * bq + torch.arange(bq, device=dev)
        acc = torch.zeros((B, KVH, g, bq, hd), dtype=torch.float32,
                          device=dev)
        m = torch.full((B, KVH, g, bq), float("-inf"), device=dev)
        l = torch.zeros((B, KVH, g, bq), device=dev)
        for jk in range(nkv):
            k_j = k[:, jk * bkv:(jk + 1) * bkv]
            v_j = v[:, jk * bkv:(jk + 1) * bkv]
            kv_pos = jk * bkv + torch.arange(bkv, device=dev)
            _, s = scores(q_i, k_j, q_pos, kv_pos, causal, window, cap,
                          scale, policy)
            m_new = torch.maximum(m, s.amax(-1))
            # fully-masked tiles leave m_new = -inf; the guard keeps exp()
            # at exactly 0 instead of NaN
            m_safe = torch.where(torch.isfinite(m_new), m_new, 0.0)
            p = torch.exp(s - m_safe[..., None])
            corr = torch.exp(m - m_safe)
            l = l * corr + p.sum(-1)
            pv = sa_einsum("bhgqk,bkhd->bhgqd", p.to(q.dtype), v_j, policy)
            acc = acc * corr[..., None] + pv.float()
            m = m_new
        blocks.append((acc / torch.clamp_min(l, 1e-30)[..., None]).to(q.dtype))
        lses.append(m + torch.log(torch.clamp_min(l, 1e-30)))
    return torch.cat(blocks, dim=3), torch.cat(lses, dim=3)


def flash_attention_ref(q, k, v, *, causal=True, window=0, cap=0.0,
                        q_offset=0, block_q=1024, block_kv=1024, scale=None,
                        policy=None):
    """Plain version: the online-softmax forward of `blockwise_attention`
    with its (block_q, block_kv) tiling, every contraction under the SA
    contract (`sa_einsum`)."""
    global PLAIN_CALLS
    from repro_torch.core.precision import current_policy

    PLAIN_CALLS += 1
    policy = policy or current_policy()
    B, T, H, hd = q.shape
    S, KVH = k.shape[1], k.shape[2]
    out, _ = flash_forward(
        q.reshape(B, T, KVH, H // KVH, hd), k, v, causal=causal,
        window=window, cap=cap, q_offset=q_offset,
        bq=_div_block(T, block_q), bkv=_div_block(S, block_kv),
        scale=scale or hd ** -0.5, policy=policy)
    return out.permute(0, 3, 1, 2, 4).reshape(B, T, H, hd)


MMA_WARPS = 8        # mma route: warps a block, 16 query rows each
_SIMT_ROWS = 16      # simt route: 4 warps x 4 query rows
MMA_HEAD_DIMS = (64, 128, 256)   # head dims the mma route instantiates
SIMT_MAX_HD = 256    # simt route: hd a multiple of 32 up to this


def key_tile(hd: int) -> int:
    """Keys a tile of the mma route: 64, or 32 at hd 256, whose warps keep
    their q rows in shared memory (csrc/sa_attention.cu `MmaShape`)."""
    return 32 if hd > 128 else 64


def launch_plan(B: int, T: int, H: int, hd: int, input_format: str,
                kv16: bool = False) -> dict:
    """How `sa_attention_cuda` launches: the route (`mma` for bf16 and fp16
    inputs, `simt` for fp32), warps a block, query rows a block, the grid
    (q tiles, H, B) and the dynamic shared memory a block (`kv16`: the mma
    route reading K and V in the policy's 16-bit type, two 16-bit tile
    pairs and no fp32 staging; at hd 256 also each warp's 16 q rows in 16
    bits).

    The mma route's blocks have MMA_WARPS warps at every T: each block
    converts its key tiles to 16 bits once for all its warps: on the card
    8 warps (128 rows) and 4 beat 2 and 1 at T = 32, 64, 128 and 1024,
    though they give fewer blocks than SMs at short T; 8 and 4 are within
    noise of each other at T ≤ 128 and 8 is faster at T = 1024
    (chip_smoke sweeps the width; PERF.md)."""
    if input_format == "fp32":
        rows = _SIMT_ROWS
        plan = {"route": "simt", "warps": 4,
                "smem": 4 * (rows * hd + 32 * (hd + 1) + 32 * hd)}
    else:
        rows = 16 * MMA_WARPS
        # fp32 staging of a K and a V tile and their 16-bit copies; or, for
        # 16-bit K and V, two 16-bit (K, V) tile pairs; at hd 256 the
        # warps' q rows in 16 bits
        q_rows = MMA_WARPS * 16 * hd * 2 if hd > 128 else 0
        plan = {"route": "mma", "warps": MMA_WARPS, "key_tile": key_tile(hd),
                "smem": key_tile(hd) * hd * (2 * 2 * 2 if kv16
                                             else 2 * 4 + 2 * 2) + q_rows}
    plan.update(rows=rows, grid=(-(-T // rows), H, B))
    return plan


def visible_pairs(T: int, S: int, causal: bool = True, window: int = 0,
                  q_offset: int = 0) -> int:
    """The (query, key) pairs the masks leave visible: query i sits at
    position q_offset + i over keys at positions 0..S-1; causal keeps keys
    at or before it, a window the last `window` of those. Attention's work
    is 4·hd flops a pair a query head (q·k and p·v), whatever computes
    it."""
    qpos = q_offset + np.arange(T, dtype=np.int64)
    hi = np.minimum(qpos + 1, S) if causal else np.full(T, S)
    lo = np.maximum(qpos - window + 1, 0) if window and causal else 0
    return int(np.maximum(hi - lo, 0).sum())


def _strides(t) -> list:
    """(batch, row, head) strides of a (B, rows, heads, hd) view whose last
    dimension is contiguous and whose rows start on 16 bytes (0 for a
    dimension of size 1), or a ValueError."""
    st = [s if n > 1 else 0 for s, n in zip(t.stride(), t.shape)]
    per16 = 16 // t.element_size()
    if (t.stride(3) != 1 or any(s % per16 for s in st[:3])
            or t.data_ptr() % 16):
        raise ValueError(f"sa_attention_cuda reads q, k, v through their "
                         f"strides; unsupported layout {tuple(t.shape)} "
                         f"strides {t.stride()}")
    return st[:3]


def sa_attention_cuda(q, k, v, *, causal=True, window=0, cap=0.0,
                      q_offset=0, scale=None, policy=None):
    """Launch the prefill flash kernel. q (B, T, H, hd) fp32, k/v (B, S,
    KVH, hd) fp32, bf16 or fp16 (one type), on one CUDA device, any strides
    with the last dimension contiguous → (B, T, H, hd) contiguous. The
    route follows the policy's input format (`launch_plan`): `mma` (tensor
    cores) for bf16 and fp16, hd 64, 128 or 256, which reads 16-bit K and
    V of the policy's type as they are (another 16-bit type is cast in
    first, exactly as `cast_in` does); `simt` for fp32, hd a multiple of 32
    up to 256, which widens 16-bit K and V to fp32."""
    global LAUNCHES
    from repro_torch.core.precision import current_policy
    from .build import check, function

    policy = policy or current_policy()
    if policy.mode != "exact":
        raise ValueError("the prefill attention kernel runs exact mode only "
                         "(serving prefill is exact)")
    if (policy.input_format not in _INPUT_FORMATS
            or policy.output_format != "fp32"):
        raise ValueError(f"prefill attention kernel does not support "
                         f"input_format={policy.input_format!r} / "
                         f"output_format={policy.output_format!r}")
    for t in (q, k, v):
        if not (t.is_cuda or t.is_meta) or t.device != q.device:
            raise ValueError("sa_attention_cuda needs q, k, v on one CUDA "
                             "device (or the meta device)")
    B, T, H, hd = q.shape
    S, KVH = k.shape[1], k.shape[2]
    if k.dtype not in _KV_DTYPES or v.dtype != k.dtype:
        raise ValueError(f"unsupported K/V types {k.dtype}, {v.dtype}")
    kv16 = (policy.input_format != "fp32"
            and k.dtype in (torch.bfloat16, torch.float16))
    plan = launch_plan(B, T, H, hd, policy.input_format, kv16)
    route = plan["route"]
    hd_ok = (hd in MMA_HEAD_DIMS if route == "mma"
             else hd % 32 == 0 and hd <= SIMT_MAX_HD)
    if H % KVH or not hd_ok or v.shape != k.shape:
        raise ValueError(f"unsupported shapes q {tuple(q.shape)} "
                         f"k {tuple(k.shape)} v {tuple(v.shape)} for the "
                         f"{route} route")
    scale = scale or hd ** -0.5
    q = q.to(torch.float32)
    kv_dtype = _TYPE_16[policy.input_format] if kv16 else torch.float32
    k, v = k.to(kv_dtype), v.to(kv_dtype)
    strides = [*_strides(q), *_strides(k), *_strides(v)]
    out = torch.empty((B, T, H, hd), dtype=torch.float32, device=q.device)
    if q.is_meta:
        tally.kernel("prefill_attention", route=route,
                     flops=4 * hd * H * B * visible_pairs(
                         T, S, causal, window, q_offset),
                     nbytes=sum(t.numel() * t.element_size()
                                for t in (q, k, v, out)))
        return out
    head = [q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            B, H, KVH, T, S, hd, *strides, float(scale), float(cap or 0.0),
            int(causal), int(window), int(q_offset)]
    common = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
              + [ctypes.c_longlong] * 9 + [ctypes.c_float] * 2
              + [ctypes.c_int] * 3)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    if route == "mma":
        fn = function("sa_attention", "sa_attention_mma_launch",
                      common + [ctypes.c_int] * 4 + [ctypes.c_void_p])
        err = fn(*head, int(policy.input_format == "fp16"), int(kv16),
                 plan["warps"], plan["smem"], stream)
    else:
        fn = function("sa_attention", "sa_attention_simt_launch",
                      common + [ctypes.c_int, ctypes.c_void_p])
        err = fn(*head, plan["smem"], stream)
    check(err, f"sa_attention ({route})")
    LAUNCHES += 1
    ROUTE_LAUNCHES[route] += 1
    MODE_LAUNCHES[policy.mode] += 1
    return out


# unit roundoff of the cast-in format (fp32 and anything else: 2⁻²⁴)
UNIT_ROUNDOFF = {"bf16": 2.0 ** -8, "fp16": 2.0 ** -11}


# products a tensor-core group aligns before one addition: at least 4 (the
# smallest group Fasi, Higham, Mikaitis and Pranesh, "Numerical behavior of
# NVIDIA tensor cores", PeerJ CS 2021, found on any NVIDIA tensor core)
TC_GROUP = 4


def softmax_error_terms(s_raw, a_abs, ok, *, hd, scale, cap=0.0,
                        approx=False, tensor_cores=False):
    """The exact softmax weights of one set of attention scores, and how far
    an fp32 implementation's weights may stray from them.

    `s_raw` (..., S) are the exact (fp64) dots of the cast-in q and k,
    `a_abs` (..., S) the matching Σ_d |q_d||k_d|, `ok` the mask. Returns
    `p` (..., S), the normalized weights (0 where masked), and `eps`
    (..., 1), a bound on |p_impl − p| / p for either implementation, per
    row. An fp32 dot of hd exact products makes hd additions, each off by
    less than one unit in the 24th bit of a partial sum (2⁻²³, rounding
    either way), so by ≤ hd·2⁻²³·Σ|q||k|. On tensor cores
    (`tensor_cores`, the bf16 and fp16 dots of the prefill kernel) the
    products are exact, but a group of n_g ≥ TC_GROUP of them and the
    running sum are aligned to the largest exponent and truncated before
    one addition, whose result is truncated once more (Fasi et al., 2021):
    n_g + 1 errors a group, each < 2⁻²³ of a term or partial sum, so
    ≤ (hd + ⌈hd / n_g⌉)·2⁻²³·Σ|q||k|. In approx mode add one truncation
    quantum, 2⁻²⁰·|s|; then scale, plus a few ulp of the scaling, softcap
    and exp; p = e^(s − m) moves by the score's error and the row max's,
    and its normalizer by the fp32 sum of S terms. Kernel and plain version
    each lie within `eps` of `p`."""
    terms = hd + (-(-hd // TC_GROUP) if tensor_cores else 0)
    ds = terms * 2.0 ** -23 * a_abs
    if approx:
        ds = ds + 2.0 ** -20 * s_raw.abs()
    s = cap * torch.tanh(s_raw * (scale / cap)) if cap else s_raw * scale
    ds = scale * ds + 2.0 ** -22 * s.abs() + (2.0 ** -21 * cap if cap else 0)
    s = torch.where(ok, s, float("-inf"))
    m = s.amax(-1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, 0.0)
    e = torch.exp(s - m)
    p = e / e.sum(-1, keepdim=True).clamp_min(1e-300)
    e_s = torch.where(ok, ds, 0.0).amax(-1, keepdim=True)
    spread = torch.where(ok, (s - m).abs(), 0.0).amax(-1, keepdim=True)
    eps = (2 * e_s + 2.0 ** -21 * (1 + spread)
           + 2 * s.shape[-1] * 2.0 ** -24)
    return p, eps


def error_bound(q, k, v, *, causal=True, window=0, cap=0.0, q_offset=0,
                scale=None, policy=None):
    """Per-output bound on |kernel − plain| (B, T, H, hd), from the plain
    version's own terms.

    With p the exact softmax weights and W_d = Σ_j p_j |v_jd| (cast-in v):
    the two tile the keys differently, so each rounds its unnormalized P to
    the input format against a different running max — up to one rounding
    u_in per element on each side (u_in = 2⁻⁸ bf16, 2⁻¹¹ fp16, 2⁻²⁴ fp32) —
    on top of each side's weights straying by `eps` (numerator and
    normalizer, `softmax_error_terms`; the kernel's bf16 and fp16 q·k on
    tensor cores), the fp32 P·V and normalizer sums and the running
    rescales and the final division:
    |Δo_d| ≤ (2·u_in + 2·eps + 8·S·2⁻²⁴ + 2⁻²²)·W_d. The 8·S·2⁻²⁴ holds
    the kernel's P·V on tensor cores (≤ (S + ⌈S / 4⌉)·2⁻²³, the same count
    as the q·k above), its normalizer (S·2⁻²⁴) and the plain version's
    two sums (S·2⁻²⁴ each), with the rescales (one a key tile) to spare.
    The leading 2 of the returned bound covers the second-order terms."""
    from repro_torch.core.precision import current_policy

    policy = policy or current_policy()
    u_in = UNIT_ROUNDOFF.get(policy.input_format, 2.0 ** -24)
    B, T, H, hd = q.shape
    S, KVH = k.shape[1], k.shape[2]
    g = H // KVH
    scale = scale or hd ** -0.5
    f64 = torch.float64
    qc = policy.cast_in(q).to(f64).reshape(B, T, KVH, g, hd)
    kc, vc = (policy.cast_in(x).to(f64) for x in (k, v))
    s_raw = torch.einsum("bthgd,bshd->bhgts", qc, kc)
    a_abs = torch.einsum("bthgd,bshd->bhgts", qc.abs(), kc.abs())
    q_pos = q_offset + torch.arange(T, device=q.device)[:, None]
    kv_pos = torch.arange(S, device=q.device)[None, :]
    ok = torch.ones((T, S), dtype=torch.bool, device=q.device)
    if causal:
        ok &= q_pos >= kv_pos
    if window:
        ok &= q_pos - kv_pos < window
    p, eps = softmax_error_terms(
        s_raw, a_abs, ok, hd=hd, scale=scale, cap=cap,
        tensor_cores=policy.input_format in ("bf16", "fp16"))
    w = torch.einsum("bhgts,bshd->bthgd", p, vc.abs())
    rel = (2 * u_in + 2 * eps.permute(0, 3, 1, 2, 4)
           + 8 * S * 2.0 ** -24 + 2.0 ** -22)
    return (2 * rel * w).reshape(B, T, H, hd).to(torch.float32) + 1e-30
