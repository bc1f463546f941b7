"""Dispatch for the port's kernels.

A CPU tensor goes to the kernel's plain PyTorch version; a CUDA tensor goes
to the hand-written kernel, which launches or raises. There is no fallback
from the kernel to the plain version.

Each kernel module keeps two plain integers: `LAUNCHES` (kernel launches)
and `PLAIN_CALLS` (calls of its plain version). `counts()` reads them and
`reset_counts()` sets them to 0, so a run can show which path it took.
"""
from __future__ import annotations

from . import sa_attention as _attn
from . import sa_decode_attention as _decode
from . import sa_matmul as _mm
from .sa_decode_attention import fused_decode_supported

_MODULES = {"sa_matmul": _mm, "paged_decode": _decode,
            "prefill_attention": _attn}


def sa_matmul(a, w, *, bias=None, act: str = "none", scale=None,
              mode: str = "exact"):
    """(M, K) @ (K, N) under the SA contract with the fused epilogue
    `act(truncate?(acc) · scale + bias)`, fp32 out."""
    if a.device.type == "cpu":
        return _mm.sa_matmul_ref(a, w, bias, scale, act=act, mode=mode)
    return _mm.sa_matmul_cuda(a, w, bias, scale, act=act, mode=mode)


def paged_decode_attention(q, k_pool, v_pool, page_positions, block_table,
                           pos, **kw):
    """Paged decode attention over the block table (see
    sa_decode_attention.py)."""
    if q.device.type == "cpu":
        return _decode.paged_decode_ref(q, k_pool, v_pool, page_positions,
                                        block_table, pos, **kw)
    return _decode.paged_decode_cuda(q, k_pool, v_pool, page_positions,
                                     block_table, pos, **kw)


def sa_attention(q, k, v, **kw):
    """Prefill flash attention, q (B, T, H, hd), k/v (B, S, KVH, hd)."""
    if q.device.type == "cpu":
        return _attn.flash_attention_ref(q, k, v, **kw)
    return _attn.sa_attention_cuda(q, k, v, **kw)


def counts() -> dict[str, dict[str, int]]:
    return {name: {"launches": m.LAUNCHES, "plain_calls": m.PLAIN_CALLS}
            for name, m in _MODULES.items()}


def reset_counts():
    for m in _MODULES.values():
        m.LAUNCHES = 0
        m.PLAIN_CALLS = 0


__all__ = ["sa_matmul", "paged_decode_attention", "sa_attention",
           "fused_decode_supported", "counts", "reset_counts"]
