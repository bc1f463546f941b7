"""Gradient compression for the cross-replica reduction, with error
feedback: the port of the JAX package's `repro/parallel/compression.py`.

Codecs: ``bf16`` rounds each gradient to bf16 before the reduction (half
the payload); ``int8`` quantizes each leaf symmetrically to int8 on one
grid agreed by every rank (a MAX all-reduce of the scale), sums the int8
payloads in int32 and dequantizes, the quantization error carried to the
next step (the residual; Karimireddy et al. 2019); ``none`` sums as is.
`compressed_psum` is a library function, as in the JAX package: no train
step calls it.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.models.model import tree_leaves, tree_map


def quantize_int8(g: torch.Tensor):
    scale = torch.clamp_min(g.abs().max(), 1e-12) / 127.0
    q = torch.clip(torch.round(g / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def _unflatten(tree, leaves):
    it = iter(leaves)
    return tree_map(lambda _: next(it), tree)


def compress_tree(grads, codec: str = "int8"):
    """grads → (payload, residual); the residual is what the codec
    dropped. An int8 payload leaf is a (q, scale) pair."""
    flat = tree_leaves(grads)
    if codec == "bf16":
        payload = [g.to(torch.bfloat16) for g in flat]
        resid = [g - p.to(torch.float32) for g, p in zip(flat, payload)]
    elif codec == "int8":
        payload = [quantize_int8(g) for g in flat]
        resid = [g - dequantize_int8(*p) for g, p in zip(flat, payload)]
    else:
        raise ValueError(f"unknown codec {codec!r}")
    return _unflatten(grads, payload), _unflatten(grads, resid)


def decompress_tree(payload, codec: str = "int8"):
    if codec == "bf16":
        return tree_map(lambda p: p.to(torch.float32), payload)
    if codec == "int8":
        def walk(t):
            if isinstance(t, dict):
                return {k: walk(v) for k, v in t.items()}
            if (isinstance(t, tuple) and len(t) == 2
                    and isinstance(t[0], torch.Tensor)
                    and t[0].dtype == torch.int8):
                return dequantize_int8(*t)
            if isinstance(t, (tuple, list)):
                return type(t)(walk(v) for v in t)
            return t
        return walk(payload)
    raise ValueError(f"unknown codec {codec!r}")


def compressed_psum(grads, group=None, codec: str = "int8", residual=None):
    """Quantize → all-reduce over `group` → dequantize, with error
    feedback. `residual` (the tree of `grads`, or None) is added before
    quantization; returns (summed, new residual)."""
    if residual is not None:
        grads = _unflatten(grads, [g + r for g, r in zip(
            tree_leaves(grads), tree_leaves(residual))])
    if codec == "none":
        def leaf(g):
            s = g.clone()
            dist.all_reduce(s, group=group)
            return s
        return tree_map(leaf, grads), tree_map(torch.zeros_like, grads)
    if codec == "bf16":
        flat = tree_leaves(grads)
        payload = [g.to(torch.bfloat16) for g in flat]
        resid = [g - p.to(torch.float32) for g, p in zip(flat, payload)]
        for p in payload:
            dist.all_reduce(p, group=group)
        return (_unflatten(grads, [p.to(torch.float32) for p in payload]),
                _unflatten(grads, resid))
    if codec == "int8":
        summed, resid = [], []
        for g in tree_leaves(grads):
            # every rank quantizes on the same grid: agree on the largest
            # scale first, then sum the int8 payloads in int32
            scale = torch.clamp_min(g.abs().max(), 1e-12) / 127.0
            dist.all_reduce(scale, op=dist.ReduceOp.MAX, group=group)
            q = torch.clip(torch.round(g / scale), -127, 127).to(torch.int8)
            s = q.to(torch.int32)
            dist.all_reduce(s, group=group)
            summed.append(s.to(torch.float32) * scale)
            resid.append(g - dequantize_int8(q, scale))
        return _unflatten(grads, summed), _unflatten(grads, resid)
    raise ValueError(f"unknown codec {codec!r}")
