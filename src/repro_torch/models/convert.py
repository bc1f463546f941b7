"""Carry trees of numpy arrays (for example the JAX package's parameter
and cache trees, converted leaf by leaf with `np.asarray`) into the port.

The port's parameters keep the JAX tree's key names and stacked
superblock axis, so the conversion is a key-for-key copy. Nothing here
imports JAX: the caller hands over nested dicts / tuples of numpy arrays.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.device import resolve_device
from .layers import KVCache, PagedKVCache


def _leaf(x, dev, mat_dtype):
    t = torch.from_numpy(np.array(x, copy=True)).to(dev)
    if t.is_floating_point():
        t = t.to(mat_dtype if t.ndim >= 2 else torch.float32)
    return t


def params_from_numpy(tree, device=None):
    """The port's parameters from a numpy tree with the JAX key names.
    Matrices are stored in bf16 on CUDA and fp32 on the CPU (see
    models/model.py); 1-D leaves stay fp32."""
    dev = resolve_device(device)
    mat = torch.bfloat16 if dev.type == "cuda" else torch.float32
    return _convert(tree, lambda x: _leaf(x, dev, mat))


def cache_from_numpy(tree, device=None):
    """A cache tree (tuple of {"kv": KVCache | PagedKVCache}) with every
    leaf copied as is; NamedTuples map by field names."""
    dev = resolve_device(device)
    return _convert(tree, lambda x: torch.from_numpy(
        np.array(x, copy=True)).to(dev))


def _convert(tree, leaf):
    if isinstance(tree, dict):
        return {k: _convert(v, leaf) for k, v in tree.items()}
    fields = getattr(tree, "_fields", None)
    if fields is not None:
        cls = PagedKVCache if "block_table" in fields else KVCache
        return cls(**{f: _convert(getattr(tree, f), leaf)
                      for f in cls._fields})
    if isinstance(tree, (tuple, list)):
        return tuple(_convert(v, leaf) for v in tree)
    return leaf(tree)
