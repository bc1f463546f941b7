"""Carry trees of numpy arrays (for example the JAX package's parameter,
cache and train-state trees, converted leaf by leaf with `np.asarray`) into
the port.

The port's parameters keep the JAX tree's key names and stacked
superblock axis, so the conversion is a key-for-key copy. Nothing here
imports JAX: the caller hands over nested dicts / tuples / NamedTuples of
numpy arrays; a NamedTuple maps to the port's class with the same fields.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.device import resolve_device
from .layers import KVCache, PagedKVCache
from .model import matrix_storage, tree_leaves


def _leaf(x, dev, mat_dtype, mat_ndim=2):
    """One numpy leaf on `dev`: a float leaf of at least `mat_ndim`
    dimensions (a matrix) in `mat_dtype`, in `matrix_storage` (rows
    rounded up to 8 elements where ragged); other float leaves (vectors)
    in fp32; integer leaves as they are."""
    t = torch.from_numpy(np.array(x, copy=True))
    if not t.is_floating_point():
        return t.to(dev)
    if t.ndim < mat_ndim:
        return t.to(dev, torch.float32)
    out = matrix_storage(tuple(t.shape), mat_dtype, dev)
    out.copy_(t)
    return out


def params_from_numpy(tree, device=None, dtype=None):
    """The port's parameters from a numpy tree with the JAX key names.
    Matrices are stored in `dtype`: by default bf16 on CUDA and fp32 on
    the CPU (see models/model.py); `torch.float32` keeps fp32 masters for
    training. Vectors stay fp32: the 1-D leaves outside any `layers` and,
    under a `layers` key at any depth (whose axis 0 stacks the
    superblocks, or the encoder-decoder's encoder layers under
    `encoder`), the 2-D stacked vectors (norms and their layernorm
    biases, the QKV biases, the SSM's `dt_bias`, `A_log`, `D_skip` and
    `norm_w`), the rule `init_params` and the forward's superblock cast
    follow."""
    dev = resolve_device(device)
    mat = dtype or (torch.bfloat16 if dev.type == "cuda" else torch.float32)

    def convert(t, nd):
        if isinstance(t, dict):
            return {k: convert(v, 3 if k == "layers" else nd)
                    for k, v in t.items()}
        if isinstance(t, (tuple, list)):
            return tuple(convert(v, nd) for v in t)
        return _leaf(t, dev, mat, nd)

    return convert(tree, 2)


def cache_from_numpy(tree, device=None):
    """A cache tree (tuple of {"kv": KVCache | PagedKVCache, "ssm":
    (state, conv tail), "cross": KVCache}) with every leaf copied as is;
    NamedTuples map by field names, the ssm tuples stay plain tuples."""
    dev = resolve_device(device)
    return _convert(tree, lambda x: torch.from_numpy(
        np.array(x, copy=True)).to(dev))


def state_from_numpy(tree, device=None):
    """A JAX `TrainState(step, params, opt_state=AdamWState(count, mu,
    nu))` as numpy leaves → the port's `TrainState`: fp32 masters (with
    gradients on), fp32 μ and ν, the integer step and count as they are."""
    dev = resolve_device(device)
    state = _convert(tree, lambda x: _leaf(x, dev, torch.float32))
    for p in tree_leaves(state.params):
        p.requires_grad_(True)
    return state


def _named(fields):
    from repro_torch.train.optimizer import AdamWState
    from repro_torch.train.train_state import TrainState

    for cls in (PagedKVCache, KVCache, AdamWState, TrainState):
        if set(cls._fields) == set(fields):
            return cls
    raise ValueError(f"no port class has the fields {fields}")


def _convert(tree, leaf):
    if isinstance(tree, dict):
        return {k: _convert(v, leaf) for k, v in tree.items()}
    fields = getattr(tree, "_fields", None)
    if fields is not None:
        cls = _named(fields)
        return cls(**{f: _convert(getattr(tree, f), leaf)
                      for f in cls._fields})
    if isinstance(tree, (tuple, list)):
        return tuple(_convert(v, leaf) for v in tree)
    return leaf(tree)
