"""Serve-side step factories (the training step comes with the training
slice).

`make_prefill_step` / `make_serve_step` return plain functions: PyTorch
runs eagerly, so there is nothing to trace. Both update the cache in
place and return it.
"""
from __future__ import annotations

from repro_torch.models import model as M
from repro_torch.models.config import ArchConfig


def make_prefill_step(cfg: ArchConfig, prefix_len: int = 0):
    """prefill(params, tokens, cache, [frontend]) → (logits_last, cache).

    With `prefix_len > 0` (continued prefill), `tokens` holds only a
    prompt's uncached suffix and the cache's first `prefix_len` rows hold
    the shared prefix's KV."""

    def prefill(params, tokens, cache, frontend=None):
        if frontend is not None:
            raise ValueError("modality frontends are not ported yet")
        logits, cache, _ = M.forward(params, cfg, tokens, cache=cache,
                                     last_only=True, prefix_len=prefix_len)
        return logits, cache

    return prefill


def make_serve_step(cfg: ArchConfig):
    """One decode step: (params, token (B,1), cache, pos (B,), [frontend])
    → (logits (B,1,V), cache)."""

    def serve_step(params, token, cache, pos, frontend=None):
        if frontend is not None:
            raise ValueError("modality frontends are not ported yet")
        logits, cache, _ = M.forward(params, cfg, token, cache=cache,
                                     pos=pos)
        return logits, cache

    return serve_step
