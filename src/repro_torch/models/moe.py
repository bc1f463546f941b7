"""Mixture-of-Experts FFN: top-k routing, capacity and dropless dispatch
(the JAX package's `repro/models/moe.py`).

Two dispatches share one router:

* **Capacity (training)**: each expert takes its top C tokens (C =
  `capacity(T, E, k)`), gathers them, runs its SwiGLU and scatter-adds the
  gated result back. Compute scales with k·T, but overflow tokens are
  dropped.
* **Dropless (serving)**: every expert runs every token and the k-sparse
  combine weights select and mix, so the result is the exact top-k
  semantics at any T: prefill + decode ≡ the full forward. Selected by
  every served forward (`model._sublayer` under a cache) or for every
  path by `cfg.moe_dropless`.

Every expert product is a 2-D `sa_dot` on the expert's slice of the
stacked weights (`wg[e]` is a contiguous row-major (D, F) view, which the
SA GEMM reads in place): on the card each is an SA GEMM kernel launch, so
a row's bits do not depend on how many rows the dispatch gave the expert
(ROADMAP F2), and no (E, D, F) fp32 copy of the stack is made. The JAX
package's expert-parallel sharding constraints are no-ops on one card and
are left out.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.core.precision import sa_dot
from .layers import ffn_swiglu


def _top_k(x, k: int):
    """The k largest values along the last axis and their indices, ties
    broken toward the lower index, as `jax.lax.top_k` breaks them
    (`torch.topk` leaves the order among equal values unspecified)."""
    v, i = torch.sort(x, dim=-1, descending=True, stable=True)
    return v[..., :k], i[..., :k]


def router(x, w_router, k: int, with_aux: bool = True):
    """x (B, T, D) → combine weights (B, T, E) (zero outside each token's
    top k, renormalized over it) and the aux losses `load_balance` and
    `router_z` (None without `with_aux`: a served forward discards them,
    as XLA drops them from the JAX package's jitted serve steps)."""
    B, T, D = x.shape
    logits = sa_dot(x.reshape(B * T, D), w_router).to(torch.float32)
    logits = logits.reshape(B, T, -1)
    E = logits.shape[-1]
    probs = torch.softmax(logits, dim=-1)
    topv, topi = _top_k(probs, k)
    topv = topv / torch.sum(topv, dim=-1, keepdim=True)
    combine = torch.zeros_like(probs).scatter(-1, topi, topv)
    if not with_aux:
        return combine, None
    density = torch.mean(F.one_hot(topi, E).to(torch.float32),
                         dim=(0, 1, 2))
    mean_probs = torch.mean(probs, dim=(0, 1))
    aux = {"load_balance": E * torch.sum(density * mean_probs),
           "router_z": torch.mean(torch.logsumexp(logits, dim=-1) ** 2)}
    return combine, aux


def capacity(T: int, E: int, k: int, factor: float = 1.25) -> int:
    return max(1, min(T, math.ceil(T * k * factor / E)))


# dropless chunks of T bound the per-expert activations (B·Tc rows) during
# long serving prefills (decode steps are single-chunk); rows are
# independent, so chunking never changes results
DROPLESS_CHUNK_T = 128


def gemm_calls(cfg, tokens: int = 1) -> int:
    """The SA GEMM calls one served forward over `tokens` tokens a row
    makes (a decode step: 1): a layer's 4 attention GEMMs, then a dense
    layer's 3 FFN GEMMs, or a MoE layer's router, each expert's 3 in every
    dropless chunk and the shared expert's 3; and the lm_head. On the card
    each call is one kernel launch."""
    chunks = -(-tokens // DROPLESS_CHUNK_T)
    n = 1
    for i in range(cfg.num_layers):
        n += 4
        if cfg.layer_kind(i)["moe"]:
            n += 1 + 3 * cfg.num_experts * chunks + 3 * cfg.shared_expert
        else:
            n += 3
    return n


def _expert(x, p, e: int, act: str):
    """Expert e's SwiGLU on x (B, T, D): three 2-D `sa_dot` calls on its
    slices of the stacks, fp32 out."""
    return ffn_swiglu(x, {"wg": p["wg"][e], "wu": p["wu"][e],
                          "wd": p["wd"][e]}, act)


def _shared(x, p, out, act: str):
    if "shared_wg" in p:
        out = out + ffn_swiglu(x, {"wg": p["shared_wg"],
                                   "wu": p["shared_wu"],
                                   "wd": p["shared_wd"]}, act)
    return out.to(x.dtype)


def moe_ffn_dropless(x, p, cfg, act: str = "silu", with_aux: bool = True):
    """Dropless dispatch (serving): every expert's SwiGLU on every token,
    mixed by the k-sparse combine weights, Σ_e c_e·E_e(x_t) summed in fp32
    in expert order. T runs in chunks of `DROPLESS_CHUNK_T` rows a batch
    row (the last one zero-padded; its padded rows are dropped)."""
    B, T, D = x.shape
    E, k = cfg.num_experts, cfg.experts_per_token
    combine, aux = router(x, p["router"], k, with_aux)      # (B, T, E)
    Tc = min(T, DROPLESS_CHUNK_T)
    pad = (-T) % Tc
    xp, cp = ((F.pad(x, (0, 0, 0, pad)), F.pad(combine, (0, 0, 0, pad)))
              if pad else (x, combine))
    outs = []
    for s in range(0, T + pad, Tc):
        xc, cc = xp[:, s:s + Tc], cp[:, s:s + Tc]
        acc = torch.zeros((B, Tc, D), dtype=torch.float32, device=x.device)
        for e in range(E):
            acc.addcmul_(_expert(xc, p, e, act), cc[..., e:e + 1])
        outs.append(acc)
    out = outs[0] if len(outs) == 1 else torch.cat(outs, dim=1)[:, :T]
    return _shared(x, p, out, act), aux


def moe_ffn(x, p, cfg, act: str = "silu", capacity_factor: float = 1.25,
            dropless: bool = False, with_aux: bool = True):
    """x (B, T, D); p: router (D, E), wg/wu (E, D, F), wd (E, F, D), and
    the optional shared expert (shared_wg/wu/wd) → (out (B, T, D) in x's
    dtype, aux). `dropless=True` selects the exact serving dispatch
    (`moe_ffn_dropless`); otherwise each expert takes its top C tokens by
    combine weight (ties toward the lower token index, as in the JAX
    package; a tie among zero-gate tokens changes nothing) and its gated
    output is scatter-added back expert by expert: within one expert the
    token indices are distinct, so `index_add_` adds each row once and
    every run gives the same bits (one scatter over all experts would
    repeat indices, which CUDA adds by atomics in no fixed order)."""
    if dropless:
        return moe_ffn_dropless(x, p, cfg, act, with_aux)
    B, T, D = x.shape
    E, k = cfg.num_experts, cfg.experts_per_token
    C = capacity(T, E, k, capacity_factor)
    combine, aux = router(x, p["router"], k, with_aux)      # (B, T, E)
    gate, token_idx = _top_k(combine.transpose(1, 2), C)    # (B, E, C)
    bidx = torch.arange(B, device=x.device)[:, None]
    rows = (bidx * T + token_idx.transpose(0, 1)).reshape(E, B * C)
    out = torch.zeros((B * T, D), dtype=torch.float32, device=x.device)
    for e in range(E):
        xe = x[bidx, token_idx[:, e]]                       # (B, C, D)
        y = _expert(xe, p, e, act) * gate[:, e, :, None]
        out.index_add_(0, rows[e], y.reshape(B * C, D))
    return _shared(x, p, out.reshape(B, T, D), act), aux
