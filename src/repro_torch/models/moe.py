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
(ROADMAP F2), and no (E, D, F) fp32 copy of the stack is made.

On a mesh the layout is the one `parallel.sharding.param_specs` gives
the expert stacks, as the JAX package decides it:

* **EP** (the `model` axis divides E): a rank holds experts r·E/tp …
  (r+1)·E/tp − 1 whole. The replicated router computes the whole combine
  on every rank from the same x; the rank runs its own experts, reading
  the combine at each expert's global index, sums them in expert order
  into an fp32 partial, and the partials are all-reduced across `model`
  (the JAX package's reduced sum over E). x and the combine enter the
  experts through `copy_to_model`, so their gradients sum the ranks'
  experts.
* **TP inside each expert** (E does not divide, d_ff does): each
  expert's wg, wu are column shards and wd a row shard (`_tp_ffn`); each
  expert's unrounded fp32 chain is all-reduced before its own rounding,
  since the approx tier truncates an expert's output before the combine.
* **Replicated** (the divisibility guard leaves E and d_ff whole):
  every rank computes the whole layer, with no collective.

The shared expert runs the dense FFN's tensor-parallel path. Under a
`data` axis (training) `load_balance` is taken over the global batch: the
token counts and router probabilities are summed over `data` before
their product (`router`).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.core.precision import sa_dot
from .layers import ffn_swiglu, tp_context


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
    from repro_torch.parallel import sharding as S

    dp = S.batch_count()
    if dp == 1:
        density = torch.mean(F.one_hot(topi, E).to(torch.float32),
                             dim=(0, 1, 2))
        mean_probs = torch.mean(probs, dim=(0, 1))
    else:
        # the global batch's means: each rank's token counts and summed
        # probabilities, summed over `data`, over every rank's tokens (a
        # batch the axis does not divide is replicated: dp copies of it,
        # the same means). The sum's backward sums the ranks' cotangents
        # (dp times this rank's, every rank holding the same global term),
        # so the step's SUM ÷ dp of the ranks' gradients gives the
        # one-process gradient over the global batch.
        from repro_torch.parallel import collectives as C

        n = B * T * dp
        stats = C.sum_over_data(torch.cat([
            F.one_hot(topi, E).to(torch.float32).sum(dim=(0, 1, 2)),
            probs.sum(dim=(0, 1))]), S.batch_group())
        density, mean_probs = stats[:E] / (n * k), stats[E:] / n
    # router_z stays this rank's mean: the step's average over `data`
    # makes it the global batch's
    aux = {"load_balance": E * torch.sum(density * mean_probs),
           "router_z": torch.mean(torch.logsumexp(logits, dim=-1) ** 2)}
    return combine, aux


def capacity(T: int, E: int, k: int, factor: float = 1.25) -> int:
    return max(1, min(T, math.ceil(T * k * factor / E)))


# dropless chunks of T bound the per-expert activations (B·Tc rows) during
# long serving prefills (decode steps are single-chunk); rows are
# independent, so chunking never changes results
DROPLESS_CHUNK_T = 128


def gemm_calls(cfg, tokens: int = 1, tp: int = 1) -> int:
    """The SA GEMM calls one served forward over `tokens` tokens a row
    makes (a decode step: 1) on one rank of a `model` axis of `tp` ranks:
    a layer's 4 attention GEMMs, then a dense layer's 3 FFN GEMMs, or a
    MoE layer's router, each of the rank's experts' 3 in every dropless
    chunk (E/tp under EP, where the axis divides E; all E otherwise) and
    the shared expert's 3; and the lm_head. On the card each call is one
    kernel launch (granite at full depth, one process: 4001 a decode
    step)."""
    from repro_torch.parallel.sharding import expert_layout

    chunks = -(-tokens // DROPLESS_CHUNK_T)
    E = cfg.num_experts
    mine = E // tp if expert_layout(cfg, tp) == "ep" else E
    n = 1
    for i in range(cfg.num_layers):
        n += 4
        if cfg.layer_kind(i)["moe"]:
            n += 1 + 3 * mine * chunks + 3 * cfg.shared_expert
        else:
            n += 3
    return n


def _layout(p, cfg):
    """How this rank holds the expert stacks `p` (one superblock's, (E or
    E/tp, D, F)), by `sharding.expert_layout`: ("ep", group, its first
    expert, its count), ("tp", group, 0, E) for column/row shards of every
    expert, or ("whole", None, 0, E) in one process and where the
    divisibility guard left the stacks whole."""
    from repro_torch.parallel.sharding import expert_layout

    tp, group, rank = tp_context()
    E = cfg.num_experts
    mode = expert_layout(cfg, tp)
    if mode == "ep":
        n = E // tp
        if p["wg"].shape[0] != n:
            raise ValueError(f"{p['wg'].shape[0]} experts on a rank of a "
                             f"model axis of {tp}: expected {n}")
        return "ep", group, rank * n, n
    if mode == "tp":
        return "tp", group, 0, E
    return "whole", None, 0, E


def _expert(x, p, i: int, act: str, mode: str, cfg):
    """The rank's i-th expert's SwiGLU on x (B, T, D): three 2-D `sa_dot`
    calls on its slices of the stacks, fp32 out; on column and row shards
    (`mode` "tp") the dense FFN's tensor-parallel path, whole."""
    return ffn_swiglu(x, {"wg": p["wg"][i], "wu": p["wu"][i],
                          "wd": p["wd"][i]}, act,
                      cfg.d_ff if mode == "tp" else None)


def _shared(x, p, out, act: str, cfg):
    if "shared_wg" in p:
        out = out + ffn_swiglu(x, {"wg": p["shared_wg"],
                                   "wu": p["shared_wu"],
                                   "wd": p["shared_wd"]}, act, cfg.d_ff)
    return out.to(x.dtype)


def _ep_inputs(x, combine, mode, group):
    """Under EP the experts read x and the combine through
    `copy_to_model`: each rank's experts give a part of their gradients,
    which the backward sums over the axis (the router's own part of x's
    gradient, the same on every rank, is not summed again)."""
    if mode != "ep":
        return x, combine
    from repro_torch.parallel import collectives as C

    return C.copy_to_model(x, group), C.copy_to_model(combine, group)


def _ep_reduce(out, mode, group):
    """The ranks' fp32 partials (each its experts' sum) summed across
    `model` under EP."""
    if mode != "ep":
        return out
    from repro_torch.parallel import collectives as C

    return C.reduce_from_model(out, group)


def moe_ffn_dropless(x, p, cfg, act: str = "silu", with_aux: bool = True):
    """Dropless dispatch (serving): every expert's SwiGLU on every token,
    mixed by the k-sparse combine weights, Σ_e c_e·E_e(x_t) summed in fp32
    in expert order (under EP, the rank's experts' sum, then the ranks'
    sums). T runs in chunks of `DROPLESS_CHUNK_T` rows a batch row (the
    last one zero-padded; its padded rows are dropped)."""
    B, T, D = x.shape
    k = cfg.experts_per_token
    combine, aux = router(x, p["router"], k, with_aux)      # (B, T, E)
    mode, group, e0, n = _layout(p, cfg)
    xe, ce = _ep_inputs(x, combine, mode, group)
    Tc = min(T, DROPLESS_CHUNK_T)
    pad = (-T) % Tc
    xp, cp = ((F.pad(xe, (0, 0, 0, pad)), F.pad(ce, (0, 0, 0, pad)))
              if pad else (xe, ce))
    outs = []
    for s in range(0, T + pad, Tc):
        xc, cc = xp[:, s:s + Tc], cp[:, s:s + Tc]
        acc = torch.zeros((B, Tc, D), dtype=torch.float32, device=x.device)
        for i in range(n):
            acc.addcmul_(_expert(xc, p, i, act, mode, cfg),
                         cc[..., e0 + i:e0 + i + 1])
        outs.append(acc)
    out = outs[0] if len(outs) == 1 else torch.cat(outs, dim=1)[:, :T]
    return _shared(x, p, _ep_reduce(out, mode, group), act, cfg), aux


def moe_ffn(x, p, cfg, act: str = "silu", capacity_factor: float = 1.25,
            dropless: bool = False, with_aux: bool = True):
    """x (B, T, D); p: router (D, E), wg/wu (E, D, F), wd (E, F, D), and
    the optional shared expert (shared_wg/wu/wd) → (out (B, T, D) in x's
    dtype, aux). `dropless=True` selects the exact serving dispatch
    (`moe_ffn_dropless`); otherwise each expert takes its top C tokens by
    combine weight (ties toward the lower token index, as in the JAX
    package; a tie among zero-gate tokens changes nothing; the top C of
    each batch row, so splitting rows over `data` moves no token) and its
    gated output is scatter-added back expert by expert: within one
    expert the token indices are distinct, so `index_add_` adds each row
    once and every run gives the same bits (one scatter over all experts
    would repeat indices, which CUDA adds by atomics in no fixed
    order)."""
    if dropless:
        return moe_ffn_dropless(x, p, cfg, act, with_aux)
    B, T, D = x.shape
    E, k = cfg.num_experts, cfg.experts_per_token
    C = capacity(T, E, k, capacity_factor)
    combine, aux = router(x, p["router"], k, with_aux)      # (B, T, E)
    mode, group, e0, n = _layout(p, cfg)
    xin, ce = _ep_inputs(x, combine, mode, group)
    # each of the rank's experts' top C tokens of each batch row
    gate, token_idx = _top_k(ce[..., e0:e0 + n].transpose(1, 2), C)
    bidx = torch.arange(B, device=x.device)[:, None]
    rows = (bidx * T + token_idx.transpose(0, 1)).reshape(n, B * C)
    out = torch.zeros((B * T, D), dtype=torch.float32, device=x.device)
    for i in range(n):
        xe = xin[bidx, token_idx[:, i]]                     # (B, C, D)
        y = _expert(xe, p, i, act, mode, cfg) * gate[:, i, :, None]
        out.index_add_(0, rows[i], y.reshape(B * C, D))
    out = _ep_reduce(out, mode, group)
    return _shared(x, p, out.reshape(B, T, D), act, cfg), aux
