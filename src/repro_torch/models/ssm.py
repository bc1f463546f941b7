"""Mamba2 SSD (state-space duality) layer: chunked scan and O(1) decode.

The JAX package's `repro/models/ssm.py` (Dao & Gu 2024, arXiv:2405.21060):
within a chunk the recurrence runs in its quadratic "attention" form,
states pass between chunks (JAX's `lax.scan`, a Python loop over chunks
here), and a decode token updates the (H, P, N) state in O(1).

Layer: in_proj → [z | x | B | C | dt], causal depthwise conv on (x, B, C),
SSD core, gated RMSNorm, out_proj. The two projections are SA GEMMs
(`sa_dot`, the hand-written kernel on the card); the SSD's contractions
are `sa_einsum`s, which the JAX package computes outside any Pallas
kernel too. The operand types are the JAX package's: `sa_dot` returns
fp32, so x, B and C reach the einsums in fp32 and `sa_einsum` rounds them
to the input format on the way in; the state stays fp32 and is rounded
only inside `sa_einsum`.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core.precision import sa_dot, sa_einsum
from .layers import rmsnorm, row_linear, tp_context


def _segsum(a):
    """'Segment sum' → lower-triangular L[t, s] = Σ_{s<j<=t} a_j, -inf
    above the diagonal (the cumsum-difference form of the JAX package)."""
    T = a.shape[-1]
    cum = torch.cumsum(a, dim=-1)
    L = cum[..., :, None] - cum[..., None, :]
    mask = torch.tril(torch.ones((T, T), dtype=torch.bool, device=a.device))
    return torch.where(mask, L, float("-inf"))


def _softplus(x):
    # jax.nn.softplus: logaddexp(x, 0)
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def ssd_chunked(x, dt, A, B_, C_, chunk: int, initial_state=None):
    """SSD core.

    x:  (B, T, H, P)   inputs per head
    dt: (B, T, H)      positive step sizes (post-softplus)
    A:  (H,)           negative decay rates
    B_: (B, T, N)      input projection (one group, broadcast over heads)
    C_: (B, T, N)      output projection
    returns y (B, T, H, P), final_state (B, H, P, N) fp32
    """
    Bsz, T, H, P = x.shape
    N = B_.shape[-1]
    Q = min(chunk, T)
    pad = (-T) % Q
    if pad:   # zero-pad the tail: dt = 0 ⇒ decay 1, no input ⇒ state kept
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        B_ = F.pad(B_, (0, 0, 0, pad))
        C_ = F.pad(C_, (0, 0, 0, pad))
    T_orig = T
    T = T + pad
    nc = T // Q

    xb = x.reshape(Bsz, nc, Q, H, P)
    dtb = dt.reshape(Bsz, nc, Q, H)
    Bb = B_.reshape(Bsz, nc, Q, N)
    Cb = C_.reshape(Bsz, nc, Q, N)

    dA = dtb * A                                        # (B, nc, Q, H)
    dA_cum = torch.cumsum(dA, dim=2)                    # within-chunk cumsum
    dA_total = dA_cum[:, :, -1]                         # (B, nc, H)

    # intra-chunk (quadratic / attention form)
    Lmat = torch.exp(_segsum(dA.permute(0, 1, 3, 2)))   # (B, nc, H, Q, Q)
    scores = sa_einsum("bcqn,bckn->bcqk", Cb, Bb)       # (B, nc, Q, Q)
    M = scores[:, :, None] * Lmat                       # (B, nc, H, Q, Q)
    del Lmat
    xdt = xb * dtb[..., None]                           # (B, nc, Q, H, P)
    y_intra = sa_einsum("bchqk,bckhp->bcqhp", M.to(x.dtype),
                        xdt.to(x.dtype))
    del M

    # chunk states: S_c = Σ_s exp(dA_total − dA_cum[s]) · B_s ⊗ (x_s·dt_s)
    decay_to_end = torch.exp(dA_total[:, :, None] - dA_cum)   # (B, nc, Q, H)
    Sx = xdt * decay_to_end[..., None]
    S_chunk = sa_einsum("bcqn,bcqhp->bchpn", Bb.to(x.dtype),
                        Sx.to(x.dtype)).to(torch.float32)     # (B,nc,H,P,N)
    del Sx, xdt

    # inter-chunk scan: carry the running state across chunks
    S = (initial_state if initial_state is not None
         else torch.zeros((Bsz, H, P, N), dtype=torch.float32,
                          device=x.device)).to(torch.float32)
    y_inter = []
    for c in range(nc):
        # the carried state's contribution to this chunk's outputs
        decay_in = torch.exp(dA_cum[:, c])               # (B, Q, H)
        y_c = sa_einsum("bqn,bhpn->bqhp", Cb[:, c].to(x.dtype),
                        S.to(x.dtype))
        y_inter.append(y_c * decay_in[..., None])
        S = S * torch.exp(dA_total[:, c])[:, :, None, None] + S_chunk[:, c]
    y = y_intra + torch.stack(y_inter, dim=1).to(y_intra.dtype)
    return y.reshape(Bsz, T, H, P)[:, :T_orig], S


def ssd_decode_step(state, x_t, dt_t, A, B_t, C_t):
    """O(1) recurrent update. state: (B, H, P, N); x_t: (B, H, P);
    dt_t: (B, H); B_t, C_t: (B, N). Returns (state, y (B, H, P))."""
    dA = torch.exp(dt_t * A)                                  # (B, H)
    dBx = (dt_t[..., None] * x_t)[..., None] * B_t[:, None, None, :]
    state = state * dA[..., None, None] + dBx
    y = sa_einsum("bn,bhpn->bhp", C_t.to(x_t.dtype), state.to(x_t.dtype))
    return state, y


def _causal_conv(x, w, cache=None):
    """Depthwise causal conv1d. x: (B, T, D); w: (KW, D); cache: the
    previous KW-1 inputs (B, KW-1, D) or None (zeros). Returns (silu(y),
    tail): the tail is the last KW-1 inputs (the decode cache)."""
    KW = w.shape[0]
    if cache is not None:
        dt = torch.promote_types(cache.dtype, x.dtype)
        xp = torch.cat([cache.to(dt), x.to(dt)], dim=1)
    else:
        xp = F.pad(x, (0, 0, KW - 1, 0))
    y = sum(xp[:, i:i + x.shape[1]] * w[i] for i in range(KW))
    tail = xp[:, -(KW - 1):] if KW > 1 else None
    return F.silu(y), tail


def _tp_mixer_params(x, p, cfg):
    """The mixer's inputs under a `model` axis of more than one rank, the
    gather layout: the parameters are stored as the JAX package's specs
    cut them (`param_specs`: in_proj's columns, conv_w's channels, A_log,
    dt_bias, D_skip and norm_w over `model`, each whole where the axis
    does not divide it), but the conv, the SSD and the gated norm run
    whole on every rank. in_proj runs column-parallel on the rank's piece
    (whole where the guard left it whole) and its output is gathered: a
    column piece carries the whole call's bits, so the gathered
    [z | x | B | C | dt] is the one-process tensor; the cut small vectors
    are gathered too. Returns (in_proj's output (B·T, n), the parameter
    dict with every small vector whole).

    The backward is right because everything between the gathers and
    out_proj's `row_linear` is replicated: every rank computes the same
    whole cotangent of the gathered tensors, so `gather_from_model`'s
    backward (this rank's slice) is the gradient of the rank's piece, and
    `row_linear`'s `split_to_model` gathers the ranks' equal slices back.
    A layout whose compute between them were partitioned would need these
    cotangents summed over `model` instead (ROADMAP, the P-sliced SSD)."""
    from repro_torch.parallel import collectives as C

    _, group, _ = tp_context()
    B, T, D = x.shape
    H, N, din = cfg.n_ssm_heads, cfg.ssm_state, cfg.d_inner
    xf = x.reshape(B * T, D)
    w = p["in_proj"]
    if w.shape[1] != 2 * din + 2 * N + H:         # the rank's columns
        y = C.gather_from_model(sa_dot(C.copy_to_model(xf, group), w), -1,
                                group)
    else:
        y = sa_dot(xf, w)
    full = {"conv_w": din + 2 * N, "A_log": H, "dt_bias": H,
            "D_skip": din, "norm_w": din}
    q = dict(p)
    for k, n in full.items():
        if p[k].shape[-1] != n:
            q[k] = C.gather_from_model(p[k], -1, group)
    return y, q


def mamba2_block(x, p, cfg, state=None, conv_cache=None):
    """The Mamba2 mixer. x: (B, T, D). With a `state` and T == 1 it runs
    the recurrent decode step, else the chunked SSD from `state` (zeros
    where None). Returns (y (B, T, D) fp32, (state, conv_tail)); the
    caller writes them into its cache. Under a `model` axis of more than
    one rank (`_tp_mixer_params`) the state and conv tail are whole on
    every rank, and out_proj runs row-parallel (`layers.row_linear`: the
    rank's K rows, the fp32 chains all-reduced, then one rounding)."""
    B, T, D = x.shape
    H, N = cfg.n_ssm_heads, cfg.ssm_state
    din = cfg.d_inner
    tp = tp_context()[0] > 1
    if tp:
        zxbcdt, p = _tp_mixer_params(x, p, cfg)
    else:
        zxbcdt = sa_dot(x.reshape(B * T, D), p["in_proj"])
    zxbcdt = zxbcdt.reshape(B, T, -1)
    z, xin, B_, C_, dt = torch.split(
        zxbcdt, [din, din, N, N, zxbcdt.shape[-1] - 2 * din - 2 * N], dim=-1)
    dt = _softplus(dt.to(torch.float32) + p["dt_bias"])     # (B, T, H)
    A = -torch.exp(p["A_log"].to(torch.float32))             # (H,)

    conv_in = torch.cat([xin, B_, C_], dim=-1)
    conv_out, conv_tail = _causal_conv(conv_in, p["conv_w"], conv_cache)
    xin, B_, C_ = torch.split(conv_out, [din, N, N], dim=-1)
    xh = xin.reshape(B, T, H, cfg.ssm_head_dim)

    if state is not None and T == 1:
        new_state, y = ssd_decode_step(state, xh[:, 0], dt[:, 0], A,
                                       B_[:, 0], C_[:, 0])
        y = y[:, None]                                       # (B, 1, H, P)
    else:
        y, new_state = ssd_chunked(xh, dt, A, B_, C_, cfg.ssm_chunk,
                                   initial_state=state)
    y = y.reshape(B, T, din) + xin * p["D_skip"]
    y = rmsnorm(y * F.silu(z.to(torch.float32)).to(y.dtype), p["norm_w"],
                cfg.norm_eps)
    if tp:
        out = row_linear(y.reshape(B * T, din), False, p["out_proj"], din)
    else:
        out = sa_dot(y.reshape(B * T, din), p["out_proj"])
    out = out.reshape(B, T, D)
    return out, (new_state, conv_tail)
