"""Model layers, main-path subset. Every GEMM routes through the SA
precision policy (`repro_torch.core.precision.sa_dot` / `sa_einsum`).

Caches are tensors updated in place: where the JAX package returns a new
cache from `.at[].set` (and donates the old buffer), the port writes into
the given tensors and returns the same cache object. Each such write says
so in a comment.

Under a mesh whose `model` axis has more than one rank
(`parallel.sharding.set_active_mesh`), attention (training and serving,
over a cache of the rank's KV heads; cross-attention over the rank's
heads of the encoder's K and V) and the FFNs run tensor-parallel on the
rank's parameter shards (`parallel.sharding.param_specs`): wq, wk, wv,
wg, wu, w1 column-parallel, wo, wd, w2 row-parallel, with the explicit
collectives of `parallel/collectives.py` (`_tp_attention`, `_tp_ffn`,
`_tp_column_row`, `row_linear`).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core import optflags, tally
from repro_torch.core.precision import sa_dot, sa_einsum

# ---------------------------------------------------------------------------
# Norms / activations
# ---------------------------------------------------------------------------


def rmsnorm(x, w, eps=1e-6):
    x32 = x.to(torch.float32)
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps) * w.to(torch.float32)).to(x.dtype)


def layernorm(x, w, b, eps=1e-5):
    # the population variance, as jnp.var
    x32 = x.to(torch.float32)
    mu = torch.mean(x32, dim=-1, keepdim=True)
    var = torch.var(x32, dim=-1, keepdim=True, unbiased=False)
    y = ((x32 - mu) * torch.rsqrt(var + eps) * w.to(torch.float32)
         + b.to(torch.float32))
    return y.to(x.dtype)


def norm_apply(x, p, kind="rmsnorm", eps=1e-6):
    if kind == "layernorm":
        return layernorm(x, p["w"], p["b"], eps)
    return rmsnorm(x, p["w"], eps)


def act_fn(x, kind="silu"):
    # one activation table for fused and unfused paths
    from repro_torch.kernels.sa_matmul import EPILOGUES, apply_act
    if kind not in EPILOGUES or kind == "none":
        raise ValueError(f"unknown activation {kind!r}")
    return apply_act(x, kind)


def _fuse_epilogue() -> bool:
    return optflags.enabled("fused_epilogue")


def softcap(x, cap: float):
    return cap * torch.tanh(x / cap) if cap else x


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope_freqs(hd: int, theta: float, device=None):
    exps = -torch.arange(0, hd, 2, dtype=torch.float32, device=device) / hd
    return torch.pow(torch.tensor(theta, dtype=torch.float32, device=device),
                     exps)


def apply_rope(x, positions, theta: float):
    """x: (..., T, hd); positions: broadcastable to (..., T)."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)                 # (hd/2,)
    ang = positions[..., None].to(torch.float32) * freqs
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------

class _Flash(torch.autograd.Function):
    """Flash attention with the JAX package's custom VJP (`_flash`): the
    forward keeps only (out, lse); the backward recomputes the
    probabilities tile by tile, O(block²) memory. Plain torch, as the JAX
    package computes it outside any Pallas kernel. The cost counters
    (`core/tally.py`) take its work as the function's: 4·hd flops a
    visible (query, key) pair a query head forward, 8·hd backward (dP, dV,
    dQ, dK), whatever the tiles compute around the masks."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, cap, q_offset, bq, bkv, scale,
                policy):
        from repro_torch.kernels.sa_attention import flash_forward
        _count_attention(q, k, causal, window, q_offset, 4)
        with tally.in_function():
            out, lse = flash_forward(q, k, v, causal=causal, window=window,
                                     cap=cap, q_offset=q_offset, bq=bq,
                                     bkv=bkv, scale=scale, policy=policy)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (causal, window, cap, q_offset, bq, bkv, scale, policy)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        causal, window, _, q_offset = ctx.args[:4]
        _count_attention(q, k, causal, window, q_offset, 8)
        with tally.in_function():
            dq, dk, dv = _flash_bwd(q, k, v, out, lse, dout, *ctx.args)
        return (dq, dk, dv) + (None,) * 8


def _count_attention(q, k, causal, window, q_offset, per_pair: int):
    """`per_pair`·hd flops for each visible pair of each query head, for
    the active cost counters (none: nothing is computed)."""
    if tally.ACTIVE:
        from repro_torch.kernels.sa_attention import visible_pairs

        B, T, KVH, g, hd = q.shape
        tally.attention(per_pair * hd * B * KVH * g * visible_pairs(
            T, k.shape[1], causal, window, q_offset))


def _flash_bwd(q, k, v, out, lse, dout, causal, window, cap, q_offset, bq,
               bkv, scale, policy):
    """The JAX package's `_flash_bwd`: a dq pass over q blocks (kv inner)
    and a dk/dv pass over kv blocks (q inner) on the same (bq, bkv) tiles,
    with the same `sa_einsum` casts."""
    from repro_torch.kernels.sa_attention import scores

    B, T, KVH, g, hd = q.shape
    S = k.shape[1]
    nq, nkv = T // bq, S // bkv
    dev = q.device
    # delta = rowsum(dout ⊙ out)
    delta = torch.sum(dout.float() * out.float(), -1)        # (B,KVH,g,T)

    def p_and_ds(iq, jk):
        q_i = q[:, iq * bq:(iq + 1) * bq]
        k_j = k[:, jk * bkv:(jk + 1) * bkv]
        v_j = v[:, jk * bkv:(jk + 1) * bkv]
        do_i = dout[:, :, :, iq * bq:(iq + 1) * bq]
        q_pos = q_offset + iq * bq + torch.arange(bq, device=dev)
        kv_pos = jk * bkv + torch.arange(bkv, device=dev)
        s_raw, s = scores(q_i, k_j, q_pos, kv_pos, causal, window, cap,
                          scale, policy)
        p = torch.exp(s - lse[..., iq * bq:(iq + 1) * bq, None])
        dp = sa_einsum("bhgqd,bkhd->bhgqk", do_i, v_j, policy).float()
        ds = p * (dp - delta[..., iq * bq:(iq + 1) * bq, None])
        if cap:   # softcap jacobian: d tanh = 1 - tanh²
            ds = ds * (1.0 - (softcap(s_raw * scale, cap) / cap) ** 2)
        return q_i, k_j, do_i, p, ds * scale

    dq_blocks = []
    for iq in range(nq):
        dq_acc = torch.zeros((B, bq, KVH, g, hd), dtype=torch.float32,
                             device=dev)
        for jk in range(nkv):
            _, k_j, _, _, ds = p_and_ds(iq, jk)
            dq_acc += sa_einsum("bhgqk,bkhd->bqhgd", ds.to(q.dtype), k_j,
                                policy).float()
        dq_blocks.append(dq_acc)
    dk_blocks, dv_blocks = [], []
    for jk in range(nkv):
        dk_acc = torch.zeros((B, bkv, KVH, hd), dtype=torch.float32,
                             device=dev)
        dv_acc = torch.zeros_like(dk_acc)
        for iq in range(nq):
            q_i, _, do_i, p, ds = p_and_ds(iq, jk)
            dv_acc += sa_einsum("bhgqk,bhgqd->bkhd", p.to(q.dtype), do_i,
                                policy).float()
            dk_acc += sa_einsum("bhgqk,bqhgd->bkhd", ds.to(q.dtype), q_i,
                                policy).float()
        dk_blocks.append(dk_acc)
        dv_blocks.append(dv_acc)
    dq = torch.cat(dq_blocks, dim=1)
    dk, dv = torch.cat(dk_blocks, dim=1), torch.cat(dv_blocks, dim=1)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def blockwise_attention(q, k, v, *, causal=True, window=0, cap=0.0,
                        q_offset=0, block_q=1024, block_kv=1024, scale=None):
    """q: (B, T, H, hd); k, v: (B, S, KVH, hd) → (B, T, H, hd).

    Flash-style attention under the SA contract with the JAX package's
    custom VJP (`_Flash`): the forward keeps only (out, lse), the backward
    recomputes probabilities tile by tile. The forward is the plain
    version of the prefill kernel (kernels/sa_attention.py). The policy in
    force at the forward also runs the backward."""
    from repro_torch.core.precision import current_policy
    from repro_torch.kernels.sa_attention import _div_block

    B, T, H, hd = q.shape
    S, KVH = k.shape[1], k.shape[2]
    g = H // KVH
    out = _Flash.apply(q.reshape(B, T, KVH, g, hd), k, v, causal, window,
                       cap, q_offset, _div_block(T, block_q),
                       _div_block(S, block_kv), scale or hd ** -0.5,
                       current_policy())
    # (B, KVH, g, T, hd) → (B, T, H, hd)
    return out.permute(0, 3, 1, 2, 4).reshape(B, T, H, hd)


def decode_attention(q, k_cache, v_cache, kv_positions, pos, *, window=0,
                     cap=0.0, scale=None, return_lse: bool = False):
    """Single-token attention against a per-slot cache.

    q: (B, 1, H, hd); caches: (B, S, KVH, hd); kv_positions: (B, S) token
    position per cache row (-1 = empty); pos: (B,) per-slot position.
    `return_lse`: also each query row's log-sum-exp of its scaled scores,
    (B, H) fp32 (-inf, and an output of zeros, where every row is
    masked), so partial attentions over disjoint rows fold into the
    whole one (`fold_partials`)."""
    B, _, H, hd = q.shape
    S, KVH = k_cache.shape[1], k_cache.shape[2]
    g = H // KVH
    scale = scale or hd ** -0.5
    qg = q.reshape(B, KVH, g, hd)
    s = sa_einsum("bhgd,bkhd->bhgk", qg, k_cache).to(torch.float32)
    # softcap with the constants folded on the host (one multiply, then
    # tanh) — the expression the paged kernel computes
    s = cap * torch.tanh(s * (scale / cap)) if cap else s * scale
    pos = pos.reshape(B)
    ok = (kv_positions >= 0) & (kv_positions <= pos[:, None])
    if window:
        ok &= kv_positions > pos[:, None] - window
    s = torch.where(ok[:, None, None, :], s, float("-inf"))
    # safe-row softmax: a slot with no valid entry is a row of -inf; the
    # guarded max keeps exp() at 0 and the floored normalizer gives zeros
    m = s.amax(dim=-1)
    m_safe = torch.where(torch.isfinite(m), m, 0.0)
    p = torch.exp(s - m_safe[..., None])
    den = p.sum(dim=-1, keepdim=True)
    p = p / torch.clamp_min(den, 1e-30)
    out = sa_einsum("bhgk,bkhd->bhgd", p.to(q.dtype), v_cache)
    if not return_lse:
        return out.reshape(B, 1, H, hd)
    lse = torch.where(torch.isfinite(m), m + torch.log(den[..., 0]),
                      float("-inf"))
    return out.reshape(B, 1, H, hd), lse.reshape(B, H)


def fold_partials(o, lse):
    """Attention over disjoint sets of key rows folded into the attention
    over all of them: o (R, N, 1, H, hd) and lse (R, N, H) fp32 of R
    parts → o (N, 1, H, hd) = Σ_r exp(lse_r − lse)·o_r in part order,
    lse the log-sum-exp of the lse_r. A part whose rows are all masked
    (lse_r = -inf) weighs 0; where every part is, the output is zeros, as
    one `decode_attention` over the masked rows gives."""
    m = lse.amax(0)
    m_safe = torch.where(torch.isfinite(m), m, 0.0)
    total = m_safe + torch.log(torch.exp(lse - m_safe).sum(0))
    total = torch.where(torch.isfinite(total), total, 0.0)
    w = torch.exp(lse - total)                          # (R, N, H)
    out = w[0, :, None, :, None] * o[0]
    for r in range(1, o.shape[0]):
        out = out + w[r, :, None, :, None] * o[r]
    return out


class KVCache(NamedTuple):
    k: torch.Tensor          # (B, S_cache, KVH, hd)
    v: torch.Tensor
    positions: torch.Tensor  # (B, S_cache) int32 per-slot positions, -1 = empty


class PagedKVCache(NamedTuple):
    """Paged KV layout: a global page pool shared by every batch slot.
    Page 0 is the reserved trash page: decode writes from slots with no
    mapped page for their position land there, and it is never handed out
    by the allocator."""
    k: torch.Tensor            # (n_pages, page_size, KVH, hd)
    v: torch.Tensor
    positions: torch.Tensor    # (n_pages, page_size) int32, -1 = empty
    block_table: torch.Tensor  # (B, max_pages) int32 page ids, -1 = unmapped


def gather_pages(cache: PagedKVCache, min_page: int = 1):
    """Each slot's mapped pages as a dense (B, max_pages·page_size) view.
    Unmapped entries and the trash page (id < `min_page`: id <= 0 for the
    pool; 0 reads page 0, for dense rows presented as a pool) gather zeros
    with positions -1, so they are masked like empty ring entries."""
    B, P = cache.block_table.shape
    psz = cache.k.shape[1]
    safe = torch.clamp_min(cache.block_table, 0).long()       # (B, P)
    mapped = (cache.block_table >= min_page)[:, :, None]      # (B, P, 1)
    kvhd = cache.k.shape[2:]
    zero = torch.zeros((), dtype=cache.k.dtype, device=cache.k.device)
    k = torch.where(mapped[..., None, None], cache.k[safe], zero)
    v = torch.where(mapped[..., None, None], cache.v[safe], zero)
    pos = torch.where(mapped, cache.positions[safe], -1)
    return (k.reshape(B, P * psz, *kvhd), v.reshape(B, P * psz, *kvhd),
            pos.reshape(B, P * psz))


# the decode steps' rings hold this data rank's block of R/D rows of
# every slot (`seq_sharded`: the engine's layout where the `data` axis does
# not divide the batch)
_SEQ_SHARDED = False


class seq_sharded:
    """Run the decode steps in a block over rings whose rows split over the
    active mesh's `data` axis (`on`; a no-op otherwise): data rank r holds
    rows [r·R/D, (r + 1)·R/D) of every slot's ring of R rows, writes a
    step's K/V only where it holds row pos % R, and the ranks' partial
    attentions are folded by their log-sum-exps (`_ring_decode_split`)."""

    def __init__(self, on: bool = True):
        self.on = bool(on)

    def __enter__(self):
        global _SEQ_SHARDED
        self.prev, _SEQ_SHARDED = _SEQ_SHARDED, self.on or _SEQ_SHARDED
        return self

    def __exit__(self, *exc):
        global _SEQ_SHARDED
        _SEQ_SHARDED = self.prev


def _rank_pool(cache: "PagedKVCache", batch: int) -> "PagedKVCache":
    """A pool as this data rank's decode reads it. Under a `data` axis of
    D > 1 ranks the pool holds the rank's shard of the pages (global ids
    [r·n, (r + 1)·n) for n local pages) beside the whole block table of
    the D·`batch` slots: the rank's `batch` rows of the table, each id
    made relative to its first page (-1 where unmapped). The same cache
    in one process."""
    from repro_torch.parallel import sharding as S

    dp = S.batch_count()
    bt = cache.block_table
    if dp == 1 or bt.shape[0] != dp * batch:
        return cache
    r = S.batch_index()
    bt = bt[r * batch:(r + 1) * batch]
    base = r * cache.k.shape[0]
    return cache._replace(block_table=torch.where(bt >= 0, bt - base, -1))


def tp_context():
    """(tp, group, rank) of the active mesh's `model` axis; (1, None, 0)
    without one."""
    from repro_torch.parallel import sharding as S

    tp = S.axis_count("model")
    if tp == 1:
        return 1, None, 0
    return tp, S.axis_group("model"), S.axis_index("model")


def row_linear(h, h_sharded: bool, w, k_full: int):
    """`h @ w` for a row-parallel weight (wo, wd): where `w` holds this
    rank's K rows, each rank's partial is the SA contract's unrounded fp32
    chain over its K slice (`sa_dot_chain`, the hand-written SA GEMM on
    `cuda`); the ranks' partials are all-reduced in fp32, and only then
    come the approx truncation and the single rounding (`sa_finish`), the
    order of the JAX package's reduced fp32 dot. A replicated `w` (the
    divisibility guard) takes the whole K on every rank. `h_sharded`: `h`
    holds this rank's K columns (else the whole K, replicated)."""
    from repro_torch.core.precision import sa_dot_chain, sa_finish
    from repro_torch.parallel import collectives as C

    _, group, _ = tp_context()
    if w.shape[0] != k_full:
        if not h_sharded:
            h = C.split_to_model(h, -1, group)
        return sa_finish(C.reduce_from_model(sa_dot_chain(h, w), group))
    if h_sharded:
        h = C.gather_from_model(h, -1, group)
    return sa_dot(h, w)


def _pad_heads(q, k, v, kvh_target: int):
    """Zero-pad the KV heads, and the kv-major grouped Q heads, to
    `kvh_target` (the JAX package's `_pad_heads`): a padded Q head
    attends over zero K and V, and its output is dropped."""
    pad = kvh_target - k.shape[2]
    g = q.shape[2] // k.shape[2]
    pad_k = (0, 0, 0, pad)
    return (torch.nn.functional.pad(q, (0, 0, 0, pad * g)),
            torch.nn.functional.pad(k, pad_k),
            torch.nn.functional.pad(v, pad_k))


def padded_kvh(kvh: int, tp: int) -> int:
    """KV heads after TP padding (the JAX package's, under its default
    optflags)."""
    if tp <= 1 or kvh % tp == 0 or not optflags.enabled("pad_kv_heads"):
        return kvh
    return -(-kvh // tp) * tp


def _tp_attention(x, p, cfg, window, positions, rope: bool, causal: bool,
                  cache=None, prefix_len: int = 0,
                  decode_multi: bool = False, page_size: int = 16,
                  kv_input=None):
    """The attention sub-layer on the rank's shards. wq, wk, wv (and their
    biases) are column shards of the replicated input; wo a row shard.
    `kv_input` (B, S, D), the encoder's output, gives the cross-attention
    its K and V through the same wk and wv pieces (`encoder_kv`'s rule,
    unrotated); the three projections of x still run, as in one process.
    With a cache (serving) every `"kv"` leaf holds this rank's KV heads
    (`cache_specs` puts the padded heads on `model`), and the rank writes
    and attends over those heads only, by the one-process cache paths
    (`_attend`: prefill into a dense fragment or ring, decode, the
    speculative verify).

    Where the KV heads divide the axis, each rank's columns are whole
    heads (kv-major: its Q heads group over its KV heads), so it attends
    over its own heads and feeds its row shard of wo. Otherwise the
    projections are gathered whole (a column shard need not end on a head
    boundary: phi3's 1280 K columns over 4 ranks are 2.5 heads a rank);
    under a cache (whose layout wins) or with `cfg.pad_attn_train` the KV
    heads and kv-major Q heads are zero-padded to `padded_kvh` and split
    by padded heads; the padded heads' outputs are dropped after the heads
    are gathered back, and wo takes this rank's K rows of the whole
    output, as GSPMD reshards the JAX package's layout. Without padding
    every rank attends over every head (training only)."""
    from repro_torch.parallel import collectives as C

    tp, group, _ = tp_context()
    B, T, _ = x.shape
    H, KVH, hd = cfg.num_heads, cfg.num_kv_heads, cfg.hd
    fused = cfg.qkv_bias and _fuse_epilogue()

    def rows(t):         # (rows, D) and its copy onto the model axis
        t = t.reshape(-1, t.shape[-1])
        return t, C.copy_to_model(t, group)

    def proj(src, w, b, n_full):
        sharded = w.shape[1] != n_full
        y = sa_dot(src[1] if sharded else src[0], w,
                   bias=b if fused else None)
        if b is not None and not fused:
            y = y + b
        return y, sharded

    xs = rows(x)
    (q, qs), (k, ks), (v, vs) = (
        proj(xs, p["w" + n], p["b" + n] if cfg.qkv_bias else None,
             heads * hd)
        for n, heads in (("q", H), ("k", KVH), ("v", KVH)))
    if kv_input is not None:
        es = rows(kv_input)
        (k, ks), (v, vs) = (proj(es, p[w], None, KVH * hd)
                            for w in ("wk", "wv"))
    aligned = qs and ks and vs and KVH % tp == 0
    if not aligned:      # whole projections, replicated
        q, k, v = (C.gather_from_model(t, -1, group) if s else t
                   for t, s in ((q, qs), (k, ks), (v, vs)))
    q, k, v = (t.reshape(B, t.shape[0] // B, -1, hd) for t in (q, k, v))
    if rope:             # the encoder's K is not rotated
        q = apply_rope(q.transpose(1, 2), positions[:, None, :],
                       cfg.rope_theta).transpose(1, 2)
        if kv_input is None:
            k = apply_rope(k.transpose(1, 2), positions[:, None, :],
                           cfg.rope_theta).transpose(1, 2)

    def attend(q_, k_, v_):
        return _attend(q_, k_, v_, cache, cfg, window, positions, causal,
                       prefix_len, decode_multi, page_size)

    if cache is not None:
        kvp = cache.k.shape[-2] * tp        # the cache's heads, all ranks
    else:
        kvp = padded_kvh(KVH, tp) if cfg.pad_attn_train else KVH
    if aligned and kvp == KVH:
        return row_linear(attend(q, k, v).reshape(B * T, -1), True,
                          p["wo"], H * hd).reshape(B, T, -1)
    if kvp % tp == 0:
        q, k, v = (C.split_to_model(t, 2, group)
                   for t in _pad_heads(q, k, v, kvp))
        o = C.gather_from_model(attend(q, k, v), 2, group)[:, :, :H]
    else:
        o = attend(q, k, v)
    return row_linear(o.reshape(B * T, H * hd), False, p["wo"],
                      H * hd).reshape(B, T, -1)


def _act_dot(x, w, act=None):
    """`x @ w` through the SA GEMM, `act` in its epilogue when fused, else
    applied to its fp32 output."""
    if act is None:
        return sa_dot(x, w)
    if _fuse_epilogue():
        return sa_dot(x, w, act=act)
    return act_fn(sa_dot(x, w), act)


def _tp_column_row(x, cols, w_out, ff: int, mix):
    """The FFN's column-in, row-out rule on the rank's shards: each
    (w, act) of `cols` runs column-parallel on the copied input where `w`
    holds the rank's columns, whole where the divisibility guard left it
    whole, its activation in its epilogue as unsharded; where pieces and
    whole outputs meet, the pieces are gathered (one layout for `mix`);
    `mix` of the outputs feeds `w_out` through `row_linear`."""
    from repro_torch.parallel import collectives as C

    _, group, _ = tp_context()
    B, T, D = x.shape
    xf = x.reshape(B * T, D)
    xc = C.copy_to_model(xf, group)
    sharded = [w.shape[1] != ff for w, _ in cols]
    outs = [_act_dot(xc if s else xf, w, act)
            for (w, act), s in zip(cols, sharded)]
    if len(set(sharded)) > 1:
        outs = [C.gather_from_model(o, -1, group) if s else o
                for o, s in zip(outs, sharded)]
        sharded = [False]
    return row_linear(mix(*outs), sharded[0], w_out, ff).reshape(B, T, D)


def _tp_ffn(x, p, act, ff: int):
    """SwiGLU on the rank's shards: wg, wu column-parallel, wd
    row-parallel (`_tp_column_row`)."""
    return _tp_column_row(x, ((p["wg"], act), (p["wu"], None)), p["wd"],
                          ff, torch.mul)


def qkv_project(x, p, cfg):
    """x: (B, T, D) → q (B,T,H,hd), k/v (B,T,KVH,hd)."""
    B, T, _ = x.shape
    xf = x.reshape(B * T, -1)
    # fused: the bias rides the GEMM epilogue, added to the fp32 chain
    fused = cfg.qkv_bias and _fuse_epilogue()
    q = sa_dot(xf, p["wq"], bias=p["bq"] if fused else None
               ).reshape(B, T, cfg.num_heads, cfg.hd)
    k = sa_dot(xf, p["wk"], bias=p["bk"] if fused else None
               ).reshape(B, T, cfg.num_kv_heads, cfg.hd)
    v = sa_dot(xf, p["wv"], bias=p["bv"] if fused else None
               ).reshape(B, T, cfg.num_kv_heads, cfg.hd)
    if cfg.qkv_bias and not fused:
        q = q + p["bq"].reshape(cfg.num_heads, cfg.hd)
        k = k + p["bk"].reshape(cfg.num_kv_heads, cfg.hd)
        v = v + p["bv"].reshape(cfg.num_kv_heads, cfg.hd)
    return q, k, v


def encoder_kv(p, cfg, encoder_out):
    """The cross-attention's K and V: the encoder's output (B, S, D)
    through wk and wv → (B, S, KVH, hd) each."""
    B, S, _ = encoder_out.shape
    flat = encoder_out.reshape(B * S, -1)
    k = sa_dot(flat, p["wk"]).reshape(B, S, cfg.num_kv_heads, cfg.hd)
    v = sa_dot(flat, p["wv"]).reshape(B, S, cfg.num_kv_heads, cfg.hd)
    return k, v


def attn_out(x_attn, p):
    B, T, H, hd = x_attn.shape
    return sa_dot(x_attn.reshape(B * T, H * hd), p["wo"]).reshape(B, T, -1)


def _paged_write(cache: PagedKVCache, k, v, pos):
    """Write K/V rows into the pool, IN PLACE: k, v (B, T, KVH, hd) at
    positions pos (B, T). Position p of slot b lives at offset p %
    page_size of page block_table[b, p // page_size]; rows whose position
    falls outside their mapped pages (free slots, steps after retirement,
    verify rows past a request's run) go to the trash page 0."""
    B = k.shape[0]
    psz = cache.k.shape[1]
    P = cache.block_table.shape[1]
    pos = pos.long()
    page_i = pos // psz
    off = pos % psz
    b = torch.arange(B, device=k.device)[:, None]
    pid = cache.block_table[b, page_i.clamp(0, P - 1)].long()
    pid = torch.where((page_i < P) & (pid >= 0), pid, 0)
    cache.k[pid, off] = k.to(cache.k.dtype)                 # in place
    cache.v[pid, off] = v.to(cache.v.dtype)                 # in place
    cache.positions[pid, off] = pos.to(cache.positions.dtype)  # in place


def _decode_attend(q, k, v, cache, positions, window: int, cap: float,
                   page_size: int):
    """Decode with a cache: each slot's T tokens are T consecutive decode
    steps (T = 1: the decode step; T > 1: the speculative verify). Row t
    writes its K/V at position pos + t in place (paged pool or per-slot
    ring: row b is an independent request at its own depth), then the B·T
    query rows fold into the batch and each runs the single-token decode
    arithmetic, `kv_positions <= pos + t` standing in for the causal mask.
    Every kernel on this path gives a row the same bits at any batch
    (ROADMAP F2), so verify row t equals the sequential decode step it
    replaces. Each slot's block-table row (or ring row) is repeated for
    its T query rows in `jnp.repeat`'s order (`repeat_interleave`).

    On the card every layout decodes through the paged-decode kernel
    wherever the policy lets it (ROADMAP F5): the pool by its block table,
    the gathered view and the ring as dense rows presented as a pool
    (`dense_pool_view`, split into `page_size`-row pages for the ring, the
    pool's pages for the gathered view), so a slot gets the fused path's
    order of sums whichever way it decodes. On the CPU, and for a policy
    the kernel does not reproduce (FP8 in, non-fp32 out), the gathered
    view and the ring run `decode_attention`, as in the JAX engine."""
    from repro_torch.core.device import card_program
    from repro_torch.core.precision import current_policy
    from repro_torch.kernels import ops
    from repro_torch.kernels.sa_decode_attention import dense_pool_view

    B, T, H, hd = q.shape
    tpos = positions.to(torch.int32)                     # (B, T) = pos + t
    qf = q.reshape(B * T, 1, H, hd)
    posf = tpos.reshape(B * T)
    dense_kernel = (card_program(q.device)
                    and ops.fused_decode_supported(current_policy()))

    def rows(t):
        return t if T == 1 else torch.repeat_interleave(t, T, dim=0)

    def attend_dense(k_d, v_d, pos_d, psz, block_table=None, lse=False):
        if not dense_kernel:
            return decode_attention(qf, rows(k_d), rows(v_d), rows(pos_d),
                                    posf, window=window, cap=cap,
                                    return_lse=lse)
        kp, vp, pp, table = dense_pool_view(k_d, v_d, pos_d, psz,
                                            block_table)
        return ops.paged_decode_attention(qf, kp, vp, pp, rows(table), posf,
                                          window=window, cap=cap,
                                          min_page=0, lse=lse)

    if _SEQ_SHARDED and isinstance(cache, KVCache):
        return _ring_decode_split(k, v, cache, tpos, page_size,
                                  attend_dense).reshape(B, T, H, hd)
    if isinstance(cache, PagedKVCache):
        cache = _rank_pool(cache, B)
        _paged_write(cache, k, v, tpos)
        # attention over the slot's mapped pages: the hand kernel walks the
        # block table (default; on the card it raises for a policy it cannot
        # reproduce, FP8 in or non-fp32 out); REPRO_DECODE_ATTN=gather
        # materializes the dense view (the A/B path)
        if optflags.decode_attn_impl() == "fused":
            o = ops.paged_decode_attention(
                qf, cache.k, cache.v, cache.positions,
                rows(cache.block_table), posf, window=window, cap=cap)
        else:
            o = attend_dense(*gather_pages(cache), cache.k.shape[1],
                             cache.block_table)
    else:
        slot = tpos.long() % cache.k.shape[1]
        b = torch.arange(B, device=q.device)[:, None]
        cache.k[b, slot] = k.to(cache.k.dtype)                # in place
        cache.v[b, slot] = v.to(cache.v.dtype)                # in place
        cache.positions[b, slot] = tpos                       # in place
        o = attend_dense(cache.k, cache.v, cache.positions, page_size)
    return o.reshape(B, T, H, hd)


def _ring_decode_split(k, v, cache: KVCache, tpos, page_size: int,
                       attend_dense):
    """The decode step over rings whose rows split over `data`
    (`seq_sharded`): this rank's cache holds rows [r·n, (r + 1)·n) of each
    slot's ring of D·n rows. Row t of slot b writes its K/V where this
    rank holds ring row pos % (D·n) (in place; the other ranks keep
    theirs), every rank attends over its own rows with the log-sum-exp
    output (on the card the decode kernel's over the rows as pages), and
    the ranks' (out, lse) are gathered over `data` in one all-gather and
    folded (`fold_partials`): every rank the same bits."""
    from repro_torch.parallel import collectives as C
    from repro_torch.parallel import sharding as S

    B, T = tpos.shape
    n = cache.k.shape[1]
    # the rows split over `data` alone, as `cache_specs` cuts a batch the
    # batch axes do not divide (a `pod` axis holds copies)
    dp, r = S.axis_count("data"), S.axis_index("data")
    row = tpos.long() % (dp * n)
    mine = (row // n) == r
    loc = row % n
    b = torch.arange(B, device=k.device)[:, None]
    held = mine[..., None, None]
    cache.k[b, loc] = torch.where(held, k.to(cache.k.dtype),
                                  cache.k[b, loc])          # in place
    cache.v[b, loc] = torch.where(held, v.to(cache.v.dtype),
                                  cache.v[b, loc])          # in place
    cache.positions[b, loc] = torch.where(mine, tpos,
                                          cache.positions[b, loc])
    o, lse = attend_dense(cache.k, cache.v, cache.positions, page_size,
                          lse=True)
    N, _, H, hd = o.shape
    both = torch.cat([o.reshape(N, H * hd).to(torch.float32), lse], dim=1)
    every = C.all_gather(both[None], 0, S.axis_group("data"))
    return fold_partials(every[..., :H * hd].reshape(dp, N, 1, H, hd),
                         every[..., H * hd:])


def attention_block(x, p, cfg, meta, positions, cache=None,
                    rope: bool = True, causal: bool = True,
                    kv_input=None, prefix_len: int = 0,
                    decode_multi: bool = False, page_size: int = 16):
    """Attention sub-layer. Returns (out, cache).

    With a cache and a single token: decode (paged pool or per-slot ring),
    writing the token's K/V into the cache in place; with `decode_multi`
    the T tokens are T consecutive decode steps a slot (`_decode_attend`;
    `page_size` splits a ring's rows for the decode kernel on the card).
    Otherwise prefill: a dense cache is filled in place; `prefix_len` is
    continued prefill over KV already in the cache's first `prefix_len`
    rows. `rope=False` rotates neither q nor k (whisper). `kv_input`
    (B, S, D), the encoder's output, gives the cross-attention its K and V
    (`encoder_kv`), unrotated, in place of the projected ones; the three
    projections still run, as in the JAX package.

    A cache whose KV heads outnumber the model's (`init_cache(kv_pad_to=)`)
    wins the layout, as in the JAX package: the KV heads and the kv-major
    Q heads are zero-padded to the cache's count (`_pad_heads`), the
    padded K/V rows are written as the zeros they are, and the padded Q
    heads' outputs are dropped before wo. Under a mesh with a `model`
    axis the sub-layer runs on the rank's shards (`_tp_attention`)."""
    window = cfg.window if meta.get("attn") == "local" else 0
    if tp_context()[0] > 1:
        return _tp_attention(x, p, cfg, window, positions, rope, causal,
                             cache, prefix_len, decode_multi, page_size,
                             kv_input), cache
    q, k, v = qkv_project(x, p, cfg)
    if kv_input is not None:             # cross-attention: kv from encoder
        k, v = encoder_kv(p, cfg, kv_input)
    if rope:
        q = apply_rope(q.transpose(1, 2), positions[:, None, :],
                       cfg.rope_theta).transpose(1, 2)
        if kv_input is None:
            k = apply_rope(k.transpose(1, 2), positions[:, None, :],
                           cfg.rope_theta).transpose(1, 2)
    H = q.shape[2]
    if cache is not None and cache.k.shape[-2] != k.shape[2]:
        q, k, v = _pad_heads(q, k, v, cache.k.shape[-2])
    o = _attend(q, k, v, cache, cfg, window, positions, causal, prefix_len,
                decode_multi, page_size)
    return attn_out(o[:, :, :H], p), cache


def _attend(q, k, v, cache, cfg, window: int, positions, causal: bool,
            prefix_len: int, decode_multi: bool, page_size: int):
    """Attention of q (B, T, H, hd) over k, v (B, T, KVH, hd), the cache's
    head count, writing k and v into the cache in place: decode with a
    cache and one token or `decode_multi` (`_decode_attend`); otherwise
    prefill (on the card with a cache through the prefill kernel), a dense
    cache filled after, continued over its first `prefix_len` rows."""
    if cache is not None and (decode_multi or q.shape[1] == 1):
        return _decode_attend(q, k, v, cache, positions, window,
                              cfg.attn_softcap, page_size)
    from repro_torch.kernels import ops
    if cache is not None and isinstance(cache, PagedKVCache):
        raise ValueError(
            "paged KV caches take prefill via the engine's fragment "
            "splice, not a multi-token forward")
    k_att, v_att = k, v
    if cache is not None and prefix_len:
        # continued prefill: suffix queries attend over [cached prefix
        # ‖ fragment] at their absolute offset
        k_att = torch.cat([cache.k[:, :prefix_len].to(k.dtype), k], 1)
        v_att = torch.cat([cache.v[:, :prefix_len].to(v.dtype), v], 1)
    if cache is not None and optflags.prefill_kernel_on(q.device):
        # serving prefill through the hand-written flash kernel
        o = ops.sa_attention(q, k_att, v_att, causal=causal,
                             window=window, cap=cfg.attn_softcap,
                             q_offset=prefix_len)
    else:
        o = blockwise_attention(q, k_att, v_att, causal=causal,
                                window=window, cap=cfg.attn_softcap,
                                q_offset=prefix_len)
    if cache is not None:
        _fill_dense(cache, k, v, positions, prefix_len)
    return o


def _fill_dense(cache: KVCache, k, v, positions, prefix_len: int):
    """Prefill write into a dense per-slot cache, IN PLACE."""
    S = cache.k.shape[1]
    T = k.shape[1]
    k = k.to(cache.k.dtype)
    v = v.to(cache.v.dtype)
    if T >= S:                   # keep the last S positions (ring)
        assert not prefix_len, (
            "continued prefill needs prefix_len + suffix <= cache capacity")
        pos_keep = positions[:, -S:].long()                   # (B, S)
        slots = pos_keep % S
        bidx = torch.arange(k.shape[0], device=k.device)[:, None]
        cache.k.zero_()
        cache.v.zero_()
        cache.positions.fill_(-1)
        cache.k[bidx, slots] = k[:, -S:]                      # in place
        cache.v[bidx, slots] = v[:, -S:]                      # in place
        cache.positions[bidx, slots] = pos_keep.to(cache.positions.dtype)
    else:                        # suffix rows land after the prefix
        end = prefix_len + T
        cache.k[:, prefix_len:end] = k                        # in place
        cache.v[:, prefix_len:end] = v                        # in place
        cache.positions[:, prefix_len:end] = positions.to(
            cache.positions.dtype)


# ---------------------------------------------------------------------------
# FFN
# ---------------------------------------------------------------------------

def ffn_swiglu(x, p, act="silu", ff: int | None = None):
    """SwiGLU; `ff` (the full width) engages the tensor-parallel path
    under a mesh with a `model` axis (`_tp_ffn`)."""
    if ff is not None and tp_context()[0] > 1:
        return _tp_ffn(x, p, act, ff)
    B, T, D = x.shape
    xf = x.reshape(B * T, D)
    h = _act_dot(xf, p["wg"], act) * sa_dot(xf, p["wu"])
    return sa_dot(h, p["wd"]).reshape(B, T, D)


def ffn_mlp(x, p, act="gelu", ff: int | None = None):
    """The classic two-matrix MLP (whisper): act in w1's epilogue when
    fused, else applied to its fp32 output. `ff` (the full width) engages
    the tensor-parallel path under a mesh with a `model` axis
    (`_tp_column_row`: w1 column-parallel, w2 row-parallel)."""
    if ff is not None and tp_context()[0] > 1:
        return _tp_column_row(x, ((p["w1"], act),), p["w2"], ff,
                              lambda h: h)
    B, T, D = x.shape
    xf = x.reshape(B * T, D)
    return sa_dot(_act_dot(xf, p["w1"], act), p["w2"]).reshape(B, T, D)
