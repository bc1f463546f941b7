"""Model assembly: the decoder-only LM, dense (qwen2.5, phi3, gemma2,
gemma3: untied or tied embeddings, global and local-window attention,
softcaps, SwiGLU or GeGLU), MoE (granite, llama4: routed experts on every
`moe_every`-th layer, an optional shared expert; models/moe.py), SSM
(mamba2: every layer a Mamba2 mixer; models/ssm.py) and hybrid (hymba:
attention and a Mamba2 mixer side by side in every layer, their outputs'
RMSNorms averaged); the encoder-decoder (whisper: layernorm, a GELU MLP,
an encoder stack over stub frame embeddings with sinusoidal positions,
and a cross-attention sublayer in every decoder layer) and the VLM
(pixtral: stub patch embeddings prepended to the text sequence).

Parameters are a plain nested dict with the JAX package's key names and
its stacked superblock axis: `params["layers"]` is a tuple of
`cfg.stack_period` layer dicts whose leaves carry the superblock index on
axis 0. For serving on CUDA, matrices (≥ 2-D leaves; ≥ 3-D under
`layers`, where axis 0 stacks the superblocks) are stored in bf16 —
the JAX forward casts them to bf16 at superblock entry and `cast_in`
rounds to bf16 at every use, so this is the same arithmetic at half the
memory (the full qwen2.5-14b in fp32 would take 59 GB). On the CPU, and
for training (`init_params(..., dtype=torch.float32)`: fp32 masters, as
the JAX package's), they are fp32 and the forward casts at superblock
entry, as the JAX package does. A matrix whose last dimension is not a
multiple of 8 (hymba's in_proj: 6482 columns) is a view of a buffer whose
rows are rounded up to 8 elements (`matrix_storage`), so the SA GEMM's
16-byte copies read it in place and no launch copies the weight.
"""
from __future__ import annotations

import functools
import itertools
from typing import Any

import torch
import torch.utils.checkpoint

from repro_torch.core import optflags
from repro_torch.core.device import card_program, resolve_device
from repro_torch.core.precision import input_dtype, sa_dot
from .config import ArchConfig
from . import layers as L
from .layers import KVCache, PagedKVCache
from .moe import gemm_calls as moe_gemm_calls, moe_ffn
from .ssm import mamba2_block


def check_supported(cfg: ArchConfig):
    """The port's model code covers every family the JAX package builds
    (dense, MoE, SSM, hybrid, the encoder-decoder and the VLM), with
    RMSNorm or LayerNorm, tied or untied embeddings."""
    if (cfg.family not in ("dense", "moe", "ssm", "hybrid", "audio", "vlm")
            or cfg.norm not in ("rmsnorm", "layernorm")):
        raise ValueError(f"{cfg.name}: family {cfg.family!r} / norm "
                         f"{cfg.norm!r} is not ported")


def check_parallel(cfg: ArchConfig, model_parallel: int,
                   data_parallel: int = 1, serving: bool = False,
                   batch: int | None = None, kv_layout: str | None = None):
    """Refuse what the mesh does not cover yet. Tensor parallelism covers
    every family at any `model_parallel`: dense, MoE (the MoE layer by
    expert parallelism where the axis divides the experts, else tensor
    parallelism inside each expert, `models/moe.py`), the SSM and hybrid
    families (the Mamba2 mixer in the gather layout,
    `ssm._tp_mixer_params`), the encoder-decoder (cross-attention over
    the rank's heads of the encoder's K and V) and the VLM. Training takes
    any data axis. A config flagged `cfg.fsdp` trains with its leaves cut
    over `data` too, as the JAX rules cut them: `forward` gathers each
    one whole over the axis where a layer reads it (`_data_dims`), its
    gradient comes back reduce-scattered to the rank's piece, and the
    optimizer keeps μ and ν on that piece. MoE training splits rows over
    `data`: the capacity dispatch takes each expert's top C tokens within
    each batch row, so that moves no token, and only `load_balance` needs
    the global batch's statistics, which `moe.router` sums over `data`.
    Serving (`serving`) covers both axes, every family: where the data
    axis divides `batch` a data rank serves its own slots, with its own
    range of the pool's pages and one page allocator a data shard
    (`serve/engine.py`); where it does not (the batch-1 long-context
    case), every slot's ring rows split over `data` and the ranks' partial
    attentions are folded by their log-sum-exps. A paged pool there
    (`kv_layout` "paged" for a stack with KV to page) is refused: its
    pages would have to split a slot's sequence across ranks. An FSDP
    config serves with its leaves cut over `data`, gathered a layer at a
    time as in training."""
    if (serving and data_parallel > 1 and batch is not None
            and batch % data_parallel and kv_layout == "paged"
            and cfg.family != "ssm"):
        raise ValueError(f"{cfg.name}: a paged pool at batch {batch} over a "
                         f"data axis of {data_parallel} (the batch does not "
                         f"split over data, so each slot's sequence would) "
                         f"is not ported; serve it with --kv ring, whose "
                         f"rows split over data")


@functools.lru_cache(maxsize=16)
def _data_dim_tree(cfg: ArchConfig, names: tuple, shape: tuple):
    """The tree of each parameter's dim that the data axes of a mesh of
    `names` and `shape` cut (`sharding.data_dim` of its `param_specs`
    entry; a stacked leaf's dim in its superblock slice), None where they
    cut none."""
    from repro_torch.parallel import sharding as S
    from repro_torch.parallel.mesh import MeshSpec

    mesh = MeshSpec(names, shape)
    meta = init_params(cfg, device="meta", dtype=torch.float32)
    return S.tree_map_with_path(
        lambda path, _, sp: S.data_dim(sp, mesh, sliced="layers" in path),
        meta, S.param_specs(cfg, meta, mesh))


def _data_dims(cfg: ArchConfig):
    """Under FSDP (`cfg.fsdp` on an active mesh whose batch axes have more
    than one rank): (the tree of `_data_dim_tree`, the batch group,
    `sharding.batch_group`); else (None, None): the leaves are whole over
    the batch axes."""
    from repro_torch.parallel import sharding as S

    mesh = S.active_mesh()
    if not cfg.fsdp or S.batch_count() == 1:
        return None, None
    return (_data_dim_tree(cfg, S.axis_names(mesh), tuple(mesh.shape)),
            S.batch_group())


def _take(w, dim, group, dtype=None):
    """A weight as the layer code reads it: cast to `dtype` where given,
    and where the data axis cuts it (`dim`, with the data `group`)
    gathered whole over `data` after the cast
    (`collectives.gather_from_data`, whose backward reduce-scatters)."""
    if dim is not None:
        from repro_torch.parallel import collectives as C

        return C.gather_from_data(w, dim, group, dtype)
    return w if dtype is None else w.to(dtype)


def _stack_slice(tree, i: int, dims=None, group=None, cast: bool = False):
    """Slice `i` of a stacked tree (a superblock's layer, an encoder layer)
    as the layer code reads it: each leaf's `w[i]`, a matrix (≥ 3-D
    stacked fp32 leaf) cast to bf16 where `cast`, and under FSDP (`dims`
    this tree's part of `_data_dims`' tree, `group` the data group) each
    leaf the data axis cuts gathered whole over it after the cast
    (`_take`), so the layer code sees the tensors it sees at data 1."""
    from repro_torch.parallel.sharding import tree_map_with_path

    def take(_, w, d=None):
        dt = (torch.bfloat16 if cast and w.ndim >= 3
              and w.dtype == torch.float32 else None)
        return _take(w[i], d, group, dt)

    if dims is None:
        return tree_map_with_path(take, tree)
    return tree_map_with_path(take, tree, dims)


def has_ssm(cfg: ArchConfig) -> bool:
    """Every layer carries a Mamba2 mixer (and its per-slot state)."""
    return cfg.family == "ssm" or cfg.hybrid


def gemm_calls(cfg: ArchConfig, tokens: int = 1, tp: int = 1) -> int:
    """The SA GEMM calls one served forward over `tokens` tokens a row
    makes (on one rank of a `model` axis of `tp` ranks: a MoE layer runs
    the rank's experts, `moe.gemm_calls`): `moe.gemm_calls` (a layer's 4
    attention GEMMs and its FFN or MoE GEMMs, and the lm_head) where the
    stack has attention and an FFN;
    an SSM layer makes 2 (in_proj and out_proj), a hybrid layer those 2
    beside the 7 of attention and FFN. mamba2-2.7b: 129 a decode step,
    hymba-1.5b: 289. The encoder-decoder's forward with a frontend re-runs
    the encoder (6 an encoder layer: 4 attention, 2 MLP), and a decoder
    layer makes 12 (self-attention 4, cross-attention 3 projections + the
    encoder's K and V + the output, MLP 2): whisper-tiny 73. The VLM's is
    the dense count (pixtral-12b: 281). On a rank of a `model` axis every
    GEMM of these families runs on the rank's piece (or whole, where the
    divisibility guard left its weight whole), so a rank makes the same
    count. On the card each call is one kernel launch."""
    if cfg.family == "ssm":
        return 1 + 2 * cfg.num_layers
    if cfg.is_encdec:
        return 1 + 12 * cfg.num_layers + 6 * cfg.encoder_layers
    return moe_gemm_calls(cfg, tokens, tp) + (2 * cfg.num_layers
                                              if cfg.hybrid else 0)


def matrix_storage(shape, dtype, device) -> torch.Tensor:
    """An empty matrix (or stack of matrices) of `shape`: contiguous where
    the last dimension is a multiple of 8, else a view of a buffer whose
    rows are rounded up to 8 elements. The SA GEMM kernel reads a bf16
    operand with 16-byte copies and TMA, both of which need a leading
    dimension of a multiple of 8 elements; a view with one is read in
    place (`sa_matmul._aligned`), where a ragged contiguous weight would
    be copied at every launch."""
    n = shape[-1]
    if len(shape) < 2 or n % 8 == 0:
        return torch.empty(shape, dtype=dtype, device=device)
    buf = torch.empty((*shape[:-1], -(-n // 8) * 8), dtype=dtype,
                      device=device)
    return buf[..., :n]


def tree_map(fn, tree):
    """Map `fn` over the tensor leaves of nested dicts, tuples and the
    cache NamedTuples."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (KVCache, PagedKVCache)):
        return type(tree)(*(tree_map(fn, v) for v in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree) if tree is not None else None


def tree_leaves(tree) -> list:
    """The tensor leaves of nested dicts (in key order), tuples, lists and
    NamedTuples, depth first; None is no leaf."""
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves(v)]
    if isinstance(tree, (tuple, list)):
        return [x for v in tree for x in tree_leaves(v)]
    return [] if tree is None else [tree]


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------

def init_params(cfg: ArchConfig, *, seed: int = 0, device=None,
                generator: torch.Generator | None = None, dtype=None,
                mesh=None):
    """Full parameter tree drawn on `device` (default CUDA) from a
    `torch.Generator`: the JAX package's distributions (normal · fan_in⁻½
    matrices, 0.02-scaled embedding, unit norms, zero biases), not its
    random bits. `dtype` is the matrices' storage type: by default bf16 on
    CUDA and the meta device (serving) and fp32 on the CPU;
    `torch.float32` gives the fp32 masters training keeps. A layernorm
    adds a zero bias `b` beside each norm's `w`; the encoder-decoder adds
    `cross` and `norm_cross` to every decoder layer and `encoder =
    {layers, final_norm}`, its layers stacked over `cfg.encoder_layers`
    on axis 0 (the JAX package's tree).

    Under a `mesh`, every leaf is this rank's piece of the same tree
    (`parallel.sharding.param_specs`): each matrix is drawn a slice at a
    time in the same order from the same generator and only the rank's
    piece of each slice is kept, so a rank never holds a whole matrix
    and the pieces are `shard_tree` of the one-process tree's."""
    check_supported(cfg)
    dev = resolve_device(device)
    # on the meta device (shapes only, the sharding rules' abstract tree)
    # nothing is drawn
    gen = generator or (None if dev.type == "meta" else
                        torch.Generator(device=dev).manual_seed(seed))
    mat_dtype = dtype or (torch.bfloat16 if card_program(dev)
                          else torch.float32)
    period = cfg.stack_period
    n_super = cfg.num_layers // period
    assert n_super * period == cfg.num_layers, (cfg.num_layers, period)
    d, H, KVH, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.hd
    E, F = cfg.num_experts, cfg.d_ff
    ff = cfg.d_ff_dense or cfg.d_ff      # the dense layers' FFN width

    draws = []

    def normal(shape, std):
        # drawn in fp32 one matrix at a time (a superblock slice, or one
        # expert of an expert stack), then stored: the fp32 temporary
        # never exceeds one matrix (llama4's whole (128, 5120, 8192) slice
        # would be 21.5 GB). Under a mesh the draw waits until the leaf's
        # spec is known (`_draw_pieces`), in this order.
        if mesh is not None:
            draws.append(_Draw(tuple(shape), std))
            return draws[-1]
        out = matrix_storage(shape, mat_dtype, dev)
        if dev.type == "meta":
            return out
        for i in range(shape[0]):
            if len(shape) == 4:
                for e in range(shape[1]):
                    out[i, e] = torch.randn(shape[2:], generator=gen,
                                            device=dev) * std
            else:
                out[i] = torch.randn(shape[1:], generator=gen,
                                     device=dev) * std
        return out

    def dense(fan_in, shape, n=n_super):
        return normal((n, *shape), fan_in ** -0.5)

    def ones(*shape):
        return torch.ones(shape, dtype=torch.float32, device=dev)

    def zeros(*shape):
        return torch.zeros(shape, dtype=torch.float32, device=dev)

    def norm(*lead):
        p = {"w": ones(*lead, d)}
        if cfg.norm == "layernorm":
            p["b"] = zeros(*lead, d)
        return p

    def attention(n=n_super):
        p = {"wq": dense(d, (d, H * hd), n), "wk": dense(d, (d, KVH * hd), n),
             "wv": dense(d, (d, KVH * hd), n),
             "wo": dense(H * hd, (H * hd, d), n)}
        if cfg.qkv_bias:
            p |= {"bq": zeros(n, H * hd), "bk": zeros(n, KVH * hd),
                  "bv": zeros(n, KVH * hd)}
        return p

    def ffn(n=n_super):
        if cfg.family == "audio":     # the classic 2-matrix MLP (whisper)
            return {"w1": dense(d, (d, ff), n), "w2": dense(ff, (ff, d), n)}
        return {"wg": dense(d, (d, ff), n), "wu": dense(d, (d, ff), n),
                "wd": dense(ff, (ff, d), n)}

    def ssm():
        # the JAX package's `_init_ssm`: the conv runs over [x | B | C]
        din, N, Hs = cfg.d_inner, cfg.ssm_state, cfg.n_ssm_heads
        return {"in_proj": dense(d, (d, 2 * din + 2 * N + Hs)),
                "conv_w": normal((n_super, 4, din + 2 * N), 0.1),
                "dt_bias": zeros(n_super, Hs), "A_log": zeros(n_super, Hs),
                "D_skip": ones(n_super, din), "norm_w": ones(n_super, din),
                "out_proj": dense(din, (din, d))}

    def layer(j):
        if cfg.family == "ssm":           # no attention, no FFN, no norm2
            return {"norm1": norm(n_super), "ssm": ssm()}
        p = {"norm1": norm(n_super), "norm2": norm(n_super),
             "attn": attention()}
        if cfg.is_encdec:
            p |= {"cross": attention(), "norm_cross": norm(n_super)}
        if cfg.hybrid:
            p |= {"ssm": ssm(), "attn_norm": {"w": ones(n_super, d)},
                  "ssm_norm": {"w": ones(n_super, d)}}
        if cfg.layer_kind(j)["moe"]:
            # the experts are d_ff wide; the JAX package's `_init_moe`
            p["moe"] = {"router": dense(d, (d, E)),
                        "wg": dense(d, (E, d, F)), "wu": dense(d, (E, d, F)),
                        "wd": dense(F, (E, F, d))}
            if cfg.shared_expert:
                p["moe"] |= {"shared_wg": dense(d, (d, F)),
                             "shared_wu": dense(d, (d, F)),
                             "shared_wd": dense(F, (F, d))}
        else:
            p["ffn"] = ffn()
        return p

    params: dict[str, Any] = {
        "embed": normal((cfg.padded_vocab, d), 0.02),
        "final_norm": norm(),
        "layers": tuple(layer(j) for j in range(period)),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = normal((d, cfg.padded_vocab), d ** -0.5)
    if cfg.is_encdec:
        n_enc = cfg.encoder_layers
        params["encoder"] = {
            "layers": {"norm1": norm(n_enc), "norm2": norm(n_enc),
                       "attn": attention(n_enc), "ffn": ffn(n_enc)},
            "final_norm": norm()}
    if mesh is not None:
        params = _draw_pieces(cfg, params, draws, mesh, gen,
                              mat_dtype, dev)
    return params


class _Draw:
    """A matrix `init_params` draws under a mesh once its spec is known."""

    def __init__(self, shape, std):
        self.shape, self.std, self.spec = shape, std, None


def _draw_pieces(cfg, params, draws, mesh, gen, mat_dtype, dev):
    """Fill a tree of `_Draw` placeholders and whole small leaves with
    this rank's pieces: the matrices drawn slice by slice along axis 0 in
    `draws`' order (the one-process tree's draws), each slice cut to the
    rank's piece of its spec before it is stored; the other leaves (norms,
    biases) cut from the whole."""
    from repro_torch.parallel import sharding as S

    specs = S.param_specs(cfg, params, mesh)
    S.tree_map_with_path(
        lambda _, x, sp: setattr(x, "spec", sp) if isinstance(x, _Draw)
        else None, params, specs)
    coords = S.mesh_coords(mesh)
    sizes = S.axis_sizes(mesh)

    def piece(shape, spec):
        out = []
        for d, e in zip(shape, spec):
            parts, idx = (1, 0) if e is None else S._entry_index(
                e, coords, sizes)
            out.append((idx * (d // parts), d // parts))
        return out

    for d in draws:
        cut = piece(d.shape, d.spec)
        out = matrix_storage(tuple(n for _, n in cut), mat_dtype, dev)
        d.out = out
        if dev.type == "meta":                  # shapes only: no draw
            continue
        lead = 2 if len(d.shape) == 4 else 1    # `normal`'s slices
        for idx in itertools.product(*map(range, d.shape[:lead])):
            x = torch.randn(d.shape[lead:], generator=gen,
                            device=dev) * d.std
            if not all(a <= i < a + n for i, (a, n) in zip(idx, cut)):
                continue
            for dim, (a, n) in enumerate(cut[lead:]):
                x = x.narrow(dim, a, n)
            out[tuple(i - a for i, (a, _) in zip(idx, cut))] = x
    return S.tree_map_with_path(
        lambda _, x, sp: x.out if isinstance(x, _Draw)
        else S.shard_leaf(x, sp, mesh, coords), params, specs)


# ---------------------------------------------------------------------------
# Caches (decode)
# ---------------------------------------------------------------------------

def init_cache(cfg: ArchConfig, batch: int, seq_len: int, *,
               dtype=torch.bfloat16, device=None,
               paged: tuple[int, int] | None = None,
               local_rows: int | None = None, kv_pad_to: int = 1,
               kv_shards: int = 1, data_shards: int = 1):
    """Stacked per-layer cache, leaves with the superblock index on axis 0
    and (dense) the batch slot on axis 1. A local-window layer gets a
    dense ring of min(window, seq_len) rows.

    `kv_pad_to`: the `model` axis's size; every `"kv"` leaf (pools and
    rings alike) gets `padded_kvh(num_kv_heads, kv_pad_to)` KV heads, so
    the cache splits by heads across the axis (the JAX package's
    `kv_pad_to`). `kv_shards`: the leaves hold one rank's share of those
    heads, the shapes `shard_leaf` cuts from the whole cache by
    `cache_specs` on a (data 1, model kv_shards) mesh, so no rank
    allocates the whole pool.

    `paged=(n_pages, page_size)`: each global layer a shared `PagedKVCache`
    page pool plus a per-slot block table of ceil(seq_len / page_size)
    columns. A local layer keeps its dense ring beside the pools where
    `window < seq_len` (bounded by the window, it strands no capacity),
    and is paged like a global one otherwise, as in the JAX package; the
    engine's splices handle the mixed tree.

    An SSM or hybrid layer also carries `"ssm"`: (state (n_super, batch,
    H, P, N) fp32 whatever `dtype`, conv tail (n_super, batch, 3,
    d_inner + 2N) in `dtype`), per slot in either layout; an SSM layer
    has no `"kv"`. Under `kv_shards` these stay whole on every rank: the
    mixer's gather layout runs the conv and the SSD whole on every rank
    (`ssm._tp_mixer_params`), where the JAX package's `cache_specs` cuts
    the state on P and the tail on its channels (ROADMAP queue 1 item
    9). An encoder-decoder layer carries `"cross"`, a KVCache
    of `frontend_tokens` rows that the forward passes through unused (the
    cross-attention recomputes the encoder's K and V, as the JAX package
    does); its heads unpadded, and under `kv_shards` cut on the heads or,
    where the shards do not divide them, on the head dim, as
    `cache_specs` cuts them. The JAX package's leaves and types.

    `local_rows` gives each local layer's ring that many rows instead of
    `window`, and makes it a ring whatever `seq_len`: the serve engine's
    rings under speculative decoding, `window + spec_k` rounded up to a
    page, so a verify's writes never land on a row a live window still
    reads (ROADMAP F6).

    `data_shards`: the leaves hold one rank's share over a `data` axis of
    that many ranks, the shapes `shard_leaf` cuts by `cache_specs`: where
    it divides `batch`, every per-slot leaf (rings, SSM states and tails,
    the cross leaves) holds batch / data_shards slots and a pool n_pages /
    data_shards pages beside the whole block table; where it does not,
    every ring's rows (and the cross leaves' where they divide) split into
    data_shards blocks, the SSM states whole. The SSM states stay whole
    over `model` (above)."""
    check_supported(cfg)
    dev = resolve_device(device)
    period = cfg.stack_period
    n_super = cfg.num_layers // period
    kvh, hd = L.padded_kvh(cfg.num_kv_heads, kv_pad_to), cfg.hd
    if kvh % kv_shards:
        raise ValueError(f"{cfg.name}: {kvh} KV heads do not split over "
                         f"{kv_shards} ranks (pad them: kv_pad_to)")
    kvh //= kv_shards
    by_slot = batch % data_shards == 0
    rows_b = batch // data_shards if by_slot else batch   # per-slot leaves

    def seq_rows(n):      # a ring's rows on this rank
        if by_slot:
            return n
        if n % data_shards:
            raise ValueError(f"{cfg.name}: a ring of {n} rows does not split "
                             f"over {data_shards} data ranks")
        return n // data_shards

    def full(shape, fill, dt):
        return torch.full(shape, fill, dtype=dt, device=dev)

    def kv_cache(j):
        local = (cfg.layer_kind(j)["attn"] == "local" and cfg.window
                 and (cfg.window < seq_len or local_rows))
        if paged is not None and not local:
            n_pages, psz = paged
            if not by_slot or n_pages % data_shards:
                raise ValueError(f"{cfg.name}: a pool of {n_pages} pages at "
                                 f"batch {batch} does not split over "
                                 f"{data_shards} data ranks")
            n_pages //= data_shards
            max_pages = -(-seq_len // psz)
            return PagedKVCache(
                k=full((n_super, n_pages, psz, kvh, hd), 0, dtype),
                v=full((n_super, n_pages, psz, kvh, hd), 0, dtype),
                positions=full((n_super, n_pages, psz), -1, torch.int32),
                block_table=full((n_super, batch, max_pages), -1,
                                 torch.int32))
        S = seq_rows((local_rows or cfg.window) if local else seq_len)
        return KVCache(
            k=full((n_super, rows_b, S, kvh, hd), 0, dtype),
            v=full((n_super, rows_b, S, kvh, hd), 0, dtype),
            positions=full((n_super, rows_b, S), -1, torch.int32))

    def layer_cache(j):
        c = {} if cfg.family == "ssm" else {"kv": kv_cache(j)}
        if has_ssm(cfg):
            c["ssm"] = (
                full((n_super, rows_b, cfg.n_ssm_heads, cfg.ssm_head_dim,
                      cfg.ssm_state), 0, torch.float32),
                full((n_super, rows_b, 3, cfg.d_inner + 2 * cfg.ssm_state),
                     0, dtype))
        if cfg.is_encdec:
            ft = cfg.frontend_tokens
            if not by_slot and ft % data_shards == 0:
                ft //= data_shards
            # unpadded: cut over `model` on the heads where the axis
            # divides them, else on the head dim (`cache_specs`)
            ck, chd = cfg.num_kv_heads, hd
            if ck % kv_shards == 0:
                ck //= kv_shards
            elif chd % kv_shards == 0:
                chd //= kv_shards
            c["cross"] = KVCache(
                k=full((n_super, rows_b, ft, ck, chd), 0, dtype),
                v=full((n_super, rows_b, ft, ck, chd), 0, dtype),
                positions=full((n_super, rows_b, ft), -1, torch.int32))
        return c

    return tuple(layer_cache(j) for j in range(period))


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------

def _sublayer(x, p, cfg, meta, positions, cache, prefix_len: int = 0,
              decode_multi: bool = False, page_size: int = 16,
              encoder_out=None):
    """One transformer layer. Returns (x, cache, aux): aux is a MoE
    layer's aux losses where no cache is threaded, else None. An SSM or
    hybrid layer's mixer state and conv tail are written into the cache's
    `"ssm"` tensors in place (the tail rounded to the cache's type). With
    `encoder_out`, an encoder-decoder layer attends over it after its
    self-attention (no rope, no mask; the cache's `"cross"` leaves pass
    through unused, as in the JAX package)."""
    h = L.norm_apply(x, p["norm1"], cfg.norm, cfg.norm_eps)

    def mamba(h):
        st = cache["ssm"] if cache else None
        out, (state, tail) = mamba2_block(
            h, p["ssm"], cfg, state=st[0] if st else None,
            conv_cache=st[1] if st else None)
        if st:
            st[0].copy_(state)                                  # in place
            st[1].copy_(tail)                                   # in place
        return out

    if cfg.family == "ssm":
        x = x + mamba(h).to(x.dtype)
        return x, cache, None
    mix, _ = L.attention_block(h, p["attn"], cfg, meta, positions,
                               cache=cache["kv"] if cache else None,
                               prefix_len=prefix_len,
                               decode_multi=decode_multi,
                               page_size=page_size)
    if cfg.hybrid:
        # hymba's parallel heads: the mean of each branch's RMSNorm
        s = mamba(h)
        mix = 0.5 * (L.rmsnorm(mix, p["attn_norm"]["w"], cfg.norm_eps)
                     + L.rmsnorm(s, p["ssm_norm"]["w"], cfg.norm_eps))
    x = x + mix.to(x.dtype)
    if cfg.is_encdec and encoder_out is not None:
        h = L.norm_apply(x, p["norm_cross"], cfg.norm, cfg.norm_eps)
        ca, _ = L.attention_block(
            h, p["cross"], cfg, {"attn": "global"}, positions, cache=None,
            rope=False, causal=False, kv_input=encoder_out)
        x = x + ca.to(x.dtype)
    h = L.norm_apply(x, p["norm2"], cfg.norm, cfg.norm_eps)
    aux = None
    if meta["moe"]:
        # every served path threads a cache, so it routes through the
        # dropless dispatch: capacity drops tokens, a training-time
        # approximation that would also let a padded or foreign row take
        # a real token's slot
        dropless = cfg.moe_dropless or cache is not None
        f, aux = moe_ffn(h, p["moe"], cfg, cfg.act, dropless=dropless,
                         with_aux=cache is None)
    elif cfg.family == "audio":
        f = L.ffn_mlp(h, p["ffn"], "gelu", cfg.d_ff)
    else:
        f = L.ffn_swiglu(h, p["ffn"], cfg.act, cfg.d_ff_dense or cfg.d_ff)
    return x + f.to(x.dtype), cache, aux


def _sinusoid(T, d, device=None):
    """(1, T, d) fp32 positions: sin of pos / 10000^(2i/d) for the first
    d/2 columns, then cos (concatenated, not interleaved)."""
    pos = torch.arange(T, dtype=torch.float32, device=device)[:, None]
    dim = torch.arange(0, d, 2, dtype=torch.float32, device=device)[None]
    ang = pos / torch.pow(torch.tensor(10000.0, device=device), dim / d)
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)[None]


def encode(params, cfg: ArchConfig, frontend_embeds):
    """The encoder stack over stub frontend embeddings (B, S, d_model):
    sinusoidal positions added in the embeddings' type, then each encoder
    layer (pre-norm self-attention without rope or mask, pre-norm GELU
    MLP; the JAX package's `lax.scan` as a loop over the stacked layers),
    then the encoder's final norm."""
    x = frontend_embeds + _sinusoid(frontend_embeds.shape[1], cfg.d_model,
                                    frontend_embeds.device
                                    ).to(frontend_embeds.dtype)
    B, S = x.shape[:2]
    positions = torch.arange(S, dtype=torch.int32,
                             device=x.device)[None].expand(B, S)
    layers = params["encoder"]["layers"]
    dims, dgroup = _data_dims(cfg)
    dims = dims and dims["encoder"]["layers"]
    for i in range(cfg.encoder_layers):
        p = _stack_slice(layers, i, dims, dgroup)
        h = L.norm_apply(x, p["norm1"], cfg.norm, cfg.norm_eps)
        a, _ = L.attention_block(h, p["attn"], cfg, {"attn": "global"},
                                 positions, rope=False, causal=False)
        x = x + a.to(x.dtype)
        h = L.norm_apply(x, p["norm2"], cfg.norm, cfg.norm_eps)
        x = x + L.ffn_mlp(h, p["ffn"], "gelu", cfg.d_ff).to(x.dtype)
    return L.norm_apply(x, params["encoder"]["final_norm"], cfg.norm,
                        cfg.norm_eps)


def forward(params, cfg: ArchConfig, tokens, *, positions=None, cache=None,
            pos=None, frontend_embeds=None, last_only: bool = False,
            last_index=None, prefix_len: int = 0, decode_multi: bool = False,
            page_size: int = 16):
    """Token ids (B, T) → (logits, cache, aux).

    `cache`/`pos` engage the decode path (`pos` is a (B,) vector of
    per-slot positions; a scalar is broadcast). The cache is updated in
    place and returned. `prefix_len` is the continued-prefill offset.
    `decode_multi` makes the T tokens T consecutive decode steps a slot
    (the speculative verify): row t writes and attends at position pos + t.
    `last_index` (with `last_only`) picks which row feeds the lm_head.
    `page_size` is the page a dense ring's rows are split into when the
    decode kernel walks them on the card (`layers._decode_attend`; the
    engine passes its own, so a ring slot gets the pool's split).
    The forward runs the first `cfg.num_layers // cfg.stack_period`
    superblocks of the stacked params and cache, so a config of fewer
    layers over the full tree is the early-exit draft
    (train/step.py `make_draft_step`).
    `frontend_embeds` (B, S, d_model) feeds the modality stub: a VLM
    prepends it to the text embeddings (T becomes S + T, positions start
    at the first patch row), an encoder-decoder runs `encode` over it and
    every decoder layer cross-attends to the result.
    Under a mesh whose `model` axis has more than one rank every family
    runs tensor-parallel on the rank's shards (models/layers.py,
    models/moe.py, models/ssm.py; the frontend embeddings replicated);
    a vocabulary-parallel head (its columns cut across the axis) returns
    this rank's columns of the logits, which `lm_loss` reduces across
    the axis; with a cache (serving) the columns are gathered across the
    axis, so every rank returns the whole logits, the same bits.
    Under FSDP (`cfg.fsdp` on a mesh whose data axis has more than one
    rank) each leaf the JAX rules cut over `data` is gathered whole over
    it before the layer code reads it (`_take`: the head after its 16-bit
    input rounding, a superblock's matrices one superblock at a time
    after their bf16 cast, inside the function remat recomputes), so the
    layer code runs on the tensors it runs on at data 1, and each
    gradient comes back reduce-scattered to the rank's piece; the
    embedding's rows are looked up without the whole table
    (`collectives.lookup_over_data`; a tied table, which the head reads
    too, is gathered whole in fp32).
    `aux` is the JAX package's dict: a MoE stack's `load_balance` and
    `router_z` summed over its layers (zero for a dense stack and
    wherever a cache is threaded, as the JAX forward leaves them); on a
    mesh every model rank sums the same per-layer values (each layer's
    `load_balance` over the global batch under a data axis).

    With `cfg.remat`, no cache and autograd recording, each superblock
    runs under `torch.utils.checkpoint` (the JAX package's `jax.checkpoint`
    for training): its activations are recomputed in the backward by the
    same operations on the same inputs, so the gradients are the same
    (bit for bit on the CPU, tests/test_torch_train.py).

    SSM and hybrid stacks refuse `decode_multi` (their state cannot roll
    back). With a cache, a single token runs the Mamba2 decode step from
    the cached state, more tokens the chunked scan from it; either way
    the state and conv tail are written back in place."""
    check_supported(cfg)
    B, T = tokens.shape
    if decode_multi and has_ssm(cfg):
        # a rejected draft would leave the recurrent state advanced past
        # the rollback point: attention caches roll back by position, an
        # SSM state cannot (the engine gates spec decoding off for these
        # families, as the JAX engine does)
        raise ValueError("decode_multi needs rollback by position; an "
                         "ssm/hybrid recurrent state cannot roll back")
    dev = tokens.device
    tp, group, tp_rank = L.tp_context()
    if tp > 1:
        from repro_torch.parallel.sharding import batch_count
        check_parallel(cfg, tp, batch_count(), serving=cache is not None)
    # under FSDP each leaf the data axis cuts is gathered where it is read
    # (a superblock's inside the function remat recomputes, so its
    # gathered weights live only while the superblock runs); the
    # embedding's rows are looked up without the whole table
    dims, dgroup = _data_dims(cfg)
    embed, lookup_group = params["embed"], None
    if dims and dims["embed"] is not None:
        if "lm_head" in params:         # the lookup alone reads the table
            lookup_group = dgroup
        else:                           # the tied head reads it whole too
            embed = _take(embed, dims["embed"], dgroup)
    x = _embed(embed, tokens, cfg, group, tp_rank, lookup_group)
    if cfg.embed_scale:
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=torch.bfloat16,
                             device=dev)
    encoder_out = None
    if cfg.family == "vlm" and frontend_embeds is not None:
        x = torch.cat([frontend_embeds.to(torch.bfloat16), x], dim=1)
        T = x.shape[1]
    elif cfg.is_encdec and frontend_embeds is not None:
        encoder_out = encode(params, cfg, frontend_embeds.to(torch.bfloat16))
    if pos is None and prefix_len:
        pos = prefix_len
    if pos is not None:
        pos = torch.as_tensor(pos, dtype=torch.int32, device=dev
                              ).reshape(-1).expand(B)
    if positions is None:
        ar = torch.arange(T, dtype=torch.int32, device=dev)
        positions = (pos[:, None] + ar[None] if pos is not None
                     else ar[None].expand(B, T))
    period = cfg.stack_period
    n_super = cfg.num_layers // period
    cast = optflags.enabled("bf16_params_in_layers")

    def add_aux(total, a):
        return a if total is None else total + a

    def superblock(x, sb):
        aux = None      # (2,): load_balance, router_z of its MoE layers
        for j in range(period):
            # cast matrices to bf16 at superblock entry (a no-op for the
            # bf16 storage on CUDA; 1-D norms and biases stay fp32)
            p_j = _stack_slice(params["layers"][j], sb,
                               dims and dims["layers"][j], dgroup, cast)
            c_j = (None if cache is None
                   else tree_map(lambda t: t[sb], cache[j]))
            x, _, a = _sublayer(x, p_j, cfg, cfg.layer_kind(j), positions,
                                c_j, prefix_len, decode_multi, page_size,
                                encoder_out)
            if a is not None:
                aux = add_aux(aux, torch.stack([a["load_balance"],
                                                a["router_z"]]))
        return x, aux

    remat = cfg.remat and cache is None and torch.is_grad_enabled()
    aux = None
    for sb in range(n_super):
        if remat:
            x, a = torch.utils.checkpoint.checkpoint(superblock, x, sb,
                                                     use_reentrant=False)
        else:
            x, a = superblock(x, sb)
        if a is not None:
            aux = add_aux(aux, a)
    if aux is None:
        aux = torch.zeros((2,), dtype=torch.float32, device=dev)
    x = L.norm_apply(x, params["final_norm"], cfg.norm, cfg.norm_eps)
    if last_only:
        if last_index is not None:
            i = int(last_index)
            x = x[:, i:i + 1]
        else:
            x = x[:, -1:]
    # a tied head reads the embedding table transposed, as a view: the
    # SA GEMM takes a K-contiguous W through its strides, so no step
    # copies the (padded_vocab, d_model) table
    head = params.get("lm_head")
    if head is None:
        head = embed.t()
    elif dims and dims["lm_head"] is not None:
        # gathered after `sa_dot`'s 16-bit input rounding, which the
        # kernel would make anyway: half the bytes, the same bits both
        # ways (the cotangent reaching the gather is rounded as the
        # cast's backward rounds it)
        head = _take(head, dims["lm_head"], dgroup, input_dtype())
    x2 = x.reshape(-1, cfg.d_model)
    v0 = 0                  # the first vocabulary column of the logits
    if head.shape[1] != cfg.padded_vocab:   # vocabulary-parallel head
        from repro_torch.parallel import collectives as C
        x2, v0 = C.copy_to_model(x2, group), tp_rank * head.shape[1]
    logits = sa_dot(x2, head).reshape(x.shape[0], x.shape[1], head.shape[1])
    logits = L.softcap(logits.to(torch.float32), cfg.final_softcap)
    if cfg.padded_vocab != cfg.vocab_size:   # mask padding logits
        valid = (torch.arange(head.shape[1], device=dev) + v0
                 < cfg.vocab_size)
        logits = torch.where(valid, logits, float("-inf"))
    if cache is not None and head.shape[1] != cfg.padded_vocab:
        # served logits reach the engine whole: its picks and argmaxes
        # read the global vocabulary on every rank
        from repro_torch.parallel import collectives as C
        logits = C.all_gather(logits, -1, group)
    return logits, cache, {"load_balance": aux[0], "router_z": aux[1]}


def _embed(embed, tokens, cfg: ArchConfig, group, tp_rank: int,
           data_group=None):
    """The token lookup, cast to bf16. A vocabulary-parallel table (this
    rank's rows) looks up the tokens it holds, zeros for the others, and
    the ranks' rows are summed (one of them nonzero: exact). `data_group`:
    the table's columns are cut over that data group (FSDP), and each row
    is made whole by `collectives.lookup_over_data`, the same bits as a
    lookup in the whole table."""
    from repro_torch.parallel import collectives as C

    def lookup(i):
        return embed[i] if data_group is None else C.lookup_over_data(
            embed, i, data_group)

    if embed.shape[0] == cfg.padded_vocab:
        return lookup(tokens.long()).to(torch.bfloat16)
    n = embed.shape[0]
    t = tokens.long() - tp_rank * n
    mine = (t >= 0) & (t < n)
    rows = torch.where(mine[..., None], lookup(t.clamp(0, n - 1)), 0.0)
    return C.reduce_from_model(rows, group).to(torch.bfloat16)


def lm_loss(params, cfg: ArchConfig, tokens, labels,
            aux_weight: float = 0.01, frontend_embeds=None):
    """Next-token cross-entropy (fp32 logsumexp minus the gold logit,
    mean) plus `aux_weight` times the MoE aux losses → (loss, nll). The
    aux losses are zero for the dense family, so there loss == nll. A
    tied embedding's gradient is the lookup's scatter plus the head's
    dWᵀ, summed by autograd through the transposed view. A VLM's loss
    drops the prepended frontend rows' logits."""
    logits, _, aux = forward(params, cfg, tokens,
                             frontend_embeds=frontend_embeds)
    if cfg.family == "vlm" and frontend_embeds is not None:
        logits = logits[:, frontend_embeds.shape[1]:]
    if logits.shape[-1] != cfg.padded_vocab:
        lse, gold = _vocab_parallel_terms(logits, labels)
    else:
        lse = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    nll = torch.mean(lse - gold)
    return nll + aux_weight * (aux["load_balance"] + aux["router_z"]), nll


def _vocab_parallel_terms(logits, labels):
    """logsumexp and the gold logit of rows whose vocabulary is cut
    across the `model` axis (`logits`: this rank's columns): the row max
    by an all-reduce MAX (a constant of the gradient, as logsumexp's),
    the exp-sum by SUM, the gold logit by SUM of the one rank that holds
    its column (global column ids)."""
    import torch.distributed as dist

    from repro_torch.parallel import collectives as C

    _, group, tp_rank = L.tp_context()
    n = logits.shape[-1]
    m = C.all_reduce_(logits.detach().amax(dim=-1), group,
                      dist.ReduceOp.MAX)
    se = C.reduce_from_model(torch.exp(logits - m[..., None]).sum(-1), group)
    lab = labels.long() - tp_rank * n
    mine = (lab >= 0) & (lab < n)
    gold = torch.gather(logits, -1, lab.clamp(0, n - 1)[..., None])[..., 0]
    gold = C.reduce_from_model(torch.where(mine, gold, 0.0), group)
    return m + torch.log(se), gold
