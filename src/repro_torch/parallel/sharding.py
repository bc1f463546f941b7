"""Sharding rules, the port of the JAX package's `repro/parallel/
sharding.py`: which dims of each parameter, cache and batch leaf are cut
across which mesh axes, and the two moves between a full tree and a
rank's slice of it (`shard_tree`, `gather_tree`).

Axes: `model` = TP/EP (attention heads, FFN width, experts, vocab);
`data` (+ `pod` when present) = DP, and FSDP too for archs flagged
`fsdp=True`. Scan-stacked superblock leaves (under `layers`) carry a
leading block dim, so their specs are prepended with None. A dim the
axis does not divide is replicated (the divisibility guard: the reduced
configs' vocabulary of 503, granite's 40 experts over 16).

Under FSDP `data_dim` names the dim of a leaf that the data axes cut
(the forward gathers the leaf over it, `models/model.py`), and
`counts_once` which rank's piece enters a sum over the whole mesh that
must take each element once (the clip's global norm).

A spec is a `P`: a tuple with one entry a dim, None (replicated), an axis
name or a tuple of names. The rules read a mesh's axis names and sizes
only (a `mesh.MeshSpec` or a `DeviceMesh`). The JAX package's
`constrain` has no counterpart: the port's model code calls its
collectives explicitly (`parallel/collectives.py`), so there is no layout
to pin.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.models.config import ArchConfig
from .mesh import axis_names, axis_sizes


class P(tuple):
    """A PartitionSpec: one entry a dim (None, an axis name or a tuple of
    axis names; a tuple of one name is that name, as JAX's)."""

    def __new__(cls, *axes):
        return super().__new__(cls, (
            a[0] if isinstance(a, tuple) and len(a) == 1 else a
            for a in axes))

    def __repr__(self):
        return f"P{tuple.__repr__(self)}"


def batch_axes(mesh) -> tuple[str, ...]:
    return ("pod", "data") if "pod" in axis_names(mesh) else ("data",)


# ---------------------------------------------------------------------------
# the active mesh: the model code reads the tensor-parallel axis from it
# ---------------------------------------------------------------------------

_ACTIVE_MESH = None


def set_active_mesh(mesh):
    """Register the mesh the model code runs under (None: one process, no
    collective)."""
    global _ACTIVE_MESH
    _ACTIVE_MESH = mesh


def active_mesh():
    return _ACTIVE_MESH


def axis_count(name: str) -> int:
    if _ACTIVE_MESH is None or name not in axis_names(_ACTIVE_MESH):
        return 1
    return axis_sizes(_ACTIVE_MESH)[name]


def axis_group(name: str):
    """The process group of this rank's line along axis `name`."""
    return _ACTIVE_MESH.get_group(name)


def axis_index(name: str) -> int:
    """This rank's index along axis `name` (0 without a mesh)."""
    if _ACTIVE_MESH is None or name not in axis_names(_ACTIVE_MESH):
        return 0
    return _ACTIVE_MESH.get_local_rank(name)


class using_mesh:
    """Run a block under `mesh` as the active mesh, restoring the one
    before."""

    def __init__(self, mesh):
        self.mesh = mesh

    def __enter__(self):
        self.prev = _ACTIVE_MESH
        set_active_mesh(self.mesh)
        return self.mesh

    def __exit__(self, *exc):
        set_active_mesh(self.prev)


# ---------------------------------------------------------------------------
# the batch axes together: ("data",), or ("pod", "data") pod-major
# ---------------------------------------------------------------------------

_BATCH_GROUPS: dict = {}


def _mesh_or_active(mesh):
    return _ACTIVE_MESH if mesh is None else mesh


def batch_count(mesh=None) -> int:
    """The data-parallel ranks of `mesh` (default the active mesh): the
    batch axes' sizes multiplied; 1 without a mesh."""
    mesh = _mesh_or_active(mesh)
    if mesh is None:
        return 1
    sizes = axis_sizes(mesh)
    n = 1
    for a in batch_axes(mesh):
        n *= sizes[a]
    return n


def batch_index(mesh=None) -> int:
    """This rank's index over the batch axes, pod-major (the order in
    which the JAX `P(("pod", "data"))` lays out shards, and `shard_leaf`
    cuts them); 0 without a mesh."""
    mesh = _mesh_or_active(mesh)
    if mesh is None:
        return 0
    sizes = axis_sizes(mesh)
    idx = 0
    for a in batch_axes(mesh):
        idx = idx * sizes[a] + mesh.get_local_rank(a)
    return idx


def batch_group(mesh=None):
    """The process group of this rank's line over the batch axes: the
    `data` axis's group, or on a mesh with a `pod` axis the ("pod",
    "data") sub-mesh flattened, pod-major (made once a mesh, by every
    rank at its first call)."""
    mesh = _mesh_or_active(mesh)
    if "pod" not in axis_names(mesh):
        return mesh.get_group("data")
    key = id(mesh)
    if key not in _BATCH_GROUPS:
        _BATCH_GROUPS[key] = (mesh, mesh["pod", "data"]._flatten()
                              .get_group())
    return _BATCH_GROUPS[key][1]


def mesh_coords(mesh) -> dict:
    """This rank's index along every axis of a `DeviceMesh`."""
    return {a: mesh.get_local_rank(a) for a in axis_names(mesh)}


# ---------------------------------------------------------------------------
# trees: nested dicts, tuples, lists and NamedTuples (the caches)
# ---------------------------------------------------------------------------

def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def tree_map_with_path(fn, tree, *rest, path=(), is_leaf=None):
    """fn(path, leaf, *rest_leaves) over the leaves of `tree` (None is no
    leaf); `path` is the tuple of dict keys, sequence indices and
    NamedTuple field names, as the JAX package's key paths."""
    if is_leaf is not None and is_leaf(tree):
        return fn(path, tree, *rest)
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, *(r[k] for r in rest),
                                      path=path + (k,), is_leaf=is_leaf)
                for k, v in tree.items()}
    if _is_namedtuple(tree):
        return type(tree)(*(
            tree_map_with_path(fn, v, *(r[i] for r in rest),
                               path=path + (f,), is_leaf=is_leaf)
            for i, (f, v) in enumerate(zip(tree._fields, tree))))
    if isinstance(tree, (tuple, list)):
        return type(tree)(
            tree_map_with_path(fn, v, *(r[i] for r in rest),
                               path=path + (i,), is_leaf=is_leaf)
            for i, v in enumerate(tree))
    return None if tree is None else fn(path, tree, *rest)


def _path_str(path) -> str:
    return "/".join(str(k) for k in path)


def _fit(spec, shape, sizes) -> P:
    """Replicate every dim its axis does not divide."""
    def n(a):
        if a is None:
            return 1
        out = 1
        for x in (a if isinstance(a, tuple) else (a,)):
            out *= sizes[x]
        return out
    return P(*(a if d % n(a) == 0 else None for a, d in zip(spec, shape)))


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------

def expert_layout(cfg: ArchConfig, tp: int) -> str:
    """How a `model` axis of `tp` ranks holds a MoE layer's expert stacks,
    as `_param_rule` and its divisibility guard cut them: "ep" where the
    axis divides the expert count (a rank holds E/tp experts whole), "tp"
    where it divides only d_ff (every expert cut by its d_ff columns and
    rows), "whole" in one process and where it divides neither."""
    if tp > 1 and cfg.num_experts % tp == 0:
        return "ep"
    if tp > 1 and cfg.d_ff % tp == 0:
        return "tp"
    return "whole"


def _param_rule(path: str, ndim: int, cfg: ArchConfig, fsdp,
                model_size: int) -> P:
    """PartitionSpec for one (unstacked) parameter leaf."""
    f = fsdp if cfg.fsdp else None
    # at model 1 the axis cuts nothing either way; JAX names it on E there
    ep = cfg.num_experts > 0 and (
        model_size == 1 or expert_layout(cfg, model_size) == "ep")
    # modality-agnostic rules, most-specific first
    if "embed" in path:
        return P("model", f)
    if "lm_head" in path:
        return P(f, "model")
    if any(k in path for k in ("wq", "wk", "wv", "wg", "wu", "w1")):
        if ndim == 3:                       # stacked experts (E, D, F)
            # EP when expert count divides the TP axis, else TP inside expert
            return P("model", f, None) if ep else P(None, f, "model")
        return P(f, "model")
    if any(k in path for k in ("wo", "wd", "w2")):
        if ndim == 3:                       # experts (E, F, D)
            return P("model", None, f) if ep else P(None, "model", f)
        return P("model", f)
    if "router" in path:
        return P(f, None)
    if any(k in path for k in ("bq", "bk", "bv")):
        return P("model")
    if "in_proj" in path:
        return P(f, "model")
    if "out_proj" in path:
        return P("model", f)
    if "conv_w" in path:
        return P(None, "model")
    if any(k in path for k in ("A_log", "dt_bias")):
        return P("model")
    if any(k in path for k in ("D_skip", "norm_w")):
        return P("model")
    return P()  # norms, scalars: replicated


def param_specs(cfg: ArchConfig, params_tree: Any, mesh):
    """The P tree matching `params_tree` (any leaves with a `.shape`:
    tensors, meta tensors)."""
    ba = batch_axes(mesh)
    fsdp = ba if len(ba) > 1 else ba[0]
    sizes = axis_sizes(mesh)

    def spec_for(path, leaf):
        ps = _path_str(path)
        stacked = "layers" in ps            # scan-stacked: leading block dim
        shape = tuple(leaf.shape)
        nd = len(shape) - (1 if stacked else 0)
        rule = tuple(_param_rule(ps, nd, cfg, fsdp, sizes["model"]))
        if stacked:
            rule = (None, *rule)
        # pad/trim to the leaf rank (biases, scalars)
        rule = rule[:len(shape)] + (None,) * (len(shape) - len(rule))
        return _fit(rule, shape, sizes)

    return tree_map_with_path(spec_for, params_tree)


# ---------------------------------------------------------------------------
# batches and caches
# ---------------------------------------------------------------------------

def data_specs(mesh, tokens_shape: tuple[int, ...]) -> P:
    """Input token sharding: batch over the DP axes (global batch
    permitting)."""
    ba = batch_axes(mesh)
    sizes = axis_sizes(mesh)
    dp = 1
    for a in ba:
        dp *= sizes[a]
    if tokens_shape[0] % dp == 0:
        return P(ba, *([None] * (len(tokens_shape) - 1)))
    return P(*([None] * len(tokens_shape)))


def _kv_head_specs(kvh: int, sizes):
    """Padded caches shard on heads; unpadded fall back to the head dim."""
    if kvh % sizes.get("model", 1) == 0:
        return "model", None
    return None, "model"


def cache_specs(cfg: ArchConfig, cache_tree: Any, mesh, batch: int):
    """KV/SSM cache sharding for serving: batch over the DP axes where the
    batch divides, else the KV sequence dim over `data` (sequence
    parallelism, the long-context cell); a paged pool shards its page dim
    over the DP axes and KV heads over `model`, its block table
    replicated. The JAX package's rules on the port's cache tree."""
    from repro_torch.models.layers import PagedKVCache

    ba = batch_axes(mesh)
    sizes = axis_sizes(mesh)
    dp = 1
    for a in ba:
        dp *= sizes[a]
    batch_ok = batch % dp == 0

    def spec_for(path, leaf):
        if isinstance(leaf, PagedKVCache):
            kv_spec, hd_spec = _kv_head_specs(leaf.k.shape[3], sizes)
            pool = (None, ba, None, kv_spec, hd_spec)
            return PagedKVCache(
                k=_fit(pool, leaf.k.shape, sizes),
                v=_fit(pool, leaf.v.shape, sizes),
                positions=_fit((None, ba, None), leaf.positions.shape,
                               sizes),
                block_table=P(None, None, None))
        ps = _path_str(path)
        nd = len(leaf.shape)
        if ps.endswith("positions"):
            if nd == 3:
                if batch_ok:
                    return _fit((None, ba, None), leaf.shape, sizes)
                return _fit((None, None, "data"), leaf.shape, sizes)
            return P(*([None] * nd))
        if "ssm" in ps:
            if nd == 5:   # state: (n_super, B, H, P, N): TP on head dim P
                return _fit((None, ba if batch_ok else None, None, "model",
                             None), leaf.shape, sizes)
            if nd == 4:   # conv tail: (n_super, B, KW-1, conv_dim)
                return _fit((None, ba if batch_ok else None, None, "model"),
                            leaf.shape, sizes)
            return P(*([None] * nd))
        if nd == 5:       # k/v: (n_super, B, S, KVH, hd)
            kv_spec, hd_spec = _kv_head_specs(leaf.shape[3], sizes)
            if batch_ok:
                return _fit((None, ba, None, kv_spec, hd_spec), leaf.shape,
                            sizes)
            return _fit((None, None, "data", kv_spec, hd_spec), leaf.shape,
                        sizes)
        return P(*([None] * nd))

    return tree_map_with_path(
        spec_for, cache_tree, is_leaf=lambda x: isinstance(x, PagedKVCache))


def handoff_frag_specs(cfg: ArchConfig, frag_tree: Any, mesh):
    """Specs of a dense batch-1 prefill fragment handed off to a paged
    pool (disaggregated serving): KV heads over `model` as the pool's
    (`cache_specs`), the token dim replicated over the data axes (a
    fragment's whole pages scatter to any page shard)."""
    from repro_torch.models.layers import KVCache

    sizes = axis_sizes(mesh)

    def spec_for(path, leaf):
        if isinstance(leaf, KVCache):
            kv_spec, hd_spec = _kv_head_specs(leaf.k.shape[3], sizes)
            kv = (None, None, None, kv_spec, hd_spec)
            return KVCache(k=_fit(kv, leaf.k.shape, sizes),
                           v=_fit(kv, leaf.v.shape, sizes),
                           positions=P(None, None, None))
        return P(*([None] * len(leaf.shape)))

    return tree_map_with_path(spec_for, frag_tree,
                              is_leaf=lambda x: isinstance(x, KVCache))


def reshard_handoff(frag: Any, mesh, cfg: ArchConfig):
    """This rank's piece (`handoff_frag_specs`) of a whole prefill
    fragment: the page-handoff move of the JAX package's two-pool serve
    loop (`reshard_handoff`, a `device_put` there), for a fragment built
    on every KV head (`init_cache(kv_pad_to=)` without `kv_shards`). The
    identity without a mesh. The serve engine does not need it: its
    fragments are born on the rank's heads (`ServeEngine.new_frag`)."""
    if mesh is None:
        return frag
    return shard_tree(frag, handoff_frag_specs(cfg, frag, mesh), mesh)


# ---------------------------------------------------------------------------
# a full tree and a rank's slice of it
# ---------------------------------------------------------------------------

def _entry_index(entry, coords, sizes):
    """(parts, index) of a spec entry: the axes' sizes multiplied, and
    this rank's row-major index over them."""
    parts, idx = 1, 0
    for a in (entry if isinstance(entry, tuple) else (entry,)):
        parts, idx = parts * sizes[a], idx * sizes[a] + coords[a]
    return parts, idx


def shard_shape(shape, spec, mesh) -> tuple:
    """The shape of a rank's slice of a leaf of `shape` cut by `spec`."""
    sizes = axis_sizes(mesh)
    return tuple(d if e is None else d // _entry_index(
        e, dict.fromkeys(sizes, 0), sizes)[0] for d, e in zip(shape, spec))


def shard_leaf(x: torch.Tensor, spec, mesh, coords) -> torch.Tensor:
    """This rank's slice of the full leaf `x` (a copy, so the full leaf
    can be freed)."""
    sizes = axis_sizes(mesh)
    out = x.detach()
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        parts, idx = _entry_index(entry, coords, sizes)
        n = out.shape[dim] // parts
        out = out.narrow(dim, idx * n, n)
    return out.clone()


def shard_tree(tree, specs, mesh, coords=None):
    """Cut this rank's slice of every leaf of a full tree. `coords`: the
    rank's index along each axis (default: the mesh's own)."""
    coords = mesh_coords(mesh) if coords is None else coords
    return tree_map_with_path(
        lambda _, x, s: shard_leaf(x, s, mesh, coords), tree, specs)


def gather_leaf(x: torch.Tensor, spec, mesh) -> torch.Tensor:
    """The full leaf from every rank's slice (`collectives.all_gather`
    along each sharded dim); every rank of the mesh must call it."""
    from .collectives import all_gather

    out = x.detach()
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        if isinstance(entry, tuple):
            if set(entry) != set(batch_axes(mesh)):
                raise ValueError(f"gather over the axes {entry} together "
                                 f"is not supported")
            group = batch_group(mesh)
        else:
            group = mesh.get_group(entry)
        out = all_gather(out, dim, group)
    return out


def gather_tree(tree, specs, mesh):
    """The inverse of `shard_tree`: every leaf whole, on every rank."""
    return tree_map_with_path(lambda _, x, s: gather_leaf(x, s, mesh),
                              tree, specs)


def spec_leaves(specs, tree=None) -> list:
    """The P leaves of a spec tree, in `model.tree_leaves`'s order of
    `tree` where given (its dicts may order their keys otherwise: a tree
    converted from numpy against one drawn by `init_params`)."""
    if tree is not None:
        specs = tree_map_with_path(lambda _, x, sp: sp, tree, specs)
    if isinstance(specs, P):
        return [specs]
    if isinstance(specs, dict):
        return [x for v in specs.values() for x in spec_leaves(v)]
    if isinstance(specs, (tuple, list)):
        return [x for v in specs for x in spec_leaves(v)]
    return []


def cut_axes(spec, mesh) -> set:
    """The axes of `mesh` that cut a leaf of `spec`: those an entry names
    whose size is above 1 (an FSDP config's `data` entries at data 1 cut
    nothing)."""
    sizes = axis_sizes(mesh)
    return {a for e in spec if e is not None
            for a in (e if isinstance(e, tuple) else (e,)) if sizes[a] > 1}


def data_dim(spec, mesh, sliced: bool = False):
    """The dim of a leaf of `spec` (a `param_specs` entry) that the data
    axes cut on `mesh` (FSDP; on a mesh with a `pod` axis the two
    together, `batch_group`), or None where they cut none. `sliced`: the
    dim in a superblock's slice `w[sb]` of a stacked leaf, whose leading
    (None) entry the slice drops. Read off the rules' spec alone, never
    off the leaf's shape."""
    data = set(batch_axes(mesh)) & cut_axes(spec, mesh)
    dims = [d for d, e in enumerate(spec) if e is not None and data & set(
        e if isinstance(e, tuple) else (e,))]
    if not dims:
        return None
    d = dims[0]
    e = spec[d]
    if (len(dims) > 1
            or isinstance(e, tuple) and not set(e) <= set(batch_axes(mesh))
            or (sliced and spec[0] is not None)):
        raise ValueError(f"{spec}: the data axes cut more than one dim, or "
                         f"one dim together with another axis")
    return d - 1 if sliced else d


def counts_once(spec, mesh, coords) -> bool:
    """Whether this rank's piece of a leaf of `spec` enters a sum over the
    whole mesh that takes every element of the leaf once (the clip's
    global norm): the rank at index 0 along every axis that does not cut
    the leaf holds the piece that its copies on the other ranks repeat."""
    cut = cut_axes(spec, mesh)
    return all(coords[a] == 0 for a in axis_names(mesh) if a not in cut)


def is_sharded(spec, mesh) -> bool:
    """Whether `spec` cuts its leaf on `mesh`: an entry whose axes all have
    size 1 cuts nothing (an FSDP config's `data` entries at data 1: the
    leaf is whole on every rank)."""
    return bool(cut_axes(spec, mesh))
