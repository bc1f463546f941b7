"""What one step costs, counted while it runs on meta tensors: the
counterpart of the JAX package's `repro/launch/hlo_cost.py`.

The JAX dry run compiles a cell and reads the optimized HLO. The port
runs eagerly, so it counts the step as it runs: `CostCounter` is a
context in which a step runs on the meta device (shapes and types,
nothing computed), and it sees three streams of events:

* the kernels' meta routes (`kernels/*.py` through `core/tally.py`): each
  launch the card would make, with the route and tile the CUDA dispatch
  would choose from the same shapes and types (the same planning
  functions run), its flops (2·M·N·K for the SA GEMM and fp_emu; 4·hd a
  visible (query, key) pair a query head for attention, the masks'
  causal, window and `q_offset` read by `sa_attention.visible_pairs`, a
  decode row's live keys from `decode_keys`) and its compulsory bytes
  (each operand read once and each output written once at its type; a
  decode kernel reads only the live pages);
* every other aten op (a `TorchDispatchMode`): the ops that would launch
  on the card (`host_ops`; views, allocations and metadata ops launch
  nothing), the bytes each moves as the port runs it eagerly
  (`eager_bytes`: operands and output; a gather-style read takes only
  what it outputs, an update-style write only what it writes), matmul
  flops by op (`torch.utils.flop_counter`'s formulas), and the live
  storages, for memory;
* the collectives of `parallel/collectives.py`: count and payload bytes
  by class, as the nccl path issues them.

Eager attention (training's `layers._Flash`) is counted as the function's
work too (4·hd a visible pair forward, 8·hd backward); its aten ops then
count their bytes and launches but not their flops.

Memory: the live total of the storages the step allocates, followed op
by op (a weakref finalizer on each storage says when it is freed, so a
tensor autograd keeps for the backward stays counted). `argument_bytes`
are the arguments' storages (a padded matrix's whole buffer),
`output_bytes` the storages the step returns that it allocated (a cache
updated in place is an argument, not an output), `temp_peak_bytes` the
largest live total of the other storages it allocated, and
`peak_estimate_bytes` the three summed, as the JAX dry run's
`memory_dict` sums them.

Kernel bytes and eager bytes are two counts, never merged: the first is
the kernels' compulsory traffic, the second what the eager ops around
them move as the port runs today.
"""
from __future__ import annotations

import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.core import tally

# ops that launch nothing and move no bytes (besides views): allocations
# and metadata
_FREE = {"empty", "empty_like", "empty_strided", "new_empty",
         "new_empty_strided", "_unsafe_view", "set_", "resize_",
         "_local_scalar_dense", "is_same_size", "result_type",
         "lift_fresh_copy", "_has_compatible_shallow_copy_type",
         "record_stream", "_to_copy_meta"}
# update-style writes: the bytes they write are the size of what they
# are given, not of the tensor they write into
_UPDATE = {"index_put_", "_index_put_impl_", "index_put", "scatter_",
           "scatter", "scatter_add_", "scatter_add", "scatter_reduce_",
           "index_copy_", "index_copy", "index_add_", "index_add",
           "index_fill_", "masked_scatter_", "slice_scatter",
           "select_scatter", "copy_"}
# gather-style reads: they read only what they output
_GATHER = {"index", "_unsafe_index", "index_select", "gather", "embedding",
           "take", "narrow_copy", "slice_copy", "select_copy"}
COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all")


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


_INFO: dict = {}


def _flat(xs) -> list:
    """The tensors of an op's arguments (or outputs): top level, and one
    level of lists (cat, stack)."""
    out = []
    for x in xs:
        if isinstance(x, torch.Tensor):
            out.append(x)
        elif isinstance(x, (list, tuple)):
            out.extend(y for y in x if isinstance(y, torch.Tensor))
    return out


def _op_bytes(name, mutates, ins, outs) -> int:
    """The bytes an eager op moves (see the module's docstring)."""
    if name in _UPDATE or (mutates and name.endswith("scatter_")):
        dst = ins[0] if mutates or name == "copy_" else outs[0]
        given = sum(_nbytes(t) for t in ins[1:])
        return given + min(_nbytes(dst), given)
    if mutates:                    # elementwise in place: read, write
        return 2 * _nbytes(ins[0]) + sum(_nbytes(t) for t in ins[1:])
    ob = sum(_nbytes(t) for t in outs)
    if name in _GATHER:
        return ob + sum(min(_nbytes(t), ob) for t in ins)
    return ob + sum(_nbytes(t) for t in ins)


def _tensors(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (list, tuple)):
        for y in x:
            yield from _tensors(y)
    elif isinstance(x, dict):
        for y in x.values():
            yield from _tensors(y)


def storage_bytes(tree) -> int:
    """The bytes of the distinct storages the tensors of `tree` (nested
    dicts, tuples, lists, NamedTuples) live in: what they hold on the
    device, a view's whole buffer once."""
    seen = {}
    for t in _tensors(tree):
        st = t.untyped_storage()
        seen[st._cdata] = st.nbytes()
    return sum(seen.values())


def _launch_keys():
    from repro_torch.kernels import ops
    return (list(ops.counts()), {k: list(v) for k, v in
                                 ops.route_counts().items()},
            list(ops.tile_counts()))


class CostCounter(TorchDispatchMode):
    """Count a step run inside the context (see the module's docstring).
    `decode_keys`: the keys each decode row sees live (the dry run's
    decode cell: every row at position T − 1 over a full cache of T); by
    default every key of its mapped pages."""

    def __init__(self, decode_keys: int | None = None):
        super().__init__()
        self.decode_keys = decode_keys
        names, routes, tiles = _launch_keys()
        self.launches = {n: 0 for n in names}
        self.routes = {k: {r: 0 for r in v} for k, v in routes.items()}
        self.tiles = {t: 0 for t in tiles}
        self.other: dict = {}          # launches beside ops.counts()'s
        self.flops_by: dict = {}
        self.kernel_bytes = 0
        self.eager_bytes = 0
        self.host_ops = 0
        self.coll = {c: 0 for c in COLLECTIVES}
        self.coll_counts = {c: 0 for c in COLLECTIVES}
        self.depth = 0                 # inside a function counted whole
        # memory: storage key -> (serial, bytes) while alive
        self._live: dict = {}
        self._external: set = set()
        self._events: list = []        # (serial, +bytes or -bytes)
        self._serial = 0

    # -- the context -----------------------------------------------------
    def __enter__(self):
        tally.ACTIVE.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        tally.ACTIVE.remove(self)
        return super().__exit__(*exc)

    # -- events from core/tally.py ----------------------------------------
    def kernel(self, name, *, route=None, tile=None, flops=0, nbytes=0,
               lse=False, decode=None):
        if decode is not None:
            flops, nbytes = self._decode_work(decode, lse)
        if name in self.launches:
            self.launches[name] += 1
            if name == "paged_decode" and lse:
                self.launches["paged_decode_lse"] += 1
            key = "sa_matmul" if name.startswith("sa_matmul") else name
            if route is not None and key in self.routes:
                self.routes[key][route] += 1
            if tile is not None and route in ("mma", "split3"):
                self.tiles[tile] += 1
        else:
            self.other[name] = self.other.get(name, 0) + 1
        if flops:
            self.flops_by[name] = self.flops_by.get(name, 0) + flops
        self.kernel_bytes += nbytes

    def _decode_work(self, d, lse):
        """(flops, bytes) of a paged decode launch: each row's live keys
        (`decode_keys`, capped by its mapped pages) and, under a window,
        the visible ones; the pages holding the visible keys read once."""
        psz, S = d["psz"], d["P"] * d["psz"]
        live = S if self.decode_keys is None else min(self.decode_keys, S)
        vis = min(live, d["window"]) if d["window"] else live
        pages = -(-live // psz) - (live - vis) // psz
        B, H, KVH, hd = d["B"], d["H"], d["KVH"], d["hd"]
        kv = B * pages * psz * (2 * KVH * hd * d["pool_bytes"] + 4)
        io = (2 * B * H * hd * 4 + B * d["P"] * 4 + B * 4
              + (B * H * 4 if lse else 0))
        return 4 * hd * H * B * vis, kv + io

    def collective(self, cls, payload):
        self.coll[cls] += payload
        self.coll_counts[cls] += 1

    def attention(self, flops):
        self.flops_by["attention"] = self.flops_by.get("attention", 0) + flops

    # -- the aten ops ------------------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        try:
            self._op(func, args, kwargs, out)
        except Exception as e:        # a counting fault must not pass
            raise RuntimeError(f"cost counter on {func}: {e}") from e
        return out

    def _info(self, func):
        """(name, launches?, mutates its first argument?, flop formula) of
        an op, worked out once."""
        info = _INFO.get(func)
        if info is None:
            from torch.utils.flop_counter import flop_registry

            name = func.overloadpacket.__name__
            schema = func._schema.arguments
            info = _INFO[func] = (
                name, func.namespace == "aten" and not func.is_view
                and name not in _FREE,
                bool(schema) and schema[0].alias_info is not None
                and schema[0].alias_info.is_write,
                flop_registry.get(func.overloadpacket))
        return info

    def _op(self, func, args, kwargs, out):
        ins = _flat(args)
        if kwargs:
            ins += _flat(tuple(kwargs.values()))
        outs = _flat((out,))
        if all(t.device.type == "cpu" for t in ins + outs):
            return                      # a host op (the step counter)
        for t in ins:
            self._seen(t)
        for t in outs:
            self._allocated(t)
        name, launches, mutates, flop = self._info(func)
        if not launches or not outs:
            return
        self.host_ops += 1
        self.eager_bytes += _op_bytes(name, mutates, ins, outs)
        if flop is not None and self.depth == 0:
            key = f"aten.{name}"
            self.flops_by[key] = self.flops_by.get(key, 0) + flop(
                *args, **kwargs, out_val=out)

    # -- memory ------------------------------------------------------------
    def _seen(self, t):
        if t.device.type == "cpu":
            return
        st = t.untyped_storage()
        key = st._cdata
        if key in self._live or key in self._external:
            return
        self._external.add(key)
        weakref.finalize(st, self._external.discard, key)

    def _allocated(self, t):
        if t.device.type == "cpu":
            return
        st = t.untyped_storage()
        key = st._cdata
        if key in self._live or key in self._external:
            return
        n = st.nbytes()
        self._serial += 1
        self._live[key] = (self._serial, n)
        self._events.append((self._serial, n))
        weakref.finalize(st, self._freed, key)

    def _freed(self, key):
        serial, n = self._live.pop(key)
        self._events.append((serial, -n))

    # -- the summary -------------------------------------------------------
    def memory(self, args, outputs) -> dict:
        """The memory fields of `summary` for a step that took `args` and
        returned `outputs` (still alive)."""
        outs = {}
        for t in _tensors(outputs):
            st = t.untyped_storage()
            if st._cdata in self._live:
                outs[self._live[st._cdata][0]] = st.nbytes()
        live = peak = 0
        for serial, n in self._events:
            if serial not in outs:
                live += n
                peak = max(peak, live)
        arg = storage_bytes(args)
        out = sum(outs.values())
        return {"argument_bytes": arg, "output_bytes": out,
                "temp_peak_bytes": peak,
                "peak_estimate_bytes": arg + out + peak}

    def summary(self, args=(), outputs=()) -> dict:
        flops = sum(self.flops_by.values())
        return {
            "flops": flops,
            "flops_by": dict(sorted(self.flops_by.items())),
            "kernel_bytes": self.kernel_bytes,
            "eager_bytes": self.eager_bytes,
            "launches": {"counts": dict(self.launches),
                         "routes": {k: dict(v)
                                    for k, v in self.routes.items()},
                         "tiles": dict(self.tiles),
                         "other": dict(self.other)},
            "host_ops": self.host_ops,
            "collectives": {"total": sum(self.coll.values()),
                            **self.coll, "counts": dict(self.coll_counts)},
            "memory": self.memory(args, outputs),
        }
