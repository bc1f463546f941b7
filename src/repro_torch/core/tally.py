"""Where a step tells the cost counters what it did beside its aten ops.

`launch/cost.py`'s `CostCounter` registers itself in `ACTIVE` while a
step runs under it. Three kinds of event reach it from here, each from
the one place that does the work:

* `kernel` — a kernel's meta route (`kernels/*.py`: a meta tensor gets a
  meta output and this record instead of a launch), with its route,
  tile, flops and compulsory bytes, keyed as `kernels.ops.counts()`,
  `route_counts()` and `tile_counts()` key the launches;
* `collective` — every collective of `parallel/collectives.py`, on any
  backend, by the class the nccl path issues and its payload (the
  largest tensor of the op);
* `attention` — the eager attention functions of `models/layers.py`
  (training's blockwise attention, the CPU decode), the function's work
  whatever implements it.

With no counter active each call returns at once.
"""
from __future__ import annotations

ACTIVE: list = []


def kernel(name: str, **kw):
    for c in ACTIVE:
        c.kernel(name, **kw)


def collective(cls: str, payload: int):
    for c in ACTIVE:
        c.collective(cls, payload)


def attention(flops: float):
    for c in ACTIVE:
        c.attention(flops)


def in_function():
    """A context under which the active counters take the aten ops as part
    of a function counted whole (`attention`): their bytes and launches
    count, their flops do not (the function's own count holds them)."""
    return _Inside()


class _Inside:
    def __enter__(self):
        for c in ACTIVE:
            c.depth += 1

    def __exit__(self, *exc):
        for c in ACTIVE:
            c.depth -= 1
