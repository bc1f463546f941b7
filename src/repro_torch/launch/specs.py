"""Every (arch x shape) cell's step and this rank's arguments on the meta
device: the counterpart of the JAX package's `repro/launch/specs.py`.

`input_specs(cfg, shape, mesh)` returns the step function the cell runs
(`train_step`, `prefill` or `serve_step`, train/step.py) and the
arguments one rank of `mesh` holds, as meta tensors of their per-rank
shapes and types: the parameters (`model.init_params(mesh=,
device="meta")`: the rank's pieces by `sharding.param_specs`), the AdamW
state, the rank's rows of the batch (`sharding.data_specs`), the cache
(`model.init_cache(kv_pad_to=, kv_shards=, data_shards=)`, the
`cache_specs` piece), the positions and the frontend embeddings. Nothing
is allocated on a device. `mesh` is a `DeviceMesh` (the dry run's, over
the `fake` backend: `parallel.mesh.make_dry_mesh`), whose coordinates
pick the rank.

Where the port's layout departs from the JAX cell's, on purpose:

* a paged pool keeps a trash page a data shard (`pool_pages_for`, the
  serve engine's rule), where JAX rounds one pool's up to the data axes;
  at a batch the data axes divide the two give the same pages a rank;
* the SSM state and conv tail stay whole over `model` (the Mamba2 mixer's
  gather layout, `ssm._tp_mixer_params`), where JAX cuts them;
* a paged pool at a batch the data axes do not divide (paged
  `long_500k`) is refused by `model.check_parallel`: its pages would split
  a slot's sequence across ranks;
* a VLM's decode cell takes no frontend (ROADMAP F8: the port's decode of
  a VLM reads no patches; the JAX serve step would prepend them to the
  one token).
"""
from __future__ import annotations

import torch

from repro_torch.models import model as M
from repro_torch.models.config import ArchConfig, ShapeCfg
from repro_torch.parallel import sharding as S
from repro_torch.parallel.mesh import axis_sizes
from repro_torch.train.optimizer import AdamW, warmup_cosine
from repro_torch.train.step import (make_prefill_step, make_serve_step,
                                    make_train_step)
from repro_torch.train.train_state import TrainState

DEFAULT_PAGE_SIZE = 64


def default_optimizer(total_steps: int = 100_000) -> AdamW:
    return AdamW(schedule=warmup_cosine(3e-4, 2000, total_steps))


def accum_steps_for(cfg: ArchConfig, shape: ShapeCfg, mesh) -> int:
    """Microbatch count: target about 2 sequences a DP group a
    microstep."""
    per_dp = max(1, shape.global_batch // S.batch_count(mesh))
    return max(1, per_dp // 2)


def cell_is_applicable(cfg: ArchConfig, shape: ShapeCfg) -> tuple[bool, str]:
    """long_500k is skipped for pure full-attention archs."""
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return False, ("pure full-attention arch: 500k decode cell skipped "
                       "(DESIGN.md §5)")
    return True, ""


def pool_pages_for(mesh, batch: int, seq_len: int, page_size: int) -> int:
    """Pages of a decode cell's pool, the serve engine's rule: D·(⌈(B/D)·T
    / page⌉ + 1) over D data ranks (D dividing B), each shard its slots'
    ring-equivalent pages and its own trash page. The JAX rule,
    ⌈(⌈B·T/page⌉ + 1) / D⌉·D, keeps one trash page for the whole pool and
    rounds up to split over D; where B·T/page splits over D the two give
    the same pages a rank."""
    dp = S.batch_count(mesh)
    rows = batch // dp if batch % dp == 0 else batch
    return dp * (-(-rows * seq_len // page_size) + 1)


def _frontend(cfg: ArchConfig, batch: int):
    if cfg.family == "vlm" or cfg.is_encdec:
        return torch.empty((batch, cfg.frontend_tokens, cfg.d_model),
                           dtype=torch.float32, device="meta")
    return None


def _rows(mesh, shape_) -> tuple:
    """The per-rank shape of a batch leaf (`data_specs`)."""
    spec = S.data_specs(mesh, shape_)
    return S.shard_shape(shape_, spec, mesh)


def serve_shards(cfg: ArchConfig, batch: int, mesh) -> dict:
    """`init_cache`'s sharding arguments for a rank: KV heads padded to and
    split over `model`; slots over the batch axes where they divide the
    batch, else every ring's rows over `data` alone (`cache_specs`)."""
    sizes = axis_sizes(mesh)
    tp, dp = sizes["model"], S.batch_count(mesh)
    return {"kv_pad_to": tp, "kv_shards": tp,
            "data_shards": dp if batch % dp == 0 else sizes["data"]}


def input_specs(cfg: ArchConfig, shape: ShapeCfg, mesh,
                accum: int | None = None, kv_layout: str = "ring",
                page_size: int = DEFAULT_PAGE_SIZE):
    """→ (step_fn, args): the cell's step and this rank's meta arguments
    (see the module's docstring). `kv_layout="paged"` gives a decode cell
    a paged pool (`pool_pages_for` pages of `page_size`) in place of
    per-slot rings. Raises ValueError for a layout `model.check_parallel`
    refuses."""
    GB, T = shape.global_batch, shape.seq_len
    sizes = axis_sizes(mesh)
    tp, dp = sizes["model"], S.batch_count(mesh)
    if cfg.fsdp:
        # the FSDP gathers' dims, worked out once a config and mesh from a
        # whole meta tree: here, not inside the counted step
        M._data_dim_tree(cfg, S.axis_names(mesh), tuple(mesh.shape))
    if kv_layout not in ("ring", "paged"):
        raise ValueError(f"kv_layout={kv_layout!r}; want 'ring' or 'paged'")
    fe = _frontend(cfg, GB)
    if fe is not None:
        fe = torch.empty(_rows(mesh, fe.shape), dtype=fe.dtype,
                         device="meta")

    if shape.kind == "train":
        opt = default_optimizer()
        accum = accum or accum_steps_for(cfg, shape, mesh)
        params = M.init_params(cfg, device="meta", dtype=torch.float32,
                               mesh=mesh)
        for p in M.tree_leaves(params):
            p.requires_grad_(True)
        state = TrainState(step=torch.zeros((), dtype=torch.int32),
                           params=params, opt_state=opt.init(params))
        rows = _rows(mesh, (GB, T))
        batch = {"tokens": torch.empty(rows, dtype=torch.int32,
                                       device="meta"),
                 "labels": torch.empty(rows, dtype=torch.int32,
                                       device="meta")}
        if fe is not None:
            batch["frontend"] = fe
        step = make_train_step(cfg, opt, accum, mesh=mesh)
        return step, (state, batch)

    # serving cells: bf16 parameters; the cache's KV heads padded to the
    # model axis
    paged = kv_layout == "paged" and shape.kind == "decode"
    M.check_parallel(cfg, tp, dp, serving=True, batch=GB,
                     kv_layout="paged" if paged else "ring")
    params = M.init_params(cfg, device="meta", dtype=torch.bfloat16,
                           mesh=mesh)
    cache = M.init_cache(
        cfg, GB, T, dtype=torch.bfloat16, device="meta",
        paged=((pool_pages_for(mesh, GB, T, page_size), page_size)
               if paged else None), **serve_shards(cfg, GB, mesh))
    if shape.kind == "prefill":
        tokens = torch.empty(_rows(mesh, (GB, T)), dtype=torch.int32,
                             device="meta")
        return (make_prefill_step(cfg),
                (params, tokens, cache) + ((fe,) if fe is not None else ()))
    if shape.kind == "decode":
        token = torch.empty(_rows(mesh, (GB, 1)), dtype=torch.int32,
                            device="meta")
        pos = torch.empty(_rows(mesh, (GB,)), dtype=torch.int32,
                          device="meta")
        if cfg.family == "vlm":
            fe = None
        return (make_serve_step(cfg, page_size),
                (params, token, cache, pos)
                + ((fe,) if fe is not None else ()))
    raise ValueError(shape.kind)


def handoff_specs(cfg: ArchConfig, shape: ShapeCfg, mesh,
                  page_size: int = DEFAULT_PAGE_SIZE):
    """The two-pool handoff against a decode cell's paged pool: the page
    scatter and block-table bind of a batch-1 fragment of one full-length
    prompt (`ServeEngine._insert_impl`, which the two-pool engine splits
    across its pools) into this rank's first slot, the fragment on the
    rank's KV heads (as `ServeEngine.new_frag` builds it) and whole over
    the data axes, the pages this data shard's. → (step_fn, args)."""
    from repro_torch.serve.engine import ServeEngine

    GB, T = shape.global_batch, shape.seq_len
    pages = pool_pages_for(mesh, GB, T, page_size)
    shards = serve_shards(cfg, GB, mesh)
    cache = M.init_cache(cfg, GB, T, dtype=torch.bfloat16, device="meta",
                         paged=(pages, page_size), **shards)
    cap = -(-T // page_size) * page_size
    frag = M.init_cache(cfg, 1, cap, dtype=torch.bfloat16, device="meta",
                        kv_pad_to=shards["kv_pad_to"],
                        kv_shards=shards["kv_shards"])
    r = S.batch_index(mesh)
    slot = r * (GB // shards["data_shards"])
    block_row = torch.empty((cap // page_size,), dtype=torch.int32,
                            device="meta")
    base = r * (pages // shards["data_shards"])

    def handoff(cache, frag, block_row):
        return ServeEngine._insert_impl(cache, frag, slot, block_row, 0,
                                        base, 0)

    return handoff, (cache, frag, block_row)
