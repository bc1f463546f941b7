"""Train state: step, fp32 masters, AdamW state."""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch.models.config import ArchConfig
from repro_torch.models import model as M
from .optimizer import AdamW, AdamWState


class TrainState(NamedTuple):
    step: torch.Tensor   # int32 scalar
    params: Any          # fp32 masters, gradients on
    opt_state: AdamWState


def param_specs(cfg: ArchConfig, mesh):
    """The parameters' specs (`parallel.sharding.param_specs`) from the
    full tree's shapes (a meta-device tree: nothing is drawn)."""
    from repro_torch.parallel import sharding as S

    return S.param_specs(cfg, M.init_params(cfg, device="meta",
                                            dtype=torch.float32), mesh)


def state_specs(cfg: ArchConfig, mesh) -> TrainState:
    """Specs of a whole TrainState: the step and the AdamW count
    replicated, μ and ν as the parameters."""
    from repro_torch.parallel.sharding import P

    ps = param_specs(cfg, mesh)
    return TrainState(step=P(), params=ps,
                      opt_state=AdamWState(count=P(), mu=ps, nu=ps))


def init_state(cfg: ArchConfig, opt: AdamW, *, seed: int = 0,
               device=None, mesh=None) -> TrainState:
    """Fresh fp32 masters from `seed` (a `torch.Generator`, see
    `model.init_params`) and a zero AdamW state. Under a `mesh` every
    rank draws the same tree a matrix slice at a time and keeps its shard
    of each (`init_params(mesh=)`, `param_specs`), so a one-process run
    and a sharded one start from the same weights and no rank holds the
    whole tree; μ and ν take the shards' shapes."""
    params = M.init_params(cfg, seed=seed, device=device,
                           dtype=torch.float32, mesh=mesh)
    for p in M.tree_leaves(params):
        p.requires_grad_(True)
    return TrainState(step=torch.zeros((), dtype=torch.int32),
                      params=params, opt_state=opt.init(params))
