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


def init_state(cfg: ArchConfig, opt: AdamW, *, seed: int = 0,
               device=None) -> TrainState:
    """Fresh fp32 masters from `seed` (a `torch.Generator`, see
    `model.init_params`) and a zero AdamW state."""
    params = M.init_params(cfg, seed=seed, device=device,
                           dtype=torch.float32)
    for p in M.tree_leaves(params):
        p.requires_grad_(True)
    return TrainState(step=torch.zeros((), dtype=torch.int32),
                      params=params, opt_state=opt.init(params))
