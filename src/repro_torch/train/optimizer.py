"""AdamW with fp32 statistics, global-norm clipping and warmup+cosine
schedules, in the JAX package's (init, update) form and arithmetic
(`repro/train/optimizer.py`): the same fp32 operations in the same order
(bias correction at `count + 1`, decoupled weight decay on the fp32
master).

One difference, for memory: `update` writes the new parameters, μ and ν
in place (under `torch.no_grad`, a piece of a leaf at a time, two
temporaries of at most CHUNK elements) and returns the same tensors,
where the JAX package returns new arrays. At full width a second copy of 2.7 B fp32
parameters and their two moments would not fit the card.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, NamedTuple

import torch

from repro_torch.models.model import tree_leaves, tree_map

_F32 = torch.float32


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=_F32)


def warmup_cosine(peak_lr: float, warmup_steps: int, total_steps: int,
                  final_frac: float = 0.1) -> Callable:
    """Linear warmup to `peak_lr`, then cosine decay to final_frac·peak;
    fp32 scalars, as the JAX schedule computes them."""
    def schedule(step):
        step = _f32(step)
        warm = peak_lr * step / max(warmup_steps, 1)
        prog = torch.clip((step - warmup_steps)
                          / max(total_steps - warmup_steps, 1), 0.0, 1.0)
        cos = peak_lr * (final_frac + (1 - final_frac)
                         * 0.5 * (1 + torch.cos(_f32(math.pi) * prog)))
        return torch.where(step < warmup_steps, warm, cos)
    return schedule


def constant_lr(lr: float) -> Callable:
    return lambda step: _f32(lr)


CHUNK = 1 << 26   # elements an update step works on at a time


def _chunks(*trees):
    """The leaves (p, m, v, g), each cut along dim 0 into views of at
    most about CHUNK elements: the update is elementwise, so the pieces
    give the whole leaf's bits with smaller temporaries."""
    for leaves in zip(*trees):
        p = leaves[0]
        rows = max(1, CHUNK // max(1, p[0].numel())) if p.dim() else 1
        if p.dim() == 0 or rows >= p.shape[0]:
            yield leaves
            continue
        for i in range(0, p.shape[0], rows):
            yield tuple(x[i:i + rows] for x in leaves)


class AdamWState(NamedTuple):
    count: torch.Tensor   # int32 scalar
    mu: dict
    nu: dict


@dataclasses.dataclass(frozen=True)
class AdamW:
    schedule: Callable
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0

    def init(self, params) -> AdamWState:
        def z(p):
            return torch.zeros(p.shape, dtype=_F32, device=p.device)
        return AdamWState(count=torch.zeros((), dtype=torch.int32),
                          mu=tree_map(z, params),
                          nu=tree_map(z, params))

    @torch.no_grad()
    def update(self, grads, state: AdamWState, params, sq_sum=None):
        """One step on the gradient tree `grads` (same structure as
        `params`; each leaf is scaled in place by the clip). Returns
        (params, state, {"grad_norm", "lr"}), the first two updated in
        place. `sq_sum(squares)` takes each leaf's fp32 sum of squares,
        in `tree_leaves` order, to the global tree's (default: their sum,
        one process). On a mesh, where a rank holds pieces of the global
        leaves, the caller's `sq_sum` counts each element of the global
        tree once and gives every rank the same total, so every rank
        clips by the same scale (`train.step.make_train_step`)."""
        gs = [g.to(_F32) for g in tree_leaves(grads)]
        ps, ms, vs = (tree_leaves(t) for t in (params, state.mu, state.nu))
        # global-norm clip
        sq = [torch.sum(g * g) for g in gs]
        gnorm = torch.sqrt(sum(sq) if sq_sum is None else sq_sum(sq))
        if self.clip_norm:
            scale = torch.minimum(
                _f32(1.0).to(gnorm.device),
                self.clip_norm / torch.clamp_min(gnorm, 1e-12))
        count = state.count + 1
        b1, b2 = self.b1, self.b2
        c = count.to(_F32)
        bc1 = float(1 - _f32(b1) ** c)
        bc2 = float(1 - _f32(b2) ** c)
        lr = self.schedule(count)
        lr_f = float(lr)
        for p, m, v, g in _chunks(ps, ms, vs, gs):
            # the JAX update's fp32 operations in its order, in place where
            # that changes no bit: two temporaries of at most a chunk
            if self.clip_norm:
                g.mul_(scale)
            m.mul_(b1).add_(g.mul(1 - b1))
            t = g.mul(1 - b2)
            v.mul_(b2).add_(t.mul_(g))
            upd = m.div(bc1)
            t = v.div(bc2)
            upd.div_(t.sqrt_().add_(self.eps))
            del t
            upd.add_(p.to(_F32).mul(self.weight_decay))
            if p.dtype == _F32:
                p.sub_(upd.mul_(lr_f))
            else:
                p.copy_((p.to(_F32) - lr_f * upd).to(p.dtype))
        return (params, AdamWState(count=count, mu=state.mu, nu=state.nu),
                {"grad_norm": gnorm, "lr": lr})
