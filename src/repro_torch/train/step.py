"""Train and serve step factories.

`make_train_step` is the JAX package's training step: strided microbatch
gradient accumulation in fp32, remat inside the model's superblocks, AdamW
on fp32 masters. `make_prefill_step`, `make_bucketed_prefill_step` and
`make_serve_step` are the decode path's steps, `make_draft_step` and
`make_verify_step` self-speculative decoding's. PyTorch runs eagerly, so
each factory returns a plain function; the serve steps update the cache in
place and return it.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.models import model as M
from repro_torch.models.config import ArchConfig
from .optimizer import AdamW
from .train_state import TrainState


def make_grad_fn(cfg: ArchConfig, accum_steps: int = 1,
                 aux_weight: float = 0.01):
    """grad_fn(params, batch) → (loss, nll, grads), the gradient half of
    `make_train_step`; the loss is `M.lm_loss`'s, nll plus `aux_weight`
    times the MoE aux losses. `params` leaves require grad; their `.grad` is
    cleared, filled and returned as `grads` (the same tree of tensors,
    owned by the caller until the next call).

    batch: {"tokens": (B, T) int, "labels": (B, T) int, optional
    "frontend": (B, S, d) float, the modality stub's embeddings}. With
    accum_steps > 1, B must divide evenly; microbatches are strided (row j
    of microbatch i is row j·A + i, as the JAX step splits them; the
    frontend rows with their tokens), gradients accumulate in fp32 over
    them and are divided by A, and loss and nll are averaged."""

    def grad_fn(params, batch):
        leaves = M.tree_leaves(params)
        for p in leaves:
            p.grad = None
        if accum_steps == 1:
            loss, nll = M.lm_loss(params, cfg, batch["tokens"],
                                  batch["labels"], aux_weight,
                                  batch.get("frontend"))
            backward(loss, leaves)
            loss, nll = loss.detach(), nll.detach()
        else:
            def split(x, i):
                if x is None:
                    return None
                mb = x.shape[0] // accum_steps
                return x.reshape(mb, accum_steps, *x.shape[1:])[:, i]
            loss = nll = torch.zeros((), device=batch["tokens"].device)
            for i in range(accum_steps):
                l, n = M.lm_loss(params, cfg, split(batch["tokens"], i),
                                 split(batch["labels"], i), aux_weight,
                                 split(batch.get("frontend"), i))
                # .backward() adds into .grad (fp32): g1 + g2 + ...
                backward(l, leaves)
                loss, nll = loss + l.detach(), nll + n.detach()
            for p in leaves:
                p.grad.div_(accum_steps)
            loss, nll = loss / accum_steps, nll / accum_steps
        grads = M.tree_map(lambda p: p.grad, params)
        return loss, nll, grads

    def backward(loss, leaves):
        # a parameter the loss does not reach (an encoder-decoder's encoder
        # and cross-attention without a frontend) gets a zero gradient, as
        # jax.grad gives it
        loss.backward()
        for p in leaves:
            if p.grad is None:
                p.grad = torch.zeros_like(p)

    return grad_fn


def make_train_step(cfg: ArchConfig, opt: AdamW, accum_steps: int = 1,
                    aux_weight: float = 0.01, mesh=None, on_grads=None):
    """Returns train_step(state, batch) → (state, metrics), metrics the
    0-d tensors loss, nll, grad_norm and lr. The parameters and optimizer
    moments are updated in place (see train/optimizer.py); the gradients
    are released after the update.

    Under a `mesh` (a ("data", "model") or ("pod", "data", "model")
    `DeviceMesh`) `state` holds this rank's shards
    (`train_state.init_state(mesh=)`) and `batch` this data rank's rows
    (`parallel.sharding.data_specs`); the forward runs tensor-parallel
    over `model`, the gradients are summed over the batch axes
    (`sharding.batch_group`: `data`, or `pod` and `data` together) in
    fp32 and divided by dp, loss and nll averaged the same way. A leaf
    whole over `data` is all-reduced; a leaf the data axis cuts (FSDP,
    `cfg.fsdp`: the forward gathers it and its gradient arrives
    reduce-scattered, `models.model._take`) is already summed. The
    clip's global norm takes every element of the global tree once
    (`sharding.counts_once`: each piece from the one rank of its copies
    at index 0 along the axes that do not cut it), summed over `model`
    and then the batch axes, so every rank gets the same norm. A MoE model's
    `load_balance` is taken over the global batch (`moe.router`); with
    accum_steps A dividing a data rank's rows, the ranks' microbatch i
    together are the one-process step's microbatch i (rows ≡ i mod A of
    the global batch), so the step is the one-process step's.
    `on_grads(loss, nll, grads)`, if given, sees the step's gradients
    after that reduction and before the update (which scales them in
    place by the clip)."""
    grad_fn = make_grad_fn(cfg, accum_steps, aux_weight)
    if mesh is not None:
        from repro_torch.parallel import collectives as C
        from repro_torch.parallel import sharding as S
        from .train_state import param_specs

        sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
        dp = S.batch_count(mesh)
        M.check_parallel(cfg, sizes["model"], dp)
        specs = param_specs(cfg, mesh)
        coords = S.mesh_coords(mesh)
        # the groups a sum over the whole mesh runs through, model first,
        # then the batch axes together
        groups = ([mesh.get_group("model")] if sizes["model"] > 1 else []) \
            + ([S.batch_group(mesh)] if dp > 1 else [])

    def leaf_specs(params):
        return S.spec_leaves(specs, params)

    def grads_of(state, batch):
        if mesh is None:
            return grad_fn(state.params, batch)
        with S.using_mesh(mesh):
            loss, nll, grads = grad_fn(state.params, batch)
        if dp > 1:
            group = S.batch_group(mesh)
            for g, sp in zip(M.tree_leaves(grads), leaf_specs(grads)):
                if S.data_dim(sp, mesh) is None:
                    C.all_reduce_(g, group)
                g.div_(dp)
            ln = torch.stack([loss, nll])
            C.all_reduce_(ln, group)
            loss, nll = ln[0] / dp, ln[1] / dp
        return loss, nll, grads

    def sq_sum(params):
        """The clip's global sum of squares over the mesh (`update`'s
        `sq_sum`), for this rank's leaves of `params`."""
        once = [S.counts_once(sp, mesh, coords) for sp in leaf_specs(params)]

        def total(sq):
            part = sum(q for q, o in zip(sq, once) if o)
            part = torch.as_tensor(part, dtype=torch.float32,
                                   device=sq[0].device)
            for group in groups:
                C.all_reduce_(part, group)
            return part
        return total

    def train_step(state: TrainState, batch):
        loss, nll, grads = grads_of(state, batch)
        if on_grads is not None:
            on_grads(loss, nll, grads)
        params, opt_state, om = opt.update(
            grads, state.opt_state, state.params,
            sq_sum=None if mesh is None else sq_sum(state.params))
        for p in M.tree_leaves(params):
            p.grad = None
        metrics = {"loss": loss, "nll": nll, **om}
        return TrainState(step=state.step + 1, params=params,
                          opt_state=opt_state), metrics

    return train_step


def make_prefill_step(cfg: ArchConfig, prefix_len: int = 0):
    """prefill(params, tokens, cache, [frontend]) → (logits_last, cache).

    With `prefix_len > 0` (continued prefill), `tokens` holds only a
    prompt's uncached suffix and the cache's first `prefix_len` rows hold
    the shared prefix's KV. `frontend` feeds the modality stub (the
    VLM's patch rows, prepended; the encoder-decoder's frame embeddings,
    encoded)."""

    def prefill(params, tokens, cache, frontend=None):
        logits, cache, _ = M.forward(params, cfg, tokens, cache=cache,
                                     frontend_embeds=frontend,
                                     last_only=True, prefix_len=prefix_len)
        return logits, cache

    return prefill


def make_bucketed_prefill_step(cfg: ArchConfig, prefix_len: int = 0):
    """prefill(params, tokens, cache, last_idx, valid_len) → (logits_last,
    cache) for prompt-length bucketing: `tokens` is a suffix right-padded
    to a bucket length. The lm_head reads row `last_idx` (the real
    suffix's last row), and every cache row at position >= `valid_len`
    (the real absolute prompt length) gets position -1 after the forward:
    its K/V came from padding, and -1 hides it from the attention mask
    until a decode step overwrites it. Causal masking keeps the padding
    out of the real rows, so they come out of an exact-length prefill's
    arithmetic. Sound for attention-only stacks without local windows."""

    def prefill(params, tokens, cache, last_idx: int, valid_len: int,
                frontend=None):
        logits, cache, _ = M.forward(params, cfg, tokens, cache=cache,
                                     frontend_embeds=frontend,
                                     last_only=True, last_index=last_idx,
                                     prefix_len=prefix_len)
        for c in cache:
            if "kv" in c:
                c["kv"].positions[..., int(valid_len):] = -1      # in place
        return logits, cache

    return prefill


def make_serve_step(cfg: ArchConfig, page_size: int = 16):
    """One decode step: (params, token (B,1), cache, pos (B,), [frontend])
    → (logits (B,1,V), cache). `page_size` splits a ring's rows for the
    decode kernel on the card (`M.forward`); the serve steps below take it
    too. `frontend` is passed to the forward as the JAX step passes it:
    the encoder-decoder re-encodes it every step; a VLM would prepend it
    to the one token, so the engine passes None for a VLM's decode
    (ROADMAP F8)."""

    def serve_step(params, token, cache, pos, frontend=None):
        logits, cache, _ = M.forward(params, cfg, token, cache=cache,
                                     pos=pos, frontend_embeds=frontend,
                                     page_size=page_size)
        return logits, cache

    return serve_step


def make_draft_step(cfg: ArchConfig, draft_layers: int,
                    page_size: int = 16):
    """Early-exit decode step for self-speculative drafting: the first
    `draft_layers` superblocks of the same params, then the shared final
    norm and lm_head. (params, token (B,1), cache, pos (B,)) → (logits
    (B,1,V), cache). The forward of a config with `draft_layers` periods
    runs exactly those superblocks of the full params and cache, and its
    in-place KV writes land in them: what the JAX step merges back into
    the full cache. The verify later rewrites every row a draft wrote."""
    sub = dataclasses.replace(cfg,
                              num_layers=draft_layers * cfg.stack_period)

    def draft_step(params, token, cache, pos):
        logits, cache, _ = M.forward(params, sub, token, cache=cache,
                                     pos=pos, page_size=page_size)
        return logits, cache

    return draft_step


def make_verify_step(cfg: ArchConfig, page_size: int = 16):
    """Batched speculative verify: (params, tokens (B, k+1), cache, pos
    (B,)) → (logits (B, k+1, V), cache). Column 0 is each slot's last
    emitted token, columns 1..k the draft; one full-depth forward in
    decode_multi mode scores all k+1 next-token distributions and writes
    KV at pos..pos+k a slot."""

    def verify_step(params, tokens, cache, pos):
        logits, cache, _ = M.forward(params, cfg, tokens, cache=cache,
                                     pos=pos, decode_multi=True,
                                     page_size=page_size)
        return logits, cache

    return verify_step
