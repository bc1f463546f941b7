"""Architecture registry: the 10 assigned archs + reduced smoke variants."""
from __future__ import annotations

import dataclasses

from repro_torch.models.config import ArchConfig, SHAPES, SHAPES_BY_NAME, ShapeCfg

from .hymba_1_5b import CONFIG as HYMBA
from .granite_moe_3b import CONFIG as GRANITE
from .llama4_maverick import CONFIG as LLAMA4
from .mamba2_2_7b import CONFIG as MAMBA2
from .whisper_tiny import CONFIG as WHISPER
from .phi3_medium import CONFIG as PHI3
from .qwen2_5_14b import CONFIG as QWEN25
from .gemma2_9b import CONFIG as GEMMA2
from .gemma3_12b import CONFIG as GEMMA3
from .pixtral_12b import CONFIG as PIXTRAL

REGISTRY: dict[str, ArchConfig] = {c.name: c for c in (
    HYMBA, GRANITE, LLAMA4, MAMBA2, WHISPER, PHI3, QWEN25, GEMMA2, GEMMA3,
    PIXTRAL)}

ARCH_NAMES = tuple(REGISTRY)


def get_config(name: str) -> ArchConfig:
    try:
        return REGISTRY[name]
    except KeyError as e:
        raise ValueError(f"unknown arch {name!r}; have {sorted(REGISTRY)}") from e


def reduced_config(name: str, layers_per_period: int = 1,
                   width: int = 1) -> ArchConfig:
    """Smoke-test variant: same family/structure, tiny dims.

    Keeps the structural pattern (attn_pattern, moe cadence, hybrid/enc-dec)
    but shrinks width/depth/experts/vocab so one CPU train step is cheap.
    `width` scales d_model/d_ff (×width) past the dispatch-bound floor —
    at width 1 every forward costs about the same wall time regardless of
    depth, so experiments about *compute* ratios (e.g. the early-exit
    draft's depth saving, DESIGN.md §9) need width ≥ ~4 to measure
    anything but op-dispatch overhead.
    """
    full = get_config(name)
    period = full.stack_period
    hd = 16
    n_heads = max(2, min(full.num_heads, 4))
    n_kv = max(1, min(full.num_kv_heads, 2))
    changes = dict(
        name=full.name + "-smoke",
        num_layers=period * layers_per_period,
        d_model=64 * width, head_dim=hd,
        num_heads=n_heads, num_kv_heads=n_kv,
        d_ff=0 if full.family == "ssm" else 128 * width,
        d_ff_dense=128 * width if full.d_ff_dense else 0,
        vocab_size=503,  # odd on purpose: catches divisibility assumptions
        window=min(full.window, 8) if full.window else 0,
        ssm_state=16 if full.ssm_state else 0,
        ssm_head_dim=16 if full.ssm_state else 64,
        ssm_chunk=8,
        num_experts=min(full.num_experts, 8),
        experts_per_token=min(full.experts_per_token, 2),
        encoder_layers=2 if full.encoder_layers else 0,
        frontend_tokens=16 if full.frontend_tokens else 0,
        fsdp=False,
    )
    return dataclasses.replace(full, **changes)


def cut_depth(cfg: ArchConfig, layers: int) -> ArchConfig:
    """`cfg` cut to its first `layers` layers (a full-width model cut in
    depth). Where `layers` is below the attention pattern's period the
    pattern is cut with it (hymba's 2 layers: its global layer 0 and the
    local layer 1), so the stack is one superblock of those layers."""
    changes = {"num_layers": layers}
    if layers < len(cfg.attn_pattern):
        changes["attn_pattern"] = cfg.attn_pattern[:layers]
    return dataclasses.replace(cfg, **changes)


__all__ = ["REGISTRY", "ARCH_NAMES", "get_config", "reduced_config",
           "cut_depth", "ArchConfig", "SHAPES", "SHAPES_BY_NAME",
           "ShapeCfg"]
