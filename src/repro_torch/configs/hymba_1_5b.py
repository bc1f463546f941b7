"""Hymba-1.5B — hybrid parallel attention ∥ Mamba heads [arXiv:2411.13676].

Parallel-head fusion (mean of per-branch RMSNorms), SWA for most layers with
periodic global layers. The published model places global attention at layers
{1, 17, 32}; the scan-superblock layout here uses a period-16 pattern (global
at layers 0 and 16) — noted in DESIGN.md §5.
"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="hymba-1.5b", family="hybrid", hybrid=True,
    num_layers=32, d_model=1600, num_heads=25, num_kv_heads=5, head_dim=64,
    d_ff=5504, vocab_size=32001,
    attn_pattern=("global",) + ("local",) * 15, window=2048,
    ssm_state=16, ssm_head_dim=64, ssm_expand=2,
)
