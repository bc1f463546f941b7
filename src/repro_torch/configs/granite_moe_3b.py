"""Granite-3.0 MoE 3B-A800M — 40 experts, top-8 [hf:ibm-granite]."""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="granite-moe-3b-a800m", family="moe",
    num_layers=32, d_model=1536, num_heads=24, num_kv_heads=8, head_dim=64,
    d_ff=512, vocab_size=49155,
    num_experts=40, experts_per_token=8, moe_every=1,
    pad_attn_train=True,   # measured: 18.1→10.9 s train collectives (§Perf)
)
