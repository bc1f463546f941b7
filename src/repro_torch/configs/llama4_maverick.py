"""Llama-4 Maverick 400B-A17B — 128-expert top-1 MoE, early fusion.

MoE on every second layer with a shared expert (hf Llama-4
`interleave_moe_layer_step=2`); dense layers use a 16384-wide FFN so the
total lands at ~400 B with ~17 B active (DESIGN.md §5). Requires FSDP
(params 2-D sharded over (pod, data) × model).
"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="llama4-maverick-400b-a17b", family="moe",
    num_layers=48, d_model=5120, num_heads=40, num_kv_heads=8, head_dim=128,
    d_ff=8192, d_ff_dense=16384, vocab_size=202048,
    num_experts=128, experts_per_token=1, moe_every=2, shared_expert=True,
    rope_theta=500000.0, fsdp=True,
    pad_attn_train=True,   # measured: improves train collectives (§Perf)
)
