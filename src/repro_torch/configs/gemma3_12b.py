"""Gemma3-12B — 5:1 local:global, 128k context [hf:google/gemma-3]."""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="gemma3-12b", family="dense",
    num_layers=48, d_model=3840, num_heads=16, num_kv_heads=8, head_dim=256,
    d_ff=15360, vocab_size=262144,
    attn_pattern=("local",) * 5 + ("global",), window=1024,
    act="gelu", embed_scale=True, tie_embeddings=True,
    rope_theta=1000000.0,
)
