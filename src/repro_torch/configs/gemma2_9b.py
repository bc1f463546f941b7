"""Gemma2-9B — alternating local:global attention, logit softcaps
[arXiv:2408.00118]."""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="gemma2-9b", family="dense",
    num_layers=42, d_model=3584, num_heads=16, num_kv_heads=8, head_dim=256,
    d_ff=14336, vocab_size=256000,
    attn_pattern=("local", "global"), window=4096,
    attn_softcap=50.0, final_softcap=30.0,
    act="gelu", embed_scale=True, tie_embeddings=True,
)
