"""Pixtral-12B — ViT frontend STUB (input_specs supplies patch embeddings)
over a mistral-nemo-style decoder backbone [hf:mistralai/Pixtral-12B]."""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="pixtral-12b", family="vlm",
    num_layers=40, d_model=5120, num_heads=32, num_kv_heads=8, head_dim=128,
    d_ff=14336, vocab_size=131072,
    frontend_tokens=256, rope_theta=1000000.0,
)
