"""Whisper-tiny — enc-dec backbone; conv frontend is a STUB (input_specs
supplies precomputed 1500×384 frame embeddings) [arXiv:2212.04356]."""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="whisper-tiny", family="audio",
    num_layers=4, encoder_layers=4, d_model=384, num_heads=6, num_kv_heads=6,
    d_ff=1536, vocab_size=51865, frontend_tokens=1500,
    norm="layernorm", act="gelu",
)
