"""Phi-3-medium 14B — dense RoPE/SwiGLU/GQA [arXiv:2404.14219]."""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="phi3-medium-14b", family="dense",
    num_layers=40, d_model=5120, num_heads=40, num_kv_heads=10, head_dim=128,
    d_ff=17920, vocab_size=100352,
    pad_attn_train=True,   # 40H/10KVH replicates 16× without padding
)
