"""Qwen2.5-14B — dense GQA with QKV bias [hf:Qwen]."""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="qwen2.5-14b", family="dense",
    num_layers=48, d_model=5120, num_heads=40, num_kv_heads=8, head_dim=128,
    d_ff=13824, vocab_size=152064,
    qkv_bias=True, rope_theta=1000000.0,
    pad_attn_train=True,   # measured: halves train collectives (§Perf)
)
