"""Mamba2-2.7B — attention-free SSD [arXiv:2405.21060]."""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="mamba2-2.7b", family="ssm",
    num_layers=64, d_model=2560, num_heads=1, num_kv_heads=1,
    d_ff=0, vocab_size=50280,
    ssm_state=128, ssm_head_dim=64, ssm_expand=2, ssm_chunk=256,
)
