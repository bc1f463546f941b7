"""PyTorch/CUDA port of the SA reproduction (see README, PyTorch/H100 port)."""
