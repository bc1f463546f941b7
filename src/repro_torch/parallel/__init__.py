"""Data and tensor parallelism on `torch.distributed`: meshes (`mesh`),
the sharding rules (`sharding`), the explicit collectives the model code
calls (`collectives`) and gradient compression (`compression`)."""
