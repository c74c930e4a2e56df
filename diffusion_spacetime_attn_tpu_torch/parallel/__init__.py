"""Multi-device: the ('data', 'model') mesh over torch.distributed
(`mesh.py`), FSDP over the data axis and Megatron tensor parallelism over
the model axis (`sharding.py`, `tensor.py`); ports of the JAX package's
`parallel/`."""
