"""Multi-device: the data mesh over torch.distributed (`mesh.py`) and FSDP
(`sharding.py`); ports of the JAX package's `parallel/`."""
