"""PyTorch / CUDA port of `diffusion_spacetime_attn_tpu` for NVIDIA Hopper.

The module layout mirrors the JAX package: `config`, `ops`, `models`,
`samplers`, `pipeline`, `serving`, `utils`.  Plain tensor code is PyTorch;
the Pallas TPU kernels of the serving path are hand-written CUDA C++ kernels
under `csrc/`, built at first use and bound through `ctypes`
(`ops/cuda_lib.py`).  Entry points run on ``"cuda"`` unless the caller passes
``device="cpu"``; on CPU tensors every kernel wrapper takes its plain PyTorch
version.
"""
