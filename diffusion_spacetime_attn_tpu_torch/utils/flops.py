"""FLOP count of a PyTorch program, port of the JAX package's `utils/flops.py`.

`count_flops(fn, *args, **kwargs)` calls `fn` under
`torch.utils.flop_counter.FlopCounterMode` and sorts its per-op counts into
JAX's keys.  Only products and convolutions are counted, as in JAX: the
elementwise, norm and softmax work is O(elements) and the count is the
numerator an MFU figure wants.  Everything `fn` dispatches is counted, so a
program that calls `backward` (or `torch.autograd.grad`) inside `fn` counts
its backward and the remat recompute too.

  * `matmul`: `mm`, `addmm`, `bmm`, `baddbmm` (what `F.linear` and `einsum`
    dispatch), `2·M·N·K` each, as JAX's `dot_general`.
  * `conv`: `convolution` and `convolution_backward`; the backward counts
    the gradients its `output_mask` asks for only (the input gradient of a
    convolution whose weights take none).
  * Strided convolutions: the count is of the arithmetic the program really
    does.  PyTorch takes the input gradient of a stride-s convolution as a
    transposed convolution over the cotangent: the forward's FLOPs.  JAX's
    `_conv_flops` counts the convolution XLA traces for it, over the
    s-dilated cotangent, zeros included: s² times the forward.  So a
    gradient program counts 3 × the forward FLOPs of each stride-2
    convolution whose input gradient it takes less than JAX does (SD's UNet
    has three, its `Downsample` at levels 0-2).
  * Context projections under remat: each UNet evaluation's recompute
    runs attn2's `to_k` / `to_v` on the text and local contexts again,
    although the contexts are constants of the chain; JAX's backward
    `lax.scan` computes such loop-invariant residuals once for all the
    evaluations inside the scan.  So a gradient program through an
    S-step chain counts S − 2 evaluations' worth of those projections more
    matmul than JAX does.  Every forward program counts what JAX counts
    (`tests/test_torch_flops.py` computes both gaps from the shapes).
  * `opaque_kernel_calls`: the launches the CUDA kernels' wrappers counted
    during the call (`ops/cuda_lib.launch_counts`), the counterpart of JAX's
    `opaque_pallas_calls`.  The kernels are ctypes calls the counter cannot
    see, so a nonzero value means the count is a lower bound: count on the
    kernels-off path, which computes the same function.
  * `dynamic_while_loops`: always 0.  The port's loops are Python loops
    that run under the counter, so every iteration is counted as it runs;
    there is no loop whose trip count the count cannot see.

No card is needed: on tensors on the meta device, and a model built there,
the program runs shapes only, as JAX's abstract trace does
(`scripts/flops_model.py`).
"""
from __future__ import annotations

from typing import Any, Dict

from torch.utils.flop_counter import FlopCounterMode

from ..ops.cuda_lib import launch_counts


def count_flops(fn, *args, **kwargs) -> Dict[str, Any]:
    """Call `fn(*args, **kwargs)` and count its FLOPs (see module doc):
    {'matmul', 'conv', 'total', 'opaque_kernel_calls',
    'dynamic_while_loops'}."""
    before = launch_counts()
    with FlopCounterMode(display=False) as counter:
        fn(*args, **kwargs)
    after = launch_counts()
    out = {"matmul": 0.0, "conv": 0.0}
    for op, n in counter.get_flop_counts().get("Global", {}).items():
        out["conv" if "conv" in str(op) else "matmul"] += float(n)
    out["total"] = out["matmul"] + out["conv"]
    out["opaque_kernel_calls"] = sum(after.values()) - sum(before.values())
    out["dynamic_while_loops"] = 0
    return out
