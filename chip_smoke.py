#!/usr/bin/env python3
"""On-card smoke test of the PyTorch / CUDA port (`diffusion_spacetime_attn_tpu_torch`).

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py
    python3 chip_smoke.py --compare DIR   # DIR: another checkout (e.g. the parent
                                          # commit); times both trees in turns

Phases, each printed as one JSON object per line; any failure raises and the
script exits non-zero without its final line:

  1. device: the card's name and power limit; TF32 off for the comparisons.
  2. build:  the CUDA kernels from `diffusion_spacetime_attn_tpu_torch/csrc`,
             with nvcc's register / shared-memory / spill report and, per
             kernel function of the built library, its count of wgmma
             (HGMMA) and TMA / bulk-copy (UTMALDG, UBLKCP) instructions from
             `cuobjdump -sass`; the wgmma attention and GEGLU kernels must
             have both, and ptxas must not report serialized wgmma (C7513)
             or spills (C7512).
  3. kernels: each forward kernel against its plain PyTorch version at every
             shape of the SD v1-4 serving path (flash: the level-0 and level-1
             self-attention sites that pass `flash_ok`), in bfloat16 at one
             prompt (CFG rows = 2) and at the engine's batch of 2 prompts, and
             in float32 at one prompt (tolerances in `utils/testing.py`), with
             times (CUDA events), the plain version's time, the roofline
             bound and, for attention, the time of
             `scaled_dot_product_attention` as a yardstick.  Each kernel must
             give the same bits when launched twice on the same inputs, and
             the comparison must reject planted faults (a skipped key tile,
             a 5 % wrong scale, a skipped inner tile, the flash log-sum-exp
             off by log 2 on one query tile; for the wgmma attention loop,
             one key tile replaced by the previous ring stage's tile; for
             GEGLU, one k-step of h and g served from the previous ring
             stage and the last k-step of the second product skipped) at
             every shape.  Each attention and GEGLU row names its kernel
             design; every flash and GEGLU site and MHA's level-0/1 sites
             must run the wgmma design.  In bf16 each attention and GEGLU
             row (and each flash backward and GEGLU dx row) also carries
             `device_ms`: the kernels' own time through the C entry (CUDA
             events, no wrapper work) for each design the shape can take
             (attention: the wgmma kernels and the mma_sync kernels, same
             inputs; GEGLU: wgmma, its only bf16 design); GEGLU rows carry
             `composite_ms`, the same function as PyTorch calls (cuBLAS
             products and elementwise kernels), a yardstick.
     kernels_bwd: each backward kernel the same way at every chain shape, in
             bf16 and float32 at 1 and 2 prompts (flash: bf16 at 1 and 2, f32
             at 1), every cotangent (dK/dV included); planted faults: one
             object's blend products zeroed, the last key tile dropped from
             dKc or dK, a skipped inner tile in dx and its stale ring stage
             (and, as a check of the tolerance only, computed without the
             kernel, the last k-step of [dh | dg]·W1 skipped), o zeroed on
             one query tile of the flash backward (di comes from o on the
             card), and for its wgmma passes one key tile (dq pass) or one
             query tile (dK/dV pass) replaced by the previous ring stage's
             tile.  The flash
             backward's yardstick is the backward of
             `scaled_dot_product_attention` under autograd.
  4. unet:   one full-width SD v1-4 UNet evaluation (bfloat16, 4 active
             objects, seeded weights) with the three kernel flags on and off.
  5. slice:  the full-width pipeline in float32 (text encoder, controlled
             PLMS with 4 steps, VAE decode), kernels on vs off.
  6. chain:  the optimization's loss and its gradient in the blend weights
             (full-width SD v1-4 and the ViT-B/32 loss CLIP in float32, one
             prompt, 4 objects, PLMS-4 under remat), the four kernel flags
             (use_flash too) on vs off, within 1e-3 relative.
  7. serve:  TextToImageEngine at full SD v1-4 width (UNet, VAE, ViT-L/14 text
             tower), PLMS-50, batch 2, 4 objects per prompt: 3 requests in
             two batches, the second padded; it repeats the first request
             (prompt, seed) beside a pad row, which must give the same bytes.
             Every forward kernel must be launched 816 times per batch (16
             sites x 51 UNet evaluations), GEGLU's all on the wgmma design.
  8. profile: where a serving batch's time goes (host clock per part, and
             device time by kernel family under torch.profiler); no GEGLU
             slice sum may appear.
  9. optimize: SpaceTimeEngine (the paper's temporal optimization) at the
             same width with the ViT-B/32 loss CLIP, bf16, PLMS-50, batch 2,
             4 objects, 3 Adam epochs (the last forward only), use_flash on as
             in the JAX package's spacetime mode: 2 requests, then the first
             again beside a pad row (same bytes).  A forward kernel at n sites
             per evaluation must be launched 2 x 51 x 2 x n + 51 x n times per
             batch (2 training epochs x 51 evaluations x 2 for the remat
             recompute, + the forward-only epoch) and a backward kernel
             2 x 51 x n: n = 16 for spacetime and GEGLU (4080 / 1632), 10 for
             flash (2550 / 1018: the first self-attention of each chain sees
             only x_T and gets no backward), 6 for MHA (1530); losses finite;
             coef moved on active slots, 0 on padded ones; flash and GEGLU
             launches all on the wgmma design.
 10. profile_train: one training UNet evaluation (forward, recompute,
             backward) by kernel family, and the plain MHA backward that is
             left (levels 2 and mid).
 11. the `kernels` summary line (times per UNet evaluation at the engine's
     batch; launches of the optimization run; each kernel's design and, for
     the attention kernels, launches by design), the nvidia-smi line, and
     the final {"ok": true, ...} line.

With `--compare DIR` the script runs only phases device, build, kernels,
kernels_bwd, profile and profile_train, and `geglu_host` (the host work
per bf16 GEGLU call; this script's phase run on either tree's package), in
four fresh processes: DIR, this tree, this tree, DIR (each tree builds its
own kernels), and prints their lines tagged with turn and tree, then one
`compare` summary line per turn.

The weights are random (no checkpoint is loaded): N(0, 0.02²) per parameter
from a seed, as the JAX package's bench does.
"""
from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

# peak rates of one H100 SXM (NVIDIA data sheet, dense): the roofline bound
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
PEAK_BYTES = 3.35e12

# one prompt's sites per UNet evaluation: (level, Lq, inner, count)
SITES = [("level0", 4096, 320, 5), ("level1", 1024, 640, 5),
         ("level2", 256, 1280, 5), ("mid", 64, 1280, 1)]
FLASH_LEVELS = ("level0", "level1")    # the self-attention sites that pass flash_ok
HEADS, OBJECTS, CONTEXT_LEN = 8, 4, 77
SERVE_PROMPTS = 2               # the engine's batch size
LAUNCHES_PER_BATCH = 16 * 51
SLICE_STEPS = 4                 # PLMS steps of the float32 on-vs-off checks
# sites per UNet evaluation of each kernel with the four flags on: flash
# takes the self-attention of levels 0 and 1, MHA that of level 2 and mid
SITES_PER_EVAL = {"spacetime_fwd": 16, "spacetime_bwd": 16, "geglu_fwd": 16, "geglu_bwd": 16,
                  "flash_fwd": 10, "flash_bwd": 10, "mha_fwd": 6}
# backward sites per chain that get no gradient: the first self-attention of
# the first evaluation sees only x_T and the timestep, so autograd records no
# backward there; every other site depends on the blend weights
NO_GRAD_SITES = {"flash_bwd": 1}


def chain_launches(kernel: str, evals: int) -> int:
    """Launches of one chain of `evals` UNet evaluations under remat, forward
    (run again by the recompute) and backward."""
    n = SITES_PER_EVAL[kernel]
    if kernel.endswith("bwd"):
        return n * evals - NO_GRAD_SITES.get(kernel, 0)
    return 2 * n * evals


def opt_launches(kernel: str) -> int:
    """Launches per optimization batch: 2 training epochs of 51 evaluations,
    then the forward-only epoch."""
    return 2 * chain_launches(kernel, 51) + (0 if kernel.endswith("bwd")
                                             else 51 * SITES_PER_EVAL[kernel])


# rows the planted "stale ring stage" faults replace: one ring stage of the
# wgmma forward at dh > 48 (128 keys, `csrc/attn_fwd.cuh` FwdWgmma::BK; two
# 64-key stages at dh <= 48) and of the backward passes (`csrc/flash_bwd.cu`
# DQ_TILE, DKV_TILE)
WGMMA_FWD_TILE, WGMMA_BWD_TILE = 128, 64
# the wgmma kernel functions of the built library (`cuobjdump -sass`)
WGMMA_FUNCTIONS = ("flash_fwd_wgmma_kernel", "mha_fwd_wgmma_kernel",
                   "flash_bwd_dq_wgmma_kernel", "flash_bwd_dkv_wgmma_kernel",
                   "geglu_gate_wgmma_kernel", "geglu_out_wgmma_kernel",
                   "geglu_dgate_wgmma_kernel", "geglu_dx_out_wgmma_kernel")
# ptxas warnings that undo a wgmma design: wgmma serialized, registers spilled
PTXAS_FAULTS = ("C7513", "C7512")

BWD_NAMES = ("dq_c", "dg_u", "dkc", "dvc", "dlk", "dlv", "dmasks", "dcoef")
SPLASH = "jax/experimental/pallas/ops/tpu/splash_attention/splash_attention_kernel.py"

KERNELS = {
    "spacetime_fwd": dict(
        route="cuda", source="diffusion_spacetime_attn_tpu_torch/csrc/spacetime_fwd.cu",
        replaces="diffusion_spacetime_attn_tpu/ops/pallas_spacetime.py:44", design="simt"),
    "spacetime_bwd": dict(
        route="cuda", source="diffusion_spacetime_attn_tpu_torch/csrc/spacetime_bwd.cu",
        replaces="diffusion_spacetime_attn_tpu/ops/pallas_spacetime.py:152", design="simt"),
    "geglu_fwd": dict(
        route="cuda", source="diffusion_spacetime_attn_tpu_torch/csrc/geglu_fwd.cu",
        replaces="diffusion_spacetime_attn_tpu/ops/pallas_geglu.py:126", design="wgmma"),
    "geglu_bwd": dict(
        route="cuda", source="diffusion_spacetime_attn_tpu_torch/csrc/geglu_bwd.cu",
        replaces="diffusion_spacetime_attn_tpu/ops/pallas_geglu.py:244", design="wgmma"),
    "mha_fwd": dict(
        route="cuda", source="diffusion_spacetime_attn_tpu_torch/csrc/mha_fwd.cu",
        replaces="diffusion_spacetime_attn_tpu/ops/pallas_mha.py:79"),
    "flash_fwd": dict(
        route="cuda", source="diffusion_spacetime_attn_tpu_torch/csrc/flash_fwd.cu",
        replaces=f"diffusion_spacetime_attn_tpu/ops/attention.py:194 "
                 f"({SPLASH}:696 flash_attention_kernel)"),
    "flash_bwd": dict(
        route="cuda", source="diffusion_spacetime_attn_tpu_torch/csrc/flash_bwd.cu",
        replaces=f"diffusion_spacetime_attn_tpu/ops/attention.py:194 "
                 f"({SPLASH}:1307 _flash_attention_dq_kernel, "
                 f":1669 _flash_attention_dkv_kernel)"),
}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def fail(msg: str):
    raise RuntimeError(msg)


def cuda_ms(fn, iters: int) -> float:
    """Mean device time of fn() in ms over `iters` warm launches."""
    import torch

    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(iters):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / iters


def _design_device_ms(kind: str, args) -> dict:
    """{design: ms per call} of a bf16 attention call straight through the C
    entry (CUDA events over 20 back-to-back calls, the host ahead of the
    card: the kernels' own time, without the wrapper's host work or PyTorch
    ops), for each design this shape can take: the wgmma kernels and the
    synchronous mma_sync loop they replace, on the same inputs."""
    import torch

    from diffusion_spacetime_attn_tpu_torch.ops import cuda_flash, cuda_lib, cuda_mha

    lib, code = cuda_lib.library(), cuda_mha.DESIGN_CODES
    q, k, v = args[:3]
    B, L, inner = q.shape
    dh = inner // HEADS
    designs = ["mma_sync"] + (["wgmma"] if cuda_mha.attention_design(q.dtype, dh) == "wgmma"
                              else [])
    qs = cuda_flash.scaled_query(q, k, HEADS)
    out = torch.empty_like(q)
    if kind == "mha":
        entry, ptrs, rest = "dsta_mha_fwd", (q, k, v, out), (dh ** -0.5,)
    elif kind == "flash":
        lse = torch.empty((B * HEADS, L), dtype=torch.float32, device="cuda")
        entry, ptrs, rest = "dsta_flash_fwd", (qs, k, v, out, lse), ()
    else:
        o, lse, g = args[3:]
        rows = -(-L // cuda_flash.SCRATCH_ROWS) * cuda_flash.SCRATCH_ROWS
        scratch = torch.empty(2 * B * HEADS * rows, dtype=torch.float32, device="cuda")
        entry, ptrs, rest = ("dsta_flash_bwd", (qs, k, v, g, o, lse, scratch, out,
                                                torch.empty_like(k), torch.empty_like(v)),
                             (cuda_flash.query_scale(q, HEADS),))
    fn = getattr(lib, entry)

    def launch(design):
        c_args = (1, code[design], *(t.data_ptr() for t in ptrs), B, L, L, HEADS, dh, *rest,
                  cuda_lib.stream_ptr(q))
        return lambda: cuda_lib.check(fn(*c_args), entry)

    return {d: cuda_ms(launch(d), 20) for d in designs}


def _geglu_device_ms(args, dx: bool) -> dict:
    """{"wgmma": ms per call} of a bf16 GEGLU forward (args: x, w1, b1, w2,
    b2, res) or dx (x, w1, b1, w2, dy) straight through the C entry (CUDA
    events over 20 back-to-back calls, scratch allocated once): the kernels'
    own time, without the wrapper's host work."""
    import torch

    from diffusion_spacetime_attn_tpu_torch.ops import cuda_geglu, cuda_lib

    lib = cuda_lib.library()
    x, w1, b1, w2 = args[:4]
    (M, dim), inner = x.shape, w2.shape[1]
    out = torch.empty_like(x)
    scratch = cuda_geglu._scratch("wgmma", M, dim, inner, (2 if dx else 1) * inner, x.device)
    if dx:
        fn, name = lib.dsta_geglu_dx, "dsta_geglu_dx"
        ptrs = (x, w1, b1, w2, args[4], scratch, out)
    else:
        fn, name = lib.dsta_geglu_fwd, "dsta_geglu_fwd"
        ptrs = (x, w1, b1, w2, args[4], args[5], scratch, out)
    c_args = (1, *(t.data_ptr() for t in ptrs), M, dim, inner, cuda_lib.stream_ptr(x))
    return {"wgmma": cuda_ms(lambda: cuda_lib.check(fn(*c_args), name), 20)}


def _geglu_composite(args, dx: bool):
    """The same function as a chain of PyTorch calls in x's dtype (cuBLAS
    products and elementwise kernels): F.linear -> h·gelu(g) -> F.linear, or
    for dx, h, g and du -> dh, dg -> [dh | dg]·W1.  A yardstick only: the
    port never calls it."""
    import torch
    import torch.nn.functional as F

    x, w1, b1, w2 = args[:4]
    h, g = F.linear(x, w1, b1).chunk(2, dim=-1)
    if not dx:
        return F.linear(h * F.gelu(g), w2, args[4]) + args[5]
    du = args[4] @ w2
    c = 0.5 * (1.0 + torch.erf(g * 2.0 ** -0.5))
    phi = torch.exp(-0.5 * g * g) * (2.0 * math.pi) ** -0.5
    return torch.cat([du * (g * c), du * (h * (c + g * phi))], dim=-1) @ w1


def bound_ms(flops: float, nbytes: float, dtype: str):
    t_ops, t_bytes = flops / PEAK_FLOPS[dtype], nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def phase_device():
    import torch

    if not torch.cuda.is_available():
        fail("no CUDA device: the port's smoke test runs on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    name = torch.cuda.get_device_name(0)
    emit({"phase": "device", "name": name, "nvidia_smi": smi, "count": torch.cuda.device_count(),
          "torch": torch.__version__, "cuda": torch.version.cuda})
    return name, smi


def phase_build():
    from diffusion_spacetime_attn_tpu_torch.ops import cuda_lib

    t0 = time.perf_counter()
    info = cuda_lib.build()
    cuda_lib.library()
    keep = [ln.strip() for ln in info["ptxas"].splitlines()
            if ln.startswith("==") or "registers" in ln or "spill" in ln
            or "Compiling entry" in ln or "arning" in ln]
    sass = sass_counts(info["path"])
    emit({"phase": "build", "seconds": time.perf_counter() - t0, "path": info["path"],
          "ptxas": keep, "sass": sass})
    bad = [ln for ln in keep if any(code in ln for code in PTXAS_FAULTS)]
    if bad:
        fail(f"build: ptxas serialized wgmma or spilled: {bad}")
    for fn in WGMMA_FUNCTIONS:
        found = {k: v for k, v in sass.items() if fn in k}
        if not found:
            fail(f"build: no kernel function {fn} in the library")
        for name, c in found.items():
            if c["HGMMA"] == 0 or c["UTMALDG"] + c["UBLKCP"] == 0:
                fail(f"build: {name} has {c}: no wgmma or no TMA copy")


def sass_counts(lib_path: str) -> dict:
    """{kernel function: counts of HGMMA, UTMALDG and UBLKCP instructions}
    from `cuobjdump -sass` of the built library."""
    import shutil

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    out = subprocess.run([tool, "-sass", lib_path], capture_output=True, text=True,
                         check=True).stdout
    counts, fn = {}, None
    for ln in out.splitlines():
        if "Function :" in ln:
            fn = ln.split("Function :", 1)[1].strip()
            counts[fn] = {"HGMMA": 0, "UTMALDG": 0, "UBLKCP": 0}
        elif fn is not None:
            for op in ("HGMMA", "UTMALDG", "UBLKCP"):
                if op in ln:
                    counts[fn][op] += 1
    return {k: v for k, v in counts.items() if sum(v.values()) or "wgmma" in k}


def _outs(x):
    return x if isinstance(x, tuple) else (x,)


def _stale_tile(t, tile: int):
    """t [B, L, ...] with rows [tile, 2·tile) replaced by rows [0, tile): what
    a ring that served the previous stage's tile in place of the second
    would compute on."""
    t = t.clone()
    t[:, tile:2 * tile] = t[:, :tile]
    return t


def _stale_cols(t, tile: int = 64):
    """t [R, C] with columns [tile, 2·tile) replaced by columns [0, tile): the
    GEGLU kernels' second k-step over dim served from the first one's ring
    stage."""
    t = t.clone()
    t[:, tile:2 * tile] = t[:, :tile]
    return t


def _planted_faults(kind: str, args, kern):
    """Outputs of the kernel with a planted fault, which the comparison with
    the plain version must reject: a skipped key tile (the last 64 keys; 32
    at L = 64) or a 5 % wrong softmax scale for attention, the log-sum-exp
    off by log 2 on the first query tile for flash, the second 128-key tile
    replaced by the first (a stale ring stage) where the wgmma loop runs; for
    GEGLU a skipped 64-wide inner tile, the second 64-deep k-step of h and g
    replaced by the first (a stale ring stage) and the last k-step of the
    second product skipped; and only the first 64 of the 77 context keys for
    the spacetime blend."""
    from diffusion_spacetime_attn_tpu_torch.ops import cuda_mha

    if kind in ("mha", "flash"):
        q, k, v = args
        L = k.shape[1]
        keep = L - (64 if L > 64 else 32)
        faults = {"skip_key_tile": kern((q, k[:, :keep].contiguous(), v[:, :keep].contiguous()))}
        if kind == "mha":
            faults["scale_x1.05"] = kern(((q.float() * 1.05).to(q.dtype), k, v))
        else:
            o, lse = kern(args)
            lse = lse.clone()
            lse[:, :64] += math.log(2.0)
            faults["lse_off_by_log2_on_one_query_tile"] = (o, lse)
        if cuda_mha.attention_design(q.dtype, q.shape[2] // HEADS) == "wgmma":
            faults["stale_ring_stage_for_one_key_tile"] = kern(
                (q, _stale_tile(k, WGMMA_FWD_TILE), _stale_tile(v, WGMMA_FWD_TILE)))
        return faults
    if kind == "geglu":
        x, w1, b1, w2 = args[:4]
        skip, last = w2.clone(), w2.clone()
        skip[:, :64] = 0
        last[:, -64:] = 0
        return {"skip_inner_tile": kern(args[:3] + (skip,) + args[4:]),
                "stale_ring_stage_for_one_k_tile_of_h_g": kern(
                    (_stale_cols(x), _stale_cols(w1), b1, w2) + args[4:]),
                "last_k_tile_of_second_product_skipped": kern(args[:3] + (last,) + args[4:])}
    ctx = tuple(t[..., :64, :].contiguous() for t in args[2:6])
    return {"first_key_tile_only": kern(args[:2] + ctx + args[6:])}


def _inputs(kind: str, prompts: int, Lq: int, inner: int, dtype, gen):
    """Kernel inputs at one site for `prompts` prompts (2·prompts CFG rows),
    on the card, from a seeded generator."""
    import torch

    from diffusion_spacetime_attn_tpu_torch.ops.masks import flat_circular_mask

    dev = "cuda"

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(dtype)

    rows = 2 * prompts
    if kind in ("mha", "flash"):
        return (randn(rows, Lq, inner), randn(rows, Lq, inner), randn(rows, Lq, inner))
    if kind == "geglu":
        M, dim, hid = rows * Lq, inner, 4 * inner
        return (randn(M, dim), randn(2 * hid, dim, scale=dim ** -0.5), randn(2 * hid, scale=0.1),
                randn(dim, hid, scale=hid ** -0.5), randn(dim, scale=0.1), randn(M, dim))
    B = prompts
    centers = torch.rand((B, OBJECTS, 2), generator=gen, device=dev)
    masks = flat_circular_mask(centers, int(round(Lq ** 0.5)), 0.2,
                               torch.ones(B, OBJECTS, device=dev))
    return (randn(B, Lq, inner), randn(B, Lq, inner), randn(B, CONTEXT_LEN, inner),
            randn(B, CONTEXT_LEN, inner), randn(B, OBJECTS, CONTEXT_LEN, inner),
            randn(B, OBJECTS, CONTEXT_LEN, inner), masks,
            torch.full((B, OBJECTS), 1.25, device=dev))


def _sites(kind: str):
    """The main-path sites of a kernel kind: flash takes levels 0 and 1."""
    return [s for s in SITES if not kind.startswith("flash") or s[0] in FLASH_LEVELS]


def _design_counter(kind: str):
    """The launches-by-design counter of a kernel kind, or None (spacetime)."""
    from diffusion_spacetime_attn_tpu_torch.ops import cuda_flash, cuda_geglu, cuda_mha

    wrapper = {"mha": cuda_mha.mha_attention, "flash": cuda_flash.flash_attention,
               "flash_bwd": cuda_flash.flash_bwd, "geglu": cuda_geglu.geglu_ff,
               "geglu_bwd": cuda_geglu.geglu_dx}.get(kind)
    return None if wrapper is None else wrapper.launches_by_design


def _design_ran(name: str, counter, before):
    """The one design whose count moved since `before` (None without a counter)."""
    if counter is None:
        return None
    ran = [d for d, n in counter.items() if n != before[d]]
    if len(ran) != 1:
        fail(f"{name}: one launch moved the design counts {before} -> {counter}")
    return ran[0]


def phase_kernels():
    """Every kernel vs its plain version at every main-path shape: in bf16 at
    one prompt (CFG rows = 2) and at the serving batch of SERVE_PROMPTS, and
    in f32 at one prompt.  Returns per-kernel aggregates over one UNet
    evaluation at the serving batch (bf16 sites x counts)."""
    import torch
    import torch.nn.functional as F

    from diffusion_spacetime_attn_tpu_torch.ops import (
        cuda_flash,
        cuda_geglu,
        cuda_mha,
        cuda_spacetime,
    )
    from diffusion_spacetime_attn_tpu_torch.utils.testing import compare

    impl = {
        "mha": ("mha_fwd", lambda a: cuda_mha.mha_attention(*a, HEADS),
                lambda a: cuda_mha.mha_attention_plain(*a, HEADS),
                lambda a, it: cuda_mha.mha_cost(a[0].shape[0], a[0].shape[1], a[1].shape[1],
                                                a[0].shape[2], it)),
        "flash": ("flash_fwd", lambda a: cuda_flash.flash_fwd(*a, HEADS),
                  lambda a: cuda_flash.flash_attention_plain(*a, HEADS),
                  lambda a, it: cuda_flash.flash_cost(a[0].shape[0], a[0].shape[1],
                                                      a[1].shape[1], a[0].shape[2], HEADS, it)),
        "geglu": ("geglu_fwd", lambda a: cuda_geglu.geglu_ff(*a),
                  lambda a: cuda_geglu.geglu_plain(*a),
                  lambda a, it: cuda_geglu.geglu_cost(a[0].shape[0], a[0].shape[1],
                                                      a[3].shape[1], it)),
        "spacetime": ("spacetime_fwd",
                      lambda a: cuda_spacetime.fused_spacetime_attention(*a, HEADS),
                      lambda a: cuda_spacetime.spacetime_plain(*a, HEADS),
                      lambda a, it: cuda_spacetime.spacetime_cost(
                          a[0].shape[0], OBJECTS, a[0].shape[1], CONTEXT_LEN, a[0].shape[2],
                          it)),
    }
    cases = [("bfloat16", 1), ("bfloat16", SERVE_PROMPTS), ("float32", 1)]
    agg = {}
    gen = torch.Generator(device="cuda")
    case = 0
    for kind, (name, kern, plain, cost) in impl.items():
        a_ = agg.setdefault(name, {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0,
                                   "bound_ms": 0.0, "flops_ms": 0.0, "bytes_ms": 0.0,
                                   "library_ms": None})
        for dtype_name, prompts in cases:
            dtype = getattr(torch, dtype_name)
            for level, Lq, inner, count in _sites(kind):
                case += 1
                gen.manual_seed(case)
                args = _inputs(kind, prompts, Lq, inner, dtype, gen)
                counter = _design_counter(kind)
                before = dict(counter or {})
                got = _outs(kern(args))
                design = _design_ran(name, counter, before)
                if design == "mma_sync" and (kind in ("flash", "geglu") or level in FLASH_LEVELS):
                    fail(f"{name} {level} {dtype_name}: a main-path site ran the mma_sync loop")
                again = _outs(kern(args))
                want = _outs(plain(args))
                torch.cuda.synchronize()
                cmps = [compare(g_, w_, kind) for g_, w_ in zip(got, want)]
                if not all(c["ok"] for c in cmps):
                    fail(f"{name} {level} {dtype_name} {prompts} prompt(s): {cmps}")
                if not all(torch.equal(g_, a2) for g_, a2 in zip(got, again)):
                    fail(f"{name} {level} {dtype_name}: two launches on the same inputs differ")
                faults = {}
                for fault, outs in _planted_faults(kind, args, kern).items():
                    fc = [compare(o, w_, kind) for o, w_ in zip(_outs(outs), want)]
                    if all(c["ok"] for c in fc):
                        fail(f"{name} {level} {dtype_name}: planted fault {fault} passes {fc}")
                    faults[fault] = {"rel_norm": max(c["rel_norm"] for c in fc),
                                     "max_abs_err": max(c["max_abs_err"] for c in fc)}
                cmp = cmps[0]
                max_err = max(c["max_abs_err"] for c in cmps)
                ms = cuda_ms(lambda: kern(args), 20)
                plain_ms = cuda_ms(lambda: plain(args), 5)
                flops, nbytes = cost(args, args[0].element_size())
                b_ms, b_by = bound_ms(flops, nbytes, dtype_name)
                lib_ms = None
                if kind in ("mha", "flash"):
                    B, L, _ = args[0].shape
                    qh, kh, vh = (t.view(B, L, HEADS, -1).transpose(1, 2) for t in args)
                    lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(qh, kh, vh), 20)
                row = {"phase": "kernel", "name": name, "site": level, "dtype": dtype_name,
                       "prompts": prompts, "Lq": Lq, "inner": inner, "design": design,
                       "max_abs_err": max_err,
                       "rel_norm": cmp["rel_norm"], "atol": cmp["atol"], "rtol": cmp["rtol"],
                       "rel_norm_limit": cmp["rel_norm_limit"], "deterministic": True,
                       "planted_faults_rejected": faults, "kernel_ms": ms, "plain_ms": plain_ms,
                       "bound_us": 1e3 * b_ms, "bound_by": b_by, "flops": flops,
                       "bytes": nbytes, "library_ms": lib_ms,
                       "fraction_of_bound": b_ms / ms}
                if kind == "flash":
                    row["lse_max_abs_err"] = cmps[1]["max_abs_err"]
                if kind in ("mha", "flash") and dtype_name == "bfloat16":
                    row["device_ms"] = _design_device_ms(kind, args)
                if kind == "geglu" and dtype_name == "bfloat16":
                    row["device_ms"] = _geglu_device_ms(args, dx=False)
                    row["composite_ms"] = cuda_ms(lambda: _geglu_composite(args, dx=False), 20)
                emit(row)
                a_["max_abs_err"] = max(a_["max_abs_err"], max_err)
                if (dtype_name, prompts) == ("bfloat16", SERVE_PROMPTS):  # the serving shapes
                    a_["ms"] += count * ms
                    a_["plain_ms"] += count * plain_ms
                    a_["bound_ms"] += count * b_ms
                    a_["flops_ms"] += count * 1e3 * flops / PEAK_FLOPS[dtype_name]
                    a_["bytes_ms"] += count * 1e3 * nbytes / PEAK_BYTES
                    if lib_ms is not None:
                        a_["library_ms"] = (a_["library_ms"] or 0.0) + count * lib_ms
    return agg


def _bwd_planted_faults(kind: str, args, heads: int = HEADS):
    """Backward outputs with a planted fault, which the comparison with the
    plain version must reject: one object's blend products t zeroed, or the
    last key tile (keys 64-76) dropped from dKc, for the spacetime backward;
    a skipped 64-wide inner tile and the second k-step of h, g and du
    replaced by the first (a stale ring stage) for the GEGLU dx, and the last
    k-step of [dh | dg]·W1 skipped (the plain formulas, not the kernel: a
    check of the tolerance only); the last key tile dropped from dK, or the
    forward's output o (and with it di) zeroed on the first query tile, for
    the flash backward, and where its wgmma passes run, the
    second 64-key tile of the dq pass or the second 64-query tile of the
    dK/dV pass replaced by the first (a stale ring stage)."""
    import torch

    from diffusion_spacetime_attn_tpu_torch.ops import cuda_flash, cuda_geglu, cuda_mha, cuda_spacetime

    if kind == "flash":
        q, k, v, o, lse, g = args
        dq, dk, dv = cuda_flash.flash_bwd(q, k, v, o, lse, g, heads)
        cut = dk.clone()
        cut[:, -64:] = 0
        o0 = o.clone()
        o0[:, :64] = 0
        faults = {"last_key_tile_dropped_from_dk": (dq, cut, dv),
                  "o_zeroed_on_one_query_tile": cuda_flash.flash_bwd(q, k, v, o0, lse, g, heads)}
        if cuda_mha.attention_design(q.dtype, q.shape[2] // heads) == "wgmma":
            T = WGMMA_BWD_TILE
            faults["stale_ring_stage_for_one_key_tile_dq_pass"] = cuda_flash.flash_bwd(
                q, _stale_tile(k, T), _stale_tile(v, T), o, lse, g, heads)
            faults["stale_ring_stage_for_one_query_tile_dkv_pass"] = cuda_flash.flash_bwd(
                _stale_tile(q, T), k, v, o, lse, _stale_tile(g, T), heads)
        return faults
    if kind == "geglu":
        x, w1, b1, w2, dy = args
        skip = w2.clone()
        skip[:, :64] = 0
        stale_w2 = w2.clone()      # W2 [dim, inner]: the k-step over dim runs down its rows
        stale_w2[64:128] = stale_w2[:64]
        # a check of the tolerance only, computed from the plain formulas
        # without the kernel: W1 feeds both products of dx, so no input
        # drops a k-step of [dh | dg]·W1 alone.  [dh | dg] rounded as the
        # kernel rounds them, its last 64 columns dropped from the product.
        inner = w2.shape[1]
        h, g = cuda_geglu._h_g(x, w1, b1, inner)
        dh, dg = cuda_geglu._dh_dg(h, g, dy.float() @ w2.float())
        dhg = torch.cat([dh, dg], dim=-1).to(x.dtype).float()
        dhg[:, -64:] = 0
        return {"skip_inner_tile": (cuda_geglu.geglu_dx(x, w1, b1, skip, dy),),
                "stale_ring_stage_for_one_k_tile_of_h_g_du": (cuda_geglu.geglu_dx(
                    _stale_cols(x), _stale_cols(w1), b1, stale_w2, _stale_cols(dy)),),
                "tolerance_only_last_k_tile_of_second_product_skipped": (
                    (dhg @ w1.float()).to(x.dtype),)}
    q_c, g_u, kc, vc, lk, lv, masks, coef, g = args
    dq, t, dkc, dvc, dlk, dlv = cuda_spacetime.spacetime_bwd_raw(
        q_c, g_u, kc, vc, lk, lv, masks, coef, heads, g)

    def cotangents(t_, dkc_):
        dg_u, dmasks, dcoef = cuda_spacetime._blend_cotangents(t_, masks, coef, g, g_u)
        return (dq.to(q_c.dtype), dg_u, dkc_.to(kc.dtype), dvc.to(vc.dtype), dlk.to(lk.dtype),
                dlv.to(lv.dtype), dmasks, dcoef)

    t0, cut = t.clone(), dkc.clone()
    t0[:, :, 0] = 0
    cut[:, 64:] = 0
    return {"object0_t_zeroed": cotangents(t0, dkc),
            "last_key_tile_dropped_from_dkc": cotangents(t, cut)}


def phase_kernels_bwd():
    """Each backward kernel vs its plain version at every chain shape, in
    bf16 and f32 at 1 and 2 prompts (flash: bf16 at 1 and 2, f32 at 1),
    every cotangent compared (dK/dV too); planted faults must fail and a
    repeat must give the same bits.  Returns per-kernel aggregates over one
    UNet evaluation's backward at the optimization batch (2 prompts, bf16,
    the chain's form: no spacetime dK/dV); emits the plain MHA backward's
    time per evaluation at that batch beside them.

    The flash backward's V has mean 1: with zero-mean random V the softmax
    averages V away, the output o and with it di = rowsum(o ⊙ ḡ) are near
    zero, and the comparison could not see di.  Its `library_ms` is the
    backward of `scaled_dot_product_attention` under autograd, timed alone."""
    import torch
    import torch.nn.functional as F

    from diffusion_spacetime_attn_tpu_torch.ops import (
        cuda_flash,
        cuda_geglu,
        cuda_mha,
        cuda_spacetime,
    )
    from diffusion_spacetime_attn_tpu_torch.utils.testing import compare

    def st_bwd(a, need_kv=True):
        return cuda_spacetime.spacetime_bwd(*a[:8], HEADS, a[8], need_kv=need_kv)

    impl = {
        "spacetime": ("spacetime_bwd", "spacetime_bwd", st_bwd,
                      lambda a: cuda_spacetime.spacetime_bwd_plain(*a[:8], HEADS, a[8]),
                      lambda a, it: cuda_spacetime.spacetime_bwd_cost(
                          a[0].shape[0], OBJECTS, a[0].shape[1], CONTEXT_LEN, a[0].shape[2],
                          HEADS, it, need_kv=False)),
        "geglu": ("geglu_bwd", "geglu", lambda a, need_kv=True: (cuda_geglu.geglu_dx(*a),),
                  lambda a: (cuda_geglu.geglu_dx_plain(*a),),
                  lambda a, it: cuda_geglu.geglu_dx_cost(a[0].shape[0], a[0].shape[1],
                                                         a[3].shape[1], it)),
        "flash": ("flash_bwd", "flash",
                  lambda a, need_kv=True: cuda_flash.flash_bwd(*a, HEADS),
                  lambda a: cuda_flash.flash_bwd_plain(*a, HEADS),
                  lambda a, it: cuda_flash.flash_bwd_cost(a[0].shape[0], a[0].shape[1],
                                                          a[1].shape[1], a[0].shape[2], HEADS,
                                                          it)),
    }
    cases = [("bfloat16", 1), ("bfloat16", SERVE_PROMPTS), ("float32", 1),
             ("float32", SERVE_PROMPTS)]
    names_of = {"spacetime": BWD_NAMES, "geglu": ("dx",), "flash": ("dq", "dk", "dv")}
    agg, mha_bwd_ms = {}, 0.0
    gen = torch.Generator(device="cuda")
    case = 1000
    for kind, (name, cmp_kind, kern, plain, cost) in impl.items():
        a_ = agg.setdefault(name, {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0,
                                   "bound_ms": 0.0, "flops_ms": 0.0, "bytes_ms": 0.0,
                                   "library_ms": None})
        for dtype_name, prompts in cases[:3] if kind == "flash" else cases:
            dtype = getattr(torch, dtype_name)
            for level, Lq, inner, count in _sites(kind):
                case += 1
                gen.manual_seed(case)
                fwd = _inputs(kind, prompts, Lq, inner, dtype, gen)
                cot = (torch.randn(fwd[0].shape, generator=gen, device="cuda")).to(dtype)
                if kind == "flash":
                    q, k, v = fwd[0], fwd[1], (fwd[2].float() + 1.0).to(dtype)
                    args = (q, k, v) + cuda_flash.flash_attention_plain(q, k, v, HEADS) + (cot,)
                elif kind == "geglu":
                    args = fwd[:4] + (cot,)
                else:
                    args = fwd + (cot,)
                counter = _design_counter(kind + "_bwd" if kind in ("flash", "geglu") else kind)
                before = dict(counter or {})
                got = kern(args)
                design = _design_ran(name, counter, before)
                if design == "mma_sync":
                    fail(f"{name} {level} {dtype_name}: a main-path site ran the mma_sync kernels")
                again, want = kern(args), plain(args)
                torch.cuda.synchronize()
                names = names_of[kind]
                errs = {}
                for n_, g_, a2, w_ in zip(names, got, again, want):
                    cmp = compare(g_, w_, cmp_kind)
                    if not cmp["ok"]:
                        fail(f"{name} {level} {dtype_name} {prompts} prompt(s) {n_}: {cmp}")
                    if not torch.equal(g_, a2):
                        fail(f"{name} {level} {dtype_name} {n_}: two launches differ")
                    errs[n_] = {"max_abs_err": cmp["max_abs_err"], "rel_norm": cmp["rel_norm"]}
                faults = {}
                for fault, outs in _bwd_planted_faults(kind, args).items():
                    fc = [compare(o, w_, cmp_kind) for o, w_ in zip(outs, want)]
                    if all(c["ok"] for c in fc):
                        fail(f"{name} {level} {dtype_name}: planted fault {fault} passes")
                    faults[fault] = max(c["rel_norm"] for c in fc)
                max_err = max(e["max_abs_err"] for e in errs.values())
                ms = cuda_ms(lambda: kern(args, need_kv=False), 10)
                kv_ms = cuda_ms(lambda: kern(args, need_kv=True), 5) if kind == "spacetime" \
                    else None
                plain_ms = cuda_ms(lambda: plain(args), 3)
                flops, nbytes = cost(args, args[0].element_size())
                b_ms, b_by = bound_ms(flops, nbytes, dtype_name)
                lib_ms = None
                if kind == "flash":
                    B, L, _ = args[0].shape
                    qh, kh, vh = (t.view(B, L, HEADS, -1).transpose(1, 2).detach()
                                  .requires_grad_(True) for t in args[:3])
                    oh = F.scaled_dot_product_attention(qh, kh, vh)
                    gh = args[5].view(B, L, HEADS, -1).transpose(1, 2)
                    lib_ms = cuda_ms(lambda: torch.autograd.grad(oh, (qh, kh, vh), gh,
                                                                 retain_graph=True), 10)
                    del oh
                row = {"phase": "kernel_bwd", "name": name, "site": level, "dtype": dtype_name,
                       "prompts": prompts, "Lq": Lq, "inner": inner, "design": design,
                       "errors": errs,
                       "max_abs_err": max_err, "deterministic": True,
                       "planted_faults_rejected_rel_norm": faults, "kernel_ms": ms,
                       "kernel_ms_with_dkv": kv_ms, "plain_ms": plain_ms,
                       "bound_us": 1e3 * b_ms, "bound_by": b_by, "flops": flops,
                       "bytes": nbytes, "library_ms": lib_ms, "fraction_of_bound": b_ms / ms}
                if kind == "flash" and dtype_name == "bfloat16":
                    row["device_ms"] = _design_device_ms("flash_bwd", args)
                if kind == "geglu" and dtype_name == "bfloat16":
                    row["device_ms"] = _geglu_device_ms(args, dx=True)
                    row["composite_ms"] = cuda_ms(lambda: _geglu_composite(args, dx=True), 10)
                if kind == "spacetime" and dtype_name == "bfloat16":
                    # the chain's self-attention backward at this level: plain
                    # PyTorch (`_mha_bh_bwd` numerics), timed as the yardstick
                    # of what a hand-written flash backward would replace
                    rows = 2 * prompts
                    q, k, v, g = (torch.randn((rows, Lq, inner), generator=gen,
                                              device="cuda").to(dtype) for _ in range(4))
                    row["mha_bwd_plain_ms"] = cuda_ms(
                        lambda: cuda_mha.mha_bwd_plain(q, k, v, g, HEADS), 3)
                    if prompts == SERVE_PROMPTS:
                        mha_bwd_ms += count * row["mha_bwd_plain_ms"]
                emit(row)
                a_["max_abs_err"] = max(a_["max_abs_err"], max_err)
                if (dtype_name, prompts) == ("bfloat16", SERVE_PROMPTS):
                    a_["ms"] += count * ms
                    a_["plain_ms"] += count * plain_ms
                    a_["bound_ms"] += count * b_ms
                    a_["flops_ms"] += count * 1e3 * flops / PEAK_FLOPS[dtype_name]
                    a_["bytes_ms"] += count * 1e3 * nbytes / PEAK_BYTES
                    if lib_ms is not None:
                        a_["library_ms"] = (a_["library_ms"] or 0.0) + count * lib_ms
    emit({"phase": "kernels_bwd", "per_unet_eval_ms": {k: v["ms"] for k, v in agg.items()},
          "mha_bwd_plain_ms_per_unet_eval": mha_bwd_ms})
    return agg


def _control(B, dev, gen, width=768):
    import torch

    from diffusion_spacetime_attn_tpu_torch.ops.attention import SpatialControl

    return SpatialControl(
        local_contexts=torch.randn((B, OBJECTS, CONTEXT_LEN, width), generator=gen,
                                   device=dev),
        centers=torch.rand((B, OBJECTS, 2), generator=gen, device=dev),
        coef=torch.full((B, OBJECTS), 5.0 / OBJECTS, device=dev),
        active=torch.ones((B, OBJECTS), device=dev))


def phase_unet():
    """One full-width SD v1-4 UNet eval, kernels on vs off (same weights)."""
    import torch

    from diffusion_spacetime_attn_tpu_torch.config import UNetConfig
    from diffusion_spacetime_attn_tpu_torch.models.layers import cast_matmul_weights
    from diffusion_spacetime_attn_tpu_torch.models.unet import UNet
    from diffusion_spacetime_attn_tpu_torch.utils.testing import randomize_

    dev = torch.device("cuda")
    on = UNetConfig(dtype="bfloat16", use_mha=True, use_fused_ff=True, use_fused_control=True)
    off = UNetConfig(dtype="bfloat16")
    with torch.device(dev):
        u_on, u_off = UNet(on), UNet(off)
    randomize_(u_on, seed=1)
    u_off.load_state_dict(u_on.state_dict())
    for u in (u_on, u_off):
        cast_matmul_weights(u).eval().requires_grad_(False)
    gen = torch.Generator(device=dev).manual_seed(7)
    x = torch.randn((2, 64, 64, 4), generator=gen, device=dev)
    t = torch.full((2,), 981, dtype=torch.int32, device=dev)
    ctx = torch.randn((2, CONTEXT_LEN, 768), generator=gen, device=dev)
    ctl = _control(1, dev, gen)
    with torch.inference_mode():
        e_on = u_on(x, t, ctx, ctl)
        e_off = u_off(x, t, ctx, ctl)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        u_on(x, t, ctx, ctl)
        torch.cuda.synchronize()
        s_on = time.perf_counter() - t0
        t0 = time.perf_counter()
        u_off(x, t, ctx, ctl)
        torch.cuda.synchronize()
        s_off = time.perf_counter() - t0
    diff = float((e_on - e_off).abs().max())
    scale = float(e_off.abs().max())
    # bf16: the kernels round once where the plain path rounds at every
    # intermediate; the difference propagates through 16 transformer blocks
    tol = 5e-2 * scale + 1e-3
    emit({"phase": "unet", "shape": list(x.shape), "max_abs_diff": diff, "max_abs_eps": scale,
          "tol": tol, "eval_s_kernels": s_on, "eval_s_plain": s_off})
    if not (torch.isfinite(e_on).all() and diff <= tol and scale > 0):
        fail(f"UNet kernels-on vs off: max diff {diff} > {tol} (max |eps| {scale})")
    del u_on, u_off
    torch.cuda.empty_cache()


def phase_slice():
    """The slice's output against its plain path: the full-width SD v1-4
    bundle in float32, one prompt with 4 objects, encode_text -> PLMS with
    SLICE_STEPS steps from one x_T -> decode, kernels on vs off (the same
    seeded weights)."""
    import torch

    from diffusion_spacetime_attn_tpu_torch.config import (
        PipelineConfig,
        SpaceTimeConfig,
        UNetConfig,
    )
    from diffusion_spacetime_attn_tpu_torch.ops import cuda_geglu, cuda_mha, cuda_spacetime
    from diffusion_spacetime_attn_tpu_torch.pipeline.pipeline import StableDiffusion
    from diffusion_spacetime_attn_tpu_torch.utils.tokenizer import make_clip_tokenizer

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(3)
    ctl = _control(1, dev, gen)
    x_T = torch.randn((1, 64, 64, 4), generator=gen, device=dev)
    tok = make_clip_tokenizer()
    ids = [[tok.pad_to(tok.encode(t), CONTEXT_LEN)] for t in ("a cat beside a dog", "")]
    wrappers = (cuda_spacetime.fused_spacetime_attention, cuda_geglu.geglu_ff,
                cuda_mha.mha_attention)
    out = {}
    for on in (True, False):
        cfg = PipelineConfig(unet=UNetConfig(use_mha=on, use_fused_ff=on, use_fused_control=on),
                             spacetime=SpaceTimeConfig(num_steps=SLICE_STEPS))
        sd = StableDiffusion.create(cfg, seed=0, device=dev)
        before = [w.launches for w in wrappers]
        with torch.inference_mode():
            eps = sd.make_eps_fn(sd.encode_text(ids[0]), sd.encode_text(ids[1]), 7.5, ctl)
            z = sd.sample_from(eps, x_T)
            out[on] = (z, sd.decode_latents(z))
        torch.cuda.synchronize()
        launched = [w.launches - b for w, b in zip(wrappers, before)]
        if launched != [16 * (SLICE_STEPS + 1) if on else 0] * 3:
            fail(f"slice kernels {'on' if on else 'off'}: launches {launched}")
        del sd
        torch.cuda.empty_cache()
    # float32: the kernels and the plain path differ in summation order only
    errs = {}
    for k, (got, want) in zip(("latents", "image"), zip(out[True], out[False])):
        errs[k] = float((got - want).abs().max())
        if not (torch.isfinite(got).all() and torch.allclose(got, want, atol=1e-4, rtol=1e-4)):
            fail(f"slice {k}: kernels on vs off max diff {errs[k]} over 1e-4 + 1e-4·|plain|")
    emit({"phase": "slice", "dtype": "float32", "steps": SLICE_STEPS,
          "max_abs_diff": errs, "tol": [1e-4, 1e-4],
          "latent_moved": float((out[False][0] - x_T).abs().max())})


def phase_serve():
    """Three requests through TextToImageEngine at full SD v1-4 width."""
    import numpy as np
    import torch

    from diffusion_spacetime_attn_tpu_torch.config import PipelineConfig, UNetConfig, VAEConfig
    from diffusion_spacetime_attn_tpu_torch.ops import cuda_geglu, cuda_mha, cuda_spacetime
    from diffusion_spacetime_attn_tpu_torch.pipeline.pipeline import StableDiffusion
    from diffusion_spacetime_attn_tpu_torch.serving.server import TextToImageEngine
    from diffusion_spacetime_attn_tpu_torch.utils.tokenizer import make_clip_tokenizer

    cfg = PipelineConfig(
        unet=UNetConfig(dtype="bfloat16", use_mha=True, use_fused_ff=True,
                        use_fused_control=True),
        vae=VAEConfig(dtype="bfloat16"))
    t0 = time.perf_counter()
    sd = StableDiffusion.create(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    tok = make_clip_tokenizer(max_len=cfg.text_encoder.max_len)
    objects = ["cat", "dog", "tree", "car"]
    centers = np.array([[0.25, 0.25], [0.75, 0.25], [0.25, 0.75], [0.75, 0.75]], np.float32)

    def prepare_host(prompt):
        return {"centers": centers, "active": np.ones(OBJECTS, np.float32),
                "local_texts": [f"a photo of {o}" for o in objects]}

    engine = TextToImageEngine(sd=sd, tokenize=lambda t: tok.pad_to(tok.encode(t), 77),
                               batch_size=SERVE_PROMPTS, prepare_host=prepare_host)
    finite = []
    hook = sd.vae.decoder.register_forward_hook(
        lambda m, i, out: finite.append(bool(torch.isfinite(out).all())))
    wrappers = {"spacetime_fwd": cuda_spacetime.fused_spacetime_attention,
                "geglu_fwd": cuda_geglu.geglu_ff, "mha_fwd": cuda_mha.mha_attention}
    requests = [["a cat and a dog near a tree and a car", "a dog left of a car"],
                ["a cat and a dog near a tree and a car"]]
    seeds = [[11, 12], [11]]
    images = []
    launches = {k: 0 for k in wrappers}
    torch.cuda.reset_peak_memory_stats()
    batch_s = []
    by_design = {}
    for prompts, sds in zip(requests, seeds):
        _reset_counts(wrappers.values())
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        imgs = engine.generate_batch(prompts, sds)
        torch.cuda.synchronize()
        batch_s.append(time.perf_counter() - t0)
        images.append(imgs)
        counts = {k: w.launches for k, w in wrappers.items()}
        for k, n in counts.items():
            launches[k] += n
            if n != LAUNCHES_PER_BATCH:
                fail(f"{k}: {n} launches in a batch, expected {LAUNCHES_PER_BATCH}")
        # MHA: levels 0 and 1 (10 sites) on the wgmma loop, dh 160 (6) on mma_sync
        mha = dict(cuda_mha.mha_attention.launches_by_design)
        if mha != {"wgmma": 10 * 51, "mma_sync": 6 * 51, "simt": 0}:
            fail(f"serve: MHA launches by design {mha}")
        geglu = dict(cuda_geglu.geglu_ff.launches_by_design)
        if geglu != {"wgmma": LAUNCHES_PER_BATCH, "simt": 0}:
            fail(f"serve: GEGLU launches by design {geglu}")
        _add_counts(by_design, {"mha_fwd": mha, "geglu_fwd": geglu})
        if imgs.shape != (len(prompts), 512, 512, 3) or imgs.dtype != np.uint8:
            fail(f"engine output {imgs.shape} {imgs.dtype}")
        if float(imgs.std()) == 0.0:
            fail("engine output is constant")
        emit({"phase": "serve_batch", "prompts": len(prompts),
              "pad_rows": SERVE_PROMPTS - len(prompts),
              "seconds": batch_s[-1], "launches": counts, "image_mean": float(imgs.mean()),
              "image_std": float(imgs.std())})
    hook.remove()
    if len(finite) != len(requests) or not all(finite):
        fail(f"decoded images not finite: {finite}")
    # the same (prompt, seed) in another batch, beside a pad row: the same bytes
    repeat_equal = bool(np.array_equal(images[0][0], images[1][0]))
    if not repeat_equal:
        diff = np.abs(images[0][0].astype(int) - images[1][0].astype(int))
        fail(f"request (prompt, seed 11) served twice differs: {int((diff > 0).sum())} bytes, "
             f"max {int(diff.max())}")
    emit({"phase": "serve", "requests": sum(map(len, requests)), "batches": len(requests),
          "batch_size": SERVE_PROMPTS, "steps": 50, "repeat_request_same_bytes": repeat_equal,
          "setup_s": setup_s, "s_per_batch": batch_s,
          "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
          "launches": launches, "launches_by_design": by_design})
    return launches, by_design, sd


def _reset_counts(wrappers):
    """Every launch count to 0, by design too."""
    for w in wrappers:
        w.launches = 0
        for d in getattr(w, "launches_by_design", {}):
            w.launches_by_design[d] = 0


def _add_counts(total: dict, counts: dict):
    for name, by in counts.items():
        for d, n in by.items():
            total.setdefault(name, {}).setdefault(d, 0)
            total[name][d] += n


def _wrappers():
    """{kernel name: its wrapper, which carries the launch count}."""
    from diffusion_spacetime_attn_tpu_torch.ops import (
        cuda_flash,
        cuda_geglu,
        cuda_mha,
        cuda_spacetime,
    )

    return {"spacetime_fwd": cuda_spacetime.fused_spacetime_attention,
            "spacetime_bwd": cuda_spacetime.spacetime_bwd, "geglu_fwd": cuda_geglu.geglu_ff,
            "geglu_bwd": cuda_geglu.geglu_dx, "mha_fwd": cuda_mha.mha_attention,
            "flash_fwd": cuda_flash.flash_attention, "flash_bwd": cuda_flash.flash_bwd}


OBJECT_NAMES = ["cat", "dog", "tree", "car"]
OBJECT_CENTERS = [[0.25, 0.25], [0.75, 0.25], [0.25, 0.75], [0.75, 0.75]]


def _spacetime_engine(sd, clip_loss, batch_size):
    import numpy as np

    from diffusion_spacetime_attn_tpu_torch.serving.server import SpaceTimeEngine
    from diffusion_spacetime_attn_tpu_torch.utils.tokenizer import make_clip_tokenizer

    tok = make_clip_tokenizer(max_len=CONTEXT_LEN)

    def prepare_host(prompt):
        return {"centers": np.array(OBJECT_CENTERS, np.float32),
                "active": np.ones(OBJECTS, np.float32),
                "local_texts": [f"a photo of {o}" for o in OBJECT_NAMES],
                "object_texts": [f"A photo of {o}" for o in OBJECT_NAMES]}

    def tokenize(t):
        return tok.pad_to(tok.encode(t), CONTEXT_LEN)

    return SpaceTimeEngine(sd=sd, clip_loss=clip_loss, tokenize=tokenize, clip_tokenize=tokenize,
                           prepare_host=prepare_host, batch_size=batch_size)


def phase_chain():
    """The optimization's gradient against its plain path: the full-width
    SD v1-4 bundle and the ViT-B/32 loss CLIP in float32, one prompt with 4
    objects, generation_loss through PLMS with SLICE_STEPS steps (remat on)
    and its gradient in the blend weights, kernels on (the four flags, flash
    at levels 0 and 1, MHA at level 2 and mid) vs off."""
    import torch

    from diffusion_spacetime_attn_tpu_torch.config import (
        CLIPConfig,
        PipelineConfig,
        SpaceTimeConfig,
        UNetConfig,
    )
    from diffusion_spacetime_attn_tpu_torch.pipeline.losses import DCLIPLoss
    from diffusion_spacetime_attn_tpu_torch.pipeline.pipeline import StableDiffusion
    from diffusion_spacetime_attn_tpu_torch.pipeline.spacetime import generation_loss, init_coef

    dev = torch.device("cuda")
    clip_loss = DCLIPLoss.create(CLIPConfig(), seed=4, device=dev)
    wrappers = _wrappers()
    evals = SLICE_STEPS + 1
    out = {}
    for on in (True, False):
        cfg = PipelineConfig(unet=UNetConfig(use_flash=on, use_mha=on, use_fused_ff=on,
                                             use_fused_control=on),
                             spacetime=SpaceTimeConfig(num_steps=SLICE_STEPS))
        sd = StableDiffusion.create(cfg, seed=0, device=dev)
        with torch.no_grad():
            inputs = _spacetime_engine(sd, clip_loss, 1)._inputs(["a cat and a dog near a tree"],
                                                                 [21])
        coef = init_coef(inputs.active, SLICE_STEPS, cfg.spacetime.init_coef).requires_grad_()
        _reset_counts(wrappers.values())
        t0 = time.perf_counter()
        loss, images = generation_loss(coef, sd, clip_loss, inputs, cfg.spacetime)
        loss.backward()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launched = {k: w.launches for k, w in wrappers.items()}
        want = {k: (chain_launches(k, evals) if on else 0) for k in wrappers}
        if launched != want:
            fail(f"chain kernels {'on' if on else 'off'}: launches {launched}, expected {want}")
        if not (torch.isfinite(loss) and torch.isfinite(coef.grad).all()):
            fail(f"chain kernels {'on' if on else 'off'}: loss or gradient not finite")
        out[on] = (loss.detach(), coef.grad.clone(), seconds)
        del sd, loss, images
        torch.cuda.empty_cache()
    (l1, g1, s1), (l0, g0, s0) = out[True], out[False]
    loss_rel = float((l1 - l0).abs() / l0.abs())
    grad_rel = float(torch.linalg.vector_norm(g1 - g0) / torch.linalg.vector_norm(g0))
    emit({"phase": "chain", "dtype": "float32", "steps": SLICE_STEPS, "objects": OBJECTS,
          "loss": float(l1), "loss_rel_diff": loss_rel, "dcoef_rel_norm": grad_rel,
          "limit": 1e-3, "dcoef_norm": float(torch.linalg.vector_norm(g0)),
          "launches": launched,
          "s_kernels": s1, "s_plain": s0})
    if not (loss_rel <= 1e-3 and grad_rel <= 1e-3 and float(g0.abs().max()) > 0):
        fail(f"chain: kernels on vs off, loss rel {loss_rel}, dcoef rel norm {grad_rel} > 1e-3")


def phase_optimize():
    """SpaceTimeEngine at full SD v1-4 width (UNet, VAE, ViT-L/14 text
    tower; ViT-B/32 loss CLIP), bf16, PLMS-50, batch 2, 4 objects, 3 epochs
    with the last forward only, the four kernel flags on (use_flash, as the
    JAX package's spacetime mode sets it): two requests, then the first
    (prompt, seed) again beside a pad row, which must give the same bytes."""
    import dataclasses

    import numpy as np
    import torch

    from diffusion_spacetime_attn_tpu_torch.config import (
        CLIPConfig,
        CLIPVisionConfig,
        PipelineConfig,
        UNetConfig,
        VAEConfig,
    )
    from diffusion_spacetime_attn_tpu_torch.pipeline.losses import DCLIPLoss
    from diffusion_spacetime_attn_tpu_torch.pipeline.pipeline import StableDiffusion
    from diffusion_spacetime_attn_tpu_torch.pipeline.spacetime import init_coef

    cfg = PipelineConfig(
        unet=UNetConfig(dtype="bfloat16", use_flash=True, use_mha=True, use_fused_ff=True,
                        use_fused_control=True),
        vae=VAEConfig(dtype="bfloat16"))
    clip_cfg = CLIPConfig(vision=CLIPVisionConfig(dtype="bfloat16"),
                          text=dataclasses.replace(CLIPConfig().text, dtype="bfloat16"))
    t0 = time.perf_counter()
    sd = StableDiffusion.create(cfg, seed=0, device="cuda")
    engine = _spacetime_engine(sd, DCLIPLoss.create(clip_cfg, seed=4, device="cuda"),
                               SERVE_PROMPTS)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    wrappers = _wrappers()
    requests = [["a cat and a dog near a tree and a car", "a dog left of a car"],
                ["a cat and a dog near a tree and a car"]]
    seeds = [[11, 12], [11]]
    images, launches, batch_s, by_design = [], {k: 0 for k in wrappers}, [], {}
    torch.cuda.reset_peak_memory_stats()
    for prompts, sds in zip(requests, seeds):
        _reset_counts(wrappers.values())
        marks = []

        def on_epoch(e, imgs):
            torch.cuda.synchronize()
            marks.append(time.perf_counter())

        torch.cuda.synchronize()
        t0 = time.perf_counter()
        imgs, coef, losses = engine.optimize_batch(prompts, sds, on_epoch=on_epoch)
        torch.cuda.synchronize()
        batch_s.append(time.perf_counter() - t0)
        counts = {k: w.launches for k, w in wrappers.items()}
        for k, n in counts.items():
            launches[k] += n
            want = opt_launches(k)
            if n != want:
                fail(f"optimize {k}: {n} launches in a batch, expected {want}")
        # flash (levels 0 and 1) and GEGLU on the wgmma kernels; MHA (dh 160)
        # on mma_sync
        designs = {k: dict(wrappers[k].launches_by_design)
                   for k in ("flash_fwd", "flash_bwd", "mha_fwd", "geglu_fwd", "geglu_bwd")}
        for k, d in (("flash_fwd", "wgmma"), ("flash_bwd", "wgmma"), ("mha_fwd", "mma_sync"),
                     ("geglu_fwd", "wgmma"), ("geglu_bwd", "wgmma")):
            if designs[k][d] != counts[k]:
                fail(f"optimize {k}: launches by design {designs[k]}, all expected on {d}")
        _add_counts(by_design, designs)
        if not bool(torch.isfinite(losses).all()) or not bool(torch.isfinite(imgs).all()):
            fail(f"optimize: losses {losses.tolist()} or images not finite")
        active = torch.zeros(SERVE_PROMPTS, OBJECTS, device=coef.device)
        active[:len(prompts)] = 1.0
        init = init_coef(active, sd.schedule.num_steps, sd.cfg.spacetime.init_coef)
        # random N(0, 0.02²) weights give gradients of ~1e-10 (phase chain), so
        # Adam's eps (1e-8) dominates and an entry whose gradient is below
        # ~1e-13 moves less than one f32 ulp of 1.25: every active object must
        # move at some step, every padded one nowhere
        moved = (coef - init).abs()
        obj_moved = moved.amax(dim=-1)                      # [B, N]
        min_obj_moved = float(obj_moved[active > 0].min())
        moved_share = float((moved[active > 0] > 0).float().mean())
        pad_max = float(coef[active == 0].abs().max()) if bool((active == 0).any()) else 0.0
        stats = {"coef_min_object_moved": min_obj_moved, "coef_moved_share": moved_share,
                 "coef_max_moved": float(moved.max()), "coef_max_padded": pad_max}
        if not (min_obj_moved > 0 and pad_max == 0.0):
            fail(f"optimize: coef did not move as expected: {stats}")
        u8 = engine.to_uint8(imgs[:len(prompts)])
        if u8.shape != (len(prompts), 512, 512, 3) or float(u8.std()) == 0.0:
            fail(f"optimize: output {u8.shape}, std {float(u8.std())}")
        images.append(u8)
        epoch_s = np.diff([t0] + marks).tolist()
        emit({"phase": "optimize_batch", "prompts": len(prompts),
              "pad_rows": SERVE_PROMPTS - len(prompts), "seconds": batch_s[-1],
              "s_per_epoch": epoch_s, "losses": losses.tolist(), "launches": counts,
              "launches_by_design": designs,
              **stats, "coef_range": [float(coef.min()), float(coef.max())],
              "image_mean": float(u8.mean()), "image_std": float(u8.std())})
    repeat_equal = bool(np.array_equal(images[0][0], images[1][0]))
    if not repeat_equal:
        diff = np.abs(images[0][0].astype(int) - images[1][0].astype(int))
        fail(f"optimize: request (prompt, seed 11) served twice differs: "
             f"{int((diff > 0).sum())} bytes, max {int(diff.max())}")
    emit({"phase": "optimize", "requests": sum(map(len, requests)), "batches": len(requests),
          "batch_size": SERVE_PROMPTS, "steps": 50, "epochs": sd.cfg.spacetime.epochs,
          "repeat_request_same_bytes": repeat_equal, "setup_s": setup_s,
          "s_per_batch": batch_s, "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
          "launches": launches, "launches_by_design": by_design})
    return launches, by_design, engine


def phase_profile_train(sd):
    """Where a training UNet evaluation's time goes at the optimization's
    shapes (batch 2 = 4 CFG rows): one checkpointed evaluation, forward,
    recompute and backward into x and the blend weights, on the host clock
    and under torch.profiler by kernel family (flash forward and backward at
    levels 0 and 1; the plain MHA backward left at level 2 and mid)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from torch.utils.checkpoint import checkpoint

    dev, B = sd.device, SERVE_PROMPTS
    gen = torch.Generator(device=dev).manual_seed(6)
    x0 = torch.randn((2 * B, 64, 64, 4), generator=gen, device=dev)
    t = torch.full((2 * B,), 981, dtype=torch.int32, device=dev)
    ctx = torch.randn((2 * B, CONTEXT_LEN, 768), generator=gen, device=dev)
    ctl = _control(B, dev, gen)
    w = torch.randn((2 * B, 64, 64, 4), generator=gen, device=dev)

    def step():
        x = x0.clone().requires_grad_(True)
        coef = ctl.coef.clone().requires_grad_(True)
        eps = checkpoint(lambda x_: sd.unet(x_, t, ctx, ctl._replace(coef=coef)), x,
                         use_reentrant=False)
        (eps * w).sum().backward()

    # as SpaceTimeEngine runs it: cuDNN's deterministic algorithms
    with torch.backends.cudnn.flags(enabled=True, benchmark=False, deterministic=True):
        step()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(3):
            step()
        torch.cuda.synchronize()
        host_s = (time.perf_counter() - t0) / 3
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            step()
            torch.cuda.synchronize()
    groups, kernels = _families(prof)
    busy = sum(v for k, v in groups.items() if not k.startswith("("))
    _no_slices("profile_train", groups)
    emit({"phase": "profile_train", "train_eval_s": host_s, "device_ms_by_family": groups or None,
          "device_busy_ms": busy if groups else None, "device_kernels": kernels,
          "device_idle_share": (1.0 - busy / (1e3 * host_s)) if groups else None})


FAMILIES = [("flash_fwd", ("flash_fwd_",)), ("flash_bwd", ("flash_bwd_",)),
            ("mha_fwd", ("mha_fwd_",)), ("spacetime_fwd", ("spacetime_fwd_kernel",)),
            ("spacetime_bwd", ("spacetime_bwd_",)),
            ("geglu_fwd", ("geglu_gate", "geglu_out", "geglu_partial")),
            ("geglu_bwd", ("geglu_dgate", "geglu_dx_out", "geglu_dx_partial")),
            ("geglu_sum_slices", ("sum_slices",)),
            ("convolution", ("conv", "implicit", "cudnn", "fprop", "dgrad", "wgrad")),
            ("matmul", ("gemm", "cutlass", "cublas", "nvjet", "xmma")),
            ("softmax", ("softmax",)), ("norm", ("norm",))]


def _no_slices(phase: str, groups: dict):
    """The bf16 GEGLU kernels (wgmma) write no f32 slices: fail if the
    profile holds a slice sum."""
    if groups.get("geglu_sum_slices"):
        fail(f"{phase}: the bf16 path summed GEGLU slices ({groups['geglu_sum_slices']} ms)")


def _families(prof):
    """Device ms by kernel family, and the number of device kernels.  The
    device time under the `mha_bwd_plain` range (the plain self-attention
    backward, whose kernels also sit in matmul / softmax / other) is added
    as its own key."""
    import torch

    groups, kernels = {}, 0
    for e in prof.key_averages():
        if e.key == "mha_bwd_plain":
            groups["(of which mha_bwd_plain)"] = getattr(e, "device_time_total", 0.0) / 1e3
            continue
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", 0.0)
        name = e.key.lower()
        fam = next((f for f, keys in FAMILIES if any(k in name for k in keys)), "other")
        groups[fam] = groups.get(fam, 0.0) + us / 1e3
        kernels += e.count
    return groups, kernels


def phase_profile(sd):
    """Where a serving batch's time goes: host-clock times of its parts at
    the engine's shapes (batch 2 = 4 CFG rows), and one UNet evaluation under
    torch.profiler with device time grouped by kernel family."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    dev, B, L = sd.device, 2, CONTEXT_LEN
    gen = torch.Generator(device=dev).manual_seed(5)
    x = torch.randn((2 * B, 64, 64, 4), generator=gen, device=dev)
    t = torch.full((2 * B,), 981, dtype=torch.int32, device=dev)
    ctx = torch.randn((2 * B, L, 768), generator=gen, device=dev)
    ctl = _control(B, dev, gen)
    z = torch.randn((B, 64, 64, 4), generator=gen, device=dev)
    ids_cond = np.zeros((B + B * OBJECTS, L), np.int32)   # captions + local contexts
    ids_uncond = np.zeros((B, L), np.int32)

    def host_s(fn, n=3):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / n

    with torch.inference_mode():
        unet_s = host_s(lambda: sd.unet(x, t, ctx, ctl))
        decode_s = host_s(lambda: sd.decode_latents(z))
        text_s = host_s(lambda: (sd.encode_text(ids_cond), sd.encode_text(ids_uncond)))
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            sd.unet(x, t, ctx, ctl)
            torch.cuda.synchronize()
    groups, launches = _families(prof)
    busy = sum(v for k, v in groups.items() if not k.startswith("("))
    _no_slices("profile", groups)
    evals = sd.schedule.num_steps + 1  # two at step 0, then one per step
    emit({"phase": "profile", "unet_eval_s": unet_s, "decode_s": decode_s, "text_s": text_s,
          "evals_per_batch": evals, "device_ms_by_family": groups or None,
          "device_busy_ms": busy if groups else None, "device_kernels": launches,
          "device_idle_share": (1.0 - busy / (1e3 * unet_s)) if groups else None})


def phase_geglu_host():
    """Host work per bf16 GEGLU call at each SD site (2 prompts): the
    forward through `geglu_ff` (inference mode) and `geglu_dx`.  Per call:
    `host_us`, the host's time to issue it (50 calls that queue on the card
    without a wait); `wrapper_ms`, CUDA events over the same calls back to
    back; `device_ms`, the kernels' device time under torch.profiler; and
    `host_gap_ms` = wrapper_ms - device_ms, what the wrapper adds to the
    card's time.  Only the wrappers' public signatures are used, so
    `--compare` runs this phase on the other tree's package too."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from diffusion_spacetime_attn_tpu_torch.ops import cuda_geglu

    n = 50
    for level, Lq, dim, _ in SITES:
        gen = torch.Generator(device="cuda").manual_seed(Lq + dim)
        x, w1, b1, w2, b2, res = _inputs("geglu", SERVE_PROMPTS, Lq, dim, torch.bfloat16, gen)
        dy = torch.randn(x.shape, generator=gen, device="cuda").to(x.dtype)
        row = {"phase": "geglu_host", "site": level, "M": x.shape[0], "dim": dim}
        for name, call in (("fwd", lambda: cuda_geglu.geglu_ff(x, w1, b1, w2, b2, res)),
                           ("dx", lambda: cuda_geglu.geglu_dx(x, w1, b1, w2, dy))):
            with torch.inference_mode():
                wrapper_ms = cuda_ms(call, n)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(n):
                    call()
                host_us = (time.perf_counter() - t0) / n * 1e6
                torch.cuda.synchronize()
                with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                    for _ in range(n):
                        call()
                    torch.cuda.synchronize()
            dev_us = sum(getattr(e, "self_device_time_total", 0.0) for e in prof.key_averages()
                         if e.device_type == torch.autograd.DeviceType.CUDA)
            device_ms = dev_us / 1e3 / n
            row[name] = {"host_us": host_us, "wrapper_ms": wrapper_ms, "device_ms": device_ms,
                         "host_gap_ms": wrapper_ms - device_ms}
        emit(row)


# one turn of `--compare`: phases that both trees have, in a fresh process
COMPARE_TURN = """
import json, sys
sys.path.insert(0, '.')
import torch
import chip_smoke as c
from diffusion_spacetime_attn_tpu_torch.config import PipelineConfig, UNetConfig, VAEConfig
from diffusion_spacetime_attn_tpu_torch.pipeline.pipeline import StableDiffusion

def bundle(**flags):
    cfg = PipelineConfig(unet=UNetConfig(dtype='bfloat16', use_mha=True, use_fused_ff=True,
                                         use_fused_control=True, **flags),
                         vae=VAEConfig(dtype='bfloat16'))
    return StableDiffusion.create(cfg, seed=0, device='cuda')

c.phase_device()
c.phase_build()
agg = c.phase_kernels()
agg.update(c.phase_kernels_bwd())
print(json.dumps({'phase': 'agg', 'agg': agg}), flush=True)
sd = bundle()
c.phase_profile(sd)
del sd
torch.cuda.empty_cache()
c.phase_profile_train(bundle(use_flash=True))
# this script's host-work phase, run on the package of the tree in the cwd
import importlib.util
spec = importlib.util.spec_from_file_location('this_smoke', sys.argv[1])
this = importlib.util.module_from_spec(spec)
spec.loader.exec_module(this)
this.phase_geglu_host()
"""


def compare_trees(other: str) -> int:
    """Phases device, build, kernels, kernels_bwd, profile and profile_train
    of `other` and of this tree in turns (other, this, this, other), each in
    a fresh process; prints every line of each turn tagged with the turn and
    the tree, then a summary per turn."""
    here = os.path.dirname(os.path.abspath(__file__))
    summary = []
    for turn, tree in enumerate([other, here, here, other], 1):
        t0 = time.perf_counter()
        run = subprocess.run([sys.executable, "-c", COMPARE_TURN, os.path.abspath(__file__)],
                             cwd=tree, capture_output=True, text=True)
        lines = [json.loads(ln) for ln in run.stdout.splitlines() if ln.startswith("{")]
        for ln in lines:
            emit({"turn": turn, "tree": tree, **ln})
        if run.returncode != 0:
            print(run.stdout[-3000:], run.stderr[-3000:], flush=True)
            fail(f"compare turn {turn} ({tree}) exited with {run.returncode}")
        by = {ln["phase"]: ln for ln in lines if ln["phase"] in ("agg", "profile",
                                                                  "profile_train")}
        host = {ln["site"]: {k: ln[k] for k in ("fwd", "dx")} for ln in lines
                if ln["phase"] == "geglu_host"}
        sites = {f"{ln['name']} {ln['site']}": ln["kernel_ms"] for ln in lines
                 if ln["phase"] in ("kernel", "kernel_bwd") and ln["dtype"] == "bfloat16"
                 and ln["prompts"] == SERVE_PROMPTS
                 and ln["name"].startswith(("flash", "mha", "geglu"))}
        summary.append({"phase": "compare", "turn": turn, "tree": tree,
                        "seconds": time.perf_counter() - t0,
                        "per_unet_eval_ms": {k: v["ms"] for k, v in by["agg"]["agg"].items()},
                        "site_ms": sites,
                        "serve_eval_busy_ms": by["profile"]["device_busy_ms"],
                        "serve_eval_family_ms": by["profile"]["device_ms_by_family"],
                        "train_eval_s": by["profile_train"]["train_eval_s"],
                        "train_eval_busy_ms": by["profile_train"]["device_busy_ms"],
                        "train_eval_family_ms": by["profile_train"]["device_ms_by_family"],
                        "geglu_host": host})
    for row in summary:
        emit(row)
    return 0


def main() -> int:
    if len(sys.argv) == 3 and sys.argv[1] == "--compare":
        return compare_trees(os.path.abspath(sys.argv[2]))
    name, smi = phase_device()
    phase_build()
    agg = phase_kernels()
    agg.update(phase_kernels_bwd())
    phase_unet()
    phase_slice()
    phase_chain()
    serve_launches, serve_designs, sd = phase_serve()
    phase_profile(sd)
    del sd
    import torch

    torch.cuda.empty_cache()
    launches, opt_designs, engine = phase_optimize()
    phase_profile_train(engine.sd)
    missing = [k for k in KERNELS if launches.get(k, 0) == 0]
    if missing:
        fail(f"kernels never launched on the optimization path: {missing}")
    by_design = {}
    for counts in (serve_designs, opt_designs):
        _add_counts(by_design, counts)

    rows = []
    for kname, meta in KERNELS.items():
        a = agg[kname]
        row = {"name": kname, **meta, "launches": launches[kname],
               "serve_launches": serve_launches.get(kname, 0),
               "max_abs_err": a["max_abs_err"], "ms": a["ms"], "plain_ms": a["plain_ms"],
               "bound_ms": a["bound_ms"],
               "bound_by": "operations" if a["flops_ms"] >= a["bytes_ms"] else "bytes",
               "library_ms": a["library_ms"]}
        if kname in by_design:   # the designs the serving and optimization runs took
            row["design"] = "+".join(d for d, n in sorted(by_design[kname].items()) if n)
            row["launches_by_design"] = by_design[kname]
        rows.append(row)
    # times: per UNet evaluation at the engine's batch of 2 prompts (each
    # kernel's sites: 16, flash 10 at levels 0 and 1, MHA timed at all 16;
    # bfloat16; the spacetime backward without dK/dV); launches: the
    # optimization run (2 batches), serve_launches: the serving run;
    # launches_by_design: both runs
    print(json.dumps({"kernels": rows}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    sys.exit(main())
