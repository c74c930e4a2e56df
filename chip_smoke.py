#!/usr/bin/env python3
"""On-card smoke test of the PyTorch / CUDA port (`diffusion_spacetime_attn_tpu_torch`).

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases, each printed as one JSON object per line; any failure raises and the
script exits non-zero without its final line:

  1. device: the card's name and power limit; TF32 off for the comparisons.
  2. build:  the CUDA kernels from `diffusion_spacetime_attn_tpu_torch/csrc`,
             with nvcc's register / shared-memory / spill report.
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
             off by log 2 on one query tile) at every shape.
     kernels_bwd: each backward kernel the same way at every chain shape, in
             bf16 and float32 at 1 and 2 prompts (flash: bf16 at 1 and 2, f32
             at 1), every cotangent (dK/dV included); planted faults: one
             object's blend products zeroed, the last key tile dropped from
             dKc or dK, a skipped inner tile in dx, di zeroed on one query
             tile of the flash backward.  The flash backward's yardstick is
             the backward of `scaled_dot_product_attention` under autograd.
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
             sites x 51 UNet evaluations).
  8. profile: where a serving batch's time goes (host clock per part, and
             device time by kernel family under torch.profiler).
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
             coef moved on active slots, 0 on padded ones.
 10. profile_train: one training UNet evaluation (forward, recompute,
             backward) by kernel family, and the plain MHA backward that is
             left (levels 2 and mid).
 11. the `kernels` summary line (times per UNet evaluation at the engine's
     batch; launches of the optimization run), the nvidia-smi line, and the
     final {"ok": true, ...} line.

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


BWD_NAMES = ("dq_c", "dg_u", "dkc", "dvc", "dlk", "dlv", "dmasks", "dcoef")
SPLASH = "jax/experimental/pallas/ops/tpu/splash_attention/splash_attention_kernel.py"

KERNELS = {
    "spacetime_fwd": dict(
        route="cuda", source="diffusion_spacetime_attn_tpu_torch/csrc/spacetime_fwd.cu",
        replaces="diffusion_spacetime_attn_tpu/ops/pallas_spacetime.py:44"),
    "spacetime_bwd": dict(
        route="cuda", source="diffusion_spacetime_attn_tpu_torch/csrc/spacetime_bwd.cu",
        replaces="diffusion_spacetime_attn_tpu/ops/pallas_spacetime.py:152"),
    "geglu_fwd": dict(
        route="cuda", source="diffusion_spacetime_attn_tpu_torch/csrc/geglu_fwd.cu",
        replaces="diffusion_spacetime_attn_tpu/ops/pallas_geglu.py:126"),
    "geglu_bwd": dict(
        route="cuda", source="diffusion_spacetime_attn_tpu_torch/csrc/geglu_bwd.cu",
        replaces="diffusion_spacetime_attn_tpu/ops/pallas_geglu.py:244"),
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
            or "Compiling entry" in ln]
    emit({"phase": "build", "seconds": time.perf_counter() - t0, "path": info["path"],
          "ptxas": keep})


def _outs(x):
    return x if isinstance(x, tuple) else (x,)


def _planted_faults(kind: str, args, kern):
    """Outputs of the kernel with a planted fault, which the comparison with
    the plain version must reject: a skipped key tile (the last 64 keys; 32
    at L = 64) or a 5 % wrong softmax scale for attention, the log-sum-exp
    off by log 2 on the first query tile for flash, a skipped 64-wide inner
    tile for GEGLU, and only the first 64 of the 77 context keys for the
    spacetime blend."""
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
        return faults
    if kind == "geglu":
        w2 = args[3].clone()
        w2[:, :64] = 0
        return {"skip_inner_tile": kern(args[:3] + (w2,) + args[4:])}
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
                got = _outs(kern(args))
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
                       "prompts": prompts, "Lq": Lq, "inner": inner, "max_abs_err": max_err,
                       "rel_norm": cmp["rel_norm"], "atol": cmp["atol"], "rtol": cmp["rtol"],
                       "rel_norm_limit": cmp["rel_norm_limit"], "deterministic": True,
                       "planted_faults_rejected": faults, "kernel_ms": ms, "plain_ms": plain_ms,
                       "bound_us": 1e3 * b_ms, "bound_by": b_by, "flops": flops,
                       "bytes": nbytes, "library_ms": lib_ms,
                       "fraction_of_bound": b_ms / ms}
                if kind == "flash":
                    row["lse_max_abs_err"] = cmps[1]["max_abs_err"]
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
    a skipped 64-wide inner tile for the GEGLU dx; the last key tile dropped
    from dK, or di zeroed on the first query tile, for the flash backward."""
    from diffusion_spacetime_attn_tpu_torch.ops import cuda_flash, cuda_geglu, cuda_spacetime

    if kind == "flash":
        q, k, v, o, lse, g = args
        dq, dk, dv = cuda_flash.flash_bwd(q, k, v, o, lse, g, heads)
        cut = dk.clone()
        cut[:, -64:] = 0
        di = cuda_flash.row_dot(o, g, heads)
        di[:, :64] = 0
        return {"last_key_tile_dropped_from_dk": (dq, cut, dv),
                "di_zeroed_on_one_query_tile": cuda_flash.flash_bwd_raw(
                    cuda_flash.scaled_query(q, k, heads), k, v, g, lse, di, heads,
                    cuda_flash.query_scale(q, heads))}
    if kind == "geglu":
        x, w1, b1, w2, dy = args
        w2 = w2.clone()
        w2[:, :64] = 0
        return {"skip_inner_tile": (cuda_geglu.geglu_dx(x, w1, b1, w2, dy),)}
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
                got, again, want = kern(args), kern(args), plain(args)
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
                       "prompts": prompts, "Lq": Lq, "inner": inner, "errors": errs,
                       "max_abs_err": max_err, "deterministic": True,
                       "planted_faults_rejected_rel_norm": faults, "kernel_ms": ms,
                       "kernel_ms_with_dkv": kv_ms, "plain_ms": plain_ms,
                       "bound_us": 1e3 * b_ms, "bound_by": b_by, "flops": flops,
                       "bytes": nbytes, "library_ms": lib_ms, "fraction_of_bound": b_ms / ms}
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
    for prompts, sds in zip(requests, seeds):
        for w in wrappers.values():
            w.launches = 0
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
          "launches": launches})
    return launches, sd


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
        for w in wrappers.values():
            w.launches = 0
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
    images, launches, batch_s = [], {k: 0 for k in wrappers}, []
    torch.cuda.reset_peak_memory_stats()
    for prompts, sds in zip(requests, seeds):
        for w in wrappers.values():
            w.launches = 0
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
          "launches": launches})
    return launches, engine


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
    emit({"phase": "profile_train", "train_eval_s": host_s, "device_ms_by_family": groups or None,
          "device_busy_ms": busy if groups else None, "device_kernels": kernels,
          "device_idle_share": (1.0 - busy / (1e3 * host_s)) if groups else None})


FAMILIES = [("flash_fwd", ("flash_fwd_",)), ("flash_bwd", ("flash_bwd_",)),
            ("mha_fwd", ("mha_fwd_",)), ("spacetime_fwd", ("spacetime_fwd_kernel",)),
            ("spacetime_bwd", ("spacetime_bwd_",)), ("geglu_fwd", ("geglu_partial",)),
            ("geglu_bwd", ("geglu_dx_partial",)), ("geglu_sum_slices", ("sum_slices",)),
            ("convolution", ("conv", "implicit", "cudnn", "fprop", "dgrad", "wgrad")),
            ("matmul", ("gemm", "cutlass", "cublas", "nvjet", "xmma")),
            ("softmax", ("softmax",)), ("norm", ("norm",))]


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
    evals = sd.schedule.num_steps + 1  # two at step 0, then one per step
    emit({"phase": "profile", "unet_eval_s": unet_s, "decode_s": decode_s, "text_s": text_s,
          "evals_per_batch": evals, "device_ms_by_family": groups or None,
          "device_busy_ms": busy if groups else None, "device_kernels": launches,
          "device_idle_share": (1.0 - busy / (1e3 * unet_s)) if groups else None})


def main() -> int:
    name, smi = phase_device()
    phase_build()
    agg = phase_kernels()
    agg.update(phase_kernels_bwd())
    phase_unet()
    phase_slice()
    phase_chain()
    serve_launches, sd = phase_serve()
    phase_profile(sd)
    del sd
    import torch

    torch.cuda.empty_cache()
    launches, engine = phase_optimize()
    phase_profile_train(engine.sd)
    missing = [k for k in KERNELS if launches.get(k, 0) == 0]
    if missing:
        fail(f"kernels never launched on the optimization path: {missing}")

    rows = []
    for kname, meta in KERNELS.items():
        a = agg[kname]
        rows.append({"name": kname, **meta, "launches": launches[kname],
                     "serve_launches": serve_launches.get(kname, 0),
                     "max_abs_err": a["max_abs_err"], "ms": a["ms"], "plain_ms": a["plain_ms"],
                     "bound_ms": a["bound_ms"],
                     "bound_by": "operations" if a["flops_ms"] >= a["bytes_ms"] else "bytes",
                     "library_ms": a["library_ms"]})
    # times: per UNet evaluation at the engine's batch of 2 prompts (each
    # kernel's sites: 16, flash 10 at levels 0 and 1, MHA timed at all 16;
    # bfloat16; the spacetime backward without dK/dV); launches: the
    # optimization run (2 batches), serve_launches: the serving run
    print(json.dumps({"kernels": rows}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    sys.exit(main())
