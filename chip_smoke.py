#!/usr/bin/env python3
"""On-card smoke test of the PyTorch / CUDA port (`diffusion_spacetime_attn_tpu_torch`).

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases, each printed as one JSON object per line; any failure raises and the
script exits non-zero without its final line:

  1. device: the card's name and power limit; TF32 off for the comparisons.
  2. build:  the CUDA kernels from `diffusion_spacetime_attn_tpu_torch/csrc`,
             with nvcc's register / shared-memory / spill report.
  3. kernels: each kernel against its plain PyTorch version at every shape
             of the SD v1-4 serving path, in bfloat16 at one prompt (CFG
             rows = 2) and at the engine's batch of 2 prompts, and in
             float32 at one prompt (tolerances in `utils/testing.py`), with
             times (CUDA events), the plain version's time, the roofline
             bound and, for attention, the time of
             `scaled_dot_product_attention` as a yardstick.  Each kernel must
             give the same bits when launched twice on the same inputs, and
             the comparison must reject planted faults (a skipped key tile,
             a 5 % wrong scale, a skipped inner tile) at every shape.
  4. unet:   one full-width SD v1-4 UNet evaluation (bfloat16, 4 active
             objects, seeded weights) with the three kernel flags on and off.
  5. slice:  the full-width pipeline in float32 (text encoder, controlled
             PLMS with 4 steps, VAE decode), kernels on vs off.
  6. serve:  TextToImageEngine at full SD v1-4 width (UNet, VAE, ViT-L/14 text
             tower), PLMS-50, batch 2, 4 objects per prompt: 3 requests in
             two batches, the second padded; it repeats the first request
             (prompt, seed) beside a pad row, which must give the same bytes.
             Every kernel must be launched 816 times per batch (16 sites x
             51 UNet evaluations).
  7. profile: where a serving batch's time goes (host clock per part, and
             device time by kernel family under torch.profiler).
  8. the `kernels` summary line (times per UNet evaluation at the engine's
     batch), the nvidia-smi line, and the final {"ok": true, ...} line.

The weights are random (no checkpoint is loaded): N(0, 0.02²) per parameter
from a seed, as the JAX package's bench does.
"""
from __future__ import annotations

import json
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
HEADS, OBJECTS, CONTEXT_LEN = 8, 4, 77
SERVE_PROMPTS = 2               # the engine's batch size
LAUNCHES_PER_BATCH = 16 * 51
SLICE_STEPS = 4                 # PLMS steps of the float32 on-vs-off check

KERNELS = {
    "spacetime_fwd": dict(
        route="cuda", source="diffusion_spacetime_attn_tpu_torch/csrc/spacetime_fwd.cu",
        replaces="diffusion_spacetime_attn_tpu/ops/pallas_spacetime.py:44"),
    "geglu_fwd": dict(
        route="cuda", source="diffusion_spacetime_attn_tpu_torch/csrc/geglu_fwd.cu",
        replaces="diffusion_spacetime_attn_tpu/ops/pallas_geglu.py:126"),
    "mha_fwd": dict(
        route="cuda", source="diffusion_spacetime_attn_tpu_torch/csrc/mha_fwd.cu",
        replaces="diffusion_spacetime_attn_tpu/ops/pallas_mha.py:79"),
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


def _planted_faults(kind: str, args, kern):
    """Outputs of the kernel with a planted fault, which the comparison with
    the plain version must reject: a skipped key tile (the last 64 keys; 32
    at L = 64) or a 5 % wrong softmax scale for attention, a skipped 64-wide
    inner tile for GEGLU, and only the first 64 of the 77 context keys for
    the spacetime blend."""
    if kind == "mha":
        q, k, v = args
        L = k.shape[1]
        keep = L - (64 if L > 64 else 32)
        return {"skip_key_tile": kern((q, k[:, :keep].contiguous(), v[:, :keep].contiguous())),
                "scale_x1.05": kern(((q.float() * 1.05).to(q.dtype), k, v))}
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
    if kind == "mha":
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


def phase_kernels():
    """Every kernel vs its plain version at every main-path shape: in bf16 at
    one prompt (CFG rows = 2) and at the serving batch of SERVE_PROMPTS, and
    in f32 at one prompt.  Returns per-kernel aggregates over one UNet
    evaluation at the serving batch (bf16 sites x counts)."""
    import torch
    import torch.nn.functional as F

    from diffusion_spacetime_attn_tpu_torch.ops import cuda_geglu, cuda_mha, cuda_spacetime
    from diffusion_spacetime_attn_tpu_torch.utils.testing import compare

    impl = {
        "mha": ("mha_fwd", lambda a: cuda_mha.mha_attention(*a, HEADS),
                lambda a: cuda_mha.mha_attention_plain(*a, HEADS),
                lambda a, it: cuda_mha.mha_cost(a[0].shape[0], a[0].shape[1], a[1].shape[1],
                                                a[0].shape[2], it)),
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
            for level, Lq, inner, count in SITES:
                case += 1
                gen.manual_seed(case)
                args = _inputs(kind, prompts, Lq, inner, dtype, gen)
                got = kern(args)
                again = kern(args)
                want = plain(args)
                torch.cuda.synchronize()
                cmp = compare(got, want, kind)
                if not cmp["ok"]:
                    fail(f"{name} {level} {dtype_name} {prompts} prompt(s): {cmp}")
                if not torch.equal(got, again):
                    fail(f"{name} {level} {dtype_name}: two launches on the same inputs differ")
                faults = {}
                for fault, out in _planted_faults(kind, args, kern).items():
                    fcmp = compare(out, want, kind)
                    if fcmp["ok"]:
                        fail(f"{name} {level} {dtype_name}: planted fault {fault} passes {fcmp}")
                    faults[fault] = {"rel_norm": fcmp["rel_norm"],
                                     "max_abs_err": fcmp["max_abs_err"]}
                max_err = cmp["max_abs_err"]
                ms = cuda_ms(lambda: kern(args), 20)
                plain_ms = cuda_ms(lambda: plain(args), 5)
                flops, nbytes = cost(args, args[0].element_size())
                b_ms, b_by = bound_ms(flops, nbytes, dtype_name)
                lib_ms = None
                if kind == "mha":
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
    families = [("mha_fwd", ("mha_fwd_",)), ("spacetime_fwd", ("spacetime_fwd_kernel",)),
                ("geglu_fwd", ("geglu_partial", "geglu_finalize")),
                ("convolution", ("conv", "implicit", "cudnn", "xmma", "fprop")),
                ("matmul", ("gemm", "cutlass", "cublas", "nvjet")),
                ("softmax", ("softmax",)), ("norm", ("norm",))]
    groups, launches = {}, 0
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", 0.0)
        name = e.key.lower()
        fam = next((f for f, keys in families if any(k in name for k in keys)), "other")
        groups[fam] = groups.get(fam, 0.0) + us / 1e3
        launches += e.count
    busy = sum(groups.values())
    evals = sd.schedule.num_steps + 1  # two at step 0, then one per step
    emit({"phase": "profile", "unet_eval_s": unet_s, "decode_s": decode_s, "text_s": text_s,
          "evals_per_batch": evals, "device_ms_by_family": groups or None,
          "device_busy_ms": busy if groups else None, "device_kernels": launches,
          "device_idle_share": (1.0 - busy / (1e3 * unet_s)) if groups else None})


def main() -> int:
    name, smi = phase_device()
    phase_build()
    agg = phase_kernels()
    phase_unet()
    phase_slice()
    launches, sd = phase_serve()
    phase_profile(sd)
    import torch

    rows = []
    for kname, meta in KERNELS.items():
        a = agg[kname]
        rows.append({"name": kname, **meta, "launches": launches[kname],
                     "max_abs_err": a["max_abs_err"], "ms": a["ms"], "plain_ms": a["plain_ms"],
                     "bound_ms": a["bound_ms"],
                     "bound_by": "operations" if a["flops_ms"] >= a["bytes_ms"] else "bytes",
                     "library_ms": a["library_ms"]})
    # times: per UNet evaluation at the engine's batch (all 16 sites, bfloat16)
    print(json.dumps({"kernels": rows}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    sys.exit(main())
