"""Capture a torch.profiler trace of one pipeline program; port of the JAX
package's `scripts/profiler.py`, with its flags and `--cpu` / `--remat`.

    python -m diffusion_spacetime_attn_tpu_torch.scripts.profiler --mode vanilla --batch 8 --steps 50
    python -m diffusion_spacetime_attn_tpu_torch.scripts.analyze_trace --trace-dir /tmp/dsta_trace
    python -m diffusion_spacetime_attn_tpu_torch.scripts.profiler --tiny --cpu --steps 3 --iters 1

One call first (the kernels built, the allocator warm), then `--iters`
calls under `utils/profiling.trace`, each ending in
`torch.cuda.synchronize()`; the Chrome trace (`*.pt.trace.json`) goes into
`--trace-dir`, and `scripts/analyze_trace.py` turns it into a per-kernel
table.  The program is JAX's: vanilla and spatial mode sample (no remat)
and decode; spacetime mode takes the gradient of the decoded images' sum
with respect to the [B, N, S] blend weights through the chain under
`--remat` (JAX's per-step remat by default; `dots` / `dots_nb` the
selective policies, `samplers/remat.py`).  The inputs are JAX's: text
embeddings, local contexts and centers from `np.random.RandomState(0)`, 4
objects at weight 1.25, x_T from `PRNGKey(i)` (JAX's bits,
`utils/prng.py`).  At full width: SD v1-4, bf16, bf16 scores, seeded
random weights, JAX's kernel flags per mode: flash in spacetime mode, MHA
and GEGLU otherwise.  `--tiny` takes JAX's tiny configs.  `--hlo-out` has
no counterpart (there is no XLA program text) and raises.  Prints one JSON
line: the trace file and the launches each kernel wrapper counted over the
traced calls.  Runs on the card and raises without one, unless `--cpu` is
given (a trace of CPU events only).
"""
from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from ..config import CLIPTextConfig, PipelineConfig, SpaceTimeConfig, UNetConfig, VAEConfig
from ..ops.attention import SpatialControl
from ..ops.cuda_lib import launch_counts
from ..pipeline.pipeline import StableDiffusion
from ..utils import prng
from ..utils.profiling import get_logger, trace
from .layout_infer import pick_device

N_OBJECTS = 4
REMAT = {"true": True, "false": False, "dots": "dots", "dots_nb": "dots_nb"}


def pipeline_config(mode: str, steps: int, tiny: bool = False) -> PipelineConfig:
    """JAX's profiler configs: the tiny one, or SD v1-4 in bf16 with bf16
    scores and JAX's per-mode kernel flags."""
    if tiny:
        return PipelineConfig(
            unet=UNetConfig(model_channels=32, channel_mult=(1, 2), num_res_blocks=1,
                            attention_resolutions=(1, 2), num_heads=2, context_dim=16),
            vae=VAEConfig(ch=32, ch_mult=(1, 2), num_res_blocks=1),
            text_encoder=CLIPTextConfig(width=16, layers=2, heads=2, vocab_size=100,
                                        max_len=7),
            spacetime=SpaceTimeConfig(num_steps=steps, latent_size=16, image_size=32))
    st = mode == "spacetime"
    return PipelineConfig(
        unet=UNetConfig(dtype="bfloat16", attn_scores_dtype="bfloat16",
                        use_flash=st, use_mha=not st, use_fused_ff=not st),
        vae=VAEConfig(dtype="bfloat16"),
        spacetime=SpaceTimeConfig(num_steps=steps))


def make_program(sd: StableDiffusion, mode: str, sampler: str, batch: int, grad: bool,
                 remat=None):
    """call(x_T) of JAX's program on `sd`'s device (the meta device too):
    CFG at 7.5, the chain from x_T, the decode; `grad`: (Σ images, its
    gradient in the blend weights) through the chain under `remat` (default:
    per-step remat in spacetime mode, none otherwise), else the images."""
    cfg, dev = sd.cfg, sd.device
    B, N, L, D = batch, N_OBJECTS, cfg.text_encoder.max_len, cfg.unet.context_dim
    r = np.random.RandomState(0)

    def arr(a):
        return torch.from_numpy(np.asarray(a, np.float32)).to(dev)

    cond, uncond = arr(r.randn(B, L, D) * 0.02), arr(r.randn(B, L, D) * 0.02)
    control = coef = None
    if mode in ("spatial", "spacetime"):
        control = SpatialControl(local_contexts=arr(r.randn(B, N, L, D) * 0.02),
                                 centers=arr(r.rand(B, N, 2)), coef=arr(np.full((B, N), 1.25)),
                                 active=arr(np.ones((B, N))))
        coef = arr(np.full((B, N, cfg.spacetime.num_steps), 1.25))
    if remat is None:
        remat = mode == "spacetime"

    def images(x_T, c):
        eps_fn = sd.make_eps_fn(cond, uncond, 7.5, control, c)
        return sd.decode_latents(sd.sample_from(eps_fn, x_T, sampler, remat=remat))

    if not grad:
        def call(x_T):
            with torch.no_grad():
                return images(x_T, coef)
        return call

    def call_grad(x_T):
        c = coef.clone().requires_grad_(True)
        with torch.enable_grad():
            total = images(x_T, c).sum()
            (dcoef,) = torch.autograd.grad(total, c)
        return total.detach(), dcoef
    return call_grad


def draw_x_T(sd: StableDiffusion, batch: int, key_seed: int) -> torch.Tensor:
    """x_T = jax.random.normal(PRNGKey(key_seed), [B, h, w, 4]) on `sd`'s device."""
    lat = sd.cfg.spacetime.latent_size
    x = prng.normal(prng.PRNGKey(key_seed), (batch, lat, lat, sd.cfg.unet.in_channels))
    return torch.from_numpy(x).to(sd.device)


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--mode", choices=["vanilla", "spatial", "spacetime"], default="vanilla")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--sampler", choices=["plms", "ddim", "dpm"], default="plms")
    ap.add_argument("--iters", type=int, default=2,
                    help="traced steady-state iterations (the first call excluded)")
    ap.add_argument("--trace-dir", default="/tmp/dsta_trace")
    ap.add_argument("--tiny", action="store_true", help="tiny model (CPU smoke)")
    ap.add_argument("--remat", choices=sorted(REMAT), default="true",
                    help="spacetime mode's chain: per-step remat, none, or a policy")
    ap.add_argument("--hlo-out", default=None, help="no counterpart here: raises")
    ap.add_argument("--cpu", action="store_true", help="run on the host CPU")
    args = ap.parse_args(argv)
    if args.hlo_out:
        raise NotImplementedError("--hlo-out: the port runs no XLA program, so there is no "
                                  "optimized HLO to write; the trace names the CUDA kernels")
    device = pick_device(args.cpu)
    logger = get_logger("profile")

    sd = StableDiffusion.create(pipeline_config(args.mode, args.steps, args.tiny),
                                seed=0, device=device)
    st = args.mode == "spacetime"
    call = make_program(sd, args.mode, args.sampler, args.batch, grad=st,
                        remat=REMAT[args.remat] if st else False)
    logger.info("first call (kernels built)…")
    call(draw_x_T(sd, args.batch, 0))
    sync(device)
    logger.info("tracing %d iterations → %s", args.iters, args.trace_dir)
    before = launch_counts()
    with trace(args.trace_dir) as path:
        for i in range(args.iters):
            call(draw_x_T(sd, args.batch, i + 1))
            sync(device)
    after = launch_counts()
    line = {"trace": path, "mode": args.mode, "batch": args.batch, "steps": args.steps,
            "sampler": args.sampler, "iters": args.iters, "device": str(device),
            "launches": {k: after[k] - before[k] for k in after}}
    print(json.dumps(line), flush=True)
    logger.info("done — python -m diffusion_spacetime_attn_tpu_torch.scripts.analyze_trace "
                "--trace-dir %s", args.trace_dir)
    return line


if __name__ == "__main__":
    main()
