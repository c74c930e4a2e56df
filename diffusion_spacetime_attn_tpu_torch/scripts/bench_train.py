"""Training step-time benchmark; port of the JAX package's
`scripts/bench_train.py` `--what ldm`, with its flags and `--cpu`:

    python -m diffusion_spacetime_attn_tpu_torch.scripts.bench_train --what ldm
    python -m diffusion_spacetime_attn_tpu_torch.scripts.bench_train --what ldm --tiny --cpu --iters 2

`--what ldm`: the SD v1-4 UNet (860 M parameters; float32 parameters, bf16
compute by default), AdamW with EMA, no remat, batch 4 of latents
[B, 64, 64, 4] and text contexts [B, 77, 768] drawn from JAX's keys
(PRNGKey(1000 + i), split; the context N(0, 1)·0.02), seeded N(0, 0.02²)
weights.  One step first (`compile_s`: kernels loaded, allocator warmed),
then the minimum over `--iters` timed steps, each synchronized.  The UNet
runs the chain's kernel flags (`use_flash`, `use_fused_ff`) at full width;
JAX's bench leaves every flag off.  `--what layout` raises: the layout
trainer is ROADMAP A.12's remainder.  Prints one JSON line.  Runs on the
card and raises without one, unless `--cpu` is given.
"""
from __future__ import annotations

import argparse
import json
import time

import torch

from ..config import LDMTrainConfig, ScheduleConfig, UNetConfig
from ..models.unet import UNet
from ..ops.schedule import make_schedule
from ..training.ldm_trainer import LDMTrainer
from ..utils import prng
from ..utils.testing import randomize_
from .layout_infer import pick_device


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--what", choices=["layout", "ldm"], required=True)
    ap.add_argument("--batch-size", type=int, default=None)
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--dtype", default="bfloat16")
    ap.add_argument("--no-ema", action="store_true")
    ap.add_argument("--tiny", action="store_true", help="tiny UNet (CPU smoke)")
    ap.add_argument("--gpt3-pkl", default=None, help="layout data (--what layout)")
    ap.add_argument("--cpu", action="store_true", help="run on the host CPU")
    args = ap.parse_args(argv)
    if args.batch_size is None:
        args.batch_size = 64 if args.what == "layout" else 4
    return args


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize()


def bench_ldm(args, device, on_step=None):
    """-> (the JSON line, the trainer, its state, batch_for).  on_step(i),
    when given, runs after each step's synchronization."""
    if args.tiny:
        unet_cfg = UNetConfig(model_channels=32, channel_mult=(1, 2), num_res_blocks=1,
                              attention_resolutions=(1, 2), num_heads=2, context_dim=16,
                              dtype=args.dtype)
    else:
        unet_cfg = UNetConfig(dtype=args.dtype, use_flash=True, use_fused_ff=True)
    sched_cfg = ScheduleConfig()
    train_cfg = LDMTrainConfig(batch_size=args.batch_size, use_ema=not args.no_ema)
    with torch.device(device):
        unet = UNet(unet_cfg, radius=0.2)
    randomize_(unet, 1)
    trainer = LDMTrainer(train_cfg, sched_cfg, make_schedule(sched_cfg, 50, device=device), unet)
    state = trainer.init()
    B, hw = args.batch_size, (16 if args.tiny else 64)

    def batch_for(i):
        k1, k2 = prng.split(prng.PRNGKey(1000 + i))
        x0 = torch.from_numpy(prng.normal(k1, (B, hw, hw, 4))).to(device)
        ctx = torch.from_numpy(prng.normal(k2, (B, 77, unet_cfg.context_dim))).to(device) * 0.02
        return x0, ctx

    key = prng.PRNGKey(42)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    x0, ctx = batch_for(0)
    t0 = time.perf_counter()
    state, metrics = trainer.train_step(state, x0, ctx, prng.fold_in(key, 0))
    _sync(device)
    compile_s = time.perf_counter() - t0
    if on_step:
        on_step(0)
    times, losses = [], [float(metrics["loss"])]
    for i in range(1, args.iters + 1):
        x0, ctx = batch_for(i)
        _sync(device)
        t0 = time.perf_counter()
        state, metrics = trainer.train_step(state, x0, ctx, prng.fold_in(key, i))
        _sync(device)
        times.append(time.perf_counter() - t0)
        losses.append(float(metrics["loss"]))
        if on_step:
            on_step(i)
    line = {
        "metric": f"ldm_v1_train_step_b{args.batch_size}_{args.dtype}"
                  + ("" if args.no_ema else "_ema"),
        "s_per_step": min(times),
        "items_per_s": args.batch_size / min(times),
        "compile_s": compile_s,
        "times": times,
        "losses": losses,
        "peak_bytes": torch.cuda.max_memory_allocated(device) if device.type == "cuda" else None,
        "device": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
    }
    return line, trainer, state, batch_for


def main(argv=None) -> dict:
    args = parse_args(argv)
    if args.what == "layout":
        raise NotImplementedError("--what layout: the layout trainer "
                                  "(training/layout_trainer.py) is not ported yet (ROADMAP A.12)")
    line = bench_ldm(args, pick_device(args.cpu))[0]
    print(json.dumps(line))
    return line


if __name__ == "__main__":
    main()
