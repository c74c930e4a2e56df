"""Training step-time benchmark; port of the JAX package's
`scripts/bench_train.py`, with its flags and `--cpu`:

    python -m diffusion_spacetime_attn_tpu_torch.scripts.bench_train --what ldm
    python -m diffusion_spacetime_attn_tpu_torch.scripts.bench_train --what layout
    python -m diffusion_spacetime_attn_tpu_torch.scripts.bench_train --what ldm --tiny --cpu --iters 2

`--what layout`: the layout trainer's step (`training/layout_trainer.py`)
on `LayoutConfig()` (RoBERTa-base, float32) at batch 64, the reference's
`S.TRAIN.BATCH_SIZE`, over `--gpt3-pkl` rows (no default: the file is not
shipped), or JAX's 512 synthetic sentences when that flag is not given or
names no file; one step first, then `--iters` timed steps on distinct batches (`compile_s`, `s_per_step` the minimum), JAX's
metric name `layout_pretrain_step_b{batch}_{gpt-3.pkl|synthetic}`.  `--tiny`
does not apply to it.

`--what ldm`: the SD v1-4 UNet (860 M parameters; float32 parameters, bf16
compute by default), AdamW with EMA, no remat, batch 4 of latents
[B, 64, 64, 4] and text contexts [B, 77, 768] drawn from JAX's keys
(PRNGKey(1000 + i), split; the context N(0, 1)·0.02), seeded N(0, 0.02²)
weights.  One step first (`compile_s`: kernels loaded, allocator warmed),
then the minimum over `--iters` timed steps, each synchronized.  The UNet
runs the chain's kernel flags (`use_flash`, `use_fused_ff`) at full width;
JAX's bench leaves every flag off.  Prints one JSON line.  Runs on the
card and raises without one, unless `--cpu` is given.

`--mesh dp|fsdp` (`--what ldm`) trains over a data mesh
(`parallel/mesh.py`): torchrun's ranks, or else a one-rank group made here
(`--backend`; gloo with `--cpu`), each rank a batch of `--batch-size` rows
of the global batch, data-parallel or FSDP-sharded.  `--profile` runs one
more step under `torch.profiler` and adds the 25 entries with the most
host time (`profile`: name, calls, host ms, self host ms, device ms), the
optimizer's step and FSDP's hooks among them:

    python -m diffusion_spacetime_attn_tpu_torch.scripts.bench_train --what ldm --dtype float32 --batch-size 1 --iters 2 --mesh fsdp --profile
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import tempfile
import time

import numpy as np
import torch

from ..config import LayoutConfig, LayoutTrainConfig, LDMTrainConfig, ScheduleConfig, UNetConfig
from ..models.layout.model import create_layout_predictor
from ..models.unet import UNet
from ..ops.schedule import make_schedule
from ..parallel.mesh import add_mesh_args, make_mesh, mesh_from_env, shard_batch
from ..training import datasets
from ..training.layout_trainer import LayoutTrainer
from ..training.ldm_trainer import LDMTrainer
from ..utils import prng
from ..utils.testing import randomize_
from ..utils.tokenizer import make_roberta_tokenizer
from .layout_infer import pick_device


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--what", choices=["layout", "ldm"], required=True)
    ap.add_argument("--batch-size", type=int, default=None)
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--dtype", default="bfloat16")
    ap.add_argument("--no-ema", action="store_true")
    ap.add_argument("--tiny", action="store_true", help="tiny UNet (CPU smoke)")
    ap.add_argument("--gpt3-pkl", default=None,
                    help="layout data (--what layout); synthetic sentences without it")
    ap.add_argument("--cpu", action="store_true", help="run on the host CPU")
    ap.add_argument("--mesh", choices=["none", "dp", "fsdp"], default="none",
                    help="--what ldm over a data mesh: data-parallel or FSDP")
    ap.add_argument("--profile", action="store_true",
                    help="one more step under torch.profiler: the top entries by host time")
    add_mesh_args(ap)
    args = ap.parse_args(argv)
    if args.batch_size is None:
        args.batch_size = 64 if args.what == "layout" else 4
    return args


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize()


def bench_layout(args, device) -> dict:
    """-> the JSON line."""
    cfg = LayoutConfig()
    trainer = LayoutTrainer.create(cfg, LayoutTrainConfig(batch_size=args.batch_size))
    params = create_layout_predictor(cfg, seed=0, device=device)
    opt_state = trainer.init_state(params)
    tok = make_roberta_tokenizer()
    rng = np.random.RandomState(0)
    if args.gpt3_pkl is not None and os.path.exists(args.gpt3_pkl):
        examples, src = datasets.load_gpt3_examples(args.gpt3_pkl), "gpt-3.pkl"
    else:
        examples, src = datasets.synthetic_examples(512, rng), "synthetic"
    batch_list = []
    # cycle over the data until there are iters + 1 batches: a short source
    # must not time fewer steps
    while len(batch_list) < args.iters + 1:
        before = len(batch_list)
        for b in datasets.batches(examples, tok, args.batch_size, rng, max_len=cfg.max_len):
            batch_list.append(b.to(device))
            if len(batch_list) >= args.iters + 1:
                break
        if len(batch_list) == before:
            raise SystemExit(f"data source yields no full batch of {args.batch_size} "
                             f"({len(examples)} examples): lower --batch-size")
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    params, opt_state, loss, _ = trainer.train_step(params, opt_state, batch_list[0])
    float(loss)
    compile_s = time.perf_counter() - t0
    times = []
    for b in batch_list[1:]:
        _sync(device)
        t0 = time.perf_counter()
        params, opt_state, loss, _ = trainer.train_step(params, opt_state, b)
        float(loss)        # the step's end: its loss on the host
        times.append(time.perf_counter() - t0)
    line = {
        "metric": f"layout_pretrain_step_b{args.batch_size}_{src}",
        "iters": len(times),
        "s_per_step": min(times),
        "items_per_s": args.batch_size / min(times),
        "compile_s": compile_s,
        "times": times,
        "peak_bytes": torch.cuda.max_memory_allocated(device) if device.type == "cuda" else None,
        "device": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
    }
    return line


def _profile_top(step, device, n: int = 25) -> list:
    """step() once under torch.profiler -> the n entries with the most host
    time (ms; device ms where the card was traced)."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda" else [])
    with profile(activities=acts) as prof:
        step()
        _sync(device)
    rows = sorted(prof.key_averages(), key=lambda e: e.cpu_time_total, reverse=True)[:n]
    return [{"name": e.key, "calls": e.count, "host_ms": e.cpu_time_total / 1e3,
             "self_host_ms": e.self_cpu_time_total / 1e3,
             "device_ms": getattr(e, "device_time_total", 0.0) / 1e3} for e in rows]


def bench_ldm(args, device, on_step=None, mesh=None):
    """-> (the JSON line, the trainer, its state, batch_for).  on_step(i),
    when given, runs after each step's synchronization.  With `mesh`, each
    rank trains on its `--batch-size` rows of the global batch."""
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
    trainer = LDMTrainer(train_cfg, sched_cfg, make_schedule(sched_cfg, 50, device=device), unet,
                         mesh=mesh, fsdp=args.mesh == "fsdp")
    state = trainer.init()
    B, hw = args.batch_size * (1 if mesh is None else mesh.data), (16 if args.tiny else 64)

    def batch_for(i):
        k1, k2 = prng.split(prng.PRNGKey(1000 + i))
        x0 = torch.from_numpy(prng.normal(k1, (B, hw, hw, 4))).to(device)
        ctx = torch.from_numpy(prng.normal(k2, (B, 77, unet_cfg.context_dim))).to(device) * 0.02
        return (x0, ctx) if mesh is None else shard_batch(mesh, (x0, ctx))

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
    if mesh is not None:
        line.update(mesh=args.mesh, ranks=mesh.data, backend=mesh.backend)
    if args.profile:
        x0, ctx = batch_for(args.iters + 1)
        line["profile"] = _profile_top(
            lambda: trainer.train_step(state, x0, ctx, prng.fold_in(key, args.iters + 1)),
            device)
    return line, trainer, state, batch_for


@contextlib.contextmanager
def _mesh(args):
    """The run's mesh: None without `--mesh`; torchrun's ranks; or a
    one-rank group over a FileStore, destroyed on exit."""
    import torch.distributed as dist

    if args.mesh == "none":
        yield None
        return
    if args.what != "ldm":
        raise SystemExit("--mesh applies to --what ldm")
    backend = "gloo" if args.cpu else args.backend
    mesh = mesh_from_env(backend, args.cpu)
    if mesh is not None:
        yield mesh
        return
    with tempfile.TemporaryDirectory() as d:      # the store outlives the group
        mesh = make_mesh(backend=backend, device="cpu" if args.cpu else "cuda:0",
                         store=dist.FileStore(os.path.join(d, "store"), 1), rank=0,
                         world_size=1)
        try:
            yield mesh
        finally:
            dist.destroy_process_group()


def main(argv=None) -> dict:
    args = parse_args(argv)
    with _mesh(args) as mesh:
        device = mesh.device if mesh is not None else pick_device(args.cpu)
        line = (bench_layout(args, device) if args.what == "layout"
                else bench_ldm(args, device, mesh=mesh)[0])
    if mesh is None or mesh.writer:
        print(json.dumps(line))
    return line


if __name__ == "__main__":
    main()
