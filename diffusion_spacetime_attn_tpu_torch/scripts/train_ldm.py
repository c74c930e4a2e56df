"""LDM (UNet) training CLI; port of the JAX package's `scripts/train_ldm.py`
(reference `attention_optimization/stable-diffusion/main.py`), with its flags
and defaults and `--cpu`:

    python -m diffusion_spacetime_attn_tpu_torch.scripts.train_ldm --synthetic --steps 3
    python -m diffusion_spacetime_attn_tpu_torch.scripts.train_ldm --tiny --cpu --steps 4 \\
        --conditioning class --ckpt-every 2 --ckpt-dir /tmp/ldm

Conditioning: `text` (cross-attention on a [B, 77, 768] context, SD-style),
`class` (a `ClassEmbedder` trained with the UNet, cin256-style) or `none`
(the unconditional UNet).  Data: `--synthetic` random latents and contexts
(numpy's RandomState(step), as in JAX); it is also what runs without
`--data-dir`.  `--conditioning superres` concatenates a low-resolution image
on the UNet's input channels (7 in, the unconditional UNet); its synthetic
rows are `training/degradation.degradation_bsrgan_light` of RandomState(step)
images.  `--data-dir` with text conditioning reads `captions.jsonl`
({"file", "text"} per line): RandomState(step) picks the rows, the images are
opened (`utils/image_io.py`: PNG, JPEG, BMP, WebP) and resized to the VAE's
input with PIL's default filter (`utils/resample.py`, PIL-exact), encoded
by the VAE on JAX's key PRNGKey(step) and the captions by the CLIP text
tower; with class conditioning it reads an ImageNet-style synset tree
(`training/image_data.imagenet_tree`, labels the sorted synset index).  The
VAE and text tower are seeded random (no checkpoint flag in JAX either);
`--tiny` takes the tiny VAE and text tower of `run_dataset.tiny_configs`
(JAX's script builds the full-width ones under `--tiny`, whose 768-wide
context the tiny UNet cannot take).  `--unet-ckpt` warm-starts from a
CompVis SD v1 checkpoint (`utils/convert.convert_sd_unet`).

Several devices: under `torchrun --nproc-per-node N` (`--backend nccl`,
one card per rank; `--backend gloo` with `--cpu`, or ranks sharing a card)
the run is data-parallel over the N ranks, as the JAX script is over its
devices: `--batch-size` is per device (the global batch is N times it),
the learning rate scales by N, every rank makes the same global batch and
trains on its rows, and rank 0 alone writes the log and the checkpoints.
`--fsdp` shards the UNet, AdamW's moments and EMA over the ranks; on one
device it warns and is ignored, as in JAX.

At full width the UNet runs the chain's kernel flags, `use_flash` (levels 0
and 1) and `use_fused_ff` (every transformer block), with no control: the
JAX script leaves every flag off.  Initial weights are flax-like and seeded
(`utils/testing.init_flax_like_`); the step's keys are JAX's,
fold_in(PRNGKey(42), step).  Checkpoints are the port's own
(`LDMTrainer.save`: `<ckpt-dir>/step_<n>.pt`); `--resume-step` reads one,
or the JAX script's orbax `<ckpt-dir>/step_<n>/` where no `.pt` is there.
Runs on the card and raises without one, unless `--cpu` is given.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import logging
import os
import time

import numpy as np
import torch
from torch import nn

from ..config import LDMTrainConfig, PipelineConfig, ScheduleConfig, UNetConfig
from ..models.clip import CLIPTextTower
from ..models.encoders import ClassEmbedder
from ..models.layers import cast_matmul_weights
from ..models.unet import UNet
from ..models.vae import AutoencoderKL
from ..ops.schedule import make_schedule
from ..parallel.mesh import add_mesh_args, mesh_from_env, normal_rows, rows
from ..training.degradation import degradation_bsrgan_light
from ..training.image_data import imagenet_tree
from ..training.ldm_trainer import LDMTrainer
from ..utils import convert, prng
from ..utils.image_io import open_image
from ..utils.profiling import JsonLogger
from ..utils.resample import resize
from ..utils.testing import init_flax_like_, randomize_
from ..utils.tokenizer import make_clip_tokenizer, padded
from ..utils.weights import flatten_tree, load_flat
from .layout_infer import pick_device
from .run_dataset import tiny_configs

logger = logging.getLogger("train_ldm")


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--data-dir", default=None, help="directory with images + captions.jsonl")
    ap.add_argument("--synthetic", action="store_true",
                    help="random latents / contexts (smoke and benchmark mode)")
    ap.add_argument("--steps", type=int, default=1000)
    ap.add_argument("--batch-size", type=int, default=4, help="per device")
    ap.add_argument("--base-lr", type=float, default=1e-4)
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--no-ema", action="store_true")
    ap.add_argument("--dtype", default="bfloat16")
    ap.add_argument("--ckpt-dir", default="saved/ldm")
    ap.add_argument("--ckpt-every", type=int, default=500)
    ap.add_argument("--resume-step", type=int, default=None)
    ap.add_argument("--log-every", type=int, default=50)
    ap.add_argument("--unet-ckpt", default=None, help="warm start from sd-v1-4 (CompVis ckpt)")
    ap.add_argument("--tiny", action="store_true", help="tiny UNet (CPU smoke)")
    ap.add_argument("--conditioning", default="text",
                    choices=["text", "class", "superres", "none"])
    ap.add_argument("--num-classes", type=int, default=1000)
    ap.add_argument("--fsdp", action="store_true",
                    help="shard the state over devices (one device here: ignored)")
    ap.add_argument("--sr-factor", type=int, default=4)
    ap.add_argument("--cpu", action="store_true", help="run on the host CPU")
    add_mesh_args(ap)
    return ap.parse_args(argv)


class ClassConditioned(nn.Module):
    """The UNet with a jointly trained `ClassEmbedder` context (the
    reference's cond_stage_trainable, `encoders/modules.py:21-33`); the
    context is the class id as float [B, 1]."""

    def __init__(self, unet: UNet, cond: ClassEmbedder):
        super().__init__()
        self.unet, self.cond = unet, cond

    def forward(self, x, t, context):
        return self.unet(x, t, self.cond(context[:, 0]))


class SuperRes(nn.Module):
    """The unconditional UNet on the noisy latent with the low-resolution
    image concatenated on its channels (`DiffusionWrapper`'s 'concat')."""

    def __init__(self, unet: UNet):
        super().__init__()
        self.unet = unet

    def forward(self, x, t, context):
        return self.unet(torch.cat([x, context.to(x.dtype)], dim=-1), t)


class Unconditional(nn.Module):
    """The unconditional UNet behind the trainer's (x, t, context) call; the
    context is a placeholder."""

    def __init__(self, unet: UNet):
        super().__init__()
        self.unet = unet

    def forward(self, x, t, context):
        return self.unet(x, t)


def configs(args):
    """(UNetConfig, latent size, context shape) of the flags."""
    in_ch = 4 + (3 if args.conditioning == "superres" else 0)
    if args.tiny:
        cfg = UNetConfig(model_channels=32, channel_mult=(1, 2), num_res_blocks=1,
                         attention_resolutions=(1, 2), num_heads=2, context_dim=16,
                         dtype=args.dtype, in_channels=in_ch)
        return cfg, 16, (7, 16)
    cfg = UNetConfig(dtype=args.dtype, use_flash=True, use_fused_ff=True, in_channels=in_ch)
    return cfg, 64, (77, 768)


def data_encoders(args, device):
    """(VAE, CLIP text tower) that turn `--data-dir` images and captions
    into latents and contexts: seeded N(0, 0.02²) weights, eval mode, the
    matmul weights in the compute dtype.  Only the VAE follows `--dtype`:
    JAX's script builds `PipelineConfig(vae=VAEConfig(dtype=args.dtype))`
    and leaves the text tower at its own (float32)."""
    cfg = tiny_configs(1)[0] if args.tiny else PipelineConfig()
    vcfg = dataclasses.replace(cfg.vae, dtype=args.dtype)
    with torch.device(device):
        vae, text = AutoencoderKL(vcfg), CLIPTextTower(cfg.text_encoder)
    for m, seed in ((vae, 2), (text, 3)):
        cast_matmul_weights(m).eval().requires_grad_(False)
        randomize_(m, seed, 0.02)
    return vae, text


def build_model(args, unet_cfg: UNetConfig, device) -> nn.Module:
    """The trained module for the conditioning mode, float32 parameters."""
    with torch.device(device):
        unet = UNet(unet_cfg, radius=0.2,
                    conditional=args.conditioning not in ("none", "superres"))
    if args.unet_ckpt:
        sd = convert.load_torch_checkpoint(args.unet_ckpt)
        load_flat(unet, flatten_tree(convert.convert_sd_unet(
            sd, channel_mult=unet_cfg.channel_mult, num_res_blocks=unet_cfg.num_res_blocks,
            attention_ds=unet_cfg.attention_resolutions)))
    else:
        init_flax_like_(unet, 0, unet.zero_init_modules())
    if args.conditioning == "class":
        with torch.device(device):
            cond = ClassEmbedder(args.num_classes, unet_cfg.context_dim)
        return ClassConditioned(unet, init_flax_like_(cond, 1))
    if args.conditioning == "superres":
        return SuperRes(unet)
    if args.conditioning == "none":
        return Unconditional(unet)
    return unet


def synthetic_batches(args, B: int, latent_hw: int, ctx_shape, device, mesh=None):
    """next_batch(i) -> (x0, context), numpy's RandomState(i) draws of the
    global batch of B as JAX's script makes them; with `mesh`, this rank's
    rows of it."""
    mine = slice(None) if mesh is None else rows(mesh, B)

    def tensor(a):
        return torch.from_numpy(np.ascontiguousarray(a[mine]).astype(np.float32)).to(device)

    def next_batch(i):
        r = np.random.RandomState(i)
        if args.conditioning == "superres":      # synthetic HQ -> BSRGAN-light LR
            hq = r.rand(B, latent_hw * args.sr_factor, latent_hw * args.sr_factor,
                        3).astype(np.float32)
            lrs = np.stack([degradation_bsrgan_light(hq[b], sf=args.sr_factor, seed=i * B + b)[0]
                            for b in range(B)[mine]])
            return tensor(r.randn(B, latent_hw, latent_hw, 4)), \
                torch.from_numpy((lrs * 2.0 - 1.0).astype(np.float32)).to(device)
        x0 = r.randn(B, latent_hw, latent_hw, 4)
        if args.conditioning == "class":
            ctx = r.randint(0, args.num_classes, (B, 1))
        elif args.conditioning == "none":
            ctx = np.zeros((B, 1))
        else:
            ctx = r.randn(B, *ctx_shape)
        return tensor(x0), tensor(ctx)
    return next_batch


def folder_batches(args, B: int, latent_hw: int, device, encoders, mesh=None):
    """next_batch(i) -> (latents, context) from `--data-dir`, as JAX's
    script makes them: text, RandomState(i) rows of captions.jsonl; class,
    the synset tree's `batches(B, seed=0)`.  Latents are the VAE's posterior
    sample on PRNGKey(i) times the scale factor.  With `mesh`, this rank's
    rows of the global batch of B: the picks, the flips and the posterior
    noise are drawn for the global batch, and only this rank's images are
    read, encoded and captioned."""
    vae, text = encoders
    factor = 2 ** (len(vae.cfg.ch_mult) - 1)
    size = latent_hw * factor                 # 512 at SD width, as JAX resizes
    mine = slice(None) if mesh is None else rows(mesh, B)

    def encode(imgs, i):
        with torch.no_grad():
            mean, logvar = vae.encode_moments(torch.from_numpy(imgs).to(device))
            z = mean + torch.exp(0.5 * logvar) * normal_rows(prng.PRNGKey(i), mean, mesh)
        return z * vae.cfg.scale_factor

    if args.conditioning == "class":
        it = imagenet_tree(args.data_dir, size=size).batches(B, seed=0, rows=mine)

        def next_batch(i):
            imgs, labels = next(it)
            return (encode(imgs, i),
                    torch.from_numpy(labels[:, None].astype(np.float32)).to(device))
        return next_batch
    if args.conditioning != "text":
        raise SystemExit(f"--data-dir loading implements text and class conditioning; use "
                         f"--synthetic with --conditioning {args.conditioning}")
    with open(os.path.join(args.data_dir, "captions.jsonl")) as f:
        captions = [json.loads(line) for line in f]
    L = text.cfg.max_len
    tokenize = padded(make_clip_tokenizer(max_len=L), L)

    def next_batch(i):
        r = np.random.RandomState(i)
        pick = [captions[j] for j in r.randint(0, len(captions), B)[mine]]
        imgs = np.stack([resize(open_image(os.path.join(args.data_dir, p["file"]), "RGB"),
                                (size, size)) / 127.5 - 1.0 for p in pick]).astype(np.float32)
        ids = np.stack([tokenize(p["text"]) for p in pick]).astype(np.int64)
        with torch.no_grad():
            ctx = text(torch.from_numpy(ids).to(device))[0]
        return encode(imgs, i), ctx.float()
    return next_batch


def main(argv=None, init=None, encoders=None) -> dict:
    """Train; returns {"metrics": [per logged step], "step_s": [s per step],
    "host_s": [s per step making the batch], "steps": n, "first_batch":
    (x0, context) of the first step}.  `init`: a flat JAX tree of the
    trained module's initial weights (the UNet's; class conditioning's
    `unet/...` and `cond/...`) instead of the seeded flax-like ones;
    `encoders`: the (VAE, text tower) of `--data-dir` instead of seeded
    ones."""
    args = parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(name)s %(message)s")
    mesh = mesh_from_env(args.backend, args.cpu)
    if args.fsdp and mesh is None:
        logger.warning("--fsdp ignored: single device (no mesh to shard state over) — "
                       "training runs fully replicated")
    device = mesh.device if mesh is not None else pick_device(args.cpu)
    ndev = 1 if mesh is None else mesh.data
    writer = mesh is None or mesh.writer
    if not writer:                            # rank 0 alone logs
        logger.setLevel(logging.WARNING)
    unet_cfg, latent_hw, ctx_shape = configs(args)
    sched_cfg = ScheduleConfig()
    train_cfg = LDMTrainConfig(batch_size=args.batch_size, base_lr=args.base_lr,
                               accum_steps=args.accum, use_ema=not args.no_ema)
    model = build_model(args, unet_cfg, device)
    root = model.unet if isinstance(model, (SuperRes, Unconditional)) else model
    if init is not None:
        load_flat(root, init)
    trainer = LDMTrainer(train_cfg, sched_cfg, make_schedule(sched_cfg, 50, device=device),
                         model, mesh=mesh, ckpt_dir=args.ckpt_dir,
                         fsdp=args.fsdp and mesh is not None, params_root=root)
    logger.info("devices=%d lr=%.2e (scaled)", ndev, trainer.lr)
    state = trainer.init()
    start = 0
    if args.resume_step is not None:
        state = trainer.restore(args.resume_step, state)
        start = args.resume_step
        logger.info("resumed from step %d", start)
    B = args.batch_size * ndev                # per-device batch semantics, as in JAX
    if args.data_dir and not args.synthetic:        # each rank its rows of the global batch
        next_batch = folder_batches(args, B, latent_hw, device,
                                    encoders or data_encoders(args, device), mesh)
    else:
        next_batch = synthetic_batches(args, B, latent_hw, ctx_shape, device, mesh)

    if writer:
        os.makedirs(args.ckpt_dir, exist_ok=True)
    jlog = JsonLogger(os.path.join(args.ckpt_dir, "train_log.jsonl")) if writer else None
    key = prng.PRNGKey(42)
    logged, step_s, host_s, first = [], [], [], None
    for i in range(start, args.steps):
        t0 = time.perf_counter()
        x0, ctx = next_batch(i)
        host_s.append(time.perf_counter() - t0)
        first = first if first is not None else (x0, ctx)
        state, metrics = trainer.train_step(state, x0, ctx, prng.fold_in(key, i))
        m = {k: float(v) for k, v in metrics.items()}   # waits for the step
        step_s.append(time.perf_counter() - t0)
        if (i + 1) % args.log_every == 0 or i == start:
            logger.info("step %d %s", i + 1, m)
            if jlog is not None:
                jlog.log("ldm_train_step", step=i + 1, **m)
            logged.append({"step": i + 1, **m})
        if (args.ckpt_every and (i + 1) % args.ckpt_every == 0) or i + 1 == args.steps:
            trainer.save(state, i + 1)
            logger.info("checkpoint @ %d", i + 1)
    if jlog is not None:
        jlog.close()
    return {"metrics": logged, "step_s": step_s, "host_s": host_s, "steps": state.step,
            "first_batch": first}


if __name__ == "__main__":
    main()
