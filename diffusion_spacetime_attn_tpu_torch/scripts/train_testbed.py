"""Train the closed-loop testbed's models: tiny VAE, tiny CLIP, tiny LDM.
Port of the JAX package's `scripts/train_testbed.py`, with its flags and
defaults and `--cpu`:

    python -m diffusion_spacetime_attn_tpu_torch.scripts.train_testbed --ckpt-dir saved/testbed_port
    python -m diffusion_spacetime_attn_tpu_torch.scripts.train_testbed --cpu --scenes 64 \\
        --vae-steps 2 --clip-steps 2 --ldm-steps 2 --chunk 1 --vae-batch 4 --clip-batch 8 \\
        --ldm-batch 4 --ckpt-dir /tmp/tb --data-cache /tmp/tb/scenes.npz

Stages (each saves into --ckpt-dir and can run alone):
  data       build and cache the scene dataset (host, deterministic)
  vae        AutoencoderKL on the 64×64 scenes (L1 + KL; GAN and LPIPS off)
  clip       the contrastive dual-tower CLIP on truthful captions (the judge)
  ldm        the conditional UNet on VAE latents (captions carry no position)
  calibrate  the vanilla guidance scale with the best validation recall
  all        everything in order

Every draw is JAX's (`utils/prng.py`): key = PRNGKey(1234); chunk c of a
stage draws from fold_in(key, c) and its step k from fold_in(·, k), split
and drawn as the JAX script draws them (batch indices by `randint`, the
latent sample by `normal`, caption dropout by `uniform`).  JAX scans a chunk
with `lax.scan`; this loops over it with the same draws in the same order,
and runs whole chunks as JAX does.  Initial weights are flax-like and
seeded (`utils/testing.init_flax_like_`, not flax's bits); `main(init=...)`
takes flat flax trees instead.  The bundle is written in flax's msgpack
layout (`testbed/bundle.save_bundle`), so JAX's `load_bundle` reads it.
Every model is float32 with every kernel flag off, as in JAX's testbed.
Runs on the card and raises without one, unless `--cpu` is given.
"""
from __future__ import annotations

import argparse
import json
import logging
import os
import time

import numpy as np
import torch

from ..config import LDMTrainConfig
from ..eval.metrics import object_recall
from ..models.clip import CLIP, CLIPTextTower
from ..models.unet import UNet
from ..models.vae import AutoencoderKL
from ..ops.schedule import make_schedule
from ..testbed import data as tbdata
from ..testbed import oracle
from ..testbed import scenes as tbscenes
from ..testbed.bundle import load_bundle, save_bundle
from ..testbed.configs import IMAGE_SIZE, testbed_clip_cfg, testbed_pipeline_cfg
from ..training.clip_trainer import make_clip_train_step, retrieval_accuracy
from ..training.ldm_trainer import init_state, make_train_step
from ..training.vae_trainer import VAETrainConfig, VAETrainer
from ..utils import prng
from ..utils.msgpack import load_flat as read_tree
from ..utils.profiling import JsonLogger
from ..utils.testing import init_flax_like_
from ..utils.weights import flax_flat, load_flat
from .layout_infer import pick_device

STAGES = ("vae", "clip", "ldm", "calibrate")
GUIDANCE_SCALES = (1.5, 3.0, 5.0, 7.5)

logger = logging.getLogger("train_testbed")


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--stage", default="all", choices=["data", *STAGES, "all"])
    ap.add_argument("--ckpt-dir", default="saved/testbed")
    ap.add_argument("--data-cache", default="/tmp/testbed_scenes.npz")
    ap.add_argument("--scenes", type=int, default=8192)
    ap.add_argument("--data-seed", type=int, default=0)
    ap.add_argument("--vae-steps", type=int, default=4000)
    ap.add_argument("--vae-batch", type=int, default=128)
    ap.add_argument("--vae-lr", type=float, default=2e-4)
    ap.add_argument("--clip-steps", type=int, default=6000)
    ap.add_argument("--clip-batch", type=int, default=512)
    ap.add_argument("--clip-lr", type=float, default=1e-3)
    ap.add_argument("--ldm-steps", type=int, default=40000)
    ap.add_argument("--ldm-batch", type=int, default=512)
    ap.add_argument("--ldm-lr", type=float, default=3e-4)
    ap.add_argument("--ema-decay", type=float, default=0.9995)
    ap.add_argument("--uncond-drop", type=float, default=0.1)
    ap.add_argument("--chunk", type=int, default=100,
                    help="optimizer steps per chunk (one key per chunk, as JAX's scan)")
    ap.add_argument("--cpu", action="store_true", help="run on the host CPU")
    return ap.parse_args(argv)


class _Run:
    """The stages' shared state: flags, device, dataset, key and log."""

    def __init__(self, args, device, ds):
        self.args, self.device, self.ds = args, device, ds
        self.key = prng.PRNGKey(1234)
        self.jlog = JsonLogger(os.path.join(args.ckpt_dir, "train_log.jsonl"))
        self.history = {}

    def chunks(self, body, total_steps: int, tag: str):
        """Run whole chunks of `args.chunk` steps; body(r) -> {metric: tensor}
        for step key r.  Logs the last step of about 20 chunks, as JAX's
        `run_chunks`; returns the last logged metrics."""
        chunk = self.args.chunk
        n_chunks = (total_steps + chunk - 1) // chunk
        last, hist = None, self.history.setdefault(tag, [])
        for c in range(n_chunks):
            rng0 = prng.fold_in(self.key, c)
            for k in range(chunk):
                ms = body(prng.fold_in(rng0, k))
                hist.append({name: float(v) for name, v in ms.items()})
            if c % max(1, n_chunks // 20) == 0 or c == n_chunks - 1:
                last = hist[-1]
                logger.info("%s chunk %d/%d %s", tag, c + 1, n_chunks, last)
                self.jlog.log(f"{tag}_chunk", chunk=c + 1, **last)
        return last


def _u8(a: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def _take(t: torch.Tensor, idx: np.ndarray) -> torch.Tensor:
    return t[torch.from_numpy(idx.astype(np.int64)).to(t.device)]


def stage_vae(run: _Run, cfg, init=None) -> dict:
    """AutoencoderKL on the scenes; saves vae.msgpack and the measured latent
    scale factor 1/std(mean)."""
    args, dev, ds = run.args, run.device, run.ds
    vae = AutoencoderKL(cfg.vae).to(dev)
    tcfg = VAETrainConfig(base_lr=args.vae_lr, perceptual_weight=0.0, disc_start=10 ** 9,
                          disc_ndf=8, disc_layers=1, kl_weight=1e-6)
    trainer = VAETrainer(vae, tcfg)
    state = trainer.init(seed=0)
    if init is not None:
        load_flat(vae, init["vae"])
        load_flat(trainer.disc, init["disc"])
    images = _u8(ds["images"], dev)

    def body(r):
        nonlocal state
        i_r, s_r = prng.split(r)
        idx = prng.randint(i_r, (args.vae_batch,), 0, images.shape[0])
        imgs = _take(images, idx).float() / 127.5 - 1.0
        state, m = trainer.train_step(state, imgs, s_r)
        return {"rec": m["rec_loss"], "kl": m["kl_loss"]}

    run.chunks(body, args.vae_steps, "vae")
    with torch.no_grad():
        sample = _u8(ds["images"][:2048], dev).float() / 127.5 - 1.0
        mean, _ = vae.encode_moments(sample)
        scale_factor = float(1.0 / mean.cpu().numpy().std())
        test = _u8(ds["images"][-512:], dev).float() / 127.5 - 1.0
        recon = vae.decode(vae.encode_moments(test)[0])
        rec_l1 = float(torch.mean(torch.abs(recon - test)))
    logger.info("vae: scale_factor=%.4f recon_l1=%.4f", scale_factor, rec_l1)
    meta = {"scale_factor": scale_factor, "vae_recon_l1": rec_l1, "vae_steps": args.vae_steps,
            "scenes": args.scenes, "data_seed": args.data_seed}
    save_bundle(args.ckpt_dir, vae_params=flax_flat(vae), meta=meta)
    return meta


def stage_clip(run: _Run, init=None) -> dict:
    """The dual-tower CLIP on truthful captions; saves clip.msgpack and its
    held-out retrieval accuracy."""
    args, dev, ds = run.args, run.device, run.ds
    clip = CLIP(testbed_clip_cfg()).to(dev)
    M = len(ds["clip_images"])
    perm = np.random.RandomState(7).permutation(M)
    n_val = min(2048, M // 4)
    tr, va = perm[:-n_val], perm[-n_val:]
    imgs_dev = _u8(ds["clip_images"][tr], dev)
    toks_dev = _u8(ds["clip_tokens"][tr], dev)
    if init is None:
        init_flax_like_(clip, 3)
    else:
        load_flat(clip, init)
    init_fn, step_fn = make_clip_train_step(clip, lr=args.clip_lr)
    state = init_fn()

    def body(r):
        nonlocal state
        idx = prng.randint(r, (args.clip_batch,), 0, imgs_dev.shape[0])
        # [0, 1] images, not CLIP-normalized: the DCLIP loss feeds CLIP so
        state, m = step_fn(state, _take(imgs_dev, idx).float() / 255.0, _take(toks_dev, idx))
        return {"loss": m["loss"], "acc": m["acc_i2t"]}

    run.chunks(body, args.clip_steps, "clip")
    val_acc = retrieval_accuracy(clip, ds["clip_images"][va].astype(np.float32) / 255.0,
                                 ds["clip_tokens"][va])
    logger.info("clip: held-out retrieval accuracy %.3f", val_acc)
    meta = {"clip_retrieval_acc": val_acc, "clip_steps": args.clip_steps,
            "clip_logit_scale": float(state.logit_scale.detach())}
    save_bundle(args.ckpt_dir, clip_params=flax_flat(clip), meta=meta)
    return meta


def stage_ldm(run: _Run, cfg, init=None) -> dict:
    """The conditional UNet on the VAE's latents with the frozen CLIP text
    tower's contexts; saves the EMA weights as unet.msgpack."""
    args, dev, ds = run.args, run.device, run.ds
    with open(os.path.join(args.ckpt_dir, "meta.json")) as f:
        scale = float(json.load(f)["scale_factor"])
    vae_tree = read_tree(os.path.join(args.ckpt_dir, "vae.msgpack"))
    clip_tree = read_tree(os.path.join(args.ckpt_dir, "clip.msgpack"))
    vae = load_flat(AutoencoderKL(cfg.vae).to(dev), vae_tree).requires_grad_(False)
    text = CLIPTextTower(cfg.text_encoder).to(dev)
    load_flat(text, {k[len("text/"):]: v for k, v in clip_tree.items()
                     if k.startswith("text/")}).requires_grad_(False)

    means, logvars, ctxs = [], [], []
    with torch.no_grad():
        for i in range(0, len(ds["images"]), 1024):
            m, lv = vae.encode_moments(_u8(ds["images"][i:i + 1024], dev).float() / 127.5 - 1.0)
            means.append(m)
            logvars.append(lv)
            ctxs.append(text(_u8(ds["ldm_tokens"][i:i + 1024], dev))[0])
        uncond = text(_u8(tbscenes.tokenize("")[None], dev))[0][0]
    mean, logvar, ctx = torch.cat(means), torch.cat(logvars), torch.cat(ctxs)
    logger.info("ldm: precomputed %s moments + %s contexts", tuple(mean.shape), tuple(ctx.shape))

    tcfg = LDMTrainConfig(batch_size=args.ldm_batch, base_lr=args.ldm_lr, scale_lr=False,
                          use_ema=True, ema_decay=args.ema_decay)
    schedule = make_schedule(cfg.schedule, cfg.spacetime.num_steps, device=dev)
    unet = UNet(cfg.unet, radius=cfg.spacetime.radius).to(dev)
    if init is None:
        init_flax_like_(unet, 5, unet.zero_init_modules())
    else:
        load_flat(unet, init)
    state = init_state(tcfg, cfg.schedule, unet, tcfg.base_lr)
    step = make_train_step(tcfg, cfg.schedule, schedule, unet)
    B = args.ldm_batch

    def body(r):
        nonlocal state
        ri, rz, rd, rn = prng.split(r, 4)
        idx = prng.randint(ri, (B,), 0, mean.shape[0])
        m, lv = _take(mean, idx), _take(logvar, idx)
        z = (m + torch.exp(0.5 * lv) * prng.normal_like(rz, m)) * scale
        # classifier-free guidance's caption dropout (10 % unconditional rows)
        drop = torch.from_numpy(prng.uniform(rd, (B, 1, 1)) < args.uncond_drop).to(dev)
        c = torch.where(drop, uncond[None], _take(ctx, idx))
        state, ms = step(state, z, c, rn)
        return {"loss": ms["loss_simple"]}

    last = run.chunks(body, args.ldm_steps, "ldm")
    meta = {"ldm_steps": args.ldm_steps, "ldm_loss_simple": last["loss"],
            "ldm_lr": args.ldm_lr, "ema_decay": args.ema_decay,
            "uncond_drop": args.uncond_drop}
    save_bundle(args.ckpt_dir, unet_params=flax_flat(unet, state.ema_params, norm_scope=True),
                meta=meta)
    return meta


def stage_calibrate(run: _Run, prompts: int = 32, num_steps: int = 50) -> dict:
    """The vanilla guidance scale with the best oracle recall on `prompts`
    validation prompts (PLMS-`num_steps`, x_T from PRNGKey(101))."""
    args, dev = run.args, run.device
    bundle = load_bundle(args.ckpt_dir, num_steps=num_steps, device=dev)
    sd = bundle.sd
    prompts = tbscenes.make_eval_prompts(prompts, seed=555)
    table = {}
    with torch.no_grad():
        cond = bundle.encode_captions([p.caption for p in prompts])
        uncond = bundle.encode_captions([""]).expand(cond.shape)
        L = sd.cfg.spacetime.latent_size
        x_T = torch.from_numpy(prng.normal(prng.PRNGKey(101), (len(prompts), L, L, 4))).to(dev)
        gts = [[p.cat_a, p.cat_b] for p in prompts]
        for gs in GUIDANCE_SCALES:
            eps = sd.make_eps_fn(cond, uncond, gs)
            imgs = sd.decode_latents(sd.sample_from(eps, x_T, sampler="plms", remat=False))
            dets = [oracle.detect(im) for im in imgs.cpu().numpy()]
            table[gs] = round(object_recall(dets, gts)[2], 4)
            logger.info("calibrate: gs=%.1f recall=%.3f", gs, table[gs])
    best = max(table, key=table.get)
    meta = {"guidance_scale": best,
            "guidance_calibration": {str(k): v for k, v in table.items()}}
    save_bundle(args.ckpt_dir, meta=meta)
    logger.info("calibrate: guidance_scale=%s %s", best, table)
    return meta


def main(argv=None, init=None) -> dict:
    """Run the stages; returns {"seconds": {stage: s}, "meta": {...},
    "history": {stage: per-step metrics}}.  `init` = {"vae": flat AE tree,
    "disc": flat discriminator tree (batch_stats included), "clip": ...,
    "unet": ...} replaces the seeded initial weights."""
    args = parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(name)s %(message)s")
    device = pick_device(args.cpu)
    os.makedirs(args.ckpt_dir, exist_ok=True)
    init = init or {}
    cfg = testbed_pipeline_cfg()
    seconds, meta = {}, {}
    t0 = time.perf_counter()
    ds = tbdata.cached_dataset(args.data_cache, n_scenes=args.scenes, seed=args.data_seed,
                               canvas=IMAGE_SIZE)
    seconds["data"] = time.perf_counter() - t0
    logger.info("dataset: %d scenes, %d clip examples (%.1fs)", len(ds["images"]),
                len(ds["clip_images"]), seconds["data"])
    run = _Run(args, device, ds)
    if args.stage != "data":
        for stage in (STAGES if args.stage == "all" else (args.stage,)):
            t0 = time.perf_counter()
            if stage == "vae":
                meta.update(stage_vae(run, cfg, init if "vae" in init else None))
            elif stage == "clip":
                meta.update(stage_clip(run, init.get("clip")))
            elif stage == "ldm":
                meta.update(stage_ldm(run, cfg, init.get("unet")))
            else:
                meta.update(stage_calibrate(run))
            if device.type == "cuda":
                torch.cuda.synchronize()
            seconds[stage] = time.perf_counter() - t0
    run.jlog.close()
    return {"seconds": seconds, "meta": meta, "history": run.history}


if __name__ == "__main__":
    main()
