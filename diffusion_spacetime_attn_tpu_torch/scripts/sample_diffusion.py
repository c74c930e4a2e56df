"""Unconditional LDM sampling; port of the JAX package's
`scripts/sample_diffusion.py` (reference
`attention_optimization/stable-diffusion/scripts/sample_diffusion.py`), with
its flags and defaults and `--cpu`.

    python -m diffusion_spacetime_attn_tpu_torch.scripts.sample_diffusion -n 8 -l samples/ldm
    python -m diffusion_spacetime_attn_tpu_torch.scripts.sample_diffusion --tiny --cpu -n 2 -c 3

The UNet is the unconditional one (self-attention in the cross-attention
slot of every block).  The chain is DDIM at `--custom-steps` with `--eta`
(default 1.0: a σ·z draw at every step), or with `--vanilla` the full DDPM
chain over the train schedule; the VAE decodes.  Noise follows the JAX
script's key tree (`utils/prng.py`): PRNGKey(seed) -> r1, r2, rng =
split(·, 3); per batch rng, k = split(rng); k_init, k_chain = split(k);
x_T = normal(k_init), and k_chain feeds the chain (DDIM only when eta > 0).
Writes `{idx:06}.png` per sample, with `--npz` `samples.npz` (uint8), and
`sampling_config.json` (the JAX script's flags) into `--logdir`.

`--ckpt-dir` holds trainer states of `scripts/train_ldm.py`: the JAX
script's orbax `step_<n>/` directories (`utils/orbax.py`) or the port's
`step_<n>.pt` files.  As in JAX, `--ckpt-step` picks one, else the newest;
its EMA weights are taken when it holds them, else its params, and a log
line says which (`restore_unet`).  The UNet's config comes from the flags.
Without `--ckpt-dir` the UNet's weights are seeded and random (smoke mode).
The VAE's are seeded and random, or from `--vae-ckpt` (a CompVis
checkpoint) when given.  At
full width the UNet runs self-attention through the MHA kernel and the
feed-forward through the GEGLU kernel (`use_mha`, `use_fused_ff`), which the
JAX script leaves off.  Runs on the card and raises without one, unless
`--cpu` is given.
"""
from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from ..config import ScheduleConfig, UNetConfig, VAEConfig
from ..models.layers import cast_matmul_weights
from ..models.unet import UNet
from ..models.vae import AutoencoderKL
from ..ops.schedule import make_schedule
from ..pipeline.runners import save_image
from ..samplers.ddim import ddim_sample
from ..samplers.ddpm import ddpm_sample
from ..utils import convert, orbax, prng
from ..utils.cudnn import deterministic
from ..utils.testing import randomize_
from ..utils.weights import flatten_tree, load_flat
from .layout_infer import pick_device


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("-n", "--n-samples", type=int, default=8)
    ap.add_argument("--batch-size", type=int, default=4)
    ap.add_argument("--vanilla", action="store_true",
                    help="full DDPM chain (reference vanilla mode); default DDIM")
    ap.add_argument("-c", "--custom-steps", type=int, default=50,
                    help="DDIM steps (ignored with --vanilla)")
    ap.add_argument("-e", "--eta", type=float, default=1.0,
                    help="DDIM eta (reference default 1.0)")
    ap.add_argument("--clip-denoised", action="store_true",
                    help="clamp predicted x0 to [-1,1] (pixel-space DDPM default)")
    ap.add_argument("-l", "--logdir", default="samples/ldm")
    ap.add_argument("--ckpt-dir", default=None,
                    help="train_ldm states: JAX's orbax step_<n>/ or the port's step_<n>.pt")
    ap.add_argument("--ckpt-step", type=int, default=None)
    ap.add_argument("--vae-ckpt", default=None,
                    help="first-stage weights (CompVis sd ckpt or HF dir)")
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--dtype", default="bfloat16")
    ap.add_argument("--npz", action="store_true",
                    help="also write adm-style uint8 .npz of all samples")
    ap.add_argument("--tiny", action="store_true", help="tiny model (CI/CPU smoke)")
    ap.add_argument("--cpu", action="store_true", help="run on the host CPU")
    return ap.parse_args(argv)


def configs(args):
    """(UNetConfig, VAEConfig, latent side, ScheduleConfig) of the JAX
    script; at full width with the MHA and GEGLU kernels on."""
    if args.tiny:
        return (UNetConfig(model_channels=32, channel_mult=(1, 2), num_res_blocks=1,
                           attention_resolutions=(1, 2), num_heads=2, dtype=args.dtype),
                VAEConfig(ch=32, ch_mult=(1, 2), num_res_blocks=1, dtype=args.dtype),
                16, ScheduleConfig(num_train_timesteps=32))
    return (UNetConfig(dtype=args.dtype, use_mha=True, use_fused_ff=True),
            VAEConfig(dtype=args.dtype), 64, ScheduleConfig())


def build_models(unet_cfg: UNetConfig, vae_cfg: VAEConfig, device, vae_ckpt=None):
    """(unconditional UNet, AutoencoderKL) on `device` in their compute
    dtypes: seeded random weights (UNet seed 1, VAE seed 2), the VAE's from
    a CompVis checkpoint when `vae_ckpt` is given."""
    with torch.device(device):
        unet = UNet(unet_cfg, radius=0.2, conditional=False)
        vae = AutoencoderKL(vae_cfg)
    for m in (unet, vae):
        cast_matmul_weights(m).eval().requires_grad_(False)
    randomize_(unet, 1, 0.02)
    if vae_ckpt:
        state = convert.load_torch_checkpoint(vae_ckpt)
        load_flat(vae, flatten_tree(convert.convert_sd_vae(
            state, ch_mult=vae_cfg.ch_mult, num_res_blocks=vae_cfg.num_res_blocks)))
    else:
        randomize_(vae, 2, 0.02)
    return unet, vae


def restore_unet(unet: UNet, ckpt_dir: str, step=None):
    """Load a trainer state's UNet weights into `unet` -> (step, "ema" or
    "raw"): step `step`, else the newest `step_<n>` (an orbax directory of
    the JAX trainer or the port's `.pt`), its EMA weights where it holds
    them, else its params (JAX `scripts/sample_diffusion.py:96-115`)."""
    found = {}
    for name in os.listdir(ckpt_dir):
        stem = name[:-3] if name.endswith(".pt") else name
        if stem.startswith("step_") and stem[5:].isdigit():
            found[int(stem[5:])] = os.path.join(ckpt_dir, name)
    if not found:
        raise FileNotFoundError(f"{ckpt_dir}: no step_<n> checkpoint")
    step = max(found) if step is None else int(step)
    if step not in found:
        raise FileNotFoundError(f"{ckpt_dir}: no step_{step} (have {sorted(found)})")
    path = found[step]
    if os.path.isdir(path):
        st = orbax.restore(path)
        tree = st.get("ema_params") if st.get("ema_params") is not None else st["params"]
        kind = "ema" if st.get("ema_params") is not None else "raw"
        load_flat(unet, flatten_tree(orbax.to_float32(tree)))
    else:                                  # the port's LDMTrainer.save of an unconditional run
        st = torch.load(path, map_location="cpu", weights_only=True)
        kind = "ema" if st.get("ema") is not None else "raw"
        src = st["ema"] if kind == "ema" else st["params"]
        pre = "unet." if all(k.startswith("unet.") for k in src) else ""
        own = unet.state_dict()
        with torch.no_grad():
            for k, v in own.items():
                v.copy_(src[pre + k].to(v.dtype) if pre + k in src else
                        st["params"][pre + k].to(v.dtype))
    return step, kind


@torch.inference_mode()
def sample_batch(unet: UNet, vae: AutoencoderKL, key: np.ndarray, batch: int, latent_hw: int,
                 sched_cfg: ScheduleConfig, custom_steps: int = 50, eta: float = 1.0,
                 vanilla: bool = False, clip_denoised: bool = False) -> torch.Tensor:
    """One batch of the JAX script's `run`: images [batch, H, W, 3] in
    [0, 1] from the batch key."""
    device = next(unet.parameters()).device
    k_init, k_chain = prng.split(key)
    shape = (batch, latent_hw, latent_hw, unet.cfg.in_channels)
    x_T = torch.from_numpy(prng.normal(k_init, shape)).to(device)

    def eps_fn(x, t, i):
        return unet(x, torch.full((x.shape[0],), int(t), dtype=torch.int32, device=device))

    with deterministic():
        if vanilla:
            z = ddpm_sample(eps_fn, x_T, sched_cfg, k_chain, clip_denoised=clip_denoised,
                            remat=False)
        else:
            sched = make_schedule(sched_cfg, min(custom_steps, sched_cfg.num_train_timesteps),
                                  eta=eta, device=device)
            z = ddim_sample(eps_fn, x_T, sched, rng=k_chain if eta > 0 else None, remat=False)
        img = vae.decode(z / vae.cfg.scale_factor)
    return torch.clamp((img + 1.0) / 2.0, 0.0, 1.0)


def main(argv=None, models=None) -> dict:
    """Sample and write; returns {"images": [n, H, W, 3] float32 numpy,
    "seconds"}.  `models` = (unet, vae) replaces the seeded weights."""
    args = parse_args(argv)
    device = pick_device(args.cpu)
    unet_cfg, vae_cfg, latent_hw, sched_cfg = configs(args)
    rng = prng.PRNGKey(args.seed)
    _, _, rng = prng.split(rng, 3)          # r1, r2: the JAX script's init keys
    if models is None:
        models = build_models(unet_cfg, vae_cfg, device, args.vae_ckpt)
        if not args.ckpt_dir:
            print("no --ckpt-dir: sampling with random weights (smoke mode)")
    unet, vae = models
    if args.ckpt_dir:
        step, kind = restore_unet(unet, args.ckpt_dir, args.ckpt_step)
        print(f"restored {args.ckpt_dir} step {step} ({kind})")
    os.makedirs(args.logdir, exist_ok=True)
    B, imgs = args.batch_size, []
    t0 = time.perf_counter()
    for b in range(-(-args.n_samples // B)):
        rng, k = prng.split(rng)
        batch = sample_batch(unet, vae, k, B, latent_hw, sched_cfg, args.custom_steps,
                             args.eta, args.vanilla, args.clip_denoised).float().cpu().numpy()
        imgs.append(batch)
        for j in range(batch.shape[0]):
            idx = b * B + j
            if idx >= args.n_samples:
                break
            save_image(batch[j], os.path.join(args.logdir, f"{idx:06}.png"))
    seconds = time.perf_counter() - t0
    print(f"sampled {args.n_samples} images in {seconds:.1f}s -> {args.logdir}")
    arr = np.concatenate(imgs, axis=0)[:args.n_samples]
    if args.npz:
        arr8 = (arr * 255.0 + 0.5).clip(0, 255).astype(np.uint8)
        np.savez(os.path.join(args.logdir, "samples.npz"), arr8)
    with open(os.path.join(args.logdir, "sampling_config.json"), "w") as f:
        json.dump({k: v for k, v in vars(args).items() if k != "cpu"}, f, indent=2)
    return {"images": arr, "seconds": seconds}


if __name__ == "__main__":
    main()
