"""img2img and inpainting, port of the JAX package's `pipeline/img2img.py`
(reference: the stock CompVis `scripts/img2img.py` and `scripts/inpaint.py`).

img2img: encode the init image, noise it to the timestep at loop position
start_step = S − int(strength·S), run the remaining DDIM steps.  inpaint: the
full DDIM chain with the kept region re-noised from the encoded image at
every step.  Both draw JAX's bits from the caller's key in JAX's order
(`split(rng)` into the VAE sample's key and the noise / x_T key), keep the
latents in float32 whatever the VAE's dtype, and guide with CFG.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from ..ops.schedule import q_sample
from ..samplers.ddim import ddim_sample
from ..utils import prng
from .pipeline import StableDiffusion


def resize_nearest(x: torch.Tensor, size: Sequence[int]) -> torch.Tensor:
    """[B, H, W, C] -> [B, h, w, C] by nearest neighbour as
    `jax.image.resize(..., "nearest")` picks: source index
    floor((i + 0.5)·in/out), computed in float32 (at f = 8, rows 8i + 4)."""
    def index(n_in, n_out):
        pos = (np.arange(n_out, dtype=np.float32) + np.float32(0.5)) * np.float32(n_in)
        idx = np.floor(pos / np.float32(n_out)).astype(np.int64)
        return torch.from_numpy(idx).to(x.device)

    h, w = size
    return x[:, index(x.shape[1], h)][:, :, index(x.shape[2], w)]


def _eps_fn(sd: StableDiffusion, cond, uncond, guidance_scale):
    gs = sd.cfg.spacetime.guidance_scale if guidance_scale is None else guidance_scale
    return sd.make_eps_fn(cond, uncond, gs)


@torch.inference_mode()
def img2img(sd: StableDiffusion, init_image: torch.Tensor, cond, uncond, rng: np.ndarray,
            strength: float = 0.75, guidance_scale: Optional[float] = None) -> torch.Tensor:
    """init_image [B, H, W, 3] in [-1, 1] -> images [B, H, W, 3] in [0, 1];
    strength in (0, 1] is the fraction of the chain run."""
    if not 0.0 < strength <= 1.0:
        raise ValueError("strength must be in (0, 1]")
    S = sd.schedule.num_steps
    start_step = S - int(strength * S)
    r_enc, r_noise = prng.split(rng)
    z0 = sd.encode_images(init_image, r_enc).float()
    # a start past the chain's end reads its last timestep, as JAX's gather clamps
    t_enc = torch.full((z0.shape[0],), int(sd.schedule.timesteps[min(start_step, S - 1)]),
                       dtype=torch.long, device=z0.device)
    z_T = q_sample(sd.schedule, z0, t_enc, prng.normal_like(r_noise, z0))
    z = ddim_sample(_eps_fn(sd, cond, uncond, guidance_scale), z_T, sd.schedule,
                    remat=False, start_step=start_step)
    return sd.decode_latents(z)


@torch.inference_mode()
def inpaint(sd: StableDiffusion, init_image: torch.Tensor, image_mask: torch.Tensor,
            cond, uncond, rng: np.ndarray,
            guidance_scale: Optional[float] = None) -> torch.Tensor:
    """init_image [B, H, W, 3] in [-1, 1], image_mask [B, H, W, 1] (1 = keep,
    0 = generate) -> images [B, H, W, 3] in [0, 1]."""
    r_enc, r_T = prng.split(rng)
    z0 = sd.encode_images(init_image, r_enc).float()
    mask = resize_nearest(image_mask.to(z0.device, torch.float32), z0.shape[1:3])
    x_T = prng.normal_like(r_T, z0)
    z = ddim_sample(_eps_fn(sd, cond, uncond, guidance_scale), x_T, sd.schedule, rng=None,
                    remat=False, mask=mask, x0=z0)
    return sd.decode_latents(z)
