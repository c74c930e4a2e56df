"""Stable-Diffusion pipeline glue: model bundle, CFG eps function, txt2img.

Port of the JAX package's `pipeline/pipeline.py`.  Classifier-free guidance
stacks a [2B] batch, uncond rows first, so each denoising step is one UNet
call.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

from ..config import PipelineConfig
from ..models.clip import CLIPTextTower
from ..models.layers import cast_matmul_weights
from ..models.unet import UNet
from ..models.vae import AutoencoderKL
from ..ops.attention import SpatialControl
from ..ops.schedule import DiffusionSchedule, make_schedule
from ..samplers.ddim import ddim_sample
from ..samplers.dpm_solver import dpm_solver_sample
from ..samplers.plms import plms_sample
from ..utils.testing import randomize_
from ..utils.weights import load_flat


@dataclasses.dataclass
class StableDiffusion:
    """Model bundle: modules (weights inside) + schedule, on one device."""

    cfg: PipelineConfig
    unet: UNet
    vae: AutoencoderKL
    text_encoder: CLIPTextTower
    schedule: DiffusionSchedule
    device: torch.device

    @classmethod
    def _build(cls, cfg: PipelineConfig, device, fill) -> "StableDiffusion":
        device = torch.device(device)
        with torch.device(device):
            unet = UNet(cfg.unet, radius=cfg.spacetime.radius)
            vae = AutoencoderKL(cfg.vae)
            text = CLIPTextTower(cfg.text_encoder)
        for m in (unet, vae, text):      # compute dtype first: each weight lands once
            cast_matmul_weights(m).eval().requires_grad_(False)
        fill(unet, vae, text)
        sched = make_schedule(cfg.schedule, cfg.spacetime.num_steps, device=device)
        return cls(cfg, unet, vae, text, sched, device)

    @classmethod
    def create(cls, cfg: PipelineConfig, seed: int = 0, device="cuda",
               scale: float = 0.02) -> "StableDiffusion":
        """Bundle with seeded N(0, scale²) weights generated on `device`
        (no checkpoint is loaded)."""
        def fill(unet, vae, text):
            randomize_(unet, seed + 1, scale)
            randomize_(vae, seed + 2, scale)
            randomize_(text, seed + 3, scale)
        return cls._build(cfg, device, fill)

    @classmethod
    def from_flat(cls, cfg: PipelineConfig, unet: Dict[str, np.ndarray],
                  vae: Dict[str, np.ndarray], text: Dict[str, np.ndarray],
                  device="cuda") -> "StableDiffusion":
        """Bundle with weights from flat JAX trees (see utils/weights.py)."""
        def fill(u, v, t):
            load_flat(u, unet)
            load_flat(v, vae)
            load_flat(t, text)
        return cls._build(cfg, device, fill)

    # ---- text ----
    def encode_text(self, token_ids) -> torch.Tensor:
        """[B, L] ids -> [B, L, width] float32."""
        ids = torch.as_tensor(np.asarray(token_ids), device=self.device)
        return self.text_encoder(ids)[0]

    # ---- VAE ----
    def decode_latents(self, z: torch.Tensor) -> torch.Tensor:
        """Scaled latents [B, h, w, c] -> images [B, H, W, 3] in [0, 1]."""
        img = self.vae.decode(z / self.cfg.vae.scale_factor)
        return torch.clamp((img + 1.0) / 2.0, 0.0, 1.0)

    # ---- eps function ----
    def make_eps_fn(self, cond: torch.Tensor, uncond: torch.Tensor,
                    guidance_scale: float, control: Optional[SpatialControl] = None,
                    coef_schedule: Optional[torch.Tensor] = None):
        """eps_fn(x [B,h,w,c], t, i) with CFG; with `control`,
        `coef_schedule[:, :, i]` gives step i's blend weights."""
        context = torch.cat([uncond, cond], dim=0)

        def eps_fn(x, t, i):
            B = x.shape[0]
            x_in = torch.cat([x, x], dim=0)
            t_in = torch.full((2 * B,), int(t), dtype=torch.int32, device=x.device)
            ctrl = control
            if ctrl is not None and coef_schedule is not None:
                ctrl = ctrl._replace(coef=coef_schedule[:, :, i])
            e = self.unet(x_in, t_in, context, ctrl)
            e_u, e_c = e[:B], e[B:]
            return e_u + guidance_scale * (e_c - e_u)

        return eps_fn

    # ---- sampling ----
    def sample_from(self, eps_fn, x_T: torch.Tensor, sampler: str = "plms", remat=True):
        """The sampler's chain from x_T: "plms" (S + 1 UNet evaluations),
        "ddim" (eta 0) or "dpm" (DPM-Solver++ 2M), S each; `remat=True` (the
        JAX default) checkpoints every evaluation for a backward through the
        chain."""
        if sampler == "plms":
            return plms_sample(eps_fn, x_T, self.schedule, remat=remat)
        if sampler == "ddim":
            return ddim_sample(eps_fn, x_T, self.schedule, remat=remat)
        if sampler == "dpm":
            return dpm_solver_sample(eps_fn, x_T, self.schedule, remat=remat)
        raise ValueError(f"unknown sampler {sampler!r}")

    def sample_latents(self, eps_fn, generator: torch.Generator, batch: int = 1,
                       sampler: str = "plms", remat=True):
        latent = self.cfg.spacetime.latent_size
        x_T = torch.randn((batch, latent, latent, self.cfg.unet.in_channels),
                          generator=generator, device=self.device)
        return self.sample_from(eps_fn, x_T, sampler, remat)

    @torch.inference_mode()
    def txt2img(self, cond, uncond, generator: torch.Generator,
                guidance_scale: Optional[float] = None, sampler: str = "plms",
                control: Optional[SpatialControl] = None,
                coef_schedule: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Embeddings -> latents -> images in [0, 1]; control=None is the
        vanilla path, a fixed coef_schedule the spatial-only path."""
        gs = self.cfg.spacetime.guidance_scale if guidance_scale is None else guidance_scale
        eps_fn = self.make_eps_fn(cond, uncond, gs, control, coef_schedule)
        z = self.sample_latents(eps_fn, generator, batch=cond.shape[0], sampler=sampler,
                                remat=False)
        return self.decode_latents(z)
