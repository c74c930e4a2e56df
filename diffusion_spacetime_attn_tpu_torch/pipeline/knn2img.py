"""Retrieval-augmented diffusion (the reference's knn2img pipeline); port of
the JAX package's `pipeline/knn2img.py`.

Reference: `scripts/knn2img.py` + `configs/retrieval-augmented-diffusion/
768x768.yaml`, a LatentDiffusion conditioned on the CLIP ViT-L/14 joint-space
embedding of the prompt, optionally followed by the embeddings of its k
nearest neighbours in a retrieval database (`knn2img.py:355-363`):

    c  = concat([clip_text(prompt)[:, None, :], nn_embeddings], axis=1)
    uc = zeros_like(c)                        (`knn2img.py:364-365`)
    eps = eps(x, uc) + scale·(eps(x, c) − eps(x, uc))

Model: the f16 KL autoencoder (z = 16) and a UNet of 448 channels (mult
1/2/3/4, head width 32, context 768) at 768², 48×48×16 latents.  The noise
is JAX's (`utils/prng.py`): x_T from the first half of `split(rng)`, DDIM's
σ·z from the second when eta > 0.  At full width the UNet runs its
self-attention through the MHA kernel and its feed-forward through the
GEGLU kernel (`use_mha`, `use_fused_ff`), as the port's other serving paths
do; the JAX module leaves every flag off.  Cross-attention (1 + k keys)
stays plain.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

from ..config import (
    VIT_L14_JOINT_CLIP,
    CLIPConfig,
    CLIPTextConfig,
    CLIPVisionConfig,
    ScheduleConfig,
    UNetConfig,
    VAEConfig,
)
from ..models.layers import cast_matmul_weights
from ..models.unet import UNet
from ..models.vae import AutoencoderKL
from ..ops.schedule import DiffusionSchedule, make_schedule
from ..samplers.ddim import ddim_sample
from ..samplers.dpm_solver import dpm_solver_sample
from ..samplers.plms import plms_sample
from ..utils import prng
from ..utils.cudnn import deterministic
from ..utils.testing import randomize_
from ..utils.weights import load_flat
from .retrieval import Retriever, normalize


def rdm_unet_config(dtype: str = "bfloat16") -> UNetConfig:
    """The 768×768 RDM UNet (`768x768.yaml:19-41`)."""
    return UNetConfig(
        in_channels=16, out_channels=16, model_channels=448,
        channel_mult=(1, 2, 3, 4), num_res_blocks=2,
        attention_resolutions=(4, 2, 1), num_head_channels=32,
        context_dim=768, dtype=dtype,
    )


def rdm_vae_config(dtype: str = "bfloat16") -> VAEConfig:
    """The f16 first stage (`768x768.yaml:43-64`)."""
    return VAEConfig(
        ch=128, ch_mult=(1, 1, 2, 2, 4), num_res_blocks=2,
        z_channels=16, embed_dim=16, attn_resolutions=(16,),
        resolution=256, scale_factor=0.22765929, dtype=dtype,
    )


def rdm_schedule_config() -> ScheduleConfig:
    """`768x768.yaml:5-6` (linear_start / end differ from SD v1)."""
    return ScheduleConfig(linear_start=0.0015, linear_end=0.015)


def joint_clip_config(tiny: bool = False) -> CLIPConfig:
    """The CLIP whose joint space conditions the RDM: ViT-L/14 (768 wide),
    or at `tiny` a one-layer 32-wide CLIP (224² images, patch 32) whose
    embeddings the scripts crop to the tiny context, as JAX's crop its
    ViT-B/32's."""
    if not tiny:
        return VIT_L14_JOINT_CLIP
    return CLIPConfig(
        vision=CLIPVisionConfig(image_size=224, patch_size=32, width=32, layers=1, heads=2,
                                projection_dim=32),
        text=CLIPTextConfig(width=32, layers=1, heads=2), projection_dim=32)


def configs(dtype: str, tiny: bool):
    """(UNetConfig, VAEConfig, latent side) of the JAX `create`: the tiny
    model, or the RDM with the port's serving kernel flags."""
    if tiny:
        ucfg = UNetConfig(in_channels=8, out_channels=8, model_channels=32,
                          channel_mult=(1, 2), num_res_blocks=1,
                          attention_resolutions=(1, 2), num_head_channels=16,
                          context_dim=16, dtype=dtype)
        vcfg = VAEConfig(ch=32, ch_mult=(1, 2), num_res_blocks=1,
                         z_channels=8, embed_dim=8, dtype=dtype, scale_factor=0.22765929)
        return ucfg, vcfg, 8
    ucfg = dataclasses.replace(rdm_unet_config(dtype), use_mha=True, use_fused_ff=True)
    return ucfg, rdm_vae_config(dtype), 48


@dataclasses.dataclass
class RetrievalAugmentedDiffusion:
    """Model bundle for knn2img (reference `LatentDiffusion` + `Searcher`),
    on one device."""

    unet: UNet
    vae: AutoencoderKL
    schedule: DiffusionSchedule
    scale_factor: float
    latent_hw: int = 48

    @classmethod
    def _build(cls, steps, dtype, tiny, eta, device, fill) -> "RetrievalAugmentedDiffusion":
        ucfg, vcfg, latent_hw = configs(dtype, tiny)
        with torch.device(device):
            unet = UNet(ucfg, radius=0.2)
            vae = AutoencoderKL(vcfg)
        for m in (unet, vae):            # compute dtype first: each weight lands once
            cast_matmul_weights(m).eval().requires_grad_(False)
        fill(unet, vae)
        sched = make_schedule(rdm_schedule_config(), steps, eta=eta, device=device)
        return cls(unet, vae, sched, vcfg.scale_factor, latent_hw)

    @classmethod
    def create(cls, seed: int = 0, steps: int = 50, dtype: str = "bfloat16",
               tiny: bool = False, eta: float = 0.0,
               device="cuda") -> "RetrievalAugmentedDiffusion":
        """The bundle with seeded N(0, 0.02²) weights made on `device` (no
        RDM checkpoint is published with the repository)."""
        def fill(unet, vae):
            randomize_(unet, seed + 1)
            randomize_(vae, seed + 2)
        return cls._build(steps, dtype, tiny, eta, device, fill)

    @classmethod
    def from_flat(cls, unet: Dict[str, np.ndarray], vae: Dict[str, np.ndarray],
                  steps: int = 50, dtype: str = "bfloat16", tiny: bool = False,
                  eta: float = 0.0, device="cuda") -> "RetrievalAugmentedDiffusion":
        """The bundle with JAX's flat params (`utils/weights.py`), loaded
        strictly."""
        def fill(u, v):
            load_flat(u, unet)
            load_flat(v, vae)
        return cls._build(steps, dtype, tiny, eta, device, fill)

    @property
    def device(self) -> torch.device:
        return self.schedule.alphas.device

    def build_conditioning(self, text_embed: torch.Tensor, retriever: Optional[Retriever] = None,
                           knn: int = 10) -> torch.Tensor:
        """`knn2img.py:355-363`: the normalized text embedding [B, 1, D],
        followed by its k nearest database neighbours when a retriever is
        given -> [B, 1 + knn, D] float32 on the bundle's device."""
        c = normalize(text_embed.float().to(self.device))[:, None, :]
        if retriever is not None and knn > 0:
            nn_emb = retriever.search(c[:, 0], knn)["nn_embeddings"]
            c = torch.cat([c, nn_emb.to(device=c.device, dtype=c.dtype)], dim=1)
        return c

    def make_eps_fn(self, cond: torch.Tensor, guidance_scale: float):
        """CFG against the zero context, one [uc; c] batch per evaluation
        (`knn2img.py:148-154`)."""
        B = cond.shape[0]
        context = torch.cat([torch.zeros_like(cond), cond], dim=0)

        def eps_fn(x, t, i):
            x_in = torch.cat([x, x], dim=0)
            t_in = torch.full((2 * B,), int(t), dtype=torch.int32, device=x.device)
            e = self.unet(x_in, t_in, context)
            e_u, e_c = e[:B], e[B:]
            return e_u + guidance_scale * (e_c - e_u)

        return eps_fn

    @torch.inference_mode()
    def sample_latents(self, cond: torch.Tensor, rng: np.ndarray, guidance_scale: float = 5.0,
                       sampler: str = "ddim") -> torch.Tensor:
        """Conditioning -> the chain's latents [B, h, w, C] float32.  x_T is
        `normal(split(rng)[0])`; DDIM with eta > 0 draws its σ·z from
        `split(rng)[1]`."""
        cond = cond.to(self.device)
        B = cond.shape[0]
        eps_fn = self.make_eps_fn(cond, guidance_scale)
        x_rng, noise_rng = prng.split(rng)
        shape = (B, self.latent_hw, self.latent_hw, self.unet.cfg.in_channels)
        x_T = torch.from_numpy(prng.normal(x_rng, shape)).to(self.device)
        with deterministic():
            if sampler == "ddim":
                stochastic = bool((self.schedule.sigmas > 0).any())
                return ddim_sample(eps_fn, x_T, self.schedule,
                                   rng=noise_rng if stochastic else None, remat=False)
            if sampler == "plms":
                return plms_sample(eps_fn, x_T, self.schedule, remat=False)
            if sampler == "dpm":
                return dpm_solver_sample(eps_fn, x_T, self.schedule, remat=False)
        raise ValueError(f"unknown sampler {sampler!r}")

    @torch.inference_mode()
    def decode(self, z: torch.Tensor) -> torch.Tensor:
        """Latents -> images [B, H, W, 3] in [0, 1]."""
        with deterministic():
            img = self.vae.decode(z / self.scale_factor)
        return torch.clamp((img + 1.0) / 2.0, 0.0, 1.0)

    def sample(self, cond: torch.Tensor, rng: np.ndarray, guidance_scale: float = 5.0,
               sampler: str = "ddim") -> torch.Tensor:
        """Conditioning [B, 1 + knn, D] -> images [B, 16·h, 16·w, 3] in
        [0, 1] (the tiny VAE: 2·h); guidance 5.0 is the reference's
        default (`knn2img.py:381`)."""
        return self.decode(self.sample_latents(cond, rng, guidance_scale, sampler))
