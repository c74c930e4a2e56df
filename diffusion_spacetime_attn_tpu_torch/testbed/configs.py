"""Tiny-model configurations for the closed-loop semantic testbed, a copy of
the JAX package's `testbed/configs.py` against the port's `config.py`.

The testbed is a scale model of the full method (reference
`scripts/txt2img-gpt.py` → `plms.py:182-293`): 64×64 images, f=4 VAE
(16×16×4 latents), a 4-layer CLIP whose text tower doubles as the SD
conditioning encoder, and a 2-level UNet with cross-attention at both
resolutions.  Every kernel flag stays at its default (off) and the dtype is
float32, as in the JAX testbed run.

Geometry invariants that make the full method code run unchanged:
  * DCLIPLoss.global_resize is the ×7-nearest + 16-avgpool composite
    (`plms.py:25-26,41`): 64·7/16 = 28 → CLIP vision image_size 28.
  * crop_window(64, crop_half=0.2) → 25-px local crops, bilinear → 28.
  * circular mask radius 0.2 on the 16×16 / 8×8 latent grids.
"""
from __future__ import annotations

import dataclasses

from ..config import (
    CLIPConfig,
    CLIPTextConfig,
    CLIPVisionConfig,
    PipelineConfig,
    ScheduleConfig,
    SpaceTimeConfig,
    UNetConfig,
    VAEConfig,
)
from .scenes import MAX_LEN, VOCAB_SIZE

IMAGE_SIZE = 64
LATENT_SIZE = 16
CONTEXT_DIM = 128


def testbed_text_cfg() -> CLIPTextConfig:
    return CLIPTextConfig(
        vocab_size=VOCAB_SIZE, width=CONTEXT_DIM, layers=4, heads=4,
        max_len=MAX_LEN,
    )


def testbed_clip_cfg() -> CLIPConfig:
    """Dual-tower CLIP for the fidelity loss: 28×28 inputs (= global_resize
    of a 64×64 image), patch 4 → 7×7 tokens."""
    return CLIPConfig(
        vision=CLIPVisionConfig(
            image_size=28, patch_size=4, width=CONTEXT_DIM, layers=4,
            heads=4, projection_dim=64,
        ),
        text=testbed_text_cfg(),
        projection_dim=64,
    )


def testbed_pipeline_cfg(
    scale_factor: float = 1.0,
    num_steps: int = 50,
    guidance_scale: float = 7.5,
    epochs: int = 3,
) -> PipelineConfig:
    return PipelineConfig(
        unet=UNetConfig(
            in_channels=4, out_channels=4, model_channels=64,
            channel_mult=(1, 2), num_res_blocks=1,
            attention_resolutions=(1, 2), num_heads=4,
            context_dim=CONTEXT_DIM,
        ),
        vae=VAEConfig(
            ch=32, ch_mult=(1, 2, 4), num_res_blocks=1, z_channels=4,
            embed_dim=4, resolution=IMAGE_SIZE, scale_factor=scale_factor,
        ),
        text_encoder=testbed_text_cfg(),
        loss_clip=testbed_clip_cfg(),
        schedule=ScheduleConfig(),
        spacetime=SpaceTimeConfig(
            num_steps=num_steps, guidance_scale=guidance_scale,
            epochs=epochs, max_objects=2,
            image_size=IMAGE_SIZE, latent_size=LATENT_SIZE,
        ),
    )


def smoke_pipeline_cfg(num_steps: int = 6) -> PipelineConfig:
    """Miniature of the miniature: CPU-smoke-tier shapes for tests.

    Keeps every geometric contract of the testbed (image 32 → global_resize
    14 = CLIP image size, latent 8, crop 12) at test-suite cost.  Channel
    widths stay multiples of 32 — GroupNorm32 (models/layers.py:42) is
    fixed at 32 groups for reference weight compatibility."""
    return PipelineConfig(
        unet=UNetConfig(
            in_channels=4, out_channels=4, model_channels=32,
            channel_mult=(1, 2), num_res_blocks=1,
            attention_resolutions=(1, 2), num_heads=2, context_dim=32,
        ),
        vae=VAEConfig(
            ch=32, ch_mult=(1, 2, 4), num_res_blocks=1, z_channels=4,
            embed_dim=4, resolution=32, scale_factor=1.0,
        ),
        text_encoder=dataclasses.replace(
            testbed_text_cfg(), width=32, layers=2, heads=2),
        loss_clip=CLIPConfig(
            vision=CLIPVisionConfig(image_size=14, patch_size=2, width=32,
                                    layers=2, heads=2, projection_dim=16),
            text=dataclasses.replace(testbed_text_cfg(), width=32, layers=2,
                                     heads=2),
            projection_dim=16,
        ),
        schedule=ScheduleConfig(),
        spacetime=SpaceTimeConfig(
            num_steps=num_steps, guidance_scale=5.0, epochs=2,
            max_objects=2, image_size=32, latent_size=8,
        ),
    )
