"""Temporal weight optimization, the paper's core loop; port of the JAX
package's `pipeline/spacetime.py`.

Reference (`ldm/models/diffusion/plms.py:182-293`): per prompt, an [N, 50]
weight matrix initialized to 5/N is optimized by Adam (lr 0.005) for 3
epochs; each epoch runs the whole 50-step PLMS chain with the weights
driving the attention blend, decodes the latent, computes a CLIP fidelity
loss (global + 5·Σ per-object crops) and backpropagates through the whole
chain.  Here the chain runs under per-evaluation checkpointing
(`samplers/remat.py`), and everything is batched over a prompt axis [B].
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..config import SpaceTimeConfig
from ..ops.attention import SpatialControl
from .losses import DCLIPLoss
from .pipeline import StableDiffusion


class SpaceTimeInputs(NamedTuple):
    """Everything one optimized generation needs.  N = cfg.max_objects with
    `active` marking real objects; padded slots have zero masks in the blend
    and zero weight in the loss, so they are exact no-ops."""

    cond: torch.Tensor            # [B, L, D] caption embedding
    uncond: torch.Tensor          # [B, L, D] empty-prompt embedding
    local_contexts: torch.Tensor  # [B, N, L, D] "a photo of <obj>" embeddings
    centers: torch.Tensor         # [B, N, 2] layout (x, y)
    active: torch.Tensor          # [B, N] 1.0 = real object
    caption_tokens: torch.Tensor  # [B, Lc] loss-CLIP tokens of the caption
    object_tokens: torch.Tensor   # [B, N, Lc] tokens of "A photo of <obj>"
    x_T: torch.Tensor             # [B, h, w, 4] initial noise


def init_coef(active: torch.Tensor, num_steps: int, init_total: float) -> torch.Tensor:
    """[B, N, S] = init_total / n_objects for active slots (`plms.py:204-209`)."""
    n = torch.clamp(active.sum(dim=-1, keepdim=True), min=1.0)
    per = (init_total / n) * active
    return per[..., None].repeat(1, 1, num_steps)


def generation_loss(coef: torch.Tensor, sd: StableDiffusion, clip_loss: DCLIPLoss,
                    inputs: SpaceTimeInputs, cfg: SpaceTimeConfig, sampler: str = "plms",
                    remat=True):
    """(loss, images): loss = Σ_b [global + w_local·Σ_n active·local_n]
    (`plms.py:252-273`); images [B, S, S, 3] in [0, 1].  The chain runs
    under `remat` (the JAX function always checkpoints)."""
    control = SpatialControl(local_contexts=inputs.local_contexts, centers=inputs.centers,
                             coef=coef[:, :, 0], active=inputs.active)
    eps_fn = sd.make_eps_fn(inputs.cond, inputs.uncond, cfg.guidance_scale, control, coef)
    z = sd.sample_from(eps_fn, inputs.x_T, sampler=sampler, remat=remat)
    images = sd.decode_latents(z)
    g = clip_loss.global_loss(images, inputs.caption_tokens)
    loc = clip_loss.local_loss(images, inputs.centers, inputs.object_tokens, inputs.active,
                               crop_half=cfg.crop_half)
    return (g + cfg.local_loss_weight * loc).sum(), images


def make_optimizer(coef: torch.Tensor, cfg: SpaceTimeConfig) -> torch.optim.Adam:
    """Adam on the leaf `coef` with optax.adam's defaults (b1 0.9, b2 0.999,
    eps 1e-8 added to √v̂)."""
    return torch.optim.Adam([coef], lr=cfg.lr, betas=(0.9, 0.999), eps=1e-8)


def make_train_step(sd: StableDiffusion, clip_loss: DCLIPLoss, cfg: SpaceTimeConfig,
                    sampler: str = "plms"):
    """One Adam epoch: train_step(coef, optimizer, inputs) -> (loss, images),
    with the images of this epoch's forward (before the update) and `coef`
    updated in place."""

    def train_step(coef: torch.Tensor, optimizer: torch.optim.Optimizer,
                   inputs: SpaceTimeInputs):
        optimizer.zero_grad(set_to_none=True)
        with torch.enable_grad():
            loss, images = generation_loss(coef, sd, clip_loss, inputs, cfg, sampler)
            loss.backward()
        optimizer.step()
        return loss.detach(), images.detach()

    return train_step


def make_final_forward(sd: StableDiffusion, clip_loss: DCLIPLoss, cfg: SpaceTimeConfig,
                       sampler: str = "plms"):
    """The last epoch without a backward: final_forward(coef, inputs) ->
    (loss, images).  The reference saves its image during the final epoch's
    forward, before the last optimizer step applies (`plms.py:280-288`), so
    that step's backward moves weights nobody reads."""

    @torch.no_grad()
    def final_forward(coef: torch.Tensor, inputs: SpaceTimeInputs):
        return generation_loss(coef, sd, clip_loss, inputs, cfg, sampler, remat=False)

    return final_forward


def optimize_prompt(sd: StableDiffusion, clip_loss: DCLIPLoss, inputs: SpaceTimeInputs,
                    cfg: SpaceTimeConfig, sampler: str = "plms",
                    final_forward_only: bool = True, on_epoch: Optional[callable] = None):
    """The whole `cfg.epochs` optimization; returns (images, coef, losses).

    The returned image is the one decoded in the last epoch's forward, with
    the weights as of the start of that epoch (`plms.py:280-288`).  With
    `final_forward_only` (the default) the last epoch runs without a
    backward; the same image, and the returned coef is the one that produced
    it.  `final_forward_only=False` also takes the reference's last,
    unread optimizer step.  `on_epoch(e, images)` sees every epoch's images.
    """
    coef = init_coef(inputs.active, cfg.num_steps, cfg.init_coef).requires_grad_(True)
    optimizer = make_optimizer(coef, cfg)
    train_step = make_train_step(sd, clip_loss, cfg, sampler)
    losses, images = [], None
    n_train = cfg.epochs - 1 if final_forward_only else cfg.epochs
    for e in range(n_train):
        loss, images = train_step(coef, optimizer, inputs)
        losses.append(loss)
        if on_epoch is not None:
            on_epoch(e, images)
    if final_forward_only:
        loss, images = make_final_forward(sd, clip_loss, cfg, sampler)(coef, inputs)
        losses.append(loss)
        if on_epoch is not None:
            on_epoch(cfg.epochs - 1, images)
    return images, coef.detach(), torch.stack(losses)
