"""First-stage (AutoencoderKL) training: LPIPS + KL + PatchGAN.  Port of the
JAX package's `training/vae_trainer.py` (reference `ldm/models/autoencoder.py:
285-430` driving `ldm/modules/losses/contperceptual.py`
`LPIPSWithDiscriminator`):

  rec   = pixel_weight·|x − x̂| + perceptual_weight · LPIPS(x, x̂)
  nll   = rec / exp(logvar) + logvar             (learned scalar logvar)
  kl    = KL(q(z|x) ‖ N(0, 1))                   (summed over latent dims, / B)
  g     = −E[D(x̂)]                               (D in eval mode: running stats)
  d_w   = ‖∇_last nll‖ / (‖∇_last g‖ + 1e-4), clipped to [0, 1e4], × disc_weight
  L_ae  = nll + kl_weight·kl + d_w·disc_factor·g
  L_d   = disc_factor · hinge(D(x), D(x̂.detach))  (D in train mode, real then
                                                 fake, batch statistics chained)

`last` is `decoder.conv_out`'s kernel only (`contperceptual.py:32-43`);
disc_factor is 0 before `disc_start` steps (`adopt_weight`).  One step
updates the autoencoder (the discriminator frozen), then the discriminator,
each with its own Adam (b1 0.5, b2 0.9, as `VAETrainer.__init__` builds
them, `vae_trainer.py:86-108` in JAX).  The sample z = mean + std·ε draws ε
from the step's JAX key, as `AutoencoderKL.encode(x, rng)` does.

Over a data mesh (`VAETrainer(mesh=...)`, JAX `vae_trainer.py:86-150`)
each rank takes its rows of the global batch and computes JAX's global
step: ε is drawn for the global batch and each rank takes its rows; the
losses are batch means, so the gradients are averaged over the ranks; the
adaptive weight's two last-layer gradients are averaged before their norms
are taken; the discriminator's BatchNorm normalizes with, and moves its
running statistics by, the global batch's mean and E[x²] (averaged over the
ranks, differentiably).  `fsdp=True` shards the autoencoder and the
discriminator (`parallel/sharding.py`) and their Adam states with them;
`decoder.conv_out` stays whole, as the adaptive weight differentiates with
respect to it, and its gradient is all-reduced with the other whole ones.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch
from torch import nn

from ..models.vae import AutoencoderKL
from ..parallel.mesh import all_reduce_, check_mesh, metrics_mean, normal_rows, replicate
from ..parallel.sharding import fsdp as fully_shard_module
from ..parallel.sharding import is_sharded
from ..utils.testing import init_flax_like_
from .perceptual import (
    LPIPS,
    NLayerDiscriminator,
    adopt_weight,
    hinge_d_loss,
    vanilla_d_loss,
)


@dataclasses.dataclass(frozen=True)
class VAETrainConfig:
    """`configs/autoencoder/autoencoder_kl_*.yaml` + LPIPSWithDiscriminator
    defaults (KL f8: base_lr 4.5e-6, kl_weight 1e-6, disc_weight 0.5,
    disc_start 50001)."""

    base_lr: float = 4.5e-6
    kl_weight: float = 1e-6
    pixel_weight: float = 1.0
    perceptual_weight: float = 1.0
    disc_start: int = 50001
    disc_factor: float = 1.0
    disc_weight: float = 0.5
    disc_loss: str = "hinge"        # "hinge" | "vanilla"
    disc_ndf: int = 64
    disc_layers: int = 3
    logvar_init: float = 0.0


@dataclasses.dataclass
class VAETrainState:
    """The autoencoder, the discriminator (its running statistics are its
    buffers, flax's `batch_stats`) and the frozen LPIPS (None when the
    perceptual weight is 0) are modules, updated in place."""

    ae_params: AutoencoderKL
    logvar: torch.Tensor            # learned scalar
    disc_params: NLayerDiscriminator
    lpips_params: Optional[LPIPS]
    opt_ae: torch.optim.Adam
    opt_disc: torch.optim.Adam
    step: int


def kl_divergence(mean, logvar):
    """DiagonalGaussianDistribution.kl() against N(0, 1), summed over the
    latent dims (`ldm/modules/distributions/distributions.py:47-56`)."""
    return 0.5 * torch.sum(mean ** 2 + torch.exp(logvar) - 1.0 - logvar, dim=(1, 2, 3))


class VAETrainer:
    """`mesh`: a `parallel.mesh.Mesh` over whose data axis the image batch
    is split (each rank passes the rows of its data coordinate; the model
    axis replicates); `fsdp` shards the state over the data group, and is
    ignored without a mesh or with a data axis of 1, as in JAX."""

    def __init__(self, vae: AutoencoderKL, cfg: VAETrainConfig, mesh=None,
                 fsdp: bool = False):
        self.mesh = check_mesh(mesh, "VAETrainer")
        self.fsdp = fsdp and self.mesh is not None and self.mesh.data_group is not None
        self.vae, self.cfg = vae, cfg
        self.device = next(vae.parameters()).device
        self.disc = NLayerDiscriminator(ndf=cfg.disc_ndf, n_layers=cfg.disc_layers).to(self.device)
        self.d_loss_fn = hinge_d_loss if cfg.disc_loss == "hinge" else vanilla_d_loss
        for m in self.disc.modules():
            if hasattr(m, "mesh"):
                m.mesh = self.mesh

    def init(self, seed: int = 0, lpips: Optional[LPIPS] = None) -> VAETrainState:
        """The state: flax-like seeded initial weights for the autoencoder and
        the discriminator, and `lpips` (seeded random when None and the
        perceptual weight is on; none when it is 0)."""
        init_flax_like_(self.vae, seed)
        init_flax_like_(self.disc, seed + 1)
        if lpips is None and self.cfg.perceptual_weight > 0:
            lpips = init_flax_like_(LPIPS().to(self.device), seed + 2)
        if lpips is not None:
            lpips.requires_grad_(False)
        if self.mesh is not None:
            for m in (self.vae, self.disc, lpips):
                if m is not None:
                    replicate(self.mesh, m)
            if self.fsdp:
                co = self.vae.decoder.conv_out
                fully_shard_module(self.vae, self.mesh, ignored=[co.weight, co.bias])
                fully_shard_module(self.disc, self.mesh)
        logvar = torch.tensor(self.cfg.logvar_init, dtype=torch.float32, device=self.device,
                              requires_grad=True)
        lr = self.cfg.base_lr
        opt_ae = torch.optim.Adam(list(self.vae.parameters()) + [logvar], lr=lr,
                                  betas=(0.5, 0.9), eps=1e-8)
        opt_disc = torch.optim.Adam(self.disc.parameters(), lr=lr, betas=(0.5, 0.9), eps=1e-8)
        return VAETrainState(ae_params=self.vae, logvar=logvar, disc_params=self.disc,
                             lpips_params=lpips, opt_ae=opt_ae, opt_disc=opt_disc, step=0)

    def _nll(self, state: VAETrainState, recon, images):
        cfg = self.cfg
        rec = cfg.pixel_weight * torch.abs(images - recon)
        if cfg.perceptual_weight > 0:
            rec = rec + cfg.perceptual_weight * state.lpips_params(images, recon)
        nll = rec / torch.exp(state.logvar) + state.logvar
        B = images.shape[0]
        return nll.sum() / B, rec.sum() / B

    def _reduce(self, params) -> None:
        """Average the whole (not FSDP-sharded) gradients over the ranks;
        FSDP has reduce-scattered the sharded ones."""
        if self.mesh is not None:
            all_reduce_([p.grad for p in params if p.grad is not None
                         and not is_sharded(p.grad)], self.mesh)

    def train_step(self, state: VAETrainState, images: torch.Tensor,
                   rng: np.ndarray) -> Tuple[VAETrainState, dict]:
        """images [B, H, W, 3] in [-1, 1] (with a mesh, this rank's rows of
        the global batch); rng: the JAX key of the sample."""
        cfg, mesh = self.cfg, self.mesh
        vae, disc = state.ae_params, state.disc_params
        disc_factor = adopt_weight(cfg.disc_factor, state.step, cfg.disc_start)

        # ---- the autoencoder (the discriminator frozen, in eval mode) ----
        mean, lv = vae.encode_moments(images)
        z = mean + torch.exp(0.5 * lv) * normal_rows(rng, mean, mesh)
        recon = vae.decode(z)
        nll, rec = self._nll(state, recon, images)
        kl = kl_divergence(mean, lv).sum() / images.shape[0]
        g = -disc(recon, train=False).mean()
        last = vae.decoder.conv_out.weight
        g_nll = torch.autograd.grad(nll, last, retain_graph=True)[0]
        g_g = torch.autograd.grad(g, last, retain_graph=True)[0]
        if mesh is not None:      # the global batch's last-layer gradients
            all_reduce_([g_nll, g_g], mesh)
        d_weight = torch.linalg.vector_norm(g_nll) / (torch.linalg.vector_norm(g_g) + 1e-4)
        d_weight = torch.clamp(d_weight, 0.0, 1e4).detach() * cfg.disc_weight
        loss = nll + cfg.kl_weight * kl + d_weight * disc_factor * g
        trainable = list(vae.parameters()) + [state.logvar]
        loss.backward()
        disc.zero_grad(set_to_none=True)
        self._reduce(trainable)
        state.opt_ae.step()
        state.opt_ae.zero_grad(set_to_none=True)
        metrics = dict(nll_loss=nll, rec_loss=rec, kl_loss=kl, g_loss=g, d_weight=d_weight,
                       total_loss=loss)

        # ---- the discriminator (the autoencoder's pre-update reconstruction) ----
        recon = recon.detach()
        logits_real = disc(images, train=True)
        logits_fake = disc(recon, train=True)
        d_loss = disc_factor * self.d_loss_fn(logits_real, logits_fake)
        d_loss.backward()
        self._reduce(list(disc.parameters()))
        state.opt_disc.step()
        state.opt_disc.zero_grad(set_to_none=True)
        metrics["disc_loss"] = d_loss
        state.step += 1
        return state, metrics_mean({k: v.detach() for k, v in metrics.items()}, mesh)
