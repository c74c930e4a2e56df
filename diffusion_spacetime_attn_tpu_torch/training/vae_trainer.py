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
from the step's JAX key, as `AutoencoderKL.encode(x, rng)` does.  One
device: a mesh or fsdp raises (ROADMAP A.13).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch
from torch import nn

from ..models.vae import AutoencoderKL
from ..utils import prng
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
    def __init__(self, vae: AutoencoderKL, cfg: VAETrainConfig, mesh=None,
                 fsdp: bool = False):
        if mesh is not None or fsdp:
            raise NotImplementedError("VAETrainer: the PyTorch port trains on one device; a "
                                      "mesh or FSDP is ROADMAP A.13")
        self.vae, self.cfg = vae, cfg
        self.device = next(vae.parameters()).device
        self.disc = NLayerDiscriminator(ndf=cfg.disc_ndf, n_layers=cfg.disc_layers).to(self.device)
        self.d_loss_fn = hinge_d_loss if cfg.disc_loss == "hinge" else vanilla_d_loss

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

    def train_step(self, state: VAETrainState, images: torch.Tensor,
                   rng: np.ndarray) -> Tuple[VAETrainState, dict]:
        """images [B, H, W, 3] in [-1, 1]; rng: the JAX key of the sample."""
        cfg = self.cfg
        vae, disc = state.ae_params, state.disc_params
        disc_factor = adopt_weight(cfg.disc_factor, state.step, cfg.disc_start)

        # ---- the autoencoder (the discriminator frozen, in eval mode) ----
        mean, lv = vae.encode_moments(images)
        z = mean + torch.exp(0.5 * lv) * prng.normal_like(rng, mean)
        recon = vae.decode(z)
        nll, rec = self._nll(state, recon, images)
        kl = kl_divergence(mean, lv).sum() / images.shape[0]
        g = -disc(recon, train=False).mean()
        last = vae.decoder.conv_out.weight
        g_nll = torch.autograd.grad(nll, last, retain_graph=True)[0]
        g_g = torch.autograd.grad(g, last, retain_graph=True)[0]
        d_weight = torch.linalg.vector_norm(g_nll) / (torch.linalg.vector_norm(g_g) + 1e-4)
        d_weight = torch.clamp(d_weight, 0.0, 1e4).detach() * cfg.disc_weight
        loss = nll + cfg.kl_weight * kl + d_weight * disc_factor * g
        trainable = list(vae.parameters()) + [state.logvar]
        for p, gr in zip(trainable, torch.autograd.grad(loss, trainable)):
            p.grad = gr
        state.opt_ae.step()
        state.opt_ae.zero_grad(set_to_none=True)
        metrics = dict(nll_loss=nll, rec_loss=rec, kl_loss=kl, g_loss=g, d_weight=d_weight,
                       total_loss=loss)

        # ---- the discriminator (the autoencoder's pre-update reconstruction) ----
        recon = recon.detach()
        logits_real = disc(images, train=True)
        logits_fake = disc(recon, train=True)
        d_loss = disc_factor * self.d_loss_fn(logits_real, logits_fake)
        params = list(disc.parameters())
        for p, gr in zip(params, torch.autograd.grad(d_loss, params)):
            p.grad = gr
        state.opt_disc.step()
        state.opt_disc.zero_grad(set_to_none=True)
        metrics["disc_loss"] = d_loss
        state.step += 1
        return state, {k: v.detach() for k, v in metrics.items()}
