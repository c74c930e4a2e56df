"""Contrastive (InfoNCE) training of the dual-tower CLIP; port of the JAX
package's `training/clip_trainer.py`.

The reference consumes OpenAI's pretrained ViT-B/32 and never trains CLIP;
the closed-loop testbed trains a tiny CLIP from scratch as its fidelity
judge.  The objective is CLIP's (Radford et al. 2021): symmetric cross
entropy over cosine-similarity logits with a learned temperature, with one
addition: logits between distinct rows whose token sequences are identical
(in-batch duplicate captions, false negatives) are masked out of both
softmaxes; the diagonal stays.  AdamW (b1 0.9, b2 0.999, eps 1e-8, decoupled
decay) over the CLIP parameters and the log temperature, as optax's `adamw`.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..models.clip import CLIP


@dataclasses.dataclass
class CLIPTrainState:
    params: CLIP                   # updated in place
    logit_scale: torch.Tensor      # scalar, log of the inverse temperature
    opt_state: torch.optim.AdamW
    step: int


def _unit(x):
    return x / torch.clamp(torch.linalg.vector_norm(x, dim=-1, keepdim=True), min=1e-8)


def clip_contrastive_loss(img_feat: torch.Tensor, txt_feat: torch.Tensor,
                          logit_scale: torch.Tensor,
                          tokens: torch.Tensor) -> Tuple[torch.Tensor, dict]:
    """Symmetric InfoNCE with duplicate-caption masking.  img_feat / txt_feat
    [B, D] (unnormalized); tokens [B, L] (only to find duplicates)."""
    scale = torch.exp(torch.clamp(logit_scale, max=float(np.log(100.0))))
    logits = scale * _unit(img_feat) @ _unit(txt_feat).T          # [B, B]
    B = logits.shape[0]
    same = (tokens[:, None, :] == tokens[None, :, :]).all(dim=-1)
    off_diag_dup = same & ~torch.eye(B, dtype=torch.bool, device=logits.device)
    logits = logits.masked_fill(off_diag_dup, float("-inf"))
    labels = torch.arange(B, device=logits.device)
    loss = 0.5 * (F.cross_entropy(logits, labels) + F.cross_entropy(logits.T, labels))
    acc = (logits.argmax(dim=-1) == labels).float().mean()
    return loss, {"loss": loss.detach(), "acc_i2t": acc, "scale": scale.detach()}


def make_clip_train_step(clip: CLIP, lr: float = 1e-3, weight_decay: float = 0.05):
    """-> (init_fn() -> state, step_fn(state, images, tokens) -> (state,
    metrics)); images: the model-input pixels [B, H, W, 3]."""

    def init_fn() -> CLIPTrainState:
        dev = next(clip.parameters()).device
        logit_scale = torch.tensor(np.log(1.0 / 0.07), dtype=torch.float32, device=dev,
                                   requires_grad=True)
        params = list(clip.parameters()) + [logit_scale]
        fused = dev.type == "cuda"
        opt = torch.optim.AdamW(params, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                                weight_decay=weight_decay, fused=fused or None,
                                foreach=None if fused else True)
        return CLIPTrainState(params=clip, logit_scale=logit_scale, opt_state=opt, step=0)

    def step_fn(state: CLIPTrainState, images, tokens):
        img_feat, txt_feat = clip(images, tokens)
        loss, metrics = clip_contrastive_loss(img_feat, txt_feat, state.logit_scale, tokens)
        state.opt_state.zero_grad(set_to_none=True)
        loss.backward()
        state.opt_state.step()
        state.opt_state.zero_grad(set_to_none=True)
        state.step += 1
        return state, metrics

    return init_fn, step_fn


@torch.no_grad()
def retrieval_accuracy(clip: CLIP, images: np.ndarray, tokens: np.ndarray,
                       batch: int = 256) -> float:
    """Held-out zero-shot check: the share of images whose nearest caption,
    over the distinct captions present, is their own."""
    dev = next(clip.parameters()).device
    uniq, inverse = np.unique(np.asarray(tokens), axis=0, return_inverse=True)
    inverse = inverse.reshape(-1)
    tf = _unit(clip.encode_text(torch.from_numpy(uniq).to(dev)).float())
    hits = 0
    for i in range(0, len(images), batch):
        feats = _unit(clip.encode_image(torch.from_numpy(images[i:i + batch]).to(dev)).float())
        pred = (feats @ tf.T).argmax(dim=-1).cpu().numpy()
        hits += int(np.sum(pred == inverse[i:i + batch]))
    return hits / len(images)
