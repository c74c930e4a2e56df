"""Legacy layout-training losses (the reference's `trainer/loss.py:20-716`
family); port of the JAX package's `training/legacy_losses.py`.

They drive the legacy trainers (`training/legacy_trainer.py`) of the legacy
models (`models/layout/legacy.py`).  Each formula is JAX's as executed
there: boolean indexing as masked sums, the top-k component mask keeping
the k nearest components (ties to the lower index, as `lax.top_k`), the
reference's quirks kept (RegLoss masks every row from the first row holding
the sentinel on; FocalLoss weights raw scores).
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

GMM_K = 5
IGNORE_XYWH = 2.0  # the [2, 2, 2, 2] "no label" sentinel (`VGDataset.py:84`)


def _gmm_params(gmm: torch.Tensor):
    """`Log_Pdf.get_gmm_params`: split [*, 6K] -> (softmax pi, mux, muy,
    exp sx, exp sy, tanh rho)."""
    pi, ux, uy, sx, sy, rho = torch.chunk(gmm, 6, dim=-1)
    return torch.softmax(pi, -1), ux, uy, torch.exp(sx), torch.exp(sy), torch.tanh(rho)


def _bivariate_log_pdf(gmm, gt_a, gt_b, topk: int = -1):
    """`Log_Pdf.pdf`: log sum_k pi_k N((a, b); ...) + 1e-5, optionally over
    the `topk` components nearest (a, b) only."""
    pi, ux, uy, sx, sy, rho = _gmm_params(gmm)
    a, b = gt_a[..., None], gt_b[..., None]
    zx = ((a - ux) / sx) ** 2
    zy = ((b - uy) / sy) ** 2
    zxy = (a - ux) * (b - uy) / (sx * sy)
    z = zx + zy - 2.0 * rho * zxy
    e = torch.exp(-z / (2.0 * (1.0 - rho ** 2)))
    norm = torch.clamp(2.0 * math.pi * sx * sy * torch.sqrt(1.0 - rho ** 2), min=1e-5)
    raw = pi * e / norm
    if topk != -1:
        dist = torch.sqrt((a - ux) ** 2 + (b - uy) ** 2)
        idx = torch.sort(-dist, dim=-1, descending=True, stable=True)[1][..., :topk]
        raw = raw * torch.zeros_like(raw).scatter_(-1, idx, 1.0)
    return torch.log(raw.sum(-1) + 1e-5)


def _bivar_kl_vs_unit(sigma, mask):
    """`Log_Pdf.batch_Bivar_KLDivLoss` against N(mu, I): 0.5 (-log sx sy - 2
    + sx + sy) summed over components and kept rows."""
    sx, sy = sigma[..., 0], sigma[..., 1]
    per = 0.5 * (-torch.log(sx * sy) - 2.0 + sx + sy)
    return (per.sum(-1) * mask).sum()


def log_pdf_loss(gmm: torch.Tensor, xywh: torch.Tensor, only_wh: bool = False,
                 rel_gt: bool = False, topk: int = -1, kd: bool = False
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """`Log_Pdf.forward`, reduction 'sum': (bbox_loss, kl_loss).  gmm [T, 12K]
    (xy ‖ wh), xywh [T, 4]; rows with x == 2 are ignored; without rel_gt
    only the odd rows carry labels."""
    if not rel_gt:
        gmm, xywh = gmm[1::2], xywh[1::2]
    mask = (xywh[:, 0] != IGNORE_XYWH).to(gmm.dtype)
    xy_gmm, wh_gmm = gmm[:, :GMM_K * 6], gmm[:, GMM_K * 6:]
    gt_x, gt_y = (xywh[:, 2], xywh[:, 3]) if only_wh else (xywh[:, 0], xywh[:, 1])
    xy_pdf = _bivariate_log_pdf(xy_gmm, gt_x, gt_y, topk)
    wh_pdf = _bivariate_log_pdf(wh_gmm, xywh[:, 2], xywh[:, 3], topk)
    bbox_loss = -(xy_pdf * mask).sum() - (wh_pdf * mask).sum()
    kl_loss = torch.zeros((), dtype=gmm.dtype, device=gmm.device)
    if kd:
        for g in (xy_gmm, wh_gmm):
            _, _, _, sx, sy, _ = _gmm_params(g)
            kl_loss = kl_loss + _bivar_kl_vs_unit(torch.stack([sx, sy], -1), mask)
    return bbox_loss, kl_loss


def reg_loss(pred: torch.Tensor, target: torch.Tensor, pretrain: bool = False,
             reduction: str = "sum") -> torch.Tensor:
    """`RegLoss.forward`: |pred| vs target, MSE on xy + MSE on sqrt(wh),
    ignore-masked (without `pretrain`, every row from the first row holding
    the sentinel on)."""
    pred = pred.abs()
    if pretrain:
        pred, target = pred[1::2], target[1::2]
        mask = (target[:, 0] != IGNORE_XYWH).to(pred.dtype)
    else:
        row_has = (target == IGNORE_XYWH).any(1)
        n = target.shape[0]
        first = int(row_has.long().argmax()) if bool(row_has.any()) else n
        mask = (torch.arange(n, device=pred.device) < first).to(pred.dtype)
    xy_se = ((pred[:, :2] - target[:, :2]) ** 2).sum(1)
    wh_se = ((torch.sqrt(pred[:, 2:4]) - torch.sqrt(target[:, 2:4])) ** 2).sum(1)
    total = (xy_se * mask).sum() + (wh_se * mask).sum()
    if reduction == "mean":
        return total / torch.clamp(mask.sum(), min=1.0)
    return total


def focal_loss(inputs: torch.Tensor, targets: torch.Tensor, gamma: float = 2.0,
               alpha: Optional[float] = None, ignore_index: Optional[int] = None,
               reduction: str = "sum") -> torch.Tensor:
    """`FocalLoss.forward` as executed: the focal weight where(onehot, 1-x,
    x)**gamma on raw scores times the scalar mean binary cross-entropy of
    softmax(inputs) vs one-hot; ignored rows excluded from both."""
    C = inputs.shape[-1]
    onehot = F.one_hot(targets.long(), C).to(inputs.dtype)
    if ignore_index is not None:
        row = (targets != ignore_index).to(inputs.dtype)[:, None]
    else:
        row = torch.ones(inputs.shape[0], 1, dtype=inputs.dtype, device=inputs.device)
    fw = torch.where(onehot == 1.0, 1.0 - inputs, inputs)
    if alpha is not None:
        fw = torch.where(onehot == 1.0, alpha, 1.0 - alpha) * fw ** gamma
    else:
        fw = fw ** gamma
    p = torch.clamp(torch.softmax(inputs, -1), 1e-12, 1.0 - 1e-12)
    bce_elem = -(onehot * torch.log(p) + (1.0 - onehot) * torch.log(1.0 - p))
    n_kept = torch.clamp(row.sum(), min=1.0)
    bce = (bce_elem * row).sum() / (n_kept * C)
    cls = fw * bce * row
    if reduction == "mean":
        return cls.sum() / (n_kept * C)
    return cls.sum()


def xent_loss(log_probs: torch.Tensor, targets: torch.Tensor, pad_index: int,
              smoothing: float = 0.1) -> torch.Tensor:
    """`XentLoss`, reduction 'sum': with smoothing, KL(smoothed target ‖
    exp(log_probs)) with the mass spread over V - 2 slots, the pad column
    and pad rows zeroed; without, the NLL of the kept rows."""
    N, V = log_probs.shape
    keep = (targets != pad_index).to(log_probs.dtype)
    if smoothing <= 0.0:
        nll = -torch.gather(log_probs, 1, targets.long()[:, None])[:, 0]
        return (nll * keep).sum()
    smooth = torch.full((N, V), smoothing / (V - 2), dtype=log_probs.dtype,
                        device=log_probs.device)
    smooth = torch.where(F.one_hot(targets.long(), V).bool(), 1.0 - smoothing, smooth)
    smooth[:, pad_index] = 0.0
    smooth = smooth * keep[:, None]
    tlogt = torch.where(smooth > 0, smooth * torch.log(torch.where(smooth > 0, smooth, 1.0)),
                        0.0)
    return (tlogt - smooth * log_probs).sum()


def nll_loss(log_probs: torch.Tensor, targets: torch.Tensor,
             ignore_index: int = 0) -> torch.Tensor:
    """torch's `NLLLoss(ignore_index, reduction='sum')`, the legacy trainers'
    criterion."""
    keep = (targets != ignore_index).to(log_probs.dtype)
    nll = -torch.gather(log_probs, 1, targets.long()[:, None])[:, 0]
    return (nll * keep).sum()
