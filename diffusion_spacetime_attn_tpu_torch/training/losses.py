"""Layout-predictor training losses at fixed shapes; port of the JAX
package's `training/losses.py`.

Reference:
  * `Customized_Hinge_Loss` (`trainer/loss.py:315-333`): for a relation
    (i, j, rel) the GMM means of the two object tokens must satisfy the
    relation with a 0.2 margin, e.g. "above" => max(μy_i) − min(μy_j) pushed
    down to −0.2.  (The reference's leading `torch.clamp` calls discard
    their results and are not reproduced.)
  * `Customized_Gmm_Loss` (`trainer/loss.py:336-452`): −log Σ_k π_k N(gt)
    per absolute-annotated token.
  * The sum `real_loss + 0.1·gmm_loss` (`trainer/Pretrain.py:262-266`).

Relations and absolute targets are padded to [R] / [O] with validity
masks, so the loss is one expression over the batch.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..models.layout.gmm_head import gmm_log_likelihood

# relation ids
REL_ABOVE, REL_BELOW, REL_LEFT, REL_RIGHT = 0, 1, 2, 3
REL_NAMES = ("above", "below", "left of", "right of")
REL_TO_ID = {n: i for i, n in enumerate(REL_NAMES)}


class LayoutBatch(NamedTuple):
    """One fixed-shape training batch (tensors, or numpy arrays before
    `to_tensors`)."""

    tokens: torch.Tensor      # [B, L] int32
    object_pos: torch.Tensor  # [B, L] float: object-token indicator
    rel_idx: torch.Tensor     # [B, R, 2] int32: token indices of (obj1, obj2)
    rel_type: torch.Tensor    # [B, R] int32: REL_* id
    rel_valid: torch.Tensor   # [B, R] float
    abs_idx: torch.Tensor     # [B, O] int32: token index of an annotated object
    abs_xy: torch.Tensor      # [B, O, 2] float: ground-truth (x, y) center
    abs_valid: torch.Tensor   # [B, O] float

    def to(self, device) -> "LayoutBatch":
        """The batch as tensors on `device` (numpy arrays are converted)."""
        return LayoutBatch(*(torch.as_tensor(a).to(device) for a in self))


def _take(t: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """t [B, L, F] at the token indices idx [B, R] -> [B, R, F]."""
    return torch.gather(t, 1, idx.long()[..., None].expand(*idx.shape, t.shape[-1]))


def hinge_relation_loss(gmm: torch.Tensor, batch: LayoutBatch, margin: float = 0.2,
                        k: int = 5) -> torch.Tensor:
    """Σ over valid relations of max(diff, −margin) (scalar)."""
    mu_x = gmm[..., k:2 * k]       # raw slices [5:10]
    mu_y = gmm[..., 2 * k:3 * k]   # [10:15]
    x1, x2 = _take(mu_x, batch.rel_idx[..., 0]), _take(mu_x, batch.rel_idx[..., 1])
    y1, y2 = _take(mu_y, batch.rel_idx[..., 0]), _take(mu_y, batch.rel_idx[..., 1])
    diffs = torch.stack([
        y1.amax(-1) - y2.amin(-1),   # above
        y2.amax(-1) - y1.amin(-1),   # below
        x1.amax(-1) - x2.amin(-1),   # left of
        x2.amax(-1) - x1.amin(-1),   # right of
    ], dim=-1)                       # [B, R, 4]
    diff = torch.gather(diffs, -1, batch.rel_type.long()[..., None])[..., 0]
    loss = torch.clamp(diff, min=-margin)
    return torch.sum(loss * batch.rel_valid)


def gmm_nll_loss(gmm: torch.Tensor, batch: LayoutBatch, k: int = 5) -> torch.Tensor:
    """Σ over valid absolute targets of −log p(gt_xy) (scalar)."""
    raw = _take(gmm, batch.abs_idx)                    # [B, O, 6K]
    ll = gmm_log_likelihood(raw, batch.abs_xy, k)      # [B, O]
    return -torch.sum(ll * batch.abs_valid)


def layout_total_loss(gmm: torch.Tensor, batch: LayoutBatch, gmm_weight: float = 0.1,
                      margin: float = 0.2, k: int = 5):
    """-> (hinge + gmm_weight · NLL, {"hinge", "gmm_nll"})."""
    rel = hinge_relation_loss(gmm, batch, margin, k)
    nll = gmm_nll_loss(gmm, batch, k)
    return rel + gmm_weight * nll, {"hinge": rel, "gmm_nll": nll}
