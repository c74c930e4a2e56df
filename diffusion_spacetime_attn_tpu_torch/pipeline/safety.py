"""Safety checkers; port of the JAX package's `pipeline/safety.py`.

Reference surface: `scripts/txt2img-gpt.py:32-35,75-101`, diffusers'
`StableDiffusionSafetyChecker` (CLIP concept matching; flagged images are
replaced by black).  The watermark is `utils/watermark.py`.

  * `DiffusersSafetyChecker`: the diffusers module, read from its state
    dict (`vision_model.vision_model.*` through `convert_hf_clip_vision`,
    `visual_projection.weight`, `concept_embeds`, `special_care_embeds` and
    their `*_weights`), the tower's dims inferred from the state dict as
    `safety.py:58-92` does;
  * `SafetyChecker`: cosine similarity of CLIP image embeddings against
    concept embeddings; without concepts it is a no-op.

Both resize with the port's half-pixel bilinear resize (the diffusers
feature extractor resamples bicubically; for square generated images that
is the only deviation, as in JAX) and return (images, flags), the flags a
numpy bool array.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch

from ..config import CLIPVisionConfig
from ..models.clip import CLIP, CLIPVisionTower
from ..utils import convert
from ..utils.weights import flatten_tree, load_flat
from .losses import bilinear_resize

CLIP_IMAGE_MEAN = np.array([0.48145466, 0.4578275, 0.40821073], np.float32)
CLIP_IMAGE_STD = np.array([0.26862954, 0.26130258, 0.27577711], np.float32)

_TOWER = "vision_model.vision_model."


def _black_out(images01: torch.Tensor, flagged: np.ndarray) -> torch.Tensor:
    keep = torch.as_tensor(~flagged, device=images01.device)[:, None, None, None]
    return torch.where(keep, images01, torch.zeros_like(images01))


def _unit(x: torch.Tensor) -> torch.Tensor:
    return x / torch.linalg.vector_norm(x, dim=-1, keepdim=True)


class DiffusersSafetyChecker:
    """diffusers' `StableDiffusionSafetyChecker` (what the reference
    instantiates, `txt2img-gpt.py:32-35,94-101`):

      image_embeds   = visual_projection(vision_pooled)     (no bias)
      special_scores = cos(image_embeds, special_care_embeds) − special_w
      adjustment     = 0.01 where any special_score > 0 else 0
      concept_scores = cos(image_embeds, concept_embeds) − concept_w + adj
      nsfw           = any(concept_score > 0); flagged images -> black.

    Inputs are resized to the tower's image size and CLIP-normalized."""

    def __init__(self, vision: CLIPVisionTower, proj_kernel, concept_embeds, concept_weights,
                 special_embeds, special_weights):
        dev = vision.position_embedding.device

        def f32(a):
            return torch.as_tensor(np.asarray(a, np.float32), device=dev)

        self.vision = vision
        self.proj = f32(proj_kernel)               # [hidden, proj]
        self.concepts = f32(concept_embeds)        # [C, proj]
        self.concept_w = f32(concept_weights)      # [C]
        self.specials = f32(special_embeds)        # [S, proj]
        self.special_w = f32(special_weights)      # [S]

    @staticmethod
    def infer_config(state: Dict[str, np.ndarray]) -> CLIPVisionConfig:
        """The tower's dims from the state dict (the SD checker: ViT-L/14 at
        224², hidden 1024, 64-wide heads)."""
        hidden, _, patch, _ = state[_TOWER + "embeddings.patch_embedding.weight"].shape
        n_pos = state[_TOWER + "embeddings.position_embedding.weight"].shape[0]
        layers = 0
        while f"{_TOWER}encoder.layers.{layers}.layer_norm1.weight" in state:
            layers += 1
        return CLIPVisionConfig(image_size=int(round((n_pos - 1) ** 0.5)) * patch,
                                patch_size=patch, width=hidden, layers=layers,
                                heads=hidden // 64)

    @classmethod
    def from_checkpoint(cls, path_or_state: Union[str, Dict[str, np.ndarray]],
                        cfg: Optional[CLIPVisionConfig] = None,
                        device="cuda") -> "DiffusersSafetyChecker":
        """From a diffusers safety-checker checkpoint (a path or its state
        dict as arrays); the tower's config is inferred unless given."""
        state = (convert.load_torch_checkpoint(path_or_state)
                 if isinstance(path_or_state, str) else path_or_state)
        cfg = cfg or cls.infer_config(state)
        with torch.device(device):
            tower = CLIPVisionTower(cfg)
        tower.eval().requires_grad_(False)
        load_flat(tower, flatten_tree(convert.convert_hf_clip_vision(state, prefix=_TOWER)))
        return cls(tower, np.asarray(state["visual_projection.weight"], np.float32).T,
                   state["concept_embeds"], state["concept_embeds_weights"],
                   state["special_care_embeds"], state["special_care_embeds_weights"])

    @classmethod
    def from_flat(cls, cfg: CLIPVisionConfig, tower: Dict[str, np.ndarray], proj_kernel,
                  concept_embeds, concept_weights, special_embeds, special_weights,
                  device="cuda") -> "DiffusersSafetyChecker":
        """From the JAX checker's parts: its tower params as a flat tree
        (`utils/weights.py`, loaded strictly), the projection kernel
        [hidden, proj] and the concept arrays."""
        with torch.device(device):
            vision = CLIPVisionTower(cfg)
        load_flat(vision.eval().requires_grad_(False), tower)
        return cls(vision, proj_kernel, concept_embeds, concept_weights, special_embeds,
                   special_weights)

    @torch.inference_mode()
    def image_embeds(self, images01: torch.Tensor) -> torch.Tensor:
        pixels = bilinear_resize(images01.float(), self.vision.cfg.image_size)
        mean = torch.as_tensor(CLIP_IMAGE_MEAN, device=pixels.device)
        std = torch.as_tensor(CLIP_IMAGE_STD, device=pixels.device)
        return self.vision((pixels - mean) / std) @ self.proj

    def scores(self, images01: torch.Tensor) -> torch.Tensor:
        """The concept scores [B, C] (flagged where any is > 0)."""
        embn = _unit(self.image_embeds(images01))
        special = embn @ _unit(self.specials).T - self.special_w[None, :]
        adjustment = torch.where((special > 0).any(dim=-1), 0.01, 0.0)[:, None]
        return embn @ _unit(self.concepts).T - self.concept_w[None, :] + adjustment

    def __call__(self, images01: torch.Tensor) -> Tuple[torch.Tensor, np.ndarray]:
        images01 = images01.to(self.proj.device)
        flagged = (self.scores(images01) > 0).any(dim=-1).cpu().numpy()
        return _black_out(images01, flagged), flagged


class SafetyChecker:
    """Concept matching on a CLIP's image embeddings: an image is flagged
    when its largest cosine similarity to a concept exceeds `threshold`.
    Without a CLIP or concepts it flags nothing (a hook that keeps the
    API)."""

    def __init__(self, clip: Optional[CLIP] = None, concept_embeds: Optional[np.ndarray] = None,
                 threshold: float = 0.3):
        self.clip = clip
        self.concepts = concept_embeds     # [C, proj], unit norm
        self.threshold = threshold

    def similarities(self, images01: torch.Tensor) -> torch.Tensor:
        """[B, C] cosine similarities to the concepts."""
        size = self.clip.cfg.vision.image_size
        with torch.inference_mode():
            emb = self.clip.encode_image(bilinear_resize(images01.float(), size))
        emb = _unit(emb)
        return emb @ torch.as_tensor(np.asarray(self.concepts, np.float32), device=emb.device).T

    def __call__(self, images01: torch.Tensor) -> Tuple[torch.Tensor, np.ndarray]:
        """-> (checked images, has_nsfw flags); flagged images are black
        (reference `txt2img-gpt.py:94-101`)."""
        if self.clip is None or self.concepts is None:
            return images01, np.zeros(images01.shape[0], bool)
        images01 = images01.to(self.clip.visual_projection.weight.device)
        flagged = (self.similarities(images01).max(dim=-1).values > self.threshold).cpu().numpy()
        return _black_out(images01, flagged), flagged
