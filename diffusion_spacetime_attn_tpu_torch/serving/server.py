"""Serving engines, port of the JAX package's `serving/server.py`:
`TextToImageEngine` (spatial control at fixed weights) and `SpaceTimeEngine`
(the paper's full method: per-request temporal weight optimization).

The engine runs a fixed batch size: tokenize -> encode -> PLMS -> decode,
padding a short batch with empty prompts.  With `prepare_host` (prompt ->
{"centers", "active", "local_texts"} or None) requests run with the paper's
spatial attention control at fixed per-object weights
`active·init_coef / max(Σ active, 1)` for every step; pad rows and prompts
whose host stage fails get inactive control, which is an exact no-op.
Per-request noise comes from `torch.Generator(device).manual_seed(seed)`, so
a request's image does not depend on its batch position.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from ..ops.attention import SpatialControl
from ..utils.cudnn import deterministic


@dataclass
class TextToImageEngine:
    sd: object                                  # pipeline.StableDiffusion
    tokenize: Callable[[str], Sequence[int]]    # text -> fixed-length ids
    batch_size: int = 8
    sampler: str = "plms"
    guidance_scale: Optional[float] = None
    prepare_host: Optional[Callable] = None     # prompt -> dict | None (spatial)
    init_coef: Optional[float] = None           # default: cfg.spacetime.init_coef
    _uncond_ids: np.ndarray = field(default=None, repr=False)

    def __post_init__(self):
        self._uncond_ids = np.asarray(self.tokenize(""), np.int32)

    def _hosts(self, prompts: List[str]):
        """Host stage per prompt: centers, active flags, local-context ids."""
        N = self.sd.cfg.spacetime.max_objects
        L = self._uncond_ids.shape[0]
        local_ids = np.tile(self._uncond_ids, (len(prompts), N, 1))
        centers = np.zeros((len(prompts), N, 2), np.float32)
        active = np.zeros((len(prompts), N), np.float32)
        for i, p in enumerate(prompts):
            h = self.prepare_host(p)
            if h is None:
                continue
            centers[i], active[i] = h["centers"], h["active"]
            for j, t in enumerate(h["local_texts"][:N]):
                if t:
                    local_ids[i, j] = np.asarray(self.tokenize(t), np.int32)[:L]
        return local_ids, centers, active

    @torch.inference_mode()
    def _run(self, token_ids: np.ndarray, seeds: np.ndarray, local_ids=None,
             centers=None, active=None) -> torch.Tensor:
        sd = self.sd
        cfg, dev = sd.cfg, sd.device
        B, N, S = self.batch_size, cfg.spacetime.max_objects, sd.schedule.num_steps
        if self.prepare_host is not None:
            # one encoder call for captions + all local contexts
            emb = sd.encode_text(np.concatenate([token_ids, local_ids.reshape(B * N, -1)]))
            cond, locals_ = emb[:B], emb[B:].reshape(B, N, *emb.shape[1:])
            act = torch.as_tensor(active, device=dev)
            init = cfg.spacetime.init_coef if self.init_coef is None else self.init_coef
            coef = act * (init / torch.clamp(act.sum(-1, keepdim=True), min=1.0))
            control = SpatialControl(local_contexts=locals_,
                                     centers=torch.as_tensor(centers, device=dev),
                                     coef=coef, active=act)
            coef_schedule = coef[..., None].expand(B, N, S)
        else:
            cond = sd.encode_text(token_ids)
            control, coef_schedule = None, None
        uncond = sd.encode_text(np.tile(self._uncond_ids, (B, 1)))
        gs = cfg.spacetime.guidance_scale if self.guidance_scale is None else self.guidance_scale
        eps_fn = sd.make_eps_fn(cond, uncond, gs, control, coef_schedule)
        latent, in_ch = cfg.spacetime.latent_size, cfg.unet.in_channels
        x_T = torch.stack([
            torch.randn((latent, latent, in_ch), device=dev,
                        generator=torch.Generator(device=dev).manual_seed(int(s)))
            for s in seeds])
        z = sd.sample_from(eps_fn, x_T, sampler=self.sampler, remat=False)
        img = sd.decode_latents(z)
        return (img * 255.0 + 0.5).to(torch.uint8)

    def generate_batch(self, prompts: List[str], seeds: List[int]) -> np.ndarray:
        """<= batch_size prompts -> [len(prompts), H, W, 3] uint8."""
        n = len(prompts)
        if not 0 < n <= self.batch_size:
            raise ValueError(f"{n} prompts for a batch of {self.batch_size}")
        pad = self.batch_size - n
        ids = np.stack([np.asarray(self.tokenize(p), np.int32) for p in prompts]
                       + [self._uncond_ids] * pad)
        s = np.asarray(list(seeds) + [0] * pad, np.int64)
        if self.prepare_host is None:
            return self._run(ids, s)[:n].cpu().numpy()
        local_ids, centers, active = self._hosts(prompts)
        if pad:  # pad rows: inactive control
            local_ids = np.concatenate(
                [local_ids, np.tile(self._uncond_ids, (pad, local_ids.shape[1], 1))])
            centers = np.concatenate([centers, np.zeros((pad,) + centers.shape[1:], np.float32)])
            active = np.concatenate([active, np.zeros((pad,) + active.shape[1:], np.float32)])
        return self._run(ids, s, local_ids, centers, active)[:n].cpu().numpy()


@dataclass
class SpaceTimeEngine:
    """Full-method serving: every batch runs the paper's whole pipeline, the
    layout from `prepare_host`, then `cfg.spacetime.epochs` Adam epochs whose
    gradients flow through the whole sampling chain
    (`pipeline/spacetime.py`), and returns the fidelity-optimized images.

    `prepare_host(prompt)` returns {"centers", "active", "local_texts",
    "object_texts"} or None.  A None row and every pad row run with zero
    `active`, so the blend and the per-object losses are exact no-ops and
    the row is vanilla sampling of its seed.  `tokenize` gives the SD text
    encoder's ids, `clip_tokenize` the loss CLIP's.  Per-request noise comes
    from `torch.Generator(device).manual_seed(seed)`, and cuDNN runs its
    deterministic algorithms, so an image is a function of (prompt, seed)
    whatever else is in its batch.
    """

    sd: object                                  # pipeline.StableDiffusion
    clip_loss: object                           # pipeline.losses.DCLIPLoss
    tokenize: Callable[[str], Sequence[int]]    # text -> SD text-encoder ids
    clip_tokenize: Callable[[str], Sequence[int]]  # text -> loss-CLIP ids
    prepare_host: Callable                      # prompt -> dict | None
    batch_size: int = 4
    sampler: str = "plms"

    def _empty_host(self) -> dict:
        N = self.sd.cfg.spacetime.max_objects
        return {"centers": np.zeros((N, 2), np.float32), "active": np.zeros(N, np.float32),
                "local_texts": [""] * N, "object_texts": [""] * N}

    def _inputs(self, prompts: List[str], seeds: List[int]):
        from ..pipeline.spacetime import SpaceTimeInputs

        sd, dev = self.sd, self.sd.device
        N = sd.cfg.spacetime.max_objects
        hosts = [self.prepare_host(p) or self._empty_host() for p in prompts]
        pad = self.batch_size - len(prompts)
        hosts += [self._empty_host()] * pad
        texts = list(prompts) + [""] * pad
        for h in hosts:
            texts += (list(h["local_texts"]) + [""] * N)[:N]
        ids = np.stack([np.asarray(self.tokenize(t), np.int32) for t in texts])
        B = self.batch_size
        emb = sd.encode_text(ids)            # captions + every local context in one call
        uncond = sd.encode_text(np.tile(np.asarray(self.tokenize(""), np.int32), (B, 1)))

        def clip_ids(ts):
            return np.stack([np.asarray(self.clip_tokenize(t), np.int32) for t in ts])

        objects = np.stack([clip_ids((list(h["object_texts"]) + [""] * N)[:N]) for h in hosts])
        latent, in_ch = sd.cfg.spacetime.latent_size, sd.cfg.unet.in_channels
        all_seeds = list(seeds) + [0] * pad
        x_T = torch.stack([
            torch.randn((latent, latent, in_ch), device=dev,
                        generator=torch.Generator(device=dev).manual_seed(int(s)))
            for s in all_seeds])
        as_dev = lambda a, dt=torch.float32: torch.as_tensor(np.asarray(a), dtype=dt, device=dev)  # noqa: E731
        return SpaceTimeInputs(
            cond=emb[:B], uncond=uncond,
            local_contexts=emb[B:].reshape(B, N, *emb.shape[1:]),
            centers=as_dev(np.stack([h["centers"] for h in hosts])),
            active=as_dev(np.stack([h["active"] for h in hosts])),
            caption_tokens=as_dev(clip_ids(texts[:B]), torch.int64),
            object_tokens=as_dev(objects, torch.int64), x_T=x_T)

    def optimize_batch(self, prompts: List[str], seeds: List[int], on_epoch=None):
        """(images [batch_size, H, W, 3] in [0, 1], coef, losses) of one
        padded batch; `on_epoch(e, images)` as in `optimize_prompt`."""
        from ..pipeline.spacetime import optimize_prompt

        n = len(prompts)
        if not 0 < n <= self.batch_size:
            raise ValueError(f"{n} prompts for a batch of {self.batch_size}")
        with torch.no_grad():
            inputs = self._inputs(prompts, seeds)
        with deterministic():
            return optimize_prompt(self.sd, self.clip_loss, inputs, self.sd.cfg.spacetime,
                                   sampler=self.sampler, on_epoch=on_epoch)

    @staticmethod
    def to_uint8(images: torch.Tensor) -> np.ndarray:
        return (images * 255.0 + 0.5).clamp(0, 255).to(torch.uint8).cpu().numpy()

    def generate_batch(self, prompts: List[str], seeds: List[int]) -> np.ndarray:
        """<= batch_size prompts -> [len(prompts), H, W, 3] uint8."""
        images, _, _ = self.optimize_batch(prompts, seeds)
        return self.to_uint8(images[:len(prompts)])
