"""Dataset runners: gpt / mscoco / vsr prompt sets, end to end; port of the
JAX package's `pipeline/runners.py`.

Reference: `scripts/txt2img-{gpt,mscoco,vsr}.py`: layout inference per
prompt, per-object CLIP contexts, PLMS sampling with the 3-epoch weight
optimization, outputs named `final{epoch}_s{seed}_index_{idx}.png`
(`evaluation/detector_result_gpt.py:144` reads that naming).

As in the JAX package: contexts flow as tensors (no `.pt` side files);
every prompt starts from the same noise for a seed (the reference calls
`seed_everything(1)` before every prompt, `txt2img-gpt.py:304-306`), drawn
as JAX draws it: `normal(PRNGKey(seed), (1, lat, lat, 4))` by
`utils/prng.py`, so a sweep starts every image from JAX's x_T; prompts
whose layout fails are skipped and logged.  Images are written by
`utils/png.py` with JAX's truncation `(x·255).clip(0, 255).astype(uint8)`.
The device work runs under cuDNN's deterministic algorithms
(`utils/cudnn.py`), so an image is a function of (prompt, seed) and, in
bfloat16 on the card, of its slot in a `BatchedRunner` batch
(`serving/server.py`).
"""
from __future__ import annotations

import dataclasses
import os
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from ..config import SpaceTimeConfig
from ..ops.attention import SpatialControl
from ..utils import prng
from ..utils.cudnn import deterministic
from ..utils.png import write_png
from .frontend import LayoutInference, extract_objects, local_context_prompt, local_loss_prompt
from .losses import DCLIPLoss
from .pipeline import StableDiffusion
from .spacetime import SpaceTimeInputs, optimize_prompt


def parse_gpt_prompts(path: str) -> List[str]:
    """`datasets/gpt.txt`: 4-line records, prompt = line 4i+2 minus the
    'Sentence: ' prefix (`txt2img-gpt.py:255-261`)."""
    with open(path) as f:
        rows = f.read().split("\n")[:2000]
    return [rows[4 * i + 2][10:] for i in range(len(rows) // 4)]


def parse_line_prompts(path: str) -> List[str]:
    """`datasets/mscoco.txt` / `vsr.txt`: one prompt per line."""
    with open(path) as f:
        return [line.strip() for line in f if line.strip()]


def save_image(image01: np.ndarray, path: str) -> None:
    """[H, W, 3] in [0, 1] -> 8-bit PNG, truncating as JAX's runner does."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    write_png(path, (np.asarray(image01) * 255.0).clip(0, 255).astype(np.uint8))


def result_name(epoch: int, seed: int, idx: int) -> str:
    return f"final{epoch}_s{seed}_index_{idx}.png"


def spatial_coef_schedule(active: torch.Tensor, init_total: float, num_steps: int):
    """[B, N] -> [B, N, S]: init_total / max(Σ active, 1) at every step (the
    fixed weights of the spatial mode)."""
    per = init_total / torch.clamp(active.sum(dim=-1, keepdim=True), min=1.0)
    return per.expand_as(active)[..., None].repeat(1, 1, num_steps)


@dataclasses.dataclass
class PromptRunner:
    """Runs one prompt set through the chosen pipeline mode on `sd.device`."""

    sd: StableDiffusion
    clip_loss: Optional[DCLIPLoss]   # required only for mode="spacetime"
    layout: LayoutInference
    clip_tokenize: Callable[[str], Sequence[int]]   # loss-CLIP tokens
    text_tokenize: Callable[[str], Sequence[int]]   # SD text-encoder tokens
    cfg: SpaceTimeConfig
    outdir: str = "result_outputs"
    mode: str = "spacetime"  # vanilla | spatial | spacetime
    sampler: str = "plms"    # plms | ddim | dpm, in every mode
    save_epoch_images: bool = False  # also save final{0..epochs-2}_… (the
                             # reference saves every epoch's image,
                             # `plms.py:280-288`; eval reads the last)
    _cached_uncond: Optional[torch.Tensor] = None

    def _encode(self, texts: List[str]) -> torch.Tensor:
        tokens = np.stack([np.asarray(self.text_tokenize(t), np.int32) for t in texts])
        return self.sd.encode_text(tokens)

    def _uncond(self) -> torch.Tensor:
        if self._cached_uncond is None:
            self._cached_uncond = self._encode([""])
        return self._cached_uncond

    def prepare_host(self, prompt: str):
        """Host stage: layout and tokenization.  None if the layout fails,
        else a dict of numpy arrays and texts."""
        N = self.cfg.max_objects
        res = self.layout(prompt)
        words, mentions = extract_objects(prompt)
        if not res or not mentions:
            return None
        mentions = mentions[:N]
        centers = np.zeros((N, 2), np.float32)
        active = np.zeros(N, np.float32)
        local_texts, obj_tokens = [], []
        for i, m in enumerate(mentions):
            centers[i] = res[m.phrase]
            active[i] = 1.0
            local_texts.append(local_context_prompt(m))
            obj_tokens.append(np.asarray(self.clip_tokenize(local_loss_prompt(m)), np.int32))
        pad = N - len(mentions)
        local_texts += [""] * pad
        obj_tokens += [np.asarray(self.clip_tokenize(""), np.int32)] * pad
        return dict(centers=centers, active=active, local_texts=local_texts,
                    obj_tokens=np.stack(obj_tokens),
                    caption_tokens=np.asarray(self.clip_tokenize(prompt), np.int32),
                    prompt=prompt)

    @torch.no_grad()
    def assemble_inputs(self, hosts, seed: int) -> SpaceTimeInputs:
        """Device stage for a chunk of `prepare_host` outputs: one text-encoder
        call for all captions and local contexts."""
        N = self.cfg.max_objects
        B = len(hosts)
        dev = self.sd.device
        texts = [h["prompt"] for h in hosts]
        for h in hosts:
            texts += h["local_texts"]
        embeds = self._encode(texts)
        lat = self.cfg.latent_size
        noise = prng.normal(prng.PRNGKey(seed), (1, lat, lat, 4))
        x_T = torch.from_numpy(np.concatenate([noise] * B)).to(dev)

        def stack(key, dtype=torch.float32):
            return torch.as_tensor(np.stack([h[key] for h in hosts]), dtype=dtype, device=dev)

        return SpaceTimeInputs(
            cond=embeds[:B], uncond=self._uncond().repeat(B, 1, 1),
            local_contexts=embeds[B:].reshape(B, N, *embeds.shape[1:]),
            centers=stack("centers"), active=stack("active"),
            caption_tokens=stack("caption_tokens", torch.int64),
            object_tokens=stack("obj_tokens", torch.int64), x_T=x_T)

    def build_inputs(self, prompt: str, seed: int) -> Optional[SpaceTimeInputs]:
        host = self.prepare_host(prompt)
        if host is None:
            return None
        return self.assemble_inputs([host], seed)

    @torch.inference_mode()
    def sample(self, inputs: SpaceTimeInputs, control: Optional[SpatialControl] = None,
               coef: Optional[torch.Tensor] = None) -> torch.Tensor:
        """One chain from inputs.x_T and the decode (vanilla, or spatial
        with a fixed coef schedule) -> images [B, S, S, 3] in [0, 1]."""
        eps = self.sd.make_eps_fn(inputs.cond, inputs.uncond, self.cfg.guidance_scale,
                                  control, coef)
        z = self.sd.sample_from(eps, inputs.x_T, self.sampler, remat=False)
        return self.sd.decode_latents(z)

    def run_one(self, prompt: str, idx: int, seed: int = 1) -> Optional[np.ndarray]:
        with deterministic():
            inputs = self.build_inputs(prompt, seed)
            if inputs is None:
                print(f"[skip] no layout for prompt {idx}: {prompt!r}")
                return None
            if self.mode == "vanilla":
                images = self.sample(inputs)
            elif self.mode == "spatial":
                coef = spatial_coef_schedule(inputs.active, self.cfg.init_coef,
                                             self.cfg.num_steps)
                control = SpatialControl(inputs.local_contexts, inputs.centers, coef[..., 0],
                                         inputs.active)
                images = self.sample(inputs, control, coef)
            else:
                if self.clip_loss is None:
                    raise ValueError("spacetime mode requires a DCLIPLoss (clip_loss=None)")

                def on_epoch(e, imgs):
                    if self.save_epoch_images and e < self.cfg.epochs - 1:
                        save_image(imgs[0].float().cpu().numpy(), os.path.join(
                            self.outdir, result_name(e, seed, idx)))

                images, _, _ = optimize_prompt(self.sd, self.clip_loss, inputs, self.cfg,
                                               sampler=self.sampler, on_epoch=on_epoch)
        img = images[0].float().cpu().numpy()
        save_image(img, os.path.join(self.outdir, result_name(self.cfg.epochs - 1, seed, idx)))
        return img

    def run(self, prompts: List[str], start: int = 0, end: Optional[int] = None,
            seed: int = 1) -> int:
        """Sequential shard runner (`txt2img-gpt.py:303-341`); returns the
        number of images produced."""
        done = 0
        for idx in range(start, min(end or len(prompts), len(prompts))):
            if self.run_one(prompts[idx], idx, seed) is not None:
                done += 1
        return done
