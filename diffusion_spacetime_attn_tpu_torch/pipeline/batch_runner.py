"""Batched dataset runner; port of the JAX package's `pipeline/batch_runner.py`
for one device (the JAX runner's data mesh has no counterpart on one card).

Prompts are packed into fixed-size batches; a prompt whose layout fails,
and every tail slot, is a filler row with active = 0 (its blend and losses
are exact no-ops) and is reported as skipped.  While the card runs batch i
the host prepares batch i+1's layout and tokens: CUDA launches return
before the kernels finish, the layout forward runs on a stream of its own
(`LayoutInference._forward`), and the copy of batch i's images to the host
is where the runner waits.  The overlap hides only that host stage; the
issue of batch i's kernels is host work of its own, and in spacetime mode
the loss reads its crop windows back once per chain
(`losses.DCLIPLoss.local_loss`), which waits for the chain queued before
it, so there only the last loss's tail is left to overlap.
"""
from __future__ import annotations

import dataclasses
import os
import time
from typing import List, Optional

import numpy as np

from ..ops.attention import SpatialControl
from ..utils.cudnn import deterministic
from .runners import PromptRunner, result_name, save_image, spatial_coef_schedule
from .spacetime import optimize_prompt


@dataclasses.dataclass
class BatchedRunner:
    """Wraps a PromptRunner with fixed-size batching."""

    runner: PromptRunner
    batch_size: int = 4

    def _dummy_host(self) -> dict:
        """Inactive filler slot (empty caption, no objects, active = 0)."""
        r = self.runner
        N = r.cfg.max_objects
        empty = np.asarray(r.clip_tokenize(""), np.int32)
        return dict(centers=np.full((N, 2), 0.5, np.float32), active=np.zeros(N, np.float32),
                    local_texts=[""] * N, obj_tokens=np.stack([empty] * N),
                    caption_tokens=empty, prompt="")

    def _prep_chunk(self, prompts, chunk):
        """Host stage of one chunk: layout and tokenization."""
        hosts, ok_idx = [], []
        for idx in chunk:
            h = self.runner.prepare_host(prompts[idx])
            if h is None:
                print(f"[skip] no layout for prompt {idx}")
                hosts.append(self._dummy_host())
                ok_idx.append(None)
            else:
                hosts.append(h)
                ok_idx.append(idx)
        while len(hosts) < self.batch_size:       # tail padding
            hosts.append(self._dummy_host())
            ok_idx.append(None)
        return hosts, ok_idx

    def _launch(self, batch):
        """Issue all device work of one batch; returns (images on the device,
        {epoch: images} of the earlier epochs with --save-epochs)."""
        r = self.runner
        cfg = r.cfg
        if r.mode == "spacetime":
            epoch_images = {}

            def on_epoch(e, imgs):
                if r.save_epoch_images and e < cfg.epochs - 1:
                    epoch_images[e] = imgs

            images, _, _ = optimize_prompt(r.sd, r.clip_loss, batch, cfg, sampler=r.sampler,
                                           on_epoch=on_epoch)
            return images, epoch_images
        control = coef = None
        if r.mode == "spatial":
            coef = spatial_coef_schedule(batch.active, cfg.init_coef, cfg.num_steps)
            coef = coef * batch.active[..., None]
            control = SpatialControl(batch.local_contexts, batch.centers, coef[..., 0],
                                     batch.active)
        return r.sample(batch, control, coef), {}

    def run(self, prompts: List[str], indices: Optional[List[int]] = None, seed: int = 1,
            log=None, on_chunk_done=None) -> int:
        """Sweep `indices` (default: all) in chunks of batch_size; returns the
        number of images written.  `on_chunk_done(chunk_indices)` is called
        after each chunk's images are on disk (run_dataset.py writes its
        resume manifest there)."""
        r = self.runner
        cfg = r.cfg
        indices = indices if indices is not None else list(range(len(prompts)))
        B = self.batch_size
        chunks = [indices[s: s + B] for s in range(0, len(indices), B)]
        if not chunks:
            return 0
        produced = 0
        hosts, ok_idx = self._prep_chunk(prompts, chunks[0])
        for ci, chunk in enumerate(chunks):
            t0 = time.perf_counter()
            with deterministic():
                batch = r.assemble_inputs(hosts, seed)
                images, epoch_images = self._launch(batch)
            if ci + 1 < len(chunks):                      # overlaps the card's work
                next_hosts, next_ok = self._prep_chunk(prompts, chunks[ci + 1])
            images = images.float().cpu().numpy()         # the wait
            dt = time.perf_counter() - t0
            for img, idx in zip(images, ok_idx):
                if idx is not None:
                    save_image(img, os.path.join(r.outdir, result_name(cfg.epochs - 1, seed, idx)))
                    produced += 1
            for e, imgs in epoch_images.items():          # --save-epochs only
                for img, idx in zip(imgs.float().cpu().numpy(), ok_idx):
                    if idx is not None:
                        save_image(img, os.path.join(r.outdir, result_name(e, seed, idx)))
            if log:
                log.log("batch_done", first=chunk[0], n=len(chunk), seconds=round(dt, 3))
            if on_chunk_done is not None:
                on_chunk_done(list(chunk))
            if ci + 1 < len(chunks):
                hosts, ok_idx = next_hosts, next_ok
        return produced
