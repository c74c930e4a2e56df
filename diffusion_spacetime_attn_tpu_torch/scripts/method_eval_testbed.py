"""Closed-loop method evaluation on the trained testbed: does the spacetime
optimization beat vanilla sampling?  Port of the JAX package's
`scripts/method_eval_testbed.py`.

    python -m diffusion_spacetime_attn_tpu_torch.scripts.method_eval_testbed
    python -m diffusion_spacetime_attn_tpu_torch.scripts.method_eval_testbed \\
        --cpu --prompts 2 --seeds 1 --batch 2 --num-steps 3 --epochs 1 --out /tmp/e.json

Each eval prompt (`testbed/scenes.py`, prompt seed 777) is generated twice
from the same initial noise:

  vanilla  the sampler conditioned on the caption only;
  method   the paper's temporal optimization (`pipeline/spacetime.py`:
           ground-truth layout centers, masked local attention, 3 Adam
           epochs on the blend weights through the whole chain);

and both are scored by the weights-independent oracle detector
(`testbed/oracle.py`) through the protocol math (`eval/metrics.py`), with
CLIP score = 1 − the trained CLIP's global loss.  The noise of batch bi and
seed s is JAX's `normal(fold_in(fold_in(PRNGKey(2025), s), bi), (B, 16, 16, 4))`,
computed by `utils/prng.py`, so both packages start every prompt from the
same x_T.  Batches have `--batch` prompts; the last is padded with its last
prompt and only real prompts are scored.  Each finished (batch, seed) cell
is appended to `<out>.partial.jsonl`, and a run started again with the same
`--out` skips the cells found there.

The run is float32 with every kernel flag off, as the JAX testbed run is;
TF32 is off for matrix products and cuDNN convolutions, and cuDNN runs its
deterministic algorithms.  It runs on the card and raises without one,
unless `--cpu` is given.  `--sampler` takes the names `sample_from` takes
(plms, ddim, dpm).
"""
from __future__ import annotations

import argparse
import dataclasses as dc
import json
import os
import subprocess
import time
from typing import List

import numpy as np
import torch

from ..eval import metrics
from ..pipeline.spacetime import SpaceTimeInputs, optimize_prompt
from ..testbed import oracle, scenes
from ..testbed.bundle import TestbedBundle, load_bundle
from ..utils import prng
from ..utils.cudnn import deterministic
from ..utils.png import write_png

NOISE_SEED = 2025
DEFAULT_OUT = os.path.join("diffusion_spacetime_attn_tpu_torch", "results",
                           "method_eval_h100.json")


def initial_noise(seed: int, bi: int, batch: int, latent: int, device) -> torch.Tensor:
    """x_T of batch `bi` under `seed`: [batch, latent, latent, 4] float32."""
    key = prng.fold_in(prng.fold_in(prng.PRNGKey(NOISE_SEED), seed), bi)
    return torch.from_numpy(prng.normal(key, (batch, latent, latent, 4))).to(device)


def embed_batch(bundle: TestbedBundle, batch_prompts: List[scenes.EvalPrompt],
                x_T: torch.Tensor) -> SpaceTimeInputs:
    """The optimization's inputs for one batch: caption and empty-prompt
    embeddings, "a photo of a <object>" local contexts at the prompt's
    ground-truth centers, and the CLIP tokens of caption and objects."""
    B, dev = len(batch_prompts), bundle.sd.device
    caps = [p.caption for p in batch_prompts]
    obj_caps = [c for p in batch_prompts
                for c in (f"a photo of a {p.cat_a}", f"a photo of a {p.cat_b}")]
    with torch.no_grad():
        emb = bundle.encode_captions(caps + obj_caps + [""])
    cond, locals_, uncond = emb[:B], emb[B:-1], emb[-1:]

    def tokens(texts):
        return torch.as_tensor(np.stack([scenes.tokenize(c) for c in texts]),
                               dtype=torch.int64, device=dev)

    return SpaceTimeInputs(
        cond=cond, uncond=uncond.expand_as(cond).contiguous(),
        local_contexts=locals_.reshape(B, 2, *emb.shape[1:]),
        centers=torch.as_tensor(np.asarray([p.centers for p in batch_prompts], np.float32),
                                device=dev),
        active=torch.ones((B, 2), device=dev),
        caption_tokens=tokens(caps),
        object_tokens=tokens(obj_caps).reshape(B, 2, -1),
        x_T=x_T)


def vanilla_images(bundle: TestbedBundle, inputs: SpaceTimeInputs, guidance_scale: float,
                   sampler: str) -> torch.Tensor:
    sd = bundle.sd
    with torch.no_grad():
        eps = sd.make_eps_fn(inputs.cond, inputs.uncond, guidance_scale)
        return sd.decode_latents(sd.sample_from(eps, inputs.x_T, sampler=sampler, remat=False))


def score(images: torch.Tensor, batch_prompts: List[scenes.EvalPrompt]) -> List[dict]:
    """Oracle recall and relation accuracy per image."""
    rows = []
    for im, p in zip(images.detach().cpu().numpy(), batch_prompts):
        d = oracle.detect(im)
        _, _, rec = metrics.object_recall([d], [[p.cat_a, p.cat_b]])
        _, _, rel = metrics.relation_accuracy([d], [[(p.cat_a, p.cat_b, p.rel)]])
        rows.append({"recall": rec, "relation": rel, "held_out": p.held_out})
    return rows


def clip_score(bundle: TestbedBundle, images: torch.Tensor, caption_tokens) -> np.ndarray:
    with torch.no_grad():
        return (1.0 - bundle.clip_loss.global_loss(images, caption_tokens)).cpu().numpy()


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def run_cell(bundle: TestbedBundle, cfg, batch_prompts: List[scenes.EvalPrompt], n_real: int,
             seed: int, bi: int, sampler: str = "plms") -> dict:
    """Both arms of one (batch, seed) cell on one padded batch: {"rows" of
    the n_real real prompts, "vanilla" and "method" images, the method's
    "coef" and "losses", "vanilla_s", "method_s"}."""
    sd = bundle.sd
    x_T = initial_noise(seed, bi, len(batch_prompts), cfg.latent_size, sd.device)
    inputs = embed_batch(bundle, batch_prompts, x_T)
    with deterministic():
        _sync(sd.device)
        t0 = time.perf_counter()
        v_imgs = vanilla_images(bundle, inputs, cfg.guidance_scale, sampler)
        _sync(sd.device)
        t_van = time.perf_counter() - t0
        m_imgs, coef, losses = optimize_prompt(sd, bundle.clip_loss, inputs, cfg,
                                               sampler=sampler)
        _sync(sd.device)
        t_met = time.perf_counter() - t0 - t_van
    v_rows, m_rows = score(v_imgs, batch_prompts), score(m_imgs, batch_prompts)
    v_clip = clip_score(bundle, v_imgs, inputs.caption_tokens)
    m_clip = clip_score(bundle, m_imgs, inputs.caption_tokens)
    rows = [{"seed": seed, "prompt": batch_prompts[i].caption,
             "held_out": batch_prompts[i].held_out,
             "vanilla": {**v_rows[i], "clip": float(v_clip[i])},
             "method": {**m_rows[i], "clip": float(m_clip[i])}} for i in range(n_real)]
    return {"rows": rows, "vanilla": v_imgs, "method": m_imgs, "coef": coef, "losses": losses,
            "vanilla_s": t_van, "method_s": t_met}


def split_stats(rows: List[dict], seeds: int) -> dict:
    """Arm means and the method − vanilla delta: its mean over seeds, spread
    and per-seed values (rounded to 4 places, as the JAX artifact)."""
    def agg(rs, arm, key):
        return float(np.mean([r[arm][key] for r in rs])) if rs else 0.0

    out = {arm: {k: round(agg(rows, arm, k), 4) for k in ("recall", "relation", "clip")}
           for arm in ("vanilla", "method")}
    deltas = {}
    for k in ("recall", "relation", "clip"):
        per_seed = [agg(sr, "method", k) - agg(sr, "vanilla", k)
                    for sr in ([r for r in rows if r["seed"] == s] for s in range(seeds)) if sr]
        deltas[k] = {"mean": round(float(np.mean(per_seed)), 4),
                     "std_over_seeds": round(float(np.std(per_seed)), 4),
                     "per_seed": [round(d, 4) for d in per_seed]}
    out["delta_method_minus_vanilla"] = deltas
    out["n"] = len(rows)
    return out


def device_line(device) -> str:
    """The card's `nvidia-smi` name and power limit, or "cpu"."""
    if torch.device(device).type != "cuda":
        return "cpu"
    run = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return run.stdout.strip().splitlines()[torch.device(device).index or 0]


def save_grid(out_dir: str, v_imgs, m_imgs, batch_prompts) -> None:
    """Side-by-side vanilla | method PNGs of one batch."""
    os.makedirs(out_dir, exist_ok=True)
    v, m = v_imgs.detach().cpu().numpy(), m_imgs.detach().cpu().numpy()
    for i, p in enumerate(batch_prompts):
        pair = np.concatenate([v[i], np.ones_like(v[i][:, :2]), m[i]], axis=1)
        write_png(os.path.join(out_dir, f"{i:02d}_{p.caption.replace(' ', '_')}.png"),
                  np.clip(np.round(pair * 255), 0, 255).astype(np.uint8))


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ckpt-dir", default="saved/testbed")
    ap.add_argument("--prompts", type=int, default=100)
    ap.add_argument("--prompt-seed", type=int, default=777)
    ap.add_argument("--seeds", type=int, default=3)
    ap.add_argument("--batch", type=int, default=25,
                    help="prompts per batch; the last batch is padded to it")
    ap.add_argument("--num-steps", type=int, default=50)
    ap.add_argument("--epochs", type=int, default=3)
    ap.add_argument("--guidance-scale", type=float, default=None,
                    help="default: the calibrated value in meta.json")
    ap.add_argument("--sampler", default="plms", choices=["plms", "ddim", "dpm"])
    ap.add_argument("--out", default=DEFAULT_OUT)
    ap.add_argument("--save-images", default=None,
                    help="directory for side-by-side PNGs of the first batch, seed 0")
    ap.add_argument("--cpu", action="store_true")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    args = parse_args(argv)
    if args.cpu:
        device = torch.device("cpu")
    elif torch.cuda.is_available():
        device = torch.device("cuda")
    else:
        raise RuntimeError("no CUDA device: pass --cpu to run on the CPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.perf_counter()
    bundle = load_bundle(args.ckpt_dir, num_steps=args.num_steps,
                         guidance_scale=args.guidance_scale, device=device)
    cfg = dc.replace(bundle.sd.cfg.spacetime, epochs=args.epochs)
    setup_s = time.perf_counter() - t0
    print(json.dumps({"bundle": args.ckpt_dir, "device": str(device), "setup_s": setup_s,
                      "guidance_scale": cfg.guidance_scale, "num_steps": cfg.num_steps,
                      "sampler": args.sampler, "epochs": cfg.epochs}), flush=True)

    prompts = scenes.make_eval_prompts(args.prompts, seed=args.prompt_seed)
    B = args.batch
    n_batches = (len(prompts) + B - 1) // B
    partial_path = args.out + ".partial.jsonl"
    per_prompt, done = [], set()
    if os.path.exists(partial_path):
        with open(partial_path) as f:
            for line in f:
                cell = json.loads(line)
                done.add((cell["bi"], cell["seed"]))
                per_prompt.extend(cell["rows"])
        print(json.dumps({"resuming_cells": sorted(done)}), flush=True)
    t_van = t_met = 0.0
    for bi in range(n_batches):
        bp = prompts[bi * B:(bi + 1) * B]
        padded = bp + [bp[-1]] * (B - len(bp))
        for seed in range(args.seeds):
            if (bi, seed) in done:
                continue
            cell = run_cell(bundle, cfg, padded, len(bp), seed, bi, args.sampler)
            rows = cell["rows"]
            t_van += cell["vanilla_s"]
            t_met += cell["method_s"]
            per_prompt.extend(rows)
            with open(partial_path, "a") as f:
                f.write(json.dumps({"bi": bi, "seed": seed, "rows": rows}) + "\n")
            if args.save_images and bi == 0 and seed == 0:
                save_grid(args.save_images, cell["vanilla"], cell["method"], bp)
            means = {f"{arm}_{k}": float(np.mean([r[arm][k] for r in rows]))
                     for arm in ("vanilla", "method") for k in ("recall", "relation", "clip")}
            print(json.dumps({"cell": [bi, seed], "batches": n_batches, **means,
                              "vanilla_s": cell["vanilla_s"], "method_s": cell["method_s"]}),
                  flush=True)

    seen = [r for r in per_prompt if not r["held_out"]]
    held = [r for r in per_prompt if r["held_out"]]
    artifact = {
        "protocol": {
            "prompts": args.prompts, "seeds": args.seeds,
            "sampler": args.sampler, "num_steps": cfg.num_steps,
            "epochs": cfg.epochs, "guidance_scale": cfg.guidance_scale,
            "paired_noise": True,
            "detector": "oracle (weights-independent color/shape threshold)",
            "detector_self_check": oracle.oracle_self_check(),
            "training_captions": "relation word uniform-random "
                                 "(uninformative); see testbed/scenes.py",
        },
        "weights": {k: bundle.meta.get(k) for k in
                    ("scale_factor", "vae_recon_l1", "clip_retrieval_acc",
                     "vae_steps", "clip_steps", "ldm_steps", "scenes",
                     "guidance_calibration")},
        "overall": split_stats(per_prompt, args.seeds),
        "seen_pairs": split_stats(seen, args.seeds),
        "heldout_pairs": split_stats(held, args.seeds),
        "wall_clock_s": {"vanilla": t_van, "method": t_met},
        "device": device_line(device),
    }
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(artifact, f, indent=2)
    if os.path.exists(partial_path):
        os.remove(partial_path)
    o = artifact["overall"]
    print(json.dumps({"done": args.out, "vanilla": o["vanilla"], "method": o["method"],
                      "delta": {k: v["mean"] for k, v in o["delta_method_minus_vanilla"].items()},
                      "wall_clock_s": artifact["wall_clock_s"]}), flush=True)
    return artifact


if __name__ == "__main__":
    main()
