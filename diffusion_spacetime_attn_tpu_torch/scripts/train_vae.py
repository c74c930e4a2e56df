"""First-stage autoencoder training CLI; port of the JAX package's
`scripts/train_vae.py` (the reference trains its AutoencoderKL through
`main.py` with `configs/autoencoder/autoencoder_kl_*.yaml` and taming's
LPIPSWithDiscriminator), with its flags and defaults and `--cpu`:

    python -m diffusion_spacetime_attn_tpu_torch.scripts.train_vae --synthetic --steps 2 --disc-start 0
    python -m diffusion_spacetime_attn_tpu_torch.scripts.train_vae --tiny --cpu --steps 3

`training/vae_trainer.py` does the step: LPIPS + KL + PatchGAN with the
adaptive adversarial weight, both optimizer updates.  Data: `--synthetic`
uniform images in [-1, 1] (numpy's RandomState(step % 37), as in JAX), also
what runs without `--data-dir`; `--paths-txt` (an LSUN-style split of paths
under `--data-dir`, `training/image_data.lsun_split`) or `--data-dir` alone
(its PNG / JPEG / WebP files by name) through `ImagePathsDataset`: center
crop, PIL-exact bicubic resize to the image size, flips at `--flip-p`, the
same shuffles as JAX (`batches(B, seed=0)`); `host_s` per step is the
loader's time.
`--lpips-ckpt` reads a taming LPIPS checkpoint (`utils/convert.convert_lpips`);
without it LPIPS is seeded random (smoke mode), and `--tiny` turns the
perceptual term off, as in JAX.  Checkpoints: `torch.save` of the state's
tensors at `<ckpt-dir>/step_<n>.pt` every `--ckpt-every` steps (JAX writes
orbax; the port reads JAX's orbax steps in the LDM and layout trainers).  Under `torchrun --nproc-per-node N` (`--backend nccl`, or gloo
with `--cpu` or ranks sharing a card) the step is data-parallel over the N
ranks as JAX's is over its devices: `--batch-size` is per device, every
rank makes the same global batch and trains on its rows, rank 0 alone
writes the log and the checkpoints; `--fsdp` shards the state over them
and on one device warns and is ignored.  Runs on the card and raises
without one, unless `--cpu` is given.
"""
from __future__ import annotations

import argparse
import logging
import os
import time

import numpy as np
import torch

from ..config import VAEConfig
from ..models.vae import AutoencoderKL
from ..parallel.mesh import add_mesh_args, barrier, mesh_from_env, rows
from ..parallel.sharding import full_tree
from ..training.image_data import ImagePathsDataset, lsun_split
from ..training.perceptual import LPIPS
from ..training.vae_trainer import VAETrainConfig, VAETrainer, VAETrainState
from ..utils import convert, prng
from ..utils.profiling import JsonLogger
from ..utils.weights import flatten_tree, load_flat
from .layout_infer import pick_device

logger = logging.getLogger("train_vae")


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--data-dir", default=None)
    ap.add_argument("--paths-txt", default=None,
                    help="LSUN-style split file of image paths under --data-dir")
    ap.add_argument("--flip-p", type=float, default=0.5)
    ap.add_argument("--synthetic", action="store_true")
    ap.add_argument("--image-size", type=int, default=256)
    ap.add_argument("--steps", type=int, default=1000)
    ap.add_argument("--batch-size", type=int, default=4)
    ap.add_argument("--base-lr", type=float, default=4.5e-6)
    ap.add_argument("--fsdp", action="store_true",
                    help="shard the state over the ranks (one device: ignored)")
    ap.add_argument("--kl-weight", type=float, default=1e-6)
    ap.add_argument("--disc-start", type=int, default=50001)
    ap.add_argument("--disc-weight", type=float, default=0.5)
    ap.add_argument("--lpips-ckpt", default=None,
                    help="taming LPIPS weights (random without: smoke)")
    ap.add_argument("--ckpt-dir", default="saved/vae")
    ap.add_argument("--ckpt-every", type=int, default=500)
    ap.add_argument("--log-every", type=int, default=25)
    ap.add_argument("--tiny", action="store_true", help="tiny model (CPU smoke)")
    ap.add_argument("--cpu", action="store_true", help="run on the host CPU")
    add_mesh_args(ap)
    return ap.parse_args(argv)


def load_lpips(path: str, device) -> LPIPS:
    lpips = LPIPS().to(device)
    return load_flat(lpips, flatten_tree(convert.convert_lpips(
        convert.load_torch_checkpoint(path))))


def save_state(state: VAETrainState, path: str, mesh=None) -> None:
    """The state's tensors (autoencoder, logvar, discriminator with its
    running statistics, both optimizers, step) with `torch.save`; FSDP
    shards gathered (every rank calls it), rank 0 writes."""
    d = full_tree({"ae": state.ae_params.state_dict(), "logvar": state.logvar.detach(),
                   "disc": state.disc_params.state_dict(), "opt_ae": state.opt_ae.state_dict(),
                   "opt_disc": state.opt_disc.state_dict(), "step": state.step})
    if mesh is None or mesh.writer:
        torch.save(d, path)
    barrier(mesh)


def image_batches(args, B: int, hw: int, device, mesh=None):
    """next_batch(i) -> [B, hw, hw, 3] in [-1, 1] on `device`: synthetic
    (RandomState(i % 37)) unless a data flag names images.  With `mesh`,
    this rank's rows of the global batch of B (only its files read)."""
    mine = slice(None) if mesh is None else rows(mesh, B)
    if args.synthetic or not (args.data_dir or args.paths_txt):
        def next_batch(i):
            r = np.random.RandomState(i % 37)
            x = (r.rand(B, hw, hw, 3) * 2 - 1).astype(np.float32)[mine]
            return torch.from_numpy(np.ascontiguousarray(x)).to(device)
        return next_batch
    if args.paths_txt:
        ds = lsun_split(args.paths_txt, args.data_dir or ".", size=hw, flip_p=args.flip_p)
    else:
        files = sorted(os.path.join(args.data_dir, f) for f in os.listdir(args.data_dir)
                       if f.lower().endswith((".png", ".jpg", ".jpeg", ".webp")))
        ds = ImagePathsDataset(paths=files, size=hw, flip_p=args.flip_p)
    it = ds.batches(B, seed=0, rows=mine)

    def next_batch(i):
        return torch.from_numpy(next(it)[0]).to(device)
    return next_batch


def main(argv=None) -> dict:
    """Train; returns {"metrics": [per logged step], "step_s": [s per step],
    "host_s": [the loader's s per step]}."""
    args = parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(name)s %(message)s")
    mesh = mesh_from_env(args.backend, args.cpu)
    if args.fsdp and mesh is None:
        logger.warning("--fsdp ignored: single device — training runs fully replicated")
    device = mesh.device if mesh is not None else pick_device(args.cpu)
    ndev = 1 if mesh is None else mesh.data
    writer = mesh is None or mesh.writer
    if not writer:                            # rank 0 alone logs
        logger.setLevel(logging.WARNING)
    if args.tiny:
        vcfg, hw = VAEConfig(ch=32, ch_mult=(1, 2), num_res_blocks=1, z_channels=2,
                             embed_dim=2), 32
    else:
        vcfg, hw = VAEConfig(), args.image_size
    cfg = VAETrainConfig(base_lr=args.base_lr, kl_weight=args.kl_weight,
                         disc_start=args.disc_start, disc_weight=args.disc_weight,
                         disc_ndf=8 if args.tiny else 64, disc_layers=2 if args.tiny else 3,
                         perceptual_weight=0.0 if (args.tiny and not args.lpips_ckpt) else 1.0)
    with torch.device(device):
        vae = AutoencoderKL(vcfg)
    trainer = VAETrainer(vae, cfg, mesh=mesh, fsdp=args.fsdp)
    lpips = load_lpips(args.lpips_ckpt, device) if args.lpips_ckpt else None
    state = trainer.init(seed=0, lpips=lpips)

    # per-device batch semantics, as in JAX; each rank its rows of the global batch
    next_batch = image_batches(args, args.batch_size * ndev, hw, device, mesh)

    if writer:
        os.makedirs(args.ckpt_dir, exist_ok=True)
    jlog = JsonLogger(os.path.join(args.ckpt_dir, "metrics.jsonl")) if writer else None
    logged, step_s, host_s = [], [], []
    for i in range(args.steps):
        t0 = time.perf_counter()
        x = next_batch(i)
        host_s.append(time.perf_counter() - t0)
        state, m = trainer.train_step(state, x, prng.PRNGKey(i))
        vals = {k: float(v) for k, v in m.items()}      # waits for the step
        step_s.append(time.perf_counter() - t0)
        if i % args.log_every == 0:
            logger.info("step %d %s", i, vals)
            if jlog is not None:
                jlog.log("train_vae", step=i, **vals)
            logged.append({"step": i, **vals})
        if args.ckpt_every and (i + 1) % args.ckpt_every == 0:
            save_state(state, os.path.join(args.ckpt_dir, f"step_{i + 1}.pt"), mesh)
            logger.info("checkpointed step %d", i + 1)
    if jlog is not None:
        jlog.close()
    return {"metrics": logged, "step_s": step_s, "host_s": host_s}


if __name__ == "__main__":
    main()
