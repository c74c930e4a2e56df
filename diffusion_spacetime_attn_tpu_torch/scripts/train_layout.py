"""Layout-predictor training CLI; port of the JAX package's
`scripts/train_layout.py` (reference `layout_predictor/LayoutTransformer/
train.py` + `trainer/Pretrain.py`), with its flags and `--cpu`:

    python -m diffusion_spacetime_attn_tpu_torch.scripts.train_layout --gpt3-pkl gpt-3.pkl
    python -m diffusion_spacetime_attn_tpu_torch.scripts.train_layout --synthetic 512 --epochs 2 \\
        --ckpt-dir /tmp/layout
    python -m diffusion_spacetime_attn_tpu_torch.scripts.train_layout --cpu --synthetic 16 \\
        --layers 1 --heads 2 --batch-size 8 --epochs 1 --ckpt-dir /tmp/layout

Data: the reference's `gpt-3.pkl` (`--gpt3-pkl`; not shipped, so there is
no default path), with the sampled COCO anchors of `--abs-stats` (a
`sta_dict.json`; none by default), `--transitive-closure`, the COCO
half (`--coco-instances` / `--coco-captions`) and `--augment-templates` as
in JAX; VG-MSDN scene graphs (`--vg-instances`); or `--synthetic N`
relation sentences (N = 512 when no count is given, JAX's corpus).  One
of `--gpt3-pkl`, `--vg-instances` and `--synthetic` is required.  The
model is `LayoutConfig()` (RoBERTa-base) at `--layers` / `--heads`, with
flax-like seeded weights (`models/layout/model.init_layout_`).

The run dir (`--ckpt-dir`) gets JAX's layout: `config.json`,
`train_log.jsonl`, `best.json` naming `params_path` (the best validation
params, flushed every `--save-best-every` epochs and at the end) and
resume checkpoints `step_<n>.pt` every `--ckpt-every` epochs and at the
end; the params are `torch.save` files (JAX writes orbax) that
`utils/loader.load_layout_predictor` reads, as it reads JAX's orbax
ones.  `--resume-step` reads a checkpoint: the port's `step_<n>.pt`, or
the JAX script's orbax `step_<n>/` where no `.pt` is there.  Under `torchrun --nproc-per-node N` (`--backend nccl`, or
gloo with `--cpu` or ranks sharing a card) with `--fsdp` the step is
sharded over the N ranks as JAX's is over its devices (`--batch-size` is
the global batch; every rank makes the same batches and trains on its
rows; the predictor and the Adam moments are sharded; rank 0 alone writes
the run dir); a run of N ranks without `--fsdp` is data-parallel with
replicated state, and `--fsdp` on one device is ignored, as in JAX.  Runs
on the card and raises without one, unless `--cpu` is given.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import logging
import os
import time

import numpy as np
import torch

from ..config import LayoutConfig, LayoutTrainConfig
from ..models.layout.model import create_layout_predictor
from ..parallel.mesh import add_mesh_args, mesh_from_env, shard_batch
from ..parallel.sharding import full_tree
from ..training import datasets
from ..training.layout_trainer import LayoutTrainer
from ..utils.profiling import JsonLogger
from ..utils.tokenizer import make_roberta_tokenizer
from .layout_infer import pick_device

logger = logging.getLogger("train_layout")
BEST_PARAMS = "best_params.pt"


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--gpt3-pkl", default=None, help="the reference's gpt-3.pkl")
    ap.add_argument("--epochs", type=int, default=100)
    ap.add_argument("--batch-size", type=int, default=64)
    ap.add_argument("--ckpt-dir", default="saved/layout")
    ap.add_argument("--resume-step", type=int, default=None)
    ap.add_argument("--vocab", default=None)
    ap.add_argument("--merges", default=None)
    ap.add_argument("--val-split", type=float, default=0.1)
    ap.add_argument("--layers", type=int, default=None, help="encoder depth (default LayoutConfig)")
    ap.add_argument("--heads", type=int, default=None)
    ap.add_argument("--encoder-lr", type=float, default=None,
                    help="encoder max LR (the reference's 1e-6 assumes a pretrained RoBERTa)")
    ap.add_argument("--head-lr", type=float, default=None)
    ap.add_argument("--warmup", type=int, default=None)
    ap.add_argument("--hold", type=int, default=None)
    ap.add_argument("--decay", type=int, default=None)
    ap.add_argument("--abs-stats", default=None,
                    help="sta_dict.json for sampled relation-consistent anchors (none by default)")
    ap.add_argument("--fsdp", action="store_true", help="shard params and optimizer state")
    ap.add_argument("--augment-templates", type=int, default=0,
                    help="N template paraphrases per supervised relation (train split)")
    ap.add_argument("--margin", type=float, default=None, help="hinge margin (default 0.2)")
    ap.add_argument("--gmm-weight", type=float, default=None,
                    help="GMM-NLL loss weight (default 0.1)")
    ap.add_argument("--transitive-closure", action="store_true",
                    help="append transitively inferred relation triples")
    ap.add_argument("--grad-clip", type=float, default=None, help="global grad-norm clip")
    ap.add_argument("--select-metric", choices=["val_loss", "rel_satisfied"], default="val_loss",
                    help="best-checkpoint criterion")
    ap.add_argument("--log-every", type=int, default=100)
    ap.add_argument("--synthetic", type=int, nargs="?", const=512, default=0, metavar="N",
                    help="N synthetic relation sentences (512 without N)")
    ap.add_argument("--cpu", action="store_true", help="run on the host CPU")
    add_mesh_args(ap)
    ap.add_argument("--save-best-every", type=int, default=25,
                    help="epochs between best-params flushes (also flushed at the end)")
    ap.add_argument("--ckpt-every", type=int, default=50,
                    help="epochs between resume checkpoints (params + optimizer)")
    ap.add_argument("--limit", type=int, default=None, help="cap the example count")
    ap.add_argument("--coco-instances", default=None,
                    help="COCO instances JSON (adds the absolute-target half)")
    ap.add_argument("--vg-instances", default=None, help="VG-MSDN instances json")
    ap.add_argument("--coco-captions", default=None, help="COCO captions JSON")
    return ap.parse_args(argv)


def load_examples(args, rng: np.random.RandomState):
    """(examples, sta_dict path or None) as the JAX script builds them."""
    sta = None
    if args.synthetic:
        return datasets.synthetic_examples(args.synthetic, rng), sta
    if args.vg_instances:
        examples = datasets.load_vg_msdn_examples(args.vg_instances)
        print(f"loaded {len(examples)} VG-MSDN scene-graph examples")
        return examples, sta
    if args.gpt3_pkl is None:
        raise SystemExit("train_layout: give --gpt3-pkl, --vg-instances or --synthetic N")
    examples = datasets.load_gpt3_examples(args.gpt3_pkl)
    if args.transitive_closure:
        before = sum(len(e.relations) for e in examples)
        examples = datasets.close_relations_transitively(examples)
        added = sum(len(e.relations) for e in examples) - before
        logger.info(f"transitive closure: +{added} inferred relation triples")
    if args.abs_stats is not None:
        sta = args.abs_stats
        examples = datasets.attach_sampled_abs_targets(examples, sta, np.random.RandomState(1))
        print(f"attached sampled absolute anchors from {sta}")
    if args.coco_instances and args.coco_captions:
        coco = datasets.load_coco_caption_examples(args.coco_instances, args.coco_captions,
                                                   max_images=len(examples))
        print(f"added {len(coco)} COCO absolute-target examples")
        examples = examples + coco
    return examples, sta


def configs(args):
    cfg = LayoutConfig()
    if args.layers is not None:
        cfg = dataclasses.replace(cfg, layers=args.layers)
    if args.heads is not None:
        cfg = dataclasses.replace(cfg, heads=args.heads)
    train_cfg = LayoutTrainConfig(batch_size=args.batch_size, epochs=args.epochs)
    overrides = {name: v for name, v in (
        ("encoder_max_lr", args.encoder_lr), ("head_max_lr", args.head_lr),
        ("warmup_steps", args.warmup), ("hold_steps", args.hold), ("decay_steps", args.decay),
        ("hinge_margin", args.margin), ("gmm_loss_weight", args.gmm_weight),
        ("grad_clip_norm", args.grad_clip)) if v is not None}
    return cfg, dataclasses.replace(train_cfg, **overrides)


def main(argv=None) -> dict:
    """Train; returns {"run_dir", "steps", "epochs", "best" (best.json or
    None), "best_params" (the state dict best.json names, as it was in
    memory, or None), "train_losses", "seconds"}."""
    args = parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(name)s %(message)s")
    mesh = mesh_from_env(args.backend, args.cpu)
    if args.fsdp and mesh is None:
        logger.warning("--fsdp ignored: single device")
    device = mesh.device if mesh is not None else pick_device(args.cpu)
    writer = mesh is None or mesh.writer
    if not writer:                            # rank 0 alone logs
        logger.setLevel(logging.WARNING)
    t_start = time.perf_counter()
    rng = np.random.RandomState(0)
    examples, sta = load_examples(args, rng)
    if args.limit:
        examples = examples[:args.limit]
    n_val = int(len(examples) * args.val_split)
    val, train = examples[:n_val], examples[n_val:]
    if args.augment_templates:
        aug = datasets.augment_with_templates(train, np.random.RandomState(2),
                                              variants=args.augment_templates)
        if sta:   # hinge-only rows get the same relation-repaired anchors
            aug = datasets.attach_sampled_abs_targets(aug, sta, np.random.RandomState(3))
        train = train + aug
        logger.info(f"template augmentation: +{len(aug)} examples "
                    f"({args.augment_templates} variants/relation)")
    logger.info(f"{len(train)} train / {len(val)} val examples")

    cfg, train_cfg = configs(args)
    params = create_layout_predictor(cfg, seed=0, device=device)
    trainer = LayoutTrainer.create(cfg, train_cfg, params, mesh=mesh, fsdp=args.fsdp)
    opt_state = trainer.init_state(params)
    tok = make_roberta_tokenizer(args.vocab, args.merges)
    ckpt_dir = os.path.abspath(args.ckpt_dir)
    if args.resume_step is not None:
        params, opt_state = trainer.restore_checkpoint(ckpt_dir, args.resume_step, params,
                                                       opt_state)
        logger.info(f"resumed from step {args.resume_step}")

    jlog = None
    if writer:
        os.makedirs(ckpt_dir, exist_ok=True)
        jlog = JsonLogger(os.path.join(ckpt_dir, "train_log.jsonl"))
        with open(os.path.join(ckpt_dir, "config.json"), "w") as f:
            json.dump({"layout": dataclasses.asdict(cfg), "train": dataclasses.asdict(train_cfg)},
                      f, indent=1)

    def save_best_params(state, step, epoch, vmean, vmetrics):
        """The params-only file and the best.json pointer that
        `utils/loader.load_layout_predictor` reads."""
        if not writer:
            return
        torch.save(state, os.path.join(ckpt_dir, BEST_PARAMS))
        with open(os.path.join(ckpt_dir, "best.json"), "w") as f:
            json.dump({"step": step, "epoch": epoch, "val_loss": vmean,
                       "params_path": BEST_PARAMS, "select_metric": args.select_metric,
                       "val_metrics": vmetrics}, f, indent=1)

    def selection_score(vmean, vmetrics):
        """Lower is better: val_loss (`Pretrain.py:101-114`), or
        rel_satisfied with val_loss as the tiebreak."""
        if args.select_metric == "rel_satisfied":
            return (-vmetrics.get("rel_satisfied", 0.0), vmean)
        return (vmean,)

    step = args.resume_step or 0
    best_val = (float("inf"),)
    best_snapshot, best_dirty = None, False   # (params on the device, step, epoch, ...)
    losses = []

    def flush_best():
        nonlocal best_dirty
        if best_snapshot is not None and best_dirty:
            save_best_params(*best_snapshot)
            best_dirty = False

    try:
        for epoch in range(args.epochs):
            for batch in datasets.batches(train, tok, args.batch_size, rng, max_len=cfg.max_len):
                if mesh is not None:          # this rank's rows of the global batch
                    batch = shard_batch(mesh, batch)
                params, opt_state, loss, metrics = trainer.train_step(params, opt_state, batch)
                losses.append(float(loss))
                if step % args.log_every == 0:
                    logger.info(f"epoch {epoch} step {step}: loss {float(loss):.4f} " + " ".join(
                        f"{k}={float(v):.4f}" for k, v in metrics.items()))
                    if jlog is not None:
                        jlog.log("train", epoch=epoch, step=step, loss=float(loss))
                step += 1
            if val:
                vlosses, vmetrics = [], {}
                for batch in datasets.batches(val, tok, args.batch_size, rng,
                                              max_len=cfg.max_len, drop_last=False):
                    vl, vm = trainer.eval_step(params, batch)
                    vlosses.append(float(vl))
                    for k, v in vm.items():
                        vmetrics.setdefault(k, []).append(float(v))
                vmean = float(np.mean(vlosses))
                vmetrics = {k: float(np.mean(v)) for k, v in vmetrics.items()}
                logger.info(f"epoch {epoch}: val_loss {vmean:.4f} "
                            + " ".join(f"{k}={v:.4f}" for k, v in vmetrics.items()))
                if jlog is not None:
                    jlog.log("val", epoch=epoch, val_loss=vmean, **vmetrics)
                score = selection_score(vmean, vmetrics)
                if score < best_val:
                    best_val = score
                    snap = {k: v.detach().clone()
                            for k, v in full_tree(params.state_dict()).items()}
                    best_snapshot = (snap, step, epoch, vmean, vmetrics)
                    best_dirty = True
            if epoch and epoch % args.save_best_every == 0:
                flush_best()
            if epoch and epoch % args.ckpt_every == 0:
                trainer.save_checkpoint(ckpt_dir, step, params, opt_state, extra={"epoch": epoch})
        flush_best()
        trainer.save_checkpoint(ckpt_dir, step, params, opt_state,
                                extra={"epoch": args.epochs - 1, "final": True})
    finally:
        if jlog is not None:
            jlog.close()
    logger.info(f"training complete; best {args.select_metric} score {best_val} "
                f"(epoch {best_snapshot[2] if best_snapshot else -1})")
    best = None
    if os.path.isfile(os.path.join(ckpt_dir, "best.json")):
        with open(os.path.join(ckpt_dir, "best.json")) as f:
            best = json.load(f)
    return {"run_dir": ckpt_dir, "steps": step, "epochs": args.epochs, "best": best,
            "best_params": best_snapshot[0] if best_snapshot else None,
            "train_losses": losses, "seconds": time.perf_counter() - t_start}


if __name__ == "__main__":
    main()
