"""One command for the generate -> detect -> score loop, recorded as one JSON
artifact; port of the JAX package's `scripts/run_eval_protocol.py`.

    python -m diffusion_spacetime_attn_tpu_torch.scripts.run_eval_protocol \\
        --data-root DIR --end 32 --sampler dpm --steps 20 --batch-size 8 --out EVAL.json
    python -m diffusion_spacetime_attn_tpu_torch.scripts.run_eval_protocol \\
        --data-root DIR --dataset mscoco --tiny --cpu --steps 3 --end 4 --out /tmp/e.json

Phases:
  1. the port's `run_dataset` over prompts [start, end), in a subprocess so
     its device memory is released before the detector's CLIP loads;
  2. the CLIP grid detector over the generated images (read with
     `utils/image_io.open_image`) -> detections JSON;
  3. the protocol math (object recall @0.4, relation accuracy @0.5) and the
     mean CLIP fidelity score;
  4. one artifact JSON with every number and the weights' provenance (the
     checkpoint's path, or "random"), under the JAX script's keys.

`--ckpt`, `--layout-ckpt`, `--clip-ckpt` and `--clip-vocab` go to the
sweep; the last two also to the detector and the CLIP score.

Runs on the card and raises without one, unless `--cpu` is given.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--dataset", choices=["gpt", "mscoco", "vsr"], default="gpt")
    ap.add_argument("--data-root", default="datasets")
    ap.add_argument("--mode", choices=["vanilla", "spatial", "spacetime"], default="spacetime")
    ap.add_argument("--start", type=int, default=0)
    ap.add_argument("--end", type=int, default=32)
    ap.add_argument("--sampler", choices=["plms", "ddim", "dpm"], default="dpm")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch-size", type=int, default=8)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--outdir", default="result_outputs/eval_protocol")
    ap.add_argument("--out", default="EVAL.json", help="artifact JSON path")
    ap.add_argument("--ckpt", default=None, help="SD weights (CompVis sd-v1-4)")
    ap.add_argument("--layout-ckpt", default=None)
    ap.add_argument("--clip-ckpt", default=None, help="OpenAI ViT-B/32 weights")
    ap.add_argument("--clip-vocab", default=None, help="CLIP BPE vocab")
    ap.add_argument("--params-dtype", default=None,
                    help="forwarded to run_dataset; default bfloat16 in spacetime mode, "
                         "float32 otherwise (the JAX script's defaults)")
    ap.add_argument("--skip-generate", action="store_true",
                    help="reuse an existing --outdir (resume after a failure in the "
                         "detect / score phases)")
    ap.add_argument("--top-per-category", type=int, default=1)
    ap.add_argument("--tiny", action="store_true", help="tiny model configs end to end")
    ap.add_argument("--save-epochs", action="store_true",
                    help="save per-epoch images during generation; the scorer still "
                         "reads the last epoch only")
    ap.add_argument("--epochs", type=int, default=None,
                    help="optimization epochs of the generation (default: 3, or 2 with "
                         "--tiny); the scorer filters on final{epochs-1}_s{seed}_")
    ap.add_argument("--cpu", action="store_true")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    args = parse_args(argv)
    from ..eval import protocol
    from ..utils.loader import find_default_layout_checkpoint
    from .layout_infer import pick_device
    from .run_dataset import tiny_configs

    device = pick_device(args.cpu)
    if args.params_dtype is None:
        args.params_dtype = "bfloat16" if args.mode == "spacetime" else "float32"
    if args.epochs is None:
        args.epochs = 2 if args.tiny else 3
    last_epoch = args.epochs - 1
    artifact = {
        "protocol": "generate->detect->score",
        "dataset": args.dataset,
        "mode": args.mode,
        "sampler": f"{args.sampler}{args.steps}",
        "batch_size": args.batch_size,
        "prompts": [args.start, args.end],
        "seed": args.seed,
    }

    # ---- phase 1: generation sweep (a subprocess: frees device memory) ----
    t0 = time.perf_counter()
    if not args.skip_generate:
        cmd = [sys.executable, "-m", "diffusion_spacetime_attn_tpu_torch.scripts.run_dataset",
               "--dataset", args.dataset, "--data-root", args.data_root,
               "--mode", args.mode, "--sampler", args.sampler,
               "--steps", str(args.steps), "--batch-size", str(args.batch_size),
               "--start", str(args.start), "--end", str(args.end),
               "--seed", str(args.seed), "--outdir", args.outdir,
               "--params-dtype", args.params_dtype]
        for flag, value in (("--ckpt", args.ckpt), ("--layout-ckpt", args.layout_ckpt),
                            ("--clip-ckpt", args.clip_ckpt), ("--clip-vocab", args.clip_vocab)):
            if value:
                cmd += [flag, value]
        cmd += [flag for flag, on in (("--tiny", args.tiny), ("--save-epochs", args.save_epochs),
                                      ("--cpu", args.cpu)) if on]
        print("+", " ".join(cmd), flush=True)
        r = subprocess.run(cmd, cwd=REPO)
        if r.returncode != 0:
            raise SystemExit(f"generation failed (rc={r.returncode})")
    artifact["generate_seconds"] = round(time.perf_counter() - t0, 1)
    artifact["sd_weights"] = args.ckpt or "random"
    artifact["params_dtype"] = args.params_dtype
    artifact["layout_weights"] = (
        args.layout_ckpt or find_default_layout_checkpoint() or "random"
    ) if not args.tiny else (args.layout_ckpt or "random")

    # this run's [start, end), last epoch and seed only (outdirs are reused;
    # the reference scorer keeps "final2_s1_", `detector_result_gpt.py:144`)
    files = protocol.list_result_files(args.outdir, (args.start, args.end),
                                       epoch=last_epoch, seed=args.seed)
    print(f"{len(files)} generated images in {args.outdir} "
          f"(indices [{args.start}, {args.end}), filter final{last_epoch}_s{args.seed}_)")
    if not files:
        raise SystemExit("no result images: generation produced nothing")

    # ---- phase 2: detection (CLIP grid detector, calibrated approximation) ----
    print(f"NOTE: {protocol.CLIP_DETECTOR_CAVEAT}", file=sys.stderr)
    clip_cfg = tiny_configs(args.steps)[0].loss_clip if args.tiny else None
    t0 = time.perf_counter()
    det, provenance = protocol.build_clip_detector(args.clip_ckpt, args.clip_vocab, cfg=clip_cfg,
                                                   device=device)
    detections = protocol.detect_folder(args.outdir, det, files,
                                        top_per_category=args.top_per_category,
                                        log=lambda m: print(m, flush=True))
    det_path = os.path.join(args.outdir, "detections_clip.json")
    with open(det_path, "w") as f:
        json.dump(detections, f)
    artifact["detect_seconds"] = round(time.perf_counter() - t0, 1)
    artifact["detector"] = "clip-grid (calibrated approximation)"
    artifact["detector_weights"] = provenance
    calib_path = os.path.join(REPO, "DETECTOR_CALIBRATION.json")
    if os.path.isfile(calib_path):
        with open(calib_path) as f:
            calib = json.load(f)["headline"]
        artifact["detector_calibration"] = {
            "oracle_recall_iou50": calib["oracle_recall_iou50"],
            "random_floor_recall_iou50": calib["random_recall_iou50"],
            "source": "DETECTOR_CALIBRATION.json (scripts/calibrate_clip_detector.py --sweep)",
        }
    else:
        artifact["detector_calibration"] = {"uncalibrated": True}
    artifact["detections_json"] = det_path

    # ---- phase 3: protocol math + CLIP fidelity ----
    scores = protocol.score_results(args.outdir, args.dataset, args.data_root, detections,
                                    prompt_range=(args.start, args.end), epoch=last_epoch,
                                    seed=args.seed)
    artifact.update(scores)
    print(f"object recall: {scores['object_recall']:.4f} "
          f"({scores['generated_objects']}/{scores['gt_objects']})")
    print(f"relation accuracy: {scores['relation_accuracy']:.4f} "
          f"({scores['relations_correct']}/{scores['relations_total']})")
    clip_loss, tokenize, cs_prov = protocol.build_clip_loss(args.clip_ckpt, args.clip_vocab,
                                                            cfg=clip_cfg, device=device)
    cs = protocol.clip_score_results(args.outdir, args.dataset, args.data_root, clip_loss,
                                     tokenize, prompt_range=(args.start, args.end),
                                     epoch=last_epoch, seed=args.seed)
    artifact.update(cs)
    artifact["clip_score_weights"] = cs_prov
    print(f"mean CLIP score: {cs['mean_clip_score']} over {cs['n_scored']}")
    with open(args.out, "w") as f:
        json.dump(artifact, f, indent=1)
    print(f"wrote {args.out}")
    print(json.dumps(artifact))
    return artifact


if __name__ == "__main__":
    main()
