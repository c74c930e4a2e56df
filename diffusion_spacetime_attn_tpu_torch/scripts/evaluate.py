"""Evaluation CLI: object recall and relation accuracy over a results folder;
port of the JAX package's `scripts/evaluate.py` (reference
`evaluation/detector_result_gpt.py` + `relation_result_gpt.py`), with its
flags, printed lines and JSON keys.

    python -m diffusion_spacetime_attn_tpu_torch.scripts.evaluate --results DIR \\
        --dataset gpt --data-root DATA --detections detections.json --json-out e.json
    python -m diffusion_spacetime_attn_tpu_torch.scripts.evaluate --results DIR \\
        --detector clip --dump-detections d.json --clip-score --tiny --cpu

The detector is pluggable: `--detections` (filename -> [[x1, y1, x2, y2,
category, score], ...], e.g. from detrex DINO as in the reference), or
`--detector clip`, the CLIP grid detector (`eval/clip_detector.py`), a
calibrated approximation whose caveat and weight provenance are printed;
`--dump-detections` writes its detections in the same JSON form.
`--clip-score` adds the CLIP fidelity score.  `--json-out` writes every
number.  The CLIP towers run on the card unless `--cpu` is given (random
seeded weights without `--clip-ckpt`).
"""
from __future__ import annotations

import argparse
import json
import sys

from ..eval import protocol
from .layout_infer import pick_device
from .run_dataset import tiny_configs


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--results", default="result_outputs")
    ap.add_argument("--dataset", choices=["gpt", "mscoco", "vsr"], default="gpt")
    ap.add_argument("--data-root", default="datasets",
                    help="the datasets directory (gpt.txt, {mscoco,vsr}.txt and .pkl)")
    ap.add_argument("--detections", default=None, help="detections JSON")
    ap.add_argument("--detector", choices=["clip"], default=None,
                    help="run the CLIP grid detector (calibrated approximation — "
                         "prints the caveat)")
    ap.add_argument("--dump-detections", default=None,
                    help="with --detector clip: also write the detections JSON "
                         "(interchangeable with the detrex route)")
    ap.add_argument("--conf-recall", type=float, default=0.4)
    ap.add_argument("--conf-relation", type=float, default=0.5)
    ap.add_argument("--clip-score", action="store_true")
    ap.add_argument("--clip-ckpt", default=None)
    ap.add_argument("--clip-vocab", default=None)
    ap.add_argument("--json-out", default=None)
    ap.add_argument("--tiny", action="store_true", help="tiny CLIP towers (CPU protocol tests)")
    ap.add_argument("--cpu", action="store_true")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    """Score the folder; returns the report written by `--json-out`."""
    args = parse_args(argv)
    clip_cfg = tiny_configs(1)[0].loss_clip if args.tiny else None
    files = protocol.list_result_files(args.results)
    print(f"{len(files)} result images")
    report = {"results_dir": args.results, "dataset": args.dataset, "n_images": len(files)}

    detections = None
    if args.detections:
        with open(args.detections) as f:
            detections = json.load(f)
        report["detector"] = "external-json"
    elif args.detector == "clip":
        print(f"NOTE: {protocol.CLIP_DETECTOR_CAVEAT}", file=sys.stderr)
        det, provenance = protocol.build_clip_detector(
            args.clip_ckpt, args.clip_vocab, cfg=clip_cfg, device=pick_device(args.cpu))
        if provenance == "random":
            print("WARNING: random CLIP weights — detections exercise the mechanism only; "
                  "scores are not meaningful", file=sys.stderr)
        detections = protocol.detect_folder(args.results, det, files, log=print)
        report["detector"] = "clip-grid (calibrated approximation)"
        report["detector_weights"] = provenance
        if args.dump_detections:
            with open(args.dump_detections, "w") as f:
                json.dump(detections, f)
            print(f"wrote {args.dump_detections}")

    if detections is not None:
        scores = protocol.score_results(args.results, args.dataset, args.data_root,
                                        detections, args.conf_recall, args.conf_relation)
        report.update(scores)
        print(f"All object numbers: {scores['gt_objects']}")
        print(f"Generated object numbers: {scores['generated_objects']}")
        print(f"object recall: {scores['object_recall']:.4f}")
        print(f"relation accuracy: {scores['relation_accuracy']:.4f} "
              f"({scores['relations_correct']}/{scores['relations_total']})")

    if args.clip_score:
        loss, tokenize, cs_prov = protocol.build_clip_loss(
            args.clip_ckpt, args.clip_vocab, cfg=clip_cfg, device=pick_device(args.cpu))
        if cs_prov == "random":
            print("WARNING: random CLIP weights — score is not meaningful")
        report["clip_score_weights"] = cs_prov
        cs = protocol.clip_score_results(args.results, args.dataset, args.data_root,
                                         loss, tokenize)
        report.update(cs)
        print(f"mean CLIP score: {cs['mean_clip_score']} over {cs['n_scored']} images")

    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump(report, f, indent=1)
        print(f"wrote {args.json_out}")
    return report


if __name__ == "__main__":
    main()
