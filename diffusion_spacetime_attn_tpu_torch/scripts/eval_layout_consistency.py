"""Layout-level relation consistency over an evaluation prompt set; port of
the JAX package's `scripts/eval_layout_consistency.py`.

    python -m diffusion_spacetime_attn_tpu_torch.scripts.eval_layout_consistency \
        --dataset gpt --data-root DATA --random-baseline --out LAYOUT_EVAL.json

The image-level protocol measures layout predictor + diffusion + detector
together; this scores the layout predictor alone through the real inference
path (front-end parse -> `predict_xy` -> centre geometry) against the
dataset's ground-truth relations with the reference's pass rule
(`relation_result_gpt.py:95-110`; chance is 0.5).  `--random-baseline` adds
the randomly initialised predictor's row, `--breakdown` per-relation counts
and failures, `--decode greedy` the reference's argmax-component mean in
place of the relation-aware decode.  The predictor runs on the card unless
`--cpu` is given; `--ckpt random` forces random weights, and a trained run
dir of either trainer loads (the JAX one's orbax params included).
"""
import argparse
import json
import os
import time

from ..config import LayoutConfig
from ..eval import metrics
from ..eval.metrics import head_category
from ..pipeline import runners
from ..pipeline.frontend import LayoutInference
from ..utils.loader import find_default_layout_checkpoint, load_layout_predictor
from ..utils.tokenizer import make_roberta_tokenizer
from .layout_infer import pick_device


def predict_all(infer, prompts, log_every=100):
    """Category→center dict per prompt via the real inference path."""
    out = []
    t0 = time.perf_counter()
    for i, p in enumerate(prompts):
        res = infer(p)
        centers = {}
        if res:
            for phrase, xy in res.items():
                cat = head_category(phrase)
                if cat is not None and cat not in centers:
                    centers[cat] = xy
        out.append(centers or None)
        if log_every and (i + 1) % log_every == 0:
            dt = time.perf_counter() - t0
            print(f"  {i + 1}/{len(prompts)} prompts ({dt:.0f}s)", flush=True)
    return out


def main(argv=None, load=None) -> dict:
    """Score the layouts; returns the artifact.  `load(cfg, ckpt_path)` ->
    model replaces `utils/loader.load_layout_predictor` on the chosen
    device."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--dataset", choices=["gpt", "mscoco", "vsr"], default="gpt")
    ap.add_argument("--data-root", default="datasets",
                    help="the datasets directory (gpt.txt, {mscoco,vsr}.txt and .pkl)")
    ap.add_argument("--start", type=int, default=0)
    ap.add_argument("--end", type=int, default=None, help="default: all")
    ap.add_argument("--ckpt", default=None,
                    help="default: utils.loader.find_default_layout_checkpoint;"
                         " pass 'random' to force random init (tests)")
    ap.add_argument("--random-baseline", action="store_true",
                    help="also score randomly-initialized weights (~0.5)")
    ap.add_argument("--out", default=None, help="artifact JSON path")
    ap.add_argument("--breakdown", action="store_true",
                    help="add per-relation-type stats + failure samples to "
                         "the artifact (trained weights only)")
    ap.add_argument("--decode", choices=["relation", "greedy"],
                    default="relation",
                    help="'relation' = the deployed relation-aware GMM "
                         "decode (frontend.extract_relations steers "
                         "component choice); 'greedy' = the reference's "
                         "argmax-component mean")
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args(argv)
    if load is None:
        device = pick_device(args.cpu)

        def load(cfg, path):
            return load_layout_predictor(cfg, path, device=device)

    if args.dataset == "gpt":
        prompts = runners.parse_gpt_prompts(
            os.path.join(args.data_root, "gpt.txt"))
        _, gt_relations = metrics.parse_gpt_ground_truth(
            os.path.join(args.data_root, "gpt.txt"))
    else:
        prompts = runners.parse_line_prompts(
            os.path.join(args.data_root, f"{args.dataset}.txt"))
        _, gt_relations = metrics.parse_pkl_ground_truth(
            os.path.join(args.data_root, f"{args.dataset}.pkl"))
    end = len(prompts) if args.end is None else args.end
    prompts = prompts[args.start:end]
    gt_relations = gt_relations[args.start:end]

    ckpt = (None if args.ckpt == "random"
            else args.ckpt or find_default_layout_checkpoint())
    cfg = LayoutConfig()
    tok = make_roberta_tokenizer(None, None)

    artifact = {
        "protocol": "layout-relation-consistency",
        "dataset": args.dataset,
        "prompts": [args.start, end],
        "pass_rule": "relation_result_gpt.py:95-110 center geometry",
        "chance_level": 0.5,
        "decode": args.decode,
    }

    def run(label, ckpt_path):
        infer = LayoutInference(load(cfg, ckpt_path), tok,
                                relation_aware=args.decode == "relation")
        print(f"[{label}] predicting layouts for {len(prompts)} prompts "
              f"(weights: {ckpt_path or 'random'})", flush=True)
        centers = predict_all(infer, prompts)
        scores = metrics.layout_relation_consistency(centers, gt_relations)
        print(f"[{label}] consistency {scores['consistency_evaluated']:.4f} "
              f"({scores['relations_satisfied']}/{scores['relations_evaluated']}"
              f" evaluated of {scores['relations_total']} GT relations; "
              f"object coverage {scores['relation_object_coverage']:.3f})",
              flush=True)
        out = {"weights": ckpt_path or "random", **scores}
        if args.breakdown and label == "trained":
            by_rel, failures = {}, []
            for prompt, cen, rels in zip(prompts, centers, gt_relations):
                cen = cen or {}
                for o1, o2, rel in rels:
                    d = by_rel.setdefault(rel, {"sat": 0, "viol": 0,
                                                "uneval": 0})
                    if o1 not in cen or o2 not in cen:
                        d["uneval"] += 1
                        continue
                    c1, c2 = cen[o1], cen[o2]
                    ok = metrics.relation_pass(
                        rel, (c1[0], c1[1], c1[0], c1[1]),
                        (c2[0], c2[1], c2[0], c2[1]))
                    d["sat" if ok else "viol"] += 1
                    if not ok and len(failures) < 40:
                        failures.append({
                            "prompt": prompt, "rel": f"{o1} {rel} {o2}",
                            "c1": [round(float(v), 3) for v in c1[:2]],
                            "c2": [round(float(v), 3) for v in c2[:2]],
                        })
            out["by_relation"] = by_rel
            out["failure_sample"] = failures
        return out

    artifact["trained"] = run("trained", ckpt)
    if args.random_baseline:
        artifact["random_baseline"] = run("random", None)

    if args.out:
        json.dump(artifact, open(args.out, "w"), indent=1)
        print(f"wrote {args.out}")
    print(json.dumps(artifact))
    return artifact


if __name__ == "__main__":
    main()
