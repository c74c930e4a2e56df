"""The text front end's object extraction against each dataset's ground-truth
object lists; port of the JAX package's `scripts/eval_frontend_extraction.py`.

    python -m diffusion_spacetime_attn_tpu_torch.scripts.eval_frontend_extraction \
        --data-root DATA --out FRONTEND_EVAL.json

The reference extracts object mentions with spaCy noun chunks filtered by a
COCO-substring rule (`inference/inference_coco.py:441-528`); the port, like
the JAX package where spaCy is absent, runs the deterministic n-gram matcher
(`pipeline/frontend.py`).  Over the gpt, mscoco and vsr prompt sets under
`--data-root` (`gpt.txt`; `{mscoco,vsr}.txt` with their `.pkl` ground
truth), host only, it reports per dataset
  recall      GT categories found by the front end
  precision   extracted mentions that are GT categories
  full_cover  prompts where every GT category was extracted
plus `coco_recall` (GT restricted to the COCO vocabulary), the aggregate and
a failure sample, with the JAX script's keys.
"""
import argparse
import collections
import json
import os

from ..eval import metrics
from ..pipeline import runners
from ..pipeline.frontend import COCO_CATEGORIES, canonical_category, extract_objects


def main(argv=None) -> dict:
    """Score the three prompt sets; returns the artifact written to --out."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--data-root", default="datasets",
                    help="the datasets directory (gpt.txt, {mscoco,vsr}.txt and .pkl)")
    ap.add_argument("--out", default="FRONTEND_EVAL_r05.json")
    ap.add_argument("--max-failures", type=int, default=10)
    args = ap.parse_args(argv)

    artifact = {
        "protocol": "frontend-extraction-vs-gt",
        "extractor": "n-gram fallback (spaCy absent in this environment)",
        "reference": "inference/inference_coco.py:441-528",
        "notes": [
            "coco_recall restricts GT to names in the COCO vocabulary "
            "(after synonym canonicalization); names outside it are "
            "un-extractable by any COCO-category frontend.",
            "residual gpt misses are GT noise: the generated object lists "
            "sometimes name objects that appear nowhere in the caption "
            "text, which no text parser (spaCy included) can recover.",
            "precision counts repeated mentions of the same object as "
            "spurious; re-mentions are correct extractor behavior.",
        ],
        "datasets": {},
    }
    tot_gt = tot_hit = tot_extracted = tot_spurious = 0
    for ds in ("gpt", "mscoco", "vsr"):
        if ds == "gpt":
            prompts = runners.parse_gpt_prompts(
                os.path.join(args.data_root, "gpt.txt"))
            gt_objects, _ = metrics.parse_gpt_ground_truth(
                os.path.join(args.data_root, "gpt.txt"))
        else:
            prompts = runners.parse_line_prompts(
                os.path.join(args.data_root, f"{ds}.txt"))
            gt_objects, _ = metrics.parse_pkl_ground_truth(
                os.path.join(args.data_root, f"{ds}.pkl"))
        n_gt = n_hit = n_ext = n_spur = n_full = 0
        n_coco_gt = n_coco_hit = 0
        failures = []
        for prompt, gts in zip(prompts, gt_objects):
            _, mentions = extract_objects(prompt)
            found = collections.Counter(m.category for m in mentions)
            want = collections.Counter(
                canonical_category(g) for g in gts if g)
            # GT names outside the COCO vocabulary (mscoco pkl rows carry
            # e.g. "bathroom", "wheel") are un-extractable by ANY
            # COCO-category frontend, the reference's included
            coco_want = collections.Counter(
                {k: v for k, v in want.items() if k in COCO_CATEGORIES})
            hit = sum((found & want).values())
            spur = sum((found - want).values())
            n_gt += sum(want.values())
            n_hit += hit
            n_coco_gt += sum(coco_want.values())
            n_coco_hit += sum((found & coco_want).values())
            n_ext += sum(found.values())
            n_spur += spur
            if hit == sum(want.values()) and want:
                n_full += 1
            elif want and len(failures) < args.max_failures:
                failures.append({
                    "prompt": prompt,
                    "gt": sorted(want.elements()),
                    "extracted": sorted(found.elements()),
                })
        artifact["datasets"][ds] = {
            "prompts": len(prompts),
            "gt_objects": n_gt,
            "recall": round(n_hit / max(n_gt, 1), 4),
            "coco_extractable_gt": n_coco_gt,
            "coco_recall": round(n_coco_hit / max(n_coco_gt, 1), 4),
            "precision": round((n_ext - n_spur) / max(n_ext, 1), 4),
            "full_cover": round(n_full / max(len(prompts), 1), 4),
            "failure_sample": failures,
        }
        tot_gt += n_gt
        tot_hit += n_hit
        tot_extracted += n_ext
        tot_spurious += n_spur
        print(f"{ds}: recall {n_hit}/{n_gt} = {n_hit / max(n_gt, 1):.4f}  "
              f"coco-recall {n_coco_hit}/{n_coco_gt} = "
              f"{n_coco_hit / max(n_coco_gt, 1):.4f}  "
              f"precision {(n_ext - n_spur)}/{n_ext} = "
              f"{(n_ext - n_spur) / max(n_ext, 1):.4f}", flush=True)
    artifact["aggregate"] = {
        "recall": round(tot_hit / max(tot_gt, 1), 4),
        "precision": round((tot_extracted - tot_spurious)
                           / max(tot_extracted, 1), 4),
    }
    with open(args.out, "w") as f:
        json.dump(artifact, f, indent=1)
    print(f"wrote {args.out}")
    return artifact


if __name__ == "__main__":
    main()
