"""VG / VG-MSDN batch layout inference CLI; port of the JAX package's
`scripts/infer_vg_msdn.py` (reference `inference/inference_vg_msdn.py`),
with its flags:

    python -m diffusion_spacetime_attn_tpu_torch.scripts.infer_vg_msdn \\
        --instances vg_msdn.json --out out/ --layout-save out/layouts --limit 100
    python -m diffusion_spacetime_attn_tpu_torch.scripts.infer_vg_msdn --tiny --cpu \\
        --instances sg.json --out /tmp/vg

Scene graphs (a VG-MSDN instances list, or one sg2im-style dict) -> drawn
layout PNGs, relation logs, sg2im JSONs and, with `--layout-save`,
normalized layout JSONs (`pipeline/vg_inference.py`).  The layout predictor
is `utils/loader.load_layout_predictor` (`--ckpt`: a fairseq Rel2Bbox or HF
RoBERTa file, or the port's run dir; seeded random weights without) at
`LayoutConfig()` width, or the JAX script's tiny config with `--tiny`; the
tokenizer is RoBERTa's (`--vocab` / `--merges` / `--fairseq-dict`, else the
hash tokenizer).  Runs on the card and raises without one, unless `--cpu`.
"""
from __future__ import annotations

import argparse
import json

from ..config import LayoutConfig
from ..pipeline.frontend import LayoutInference
from ..pipeline.vg_inference import VGMSDNInference
from ..utils.loader import load_layout_predictor
from ..utils.tokenizer import make_roberta_tokenizer
from .layout_infer import pick_device


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--instances", required=True,
                    help="VG-MSDN instances JSON (records with objects + relationships), or "
                         "a single sg2im-style JSON dict")
    ap.add_argument("--out", required=True, help="artifact directory")
    ap.add_argument("--layout-save", default=None,
                    help="also write normalized layout JSONs here")
    ap.add_argument("--ckpt", default=None,
                    help="layout checkpoint (fairseq or HF .pth, or a run dir); random without")
    ap.add_argument("--vocab", default=None, help="RoBERTa vocab.json")
    ap.add_argument("--merges", default=None, help="RoBERTa merges.txt")
    ap.add_argument("--fairseq-dict", default=None,
                    help="test-dictionary.pkl for fairseq-id tokenization")
    ap.add_argument("--limit", type=int, default=None)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--tiny", action="store_true", help="tiny model (smoke)")
    ap.add_argument("--cpu", action="store_true", help="run on the host CPU")
    return ap.parse_args(argv)


def main(argv=None, model=None) -> list:
    """Run; returns the per-scene-graph results.  `model` replaces the
    loaded layout predictor."""
    args = parse_args(argv)
    device = pick_device(args.cpu)
    cfg = (LayoutConfig(hidden=32, layers=2, heads=2, ffn_dim=64, vocab_size=50265, max_len=32)
           if args.tiny else LayoutConfig())
    if model is None:
        model = load_layout_predictor(cfg, args.ckpt, device=device)
    tokenizer = make_roberta_tokenizer(args.vocab, args.merges,
                                       fairseq_dict_path=args.fairseq_dict)
    li = LayoutInference(model, tokenizer, cfg.max_len)
    vg = VGMSDNInference(li, args.out)
    with open(args.instances) as f:
        data = json.load(f)
    if isinstance(data, dict):
        data = [data]
    results = vg.run(data[: args.limit or len(data)], layout_save=args.layout_save,
                     batch=args.batch)
    done = sum(1 for r in results if "png" in r)
    print(f"wrote {done}/{len(results)} layouts to {args.out}")
    return results


if __name__ == "__main__":
    main()
