"""Layout-predictor inference for one sentence, in the README's golden
format; port of the JAX package's `scripts/layout_infer.py` (reference:
`python inference/inference_coco.py --sentence '...'`).

    python -m diffusion_spacetime_attn_tpu_torch.scripts.layout_infer --cpu
    python -m diffusion_spacetime_attn_tpu_torch.scripts.layout_infer --sentence "..."

Runs on the card and raises without one, unless `--cpu` is given.  `--ckpt`
takes the reference's fairseq Rel2Bbox `.pth` or an HF RoBERTa file
(`utils/loader.load_layout_predictor`); with no checkpoint the weights are
seeded and random.  `--vocab` and `--merges` give RoBERTa's BPE, and
`--fairseq-dict` maps its ids into the fairseq checkpoint's dictionary (the
JAX script has no such flag); the tokenizer's core goes to stderr.
"""
from __future__ import annotations

import argparse
import sys

import torch

from ..config import LayoutConfig
from ..pipeline.frontend import LayoutInference
from ..utils.loader import find_default_layout_checkpoint, load_layout_predictor
from ..utils.tokenizer import make_roberta_tokenizer

GOLDEN = "The silver bed was situated to the right of the white couch."


def pick_device(cpu: bool) -> torch.device:
    """The CPU when asked for, else the card; raises without a card."""
    if cpu:
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass --cpu to run on the CPU")
    return torch.device("cuda")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--sentence", default=GOLDEN)
    ap.add_argument("--ckpt", default=None, help="layout predictor checkpoint")
    ap.add_argument("--vocab", default=None, help="RoBERTa vocab.json")
    ap.add_argument("--merges", default=None, help="RoBERTa merges.txt")
    ap.add_argument("--fairseq-dict", default=None,
                    help="the fairseq checkpoint's dictionary (test-dictionary.pkl)")
    ap.add_argument("--cpu", action="store_true", help="run on the host CPU")
    args = ap.parse_args(argv)
    device = pick_device(args.cpu)
    tok = make_roberta_tokenizer(args.vocab, args.merges, fairseq_dict_path=args.fairseq_dict)
    print(f"tokenizer core: {tok.core}", file=sys.stderr)
    if args.ckpt is None:
        args.ckpt = find_default_layout_checkpoint()
        if args.ckpt:
            print(f"using trained layout checkpoint: {args.ckpt}")
        else:
            print("WARNING: no trained checkpoint found (random weights); "
                  "train one with scripts/train_layout.py")
    model = load_layout_predictor(LayoutConfig(), args.ckpt, device=device)
    infer = LayoutInference(model, tok)
    print(f"Sentence: {args.sentence}")
    res = infer(args.sentence)
    if res is None:
        print("No COCO objects found.")
        return None
    for phrase, (x, y) in res.items():
        print(f"{phrase} position: ({x:.3f}, {y:.3f})")
    return res


if __name__ == "__main__":
    main()
