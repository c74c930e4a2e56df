"""One-command real-weights drill: read the published checkpoints -> one
vanilla image + one optimized (spacetime) image + a CLIP-score JSON; port of
the JAX package's `scripts/ingest_weights.py`, with its flags and report.

    python -m diffusion_spacetime_attn_tpu_torch.scripts.ingest_weights \\
        --sd-ckpt sd-v1-4.ckpt --layout-ckpt checkpoint_90_0.0.pth \\
        --clip-ckpt ViT-B-32.pt --clip-vocab bpe_simple_vocab_16e6.txt.gz \\
        --vocab vocab.json --merges merges.txt --fairseq-dict test-dictionary.pkl \\
        --prompt "a black cat sitting on a desk next to a laptop"
    python -m diffusion_spacetime_attn_tpu_torch.scripts.ingest_weights --tiny --cpu \\
        --steps 3 --epochs 2 --outdir /tmp/drill

The report (`<outdir>/clip_scores.json`, also printed) has the JAX drill's
keys: the weights' provenance ("checkpoint" or "random"), and for each image
1 - DCLIPLoss.global_loss against the prompt (the reference's `forward_2`),
so vanilla and method fidelity compare as in the paper's protocol.  Scores
with random CLIP weights order nothing and only prove the plumbing.

Beyond the JAX drill: `--vocab`, `--merges` and `--fairseq-dict` give the
layout predictor RoBERTa's BPE in the fairseq dictionary's id space (what
the reference layout checkpoint was trained on; the JAX drill always uses
the hash tokenizer), and the tokenizer's core is printed.  The UNet runs the
GEGLU kernel in both modes and the spacetime kernel in spacetime mode
(`use_fused_ff`, `use_fused_control`, as `run_dataset` sets them at full
width), flash unless `--no-flash`.  `--tiny` takes the run_dataset tiny
configs.  Runs on the card and raises without one, unless `--cpu` is given.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os

import torch

from ..config import LayoutConfig, PipelineConfig, UNetConfig, VAEConfig
from ..pipeline.frontend import LayoutInference
from ..pipeline.runners import PromptRunner
from ..utils.loader import load_clip_loss, load_layout_predictor, load_stable_diffusion
from ..utils.tokenizer import make_clip_tokenizer, make_roberta_tokenizer, padded
from .layout_infer import pick_device
from .run_dataset import tiny_configs
from .txt2img import generate


def run_drill(sd_ckpt=None, layout_ckpt=None, clip_ckpt=None, clip_vocab=None,
              prompt="a black cat sitting on a desk next to a laptop", outdir="ingest_outputs",
              steps=50, epochs=3, seed=1, sampler="plms", dtype="bfloat16", flash=True,
              pipeline_cfg=None, layout_cfg=None, tokenize_fn=None, device="cuda",
              roberta_tokenizer=None):
    """The drill; returns the report it also writes.  `pipeline_cfg`,
    `layout_cfg`, `tokenize_fn` and `roberta_tokenizer` replace the full
    configs and the tokenizers (tests pass tiny ones)."""
    if pipeline_cfg is None:
        pipeline_cfg = PipelineConfig(
            unet=UNetConfig(dtype=dtype, use_flash=flash, use_fused_ff=True,
                            use_fused_control=True),
            vae=VAEConfig(dtype=dtype))
    cfg = dataclasses.replace(pipeline_cfg, spacetime=dataclasses.replace(
        pipeline_cfg.spacetime, num_steps=steps, epochs=epochs))
    report = {
        "prompt": prompt, "steps": steps, "epochs": epochs, "seed": seed, "sampler": sampler,
        "sd_weights": "checkpoint" if sd_ckpt else "random",
        "layout_weights": "checkpoint" if layout_ckpt else "random",
        "clip_weights": "checkpoint" if clip_ckpt else "random",
    }
    sd = load_stable_diffusion(cfg, sd_ckpt, device=device)
    clip_loss = load_clip_loss(cfg.loss_clip, clip_ckpt, seed=9, device=device)
    rtok = roberta_tokenizer or make_roberta_tokenizer()
    print(f"layout tokenizer core: {rtok.core}")
    layout = LayoutInference(load_layout_predictor(layout_cfg or LayoutConfig(), layout_ckpt,
                                                   device=device), rtok)
    L = cfg.loss_clip.text.max_len
    tokenize = tokenize_fn or padded(make_clip_tokenizer(clip_vocab, max_len=L), L)
    runner = PromptRunner(sd=sd, clip_loss=clip_loss, layout=layout, clip_tokenize=tokenize,
                          text_tokenize=tokenize, cfg=cfg.spacetime,
                          outdir=os.path.join(outdir, "vanilla"), mode="vanilla", sampler=sampler)
    prompt_tokens = [list(tokenize(prompt))]

    def clip_score(img) -> float:
        # 1 - forward_2's global loss = cos(CLIP(image), CLIP(prompt))
        with torch.no_grad():
            x = torch.as_tensor(img, device=sd.device)[None]
            return 1.0 - float(clip_loss.global_loss(x, prompt_tokens)[0])

    # a prompt whose layout fails gets a vanilla chain from the same noise
    path, img_v = generate(runner, prompt, seed)
    report["vanilla_clip_score"] = clip_score(img_v)
    report["vanilla_image"] = os.path.dirname(path)

    runner.mode, runner.outdir = "spacetime", os.path.join(outdir, "method")
    img_m = runner.run_one(prompt, 0, seed)
    if img_m is None:
        report.update(method_clip_score=None, method_image=None,
                      method_skipped="layout produced no objects for the prompt")
    else:
        report["method_clip_score"] = clip_score(img_m)
        report["method_image"] = runner.outdir
    os.makedirs(outdir, exist_ok=True)
    with open(os.path.join(outdir, "clip_scores.json"), "w") as f:
        json.dump(report, f, indent=2)
    print(json.dumps(report))
    return report


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--sd-ckpt", default=None, help="CompVis sd-v1-4.ckpt (.ckpt/.safetensors)")
    ap.add_argument("--layout-ckpt", default=None,
                    help="fairseq checkpoint_90_0.0.pth / HF RoBERTa .pth")
    ap.add_argument("--clip-ckpt", default=None,
                    help="OpenAI ViT-B/32 (ViT-B-32.pt) for the fidelity loss")
    ap.add_argument("--clip-vocab", default=None,
                    help="CLIP BPE vocab (bpe_simple_vocab_16e6.txt.gz)")
    ap.add_argument("--vocab", default=None, help="RoBERTa vocab.json (layout tokenizer)")
    ap.add_argument("--merges", default=None, help="RoBERTa merges.txt (layout tokenizer)")
    ap.add_argument("--fairseq-dict", default=None,
                    help="the layout checkpoint's fairseq dictionary (test-dictionary.pkl)")
    ap.add_argument("--prompt", default="a black cat sitting on a desk next to a laptop")
    ap.add_argument("--outdir", default="ingest_outputs")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--epochs", type=int, default=3)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--sampler", choices=["plms", "ddim", "dpm"], default="plms")
    ap.add_argument("--dtype", default="bfloat16")
    ap.add_argument("--no-flash", dest="flash", action="store_false",
                    help="the plain self-attention in the optimization chain")
    ap.add_argument("--tiny", action="store_true", help="tiny model configs (smoke mode)")
    ap.add_argument("--cpu", action="store_true", help="run on the host CPU")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    args = parse_args(argv)
    device = pick_device(args.cpu)
    if not args.sd_ckpt:
        print("WARNING: no --sd-ckpt; random weights (plumbing drill only)")
    cfg, lcfg = tiny_configs(args.steps) if args.tiny else (None, None)
    return run_drill(
        sd_ckpt=args.sd_ckpt, layout_ckpt=args.layout_ckpt, clip_ckpt=args.clip_ckpt,
        clip_vocab=args.clip_vocab, prompt=args.prompt, outdir=args.outdir, steps=args.steps,
        epochs=args.epochs, seed=args.seed, sampler=args.sampler, dtype=args.dtype,
        flash=args.flash, pipeline_cfg=cfg, layout_cfg=lcfg, device=device,
        roberta_tokenizer=make_roberta_tokenizer(args.vocab, args.merges,
                                                 fairseq_dict_path=args.fairseq_dict))


if __name__ == "__main__":
    main()
