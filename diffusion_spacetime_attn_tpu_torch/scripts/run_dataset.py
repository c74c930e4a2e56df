"""Dataset sweep: gpt / mscoco / vsr prompt sets through the port, resumable;
port of the JAX package's `scripts/run_dataset.py` (reference:
`scripts/txt2img-{gpt,mscoco,vsr}.py`).

    python -m diffusion_spacetime_attn_tpu_torch.scripts.run_dataset \\
        --dataset mscoco --data-root DIR --mode spacetime --batch-size 2
    python -m diffusion_spacetime_attn_tpu_torch.scripts.run_dataset \\
        --dataset mscoco --data-root DIR --tiny --cpu --steps 3

Each prompt: caption -> layout (`pipeline/frontend.py`) -> images
`final{epochs-1}_s{seed}_index_{idx}.png` in `--outdir`.  A JSON manifest
there (`manifest_{dataset}.json`) records the finished indices and
`--resume` skips them; `run_log.jsonl` logs one line per prompt or batch.

The flags are the JAX script's.  Per mode, as there: `--flash` defaults on
in spacetime mode only, `--mha` on outside it, `--fused-ff` on in every
mode.  At full width the controlled cross-attention of the spatial and
spacetime modes always runs the spacetime kernel (`use_fused_control`),
which the JAX script leaves off (the XLA blend), so that the sweep runs
every kernel of its path.  `--scores-dtype` defaults to bfloat16, as
there: the plain self-attention sites (levels 2 and mid in spacetime mode)
round their scores to it.  `--params-dtype bfloat16` rounds every floating parameter to
bf16, the values JAX's cast gives (storage stays in the compute dtype).
`--tiny` takes the JAX script's tiny configs.

`--ckpt` (CompVis sd-v1-4), `--clip-ckpt` (OpenAI ViT-B/32, spacetime
mode), `--clip-vocab` (CLIP's BPE) and `--layout-ckpt` (fairseq Rel2Bbox or
HF RoBERTa) read the published files; without them the weights are seeded
and random.  Runs on the card and raises without one, unless `--cpu` is
given.
"""
from __future__ import annotations

import argparse
import json
import os
import time

import torch

from ..config import (
    CLIPConfig,
    CLIPTextConfig,
    CLIPVisionConfig,
    LayoutConfig,
    PipelineConfig,
    SpaceTimeConfig,
    UNetConfig,
    VAEConfig,
)
from ..pipeline.batch_runner import BatchedRunner
from ..pipeline.frontend import LayoutInference
from ..pipeline.runners import PromptRunner, parse_gpt_prompts, parse_line_prompts
from ..utils.loader import (
    find_default_layout_checkpoint,
    load_clip_loss,
    load_layout_predictor,
    load_stable_diffusion,
)
from ..utils.profiling import JsonLogger
from ..utils.tokenizer import make_clip_tokenizer, make_roberta_tokenizer, padded
from .layout_infer import pick_device


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--dataset", choices=["gpt", "mscoco", "vsr"], required=True)
    ap.add_argument("--data-root", default="datasets",
                    help="directory holding gpt.txt / mscoco.txt / vsr.txt")
    ap.add_argument("--mode", choices=["vanilla", "spatial", "spacetime"], default="spacetime")
    ap.add_argument("--start", type=int, default=0)
    ap.add_argument("--end", type=int, default=None)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--sampler", choices=["plms", "ddim", "dpm"], default="plms")
    ap.add_argument("--outdir", default="result_outputs")
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--layout-ckpt", default=None)
    ap.add_argument("--clip-ckpt", default=None)
    ap.add_argument("--clip-vocab", default=None)
    ap.add_argument("--dtype", default="bfloat16")
    ap.add_argument("--flash", default=None, action="store_true",
                    help="flash self-attention kernels; default on in spacetime mode only")
    ap.add_argument("--no-flash", dest="flash", action="store_false")
    ap.add_argument("--mha", default=None, action="store_true",
                    help="MHA self-attention kernel; default on outside spacetime mode")
    ap.add_argument("--no-mha", dest="mha", action="store_false")
    ap.add_argument("--fused-ff", default=None, action="store_true",
                    help="GEGLU feed-forward kernels; default on in every mode")
    ap.add_argument("--no-fused-ff", dest="fused_ff", action="store_false")
    ap.add_argument("--scores-dtype", default="bfloat16")
    ap.add_argument("--params-dtype", default="float32", choices=["float32", "bfloat16"])
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--save-epochs", action="store_true",
                    help="also save the earlier epochs' images final{0..epochs-2}_…")
    ap.add_argument("--batch-size", type=int, default=1,
                    help=">1 packs prompts into fixed-size batches (BatchedRunner)")
    ap.add_argument("--tiny", action="store_true",
                    help="tiny model configs (protocol smoke, CPU tests)")
    ap.add_argument("--cpu", action="store_true", help="run on the host CPU")
    return ap.parse_args(argv)


def tiny_configs(steps: int):
    """(PipelineConfig, LayoutConfig) of the JAX script's --tiny."""
    text = CLIPTextConfig(width=16, layers=2, heads=2, vocab_size=49408, max_len=7)
    cfg = PipelineConfig(
        unet=UNetConfig(model_channels=32, channel_mult=(1, 2), num_res_blocks=1,
                        attention_resolutions=(1, 2), num_heads=2, context_dim=16),
        vae=VAEConfig(ch=32, ch_mult=(1, 2), num_res_blocks=1),
        text_encoder=text,
        loss_clip=CLIPConfig(vision=CLIPVisionConfig(image_size=14, patch_size=7, width=16,
                                                     layers=2, heads=2, projection_dim=8),
                             text=text, projection_dim=8),
        spacetime=SpaceTimeConfig(num_steps=steps, latent_size=16, image_size=32, epochs=2))
    return cfg, LayoutConfig(hidden=32, layers=2, heads=2, ffn_dim=64, max_len=32)


def round_params_(module: torch.nn.Module, dtype: str) -> None:
    """Round every floating parameter to `dtype`'s precision in place."""
    dt = getattr(torch, dtype)
    with torch.no_grad():
        for p in module.parameters():
            if p.is_floating_point():
                p.copy_(p.to(dt).to(p.dtype))


def main(argv=None) -> dict:
    """Run the sweep; returns {"done", "produced", "seconds"}."""
    args = parse_args(argv)
    device = pick_device(args.cpu)
    if args.dataset == "gpt":
        prompts = parse_gpt_prompts(os.path.join(args.data_root, "gpt.txt"))
    else:
        prompts = parse_line_prompts(os.path.join(args.data_root, f"{args.dataset}.txt"))

    use_flash = (args.mode == "spacetime") if args.flash is None else args.flash
    use_mha = (args.mode != "spacetime") if args.mha is None else args.mha
    use_fused_ff = True if args.fused_ff is None else args.fused_ff
    if args.tiny:
        cfg, lcfg = tiny_configs(args.steps)
    else:
        cfg = PipelineConfig(
            unet=UNetConfig(dtype=args.dtype, use_flash=use_flash, use_mha=use_mha,
                            use_fused_ff=use_fused_ff, use_fused_control=True,
                            attn_scores_dtype=args.scores_dtype),
            vae=VAEConfig(dtype=args.dtype),
            spacetime=SpaceTimeConfig(num_steps=args.steps))
        lcfg = LayoutConfig()
    sd = load_stable_diffusion(cfg, args.ckpt, device=device)
    clip_loss = None
    if args.mode == "spacetime":
        # the loss CLIP is on the tape in spacetime mode only
        clip_loss = load_clip_loss(cfg.loss_clip, args.clip_ckpt, seed=9, device=device)
    if args.params_dtype != "float32":
        for m in (sd.unet, sd.vae, sd.text_encoder) + ((clip_loss.clip,) if clip_loss else ()):
            round_params_(m, args.params_dtype)
        print(f"params rounded to {args.params_dtype}")
    if args.layout_ckpt is None and not args.tiny:
        args.layout_ckpt = find_default_layout_checkpoint()
        if args.layout_ckpt:
            print(f"using trained layout checkpoint: {args.layout_ckpt}")
    layout = LayoutInference(load_layout_predictor(lcfg, args.layout_ckpt, device=device),
                             make_roberta_tokenizer())
    L = cfg.text_encoder.max_len
    tokenize = padded(make_clip_tokenizer(args.clip_vocab, max_len=L), L)
    runner = PromptRunner(sd=sd, clip_loss=clip_loss, layout=layout, clip_tokenize=tokenize,
                          text_tokenize=tokenize, cfg=cfg.spacetime, outdir=args.outdir,
                          mode=args.mode, sampler=args.sampler,
                          save_epoch_images=args.save_epochs)

    manifest_path = os.path.join(args.outdir, f"manifest_{args.dataset}.json")
    done = set()
    if args.resume and os.path.exists(manifest_path):
        with open(manifest_path) as f:
            done = set(json.load(f)["done"])
        print(f"resuming: {len(done)} prompts already complete")
    os.makedirs(args.outdir, exist_ok=True)
    log = JsonLogger(os.path.join(args.outdir, "run_log.jsonl"))

    def write_manifest():
        with open(manifest_path, "w") as f:
            json.dump({"done": sorted(done)}, f)

    end = min(args.end or len(prompts), len(prompts))
    todo = [i for i in range(args.start, end) if i not in done]
    t0 = time.perf_counter()
    produced = 0
    try:
        if args.batch_size > 1:
            def checkpoint(chunk):
                # per chunk: a killed sweep resumes losing at most one batch
                done.update(chunk)
                write_manifest()

            produced = BatchedRunner(runner, batch_size=args.batch_size).run(
                prompts, indices=todo, seed=args.seed, log=log, on_chunk_done=checkpoint)
            log.log("sweep_done", produced=produced,
                    seconds=round(time.perf_counter() - t0, 3))
        else:
            for idx in todo:
                t1 = time.perf_counter()
                img = runner.run_one(prompts[idx], idx, args.seed)
                produced += img is not None
                log.log("prompt_done", idx=idx, ok=img is not None,
                        seconds=round(time.perf_counter() - t1, 3))
                done.add(idx)
                write_manifest()
    finally:
        log.close()
    print(f"sweep complete: {len(done)} prompts")
    return {"done": sorted(done), "produced": produced,
            "seconds": time.perf_counter() - t0}


if __name__ == "__main__":
    main()
