"""Serving entry point: HTTP txt2img behind the dynamic batcher, or a warmup,
a soak or an open-loop load test; port of the JAX package's
`scripts/serve.py`, with its flags.

    python -m diffusion_spacetime_attn_tpu_torch.scripts.serve --batch 2 --port 8000
    curl -X POST localhost:8000/txt2img -d '{"prompt": "a cat", "seed": 3}'
    python -m diffusion_spacetime_attn_tpu_torch.scripts.serve --tiny --cpu --soak 3

Modes: `vanilla` (TextToImageEngine), `spatial` (the same with the layout
predictor behind `PromptRunner.prepare_host`: per-object attention control
at fixed weights) and `spacetime` (SpaceTimeEngine: the per-request
temporal weight optimization, gradients through the chain, a ViT-B/32 loss
CLIP).  Per mode, as the JAX script sets them: vanilla and spatial run the
MHA and GEGLU kernels and no flash; spacetime runs flash only.  At full
width the spatial and spacetime modes also set `use_fused_control`, which
the JAX script leaves off (the XLA blend), so that the controlled
cross-attention runs the spacetime kernel, as in `scripts/run_dataset.py`.
`--params-dtype` defaults to bfloat16 in spacetime mode and float32
elsewhere; bfloat16 rounds every floating parameter to bf16 values (the
storage keeps the compute dtype, `run_dataset.round_params_`).
`--scores-dtype` defaults to bfloat16, as there (the plain self-attention
sites round their scores to it).  `--tiny` takes the JAX script's tiny configs (4 PLMS steps,
whatever `--steps` says); the layout predictor is at `LayoutConfig()` in
every mode that has one, as there.

After `engine.warmup()` (one full batch, which builds the kernels):
`--warmup-only` exits, `--soak N` runs N requests through the engine in
batches and prints one JSON line per batch and a summary line, `--loadtest
N` runs `serving/loadtest.run_loadtest` with N requests per stage and
prints its artifact; otherwise it serves (`serving/server.serve`).

`--ckpt` (CompVis sd-v1-4), `--clip-ckpt` (OpenAI ViT-B/32, spacetime
mode), `--clip-vocab` (CLIP's BPE) and `--layout-ckpt` (fairseq Rel2Bbox
or HF RoBERTa) read the published files; without them the weights are
seeded and random.  One process on one card, as JAX's `serve`: no entry
point serves over a mesh (the engines take one, `serving/server.py`).  Runs
on the card and raises without one, unless `--cpu` is given.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

from ..config import LayoutConfig, PipelineConfig, SpaceTimeConfig, UNetConfig, VAEConfig
from ..pipeline.frontend import LayoutInference
from ..pipeline.runners import PromptRunner
from ..serving import BatchingService, SpaceTimeEngine, TextToImageEngine, serve
from ..serving.loadtest import PROMPTS, run_loadtest
from ..utils.loader import (
    find_default_layout_checkpoint,
    load_clip_loss,
    load_layout_predictor,
    load_stable_diffusion,
)
from ..utils.tokenizer import make_clip_tokenizer, make_roberta_tokenizer, padded
from .layout_infer import pick_device
from .run_dataset import round_params_, tiny_configs


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--host", default="0.0.0.0")
    ap.add_argument("--port", type=int, default=8000)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--mode", choices=["vanilla", "spatial", "spacetime"], default="vanilla")
    ap.add_argument("--layout-ckpt", default=None)
    ap.add_argument("--clip-ckpt", default=None)
    ap.add_argument("--sampler", choices=["plms", "ddim", "dpm"], default="plms")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--scale", type=float, default=7.5)
    ap.add_argument("--max-wait", type=float, default=0.2,
                    help="seconds to wait filling a batch")
    ap.add_argument("--max-queue", type=int, default=None,
                    help="bounded request queue (default 8x batch); full -> HTTP 503")
    ap.add_argument("--request-timeout", type=float, default=None,
                    help="seconds a request may wait in the queue (HTTP 504 after)")
    ap.add_argument("--warmup-only", action="store_true",
                    help="run one batch (building the kernels) and exit")
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--clip-vocab", default=None)
    ap.add_argument("--dtype", default="bfloat16")
    ap.add_argument("--scores-dtype", default="bfloat16")
    ap.add_argument("--params-dtype", default=None, choices=["float32", "bfloat16"],
                    help="default: bfloat16 in spacetime mode, float32 elsewhere")
    ap.add_argument("--soak", type=int, default=None, metavar="N",
                    help="after warmup, N requests through the engine, one JSON line "
                         "per batch and a summary, then exit")
    ap.add_argument("--loadtest", type=int, default=None, metavar="N",
                    help="after warmup, the open-loop load test with N requests per "
                         "stage; prints the artifact as JSON, then exits")
    ap.add_argument("--loadtest-fractions", default="0.5,0.8,1.0,1.3",
                    help="offered rates as fractions of the measured capacity")
    ap.add_argument("--loadtest-out", default=None,
                    help="also write the load test's artifact to this path")
    ap.add_argument("--watermark", default=None, help="payload to embed")
    ap.add_argument("--tiny", action="store_true", help="tiny model configs (smoke mode)")
    ap.add_argument("--cpu", action="store_true", help="run on the host CPU")
    return ap.parse_args(argv)


def log(msg: str) -> None:
    print(f"[serve] {msg}", file=sys.stderr, flush=True)


def build_engine(args):
    """(engine, params dtype) for the parsed flags."""
    device = pick_device(args.cpu)
    if args.tiny:
        cfg, _ = tiny_configs(4)
    else:
        cfg = PipelineConfig(
            unet=UNetConfig(dtype=args.dtype, attn_scores_dtype=args.scores_dtype,
                            use_flash=args.mode == "spacetime",
                            use_mha=args.mode != "spacetime",
                            use_fused_ff=args.mode != "spacetime",
                            use_fused_control=args.mode != "vanilla"),
            vae=VAEConfig(dtype=args.dtype),
            spacetime=SpaceTimeConfig(num_steps=args.steps, guidance_scale=args.scale))
    sd = load_stable_diffusion(cfg, args.ckpt, device=device)
    clip_loss = None
    if args.mode == "spacetime":
        clip_loss = load_clip_loss(cfg.loss_clip, args.clip_ckpt, seed=9, device=device)
        if not args.clip_ckpt:
            log("no --clip-ckpt: random fidelity-loss CLIP")
    params_dtype = args.params_dtype or ("bfloat16" if args.mode == "spacetime" else "float32")
    if params_dtype != "float32":
        for m in (sd.unet, sd.vae, sd.text_encoder) + ((clip_loss.clip,) if clip_loss else ()):
            round_params_(m, params_dtype)
        log(f"params rounded to {params_dtype}")
    L = cfg.text_encoder.max_len
    tokenize = padded(make_clip_tokenizer(args.clip_vocab, max_len=L), L)
    runner = None
    if args.mode != "vanilla":
        ckpt = args.layout_ckpt or (None if args.tiny else find_default_layout_checkpoint())
        if ckpt:
            log(f"using trained layout checkpoint: {ckpt}")
        layout = LayoutInference(load_layout_predictor(LayoutConfig(), ckpt, device=device),
                                 make_roberta_tokenizer())
        runner = PromptRunner(sd=sd, clip_loss=clip_loss, layout=layout, clip_tokenize=tokenize,
                              text_tokenize=tokenize, cfg=cfg.spacetime, mode=args.mode,
                              sampler=args.sampler)
    if args.mode == "spacetime":
        engine = SpaceTimeEngine(runner=runner, batch_size=args.batch, watermark=args.watermark)
    else:
        engine = TextToImageEngine(sd=sd, tokenize=tokenize, batch_size=args.batch,
                                   sampler=args.sampler, watermark=args.watermark,
                                   prepare_host=runner.prepare_host if runner else None)
    return engine, params_dtype


def soak(engine, args, params_dtype: str) -> dict:
    """N sequential requests in batches; prints the JAX script's lines."""
    done, t_all = 0, time.perf_counter()
    batch_times, batch_sizes = [], []
    while done < args.soak:
        n = min(args.batch, args.soak - done)
        prompts = [PROMPTS[(done + i) % len(PROMPTS)] for i in range(n)]
        seeds = [1000 + done + i for i in range(n)]
        t0 = time.perf_counter()
        imgs = engine.generate_batch(prompts, seeds)
        dt = time.perf_counter() - t0
        batch_times.append(dt)
        batch_sizes.append(n)
        done += n
        print(json.dumps({"soak_batch": len(batch_times), "requests_done": done, "n": n,
                          "seconds": round(dt, 2), "img_shape": list(imgs.shape)}), flush=True)
    # the steady time per request from full batches only: a remainder batch
    # is the fastest and would understate it
    full = [dt / n for dt, n in zip(batch_times, batch_sizes) if n == args.batch]
    summary = {"soak_ok": True, "mode": args.mode, "batch_size": args.batch,
               "params_dtype": params_dtype, "requests": done, "batches": len(batch_times),
               "total_seconds": round(time.perf_counter() - t_all, 1),
               "s_per_request_steady": round(min(full), 2) if full else None}
    print(json.dumps(summary), flush=True)
    return summary


def main(argv=None):
    """Run the chosen mode; returns the soak summary, the load test's
    artifact, or the warmup seconds (None after serving)."""
    args = parse_args(argv)
    engine, params_dtype = build_engine(args)
    log(f"warming up: batch-{args.batch} {args.sampler} {args.mode}")
    warm_s = engine.warmup()
    log(f"warmup done in {warm_s:.1f}s")
    if args.warmup_only:
        return warm_s
    if args.loadtest:
        artifact = run_loadtest(
            engine, capacity_fractions=tuple(float(x) for x in args.loadtest_fractions.split(",")),
            stage_requests=args.loadtest, max_wait_s=args.max_wait, max_queue=args.max_queue,
            request_timeout_s=args.request_timeout)
        artifact.update(mode=args.mode, sampler=args.sampler, params_dtype=params_dtype,
                        steps=args.steps)
        out = json.dumps(artifact, indent=2)
        print(out, flush=True)
        if args.loadtest_out:
            with open(args.loadtest_out, "w") as f:
                f.write(out + "\n")
        return artifact
    if args.soak:
        return soak(engine, args, params_dtype)
    service = BatchingService(engine, max_wait_s=args.max_wait, max_queue=args.max_queue,
                              request_timeout_s=args.request_timeout).start()
    log(f"serving on {args.host}:{args.port} (POST /txt2img, GET /healthz)")
    try:
        serve(service, args.host, args.port)
    finally:
        service.stop()
    return None


if __name__ == "__main__":
    main()
