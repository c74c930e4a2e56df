"""FLOP / MFU accounting for the JAX package's five bench programs; port of
its `scripts/flops_model.py`.

    python -m diffusion_spacetime_attn_tpu_torch.scripts.flops_model                # counts, no card
    python -m diffusion_spacetime_attn_tpu_torch.scripts.flops_model --jobs 5       # one process each
    python -m diffusion_spacetime_attn_tpu_torch.scripts.flops_model --time dpm20_b8_final_fwd
    python -m diffusion_spacetime_attn_tpu_torch.scripts.flops_model --measured walls.json

Counts each program's matmul and convolution FLOPs with
`utils/flops.count_flops`, the backward and the per-step remat recompute
included, on the meta device: SD v1-4 at full width in bf16 with bf16
scores (JAX's programs), shapes only, no card and no arithmetic.  The
count runs on the kernels-off path and asserts that no kernel was launched
(the CUDA kernels compute the same function, but the counter cannot see
inside them, as JAX's cannot see inside `pallas_call`).  A program is the
sum of the decoded images of a CFG chain from x_T (batch B, 4 objects in
spacetime mode); an `epoch` program also takes its gradient with respect to
the [B, N, S] blend weights through the remat'd chain, as the method's
training epoch does.  The count follows `utils/flops.py`'s conventions, so
a gradient program counts less convolution work (strided convolutions'
input gradients) and more matmul work (each evaluation's recompute of the
context projections) than JAX's tool does; forward programs count the
same (`tests/test_torch_flops.py` holds both).

`--time NAME` runs that program on the card as a user runs it (the kernels
on: MHA and GEGLU in vanilla mode, the four kernels in spacetime mode; bf16;
one call first, then the median of `--iters` calls, each ending in
`torch.cuda.synchronize()`) and fails without a card.  `--measured FILE`
takes wall clocks taken on the card: {name: {"s_per_call": s,
"nvidia_smi": "<name>, <power limit>"}}.  TF/s and % of peak are computed
for the programs with a wall clock only, and read "not measured" for the
others.  The peak is one H100 SXM's 989 TF/s bf16 dense (NVIDIA's data
sheet, at 700 W), printed beside the card's name and power limit.

Writes `--out` (default `MFU_torch.json`) with the JAX artifact's keys and
prints a markdown table.
"""
from __future__ import annotations

import argparse
import json
import multiprocessing
import statistics
import subprocess
import sys
import time

H100_PEAK_TFS_BF16 = 989.0
NOT_MEASURED = "not measured"
# name: (mode, sampler, steps, batch, gradient through the chain)
PROGRAMS = {
    "vanilla_plms50_b8": ("vanilla", "plms", 50, 8, False),
    "dpm20_b8_epoch": ("spacetime", "dpm", 20, 8, True),
    "dpm20_b8_final_fwd": ("spacetime", "dpm", 20, 8, False),
    "plms50_b4_epoch": ("spacetime", "plms", 50, 4, True),
    "plms50_b4_final_fwd": ("spacetime", "plms", 50, 4, False),
}


def program_config(mode: str, steps: int, kernels: bool):
    """SD v1-4 in bf16 with bf16 scores; `kernels`: the user's flags (MHA
    and GEGLU in vanilla mode; flash, MHA, GEGLU and spacetime otherwise)."""
    from ..config import PipelineConfig, SpaceTimeConfig, UNetConfig, VAEConfig

    st = mode == "spacetime"
    return PipelineConfig(
        unet=UNetConfig(dtype="bfloat16", attn_scores_dtype="bfloat16",
                        use_flash=kernels and st, use_mha=kernels,
                        use_fused_ff=kernels, use_fused_control=kernels and st),
        vae=VAEConfig(dtype="bfloat16"),
        spacetime=SpaceTimeConfig(num_steps=steps))


def count(mode: str, sampler: str, steps: int, batch: int, grad: bool, cfg=None) -> dict:
    """count_flops of the program on the meta device (`cfg` in place of
    the SD-width config, whose schedule must have `steps` steps)."""
    import torch

    from ..pipeline.pipeline import StableDiffusion
    from ..utils.flops import count_flops
    from .profiler import make_program

    sd = StableDiffusion.create(cfg or program_config(mode, steps, kernels=False),
                                abstract=True)
    call = make_program(sd, mode, sampler, batch, grad)
    lat = sd.cfg.spacetime.latent_size
    x_T = torch.empty((batch, lat, lat, sd.cfg.unet.in_channels), device="meta")
    c = count_flops(call, x_T)
    if c["opaque_kernel_calls"] != 0:
        raise RuntimeError(f"{c['opaque_kernel_calls']} kernel launches under the count; "
                           "count on the kernels-off path")
    if c["dynamic_while_loops"] != 0:
        raise RuntimeError("a loop the count cannot see")
    return c


def count_program(name: str) -> dict:
    """count() of the named SD-width program, on one torch thread."""
    import torch

    torch.set_num_threads(1)
    return count(*PROGRAMS[name])


def time_program(name: str, iters: int) -> float:
    """Median seconds per call of program `name` on the card, kernels on."""
    import torch

    from ..pipeline.pipeline import StableDiffusion
    from .profiler import draw_x_T, make_program

    if not torch.cuda.is_available():
        raise RuntimeError("--time: no CUDA device; the wall clock is the card's")
    mode, sampler, steps, batch, grad = PROGRAMS[name]
    sd = StableDiffusion.create(program_config(mode, steps, kernels=True), seed=0, device="cuda")
    call = make_program(sd, mode, sampler, batch, grad)
    call(draw_x_T(sd, batch, 0))             # the kernels built, the allocator warm
    torch.cuda.synchronize()
    walls = []
    for i in range(iters):
        x_T = draw_x_T(sd, batch, i + 1)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        call(x_T)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    return statistics.median(walls)


def nvidia_smi() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()


def mfu_row(c: dict, measured) -> dict:
    """A program's artifact row from its count and its wall clock on the
    card ({"s_per_call", "nvidia_smi"}, or None)."""
    row = {"flops_per_call": c["total"], "matmul_flops": c["matmul"], "conv_flops": c["conv"],
           "pflops_per_call": round(c["total"] / 1e15, 3),
           "matmul_share": round(c["matmul"] / c["total"], 3),
           "conv_share": round(c["conv"] / c["total"], 3)}
    if measured is None:
        return {**row, "measured_s_per_call": None, "nvidia_smi": None,
                "tf_per_s": NOT_MEASURED, "mfu_pct_of_h100_bf16_peak": NOT_MEASURED}
    tfs = c["total"] / measured["s_per_call"] / 1e12
    return {**row, "measured_s_per_call": measured["s_per_call"],
            "nvidia_smi": measured["nvidia_smi"], "tf_per_s": round(tfs, 1),
            "mfu_pct_of_h100_bf16_peak": round(100 * tfs / H100_PEAK_TFS_BF16, 1)}


def method_line(rows: dict, prefix: str, batch: int) -> dict:
    """2 training epochs + 1 forward-only epoch per image."""
    ep, fw = rows[f"{prefix}_epoch"], rows[f"{prefix}_final_fwd"]
    total_fl = 2 * ep["flops_per_call"] + fw["flops_per_call"]
    line = {"pflops_per_optimized_image": round(total_fl / 1e15 / batch, 3)}
    if ep["measured_s_per_call"] is None or fw["measured_s_per_call"] is None:
        return {**line, "s_per_optimized_image": None, "tf_per_s": NOT_MEASURED,
                "mfu_pct_of_h100_bf16_peak": NOT_MEASURED}
    total_s = 2 * ep["measured_s_per_call"] + fw["measured_s_per_call"]
    tfs = total_fl / total_s / 1e12
    return {**line, "s_per_optimized_image": round(total_s / batch, 3),
            "tf_per_s": round(tfs, 1),
            "mfu_pct_of_h100_bf16_peak": round(100 * tfs / H100_PEAK_TFS_BF16, 1)}


def _fmt(v, spec: str) -> str:
    return NOT_MEASURED if v is None or isinstance(v, str) else format(v, spec)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default="MFU_torch.json")
    ap.add_argument("--measured", default=None,
                    help='JSON {name: {"s_per_call", "nvidia_smi"}} of card wall clocks')
    ap.add_argument("--time", default=None, choices=sorted(PROGRAMS),
                    help="time this program on the card (kernels on)")
    ap.add_argument("--iters", type=int, default=3, help="--time: timed calls (median)")
    ap.add_argument("--programs", default=",".join(PROGRAMS),
                    help="comma-separated programs to count")
    ap.add_argument("--jobs", type=int, default=1, help="processes counting side by side")
    args = ap.parse_args(argv)
    names = args.programs.split(",")
    unknown = sorted(set(names) - set(PROGRAMS))
    if unknown:
        raise ValueError(f"unknown programs {unknown}; known: {sorted(PROGRAMS)}")

    measured = {}
    if args.measured:
        with open(args.measured) as f:
            measured = json.load(f)
        for n, m in measured.items():
            if n not in PROGRAMS or not {"s_per_call", "nvidia_smi"} <= set(m):
                raise ValueError(f"--measured {n!r}: a program name with "
                                 f'{{"s_per_call", "nvidia_smi"}} expected')
    if args.time:
        measured[args.time] = {"s_per_call": time_program(args.time, args.iters),
                               "nvidia_smi": nvidia_smi()}
        print(f"timed {args.time} on {measured[args.time]['nvidia_smi']}: "
              f"{measured[args.time]['s_per_call']:.4f} s per call", file=sys.stderr)

    t0 = time.perf_counter()
    if args.jobs > 1:
        with multiprocessing.get_context("spawn").Pool(min(args.jobs, len(names))) as pool:
            counts = dict(zip(names, pool.map(count_program, names)))
    else:
        counts = {n: count_program(n) for n in names}
    count_s = time.perf_counter() - t0
    rows = {n: mfu_row(counts[n], measured.get(n)) for n in names}
    for n, r in rows.items():
        print(f"{n}: {r}", file=sys.stderr)
    method = {f"{p}_3ep": method_line(rows, p, b)
              for p, b in (("dpm20_b8", 8), ("plms50_b4", 4))
              if f"{p}_epoch" in rows and f"{p}_final_fwd" in rows}
    artifact = {
        "peak_tfs": {"h100_sxm_bf16_dense": H100_PEAK_TFS_BF16},
        "definition": "matmul + conv FLOPs as PyTorch runs them (incl. backward and each "
                      "evaluation's remat recompute) / wall clock on the card; elementwise "
                      "excluded",
        "count_device": "meta", "count_s": count_s,
        "programs": rows,
        "method_total": method,
    }
    with open(args.out, "w") as f:
        json.dump(artifact, f, indent=2)

    print("\n| program | PFLOPs/call | matmul:conv | s/call | TF/s | MFU (H100 bf16, 989 TF/s) "
          "| card |")
    print("|---|---|---|---|---|---|---|")
    for n, r in rows.items():
        print(f"| {n} | {r['pflops_per_call']} | {r['matmul_share']:.0%}:{r['conv_share']:.0%} | "
              f"{_fmt(r['measured_s_per_call'], '.4f')} | {r['tf_per_s']} | "
              f"{r['mfu_pct_of_h100_bf16_peak']} | {r['nvidia_smi'] or NOT_MEASURED} |")
    for n, r in method.items():
        print(f"| {n} (whole method) | {r['pflops_per_optimized_image']} /img | — | "
              f"{_fmt(r['s_per_optimized_image'], '.4f')} /img | {r['tf_per_s']} | "
              f"{r['mfu_pct_of_h100_bf16_peak']} | |")
    print(f"\nwrote {args.out}")
    return artifact


if __name__ == "__main__":
    main()
