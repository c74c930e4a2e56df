#!/usr/bin/env python3
"""On-card timings of the bf16 spacetime kernels' design choices.

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_spacetime_variants.py

The wgmma spacetime forward and dq pass (`csrc/spacetime_fwd.cu`,
`csrc/spacetime_bwd.cu`) choose their block shape from the grid size
(`dsta::spacetime_wide` in `csrc/common.cuh`: 128-query blocks where
64-query blocks would exceed one wave) and run the forward two blocks per
SM at head widths up to 64.  This script measures each choice against its
alternatives: it copies the package into `_archive/variants/<name>/` (a
directory `.gitignore` lists), applies one source edit per variant, and in
a fresh process per variant builds the kernels, reports ptxas spills of the
spacetime wgmma kernels, holds both kernels against their plain versions at
the four SD v1-4 sites (2 prompts, 8 heads, 4 objects, 77 keys, bf16;
`utils/testing.py` `compare`) and prints their device time per call
(CUPTI durations under torch.profiler, 20 calls).  Variants:

  as_built              the tree as it is
  blocks_64             64-query blocks at every site
  blocks_128            128-query blocks at every site
  fwd_one_block_per_sm  the forward at one block per SM at every width
  dq_two_blocks_per_sm  the dq pass at two blocks per SM at dh <= 64
                        (consumers at 104 registers, rings of 3-4 stages)

Prints one JSON object per line (the card's name and power limit first)
and exits non-zero if any variant fails to build or to match.
"""
from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

PACKAGE = "diffusion_spacetime_attn_tpu_torch"
CSRC = f"{PACKAGE}/csrc"

# variant -> [(source file, text, replacement)], each text present once
VARIANTS = {
    "as_built": [],
    "blocks_64": [(f"{CSRC}/common.cuh",
                   "  return (long)((Lq + 63) / 64) * H * B > (long)sms;",
                   "  return false;")],
    "blocks_128": [(f"{CSRC}/common.cuh",
                    "  return (long)((Lq + 63) / 64) * H * B > (long)sms;",
                    "  return true;")],
    "fwd_one_block_per_sm": [(f"{CSRC}/spacetime_fwd.cu",
                              "  static constexpr int BLOCKS = NB == 1 ? 2 : 1;",
                              "  static constexpr int BLOCKS = 1;")],
    "dq_two_blocks_per_sm": [
        (f"{CSRC}/spacetime_bwd.cu",
         "  static constexpr int STAGES = NB == 1 ? 5 : NB == 2 ? (WIDE ? 3 : 4) : 2;",
         "  static constexpr int STAGES = NB == 1 ? (WIDE ? 3 : 4) : NB == 2 ? (WIDE ? 3 : 4) : 2;\n"
         "  static constexpr int BLOCKS = NB == 1 ? 2 : 1;\n"
         "  static constexpr int CONSUMER_REGS = BLOCKS == 2 ? 104 : 240;"),
        (f"{CSRC}/spacetime_bwd.cu",
         "template <int DN, bool WIDE>\n__global__ void __launch_bounds__(WG_THREADS, 1)",
         "template <int DN, bool WIDE>\n"
         "__global__ void __launch_bounds__(WG_THREADS, DqWgmma<DN, WIDE>::BLOCKS)"),
        (f"{CSRC}/spacetime_bwd.cu", "    hop::reg_alloc<240>();",
         "    hop::reg_alloc<C::CONSUMER_REGS>();"),
    ],
}

# one variant's measurement, run in the variant's own tree (its own build)
CHILD = r'''
import json, sys
import torch
from torch.profiler import ProfilerActivity, profile
sys.path.insert(0, ".")
from diffusion_spacetime_attn_tpu_torch.ops import cuda_lib, cuda_spacetime as cs
from diffusion_spacetime_attn_tpu_torch.ops.masks import flat_circular_mask
from diffusion_spacetime_attn_tpu_torch.utils.testing import compare

name = sys.argv[1]
info = cuda_lib.build()
entry, spills = None, []
for ln in info["ptxas"].splitlines():
    if "Compiling entry" in ln:
        entry = ln
    elif entry and "spacetime" in entry and "wgmma" in entry and "spill" in ln \
            and "0 bytes spill stores, 0 bytes spill loads" not in ln:
        spills.append(ln.strip())
print(json.dumps({"variant": name, "build_s": info["seconds"], "spills": spills}), flush=True)


def device_us(fn, match, n=20):
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in prof.key_averages() if match in e.key) / n


ok = True
gen = torch.Generator(device="cuda")
for site, Lq, inner in (("level0", 4096, 320), ("level1", 1024, 640), ("level2", 256, 1280),
                        ("mid", 64, 1280)):
    gen.manual_seed(Lq + inner)
    B, N, H = 2, 4, 8

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)

    ins = (randn(B, Lq, inner), randn(B, Lq, inner), randn(B, 77, inner), randn(B, 77, inner),
           randn(B, N, 77, inner), randn(B, N, 77, inner))
    dim = int(round(Lq ** 0.5))
    masks = flat_circular_mask(torch.rand((B, N, 2), generator=gen, device="cuda"), dim, 0.2)
    args = ins + (masks, torch.full((B, N), 1.25, device="cuda"))
    g = randn(B, Lq, inner)
    out = cs.fused_spacetime_attention(*args, H)
    bwd = cs.spacetime_bwd(*args, H, g, need_kv=False)
    want = cs.spacetime_bwd_plain(*args, H, g)
    torch.cuda.synchronize()
    cmp = [compare(out, cs.spacetime_plain(*args, H), "spacetime"),
           compare(bwd[0], want[0], "spacetime_bwd"), compare(bwd[7], want[7], "spacetime_bwd")]
    same = all(torch.equal(out, cs.fused_spacetime_attention(*args, H)) for _ in range(3))
    ok = ok and same and all(c["ok"] for c in cmp)
    print(json.dumps({"variant": name, "site": site, "ok": all(c["ok"] for c in cmp),
                      "repeat_equal": same,
                      "fwd_us": device_us(lambda: cs.fused_spacetime_attention(*args, H),
                                          "spacetime_fwd_wgmma"),
                      "dq_us": device_us(lambda: cs.spacetime_bwd_raw(*args, H, g, need_kv=False),
                                         "spacetime_bwd_dq_wgmma")}), flush=True)
sys.exit(0 if ok else 1)
'''


def make_tree(root: str, name: str, edits) -> str:
    """A copy of the package under _archive/variants/<name> with `edits`."""
    tree = os.path.join(root, "_archive", "variants", name)
    shutil.rmtree(tree, ignore_errors=True)
    shutil.copytree(os.path.join(root, PACKAGE), os.path.join(tree, PACKAGE),
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    for rel, text, repl in edits:
        path = os.path.join(tree, rel)
        src = open(path).read()
        if src.count(text) != 1:
            raise RuntimeError(f"{name}: the edit of {rel} does not apply: {text!r}")
        with open(path, "w") as f:
            f.write(src.replace(text, repl))
    return tree


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the variants run on the card")
    root = os.path.dirname(os.path.abspath(__file__))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(json.dumps({"device": torch.cuda.get_device_name(0), "nvidia_smi": smi}), flush=True)
    failed = []
    for name, edits in VARIANTS.items():
        tree = make_tree(root, name, edits)
        run = subprocess.run([sys.executable, "-c", CHILD, name], cwd=tree, text=True,
                             stdout=subprocess.PIPE, stderr=subprocess.PIPE, timeout=600)
        print(run.stdout, end="", flush=True)
        if run.returncode != 0:
            failed.append(name)
            print(run.stderr[-3000:], file=sys.stderr, flush=True)
    print(json.dumps({"variants": list(VARIANTS), "failed": failed}), flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
