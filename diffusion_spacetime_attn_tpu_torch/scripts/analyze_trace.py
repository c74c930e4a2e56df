"""Aggregate a torch.profiler Chrome trace into a per-kernel device-time
table; port of the JAX package's `scripts/analyze_trace.py`, with its flags
but `--hlo`.

Companion to `scripts/profiler.py`, which captures the trace.  Keeps the
device events only, the complete events ('ph' == 'X') whose `cat` is
`kernel`, `gpu_memcpy` or `gpu_memset`: the CPU side (`cpu_op`,
`cuda_runtime`, `python_function`) and the `record_function` ranges
(`user_annotation`, `gpu_user_annotation`), which cover their children's
time as JAX's `while.*` containers do, are dropped.  Names merge their
templated and suffixed clones (`strip_suffix`: `void
ns::kernel<40, ...>(args)` and `kernel<80>` are one `ns::kernel` row;
`--raw` keeps them apart).  Prints total ms, count and share per row, the
device total, per-step ms with `--per-step`, and the family of each row
(`utils/profiling.kernel_family`).

    python -m diffusion_spacetime_attn_tpu_torch.scripts.profiler --mode vanilla --iters 2
    python -m diffusion_spacetime_attn_tpu_torch.scripts.analyze_trace          # newest trace
    python -m diffusion_spacetime_attn_tpu_torch.scripts.analyze_trace --per-step 50 --iters 2 --json

`--hlo` has no counterpart (the port runs no XLA program) and raises.
"""
from __future__ import annotations

import argparse
import collections
import glob
import gzip
import json
import os
import re
import sys

from ..utils.profiling import kernel_family

DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")


def find_trace_files(trace_dir):
    pats = [
        os.path.join(trace_dir, "**", "*.trace.json.gz"),
        os.path.join(trace_dir, "**", "*.trace.json"),
    ]
    files = []
    for p in pats:
        files.extend(glob.glob(p, recursive=True))
    return sorted(files, key=os.path.getmtime)


def load_events(path):
    op = gzip.open if path.endswith(".gz") else open
    with op(path, "rt") as f:
        return json.load(f).get("traceEvents", [])


def device_leaf_durations(events):
    """Sum the duration (µs) and count per name of the device events."""
    totals = collections.Counter()
    counts = collections.Counter()
    for e in events:
        if e.get("ph") != "X" or e.get("cat") not in DEVICE_CATEGORIES:
            continue
        name = e.get("name", "")
        totals[name] += e.get("dur", 0)
        counts[name] += 1
    return totals, counts


def _drop_groups(name: str, open_ch: str, close_ch: str) -> str:
    """`name` without its balanced open_ch ... close_ch groups."""
    out, depth = [], 0
    for ch in name:
        if ch == open_ch:
            depth += 1
        elif ch == close_ch and depth:
            depth -= 1
        elif depth == 0:
            out.append(ch)
    return "".join(out)


def strip_suffix(name):
    """One row for a kernel's clones: the return type, the argument list and
    the template arguments dropped, and a numeric suffix as JAX's
    `strip_suffix` drops it (`Memcpy` and `Memset` rows stay whole)."""
    if name.startswith(("Memcpy", "Memset")):
        return name
    s = name.replace("(anonymous namespace)::", "")
    if s.endswith(")"):
        depth = 0
        for i in range(len(s) - 1, -1, -1):
            depth += {")": 1, "(": -1}.get(s[i], 0)
            if depth == 0:
                s = s[:i]
                break
    s = _drop_groups(s, "<", ">").strip()
    s = re.sub(r"^void ", "", s)
    return re.sub(r"[.\d]+$", "", s) or name


def table(events, raw: bool = False):
    """(totals µs, counts) per row of the device events."""
    totals, counts = device_leaf_durations(events)
    if raw:
        return totals, counts
    merged_t, merged_c = collections.Counter(), collections.Counter()
    for name, dur in totals.items():
        merged_t[strip_suffix(name)] += dur
        merged_c[strip_suffix(name)] += counts[name]
    return merged_t, merged_c


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--trace-dir", default="/tmp/dsta_trace")
    ap.add_argument("--top", type=int, default=30)
    ap.add_argument("--raw", action="store_true",
                    help="don't merge templated / suffixed clones")
    ap.add_argument("--per-step", type=int, default=0,
                    help="sampler steps represented in the trace; also "
                         "prints per-step ms (divide by iters*steps)")
    ap.add_argument("--iters", type=int, default=2,
                    help="traced iterations (for --per-step normalization)")
    ap.add_argument("--json", action="store_true", help="machine-readable")
    ap.add_argument("--hlo", default=None, help="no counterpart here: raises")
    args = ap.parse_args(argv)
    if args.hlo:
        raise NotImplementedError("--hlo: the port runs no XLA program; the trace's kernel "
                                  "names are the source-level attribution")

    files = find_trace_files(args.trace_dir)
    if not files:
        sys.exit(f"no trace files under {args.trace_dir} — run "
                 f"scripts/profiler.py first")
    totals, counts = table(load_events(files[-1]), args.raw)
    if not totals:
        sys.exit("no device events found in the trace")

    grand = sum(totals.values())
    rows = totals.most_common(args.top)
    if args.json:
        print(json.dumps([
            {"op": n, "family": kernel_family(n), "total_ms": t / 1e3, "count": counts[n],
             "share": t / grand} for n, t in rows]))
        return
    print(f"# trace: {files[-1]}")
    print(f"# total device time: {grand / 1e3:.1f} ms")
    w = 48
    hdr = f"{'op':<{w}} {'family':<16} {'total ms':>9} {'count':>6} {'share':>6}"
    if args.per_step:
        hdr += f" {'ms/step':>8}"
    print(hdr)
    for name, dur in rows:
        line = (f"{name[:w]:<{w}} {kernel_family(name):<16} {dur / 1e3:>9.2f} "
                f"{counts[name]:>6} {100 * dur / grand:>5.1f}%")
        if args.per_step:
            line += f" {dur / 1e3 / (args.per_step * args.iters):>8.3f}"
        print(line)


if __name__ == "__main__":
    main()
