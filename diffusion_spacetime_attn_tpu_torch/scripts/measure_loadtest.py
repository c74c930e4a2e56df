"""The open-loop load test as a measurement: the engine of `scripts/serve.py`
(built from the same flags), every batch's rows and wall time recorded,
capacity from more warm batches than `serve --loadtest` takes, and the
ramp run `--repeats` times in one process.

    python -m diffusion_spacetime_attn_tpu_torch.scripts.measure_loadtest \\
        --mode vanilla --batch 2 --requests 60 --capacity-batches 8 --repeats 2 \\
        --out chiprun_out/loadtest_measure.json
    python -m diffusion_spacetime_attn_tpu_torch.scripts.measure_loadtest \\
        --tiny --cpu --batch 2 --requests 4 --capacity-batches 3 --repeats 1

Flags other than this script's own go to `scripts/serve.py`.  Per ramp it
prints one JSON line: `run_loadtest`'s artifact (JAX's keys), the capacity
batches' wall times, and per stage the batches it ran, their median wall
time, the stage's load, offered rate × median batch time / batch size
(the fraction of its own full-batch service rate the stage was offered),
and its busy share, offered rate × Σ batch time / Σ rows (the share of
the arrival window the worker spent in batches; above the load where
batches run short of rows).  A stage's nominal fraction is of the
capacity batches' speed; the host's speed drifts between those batches
and a stage, and the load says where the stage really stood.  Requests
carry no timeout (`--request-timeout` is not passed on), so every
accepted request reaches the engine and the stages' batches follow each
other in order.
The last line is the summary over the ramps: per stage, the latencies of
all ramps pooled, their count, median and the highest whole percentile
that leaves at least ten samples above it (`tail_percentile`; p95 and p99
of a few dozen samples are their largest values); `nvidia-smi`'s name and
power limit of the card go on a line before it.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import time

import numpy as np

from ..serving.loadtest import run_loadtest
from . import serve


class TimedEngine:
    """An engine whose batches record (rows, wall seconds); the engine
    returns host numpy, so the card has finished when the clock is read."""

    def __init__(self, engine):
        self.engine, self.batch_size, self.rows = engine, engine.batch_size, []

    def generate_batch(self, prompts, seeds):
        t0 = time.perf_counter()
        out = self.engine.generate_batch(prompts, seeds)
        self.rows.append((len(prompts), time.perf_counter() - t0))
        return out


def stage_batches(rows, capacity_batches: int, stages):
    """Split a ramp's (rows, seconds) batches into the capacity batches and
    each stage's, by the rows each stage completed (no request expires)."""
    out, i = [], capacity_batches
    for st in stages:
        served, mine = 0, []
        while served < st["completed"] and i < len(rows):
            served += rows[i][0]
            mine.append(rows[i])
            i += 1
        if served != st["completed"]:
            raise RuntimeError(f"stage {st['capacity_fraction']}: {served} rows batched, "
                               f"{st['completed']} completed")
        out.append(mine)
    if i != len(rows):
        raise RuntimeError(f"{len(rows) - i} batches belong to no stage")
    return rows[:capacity_batches], out


def ramp_record(art: dict, rows, capacity_batches: int) -> dict:
    cap_rows, per_stage = stage_batches(rows, capacity_batches, art["stages"])
    cap_s = [t for _, t in cap_rows]
    B = art["batch_size"]
    stages = []
    for st, mine in zip(art["stages"], per_stage):
        med = statistics.median(t for _, t in mine) if mine else None
        stages.append({"capacity_fraction": st["capacity_fraction"],
                       "offered_req_per_s": st["offered_req_per_s"],
                       "batches": len(mine), "rows": [n for n, _ in mine],
                       "batch_s": [t for _, t in mine], "median_batch_s": med,
                       "load": st["offered_req_per_s"] * med / B if med else None,
                       "busy": (st["offered_req_per_s"] * sum(t for _, t in mine)
                                / sum(n for n, _ in mine)) if mine else None})
    return {"capacity_batch_s": cap_s,
            "capacity_median_req_per_s": B / statistics.median(cap_s),
            "stage_batches": stages, "artifact": art}


def tail(latencies) -> dict:
    """n, median and the highest whole percentile with >= 10 samples above
    it (None below 11 samples)."""
    lat = np.sort(np.asarray(latencies, np.float64))
    n = lat.size
    q = int(np.floor(100.0 * (n - 10) / n)) if n > 10 else None
    return {"n": n, "median_s": float(np.median(lat)) if n else None,
            "tail_percentile": q,
            "tail_s": float(np.percentile(lat, q)) if q is not None else None}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--requests", type=int, default=48, help="requests per stage")
    ap.add_argument("--fractions", default="0.5,0.8,1.0,1.3",
                    help="offered rates as fractions of the measured capacity")
    ap.add_argument("--capacity-batches", type=int, default=8,
                    help="warm batches whose best sets the capacity")
    ap.add_argument("--repeats", type=int, default=2, help="ramps, one after another")
    ap.add_argument("--out", default=None, help="also write the records here")
    own, rest = ap.parse_known_args(argv)
    args = serve.parse_args(rest)
    engine, params_dtype = serve.build_engine(args)
    warm_s = engine.warmup()
    smi = None
    if not args.cpu:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True).stdout.strip()
    fractions = tuple(float(x) for x in own.fractions.split(","))
    ramps, latencies = [], [[] for _ in fractions]
    for r in range(own.repeats):
        timed, results = TimedEngine(engine), []
        t0 = time.perf_counter()
        art = run_loadtest(timed, capacity_fractions=fractions, stage_requests=own.requests,
                           max_wait_s=args.max_wait, max_queue=args.max_queue,
                           capacity_repeats=own.capacity_batches, stage_results=results)
        for pooled, res in zip(latencies, results):
            pooled += res.latencies_s
        rec = {"ramp": r, "seconds": time.perf_counter() - t0,
               **ramp_record(art, timed.rows, own.capacity_batches)}
        print(json.dumps(rec), flush=True)
        ramps.append(rec)
    summary = {"mode": args.mode, "batch_size": args.batch, "steps": args.steps,
               "sampler": args.sampler, "params_dtype": params_dtype,
               "requests_per_stage": own.requests, "capacity_batches": own.capacity_batches,
               "warmup_s": warm_s, "nvidia_smi": smi,
               "capacity_req_per_s": [rec["artifact"]["capacity_req_per_s"] for rec in ramps],
               "per_stage": [
                   {"capacity_fraction": f, **tail(latencies[i]),
                    "p50_s": [rec["artifact"]["stages"][i]["latency_s"]["p50"] for rec in ramps],
                    "rejected": [rec["artifact"]["stages"][i]["rejected"] for rec in ramps],
                    "load": [rec["stage_batches"][i]["load"] for rec in ramps],
                    "busy": [rec["stage_batches"][i]["busy"] for rec in ramps],
                    "mean_rows": [statistics.mean(rec["stage_batches"][i]["rows"] or [0])
                                  for rec in ramps]}
                   for i, f in enumerate(fractions)]}
    if own.out:
        os.makedirs(os.path.dirname(own.out) or ".", exist_ok=True)
        with open(own.out, "w") as f:
            json.dump({"summary": summary, "ramps": ramps}, f, indent=1)
    if smi is not None:
        print(smi, flush=True)
    print(json.dumps(summary), flush=True)
    return summary


if __name__ == "__main__":
    main()
