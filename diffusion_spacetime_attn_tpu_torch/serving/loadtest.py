"""Open-loop load test of the BatchingService: tail latency and saturation;
port of the JAX package's `serving/loadtest.py`, the same artifact keys.

`run_loadtest` drives a service with an open-loop arrival process (a thread
submits at a fixed rate whatever completes: independent clients; a
closed-loop soak such as `scripts/serve.py --soak` understates queueing)
over a ramp of rates given as fractions of the engine's measured
single-batch capacity.  Per stage it reports p50/p95/p99 latency (recorded
when each future resolves), the queue-depth trace, rejects and timeouts;
the summary names the saturation rate, the first stage that rejects, times
out, or whose p99 exceeds the queue-time budget.
"""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

from .server import BatchingService, ServiceSaturated

PROMPTS = [
    "a cat above a dog",
    "a bird to the left of a car",
    "an apple on top of a laptop",
    "a clock above a bed",
    "a dog to the right of a horse",
    "a vase next to a book",
]


@dataclass
class StageResult:
    offered_req_per_s: float
    capacity_fraction: float
    submitted: int = 0
    completed: int = 0
    rejected: int = 0
    timed_out: int = 0
    latencies_s: List[float] = field(default_factory=list)
    queue_depth_trace: List[int] = field(default_factory=list)

    def summary(self) -> dict:
        lat = np.asarray(self.latencies_s, np.float64)
        q = np.asarray(self.queue_depth_trace, np.int64)

        def pct(p):
            return round(float(np.percentile(lat, p)), 3) if lat.size else None

        return {
            "offered_req_per_s": round(self.offered_req_per_s, 4),
            "capacity_fraction": round(self.capacity_fraction, 3),
            "submitted": self.submitted,
            "completed": self.completed,
            "rejected": self.rejected,
            "timed_out": self.timed_out,
            "latency_s": {"p50": pct(50), "p95": pct(95), "p99": pct(99),
                          "mean": round(float(lat.mean()), 3) if lat.size else None,
                          "max": round(float(lat.max()), 3) if lat.size else None},
            "queue_depth": {"mean": round(float(q.mean()), 2) if q.size else 0.0,
                            "max": int(q.max()) if q.size else 0},
        }


def _measure_capacity(engine, repeats: int = 2) -> float:
    """Warm single-batch wall clock -> req/s capacity of the engine loop.
    `generate_batch` returns host numpy, so each batch has finished on the
    card when the clock is read."""
    prompts = [PROMPTS[i % len(PROMPTS)] for i in range(engine.batch_size)]
    seeds = list(range(1, engine.batch_size + 1))
    best = float("inf")
    for _ in range(max(repeats, 1)):
        t0 = time.perf_counter()
        engine.generate_batch(prompts, seeds)
        best = min(best, time.perf_counter() - t0)
    return engine.batch_size / best


def run_loadtest(
    engine,
    capacity_fractions=(0.5, 0.8, 1.0, 1.3),
    stage_requests: int = 24,
    max_wait_s: float = 0.2,
    max_queue: Optional[int] = None,
    request_timeout_s: Optional[float] = None,
    depth_sample_s: float = 0.25,
    capacity_req_per_s: Optional[float] = None,
    drain_timeout_s: float = 600.0,
    capacity_repeats: int = 2,
    stage_results: Optional[list] = None,
) -> dict:
    """-> the artifact (stages and the saturation rate).  Each stage gets a
    fresh BatchingService, so no queue state leaks across rates.  Capacity,
    unless given, is the best of `capacity_repeats` warm batches (2, as the
    JAX package takes).  `stage_results`, a list, also receives each
    stage's StageResult (its latencies one by one)."""
    cap = capacity_req_per_s or _measure_capacity(engine, capacity_repeats)
    stages: List[StageResult] = []
    for frac in capacity_fractions:
        rate = cap * frac
        res = StageResult(offered_req_per_s=rate, capacity_fraction=frac)
        svc = BatchingService(engine, max_wait_s=max_wait_s, max_queue=max_queue,
                              request_timeout_s=request_timeout_s).start()
        lock = threading.Lock()
        pending = []                    # accepted futures, for the drain barrier
        stop_monitor = threading.Event()

        def on_done(fut, t0, res=res, lock=lock):
            # latency at resolution (the worker thread), not in the drain
            # loop below, which runs after every submission
            dt = time.perf_counter() - t0
            with lock:
                if fut.exception() is None:
                    res.latencies_s.append(dt)
                    res.completed += 1
                else:
                    res.timed_out += 1

        def monitor(svc=svc, res=res, stop=stop_monitor):
            while not stop.is_set():
                res.queue_depth_trace.append(svc.queue_depth())
                stop.wait(depth_sample_s)

        mon = threading.Thread(target=monitor, daemon=True)
        mon.start()
        interval = 1.0 / rate
        next_t = time.perf_counter()
        for i in range(stage_requests):
            now = time.perf_counter()
            if now < next_t:
                time.sleep(next_t - now)
            next_t += interval          # open loop: the schedule is absolute
            res.submitted += 1
            t0 = time.perf_counter()
            try:
                fut = svc.submit(PROMPTS[i % len(PROMPTS)], seed=1000 + i)
            except ServiceSaturated:
                res.rejected += 1
                continue
            fut.add_done_callback(lambda f, t0=t0: on_done(f, t0))
            pending.append(fut)
        # drain barrier: every accepted request resolves (on_done counted it)
        deadline = time.time() + drain_timeout_s
        for fut in pending:
            try:
                fut.result(timeout=max(deadline - time.time(), 0.001))
            except Exception:
                if not fut.done():      # the drain budget ran out first
                    with lock:
                        res.timed_out += 1
        stop_monitor.set()
        mon.join(timeout=2)
        svc.stop()
        stages.append(res)
    if stage_results is not None:
        stage_results.extend(stages)

    budget = request_timeout_s or float("inf")
    saturation = None
    for res in stages:
        s = res.summary()
        p99 = s["latency_s"]["p99"]
        if res.rejected > 0 or res.timed_out > 0 or (p99 is not None and p99 > budget):
            saturation = s["offered_req_per_s"]
            break
    return {
        "capacity_req_per_s": round(cap, 4),
        "stage_requests": stage_requests,
        "batch_size": engine.batch_size,
        "max_wait_s": max_wait_s,
        "max_queue": max_queue if max_queue is not None else 8 * engine.batch_size,
        "request_timeout_s": request_timeout_s,
        "stages": [r.summary() for r in stages],
        "saturation_req_per_s": saturation,
    }
