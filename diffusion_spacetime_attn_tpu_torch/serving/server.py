"""Serving, port of the JAX package's `serving/server.py`: the engines
`TextToImageEngine` (spatial control at fixed weights) and `SpaceTimeEngine`
(the paper's full method: per-request temporal weight optimization), the
dynamic batcher `BatchingService` and the HTTP front `serve`.

An engine runs a fixed batch size: tokenize -> encode -> sample -> decode,
padding a short batch with empty prompts.  With `prepare_host` (prompt ->
{"centers", "active", "local_texts"} or None, e.g.
`PromptRunner.prepare_host`) `TextToImageEngine` runs with the paper's
spatial attention control at fixed per-object weights
`active·init_coef / max(Σ active, 1)` for every step; pad rows and prompts
whose host stage fails get inactive control, which is an exact no-op.

Per-request noise is JAX's: `normal(PRNGKey(uint32(seed)), (latent,
latent, in_ch))`, drawn on the host by `utils/prng.py` (key (0, seed mod
2³²), pad rows seed 0) and moved to the engine's device, so the same
(prompt, seed) starts from the same x_T in both packages and a request's
noise does not depend on its batch position.  Its image does not either in
float32; in bfloat16 the card's matrix products and convolutions round a
row differently in another batch slot (about one bf16 ulp on a third of a
UNet evaluation's outputs, `chip_smoke.py` phase slot), so an image repeats
bit for bit at the same slot only.  With `watermark` set, each uint8 row
gets `utils/watermark.embed_watermark` after the batch.

`BatchingService` is threads and a bounded `queue.Queue`: `submit` returns a
Future, one worker thread drains up to `batch_size` requests (waiting up to
`max_wait_s` to fill a batch) and runs them as one engine call, so on the
card the worker is the only thread that touches CUDA.  `serve` is the
standard library's ThreadingHTTPServer: POST /txt2img, GET /healthz.  Images
go out as PNG from `utils/png.encode_png`; the JAX front falls back to
`np.save` bytes where PIL is missing, the port always has its own encoder.

With `mesh` (a `parallel.mesh.Mesh`; JAX `server.py:58,119-138,238-305`)
an engine splits its batch over the data axis: `generate_batch` is a
collective, every rank calls it with the same prompts and seeds, builds the
same padded batch on the host, computes the rows of its data coordinate and
gets every data coordinate's images gathered in row order.  The batch size
must divide by the data axis.  Over the model axis `TextToImageEngine`
replicates (every model rank computes its data group's rows whole, JAX
`server.py:119-128`), and `SpaceTimeEngine` runs the UNet, the text tower
and the loss CLIP tensor-parallel: it shards them in place
(`parallel/sharding.shard_params`) when it is built, unless the caller did
(JAX's engine serves with parameters the caller sharded,
`server.py:238-240`).  `BatchingService` and `serve` stay one-process, as
in JAX, where no entry point serves over a mesh.
"""
from __future__ import annotations

import base64
import json
import queue
import threading
import time
from concurrent.futures import Future
from concurrent.futures import TimeoutError as _FuturesTimeout
from dataclasses import dataclass, field
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from ..ops.attention import SpatialControl
from ..parallel.mesh import check_mesh, gather_rows, rows, shard_batch
from ..utils import prng
from ..utils.cudnn import deterministic
from ..utils.png import encode_png
from ..utils.watermark import embed_watermark


def engine_noise(seeds: Sequence[int], latent: int, in_ch: int,
                 device: torch.device) -> torch.Tensor:
    """x_T [len(seeds), latent, latent, in_ch] as the JAX package's engines
    draw it, one key per request (`prng.engine_key`)."""
    noise = [prng.normal(prng.engine_key(s), (latent, latent, in_ch)) for s in seeds]
    return torch.from_numpy(np.stack(noise)).to(device)


def _watermarked(imgs: np.ndarray, message: Optional[str]) -> np.ndarray:
    if not message:
        return imgs
    return np.stack([embed_watermark(im, message) for im in imgs])


def _check_mesh(engine) -> None:
    engine.mesh = check_mesh(engine.mesh, type(engine).__name__)
    if engine.mesh is not None and engine.batch_size % engine.mesh.data:
        raise ValueError(f"batch_size {engine.batch_size} not divisible by the mesh data axis "
                         f"({engine.mesh.data})")


def _warmup(engine) -> float:
    """One full batch (the first launch of each kernel builds or loads it);
    returns the seconds.  The batch ends in a copy to the host, which waits
    for the card."""
    t0 = time.perf_counter()
    engine.generate_batch([""], [0])
    return time.perf_counter() - t0


@dataclass
class TextToImageEngine:
    sd: object                                  # pipeline.StableDiffusion
    tokenize: Callable[[str], Sequence[int]]    # text -> fixed-length ids
    batch_size: int = 8
    sampler: str = "plms"
    guidance_scale: Optional[float] = None
    watermark: Optional[str] = None             # payload string or None
    prepare_host: Optional[Callable] = None     # prompt -> dict | None (spatial)
    init_coef: Optional[float] = None           # default: cfg.spacetime.init_coef
    mesh: Optional[object] = None               # parallel.mesh.Mesh: split the batch
    _uncond_ids: np.ndarray = field(default=None, repr=False)

    def __post_init__(self):
        _check_mesh(self)
        self._uncond_ids = np.asarray(self.tokenize(""), np.int32)

    def warmup(self) -> float:
        return _warmup(self)

    def _hosts(self, prompts: List[str]):
        """Host stage per prompt: centers, active flags, local-context ids."""
        N = self.sd.cfg.spacetime.max_objects
        L = self._uncond_ids.shape[0]
        local_ids = np.tile(self._uncond_ids, (len(prompts), N, 1))
        centers = np.zeros((len(prompts), N, 2), np.float32)
        active = np.zeros((len(prompts), N), np.float32)
        for i, p in enumerate(prompts):
            h = self.prepare_host(p)
            if h is None:
                continue
            centers[i], active[i] = h["centers"], h["active"]
            for j, t in enumerate(h["local_texts"][:N]):
                if t:
                    local_ids[i, j] = np.asarray(self.tokenize(t), np.int32)[:L]
        return local_ids, centers, active

    @torch.inference_mode()
    def _run(self, token_ids: np.ndarray, seeds: np.ndarray, local_ids=None,
             centers=None, active=None) -> torch.Tensor:
        """The images of the padded batch; with a mesh this rank computes
        its rows and every rank's are gathered."""
        if self.mesh is not None:
            mine = rows(self.mesh, len(seeds))
            token_ids, seeds = token_ids[mine], list(seeds)[mine]
            if local_ids is not None:
                local_ids, centers, active = local_ids[mine], centers[mine], active[mine]
            return gather_rows(self.mesh, self._rows(token_ids, seeds, local_ids, centers,
                                                     active))
        return self._rows(token_ids, seeds, local_ids, centers, active)

    def _rows(self, token_ids: np.ndarray, seeds, local_ids=None, centers=None,
              active=None) -> torch.Tensor:
        sd = self.sd
        cfg, dev = sd.cfg, sd.device
        B, N, S = token_ids.shape[0], cfg.spacetime.max_objects, sd.schedule.num_steps
        if self.prepare_host is not None:
            # one encoder call for captions + all local contexts
            emb = sd.encode_text(np.concatenate([token_ids, local_ids.reshape(B * N, -1)]))
            cond, locals_ = emb[:B], emb[B:].reshape(B, N, *emb.shape[1:])
            act = torch.as_tensor(active, device=dev)
            init = cfg.spacetime.init_coef if self.init_coef is None else self.init_coef
            coef = act * (init / torch.clamp(act.sum(-1, keepdim=True), min=1.0))
            control = SpatialControl(local_contexts=locals_,
                                     centers=torch.as_tensor(centers, device=dev),
                                     coef=coef, active=act)
            coef_schedule = coef[..., None].expand(B, N, S)
        else:
            cond = sd.encode_text(token_ids)
            control, coef_schedule = None, None
        uncond = sd.encode_text(np.tile(self._uncond_ids, (B, 1)))
        gs = cfg.spacetime.guidance_scale if self.guidance_scale is None else self.guidance_scale
        eps_fn = sd.make_eps_fn(cond, uncond, gs, control, coef_schedule)
        x_T = engine_noise(seeds, cfg.spacetime.latent_size, cfg.unet.in_channels, dev)
        z = sd.sample_from(eps_fn, x_T, sampler=self.sampler, remat=False)
        img = sd.decode_latents(z)
        return (img * 255.0 + 0.5).to(torch.uint8)

    def generate_batch(self, prompts: List[str], seeds: List[int]) -> np.ndarray:
        """<= batch_size prompts -> [len(prompts), H, W, 3] uint8."""
        n = len(prompts)
        if not 0 < n <= self.batch_size:
            raise ValueError(f"{n} prompts for a batch of {self.batch_size}")
        pad = self.batch_size - n
        ids = np.stack([np.asarray(self.tokenize(p), np.int32) for p in prompts]
                       + [self._uncond_ids] * pad)
        s = list(seeds) + [0] * pad
        if self.prepare_host is None:
            return _watermarked(self._run(ids, s)[:n].cpu().numpy(), self.watermark)
        local_ids, centers, active = self._hosts(prompts)
        if pad:  # pad rows: inactive control
            local_ids = np.concatenate(
                [local_ids, np.tile(self._uncond_ids, (pad, local_ids.shape[1], 1))])
            centers = np.concatenate([centers, np.zeros((pad,) + centers.shape[1:], np.float32)])
            active = np.concatenate([active, np.zeros((pad,) + active.shape[1:], np.float32)])
        imgs = self._run(ids, s, local_ids, centers, active)[:n].cpu().numpy()
        return _watermarked(imgs, self.watermark)


@dataclass
class SpaceTimeEngine:
    """Full-method serving: every batch runs the paper's whole pipeline, the
    layout from `runner.prepare_host`, then `runner.cfg.epochs` Adam epochs
    whose gradients flow through the whole sampling chain
    (`pipeline/spacetime.py`), and returns the fidelity-optimized images.

    `runner` is a `pipeline.runners.PromptRunner` (its bundle, loss CLIP,
    config, sampler, host stage and `assemble_inputs`), as in the JAX
    package.  A prompt whose layout fails and every pad row take
    `runner.empty_host` (JAX's `_empty_host`): zero `active`, so the blend
    and the per-object losses are exact no-ops and the row is vanilla
    sampling of its seed.  cuDNN
    runs its deterministic algorithms, so an image is a function of
    (prompt, seed) and its batch slot whatever else is in its batch (the
    slot matters in bfloat16 only, as for TextToImageEngine).
    """

    runner: object                       # pipeline.runners.PromptRunner
    batch_size: int = 4
    watermark: Optional[str] = None
    mesh: Optional[object] = None        # parallel.mesh.Mesh: split the batch

    def __post_init__(self):
        _check_mesh(self)
        if self.mesh is not None and self.mesh.model > 1:
            from ..parallel.sharding import shard_params

            sd = self.runner.sd
            for module in (sd.unet, sd.text_encoder, self.runner.clip_loss.clip):
                shard_params(module, self.mesh)

    def warmup(self) -> float:
        return _warmup(self)

    def _inputs(self, prompts: List[str], seeds: List[int]):
        """The padded batch's SpaceTimeInputs, x_T per request (with a mesh,
        this rank's rows)."""
        runner = self.runner
        pad = self.batch_size - len(prompts)
        hosts = [runner.prepare_host(p) or runner.empty_host(p) for p in prompts]
        hosts += [runner.empty_host("")] * pad
        inputs = runner.assemble_inputs(hosts, seed=0)
        x_T = engine_noise(list(seeds) + [0] * pad, runner.cfg.latent_size,
                           runner.sd.cfg.unet.in_channels, runner.sd.device)
        inputs = inputs._replace(x_T=x_T)
        return inputs if self.mesh is None else shard_batch(self.mesh, inputs)

    def optimize_batch(self, prompts: List[str], seeds: List[int], on_epoch=None):
        """(images [batch_size, H, W, 3] in [0, 1], coef, losses) of one
        padded batch; `on_epoch(e, images)` as in `optimize_prompt`.  With a
        mesh: images and coef of every row (gathered), the losses summed
        over the data axis; `on_epoch` sees this rank's rows."""
        from ..pipeline.spacetime import optimize_prompt

        n = len(prompts)
        if not 0 < n <= self.batch_size:
            raise ValueError(f"{n} prompts for a batch of {self.batch_size}")
        runner = self.runner
        with torch.no_grad():
            inputs = self._inputs(prompts, seeds)
        with deterministic():
            images, coef, losses = optimize_prompt(runner.sd, runner.clip_loss, inputs,
                                                   runner.cfg, sampler=runner.sampler,
                                                   on_epoch=on_epoch)
        if self.mesh is not None:
            import torch.distributed as dist

            images, coef = gather_rows(self.mesh, images), gather_rows(self.mesh, coef)
            if self.mesh.data_group is not None:
                dist.all_reduce(losses, group=self.mesh.data_group)
        return images, coef, losses

    @staticmethod
    def to_uint8(images: torch.Tensor) -> np.ndarray:
        return (images * 255.0 + 0.5).clamp(0, 255).to(torch.uint8).cpu().numpy()

    def generate_batch(self, prompts: List[str], seeds: List[int]) -> np.ndarray:
        """<= batch_size prompts -> [len(prompts), H, W, 3] uint8."""
        images, _, _ = self.optimize_batch(prompts, seeds)
        return _watermarked(self.to_uint8(images[:len(prompts)]), self.watermark)


class ServiceSaturated(Exception):
    """Raised by submit() when the bounded queue is full (backpressure: the
    HTTP front answers 503)."""


@dataclass
class _Request:
    prompt: str
    seed: int
    future: Future
    enqueued_at: float = 0.0


class BatchingService:
    """Thread-safe dynamic batcher in front of an engine (`batch_size`,
    `generate_batch`).

    * The queue is bounded (`max_queue`, by default 8 × batch_size):
      `submit` raises `ServiceSaturated` when it is full.
    * Requests that waited longer than `request_timeout_s` in the queue are
      failed with TimeoutError before they reach the engine.
    * An engine exception goes to its batch's futures; the worker goes on.
    """

    def __init__(self, engine, max_wait_s: float = 0.2, max_queue: Optional[int] = None,
                 request_timeout_s: Optional[float] = None, batch_allowance_s: float = 120.0):
        self.engine = engine
        self.max_wait_s = max_wait_s
        self.request_timeout_s = request_timeout_s
        # the client's wait on top of the queue budget, to cover one batch
        self.batch_allowance_s = batch_allowance_s
        maxsize = max_queue if max_queue is not None else 8 * engine.batch_size
        self._q: "queue.Queue[_Request]" = queue.Queue(maxsize=maxsize)
        self._stop = threading.Event()
        self._worker = threading.Thread(target=self._loop, daemon=True)
        self._lock = threading.Lock()   # stats: submit threads and the worker
        self.stats = {"requests": 0, "batches": 0, "batched_rows": 0,
                      "rejected": 0, "timed_out": 0}

    def _count(self, key: str, n: int = 1):
        with self._lock:
            self.stats[key] += n

    def start(self):
        self._worker.start()
        return self

    def stop(self):
        self._stop.set()
        self._worker.join(timeout=5)

    def queue_depth(self) -> int:
        return self._q.qsize()

    def submit(self, prompt: str, seed: int = 1) -> Future:
        fut: Future = Future()
        try:
            self._q.put_nowait(_Request(prompt, seed, fut, time.time()))
        except queue.Full:
            self._count("rejected")
            raise ServiceSaturated(f"queue full ({self._q.maxsize} pending)") from None
        self._count("requests")
        return fut

    def _expired(self, r: _Request) -> bool:
        if self.request_timeout_s is None:
            return False
        if time.time() - r.enqueued_at <= self.request_timeout_s:
            return False
        self._count("timed_out")
        if not r.future.done():
            r.future.set_exception(TimeoutError(f"request waited > {self.request_timeout_s}s"))
        return True

    def _drain(self) -> List[_Request]:
        """Block for one request, then gather more until the batch is full or
        max_wait_s has passed.  Expired requests are failed and dropped."""
        batch: List[_Request] = []
        try:
            first = self._q.get(timeout=0.1)
        except queue.Empty:
            return batch
        if not self._expired(first):
            batch.append(first)
        deadline = time.time() + self.max_wait_s
        while len(batch) < self.engine.batch_size:
            remaining = deadline - time.time()
            if remaining <= 0:
                break
            try:
                r = self._q.get(timeout=max(remaining, 0.001) if batch else 0.1)
            except queue.Empty:
                break
            if not self._expired(r):
                batch.append(r)
        return batch

    def _loop(self):
        while not self._stop.is_set():
            batch = self._drain()
            if not batch:
                continue
            try:
                imgs = self.engine.generate_batch([r.prompt for r in batch],
                                                  [r.seed for r in batch])
                for r, img in zip(batch, imgs):
                    r.future.set_result(img)
                with self._lock:
                    self.stats["batches"] += 1
                    self.stats["batched_rows"] += len(batch)
            except Exception as e:  # the batch's clients get it; the worker goes on
                for r in batch:
                    if not r.future.done():
                        r.future.set_exception(e)


def serve(service: BatchingService, host: str = "0.0.0.0", port: int = 8000,
          block: bool = True):
    """HTTP front: POST /txt2img {"prompt", "seed"?} -> 200 {"image": base64
    PNG, "shape"}; 503 {"error", "retry_after_s"} when the queue is full;
    504 when the request expired in the queue or outlived
    request_timeout_s + batch_allowance_s; 500 on an engine error; 404 on
    any other path.  GET /healthz -> {"ok", "queue_depth", **stats}.
    Returns the server (serving on a daemon thread unless `block`)."""
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    class Handler(BaseHTTPRequestHandler):
        def _json(self, code: int, obj):
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                self._json(200, {"ok": True, "queue_depth": service.queue_depth(),
                                 **service.stats})
            else:
                self._json(404, {"error": "unknown path"})

        def do_POST(self):
            if self.path != "/txt2img":
                self._json(404, {"error": "unknown path"})
                return
            try:
                n = int(self.headers.get("Content-Length", 0))
                req = json.loads(self.rfile.read(n) or b"{}")
                try:
                    fut = service.submit(str(req["prompt"]), int(req.get("seed", 1)))
                except ServiceSaturated as e:
                    self._json(503, {"error": str(e), "retry_after_s": 1})
                    return
                # the deadline: the queue budget (enforced by the worker)
                # plus the allowance for one batch on the card
                deadline = None
                if service.request_timeout_s:
                    deadline = service.request_timeout_s + service.batch_allowance_s
                img = fut.result(timeout=deadline)
                self._json(200, {"image": base64.b64encode(encode_png(img)).decode(),
                                 "shape": list(img.shape)})
            except (TimeoutError, _FuturesTimeout) as e:
                self._json(504, {"error": f"timeout: {e}"})
            except Exception as e:  # an answer to the client, not a dead handler
                self._json(500, {"error": repr(e)})

        def log_message(self, *a):  # quiet
            pass

    httpd = ThreadingHTTPServer((host, port), Handler)
    if block:
        httpd.serve_forever()
    else:
        threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return httpd
