"""PyTorch port, the serving front held against the JAX package on the CPU:
the watermark, the engines' noise and images (TextToImageEngine vanilla and
spatial, with and without the watermark; SpaceTimeEngine over a
PromptRunner), BatchingService, the HTTP front, the open-loop load test and
the `serve` / `txt2img` entry points.

The smoke sizes of `tests/test_serving.py` (UNet 32 channels, 16x16
latents, 32x32 images, CLIP text width 16 at CLIP's vocabulary, PLMS-4;
the spacetime engine at PLMS-2, 2 epochs, with a tiny layout predictor),
JAX's weights randomized at scale 0.2 and carried across with
`utils/weights`.  Tolerances: uint8 images within one step (x_T agrees
within 4 float32 ulp, each UNet evaluation within ~1e-5); the watermark,
a function of the uint8 image, bit for bit.  The batcher and the load test
run on a fake engine whose batches sleep, in both packages side by side.
"""
import base64
import dataclasses
import json
import os
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from diffusion_spacetime_attn_tpu.config import (
    CLIPConfig,
    CLIPTextConfig,
    CLIPVisionConfig,
    LayoutConfig,
    PipelineConfig,
    SpaceTimeConfig,
    UNetConfig,
    VAEConfig,
)
from diffusion_spacetime_attn_tpu.models.clip import CLIP as JCLIP
from diffusion_spacetime_attn_tpu.models.layout.model import create_layout_predictor
from diffusion_spacetime_attn_tpu.pipeline.frontend import LayoutInference as JLayoutInference
from diffusion_spacetime_attn_tpu.pipeline.losses import DCLIPLoss as JDCLIPLoss
from diffusion_spacetime_attn_tpu.pipeline.pipeline import StableDiffusion as JSD
from diffusion_spacetime_attn_tpu.pipeline.runners import PromptRunner as JPromptRunner
from diffusion_spacetime_attn_tpu.serving import loadtest as jloadtest
from diffusion_spacetime_attn_tpu.serving import server as jserver
from diffusion_spacetime_attn_tpu.utils import watermark as jwatermark
from diffusion_spacetime_attn_tpu.utils.testing import randomize_params
from diffusion_spacetime_attn_tpu.utils.tokenizer import make_clip_tokenizer as jclip_tok
from diffusion_spacetime_attn_tpu.utils.tokenizer import make_roberta_tokenizer as jrob_tok
from diffusion_spacetime_attn_tpu_torch import config as tcfg
from diffusion_spacetime_attn_tpu_torch.models.layout.model import LayoutPredictor
from diffusion_spacetime_attn_tpu_torch.pipeline.frontend import LayoutInference
from diffusion_spacetime_attn_tpu_torch.pipeline.losses import DCLIPLoss
from diffusion_spacetime_attn_tpu_torch.pipeline.pipeline import StableDiffusion
from diffusion_spacetime_attn_tpu_torch.pipeline.runners import PromptRunner
from diffusion_spacetime_attn_tpu_torch.scripts import measure_loadtest
from diffusion_spacetime_attn_tpu_torch.scripts import serve as serve_cli
from diffusion_spacetime_attn_tpu_torch.scripts import txt2img as txt2img_cli
from diffusion_spacetime_attn_tpu_torch.serving import loadtest as tloadtest
from diffusion_spacetime_attn_tpu_torch.serving import server as tserver
from diffusion_spacetime_attn_tpu_torch.utils import prng
from diffusion_spacetime_attn_tpu_torch.utils import watermark as twatermark
from diffusion_spacetime_attn_tpu_torch.utils.png import decode_png, encode_png, read_png, write_png
from diffusion_spacetime_attn_tpu_torch.utils.tokenizer import (
    make_clip_tokenizer,
    make_roberta_tokenizer,
)
from diffusion_spacetime_attn_tpu_torch.utils.weights import layout_state_dict

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SERVERS = {"jax": jserver, "port": tserver}
LOADTESTS = {"jax": jloadtest, "port": tloadtest}
# seeds an HTTP client may send: int32, past it (JAX casts to uint32), negative
SEEDS = [0, 1, 7, 2 ** 31 - 1, 2 ** 31 + 5, 2 ** 32 + 7, -3]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The suite runs several test processes side by side on few cores,
    where torch's spinning intra-op threads slow each other down many-fold;
    this module's torch work is small, so it takes one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def port_cfg(c):
    cls = getattr(tcfg, type(c).__name__)
    return cls(**{f.name: (port_cfg(getattr(c, f.name))
                           if dataclasses.is_dataclass(getattr(c, f.name))
                           else getattr(c, f.name))
                  for f in dataclasses.fields(c)})


def flat(params):
    return {k: np.asarray(v) for k, v in
            traverse_util.flatten_dict(jax.device_get(params), sep="/").items()}


def smoke_cfg(num_steps: int, epochs: int = 3) -> PipelineConfig:
    """`tests/test_serving.py`'s engine config, with its loss CLIP's."""
    text = CLIPTextConfig(width=16, layers=2, heads=2, vocab_size=49408, max_len=7)
    return PipelineConfig(
        unet=UNetConfig(model_channels=32, channel_mult=(1, 2), num_res_blocks=1,
                        attention_resolutions=(1, 2), num_heads=2, context_dim=16),
        vae=VAEConfig(ch=32, ch_mult=(1, 2), num_res_blocks=1),
        text_encoder=text,
        loss_clip=CLIPConfig(vision=CLIPVisionConfig(image_size=14, patch_size=7, width=16,
                                                     layers=2, heads=2, projection_dim=8),
                             text=text, projection_dim=8),
        spacetime=SpaceTimeConfig(num_steps=num_steps, latent_size=16, image_size=32,
                                  epochs=epochs))


def bundles(num_steps: int, epochs: int = 3):
    """(cfg, JAX bundle, the port's on the same weights)."""
    cfg = smoke_cfg(num_steps, epochs)
    sd = JSD.create(cfg, jax.random.PRNGKey(0), abstract=True)
    sd = dataclasses.replace(
        sd,
        unet_params=randomize_params(sd.unet_params, jax.random.PRNGKey(1), 0.2),
        vae_params=randomize_params(sd.vae_params, jax.random.PRNGKey(2), 0.2),
        text_params=randomize_params(sd.text_params, jax.random.PRNGKey(3), 0.2))
    tsd = StableDiffusion.from_flat(port_cfg(cfg), flat(sd.unet_params), flat(sd.vae_params),
                                    flat(sd.text_params), device="cpu")
    return cfg, sd, tsd


def tokenizers(L: int = 7):
    jt, tt = jclip_tok(max_len=L), make_clip_tokenizer(max_len=L)
    return (lambda t: jt.pad_to(jt.encode(t), L)), (lambda t: tt.pad_to(tt.encode(t), L))


def within_one_step(got, want):
    assert got.shape == want.shape and got.dtype == want.dtype == np.uint8
    diff = np.abs(got.astype(int) - want.astype(int))
    assert diff.max() <= 1, (int(diff.max()), float((diff > 0).mean()))


# ---------------------------------------------------------------- (a) watermark


@pytest.mark.parametrize("message", ["SDV1", "StableDiffusionV1", "x", "ünïcode"])
def test_watermark_matches_jax(message):
    """Equal bytes to JAX's on seeded images; the decode round-trips."""
    r = np.random.RandomState(len(message))
    for shape in [(32, 32, 3), (64, 48, 3)]:
        img = r.randint(0, 256, size=shape).astype(np.uint8)
        got = twatermark.embed_watermark(img, message)
        want = jwatermark.embed_watermark(img, message)
        assert got.tobytes() == want.tobytes()
        assert np.abs(got.astype(int) - img.astype(int)).max() <= 1
        assert (got[..., :2] == img[..., :2]).all()
        n = len(message.encode())
        assert twatermark.decode_watermark(got, n) == message
        assert twatermark.decode_watermark(got, n) == jwatermark.decode_watermark(got, n)


def test_watermark_too_small_raises_in_both():
    img = np.zeros((2, 3, 3), np.uint8)            # 6 pixels < 32 bits
    with pytest.raises(ValueError, match="too small"):
        twatermark.embed_watermark(img, "SDV1")
    with pytest.raises(ValueError, match="too small"):
        jwatermark.embed_watermark(img, "SDV1")


# ---------------------------------------------------------------- (c) noise


def test_request_noise_matches_jax_engines():
    """x_T of the port's engines against JAX's engines' draw,
    `normal(PRNGKey(s))` over seeds cast to uint32: keys and bits equal,
    normals within 4 ulp; `prng.PRNGKey` keeps JAX's int32 check."""
    shape = (16, 16, 4)

    @jax.jit
    def draws(seeds):                 # as the JAX engine draws x_T, one compile
        keys = jax.vmap(jax.random.PRNGKey)(seeds)
        return (keys, jax.vmap(lambda k: jax.random.bits(k, shape, jnp.uint32))(keys),
                jax.vmap(lambda k: jax.random.normal(k, shape, jnp.float32))(keys))

    jkeys, jbits, jn = (np.asarray(a) for a in
                        draws(jnp.asarray(np.asarray(SEEDS, np.int64), jnp.uint32)))
    for i, s in enumerate(SEEDS):
        key = prng.engine_key(s)
        np.testing.assert_array_equal(key, jkeys[i])
        np.testing.assert_array_equal(prng.bits(key, shape), jbits[i])
    got = tserver.engine_noise(SEEDS, 16, 4, torch.device("cpu")).numpy()
    assert got.shape == (len(SEEDS),) + shape and got.dtype == np.float32
    ulp = np.abs(got.view(np.int32).astype(np.int64) - jn.view(np.int32))
    assert np.all(np.sign(got) == np.sign(jn)) and ulp.max() <= 4
    with pytest.raises(ValueError):
        prng.PRNGKey(2 ** 31 + 5)


# ---------------------------------------------------------------- (b) TextToImageEngine


class _Fixed:
    """A host stage: one object at a fixed center for prompts with "cat",
    None (a failed layout) for the others."""

    def __init__(self, n):
        self.n = n

    def __call__(self, prompt):
        if "cat" not in prompt:
            return None
        centers = np.zeros((self.n, 2), np.float32)
        active = np.zeros(self.n, np.float32)
        centers[0], active[0] = (0.3, 0.6), 1.0
        return dict(centers=centers, active=active,
                    local_texts=["a photo of cat"] + [""] * (self.n - 1))


@pytest.fixture(scope="module")
def t2i():
    """{mode: (JAX TextToImageEngine, the port's)} at batch 3, PLMS-4."""
    cfg, jsd, tsd = bundles(num_steps=4)
    jtok, ttok = tokenizers()
    host = _Fixed(cfg.spacetime.max_objects)
    return {"vanilla": (jserver.TextToImageEngine(sd=jsd, tokenize=jtok, batch_size=3),
                        tserver.TextToImageEngine(sd=tsd, tokenize=ttok, batch_size=3)),
            "spatial": (jserver.TextToImageEngine(sd=jsd, tokenize=jtok, batch_size=3,
                                                  prepare_host=host),
                        tserver.TextToImageEngine(sd=tsd, tokenize=ttok, batch_size=3,
                                                  prepare_host=host))}


def _generate(engine, prompts, seeds, watermark=None):
    engine.watermark = watermark
    try:
        return engine.generate_batch(prompts, seeds)
    finally:
        engine.watermark = None


@pytest.mark.parametrize("watermark", [None, "SDV1"])
@pytest.mark.parametrize("mode", ["vanilla", "spatial"])
def test_text_to_image_engine_matches_jax(t2i, mode, watermark):
    """Two requests and a pad row, seeds past int32 among them (spatial: one
    row whose layout fails): uint8 images within one step of JAX's engine.
    With the watermark, each package's rows are its unmarked rows marked."""
    jeng, teng = t2i[mode]
    prompts, seeds = ["a cat here", "no object"], [2 ** 31 + 5, 3]
    want = _generate(jeng, prompts, seeds, watermark)
    got = _generate(teng, prompts, seeds, watermark)
    if watermark is None:
        within_one_step(got, want)
        if mode == "spatial":     # the control moved the cat row only
            plain = t2i["vanilla"][1].generate_batch(prompts, seeds)
            assert (got[0] != plain[0]).any()
            within_one_step(got[1], plain[1])
        return
    for eng, marked, embed in ((jeng, want, jwatermark.embed_watermark),
                               (teng, got, twatermark.embed_watermark)):
        plain = eng.generate_batch(prompts, seeds)
        np.testing.assert_array_equal(marked, np.stack([embed(im, watermark) for im in plain]))
        assert all(twatermark.decode_watermark(im) == watermark for im in marked)


def test_text_to_image_engine_warmup_and_bad_batch(t2i):
    teng = t2i["vanilla"][1]
    assert teng.warmup() > 0.0
    with pytest.raises(ValueError):
        teng.generate_batch(["a"] * 4, [0] * 4)


# ---------------------------------------------------------------- (d) SpaceTimeEngine


LAYOUT_PROMPTS = ["a dog to the left of a cat", "no objects here at all"]


@pytest.fixture(scope="module")
def spacetime():
    """(JAX SpaceTimeEngine, the port's), each over its package's
    PromptRunner with a tiny layout predictor (the same weights); PLMS-2,
    2 epochs, batch 2."""
    cfg, jsd, tsd = bundles(num_steps=2, epochs=2)
    clip = JCLIP(cfg.loss_clip)
    cp = randomize_params(jax.eval_shape(clip.init, jax.random.PRNGKey(4),
                                         jnp.zeros((1, 14, 14, 3)),
                                         jnp.zeros((1, 7), jnp.int32))["params"],
                          jax.random.PRNGKey(5), 0.2)
    tloss = DCLIPLoss.from_flat(port_cfg(cfg.loss_clip), flat(cp), device="cpu")
    lcfg = LayoutConfig(hidden=32, layers=2, heads=2, ffn_dim=64, max_positions=140,
                        max_len=24)
    lmodel, lparams = create_layout_predictor(lcfg, jax.random.PRNGKey(6))
    tlayout = LayoutPredictor(port_cfg(lcfg))
    tlayout.load_state_dict(layout_state_dict(jax.device_get(lparams), tlayout))
    tlayout.eval().requires_grad_(False)
    jtok, ttok = tokenizers()
    jr = JPromptRunner(sd=jsd, clip_loss=JDCLIPLoss(clip, cp),
                       layout=JLayoutInference(lmodel, lparams, jrob_tok(), 24),
                       clip_tokenize=jtok, text_tokenize=jtok, cfg=cfg.spacetime,
                       mode="spacetime")
    tr = PromptRunner(sd=tsd, clip_loss=tloss,
                      layout=LayoutInference(tlayout, make_roberta_tokenizer(), 24),
                      clip_tokenize=ttok, text_tokenize=ttok, cfg=port_cfg(cfg.spacetime),
                      mode="spacetime")
    return (jserver.SpaceTimeEngine(runner=jr, batch_size=2),
            tserver.SpaceTimeEngine(runner=tr, batch_size=2))


def test_spacetime_engine_matches_jax(spacetime):
    """A laid-out prompt beside one whose layout fails (an empty host
    record), then the first alone beside a pad row, seeds past int32 among
    them: uint8 within one step of JAX's engine, with the watermark too."""
    jeng, teng = spacetime
    seeds = [2 ** 31 + 5, 9]
    assert jeng.runner.prepare_host(LAYOUT_PROMPTS[0]) is not None
    assert teng.runner.prepare_host(LAYOUT_PROMPTS[1]) is None
    want = jeng.generate_batch(LAYOUT_PROMPTS, seeds)
    got = teng.generate_batch(LAYOUT_PROMPTS, seeds)
    within_one_step(got, want)
    solo = teng.generate_batch(LAYOUT_PROMPTS[:1], seeds[:1])
    np.testing.assert_array_equal(solo[0], got[0])   # float32: slot-independent
    teng.watermark = "SDV1"
    try:
        marked = teng.generate_batch(LAYOUT_PROMPTS[:1], seeds[:1])
    finally:
        teng.watermark = None
    np.testing.assert_array_equal(marked[0], twatermark.embed_watermark(got[0]))


def test_spacetime_engine_empty_host_is_the_runners_format(spacetime):
    jeng, teng = spacetime
    want, got = jeng._empty_host("a dog"), teng.runner.empty_host("a dog")
    assert sorted(got) == sorted(want)
    for k in ("centers", "active", "obj_tokens", "caption_tokens"):
        np.testing.assert_array_equal(got[k], np.asarray(want[k]))
    assert got["local_texts"] == want["local_texts"] and got["prompt"] == "a dog"


# ---------------------------------------------------------------- (e) BatchingService


class _SlowEngine:
    """A duck-typed engine whose batches take `delay` seconds; each image is
    filled with its request's seed (mod 256), so a future's image names the
    request it answers.  `fail` makes the next batch raise."""

    def __init__(self, batch_size=2, delay=0.0):
        self.batch_size = batch_size
        self.delay = delay
        self.calls = []
        self.fail = False

    def generate_batch(self, prompts, seeds):
        if self.delay:
            time.sleep(self.delay)
        self.calls.append(list(prompts))
        if self.fail:
            self.fail = False
            raise RuntimeError("engine fault")
        return np.stack([np.full((4, 4, 3), s % 256, np.uint8) for s in seeds])


@pytest.mark.parametrize("impl", ["jax", "port"])
def test_batching_service_coalesces(impl):
    eng = _SlowEngine(batch_size=3)
    svc = SERVERS[impl].BatchingService(eng, max_wait_s=0.5)
    futs = [svc.submit(f"prompt {i}", seed=i) for i in range(3)]
    svc.start()
    try:
        imgs = [f.result(timeout=10) for f in futs]
        assert [int(im[0, 0, 0]) for im in imgs] == [0, 1, 2]
        assert svc.stats["requests"] == 3 and svc.stats["batches"] == 1
        assert svc.stats["batched_rows"] == 3 and eng.calls == [[f"prompt {i}" for i in range(3)]]
    finally:
        svc.stop()


@pytest.mark.parametrize("impl", ["jax", "port"])
def test_bounded_queue_raises_saturated(impl):
    srv = SERVERS[impl]
    svc = srv.BatchingService(_SlowEngine(batch_size=2, delay=0.1), max_wait_s=0.01,
                              max_queue=3)
    futs = [svc.submit(f"p{i}") for i in range(3)]     # not started: the queue only fills
    with pytest.raises(srv.ServiceSaturated):
        svc.submit("overflow")
    assert svc.stats["rejected"] == 1 and svc.queue_depth() == 3
    assert srv.BatchingService(_SlowEngine(batch_size=5))._q.maxsize == 40   # 8 x batch
    svc.start()
    try:
        assert all(f.result(timeout=10).shape == (4, 4, 3) for f in futs)
    finally:
        svc.stop()


@pytest.mark.parametrize("impl", ["jax", "port"])
def test_request_timeout_expires_stale_requests(impl):
    eng = _SlowEngine(batch_size=1)
    svc = SERVERS[impl].BatchingService(eng, max_wait_s=0.01, request_timeout_s=0.2)
    stale = svc.submit("stale")
    time.sleep(0.4)                                    # expire before the worker starts
    svc.start()
    try:
        with pytest.raises(TimeoutError):
            stale.result(timeout=5)
        assert svc.submit("fresh").result(timeout=5).shape == (4, 4, 3)
        assert svc.stats["timed_out"] == 1 and eng.calls == [["fresh"]]   # never ran
    finally:
        svc.stop()


@pytest.mark.parametrize("impl", ["jax", "port"])
def test_engine_error_reaches_the_batch_and_the_worker_goes_on(impl):
    eng = _SlowEngine(batch_size=2)
    eng.fail = True
    svc = SERVERS[impl].BatchingService(eng, max_wait_s=0.3)
    futs = [svc.submit("a", 1), svc.submit("b", 2)]
    svc.start()
    try:
        for f in futs:
            with pytest.raises(RuntimeError, match="engine fault"):
                f.result(timeout=5)
        assert int(svc.submit("c", 3).result(timeout=5)[0, 0, 0]) == 3
        assert svc.stats["batches"] == 1 and svc._worker.is_alive()
    finally:
        svc.stop()


def test_batching_service_counts_under_concurrent_submits():
    """More submitting threads than cores, a short switch interval: every
    submit is counted once, as a request or a reject, and every accepted
    request is answered with its own image."""
    svc = tserver.BatchingService(_SlowEngine(batch_size=4), max_wait_s=0.001,
                                  max_queue=8).start()
    accepted, lock = [], threading.Lock()
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)

    def client(c):
        for i in range(25):
            try:
                fut = svc.submit("p", seed=c * 25 + i)
            except tserver.ServiceSaturated:
                continue
            with lock:
                accepted.append((c * 25 + i, fut))

    try:
        threads = [threading.Thread(target=client, args=(c,)) for c in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
        assert not any(t.is_alive() for t in threads)
        for seed, fut in accepted:
            assert int(fut.result(timeout=30)[0, 0, 0]) == seed % 256
    finally:
        sys.setswitchinterval(interval)
        svc.stop()
    s = svc.stats
    assert s["requests"] + s["rejected"] == 400 and s["requests"] == len(accepted)
    assert s["batched_rows"] == len(accepted)


# ---------------------------------------------------------------- (f) HTTP


def _post(port, body, path="/txt2img", timeout=30):
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}",
                                 data=json.dumps(body).encode(), method="POST")
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _get(port, path):
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=10) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


class _Front:
    """A service behind `serve` on 127.0.0.1 at a free port."""

    def __init__(self, impl, engine, **kw):
        self.svc = SERVERS[impl].BatchingService(engine, **kw).start()
        self.httpd = SERVERS[impl].serve(self.svc, host="127.0.0.1", port=0, block=False)
        self.port = self.httpd.server_address[1]

    def close(self):
        self.httpd.shutdown()
        self.httpd.server_close()
        self.svc.stop()


def test_http_200_png_is_the_engines_image(t2i):
    """POST /txt2img through the port's vanilla engine: the base64 PNG
    decodes (utils/png) to the engine's own image for (prompt, seed)."""
    teng = t2i["vanilla"][1]
    front = _Front("port", teng, max_wait_s=0.05)
    try:
        code, out = _post(front.port, {"prompt": "a cat", "seed": 2 ** 31 + 5}, timeout=120)
        assert code == 200 and out["shape"] == [32, 32, 3]
        img = decode_png(base64.b64decode(out["image"]))
        np.testing.assert_array_equal(img, teng.generate_batch(["a cat"], [2 ** 31 + 5])[0])
        code, health = _get(front.port, "/healthz")
        assert code == 200 and health["ok"] and health["requests"] == 1
        assert health["batches"] == 1 and health["queue_depth"] == 0
    finally:
        front.close()


def _burst(port, n, body, gap=0.05):
    codes, threads = [], []
    for _ in range(n):
        threads.append(threading.Thread(target=lambda: codes.append(_post(port, body)[0])))
        threads[-1].start()
        time.sleep(gap)
    for t in threads:
        t.join(timeout=30)
    return sorted(codes)


@pytest.mark.parametrize("impl", ["jax", "port"])
def test_http_status_codes(impl):
    """503 with retry_after_s on a full queue, 504 for a request expired
    behind a running batch, 500 on an engine error, 404 elsewhere, and
    /healthz with the stats: the same in both packages."""
    front = _Front(impl, _SlowEngine(batch_size=1, delay=0.5), max_wait_s=0.01, max_queue=1)
    try:
        codes = _burst(front.port, 4, {"prompt": "a"})  # 1 running, 1 queued, 2 over
        assert 503 in codes and 200 in codes, codes
        code, out = _post(front.port, {"prompt": "b"})
        assert code in (200, 503)
        code, health = _get(front.port, "/healthz")
        assert code == 200 and health["rejected"] >= 1
        assert {"ok", "queue_depth", "requests", "batches", "batched_rows", "rejected",
                "timed_out"} == set(health)
        assert _get(front.port, "/nope")[0] == 404
        assert _post(front.port, {"prompt": "a"}, path="/nope")[0] == 404
    finally:
        front.close()
    front = _Front(impl, _SlowEngine(batch_size=1, delay=0.5), max_wait_s=0.01,
                   request_timeout_s=0.05)
    try:
        assert _burst(front.port, 2, {"prompt": "a"}) == [200, 504]
    finally:
        front.close()
    eng = _SlowEngine(batch_size=1)
    eng.fail = True
    front = _Front(impl, eng, max_wait_s=0.01)
    try:
        code, out = _post(front.port, {"prompt": "a"})
        assert code == 500 and "engine fault" in out["error"]
        assert _post(front.port, {"prompt": "a", "seed": 5})[0] == 200
    finally:
        front.close()


def test_png_bytes_round_trip(tmp_path):
    img = np.random.RandomState(3).randint(0, 256, size=(7, 5, 3)).astype(np.uint8)
    data = encode_png(img)
    np.testing.assert_array_equal(decode_png(data), img)
    write_png(str(tmp_path / "a.png"), img)
    assert (tmp_path / "a.png").read_bytes() == data


# ---------------------------------------------------------------- (g) load test


@pytest.mark.parametrize("impl", ["jax", "port"])
def test_loadtest_percentiles_and_saturation(impl):
    """run_loadtest on a fake slow engine (`tests/test_serving.py`): the
    half-capacity stage completes cleanly, the overload stage rejects and is
    named the saturation rate."""
    art = LOADTESTS[impl].run_loadtest(
        _SlowEngine(batch_size=2, delay=0.10), capacity_fractions=(0.5, 4.0),
        stage_requests=10, max_wait_s=0.02, max_queue=2, depth_sample_s=0.02,
        capacity_req_per_s=2 / 0.10)
    assert art["capacity_req_per_s"] == 20.0 and len(art["stages"]) == 2
    calm, storm = art["stages"]
    assert calm["rejected"] == 0 and calm["completed"] == 10
    lat = calm["latency_s"]
    assert lat["p50"] is not None and lat["p50"] <= lat["p95"] <= lat["p99"] < 0.5
    assert storm["rejected"] > 0 and storm["queue_depth"]["max"] >= 1
    assert art["saturation_req_per_s"] == storm["offered_req_per_s"]


def _keys(obj):
    """The nesting of dicts and lists with every leaf dropped."""
    if isinstance(obj, dict):
        return {k: _keys(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_keys(v) for v in obj]
    return None


def test_loadtest_artifact_keys_match_jax():
    """The same fake engine and arguments, measured capacity included: the
    artifacts have the same keys at every level."""
    kw = dict(capacity_fractions=(0.5, 1.0), stage_requests=4, max_wait_s=0.02,
              depth_sample_s=0.02)
    want = jloadtest.run_loadtest(_SlowEngine(batch_size=2, delay=0.05), **kw)
    got = tloadtest.run_loadtest(_SlowEngine(batch_size=2, delay=0.05), **kw)
    assert _keys(got) == _keys(want)
    assert got["max_queue"] == want["max_queue"] == 16


def test_measure_loadtest_attributes_batches_to_stages():
    """The measurement's bookkeeping on a fake engine: capacity from the
    best of 4 batches, every batch of the ramp in exactly one stage, rows
    equal to the stage's completed requests, load = offered rate × median
    batch time / batch size, busy = offered rate × Σ batch time / rows."""
    timed = measure_loadtest.TimedEngine(_SlowEngine(batch_size=2, delay=0.05))
    art = tloadtest.run_loadtest(timed, capacity_fractions=(0.5, 2.0), stage_requests=6,
                                 max_wait_s=0.02, max_queue=2, depth_sample_s=0.02,
                                 capacity_repeats=4)
    rec = measure_loadtest.ramp_record(art, timed.rows, 4)
    assert len(rec["capacity_batch_s"]) == 4
    assert art["capacity_req_per_s"] == pytest.approx(2 / min(rec["capacity_batch_s"]),
                                                      rel=1e-3)
    assert 4 + sum(st["batches"] for st in rec["stage_batches"]) == len(timed.rows)
    for st, sb in zip(art["stages"], rec["stage_batches"]):
        assert sum(sb["rows"]) == st["completed"]
        assert sb["load"] == pytest.approx(
            st["offered_req_per_s"] * np.median(sb["batch_s"]) / 2)
        assert sb["busy"] == pytest.approx(
            st["offered_req_per_s"] * np.sum(sb["batch_s"]) / st["completed"])
    assert rec["stage_batches"][0]["load"] < 1.0 < rec["stage_batches"][1]["load"]
    with pytest.raises(RuntimeError):
        measure_loadtest.ramp_record(art, timed.rows[:-1], 4)


# ---------------------------------------------------------------- (h)-(j) entry points


SOAK_SUMMARY = {"soak_ok", "mode", "batch_size", "params_dtype", "requests", "batches",
                "total_seconds", "s_per_request_steady"}   # JAX scripts/serve.py:291-304


def _run(module, *args):
    return subprocess.run(
        [sys.executable, "-m", f"diffusion_spacetime_attn_tpu_torch.scripts.{module}", *args],
        capture_output=True, text=True, timeout=300, cwd=ROOT)


def test_serve_cli_soak_with_bf16_params():
    """`serve --tiny --cpu --soak 3 --params-dtype bfloat16`: the JAX
    script's lines, two batch lines and its summary fields."""
    r = _run("serve", "--tiny", "--cpu", "--mode", "vanilla", "--batch", "2", "--steps", "2",
             "--soak", "3", "--params-dtype", "bfloat16")
    assert r.returncode == 0, r.stderr[-3000:]
    lines = [json.loads(ln) for ln in r.stdout.splitlines() if ln.startswith("{")]
    assert len(lines) == 3
    assert [ln["n"] for ln in lines[:2]] == [2, 1]
    assert lines[1]["img_shape"] == [1, 32, 32, 3]
    summary = lines[-1]
    assert set(summary) == SOAK_SUMMARY
    assert summary["soak_ok"] is True and summary["requests"] == 3
    assert summary["params_dtype"] == "bfloat16" and summary["batches"] == 2


@pytest.mark.parametrize("flag", ["--ckpt", "--clip-ckpt", "--clip-vocab", "--layout-ckpt"])
@pytest.mark.parametrize("cli", ["serve", "txt2img"])
def test_checkpoint_flags_raise_naming_a11(cli, flag):
    argv = ["--cpu", flag, "x"] + (["--prompt", "a cat"] if cli == "txt2img" else [])
    main = serve_cli.main if cli == "serve" else txt2img_cli.main
    with pytest.raises(NotImplementedError, match="A.11"):
        main(argv)


def test_entry_points_need_a_card_without_cpu():
    """Without --cpu on a machine with no CUDA device the CLI exits
    non-zero with a message and runs nothing on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    r = _run("serve", "--tiny", "--mode", "vanilla", "--soak", "1")
    assert r.returncode != 0 and "no CUDA device" in r.stderr
    assert "soak" not in r.stdout
    with pytest.raises(RuntimeError, match="no CUDA device"):
        txt2img_cli.main(["--prompt", "a cat", "--tiny"])


@pytest.mark.parametrize("prompt,name", [("a cat above a dog", "final1_s3_index_0.png"),
                                         ("no objects here at all", "final_s3_index_0.png")])
def test_txt2img_spatial_writes_the_marked_image(tmp_path, prompt, name):
    """`txt2img --tiny --cpu --steps 2 --mode spatial`, in this process: a
    prompt that lays out is written under `run_one`'s name (epochs 2), one
    that does not by the vanilla fallback; with `--watermark` the file is the
    unmarked run's image with "SDV1" embedded."""
    argv = ["--prompt", prompt, "--tiny", "--cpu", "--steps", "2", "--mode", "spatial",
            "--seed", "3"]
    plain = txt2img_cli.main(argv + ["--outdir", str(tmp_path / "plain")])
    marked = txt2img_cli.main(argv + ["--outdir", str(tmp_path / "marked"), "--watermark"])
    for path, d in ((plain, "plain"), (marked, "marked")):
        assert path == str(tmp_path / d / name) and os.listdir(tmp_path / d) == [name]
    img, got = read_png(plain)[..., :3], read_png(marked)[..., :3]
    assert img.shape == (32, 32, 3) and img.std() > 0
    np.testing.assert_array_equal(got, twatermark.embed_watermark(img))
    assert twatermark.decode_watermark(got) == "SDV1"


def test_txt2img_fallback_matches_jax(spacetime, tmp_path):
    """A prompt whose layout fails: `txt2img.generate` in spatial mode writes
    the vanilla chain from `PRNGKey(seed)`'s noise, within one uint8 step of
    the JAX script's fallback on the same weights (`scripts/txt2img.py`:
    `make_eps_fn` of the caption, `sample_from`, `decode_latents`, the
    runner's truncation)."""
    jeng, teng = spacetime
    runner = dataclasses.replace(teng.runner, mode="spatial", outdir=str(tmp_path))
    path = txt2img_cli.generate(runner, LAYOUT_PROMPTS[1], 9)
    assert path == str(tmp_path / "final_s9_index_0.png")
    jr, cfg = jeng.runner, jeng.runner.cfg
    eps = jr.sd.make_eps_fn(jr._encode([LAYOUT_PROMPTS[1]]), jr._uncond(), cfg.guidance_scale)
    x_T = jax.random.normal(jax.random.PRNGKey(9), (1, cfg.latent_size, cfg.latent_size, 4))
    img = np.asarray(jr.sd.decode_latents(jr.sd.sample_from(eps, x_T, "plms", remat=False))[0])
    within_one_step(read_png(path)[..., :3], (img * 255.0).clip(0, 255).astype(np.uint8))


def test_measure_loadtest_main_in_process(tmp_path):
    """`measure_loadtest --tiny --cpu` with serve's flags passed through:
    one record per ramp, written to --out, and the summary's fields."""
    out = tmp_path / "m.json"
    summary = measure_loadtest.main(["--tiny", "--cpu", "--batch", "2", "--requests", "2",
                                     "--fractions", "1.0", "--capacity-batches", "3",
                                     "--repeats", "2", "--out", str(out), "--max-wait", "0.05"])
    rec = json.loads(out.read_text())
    assert rec["summary"] == summary and len(rec["ramps"]) == 2
    assert summary["capacity_batches"] == 3 and summary["nvidia_smi"] is None
    assert [len(r["capacity_batch_s"]) for r in rec["ramps"]] == [3, 3]
    st = summary["per_stage"][0]
    assert len(summary["per_stage"]) == 1 and len(st["load"]) == 2
    assert st["n"] == sum(r["artifact"]["stages"][0]["completed"] for r in rec["ramps"])


def test_measure_loadtest_tail_leaves_ten_samples_above():
    lat = np.arange(1, 121, dtype=float)          # 120 samples
    t = measure_loadtest.tail(lat)
    assert t["n"] == 120 and t["median_s"] == 60.5 and t["tail_percentile"] == 91
    assert (lat > t["tail_s"]).sum() >= 10
    assert measure_loadtest.tail(lat[:10])["tail_percentile"] is None


def test_serve_main_loadtest_in_process(tmp_path):
    """`serve --loadtest` on the tiny config: the artifact with the mode's
    fields, also written to --loadtest-out."""
    out = tmp_path / "lt.json"
    art = serve_cli.main(["--tiny", "--cpu", "--batch", "2", "--loadtest", "2",
                          "--loadtest-fractions", "1.0", "--loadtest-out", str(out)])
    assert art["stages"][0]["completed"] + art["stages"][0]["rejected"] == 2
    assert {"mode", "sampler", "params_dtype", "steps"} <= set(art)
    assert json.loads(out.read_text()) == art
