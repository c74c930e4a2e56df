"""PyTorch port, LDM training held against the JAX package on the CPU:
`lvlb_weights`, `scaled_lr`, `ema_decay`, the LR schedules, `p_losses` on one
key, three `make_train_step` steps (global-norm clip, accumulation over 2,
`lambda_linear`, `learn_logvar`, EMA), class conditioning through
`ClassEmbedder`, the other encoders, save -> restore -> resume, and the
`train_ldm` / `bench_train` entry points.

The same weights go into both packages through the weight bridge and the
same JAX keys drive both steps.  Config: `test_ldm_training.py`'s TINY UNet
(32 channels, mult (1, 2), one res block, 2 heads, context 16), float32.
Tolerances: schedules, lvlb weights and EMA decay 1e-6 relative; p_losses
1e-5; per-step losses 1e-4 relative, parameters, EMA and logvar 1e-4
(absolute and relative); the encoders 1e-5.  Torch takes one thread.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusion_spacetime_attn_tpu.config import LDMTrainConfig as JLDMTrainConfig
from diffusion_spacetime_attn_tpu.config import ScheduleConfig as JScheduleConfig
from diffusion_spacetime_attn_tpu.config import UNetConfig as JUNetConfig
from diffusion_spacetime_attn_tpu.models import encoders as jenc
from diffusion_spacetime_attn_tpu.models.unet import UNet as JUNet
from diffusion_spacetime_attn_tpu.ops.schedule import make_schedule as jmake_schedule
from diffusion_spacetime_attn_tpu.training import ldm_trainer as jldm
from diffusion_spacetime_attn_tpu.training import schedules as jsched
from diffusion_spacetime_attn_tpu.utils.testing import randomize_params
from diffusion_spacetime_attn_tpu_torch import config as tcfg
from diffusion_spacetime_attn_tpu_torch.models import encoders as tenc
from diffusion_spacetime_attn_tpu_torch.models.unet import UNet
from diffusion_spacetime_attn_tpu_torch.ops.schedule import make_schedule
from diffusion_spacetime_attn_tpu_torch.scripts import bench_train, train_ldm
from diffusion_spacetime_attn_tpu_torch.training import ldm_trainer as tldm
from diffusion_spacetime_attn_tpu_torch.training import schedules as tsched
from diffusion_spacetime_attn_tpu_torch.utils import prng
from diffusion_spacetime_attn_tpu_torch.utils.weights import bridge, load_flat
from test_torch_pipeline import flat, port_cfg

TOL = 1e-4
TINY = JUNetConfig(model_channels=32, channel_mult=(1, 2), num_res_blocks=1,
                   attention_resolutions=(1, 2), num_heads=2, context_dim=16)
SCHED = JScheduleConfig()


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def close(got, want, tol=TOL):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=tol, rtol=tol)


def rel(a, b):
    return abs(float(a) - float(b)) / max(abs(float(b)), 1e-30)


@pytest.fixture(scope="module")
def tiny_params():
    unet = JUNet(TINY, radius=0.2)
    params = jax.jit(unet.init)(jax.random.PRNGKey(0), jnp.zeros((1, 16, 16, 4)),
                                jnp.zeros((1,), jnp.int32), jnp.zeros((1, 7, 16)))["params"]
    return unet, randomize_params(params, jax.random.PRNGKey(1))


def port_unet(params, cfg=TINY, **flags):
    unet = UNet(port_cfg(dataclasses.replace(cfg, **flags)), radius=0.2)
    return load_flat(unet, flat(params))


class SmallEps(torch.nn.Module):
    """A small eps model with well-conditioned gradients (every parameter
    moves the output), to hold the optimizer, the schedule, the clip, the
    accumulation, the learned logvar and EMA element by element:
    x·wx + bx + mean_L(c)·wc + sin(t/100)·wt."""

    def __init__(self):
        super().__init__()
        r = np.random.RandomState(5)
        for name, shape in (("wx", (4, 4)), ("bx", (4,)), ("wc", (16, 4)), ("wt", (4,))):
            self.register_parameter(name, torch.nn.Parameter(
                torch.from_numpy(r.randn(*shape).astype(np.float32) * 0.3)))

    def forward(self, x, t, c):
        return (x @ self.wx + self.bx + (c.mean(1) @ self.wc)[:, None, None, :]
                + torch.sin(t.float() / 100.0)[:, None, None, None] * self.wt)

    def jax_params(self):
        # copies: jnp.asarray may alias the numpy view of a parameter on the CPU
        return {k: jnp.array(v.detach().numpy().copy()) for k, v in self.named_parameters()}


def small_eps_jax(p, x, t, c):
    return (x @ p["wx"] + p["bx"] + (c.mean(1) @ p["wc"])[:, None, None, :]
            + jnp.sin(t.astype(jnp.float32) / 100.0)[:, None, None, None] * p["wt"])


def test_lvlb_weights_scaled_lr_and_ema_decay_match_jax():
    for param in ("eps", "x0"):
        np.testing.assert_allclose(tldm.lvlb_weights(tcfg.ScheduleConfig(), param),
                                   jldm.lvlb_weights(SCHED, param), rtol=1e-6)
    for kw in (dict(), dict(scale_lr=False), dict(accum_steps=3, batch_size=2, base_lr=2e-5)):
        for b, n in ((4, 1), (2, 8)):
            assert tldm.scaled_lr(tcfg.LDMTrainConfig(**kw), b, n) == pytest.approx(
                jldm.scaled_lr(JLDMTrainConfig(**kw), b, n), rel=1e-12)
    for step in (0, 1, 5, 100, 10 ** 4, 10 ** 6):
        for decay in (0.9999, 0.9995, 0.5):
            want = float(jldm.ema_decay(jnp.asarray(step, jnp.int32), decay))
            assert rel(tldm.ema_decay(step, decay), want) <= 1e-6


SCHEDULES = {
    "bert": ("bert_schedule", (1e-3, 1e-5, 100, 2000, 5000)),
    "warmup_cosine": ("warmup_cosine_schedule", (100, 1e-5, 1.0, 1e-6, 3000)),
    "warmup_cosine2": ("warmup_cosine_schedule2",
                       ([100, 50], [0.1, 0.2], [1.0, 0.5], [1e-6, 0.3], [1000, 2000])),
    "lambda_linear": ("lambda_linear_schedule",
                      ([100, 50], [0.1, 0.2], [1.0, 0.5], [1e-6, 0.3], [1000, 2000])),
    "lambda_linear_sd": ("lambda_linear_schedule", ([10000], [1.0], [1.0], [1e-6], [10 ** 9])),
}


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_schedule_matches_jax(name):
    fn, args = SCHEDULES[name]
    steps = np.concatenate([np.arange(0, 120), np.arange(900, 1100), np.arange(2950, 3060),
                            [5000, 9999, 10000, 10001, 10 ** 5, 10 ** 6]]).astype(np.int32)
    want = np.asarray(getattr(jsched, fn)(*args)(jnp.asarray(steps)))
    got = getattr(tsched, fn)(*args)(steps)
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-12)
    for s in (0, 57, 1000):                     # Python ints as well
        assert rel(getattr(tsched, fn)(*args)(s), want[list(steps).index(s)]) <= 1e-6


def test_p_losses_matches_jax_on_one_key():
    """Same t (randint, bit for bit) and noise (normal) from one key; the
    loss, its parts and the learned-logvar terms within 1e-5, for the eps
    and x0 targets, l2 and l1, with the VLB term."""
    rng = jax.random.PRNGKey(3)
    t_rng, n_rng = jax.random.split(rng)
    t_key, n_key = prng.split(prng.PRNGKey(3))
    np.testing.assert_array_equal(prng.randint(t_key, (2,), 0, 1000),
                                  np.asarray(jax.random.randint(t_rng, (2,), 0, 1000)))
    close(prng.normal(n_key, (2, 8, 8, 4)), jax.random.normal(n_rng, (2, 8, 8, 4)), 1e-6)
    model = SmallEps()
    x0 = np.random.RandomState(0).randn(2, 8, 8, 4).astype(np.float32)
    ctx = np.random.RandomState(1).randn(2, 7, 16).astype(np.float32)
    logvar = np.linspace(-0.5, 0.3, 1000).astype(np.float32)
    for kw in (dict(), dict(original_elbo_weight=0.5, learn_logvar=True),
               dict(parameterization="x0", loss_type="l1")):
        jc, tc = JLDMTrainConfig(**kw), tcfg.LDMTrainConfig(**kw)
        w = jldm.lvlb_weights(SCHED, jc.parameterization)
        loss, m = jldm.p_losses(jc, jmake_schedule(SCHED, 50), jnp.asarray(w), small_eps_jax,
                                model.jax_params(), jnp.asarray(logvar), jnp.asarray(x0),
                                jnp.asarray(ctx), rng)
        with torch.no_grad():
            tloss, tm = tldm.p_losses(tc, make_schedule(tcfg.ScheduleConfig(), 50),
                                      torch.from_numpy(w), model, torch.from_numpy(logvar),
                                      torch.from_numpy(x0), torch.from_numpy(ctx),
                                      prng.PRNGKey(3))
        assert sorted(tm) == sorted(m)
        for k in m:
            assert rel(tm[k], m[k]) <= 1e-5, k


def _run_steps(jcfg, params, eps_j, model, x0, ctx, n=3, lr=2e-3):
    """n JAX steps and n port steps on the same keys; returns (JAX state, the
    port's state, per-step (JAX, port) metrics)."""
    jstep = jax.jit(jldm.make_train_step(jcfg, SCHED, jmake_schedule(SCHED, 50), eps_j, lr))
    js = jldm.init_state(jcfg, SCHED, params, lr)
    tc = port_cfg(jcfg)
    ts = tldm.init_state(tc, tcfg.ScheduleConfig(), model, lr)
    tstep = tldm.make_train_step(tc, tcfg.ScheduleConfig(),
                                 make_schedule(tcfg.ScheduleConfig(), 50), model)
    pairs = []
    for i in range(n):
        js, jm = jstep(js, jnp.asarray(x0), jnp.asarray(ctx),
                       jax.random.fold_in(jax.random.PRNGKey(7), i))
        ts, tm = tstep(ts, torch.from_numpy(x0), torch.from_numpy(ctx),
                       prng.fold_in(prng.PRNGKey(7), i))
        pairs.append((jm, tm))
    return js, ts, pairs


@pytest.mark.parametrize("accum", [1, 2])
def test_three_train_steps_match_jax(accum):
    """Global-norm clip 0.5 (it clips), accumulation, lambda_linear (warm-up
    3), learned logvar, EMA 0.9: the loss per step, then the parameters, EMA
    and logvar after 3 steps, on an eps model whose every gradient is
    well conditioned (Adam turns a gradient that is rounding noise into a
    ±lr step, differently in each package; the UNet's own gradients are
    held below)."""
    model = SmallEps()
    jcfg = JLDMTrainConfig(use_ema=True, scale_lr=False, grad_clip_norm=0.5, accum_steps=accum,
                           lr_schedule="lambda_linear", lr_warmup_steps=3, lr_f_start=0.1,
                           learn_logvar=True, ema_decay=0.9)
    r = np.random.RandomState(0)
    x0 = r.randn(2, 8, 8, 4).astype(np.float32)
    ctx = r.randn(2, 7, 16).astype(np.float32)
    js, ts, pairs = _run_steps(jcfg, model.jax_params(), small_eps_jax, model, x0, ctx,
                               n=3, lr=2e-2)
    for jm, tm in pairs:
        assert sorted(jm) == sorted(tm)
        for k in jm:
            assert rel(tm[k], jm[k]) <= TOL or abs(float(tm[k]) - float(jm[k])) <= 1e-7, k
    assert ts.step == 3 and ts.opt_state.count == 3 // accum
    for k, v in model.named_parameters():
        close(v, js.params[k])
        close(ts.ema_params[k], js.ema_params[k])
        assert not torch.equal(ts.ema_params[k], v.detach())
    close(ts.logvar, js.logvar)
    assert float(torch.abs(ts.logvar).max()) > 0


def _hold_grads(loss_j, grads_j, model, loss_t):
    """The port's loss within 1e-5 and each parameter's gradient within
    1e-4 relative in norm, above a floor of 1e-6 of the global norm (the
    gradient of a bias before a per-channel GroupNorm is rounding noise)."""
    assert rel(loss_t, loss_j) <= 1e-5
    want = bridge(flat(grads_j), model)
    total = float(np.sqrt(sum(float((v.float() ** 2).sum()) for v in want.values())))
    for name, p in model.named_parameters():
        g, w = p.grad, want[name].float()
        err = float(torch.linalg.vector_norm(g - w))
        assert err <= 1e-4 * float(torch.linalg.vector_norm(w)) + 1e-6 * total, name


@pytest.fixture(scope="module")
def unet_grads(tiny_params):
    """JAX's loss and gradient of p_losses (learned logvar, VLB term) on the
    TINY UNet at 32² latents, one key."""
    junet, params = tiny_params
    cfg = JLDMTrainConfig(learn_logvar=True, original_elbo_weight=0.5)
    w = jnp.asarray(jldm.lvlb_weights(SCHED, "eps"))
    r = np.random.RandomState(0)
    x0, ctx = r.randn(2, 32, 32, 4).astype(np.float32), r.randn(2, 7, 16).astype(np.float32)
    logvar = np.linspace(-0.3, 0.3, 1000).astype(np.float32)

    def loss(p):
        return jldm.p_losses(cfg, jmake_schedule(SCHED, 50), w,
                             lambda q, x, t, c: junet.apply({"params": q}, x, t, c), p,
                             jnp.asarray(logvar), jnp.asarray(x0), jnp.asarray(ctx),
                             jax.random.PRNGKey(11))[0]

    value, grads = jax.jit(jax.value_and_grad(loss))(params)
    return value, grads, x0, ctx, logvar


@pytest.mark.parametrize("kernels", [False, True], ids=["plain", "kernel_flags"])
def test_unet_loss_and_gradients_match_jax(tiny_params, unet_grads, kernels):
    """The training loss and every parameter's gradient of the TINY UNet
    against JAX's plain UNet.  kernel_flags: the port's UNet with use_flash
    and use_fused_ff, whose plain versions run on the CPU: the GEGLU
    autograd Function's weight gradients and the flash backward at the
    1024-token level-0 self-attention."""
    _, params = tiny_params
    value, grads, x0, ctx, logvar = unet_grads
    model = port_unet(params, use_flash=kernels, use_fused_ff=kernels)
    tc = tcfg.LDMTrainConfig(learn_logvar=True, original_elbo_weight=0.5)
    loss, _ = tldm.p_losses(tc, make_schedule(tcfg.ScheduleConfig(), 50),
                            torch.from_numpy(tldm.lvlb_weights(tcfg.ScheduleConfig())), model,
                            torch.from_numpy(logvar), torch.from_numpy(x0),
                            torch.from_numpy(ctx), prng.PRNGKey(11))
    loss.backward()
    _hold_grads(value, grads, model, loss)


def test_class_conditioning_matches_jax(tiny_params):
    """`train_ldm --conditioning class`'s model, the UNet with a jointly
    trained ClassEmbedder: the loss and every gradient (the embedding table's
    included) against JAX's; then two port steps move the used rows, and
    only weight decay moves the others."""
    junet, uparams = tiny_params
    jemb = jenc.ClassEmbedder(n_classes=10, embed_dim=16)
    eparams = jemb.init(jax.random.PRNGKey(1), jnp.zeros((1,), jnp.int32))["params"]
    params = {"unet": uparams, "cond": eparams}
    r = np.random.RandomState(2)
    x0 = r.randn(2, 16, 16, 4).astype(np.float32)
    ctx = np.array([[3.0], [7.0]], np.float32)
    cfg = JLDMTrainConfig()
    w = jnp.asarray(jldm.lvlb_weights(SCHED, "eps"))

    def eps_j(p, x, t, c):
        return junet.apply({"params": p["unet"]}, x, t,
                           jemb.apply({"params": p["cond"]}, c[:, 0].astype(jnp.int32)))

    def loss(p):
        return jldm.p_losses(cfg, jmake_schedule(SCHED, 50), w, eps_j, p,
                             jnp.zeros((1000,)), jnp.asarray(x0), jnp.asarray(ctx),
                             jax.random.PRNGKey(12))[0]

    value, grads = jax.jit(jax.value_and_grad(loss))(params)
    model = train_ldm.ClassConditioned(port_unet(uparams), tenc.ClassEmbedder(10, 16))
    load_flat(model, flat(params))
    tloss, _ = tldm.p_losses(tcfg.LDMTrainConfig(), make_schedule(tcfg.ScheduleConfig(), 50),
                             torch.from_numpy(np.asarray(w)), model, torch.zeros(1000),
                             torch.from_numpy(x0), torch.from_numpy(ctx), prng.PRNGKey(12))
    tloss.backward()
    _hold_grads(value, grads, model, tloss)
    table = model.cond.embedding.weight.detach().clone()
    trainer = tldm.LDMTrainer(tcfg.LDMTrainConfig(scale_lr=False, base_lr=1e-3),
                              tcfg.ScheduleConfig(), make_schedule(tcfg.ScheduleConfig(), 50),
                              model)
    state = trainer.init()
    for i in range(2):
        state, m = trainer.train_step(state, torch.from_numpy(x0), torch.from_numpy(ctx),
                                      prng.PRNGKey(i))
        assert np.isfinite(float(m["loss"]))
    moved = (model.cond.embedding.weight.detach() - table).abs().amax(dim=1)
    decayed = table * (1.0 - 1e-3 * 1e-2) ** 2      # the unused rows: weight decay only
    unused = [0, 1, 2, 4, 5, 6, 8, 9]
    torch.testing.assert_close(model.cond.embedding.weight.detach()[unused], decayed[unused],
                               atol=1e-7, rtol=1e-6)
    assert (moved[[3, 7]] > 1e-3).all()


@pytest.mark.parametrize("which", ["transformer", "bert"])
def test_encoders_match_jax(which):
    """TransformerEmbedder / BERTEmbedder at small widths on the same
    weights (flax's per-head attention kernels through the bridge)."""
    if which == "transformer":
        kw = dict(vocab_size=50, max_seq_len=9, n_embed=32, n_layer=2, heads=4)
        jm, tm = jenc.TransformerEmbedder(**kw), tenc.TransformerEmbedder(**kw)
    else:
        kw = dict(n_embed=32, n_layer=2, vocab_size=60, max_seq_len=9, heads=2)
        jm, tm = jenc.BERTEmbedder(**kw), tenc.BERTEmbedder(**kw)
    tokens = np.random.RandomState(3).randint(0, 50, (2, 7)).astype(np.int32)
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(tokens))["params"]
    params = randomize_params(params, jax.random.PRNGKey(4), 0.2)
    load_flat(tm, flat(params))
    with torch.no_grad():
        got = tm(torch.from_numpy(tokens))
    close(got, jm.apply({"params": params}, jnp.asarray(tokens)), 1e-5)
    jc = jenc.ClassEmbedder(n_classes=5, embed_dim=8)
    cp = jc.init(jax.random.PRNGKey(2), jnp.zeros((1,), jnp.int32))["params"]
    tc = load_flat(tenc.ClassEmbedder(5, 8), flat(cp))
    ids = np.array([0, 4, 2], np.int32)
    close(tc(torch.from_numpy(ids)).detach(), jc.apply({"params": cp}, jnp.asarray(ids)), 0)


def test_save_restore_resume_equals_uninterrupted(tiny_params, tmp_path):
    """Save after 2 steps of accumulation 2 with EMA and a learned logvar;
    the third step of a fresh state restored from it equals the third step
    of the run that went on, bit for bit."""
    _, params = tiny_params
    cfg = tcfg.LDMTrainConfig(use_ema=True, scale_lr=False, accum_steps=2, learn_logvar=True,
                              base_lr=1e-3, grad_clip_norm=1.0)
    sched = make_schedule(tcfg.ScheduleConfig(), 50)
    x0 = torch.from_numpy(np.random.RandomState(0).randn(2, 16, 16, 4).astype(np.float32))
    ctx = torch.zeros(2, 7, 16)

    def run(model, steps, state=None):
        tr = tldm.LDMTrainer(cfg, tcfg.ScheduleConfig(), sched, model, ckpt_dir=str(tmp_path))
        state = state or tr.init()
        for i in steps:
            state, _ = tr.train_step(state, x0, ctx, prng.fold_in(prng.PRNGKey(9), i))
        return tr, state

    tr, state = run(port_unet(params), range(2))
    tr.save(state, 2)
    _, state = run(state.params, [2], state)
    fresh = port_unet(params)
    with torch.no_grad():
        for p in fresh.parameters():
            p.add_(1.0)
    tr2 = tldm.LDMTrainer(cfg, tcfg.ScheduleConfig(), sched, fresh, ckpt_dir=str(tmp_path))
    restored = tr2.restore(2, tr2.init())
    assert restored.step == 2 and restored.opt_state.count == 1
    _, restored = run(fresh, [2], restored)
    a, b = state.params.state_dict(), restored.params.state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert all(torch.equal(state.ema_params[k], restored.ema_params[k]) for k in a)
    assert torch.equal(state.logvar, restored.logvar) and restored.step == 3


def test_one_device_only():
    with pytest.raises(NotImplementedError, match="A.13"):
        tldm.LDMTrainer(tcfg.LDMTrainConfig(), tcfg.ScheduleConfig(),
                        make_schedule(tcfg.ScheduleConfig(), 50), torch.nn.Linear(1, 1),
                        mesh=object())
    with pytest.raises(NotImplementedError, match="A.13"):
        tldm.LDMTrainer(tcfg.LDMTrainConfig(), tcfg.ScheduleConfig(),
                        make_schedule(tcfg.ScheduleConfig(), 50), torch.nn.Linear(1, 1),
                        fsdp=True)


@pytest.mark.parametrize("conditioning", ["text", "class", "none"])
def test_train_ldm_cli(conditioning, tmp_path):
    """`train_ldm --tiny --cpu --synthetic`: finite losses, a checkpoint per
    --ckpt-every, and --resume-step continuing from it as the run did."""
    argv = ["--tiny", "--cpu", "--synthetic", "--conditioning", conditioning,
            "--ckpt-dir", str(tmp_path), "--log-every", "1", "--num-classes", "10",
            "--fsdp"]
    full = train_ldm.main(argv + ["--steps", "3", "--ckpt-every", "2"])
    assert full["steps"] == 3 and len(full["metrics"]) == 3
    assert all(np.isfinite(m["loss"]) for m in full["metrics"])
    assert (tmp_path / "step_2.pt").exists() and (tmp_path / "step_3.pt").exists()
    resumed = train_ldm.main(argv + ["--steps", "3", "--resume-step", "2", "--ckpt-every", "0"])
    assert resumed["metrics"][0]["step"] == 3
    assert resumed["metrics"][0]["loss"] == full["metrics"][2]["loss"]


def test_train_ldm_and_bench_train_raise_where_not_ported(tmp_path):
    """`--data-dir` loads text and class conditioning only, as JAX's script
    does (SystemExit for superres / none; `test_torch_data_training.py`
    holds the loaders); `bench_train --what ldm` runs."""
    for conditioning in ("superres", "none"):
        with pytest.raises(SystemExit, match="--data-dir loading"):
            train_ldm.main(["--tiny", "--cpu", "--conditioning", conditioning,
                            "--data-dir", str(tmp_path), "--ckpt-dir", str(tmp_path / "ck")])
    line = bench_train.main(["--what", "ldm", "--tiny", "--cpu", "--iters", "2",
                             "--dtype", "float32"])
    assert line["metric"] == "ldm_v1_train_step_b4_float32_ema" and len(line["times"]) == 2
    assert np.isfinite(line["losses"]).all()
