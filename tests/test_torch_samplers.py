"""PyTorch port, DDIM and DPM-Solver++ held against the JAX package on the CPU.

Each chain runs the same smooth eps function in both packages (written once
in jax.numpy and once in torch) at the smoke config's latent shape
[2, 8, 8, 4], f32, from the same numpy x_T, so what is compared is the
sampler's own arithmetic: the schedule positions, the multistep history,
DPM's order drop below 15 steps and the order-1 / DDIM identity.  The eps
function closes over a [B, S] weight read at the loop position, as the
method's blend weights are, and the gradient of a loss on the final latent
in those weights goes through each chain under remat in both packages.
Tolerance 1e-5 on latents (f32, a few ulp per step through 16 steps);
1e-4 relative on gradients.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusion_spacetime_attn_tpu.config import ScheduleConfig as JScheduleConfig
from diffusion_spacetime_attn_tpu.ops.schedule import make_schedule as jmake_schedule
from diffusion_spacetime_attn_tpu.samplers.ddim import ddim_sample as jddim
from diffusion_spacetime_attn_tpu.samplers.dpm_solver import dpm_solver_sample as jdpm
from diffusion_spacetime_attn_tpu.samplers.plms import plms_sample as jplms
from diffusion_spacetime_attn_tpu_torch.config import ScheduleConfig
from diffusion_spacetime_attn_tpu_torch.ops.schedule import make_schedule
from diffusion_spacetime_attn_tpu_torch.samplers.ddim import ddim_sample
from diffusion_spacetime_attn_tpu_torch.samplers.dpm_solver import dpm_solver_sample
from diffusion_spacetime_attn_tpu_torch.samplers.plms import plms_sample
from diffusion_spacetime_attn_tpu_torch.utils import prng

ATOL = 1e-5
GRAD_RTOL = 1e-4
SHAPE = (2, 8, 8, 4)

# name -> (JAX chain, port chain), each (eps_fn, x_T, sched, remat) -> x_0
CHAINS = {
    "ddim": (lambda e, x, s, r: jddim(e, x, s, remat=r),
             lambda e, x, s, r: ddim_sample(e, x, s, remat=r)),
    "dpm1": (lambda e, x, s, r: jdpm(e, x, s, order=1, remat=r),
             lambda e, x, s, r: dpm_solver_sample(e, x, s, order=1, remat=r)),
    "dpm2": (lambda e, x, s, r: jdpm(e, x, s, order=2, remat=r),
             lambda e, x, s, r: dpm_solver_sample(e, x, s, order=2, remat=r)),
    "plms": (lambda e, x, s, r: jplms(e, x, s, remat=r),
             lambda e, x, s, r: plms_sample(e, x, s, remat=r)),
}


def jax_eps(w):
    def eps_fn(x, t, i):
        c = w[:, i][:, None, None, None]
        return jnp.tanh(0.8 * x * (1.0 + 0.1 * c) + 0.001 * t) + 0.05 * x
    return eps_fn


def torch_eps(w):
    def eps_fn(x, t, i):
        c = w[:, i][:, None, None, None]
        return torch.tanh(0.8 * x * (1.0 + 0.1 * c) + 0.001 * t) + 0.05 * x
    return eps_fn


def inputs(S, seed=0):
    r = np.random.RandomState(seed)
    return r.randn(*SHAPE).astype(np.float32), r.rand(SHAPE[0], S).astype(np.float32)


def run_both(name, S, remat=False):
    x_T, w = inputs(S)
    jchain, tchain = CHAINS[name]
    jz = jchain(jax_eps(jnp.asarray(w)), jnp.asarray(x_T), jmake_schedule(JScheduleConfig(), S),
                remat)
    tz = tchain(torch_eps(torch.from_numpy(w)), torch.from_numpy(x_T),
                make_schedule(ScheduleConfig(), S), remat)
    return np.asarray(jz), tz.numpy(), x_T


@pytest.mark.parametrize("S", [6, 16])
@pytest.mark.parametrize("name", ["ddim", "dpm1", "dpm2"])
def test_sampler_latents_match_jax(name, S):
    """S = 6 drops DPM's last update to first order, S = 16 does not."""
    jz, tz, x_T = run_both(name, S)
    np.testing.assert_allclose(tz, jz, atol=ATOL, rtol=ATOL)
    assert np.abs(jz - x_T).max() > 0.1


def test_dpm_order_drop_only_below_15_steps():
    """With the drop disabled the 6-step chain moves, the 16-step one not."""
    for S, moves in ((6, True), (16, False)):
        x_T, w = inputs(S)
        sched = make_schedule(ScheduleConfig(), S)
        eps = torch_eps(torch.from_numpy(w))
        a = dpm_solver_sample(eps, torch.from_numpy(x_T), sched, remat=False)
        b = dpm_solver_sample(eps, torch.from_numpy(x_T), sched, remat=False,
                              lower_order_final=False)
        assert bool((a != b).any()) == moves, S


@pytest.mark.parametrize("S", [6, 16])
def test_dpm_order1_equals_ddim(S):
    x_T, w = inputs(S)
    sched = make_schedule(ScheduleConfig(), S)
    eps = torch_eps(torch.from_numpy(w))
    a = dpm_solver_sample(eps, torch.from_numpy(x_T), sched, order=1, remat=False)
    b = ddim_sample(eps, torch.from_numpy(x_T), sched, remat=False)
    np.testing.assert_allclose(a.numpy(), b.numpy(), atol=ATOL, rtol=ATOL)


def test_dpm_order_must_be_1_or_2():
    sched = make_schedule(ScheduleConfig(), 4)
    with pytest.raises(ValueError):
        dpm_solver_sample(lambda x, t, i: x, torch.zeros(SHAPE), sched, order=3)


@pytest.mark.parametrize("name,evals", [("plms", 7), ("ddim", 6), ("dpm2", 6)])
def test_evaluations_and_loop_positions_per_chain(name, evals):
    """PLMS evaluates S + 1 times (both first-step evaluations at position
    0), DDIM and DPM S times; each position's weight column is read."""
    seen = []

    def eps(x, t, i):
        seen.append((int(t), i))
        return 0.1 * x

    CHAINS[name][1](eps, torch.ones(SHAPE), make_schedule(ScheduleConfig(), 6), False)
    assert len(seen) == evals
    assert sorted({i for _, i in seen}) == list(range(6))
    assert seen[0] == (831, 0)       # the noisiest of 6 steps: (1000 // 6)·5 + 1


def test_sample_from_rejects_the_jax_scripts_dpm_solver_name():
    """`scripts/method_eval_testbed.py --sampler dpm_solver` reaches
    `StableDiffusion.sample_from`, which knows only plms, ddim and dpm: both
    packages raise ValueError for it."""
    from diffusion_spacetime_attn_tpu.pipeline.pipeline import StableDiffusion as JSD
    from diffusion_spacetime_attn_tpu_torch.pipeline.pipeline import StableDiffusion

    jsd = object.__new__(JSD)
    tsd = object.__new__(StableDiffusion)
    for sd, x in ((jsd, jnp.zeros(SHAPE)), (tsd, torch.zeros(SHAPE))):
        with pytest.raises(ValueError, match="unknown sampler"):
            sd.sample_from(lambda x, t, i: x, x, sampler="dpm_solver")


@pytest.mark.parametrize("S", [6, 16])
@pytest.mark.parametrize("name", ["ddim", "dpm2", "plms"])
def test_weight_gradient_through_chain_with_remat_matches_jax(name, S):
    x_T, w = inputs(S, seed=1)
    target = np.random.RandomState(2).randn(*SHAPE).astype(np.float32)
    jchain, tchain = CHAINS[name]
    jsched = jmake_schedule(JScheduleConfig(), S)

    def jloss(w):
        z = jchain(jax_eps(w), jnp.asarray(x_T), jsched, True)
        return jnp.sum((z - target) ** 2)

    jl, jg = jax.value_and_grad(jloss)(jnp.asarray(w))
    sched = make_schedule(ScheduleConfig(), S)
    grads = []
    for remat in (True, False):
        tw = torch.from_numpy(w).requires_grad_(True)
        tl = ((tchain(torch_eps(tw), torch.from_numpy(x_T), sched, remat)
               - torch.from_numpy(target)) ** 2).sum()
        tl.backward()
        grads.append(tw.grad.numpy())
        assert abs(tl.item() - float(jl)) <= GRAD_RTOL * abs(float(jl))
    jg = np.asarray(jg)
    assert np.linalg.norm(grads[0] - jg) <= GRAD_RTOL * np.linalg.norm(jg)
    assert np.abs(jg).min() > 0                # every step's weight reaches the loss
    np.testing.assert_allclose(grads[0], grads[1], atol=1e-7, rtol=1e-6)


def test_ddim_eta_schedule_matches_jax_and_generator_noise_is_seeded():
    """With eta > 0 and no key both packages run the deterministic update
    with the schedule's sigmas; with a key both add σ·z drawn from
    split(key, 2S)[0, i] (`utils/prng.py`): the same chain as JAX's within
    the chain tolerance, the same for the same key, another for another."""
    S = 6
    x_T, w = inputs(S)
    jsched = jmake_schedule(JScheduleConfig(), S, eta=1.0)
    jz = jddim(jax_eps(jnp.asarray(w)), jnp.asarray(x_T), jsched, remat=False)
    sched = make_schedule(ScheduleConfig(), S, eta=1.0)
    eps = torch_eps(torch.from_numpy(w))
    tz = ddim_sample(eps, torch.from_numpy(x_T), sched, remat=False)
    np.testing.assert_allclose(tz.numpy(), np.asarray(jz), atol=ATOL, rtol=ATOL)
    assert float(sched.sigmas.max()) > 0

    def noisy(seed):
        return ddim_sample(eps, torch.from_numpy(x_T), sched, rng=prng.PRNGKey(seed),
                           remat=False)

    a, b, c = noisy(3), noisy(3), noisy(4)
    ja = jddim(jax_eps(jnp.asarray(w)), jnp.asarray(x_T), jsched, rng=jax.random.PRNGKey(3),
               remat=False)
    np.testing.assert_allclose(a.numpy(), np.asarray(ja), atol=ATOL, rtol=ATOL)
    assert a.shape == SHAPE and bool(torch.isfinite(a).all())
    torch.testing.assert_close(a, b, atol=0, rtol=0)
    assert float((a - c).abs().max()) > 1e-3 and float((a - tz).abs().max()) > 1e-3