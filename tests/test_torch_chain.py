"""PyTorch port, the optimization slice as a whole, held against the JAX package
on the CPU: `generation_loss` and its gradient with respect to the [B, N, S]
blend weights through the PLMS chain, the VAE decode and the CLIP loss; one
Adam step; `optimize_prompt`; and the port's SpaceTimeEngine.

The smoke config (`testbed/configs.py:smoke_pipeline_cfg`, 3 PLMS steps:
the two-evaluation first step, AB2 and AB3) with the JAX package's
`randomize_params(scale=0.2)` weights, loaded through the bridge; text
embeddings, tokens, layouts and x_T made once and handed to both packages.
Tolerance: 1e-4 relative (in norm for gradients); each UNet evaluation
agrees to ~1e-5 and the chain carries the difference through 4 evaluations
forward and back.  The JAX oracle is compiled once, at XLA's lowest backend
optimization level (the same values; the compile dominates this file).
"""
import dataclasses
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import traverse_util

from diffusion_spacetime_attn_tpu.models.clip import CLIP as JCLIP
from diffusion_spacetime_attn_tpu.pipeline import spacetime as jst
from diffusion_spacetime_attn_tpu.pipeline.losses import DCLIPLoss as JDCLIPLoss
from diffusion_spacetime_attn_tpu.pipeline.pipeline import StableDiffusion as JSD
from diffusion_spacetime_attn_tpu.testbed.configs import smoke_pipeline_cfg
from diffusion_spacetime_attn_tpu.utils.testing import randomize_params
from diffusion_spacetime_attn_tpu_torch import config as tcfg
from diffusion_spacetime_attn_tpu_torch.pipeline import spacetime as tst
from diffusion_spacetime_attn_tpu_torch.pipeline.frontend import extract_objects
from diffusion_spacetime_attn_tpu_torch.pipeline.losses import DCLIPLoss
from diffusion_spacetime_attn_tpu_torch.pipeline.pipeline import StableDiffusion
from diffusion_spacetime_attn_tpu_torch.pipeline.runners import PromptRunner
from diffusion_spacetime_attn_tpu_torch.samplers.remat import maybe_remat
from diffusion_spacetime_attn_tpu_torch.serving.server import SpaceTimeEngine, TextToImageEngine
from diffusion_spacetime_attn_tpu_torch.utils.tokenizer import make_clip_tokenizer

RTOL = 1e-4


def port_cfg(c):
    cls = getattr(tcfg, type(c).__name__)
    return cls(**{f.name: (port_cfg(getattr(c, f.name))
                           if dataclasses.is_dataclass(getattr(c, f.name))
                           else getattr(c, f.name))
                  for f in dataclasses.fields(c)})


def flat(params):
    return {k: np.asarray(v) for k, v in
            traverse_util.flatten_dict(jax.device_get(params), sep="/").items()}


def rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The suite runs several test processes side by side on few cores,
    where torch's spinning intra-op threads slow each other down many-fold;
    this module's torch work is small, so it takes one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def pair():
    """JAX and port bundles, losses and inputs (2 prompts x 2 objects, the
    second prompt with one padded object) on the smoke config."""
    cfg = smoke_pipeline_cfg(num_steps=3)
    sd = JSD.create(cfg, jax.random.PRNGKey(0), abstract=True)
    sd = dataclasses.replace(
        sd,
        unet_params=randomize_params(sd.unet_params, jax.random.PRNGKey(1), 0.2),
        vae_params=randomize_params(sd.vae_params, jax.random.PRNGKey(2), 0.2),
        text_params=randomize_params(sd.text_params, jax.random.PRNGKey(3), 0.2))
    lc = cfg.loss_clip
    cmodel = JCLIP(lc)
    cparams = jax.eval_shape(cmodel.init, jax.random.PRNGKey(4), jnp.zeros((1, 14, 14, 3)),
                             jnp.zeros((1, lc.text.max_len), jnp.int32))["params"]
    jloss = JDCLIPLoss(cmodel, randomize_params(cparams, jax.random.PRNGKey(5), 0.2))
    pcfg = port_cfg(cfg)
    tsd = StableDiffusion.from_flat(pcfg, flat(sd.unet_params), flat(sd.vae_params),
                                    flat(sd.text_params), device="cpu")
    tloss = DCLIPLoss.from_flat(pcfg.loss_clip, flat(jloss.params), device="cpu")

    B, N, L, V = 2, 2, cfg.text_encoder.max_len, cfg.text_encoder.vocab_size
    r = np.random.RandomState(0)

    def ids(n, vocab, length):
        a = r.randint(1, vocab - 1, size=(n, length)).astype(np.int32)
        a[:, -1] = vocab - 1
        return a

    emb = np.asarray(sd.encode_text(jnp.asarray(ids(B + B + B * N, V, L))))
    arrays = dict(
        cond=emb[:B], uncond=emb[B:2 * B], local_contexts=emb[2 * B:].reshape(B, N, L, -1),
        centers=np.array([[[0.3, 0.4], [0.7, 0.6]], [[0.5, 0.2], [0.5, 0.8]]], np.float32),
        active=np.array([[1, 1], [1, 0]], np.float32),
        caption_tokens=ids(B, lc.text.vocab_size, lc.text.max_len),
        object_tokens=ids(B * N, lc.text.vocab_size, lc.text.max_len).reshape(B, N, -1),
        x_T=r.randn(B, 8, 8, 4).astype(np.float32))
    jin = jst.SpaceTimeInputs(**{k: jnp.asarray(v) for k, v in arrays.items()})
    tin = tst.SpaceTimeInputs(**{k: torch.tensor(v) for k, v in arrays.items()})
    return dict(cfg=cfg, st=cfg.spacetime, sd=sd, jloss=jloss, jin=jin, tsd=tsd, tloss=tloss,
                tin=tin)


@pytest.fixture(scope="module")
def jax_vg(pair):
    """jax.value_and_grad of the JAX generation_loss, jitted once (the
    chain's compile dominates this file's time)."""
    p = pair
    vg = jax.value_and_grad(
        lambda c: jst.generation_loss(c, p["sd"], p["jloss"], p["jin"], p["st"]), has_aux=True)
    coef = jst.init_coef(p["jin"].active, p["st"].num_steps, p["st"].init_coef)
    return jax.jit(vg).lower(coef).compile({"xla_backend_optimization_level": 0,
                                            "xla_llvm_disable_expensive_passes": True})


@pytest.fixture(scope="module")
def jax_loss_and_grad(pair, jax_vg):
    p = pair
    coef = jst.init_coef(p["jin"].active, p["st"].num_steps, p["st"].init_coef)
    (loss, _), grad = jax_vg(coef)
    return np.asarray(coef), float(loss), np.asarray(grad)


def _port_loss_and_grad(p, coef, remat=True):
    c = torch.tensor(coef).requires_grad_(True)
    loss, images = tst.generation_loss(c, p["tsd"], p["tloss"], p["tin"], p["st"], remat=remat)
    loss.backward()
    return loss.item(), c.grad.numpy(), images.detach()


@pytest.fixture(scope="module")
def port_remat(pair, jax_loss_and_grad):
    return _port_loss_and_grad(pair, jax_loss_and_grad[0], remat=True)


def test_init_coef_matches_jax():
    active = np.array([[1.0, 1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 0.0]], np.float32)
    want = np.asarray(jst.init_coef(jnp.asarray(active), 50, 5.0))
    got = tst.init_coef(torch.from_numpy(active), 50, 5.0)
    assert got.shape == (3, 3, 50)
    np.testing.assert_array_equal(got.numpy(), want)


def test_generation_loss_and_coef_grad_match_jax(jax_loss_and_grad, port_remat):
    _, jl, jg = jax_loss_and_grad
    tl, tg, _ = port_remat
    assert abs(tl - jl) <= RTOL * abs(jl), (tl, jl)
    assert rel(tg, jg) <= RTOL, rel(tg, jg)
    assert np.abs(jg).max() > 0


def test_padded_objects_get_zero_grad(port_remat):
    g = port_remat[1]
    assert np.all(g[1, 1] == 0.0)          # prompt 1, object 1 is padding
    assert np.abs(g[1, 0]).max() > 0 and np.abs(g[0]).max() > 0


def test_remat_on_and_off_give_the_same_loss_and_grad(pair, jax_loss_and_grad, port_remat):
    tl, tg, img = port_remat
    l0, g0, img0 = _port_loss_and_grad(pair, jax_loss_and_grad[0], remat=False)
    assert l0 == tl
    torch.testing.assert_close(img, img0, atol=0, rtol=0)
    np.testing.assert_allclose(tg, g0, atol=1e-7, rtol=1e-6)


def test_remat_policy_names_raise():
    """A name that is no policy raises, naming the two there are (JAX's
    `jax.checkpoint_policies` names among them); False is the identity."""
    for name in ("dots_saveable", "everything", "nothing_saveable"):
        with pytest.raises(ValueError, match="dots.*dots_nb"):
            maybe_remat(lambda x, t, i: x, name)
    f = lambda x, t, i: x  # noqa: E731
    assert maybe_remat(f, False) is f


@pytest.fixture(scope="module")
def jax_policy_loss_and_grad(pair, jax_loss_and_grad):
    """JAX's generation_loss and dcoef with the chain under each selective
    policy (its samplers' `maybe_remat` handed the policy where the loss
    asks for per-step remat), compiled as `jax_vg` is."""
    from diffusion_spacetime_attn_tpu.samplers import remat as jremat

    p, coef = pair, jax_loss_and_grad[0]
    out = {}
    for policy in ("dots", "dots_nb"):
        vg = jax.value_and_grad(
            lambda c: jst.generation_loss(c, p["sd"], p["jloss"], p["jin"], p["st"]),
            has_aux=True)
        with mock.patch.object(jremat, "maybe_remat",
                               lambda f, r, policy=policy, real=jremat.maybe_remat:
                               real(f, policy if r is True else r)):
            fn = jax.jit(vg).lower(jnp.asarray(coef)).compile(
                {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True})
        (loss, _), grad = fn(jnp.asarray(coef))
        out[policy] = float(loss), np.asarray(grad)
    return out


@pytest.mark.parametrize("policy", ["dots", "dots_nb"])
def test_remat_policies_match_remat_true_and_jax(pair, jax_loss_and_grad, port_remat,
                                                 jax_policy_loss_and_grad, policy):
    """The selective policies save matmul outputs instead of recomputing
    them: the loss and dcoef equal `remat=True`'s bit for bit, and JAX's
    chain under the same policy within the chain's tolerance."""
    tl, tg, img = port_remat
    pl, pg, pimg = _port_loss_and_grad(pair, jax_loss_and_grad[0], remat=policy)
    assert pl == tl
    np.testing.assert_array_equal(pg, tg)
    torch.testing.assert_close(pimg, img, atol=0, rtol=0)
    jl, jg = jax_policy_loss_and_grad[policy]
    assert abs(pl - jl) <= RTOL * abs(jl), (pl, jl)
    assert rel(pg, jg) <= RTOL, rel(pg, jg)


def test_remat_recomputes_each_evaluation_in_the_backward():
    calls = []

    def eps_fn(x, t, i):
        calls.append(i)
        return x * w

    w = torch.tensor(2.0, requires_grad=True)
    f = maybe_remat(eps_fn, True)
    f(torch.ones(3), 0, 7).sum().backward()
    assert calls == [7, 7] and float(w.grad) == 3.0
    with torch.no_grad():
        f(torch.ones(3), 0, 8)
    assert calls == [7, 7, 8]


def test_one_adam_step_equals_optax_adam():
    st = tcfg.SpaceTimeConfig()
    r = np.random.RandomState(1)
    coef0 = r.rand(2, 4, 50).astype(np.float32)
    grads = [r.randn(2, 4, 50).astype(np.float32) * s for s in (1.0, 1e-3)]
    opt = optax.adam(st.lr)
    state, jc = opt.init(jnp.asarray(coef0)), jnp.asarray(coef0)
    c = torch.from_numpy(coef0.copy()).requires_grad_(True)
    topt = tst.make_optimizer(c, st)
    for g in grads:
        upd, state = opt.update(jnp.asarray(g), state, jc)
        jc = optax.apply_updates(jc, upd)
        c.grad = torch.from_numpy(g)
        topt.step()
        np.testing.assert_allclose(c.detach().numpy(), np.asarray(jc), atol=1e-7, rtol=1e-6)


@pytest.fixture(scope="module")
def optimized(pair, jax_vg):
    """JAX's optimize_prompt, its train step and final forward built on the
    one jitted value_and_grad (the same math as `make_train_step` and
    `make_final_forward`: value_and_grad, then optax.adam), and the port's."""
    p = pair
    opt = optax.adam(p["st"].lr)

    def train_step(params, coef, opt_state, inputs):
        (loss, images), g = jax_vg(coef)
        upd, opt_state = opt.update(g, opt_state, coef)
        return optax.apply_updates(coef, upd), opt_state, loss, images

    jimg, jcoef, jlosses = jst.optimize_prompt(
        p["sd"], p["jloss"], p["jin"], p["st"], train_step=train_step, optimizer=opt,
        final_forward=lambda params, coef, inputs: jax_vg(coef)[0])
    timg, tcoef, tlosses = tst.optimize_prompt(p["tsd"], p["tloss"], p["tin"], p["st"])
    return (np.asarray(jimg), np.asarray(jcoef), np.asarray(jlosses)), (timg, tcoef, tlosses)


def test_optimize_prompt_matches_jax(pair, optimized):
    (jimg, jcoef, jlosses), (timg, tcoef, tlosses) = optimized
    assert tlosses.shape == (pair["st"].epochs,)
    np.testing.assert_allclose(tlosses.numpy(), jlosses, rtol=RTOL)
    np.testing.assert_allclose(tcoef.numpy(), jcoef, atol=1e-6, rtol=RTOL)
    np.testing.assert_allclose(timg.numpy(), jimg, atol=RTOL, rtol=RTOL)
    init = tst.init_coef(pair["tin"].active, pair["st"].num_steps, pair["st"].init_coef)
    moved = (tcoef - init).abs()
    assert float(moved[pair["tin"].active > 0].min()) > 1e-4   # Adam moved every active slot
    assert float(moved[1, 1].max()) == 0.0                     # and no padded one


def test_final_forward_only_gives_the_same_image(pair, optimized):
    """The last epoch's image comes from its forward, before the last Adam
    step, so skipping that step's backward changes nothing the caller sees
    but the returned coef (which then is the one that made the image)."""
    p = pair
    timg, tcoef, tlosses = optimized[1]
    seen = []
    img, coef, losses = tst.optimize_prompt(p["tsd"], p["tloss"], p["tin"], p["st"],
                                            final_forward_only=False,
                                            on_epoch=lambda e, im: seen.append(e))
    assert seen == list(range(p["st"].epochs))
    torch.testing.assert_close(img, timg, atol=0, rtol=0)
    torch.testing.assert_close(losses, tlosses, atol=0, rtol=0)
    assert float((coef - tcoef).abs().max()) > 0     # the dead update moved it


# ---------------------------------------------------------------- engine


@pytest.fixture(scope="module")
def engines():
    """(SpaceTimeEngine over a PromptRunner, vanilla TextToImageEngine) on
    the smoke config at CLIP's vocabulary size, seeded random weights."""
    base = smoke_pipeline_cfg(num_steps=3)
    clip_vocab = lambda t: dataclasses.replace(t, vocab_size=49408)  # noqa: E731
    cfg = port_cfg(dataclasses.replace(
        base, text_encoder=clip_vocab(base.text_encoder),
        loss_clip=dataclasses.replace(base.loss_clip, text=clip_vocab(base.loss_clip.text))))
    sd = StableDiffusion.create(cfg, seed=0, device="cpu", scale=0.2)
    loss = DCLIPLoss.create(cfg.loss_clip, seed=9, device="cpu", scale=0.2)
    tok = make_clip_tokenizer(max_len=cfg.text_encoder.max_len)
    ctok = make_clip_tokenizer(max_len=cfg.loss_clip.text.max_len)

    def layout(prompt):
        # the front end's mentions at fixed centers; {} (no layout) without one
        mentions = extract_objects(prompt)[1]
        return {m.phrase: c for m, c in zip(mentions, [(0.3, 0.3), (0.7, 0.7)])}

    L, Lc = cfg.text_encoder.max_len, cfg.loss_clip.text.max_len
    runner = PromptRunner(sd=sd, clip_loss=loss, layout=layout,
                          clip_tokenize=lambda t: ctok.pad_to(ctok.encode(t), Lc),
                          text_tokenize=lambda t: tok.pad_to(tok.encode(t), L),
                          cfg=cfg.spacetime, mode="spacetime")
    engine = SpaceTimeEngine(runner=runner, batch_size=2)
    vanilla = TextToImageEngine(sd=sd, tokenize=lambda t: tok.pad_to(tok.encode(t), L),
                                batch_size=1)
    return engine, vanilla


def test_spacetime_engine_shapes_and_seed_determinism(engines):
    eng, _ = engines
    a = eng.generate_batch(["a cat and a dog", "a dog"], [1, 2])
    assert a.shape == (2, 32, 32, 3) and a.dtype == np.uint8
    b = eng.generate_batch(["a cat and a dog"], [1])       # beside a pad row
    np.testing.assert_array_equal(a[0], b[0])
    c = eng.generate_batch(["a cat and a dog"], [3])
    assert (c[0] != a[0]).any()
    with pytest.raises(ValueError):
        eng.generate_batch(["a"] * 3, [0] * 3)


def test_spacetime_engine_failed_layout_row_is_vanilla(engines):
    """A prompt whose layout fails runs with no active object: its coef
    stays 0, the blend and the local loss are exact no-ops, and its image is
    the vanilla engine's for the same seed (up to one uint8 step: the text
    encoder and UNet see batches of another size)."""
    eng, vanilla = engines
    images, coef, losses = eng.optimize_batch(["no layout"], [4])
    assert float(coef.abs().max()) == 0.0 and bool(torch.isfinite(losses).all())
    a = eng.generate_batch(["no layout"], [4])
    b = vanilla.generate_batch(["no layout"], [4])
    assert int(np.abs(a.astype(int) - b.astype(int)).max()) <= 1
