"""PyTorch port, JAX's keys for every stochastic draw: `utils/prng.py`
`split` and `categorical` held bit for bit against jax 0.9's partitionable
threefry (`jax.random.split`, `jax.random.categorical`) over many keys, key
counts, shapes and axes, `split` of a `split` included; and the rule that no
port module draws from a `torch.Generator` where JAX draws from a key.

The draws' call sites are held against JAX in their modules' tests: DDIM's
σ·z (`test_torch_samplers.py`), the GMM head's categorical
(`test_torch_layout.py`), txt2img's x_T (`test_torch_pipeline.py`), and DDPM,
the VAE sample, img2img / inpaint and `sample_diffusion`
(`test_torch_img2img.py`).  Tolerance: none; keys, bits and indices are
equal.
"""
import ast
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from diffusion_spacetime_attn_tpu_torch.utils import prng

ROOT = Path(__file__).resolve().parent.parent


def _key(seed):
    return jax.random.PRNGKey(seed), prng.PRNGKey(seed)


@pytest.mark.parametrize("num", [1, 2, 3, 5, 8, 17, 100, 1000])
def test_split_equals_jax_bit_for_bit(num):
    for seed in (0, 1, 7, 42, 2 ** 31 - 1, -5):
        jk, tk = _key(seed)
        np.testing.assert_array_equal(prng.split(tk, num), np.asarray(jax.random.split(jk, num)))


def test_split_of_split_and_its_uses_equal_jax():
    """The key trees the samplers walk: split(split(k)[i], n), a [2, S]
    reshape (DDIM), fold_in of a split key, and draws from split keys."""
    jk, tk = _key(2025)
    for i, (jc, tc) in enumerate(zip(jax.random.split(jk, 4), prng.split(tk, 4))):
        np.testing.assert_array_equal(prng.split(tc, 6), np.asarray(jax.random.split(jc, 6)))
        np.testing.assert_array_equal(prng.split(tc, 10).reshape(2, 5, 2),
                                      np.asarray(jax.random.split(jc, 10).reshape(2, 5, -1)))
        np.testing.assert_array_equal(prng.fold_in(tc, i),
                                      np.asarray(jax.random.fold_in(jc, i)))
        np.testing.assert_array_equal(prng.bits(tc, (3, 5)),
                                      np.asarray(jax.random.bits(jc, (3, 5))))
        np.testing.assert_allclose(prng.normal(tc, (4, 8, 8, 4)),
                                   np.asarray(jax.random.normal(jc, (4, 8, 8, 4))),
                                   rtol=0, atol=2e-6)
    a, b, c = prng.split(tk, 3)
    ja, jb, jc = jax.random.split(jk, 3)
    np.testing.assert_array_equal(np.stack([a, b, c]), np.asarray(jnp.stack([ja, jb, jc])))


@pytest.mark.parametrize("shape, axis", [((10,), -1), ((6, 5), -1), ((6, 5), 0),
                                         ((2, 7, 5), -1), ((2, 7, 5), 1), ((3, 1000), -1)])
def test_categorical_equals_jax(shape, axis):
    """The same indices for 40 keys; logits of several scales, a -inf entry
    (log of a clipped 0) and ties among them."""
    mismatches = 0
    for seed in range(40):
        r = np.random.RandomState(seed)
        logits = (r.randn(*shape) * (0.1, 1.0, 10.0)[seed % 3]).astype(np.float32)
        if seed % 5 == 0:
            logits.reshape(-1)[0] = np.float32(np.log(1e-12))
        jk, tk = _key(seed)
        got = prng.categorical(tk, logits, axis=axis)
        want = np.asarray(jax.random.categorical(jk, jnp.asarray(logits), axis=axis))
        assert got.shape == want.shape and got.dtype == want.dtype
        mismatches += int((got != want).sum())
    assert mismatches == 0


def test_gumbel_equals_jax_within_an_ulp():
    """−log(−log(u)), u on [tiny, 1): numpy's log against XLA's."""
    for seed in range(5):
        jk, tk = _key(seed)
        want = np.asarray(jax.random.gumbel(jk, (4096,)))
        np.testing.assert_allclose(prng.gumbel(tk, (4096,)), want, rtol=4e-7, atol=4e-7)


def _draws(path: Path):
    """(line, call) of each torch.Generator, torch.randn* / rand* and
    torch.multinomial / normal_ call in a module."""
    names = {"Generator", "randn", "randn_like", "rand", "rand_like", "randint",
             "multinomial", "normal"}
    out = []
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
                and isinstance(node.func.value, ast.Name) and node.func.value.id == "torch"
                and node.func.attr in names):
            out.append((node.lineno, node.func.attr))
    return out


def test_no_torch_generator_draw_on_a_path_jax_draws_from_a_key():
    """Every torch draw left in the port seeds weights (`utils/testing.py`
    `randomize_`, the layout predictor's `init_layout_`), which the JAX
    package also draws otherwise; noise and samples come from keys."""
    package = ROOT / "diffusion_spacetime_attn_tpu_torch"
    found = {str(p.relative_to(package)): _draws(p) for p in sorted(package.rglob("*.py"))}
    found = {k: v for k, v in found.items() if v}
    assert set(found) == {"utils/testing.py", "models/layout/model.py"}, found
