"""PyTorch port, the model axis (Megatron tensor parallelism over
`parallel/mesh.py`'s ('data', 'model') mesh, `parallel/sharding.py`
`shard_params`, `parallel/tensor.py`), held against the JAX package's TP
mesh (`make_mesh(data=2, model=2)` + `shard_params`, GSPMD's collectives)
on the CPU:

  * `partition_specs` equals JAX's on `test_parallel.py`'s TINY UNet and on
    the smoke CLIP, parameter by parameter (JAX's [in, out] kernels read
    transposed; a column-parallel bias, which GSPMD slices with its output,
    is ("model",) in the port, replicated in JAX's spec);
  * the TINY UNet forward on sharded weights equals JAX's TP forward at
    JAX's own `atol=2e-5` (`test_parallel.py:56`);
  * `compile_sharded_unet.py`'s `main_tp` program (B 4, N 2, L 7, radius
    0.2, coef 1.25, loss Σ eps²) with the kernel flags on (their plain
    versions here): the parameter gradients (gathered whole, summed over
    'data') and dcoef within 1e-4 relative in norm of `jax.grad` on JAX's
    (2, 2) mesh, above a 1e-6 floor of the global norm (a bias before a
    per-channel GroupNorm has a rounding-noise gradient,
    `test_torch_parallel_training.py`); the replicated gradients and dcoef
    equal in bits across the model ranks; 3 all-reduces per transformer
    block forward, 4 backward (the block's three inputs and coef);
  * a CLIP text tower of 3 heads at M = 2: its attention stays whole, its
    MLP splits, and its forward equals JAX's TP forward;
  * the rank layout d·M + m: rows, noise and gathers of the data
    coordinate, the LDMTrainer replicated over 'model' (lr over data·model,
    FSDP over the data group, one checkpoint written);
  * `SpaceTimeEngine` over (1, 2) and (2, 2) within one uint8 level of one
    process, with the same coef on every rank.

One spawn of 4 gloo CPU ranks (data 2 x model 2; `tests/helpers/
torch_ranks.py`) runs every case while the JAX side compiles.  Inputs are
seeded numpy; JAX's weights reach the port through the weight bridge.
Torch takes one thread in each process.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from helpers.torch_ranks import Ranks
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as P

from diffusion_spacetime_attn_tpu.config import CLIPConfig as JCLIPConfig
from diffusion_spacetime_attn_tpu.config import CLIPTextConfig as JCLIPTextConfig
from diffusion_spacetime_attn_tpu.config import CLIPVisionConfig as JCLIPVisionConfig
from diffusion_spacetime_attn_tpu.config import UNetConfig as JUNetConfig
from diffusion_spacetime_attn_tpu.models.clip import CLIP as JCLIP
from diffusion_spacetime_attn_tpu.models.clip import CLIPTextTower as JCLIPTextTower
from diffusion_spacetime_attn_tpu.models.unet import UNet as JUNet
from diffusion_spacetime_attn_tpu.ops.attention import SpatialControl as JSpatialControl
from diffusion_spacetime_attn_tpu.parallel.mesh import data_sharding
from diffusion_spacetime_attn_tpu.parallel.mesh import make_mesh as jmake_mesh
from diffusion_spacetime_attn_tpu.parallel.sharding import partition_specs as jpartition_specs
from diffusion_spacetime_attn_tpu.parallel.sharding import shard_params as jshard_params
from diffusion_spacetime_attn_tpu.utils.testing import randomize_params
from diffusion_spacetime_attn_tpu_torch import config as tcfg
from diffusion_spacetime_attn_tpu_torch.models.clip import CLIP
from diffusion_spacetime_attn_tpu_torch.models.unet import UNet
from diffusion_spacetime_attn_tpu_torch.parallel.sharding import partition_specs
from diffusion_spacetime_attn_tpu_torch.utils import prng
from diffusion_spacetime_attn_tpu_torch.utils.weights import torch_key
from test_torch_parallel import smoke_cfg
from test_torch_pipeline import flat, port_cfg

TINY = JUNetConfig(model_channels=32, channel_mult=(1, 2), num_res_blocks=1,
                   attention_resolutions=(1, 2), num_heads=2, context_dim=16)
CLIP3 = JCLIPTextConfig(width=48, layers=2, heads=3, vocab_size=100, max_len=7)
B, N, L = 4, 2, 7
CASES = ["tp_layout", "tp_unet_fwd", "tp_unet_grad", "tp_clip", "tp_engine"]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def jmesh():
    return jmake_mesh(data=2, model=2, devices=jax.devices()[:4])


def main_tp_inputs():
    """`main_tp`'s controlled program, its zeros replaced by seeded draws."""
    r = np.random.RandomState(0)
    return dict(x=r.randn(2 * B, 16, 16, 4).astype(np.float32),
                t=np.full((2 * B,), 981, np.int32),
                ctx=r.randn(2 * B, L, 16).astype(np.float32),
                local_contexts=(r.randn(B, N, L, 16) * 0.5).astype(np.float32),
                centers=r.rand(B, N, 2).astype(np.float32),
                coef=np.full((B, N), 1.25, np.float32), active=np.ones((B, N), np.float32))


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """The inputs, the ranks (started first), then JAX's TP programs."""
    d = str(tmp_path_factory.mktemp("tp_ranks"))
    junet = JUNet(TINY, radius=0.2)
    g = main_tp_inputs()
    jcontrol = JSpatialControl(**{k: jnp.asarray(g[k]) for k in
                                  ("local_contexts", "centers", "coef", "active")})
    shapes = jax.eval_shape(junet.init, jax.random.PRNGKey(0), jnp.asarray(g["x"]),
                            jnp.asarray(g["t"]), jnp.asarray(g["ctx"]), jcontrol)["params"]
    uparams = randomize_params(shapes, jax.random.PRNGKey(1), 0.1)
    r = np.random.RandomState(1)
    fwd = dict(x=r.randn(4, 16, 16, 4).astype(np.float32), t=np.full((4,), 981, np.int32),
               ctx=r.randn(4, L, 16).astype(np.float32))
    ucfg = port_cfg(TINY)
    kernels = tcfg.UNetConfig(**{**ucfg.__dict__, "use_fused_ff": True,
                                 "use_fused_control": True})
    jtower = JCLIPTextTower(CLIP3)
    ids = np.random.RandomState(2).randint(1, 99, (4, CLIP3.max_len)).astype(np.int32)
    ids[:, -1] = 99                                   # EOT: the argmax
    cshapes = jax.eval_shape(jtower.init, jax.random.PRNGKey(0), jnp.asarray(ids))["params"]
    cparams = randomize_params(cshapes, jax.random.PRNGKey(3), 0.2)
    from diffusion_spacetime_attn_tpu_torch.config import LDMTrainConfig

    toy_ldm = dict(state=_toy_state(), x0=np.ones((4, 4, 4, 2), np.float32),
                   ctx=np.array([[3.0], [7.0], [3.0], [1.0]], np.float32), classes=(10, 8),
                   key=prng.PRNGKey(1), vector=True,
                   cfg=LDMTrainConfig(batch_size=2, base_lr=1e-3, scale_lr=True, use_ema=False))
    inputs = {"unet": dict(cfg=ucfg, flat=flat(uparams), **fwd, grad=dict(g, cfg=kernels)),
              "clip": dict(cfg=port_cfg(CLIP3), flat=flat(cparams), ids=ids),
              "layout": dict(x=np.arange(12, dtype=np.float32).reshape(4, 3), ldm=toy_ldm),
              "spacetime": {"cfg": smoke_cfg(2, epochs=2),
                            "prompts": ["a dog to the left of a cat", "no objects"],
                            "seeds": [1, 7]}}
    torch.save(inputs, os.path.join(d, "inputs.pt"))
    ranks = Ranks(d, CASES, world=4, model=2)

    mesh = jmesh()
    with mesh:
        sp = jshard_params(mesh, uparams, 2)
        fn = jax.jit(lambda p, x, t, c: junet.apply({"params": p}, x, t, c))
        eps = np.asarray(fn(sp, jax.device_put(jnp.asarray(fwd["x"]), data_sharding(mesh, 4)),
                            jnp.asarray(fwd["t"]), jnp.asarray(fwd["ctx"])))
        row = NamedSharding(mesh, P("data"))
        x, t, ctx = (jax.device_put(jnp.asarray(g[k]), row) for k in ("x", "t", "ctx"))
        control = jax.tree_util.tree_map(lambda a: jax.device_put(a, row), jcontrol)

        def loss(params, coef):
            e = junet.apply({"params": params}, x, t, ctx, control._replace(coef=coef))
            return jnp.sum(e ** 2)

        lval, (jgrads, jdcoef) = jax.jit(jax.value_and_grad(loss, argnums=(0, 1)))(
            sp, control.coef)
        last, pooled = jax.jit(lambda p, i: jtower.apply({"params": p}, i))(
            jshard_params(mesh, cparams, 2), jax.device_put(jnp.asarray(ids), row))
    return dict(ranks=ranks, d=d, uparams=uparams, cparams=cparams, eps=eps,
                loss=float(lval), grads=flat(jgrads), dcoef=np.asarray(jdcoef),
                last=np.asarray(last), pooled=np.asarray(pooled), ucfg=ucfg)


def _toy_state():
    from helpers.torch_ranks import VecToy

    torch.manual_seed(0)
    return VecToy(10, 8).state_dict()


def outs(setup, name):
    return [o[name] for o in setup["ranks"].join()]


def to_torch_names(jflat: dict) -> dict:
    """JAX's flat tree keyed by the port's parameter names, in torch layout."""
    return dict(torch_key(k, v) for k, v in jflat.items())


def spec_in_torch_layout(path: str, spec) -> tuple:
    """JAX's spec of a leaf read in the port's layout ([in, out] kernels
    transposed)."""
    spec = tuple(spec)
    if path.endswith("kernel") and len(spec) == 2:
        return spec[::-1]
    return spec


def jax_specs(params) -> dict:
    flat_specs = {"/".join(str(k.key) for k in path): spec for path, spec in
                  jax.tree_util.tree_flatten_with_path(
                      jpartition_specs(params),
                      is_leaf=lambda s: isinstance(s, P))[0]}
    return {torch_key(k, np.zeros((1, 1)) if k.endswith("kernel") else np.zeros(1))[0]:
            spec_in_torch_layout(k, s) for k, s in flat_specs.items()}


def check_specs(port: dict, jax_: dict) -> None:
    assert sorted(port) == sorted(jax_)
    for k, want in jax_.items():
        if port[k] == ("model",):     # a column-parallel bias: GSPMD slices it with its output
            assert want == () and k.endswith(".bias"), k
            assert port[k[:-len("bias")] + "weight"] == ("model", None), k
        else:
            assert port[k] == want, k
    assert any(v == ("model", None) for v in port.values())
    assert any(v == (None, "model") for v in port.values())


def test_partition_specs_equal_jax(setup):
    """`partition_specs` of the TINY UNet and of the smoke CLIP (both towers)
    equals JAX's by parameter name; the ranks' TINY UNet reports the same."""
    check_specs(partition_specs(UNet(setup["ucfg"], radius=0.2)), jax_specs(setup["uparams"]))
    smoke = JCLIPConfig(
        vision=JCLIPVisionConfig(image_size=14, patch_size=7, width=16, layers=2, heads=2,
                                 projection_dim=8),
        text=JCLIPTextConfig(width=16, layers=2, heads=2, vocab_size=49408, max_len=7),
        projection_dim=8)
    jclip = JCLIP(smoke)
    shapes = jax.eval_shape(jclip.init, jax.random.PRNGKey(0), jnp.zeros((1, 14, 14, 3)),
                            jnp.zeros((1, 7), jnp.int32))["params"]
    clip = CLIP(port_cfg(smoke))
    check_specs(partition_specs(clip), jax_specs(shapes))
    for o in outs(setup, "tp_unet_fwd"):
        assert o["specs"] == partition_specs(UNet(setup["ucfg"], radius=0.2))


def test_tp_unet_forward_equals_jax_tp_mesh(setup):
    """4 ranks (data 2 x model 2), each on its 2 rows and its heads: the
    gathered eps equals JAX's (2, 2) TP forward at atol 2e-5, on every
    rank; the model ranks hold half of each pair (to_q [16, 32], to_out
    [32, 16], GEGLU proj_in [128, 32] at level 0), and `model_state_dict`
    gathers them back to the bridge's whole weights, bit for bit."""
    for o in outs(setup, "tp_unet_fwd"):
        np.testing.assert_allclose(o["eps"].numpy(), setup["eps"], atol=2e-5)
        assert o["gathered_equal"]
        shapes = o["local_shapes"]
        assert shapes["down_attn_0.block_0.attn1.to_q.weight"] == (16, 32)
        assert shapes["down_attn_0.block_0.attn1.to_out.weight"] == (32, 16)
        assert shapes["down_attn_0.block_0.ff.proj_in.weight"] == (128, 32)
        assert shapes["down_attn_0.block_0.ff.proj_out.weight"] == (32, 64)


def grads_close(got: dict, want: dict):
    total = float(np.sqrt(sum(float((v.float() ** 2).sum()) for v in want.values())))
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        err = float(torch.linalg.vector_norm(got[k] - w))
        assert err <= 1e-4 * float(torch.linalg.vector_norm(w)) + 1e-6 * total, k


def test_tp_controlled_gradients_equal_jax_grad(setup):
    """main_tp's program: the loss (summed over 'data') within 1e-5
    relative; every parameter's gradient and dcoef within 1e-4 relative in
    norm of JAX's TP-mesh `jax.grad`; the replicated gradients and dcoef
    equal in bits across the model ranks of a data group; the all-reduce
    counts per evaluation."""
    o = outs(setup, "tp_unet_grad")
    want = {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in to_torch_names(setup["grads"]).items()}
    total_loss = o[0]["loss"] + o[2]["loss"]
    assert abs(total_loss - setup["loss"]) <= 1e-5 * abs(setup["loss"])
    for r in o:
        grads_close(r["grads"], want)
        dc = torch.from_numpy(setup["dcoef"])
        assert float(torch.linalg.vector_norm(r["dcoef"] - dc)) <= \
            1e-4 * float(torch.linalg.vector_norm(dc))
        blocks = r["blocks"]
        assert blocks == 7
        assert (r["stats"]["fwd"], r["stats"]["bwd"]) == (3 * blocks, 4 * blocks)
    for a, b in ((o[0], o[1]), (o[2], o[3])):           # model ranks of one data group
        assert torch.equal(a["dcoef_local"], b["dcoef_local"])
        assert sorted(a["replicated"]) == sorted(b["replicated"])
        assert all(torch.equal(a["replicated"][k], b["replicated"][k]) for k in a["replicated"])
    assert "out_conv.weight" in o[0]["replicated"]
    assert "down_attn_0.block_0.attn1.to_out.bias" in o[0]["replicated"]


def test_tp_indivisible_heads_stay_whole(setup):
    """A 3-head CLIP text tower at M = 2: q/k/v/out_proj stay whole on every
    rank, fc1/fc2 split; last hidden and pooled equal JAX's TP forward."""
    for o in outs(setup, "tp_clip"):
        assert o["sharded"] and all(".mlp." in k for k in o["sharded"])
        assert "layer_0.mlp.fc1.weight" in o["sharded"]
        np.testing.assert_allclose(o["last"].numpy(), setup["last"], atol=2e-5)
        np.testing.assert_allclose(o["pooled"].numpy(), setup["pooled"], atol=2e-5)


def test_tp_rank_layout_follows_the_data_coordinate(setup):
    """Rank d·2 + m at (d, m); shard_batch, normal_rows and gather_rows
    follow d (JAX's data shards), the model ranks of a data group equal;
    the writer is rank 0 alone; the LDMTrainer replicated over 'model'
    (FSDP over the data group) gives every rank the same weights, its lr
    counts data·model = 4 devices, and one checkpoint is written."""
    o = outs(setup, "tp_layout")
    x = np.arange(12, dtype=np.float32).reshape(4, 3)
    noise = prng.normal(prng.PRNGKey(7), (4, 3))
    for rank, r in enumerate(o):
        dd, m = divmod(rank, 2)
        assert r["coords"] == (rank, dd, m)
        assert r["writer"] == (rank == 0)
        assert r["rows"] == slice(2 * dd, 2 * dd + 2)
        np.testing.assert_array_equal(r["mine"].numpy(), x[2 * dd:2 * dd + 2])
        np.testing.assert_array_equal(r["gathered"].numpy(), x)
        np.testing.assert_array_equal(r["noise"].numpy(), noise[2 * dd:2 * dd + 2])
        assert r["ldm_fsdp"] and r["ckpt"] == ["step_1.pt"]
        assert r["ldm_lr"] == pytest.approx(4 * 2 * 1e-3)
        assert r["ldm_loss"] == o[0]["ldm_loss"]
        assert all(torch.equal(r["ldm_params"][k], o[0]["ldm_params"][k])
                   for k in o[0]["ldm_params"])


def within_one_level(got, want):
    assert got.shape == want.shape and got.dtype == want.dtype == np.uint8
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1


def test_tp_spacetime_engine_matches_one_process(setup):
    """SpaceTimeEngine (PLMS-2, 2 epochs, the smoke config: UNet, text tower
    and loss CLIP tensor-parallel) over (1, 2) and (2, 2): images within one
    uint8 level of one process; every rank the same images and coef."""
    o = outs(setup, "tp_engine")
    one = o[0]["one"]
    for tag in ("row", "mesh"):
        for r in o:
            within_one_level(r[tag]["images"], one["images"])
            np.testing.assert_array_equal(r[tag]["images"], o[0][tag]["images"])
            assert torch.equal(r[tag]["coef"], o[0][tag]["coef"])
        np.testing.assert_allclose(o[0][tag]["coef"].numpy(), one["coef"].numpy(),
                                   rtol=1e-4, atol=1e-6)
    assert o[0]["mesh"]["images"].std() > 0
