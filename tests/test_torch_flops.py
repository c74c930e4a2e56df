"""PyTorch port, the FLOP count (`utils/flops.py`, `scripts/flops_model.py`)
held against the JAX package's `count_flops` on the CPU.

At the smoke config (`testbed/configs.py:smoke_pipeline_cfg`) the five
programs of JAX's `scripts/flops_model.py`, built by that script (its
`build_programs`, with the smoke config in place of SD v1-4: 77-token
contexts, 64×64 latents, 4 objects) at batch 1-2 and 3-4 steps, against
the port's `flops_model.count` on the meta device.  Forward programs give
equal `matmul` and `conv`, exactly.  Gradient programs differ by two
conventions, each computed here from the shapes:

  * strided convolutions: JAX counts the input gradient of a stride-2
    convolution over the 2-dilated cotangent, zeros included (4 × the
    forward); PyTorch runs a transposed convolution (1 ×).  The port's
    `conv` is JAX's less 3 × the forward FLOPs of every stride-2
    convolution whose input gradient the program takes (each `Downsample`
    of every evaluation);
  * loop-invariant context projections: the port's per-evaluation
    recompute runs attn2's `to_k` / `to_v` on the text and local contexts
    (constants of the chain) again for every evaluation; JAX's backward
    `lax.scan` computes those residuals once for all the evaluations inside
    it (steps 1 .. S−1), so the port's `matmul` is JAX's plus S − 2
    evaluations' worth of them.

At SD v1-4 width the JAX counts take minutes to trace, too long here: they
are constants (JAX's `count_flops` of its `flops_model.py` programs, cross-
checked against `MFU_r05.json`), and `chip_smoke.FLOPS_SD`, which the card's
run holds the port's meta-device counts to, must be them with the same two
gaps.  Tolerance: none.
"""
import dataclasses
import importlib.util
import json
import math
from pathlib import Path
from unittest import mock

import jax
import numpy as np
import pytest
import torch

import chip_smoke
from diffusion_spacetime_attn_tpu import config as jcfg
from diffusion_spacetime_attn_tpu.testbed.configs import smoke_pipeline_cfg
from diffusion_spacetime_attn_tpu.utils.flops import count_flops as jax_count_flops
from diffusion_spacetime_attn_tpu_torch import config as tcfg
from diffusion_spacetime_attn_tpu_torch.scripts import flops_model
from diffusion_spacetime_attn_tpu_torch.utils.flops import count_flops

ROOT = Path(__file__).resolve().parent.parent
CONTEXT_LEN, LATENT, OBJECTS = 77, 64, 4      # JAX's flops_model shapes

# the smoke programs: JAX's five, cut to batch 1-2 and 3-4 steps
SMOKE = {
    "vanilla_plms50_b8": ("vanilla", "plms", 4, 2, False),
    "dpm20_b8_epoch": ("spacetime", "dpm", 3, 2, True),
    "dpm20_b8_final_fwd": ("spacetime", "dpm", 3, 2, False),
    "plms50_b4_epoch": ("spacetime", "plms", 4, 1, True),
    "plms50_b4_final_fwd": ("spacetime", "plms", 4, 1, False),
}
# JAX's count_flops of its scripts/flops_model.py programs at SD v1-4 width
# (jax 0.9 on the CPU): (matmul, conv)
JAX_SD = {
    "vanilla_plms50_b8": (293485982777344, 382101296775168),
    "dpm20_b8_epoch": (391358743314432, 471019905089536),
    "dpm20_b8_final_fwd": (119440611999744, 161904027762688),
    "plms50_b4_epoch": (498794190340096, 569995210784768),
    "plms50_b4_final_fwd": (152073749921792, 191050648387584),
}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def jax_flops_model():
    spec = importlib.util.spec_from_file_location("jax_script_flops_model",
                                                  ROOT / "scripts" / "flops_model.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def smoke_cfg(steps: int):
    cfg = smoke_pipeline_cfg(num_steps=steps)
    return dataclasses.replace(
        cfg, text_encoder=dataclasses.replace(cfg.text_encoder, max_len=CONTEXT_LEN),
        spacetime=dataclasses.replace(cfg.spacetime, latent_size=LATENT))


def port_cfg(c):
    cls = getattr(tcfg, type(c).__name__)
    return cls(**{f.name: (port_cfg(getattr(c, f.name))
                           if dataclasses.is_dataclass(getattr(c, f.name))
                           else getattr(c, f.name))
                  for f in dataclasses.fields(c)})


def jax_count(mode, sampler, steps, batch, grad):
    """JAX's flops_model program at the smoke config: its `build_programs`
    with the smoke config handed in where it builds SD v1-4's."""
    script = jax_flops_model()
    smoke = smoke_cfg(steps)

    def pipeline_config(unet, vae, spacetime):
        return dataclasses.replace(smoke, unet=dataclasses.replace(
            smoke.unet, dtype=unet.dtype, attn_scores_dtype=unet.attn_scores_dtype))

    with mock.patch.object(jcfg, "PipelineConfig", pipeline_config):
        run, args = script.build_programs()(mode, sampler, steps, batch)
    fn = run
    if grad:
        def fn(*a):
            return jax.value_and_grad(run, argnums=5)(*a)
    return jax_count_flops(fn, *args)


def gaps(ucfg, steps: int, evals: int, batch: int):
    """(matmul, conv) FLOPs the port's gradient program counts more than
    JAX's (module doc), from the UNet's shapes."""
    mc, mult = ucfg.model_channels, ucfg.channel_mult
    conv = sum(2 * (2 * batch) * (LATENT >> (level + 1)) ** 2 * (mc * m) ** 2 * 9
               for level, m in enumerate(mult[:-1]))
    rows = 2 * batch + batch * OBJECTS            # CFG contexts + local contexts
    sites = [mc * m for level, m in enumerate(mult) if 2 ** level in ucfg.attention_resolutions
             for _ in range(2 * ucfg.num_res_blocks + 1)] + [mc * mult[-1]]
    proj = sum(2 * 2 * rows * CONTEXT_LEN * ucfg.context_dim * c for c in sites)
    return (steps - 2) * proj, -3 * evals * conv


def evals_of(sampler: str, steps: int) -> int:
    return steps + 1 if sampler == "plms" else steps


@pytest.mark.parametrize("name", list(SMOKE))
def test_count_flops_matches_jax_at_the_smoke_config(name):
    mode, sampler, steps, batch, grad = SMOKE[name]
    want = jax_count(mode, sampler, steps, batch, grad)
    cfg = smoke_cfg(steps)
    pcfg = port_cfg(dataclasses.replace(cfg, unet=dataclasses.replace(
        cfg.unet, dtype="bfloat16", attn_scores_dtype="bfloat16")))
    got = flops_model.count(mode, sampler, steps, batch, grad, cfg=pcfg)
    assert got["opaque_kernel_calls"] == 0 and got["dynamic_while_loops"] == 0
    assert want["opaque_pallas_calls"] == 0 and want["dynamic_while_loops"] == 0
    d_mm, d_conv = gaps(cfg.unet, steps, evals_of(sampler, steps), batch) if grad else (0, 0)
    if grad:
        assert d_mm > 0 and d_conv < 0
    assert got["matmul"] == want["matmul"] + d_mm
    assert got["conv"] == want["conv"] + d_conv
    assert got["total"] == got["matmul"] + got["conv"]


@pytest.mark.parametrize("name", list(JAX_SD))
def test_sd_width_constants_are_jax_counts_less_the_gaps(name):
    """chip_smoke.FLOPS_SD (what the card's meta-device count must give)
    equals JAX's SD-width count with the two gaps; JAX's constants agree
    with the JAX tool's artifact, MFU_r05.json, to its rounding."""
    mode, sampler, steps, batch, grad = flops_model.PROGRAMS[name]
    j_mm, j_conv = JAX_SD[name]
    mfu = json.loads((ROOT / "MFU_r05.json").read_text())["programs"][name]
    assert round((j_mm + j_conv) / 1e15, 3) == mfu["pflops_per_call"]
    assert round(j_mm / (j_mm + j_conv), 3) == mfu["matmul_share"]
    d_mm, d_conv = (gaps(tcfg.UNetConfig(), steps, evals_of(sampler, steps), batch) if grad
                    else (0, 0))
    assert chip_smoke.FLOPS_SD[name] == (j_mm + d_mm, j_conv + d_conv)


def test_conv_backward_counts_its_output_mask_and_the_strided_gap():
    """The issue's measured case: a stride-2 3×3 conv (B 2, 16², 8
    channels) differentiated in its input: 147,456 forward FLOPs; JAX
    737,280 (forward + 4×), the port 294,912 (forward + 1×)."""
    x0 = np.random.RandomState(0).randn(2, 8, 16, 16).astype(np.float32)
    w = torch.randn(8, 8, 3, 3, generator=torch.Generator().manual_seed(0))

    def grad_of_input():
        x = torch.from_numpy(x0).requires_grad_(True)
        y = torch.nn.functional.conv2d(x, w, stride=2, padding=1)
        return torch.autograd.grad(y.sum(), x)

    c = count_flops(grad_of_input)
    assert c == {"matmul": 0.0, "conv": 294912.0, "total": 294912.0,
                 "opaque_kernel_calls": 0, "dynamic_while_loops": 0}
    jw = jax.numpy.asarray(w.numpy())

    def jax_loss(x):
        y = jax.lax.conv_general_dilated(x, jw, (2, 2), ((1, 1), (1, 1)))
        return y.sum()

    assert jax_count_flops(jax.grad(jax_loss), jax.numpy.asarray(x0))["conv"] == 737280.0
    assert count_flops(lambda: torch.nn.functional.conv2d(
        torch.from_numpy(x0), w, stride=2, padding=1))["conv"] == 147456.0


def test_count_flops_counts_kernel_launches_as_opaque(monkeypatch):
    """A wrapper launch during the call makes the count a lower bound."""
    from diffusion_spacetime_attn_tpu_torch.ops import cuda_mha

    def launch():
        cuda_mha.mha_attention.launches += 2
        return torch.ones(4, 4) @ torch.ones(4, 4)

    monkeypatch.setattr(cuda_mha.mha_attention, "launches", cuda_mha.mha_attention.launches)
    c = count_flops(launch)
    assert c["opaque_kernel_calls"] == 2 and c["matmul"] == 2 * 4 * 4 * 4


def test_flops_model_cli_writes_counts_and_not_measured(tmp_path, monkeypatch):
    """The script's artifact and table for a count without a wall clock:
    TF/s 'not measured'; --measured takes a card's wall clock with its
    name and power limit.  (One SD-width program through the meta device
    would take ~25 s; `count_program` gives the JAX constants here.)"""
    def count_program(name):
        mm, conv = map(float, JAX_SD[name])
        return {"matmul": mm, "conv": conv, "total": mm + conv, "opaque_kernel_calls": 0,
                "dynamic_while_loops": 0}

    monkeypatch.setattr(flops_model, "count_program", count_program)
    walls = tmp_path / "walls.json"
    walls.write_text(json.dumps({"dpm20_b8_final_fwd": {
        "s_per_call": 1.0, "nvidia_smi": "NVIDIA H100 80GB HBM3, 700.00 W"}}))
    art = flops_model.main(["--out", str(tmp_path / "m.json"), "--measured", str(walls)])
    rows = art["programs"]
    assert set(rows) == set(flops_model.PROGRAMS)
    assert rows["vanilla_plms50_b8"]["tf_per_s"] == "not measured"
    fwd = rows["dpm20_b8_final_fwd"]
    assert fwd["tf_per_s"] == round(sum(JAX_SD["dpm20_b8_final_fwd"]) / 1e12, 1)
    assert fwd["mfu_pct_of_h100_bf16_peak"] == round(100 * fwd["tf_per_s"] / 989.0, 1)
    assert art["method_total"]["dpm20_b8_3ep"]["tf_per_s"] == "not measured"
    assert json.loads((tmp_path / "m.json").read_text())["peak_tfs"] == {
        "h100_sxm_bf16_dense": 989.0}
    with pytest.raises(ValueError):
        bad = tmp_path / "bad.json"
        bad.write_text(json.dumps({"dpm20_b8_final_fwd": {"s_per_call": 1.0}}))
        flops_model.main(["--out", str(tmp_path / "m.json"), "--measured", str(bad)])


def test_flops_model_time_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        flops_model.time_program("dpm20_b8_final_fwd", 1)


def test_sd_width_count_is_on_the_meta_device():
    """StableDiffusion.create(abstract=True): modules on the meta device,
    the schedule on the CPU (the samplers read its timesteps on the host)."""
    from diffusion_spacetime_attn_tpu_torch.pipeline.pipeline import StableDiffusion

    sd = StableDiffusion.create(flops_model.program_config("spacetime", 20, kernels=False),
                                abstract=True)
    assert all(p.device.type == "meta" for p in sd.unet.parameters())
    assert sd.schedule.timesteps.device.type == "cpu"
    assert math.prod(sd.unet.time_embed_0.weight.shape) == 320 * 1280
