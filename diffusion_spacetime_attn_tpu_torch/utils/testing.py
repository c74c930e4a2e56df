"""Seeded random weights, synthetic checkpoints in the published key
layouts, and the kernel-vs-plain comparison, for tests and benchmarks.

SD-style models zero-initialize their output convs, so a fresh init is
degenerate (identically-zero output); without a checkpoint, every parameter
is replaced by N(0, scale²) noise, as the JAX package's `randomize_params`
does.  One generator per state-dict key, seeded from the seed and a hash of
the key, on the parameter's own device (no host-side generation of GBs).

`compvis_shapes`, `openai_clip_shapes`, `rel2bbox_shapes` and
`safety_checker_shapes` give the keys and shapes of the published
checkpoints the converters read (CompVis `sd-v1-4.ckpt`, OpenAI
`ViT-B-32.pt`, the reference's fairseq `checkpoint_90_0.0.pth`, diffusers'
`StableDiffusionSafetyChecker`) at a config's widths; `seeded_normal` draws any one
array of such a file with numpy, alone, from the seed and its key.
"""
from __future__ import annotations

import hashlib
import os
import zlib
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Tuple

import numpy as np
import torch
from torch import nn

from ..config import CLIPConfig, CLIPVisionConfig, LayoutConfig, PipelineConfig


def _generator(seed: int, name: str, device) -> torch.Generator:
    h = int.from_bytes(hashlib.sha1(name.encode()).digest()[:4], "little")
    g = torch.Generator(device=device)
    g.manual_seed((seed ^ h) & 0x7FFFFFFF)
    return g


def randomize_(module: nn.Module, seed: int, scale: float = 0.02) -> nn.Module:
    """Fill every parameter of `module` in place with seeded N(0, scale²)."""
    with torch.no_grad():
        for name, p in module.named_parameters():
            g = _generator(seed, name, p.device)
            noise = torch.randn(p.shape, generator=g, device=p.device, dtype=torch.float32)
            p.copy_(noise * scale)
    return module


def init_flax_like_(module: nn.Module, seed: int, zero=()) -> nn.Module:
    """Initial weights for training, in place, with the distributions of
    flax's default initializers (not flax's bits): Linear and Conv kernels
    lecun_normal (N(0, 1/fan_in) truncated at ±2σ, rescaled), biases 0, 1-D
    norm weights 1, `nn.Embedding` N(0, 1/features), other parameters
    N(0, 0.02²); the modules named in `zero` (the UNet's zero-initialized
    convolutions, `UNet.zero_init_modules`) all 0.  One generator per
    parameter, seeded from `seed` and its name, on its device."""
    zero = set(zero)
    with torch.no_grad():
        for mname, m in module.named_modules():
            for pname, p in m.named_parameters(recurse=False):
                name = f"{mname}.{pname}" if mname else pname
                g = _generator(seed, name, p.device)
                if mname in zero or pname == "bias":
                    p.zero_()
                elif isinstance(m, (nn.Linear, nn.Conv2d)):
                    std = (1.0 / p[0].numel()) ** 0.5 / 0.87962566103423978
                    nn.init.trunc_normal_(p, 0.0, 1.0, -2.0, 2.0, generator=g).mul_(std)
                elif isinstance(m, nn.Embedding):
                    p.normal_(0.0, p.shape[1] ** -0.5, generator=g)
                elif pname == "weight" and p.ndim == 1:
                    p.fill_(1.0)
                else:
                    p.normal_(0.0, 0.02, generator=g)
    return module


def seeded_normal(seed: int, name: str, shape, scale: float = 0.02) -> np.ndarray:
    """float32 N(0, scale²) from numpy's generator seeded by (seed,
    crc32(name)); its first k values are those of the same draw at any
    larger size."""
    rng = np.random.default_rng([seed, zlib.crc32(name.encode())])
    return rng.standard_normal(shape, dtype=np.float32) * np.float32(scale)


Shapes = Dict[str, Tuple[int, ...]]


class _Keys:
    """Collects {key: shape} in the torch layouts (Linear [out, in], Conv
    [O, I, kh, kw], norms weight and bias)."""

    def __init__(self, prefix: str = ""):
        self.p, self.shapes = prefix, {}

    def add(self, name, *shape):
        self.shapes[self.p + name] = tuple(shape)

    def linear(self, name, out, inp, bias=True):
        self.add(f"{name}.weight", out, inp)
        if bias:
            self.add(f"{name}.bias", out)

    def conv(self, name, out, inp, k, bias=True):
        self.add(f"{name}.weight", out, inp, k, k)
        if bias:
            self.add(f"{name}.bias", out)

    def norm(self, name, c):
        self.add(f"{name}.weight", c)
        self.add(f"{name}.bias", c)


def _unet_shapes(cfg, keys: _Keys) -> None:
    """`ldm.modules.diffusionmodules.openaimodel.UNetModel` with spatial
    transformers of depth 1 (v1-inference.yaml)."""
    C, emb = cfg.model_channels, 4 * cfg.model_channels

    def res(n, i, o):
        keys.norm(f"{n}.in_layers.0", i)
        keys.conv(f"{n}.in_layers.2", o, i, 3)
        keys.linear(f"{n}.emb_layers.1", o, emb)
        keys.norm(f"{n}.out_layers.0", o)
        keys.conv(f"{n}.out_layers.3", o, o, 3)
        if i != o:
            keys.conv(f"{n}.skip_connection", o, i, 1)

    def st(n, c):
        keys.norm(f"{n}.norm", c)
        keys.conv(f"{n}.proj_in", c, c, 1)
        b = f"{n}.transformer_blocks.0"
        for a, ctx in (("attn1", c), ("attn2", cfg.context_dim)):
            keys.linear(f"{b}.{a}.to_q", c, c, bias=False)
            keys.linear(f"{b}.{a}.to_k", c, ctx, bias=False)
            keys.linear(f"{b}.{a}.to_v", c, ctx, bias=False)
            keys.linear(f"{b}.{a}.to_out.0", c, c)
        keys.linear(f"{b}.ff.net.0.proj", 8 * c, c)
        keys.linear(f"{b}.ff.net.2", c, 4 * c)
        for j in (1, 2, 3):
            keys.norm(f"{b}.norm{j}", c)
        keys.conv(f"{n}.proj_out", c, c, 1)

    keys.linear("time_embed.0", emb, C)
    keys.linear("time_embed.2", emb, emb)
    keys.conv("input_blocks.0.0", C, cfg.in_channels, 3)
    chans, ch, ds, idx = [C], C, 1, 1
    levels = len(cfg.channel_mult)
    for level, mult in enumerate(cfg.channel_mult):
        for _ in range(cfg.num_res_blocks):
            res(f"input_blocks.{idx}.0", ch, mult * C)
            ch = mult * C
            if ds in cfg.attention_resolutions:
                st(f"input_blocks.{idx}.1", ch)
            chans.append(ch)
            idx += 1
        if level != levels - 1:
            keys.conv(f"input_blocks.{idx}.0.op", ch, ch, 3)
            chans.append(ch)
            idx += 1
            ds *= 2
    res("middle_block.0", ch, ch)
    st("middle_block.1", ch)
    res("middle_block.2", ch, ch)
    idx = 0
    for level, mult in reversed(list(enumerate(cfg.channel_mult))):
        for i in range(cfg.num_res_blocks + 1):
            res(f"output_blocks.{idx}.0", ch + chans.pop(), mult * C)
            ch, op = mult * C, 1
            if ds in cfg.attention_resolutions:
                st(f"output_blocks.{idx}.1", ch)
                op = 2
            if level and i == cfg.num_res_blocks:
                keys.conv(f"output_blocks.{idx}.{op}.conv", ch, ch, 3)
                ds //= 2
            idx += 1
    keys.norm("out.0", ch)
    keys.conv("out.2", cfg.out_channels, ch, 3)


def _vae_shapes(cfg, keys: _Keys) -> None:
    """`ldm.models.autoencoder.AutoencoderKL` (Encoder / Decoder of
    `diffusionmodules/model.py`, no attention outside the mid blocks)."""

    def res(n, i, o):
        keys.norm(f"{n}.norm1", i)
        keys.conv(f"{n}.conv1", o, i, 3)
        keys.norm(f"{n}.norm2", o)
        keys.conv(f"{n}.conv2", o, o, 3)
        if i != o:
            keys.conv(f"{n}.nin_shortcut", o, i, 1)

    def mid(n, c):
        res(f"{n}.mid.block_1", c, c)
        keys.norm(f"{n}.mid.attn_1.norm", c)
        for q in ("q", "k", "v", "proj_out"):
            keys.conv(f"{n}.mid.attn_1.{q}", c, c, 1)
        res(f"{n}.mid.block_2", c, c)

    ch, mult, z = cfg.ch, cfg.ch_mult, cfg.z_channels
    keys.conv("encoder.conv_in", ch, cfg.in_ch, 3)
    block_in = ch
    for level, m in enumerate(mult):
        for j in range(cfg.num_res_blocks):
            res(f"encoder.down.{level}.block.{j}", block_in, ch * m)
            block_in = ch * m
        if level != len(mult) - 1:
            keys.conv(f"encoder.down.{level}.downsample.conv", block_in, block_in, 3)
    mid("encoder", block_in)
    keys.norm("encoder.norm_out", block_in)
    keys.conv("encoder.conv_out", 2 * z, block_in, 3)
    block_in = ch * mult[-1]
    keys.conv("decoder.conv_in", block_in, z, 3)
    mid("decoder", block_in)
    for level in reversed(range(len(mult))):
        for j in range(cfg.num_res_blocks + 1):
            res(f"decoder.up.{level}.block.{j}", block_in, ch * mult[level])
            block_in = ch * mult[level]
        if level != 0:
            keys.conv(f"decoder.up.{level}.upsample.conv", block_in, block_in, 3)
    keys.norm("decoder.norm_out", block_in)
    keys.conv("decoder.conv_out", cfg.out_ch, block_in, 3)
    keys.conv("quant_conv", 2 * cfg.embed_dim, 2 * z, 1)
    keys.conv("post_quant_conv", z, cfg.embed_dim, 1)


def _hf_clip_text_shapes(cfg, keys: _Keys) -> None:
    """transformers `CLIPTextModel` (`text_model.` stripped)."""
    w = cfg.width
    keys.add("embeddings.token_embedding.weight", cfg.vocab_size, w)
    keys.add("embeddings.position_embedding.weight", cfg.max_len, w)
    for i in range(cfg.layers):
        p = f"encoder.layers.{i}"
        for q in ("q_proj", "k_proj", "v_proj", "out_proj"):
            keys.linear(f"{p}.self_attn.{q}", w, w)
        keys.norm(f"{p}.layer_norm1", w)
        keys.linear(f"{p}.mlp.fc1", 4 * w, w)
        keys.linear(f"{p}.mlp.fc2", w, 4 * w)
        keys.norm(f"{p}.layer_norm2", w)
    keys.norm("final_layer_norm", w)


def compvis_shapes(cfg: PipelineConfig) -> Shapes:
    """Keys and shapes a CompVis SD v1 checkpoint holds for the UNet
    (`model.diffusion_model.`), the KL VAE (`first_stage_model.`) and the
    CLIP text tower (`cond_stage_model.transformer.text_model.`) at `cfg`'s
    widths; the float parameters only (no EMA copy, schedule buffers or
    `position_ids`)."""
    shapes: Shapes = {}
    for prefix, fn, sub in (("model.diffusion_model.", _unet_shapes, cfg.unet),
                            ("first_stage_model.", _vae_shapes, cfg.vae),
                            ("cond_stage_model.transformer.text_model.", _hf_clip_text_shapes,
                             cfg.text_encoder)):
        keys = _Keys(prefix)
        fn(sub, keys)
        shapes.update(keys.shapes)
    return shapes


def openai_clip_shapes(cfg: CLIPConfig) -> Shapes:
    """Keys and shapes of OpenAI CLIP's state dict (`clip.model.CLIP`, what
    `clip.load` reads) at `cfg`'s widths: both towers' residual blocks with
    packed `in_proj`, `[in, out]` projections, no `logit_scale`."""
    keys = _Keys()
    v, t = cfg.vision, cfg.text

    def blocks(prefix, w, layers):
        for i in range(layers):
            p = f"{prefix}resblocks.{i}"
            keys.add(f"{p}.attn.in_proj_weight", 3 * w, w)
            keys.add(f"{p}.attn.in_proj_bias", 3 * w)
            keys.linear(f"{p}.attn.out_proj", w, w)
            keys.norm(f"{p}.ln_1", w)
            keys.linear(f"{p}.mlp.c_fc", 4 * w, w)
            keys.linear(f"{p}.mlp.c_proj", w, 4 * w)
            keys.norm(f"{p}.ln_2", w)

    keys.add("visual.class_embedding", v.width)
    keys.add("visual.positional_embedding", (v.image_size // v.patch_size) ** 2 + 1, v.width)
    keys.conv("visual.conv1", v.width, 3, v.patch_size, bias=False)
    keys.norm("visual.ln_pre", v.width)
    blocks("visual.transformer.", v.width, v.layers)
    keys.norm("visual.ln_post", v.width)
    keys.add("visual.proj", v.width, cfg.projection_dim)
    keys.add("token_embedding.weight", t.vocab_size, t.width)
    keys.add("positional_embedding", t.max_len, t.width)
    blocks("transformer.", t.width, t.layers)
    keys.norm("ln_final", t.width)
    keys.add("text_projection", t.width, cfg.projection_dim)
    return keys.shapes


def rel2bbox_shapes(cfg: LayoutConfig, prefix: str = "encoder.model.encoder.") -> Shapes:
    """Keys and shapes of the reference's fairseq Rel2Bbox checkpoint that the
    layout predictor reads: the RoBERTa encoder under
    `{prefix}sentence_encoder.` with its `object_embedding`, and the GMM
    head under `bbox_head.Decoder.`."""
    keys = _Keys(prefix + "sentence_encoder.")
    h = cfg.hidden
    keys.add("embed_tokens.weight", cfg.vocab_size, h)
    keys.add("embed_positions.weight", cfg.max_positions, h)
    keys.norm("layernorm_embedding", h)
    keys.add("object_embedding", 1, h)
    for i in range(cfg.layers):
        p = f"layers.{i}"
        for q in ("q_proj", "k_proj", "v_proj", "out_proj"):
            keys.linear(f"{p}.self_attn.{q}", h, h)
        keys.norm(f"{p}.self_attn_layer_norm", h)
        keys.linear(f"{p}.fc1", cfg.ffn_dim, h)
        keys.linear(f"{p}.fc2", h, cfg.ffn_dim)
        keys.norm(f"{p}.final_layer_norm", h)
    head = _Keys("bbox_head.Decoder.")
    head.linear("output_Layer", h, h)
    head.linear("box_predictor.xy_bivariate", 6 * cfg.gmm_components, h)
    return {**keys.shapes, **head.shapes}


def safety_checker_shapes(cfg: CLIPVisionConfig, concepts: int = 17,
                          special: int = 3) -> Shapes:
    """Keys and shapes of diffusers' `StableDiffusionSafetyChecker` state
    dict (what `pipeline/safety.DiffusersSafetyChecker.from_checkpoint`
    reads) at `cfg`'s widths: the transformers CLIPVisionModel under
    `vision_model.vision_model.`, the bias-free `visual_projection` to
    `cfg.projection_dim`, and the concept and special-care embeddings with
    their weights (the published checker: ViT-L/14, 17 and 3)."""
    keys = _Keys("vision_model.vision_model.")
    w, n = cfg.width, (cfg.image_size // cfg.patch_size) ** 2
    keys.conv("embeddings.patch_embedding", w, 3, cfg.patch_size, bias=False)
    keys.add("embeddings.class_embedding", w)
    keys.add("embeddings.position_embedding.weight", n + 1, w)
    keys.norm("pre_layrnorm", w)                       # (sic) transformers' spelling
    for i in range(cfg.layers):
        p = f"encoder.layers.{i}"
        for q in ("q_proj", "k_proj", "v_proj", "out_proj"):
            keys.linear(f"{p}.self_attn.{q}", w, w)
        keys.norm(f"{p}.layer_norm1", w)
        keys.linear(f"{p}.mlp.fc1", 4 * w, w)
        keys.linear(f"{p}.mlp.fc2", w, 4 * w)
        keys.norm(f"{p}.layer_norm2", w)
    keys.norm("post_layernorm", w)
    top = _Keys()
    top.linear("visual_projection", cfg.projection_dim, w, bias=False)
    top.add("concept_embeds", concepts, cfg.projection_dim)
    top.add("concept_embeds_weights", concepts)
    top.add("special_care_embeds", special, cfg.projection_dim)
    top.add("special_care_embeds_weights", special)
    return {**keys.shapes, **top.shapes}


def vq_shapes(cfg) -> Shapes:
    """Keys and shapes of the reference `VQModel` (`ldm/models/autoencoder.py:14-283`)
    under `first_stage_model.` at a `VAEConfig`'s widths: the KL layout with
    quant_conv 2z -> embed_dim and the codebook `quantize.embedding.weight`
    [n_embed, embed_dim]."""
    keys = _Keys("first_stage_model.")
    _vae_shapes(cfg, keys)
    keys.conv("quant_conv", cfg.embed_dim, 2 * cfg.z_channels, 1)
    keys.add("quantize.embedding.weight", cfg.n_embed, cfg.embed_dim)
    return keys.shapes


def seeded_state_dict(shapes: Shapes, seed: int, scale: float = 0.02) -> Dict[str, np.ndarray]:
    """{key: seeded_normal(seed, key, shape, scale)} for every key, drawn in
    threads (numpy's generators release the GIL)."""
    keys = list(shapes)
    with ThreadPoolExecutor(min(8, os.cpu_count() or 1)) as ex:
        arrays = ex.map(lambda k: seeded_normal(seed, k, shapes[k], scale), keys)
        return dict(zip(keys, arrays))


# Kernel-vs-plain tolerances: an output passes when every element has
# |got - want| <= atol + rtol·|want| and ||got - want|| / ||want|| <= rel_norm.
#   float32: the kernel and the plain version differ in summation order only.
#   bfloat16, mha and geglu: both round at the same points (p, or the gated u,
#     before the second product; the output once), so they differ by about
#     one bf16 ulp of the output (2^-7 relative at most; rtol allows two).
#     The absolute floor scales with the output: atol = 2 % of rms(want),
#     for elements near zero.
#   bfloat16, spacetime: the plain version rounds every blend term (loc_n,
#     w·loc_n, g_c + blend, (Σ w)·g_u) while the kernel rounds once, so an
#     output near zero carries a few ulps of terms of magnitude up to ~10.
#   bfloat16, spacetime_bwd: both backwards compute in float32 and round each
#     cotangent once, like mha (the f32 dmasks and dcoef take the f32 rule).
#     The GEGLU dx uses "geglu": both round dh and dg at the same point.
#   bfloat16, flash: the forward kernel rounds p to bf16 as the A operand of
#     its PV product, where splash and the plain version keep p in f32
#     (splash `:819-820`): about 2^-9 relative per term, 0.24-0.25 % in
#     relative norm at the SD level-0 and level-1 sites on an H100
#     (`chip_smoke.py` phase kernels), within the mha rule with a margin of
#     2x at least (`tests/test_torch_cuda.py`, the CPU simulation of that
#     rounding).  The backward rounds p and ds where splash rounds and takes
#     the same rule.
BF16_ATOL_RMS = {"mha": 0.02, "geglu": 0.02, "spacetime_bwd": 0.02, "flash": 0.02}
BF16_ABS = {"spacetime": (5e-2, 2e-2)}
BF16_RTOL, BF16_REL_NORM = 2.0 ** -6, 1e-2
F32_TOL = 1e-4


def compare(got: torch.Tensor, want: torch.Tensor, kind: str) -> dict:
    """Hold a kernel's output against its plain version (`kind`: "mha",
    "geglu", "spacetime", "spacetime_bwd" or "flash").  Returns the errors,
    the limits and "ok"."""
    g, w = got.float(), want.float()
    err = (g - w).abs()
    rel_norm = float(torch.linalg.vector_norm(g - w) / torch.linalg.vector_norm(w).clamp_min(1e-30))
    if want.dtype == torch.float32:
        atol = rtol = limit = F32_TOL
    elif kind in BF16_ABS:
        (atol, rtol), limit = BF16_ABS[kind], BF16_REL_NORM
    else:
        atol = BF16_ATOL_RMS[kind] * float(w.square().mean().sqrt())
        rtol, limit = BF16_RTOL, BF16_REL_NORM
    excess = float((err - atol - rtol * w.abs()).max())
    ok = (got.shape == want.shape and got.dtype == want.dtype
          and bool(torch.isfinite(g).all()) and excess <= 0 and rel_norm <= limit)
    return {"ok": ok, "max_abs_err": float(err.max()), "rel_norm": rel_norm, "atol": atol,
            "rtol": rtol, "rel_norm_limit": limit}
