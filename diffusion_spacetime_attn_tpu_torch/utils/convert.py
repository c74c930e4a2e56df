"""Checkpoint readers and weight converters: published torch state dicts ->
flax-path parameter trees; port of the JAX package's `utils/convert.py`.

The four external checkpoints the reference consumes:
  * CompVis `sd-v1-4.ckpt` (UNet `model.diffusion_model.*`, VAE
    `first_stage_model.*`, CLIP text `cond_stage_model.transformer.*`);
  * HF CLIP text and vision towers (transformers `CLIPTextModel`,
    `CLIPVisionModel`);
  * OpenAI CLIP ViT-B/32 (`clip.load`'s `ViT-B-32.pt`, a TorchScript
    archive, or its plain state dict);
  * HF RoBERTa-base and the fairseq Rel2Bbox layout checkpoint;
  * taming-transformers' LPIPS (VGG16 + linear heads), for VAE training.

Each converter takes a flat {name: array} dict (`load_torch_checkpoint`)
and returns the nested parameter tree of the JAX package's module, with
flax's layouts: torch Linear [out, in] -> kernel [in, out], torch Conv
[O, I, kh, kw] -> kernel [kh, kw, I, O], norm weight -> scale.  The port's
modules carry the same names, so `utils/weights.flatten_tree` and `bridge`
take such a tree onto a module strictly (a missing, unexpected or
mis-shaped key raises).
"""
from __future__ import annotations

import io
import os
import pickle
import zipfile
from typing import Dict

import numpy as np
import torch

from . import safetensors

# globals a tensor checkpoint needs besides storages (which torch's own
# unpickler resolves first); the fallback unpickler stubs every other one
_TENSOR_GLOBALS = {("collections", "OrderedDict"), ("torch", "Size"),
                   ("torch._utils", "_rebuild_tensor_v2"),
                   ("torch._utils", "_rebuild_parameter"),
                   ("torch._utils", "_rebuild_parameter_with_state")}


class _Stub:
    """Stands in for a pickled object of any class outside _TENSOR_GLOBALS."""

    def __init__(self, *args, **kwargs):
        self.args = args

    def __setstate__(self, state):
        self.state = state


class _StubUnpickler(pickle.Unpickler):
    def find_class(self, module, name):
        if (module, name) in _TENSOR_GLOBALS:
            return super().find_class(module, name)
        return type(name, (_Stub,), {"__module__": module})


class _StubPickle:
    """The `pickle_module` torch.load takes, with the stubbing unpickler."""
    Unpickler = _StubUnpickler

    @staticmethod
    def load(f, **kw):
        return _StubUnpickler(f, **kw).load()


def _is_torchscript(path: str) -> bool:
    with zipfile.ZipFile(path) as z:
        return any(n.endswith("/constants.pkl") for n in z.namelist())


def load_torch_checkpoint(path: str) -> Dict[str, np.ndarray]:
    """A `.ckpt` / `.pt` / `.pth` / `.safetensors` file -> {name: array} on
    the host: float32 numpy for a torch file; a `.safetensors` file keeps
    its dtype, as the JAX package's reader does (`utils/safetensors.py`).

    torch files: `torch.load(weights_only=True)` (memory-mapped when the file
    is a zip archive); a TorchScript archive (OpenAI's `ViT-B-32.pt`) through
    `torch.jit.load(...).state_dict()`; a pickle that names a class outside
    torch's tensor rebuilders (Lightning's callback state in a training
    checkpoint, often of a package that is not installed) through an
    unpickler that stubs every such class, so no code of it runs.  A
    top-level `"state_dict"` is unwrapped and only tensors are kept, cast to
    float32 as the JAX package's `.float().numpy()` does."""
    if not os.path.isfile(path):
        raise FileNotFoundError(f"no checkpoint file {path}")
    if path.endswith(".safetensors"):
        return safetensors.load_file(path)
    is_zip = zipfile.is_zipfile(path)
    if is_zip and _is_torchscript(path):
        obj = torch.jit.load(path, map_location="cpu").state_dict()
    else:
        try:
            obj = torch.load(path, map_location="cpu", weights_only=True, mmap=is_zip)
        except pickle.UnpicklingError:
            obj = torch.load(path, map_location="cpu", weights_only=False, mmap=is_zip,
                             pickle_module=_StubPickle)
    if isinstance(obj, dict) and "state_dict" in obj:
        obj = obj["state_dict"]
    return {k: v.float().numpy() for k, v in obj.items() if isinstance(v, torch.Tensor)}


def _dense(sd, name):
    out = {"kernel": sd[f"{name}.weight"].T}
    if f"{name}.bias" in sd:
        out["bias"] = sd[f"{name}.bias"]
    return out


def _hwio(w):
    """OIHW -> HWIO, for numpy arrays and (bfloat16) tensors alike."""
    return w.permute(2, 3, 1, 0) if isinstance(w, torch.Tensor) else np.transpose(w, (2, 3, 1, 0))


def _conv(sd, name):
    out = {"kernel": _hwio(sd[f"{name}.weight"])}
    if f"{name}.bias" in sd:
        out["bias"] = sd[f"{name}.bias"]
    return out


def _norm(sd, name):
    return {"scale": sd[f"{name}.weight"], "bias": sd[f"{name}.bias"]}


class _Stripped(dict):
    """The entries under `prefix`, without it; a missing key raises naming
    the checkpoint's full key."""

    def __init__(self, sd, prefix):
        super().__init__((k[len(prefix):], v) for k, v in sd.items() if k.startswith(prefix))
        self.prefix = prefix

    def __missing__(self, key):
        raise KeyError(f"the checkpoint has no {self.prefix}{key}")



# --------------------------------------------------------------------------
# SD v1 UNet (CompVis `model.diffusion_model.*` -> models.unet.UNet)
# --------------------------------------------------------------------------

def _res_block(sd, p):
    out = {
        "in_norm": {"GroupNorm_0": _norm(sd, f"{p}.in_layers.0")},
        "in_conv": _conv(sd, f"{p}.in_layers.2"),
        "emb_proj": _dense(sd, f"{p}.emb_layers.1"),
        "out_norm": {"GroupNorm_0": _norm(sd, f"{p}.out_layers.0")},
        "out_conv": _conv(sd, f"{p}.out_layers.3"),
    }
    if f"{p}.skip_connection.weight" in sd:
        out["skip"] = _conv(sd, f"{p}.skip_connection")
    return out


def _cross_attn(sd, p):
    return {
        "to_q": {"kernel": sd[f"{p}.to_q.weight"].T},
        "to_k": {"kernel": sd[f"{p}.to_k.weight"].T},
        "to_v": {"kernel": sd[f"{p}.to_v.weight"].T},
        "to_out": _dense(sd, f"{p}.to_out.0"),
    }


def _transformer_block(sd, p):
    return {
        "attn1": _cross_attn(sd, f"{p}.attn1"),
        "attn2": _cross_attn(sd, f"{p}.attn2"),
        "ff": {
            "proj_in": _dense(sd, f"{p}.ff.net.0.proj"),
            "proj_out": _dense(sd, f"{p}.ff.net.2"),
        },
        "norm1": _norm(sd, f"{p}.norm1"),
        "norm2": _norm(sd, f"{p}.norm2"),
        "norm3": _norm(sd, f"{p}.norm3"),
    }


def _spatial_transformer(sd, p, depth=1):
    out = {
        "norm": {"GroupNorm_0": _norm(sd, f"{p}.norm")},
        "proj_in": _conv(sd, f"{p}.proj_in"),
        "proj_out": _conv(sd, f"{p}.proj_out"),
    }
    for d in range(depth):
        out[f"block_{d}"] = _transformer_block(sd, f"{p}.transformer_blocks.{d}")
    return out


def convert_sd_unet(sd: Dict[str, np.ndarray], prefix: str = "model.diffusion_model.",
                    channel_mult=(1, 2, 4, 4), num_res_blocks: int = 2,
                    attention_ds=(1, 2, 4)):
    sd = _Stripped(sd, prefix)
    params = {
        "time_embed_0": _dense(sd, "time_embed.0"),
        "time_embed_2": _dense(sd, "time_embed.2"),
        "in_conv": _conv(sd, "input_blocks.0.0"),
        "mid_res_0": _res_block(sd, "middle_block.0"),
        "mid_attn": _spatial_transformer(sd, "middle_block.1"),
        "mid_res_1": _res_block(sd, "middle_block.2"),
        "out_norm": {"GroupNorm_0": _norm(sd, "out.0")},
        "out_conv": _conv(sd, "out.2"),
    }
    # encoder
    idx, k, ds = 1, 0, 1
    num_levels = len(channel_mult)
    for level in range(num_levels):
        for _ in range(num_res_blocks):
            params[f"down_res_{k}"] = _res_block(sd, f"input_blocks.{idx}.0")
            if ds in attention_ds:
                params[f"down_attn_{k}"] = _spatial_transformer(sd, f"input_blocks.{idx}.1")
            idx += 1
            k += 1
        if level != num_levels - 1:
            params[f"down_sample_{level}"] = {"conv": _conv(sd, f"input_blocks.{idx}.0.op")}
            idx += 1
            ds *= 2
    # decoder
    idx, k = 0, 0
    for level in reversed(range(num_levels)):
        for i in range(num_res_blocks + 1):
            params[f"up_res_{k}"] = _res_block(sd, f"output_blocks.{idx}.0")
            op = 1
            if ds in attention_ds:
                params[f"up_attn_{k}"] = _spatial_transformer(sd, f"output_blocks.{idx}.{op}")
                op += 1
            if level > 0 and i == num_res_blocks:
                params[f"up_sample_{level}"] = {
                    "conv": _conv(sd, f"output_blocks.{idx}.{op}.conv")}
                ds //= 2
            idx += 1
            k += 1
    return params


# --------------------------------------------------------------------------
# VAE (CompVis `first_stage_model.*` -> models.vae.AutoencoderKL)
# --------------------------------------------------------------------------

def _vae_res(sd, p):
    out = {
        "norm1": _norm(sd, f"{p}.norm1"),
        "conv1": _conv(sd, f"{p}.conv1"),
        "norm2": _norm(sd, f"{p}.norm2"),
        "conv2": _conv(sd, f"{p}.conv2"),
    }
    if f"{p}.nin_shortcut.weight" in sd:
        out["nin_shortcut"] = _conv(sd, f"{p}.nin_shortcut")
    return out


def _vae_attn(sd, p):
    return {
        "norm": _norm(sd, f"{p}.norm"),
        "q": _conv(sd, f"{p}.q"),
        "k": _conv(sd, f"{p}.k"),
        "v": _conv(sd, f"{p}.v"),
        "proj_out": _conv(sd, f"{p}.proj_out"),
    }


def convert_sd_vae(sd: Dict[str, np.ndarray], prefix: str = "first_stage_model.",
                   ch_mult=(1, 2, 4, 4), num_res_blocks: int = 2):
    sd = _Stripped(sd, prefix)
    num_levels = len(ch_mult)
    enc = {
        "conv_in": _conv(sd, "encoder.conv_in"),
        "mid_block_1": _vae_res(sd, "encoder.mid.block_1"),
        "mid_attn_1": _vae_attn(sd, "encoder.mid.attn_1"),
        "mid_block_2": _vae_res(sd, "encoder.mid.block_2"),
        "norm_out": _norm(sd, "encoder.norm_out"),
        "conv_out": _conv(sd, "encoder.conv_out"),
    }
    for level in range(num_levels):
        for i in range(num_res_blocks):
            enc[f"down_{level}_block_{i}"] = _vae_res(sd, f"encoder.down.{level}.block.{i}")
        if level != num_levels - 1:
            enc[f"down_{level}_downsample"] = _conv(sd, f"encoder.down.{level}.downsample.conv")
    dec = {
        "conv_in": _conv(sd, "decoder.conv_in"),
        "mid_block_1": _vae_res(sd, "decoder.mid.block_1"),
        "mid_attn_1": _vae_attn(sd, "decoder.mid.attn_1"),
        "mid_block_2": _vae_res(sd, "decoder.mid.block_2"),
        "norm_out": _norm(sd, "decoder.norm_out"),
        "conv_out": _conv(sd, "decoder.conv_out"),
    }
    for level in range(num_levels):
        for i in range(num_res_blocks + 1):
            dec[f"up_{level}_block_{i}"] = _vae_res(sd, f"decoder.up.{level}.block.{i}")
        if level != 0:
            dec[f"up_{level}_upsample"] = _conv(sd, f"decoder.up.{level}.upsample.conv")
    return {
        "encoder": enc,
        "decoder": dec,
        "quant_conv": _conv(sd, "quant_conv"),
        "post_quant_conv": _conv(sd, "post_quant_conv"),
    }


# --------------------------------------------------------------------------
# CLIP: HF text and vision towers, OpenAI's dual-tower model
# --------------------------------------------------------------------------

def _hf_layer(sd, p):
    return {
        "ln1": _norm(sd, f"{p}.layer_norm1"),
        "ln2": _norm(sd, f"{p}.layer_norm2"),
        "attn": {
            "q_proj": _dense(sd, f"{p}.self_attn.q_proj"),
            "k_proj": _dense(sd, f"{p}.self_attn.k_proj"),
            "v_proj": _dense(sd, f"{p}.self_attn.v_proj"),
            "out_proj": _dense(sd, f"{p}.self_attn.out_proj"),
        },
        "mlp": {
            "fc1": _dense(sd, f"{p}.mlp.fc1"),
            "fc2": _dense(sd, f"{p}.mlp.fc2"),
        },
    }


def _hf_layers(sd, params):
    i = 0
    while f"encoder.layers.{i}.layer_norm1.weight" in sd:
        params[f"layer_{i}"] = _hf_layer(sd, f"encoder.layers.{i}")
        i += 1
    return params


def convert_hf_clip_text(sd: Dict[str, np.ndarray], prefix: str = "text_model."):
    """transformers CLIPTextModel -> models.clip.CLIPTextTower params."""
    sd = _Stripped(sd, prefix)
    return _hf_layers(sd, {
        "token_embedding": {"embedding": sd["embeddings.token_embedding.weight"]},
        "position_embedding": sd["embeddings.position_embedding.weight"],
        "ln_final": _norm(sd, "final_layer_norm"),
    })


def convert_hf_clip_vision(sd: Dict[str, np.ndarray], prefix: str = "vision_model."):
    """transformers CLIPVisionModel -> models.clip.CLIPVisionTower params."""
    sd = _Stripped(sd, prefix)
    return _hf_layers(sd, {
        "patch_embedding": {
            "kernel": _hwio(sd["embeddings.patch_embedding.weight"])},
        "class_embedding": sd["embeddings.class_embedding"],
        "position_embedding": sd["embeddings.position_embedding.weight"],
        "ln_pre": _norm(sd, "pre_layrnorm"),   # (sic) HF key spelling
        "ln_post": _norm(sd, "post_layernorm"),
    })


def _openai_layer(sd, p):
    w = sd[f"{p}.attn.in_proj_weight"]
    b = sd[f"{p}.attn.in_proj_bias"]
    d = w.shape[0] // 3
    return {
        "ln1": _norm(sd, f"{p}.ln_1"),
        "ln2": _norm(sd, f"{p}.ln_2"),
        "attn": {
            "q_proj": {"kernel": w[:d].T, "bias": b[:d]},
            "k_proj": {"kernel": w[d:2 * d].T, "bias": b[d:2 * d]},
            "v_proj": {"kernel": w[2 * d:].T, "bias": b[2 * d:]},
            "out_proj": _dense(sd, f"{p}.attn.out_proj"),
        },
        "mlp": {
            "fc1": _dense(sd, f"{p}.mlp.c_fc"),
            "fc2": _dense(sd, f"{p}.mlp.c_proj"),
        },
    }


def _openai_layers(sd, prefix, params):
    i = 0
    while f"{prefix}resblocks.{i}.ln_1.weight" in sd:
        params[f"layer_{i}"] = _openai_layer(sd, f"{prefix}resblocks.{i}")
        i += 1
    return params


def convert_openai_clip(sd: Dict[str, np.ndarray]):
    """OpenAI CLIP (`clip.load`'s state dict) -> models.clip.CLIP params."""
    vision = _openai_layers(sd, "visual.transformer.", {
        "patch_embedding": {"kernel": _hwio(sd["visual.conv1.weight"])},
        "class_embedding": sd["visual.class_embedding"],
        "position_embedding": sd["visual.positional_embedding"],
        "ln_pre": _norm(sd, "visual.ln_pre"),
        "ln_post": _norm(sd, "visual.ln_post"),
    })
    text = _openai_layers(sd, "transformer.", {
        "token_embedding": {"embedding": sd["token_embedding.weight"]},
        "position_embedding": sd["positional_embedding"],
        "ln_final": _norm(sd, "ln_final"),
    })
    return {
        "vision": vision,
        "text": text,
        # OpenAI stores the projections as [in, out] matrices already
        "visual_projection": {"kernel": sd["visual.proj"]},
        "text_projection": {"kernel": sd["text_projection"]},
    }


# --------------------------------------------------------------------------
# Layout predictor: HF RoBERTa backbone, fairseq Rel2Bbox checkpoint
# --------------------------------------------------------------------------

def _roberta_layer(sd, p, names):
    q, k, v, out, attn_ln, fc1, fc2, final_ln = names
    return {
        "attn": {"q": _dense(sd, f"{p}.{q}"), "k": _dense(sd, f"{p}.{k}"),
                 "v": _dense(sd, f"{p}.{v}"), "out": _dense(sd, f"{p}.{out}")},
        "attn_ln": _norm(sd, f"{p}.{attn_ln}"),
        "fc1": _dense(sd, f"{p}.{fc1}"),
        "fc2": _dense(sd, f"{p}.{fc2}"),
        "final_ln": _norm(sd, f"{p}.{final_ln}"),
    }


_HF_ROBERTA = ("attention.self.query", "attention.self.key", "attention.self.value",
               "attention.output.dense", "attention.output.LayerNorm", "intermediate.dense",
               "output.dense", "output.LayerNorm")
_FAIRSEQ = ("self_attn.q_proj", "self_attn.k_proj", "self_attn.v_proj", "self_attn.out_proj",
            "self_attn_layer_norm", "fc1", "fc2", "final_layer_norm")


def convert_hf_roberta(sd: Dict[str, np.ndarray], prefix: str = ""):
    """transformers RobertaModel -> models.layout RobertaBackbone params (no
    object embedding)."""
    sd = _Stripped(sd, prefix)
    pos = sd["embeddings.position_embeddings.weight"]
    # HF adds a constant token_type(0) embedding everywhere; fold it into the
    # position table (the backbone has no token_type input)
    if "embeddings.token_type_embeddings.weight" in sd:
        pos = pos + sd["embeddings.token_type_embeddings.weight"][0]
    params = {
        "token_embedding": {"embedding": sd["embeddings.word_embeddings.weight"]},
        "position_embedding": {"embedding": pos},
        "emb_ln": _norm(sd, "embeddings.LayerNorm"),
    }
    i = 0
    while f"encoder.layer.{i}.attention.self.query.weight" in sd:
        params[f"layer_{i}"] = _roberta_layer(sd, f"encoder.layer.{i}", _HF_ROBERTA)
        i += 1
    return params


def convert_fairseq_rel2bbox(sd: Dict[str, np.ndarray]) -> Dict:
    """The reference's `Rel2Bbox` state dict (`checkpoint_90_0.0.pth`) -> the
    full LayoutPredictor tree.

    The backbone is a torch.hub RoBERTa with fairseq naming under any prefix
    down to `sentence_encoder.` (`embed_tokens`, `embed_positions`,
    `layernorm_embedding`, `object_embedding`, `layers.{i}.self_attn.*`,
    `self_attn_layer_norm`, `fc1`, `fc2`, `final_layer_norm`); the GMM head
    is `bbox_head.Decoder.output_Layer` and
    `bbox_head.Decoder.box_predictor.xy_bivariate` (or the same under
    `Decoder.`).  Dead modules (lm_head, the unused decoder, the refine
    stages) are ignored.  fairseq's learned positions (`padding_idx +
    cumsum(mask)`) and RoBERTa's unscaled embeddings match the backbone
    without remapping."""
    enc = {}
    for k, v in sd.items():
        pos = k.find("sentence_encoder.")
        if pos >= 0:
            enc[k[pos + len("sentence_encoder."):]] = v
    if not enc:
        raise ValueError("no sentence_encoder.* keys: not a fairseq Rel2Bbox checkpoint")
    backbone = {
        "token_embedding": {"embedding": enc["embed_tokens.weight"]},
        "position_embedding": {"embedding": enc["embed_positions.weight"]},
        "emb_ln": _norm(enc, "layernorm_embedding"),
        "object_embedding": enc["object_embedding"].reshape(1, -1),
    }
    i = 0
    while f"layers.{i}.self_attn.q_proj.weight" in enc:
        backbone[f"layer_{i}"] = _roberta_layer(enc, f"layers.{i}", _FAIRSEQ)
        i += 1
    head_prefix = next((c for c in ("bbox_head.Decoder.", "Decoder.")
                        if f"{c}output_Layer.weight" in sd), None)
    if head_prefix is None:
        raise ValueError("no bbox_head.Decoder.output_Layer.* keys")
    head = {
        "output_layer": _dense(sd, f"{head_prefix}output_Layer"),
        "xy_bivariate": _dense(sd, f"{head_prefix}box_predictor.xy_bivariate"),
    }
    return {"backbone": backbone, "head": head}


def load_fairseq_dictionary(path: str) -> Dict[int, int]:
    """The reference's `configs/test-dictionary.pkl` (a pickled fairseq
    `Dictionary`) -> {gpt2_bpe_id: fairseq_index}.

    After the 4 specials (<s>=0, <pad>=1, </s>=2, <unk>=3) the dictionary's
    symbols are GPT-2 byte-BPE ids written as strings, in corpus-frequency
    order.  Read without fairseq: every class the pickle names is stubbed,
    and only the plain `symbols` list is used."""
    if not os.path.isfile(path):
        raise FileNotFoundError(f"no fairseq dictionary {path}")
    with open(path, "rb") as f:
        obj = _StubUnpickler(io.BytesIO(f.read())).load()
    symbols = obj["symbols"] if isinstance(obj, dict) else obj.state["symbols"]
    return {int(sym): idx for idx, sym in enumerate(symbols) if sym.lstrip("-").isdigit()}


def convert_sd_vq(sd: Dict[str, np.ndarray], prefix: str = "first_stage_model.",
                  ch_mult=(1, 2, 4, 4), num_res_blocks: int = 2):
    """The reference `VQModel` state dict (`autoencoder.py:14-283`: the KL
    layout plus `quantize.embedding.weight` [n_embed, embed_dim]) ->
    models.vae.VQModel's tree."""
    params = convert_sd_vae(sd, prefix=prefix, ch_mult=ch_mult, num_res_blocks=num_res_blocks)
    params["quantize"] = {"embedding": _Stripped(sd, prefix)["quantize.embedding.weight"]}
    return params


# torchvision VGG16 `features` indices of the 13 convolutions, and the taming
# LPIPS slice each sits in (`taming/modules/losses/lpips.py` vgg16 slices)
_VGG16_CONV_IDX = (0, 2, 5, 7, 10, 12, 14, 17, 19, 21, 24, 26, 28)
_VGG16_SLICE_OF = {0: 1, 2: 1, 5: 2, 7: 2, 10: 3, 12: 3, 14: 3,
                   17: 4, 19: 4, 21: 4, 24: 5, 26: 5, 28: 5}


def convert_lpips(sd: Dict[str, np.ndarray]):
    """A taming-transformers LPIPS checkpoint (`net.slice{k}.{i}.weight`,
    the VGG16 convolutions at torchvision's feature indices, and
    `lin{j}.model.1.weight`, the 1×1 heads) -> `training.perceptual.LPIPS`'s
    tree.  The convolutions may also come as torchvision's VGG16
    `features.{i}.*` beside taming's `vgg.pth` heads (the two published
    files taming's LPIPS loads).  The scaling layer's constants are in the
    module."""
    vgg = {}
    for j, i in enumerate(_VGG16_CONV_IDX):
        name = f"net.slice{_VGG16_SLICE_OF[i]}.{i}"
        tv = f"features.{i}"              # torchvision's key; a missing key names taming's
        vgg[f"conv_{j}"] = _conv(sd, tv if f"{name}.weight" not in sd and f"{tv}.weight" in sd
                                 else name)
    params = {"vgg": vgg}
    for j in range(5):
        params[f"lin_{j}"] = {"kernel": _hwio(sd[f"lin{j}.model.1.weight"])}
    return params
