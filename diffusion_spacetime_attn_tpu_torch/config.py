"""Typed configuration, a copy of the JAX package's `config.py` dataclasses.

Same fields, same defaults.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class UNetConfig:
    """SD v1 UNet (reference `configs/stable-diffusion/v1-inference.yaml:30-44`)."""

    in_channels: int = 4
    out_channels: int = 4
    model_channels: int = 320
    channel_mult: Tuple[int, ...] = (1, 2, 4, 4)
    num_res_blocks: int = 2
    # downsample factors at which SpatialTransformers are inserted
    attention_resolutions: Tuple[int, ...] = (4, 2, 1)
    num_heads: int = 8
    # if set, heads = channels // num_head_channels per level
    num_head_channels: Optional[int] = None
    transformer_depth: int = 1
    context_dim: int = 768
    dropout: float = 0.0
    # compute dtype name ("bfloat16" or "float32")
    dtype: str = "float32"
    # long self-attention (the sites that pass `flash_ok`) through the CUDA
    # flash kernels, forward and backward (ops/cuda_flash.py); wins over
    # use_mha where both apply
    use_flash: bool = False
    # self-attention (attn1) through the CUDA MHA kernel (ops/cuda_mha.py)
    use_mha: bool = False
    # controlled cross-attention's cond half through the CUDA spacetime
    # kernel (ops/cuda_spacetime.py)
    use_fused_control: bool = False
    # GEGLU feed-forward through the CUDA kernel (ops/cuda_geglu.py)
    use_fused_ff: bool = False
    # JAX's optimization_barrier between each ResBlock's GroupNorm+SiLU and
    # its conv.  Eager PyTorch always materializes that output before the
    # conv, which is what the barrier forces in XLA, so the flag changes
    # nothing here
    conv_norm_barrier: bool = False
    # >0: the plain self-attention path in query chunks of this size (the
    # same numerics, O(q_chunk·Lk) score memory instead of O(Lq·Lk)); a site
    # a kernel takes is untouched (ops/attention.py)
    attn_q_chunk: int = 0
    # dtype the plain self-attention's float32 scores are rounded to before
    # the float32 scale and softmax ("float32" | "bfloat16"); a site a
    # kernel takes is untouched
    attn_scores_dtype: str = "float32"


@dataclasses.dataclass(frozen=True)
class VAEConfig:
    """AutoencoderKL f=8 (reference `v1-inference.yaml:46-68`)."""

    ch: int = 128
    ch_mult: Tuple[int, ...] = (1, 2, 4, 4)
    num_res_blocks: int = 2
    z_channels: int = 4
    embed_dim: int = 4
    out_ch: int = 3
    in_ch: int = 3
    scale_factor: float = 0.18215
    attn_resolutions: Tuple[int, ...] = ()
    resolution: int = 256
    dtype: str = "float32"
    # codebook size of the VQ variant; the KL model ignores it
    n_embed: int = 8192


@dataclasses.dataclass(frozen=True)
class CLIPTextConfig:
    """CLIP text transformer; defaults = the ViT-L/14 text tower."""

    vocab_size: int = 49408
    width: int = 768
    layers: int = 12
    heads: int = 12
    max_len: int = 77
    dtype: str = "float32"


@dataclasses.dataclass(frozen=True)
class CLIPVisionConfig:
    """CLIP vision transformer (ViT-B/32 defaults), the image tower of the
    loss CLIP (`models/clip.py:CLIPVisionTower`)."""

    image_size: int = 224
    patch_size: int = 32
    width: int = 768
    layers: int = 12
    heads: int = 12
    projection_dim: int = 512
    dtype: str = "float32"


@dataclasses.dataclass(frozen=True)
class CLIPConfig:
    """Dual-tower CLIP behind the DCLIP loss (`models/clip.py:CLIP`,
    `pipeline/losses.py`)."""

    vision: CLIPVisionConfig = CLIPVisionConfig()
    text: CLIPTextConfig = CLIPTextConfig(width=512, heads=8, layers=12)
    projection_dim: int = 512


# The ViT-L/14 joint-space CLIP (OpenAI's `ViT-L/14`): a 768-wide text tower
# of 12 layers and 12 heads, a 224² vision tower with patch 14, width 1024,
# 24 layers and 16 heads, both projected to 768.  The retrieval-augmented
# diffusion model is conditioned on this space (`pipeline/knn2img.py`), so
# knn2img's text tower and train_searcher's image tower take it at full
# width; the JAX scripts build `CLIPConfig()` (ViT-B/32, 512 wide) there,
# which cannot feed the RDM's 768-wide context.
VIT_L14_JOINT_CLIP = CLIPConfig(
    vision=CLIPVisionConfig(image_size=224, patch_size=14, width=1024, layers=24, heads=16,
                            projection_dim=768),
    text=CLIPTextConfig(width=768, layers=12, heads=12),
    projection_dim=768)


@dataclasses.dataclass(frozen=True)
class ScheduleConfig:
    """DDPM noise schedule (reference `v1-inference.yaml:5-6`)."""

    num_train_timesteps: int = 1000
    linear_start: float = 0.00085
    linear_end: float = 0.0120
    schedule: str = "linear"


@dataclasses.dataclass(frozen=True)
class SpaceTimeConfig:
    """The paper's method constants."""

    num_steps: int = 50
    guidance_scale: float = 7.5
    radius: float = 0.2
    epochs: int = 3
    lr: float = 0.005
    init_coef: float = 5.0
    local_loss_weight: float = 5.0
    crop_half: float = 0.2
    max_objects: int = 4
    image_size: int = 512
    latent_size: int = 64


@dataclasses.dataclass(frozen=True)
class LayoutConfig:
    """Layout predictor = RoBERTa-base encoder + object-position embedding +
    GMM center head (reference: `layout_predictor/LayoutTransformer/model/Model.py:1017-1034`,
    `model/bbox_head.py:46-306`).  `refine_layers` / `refine_heads` describe
    the reference's refine encoder, which its forward never runs; they are
    kept so a run dir's `config.json` loads unchanged."""

    vocab_size: int = 50265
    hidden: int = 768
    layers: int = 12
    heads: int = 12
    ffn_dim: int = 3072
    max_positions: int = 514
    pad_token_id: int = 1
    max_len: int = 128                  # BPE sequence length (`inference_coco.py:490`)
    gmm_components: int = 5             # `bbox_head.py:46`
    box_dim: int = 2                    # (x, y) centers only
    refine_layers: int = 2
    refine_heads: int = 2
    dtype: str = "float32"


@dataclasses.dataclass(frozen=True)
class LayoutTrainConfig:
    """Layout-predictor training hyperparameters (reference:
    `configs/coco/coco_seq2seq_v9_ablation_4.yaml:47-63`, `trainer/Pretrain.py`)."""

    batch_size: int = 64
    epochs: int = 100
    encoder_max_lr: float = 1e-6
    head_max_lr: float = 4e-5
    warmup_steps: int = 1000
    hold_steps: int = 2000
    decay_steps: int = 100000
    gmm_loss_weight: float = 0.1        # `Pretrain.py:262-266`
    hinge_margin: float = 0.2           # `loss.py:315-333`
    grad_clip_norm: float = 0.0         # 0 = off (the reference has none)
    checkpoint_every: int = 10          # epochs


@dataclasses.dataclass(frozen=True)
class LDMTrainConfig:
    """UNet (latent-diffusion) training hyperparameters (reference:
    `main.py:674-689` LR scaling, `ddpm.py:55-113` loss / EMA knobs,
    `ddpm.py:1379-1388` AdamW)."""

    batch_size: int = 4                  # per device
    base_lr: float = 1e-4
    scale_lr: bool = True                # lr = accum × ndev × batch × base_lr
    accum_steps: int = 1                 # accumulate_grad_batches
    weight_decay: float = 1e-2           # torch AdamW's default, as the reference
    grad_clip_norm: float = 0.0          # 0 = no clipping (Lightning's default)
    use_ema: bool = True
    ema_decay: float = 0.9999            # LitEma's default
    parameterization: str = "eps"        # "eps" | "x0"
    loss_type: str = "l2"                # "l2" | "l1"
    l_simple_weight: float = 1.0
    original_elbo_weight: float = 0.0
    learn_logvar: bool = False
    logvar_init: float = 0.0
    # LR-multiplier schedule over the scaled lr (reference `main.py:691-701`):
    # "none" | "lambda_linear" | "warmup_cosine"
    lr_schedule: str = "none"
    lr_warmup_steps: int = 10000
    lr_f_start: float = 1e-6
    lr_f_min: float = 1.0
    lr_f_max: float = 1.0
    lr_cycle_steps: int = 1_000_000_000  # one unbounded cycle


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    unet: UNetConfig = UNetConfig()
    vae: VAEConfig = VAEConfig()
    text_encoder: CLIPTextConfig = CLIPTextConfig()
    loss_clip: CLIPConfig = CLIPConfig()
    schedule: ScheduleConfig = ScheduleConfig()
    spacetime: SpaceTimeConfig = SpaceTimeConfig()
