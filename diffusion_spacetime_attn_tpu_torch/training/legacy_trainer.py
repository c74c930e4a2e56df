"""Legacy layout-trainer family (reference `trainer/{Trainer,RegTrainer,
Finetune}.py`); port of the JAX package's `training/legacy_trainer.py`.

  * `LegacyDiscreteTrainer` (`Trainer.py:83-205`): Rel2Layout, teacher-forced
    shifted targets, NLL(ignore pad, sum) / B on the (cats, pos, shape)
    heads weighted 0.4 / 0.3 / 0.3;
  * `LegacyRegTrainer` (`RegTrainer.py:94-180`): Rel2RegLayout, NLL cats / B
    + λ · RegLoss(mean) on the sigmoid boxes;
  * `LegacyFinetuneTrainer` (`Finetune.py:77-141`): the RelEncoder with a
    vocabulary and a token-type head, (NLL vocab + NLL type) / (2B).

JAX's `optax.multi_transform` of two `adamw`s over the encoder / decoder
partition is `torch.optim.AdamW` with two parameter groups and their own
learning rates: a parameter is "encoder" when its top-level name is
`encoder` or `text_encoder`, else "decoder".  The state's `params` is the
module and `opt_state` its optimizer, both updated in place by
`train_step(state, batch)`, which keeps JAX's signature; `init_state(seed,
init=None)` gives flax-like seeded weights (`utils/testing.init_flax_like_`)
or loads a flat JAX tree (`utils/weights.load_flat`).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch
from torch import nn

from ..models.layout.legacy import LegacyConfig, RelEncoder, Rel2Layout, Rel2RegLayout
from ..utils.testing import init_flax_like_
from ..utils.weights import load_flat
from .legacy_losses import nll_loss, reg_loss

PAD = 0
ENCODER_GROUPS = ("encoder", "text_encoder")


@dataclasses.dataclass(frozen=True)
class LegacyTrainConfig:
    """`configs/default.yaml` SOLVER block as the legacy trainers read it."""

    encoder_lr: float = 1e-4
    decoder_lr: float = 1e-4
    betas: Tuple[float, float] = (0.9, 0.999)
    weight_decay: float = 0.0
    reg_box_weight: float = 1.0      # λ (`RegTrainer.py:41`)


class LegacyTrainState(NamedTuple):
    params: nn.Module
    opt_state: torch.optim.Optimizer
    step: int


def group_of(name: str) -> str:
    """The optimizer group of a parameter ("a.b.c" state-dict name)."""
    return "encoder" if name.split(".")[0] in ENCODER_GROUPS else "decoder"


def make_optimizer(cfg: LegacyTrainConfig, model: nn.Module) -> torch.optim.Optimizer:
    groups: Dict[str, list] = {"encoder": [], "decoder": []}
    for name, p in model.named_parameters():
        groups[group_of(name)].append(p)
    lr = {"encoder": cfg.encoder_lr, "decoder": cfg.decoder_lr}
    return torch.optim.AdamW([{"params": v, "lr": lr[k], "name": k} for k, v in groups.items()
                              if v], betas=cfg.betas, eps=1e-8, weight_decay=cfg.weight_decay)


class MLMModel(nn.Module):
    """The RelEncoder with a vocabulary and a token-type head (the model of
    `Finetune.py`)."""

    def __init__(self, cfg: LegacyConfig):
        super().__init__()
        self.encoder = RelEncoder(cfg)
        self.vocab_head = nn.Linear(cfg.hidden, cfg.vocab_size)
        self.type_head = nn.Linear(cfg.hidden, 4)

    def forward(self, tokens, obj_ids, segments, token_types, pad_mask):
        memory = self.encoder(tokens, obj_ids, segments, token_types, pad_mask)[0]
        return self.vocab_head(memory), self.type_head(memory)


class _LegacyTrainer:
    model_cls: Any = None

    def __init__(self, model_cfg: LegacyConfig, cfg: LegacyTrainConfig = LegacyTrainConfig(),
                 device="cuda"):
        self.device = torch.device(device)
        with self.device:
            self.model = self.model_cls(model_cfg)
        self.cfg = cfg

    def init_state(self, seed: int = 0, init: Optional[Dict] = None) -> LegacyTrainState:
        if init is not None:
            load_flat(self.model, init)
        else:
            init_flax_like_(self.model, seed)
        return LegacyTrainState(self.model, make_optimizer(self.cfg, self.model), 0)

    def _batch(self, batch) -> Dict[str, torch.Tensor]:
        return {k: torch.as_tensor(v, device=self.device) for k, v in batch.items()}

    def _enc_args(self, b):
        return (b["tokens"], b["obj_ids"], b["segments"], b["token_types"], b["tokens"] != PAD)

    def train_step(self, state: LegacyTrainState, batch):
        """One AdamW update of both groups; returns (state, metrics)."""
        model, opt = state.params, state.opt_state
        model.train()
        opt.zero_grad(set_to_none=True)
        loss, metrics = self.loss_fn(model, self._batch(batch))
        loss.backward()
        opt.step()
        return (LegacyTrainState(model, opt, state.step + 1),
                {k: v.detach() for k, v in metrics.items()})


def _lp(t: torch.Tensor) -> torch.Tensor:
    return torch.log_softmax(t.reshape(-1, t.shape[-1]).float(), -1)


class LegacyDiscreteTrainer(_LegacyTrainer):
    """`Trainer.py` for Rel2Layout."""

    model_cls = Rel2Layout

    def loss_fn(self, model, b):
        out_c, out_p, out_s = model(*self._enc_args(b), b["cats"][:, :-1], b["pos"][:, :-1],
                                    b["shapes"][:, :-1])
        B = b["cats"].shape[0]
        c_loss = nll_loss(_lp(out_c), b["cats"][:, 1:].reshape(-1), PAD) / B
        p_loss = nll_loss(_lp(out_p), b["pos"][:, 1:].reshape(-1), PAD) / B
        s_loss = nll_loss(_lp(out_s), b["shapes"][:, 1:].reshape(-1), PAD) / B
        loss = 0.4 * c_loss + 0.3 * p_loss + 0.3 * s_loss        # Trainer.py:164
        return loss, dict(loss=loss, cat_loss=c_loss, pos_loss=p_loss, shape_loss=s_loss)


class LegacyRegTrainer(_LegacyTrainer):
    """`RegTrainer.py` for Rel2RegLayout."""

    model_cls = Rel2RegLayout

    def loss_fn(self, model, b):
        out_c, out_box = model(*self._enc_args(b), b["cats"][:, :-1],
                               b["boxes"][:, :-1].float())
        B = b["cats"].shape[0]
        c_loss = nll_loss(_lp(out_c), b["cats"][:, 1:].reshape(-1), PAD) / B
        b_loss = reg_loss(out_box.reshape(-1, 4), b["boxes"][:, 1:].reshape(-1, 4).float(),
                          pretrain=False, reduction="mean")
        lam = self.cfg.reg_box_weight
        loss = c_loss + lam * b_loss                              # RegTrainer.py:156
        return loss, dict(loss=loss, cat_loss=c_loss, box_loss=lam * b_loss)


class LegacyFinetuneTrainer(_LegacyTrainer):
    """`Finetune.py`: masked-LM training of the legacy encoder over
    `legacy_data.mask_relation_sentence` batches."""

    model_cls = MLMModel

    def loss_fn(self, model, b):
        vocab, ttype = model(*self._enc_args(b))
        B = b["tokens"].shape[0]
        v_loss = nll_loss(_lp(vocab), b["labels"].reshape(-1), PAD)
        t_loss = nll_loss(_lp(ttype), b["type_labels"].reshape(-1), PAD)
        loss = (v_loss + t_loss) / (2 * B)
        return loss, dict(loss=loss, vocab_loss=v_loss, type_loss=t_loss)
