"""Legacy layout model family (Rel2Layout / Rel2RegLayout / Text2Layout);
port of the JAX package's `models/layout/legacy.py` (reference
`model/Model.py:817-1016`, `model/Encoder.py:20-152`,
`model/Decoder.py:211-306`, `model/Embedding.py:50-128`,
`model/Inference.py:8-301`).

Dead code in the reference (its `build_model` only builds Rel2Bbox), kept
for the surface.  Module names follow the flax tree, so the weight bridge
(`utils/weights.load_flat`) loads JAX's params into these modules: flax's
per-head attention kernels fold into the `query` / `key` / `value` / `out`
Linear layers.  Numerics are flax's: LayerNorm eps 1e-6, the query scaled
by dh^-½, a float32 softmax, masked logits set to float32's lowest value.
Attention is plain matmul + softmax (no kernel: JAX has none here either).

`greedy_decode`, `beam_decode` (a static [B, K] beam, pos and shape greedy
per hypothesis, finished hypotheses absorbing at zero cost; ties broken
towards the lower index as `lax.top_k` does) and `greedy_decode_reg` re-run
the decoder over the fixed-length prefix each step, as JAX's scans do.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..encoders import TransformerEmbedder

PAD, BOS, EOS, MASK = 0, 1, 2, 3


@dataclasses.dataclass(frozen=True)
class LegacyConfig:
    """`Rel2Layout.__init__` defaults (`Model.py:939`)."""

    vocab_size: int = 204
    obj_id_size: int = 154
    cls_size: int = 154
    pos_size: int = 68
    shape_size: int = 68
    hidden: int = 512
    layers: int = 6
    heads: int = 8
    max_rel_pair: int = 33
    max_out_len: int = 64


def _as_long(x, device) -> torch.Tensor:
    return torch.as_tensor(x, device=device).long()


class MHA(nn.Module):
    """flax `MultiHeadDotProductAttention(qkv_features=dim, out_features=dim)`
    with an optional boolean mask (True = attend) broadcast to [B, H, Lq, Lk]."""

    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.heads = heads
        self.query, self.key, self.value = (nn.Linear(dim, dim) for _ in range(3))
        self.out = nn.Linear(dim, dim)

    def forward(self, x, kv, mask=None):
        B, Lq, D = x.shape
        Lk = kv.shape[1]
        hd = D // self.heads
        q = self.query(x).reshape(B, Lq, self.heads, hd) / hd ** 0.5
        k = self.key(kv).reshape(B, Lk, self.heads, hd)
        v = self.value(kv).reshape(B, Lk, self.heads, hd)
        logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
        if mask is not None:
            logits = logits.masked_fill(~mask, torch.finfo(torch.float32).min)
        p = torch.softmax(logits, dim=-1)
        o = torch.einsum("bhqk,bkhd->bqhd", p, v.float()).reshape(B, Lq, D)
        return self.out(o.to(x.dtype))


class PreLNBlock(nn.Module):
    """joeynmt encoder layer: LN -> self-attn -> res, LN -> FF -> res."""

    def __init__(self, hidden: int, heads: int):
        super().__init__()
        self.ln1 = nn.LayerNorm(hidden, eps=1e-6)
        self.attn = MHA(hidden, heads)
        self.ln2 = nn.LayerNorm(hidden, eps=1e-6)
        self.ff1 = nn.Linear(hidden, hidden * 4)
        self.ff2 = nn.Linear(hidden * 4, hidden)

    def forward(self, x, mask=None):
        h = self.ln1(x)
        x = x + self.attn(h, h, mask)
        return x + self.ff2(F.relu(self.ff1(self.ln2(x))))


class PreLNDecoderBlock(nn.Module):
    """LN -> causal self-attn -> res, LN -> cross-attn -> res, LN -> FF -> res."""

    def __init__(self, hidden: int, heads: int):
        super().__init__()
        self.ln1 = nn.LayerNorm(hidden, eps=1e-6)
        self.self_attn = MHA(hidden, heads)
        self.ln2 = nn.LayerNorm(hidden, eps=1e-6)
        self.cross_attn = MHA(hidden, heads)
        self.ln3 = nn.LayerNorm(hidden, eps=1e-6)
        self.ff1 = nn.Linear(hidden, hidden * 4)
        self.ff2 = nn.Linear(hidden * 4, hidden)

    def forward(self, x, memory, self_mask, cross_mask):
        h = self.ln1(x)
        x = x + self.self_attn(h, h, self_mask)
        x = x + self.cross_attn(self.ln2(x), memory, cross_mask)
        return x + self.ff2(F.relu(self.ff1(self.ln3(x))))


class RelEncoder(nn.Module):
    """4-way summed embeddings -> pre-LN encoder -> 3 classifier heads."""

    def __init__(self, cfg: LegacyConfig):
        super().__init__()
        c = self.cfg = cfg
        self.word = nn.Embedding(c.vocab_size, c.hidden)
        self.obj_id = nn.Embedding(c.obj_id_size, c.hidden)
        self.segment = nn.Embedding(c.max_rel_pair, c.hidden)
        self.token_type = nn.Embedding(4, c.hidden)
        for i in range(c.layers):
            self.add_module(f"layer_{i}", PreLNBlock(c.hidden, c.heads))
        self.ln_out = nn.LayerNorm(c.hidden, eps=1e-6)
        self.vocab_cls = nn.Linear(c.hidden, c.vocab_size)
        self.obj_id_cls = nn.Linear(c.hidden, c.obj_id_size)
        self.token_type_cls = nn.Linear(c.hidden, 4)

    def forward(self, tokens, obj_ids, segments, token_types, pad_mask):
        x = (self.word(tokens.long()) + self.obj_id(obj_ids.long())
             + self.segment(segments.long()) + self.token_type(token_types.long()))
        mask = pad_mask.bool()[:, None, None, :]
        for i in range(self.cfg.layers):
            x = getattr(self, f"layer_{i}")(x, mask)
        x = self.ln_out(x)
        return x, self.vocab_cls(x), self.obj_id_cls(x), self.token_type_cls(x)


class _Decoder(nn.Module):
    def __init__(self, cfg: LegacyConfig):
        super().__init__()
        self.cfg = cfg
        for i in range(cfg.layers):
            self.add_module(f"layer_{i}", PreLNDecoderBlock(cfg.hidden, cfg.heads))
        self.ln_out = nn.LayerNorm(cfg.hidden, eps=1e-6)

    def forward(self, trg_embed, memory, src_pad_mask, causal: bool = True):
        T = trg_embed.shape[1]
        self_mask = (torch.tril(torch.ones(1, 1, T, T, dtype=torch.bool,
                                           device=trg_embed.device)) if causal else None)
        cross = src_pad_mask.bool()[:, None, None, :]
        x = trg_embed
        for i in range(self.cfg.layers):
            x = getattr(self, f"layer_{i}")(x, memory, self_mask, cross)
        return self.ln_out(x)


class _DiscreteHeads(nn.Module):
    """The (cls, pos, shape) token embeddings, decoder and heads shared by
    Rel2Layout and Text2Layout (`Add_Embeddings`, `Embedding.py:85`)."""

    def _build_decoder(self, c: LegacyConfig):
        self.cls_embed = nn.Embedding(c.cls_size, c.hidden)
        self.pos_embed = nn.Embedding(c.pos_size, c.hidden)
        self.shape_embed = nn.Embedding(c.shape_size, c.hidden)
        self.decoder = _Decoder(c)
        self.cls_head = nn.Linear(c.hidden, c.cls_size)
        self.pos_head = nn.Linear(c.hidden, c.pos_size)
        self.shape_head = nn.Linear(c.hidden, c.shape_size)

    def decode(self, cls_tok, pos_tok, shape_tok, memory, src_pad_mask):
        trg = (self.cls_embed(cls_tok.long()) + self.pos_embed(pos_tok.long())
               + self.shape_embed(shape_tok.long()))
        h = self.decoder(trg, memory, src_pad_mask)
        return self.cls_head(h), self.pos_head(h), self.shape_head(h)


class Rel2Layout(_DiscreteHeads):
    """Discrete AR layout decoder over (cls, pos, shape) token trios."""

    def __init__(self, cfg: LegacyConfig):
        super().__init__()
        self.cfg = cfg
        self.encoder = RelEncoder(cfg)
        self.latent = nn.Linear(cfg.hidden, cfg.hidden)     # Decoder.py:224
        self._build_decoder(cfg)

    def encode(self, tokens, obj_ids, segments, token_types, pad_mask):
        return self.latent(self.encoder(tokens, obj_ids, segments, token_types, pad_mask)[0])

    def forward(self, tokens, obj_ids, segments, token_types, pad_mask, cls_tok, pos_tok,
                shape_tok):
        """Teacher-forced training forward (`Model.py:954-959`)."""
        memory = self.encode(tokens, obj_ids, segments, token_types, pad_mask)
        return self.decode(cls_tok, pos_tok, shape_tok, memory, pad_mask)


class Rel2RegLayout(nn.Module):
    """Regression variant: cls tokens + continuous sigmoid boxes."""

    def __init__(self, cfg: LegacyConfig):
        super().__init__()
        c = self.cfg = cfg
        self.encoder = RelEncoder(c)
        self.cls_embed = nn.Embedding(c.cls_size, c.hidden)
        self.box_proj = nn.Linear(4, c.hidden)
        self.merge = nn.Linear(2 * c.hidden, c.hidden)
        self.decoder = _Decoder(c)
        self.cls_head = nn.Linear(c.hidden, c.cls_size)
        self.box_head = nn.Linear(c.hidden, 4)

    def encode(self, tokens, obj_ids, segments, token_types, pad_mask):
        return self.encoder(tokens, obj_ids, segments, token_types, pad_mask)[0]

    def decode(self, cls_tok, boxes, memory, src_pad_mask):
        trg = self.merge(torch.cat([self.cls_embed(cls_tok.long()), self.box_proj(boxes)], -1))
        h = self.decoder(trg, memory, src_pad_mask)
        return self.cls_head(h), torch.sigmoid(self.box_head(h))

    def forward(self, tokens, obj_ids, segments, token_types, pad_mask, cls_tok, boxes):
        memory = self.encode(tokens, obj_ids, segments, token_types, pad_mask)
        return self.decode(cls_tok, boxes, memory, pad_mask)


class Text2Layout(_DiscreteHeads):
    """Caption -> discrete layout (reference `Model.py:817-935`): the
    pre-LN text transformer (`models/encoders.TransformerEmbedder`) over
    host-tokenized ids feeding the discrete AR decoder."""

    def __init__(self, cfg: LegacyConfig, max_seq_len: int = 64):
        super().__init__()
        self.cfg = cfg
        self.text_encoder = TransformerEmbedder(vocab_size=cfg.vocab_size,
                                                max_seq_len=max_seq_len, n_embed=cfg.hidden,
                                                n_layer=cfg.layers, heads=cfg.heads)
        self._build_decoder(cfg)

    def encode(self, tokens, obj_ids=None, segments=None, token_types=None, pad_mask=None):
        return self.text_encoder(tokens)       # extra operands ignored, as in JAX

    def forward(self, tokens, pad_mask, cls_tok, pos_tok, shape_tok):
        return self.decode(cls_tok, pos_tok, shape_tok, self.text_encoder(tokens), pad_mask)


def _inputs(model: nn.Module, tokens, obj_ids, segments, token_types, pad_mask):
    dev = next(model.parameters()).device
    return (_as_long(tokens, dev), _as_long(obj_ids, dev), _as_long(segments, dev),
            _as_long(token_types, dev), torch.as_tensor(pad_mask, device=dev).bool())


@torch.no_grad()
def greedy_decode(model, tokens, obj_ids, segments, token_types, pad_mask,
                  max_len: Optional[int] = None):
    """Greedy AR decode (`Inference.py:8-83`): (cls, pos, shape) [B, T] and
    the validity mask that ends at the first EOS cls token (included)."""
    args = _inputs(model, tokens, obj_ids, segments, token_types, pad_mask)
    T = max_len or model.cfg.max_out_len
    B = args[0].shape[0]
    memory = model.encode(*args)
    bufs = [torch.full((B, T + 1), BOS, dtype=torch.long, device=memory.device)
            for _ in range(3)]
    outs = []
    for t in range(T):
        logits = model.decode(*bufs, memory, args[4])
        step = [lg[:, t].argmax(-1) for lg in logits]
        for buf, s in zip(bufs, step):
            buf[:, t + 1] = s
        outs.append(step)
    cls_o, pos_o, shp_o = (torch.stack([o[j] for o in outs], 1) for j in range(3))
    eos = (cls_o == EOS).long()
    valid = (torch.cumsum(eos, 1) - eos) == 0
    return cls_o, pos_o, shp_o, valid


def _top_k(x: torch.Tensor, k: int):
    """`lax.top_k` over the last axis: the k largest, ties to the lower index."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


@torch.no_grad()
def beam_decode(model, tokens, obj_ids, segments, token_types, pad_mask, beam: int = 4,
                max_len: Optional[int] = None) -> Tuple[torch.Tensor, ...]:
    """Beam search over cls log-probs, greedy pos / shape per hypothesis
    (`Inference.py:84-301`): (cls, pos, shape) [B, K, T] and scores [B, K]."""
    args = _inputs(model, tokens, obj_ids, segments, token_types, pad_mask)
    T = max_len or model.cfg.max_out_len
    B, K = args[0].shape[0], beam
    memory = model.encode(*args)
    memory_k = torch.repeat_interleave(memory, K, dim=0)
    pad_k = torch.repeat_interleave(args[4], K, dim=0)
    dev = memory.device
    cls_t, pos_t, shp_t = (torch.full((B, K, T + 1), BOS, dtype=torch.long, device=dev)
                           for _ in range(3))
    scores = torch.tensor([0.0] + [-1e9] * (K - 1), device=dev)[None].repeat(B, 1)
    done = torch.zeros(B, K, dtype=torch.bool, device=dev)
    for t in range(T):
        lc, lp, ls = model.decode(cls_t.reshape(B * K, T + 1), pos_t.reshape(B * K, T + 1),
                                  shp_t.reshape(B * K, T + 1), memory_k, pad_k)
        logp = torch.log_softmax(lc[:, t].float().reshape(B, K, -1), -1)
        frozen = torch.full_like(logp, -1e9)
        frozen[..., EOS] = 0.0
        logp = torch.where(done[..., None], frozen, logp)
        cand = scores[..., None] + logp
        V = cand.shape[-1]
        top, flat_idx = _top_k(cand.reshape(B, K * V), K)
        src = torch.div(flat_idx, V, rounding_mode="floor")
        tok = flat_idx % V

        def gather(a):
            return torch.gather(a, 1, src[..., None].expand(-1, -1, a.shape[-1]))
        cls_t, pos_t, shp_t = gather(cls_t), gather(pos_t), gather(shp_t)
        done = torch.gather(done, 1, src)
        pos_best = torch.gather(lp[:, t].reshape(B, K, -1).argmax(-1), 1, src)
        shp_best = torch.gather(ls[:, t].reshape(B, K, -1).argmax(-1), 1, src)
        cls_t[:, :, t + 1] = tok
        pos_t[:, :, t + 1] = pos_best
        shp_t[:, :, t + 1] = shp_best
        done = done | (tok == EOS)
        scores = top
    return cls_t[:, :, 1:], pos_t[:, :, 1:], shp_t[:, :, 1:], scores


@torch.no_grad()
def greedy_decode_reg(model: Rel2RegLayout, tokens, obj_ids, segments, token_types, pad_mask,
                      max_len: Optional[int] = None):
    """Greedy decode of the regression variant (`Inference_Reg.py:8-`): the
    argmax cls token and the predicted box fed back each step; (cls [B, T],
    boxes [B, T, 4])."""
    args = _inputs(model, tokens, obj_ids, segments, token_types, pad_mask)
    T = max_len or model.cfg.max_out_len
    B = args[0].shape[0]
    memory = model.encode(*args)
    cls_t = torch.full((B, T + 1), BOS, dtype=torch.long, device=memory.device)
    box_t = torch.zeros(B, T + 1, 4, device=memory.device)
    cls_o, box_o = [], []
    for t in range(T):
        lc, boxes = model.decode(cls_t, box_t, memory, args[4])
        nc, nb = lc[:, t].argmax(-1), boxes[:, t]
        cls_t[:, t + 1] = nc
        box_t[:, t + 1] = nb
        cls_o.append(nc)
        box_o.append(nb)
    return torch.stack(cls_o, 1), torch.stack(box_o, 1)
