"""Legacy scene-graph pretraining data (the VGDataset / RelDataset family);
port of the JAX package's `training/legacy_data.py` (reference
`loader/VGDataset.py`).

Pickle-backed relation sentences in the legacy closed vocabulary (`{'rel':
[L]-token sentences, 'id': per-token object ids, 'rel_box': per-token [xc,
yc, w, h]}`) served through the BERT-style masked-LM sampler (`random_word`,
`VGDataset.py:63-103`): each non-pad token is masked with p = 0.15 (replaced
by MASK = 3 with p = 0.8 within that), its id becoming the label and its
box the box label; unmasked positions carry label 0 and box [2, 2, 2, 2];
segment ids increment at every SEP = 2; token_type is i % 4 over non-pad
positions.  Numpy on the host, the same draws from the same
`random.Random` as JAX.
"""
from __future__ import annotations

import pickle
import random
from typing import Optional

import numpy as np

PAD, CLS, SEP, MASK = 0, 1, 2, 3


def load_legacy_rel_pickle(path: str):
    """`RelDataset.__init__` (`VGDataset.py:34-43`)."""
    with open(path, "rb") as f:
        d = pickle.load(f)
    return d["rel"], d["id"], d["rel_box"]


def mask_relation_sentence(
    sentence: np.ndarray,            # [L] int token ids (legacy closed vocab)
    obj_id: np.ndarray,              # [L] int object ids
    box_xy: np.ndarray,              # [L, 4] float boxes
    rng: Optional[random.Random] = None,
):
    """`VGDataset.random_word` exactly: returns (input_tokens, input_obj_id,
    output_label, segment_label, token_type, output_box_label)."""
    rng = rng or random.Random()
    sent = np.array(sentence, np.int64).copy()
    labels = np.zeros_like(sent)
    box_labels = np.full((len(sent), 4), 2.0, np.float32)
    segment = np.zeros_like(sent)
    token_type = np.zeros_like(sent)
    seg_idx = 1
    for i in range(len(sent)):
        prob = rng.random()
        if prob < 0.15 and sent[i] > 0:
            labels[i] = sent[i]
            box_labels[i] = box_xy[i]
            if prob / 0.15 < 0.8:
                sent[i] = MASK
        if sent[i] > 0:
            segment[i] = seg_idx
            token_type[i] = i % 4
            if sent[i] == SEP:
                seg_idx += 1
    return sent, np.array(obj_id, np.int64), labels, segment, token_type, box_labels


def legacy_pretrain_batches(
    sentences, obj_ids, boxes, batch_size: int, seed: int = 0, epochs: int = 1
):
    """Shuffled fixed-shape batches of masked examples (replaces the torch
    DataLoader + collate of `loader/build_loader.py` for this family)."""
    rng = random.Random(seed)
    n = len(sentences)
    for _ in range(epochs):
        order = list(range(n))
        rng.shuffle(order)
        for s in range(0, n - batch_size + 1, batch_size):
            rows = [
                mask_relation_sentence(sentences[j], obj_ids[j], boxes[j], rng)
                for j in order[s: s + batch_size]
            ]
            yield tuple(np.stack([r[k] for r in rows]) for k in range(6))
