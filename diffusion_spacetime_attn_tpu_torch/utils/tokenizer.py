"""Vocab-file-free tokenizer, a copy of the JAX package's `HashTokenizer` and
of the no-vocab branches of its `make_clip_tokenizer` and
`make_roberta_tokenizer`.

One token per word, ids from a SHA-1 of the lower-cased word, so the port
and the JAX package give the same ids for the same text.
"""
from __future__ import annotations

import hashlib
import re
from typing import List, Optional, Sequence, Tuple


def _hash_id(word: str, lo: int, hi: int) -> int:
    h = int.from_bytes(hashlib.sha1(word.encode()).digest()[:4], "little")
    return lo + (h % (hi - lo))


class HashTokenizer:
    """Deterministic 1-token-per-word tokenizer."""

    def __init__(self, vocab_size: int, bos: Optional[int] = 0, eos: Optional[int] = 2,
                 pad: int = 1, reserved: int = 10, max_len: int = 77):
        self.vocab_size = vocab_size
        self.bos, self.eos, self.pad = bos, eos, pad
        self.lo = reserved
        self.max_len = max_len

    def _word_ids(self, words: Sequence[str]) -> List[int]:
        return [_hash_id(w.strip().lower(), self.lo, self.vocab_size) for w in words]

    def encode(self, text: str) -> List[int]:
        ids = self._word_ids(re.findall(r"\w+|[^\w\s]", text))
        if self.bos is not None:
            ids = [self.bos] + ids
        if self.eos is not None:
            ids = ids + [self.eos]
        return ids[: self.max_len]

    def encode_with_alignment(self, words: Sequence[str]) -> Tuple[List[int], List[int]]:
        ids = [self.bos] if self.bos is not None else []
        align = []
        for w in words:
            align.append(len(ids))
            ids.append(self._word_ids([w])[0])
        if self.eos is not None:
            ids.append(self.eos)
        return ids[: self.max_len], align

    def pad_to(self, ids: List[int], length: int) -> List[int]:
        return (ids + [self.pad] * max(0, length - len(ids)))[:length]


def make_clip_tokenizer(max_len: int = 77) -> HashTokenizer:
    """HashTokenizer with CLIP's vocab size and special ids (sot 49406,
    eot 49407, pad 0).  The BPE tokenizer needs a vocab file the port does
    not load yet."""
    return HashTokenizer(vocab_size=49406, bos=49406, eos=49407, pad=0,
                         reserved=1000, max_len=max_len)


def make_roberta_tokenizer(vocab_path: Optional[str] = None,
                           merges_path: Optional[str] = None) -> HashTokenizer:
    """HashTokenizer with RoBERTa's vocab size and special ids (bos 0, eos 2,
    pad 1), the no-vocab branch of the JAX package's `make_roberta_tokenizer`.
    The byte-level BPE (and its native core) needs vocab files the port
    does not read yet (ROADMAP A.11), so vocab paths raise."""
    if vocab_path or merges_path:
        raise NotImplementedError(
            "the RoBERTa BPE vocabulary (vocab.json / merges.txt) is not read by the "
            "PyTorch port yet (ROADMAP A.11); omit the paths for the hash tokenizer")
    return HashTokenizer(vocab_size=50265, bos=0, eos=2, pad=1, reserved=10)
