"""Tokenizers for the two text stacks; port of the JAX package's
`utils/tokenizer.py`.

* `CLIPTokenizer`: OpenAI CLIP's BPE from `bpe_simple_vocab_16e6.txt.gz`
  (the reference's `clip.tokenize`, and the SD text encoder's ids);
* `GPT2Tokenizer`: RoBERTa's byte-level BPE from `vocab.json` and
  `merges.txt` (fairseq `roberta.encode`), optionally mapped into a fairseq
  dictionary's index space; `utils/native_bpe.NativeBPE` runs the same merge
  loop in C++ (`native/bpe.cpp`);
* `HashTokenizer`: one token per word, ids from a SHA-1 of the lower-cased
  word, for runs without vocab files; the port and the JAX package give
  the same ids for the same text.

Every tokenizer has `core` ("python", "native" or "hash"), `encode(text)`
and `pad_to(ids, length)`; the RoBERTa ones also
`encode_with_alignment(words) -> (ids, first token of each word)`.  A vocab
path that does not exist raises `FileNotFoundError` (the JAX package falls
back to the hash tokenizer there).
"""
from __future__ import annotations

import gzip
import hashlib
import json
import os
import re
from typing import Dict, List, Optional, Sequence, Tuple


def _hash_id(word: str, lo: int, hi: int) -> int:
    h = int.from_bytes(hashlib.sha1(word.encode()).digest()[:4], "little")
    return lo + (h % (hi - lo))


class HashTokenizer:
    """Deterministic 1-token-per-word tokenizer."""

    core = "hash"

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


def _bytes_to_unicode() -> Dict[int, str]:
    """GPT-2's byte -> unicode table."""
    bs = (list(range(ord("!"), ord("~") + 1)) + list(range(ord("¡"), ord("¬") + 1))
          + list(range(ord("®"), ord("ÿ") + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


def _merge(word: List[str], ranks: Dict[Tuple[str, str], int]) -> List[str]:
    """Apply the lowest-ranked adjacent merge, leftmost first, until none
    applies."""
    while len(word) > 1:
        pairs = {(word[i], word[i + 1]) for i in range(len(word) - 1)}
        best = min(pairs, key=lambda p: ranks.get(p, 1 << 30))
        if best not in ranks:
            break
        a, b = best
        out, i = [], 0
        while i < len(word):
            if i < len(word) - 1 and word[i] == a and word[i + 1] == b:
                out.append(a + b)
                i += 2
            else:
                out.append(word[i])
                i += 1
        word = out
    return word


class _BPE:
    """The merge loop over a rank table, with a cache per token."""

    def __init__(self, merges: List[Tuple[str, str]]):
        self.ranks = {m: i for i, m in enumerate(merges)}
        self.cache: Dict[str, List[str]] = {}

    def __call__(self, token: str) -> List[str]:
        if token not in self.cache:
            self.cache[token] = _merge(list(token), self.ranks)
        return self.cache[token]


def _need(path: str, what: str) -> str:
    if not os.path.isfile(path):
        raise FileNotFoundError(f"no {what} file {path}")
    return path


def read_gpt2_files(vocab_path: str, merges_path: str, id_map=None):
    """(vocab {token: id}, merges [(a, b)]) from RoBERTa's vocab.json and
    merges.txt; `id_map` {gpt2_id: target_id} maps every id (missing -> 3,
    fairseq's <unk>)."""
    with open(_need(vocab_path, "BPE vocab")) as f:
        vocab = json.load(f)
    if id_map is not None:
        vocab = {t: id_map.get(i, 3) for t, i in vocab.items()}
    with open(_need(merges_path, "BPE merges")) as f:
        lines = f.read().split("\n")
    merges = [tuple(ln.split()) for ln in lines if ln and not ln.startswith("#")]
    return vocab, [m for m in merges if len(m) == 2]


class _RobertaIds:
    """encode / alignment / padding over `_raw(text) -> content ids`, with
    the fairseq specials <s>=0, </s>=2, <pad>=1."""

    bos, eos, pad = 0, 2, 1

    def encode(self, text: str) -> List[int]:
        return [self.bos] + self._raw(text) + [self.eos]

    def encode_with_alignment(self, words: Sequence[str]) -> Tuple[List[int], List[int]]:
        ids, align = [self.bos], []
        for i, w in enumerate(words):
            align.append(len(ids))
            ids.extend(self._raw(w if i == 0 else " " + w))
        ids.append(self.eos)
        return ids, align

    def pad_to(self, ids: List[int], length: int) -> List[int]:
        return (ids + [self.pad] * max(0, length - len(ids)))[:length]


class GPT2Tokenizer(_RobertaIds):
    """Byte-level BPE (RoBERTa / GPT-2) from vocab.json + merges.txt."""

    core = "python"
    PAT = re.compile(r"'s|'t|'re|'ve|'m|'ll|'d| ?\w+| ?[^\w\s]+|\s+(?!\S)|\s+",
                     re.IGNORECASE)

    def __init__(self, vocab_path: str, merges_path: str, id_map=None):
        """id_map: {gpt2_id: target_id} for content tokens, the fairseq
        dictionary bridge (`convert.load_fairseq_dictionary`)."""
        self.vocab, merges = read_gpt2_files(vocab_path, merges_path, id_map)
        self.bpe = _BPE(merges)
        self.byte_enc = _bytes_to_unicode()

    def _raw(self, text: str) -> List[int]:
        ids = []
        for tok in self.PAT.findall(text):
            tok = "".join(self.byte_enc[b] for b in tok.encode("utf-8"))
            ids.extend(self.vocab[t] for t in self.bpe(tok))
        return ids


class CLIPTokenizer:
    """OpenAI CLIP's BPE from bpe_simple_vocab_16e6.txt(.gz): the 256 byte
    symbols, the same with "</w>", one entry per merge in rank order, then
    <|startoftext|> and <|endoftext|> (49406, 49407 with the real table)."""

    core = "python"
    PAT = re.compile(r"<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|[\w]+|[^\s\w]+",
                     re.IGNORECASE)

    def __init__(self, bpe_path: str, max_len: int = 77):
        opener = gzip.open if bpe_path.endswith(".gz") else open
        with opener(_need(bpe_path, "CLIP BPE vocab"), "rt", encoding="utf-8") as f:
            merges = f.read().split("\n")[1:49152 - 256 - 2 + 1]
        merges = [tuple(m.split()) for m in merges]
        vocab = list(_bytes_to_unicode().values())
        vocab = vocab + [v + "</w>" for v in vocab]
        vocab += ["".join(m) for m in merges] + ["<|startoftext|>", "<|endoftext|>"]
        self.encoder = {v: i for i, v in enumerate(vocab)}
        self.bpe_ranks = {m: i for i, m in enumerate(merges)}
        self.byte_enc = _bytes_to_unicode()
        self.max_len = max_len
        self.sot = self.encoder["<|startoftext|>"]
        self.eot = self.encoder["<|endoftext|>"]
        self.cache: Dict[str, List[str]] = {}

    def _bpe(self, token: str) -> List[str]:
        if token not in self.cache:
            self.cache[token] = _merge(list(token[:-1]) + [token[-1] + "</w>"], self.bpe_ranks)
        return self.cache[token]

    def encode(self, text: str) -> List[int]:
        """sot, the BPE ids of the cleaned, lower-cased text, eot."""
        ids = [self.sot]
        for tok in self.PAT.findall(re.sub(r"\s+", " ", text.strip()).lower()):
            tok = "".join(self.byte_enc[b] for b in tok.encode("utf-8"))
            ids.extend(self.encoder[t] for t in self._bpe(tok))
        return ids + [self.eot]

    def pad_to(self, ids: List[int], length: int) -> List[int]:
        """Cut to `length` keeping eot last, then pad with 0 (`clip.tokenize`)."""
        ids = ids[:length]
        if ids[-1] != self.eot:
            ids[-1] = self.eot
        return ids + [0] * (length - len(ids))

    def tokenize(self, text: str) -> List[int]:
        """`max_len` ids: the JAX package's `CLIPTokenizer.tokenize`."""
        return self.pad_to(self.encode(text), self.max_len)


def padded(tok, length: int):
    """text -> `length` ids through `tok.encode` and `tok.pad_to`."""
    return lambda text: tok.pad_to(tok.encode(text), length)


def make_clip_tokenizer(vocab_path: Optional[str] = None, max_len: int = 77):
    """CLIP's BPE from `vocab_path`, else a HashTokenizer with CLIP's vocab
    size and special ids (sot 49406, eot 49407, pad 0)."""
    if vocab_path:
        return CLIPTokenizer(vocab_path, max_len)
    return HashTokenizer(vocab_size=49406, bos=49406, eos=49407, pad=0,
                         reserved=1000, max_len=max_len)


def make_roberta_tokenizer(vocab_path: Optional[str] = None,
                           merges_path: Optional[str] = None, prefer_native: bool = True,
                           fairseq_dict_path: Optional[str] = None):
    """RoBERTa's BPE from vocab.json + merges.txt (the C++ core when
    `prefer_native` and it builds, else Python; `core` says which), else a
    HashTokenizer with RoBERTa's special ids (bos 0, eos 2, pad 1).

    fairseq_dict_path: the reference's `configs/test-dictionary.pkl`; content
    ids then come in that dictionary's index space, as `roberta.encode`
    gives them, to match the reference layout checkpoint's embedding table."""
    if not (vocab_path or merges_path):
        return HashTokenizer(vocab_size=50265, bos=0, eos=2, pad=1, reserved=10)
    if not (vocab_path and merges_path):
        raise ValueError("the RoBERTa BPE needs both vocab.json and merges.txt")
    id_map = None
    if fairseq_dict_path:
        from .convert import load_fairseq_dictionary

        id_map = load_fairseq_dictionary(fairseq_dict_path)
    if prefer_native:
        from .native_bpe import NativeBPE, NativeBuildError

        try:
            return NativeBPE.from_files(vocab_path, merges_path, id_map=id_map)
        except NativeBuildError:
            pass
    return GPT2Tokenizer(vocab_path, merges_path, id_map=id_map)
