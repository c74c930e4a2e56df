"""PyTorch port, the BPE tokenizers held against the JAX package on the CPU:
OpenAI CLIP's BPE (`CLIPTokenizer`), RoBERTa's byte-level BPE
(`GPT2Tokenizer`, with and without the fairseq dictionary's `id_map`), the
C++ core (`utils/native_bpe.py`, compiled here with g++ into the package's
`_build/`) and `make_roberta_tokenizer` / `make_clip_tokenizer`.

The vocab files are synthetic, built as the JAX package's own tokenizer
tests build them: CLIP's table padded with never-occurring merges to its
real size (so merge ids sit at 512 + rank and the specials at 49406/49407),
RoBERTa's byte symbols plus a few merges.  Ids and alignments must be equal.
"""
import json
import pickle
import sys
import types

import pytest
import torch

from diffusion_spacetime_attn_tpu.utils import convert as jconvert
from diffusion_spacetime_attn_tpu.utils import tokenizer as jtok
from diffusion_spacetime_attn_tpu_torch.utils import native_bpe
from diffusion_spacetime_attn_tpu_torch.utils import tokenizer as ttok

N_CLIP_MERGES = 49152 - 256 - 2
CLIP_MERGES = [("a", "t</w>"), ("c", "at</w>"), ("c", "a"), ("d", "o"), ("do", "g</w>"),
               ("t", "h"), ("th", "e</w>"), ("o", "n</w>"), ("l", "e"), ("t", "a"),
               ("b", "le</w>")]
GPT2_MERGES = [("t", "h"), ("th", "e"), ("Ġ", "c"), ("Ġc", "a"), ("Ġca", "t"), ("a", "n"),
               ("Ġ", "d"), ("Ġd", "o"), ("Ġdo", "g"), ("o", "g"), ("Ġ", "t"), ("Ġt", "he"),
               ("o", "n"), ("Ġ", "a")]
SENTENCES = [
    "a cat on the table",
    "The silver bed was situated to the right of the white couch.",
    "a, b; c! 'll don't 123 mixed42words",
    "multiple   spaces\tand\nnewlines",
    "A dog sat on the cat's table.",
    "",
]


@pytest.fixture(scope="module", autouse=True)
def torch_one_thread():
    """The test workers share the CPU cores; this module's torch work is
    small, so it takes one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def write_clip_vocab(path, merges=CLIP_MERGES):
    """A CLIP-format BPE file (a header line, then one merge per line) padded
    to the real table size with CJK pairs that never occur."""
    syms = [chr(0x4E00 + i) for i in range(400)]
    lines = [f"{a} {b}" for a, b in merges]
    lines += [f"{syms[i // 400]} {syms[i % 400]}" for i in range(N_CLIP_MERGES - len(lines))]
    path.write_text("#version\n" + "\n".join(lines) + "\n")
    return str(path)


def write_gpt2_vocab(directory, merges=GPT2_MERGES):
    """RoBERTa-format vocab.json (the byte symbols, then one id per merge)
    and merges.txt."""
    vocab = {u: i for i, u in enumerate(jtok._bytes_to_unicode().values())}
    for a, b in merges:
        vocab.setdefault(a + b, len(vocab))
    vp, mp = directory / "vocab.json", directory / "merges.txt"
    vp.write_text(json.dumps(vocab))
    mp.write_text("#version: 0.2\n" + "\n".join(f"{a} {b}" for a, b in merges))
    return str(vp), str(mp)


def write_fairseq_dictionary(path, n_symbols: int = 300):
    """A pickled fairseq `Dictionary` of a module that is not installed:
    the 4 specials, then GPT-2 ids as strings in a shuffled order and one
    non-numeric symbol."""
    mod = types.ModuleType("fairseq_stub_data")
    Dictionary = type("Dictionary", (), {"__module__": "fairseq_stub_data"})
    mod.Dictionary = Dictionary
    sys.modules["fairseq_stub_data"] = mod
    try:
        d = Dictionary()
        ids = [(i * 37) % n_symbols for i in range(n_symbols)]
        d.symbols = ["<s>", "<pad>", "</s>", "<unk>"] + [str(i) for i in ids] + ["madeupword0"]
        d.count = [1] * len(d.symbols)
        path.write_bytes(pickle.dumps(d))
    finally:
        del sys.modules["fairseq_stub_data"]
    return str(path)


def test_clip_tokenizer_matches_jax(tmp_path):
    path = write_clip_vocab(tmp_path / "bpe.txt")
    j, t = jtok.CLIPTokenizer(path, max_len=12), ttok.CLIPTokenizer(path, max_len=12)
    assert (t.sot, t.eot) == (j.sot, j.eot) == (49406, 49407)
    assert t.encoder == j.encoder
    for s in SENTENCES + ["a cat " * 20]:
        assert t.tokenize(s) == j.tokenize(s), s
        assert ttok.padded(t, 12)(s) == j.tokenize(s), s
    # the constructed ids: 'a' 320, merge rank r at 512 + r
    assert t.tokenize("a cat")[:4] == [49406, 320, 512 + 1, 49407]
    gz = tmp_path / "bpe.txt.gz"
    import gzip
    with gzip.open(gz, "wt", encoding="utf-8") as f:
        f.write((tmp_path / "bpe.txt").read_text())
    assert ttok.make_clip_tokenizer(str(gz), max_len=12).tokenize("the dog") == \
        jtok.make_clip_tokenizer(str(gz), max_len=12).tokenize("the dog")
    assert ttok.make_clip_tokenizer(str(gz)).core == "python"


@pytest.mark.parametrize("with_id_map", [False, True])
def test_gpt2_tokenizer_matches_jax(tmp_path, with_id_map):
    vp, mp = write_gpt2_vocab(tmp_path)
    id_map = None
    if with_id_map:
        id_map = jconvert.load_fairseq_dictionary(write_fairseq_dictionary(tmp_path / "d.pkl"))
    j = jtok.GPT2Tokenizer(vp, mp, id_map=id_map)
    t = ttok.GPT2Tokenizer(vp, mp, id_map=id_map)
    for s in SENTENCES:
        assert t.encode(s) == j.encode(s), s
        words = s.split()
        assert t.encode_with_alignment(words) == j.encode_with_alignment(words), s
        assert t.pad_to(t.encode(s), 24) == j.pad_to(j.encode(s), 24)
    if with_id_map:     # content ids in the dictionary's space, <unk> where it has none
        ids = t.encode("the cat")
        assert ids[0] == 0 and ids[-1] == 2 and set(ids[1:-1]) <= set(id_map.values()) | {3}


@pytest.mark.parametrize("with_id_map", [False, True])
def test_native_core_matches_jax(tmp_path, with_id_map):
    """The C++ core, built by the port into its `_build/`, gives the JAX
    package's Python ids and alignments."""
    vp, mp = write_gpt2_vocab(tmp_path)
    dict_path = write_fairseq_dictionary(tmp_path / "d.pkl") if with_id_map else None
    id_map = jconvert.load_fairseq_dictionary(dict_path) if dict_path else None
    j = jtok.GPT2Tokenizer(vp, mp, id_map=id_map)
    t = ttok.make_roberta_tokenizer(vp, mp, fairseq_dict_path=dict_path)
    assert t.core == "native" and isinstance(t, native_bpe.NativeBPE)
    assert str(native_bpe.build()).startswith(str(native_bpe.BUILD_DIR))
    for s in SENTENCES[:-1] + ["a cat " * 200]:
        assert t.encode(s) == j.encode(s), s[:40]
        words = s.split()
        assert t.encode_with_alignment(words) == j.encode_with_alignment(words)
    python = ttok.make_roberta_tokenizer(vp, mp, prefer_native=False, fairseq_dict_path=dict_path)
    assert python.core == "python" and python.encode(SENTENCES[1]) == t.encode(SENTENCES[1])


def test_native_build_failure_falls_back_to_python(tmp_path, monkeypatch):
    """A core that cannot be built gives the Python tokenizer, and says so."""
    vp, mp = write_gpt2_vocab(tmp_path)
    monkeypatch.setattr(native_bpe, "SOURCE", tmp_path / "missing.cpp")
    monkeypatch.setattr(native_bpe, "_state", {})
    tok = ttok.make_roberta_tokenizer(vp, mp)
    assert tok.core == "python"
    with pytest.raises(native_bpe.NativeBuildError):
        native_bpe.load_library()


def test_fairseq_dictionary_matches_jax(tmp_path):
    path = write_fairseq_dictionary(tmp_path / "dict.pkl")
    from diffusion_spacetime_attn_tpu_torch.utils import convert as tconvert

    got = tconvert.load_fairseq_dictionary(path)
    assert got == jconvert.load_fairseq_dictionary(path)
    assert got[0] == 4 and len(got) == 300 and min(got.values()) == 4


def test_missing_vocab_files_raise_naming_them(tmp_path):
    """The JAX package falls back to the hash tokenizer for a path that does
    not exist; the port raises, naming it."""
    missing = str(tmp_path / "nope.txt")
    with pytest.raises(FileNotFoundError, match="nope.txt"):
        ttok.make_clip_tokenizer(missing)
    vp, mp = write_gpt2_vocab(tmp_path)
    for args in ((missing, mp), (vp, missing)):
        with pytest.raises(FileNotFoundError, match="nope.txt"):
            ttok.make_roberta_tokenizer(*args)
    with pytest.raises(ValueError, match="both"):
        ttok.make_roberta_tokenizer(vp, None)
    assert ttok.make_roberta_tokenizer().core == ttok.make_clip_tokenizer().core == "hash"
