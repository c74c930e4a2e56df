"""PyTorch port, the layout slice held against the JAX package on the CPU: the
LayoutPredictor (RoBERTa backbone + object embedding + GMM head) with JAX's
weights through `utils/weights.layout_state_dict`, the GMM functions, the
text front end (object and relation extraction, local prompts),
`LayoutInference` (greedy and relation-aware decode), the tokenizer, the
checkpoint loader and the `layout_infer` entry point.

Small config: LayoutConfig(hidden=32, layers=2, heads=2, ffn_dim=64,
max_positions=140, max_len=24) with flax's own init.  Tolerances: features
and raw GMM outputs within 1e-5 + 1e-5·|ref| (float32, the same products in
another order); centers within 1e-5; decoded components exactly equal when
both decodes are fed JAX's raw outputs.
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusion_spacetime_attn_tpu.config import LayoutConfig as JLayoutConfig
from diffusion_spacetime_attn_tpu.models.layout import gmm_head as jgmm
from diffusion_spacetime_attn_tpu.models.layout.model import (
    create_layout_predictor as jcreate,
)
from diffusion_spacetime_attn_tpu.pipeline import frontend as jfe
from diffusion_spacetime_attn_tpu.utils import loader as jloader
from diffusion_spacetime_attn_tpu.utils.tokenizer import (
    make_roberta_tokenizer as jmake_roberta_tokenizer,
)
from diffusion_spacetime_attn_tpu_torch.config import LayoutConfig
from diffusion_spacetime_attn_tpu_torch.models.layout import gmm_head
from diffusion_spacetime_attn_tpu_torch.models.layout.model import (
    LayoutPredictor,
    create_layout_predictor,
)
from diffusion_spacetime_attn_tpu_torch.pipeline import frontend as fe
from diffusion_spacetime_attn_tpu_torch.scripts import layout_infer
from diffusion_spacetime_attn_tpu_torch.utils import loader
from diffusion_spacetime_attn_tpu_torch.utils.tokenizer import make_roberta_tokenizer
from diffusion_spacetime_attn_tpu_torch.utils.weights import layout_state_dict

SMALL = dict(hidden=32, layers=2, heads=2, ffn_dim=64, max_positions=140, max_len=24)

# every sentence the JAX front-end tests use (tests/test_frontend_eval.py,
# tests/test_batch_runner.py), the README golden sentence, and a few more
SENTENCES = [
    "The silver bed was situated to the right of the white couch.",
    "A wine glass next to two dogs near a traffic light.",
    "The red television sat beside a sofa and a bike.",
    "The cat is above the dog.",
    "The bowl was placed underneath the toilet.",
    "The book was placed on the bed.",
    "The person was lying on the ground, with the black bowl nearby.",
    "The giraffe stood tall, with the horse grazing to its right.",
    "The bird flew away from the elephant to its left.",
    "The person stood there, with the bowl positioned to their left.",
    "The bowl was placed on the counter, with the knife resting above it.",
    "The handbag is right of the suitcase, with a red umbrella placed to the left of it.",
    "The person sat at the desk, with the red mouse at their feet.",
    "The cat is positioned beneath both the dog and the horse.",
    "A blue boat was parked between a car to its right and a bicycle to its left.",
    "The cup is left of the fork and the fork is left of the bowl.",
    "The person held the remote in their right hand.",
    "A cat and a dog.",
    "The cat is to the left of the dog.",
    "a dog to the left of a cat",
    "a car above a bench",
    "no objects here at all",
    "the bird sits on a chair",
    "a cup next to a laptop",
    "The clock hung over the bed, and the vase stood on the left side of the table.",
    "A person looked over their left shoulder at the horse.",
    "The dog was positioned lower, next to the cat.",
    "Two cats, a cat and the cat: the same category three times, left of a dog.",
    "",
]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The suite runs several test processes side by side on few cores,
    where torch's spinning intra-op threads slow each other down many-fold;
    this module's torch work is small, so it takes one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def models():
    """(JAX model, its params, the port's model with those weights)."""
    jcfg = JLayoutConfig(**SMALL)
    jmodel, jparams = jcreate(jcfg, jax.random.PRNGKey(6))
    jparams = jax.tree_util.tree_map(np.asarray, jax.device_get(jparams))
    model = LayoutPredictor(LayoutConfig(**SMALL))
    model.load_state_dict(layout_state_dict(jparams, model), strict=True)
    return jmodel, jparams, model.eval().requires_grad_(False)


def close(got, want, atol=1e-5, rtol=1e-5, what=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    excess = np.abs(got - want) - (atol + rtol * np.abs(want))
    assert excess.max() <= 0, (what, float(np.abs(got - want).max()))


def _batch(seed=0, B=3, L=24, V=50265, pad=1):
    r = np.random.RandomState(seed)
    tokens = r.randint(3, V, size=(B, L)).astype(np.int32)
    lengths = [L, 15, 7]
    for b, n in enumerate(lengths[:B]):
        tokens[b, 0], tokens[b, n - 1] = 0, 2
        tokens[b, n:] = pad
    object_pos = np.zeros((B, L), np.float32)
    for b, n in enumerate(lengths[:B]):
        object_pos[b, r.choice(np.arange(1, n - 1), 2, replace=False)] = 1.0
    return tokens, object_pos


def test_state_dict_maps_every_flax_leaf(models):
    """Dense kernels are transposed, Embed tables and the object embedding
    are not; LayerNorm scale is the weight."""
    _, jp, model = models
    sd = model.state_dict()
    b = jp["backbone"]
    np.testing.assert_array_equal(sd["backbone.layer_1.attn.q.weight"].numpy(),
                                  b["layer_1"]["attn"]["q"]["kernel"].T)
    np.testing.assert_array_equal(sd["backbone.token_embedding.weight"].numpy(),
                                  b["token_embedding"]["embedding"])
    np.testing.assert_array_equal(sd["backbone.object_embedding"].numpy(), b["object_embedding"])
    np.testing.assert_array_equal(sd["backbone.emb_ln.weight"].numpy(), b["emb_ln"]["scale"])
    np.testing.assert_array_equal(sd["head.xy_bivariate.weight"].numpy(),
                                  jp["head"]["xy_bivariate"]["kernel"].T)
    assert float(np.abs(b["object_embedding"]).max()) > 0
    # a wrong shape or a missing leaf raises
    with pytest.raises(KeyError):
        layout_state_dict({"backbone": {k: v for k, v in b.items() if k != "object_embedding"},
                           "head": jp["head"]}, model)


@pytest.mark.parametrize("with_object_pos", [True, False])
def test_backbone_and_raw_gmm_match_jax(models, with_object_pos):
    jmodel, jp, model = models
    tokens, opos = _batch()
    op = opos if with_object_pos else None
    jfeat = jmodel.apply({"params": jp}, jnp.asarray(tokens), None if op is None else
                         jnp.asarray(op), method=lambda m, t, o: m.backbone(t, o))
    jraw = jmodel.apply({"params": jp}, jnp.asarray(tokens), None if op is None else
                        jnp.asarray(op))
    t = torch.from_numpy(tokens.astype(np.int64))
    o = None if op is None else torch.from_numpy(op)
    with torch.inference_mode():
        feat = model.backbone(t, o)
        raw = model(t, o)
        xy, raw2 = model.predict_xy(t, o, greedy_component=True)
    close(feat, jfeat, what="features")
    close(raw, jraw, what="raw")
    jxy, _ = jmodel.apply({"params": jp}, jnp.asarray(tokens), None if op is None else
                          jnp.asarray(op), method=type(jmodel).predict_xy)
    close(xy, jxy, what="xy")
    # padded positions carry no object embedding: zeroed before layer 0
    if with_object_pos:
        jfeat0 = jmodel.apply({"params": jp}, jnp.asarray(tokens), None,
                              method=lambda m, t, o: m.backbone(t, o))
        assert float(np.abs(np.asarray(jfeat) - np.asarray(jfeat0)).max()) > 1e-3


def test_gmm_functions_match_jax():
    r = np.random.RandomState(1)
    raw = r.randn(2, 7, 30).astype(np.float32)
    raw[0, 0, :5] = [0.5, 2.0, 2.0, -1.0, 2.0]     # a tie: the first maximum wins
    xy = r.rand(2, 7, 2).astype(np.float32)
    jp, tp = jgmm.split_gmm(jnp.asarray(raw)), gmm_head.split_gmm(torch.from_numpy(raw))
    for name in jgmm.GMMParams._fields:
        close(getattr(tp, name), getattr(jp, name), atol=1e-6, rtol=1e-6, what=name)
    close(gmm_head.gmm_log_likelihood(torch.from_numpy(raw), torch.from_numpy(xy)),
          jgmm.gmm_log_likelihood(jnp.asarray(raw), jnp.asarray(xy)), what="log likelihood")
    jxy = np.asarray(jgmm.sample_xy(jnp.asarray(raw), None, greedy_component=True))
    txy = gmm_head.sample_xy(torch.from_numpy(raw), greedy_component=True).numpy()
    np.testing.assert_array_equal(txy, jxy)
    assert txy[0, 0, 0] == raw[0, 0, 6]              # component 1 of the tie
    g = torch.Generator().manual_seed(0)
    drawn = gmm_head.sample_xy(torch.from_numpy(raw), g).numpy()
    assert drawn.shape == (2, 7, 2) and np.isin(drawn[..., 0], raw[..., 5:10]).all()


def _mentions(ms):
    return [(m.phrase, m.category, m.word_index) for m in ms]


@pytest.mark.parametrize("sentence", SENTENCES)
def test_front_end_matches_jax(sentence):
    jw, jm = jfe.extract_objects(sentence)
    tw, tm = fe.extract_objects(sentence)
    assert tw == jw and _mentions(tm) == _mentions(jm)
    assert fe.extract_relations(tw, tm) == jfe.extract_relations(jw, jm)
    assert [fe.local_context_prompt(m) for m in tm] == [jfe.local_context_prompt(m) for m in jm]
    assert [fe.local_loss_prompt(m) for m in tm] == [jfe.local_loss_prompt(m) for m in jm]
    for w in tw:
        assert fe.canonical_category(w) == jfe.canonical_category(w)


def test_tables_and_tokenizer_match_jax():
    assert fe.COCO_CATEGORIES == jfe.COCO_CATEGORIES
    assert fe.CATEGORY_ALIASES == jfe.CATEGORY_ALIASES
    assert fe._REL_CUES == jfe._REL_CUES
    jt, tt = jmake_roberta_tokenizer(), make_roberta_tokenizer()
    for s in SENTENCES:
        words = fe.simple_words(s)
        assert tt.encode(s) == jt.encode(s)
        assert tt.encode_with_alignment(words) == jt.encode_with_alignment(words)
        assert tt.pad_to(tt.encode(s), 24) == jt.pad_to(jt.encode(s), 24)

def test_bpe_tokenizer_from_vocab_files_matches_jax(tmp_path):
    """RoBERTa's BPE from vocab.json + merges.txt (until the loaders were
    ported the paths raised, naming ROADMAP A.11): the port's tokenizer
    gives the JAX package's ids and alignments; missing files raise naming
    them."""
    from test_torch_tokenizer import write_gpt2_vocab

    vp, mp = write_gpt2_vocab(tmp_path)
    jt, tt = jmake_roberta_tokenizer(vp, mp), make_roberta_tokenizer(vp, mp)
    assert tt.core == "native"
    for s in SENTENCES:
        words = fe.simple_words(s)
        assert tt.encode(s) == jt.encode(s)
        assert tt.encode_with_alignment(words) == jt.encode_with_alignment(words)
    with pytest.raises(FileNotFoundError, match="vocab.json"):
        make_roberta_tokenizer(str(tmp_path / "none" / "vocab.json"), mp)


@pytest.fixture(scope="module")
def inferences(models):
    jmodel, jp, model = models
    tok, jtok = make_roberta_tokenizer(), jmake_roberta_tokenizer()
    return {aware: (jfe.LayoutInference(jmodel, jp, jtok, relation_aware=aware),
                    fe.LayoutInference(model, tok, relation_aware=aware))
            for aware in (True, False)}


@pytest.mark.parametrize("aware", [True, False])
def test_layout_inference_matches_jax(inferences, aware):
    jinf, tinf = inferences[aware]
    assert tinf.max_len == jinf.max_len == SMALL["max_len"]
    n_rel = 0
    for s in SENTENCES:
        want, got = jinf(s), tinf(s)
        if want is None:
            assert got is None, s
            continue
        assert list(got) == list(want), s
        for k in want:
            np.testing.assert_allclose(got[k], want[k], atol=1e-5, rtol=0, err_msg=s)
        n_rel += bool(fe.extract_relations(*fe.extract_objects(s)))
    assert n_rel >= 10
    jmc, tmc = jinf.mentions_and_centers(SENTENCES[0]), tinf.mentions_and_centers(SENTENCES[0])
    assert _mentions(tmc[0]) == _mentions(jmc[0])
    np.testing.assert_allclose(tmc[1], jmc[1], atol=1e-5, rtol=0)


def test_relation_decode_picks_jax_components_from_jax_raw(inferences):
    """Both decodes fed JAX's raw GMM outputs choose the same components, so
    the centers are bit-equal (a 1e-7 difference in μ could flip a relation
    test and would hide behind a tolerance)."""
    jinf, tinf = inferences[True]
    checked = 0
    for s in SENTENCES:
        words, mentions = jfe.extract_objects(s)
        relations = jfe.extract_relations(words, mentions)
        if not mentions or not relations:
            continue
        ids, align = jinf.tokenizer.encode_with_alignment(words)
        tokens = np.asarray(jinf.tokenizer.pad_to(ids, jinf.max_len), np.int32)[None]
        opos = np.zeros((1, jinf.max_len), np.float32)
        tok_idx = [align[m.word_index] for m in mentions]
        if max(tok_idx) >= jinf.max_len:
            continue
        opos[0, tok_idx] = 1.0
        _, raw = jinf._jit_forward(jinf.params, jnp.asarray(tokens), jnp.asarray(opos))
        raw = np.asarray(raw)[0]
        want = jinf._relation_decode(mentions, tok_idx, raw, relations)
        got = tinf._relation_decode(fe.extract_objects(s)[1], tok_idx, raw.copy(), relations)
        assert got == want, s
        checked += 1
    assert checked >= 10


def test_loader_finds_and_refuses_as_specified(tmp_path, monkeypatch):
    monkeypatch.delenv("DSTA_LAYOUT_CKPT", raising=False)
    # saved/layout_gpt3 commits best.json and config.json without params
    assert loader.find_default_layout_checkpoint() == jloader.find_default_layout_checkpoint()
    assert loader.find_default_layout_checkpoint() is None
    monkeypatch.setenv("DSTA_LAYOUT_CKPT", str(tmp_path / "missing"))
    with pytest.raises(FileNotFoundError):
        loader.find_default_layout_checkpoint()
    run = tmp_path / "run"
    (run / "best_params").mkdir(parents=True)
    (run / "best.json").write_text(json.dumps({"params_path": "best_params"}))
    (run / "config.json").write_text(json.dumps(
        {"layout": dataclasses.asdict(LayoutConfig(**SMALL))}))
    monkeypatch.setenv("DSTA_LAYOUT_CKPT", str(run))
    assert loader.find_default_layout_checkpoint() == str(run)
    with pytest.raises(NotImplementedError, match="A.15") as err:   # orbax params
        loader.load_layout_predictor(LayoutConfig(), str(run), device="cpu")
    assert "2 layers, hidden 32" in str(err.value)        # the run's own config
    # torch and safetensors files are read (until the loaders were ported
    # they raised, naming ROADMAP A.11); a missing one raises naming it
    for path in ("rel2bbox.pth", "roberta.safetensors"):
        with pytest.raises(FileNotFoundError, match=path):
            loader.load_layout_predictor(LayoutConfig(), str(tmp_path / path), device="cpu")
    from safetensors.numpy import save_file

    from diffusion_spacetime_attn_tpu.utils import convert as jconvert
    from diffusion_spacetime_attn_tpu_torch.utils import testing
    from diffusion_spacetime_attn_tpu_torch.utils.weights import flatten_tree

    fs = testing.seeded_state_dict(testing.rel2bbox_shapes(LayoutConfig(**SMALL)), 4)
    torch.save({"state_dict": {k: torch.from_numpy(v) for k, v in fs.items()}, "log": {},
                "n_steps": 0}, tmp_path / "rel2bbox.pth")        # the reference trainer's dict
    model = loader.load_layout_predictor(LayoutConfig(**SMALL), str(tmp_path / "rel2bbox.pth"),
                                         device="cpu")
    want = layout_state_dict(jconvert.convert_fairseq_rel2bbox(fs), model)
    assert all(torch.equal(v, want[k]) for k, v in model.state_dict().items())
    rb = {f"roberta.{k}": v for k, v in fs.items()}      # not HF names: no backbone key
    save_file({"roberta.embeddings.word_embeddings.weight": rb[
        "roberta.encoder.model.encoder.sentence_encoder.embed_tokens.weight"]},
        str(tmp_path / "roberta.safetensors"))
    with pytest.raises(KeyError, match="position_embeddings"):
        loader.load_layout_predictor(LayoutConfig(**SMALL), str(tmp_path / "roberta.safetensors"),
                                     device="cpu")
    model = loader.load_layout_predictor(LayoutConfig(**SMALL), None, seed=3, device="cpu")
    again = create_layout_predictor(LayoutConfig(**SMALL), 3, "cpu")
    for (k, a), b in zip(model.state_dict().items(), again.state_dict().values()):
        assert torch.equal(a, b), k
    assert float(model.backbone.emb_ln.weight.min()) == 1.0


def test_layout_infer_prints_the_golden_format(capsys, monkeypatch, tmp_path):
    """Full LayoutConfig (RoBERTa-base width) on the CPU; without --cpu and
    without a card the entry point raises."""
    monkeypatch.delenv("DSTA_LAYOUT_CKPT", raising=False)
    res = layout_infer.main(["--cpu"])
    out = capsys.readouterr().out.splitlines()
    assert out[1] == f"Sentence: {layout_infer.GOLDEN}"
    assert [ln.split(" position: ")[0] for ln in out[2:]] == ["The silver bed", "the white couch"]
    assert all(ln.endswith(")") and ln.count(",") == 1 for ln in out[2:])
    assert list(res) == ["The silver bed", "the white couch"]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--cpu"):
        layout_infer.main([])
    # --vocab / --merges read RoBERTa's BPE (until the loaders were ported
    # they raised, naming ROADMAP A.11); the core goes to stderr
    from test_torch_tokenizer import write_gpt2_vocab

    vp, mp = write_gpt2_vocab(tmp_path)
    with pytest.raises(FileNotFoundError, match="m.txt"):
        layout_infer.main(["--cpu", "--vocab", vp, "--merges", str(tmp_path / "m.txt")])
    capsys.readouterr()
    layout_infer.main(["--cpu", "--vocab", vp, "--merges", mp])
    got = capsys.readouterr()
    assert "tokenizer core: native" in got.err
    assert got.out.splitlines()[1] == f"Sentence: {layout_infer.GOLDEN}"
