"""PyTorch port, the evaluation slice held against the JAX package on the CPU:
the CLIP grid detector (scores, boxes, refinement), the protocol over an
image folder (detections, object recall, relation accuracy, CLIP score),
the ground-truth parsers and the rest of the protocol math, and the
`run_eval_protocol` entry point (its artifact keys against JAX's script
scoring the same folder).

A small CLIP (28x28 images in patches of 14, width 16, JAX's init
randomized at scale 0.1) loaded into the port through the bridge; 64x64
images, so the grid has 10 boxes at scales 1.0 and 0.5.  Tolerance: scores
and sims within 1e-4 (float32, the same products in another order); boxes
and the protocol's counts exactly equal.
"""
import dataclasses
import json
import os
import pickle
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from diffusion_spacetime_attn_tpu.config import CLIPConfig, CLIPTextConfig, CLIPVisionConfig
from diffusion_spacetime_attn_tpu.eval import clip_detector as jdet
from diffusion_spacetime_attn_tpu.eval import metrics as jmetrics
from diffusion_spacetime_attn_tpu.eval import protocol as jprotocol
from diffusion_spacetime_attn_tpu.models.clip import CLIP as JCLIP
from diffusion_spacetime_attn_tpu.pipeline.losses import DCLIPLoss as JDCLIPLoss
from diffusion_spacetime_attn_tpu.utils.testing import randomize_params
from diffusion_spacetime_attn_tpu.utils.tokenizer import make_clip_tokenizer as jclip_tok
from diffusion_spacetime_attn_tpu_torch import config as tcfg
from diffusion_spacetime_attn_tpu_torch.eval import clip_detector, metrics, protocol
from diffusion_spacetime_attn_tpu_torch.pipeline.losses import DCLIPLoss
from diffusion_spacetime_attn_tpu_torch.scripts import run_eval_protocol
from diffusion_spacetime_attn_tpu_torch.utils.png import write_png
from diffusion_spacetime_attn_tpu_torch.utils.tokenizer import make_clip_tokenizer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CATEGORIES = ["dog", "cat", "car", "person"]
GPT_TXT = """Objects: big dog, small cat
Relation: big dog left of small cat
Sentence: a big dog left of a small cat

Objects: person, car
Relation: person above car
Sentence: a person above a car

Objects: cat, dog
Relation: cat right of dog
Sentence: a cat right of a dog

"""


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The suite runs several test processes side by side on few cores,
    where torch's spinning intra-op threads slow each other down many-fold;
    this module's torch work is small, so it takes one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def port_cfg(c):
    cls = getattr(tcfg, type(c).__name__)
    return cls(**{f.name: (port_cfg(getattr(c, f.name))
                           if dataclasses.is_dataclass(getattr(c, f.name))
                           else getattr(c, f.name))
                  for f in dataclasses.fields(c)})


@pytest.fixture(scope="module")
def clips():
    """(JAX CLIP, its params, the port's DCLIPLoss with those weights,
    JAX tokenize, port tokenize)."""
    cfg = CLIPConfig(
        vision=CLIPVisionConfig(image_size=28, patch_size=14, width=16, layers=1, heads=2,
                                projection_dim=8),
        text=CLIPTextConfig(width=16, layers=1, heads=2, vocab_size=49408, max_len=12),
        projection_dim=8)
    clip = JCLIP(cfg)
    params = randomize_params(
        jax.eval_shape(clip.init, jax.random.PRNGKey(0), jnp.zeros((1, 28, 28, 3)),
                       jnp.zeros((1, 12), jnp.int32))["params"], jax.random.PRNGKey(1), 0.1)
    flat = {k: np.asarray(v) for k, v in
            traverse_util.flatten_dict(jax.device_get(params), sep="/").items()}
    loss = DCLIPLoss.from_flat(port_cfg(cfg), flat, device="cpu")
    jt, tt = jclip_tok(max_len=12), make_clip_tokenizer(max_len=12)
    return (clip, params, loss, lambda s: jt.pad_to(jt.encode(s), 12),
            lambda s: tt.pad_to(tt.encode(s), 12))


@pytest.fixture(scope="module")
def detectors(clips):
    clip, params, loss, jtok, ttok = clips
    kw = dict(categories=CATEGORIES, scales=(1.0, 0.5))
    return (jdet.CLIPDetector(clip, params, jtok, **kw),
            clip_detector.CLIPDetector(loss.clip, ttok, **kw))


def _image(seed, size=64):
    r = np.random.RandomState(seed)
    img = np.full((size, size, 3), 0.45, np.float32) + 0.1 * r.rand(size, size, 3)
    x, y = r.randint(0, size // 2, 2)
    img[y:y + size // 3, x:x + size // 3] = r.rand(3)       # one bright block
    return img.astype(np.float32)


def test_scores_and_sims_match_jax(detectors):
    jd, td = detectors
    img = _image(0)
    boxes = jdet._grid_boxes(64, (1.0, 0.5))
    np.testing.assert_array_equal(clip_detector._grid_boxes(64, (1.0, 0.5)), boxes)
    np.testing.assert_array_equal(clip_detector._expand_boxes(boxes, 64),
                                  jdet._expand_boxes(boxes, 64))
    calls = td.embed_calls
    (js, jsims), (ts, tsims) = jd._scores(img, boxes, 64), td._scores(img, boxes, 64)
    assert td.embed_calls == calls + 2                 # crops, then rings: one call each
    np.testing.assert_allclose(tsims, jsims, atol=1e-4, rtol=0)
    np.testing.assert_allclose(ts, js, atol=1e-4, rtol=0)
    crop = img[3:40, 5:29]
    np.testing.assert_allclose(clip_detector._host_resize(crop, 28, {}),
                               jdet._host_resize(crop, 28), atol=1e-6, rtol=0)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_detections_match_jax(detectors, seed):
    """Same boxes (grid choice and refinement), scores within 1e-4."""
    jd, td = detectors
    img = _image(seed)
    want, got = jd(img), td(img)
    assert [d.category for d in got] == [d.category for d in want] == CATEGORIES
    refined = 0
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g.box), np.asarray(w.box))
        assert abs(g.score - w.score) <= 1e-4
        refined += g.score >= td.refine_prob_gate
    assert refined >= 1                                 # the refinement ran


def _folder(tmp_path):
    (tmp_path / "gpt.txt").write_text(GPT_TXT)
    res = tmp_path / "results"
    res.mkdir()
    for i in range(3):
        write_png(str(res / f"final2_s1_index_{i}.png"),
                  (_image(10 + i) * 255).astype(np.uint8))
    write_png(str(res / "final1_s1_index_0.png"), (_image(20) * 255).astype(np.uint8))
    return res


def test_protocol_over_a_folder_matches_jax(detectors, clips, tmp_path):
    """detect_folder -> score_results and clip_score_results on one image
    folder: the same detections JSON (scores within 1e-4), recall,
    relation accuracy and counts; CLIP scores within 1e-4."""
    jd, td = detectors
    clip, params, loss, jtok, ttok = clips
    res = _folder(tmp_path)
    files = protocol.list_result_files(str(res), (0, 3), epoch=2, seed=1)
    assert files == jprotocol.list_result_files(str(res), (0, 3), epoch=2, seed=1)
    assert files == [f"final2_s1_index_{i}.png" for i in range(3)]
    jdets = jprotocol.detect_folder(str(res), jd, files)
    tdets = protocol.detect_folder(str(res), td, files)
    assert list(tdets) == list(jdets)
    for f in files:
        for g, w in zip(tdets[f], jdets[f]):
            assert g[:5] == w[:5] and abs(g[5] - w[5]) <= 1e-4
    # the reference thresholds (0.4 / 0.5), then lower ones so the counts are not all 0
    for conf in ((0.4, 0.5), (0.0, 0.0)):
        kw = dict(conf_recall=conf[0], conf_relation=conf[1], prompt_range=(0, 3), epoch=2,
                  seed=1)
        want = jprotocol.score_results(str(res), "gpt", str(tmp_path), jdets, **kw)
        got = protocol.score_results(str(res), "gpt", str(tmp_path), tdets, **kw)
        assert got == want
        assert 0.0 <= got["object_recall"] <= 1.0 and 0.0 <= got["relation_accuracy"] <= 1.0
    assert got["gt_objects"] == 6 and got["generated_objects"] == 6
    jcs = jprotocol.clip_score_results(str(res), "gpt", str(tmp_path), JDCLIPLoss(clip, params),
                                       jtok, prompt_range=(0, 3), epoch=2, seed=1)
    tcs = protocol.clip_score_results(str(res), "gpt", str(tmp_path), loss, ttok,
                                      prompt_range=(0, 3), epoch=2, seed=1)
    assert tcs["n_scored"] == jcs["n_scored"] == 3
    assert abs(tcs["mean_clip_score"] - jcs["mean_clip_score"]) <= 1e-4


def test_ground_truth_parsers_and_metrics_match_jax(tmp_path):
    (tmp_path / "gpt.txt").write_text(GPT_TXT)
    assert (metrics.parse_gpt_ground_truth(str(tmp_path / "gpt.txt"))
            == jmetrics.parse_gpt_ground_truth(str(tmp_path / "gpt.txt")))
    rows = [
        ["a dog left of a cat", ["a", "dog"], [1, 4], [[1, 4, "left of"]], ["a dog", "a cat"]],
        ["the sofa at the right side of a tv", [], [1, 6],
         [[1, 6, "at the right side of"], [6, 1, "near"]], ["the sofa", "a tv"]],
        ["a bathroom", [], [1], None, ["a bathroom"]],
        ["two", [], [2, 3], [[2, 9, "above"]], ["a person", "the stop sign"]],
    ]
    with open(tmp_path / "mscoco.pkl", "wb") as f:
        pickle.dump(rows, f)
    got = metrics.parse_pkl_ground_truth(str(tmp_path / "mscoco.pkl"))
    assert got == jmetrics.parse_pkl_ground_truth(str(tmp_path / "mscoco.pkl"))
    assert got[1][1] == [("couch", "tv", "right of")]
    for phrase in ("the silver bed", "a stop sign on the corner", "quux", "the red television",
                   "A Hot Dog", "wine glass"):
        assert metrics.head_category(phrase) == jmetrics.head_category(phrase)
    for name in ("final2_s1_index_42.png", "final2_s1_other.png", "x/final0_s7_index_3.png"):
        assert metrics.result_index(name) == jmetrics.result_index(name)
    preds = [{"dog": (0.2, 0.5), "cat": (0.8, 0.5)}, {"dog": (0.9, 0.5), "cat": (0.1, 0.5)},
             {"dog": (0.5, 0.5)}, None]
    rels = [[("dog", "cat", "left of")]] * 4
    assert (metrics.layout_relation_consistency(preds, rels)
            == jmetrics.layout_relation_consistency(preds, rels))


def test_run_eval_protocol_artifact_keys_match_jax(tmp_path, capsys):
    """The port's protocol end to end (tiny, CPU: generation in a
    subprocess, detection, scoring), then JAX's script scoring the same
    folder (`--skip-generate`): the same artifact keys, the same counts and
    weights' provenance ("random")."""
    (tmp_path / "gpt.txt").write_text(GPT_TXT)
    common = ["--dataset", "gpt", "--data-root", str(tmp_path), "--tiny", "--cpu", "--steps",
              "2", "--end", "3", "--batch-size", "2", "--outdir", str(tmp_path / "out")]
    art = run_eval_protocol.main(common + ["--out", str(tmp_path / "port.json")])
    assert art == json.loads((tmp_path / "port.json").read_text())
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "scripts/run_eval_protocol.py", *common,
                        "--skip-generate", "--out", str(tmp_path / "jax.json")],
                       capture_output=True, text=True, timeout=600, cwd=REPO, env=env)
    assert r.returncode == 0, r.stderr[-3000:]
    jart = json.loads((tmp_path / "jax.json").read_text())
    assert list(art) == list(jart)
    for k in ("n_images", "gt_objects", "relations_total", "sd_weights", "layout_weights",
              "detector_weights", "clip_score_weights", "params_dtype", "n_scored",
              "detector_calibration", "sampler", "prompts"):
        assert art[k] == jart[k], k
    assert art["n_images"] == 3 and art["detector_weights"] == "random"
    assert np.isfinite(art["mean_clip_score"])
    assert 0.0 <= art["object_recall"] <= 1.0 and 0.0 <= art["relation_accuracy"] <= 1.0
    # the CLIP branches read their files (until the loaders were ported they
    # raised, naming ROADMAP A.11): a missing path raises naming it; OpenAI
    # CLIP weights and CLIP's BPE go to the detector and the CLIP score
    from diffusion_spacetime_attn_tpu_torch.scripts.run_dataset import tiny_configs
    from test_torch_loader import checkpoint_flag_file

    clip_cfg = tiny_configs(2)[0].loss_clip
    path, _, check = checkpoint_flag_file("--clip-ckpt", tmp_path)
    vocab, _, _ = checkpoint_flag_file("--clip-vocab", tmp_path)
    with pytest.raises(FileNotFoundError, match="vitb32.pt"):
        protocol.build_clip_detector(str(tmp_path / "vitb32.pt"), cfg=clip_cfg, device="cpu")
    det, prov = protocol.build_clip_detector(path, vocab, cfg=clip_cfg, device="cpu")
    loss, tokenize, prov2 = protocol.build_clip_loss(path, vocab, cfg=clip_cfg, device="cpu")
    assert prov == prov2 == path and check(loss)
    assert torch.equal(det.clip.visual_projection.weight, loss.clip.visual_projection.weight)
    assert list(tokenize("a cat"))[:4] == [49406, 320, 512 + 1, 49407]
