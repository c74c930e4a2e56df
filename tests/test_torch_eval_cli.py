"""PyTorch port, the evaluation CLIs held against the JAX package's scripts
on the CPU: `evaluate` (its JSON on the same folder and detections, numbers
within 1e-6; the CLIP route's keys and its dumped detections scoring as
JAX scores them), `calibrate_clip_detector` (the artifact equal to JAX's at
a small size, the sweep included, and its cells and layout those of the
committed `DETECTOR_CALIBRATION.json`), `compare_outputs` (its JSON line),
`eval_frontend_extraction` (its artifact on prompt files written here) and
`eval_layout_consistency` (its artifact with the layout predictor's weights
carried across by the weight bridge).  The JAX scripts are loaded from
`scripts/` and called with their command lines.
"""
import contextlib
import importlib.util
import io
import json
import pickle
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from diffusion_spacetime_attn_tpu.config import LayoutConfig as JLayoutConfig
from diffusion_spacetime_attn_tpu.models.layout.model import create_layout_predictor as jcreate
from diffusion_spacetime_attn_tpu.utils import loader as jloader
from diffusion_spacetime_attn_tpu_torch.config import LayoutConfig
from diffusion_spacetime_attn_tpu_torch.models.layout.model import LayoutPredictor
from diffusion_spacetime_attn_tpu_torch.scripts import (
    calibrate_clip_detector,
    compare_outputs,
    eval_frontend_extraction,
    eval_layout_consistency,
    evaluate,
)
from diffusion_spacetime_attn_tpu_torch.utils.png import write_png
from diffusion_spacetime_attn_tpu_torch.utils.weights import layout_state_dict

REPO = Path(__file__).resolve().parent.parent
GPT_TXT = """Objects: big dog, small cat
Relation: big dog left of small cat
Sentence: a big dog left of a small cat

Objects: person, car
Relation: person above car
Sentence: a person above a car

Objects: cat, dog
Relation: cat right of dog
Sentence: a cat right of a dog

Objects: bowl, knife
Relation: knife above bowl
Sentence: The bowl was placed on the counter, with the knife resting above it.

"""
PKL_ROWS = [
    ["a dog left of a cat", ["a", "dog"], [1, 4], [[1, 4, "left of"]], ["a dog", "a cat"]],
    ["the sofa at the right side of a tv", [], [1, 6],
     [[1, 6, "at the right side of"], [6, 1, "near"]], ["the sofa", "a tv"]],
    ["a bathroom with a toilet", [], [1, 4], None, ["a bathroom", "a toilet"]],
    ["a person above the stop sign", [], [1, 4], [[1, 4, "above"]],
     ["a person", "the stop sign"]],
]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def jax_script(name):
    """The JAX package's `scripts/<name>.py` as a module."""
    spec = importlib.util.spec_from_file_location(f"jax_script_{name}",
                                                  REPO / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run_jax(name, argv, monkeypatch):
    """JAX's script main() on `argv`; returns (its return value, stdout)."""
    monkeypatch.setattr(sys, "argv", [f"{name}.py", *argv])
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        ret = jax_script(name).main()
    return ret, out.getvalue()


def assert_same_json(got, want, tol=1e-6):
    if isinstance(want, dict):
        assert list(got) == list(want)
        for k in want:
            assert_same_json(got[k], want[k], tol)
    elif isinstance(want, list):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert_same_json(g, w, tol)
    elif isinstance(want, float):
        assert abs(got - want) <= tol, (got, want)
    else:
        assert got == want


def _dataset(root: Path):
    """gpt.txt, {mscoco,vsr}.txt and .pkl under root."""
    (root / "gpt.txt").write_text(GPT_TXT)
    for ds in ("mscoco", "vsr"):
        (root / f"{ds}.txt").write_text("".join(r[0] + "\n" for r in PKL_ROWS))
        with open(root / f"{ds}.pkl", "wb") as f:
            pickle.dump(PKL_ROWS, f)
    return root


def _results(root: Path, n=4, size=32, seed=0):
    res = root / "results"
    res.mkdir(exist_ok=True)
    r = np.random.RandomState(seed)
    for i in range(n):
        write_png(str(res / f"final2_s1_index_{i}.png"),
                  r.randint(0, 256, size=(size, size, 3)).astype(np.uint8))
    return res


# ---------------------------------------------------------------- evaluate


def test_evaluate_json_equals_jax_on_the_same_detections(tmp_path, monkeypatch):
    data = _dataset(tmp_path)
    res = _results(tmp_path)
    dets = {
        "final2_s1_index_0.png": [[1, 4, 10, 12, "dog", 0.9], [20, 4, 30, 12, "cat", 0.7]],
        "final2_s1_index_1.png": [[4, 1, 12, 9, "person", 0.45], [4, 20, 12, 30, "car", 0.8]],
        "final2_s1_index_2.png": [[20, 4, 30, 12, "cat", 0.3], [1, 4, 10, 12, "dog", 0.95]],
        "final2_s1_index_3.png": [[4, 20, 12, 30, "bowl", 0.6], [4, 1, 12, 9, "knife", 0.55]],
    }
    (tmp_path / "dets.json").write_text(json.dumps(dets))
    for conf in ("0.4", "0.5"):
        argv = ["--results", str(res), "--dataset", "gpt", "--data-root", str(data),
                "--detections", str(tmp_path / "dets.json"), "--conf-recall", conf]
        got = evaluate.main(argv + ["--json-out", str(tmp_path / "port.json")])
        run_jax("evaluate", argv + ["--json-out", str(tmp_path / "jax.json")], monkeypatch)
        want = json.loads((tmp_path / "jax.json").read_text())
        assert_same_json(json.loads((tmp_path / "port.json").read_text()), want)
        assert got == json.loads((tmp_path / "port.json").read_text())
        assert want["gt_objects"] == 8 and want["relations_total"] == 4


def test_evaluate_clip_route_dumps_detections_jax_scores_alike(tmp_path, monkeypatch):
    """--detector clip --tiny --cpu --dump-detections --clip-score: the JAX
    script's keys; the dumped detections give the same numbers through the
    port's and JAX's --detections route."""
    data = _dataset(tmp_path)
    res = _results(tmp_path, n=3, size=32)
    argv = ["--results", str(res), "--dataset", "gpt", "--data-root", str(data)]
    rep = evaluate.main(argv + ["--detector", "clip", "--tiny", "--cpu", "--clip-score",
                                "--dump-detections", str(tmp_path / "d.json")])
    assert list(rep) == ["results_dir", "dataset", "n_images", "detector", "detector_weights",
                         "gt_objects", "generated_objects", "object_recall",
                         "relations_correct", "relations_total", "relation_accuracy",
                         "conf_recall", "conf_relation", "clip_score_weights",
                         "mean_clip_score", "n_scored"]
    assert rep["detector_weights"] == rep["clip_score_weights"] == "random"
    assert rep["n_scored"] == 3 and np.isfinite(rep["mean_clip_score"])
    dumped = json.loads((tmp_path / "d.json").read_text())
    assert sorted(dumped) == [f"final2_s1_index_{i}.png" for i in range(3)]
    det_argv = argv + ["--detections", str(tmp_path / "d.json")]
    port = evaluate.main(det_argv + ["--json-out", str(tmp_path / "p.json")])
    run_jax("evaluate", det_argv + ["--json-out", str(tmp_path / "j.json")], monkeypatch)
    assert_same_json(port, json.loads((tmp_path / "j.json").read_text()))
    for k in ("gt_objects", "generated_objects", "object_recall", "relation_accuracy"):
        assert port[k] == rep[k]


# ---------------------------------------------------------------- calibration


def test_calibration_artifact_equals_jax_and_has_the_committed_layout(tmp_path, monkeypatch):
    """Both scripts with --sweep on one composite of 64 px per cell (the
    full 24 at 512 px take minutes): equal artifacts.  The committed artifact's seed,
    size, headline keys and 12 sweep cells are what the port writes with the
    default flags; its numbers come from the 24-image run."""
    argv = ["--n-images", "1", "--size", "64", "--sweep"]
    got = calibrate_clip_detector.main(argv + ["--out", str(tmp_path / "p.json")])
    run_jax("calibrate_clip_detector", argv + ["--out", str(tmp_path / "j.json")], monkeypatch)
    want = json.loads((tmp_path / "j.json").read_text())
    assert got == json.loads((tmp_path / "p.json").read_text()) == want
    committed = json.loads((REPO / "DETECTOR_CALIBRATION.json").read_text())
    assert committed["seed"] == 0 and committed["size"] == 512
    assert list(committed["headline"]) == list(got["headline"])
    assert committed["headline"]["n_images"] == 24
    strip = lambda rows: [{k: v for k, v in r.items()                     # noqa: E731
                           if k not in ("oracle_recall_iou50", "oracle_mean_iou", "n_objects")}
                          for r in rows]
    assert strip(committed["sweep"]) == strip(got["sweep"]) and len(got["sweep"]) == 12


# ---------------------------------------------------------------- compare_outputs


def test_compare_outputs_json_equals_jax(tmp_path, monkeypatch, capsys):
    a, b = tmp_path / "a", tmp_path / "b"
    a.mkdir(), b.mkdir()
    r = np.random.RandomState(4)
    for name in ("final2_s1_index_0.png", "final2_s1_index_1.png", "x.png"):
        img = r.randint(0, 256, size=(16, 16, 3)).astype(np.uint8)
        write_png(str(a / name), img)
        write_png(str(b / name), np.clip(img.astype(int) + r.randint(-3, 4, img.shape), 0, 255)
                  .astype(np.uint8))
    write_png(str(a / "only_a.png"), np.zeros((4, 4, 3), np.uint8))
    assert compare_outputs.main([str(a), str(b), "--json"]) == 0
    got = json.loads(capsys.readouterr().out.strip())
    ret, out = run_jax("compare_outputs", [str(a), str(b), "--json"], monkeypatch)
    assert ret == 0
    assert_same_json(got, json.loads(out.strip()), tol=1e-7)
    assert got["only_in_a"] == 1 and got["n_images"] == 3
    empty = tmp_path / "empty"
    empty.mkdir()
    assert compare_outputs.main([str(a), str(empty)]) == 1


# ---------------------------------------------------------------- front end and layout


def test_frontend_extraction_artifact_equals_jax(tmp_path, monkeypatch):
    data = _dataset(tmp_path)
    argv = ["--data-root", str(data), "--max-failures", "3"]
    got = eval_frontend_extraction.main(argv + ["--out", str(tmp_path / "p.json")])
    run_jax("eval_frontend_extraction", argv + ["--out", str(tmp_path / "j.json")], monkeypatch)
    want = json.loads((tmp_path / "j.json").read_text())
    assert got == json.loads((tmp_path / "p.json").read_text()) == want
    assert want["datasets"]["gpt"]["prompts"] == 4


SMALL = dict(hidden=32, layers=2, heads=2, ffn_dim=64, max_positions=140, max_len=24)


@pytest.fixture(scope="module")
def layout_models():
    jmodel, jparams = jcreate(JLayoutConfig(**SMALL), jax.random.PRNGKey(6))
    jparams = jax.tree_util.tree_map(np.asarray, jax.device_get(jparams))
    model = LayoutPredictor(LayoutConfig(**SMALL))
    model.load_state_dict(layout_state_dict(jparams, model), strict=True)
    return jmodel, jparams, model.eval().requires_grad_(False)


@pytest.mark.parametrize("dataset, extra", [("gpt", ["--breakdown"]),
                                            ("mscoco", ["--decode", "greedy"])])
def test_layout_consistency_artifact_equals_jax(layout_models, dataset, extra, tmp_path,
                                                monkeypatch):
    """The same small predictor in both packages (the JAX params bridged
    into the port) for the trained row and the random baseline."""
    jmodel, jparams, model = layout_models
    data = _dataset(tmp_path)
    monkeypatch.setattr(jloader, "load_layout_predictor", lambda cfg, path: (jmodel, jparams))
    argv = ["--dataset", dataset, "--data-root", str(data), "--ckpt", "random",
            "--random-baseline", "--cpu", *extra]
    got = eval_layout_consistency.main(argv + ["--out", str(tmp_path / "p.json")],
                                       load=lambda cfg, path: model)
    run_jax("eval_layout_consistency", argv + ["--out", str(tmp_path / "j.json")], monkeypatch)
    want = json.loads((tmp_path / "j.json").read_text())
    assert_same_json(got, want)
    assert want["trained"]["relations_total"] > 0
