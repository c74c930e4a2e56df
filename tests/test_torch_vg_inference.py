"""PyTorch port, VG-MSDN batch inference and the layout drawings held
against the JAX package on the CPU: `scene_graph_to_words`, the batched
centers (within 1e-4 of JAX's `VGMSDNInference` on the same layout weights),
the relation log, sg2im JSON and layout JSON bytes (the layout JSON on
JAX's centers, so both format the same floats; the run's own within 1e-4),
the PNG's rectangles equal to PIL's pixels outside the label boxes, the
control circles of `utils/vis.draw_layout` at IoU >= 0.9 of PIL's outline
pixels, and the `infer_vg_msdn` CLI end to end.

Layout config: hidden 32, 2 layers, 2 heads, length 32 (the JAX script's
`--tiny`), float32; torch takes one thread.
"""
import json
import os

import jax
import numpy as np
import pytest
import torch
from PIL import Image, ImageDraw

from diffusion_spacetime_attn_tpu.config import LayoutConfig as JLayoutConfig
from diffusion_spacetime_attn_tpu.models.layout.model import create_layout_predictor as jcreate
from diffusion_spacetime_attn_tpu.pipeline import frontend as jfe
from diffusion_spacetime_attn_tpu.pipeline import vg_inference as jvg
from diffusion_spacetime_attn_tpu.utils import vis as jvis
from diffusion_spacetime_attn_tpu.utils.tokenizer import make_roberta_tokenizer as jtokenizer
from diffusion_spacetime_attn_tpu_torch.config import LayoutConfig
from diffusion_spacetime_attn_tpu_torch.models.layout.model import LayoutPredictor
from diffusion_spacetime_attn_tpu_torch.pipeline import frontend as fe
from diffusion_spacetime_attn_tpu_torch.pipeline import vg_inference as tvg
from diffusion_spacetime_attn_tpu_torch.scripts import infer_vg_msdn
from diffusion_spacetime_attn_tpu_torch.utils import draw, vis
from diffusion_spacetime_attn_tpu_torch.utils.png import read_png
from diffusion_spacetime_attn_tpu_torch.utils.tokenizer import make_roberta_tokenizer
from diffusion_spacetime_attn_tpu_torch.utils.weights import layout_state_dict

TINY = dict(hidden=32, layers=2, heads=2, ffn_dim=64, vocab_size=50265, max_len=32)
SCENE_GRAPHS = [
    {"id": 7, "objects": [{"class": "cat"}, {"class": "table"}, {"class": "lamp"}],
     "relationships": [{"sub_id": 0, "obj_id": 1, "predicate": "on"},
                       {"sub_id": 2, "obj_id": 1, "predicate": "next to"}]},
    {"image_id": "sg2im_a", "objects": ["dog", "tree", "sky"],
     "relationships": [[0, "left of", 1], [2, "above", 1], [0, "near", 9]]},
    {"id": 9, "objects": [{"class": "car"}], "relationships": []},
    {"id": 11, "objects": [{"class": ""}, {"class": "bench"}],
     "relationships": [{"sub_id": 0, "obj_id": 1, "predicate": "beside"}]},
]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def inferences():
    jmodel, jparams = jcreate(JLayoutConfig(**TINY), jax.random.PRNGKey(3))
    jparams = jax.tree_util.tree_map(np.asarray, jax.device_get(jparams))
    model = LayoutPredictor(LayoutConfig(**TINY))
    model.load_state_dict(layout_state_dict(jparams, model), strict=True)
    model.eval().requires_grad_(False)
    return (jfe.LayoutInference(jmodel, jparams, jtokenizer(), TINY["max_len"]),
            fe.LayoutInference(model, make_roberta_tokenizer(), TINY["max_len"]), model)


def test_scene_graph_to_words_matches_jax():
    for sg in SCENE_GRAPHS:
        assert tvg.scene_graph_to_words(sg) == jvg.scene_graph_to_words(sg)


def _outside_text(shape, boxes):
    keep = np.ones(shape[:2], bool)
    for x0, y0, x1, y1 in boxes:
        keep[max(int(y0), 0):int(np.ceil(y1)) + 1, max(int(x0), 0):int(np.ceil(x1)) + 1] = False
    return keep


def _text_boxes(names, boxes):
    """Label boxes of both renderers: PIL's default font and the bitmap one."""
    probe = ImageDraw.Draw(Image.new("RGB", (8, 8)))
    out = []
    for i, (name, bb) in enumerate(zip(names, boxes)):
        label, x, y = f"{name}[{i + 1}]", float(bb[0]) + 3, float(bb[1]) + 3
        out.append(probe.textbbox((x, y), label))
        w, h = draw.text_size(label)
        out.append((int(x), int(y), int(x) + w, int(y) + h))
    return out


def test_vg_inference_matches_jax(inferences, tmp_path):
    jli, tli, _ = inferences
    jout, tout = tmp_path / "jax", tmp_path / "port"
    jres = jvg.VGMSDNInference(jli, str(jout)).run(SCENE_GRAPHS, layout_save=str(jout / "lay"),
                                                   batch=3)
    tinf = tvg.VGMSDNInference(tli, str(tout))
    tres = tinf.run(SCENE_GRAPHS, layout_save=str(tout / "lay"), batch=3)
    assert [r.get("skipped") for r in tres] == [r.get("skipped") for r in jres]
    assert sum("png" in r for r in tres) == 3
    for j, t in zip(jres, tres):
        assert {k: os.path.basename(str(v)) for k, v in t.items() if k != "centers"} == \
            {k: os.path.basename(str(v)) for k, v in j.items() if k != "centers"}
        if "png" not in j:
            continue
        np.testing.assert_allclose(t["centers"], j["centers"], atol=1e-4)
        for key in ("txt", "json"):
            assert open(t[key], "rb").read() == open(j[key], "rb").read(), key
        jl, tl = json.load(open(j["layout_json"])), json.load(open(t["layout_json"]))
        assert {k: v for k, v in tl.items() if k != "boxes"} == \
            {k: v for k, v in jl.items() if k != "boxes"}
        np.testing.assert_allclose(tl["boxes"], jl["boxes"], atol=1e-4)
        # on JAX's centers: the same layout JSON bytes and PNG rectangles
        idx = jres.index(j)
        _, _, names, _ = jvg.scene_graph_to_words(SCENE_GRAPHS[idx])
        boxes = tinf._boxes_xyxy(np.asarray(j["centers"], np.float32))
        path = tinf._write_layout_json(j["image_id"], names, boxes, str(tmp_path / "same"))
        assert open(path, "rb").read() == open(j["layout_json"], "rb").read()
        png = read_png(tinf._draw(j["image_id"], idx, names, boxes))
        want = np.asarray(Image.open(j["png"]).convert("RGB"))
        keep = _outside_text(want.shape, _text_boxes(names, boxes))
        np.testing.assert_array_equal(png[keep], want[keep])
        assert (png[~keep] != 200).any()                # the labels were drawn


def _iou(a, b):
    return (a & b).sum() / max((a | b).sum(), 1)


def test_draw_layout_circles_match_pil():
    layout = {"cat": (0.3, 0.35), "dog": (0.72, 0.6), "tree": (0.5, 0.9)}
    size = 256
    got, want = vis.draw_layout(layout, size=size), jvis.draw_layout(layout, size=size)
    probe = ImageDraw.Draw(Image.new("RGB", (8, 8)))
    boxes = []
    for phrase, (x, y) in layout.items():
        xy = (min(x * size + 6, size - 60), min(y * size + 6, size - 14))
        boxes.append(probe.textbbox(xy, phrase))
        w, h = draw.text_size(phrase)
        boxes.append((int(xy[0]), int(xy[1]), int(xy[0]) + w, int(xy[1]) + h))
    keep = _outside_text(got.shape, boxes)
    for i in range(len(layout)):
        color = np.array(vis.COLORS[i])
        a = (got == color).all(-1) & keep
        b = (want == color).all(-1) & keep
        assert b.sum() > 100 and _iou(a, b) >= 0.9, (i, _iou(a, b))
    bg = np.asarray(Image.fromarray(np.full((40, 30, 3), 90, np.uint8)))
    on_image = vis.draw_layout(layout, size=size, image=bg)
    assert on_image.shape == (size, size, 3) and (on_image == 90).all(-1).mean() > 0.5


def test_infer_vg_msdn_cli(inferences, tmp_path):
    _, _, model = inferences
    path = tmp_path / "sg.json"
    path.write_text(json.dumps(SCENE_GRAPHS))
    out = tmp_path / "out"
    res = infer_vg_msdn.main(["--instances", str(path), "--out", str(out), "--tiny", "--cpu",
                              "--layout-save", str(out / "lay"), "--batch", "2"], model=model)
    assert sum("png" in r for r in res) == 3
    assert sorted(os.listdir(out / "sg2im_json")) == \
        sorted(["7.json", "sg2im_a.json", "11.json"])
    img = read_png(res[0]["png"])
    assert img.shape == (640, 640, 3)
    single = tmp_path / "one.json"
    single.write_text(json.dumps(SCENE_GRAPHS[0]))
    res = infer_vg_msdn.main(["--instances", str(single), "--out", str(tmp_path / "o2"), "--tiny",
                              "--cpu"])
    assert len(res) == 1 and os.path.exists(res[0]["png"])
