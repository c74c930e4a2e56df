"""VG / VG-MSDN batch layout inference, drawing and sg2im JSON export; port
of the JAX package's `pipeline/vg_inference.py` (reference
`inference/inference_vg_msdn.py:33-347`, `inference_coco.py:69-150`).

Scene graphs are packed into one fixed-shape [B, L] token batch per chunk
and one `LayoutPredictor.predict_xy` call (greedy component) serves it;
the artifacts are written on the host, named as JAX names them:

  {save_dir}/{image_id}_{idx}_c_{n}.png           drawn layout
  {save_dir}/{image_id}.txt                        relation-pair log
  {save_dir}/sg2im_json/{image_id}.json            sg2im scene-graph JSON
  {layout_save}/{image_id}.json                    normalized layout JSON

The model predicts (x, y) centers, so the boxes take the method's control
radius (0.2) as their extent.  The PNG is drawn with `utils/draw.py`: its
rectangles are Pillow's pixels, its labels come from a bitmap font
(Pillow's default font is FreeType-rendered; ROADMAP C).
"""
from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..utils import draw
from ..utils.png import write_png
from ..utils.vis import COLORS


def scene_graph_to_words(
    sg: Dict,
    max_triples: int = 8,
) -> Tuple[List[str], List[int], List[str], List[Tuple[int, str, int]]]:
    """A VG-MSDN record (`{objects: [{class,…}], relationships:
    [{sub_id, obj_id, predicate}]}`) or sg2im-style dict (`{objects:
    [name,…], relationships: [[i, pred, j],…]}`) → (words,
    first-mention word index per object, object names, triples).
    Mirrors the triple-sentence construction of
    `training/datasets.load_vg_msdn_examples` (and `VGmsdnDataset.py`'s
    `[CLS] sub pred obj [SEP]` sentences)."""
    objs = sg.get("objects", [])
    names = [o["class"] if isinstance(o, dict) else str(o) for o in objs]
    rels = sg.get("relationships", [])
    words: List[str] = []
    first_mention: Dict[int, int] = {}
    triples: List[Tuple[int, str, int]] = []
    for rel in rels[:max_triples]:
        if isinstance(rel, dict):
            s, p, o = rel["sub_id"], str(rel["predicate"]), rel["obj_id"]
        else:
            s, p, o = rel[0], str(rel[1]), rel[2]
        if s >= len(names) or o >= len(names):
            continue
        si = len(words)
        words.extend(str(names[s]).split())
        words.extend(p.split())
        oi = len(words)
        words.extend(str(names[o]).split())
        words.append(".")
        triples.append((s, p, o))
        first_mention.setdefault(s, si)
        first_mention.setdefault(o, oi)
    order = sorted(first_mention)                 # object id order
    remap = {orig: new for new, orig in enumerate(order)}
    mention_word_idx = [first_mention[i] for i in order]
    # triples re-indexed into the returned (kept, ordered) object list
    triples = [(remap[s], p, remap[o]) for s, p, o in triples]
    return words, mention_word_idx, [names[i] for i in order], triples


class VGMSDNInference:
    """Batched scene-graph → layout inference with reference-format
    artifact export."""

    def __init__(self, layout_inference, save_dir: str,
                 radius: float = 0.2, canvas_wh: Tuple[int, int] = (640, 640)):
        """layout_inference: a `pipeline.frontend.LayoutInference` (the model,
        weights inside, and a word-aligned tokenizer).  canvas_wh: the reference pins
        [640, 640] for sg-driven drawing (`inference_vg_msdn.py:86-88`)."""
        self.li = layout_inference
        self.save_dir = save_dir
        self.radius = radius
        self.canvas_wh = canvas_wh
        os.makedirs(save_dir, exist_ok=True)
        os.makedirs(os.path.join(save_dir, "sg2im_json"), exist_ok=True)

    # ------------------------------------------------------------- device
    def _predict_batch(self, batch_words, batch_mention_idx, pad_to=None):
        """Pack B samples into one [B, L] call; returns per-sample [N, 2]
        centers.  pad_to: pad the batch dim to this fixed size so every
        chunk has one shape (skipped empties would otherwise shrink B)."""
        L = self.li.max_len
        tok = self.li.tokenizer
        B = max(pad_to or 0, len(batch_words))
        tokens = np.full((B, L), getattr(tok, "pad", 1), np.int32)
        obj_pos = np.zeros((B, L), np.float32)
        tok_idx: List[List[int]] = []
        for b, (words, mention) in enumerate(zip(batch_words, batch_mention_idx)):
            ids, align = tok.encode_with_alignment(words)
            ids = tok.pad_to(ids, L)
            tokens[b] = np.asarray(ids, np.int32)
            ti = []
            for wi in mention:
                t = align[wi] if wi < len(align) else L - 1
                t = min(t, L - 1)
                obj_pos[b, t] = 1.0
                ti.append(t)
            tok_idx.append(ti)
        dev = self.li.device
        with torch.inference_mode():
            xy, _ = self.li.model.predict_xy(torch.as_tensor(tokens, dtype=torch.int64, device=dev),
                                             torch.as_tensor(obj_pos, device=dev),
                                             greedy_component=True)
        xy = xy.float().cpu().numpy()
        return [xy[b, ti] for b, ti in enumerate(tok_idx)]

    # -------------------------------------------------------------- host
    def _boxes_xyxy(self, centers: np.ndarray) -> np.ndarray:
        """centers [N,2] in [0,1] → pixel xyxy with the control radius as
        extent (`xcycwh2xyxy` semantics, `inference_vg_msdn.py:319-331`)."""
        W, H = self.canvas_wh
        r = self.radius
        out = np.stack([
            (centers[:, 0] - r) * W, (centers[:, 1] - r) * H,
            (centers[:, 0] + r) * W, (centers[:, 1] + r) * H,
        ], axis=1)
        # per-axis clamp into the canvas (`draw_img` clamps, :250-251 — but
        # against one dim only; with a non-square canvas that leaks boxes
        # off-canvas, so clamp each axis to its own extent here)
        out[:, 0] = np.clip(out[:, 0], 1.0, W - 1)
        out[:, 2] = np.clip(out[:, 2], 1.0, W - 1)
        out[:, 1] = np.clip(out[:, 1], 1.0, H - 1)
        out[:, 3] = np.clip(out[:, 3], 1.0, H - 1)
        return out

    def _draw(self, image_id, idx, names, boxes_xyxy):
        W, H = self.canvas_wh
        img = np.full((H, W, 3), 200, np.uint8)          # grey canvas (:249)
        for i, (name, bb) in enumerate(zip(names, boxes_xyxy)):
            # color keyed by first letter (`draw_img`, :255); dirty VG data
            # can carry empty class names: fall back to the index
            key = ord(name[0].lower()) - ord("a") if name else i
            color = COLORS[key % len(COLORS)]
            draw.rectangle(img, list(map(float, bb)), outline=color, width=3)
            draw.text(img, (float(bb[0]) + 3, float(bb[1]) + 3), f"{name}[{i + 1}]", fill=color)
        path = os.path.join(self.save_dir, f"{image_id}_{idx}_c_{len(boxes_xyxy)}.png")
        write_png(path, img)
        return path

    def _write_log(self, image_id, names, triples):
        """`write_log` (:262-274): one `sub[id] pred obj[id]` line per
        triple (1-based ids like the reference's class_ids)."""
        path = os.path.join(self.save_dir, f"{image_id}.txt")
        with open(path, "w") as f:
            for s, p, o in triples:
                f.write(f"{names[s]}[{s + 1}] {p} {names[o]}[{o + 1}]\n")
        return path

    def _write_sg2im_json(self, image_id, idx, names, triples):
        """`write_json` (:276-291): sg2im scene-graph JSON (0-based object
        indices + [sub, predicate, obj] triples)."""
        out = {
            "image_id": image_id,
            "dataset_idx": idx,
            "objects": list(names),
            "relationships": [[s, p, o] for s, p, o in triples],
        }
        path = os.path.join(self.save_dir, "sg2im_json", f"{image_id}.json")
        with open(path, "w") as f:
            json.dump(out, f)
        return path

    def _write_layout_json(self, image_id, names, boxes_xyxy, layout_save):
        """`save_layout` (:293-304): boxes normalized by canvas width."""
        os.makedirs(layout_save, exist_ok=True)
        out = {
            "image_id": image_id,
            "boxes": (np.asarray(boxes_xyxy) / self.canvas_wh[0]).tolist(),
            "classes": list(names),
            "class_ids": list(range(1, len(names) + 1)),
        }
        path = os.path.join(layout_save, f"{image_id}.json")
        with open(path, "w") as f:
            json.dump(out, f)
        return path

    # --------------------------------------------------------------- API
    def check_from_sg(self, sg: Dict, layout_save: Optional[str] = None
                      ) -> Dict[str, str]:
        """One scene graph → all artifacts (`check_from_sg`, :167-241)."""
        return self.run([sg], layout_save=layout_save)[0]

    def run(self, scene_graphs: Sequence[Dict],
            layout_save: Optional[str] = None,
            batch: int = 64) -> List[Dict[str, str]]:
        """Batched inference over many scene graphs; returns per-sample
        artifact paths.  `batch` rows share one forward."""
        results: List[Dict[str, str]] = []
        for start in range(0, len(scene_graphs), batch):
            chunk = scene_graphs[start:start + batch]
            parsed = [scene_graph_to_words(sg) for sg in chunk]
            keep = [i for i, (_, m, _, _) in enumerate(parsed) if m]
            if not keep:
                for i, sg in enumerate(chunk):
                    results.append({
                        "image_id": sg.get("id", sg.get("image_id", start + i)),
                        "skipped": "no objects"})
                continue
            centers = self._predict_batch(
                [parsed[i][0] for i in keep], [parsed[i][1] for i in keep],
                pad_to=batch)
            ci = iter(range(len(keep)))
            for i, sg in enumerate(chunk):
                idx = start + i
                image_id = sg.get("id", sg.get("image_id", idx))
                words, mention, names, triples = parsed[i]
                if i not in keep:
                    results.append({"image_id": image_id, "skipped": "no objects"})
                    continue
                xy = centers[next(ci)]
                boxes = self._boxes_xyxy(np.asarray(xy))
                res = {
                    "image_id": image_id,
                    "png": self._draw(image_id, idx, names, boxes),
                    "txt": self._write_log(image_id, names, triples),
                    "json": self._write_sg2im_json(image_id, idx, names, triples),
                    "centers": np.asarray(xy).tolist(),
                }
                if layout_save is not None:
                    res["layout_json"] = self._write_layout_json(
                        image_id, names, boxes, layout_save)
                results.append(res)
        return results

    def run_dataset(self, instances_json_path: str,
                    limit: Optional[int] = None,
                    layout_save: Optional[str] = None,
                    batch: int = 64) -> List[Dict[str, str]]:
        """`run` over a VG-MSDN instances JSON file (`check_from_model` over
        a dataset, :77-165)."""
        with open(instances_json_path) as f:
            data = json.load(f)
        return self.run(data[: limit or len(data)],
                        layout_save=layout_save, batch=batch)
