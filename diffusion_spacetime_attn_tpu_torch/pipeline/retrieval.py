"""Retrieval for retrieval-augmented diffusion (knn2img); port of the JAX
package's `pipeline/retrieval.py` (the reference's scann `Searcher`,
`scripts/knn2img.py:61-166`, `scripts/train_searcher.py:62-113`).

The database is one [M, D] float32 tensor of L2-normalized embeddings on
one device (the card by default), and a search is exact: one f32
[B, D] x [D, M] product, then `torch.topk`.  A 1 M x 768 database is 3.07
GB; a batch of queries reads it once.  `sharded_search` (a database split
over several devices) and a `mesh` raise: one device (ROADMAP A.13).

The npz files are the JAX package's format (`embedding` [M, D], stored
normalized, `img_id` [M], `patch_coords` [M, 4]), so each package reads the
other's.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import numpy as np
import torch


def normalize(x: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    return x / (torch.linalg.vector_norm(x, dim=-1, keepdim=True) + eps)


def exact_search(db: torch.Tensor, queries: torch.Tensor, k: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Ground-truth top-k by cosine score: db [M, D] (normalized), queries
    [B, D] -> (scores [B, k] float32, indices [B, k] int64), scores
    descending."""
    sim = normalize(queries.float()) @ db.float().T
    return torch.topk(sim, k, dim=-1)


_ONE_DEVICE = ("the PyTorch port searches one device's database; a database split "
               "over a mesh is ROADMAP A.13")


def sharded_search(db, queries, k: int, mesh):
    raise NotImplementedError(f"sharded_search: {_ONE_DEVICE}")


@dataclasses.dataclass
class Retriever:
    """In-memory retrieval database (the reference `Searcher`)."""

    embedding: torch.Tensor           # [M, D] float32, L2-normalized, on its device
    img_id: np.ndarray                # [M]
    patch_coords: np.ndarray          # [M, 4]
    mesh: Optional[object] = None

    def __post_init__(self):
        if self.mesh is not None:
            raise NotImplementedError(f"Retriever(mesh=...): {_ONE_DEVICE}")

    @classmethod
    def from_npz(cls, path: str, mesh=None, device="cuda") -> "Retriever":
        """Read a database npz (normalizing it again, as JAX does) onto
        `device`."""
        d = np.load(path)
        emb = np.asarray(d["embedding"], np.float32)
        emb = emb / (np.linalg.norm(emb, axis=-1, keepdims=True) + 1e-8)
        return cls(
            embedding=torch.from_numpy(emb).to(device),
            img_id=np.asarray(d["img_id"]) if "img_id" in d else np.arange(len(emb)),
            patch_coords=(np.asarray(d["patch_coords"]) if "patch_coords" in d
                          else np.zeros((len(emb), 4), np.float32)),
            mesh=mesh,
        )

    def save_npz(self, path: str) -> None:
        np.savez(path, embedding=self.embedding.detach().float().cpu().numpy(),
                 img_id=self.img_id, patch_coords=self.patch_coords)

    def search(self, queries: torch.Tensor, k: int) -> dict:
        """queries [B, D] (or [B, 1, D]) -> the reference `Searcher.search`'s
        dict (`knn2img.py:135-161`), JAX's keys: neighbor embeddings
        [B, k, D] (normalized), their image ids and patch coords, scores,
        indices and the normalized queries."""
        if queries.dim() == 3:
            queries = queries[:, 0]
        queries = queries.to(self.embedding.device)
        scores, idx = exact_search(self.embedding, queries, k)
        idx_np = idx.cpu().numpy()
        return {
            "nn_embeddings": self.embedding[idx],
            "img_ids": self.img_id[idx_np],
            "patch_coords": self.patch_coords[idx_np],
            "scores": scores,
            "nns": idx,
            "q_embeddings": normalize(queries.float()),
        }


def build_database_from_images(
    images: np.ndarray,                                   # [M, H, W, 3] in [0, 1]
    embed: Callable[[torch.Tensor], torch.Tensor],        # pixels [B, H, W, 3] -> [B, D]
    batch: int = 64,
    img_ids: Optional[np.ndarray] = None,
    device="cuda",
) -> Retriever:
    """Embed an image collection into a database on `device`, `batch`
    images per call of `embed` (the port's `CLIP.encode_image` after
    `clip_normalize`); every entry is the whole image, patch coords
    (0, 0, W, H), as the JAX function writes them."""
    M = images.shape[0]
    out = []
    with torch.inference_mode():
        for s in range(0, M, batch):
            chunk = torch.from_numpy(np.asarray(images[s:s + batch], np.float32)).to(device)
            out.append(embed(chunk).float())
    emb = normalize(torch.cat(out, dim=0))
    H, W = images.shape[1:3]
    coords = np.tile(np.array([0, 0, W, H], np.float32), (M, 1))
    return Retriever(embedding=emb,
                     img_id=img_ids if img_ids is not None else np.arange(M),
                     patch_coords=coords)
