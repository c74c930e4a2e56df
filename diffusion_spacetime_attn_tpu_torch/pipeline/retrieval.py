"""Retrieval for retrieval-augmented diffusion (knn2img); port of the JAX
package's `pipeline/retrieval.py` (the reference's scann `Searcher`,
`scripts/knn2img.py:61-166`, `scripts/train_searcher.py:62-113`).

The database is one [M, D] float32 tensor of L2-normalized embeddings on
one device (the card by default), and a search is exact: one f32
[B, D] x [D, M] product, then `torch.topk`.  A 1 M x 768 database is 3.07
GB; a batch of queries reads it once.

Over a mesh (`Retriever(mesh=...)`, `sharded_search`; JAX
`retrieval.py:48-93`) each rank holds the rows of the database at its data
coordinate (`shard_database`: padded to a multiple of the data axis, the
pad rows scored −inf; the model ranks of a data group hold the same rows),
scores the queries against them, and keeps its top k with global indices;
the candidates of every data coordinate are all-gathered and their top k
is the global one, exact because every winner is its shard's winner.  A
shard of fewer than k rows takes the exact search over the gathered
database.  Every rank gets the result.

The npz files are the JAX package's format (`embedding` [M, D], stored
normalized, `img_id` [M], `patch_coords` [M, 4]), so each package reads the
other's.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from ..parallel.mesh import Mesh, check_mesh, gather_rows


def normalize(x: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    return x / (torch.linalg.vector_norm(x, dim=-1, keepdim=True) + eps)


def exact_search(db: torch.Tensor, queries: torch.Tensor, k: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Ground-truth top-k by cosine score: db [M, D] (normalized), queries
    [B, D] -> (scores [B, k] float32, indices [B, k] int64), scores
    descending."""
    sim = normalize(queries.float()) @ db.float().T
    return torch.topk(sim, k, dim=-1)


def shard_database(db: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The rows of db [M, D] at this rank's data coordinate, padded with
    zero rows to a multiple of the data axis (`sharded_search` masks
    them)."""
    n = mesh.data
    per = -(-db.shape[0] // n)
    part = db[mesh.data_index * per:(mesh.data_index + 1) * per]
    if part.shape[0] < per:
        part = torch.cat([part, part.new_zeros(per - part.shape[0], db.shape[1])])
    return part


def sharded_search(db_shard: torch.Tensor, queries: torch.Tensor, k: int, mesh: Mesh,
                   rows: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """`exact_search` over a database of `rows` rows split as
    `shard_database` splits it (db_shard: this rank's), queries replicated
    -> (scores [B, k], global indices [B, k]) on every rank."""
    check_mesh(mesh, "sharded_search")
    per = db_shard.shape[0]
    if rows // mesh.data < k:
        # shards too small to hold k candidates each: the exact search
        return exact_search(gather_rows(mesh, db_shard)[:rows], queries, k)
    sim = normalize(queries.float()) @ db_shard.float().T
    base = mesh.data_index * per
    glob = base + torch.arange(per, device=sim.device)
    sim = torch.where(glob[None, :] < rows, sim, torch.full_like(sim, -float("inf")))
    s, i = torch.topk(sim, k, dim=-1)
    s_all = gather_rows(mesh, s[None])                 # [ranks, B, k]
    i_all = gather_rows(mesh, (i + base)[None])
    s_all = s_all.permute(1, 0, 2).reshape(s.shape[0], -1)
    i_all = i_all.permute(1, 0, 2).reshape(s.shape[0], -1)
    s2, pos = torch.topk(s_all, k, dim=-1)
    return s2, torch.gather(i_all, 1, pos)


@dataclasses.dataclass
class Retriever:
    """In-memory retrieval database (the reference `Searcher`).  With a
    `mesh`, `embedding` is this rank's shard (`shard_database`) of a
    database of `rows` rows; `img_id` and `patch_coords` stay whole on the
    host."""

    embedding: torch.Tensor           # [M, D] float32, L2-normalized, on its device
    img_id: np.ndarray                # [M]
    patch_coords: np.ndarray          # [M, 4]
    mesh: Optional[Mesh] = None
    rows: Optional[int] = None        # the database's rows (the mesh's shards are padded)

    def __post_init__(self):
        self.mesh = check_mesh(self.mesh, "Retriever")
        if self.rows is None:
            self.rows = len(self.img_id)

    @classmethod
    def from_npz(cls, path: str, mesh=None, device="cuda") -> "Retriever":
        """Read a database npz (normalizing it again, as JAX does) onto
        `device`; with a mesh, each rank keeps its rows."""
        d = np.load(path)
        emb = np.asarray(d["embedding"], np.float32)
        emb = emb / (np.linalg.norm(emb, axis=-1, keepdims=True) + 1e-8)
        table = torch.from_numpy(emb)
        if mesh is not None:
            table = shard_database(table, check_mesh(mesh, "Retriever"))
        return cls(
            embedding=table.to(device),
            img_id=np.asarray(d["img_id"]) if "img_id" in d else np.arange(len(emb)),
            patch_coords=(np.asarray(d["patch_coords"]) if "patch_coords" in d
                          else np.zeros((len(emb), 4), np.float32)),
            mesh=mesh, rows=len(emb),
        )

    def _rows_of(self, idx: torch.Tensor) -> torch.Tensor:
        """The database rows at global indices idx [B, k] -> [B, k, D]: each
        rank fills the rows it holds, the rest zeros, and the sum over the
        data axis is exact (one term per row)."""
        import torch.distributed as dist

        per = self.embedding.shape[0]
        loc = idx - self.mesh.data_index * per
        mine = (loc >= 0) & (loc < per)
        out = self.embedding.new_zeros(*idx.shape, self.embedding.shape[1])
        out[mine] = self.embedding[loc[mine]]
        if self.mesh.data_group is not None:
            dist.all_reduce(out, group=self.mesh.data_group)
        return out

    def save_npz(self, path: str) -> None:
        """JAX's npz; with a mesh every rank calls it (the shards are
        gathered) and the mesh's writer writes."""
        emb = self.embedding if self.mesh is None else \
            gather_rows(self.mesh, self.embedding)[:self.rows]
        emb = emb.detach().float().cpu().numpy()
        if self.mesh is None or self.mesh.writer:
            np.savez(path, embedding=emb, img_id=self.img_id, patch_coords=self.patch_coords)

    def search(self, queries: torch.Tensor, k: int) -> dict:
        """queries [B, D] (or [B, 1, D]) -> the reference `Searcher.search`'s
        dict (`knn2img.py:135-161`), JAX's keys: neighbor embeddings
        [B, k, D] (normalized), their image ids and patch coords, scores,
        indices and the normalized queries.  With a mesh every rank calls
        it with the same queries and gets the whole result."""
        if queries.dim() == 3:
            queries = queries[:, 0]
        queries = queries.to(self.embedding.device)
        if self.mesh is not None:
            scores, idx = sharded_search(self.embedding, queries, k, self.mesh, self.rows)
            nn = self._rows_of(idx)
        else:
            scores, idx = exact_search(self.embedding, queries, k)
            nn = self.embedding[idx]
        idx_np = idx.cpu().numpy()
        return {
            "nn_embeddings": nn,
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
