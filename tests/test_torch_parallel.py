"""PyTorch port, the data mesh (`parallel/mesh.py`) and the pieces that split
their batch or database over it, on two gloo ranks on the CPU, held against
the JAX package's meshes where JAX computes the same function cheaply and
against the port's one-process result otherwise:

  * `shard_batch` / `gather_rows` / `replicate` (JAX `test_parallel.py:69`:
    each rank's rows are JAX's device shards of `shard_batch`);
  * `sharded_search` and `Retriever(mesh=)` (JAX `test_retrieval.py:36`):
    equal to `exact_search` exactly, indices and scores, on a database whose
    rows do not divide by the ranks, and the exact fallback when a shard
    holds fewer than k rows; JAX's `sharded_search` gives the same indices;
  * `TextToImageEngine(mesh=)` and `SpaceTimeEngine(mesh=)` (JAX
    `test_serving.py:279,306`): float32, within one uint8 level of the same
    engine in one process (which `test_torch_serving.py` holds against
    JAX's), and the ValueError for a batch of 3 over 2 ranks;
  * `BatchedRunner(mesh=)` (JAX `test_batch_runner.py:92`): rank 0 writes
    the file names JAX's runner writes, the one-process runner's images
    within one uint8 level.

The ranks (`tests/helpers/torch_ranks.py`) are spawned once for the module.
Sizes: a 100 x 16 database, 3 queries; the serving smoke config of
`test_torch_serving.py` (UNet 32 channels, 16² latents, 32² images, CLIP
text width 16 at CLIP's vocabulary), seeded N(0, 0.2²) weights, DDIM-3
(serving) and PLMS-2 with 2 epochs (the method).  Torch takes one thread
in each process.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from helpers.torch_ranks import Ranks

from diffusion_spacetime_attn_tpu.parallel.mesh import make_mesh as jmake_mesh
from diffusion_spacetime_attn_tpu.parallel.mesh import shard_batch as jshard_batch
from diffusion_spacetime_attn_tpu.pipeline import retrieval as jret
from diffusion_spacetime_attn_tpu_torch import config as C
from diffusion_spacetime_attn_tpu_torch.parallel import mesh as tmesh
from diffusion_spacetime_attn_tpu_torch.pipeline import retrieval as tret
from diffusion_spacetime_attn_tpu_torch.utils.png import read_png

CASES = ["mesh_basics", "search", "engine_t2i", "engine_spacetime", "batch_runner"]
SWEEP = ["a dog to the left of a cat", "a car above a bench", "no objects here at all",
         "the bird sits on a chair", "a cup next to a laptop"]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def smoke_cfg(num_steps: int, epochs: int = 3) -> C.PipelineConfig:
    """`test_torch_serving.py`'s smoke config, in the port's classes."""
    text = C.CLIPTextConfig(width=16, layers=2, heads=2, vocab_size=49408, max_len=7)
    return C.PipelineConfig(
        unet=C.UNetConfig(model_channels=32, channel_mult=(1, 2), num_res_blocks=1,
                          attention_resolutions=(1, 2), num_heads=2, context_dim=16),
        vae=C.VAEConfig(ch=32, ch_mult=(1, 2), num_res_blocks=1),
        text_encoder=text,
        loss_clip=C.CLIPConfig(vision=C.CLIPVisionConfig(image_size=14, patch_size=7, width=16,
                                                         layers=2, heads=2, projection_dim=8),
                               text=text, projection_dim=8),
        spacetime=C.SpaceTimeConfig(num_steps=num_steps, latent_size=16, image_size=32,
                                    epochs=epochs))


def database(m=100, d=16):
    x = np.random.RandomState(0).randn(m, d).astype(np.float32)
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("ranks"))
    db = database()
    q = np.random.RandomState(2).randn(3, 16).astype(np.float32)
    np.savez(os.path.join(d, "db.npz"), embedding=db, img_id=np.arange(100) * 3,
             patch_coords=np.random.RandomState(3).rand(100, 4).astype(np.float32))
    inputs = {"basics": {"x": np.arange(12, dtype=np.float32).reshape(4, 3)},
              "search": {"db": db, "q": q},
              "t2i": {"cfg": smoke_cfg(3), "sampler": "ddim", "prompts": ["a cat", "a dog"],
                      "seeds": [3, 2 ** 31 + 5]},
              "spacetime": {"cfg": smoke_cfg(2, epochs=2),
                            "prompts": ["a dog to the left of a cat", "no objects"],
                            "seeds": [1, 7], "sweep": SWEEP}}
    torch.save(inputs, os.path.join(d, "inputs.pt"))
    r = Ranks(d, CASES)
    return d, inputs, r


def outs(ranks, name):
    o = ranks[2].join()
    return o[0][name], o[1][name]


def within_one_level(got, want):
    assert got.shape == want.shape and got.dtype == want.dtype == np.uint8
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1


def test_shard_batch_gather_rows_and_replicate_match_jax_data_axis(ranks):
    """Each rank's rows of a [4, 3] leaf are JAX's device shards on the data
    axis; a leaf that does not divide raises ValueError (JAX cannot place
    it); gather_rows restores the global batch; replicate broadcasts rank
    0's tensors and a module's weights."""
    _, inputs, _ = ranks
    x = inputs["basics"]["x"]
    jm = jmake_mesh(data=2, devices=jax.devices()[:2])
    shards = jshard_batch(jm, {"a": jnp.asarray(x)})["a"].addressable_shards
    want = {s.device: np.asarray(s.data) for s in shards}
    for r, o in enumerate(outs(ranks, "mesh_basics")):
        np.testing.assert_array_equal(o["a"].numpy(), want[jax.devices()[r]])
        assert o["rows"] == slice(2 * r, 2 * r + 2) and o["b_shape"] == (2, 3) and o["c"] is None
        np.testing.assert_array_equal(o["gathered"].numpy(), x)
        assert o["odd_batch"].startswith("ValueError")
        assert torch.equal(o["replicated"], torch.ones(3))
        assert torch.equal(o["module_weight"], torch.zeros(2, 2))


def test_make_mesh_refuses_the_model_axis_and_a_missing_rendezvous(ranks, monkeypatch):
    """The model axis, refused until it was ported, is a mesh axis: on the
    two ranks make_mesh(data=1, model=2) puts rank m at (0, m), rank 0
    writes, every rank holds the whole batch, and its model group sums;
    check_mesh takes a mesh with model > 1.  With no process group and no
    torchrun environment make_mesh raises instead of running on one
    process, model axis or not; the backend is the caller's."""
    x = ranks[1]["basics"]["x"]
    for r, o in enumerate(outs(ranks, "mesh_basics")):
        m = o["model_axis"]
        assert m["coords"] == (r, 0, r) and m["writer"] == (r == 0)
        assert m["rows"] == slice(0, 4)
        np.testing.assert_array_equal(m["gathered"].numpy(), x[2 * r:2 * r + 2])
        assert torch.equal(m["model_sum"], torch.full((2,), 3.0))
    tp = tmesh.Mesh(data=1, model=2)
    assert tmesh.check_mesh(tp, "x") is tp and tp.devices == 2
    for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    with pytest.raises(RuntimeError, match="rendezvous"):
        tmesh.make_mesh(data=1, model=2, backend="gloo")
    with pytest.raises(ValueError, match="backend"):
        tmesh.make_mesh(backend="mpi")
    for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    with pytest.raises(RuntimeError, match="rendezvous"):
        tmesh.make_mesh(backend="gloo")
    assert tmesh.mesh_from_env("gloo", cpu=True) is None      # one process: no mesh
    with pytest.raises(TypeError):
        tmesh.check_mesh(object(), "x")


def test_sharded_search_equals_exact_search(ranks):
    """100 rows over 2 ranks (and 5 at k 60 > 50 rows per shard: the exact
    search): the same indices and the same scores, bit for bit, as the
    one-device exact search, on both ranks; JAX's sharded_search gives the
    same indices."""
    _, inputs, _ = ranks
    db, q = inputs["search"]["db"], inputs["search"]["q"]
    for o in outs(ranks, "search"):
        for k in (5, 60):
            s, i = o[k]
            s0, i0 = tret.exact_search(torch.from_numpy(db), torch.from_numpy(q), k)
            assert torch.equal(i, i0) and torch.equal(s, s0), k
    js, ji = jret.sharded_search(jnp.asarray(db), jnp.asarray(q), k=5,
                                 mesh=jmake_mesh(data=2, devices=jax.devices()[:2]))
    np.testing.assert_array_equal(outs(ranks, "search")[0][5][1].numpy(), np.asarray(ji))
    np.testing.assert_allclose(outs(ranks, "search")[0][5][0].numpy(), np.asarray(js),
                               rtol=1e-5)


def test_retriever_over_mesh_equals_one_device(ranks):
    """Retriever.from_npz(mesh=) keeps 50 rows per rank and its search dict
    (neighbour embeddings, ids, coordinates, scores) equals the one-device
    Retriever's exactly."""
    d, inputs, _ = ranks
    one = tret.Retriever.from_npz(os.path.join(d, "db.npz"), device="cpu").search(
        torch.from_numpy(inputs["search"]["q"]), 4)
    for o in outs(ranks, "search"):
        assert o["shard_rows"] == 50
        got = o["retriever"]
        assert set(got) == set(one)
        for k in ("nn_embeddings", "scores", "nns", "q_embeddings"):
            assert torch.equal(got[k], one[k]), k
        for k in ("img_ids", "patch_coords"):
            np.testing.assert_array_equal(got[k], one[k])


def test_text_to_image_engine_over_mesh_matches_one_process(ranks):
    """A batch of 2 over 2 ranks (one row each) and a short batch of 1
    (padded), float32: every rank gets both images, within one uint8 level
    of the one-process engine; batch 3 over 2 ranks raises ValueError, as
    JAX's engine does."""
    a, b = outs(ranks, "engine_t2i")
    assert a["mesh"].shape == (2, 32, 32, 3)
    within_one_level(a["mesh"], a["one"])
    within_one_level(a["short"], a["one"][:1])
    np.testing.assert_array_equal(a["mesh"], b["mesh"])
    assert a["batch3"].startswith("ValueError") and b["batch3"].startswith("ValueError")


def test_spacetime_engine_over_mesh_matches_one_process(ranks):
    """The method (PLMS-2, 2 epochs; the weight optimization per rank on its
    row, the second prompt without objects) within one uint8 level of the
    one-process engine."""
    a, b = outs(ranks, "engine_spacetime")
    within_one_level(a["mesh"], a["one"])
    np.testing.assert_array_equal(a["mesh"], b["mesh"])
    assert a["mesh"].std() > 0


def test_batched_runner_over_mesh_writes_jax_names(ranks):
    """The sweep at batch 2 over 2 ranks in spacetime mode: rank 0 writes
    JAX's names (`final{epochs-1}_s{seed}_index_{i}.png`, the prompt
    without objects skipped), the chunks reported on rank 0 only, every
    image within one uint8 level of the one-process runner's."""
    d, _, _ = ranks
    a, b = outs(ranks, "batch_runner")
    assert a["produced"] == b["produced"] == a["one_produced"] == 4
    assert a["chunks"] == [[0, 1], [2, 3], [4]] and b["chunks"] == []
    names = sorted(os.listdir(os.path.join(d, "mesh_run")))
    assert names == sorted(os.listdir(os.path.join(d, "one_run"))) == [
        f"final1_s1_index_{i}.png" for i in (0, 1, 3, 4)]
    for n in names:
        within_one_level(read_png(os.path.join(d, "mesh_run", n)),
                         read_png(os.path.join(d, "one_run", n)))


def test_bench_train_on_a_one_rank_mesh_equals_one_device():
    """`bench_train --what ldm --mesh dp|fsdp` on a one-rank gloo group made
    in process: the losses of its steps equal the one-device run's (rtol
    1e-6), and `--profile` lists the optimizer's step among the entries."""
    from diffusion_spacetime_attn_tpu_torch.scripts import bench_train

    argv = ["--what", "ldm", "--tiny", "--cpu", "--dtype", "float32", "--batch-size", "1",
            "--iters", "1"]
    one = bench_train.main(argv)
    for mode, profile in (("dp", []), ("fsdp", ["--profile"])):
        got = bench_train.main(argv + ["--mesh", mode] + profile)
        assert (got["mesh"], got["ranks"], got["backend"]) == (mode, 1, "gloo")
        np.testing.assert_allclose(got["losses"], one["losses"], rtol=1e-6)
        assert not torch.distributed.is_initialized()
    assert any(r["name"].startswith("Optimizer.step") for r in got["profile"])
