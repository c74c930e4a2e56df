"""PyTorch port, the batched runner and the sweep entry point held against the
JAX package on the CPU: `BatchedRunner` (JAX's without a mesh, and the
port's own sequential runner) in the spatial and spacetime modes, and
`run_dataset --tiny --cpu` against JAX's `scripts/run_dataset.py` (file
names, manifest, `--resume`).

The runners, weights and tolerances are those of
`tests/test_torch_runners.py`, whose fixture builds them.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
from test_torch_loader import checkpoint_flag_file
from test_torch_runners import PROMPTS, one_torch_thread, pngs, pngs_close, runners  # noqa: F401

from diffusion_spacetime_attn_tpu.pipeline.batch_runner import BatchedRunner as JBatchedRunner
from diffusion_spacetime_attn_tpu_torch.pipeline.batch_runner import BatchedRunner
from diffusion_spacetime_attn_tpu_torch.scripts import run_dataset
from diffusion_spacetime_attn_tpu_torch.utils.png import read_png

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("mode", ["spatial", "spacetime"])
def test_batched_runner_matches_jax_and_sequential(runners, mode):
    """BatchedRunner at batch 2 over all five prompts (a skipped prompt
    and a padded tail): the same files as JAX's runner without a mesh, the
    same pixels, the chunks reported after their images are written, and
    each image as the port's sequential runner draws it alone."""
    j, t = runners[mode]
    j.outdir, t.outdir = j.outdir + "_batched", t.outdir + "_batched"
    assert JBatchedRunner(j, batch_size=2).run(PROMPTS, seed=1) == 4
    chunks = []

    def on_chunk_done(chunk):
        chunks.append((chunk, pngs(t.outdir)))

    assert BatchedRunner(t, batch_size=2).run(PROMPTS, seed=1, on_chunk_done=on_chunk_done) == 4
    assert [c for c, _ in chunks] == [[0, 1], [2, 3], [4]]
    assert "final1_s1_index_3.png" in chunks[1][1] and "final1_s1_index_4.png" not in chunks[1][1]
    names = pngs(t.outdir)
    assert names == pngs(j.outdir)
    assert [n for n in names if n.startswith("final1")] == [
        f"final1_s1_index_{i}.png" for i in (0, 1, 3, 4)]
    for n in names:
        pngs_close(os.path.join(t.outdir, n), os.path.join(j.outdir, n))
    batched = read_png(os.path.join(t.outdir, "final1_s1_index_4.png")).astype(int)
    t.outdir = t.outdir + "_sequential"
    alone = t.run_one(PROMPTS[4], 4, seed=1)
    seq = (alone * 255.0).clip(0, 255).astype(np.uint8).astype(int)
    diff = np.abs(batched - seq)
    assert diff.max() <= 1 and (diff > 0).mean() <= 1e-3


def test_run_dataset_tiny_cpu_matches_jax_script(tmp_path, capsys, monkeypatch):
    """run_dataset --tiny --cpu (vanilla, batch 2) writes the names and the
    manifest JAX's script writes; --resume then produces nothing."""
    data = tmp_path / "data"
    data.mkdir()
    (data / "mscoco.txt").write_text("\n".join(PROMPTS) + "\n")
    args = ["--dataset", "mscoco", "--data-root", str(data), "--mode", "vanilla", "--tiny",
            "--cpu", "--steps", "1", "--batch-size", "2"]
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "scripts/run_dataset.py", *args, "--outdir",
                        str(tmp_path / "jax")], capture_output=True, text=True, timeout=600,
                       cwd=REPO, env=env)
    assert r.returncode == 0, r.stderr[-3000:]
    summary = run_dataset.main(args + ["--outdir", str(tmp_path / "port")])
    assert summary["produced"] == 4 and summary["done"] == [0, 1, 2, 3, 4]
    assert pngs(tmp_path / "port") == pngs(tmp_path / "jax") == [
        f"final1_s1_index_{i}.png" for i in (0, 1, 3, 4)]
    for name in ("manifest_mscoco.json",):
        assert (json.loads((tmp_path / "port" / name).read_text())
                == json.loads((tmp_path / "jax" / name).read_text()) == {"done": [0, 1, 2, 3, 4]})
    events = [json.loads(ln)["event"] for ln in
              (tmp_path / "port" / "run_log.jsonl").read_text().splitlines()]
    assert events == ["batch_done"] * 3 + ["sweep_done"]
    capsys.readouterr()
    again = run_dataset.main(args + ["--outdir", str(tmp_path / "port"), "--resume"])
    assert again["produced"] == 0
    assert "resuming: 5 prompts already complete" in capsys.readouterr().out
    # each checkpoint flag reads its file (until the loaders were ported it
    # raised): a missing path raises naming it; a small real file is what
    # the sweep's loader returns (spacetime mode, which loads the loss CLIP)
    for flag in ("--ckpt", "--clip-ckpt", "--clip-vocab"):
        d = tmp_path / flag.strip("-")
        d.mkdir()
        path, name, check = checkpoint_flag_file(flag, d)
        spacetime = args + ["--mode", "spacetime", "--end", "1", "--outdir", str(d)]
        with pytest.raises(FileNotFoundError, match="gone.bin"):
            run_dataset.main(spacetime + [flag, str(d / "gone.bin")])
        seen, real = [], getattr(run_dataset, name)

        def spy(*a, real=real, **k):
            seen.append(real(*a, **k))
            return seen[-1]

        monkeypatch.setattr(run_dataset, name, spy)
        again = run_dataset.main(spacetime + [flag, path])
        monkeypatch.undo()
        assert again["produced"] == 1 and seen and all(check(obj) for obj in seen), flag
