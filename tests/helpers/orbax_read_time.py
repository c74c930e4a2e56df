"""Read time of a full-width layout params dir: orbax against the port.

    python tests/helpers/orbax_read_time.py [DIR]      # DIR: where to write it (a temp dir)

JAX builds `LayoutConfig()` (RoBERTa-base, 50,265-token vocabulary) from
PRNGKey(0) and writes its params as `scripts/train_layout.py` writes
`best_params` (`ocp.StandardCheckpointer().save` of the numpy tree); then
`ocp.StandardCheckpointer().restore(path)` and the port's
`utils/orbax.restore(path)` each read it three times, in turns, and the
port's `utils/loader.load_layout_predictor` loads it once into the model on
the CPU.  Prints one JSON line: bytes on disk, parameter count, seconds per
read (each run and the median), and whether the two trees are equal bit
for bit.  Both readers run on this machine's CPU; the card's machine has
no orbax, so no card figure exists for the orbax side.
"""
from __future__ import annotations

import json
import os
import shutil
import statistics
import sys
import tempfile
import time


def main(argv=None):
    import jax

    jax.config.update("jax_platforms", "cpu")
    import numpy as np
    import orbax.checkpoint as ocp
    import torch

    from diffusion_spacetime_attn_tpu.config import LayoutConfig as JLayoutConfig
    from diffusion_spacetime_attn_tpu.models.layout.model import create_layout_predictor
    from diffusion_spacetime_attn_tpu_torch.config import LayoutConfig
    from diffusion_spacetime_attn_tpu_torch.utils import loader, orbax

    argv = sys.argv[1:] if argv is None else argv
    root = argv[0] if argv else tempfile.mkdtemp()
    path = os.path.join(root, "best_params")
    shutil.rmtree(path, ignore_errors=True)
    _, params = create_layout_predictor(JLayoutConfig(), jax.random.PRNGKey(0))
    params = jax.tree_util.tree_map(np.asarray, params)
    n_params = sum(a.size for a in jax.tree_util.tree_leaves(params))
    with ocp.StandardCheckpointer() as c:
        c.save(path, params)
    del params
    nbytes = sum(os.path.getsize(os.path.join(d, f)) for d, _, fs in os.walk(path) for f in fs)
    times = {"orbax": [], "port": []}
    for _ in range(3):
        for who in ("orbax", "port"):
            t0 = time.perf_counter()
            tree = (ocp.StandardCheckpointer().restore(path) if who == "orbax"
                    else orbax.restore(path))
            times[who].append(time.perf_counter() - t0)
            if who == "orbax":
                want = jax.tree_util.tree_map(np.asarray, tree)
            else:
                got = tree
            del tree
    same = all(np.array_equal(a, b) for a, b in zip(jax.tree_util.tree_leaves(want),
                                                    jax.tree_util.tree_leaves(got)))
    torch.set_num_threads(max(1, os.cpu_count() or 1))
    t0 = time.perf_counter()
    loader.load_layout_predictor(LayoutConfig(), path, device="cpu")
    load_s = time.perf_counter() - t0
    print(json.dumps({"what": "LayoutConfig() params dir, read on this machine's CPU",
                      "cpus": os.cpu_count(), "bytes_on_disk": nbytes, "parameters": int(n_params),
                      "orbax_restore_s": times["orbax"],
                      "orbax_restore_median_s": statistics.median(times["orbax"]),
                      "port_restore_s": times["port"],
                      "port_restore_median_s": statistics.median(times["port"]),
                      "port_load_layout_predictor_s": load_s, "equal_bits": bool(same)}))
    if not argv:
        shutil.rmtree(root, ignore_errors=True)


if __name__ == "__main__":
    main()
