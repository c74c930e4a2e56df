"""Two-rank bodies of the port's multi-device tests, and their launcher.

JAX-free: a spawned rank imports torch, numpy and the port only.  A test
writes its inputs (numpy arrays, port configs, state dicts) with
`torch.save` to `<dir>/inputs.pt`, then `Ranks(dir, cases)` starts one
process per rank and `join()` waits for them:

    python tests/helpers/torch_ranks.py DIR RANK WORLD [--model=M] CASE [CASE ...]

Each rank joins a gloo group through a `FileStore` in DIR (no port to
clash with under pytest-xdist), runs the named cases in order over one
`parallel.mesh.Mesh` (WORLD/M x M, model 1 by default) and writes
`{case: result}` to `<dir>/out<RANK>.pt`.
Torch runs one thread per rank.  A collective times out after
`COLLECTIVE_S` seconds and the launcher kills both ranks after its own
timeout, so a hung collective fails its test.
"""
from __future__ import annotations

import os
import subprocess
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
COLLECTIVE_S = 90.0


class Ranks:
    """`world` gloo ranks running `cases` over the inputs in `d`, started at
    once; `join()` waits (the parent may compute meanwhile) and returns each
    rank's {case: result}, or fails with the ranks' output when a rank exits
    non-zero or the join times out."""

    def __init__(self, d: str, cases, world: int = 2, timeout_s: float = 240.0,
                 model: int = 1):
        env = dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1",
                   PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
        for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
            env.pop(k, None)
        self.d, self.world = d, world
        self.deadline = time.monotonic() + timeout_s
        self.logs = [open(os.path.join(d, f"rank{r}.log"), "w+") for r in range(world)]
        self.procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), d, str(r),
                                        str(world), f"--model={model}", *cases],
                                       stdout=self.logs[r],
                                       stderr=subprocess.STDOUT, env=env, cwd=REPO)
                      for r in range(world)]
        self.outs = None

    def join(self) -> list:
        if self.outs is not None:
            return self.outs
        try:
            for p in self.procs:
                p.wait(timeout=max(1.0, self.deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            pass
        finally:
            for p in self.procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        bad = [r for r, p in enumerate(self.procs) if p.returncode != 0]
        tails = []
        for r, f in enumerate(self.logs):
            f.seek(0)
            if r in bad:
                tails.append(f"--- rank {r} (exit {self.procs[r].returncode}):\n"
                             f"{f.read()[-4000:]}")
            f.close()
        if bad:
            raise AssertionError("ranks failed or hung:\n" + "\n".join(tails))
        self.outs = [torch.load(os.path.join(self.d, f"out{r}.pt"), weights_only=False)
                     for r in range(self.world)]
        return self.outs


# ----------------------------------------------------------------- cases

CASES = {}


def case(fn):
    CASES[fn.__name__] = fn
    return fn


def _tensor(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _whole(module) -> dict:
    from diffusion_spacetime_attn_tpu_torch.parallel.sharding import full_tree

    return {k: v.detach().clone() for k, v in full_tree(module.state_dict()).items()}


def _grads(module) -> dict:
    from diffusion_spacetime_attn_tpu_torch.parallel.sharding import full

    return {k: full(p.grad).clone() for k, p in module.named_parameters() if p.grad is not None}


class ClassToy(torch.nn.Module):
    """`test_ldm_training.py`'s class-conditional eps model: x·w + each
    row's mean of the jointly trained class embedding of its class id."""

    def __init__(self, classes: int, dim: int):
        from diffusion_spacetime_attn_tpu_torch.models.encoders import ClassEmbedder

        super().__init__()
        self.w = torch.nn.Parameter(torch.ones(()))
        self.cond = ClassEmbedder(classes, dim)

    def forward(self, x, t, c):
        emb = self.cond(c[:, 0]).reshape(x.shape[0], -1)
        return x * self.w + emb.mean(-1)[:, None, None, None]


class VecToy(ClassToy):
    """ClassToy whose scale is a [1] vector (FSDP shards no scalar)."""

    def __init__(self, classes: int, dim: int):
        super().__init__(classes, dim)
        self.w = torch.nn.Parameter(torch.ones(1))


def _ldm_model(a):
    from diffusion_spacetime_attn_tpu_torch.models.unet import UNet

    toy = VecToy if a.get("vector") else ClassToy
    model = toy(*a["classes"]) if a.get("classes") else UNet(a["unet_cfg"], radius=0.2)
    model.load_state_dict(a["state"])
    return model


def _ldm_trainer(a, model, mesh, fsdp, ckpt_dir=None):
    from diffusion_spacetime_attn_tpu_torch.config import ScheduleConfig
    from diffusion_spacetime_attn_tpu_torch.ops.schedule import make_schedule
    from diffusion_spacetime_attn_tpu_torch.training.ldm_trainer import LDMTrainer

    return LDMTrainer(a["cfg"], ScheduleConfig(), make_schedule(ScheduleConfig(), 50), model,
                      mesh=mesh, ckpt_dir=ckpt_dir, fsdp=fsdp)


def _ldm_step(mesh, a, fsdp, ckpt_dir=None):
    """(result, trainer, state) of one step over the mesh: the loss, the
    reduced gradients (whole), the updated weights and EMA (whole)."""
    from diffusion_spacetime_attn_tpu_torch.parallel.mesh import shard_batch
    from diffusion_spacetime_attn_tpu_torch.parallel.sharding import full_tree

    model = _ldm_model(a)
    tr = _ldm_trainer(a, model, mesh, fsdp, ckpt_dir)
    state = tr.init()
    x0, ctx = shard_batch(mesh, (_tensor(a["x0"]), _tensor(a["ctx"])))
    key = np.asarray(a["key"], np.uint32)
    _, gm = tr.gradients(state, x0, ctx, key)
    out = {"grad_loss": float(gm["loss"]), "grads": _grads(model)}
    state, m = tr.train_step(state, x0, ctx, key)
    out.update(loss=float(m["loss"]), metrics={k: float(v) for k, v in m.items()},
               params=_whole(model), lr=tr.lr, rows=int(x0.shape[0]),
               ema=None if state.ema_params is None else
               {k: v.clone() for k, v in full_tree(state.ema_params).items()})
    return out, tr, state


@case
def ldm_dp(mesh, inputs, d):
    return _ldm_step(mesh, inputs["ldm_dp"], fsdp=False)[0]


@case
def ldm_class(mesh, inputs, d):
    return _ldm_step(mesh, inputs["ldm_class"], fsdp=False)[0]


@case
def ldm_fsdp(mesh, inputs, d):
    """The FSDP step; the per-rank state bytes against the replicated
    state's; a checkpoint saved over the ranks restored into a fresh sharded
    state, and the one-device checkpoint in `<d>/one` restored onto the
    ranks."""
    from diffusion_spacetime_attn_tpu_torch.parallel.sharding import (
        full,
        is_sharded,
        local,
        moments,
        state_bytes,
    )

    a = inputs["ldm_fsdp"]
    out, tr, state = _ldm_step(mesh, a, fsdp=True, ckpt_dir=os.path.join(d, "mesh"))
    params = list(state.params.parameters())
    opt = state.opt_state
    pairs = moments(opt.adamw, opt.params, opt.views)
    moms = [t for _, t in pairs]
    ema = list(state.ema_params.values())
    out["state_bytes"] = state_bytes(params + moms + ema)
    # a moment is whole where its parameter is
    out["replicated_bytes"] = sum(t.numel() * t.element_size()
                                  for t in params + [p for p, _ in pairs] + ema)
    out["sharded"] = sum(is_sharded(p) for p in params)
    out["n_params"] = len(params)
    tr.save(state, 1)
    fresh = _ldm_trainer(a, _ldm_model(a), mesh, True, os.path.join(d, "mesh"))
    back = fresh.restore(1, fresh.init())
    same = all(torch.equal(local(p), local(q)) for p, q in
               zip(state.params.parameters(), back.params.parameters()))
    same &= all(torch.equal(local(state.ema_params[k]), local(back.ema_params[k]))
                for k in state.ema_params)
    mine = [t for st in back.opt_state.adamw.state.values() for t in st.values()
            if torch.is_tensor(t) and t.dim() > 0]
    same &= len(mine) == len(moms) and all(torch.equal(local(p), local(q))
                                           for p, q in zip(moms, mine))
    out["restored_equal"] = bool(same) and back.step == state.step
    one = _ldm_trainer(a, _ldm_model(a), mesh, True, os.path.join(d, "one"))
    onto = one.restore(1, one.init())
    ck = torch.load(os.path.join(d, "one", "step_1.pt"), weights_only=True)
    out["one_device_onto_ranks"] = (
        all(torch.equal(full(p), ck["params"][k]) for k, p in onto.params.named_parameters())
        and all(torch.equal(full(v), ck["ema"][k]) for k, v in onto.ema_params.items())
        and onto.step == ck["step"] and onto.opt_state.count == ck["opt"]["count"])
    return out


def _vae_step(mesh, a, fsdp):
    from diffusion_spacetime_attn_tpu_torch.models.vae import AutoencoderKL
    from diffusion_spacetime_attn_tpu_torch.parallel.mesh import shard_batch
    from diffusion_spacetime_attn_tpu_torch.parallel.sharding import is_sharded, load_full_
    from diffusion_spacetime_attn_tpu_torch.training.vae_trainer import VAETrainer

    vae = AutoencoderKL(a["vae_cfg"])
    tr = VAETrainer(vae, a["cfg"], mesh=mesh, fsdp=fsdp)
    state = tr.init(seed=0)
    load_full_(vae, a["ae"])
    load_full_(tr.disc, a["disc"])
    metrics = []
    for i, x in enumerate(a["images"]):
        state, m = tr.train_step(state, shard_batch(mesh, _tensor(x)),
                                 np.asarray(a["keys"][i], np.uint32))
        metrics.append({k: float(v) for k, v in m.items()})
    return {"metrics": metrics, "ae": _whole(vae), "disc": _whole(tr.disc),
            "logvar": float(state.logvar),
            "sharded": sum(is_sharded(p) for p in vae.parameters())}


@case
def vae_dp(mesh, inputs, d):
    return _vae_step(mesh, inputs["vae"], fsdp=False)


@case
def vae_fsdp(mesh, inputs, d):
    return _vae_step(mesh, inputs["vae"], fsdp=True)


def _layout_step(mesh, a, fsdp):
    from diffusion_spacetime_attn_tpu_torch.models.layout.model import LayoutPredictor
    from diffusion_spacetime_attn_tpu_torch.parallel.mesh import shard_batch
    from diffusion_spacetime_attn_tpu_torch.parallel.sharding import is_sharded, local, moments
    from diffusion_spacetime_attn_tpu_torch.training.layout_trainer import LayoutTrainer
    from diffusion_spacetime_attn_tpu_torch.training.losses import LayoutBatch

    model = LayoutPredictor(a["cfg"])
    model.load_state_dict(a["state"])
    tr = LayoutTrainer.create(a["cfg"], a["train_cfg"], mesh=mesh, fsdp=fsdp)
    opt = tr.init_state(model)
    losses = []
    for b in a["batches"]:
        model, opt, loss, m = tr.train_step(model, opt, shard_batch(mesh, LayoutBatch(*b)))
        losses.append({"loss": float(loss), **{k: float(v) for k, v in m.items()}})
    pairs = moments(opt.adam, opt.params, opt.views)
    return {"losses": losses, "params": _whole(model), "count": opt.count,
            "sharded_moments": sum(is_sharded(p) and t.shape == local(p).shape
                                   for p, t in pairs),
            "n_moments": len(pairs)}


@case
def layout_dp(mesh, inputs, d):
    return _layout_step(mesh, inputs["layout"], fsdp=False)


@case
def layout_fsdp(mesh, inputs, d):
    return _layout_step(mesh, inputs["layout"], fsdp=True)


@case
def mesh_basics(mesh, inputs, d):
    """shard_batch / gather_rows / replicate / rows over the ranks."""
    from diffusion_spacetime_attn_tpu_torch.parallel.mesh import (
        gather_rows,
        replicate,
        rows,
        shard_batch,
    )

    a = inputs["basics"]
    tree = {"a": _tensor(a["x"]), "b": torch.ones(4, 3), "c": None}
    mine = shard_batch(mesh, tree)
    out = {"rows": rows(mesh, 4), "a": mine["a"].clone(), "b_shape": tuple(mine["b"].shape),
           "c": mine["c"], "gathered": gather_rows(mesh, mine["a"]).clone()}
    t = torch.full((3,), float(mesh.rank + 1))
    lin = torch.nn.Linear(2, 2)
    torch.nn.init.constant_(lin.weight, float(mesh.rank))
    replicate(mesh, [t])
    replicate(mesh, lin)
    out["replicated"] = t.clone()
    out["module_weight"] = lin.weight.detach().clone()
    try:
        rows(mesh, 3)
        out["odd_batch"] = "no error"
    except ValueError as e:
        out["odd_batch"] = f"ValueError: {e}"
    # the same ranks as a (1, 2) mesh: the model axis
    from diffusion_spacetime_attn_tpu_torch.parallel.mesh import make_mesh
    from diffusion_spacetime_attn_tpu_torch.parallel.tensor import ModelSplit, reduce_from_model

    m = make_mesh(data=1, model=2, backend="gloo", device="cpu")
    y = reduce_from_model(torch.full((2,), float(m.model_index + 1)),
                          ModelSplit(m.model_group, m.model, m.model_index))
    out["model_axis"] = {"coords": (m.rank, m.data_index, m.model_index), "writer": m.writer,
                         "rows": rows(m, 4), "gathered": gather_rows(m, mine["a"]).clone(),
                         "model_sum": y.clone()}
    return out


@case
def search(mesh, inputs, d):
    """sharded_search over the ranks' shards, the exact-search fallback,
    and a Retriever read from an npz onto the mesh."""
    from diffusion_spacetime_attn_tpu_torch.pipeline.retrieval import (
        Retriever,
        shard_database,
        sharded_search,
    )

    a = inputs["search"]
    db, q = _tensor(a["db"]), _tensor(a["q"])
    out = {}
    for k in (5, 60):                     # 60 > 100 / 2 rows per shard: the exact search
        s, i = sharded_search(shard_database(db, mesh), q, k, mesh, db.shape[0])
        out[k] = (s, i)
    r = Retriever.from_npz(os.path.join(d, "db.npz"), mesh=mesh, device="cpu")
    out["shard_rows"] = int(r.embedding.shape[0])
    out["retriever"] = r.search(q, 4)
    return out


def _smoke_sd(a):
    """The bundle at a["cfg"] with seeded N(0, 0.2²) weights, equal on
    every rank."""
    from diffusion_spacetime_attn_tpu_torch.pipeline.pipeline import StableDiffusion

    return StableDiffusion.create(a["cfg"], seed=0, device="cpu", scale=0.2)


def _clip_tokenize(L):
    from diffusion_spacetime_attn_tpu_torch.utils.tokenizer import make_clip_tokenizer

    tok = make_clip_tokenizer(max_len=L)
    return lambda t: tok.pad_to(tok.encode(t), L)


@case
def engine_t2i(mesh, inputs, d):
    """TextToImageEngine over the mesh at batch 2 (one row per rank);
    rank 0 also runs it without a mesh; batch 3 raises."""
    from diffusion_spacetime_attn_tpu_torch.serving.server import TextToImageEngine

    a = inputs["t2i"]
    sd = _smoke_sd(a)
    tok = _clip_tokenize(a["cfg"].text_encoder.max_len)
    eng = TextToImageEngine(sd=sd, tokenize=tok, batch_size=2, sampler=a["sampler"], mesh=mesh)
    out = {"mesh": eng.generate_batch(a["prompts"], a["seeds"]),
           "short": eng.generate_batch(a["prompts"][:1], a["seeds"][:1])}
    if mesh.rank == 0:
        one = TextToImageEngine(sd=sd, tokenize=tok, batch_size=2, sampler=a["sampler"])
        out["one"] = one.generate_batch(a["prompts"], a["seeds"])
    try:
        TextToImageEngine(sd=sd, tokenize=tok, batch_size=3, sampler=a["sampler"], mesh=mesh)
        out["batch3"] = "no error"
    except ValueError as e:
        out["batch3"] = f"ValueError: {e}"
    return out


def _spacetime_runner(a, outdir=None):
    from diffusion_spacetime_attn_tpu_torch.pipeline.frontend import extract_objects
    from diffusion_spacetime_attn_tpu_torch.pipeline.losses import DCLIPLoss
    from diffusion_spacetime_attn_tpu_torch.pipeline.runners import PromptRunner

    cfg = a["cfg"]
    sd = _smoke_sd(a)
    loss = DCLIPLoss.create(cfg.loss_clip, seed=9, device="cpu", scale=0.2)
    tok = _clip_tokenize(cfg.text_encoder.max_len)
    xs = (0.25, 0.75, 0.5, 0.4)

    def layout(prompt):
        return {m.phrase: (xs[i % 4], 0.5) for i, m in enumerate(extract_objects(prompt)[1])}

    return PromptRunner(sd=sd, clip_loss=loss, layout=layout, clip_tokenize=tok,
                        text_tokenize=tok, cfg=cfg.spacetime, outdir=outdir, mode="spacetime")


@case
def engine_spacetime(mesh, inputs, d):
    """SpaceTimeEngine over the mesh at batch 2; rank 0 also without."""
    from diffusion_spacetime_attn_tpu_torch.serving.server import SpaceTimeEngine

    a = inputs["spacetime"]
    runner = _spacetime_runner(a)
    eng = SpaceTimeEngine(runner=runner, batch_size=2, mesh=mesh)
    out = {"mesh": eng.generate_batch(a["prompts"], a["seeds"])}
    if mesh.rank == 0:
        out["one"] = SpaceTimeEngine(runner=runner, batch_size=2).generate_batch(
            a["prompts"], a["seeds"])
    return out


@case
def batch_runner(mesh, inputs, d):
    """BatchedRunner over the mesh (batch 2, spacetime mode) into
    `<d>/mesh_run`; rank 0 also without a mesh into `<d>/one_run`."""
    from diffusion_spacetime_attn_tpu_torch.pipeline.batch_runner import BatchedRunner

    a = inputs["spacetime"]
    chunks = []
    runner = _spacetime_runner(a, os.path.join(d, "mesh_run"))
    if mesh.rank == 0:
        os.makedirs(runner.outdir, exist_ok=True)
    out = {"produced": BatchedRunner(runner, batch_size=2, mesh=mesh).run(
        a["sweep"], seed=1, on_chunk_done=chunks.append), "chunks": chunks}
    if mesh.rank == 0:
        one = _spacetime_runner(a, os.path.join(d, "one_run"))
        os.makedirs(one.outdir, exist_ok=True)
        out["one_produced"] = BatchedRunner(one, batch_size=2).run(a["sweep"], seed=1)
    return out


@case
def scripts(mesh, inputs, d):
    """`train_ldm --data-dir` (text) and `train_vae --data-dir` as under
    `torchrun --nproc-per-node 2` (the group is this one): the per-rank
    metrics, the checkpoint directories under `<d>/scripts_mesh`."""
    from diffusion_spacetime_attn_tpu_torch.scripts import train_ldm, train_vae

    a = inputs["scripts"]
    env = dict(os.environ)
    os.environ.update(WORLD_SIZE=str(mesh.data), RANK=str(mesh.rank), LOCAL_RANK=str(mesh.rank))
    try:
        root = os.path.join(d, "scripts_mesh")
        ldm = train_ldm.main(a["ldm"] + ["--batch-size", "1", "--backend", "gloo",
                                         "--ckpt-dir", os.path.join(root, "ldm")])
        vae = train_vae.main(a["vae"] + ["--batch-size", "1", "--backend", "gloo",
                                         "--ckpt-dir", os.path.join(root, "vae")])
    finally:
        os.environ.clear()
        os.environ.update(env)
    return {"ldm": ldm["metrics"], "vae": vae["metrics"],
            "ldm_first": [t.clone() for t in ldm["first_batch"]]}

# ------------------------------------------------------- the model axis (TP)


def _tp_unet(a, mesh):
    """The TINY UNet from the flat JAX tree a["flat"] through the bridge,
    then sliced to this rank's share of the model axis."""
    from diffusion_spacetime_attn_tpu_torch.models.unet import UNet
    from diffusion_spacetime_attn_tpu_torch.parallel.sharding import shard_params
    from diffusion_spacetime_attn_tpu_torch.utils.weights import load_flat

    unet = load_flat(UNet(a["cfg"], radius=0.2), a["flat"])
    return shard_params(unet, mesh)


def _local_grads(module) -> dict:
    """This rank's gradients of the parameters the model axis leaves whole."""
    from diffusion_spacetime_attn_tpu_torch.parallel.sharding import model_sharded

    sharded = model_sharded(module)
    return {k: p.grad.clone() for k, p in module.named_parameters()
            if p.grad is not None and k not in sharded}


@case
def tp_layout(mesh, inputs, d):
    """The rank layout d·M + m, the rows and noise of the data coordinate,
    and an LDMTrainer step replicated over 'model' (lr over data·model, the
    checkpoint written by the writer alone)."""
    from diffusion_spacetime_attn_tpu_torch.parallel.mesh import (
        gather_rows,
        normal_rows,
        rows,
        shard_batch,
    )
    from diffusion_spacetime_attn_tpu_torch.utils import prng

    a = inputs["layout"]
    x = _tensor(a["x"])
    mine = shard_batch(mesh, {"x": x})["x"]
    out = {"coords": (mesh.rank, mesh.data_index, mesh.model_index), "writer": mesh.writer,
           "rows": rows(mesh, x.shape[0]), "mine": mine.clone(),
           "gathered": gather_rows(mesh, mine).clone(),
           "noise": normal_rows(np.asarray(prng.PRNGKey(7), np.uint32),
                                torch.zeros(2, 3), mesh).clone()}
    res, tr, state = _ldm_step(mesh, a["ldm"], fsdp=True, ckpt_dir=os.path.join(d, "tp_ckpt"))
    tr.save(state, 1)
    out.update(ldm_loss=res["loss"], ldm_lr=res["lr"], ldm_fsdp=tr.fsdp,
               ldm_params=res["params"], ckpt=sorted(os.listdir(os.path.join(d, "tp_ckpt"))))
    return out


@case
def tp_unet_fwd(mesh, inputs, d):
    """The TINY UNet forward on sharded weights, this data coordinate's rows,
    gathered."""
    from diffusion_spacetime_attn_tpu_torch.models.unet import UNet
    from diffusion_spacetime_attn_tpu_torch.parallel.mesh import gather_rows, shard_batch
    from diffusion_spacetime_attn_tpu_torch.parallel.sharding import (
        model_state_dict,
        partition_specs,
    )
    from diffusion_spacetime_attn_tpu_torch.utils.weights import load_flat

    a = inputs["unet"]
    unet = _tp_unet(a, mesh)
    x, t, ctx = shard_batch(mesh, (_tensor(a["x"]), _tensor(a["t"]), _tensor(a["ctx"])))
    with torch.no_grad():
        eps = unet(x, t, ctx)
    whole = load_flat(UNet(a["cfg"], radius=0.2), a["flat"]).state_dict()
    gathered = model_state_dict(unet)
    return {"eps": gather_rows(mesh, eps).clone(), "specs": partition_specs(unet),
            "local_shapes": {k: tuple(p.shape) for k, p in unet.named_parameters()},
            "gathered_equal": sorted(gathered) == sorted(whole)
            and all(torch.equal(gathered[k], v) for k, v in whole.items())}


@case
def tp_unet_grad(mesh, inputs, d):
    """The controlled program (`compile_sharded_unet.py` main_tp): the
    prompts over 'data', the heads over 'model', loss Σ eps² of this rank's
    rows; the parameter gradients whole (gathered over 'model', summed over
    'data'), dcoef gathered, the replicated gradients before the data sum,
    the all-reduce counts."""
    from diffusion_spacetime_attn_tpu_torch.ops.attention import SpatialControl
    from diffusion_spacetime_attn_tpu_torch.parallel import tensor as tp
    from diffusion_spacetime_attn_tpu_torch.parallel.mesh import all_reduce_, gather_rows, rows
    from diffusion_spacetime_attn_tpu_torch.parallel.sharding import model_grads

    a = inputs["unet"]
    g = a["grad"]
    unet = _tp_unet(dict(a, cfg=g["cfg"]), mesh)
    B = g["coef"].shape[0]
    r = rows(mesh, B)

    def cfg_rows(v):       # [2B, ...]: this coordinate's uncond rows, then its cond rows
        v = _tensor(v)
        return torch.cat([v[:B][r], v[B:][r]])

    coef = _tensor(g["coef"])[r].clone().requires_grad_(True)
    control = SpatialControl(local_contexts=_tensor(g["local_contexts"])[r],
                             centers=_tensor(g["centers"])[r], coef=coef,
                             active=_tensor(g["active"])[r])
    tp.reset_stats()
    eps = unet(cfg_rows(g["x"]), cfg_rows(g["t"]), cfg_rows(g["ctx"]), control)
    loss = (eps ** 2).sum()
    loss.backward()
    stats = dict(tp.STATS)
    whole = model_grads(unet)
    names = sorted(whole)
    all_reduce_([whole[k] for k in names], mesh, op="sum")
    return {"loss": float(loss), "grads": whole, "dcoef": gather_rows(mesh, coef.grad).clone(),
            "dcoef_local": coef.grad.clone(), "replicated": _local_grads(unet),
            "stats": stats, "blocks": sum(1 for n, _ in unet.named_modules()
                                          if n.endswith(".attn2"))}


@case
def tp_clip(mesh, inputs, d):
    """A CLIP text tower whose 3 heads the model axis does not divide: its
    attention stays whole, its MLP splits; the forward of this data
    coordinate's token rows, gathered."""
    from diffusion_spacetime_attn_tpu_torch.models.clip import CLIPTextTower
    from diffusion_spacetime_attn_tpu_torch.parallel.mesh import gather_rows, shard_batch
    from diffusion_spacetime_attn_tpu_torch.parallel.sharding import (
        model_sharded,
        shard_params,
    )
    from diffusion_spacetime_attn_tpu_torch.utils.weights import load_flat

    a = inputs["clip"]
    tower = shard_params(load_flat(CLIPTextTower(a["cfg"]), a["flat"]), mesh)
    with torch.no_grad():
        last, pooled = tower(shard_batch(mesh, _tensor(a["ids"])))
    return {"last": gather_rows(mesh, last).clone(), "pooled": gather_rows(mesh, pooled).clone(),
            "sharded": sorted(model_sharded(tower))}


@case
def tp_engine(mesh, inputs, d):
    """SpaceTimeEngine at the smoke config over this data group's (1, M) row
    of the mesh and over the whole (data, model) mesh (each on runners of
    its own: the engine shards them); rank 0 also in one process."""
    from diffusion_spacetime_attn_tpu_torch.serving.server import SpaceTimeEngine

    a = inputs["spacetime"]
    out = {}
    for tag, m in (("row", mesh.model_row()), ("mesh", mesh)):
        eng = SpaceTimeEngine(runner=_spacetime_runner(a), batch_size=2, mesh=m)
        images, coef, losses = eng.optimize_batch(a["prompts"], a["seeds"])
        out[tag] = {"images": eng.to_uint8(images), "coef": coef.detach().clone(),
                    "losses": losses.detach().clone()}
    if mesh.rank == 0:
        eng = SpaceTimeEngine(runner=_spacetime_runner(a), batch_size=2)
        images, coef, _ = eng.optimize_batch(a["prompts"], a["seeds"])
        out["one"] = {"images": eng.to_uint8(images), "coef": coef.detach().clone()}
    return out


def model_axis_ranks(d: str, payload: dict) -> Ranks:
    """Two ranks running `model_axis_trainers` on `payload` ({"ldm": ...,
    "vae": ..., "layout": ...}, the inputs of `_ldm_step`, `_vae_step`,
    `_layout_step`) over a (1, 2) mesh; `join()` gives each rank's result."""
    torch.save({"model_axis": payload}, os.path.join(d, "inputs.pt"))
    return Ranks(d, ["model_axis_trainers"])


@case
def model_axis_trainers(mesh, inputs, d):
    """The trainers over a (1, world) mesh made on this group: replicated
    over 'model' (fsdp over a data axis of 1 shards nothing), the lr over
    data·model; the same step computed whole on every rank."""
    from diffusion_spacetime_attn_tpu_torch.parallel.mesh import make_mesh

    m = make_mesh(data=1, model=mesh.data * mesh.model, backend="gloo", device="cpu")
    a = inputs["model_axis"]
    out = {"coords": (m.rank, m.data_index, m.model_index), "devices": m.devices}
    if "ldm" in a:
        res, tr, _ = _ldm_step(m, a["ldm"], fsdp=True)
        out["ldm"] = dict(res, fsdp=tr.fsdp)
    if "vae" in a:
        out["vae"] = _vae_step(m, a["vae"], fsdp=True)
    if "layout" in a:
        out["layout"] = _layout_step(m, a["layout"], fsdp=True)
    return out


def main(argv) -> None:
    import torch.distributed as dist

    from diffusion_spacetime_attn_tpu_torch.parallel.mesh import make_mesh

    d, rank, world, names = argv[0], int(argv[1]), int(argv[2]), argv[3:]
    model = 1
    if names and names[0].startswith("--model="):
        model, names = int(names[0].split("=")[1]), names[1:]
    torch.set_num_threads(1)
    store = dist.FileStore(os.path.join(d, "store"), world)
    mesh = make_mesh(data=world // model, model=model, backend="gloo", device="cpu",
                     store=store, rank=rank, world_size=world, timeout_s=COLLECTIVE_S)
    inputs = torch.load(os.path.join(d, "inputs.pt"), weights_only=False)
    out = {}
    for name in names:
        out[name] = CASES[name](mesh, inputs, d)
    torch.save(out, os.path.join(d, f"out{rank}.pt"))
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1:])
