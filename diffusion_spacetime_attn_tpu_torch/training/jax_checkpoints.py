"""JAX trainer checkpoints (orbax `step_<n>/` directories) as the port's own.

The JAX package's trainers save with `ocp.StandardCheckpointer`: the LDM
trainer its `LDMTrainState` (`training/ldm_trainer.py:69-76` there: params,
opt_state, ema_params, logvar, step), the layout trainer `{"params",
"opt_state", "extra"}`.  `utils/orbax.restore` reads such a directory without
orbax; the functions here turn the tree into the dict the port's trainers
write with `torch.save` (whole tensors keyed by the port's parameter names),
so each trainer's `restore` loads either, sharded or not:

* parameters, EMA copies, Adam moments and accumulated gradients are flax
  trees of the parameters' shape; each goes through the strict weight bridge
  (`utils/weights.bridge`: every parameter filled exactly once, Dense kernels
  transposed, convolutions permuted);
* optax's states are found by their fields, wherever the chain puts them:
  `ScaleByAdamState` {count, mu, nu}, `ScaleByScheduleState` {count},
  `MultiStepsState` {mini_step, gradient_step, acc_grads, inner_opt_state,
  ...}, `ApplyIfFiniteState` {notfinite_count, last_finite,
  total_notfinite, inner_state}, and `multi_transform`'s `inner_states`
  whose masked moments hold None for the other group's leaves;
* torch keeps Adam's step count per parameter and optax once per
  transformation: every parameter gets optax's `count`.

`read_on_rank0` makes rank 0 alone read the directory over a mesh and hands
the dict to the other ranks.
"""
from __future__ import annotations

import os
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch
from torch import nn

from ..utils import orbax
from ..utils.weights import bridge, flatten_tree


def is_orbax_dir(path: str) -> bool:
    return os.path.isfile(os.path.join(path, "_METADATA"))


def find_states(tree: Any, fields: set) -> List[Dict]:
    """Every dict node of `tree` whose keys include `fields`, in tree order."""
    out: List[Dict] = []
    if isinstance(tree, dict):
        if fields <= set(tree):
            out.append(tree)
        for v in tree.values():
            out.extend(find_states(v, fields))
    elif isinstance(tree, list):
        for v in tree:
            out.extend(find_states(v, fields))
    return out


def merge_masked(a: Any, b: Any) -> Any:
    """Two trees of one structure where each leaf is None in one of them
    (multi_transform's masked moments) -> the tree of their leaves."""
    if isinstance(a, dict) and isinstance(b, dict):
        if set(a) != set(b):
            raise ValueError(f"masked trees differ: {sorted(a)} vs {sorted(b)}")
        return {k: merge_masked(a[k], b[k]) for k in a}
    if a is None:
        return b
    if b is None:
        return a
    raise ValueError("a leaf present in both parameter groups")


def _prefix(module: nn.Module, root: nn.Module) -> str:
    for name, m in module.named_modules():
        if m is root:
            return f"{name}." if name else ""
    raise ValueError("the parameter root is not a submodule of the trained module")


def state_dict_of(tree: Any, module: nn.Module, root: Optional[nn.Module] = None
                  ) -> Dict[str, torch.Tensor]:
    """A flax parameter tree (numpy, bf16 as torch) -> float32 CPU tensors
    keyed like `module.state_dict()`; `root` is the submodule the tree maps
    to (default `module`)."""
    root = module if root is None else root
    sd = bridge(flatten_tree(orbax.to_float32(tree)), root)
    pre = _prefix(module, root)
    return {pre + k: v.detach().to(torch.float32).contiguous() for k, v in sd.items()}


def by_parameter(tree: Any, module: nn.Module, params: List[torch.Tensor],
                 root: Optional[nn.Module] = None) -> List[torch.Tensor]:
    """A parameter-shaped flax tree as one tensor per entry of `params`
    (parameters of `module`, in the optimizer's order)."""
    sd = state_dict_of(tree, module, root)
    names = {id(p): n for n, p in module.named_parameters()}
    missing = [i for i, p in enumerate(params) if names.get(id(p)) not in sd]
    if missing:
        raise KeyError(f"the checkpoint's tree lacks optimizer parameters {missing[:5]}")
    return [sd[names[id(p)]] for p in params]


def _one(states: List[Dict], what: str, path: str) -> Dict:
    if len(states) != 1:
        raise ValueError(f"{path}: expected one {what} in the optax state, found {len(states)}")
    return states[0]


def adam_state(count: int, mu: List[torch.Tensor], nu: List[torch.Tensor],
               param_groups: List[Dict]) -> Dict:
    """A torch Adam / AdamW state dict of whole tensors: optax's one count
    becomes every parameter's step."""
    state = {i: {"step": torch.tensor(float(count)), "exp_avg": m, "exp_avg_sq": v}
             for i, (m, v) in enumerate(zip(mu, nu))}
    return {"state": state, "param_groups": param_groups}


def _split_logvar(tree: Any, learn_logvar: bool):
    """(params tree, logvar array or None) of a trainable tree: JAX trains
    (params, logvar) together when learn_logvar is set."""
    if learn_logvar:
        if not (isinstance(tree, list) and len(tree) == 2):
            raise ValueError("learn_logvar: the optax state is not over (params, logvar)")
        return tree[0], torch.as_tensor(np.asarray(tree[1], np.float32))
    return tree, None


def ldm_checkpoint(path: str, cfg, module: nn.Module, opt, root: Optional[nn.Module] = None
                   ) -> Dict:
    """The port's `LDMTrainer.save` dict of a JAX `LDMTrainer.save` directory.
    `cfg`: the port's LDMTrainConfig; `module`: the trained module; `opt`:
    its `ldm_trainer.Optimizer`; `root`: the submodule JAX's params tree maps
    to (the UNet inside the unconditional and superres wrappers)."""
    tree = orbax.restore(path)
    for k in ("params", "opt_state", "logvar", "step"):
        if k not in tree:
            raise ValueError(f"{path}: not an LDMTrainState (no {k!r})")
    ost = tree["opt_state"]
    adam = _one(find_states(ost, {"count", "mu", "nu"}), "Adam state", path)
    multi = find_states(ost, {"mini_step", "gradient_step", "acc_grads", "inner_opt_state"})
    if bool(multi) != (cfg.accum_steps > 1):
        raise ValueError(f"{path}: optax MultiSteps {'present' if multi else 'absent'}, but "
                         f"accum_steps is {cfg.accum_steps}")

    def per_param(t):
        ptree, lv = _split_logvar(t, cfg.learn_logvar)
        n = len(opt.params) - (1 if lv is not None else 0)
        out = by_parameter(ptree, module, opt.params[:n], root)
        return out + ([lv] if lv is not None else [])

    count = int(np.asarray(adam["count"]))
    for s in find_states(ost, {"count"}):
        if set(s) == {"count"} and int(np.asarray(s["count"])) != count:
            raise ValueError(f"{path}: the schedule's count differs from Adam's")
    opt_d = {"adamw": adam_state(count, per_param(adam["mu"]), per_param(adam["nu"]),
                                 opt.adamw.state_dict()["param_groups"]),
             "count": count, "mini_step": 0, "acc": None}
    if multi:
        m = multi[0]
        opt_d["mini_step"] = int(np.asarray(m["mini_step"]))
        opt_d["acc"] = per_param(m["acc_grads"])
        if int(np.asarray(m["gradient_step"])) != count:
            raise ValueError(f"{path}: MultiSteps' gradient_step differs from Adam's count")
    ema = tree.get("ema_params")
    return {"params": state_dict_of(tree["params"], module, root), "opt": opt_d,
            "ema": None if ema is None else
            {n: t for n, t in state_dict_of(ema, module, root).items()
             if n in dict(module.named_parameters())},
            "logvar": torch.as_tensor(np.asarray(tree["logvar"], np.float32)),
            "step": int(np.asarray(tree["step"]))}


def layout_checkpoint(path: str, model: nn.Module, opt) -> Dict:
    """The port's `LayoutTrainer.save_checkpoint` dict of a JAX one: params,
    both groups' Adam moments and counts, and apply_if_finite's counters.
    `opt`: the port's `layout_trainer.Optimizer` over `model`."""
    tree = orbax.restore(path)
    if "params" not in tree or "opt_state" not in tree:
        raise ValueError(f"{path}: not a layout trainer checkpoint (params, opt_state)")
    ost = tree["opt_state"]
    groups = _one(find_states(ost, {"inner_states"}), "multi_transform state", path)
    adams = {}
    for g, st in groups["inner_states"].items():
        adams[g] = _one(find_states(st, {"count", "mu", "nu"}), f"{g} Adam state", path)
    counts = {int(np.asarray(a["count"])) for a in adams.values()}
    if len(counts) != 1:
        raise ValueError(f"{path}: the groups' Adam counts differ ({sorted(counts)})")
    count = counts.pop()
    mu = nu = None
    for a in adams.values():
        mu = a["mu"] if mu is None else merge_masked(mu, a["mu"])
        nu = a["nu"] if nu is None else merge_masked(nu, a["nu"])
    fin = find_states(ost, {"notfinite_count", "last_finite", "total_notfinite"})
    fin = fin[0] if fin else {"notfinite_count": 0, "last_finite": True, "total_notfinite": 0}
    return {"params": state_dict_of(tree["params"], model),
            "opt_state": {"adam": adam_state(count, by_parameter(mu, model, opt.params),
                                             by_parameter(nu, model, opt.params),
                                             opt.adam.state_dict()["param_groups"]),
                          "count": count,
                          "notfinite_count": int(np.asarray(fin["notfinite_count"])),
                          "total_notfinite": int(np.asarray(fin["total_notfinite"])),
                          "last_finite": bool(np.asarray(fin["last_finite"]))},
            "extra": tree.get("extra", {})}


def read_on_rank0(mesh, read: Callable[[], Dict]) -> Dict:
    """`read()` on rank 0 alone (every process without a mesh), its result
    handed to the other ranks."""
    if mesh is None:
        return read()
    import torch.distributed as dist

    box = [read() if mesh.writer else None]
    dist.broadcast_object_list(box, src=0)
    return box[0]
