"""Checkpoint and exact resume for flows, optimizers and generators.

Counterpart of `normalizingflows/jl_tpu/utils/checkpoint.py`. The JAX
package saves a pytree's leaves to one ``.npz`` and rebuilds the tree from
a template's treedef. The port's format is PyTorch's: one `torch.save` of

    {"flow": state_dict, "optimizer": state_dict or None,
     "generator": generator.get_state() or None, "iteration": int}

written atomically (a ``.tmp`` file, then `os.replace`), read with
``torch.load(weights_only=True)`` onto the template's device and loaded in
place into the template's flow and optimizer. With the training
generator's state saved beside them, a run resumed from a checkpoint
continues the uninterrupted run's trajectory bit for bit (the generator
takes the place of JAX's advanced key). Shape and key mismatches raise
ValueError, as the JAX leaf-count and shape checks do.

`load_jax_checkpoint` reads a ``.npz`` written by the JAX package's
`save_pytree` (a flow) or `save_train_state` (flow, optax Adam state,
iteration) into the port's flow and `torch.optim.Adam`, given the JAX
tree's ``keystr`` leaf paths in leaf order (this module imports no JAX).

``backend="dcp"`` is the multi-rank path, the counterpart of the JAX
package's ``backend="orbax"``: `torch.distributed.checkpoint` writes a
directory in which every rank saves its own shards, of a module or of a
dict of modules and tensors (`DTensor`s of `parallel.sample_sharded`
among them), and loads them in place into a template built the same way:
a module gets its state_dict back, a `DTensor` keeps its placements and
each rank reads only its own shard. It runs on one rank too. A train
state is saved with ``"torch"`` only, as the JAX package saves one to its
``.npz`` only.
"""

from __future__ import annotations

import copy
import os
import re

import numpy as np
import torch
from torch import nn

from .bridge import load_jax_params

__all__ = ["save_pytree", "load_pytree", "save_train_state",
           "load_train_state", "load_jax_checkpoint"]


def _check_backend(backend: str, allowed=("torch", "dcp")):
    if backend == "orbax":
        raise ValueError(
            "backend='orbax' is the JAX package's multi-host checkpoint; "
            "the port's is backend='dcp' (torch.distributed.checkpoint)")
    if backend not in allowed:
        raise ValueError(f"unknown checkpoint backend {backend!r}: "
                         f"this call takes {' or '.join(allowed)}")


def _dcp_state(tree) -> dict:
    """``tree``'s tensors as `torch.distributed.checkpoint` takes them: a
    module's state_dict (its own tensors), a dict's values in turn."""
    if isinstance(tree, nn.Module):
        return tree.state_dict()
    if isinstance(tree, dict):
        return {k: (v if torch.is_tensor(v) else _dcp_state(v))
                for k, v in tree.items()}
    raise TypeError("backend='dcp' saves a module or a dict of modules and "
                    f"tensors, not {type(tree).__name__}")


def _dcp_restore(tree, state: dict):
    """Each module of ``tree`` loads its part of ``state`` back."""
    if isinstance(tree, nn.Module):
        tree.load_state_dict(state)
    else:
        for k, v in tree.items():
            if not torch.is_tensor(v):
                _dcp_restore(v, state[k])


def _save(path: str, payload: dict):
    tmp = os.fspath(path) + ".tmp"
    with open(tmp, "wb") as f:
        torch.save(payload, f)
    os.replace(tmp, path)


def _read(path: str, device: torch.device) -> dict:
    return torch.load(path, map_location=device, weights_only=True)


def _device(module: nn.Module) -> torch.device:
    t = next(iter(module.state_dict().values()), None)
    return t.device if t is not None else torch.device("cpu")


def _load_flow(module: nn.Module, saved: dict, path: str):
    """Copy ``saved`` (a state_dict) into ``module`` in place, after
    checking that it holds exactly the module's keys and shapes."""
    own = module.state_dict()
    missing = sorted(set(own) - set(saved))
    extra = sorted(set(saved) - set(own))
    if missing or extra:
        raise ValueError(f"{path}: checkpoint and template differ in their "
                         f"tensors: missing {missing}, unexpected {extra}")
    for k, t in own.items():
        if tuple(saved[k].shape) != tuple(t.shape):
            raise ValueError(f"{path}: checkpoint tensor {k} has shape "
                             f"{tuple(saved[k].shape)}, template expects "
                             f"{tuple(t.shape)}")
    module.load_state_dict(saved)


def _place_steps(opt: torch.optim.Optimizer):
    """Each parameter's ``step`` where torch keeps it: on the parameter's
    device as float32 for a capturable or fused group, else on the host."""
    for group in opt.param_groups:
        on_device = group.get("capturable") or group.get("fused")
        for p in group["params"]:
            step = opt.state.get(p, {}).get("step")
            if torch.is_tensor(step):
                opt.state[p]["step"] = (
                    step.to(device=p.device, dtype=torch.float32)
                    if on_device else step.cpu())


def _load_optimizer(opt: torch.optim.Optimizer, saved: dict, path: str):
    """`load_state_dict` (which raises ValueError where the parameter
    groups differ in number or size), then a check of each state tensor's
    shape against its parameter's."""
    opt.load_state_dict(saved)
    for p, state in opt.state.items():
        for k, v in state.items():
            if torch.is_tensor(v) and v.dim() and v.shape != p.shape:
                raise ValueError(f"{path}: optimizer state {k} of shape "
                                 f"{tuple(v.shape)} for a parameter of "
                                 f"{tuple(p.shape)}")
    _place_steps(opt)


def save_pytree(path: str, module, backend: str = "torch"):
    """Save ``module``'s parameters and persistent buffers (its
    state_dict) to the file ``path``, atomically. With ``backend="dcp"``,
    on every rank of the group: ``module`` may also be a dict of modules
    and tensors, and ``path`` is a directory."""
    _check_backend(backend)
    if backend == "dcp":
        import torch.distributed.checkpoint as dcp

        dcp.save(_dcp_state(module), checkpoint_id=path)
        return
    _save(path, {"flow": module.state_dict(), "optimizer": None,
                 "generator": None, "iteration": None})


def load_pytree(path: str, module, backend: str = "torch"):
    """Load a flow saved by `save_pytree` or `save_train_state` into
    ``module`` (built the same way) in place, and return it. With
    ``backend="dcp"``, on every rank, a `save_pytree(backend="dcp")`
    directory into a template of the saved tree's structure: tensors and
    `DTensor`s are loaded in place (a `DTensor` keeps its placements)."""
    _check_backend(backend)
    if backend == "dcp":
        import torch.distributed.checkpoint as dcp

        state = _dcp_state(module)
        dcp.load(state, checkpoint_id=path)
        _dcp_restore(module, state)
        return module
    _load_flow(module, _read(path, _device(module))["flow"], path)
    return module


def save_train_state(path: str, state, generator: torch.Generator | None
                     = None, backend: str = "torch"):
    """Save a `TrainState` (flow, optimizer, iteration) and, for an exact
    resume, the training generator's state, atomically (``"torch"``
    only)."""
    _check_backend(backend, ("torch",))
    _save(path, {"flow": state.flow.state_dict(),
                 "optimizer": state.opt_state.state_dict(),
                 "generator": (None if generator is None
                               else generator.get_state()),
                 "iteration": int(state.iteration)})


def load_train_state(path: str, template_state,
                     generator: torch.Generator | None = None,
                     backend: str = "torch"):
    """Load a `save_train_state` checkpoint in place into
    ``template_state``'s flow and optimizer (built the same way, the
    optimizer over the same parameters, fresh or not) and, if given,
    ``generator``; returns the `TrainState` to pass as ``resume_state``.
    The loaded optimizer's step counts sit where torch keeps them (on the
    parameters' device for a capturable group), so a graphed run resumes
    from it."""
    from ..train import TrainState

    _check_backend(backend, ("torch",))
    saved = _read(path, _device(template_state.flow))
    if saved["optimizer"] is None:
        raise ValueError(f"{path} holds a flow, not a train state")
    _load_flow(template_state.flow, saved["flow"], path)
    _load_optimizer(template_state.opt_state, saved["optimizer"], path)
    if generator is not None:
        if saved["generator"] is None:
            raise ValueError(f"{path} was saved without a generator state")
        generator.set_state(saved["generator"].cpu())
    return TrainState(template_state.flow, template_state.opt_state,
                      int(saved["iteration"]))


# A JAX (flow, opt_state, iteration) leaf path: [0] the flow's, [1] the
# optax state's (a count: Adam's, or with a schedule also its
# ScaleByScheduleState's; or a moment's leaf at the flow path that follows
# mu/nu), [2] the iteration.
_ADAM_LEAF = re.compile(r"\[1\](?:\[\d+\])*\.(count|mu|nu)(.*)")


def load_jax_checkpoint(path: str, flow: nn.Module, leaf_paths,
                        optimizer: torch.optim.Optimizer | None = None):
    """Read a JAX ``.npz`` checkpoint into the port.

    ``leaf_paths`` are the JAX tree's ``jax.tree_util.keystr`` paths in
    `tree_leaves` order, which is the order of the file's ``leaf_{i}``:
    those of the flow for `save_pytree(flow)`, or of ``(flow, opt_state,
    iteration)`` for `save_train_state`. The flow's leaves go through
    `load_jax_params`. A train state's optax Adam state (``count``,
    ``mu``, ``nu``) becomes ``optimizer``'s per-parameter ``step``,
    ``exp_avg`` and ``exp_avg_sq`` (a `torch.optim.Adam` or AdamW over
    the flow's trainable parameters); the moments of parameters outside
    the optimizer (a frozen base) are not kept. The state of
    ``optax.adam(schedule)`` holds one more leaf, the schedule's
    ``ScaleByScheduleState.count`` (``[1][1].count``): it is the count the
    schedule reads, which `optim.adam` takes from Adam's ``step``, so it
    maps onto the same ``step`` and must equal Adam's ``count``
    (ValueError where they differ). Returns the flow for a flow's file, and
    a `TrainState` (the iteration as an int) for a train state's."""
    from ..train import TrainState

    with np.load(path) as z:
        leaves = [z[f"leaf_{i}"] for i in range(len(z.files))]
    paths = list(leaf_paths)
    if len(paths) != len(leaves):
        raise ValueError(f"{path} has {len(leaves)} leaves, leaf_paths "
                         f"{len(paths)}")
    if not all(p.startswith(("[0]", "[1]", "[2]")) for p in paths):
        if optimizer is not None:
            raise ValueError(f"{path} holds a flow, not a train state")
        return load_jax_params(flow, dict(zip(paths, leaves)))

    params, moments, counts, iteration = {}, {"mu": {}, "nu": {}}, {}, None
    for p, leaf in zip(paths, leaves):
        if p.startswith("[0]"):
            params[p[3:]] = leaf
        elif p == "[2]":
            iteration = int(leaf)
        elif (m := _ADAM_LEAF.fullmatch(p)) is None:
            raise ValueError(f"{path}: {p} is not a leaf of an optax Adam "
                             "state")
        elif m.group(1) == "count":
            counts[p] = int(leaf)
        else:
            moments[m.group(1)][m.group(2)] = leaf
    if iteration is None:
        raise ValueError(f"{path}: no iteration leaf [2]")
    if len(set(counts.values())) > 1:
        raise ValueError(f"{path}: the optax state's counts differ "
                         f"({counts}); Adam's and its schedule's must agree")
    count = next(iter(counts.values()), None)
    load_jax_params(flow, params)
    if optimizer is not None:
        if count is None:
            raise ValueError(f"{path}: no optax Adam count")
        names = {id(t): n for n, t in flow.named_parameters()}
        mu, nu = (dict(load_jax_params(copy.deepcopy(flow),
                                       moments[k]).named_parameters())
                  for k in ("mu", "nu"))
        for group in optimizer.param_groups:
            for p in group["params"]:
                name = names[id(p)]
                optimizer.state[p] = {
                    "step": torch.tensor(float(count)),
                    "exp_avg": mu[name].detach().clone(),
                    "exp_avg_sq": nu[name].detach().clone()}
        _place_steps(optimizer)
    return TrainState(flow, optimizer, iteration)
