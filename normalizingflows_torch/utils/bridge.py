"""Weight bridge: load the JAX package's parameters into the port's modules.

The JAX package's flows are pytrees; flattened with their paths they give
``{path: array}`` with paths such as
``.bijector.bijectors[0].stacked['even'].layers[2].W``. `load_jax_params`
walks the same path through the torch module (attributes, ``['key']``
entries of a `ModuleDict`, ``[i]`` entries of a `ModuleList`) and copies
the array into the parameter or buffer it reaches. The two differ in one
place: the JAX `SplinePairStack` and `Repeated` stack their blocks'
leaves along a leading axis, where the port keeps a list of per-block
modules; when a path meets such a list with an attribute still to follow,
the array's leading axis is split across the list. `Dense.W` is ``(in,
out)`` on both sides, so no transpose is needed. This module imports no
JAX: the caller flattens the JAX flow to numpy. A bfloat16 leaf (numpy
dtype ``bfloat16``, from ml_dtypes) is carried bit for bit: its 16-bit
words are reinterpreted as `torch.bfloat16` without importing ml_dtypes.
"""

from __future__ import annotations

import re

import numpy as np
import torch
from torch import nn

__all__ = ["load_jax_params"]

_TOKEN = re.compile(r"\.(\w+)|\['([^']*)'\]|\[(\d+)\]")


def _tokens(path: str) -> list[str | int]:
    out, pos = [], 0
    for m in _TOKEN.finditer(path):
        if m.start() != pos:
            raise KeyError(f"cannot parse parameter path {path!r}")
        attr, key, idx = m.groups()
        out.append(int(idx) if idx is not None else (attr or key))
        pos = m.end()
    if pos != len(path) or not out:
        raise KeyError(f"cannot parse parameter path {path!r}")
    return out


def _assign(obj, tokens, value: np.ndarray, path: str, seen: set):
    if isinstance(obj, nn.ModuleList) and tokens and isinstance(tokens[0],
                                                                 str):
        # a stacked JAX subtree against a list of per-block modules
        if value.shape[0] != len(obj):
            raise ValueError(f"{path}: leading axis {value.shape[0]} != "
                             f"{len(obj)} blocks")
        for i, sub in enumerate(obj):
            _assign(sub, tokens, value[i], path, seen)
        return
    if not tokens:
        raise KeyError(f"{path} does not end at a parameter")
    head, rest = tokens[0], tokens[1:]
    try:
        if isinstance(head, int) or isinstance(obj, nn.ModuleDict):
            child = obj[head]
        else:
            child = getattr(obj, head)
    except (AttributeError, IndexError, KeyError):
        raise KeyError(f"{path}: {type(obj).__name__} has no "
                       f"{head!r}") from None
    if rest:
        _assign(child, rest, value, path, seen)
        return
    if not isinstance(child, torch.Tensor):
        raise KeyError(f"{path} does not end at a tensor")
    if tuple(child.shape) != value.shape:
        raise ValueError(f"{path}: shape {value.shape} != "
                         f"{tuple(child.shape)}")
    with torch.no_grad():
        child.copy_(_tensor(value))
    seen.add(id(child))


def _tensor(value: np.ndarray) -> torch.Tensor:
    """A CPU tensor of ``value``'s values; a bfloat16 array (which numpy
    knows only through ml_dtypes) by its bits."""
    if value.dtype.name == "bfloat16":
        bits = np.ascontiguousarray(value).view(np.int16)
        return torch.from_numpy(bits.copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(value))


def load_jax_params(module: nn.Module, arrays: dict[str, np.ndarray]):
    """Copy ``arrays`` (JAX pytree path → numpy array) into ``module``'s
    parameters and buffers (the JAX package's non-trainable leaves, such
    as `InvertibleLinear`'s ``pmat`` and ``sign_s``), converting to each
    tensor's dtype and device. Raises KeyError if a path does not resolve
    to a tensor, or a parameter or persistent buffer of ``module`` is left
    without a value, and ValueError if a shape differs. Non-persistent
    buffers (masks and indices made at construction, static fields in
    JAX) are not expected."""
    seen: set[int] = set()
    for path, value in arrays.items():
        _assign(module, _tokens(path), np.asarray(value), path, seen)
    missing = [n for n, t in module.state_dict(keep_vars=True).items()
               if id(t) not in seen]
    if missing:
        raise KeyError(f"no value for parameters {missing}")
    return module
