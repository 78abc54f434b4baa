"""Declarative experiment configs (flows, optimizer, training loop).

Counterpart of `normalizingflows/jl_tpu/config.py`: frozen dataclasses
with the JAX package's fields, defaults and JSON layout, so a JSON written
by either package builds the same experiment in the other.
`FlowConfig.build(generator)` calls the port's constructors (on the card
unless ``device`` says otherwise), `OptimizerConfig.build()` gives an
optimizer factory ``params -> torch.optim.Optimizer`` and `TrainConfig.run`
drives `train_flow` or, for ``objective="mle"``, `train_flow_mle`.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass
from typing import Any, Callable

import numpy as np
import torch

from .models.autoregressive import iaf, maf
from .models.coupling import realnvp
from .models.hamiltonian import hamiltonian_flow
from .models.linear import glow
from .models.planar_radial import planarflow, radialflow
from .models.spline import nsf
from .train import TrainResult, train_flow, train_flow_mle
from .utils.device import resolve_device

__all__ = [
    "FlowConfig",
    "OptimizerConfig",
    "TrainConfig",
    "config_to_json",
    "config_from_json",
]

_DTYPES = {"float32": torch.float32, "float64": torch.float64,
           "bfloat16": torch.bfloat16}


@dataclass(frozen=True)
class FlowConfig:
    """Which flow to build, with the reference's constructor defaults.

    ``family``: 'planar' | 'radial' | 'realnvp' | 'nsf' | 'maf' | 'iaf' |
    'glow' | 'hamiltonian'; 10 layers, conditioner hdims (32, 32), NSF K=10
    knots in a box of B=30. For 'hamiltonian', ``nlayers`` is the block
    count and the target's score function is passed to :meth:`build`.
    ``fused`` builds RealNVP on the fused coupling-stack kernels.
    """

    family: str = "realnvp"
    dim: int = 2
    nlayers: int = 10
    hdims: tuple = (32, 32)
    K: int = 10
    B: float = 30.0
    dtype: str = "float32"  # the reference's `paramtype` knob
    fused: bool = False
    leapfrog_steps: int = 3    # hamiltonian: L per block
    leapfrog_eps0: float = 0.05  # hamiltonian: initial step size

    def build(self, generator: torch.Generator,
              score_fn: Callable | None = None, device=None):
        """The flow, its weights drawn from ``generator`` (a CPU
        generator), on ``device`` (None: the card), its parameters in
        ``dtype`` (``bfloat16`` for every family: 'nsf' and fused
        'realnvp' then run the kernels' bfloat16 instantiations)."""
        if self.dtype not in _DTYPES:
            raise ValueError(f"unknown dtype {self.dtype!r}")
        dt = _DTYPES[self.dtype]
        kw = dict(dtype=dt, device=device)
        hdims = tuple(self.hdims)
        if self.family == "planar":
            return planarflow(generator, self.dim, self.nlayers, **kw)
        if self.family == "radial":
            return radialflow(generator, self.dim, self.nlayers, **kw)
        if self.family == "realnvp":
            return realnvp(generator, self.dim, hdims, nlayers=self.nlayers,
                           fused=self.fused, **kw)
        if self.family == "nsf":
            return nsf(generator, self.dim, hdims, K=self.K, B=self.B,
                       nlayers=self.nlayers, **kw)
        if self.family == "maf":
            return maf(generator, self.dim, hdims, nlayers=self.nlayers, **kw)
        if self.family == "iaf":
            return iaf(generator, self.dim, hdims, nlayers=self.nlayers, **kw)
        if self.family == "glow":
            return glow(generator, self.dim, hdims, nlayers=self.nlayers,
                        **kw)
        if self.family == "hamiltonian":
            if score_fn is None:
                raise ValueError(
                    "family='hamiltonian' needs the target's score function: "
                    "FlowConfig.build(generator, score_fn=target.score)")
            return hamiltonian_flow(
                self.dim, score_fn, n_blocks=self.nlayers,
                L=self.leapfrog_steps, eps0=self.leapfrog_eps0, **kw)
        raise ValueError(f"unknown flow family {self.family!r}")


@dataclass(frozen=True)
class OptimizerConfig:
    """Optimizer by name. Reference default: `Optimisers.ADAM()` ==
    Adam(1e-3) (`src/NormalizingFlows.jl:60`)."""

    name: str = "adam"
    learning_rate: float = 1e-3
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8

    def build(self) -> Callable[[list], torch.optim.Optimizer]:
        """A factory ``params -> optimizer``: torch's Adam, SGD or AdamW
        (optax.adamw's default weight decay, 1e-4). Each runs under the
        trainers' CUDA graph: Adam and AdamW in their capturable mode, SGD
        as it is (it keeps no step count)."""
        betas = (self.b1, self.b2)
        if self.name == "adam":
            return lambda p: torch.optim.Adam(
                p, lr=self.learning_rate, betas=betas, eps=self.eps)
        if self.name == "sgd":
            return lambda p: torch.optim.SGD(p, lr=self.learning_rate)
        if self.name == "adamw":
            return lambda p: torch.optim.AdamW(
                p, lr=self.learning_rate, betas=betas, eps=self.eps,
                weight_decay=1e-4)
        raise ValueError(f"unknown optimizer {self.name!r}")


_ELBOS = ("elbo", "elbo_batch", "elbo_stl", "elbo_iw")


@dataclass(frozen=True)
class TrainConfig:
    """Loop knobs of `train_flow` (reference kwargs at
    `src/NormalizingFlows.jl:59-62` / `src/optimize.jl:63-71`). ``unroll``
    is read from a JAX package's JSON and not used: a CUDA graph already
    lays out every step's kernels."""

    flow: FlowConfig = dataclasses.field(default_factory=FlowConfig)
    optimizer: OptimizerConfig = dataclasses.field(
        default_factory=OptimizerConfig)
    max_iters: int = 1000       # train_flow default (optimize's is 10_000)
    n_samples: int = 32         # MC samples per iteration
    # 'elbo'|'elbo_batch'|'elbo_stl'|'elbo_iw' (reverse KL), or 'mle'
    # (forward KL from data via `train_flow_mle`)
    objective: str = "elbo_batch"
    check_every: int = 100
    show_progress: bool = False
    train_base: bool = False    # the reference's `@leaf MvNormal` freezing
    unroll: int = 1
    seed: int = 0
    # MLE-only knobs: dataset (path to a raw/npy file or in-memory array
    # passed to run(data=...)) and minibatch size
    data_path: str | None = None
    batch_size: int = 128

    def generators(self, device=None) -> tuple:
        """The two generators `run` draws from, both seeded from ``seed``
        (as the JAX package splits its key): one on the host for the
        flow's initial weights, one on ``device`` (None: the card) for
        training."""
        init, train = np.random.SeedSequence(self.seed).generate_state(
            2, np.uint64)
        return (torch.Generator().manual_seed(int(init)),
                torch.Generator(device=resolve_device(device)).manual_seed(
                    int(train)))

    def run(self, target_logp: Callable | None = None,
            score_fn: Callable | None = None, data: Any | None = None,
            device=None, generator: torch.Generator | None = None,
            **overrides: Any) -> TrainResult:
        """Build the flow on ``device`` (None: the card) and train it.

        Reverse-KL objectives train against ``target_logp``; for
        ``objective='mle'`` pass ``data`` (an (n, dim) array or a path) or
        set ``data_path``: the flow maximizes the data's log-likelihood
        through `train_flow_mle`, on `make_loader`'s batches from ``seed``
        (a raw float32 file has ``flow.dim`` columns and as many rows as
        its size holds). ``score_fn`` is required for (and only used by)
        the hamiltonian family. ``generator`` is the training generator
        (default: `generators`' second); pass your own to save its state
        beside a checkpoint. ``overrides`` replace the trainer's keywords
        (``resume_state``, ``graph``, ``max_iters``, ...)."""
        from . import objectives
        from .utils.data import make_loader

        if self.objective != "mle" and self.objective not in _ELBOS:
            raise ValueError(f"unknown objective {self.objective!r}")
        init, train = self.generators(device)
        generator = train if generator is None else generator
        kwargs = dict(
            max_iters=self.max_iters,
            optimizer=self.optimizer.build(),
            train_base=self.train_base,
            check_every=self.check_every,
            show_progress=self.show_progress,
        )
        kwargs.update(overrides)
        flow = (kwargs["resume_state"].flow if kwargs.get("resume_state")
                else self.flow.build(init, score_fn=score_fn, device=device))

        if self.objective == "mle":
            source = data if data is not None else self.data_path
            if source is None:
                raise ValueError(
                    "objective='mle' needs data: pass run(data=array) or "
                    "set TrainConfig.data_path")
            loader = make_loader(source, self.batch_size, dim=self.flow.dim,
                                 seed=self.seed)
            try:
                return train_flow_mle(flow, loader, **kwargs)
            finally:
                loader.close()

        if target_logp is None:
            raise ValueError(
                f"objective={self.objective!r} needs target_logp")
        return train_flow(generator, getattr(objectives, self.objective),
                          flow, target_logp, self.n_samples, **kwargs)


def _to_dict(cfg: Any) -> Any:
    if dataclasses.is_dataclass(cfg):
        return {f.name: _to_dict(getattr(cfg, f.name))
                for f in dataclasses.fields(cfg)}
    if isinstance(cfg, (tuple, list)):
        return [_to_dict(v) for v in cfg]
    return cfg


def config_to_json(cfg: Any) -> str:
    """Serialize any config dataclass to JSON (the JAX package's layout)."""
    return json.dumps(_to_dict(cfg), indent=2)


_NESTED = {"flow": FlowConfig, "optimizer": OptimizerConfig}


def _coerce(cls: type, data: dict) -> Any:
    kwargs = {}
    for f in dataclasses.fields(cls):
        if f.name not in data:
            continue
        v = data[f.name]
        if cls is TrainConfig and f.name in _NESTED:
            v = _coerce(_NESTED[f.name], v)
        elif isinstance(v, list):
            v = tuple(v)
        kwargs[f.name] = v
    return cls(**kwargs)


def config_from_json(s: str, cls: type = TrainConfig) -> Any:
    """Rebuild a config dataclass from `config_to_json` output (either
    package's)."""
    return _coerce(cls, json.loads(s))
