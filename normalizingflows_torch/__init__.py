"""Normalizing-flow variational inference in PyTorch, for NVIDIA Hopper.

The PyTorch port of `normalizingflows.jl_tpu`, with the same public names.
Its tree mirrors the JAX package's (`models/`, `ops/`, `utils/`,
`objectives.py`, `train.py`), so each module's counterpart sits at the same
relative path. The hand-written kernels (the neural spline flow's fused
rational-quadratic spline, the fused RealNVP coupling stack and its
whole training run) are CUDA C++ in `csrc/`, built with nvcc at first use.

The port covers reverse-KL ELBO training of the neural spline flow, its
density path (log_prob with gradients) and maximum-likelihood training,
annealed (tempered-path) training, RealNVP, unfused or through the
fused coupling-stack kernels, whose whole ELBO training run
`train_realnvp_fused` takes one kernel launch per chunk of steps, the
classic flows: planar and radial (inverses by an implicit-gradient root
solve) and the Hamiltonian flow with its targets, Glow (ActNorm and PLU
mixing), MAF/IAF, and the VI diagnostics; experiments from a JSON config,
checkpoints with an exact resume, the native prefetching loader, Adam under
a warmup-cosine schedule, the plots, the demos and the parity harness. On the
card the trainers replay their step from a CUDA graph (``graph=``):
  train_flow, train_flow_mle, train_flow_annealed,
  optimize                             -> .train
  elbo, elbo_batch, elbo_from_samples, elbo_stl, elbo_iw,
  loglikelihood, tempered              -> .objectives
  create_flow                          -> .models.flows
  Shift, Scale, Stacked, Repeated, chain,
  stack_bijectors                      -> .models.bijector
  transformed                          -> .models.distributions
  nsf, NSF_layer, NeuralSplineCoupling, SplinePairStack -> .models.spline
  glow, glow_init_actnorms, GlowBlock, ActNorm,
  InvertibleLinear                     -> .models.linear
  iaf, maf, maf_layer, MADE, MaskedAutoregressive,
  Permute                              -> .models.autoregressive
  realnvp, RealNVP_layer, AffineCoupling, CouplingPairStack
                                       -> .models.coupling
  realnvp(fused=True): FusedRealNVP,
  train_realnvp_fused (lazy)           -> .experimental
  planarflow, radialflow, PlanarLayer, RadialLayer
                                       -> .models.planar_radial
  hamiltonian_flow, LeapFrog, momentum_normalization_layer
                                       -> .models.hamiltonian
                                          (and joint_logp, not re-exported,
                                          as in the JAX package)
  MLP, fnn, mlp3                       -> .models.nets
  Banana, Funnel, GaussianMixture, Cross, WarpedGauss
                                       -> .models.targets
  log_weights, elbo_with_sem, log_normalizer, ess, evaluate_flow,
  FlowDiagnostics, sliced_wasserstein2,
  grid_total_variation                 -> .diagnostics
  FlowConfig, OptimizerConfig, TrainConfig,
  config_to_json, config_from_json     -> .config
  utils.data: make_loader, NativeLoader (the C++ prefetching loader),
  NumpyLoader                          -> .utils.data
  utils.checkpoint: save_pytree, load_pytree, save_train_state,
  load_train_state, load_jax_checkpoint -> .utils.checkpoint
  utils.profiling: trace, sync_fetch, time_scan_steps
                                       -> .utils.profiling
  utils.viz: compare_trained_and_untrained_flow, visualize,
  plot_losses (matplotlib imported at a call) -> .utils.viz
  adam, warmup_cosine_decay_schedule (optax's names; the schedule runs
  inside the graphed step)             -> .optim
  the seven demos and the parity harness, runnable with python -m
                                       -> .examples
Constructors build on the card unless given ``device="cpu"``.
"""

import torch

# Exact float32 matrix products on the card. The JAX package forces
# Precision.HIGHEST for f32/f64 conditioners (`jl_tpu/models/nets.py`)
# because log-dets feed exp(); TF32 keeps about three decimal digits.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

from .models.bijector import (  # noqa: E402
    Bijector,
    Chain,
    Identity,
    Inverse,
    Repeated,
    Scale,
    Shift,
    Stacked,
    chain,
    invert,
    stack_bijectors,
)
from .models.coupling import (  # noqa: E402
    AffineCoupling,
    CouplingPairStack,
    RealNVP_layer,
    realnvp,
)
from .models.distributions import (  # noqa: E402
    DiagNormal,
    Distribution,
    StandardNormal,
    TransformedDistribution,
    transformed,
)
from .models.flows import create_flow  # noqa: E402
from .models.hamiltonian import (  # noqa: E402
    LeapFrog,
    hamiltonian_flow,
    momentum_normalization_layer,
)
from .models.linear import (  # noqa: E402
    ActNorm,
    GlowBlock,
    InvertibleLinear,
    glow,
    glow_init_actnorms,
)
from .models.autoregressive import (  # noqa: E402
    MADE,
    MaskedAutoregressive,
    Permute,
    iaf,
    maf,
    maf_layer,
)
from .models.nets import MLP, fnn, mlp3  # noqa: E402
from .models.planar_radial import (  # noqa: E402
    PlanarLayer,
    RadialLayer,
    planarflow,
    radialflow,
)
from .models.spline import (  # noqa: E402
    NeuralSplineCoupling,
    NSF_layer,
    SplinePairStack,
    nsf,
)
from .models.targets import (  # noqa: E402
    Banana,
    Cross,
    Funnel,
    GaussianMixture,
    WarpedGauss,
)
from .objectives import (  # noqa: E402
    elbo,
    elbo_batch,
    elbo_from_samples,
    elbo_iw,
    elbo_single_sample,
    elbo_stl,
    loglikelihood,
    presample_base,
    tempered,
)
from .train import (  # noqa: E402
    TrainResult,
    TrainState,
    optimize,
    train_flow,
    train_flow_annealed,
    train_flow_mle,
)
from .diagnostics import (  # noqa: E402
    FlowDiagnostics,
    elbo_with_sem,
    ess,
    evaluate_flow,
    grid_total_variation,
    log_normalizer,
    log_weights,
    sliced_wasserstein2,
)
from .config import (  # noqa: E402
    FlowConfig,
    OptimizerConfig,
    TrainConfig,
    config_from_json,
    config_to_json,
)
# nft.utils.data, .checkpoint, .profiling and .viz, as in the JAX package
from .utils import checkpoint as _checkpoint  # noqa: E402,F401
from .utils import data as _data  # noqa: E402,F401
from .utils import profiling as _profiling  # noqa: E402,F401
from .utils import viz as _viz  # noqa: E402,F401
# optax's names for the one optimizer and schedule the demos use, and the
# JAX package's viz functions: attributes of the package, not in __all__,
# which names only the JAX package's top-level names
from . import optim  # noqa: E402
from .optim import adam, warmup_cosine_decay_schedule  # noqa: E402,F401
from .utils.viz import (  # noqa: E402,F401
    compare_trained_and_untrained_flow,
    plot_losses,
    visualize,
)

__version__ = "0.1.0"


def __getattr__(name: str):
    # The fused RealNVP path lives in `.experimental`, which a plain import
    # does not load; `nft.train_realnvp_fused` and `nft.FusedRealNVP` load it
    # on first use, as the JAX package's names do.
    if name in ("FusedRealNVP", "train_realnvp_fused"):
        from . import experimental

        return getattr(experimental, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = [
    # bijectors
    "Bijector", "Chain", "Identity", "Inverse", "Repeated", "Scale", "Shift",
    "Stacked", "chain", "invert", "stack_bijectors",
    # distributions
    "DiagNormal", "Distribution", "StandardNormal",
    "TransformedDistribution", "transformed",
    # flows
    "create_flow", "MLP", "fnn", "mlp3",
    "NeuralSplineCoupling", "NSF_layer", "SplinePairStack", "nsf",
    "MADE", "MaskedAutoregressive", "Permute", "iaf", "maf", "maf_layer",
    "ActNorm", "GlowBlock", "InvertibleLinear", "glow", "glow_init_actnorms",
    "AffineCoupling", "CouplingPairStack", "RealNVP_layer", "realnvp",
    "PlanarLayer", "RadialLayer", "planarflow", "radialflow",
    "LeapFrog", "hamiltonian_flow", "momentum_normalization_layer",
    # targets
    "Banana", "Cross", "Funnel", "GaussianMixture", "WarpedGauss",
    # objectives
    "elbo", "elbo_batch", "elbo_from_samples", "elbo_iw",
    "elbo_single_sample", "elbo_stl", "loglikelihood", "presample_base",
    "tempered",
    # training
    "TrainResult", "TrainState", "optimize", "train_flow", "train_flow_mle",
    "train_flow_annealed",
    # configs
    "FlowConfig", "OptimizerConfig", "TrainConfig",
    "config_from_json", "config_to_json",
    # diagnostics
    "FlowDiagnostics", "elbo_with_sem", "ess", "evaluate_flow",
    "grid_total_variation", "log_normalizer", "log_weights",
    "sliced_wasserstein2",
]
