"""The port imports without JAX and names its public API as the JAX
package does."""

import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("jax")
import torch  # noqa: E402

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "normalizingflows_torch"


def test_imports_with_jax_blocked():
    """With ``sys.modules["jax"] = None`` any ``import jax`` fails; the
    package and every module of it (the kernels' wrappers
    `ops.rqs_cuda`, `experimental.coupling_cuda` and
    `experimental.train_cuda` among them) still import, and importing them
    builds no kernel."""
    modules = sorted(
        ".".join(p.relative_to(ROOT).with_suffix("").parts)
        for p in PKG.rglob("*.py") if p.name != "__init__.py")
    code = (
        "import importlib, sys\n"
        f"sys.path.insert(0, {str(ROOT)!r})\n"
        "sys.modules['jax'] = None\n"
        "import normalizingflows_torch as nft\n"
        f"for m in {modules!r}:\n"
        "    importlib.import_module(m)\n"
        "assert 'normalizingflows' not in sys.modules\n"
        "from normalizingflows_torch.ops import _build\n"
        "assert _build._LIB is None\n"
        "from normalizingflows_torch.utils import data\n"
        "assert data._library.cache_info().currsize == 0\n"
        "print(len(nft.__all__))\n")
    assert "normalizingflows_torch.experimental.train_cuda" in modules
    assert {"normalizingflows_torch.config",
            "normalizingflows_torch.utils.checkpoint",
            "normalizingflows_torch.utils.data",
            "normalizingflows_torch.utils.profiling"} <= set(modules)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) > 0


def test_no_source_file_imports_jax():
    files = list(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    for path in files:
        for line in path.read_text().splitlines():
            stripped = line.strip()
            assert not stripped.startswith(("import jax", "from jax")), path
            assert not stripped.startswith(
                ("import normalizingflows.", "from normalizingflows.",
                 "from normalizingflows import",
                 "import normalizingflows ")), path


def test_public_names_are_spelled_as_in_the_jax_package():
    import normalizingflows as nf
    import normalizingflows_torch as nft

    missing = [n for n in nft.__all__ if not hasattr(nft, n)]
    assert not missing
    assert set(nft.__all__) <= set(nf.__all__)
    # the classic flow zoo, its combinators and targets
    assert {"planarflow", "radialflow", "PlanarLayer", "RadialLayer",
            "hamiltonian_flow", "LeapFrog", "momentum_normalization_layer",
            "Stacked", "Repeated", "stack_bijectors", "chain", "transformed",
            "mlp3", "Funnel", "GaussianMixture", "Cross",
            "WarpedGauss"} <= set(nft.__all__)
    # the rest of the zoo and the diagnostics
    assert {"ActNorm", "GlowBlock", "InvertibleLinear", "glow",
            "glow_init_actnorms", "MADE", "MaskedAutoregressive", "Permute",
            "iaf", "maf", "maf_layer", "FlowDiagnostics", "elbo_with_sem",
            "ess", "evaluate_flow", "grid_total_variation", "log_normalizer",
            "log_weights", "sliced_wasserstein2"} <= set(nft.__all__)
    # the experiment path: configs at the top, the utilities by module
    assert {"FlowConfig", "OptimizerConfig", "TrainConfig",
            "config_from_json", "config_to_json"} <= set(nft.__all__)
    from normalizingflows.jl_tpu.utils import checkpoint as jck
    from normalizingflows.jl_tpu.utils import data as jdata
    from normalizingflows.jl_tpu.utils import profiling as jprof

    for theirs, ours in ((jck, nft.utils.checkpoint),
                         (jdata, nft.utils.data),
                         (jprof, nft.utils.profiling)):
        assert set(theirs.__all__) <= set(ours.__all__)
        assert all(callable(getattr(ours, n)) for n in ours.__all__)
    # MaskedDense is public in its module only, in both packages
    from normalizingflows.jl_tpu.models import autoregressive as jar
    from normalizingflows_torch.models import autoregressive as tar

    assert "MaskedDense" in tar.__all__ and "MaskedDense" in jar.__all__
    assert not hasattr(nf, "MaskedDense") and not hasattr(nft, "MaskedDense")
    # joint_logp is public in its module only, in both packages
    from normalizingflows.jl_tpu.models import hamiltonian as jh
    from normalizingflows_torch.models import hamiltonian as th

    assert "joint_logp" in th.__all__ and callable(jh.joint_logp)
    assert not hasattr(nf, "joint_logp") and not hasattr(nft, "joint_logp")


def test_fused_path_loads_lazily():
    """`import normalizingflows_torch` does not load `experimental`;
    `nft.train_realnvp_fused` and `nft.FusedRealNVP` load it on first use,
    as the JAX package's names do."""
    code = (
        "import sys\n"
        f"sys.path.insert(0, {str(ROOT)!r})\n"
        "import normalizingflows_torch as nft\n"
        "assert 'normalizingflows_torch.experimental' not in sys.modules\n"
        "from normalizingflows_torch import experimental\n"
        "assert nft.train_realnvp_fused is experimental.train_realnvp_fused\n"
        "assert nft.FusedRealNVP is experimental.FusedRealNVP\n"
        "try:\n"
        "    nft.no_such_name\n"
        "except AttributeError:\n"
        "    print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
