"""The run's guard against JAX compares top-level module names whole."""

import pytest

from perfbench import guard


@pytest.mark.parametrize("modules,found", [
    ({"normalizingflows_torch", "normalizingflows_torch.models"}, []),
    ({"normalizingflows", "normalizingflows.jl_tpu"}, ["normalizingflows"]),
    ({"jax.numpy"}, ["jax"]),
    ({"jaxlib.xla_client"}, ["jaxlib"]),
    ({"flax.linen"}, ["flax"]),
    ({"jaxtyping", "flaxen", "normalizingflows_torchx"}, []),
])
def test_forbidden_by_whole_top_level_name(modules, found):
    assert guard.forbidden(modules) == found


def test_the_harness_and_the_port_load_no_jax():
    """In a fresh process, as a run imports them."""
    import subprocess
    import sys

    from perfbench import spec

    code = ("import sys; sys.path[0] = %r; "
            "import perfbench.harness, perfbench.calibrate, "
            "perfbench.drivers.sample, perfbench.drivers.train_elbo, "
            "perfbench.systems.nsf, perfbench.systems.realnvp, "
            "normalizingflows_torch, normalizingflows_torch.experimental; "
            "from perfbench import guard; print(guard.forbidden())"
            % str(spec.REPO))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True)
    assert out.stdout.strip() == "[]"


def test_the_reference_imports_nothing_of_the_program():
    import ast

    from perfbench import spec

    for path in (spec.HERE / "reference").glob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            for n in names:
                assert n.split(".")[0] not in (
                    "normalizingflows_torch", "normalizingflows", "jax",
                    "jaxlib", "flax"), (path.name, n)
