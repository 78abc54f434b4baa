"""The port's plots (`utils/viz.py`) against the JAX package's
(`jl_tpu/utils/viz.py`), with matplotlib's Agg backend: each function's
figure has JAX's groups, labels, colours and point counts, ``save_to``
writes a PNG, `visualize`'s density grid equals the JAX function's on the
same target and grid (float64, rtol 1e-6), and importing the module does
not import matplotlib."""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

jax = pytest.importorskip("jax")
matplotlib = pytest.importorskip("matplotlib")
matplotlib.use("Agg")
import jax.numpy as jnp  # noqa: E402
import matplotlib.collections  # noqa: E402
import matplotlib.colors as mcolors  # noqa: E402
import matplotlib.pyplot as plt  # noqa: E402
import torch  # noqa: E402

import normalizingflows as nf  # noqa: E402
from normalizingflows.jl_tpu.utils import viz as jviz  # noqa: E402
import normalizingflows_torch as nft  # noqa: E402
from normalizingflows_torch.utils import viz  # noqa: E402

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parents[1]


def _scatters(fig):
    """(label, RGBA colour, alpha, point count) of each scatter group."""
    ax = fig.axes[0]
    return [(c.get_label(),
             tuple(np.round(mcolors.to_rgba(c.get_facecolor()[0]), 6)),
             c.get_alpha(), len(c.get_offsets()))
            for c in ax.collections
            if isinstance(c, matplotlib.collections.PathCollection)]


def _texts(fig):
    ax = fig.axes[0]
    return ax.get_xlabel(), ax.get_ylabel(), ax.get_title()


def test_compare_trained_and_untrained_flow(tmp_path):
    target_j, target_t = nf.Banana(2, 1.0, 10.0), nft.Banana(2, 1.0, 10.0)
    k1, k2 = jax.random.split(jax.random.key(0))
    fj = jviz.compare_trained_and_untrained_flow(
        nf.realnvp(k1, 2, (8,), nlayers=1), nf.realnvp(k2, 2, (8,),
                                                      nlayers=1),
        target_j, jax.random.key(0), n_samples=50)
    g = torch.Generator().manual_seed(0)
    out = tmp_path / "cmp.png"
    ft = viz.compare_trained_and_untrained_flow(
        nft.realnvp(g, 2, (8,), nlayers=1, device="cpu"),
        nft.realnvp(g, 2, (8,), nlayers=1, device="cpu"), target_t,
        torch.Generator().manual_seed(1), n_samples=50, save_to=str(out))
    assert _scatters(ft) == _scatters(fj)
    assert [s[0] for s in _scatters(ft)] == ["trained flow", "untrained flow",
                                             "target"]
    assert all(s[3] == 50 for s in _scatters(ft))
    assert _texts(ft) == _texts(fj)
    leg_t, leg_j = ft.axes[0].get_legend(), fj.axes[0].get_legend()
    assert [t.get_text() for t in leg_t.get_texts()] == \
        [t.get_text() for t in leg_j.get_texts()]
    assert out.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"
    # d > 2: the two coordinates ``dims`` picks
    f3 = viz.compare_trained_and_untrained_flow(
        nft.realnvp(g, 3, (8,), nlayers=1, device="cpu"),
        nft.realnvp(g, 3, (8,), nlayers=1, device="cpu"),
        nft.Banana(3, 1.0, 10.0), torch.Generator().manual_seed(1),
        n_samples=20, dims=(0, 2))
    assert f3.axes[0].get_ylabel() == "x[2]"
    plt.close("all")


@pytest.mark.parametrize("kind", ["warped", "banana", "cross"])
def test_visualize_density_grid_matches_jax(tmp_path, kind):
    """The same samples through both functions: the same padded box, the
    same 40×40 grid and density (float64, rtol 1e-6), the same contour
    levels, and the samples as one white group."""
    targets = {"warped": (nf.WarpedGauss(), nft.WarpedGauss()),
               "banana": (nf.Banana(2, 1.0, 10.0), nft.Banana(2, 1.0, 10.0)),
               "cross": (nf.Cross(dtype=jnp.float64),
                         nft.Cross(dtype=torch.float64,
                                   device="cpu"))}
    tj, tt = targets[kind]
    samples = np.asarray(tj.sample(jax.random.key(3), (64,)), np.float64)
    fj = jviz.visualize(tj, samples=samples, grid_res=40)
    out = tmp_path / "viz.png"
    ft = viz.visualize(tt, samples=samples, grid_res=40, save_to=str(out))
    assert out.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"
    lo, hi = samples.min(axis=0), samples.max(axis=0)
    pad = 0.1 * (hi - lo)
    lims = (lo[0] - pad[0], hi[0] + pad[0], lo[1] - pad[1], hi[1] + pad[1])
    xx, yy, p = viz.density_grid(tt, lims, 40, dtype=torch.float64)
    pts = np.stack([xx.ravel(), yy.ravel()], axis=-1)
    want = np.exp(np.asarray(jax.jit(tj.log_prob)(jnp.asarray(pts))))
    np.testing.assert_allclose(p.ravel(), want, rtol=1e-6, atol=1e-300)
    levels_t = ft.axes[0].collections[0].levels
    levels_j = fj.axes[0].collections[0].levels
    np.testing.assert_allclose(levels_t, levels_j, rtol=1e-6)
    assert _scatters(ft) == _scatters(fj)
    assert _texts(ft) == _texts(fj)
    plt.close("all")


def test_visualize_draws_its_own_samples():
    fig = viz.visualize(nft.WarpedGauss(), n_samples=64, grid_res=20)
    assert _scatters(fig)[0][3] == 64
    plt.close("all")


def test_plot_losses(tmp_path):
    stats = {"iteration": np.arange(1, 101),
             "loss": np.linspace(100.0, 1.0, 100)}
    out = tmp_path / "loss.png"
    ft = viz.plot_losses(stats, save_to=str(out))
    fj = jviz.plot_losses(stats)
    assert out.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"
    (line,) = ft.axes[0].get_lines()
    np.testing.assert_array_equal(line.get_xdata(), stats["iteration"])
    np.testing.assert_array_equal(line.get_ydata(), stats["loss"])
    assert ft.axes[0].get_yscale() == fj.axes[0].get_yscale() == "symlog"
    assert _texts(ft) == _texts(fj)
    plt.close("all")


def test_importing_viz_does_not_import_matplotlib():
    code = ("import sys\n"
            f"sys.path.insert(0, {str(ROOT)!r})\n"
            "import normalizingflows_torch as nft\n"
            "from normalizingflows_torch.utils import viz\n"
            "assert 'matplotlib' not in sys.modules\n"
            "assert nft.visualize is viz.visualize\n"
            "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
