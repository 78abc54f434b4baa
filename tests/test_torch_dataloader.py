"""The port's data loaders against the JAX package's.

`NativeLoader` binds the same `native/dataloader.cc` as the JAX package's:
from one seed both yield the same batches, bit for bit (one producer
thread, one xoshiro256** stream). Plus an epoch's coverage, the reshuffle
between epochs, `make_loader`'s dispatch, ``next_batches(k, out=)`` into
a caller's buffer, and a build that fails raising.
"""

import numpy as np
import pytest

pytest.importorskip("jax")
import torch  # noqa: E402

from normalizingflows.jl_tpu.utils import data as jax_data  # noqa: E402
from normalizingflows_torch.utils import data  # noqa: E402

torch.set_num_threads(1)

ROWS, DIM = 1000, 3


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    rng = np.random.default_rng(0)
    arr = (rng.standard_normal((ROWS, DIM)) * [1.0, 2.0, 0.5]
           + [3.0, -1.0, 0.0]).astype(np.float32)
    path = str(tmp_path_factory.mktemp("data") / "train.f32")
    data.to_raw_file(path, arr)
    return path, arr


def _sorted(rows):
    return rows[np.lexsort(rows.T)]


def _epochs(k, batch):
    """Epochs completed by k batches' rows (the producer's count once it
    has filled exactly k batches)."""
    return (k * batch - 1) // ROWS if k else 0


@pytest.mark.parametrize("batch,seed", [(64, 1), (300, 7)])
def test_native_loader_gives_the_jax_batches(dataset, batch, seed):
    """From one seed, across epoch ends (a batch that does not divide the
    rows), through `next` and `next_batches` alike. The port's `epoch`
    counts the batches handed out; JAX's reads its producer thread, which
    may have filled up to `n_prefetch` (4) batches more."""
    path, _ = dataset
    ours = data.NativeLoader(path, ROWS, DIM, batch, seed=seed)
    theirs = jax_data.NativeLoader(path, ROWS, DIM, batch, seed=seed)
    try:
        assert ours.epoch == 0
        for _ in range(4):
            np.testing.assert_array_equal(next(ours), next(theirs))
            b = ours.next_batches(4)
            assert b.dtype == np.float32 and b.shape == (4, batch, DIM)
            np.testing.assert_array_equal(b, theirs.next_batches(4))
        k = 4 * 5
        assert ours.epoch == _epochs(k, batch) > 0
        assert _epochs(k, batch) <= theirs.epoch <= _epochs(k + 4, batch)
    finally:
        ours.close()
        theirs.close()


def test_an_epoch_covers_every_row(dataset):
    path, arr = dataset
    loader = data.NativeLoader(path, ROWS, DIM, 100, seed=2)
    rows = loader.next_batches(10).reshape(-1, DIM)
    loader.close()
    np.testing.assert_array_equal(_sorted(rows), _sorted(arr))


def test_reshuffles_between_epochs(dataset):
    path, arr = dataset
    loader = data.NativeLoader(path, ROWS, DIM, ROWS, seed=3)
    e1, e2 = next(loader), next(loader)
    loader.close()
    assert not np.array_equal(e1, e2)
    np.testing.assert_array_equal(_sorted(e1), _sorted(e2))


def test_make_loader_dispatch(dataset, tmp_path):
    """Arrays and .npy through `NumpyLoader`, a raw file through
    `NativeLoader` (its rows from the file's size when not given), the
    same batches as JAX's `make_loader` from one seed."""
    path, arr = dataset
    np.save(tmp_path / "a.npy", arr)
    for src in (arr, str(tmp_path / "a.npy")):
        loader = data.make_loader(src, 32, seed=5)
        assert isinstance(loader, data.NumpyLoader)
        np.testing.assert_array_equal(
            loader.next_batches(3),
            jax_data.make_loader(arr, 32, seed=5).next_batches(3))
    for n_rows in (ROWS, None):
        loader = data.make_loader(path, 32, n_rows=n_rows, dim=DIM, seed=5)
        theirs = jax_data.make_loader(path, 32, n_rows=ROWS, dim=DIM,
                                      seed=5)
        assert isinstance(loader, data.NativeLoader)
        assert loader.n_rows == ROWS
        np.testing.assert_array_equal(loader.next_batches(3),
                                      theirs.next_batches(3))
        loader.close()
        theirs.close()
    with pytest.raises(ValueError, match="dim"):
        data.make_loader(path, 32)
    with pytest.raises(ValueError, match="whole number"):
        data.make_loader(path, 32, dim=7)
    with pytest.raises(IOError):
        data.NativeLoader(path, ROWS + 1, DIM, 32)


@pytest.mark.parametrize("kind", ["native", "numpy"])
def test_next_batches_writes_into_out(dataset, kind):
    """``next_batches(k, out=)`` writes the batches of ``next_batches(k)``
    into a numpy buffer or a CPU tensor of at least k batches and returns
    its first k; a buffer of the wrong shape or dtype raises."""
    path, arr = dataset

    def make():
        return (data.NativeLoader(path, ROWS, DIM, 64, seed=4)
                if kind == "native" else data.NumpyLoader(arr, 64, seed=4))

    want, a, b = make(), make(), make()
    ref = want.next_batches(6)
    buf = np.full((5, 64, DIM), np.nan, dtype=np.float32)
    got = a.next_batches(3, out=buf)
    assert np.shares_memory(got, buf) and got.shape == (3, 64, DIM)
    np.testing.assert_array_equal(buf[:3], ref[:3])
    assert np.isnan(buf[3:]).all()
    t = torch.empty((3, 64, DIM))
    b.next_batches(3, out=t)
    a.next_batches(2, out=buf[3:])
    np.testing.assert_array_equal(buf[3:], ref[3:5])
    np.testing.assert_array_equal(t.numpy(), ref[:3])
    for bad in (np.empty((2, 64, DIM), np.float32),
                np.empty((3, 64, DIM), np.float64),
                np.empty((3, 32, DIM), np.float32)):
        with pytest.raises(ValueError, match="out must be"):
            a.next_batches(3, out=bad)
    for loader in (want, a, b):
        loader.close()


def test_a_failed_build_raises(tmp_path):
    """No numpy fallback: a compiler that is not there raises, and so
    does one that fails, naming the compiler."""
    with pytest.raises(RuntimeError, match="no-such-g"):
        data.build_native(cxx=str(tmp_path / "no-such-g++"),
                          build_dir=tmp_path / "build")
    with pytest.raises(RuntimeError, match="false.*failed"):
        data.build_native(cxx="false", build_dir=tmp_path / "build")
    assert not list((tmp_path / "build").glob("*.so"))
    lib = data.build_native(build_dir=tmp_path / "ok")
    assert lib.exists() and lib.parent == tmp_path / "ok"
    assert data.build_native(build_dir=tmp_path / "ok") == lib


def test_train_flow_mle_fills_one_host_buffer(dataset):
    """`train_flow_mle` hands the port's loaders one host buffer of
    ``check_every`` batches to write into, chunk after chunk (a short last
    chunk into its head), and trains on what they wrote: the same bits as
    a loader that returns its batches, which are copied in."""
    import normalizingflows_torch as nft

    path, _ = dataset
    seen = []

    class Spy(data.NativeLoader):
        def next_batches(self, k, out=None):
            seen.append((k, out.data_ptr(), tuple(out.shape)))
            return super().next_batches(k, out=out)

    class Returns:
        def __init__(self, loader):
            self.loader = loader

        def next_batches(self, k):
            return self.loader.next_batches(k)

    def run(loader):
        flow = nft.realnvp(torch.Generator().manual_seed(0), DIM, (8, 8),
                           nlayers=2, device="cpu")
        return nft.train_flow_mle(
            flow, loader, max_iters=7, check_every=3,
            optimizer=lambda p: torch.optim.Adam(p, lr=1e-2)).stats["loss"]

    spy, native = (Spy(path, ROWS, DIM, 50, seed=8),
                   data.NativeLoader(path, ROWS, DIM, 50, seed=8))
    a, b = run(spy), run(Returns(native))
    spy.close()
    native.close()
    assert [k for k, _, _ in seen] == [3, 3, 1]
    assert len({ptr for _, ptr, _ in seen}) == 1
    assert [s for _, _, s in seen] == [(3, 50, DIM)] * 2 + [(1, 50, DIM)]
    assert a.shape == (7,) and np.all(np.isfinite(a))
    np.testing.assert_array_equal(a, b)
