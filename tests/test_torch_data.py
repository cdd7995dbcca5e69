"""The port's dataset format and minibatch streams (edrgp_tpu_torch.data)
against the JAX package's (edrgp_tpu.data): the same file bytes, and the same
batches for the same seed from the native loader (each package builds its
own copy of it) and from the NumPy stream."""

import itertools
from pathlib import Path

import numpy as np
import pytest

import edrgp_tpu.data as jdata
from edrgp_tpu_torch import data
from edrgp_tpu_torch.ops.cuda._build import BUILD_DIR

REPO = Path(__file__).resolve().parents[1]


def _rows(n=97, q=3, seed=0):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(n, q)), rng.normal(size=n)


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("data") / "d.edrg")
    data.write_dataset(path, *_rows())
    return path


def _take(stream, k):
    return [(X.copy(), y.copy()) for X, y in itertools.islice(stream, k)]


def _assert_same_batches(a, b):
    assert len(a) == len(b)
    for (Xa, ya), (Xb, yb) in zip(a, b):
        np.testing.assert_array_equal(Xa, Xb)
        np.testing.assert_array_equal(ya, yb)


@pytest.mark.parametrize("port_writes", [True, False])
def test_files_are_byte_identical_and_read_by_either_package(tmp_path,
                                                             port_writes):
    X, y = _rows()
    ours, theirs = str(tmp_path / "port.edrg"), str(tmp_path / "jax.edrg")
    data.write_dataset(ours, X, y)
    jdata.write_dataset(theirs, X, y)
    assert Path(ours).read_bytes() == Path(theirs).read_bytes()
    path = ours if port_writes else theirs
    idx = np.array([0, 5, 96, 5])
    for reader in (data.MMapDataset(path), data.MMapDataset(path, True),
                   jdata.MMapDataset(path)):
        assert (reader.n_rows, reader.n_features) == (97, 3)
        Xr, yr = reader.read_rows(idx)
        np.testing.assert_array_equal(Xr, X[idx].astype(np.float32))
        np.testing.assert_array_equal(yr, y[idx].astype(np.float32))
        reader.close()


def test_bad_files_are_refused(tmp_path):
    path = tmp_path / "bad.edrg"
    path.write_bytes(b"NOPE" + bytes(20))
    with pytest.raises(OSError):
        data.MMapDataset(str(path))
    with pytest.raises(OSError):
        data.MMapDataset(str(path), force_numpy=True)
    with pytest.raises(ValueError, match="row counts"):
        data.write_dataset(str(path), np.zeros((3, 2)), np.zeros(4))


@pytest.mark.parametrize("with_replacement", [True, False])
def test_native_stream_matches_jax_bitwise(dataset, with_replacement):
    """Both native loaders draw from SplitMix64 with the same seed; without
    replacement 12 batches of 16 cross the 97-row epoch twice."""
    assert jdata.native_available(), "the JAX package's loader is not built"
    ours, theirs = data.MMapDataset(dataset), jdata.MMapDataset(dataset)
    assert ours._handle is not None and theirs._handle is not None
    try:
        _assert_same_batches(
            _take(ours.batches(16, seed=11,
                               with_replacement=with_replacement), 12),
            _take(theirs.batches(16, seed=11,
                                 with_replacement=with_replacement), 12))
    finally:
        ours.close()
        theirs.close()


@pytest.mark.parametrize("with_replacement", [True, False])
def test_numpy_stream_matches_jax(dataset, with_replacement):
    ours = data.MMapDataset(dataset, force_numpy=True)
    theirs = jdata.MMapDataset(dataset, force_numpy=True)
    _assert_same_batches(
        _take(ours.batches(16, seed=4, with_replacement=with_replacement), 9),
        _take(theirs.batches(16, seed=4,
                             with_replacement=with_replacement), 9))


def test_a_second_stream_on_one_handle(dataset):
    """The native handle takes one stream; a second ``batches`` is served
    by a fresh mapping of the same file, with its own seed."""
    ds = data.MMapDataset(dataset)
    try:
        first = _take(ds.batches(8, seed=1), 3)
        second = _take(ds.batches(8, seed=2), 3)
        fresh = data.MMapDataset(dataset)
        _assert_same_batches(second, _take(fresh.batches(8, seed=2), 3))
        fresh.close()
        assert not np.array_equal(first[0][0], second[0][0])
    finally:
        ds.close()


def test_native_library_is_the_ports_own_build(dataset):
    data.MMapDataset(dataset).close()
    loaded = Path(data._lib._name).resolve()
    assert loaded == data.library_path().resolve()
    assert loaded.parent == BUILD_DIR.resolve()
    assert loaded.name.startswith("libedrgp_data-")
    assert loaded != (REPO / "native" / "libedrgp_data.so").resolve()
    assert data.native_available()


@pytest.mark.parametrize("compiler", ["/nonexistent/g++", "false"])
def test_failed_build_raises(tmp_path, compiler):
    """A missing compiler or a failed compile raises; nothing falls back."""
    with pytest.raises(RuntimeError):
        data.build_native(compiler=compiler, build_dir=tmp_path)
    assert not list(tmp_path.iterdir())


def test_numpy_stream_waits_for_a_slow_consumer(dataset):
    """A consumer that stalls past the producer's 1 s put timeout still
    gets the seed's stream: the producer waits for room and drops nothing
    (the JAX package's producer drops that batch)."""
    import time
    fast = _take(data.MMapDataset(dataset, True).batches(8, seed=9,
                                                        n_buffers=1), 4)
    stream = data.MMapDataset(dataset, True).batches(8, seed=9, n_buffers=1)
    slow = _take(stream, 1)
    time.sleep(1.5)
    _assert_same_batches(fast, slow + _take(stream, 3))
