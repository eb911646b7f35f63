"""The port's host kernels (``ray_shuffling_data_loader_tpu_torch.native``)
against two references on the same seeded inputs: the port's plain numpy
version of each wrapper, and the JAX package's ``native`` module. Every
output must be the same bits. The first test to load the library builds
it with g++; the rest share that build."""

import importlib
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

from ray_shuffling_data_loader_tpu import native as jax_native
from ray_shuffling_data_loader_tpu_torch import native
from ray_shuffling_data_loader_tpu_torch import shuffle as port_shuffle

# The JAX package's root exports its ``shuffle`` function under the module's name.
jax_shuffle = importlib.import_module("ray_shuffling_data_loader_tpu.shuffle")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# Rows of 1, 2, 4 and 8 bytes (the typed loops), 3-byte and 12-byte rows
# (the byte-copy loops) and a float column.
WIDTHS = {
    "u8": lambda rng, n: rng.integers(0, 255, size=n).astype(np.uint8),
    "i16": lambda rng, n: rng.integers(-(1 << 14), 1 << 14, size=n).astype(np.int16),
    "i32": lambda rng, n: rng.integers(-(1 << 30), 1 << 30, size=n).astype(np.int32),
    "f32": lambda rng, n: rng.random(n).astype(np.float32),
    "i64": lambda rng, n: rng.integers(0, 1 << 40, size=n),
    "f64": lambda rng, n: rng.random(n),
    "rows3": lambda rng, n: rng.integers(0, 255, size=(n, 3)).astype(np.uint8),
    "rows2d": lambda rng, n: rng.random((n, 3)).astype(np.float32),
}


@pytest.fixture(autouse=True)
def native_on(monkeypatch):
    monkeypatch.delenv(native.ENV_DISABLE, raising=False)
    native.set_enabled(None)
    yield
    native.set_enabled(None)


def _same(*arrays):
    first = arrays[0]
    for a in arrays[1:]:
        assert a.dtype == first.dtype and a.shape == first.shape
        assert a.tobytes() == first.tobytes()


def _ran(before, kernel, how="native"):
    return native.counts_since(before)[how][kernel]


def test_native_builds_into_the_build_directory():
    assert native.native_available()
    path = native.build()
    assert path == native.library_path() and path.is_file()
    assert path.parent.name == "kernels" and path.name.startswith("librsdl_native-")
    assert native.load().rsdl_abi_version() == native.ABI_VERSION == 5
    assert jax_native.native_available()


@pytest.mark.parametrize("width", sorted(WIDTHS))
def test_take_at_every_width(width):
    rng = np.random.default_rng(1234)
    arr = WIDTHS[width](rng, 10_001)
    for idx in (rng.permutation(len(arr)), rng.integers(0, len(arr), size=137)):
        before = native.counts()
        got = native.take(arr, idx)
        assert _ran(before, "take") == 1
        _same(got, native.take_plain(arr, idx), jax_native.take(arr, idx), arr[idx])
    # Into a destination, threaded past one thread's rows.
    big = WIDTHS[width](rng, 1_100_000)
    idx = rng.permutation(len(big))
    out = np.empty_like(big)
    assert native.take(big, idx, out=out, n_threads=4) is out
    _same(out, jax_native.take(big, idx), native.take_plain(big, idx))


def test_take_bounds_semantics():
    rng = np.random.default_rng(7)
    arr = rng.integers(0, 100, size=100)
    neg = np.array([-1, -100, 5])
    _same(native.take(arr, neg), jax_native.take(arr, neg), native.take_plain(arr, neg), arr[neg])
    for bad in (np.array([0, 100]), np.array([-101])):
        for mod in (native, jax_native):
            with pytest.raises(IndexError):
                mod.take(arr, bad)
        with pytest.raises(IndexError):
            native.take_plain(arr, bad)
    # A destination the kernel began to write is zeroed again on the raise.
    out = np.ones(3, dtype=arr.dtype)
    with pytest.raises(IndexError):
        native.take(arr, np.array([1, 2, 100]), out=out)
    assert not out.any()
    with pytest.raises(ValueError, match="out= mismatch"):
        native.take(arr, np.arange(3), out=np.empty(4, dtype=arr.dtype))


def test_take_multi_dense():
    rng = np.random.default_rng(11)
    parts = [rng.integers(0, 100, size=n) for n in (1000, 1, 5000, 0, 333)]
    idx = rng.permutation(sum(len(p) for p in parts))
    before = native.counts()
    got = native.take_multi(parts, idx)
    assert _ran(before, "take_multi") == 1
    _same(got, native.take_multi_plain(parts, idx), jax_native.take_multi(parts, idx), np.concatenate(parts)[idx])
    # Hundreds of parts, some empty, many inside one 1024-row block of the
    # kernel's part table.
    parts = [rng.integers(0, 1 << 30, size=int(rng.integers(0, 40))).astype(np.int32) for _ in range(300)]
    idx = rng.permutation(sum(len(p) for p in parts))
    _same(native.take_multi(parts, idx), jax_native.take_multi(parts, idx), np.concatenate(parts)[idx])
    # Every width, into a destination, threaded.
    for width in sorted(WIDTHS):
        parts = [WIDTHS[width](rng, n) for n in (400_000, 3, 700_000)]
        idx = rng.permutation(sum(len(p) for p in parts))
        out = np.empty((len(idx), *parts[0].shape[1:]), parts[0].dtype)
        assert native.take_multi(parts, idx, out=out, n_threads=8) is out
        _same(out, jax_native.take_multi(parts, idx), np.concatenate(parts)[idx])


def test_take_multi_sparse():
    rng = np.random.default_rng(12)
    parts = [rng.integers(0, 1 << 20, size=n) for n in (4000, 0, 9000, 17, 2500)]
    cat = np.concatenate(parts)
    idx = rng.choice(len(cat), size=len(cat) // 8, replace=False)
    _same(native.take_multi(parts, idx), native.take_multi_plain(parts, idx), jax_native.take_multi(parts, idx),
          cat[idx])
    parts2d = [rng.random((n, 3)) for n in (700, 1200, 5)]
    idx2 = rng.choice(sum(len(p) for p in parts2d), size=64, replace=False)
    out = np.empty((64, 3))
    assert native.take_multi(parts2d, idx2, out=out) is out
    _same(out, native._take_multi_sparse(parts2d, idx2.astype(np.int64), None),
          jax_native._take_multi_sparse(parts2d, idx2.astype(np.int64), None), np.concatenate(parts2d)[idx2])
    # Mixed dtypes keep numpy's promotion (through the concat), counted as numpy.
    mixed = [np.arange(100, dtype=np.int32), np.arange(100, dtype=np.int64) + (1 << 40)]
    midx = np.array([5, 150, 199])
    before = native.counts()
    got = native.take_multi(mixed, midx)
    assert _ran(before, "take_multi", "plain") == 1
    _same(got, jax_native.take_multi(mixed, midx), np.concatenate(mixed)[midx])
    with pytest.raises(IndexError):
        native.take_multi(parts, np.array([len(cat)]))
    neg = np.array([-1, 3])
    _same(native.take_multi(parts, neg), jax_native.take_multi(parts, neg), cat[neg])


def test_narrow_casts():
    rng = np.random.default_rng(13)
    a = rng.integers(-(2**31), 2**31 - 1, size=9999)
    f = rng.random(9999) * 1e30
    before = native.counts()
    _same(native.narrow(a, np.int32), native.narrow_plain(a, np.int32), jax_native.narrow(a, np.int32))
    _same(native.narrow(f, np.float32), native.narrow_plain(f, np.float32), jax_native.narrow(f, np.float32))
    _same(native.narrow_i64_checked(a), native.narrow_i64_checked_plain(a), jax_native.narrow_i64_checked(a))
    assert _ran(before, "narrow") == 3
    i32 = a.astype(np.int32)
    assert native.narrow(i32, np.int32) is i32
    big = rng.integers(0, 2**31 - 1, size=2_000_000)
    _same(native.narrow_i64_checked(big, n_threads=8), jax_native.narrow_i64_checked(big), big.astype(np.int32))


def test_narrowing_out_of_range_raises():
    for v in (2**40, -(2**31) - 1, 2**31):
        arr = np.array([1, v, 3], dtype=np.int64)
        assert native.narrow_i64_checked(arr) is None
        assert native.narrow_i64_checked_plain(arr) is None
        assert jax_native.narrow_i64_checked(arr) is None
    with pytest.raises(TypeError):
        native.narrow_i64_checked(np.zeros(3, np.int32))
    bad = np.array([2**40], dtype=np.int64)
    with pytest.raises(ValueError) as port_err:
        port_shuffle._narrow_column("big", bad)
    with pytest.raises(ValueError) as jax_err:
        jax_shuffle._narrow_column("big", bad)
    assert str(port_err.value) == str(jax_err.value)


def test_group_rows_stable():
    rng = np.random.default_rng(14)
    arr = rng.integers(0, 1 << 40, size=20_000)
    assign = rng.integers(0, 7, size=len(arr))
    grouped, offsets = native.group_rows(arr, assign, 7)
    jg, joff = jax_native.group_rows(arr, assign, 7)
    _same(grouped, jg, arr[np.argsort(assign, kind="stable")])
    _same(offsets, joff)
    np.testing.assert_array_equal(np.diff(offsets), np.bincount(assign, minlength=7))
    g0, off0 = native.group_rows(arr, np.zeros(len(arr), dtype=np.int64), 3)
    _same(g0, arr)
    assert off0[1] == off0[2] == off0[3] == len(arr)
    with pytest.raises(ValueError, match="assignment"):
        native.group_rows(arr, np.full(len(arr), 7), 7)


@pytest.mark.parametrize("n", [20_001, 1_048_577])
def test_group_rows_multi_threaded_bit_identity(n):
    """At 1,048,577 rows (two threads' worth and one more) 2 and 8 threads
    take the two-pass parallel scatter; every width and an empty group."""
    rng = np.random.default_rng(15)
    cols = {k: WIDTHS[k](rng, n) for k in ("u8", "i16", "i32", "i64", "rows3")}
    assign = rng.choice([0, 1, 2, 4, 5], size=n)
    plain, plain_off = native.group_rows_multi_plain(cols, assign, 6)
    for t in (1, 2, 8):
        got, offsets = native.group_rows_multi(cols, assign, 6, n_threads=t)
        ref, ref_off = jax_native.group_rows_multi(cols, assign, 6, n_threads=t)
        for k in cols:
            _same(got[k], plain[k], ref[k])
        _same(offsets, plain_off, ref_off)
        assert offsets[4] == offsets[3]


def test_group_rows_multi_into_out_views():
    rng = np.random.default_rng(16)
    n = 1_200_000
    cols = {"a": rng.integers(0, 1 << 30, size=n).astype(np.int32), "b": rng.random(n).astype(np.float32)}
    assign = rng.integers(0, 8, size=n)
    for t in (1, 8):
        # Views of one segment, as the map's store destination.
        seg = np.empty((2, n), dtype=np.int32)
        out = {"a": seg[0], "b": seg[1].view(np.float32)}
        got, _ = native.group_rows_multi(cols, assign, 8, out=out, n_threads=t)
        assert got["a"] is out["a"] and got["b"] is out["b"]
        ref, _ = jax_native.group_rows_multi(cols, assign, 8)
        _same(out["a"], ref["a"])
        _same(out["b"], ref["b"])
    with pytest.raises(KeyError):
        native.group_rows_multi(cols, assign, 8, out={"a": np.empty_like(cols["a"])})


@pytest.mark.parametrize("width", ["i32", "rows2d", "rows3", "i64"])
def test_scatter_matches(width):
    rng = np.random.default_rng(17)
    n = 10_000
    perm = rng.permutation(n)
    arr = WIDTHS[width](rng, n)
    for t in (1, 2, 8):
        out, ref, plain = np.zeros_like(arr), np.zeros_like(arr), np.zeros_like(arr)
        before = native.counts()
        assert native.scatter(arr, perm, out, n_threads=t) is out
        assert _ran(before, "scatter") == 1
        jax_native.scatter(arr, perm, ref, n_threads=t)
        native.scatter_plain(arr, perm, plain)
        _same(out, ref, plain)
    # A window of an inverted permutation, the real call's shape.
    inv = np.empty(n, dtype=np.int64)
    inv[perm] = np.arange(n)
    out, ref = np.zeros_like(arr), np.zeros_like(arr)
    native.scatter(arr[: n // 4], inv[: n // 4], out)
    jax_native.scatter(arr[: n // 4], inv[: n // 4], ref)
    _same(out, ref)


def test_scatter_bounds_and_numpy_paths():
    rng = np.random.default_rng(18)
    arr = rng.integers(0, 100, size=10)
    out = np.zeros(10, dtype=arr.dtype)
    with pytest.raises(IndexError):
        native.scatter(arr, np.arange(5, 15), out)
    with pytest.raises(ValueError):
        native.scatter(arr, np.arange(3), out)
    out[:] = 0
    native.scatter(arr[:2], np.array([-1, -2]), out)
    assert out[-1] == arr[0] and out[-2] == arr[1]


def test_calls_numpy_takes_are_counted_as_plain():
    """A non-contiguous input goes to numpy for that call, counted so; a
    call with nothing to do is not counted."""
    rng = np.random.default_rng(19)
    strided = rng.integers(0, 100, size=(100, 2))[:, 0]
    idx = rng.permutation(100)
    before = native.counts()
    _same(native.take(strided, idx), strided[idx])
    native.take(strided, np.zeros(0, dtype=np.int64))
    native.narrow(np.zeros(0, np.int64), np.int32)
    delta = native.counts_since(before)
    assert delta["plain"]["take"] == 1 and delta["native"]["take"] == 0
    assert sum(delta["plain"].values()) + sum(delta["native"].values()) == 1


def test_disabled_takes_the_plain_versions(monkeypatch):
    rng = np.random.default_rng(20)
    arr = rng.integers(0, 1 << 40, size=1000)
    idx = rng.permutation(1000)
    # The JAX package reads the same variable once per process, at its
    # first kernel call: keep its kernels on for later tests here.
    assert jax_native.native_available()
    monkeypatch.setenv("RSDL_DISABLE_NATIVE", "1")
    assert not native.enabled()
    before = native.counts()
    _same(native.take(arr, idx), arr[idx])
    got, _ = native.group_rows_multi({"a": arr}, idx % 3, 3)
    _same(got["a"], arr[np.argsort(idx % 3, kind="stable")])
    delta = native.counts_since(before)
    assert delta["native"]["take"] == 0 and delta["plain"]["take"] == 1 and delta["plain"]["group_rows"] == 1
    # The shuffle's decision, handed to a task, outranks a worker's environment.
    native.set_enabled(True)
    before = native.counts()
    native.take(arr, idx)
    assert _ran(before, "take") == 1


def test_native_threads_env_knob(monkeypatch):
    default = native.num_threads()
    assert default == max(1, min(8, os.cpu_count() or 1))
    monkeypatch.setenv(native.ENV_THREADS, "5")
    native.refresh_threads_from_env()
    assert native.num_threads() == 5
    monkeypatch.setenv(native.ENV_THREADS, "0")
    native.refresh_threads_from_env()
    assert native.num_threads() == 1
    monkeypatch.setenv(native.ENV_THREADS, "junk")
    native.refresh_threads_from_env()
    assert native.num_threads() == default
    native.set_num_threads(3)
    assert native.num_threads() == 3
    native.set_num_threads(None)
    assert native.num_threads() == 3
    monkeypatch.delenv(native.ENV_THREADS)
    native.refresh_threads_from_env()
    assert native.num_threads() == default


def test_a_failed_build_raises(tmp_path):
    """No silent fallback: a missing compiler, or one that fails, raises a
    RuntimeError that names g++ and carries what the compiler said."""
    with pytest.raises(RuntimeError, match="g\\+\\+") as missing:
        native.build(cxx=str(tmp_path / "no-such-g++"), directory=tmp_path)
    assert "cannot run" in str(missing.value)
    failing = tmp_path / "failing-cxx"
    failing.write_text("#!/bin/sh\necho 'kernels.cc:1: error: made up' >&2\nexit 1\n")
    failing.chmod(0o755)
    with pytest.raises(RuntimeError, match="g\\+\\+ exited 1") as failed:
        native.build(cxx=str(failing), directory=tmp_path)
    assert "error: made up" in str(failed.value)
    assert not list(tmp_path.glob("*.so"))


def test_import_leaves_torch_out(tmp_path):
    script = textwrap.dedent(f"""
        import sys
        sys.path.insert(0, {REPO!r})
        import numpy as np
        import ray_shuffling_data_loader_tpu_torch.native as native
        native.take(np.arange(10), np.arange(10)[::-1].copy())
        assert native.counts()["native"]["take"] == 1
        print("torch" in sys.modules, "ray_shuffling_data_loader_tpu" in sys.modules)
    """)
    out = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True, timeout=120,
                         cwd=str(tmp_path))
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["False", "False"]
