"""The port's loader against the JAX package's: same Parquet, same row
stream, same staged tensors."""

import os
import sys
import threading
import uuid

import numpy as np
import pyarrow.parquet as pq
import pytest
import torch

from ray_shuffling_data_loader_tpu import data_generation as jax_gen
from ray_shuffling_data_loader_tpu import dataset as jax_dataset
from ray_shuffling_data_loader_tpu.jax_dataset import JaxShufflingDataset
from ray_shuffling_data_loader_tpu.runtime import ColumnBatch as JaxColumnBatch
from ray_shuffling_data_loader_tpu_torch import runtime as port_runtime
from ray_shuffling_data_loader_tpu_torch import data_generation as port_gen
from ray_shuffling_data_loader_tpu_torch.dataset import CarryRebatcher, ShufflingDataset
from ray_shuffling_data_loader_tpu_torch.device_dataset import DeviceShufflingDataset
from ray_shuffling_data_loader_tpu_torch.runtime import ColumnBatch
from ray_shuffling_data_loader_tpu_torch.shuffle import _narrow_column, shuffle

FEATURES = [c for c in port_gen.DATA_SPEC if c != port_gen.LABEL_COLUMN]


@pytest.fixture(scope="module")
def port_rt():
    port_runtime.init(num_workers=2)
    yield
    port_runtime.shutdown()


@pytest.fixture(scope="module")
def files(tmp_path_factory, port_rt):
    names, _ = port_gen.generate_data(8000, 4, 2, 0.0, str(tmp_path_factory.mktemp("data")))
    return names


def _qname():
    return f"torch-port-{uuid.uuid4().hex[:8]}"


@pytest.mark.parametrize("skew", [0.0, 0.5])
def test_generate_data_writes_the_jax_tables(tmp_path, local_runtime, port_rt, skew):
    port_files, port_bytes = port_gen.generate_data(3000, 3, 4, skew, str(tmp_path / "port"), seed=5)
    jax_files, jax_bytes = jax_gen.generate_data(3000, 3, 4, skew, str(tmp_path / "jax"), seed=5)
    assert port_bytes == jax_bytes
    for p, j in zip(port_files, jax_files):
        pf, jf = pq.ParquetFile(p), pq.ParquetFile(j)
        assert pf.metadata.num_row_groups == jf.metadata.num_row_groups
        assert pf.read().equals(jf.read())


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("skip", [0, 3])
@pytest.mark.parametrize("drop_last", [False, True])
def test_carry_rebatcher_matches_jax(seed, skip, drop_last):
    rng = np.random.default_rng(seed)
    batch_size = int(rng.integers(1, 40))
    sizes = rng.integers(0, 100, size=int(rng.integers(1, 12)))
    port, ref = CarryRebatcher(batch_size, skip), jax_dataset.CarryRebatcher(batch_size, skip)
    got, want, at = [], [], 0
    for n in sizes:
        col = np.arange(at, at + n)
        at += n
        got += [b["k"] for b in port.feed(ColumnBatch({"k": col}))]
        want += [b["k"] for b in ref.feed(JaxColumnBatch({"k": col}))]
    got.append(getattr(port.finish(drop_last), "columns", {}).get("k"))
    want.append(getattr(ref.finish(drop_last), "columns", {}).get("k"))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert (g is None) == (w is None)
        if g is not None:
            np.testing.assert_array_equal(g, w)


def _host_stream(ds, epochs):
    out = []
    for epoch in range(epochs):
        ds.set_epoch(epoch)
        out.append([{k: np.array(v) for k, v in b.items()} for b in ds])
    return out


@pytest.mark.parametrize(
    "num_rows,num_files,num_reducers,batch_size",
    [
        (8000, 4, 4, 768),  # batches straddle reducer outputs
        (15, 3, 8, 4),  # 5-row files: most partitions are empty
    ],
)
def test_row_stream_matches_jax(tmp_path, local_runtime, port_rt, num_rows, num_files, num_reducers, batch_size):
    files, _ = port_gen.generate_data(num_rows, num_files, 2, 0.0, str(tmp_path))
    kwargs = dict(num_reducers=num_reducers, seed=7, narrow_to_32=True)
    want = _host_stream(
        jax_dataset.ShufflingDataset(files, 2, 1, batch_size, 0, queue_name=_qname(), **kwargs), 2
    )
    got = _host_stream(ShufflingDataset(files, 2, 1, batch_size, 0, queue_name=_qname(), **kwargs), 2)
    for g_epoch, w_epoch in zip(got, want):
        assert len(g_epoch) == len(w_epoch) > 0
        for g, w in zip(g_epoch, w_epoch):
            assert list(g) == list(w)
            for name in w:
                assert g[name].dtype == w[name].dtype, name
                np.testing.assert_array_equal(g[name], w[name], err_msg=name)
    # Two epochs are two different permutations.
    assert not np.array_equal(got[0][0]["key"], got[1][0]["key"])


def test_staged_tensors_match_jax(files, local_runtime):
    kwargs = dict(
        feature_columns=[*FEATURES, port_gen.KEY_COLUMN],
        label_column=port_gen.LABEL_COLUMN,
        num_reducers=4,
        seed=7,
    )
    # 1000 rows divide the 8 virtual devices the JAX side shards over.
    jds = JaxShufflingDataset(files, 2, 1, 1000, 0, queue_name=_qname(), **kwargs)
    tds = DeviceShufflingDataset(files, 2, 1, 1000, 0, queue_name=_qname(), device="cpu", **kwargs)
    for epoch in range(2):
        jds.set_epoch(epoch)
        tds.set_epoch(epoch)
        want = [({k: np.asarray(v) for k, v in f.items()}, np.asarray(l)) for f, l in jds]
        got = [(f, l) for f, l in tds]
        assert len(got) == len(want) == 8
        for (gf, gl), (wf, wl) in zip(got, want):
            # The port keeps the spec's column order; JAX's jitted unpack
            # returns its dict in sorted key order.
            assert list(gf) == kwargs["feature_columns"] and set(gf) == set(wf)
            for name in wf:
                assert gf[name].device.type == "cpu"
                assert gf[name].dtype == torch.int32
                np.testing.assert_array_equal(gf[name].numpy(), wf[name], err_msg=name)
            assert gl.dtype == torch.float32
            np.testing.assert_array_equal(gl.numpy(), wl)
    assert tds.stats.batches_staged == 16
    assert tds.stats.bytes_staged == 16 * 1000 * (len(FEATURES) + 2) * 4


def _device_keys(files, epochs, skips=None, drop_last=True, batch_size=1000):
    ds = DeviceShufflingDataset(
        files, epochs, 1, batch_size, 0,
        feature_columns=[port_gen.KEY_COLUMN], label_column=port_gen.LABEL_COLUMN,
        num_reducers=3, seed=11, device="cpu", queue_name=_qname(), drop_last=drop_last,
    )
    out = []
    for epoch in range(epochs):
        ds.set_epoch(epoch, skip_batches=(skips or {}).get(epoch, 0))
        out.append([f[port_gen.KEY_COLUMN].numpy().copy() for f, _ in ds])
    return out


def test_keys_exactly_once_and_skip_batches(files):
    full = _device_keys(files, 2, drop_last=False, batch_size=1500)
    for epoch in full:
        assert [len(k) for k in epoch] == [1500] * 5 + [500]
        np.testing.assert_array_equal(np.sort(np.concatenate(epoch)), np.arange(8000))
    resumed = _device_keys(files, 2, skips={1: 3}, drop_last=False, batch_size=1500)
    assert len(resumed[1]) == len(full[1]) - 3
    for got, want in zip(resumed[1], full[1][3:]):
        np.testing.assert_array_equal(got, want)
    dropped = _device_keys(files, 1, drop_last=True, batch_size=1500)
    assert [len(k) for k in dropped[0]] == [1500] * 5


def test_ranks_take_contiguous_reducer_runs_under_thread_stress(files):
    """More trainer ranks than cores, as threads of one process, with a
    tiny switch interval: rank r's rows, concatenated over its batches, are
    its reducers' outputs in reducer order, so the ranks' streams in rank
    order rebuild the one-rank stream of the same seed."""
    num_trainers = min(16, (os.cpu_count() or 1) + 1)
    kwargs = dict(num_reducers=2 * num_trainers - 1, seed=5, narrow_to_32=True)

    def keys(ds, out, epochs=2):
        for epoch in range(epochs):
            ds.set_epoch(epoch)
            out.append(np.concatenate([b[port_gen.KEY_COLUMN] for b in ds]))

    single = []
    keys(ShufflingDataset(files, 2, 1, 700, 0, queue_name=_qname(), **kwargs), single)
    name = _qname()
    ranks = [
        ShufflingDataset(files, 2, num_trainers, 700, r, queue_name=name, **kwargs)
        for r in range(num_trainers)
    ]
    per_rank = [[] for _ in ranks]
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [
            threading.Thread(target=keys, args=(ds, out), daemon=True)
            for ds, out in zip(ranks, per_rank)
        ]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    for epoch in range(2):
        np.testing.assert_array_equal(
            np.concatenate([out[epoch] for out in per_rank]), single[epoch]
        )
        assert all(len(out[epoch]) > 0 for out in per_rank)


def test_per_column_staging_for_unpackable_specs(files):
    ds = DeviceShufflingDataset(
        files, 1, 1, 1000, 0, feature_columns=[port_gen.KEY_COLUMN, "one_hot0"],
        feature_types=[np.int64, None], label_column=port_gen.LABEL_COLUMN,
        num_reducers=2, device="cpu", queue_name=_qname(),
    )
    assert not ds._packed
    ds.set_epoch(0)
    batches = list(ds)
    assert len(batches) == 8
    feats, label = batches[0]
    assert feats[port_gen.KEY_COLUMN].dtype == torch.int64
    assert feats["one_hot0"].dtype == torch.int32 and label.dtype == torch.float32


def test_unported_plan_and_narrowing_range_raise(monkeypatch, files):
    """The block plan family is ported now: ``block`` and ``block:2`` run
    and deliver every key once. A malformed plan and a narrowing out of
    int32's range still raise."""
    for plan in ("block", "block:2"):
        monkeypatch.setenv("RSDL_SHUFFLE_PLAN", plan)
        ds = ShufflingDataset(files, 1, 1, 1000, 0, num_reducers=2, queue_name=_qname())
        ds.set_epoch(0)
        keys = np.concatenate([b["key"] for b in ds])
        ds.join()
        assert sorted(keys.tolist()) == list(range(len(keys))) and len(keys) > 0
        assert ds.shuffle_stats["plan"] == ("block:1" if plan == "block" else plan)
    monkeypatch.setenv("RSDL_SHUFFLE_PLAN", "bogus")
    with pytest.raises(ValueError):
        shuffle(files, None, 1, 2, 1)
    with pytest.raises(ValueError):
        _narrow_column("big", np.array([2**40], dtype=np.int64))
