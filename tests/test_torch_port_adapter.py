"""The port's Torch adapter against the JAX package's: the same files and
seed give the same tensors, and the conversion cases of
``tests/test_torch_dataset.py`` hold on the port's converter."""

import uuid

import numpy as np
import pytest
import torch

from ray_shuffling_data_loader_tpu import torch_dataset as jax_adapter
from ray_shuffling_data_loader_tpu_torch import runtime as port_runtime
from ray_shuffling_data_loader_tpu_torch.data_generation import DATA_SPEC, LABEL_COLUMN, generate_data
from ray_shuffling_data_loader_tpu_torch.runtime import ColumnBatch
from ray_shuffling_data_loader_tpu_torch.torch_dataset import (
    TorchShufflingDataset,
    batch_to_tensor_factory,
    convert_to_tensor,
    dataframe_to_tensor_factory,
)

FEATURES = [c for c in DATA_SPEC if c != LABEL_COLUMN]


@pytest.fixture(scope="module")
def port_rt():
    port_runtime.init(num_workers=2)
    yield
    port_runtime.shutdown()


@pytest.fixture(scope="module")
def files(tmp_path_factory, port_rt):
    names, _ = generate_data(2000, 2, 2, 0.0, str(tmp_path_factory.mktemp("adapter")))
    return names


def _epochs(ds, num_epochs):
    out = []
    for epoch in range(num_epochs):
        ds.set_epoch(epoch)
        out.append([([t.clone() for t in f], l.clone()) for f, l in ds])
    return out


@pytest.mark.parametrize("narrow", [False, True])
def test_tensors_match_jax(files, local_runtime, narrow):
    types = [torch.int64] * (len(FEATURES) - 1) + [torch.int32]
    kw = dict(num_epochs=2, num_trainers=1, batch_size=300, rank=0, num_reducers=3, seed=9,
              feature_columns=FEATURES, feature_types=types, label_column=LABEL_COLUMN, label_type=torch.float64,
              narrow_to_32=narrow)
    port = TorchShufflingDataset(files, queue_name=f"adapter-{uuid.uuid4().hex[:8]}", **kw)
    got = _epochs(port, 2)
    port._ds.join(timeout=60)  # the port's shuffle thread has ended
    want = _epochs(jax_adapter.TorchShufflingDataset(files, queue_name=f"adapter-{uuid.uuid4().hex[:8]}", **kw), 2)
    for g_epoch, w_epoch in zip(got, want, strict=True):
        # 2000 rows at 300: six full batches and a final 200 (drop_last off).
        assert [len(l) for _, l in g_epoch] == [len(l) for _, l in w_epoch] == [300] * 6 + [200]
        for (gf, gl), (wf, wl) in zip(g_epoch, w_epoch):
            assert len(gf) == len(wf) == len(FEATURES)
            for g, w in zip(gf, wf):
                assert g.dtype == w.dtype and g.shape == w.shape == (len(gl), 1)
                assert torch.equal(g, w)
            assert gl.dtype == wl.dtype == torch.float64 and torch.equal(gl, wl)


def test_convert_basic():
    cb = ColumnBatch({"a": np.arange(6, dtype=np.int64), "b": np.linspace(0, 1, 6), "y": np.ones(6)})
    features, label = batch_to_tensor_factory(
        feature_columns=["a", "b"], feature_types=[torch.int64, torch.float32], label_column="y"
    )(cb)
    assert [f.dtype for f in features] == [torch.int64, torch.float32]
    assert features[0].shape == label.shape == (6, 1)
    assert label.dtype == torch.float32


def test_convert_shapes():
    cb = ColumnBatch({"a": np.arange(12, dtype=np.float64), "y": np.ones(12)})
    features, label = batch_to_tensor_factory(
        feature_columns=["a"], feature_shapes=[(3,)], label_column="y", label_shape=1
    )(cb)
    assert features[0].shape == (4, 3) and label.shape == (12, 1)


def test_convert_object_ndarray_column():
    col = np.empty(3, dtype=object)
    for i in range(3):
        col[i] = np.full(4, i, dtype=np.float32)
    features, _ = batch_to_tensor_factory(feature_columns=["vec"], feature_shapes=[(4,)], label_column="y")(
        ColumnBatch({"vec": col, "y": np.zeros(3)})
    )
    assert features[0].shape == (3, 4)
    np.testing.assert_array_equal(features[0].numpy()[2], np.full(4, 2, np.float32))


def test_convert_object_unsupported():
    col = np.empty(2, dtype=object)
    col[0] = col[1] = {"not": "supported"}
    with pytest.raises(TypeError, match="not supported"):
        batch_to_tensor_factory(feature_columns=["bad"], label_column="y")(ColumnBatch({"bad": col, "y": np.zeros(2)}))


def test_spec_size_mismatch_raises():
    with pytest.raises(ValueError, match="feature_shapes"):
        batch_to_tensor_factory(feature_columns=["a", "b"], feature_shapes=[(1,)], label_column="y")
    with pytest.raises(ValueError, match="feature_types"):
        batch_to_tensor_factory(feature_columns=["a"], feature_types=[torch.float, torch.int64], label_column="y")
    with pytest.raises(ValueError, match="torch.dtype"):
        batch_to_tensor_factory(feature_columns=["a"], feature_types=["float32"], label_column="y")


def test_dataframe_alias_and_pandas_input():
    import pandas as pd

    features, label = dataframe_to_tensor_factory(feature_columns=["a"], label_column="y")(
        pd.DataFrame({"a": np.arange(4), "y": np.zeros(4)})
    )
    assert features[0].shape == (4, 1) and label.shape == (4, 1)


def test_read_only_columns_are_copied():
    values = np.arange(5, dtype=np.int64)
    values.flags.writeable = False
    features, _ = batch_to_tensor_factory(feature_columns=["a"], feature_types=[torch.int64], label_column="a")(
        {"a": values}
    )
    features[0].add_(1)  # a tensor of its own, writable
    np.testing.assert_array_equal(values, np.arange(5))


@pytest.mark.parametrize(
    "args",
    [
        (["a", "b"], [None, (2,)], [torch.float, torch.float], "y", None, torch.float),
        ("a", None, None, "y", 1, torch.float64),
        (["a"], [2], [torch.int64], "y", None, None),
    ],
)
def test_convert_to_tensor_matches_jax(args):
    batch = {"a": np.arange(6), "b": np.arange(12).reshape(6, 2), "y": np.linspace(0, 1, 6)}
    if args[1] == [2]:
        batch["a"] = np.arange(12)
    got_f, got_l = convert_to_tensor(batch, *args)
    want_f, want_l = jax_adapter.convert_to_tensor(batch, *args)
    for g, w in zip(got_f, want_f, strict=True):
        assert g.dtype == w.dtype and torch.equal(g, w)
    assert got_l.dtype == want_l.dtype and torch.equal(got_l, want_l)
