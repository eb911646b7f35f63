"""The port's device-resident loader on the CPU, against the JAX package's
``DeviceResidentShufflingDataset`` on a one-device mesh: the batch stream
bit for bit, the shuffle contract, staging, the budget policy, and the
fused epoch's losses against the JAX package's ``make_fused_epoch``."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pyarrow.parquet as pq
import pytest
import torch
from jax.sharding import Mesh

from ray_shuffling_data_loader_tpu.models import dlrm as jax_dlrm
from ray_shuffling_data_loader_tpu.parallel.train import TrainState, make_step_body
from ray_shuffling_data_loader_tpu.resident import DeviceResidentShufflingDataset as JaxResident
from ray_shuffling_data_loader_tpu.resident import make_fused_epoch as jax_make_fused_epoch
from ray_shuffling_data_loader_tpu_torch import runtime as port_runtime
from ray_shuffling_data_loader_tpu_torch.convert import dlrm_state_dict_from_jax
from ray_shuffling_data_loader_tpu_torch.data_generation import DATA_SPEC, KEY_COLUMN, LABEL_COLUMN, generate_data
from ray_shuffling_data_loader_tpu_torch.models import dlrm_for_data_spec
from ray_shuffling_data_loader_tpu_torch.parallel import make_optimizer, make_train_step
from ray_shuffling_data_loader_tpu_torch.resident import (
    DeviceResidentShufflingDataset,
    dataset_num_rows,
    device_memory_budget,
    fits_device,
    make_fused_epoch,
    packed_nbytes,
)
from ray_shuffling_data_loader_tpu_torch.shuffle import _decode_narrow_to_store, read_parquet_columns

NUM_ROWS, NUM_FILES = 20_000, 4
FEATURES = [KEY_COLUMN, "embeddings_name0", "embeddings_name3"]
MODEL_COLUMNS = [c for c in DATA_SPEC if c != LABEL_COLUMN]


@pytest.fixture(scope="module")
def port_rt():
    port_runtime.init(num_workers=2)
    yield
    port_runtime.shutdown()


@pytest.fixture(scope="module")
def files(tmp_path_factory, port_rt):
    names, _ = generate_data(NUM_ROWS, NUM_FILES, 2, 0.0, str(tmp_path_factory.mktemp("resident")))
    return names


def _mesh():
    return Mesh(np.array(jax.devices()[:1]), ("data",))


def _make(files, **kw):
    kw.setdefault("num_epochs", 3)
    kw.setdefault("batch_size", 1500)
    kw.setdefault("feature_columns", FEATURES)
    kw.setdefault("label_column", LABEL_COLUMN)
    kw.setdefault("seed", 5)
    # Several pieces per file and a ragged last piece.
    kw.setdefault("piece_rows", 3000)
    return DeviceResidentShufflingDataset(files, device="cpu", **kw)


def _stream(ds, epoch, skip=0):
    ds.set_epoch(epoch, skip)
    return [({k: np.asarray(v) for k, v in f.items()}, np.asarray(l)) for f, l in ds]


@pytest.mark.parametrize("rank", [0, 1, 2])
@pytest.mark.parametrize("materialize", [True, False])
def test_batch_stream_matches_jax(files, local_runtime, materialize, rank):
    kw = dict(num_epochs=2, batch_size=1500, feature_columns=FEATURES, label_column=LABEL_COLUMN, num_trainers=3,
              rank=rank, seed=5, piece_rows=3000, materialize_epoch=materialize, drop_last=False)
    port = DeviceResidentShufflingDataset(files, device="cpu", **kw)
    ref = JaxResident(files, mesh=_mesh(), **kw)
    for epoch in range(2):
        for skip in (0, 2):
            got, want = _stream(port, epoch, skip), _stream(ref, epoch, skip)
            # 6667 or 6666 rows per rank: 4 full batches and a ragged tail.
            assert len(got) == len(want) == 5 - skip
            assert len(got[-1][1]) == port._rank_rows % 1500
            for (pf, pl), (jf, jl) in zip(got, want):
                assert set(pf) == set(jf) == set(FEATURES)
                for c in FEATURES:
                    assert pf[c].dtype == jf[c].dtype
                    np.testing.assert_array_equal(pf[c], jf[c])
                assert pl.dtype == jl.dtype == np.float32
                np.testing.assert_array_equal(pl, jl)
    port.close()
    ref.close()


def test_exactly_once_and_shapes(files):
    ds = _make(files, batch_size=2000)
    assert ds.num_rows == NUM_ROWS and ds.num_batches == NUM_ROWS // 2000
    orders = []
    for epoch in range(2):
        ds.set_epoch(epoch)
        seen = []
        for features, label in ds:
            assert set(features) == set(FEATURES)
            key = features[KEY_COLUMN]
            assert key.dtype == torch.int32 and key.shape == (2000,) and key.device.type == "cpu"
            assert label.dtype == torch.float32 and 0.0 <= float(label.min()) and float(label.max()) <= 1.0
            seen.append(key.numpy().copy())
        flat = np.concatenate(seen)
        assert np.array_equal(np.sort(flat), np.arange(NUM_ROWS))
        orders.append(flat)
    assert not np.array_equal(orders[0], orders[1])


def test_label_values_roundtrip(files):
    expected = {}
    for f in files:
        t = pq.read_table(f, columns=[KEY_COLUMN, LABEL_COLUMN])
        expected.update(zip(t.column(KEY_COLUMN).to_numpy().tolist(),
                            t.column(LABEL_COLUMN).to_numpy().astype(np.float32).tolist()))
    ds = _make(files)
    ds.set_epoch(0)
    features, label = next(iter(ds))
    for k, v in zip(features[KEY_COLUMN].tolist(), label.tolist()):
        assert expected[k] == v


def test_deterministic_given_seed(files):
    a, b = _make(files), _make(files)
    fa, la = _stream(a, 1)[0]
    fb, lb = _stream(b, 1)[0]
    np.testing.assert_array_equal(fa[KEY_COLUMN], fb[KEY_COLUMN])
    np.testing.assert_array_equal(la, lb)


def test_rank_split_disjoint_and_complete(files):
    keys = []
    for r in range(2):
        ds = _make(files, num_trainers=2, rank=r, drop_last=False)
        keys.append(np.concatenate([f[KEY_COLUMN] for f, _ in _stream(ds, 0)]))
    assert not set(keys[0].tolist()) & set(keys[1].tolist())
    assert np.array_equal(np.sort(np.concatenate(keys)), np.arange(NUM_ROWS))


def test_drop_last_and_ragged_tail(files):
    batches = [f[KEY_COLUMN] for f, _ in _stream(_make(files, batch_size=1700), 0)]
    assert len(batches) == NUM_ROWS // 1700 and all(len(b) == 1700 for b in batches)
    ds = _make(files, batch_size=1700, drop_last=False)
    assert ds.num_batches == NUM_ROWS // 1700 + 1
    batches = [f[KEY_COLUMN] for f, _ in _stream(ds, 0)]
    assert len(batches[-1]) == NUM_ROWS % 1700
    assert np.array_equal(np.sort(np.concatenate(batches)), np.arange(NUM_ROWS))


def test_skip_batches_resume(files):
    ds = _make(files)
    full = [f[KEY_COLUMN] for f, _ in _stream(ds, 2)]
    resumed = [f[KEY_COLUMN] for f, _ in _stream(ds, 2, skip=5)]
    assert len(resumed) == len(full) - 5
    for a, b in zip(full[5:], resumed):
        np.testing.assert_array_equal(a, b)


def test_materialized_and_gather_schedules_identical(files):
    mat, gat = _make(files, materialize_epoch=True), _make(files, materialize_epoch=False)
    assert mat._materialize is True and gat._materialize is False
    for epoch in (0, 1):
        for (fa, la), (fb, lb) in zip(_stream(mat, epoch), _stream(gat, epoch), strict=True):
            np.testing.assert_array_equal(fa[KEY_COLUMN], fb[KEY_COLUMN])
            np.testing.assert_array_equal(la, lb)


def test_epoch_bounds_and_bad_rank(files):
    ds = _make(files)
    with pytest.raises(ValueError):
        ds.set_epoch(99)
    with pytest.raises(RuntimeError, match="set_epoch"):
        next(iter(ds))
    with pytest.raises(ValueError, match="rank"):
        _make(files, num_trainers=2, rank=2)
    with pytest.raises(ValueError, match="no input files"):
        _make([])


def test_close_releases_and_blocks_iteration(files):
    ds = _make(files)
    ds.set_epoch(0)
    next(iter(ds))
    ds.close()
    assert ds._buf is None
    with pytest.raises(RuntimeError, match="closed"):
        next(iter(ds))
    with pytest.raises(RuntimeError, match="closed"):
        ds.set_epoch(0)


def test_close_invalidates_live_iterator(files):
    ds = _make(files, lookahead=1)
    ds.set_epoch(0)
    it = iter(ds)
    next(it)
    ds.close()
    with pytest.raises(RuntimeError, match="closed"):
        for _ in range(5):  # what the lookahead dispatched, then a failure
            next(it)


def test_stats_accounting(files):
    ds = _make(files)
    assert ds.stats.bytes_staged == packed_nbytes(NUM_ROWS, len(FEATURES))
    assert ds.stats.first_batch_s > 0
    ds.set_epoch(0)
    n = sum(1 for _ in ds)
    assert ds.stats.batches_staged == n == NUM_ROWS // 1500


def test_num_rows_hint(files):
    assert _make(files, num_rows=NUM_ROWS).num_rows == NUM_ROWS
    for wrong in (NUM_ROWS - 1, NUM_ROWS + 1):
        with pytest.raises(ValueError, match="num_rows"):
            _make(files, num_rows=wrong)


def test_fits_device_policy(files, monkeypatch):
    assert dataset_num_rows(files) == NUM_ROWS
    monkeypatch.delenv("RSDL_RESIDENT_BUDGET_GB", raising=False)
    assert device_memory_budget(device="cpu")[0] > 0
    # Never on the CPU by itself: the "device" is host memory there ...
    assert fits_device(files, len(FEATURES), device="cpu") is False
    # ... unless a budget is set, which must hold the packed dataset.
    monkeypatch.setenv("RSDL_RESIDENT_BUDGET_GB", "1")
    assert device_memory_budget(device="cpu") == (10**9, False)
    assert fits_device(files, len(FEATURES), device="cpu") is True
    monkeypatch.setenv("RSDL_RESIDENT_BUDGET_GB", "1e-9")
    assert fits_device(files, len(FEATURES), device="cpu") is False


def test_decode_task_projects_and_narrows(files):
    from ray_shuffling_data_loader_tpu_torch import runtime

    ref = runtime.submit(_decode_narrow_to_store, files[0], [KEY_COLUMN, LABEL_COLUMN], 4).result(timeout=60)
    try:
        cb = runtime.get_columns(ref)
        assert list(cb) == [KEY_COLUMN, LABEL_COLUMN]
        assert cb[KEY_COLUMN].dtype == np.int32 and cb[LABEL_COLUMN].dtype == np.float32
        whole = read_parquet_columns(files[0])
        np.testing.assert_array_equal(cb[KEY_COLUMN], whole[KEY_COLUMN])
        np.testing.assert_array_equal(cb[LABEL_COLUMN], whole[LABEL_COLUMN].astype(np.float32))
    finally:
        runtime.free(ref)
    with pytest.raises(ValueError, match="no_such_column"):
        read_parquet_columns(files[0], columns=["no_such_column"])


@pytest.mark.parametrize("materialize", [True, False])
def test_fused_epoch_on_the_cpu_is_the_batch_loop(files, materialize):
    """The CPU fused epoch trains exactly the iterator's batches, in order."""
    losses = {}
    for fused in (True, False):
        ds = _make(files, batch_size=4000, feature_columns=MODEL_COLUMNS, materialize_epoch=materialize)
        model = dlrm_for_data_spec(embed_dim=4, top_mlp=(8,), vocab_cap=256, compute_dtype=torch.float32,
                                   device="cpu")
        step = make_train_step(model, make_optimizer(model))
        run = make_fused_epoch(ds, step) if fused else None
        out = []
        for epoch in range(2):
            if fused:
                out.append(run(epoch))
            else:
                ds.set_epoch(epoch)
                out.append(torch.stack([step(f, l)["loss"] for f, l in ds]))
        losses[fused] = torch.cat(out)
        assert ds.stats.batches_staged == 2 * (NUM_ROWS // 4000)
    assert losses[True].shape == (2 * (NUM_ROWS // 4000),)
    assert torch.equal(losses[True], losses[False])


@pytest.mark.parametrize("materialize", [True, False])
def test_fused_epoch_losses_match_jax(files, local_runtime, materialize):
    batch, epochs = 4000, 2
    kw = dict(num_epochs=epochs, batch_size=batch, feature_columns=MODEL_COLUMNS, label_column=LABEL_COLUMN,
              seed=11, materialize_epoch=materialize)
    jds = JaxResident(files, mesh=_mesh(), **kw)
    jmodel = jax_dlrm.dlrm_for_data_spec(
        embed_dim=8, top_mlp=(32, 16), vocab_cap=1024, use_pallas_interaction=True
    ).clone(compute_dtype=jnp.float32)
    jds.set_epoch(0)
    feats0, _ = next(iter(jds))
    params = jmodel.init(jax.random.key(1), feats0)
    opt = optax.adam(1e-3)
    state = TrainState(step=jnp.zeros((), jnp.int32), params=params, opt_state=opt.init(params))
    jrun = jax_make_fused_epoch(jds, make_step_body(jmodel, opt), donate_state=False)
    want = []
    for epoch in range(epochs):
        state, losses = jrun(state, epoch)
        want.append(np.asarray(losses))
    jds.close()

    pds = DeviceResidentShufflingDataset(files, device="cpu", **kw)
    model = dlrm_for_data_spec(embed_dim=8, top_mlp=(32, 16), vocab_cap=1024, compute_dtype=torch.float32,
                               device="cpu")
    model.load_state_dict(dlrm_state_dict_from_jax(jax.tree.map(np.asarray, params)))
    run = make_fused_epoch(pds, make_train_step(model, make_optimizer(model, lr=1e-3)))
    got = [run(epoch).numpy() for epoch in range(epochs)]
    pds.close()
    assert all(len(g) == NUM_ROWS // batch for g in got)
    np.testing.assert_allclose(np.concatenate(got), np.concatenate(want), atol=1e-4, rtol=0)
