"""The port's pod: the resident loader over processes, each with its shard
of every global batch, against the JAX package's multi-device resident
loader on the conftest's virtual CPU devices. The ranks run as separate
processes over gloo on the CPU, each world under a deadline and killed on
failure: the range decode, both schedules' joined shards over two epochs
on a data mesh of 2 and a ``(2, 2)`` data × model mesh, bit for bit, the
file-list digest, ``fits_device``'s vote, the multi-process fused epoch's
losses against JAX's multi-device fused epoch, a preempted pod resumed
from its cursor, and ``pod.py`` with both loaders (the sizes of the JAX
package's pod tests: 8,000 rows, batch 1,000)."""

import json
import math
import os
import re
import socket
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pyarrow.parquet as pq
import pytest
import torch
from jax.sharding import Mesh

import torch_port_helpers as helpers
from ray_shuffling_data_loader_tpu import runtime as jax_runtime
from ray_shuffling_data_loader_tpu.models import dlrm as jax_dlrm
from ray_shuffling_data_loader_tpu.parallel.train import TrainState, make_step_body
from ray_shuffling_data_loader_tpu.resident import DeviceResidentShufflingDataset as JaxResident
from ray_shuffling_data_loader_tpu.resident import _decode_narrow_range_to_store as jax_range_decode
from ray_shuffling_data_loader_tpu.resident import make_fused_epoch as jax_make_fused_epoch
from ray_shuffling_data_loader_tpu_torch import runtime as port_runtime
from ray_shuffling_data_loader_tpu_torch.convert import dlrm_state_dict_from_jax
from ray_shuffling_data_loader_tpu_torch.data_generation import DATA_SPEC, KEY_COLUMN, LABEL_COLUMN, generate_data
from ray_shuffling_data_loader_tpu_torch.resident import _decode_narrow_range_to_store

REPO = helpers.REPO
DEADLINE_S = 110
NUM_ROWS, BATCH, SEED = 8000, 1000, 11
COLUMNS = [KEY_COLUMN, "embeddings_name0"]
MODEL_COLUMNS = [c for c in DATA_SPEC if c != LABEL_COLUMN]
RAGGED_BATCH = 1500  # 5 full batches and a ragged one of 500, which 2 divides
INDIVISIBLE_BATCH = 999  # 2 does not divide it
# The fused epochs against JAX's: the same fp32 step on the same batches,
# the gradients' mean over the data group summed in another order.
FUSED_ATOL = 1e-5


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def port_rt():
    port_runtime.init(num_workers=2)
    yield
    port_runtime.shutdown()


@pytest.fixture(scope="module")
def pod_files(tmp_path_factory, local_runtime, port_rt):
    """The JAX pod tests' dataset: 8,000 rows in 3 files of 2 row groups
    (4 files: 2666 × 3 and a 2-row tail), so that the span boundary at row
    4,000 falls inside file 1, mid row group."""
    names, _ = generate_data(NUM_ROWS, 3, 2, 0.0, str(tmp_path_factory.mktemp("pod-data")))
    return sorted(names)


def _rank_env(shm_dir):
    """A rank's environment: a session of its own (no inherited runtime
    directory) with its shared memory under the test's directory."""
    env = {k: v for k, v in os.environ.items() if k != "RSDL_RUNTIME_DIR"}
    return {**env, "RSDL_SHM_DIR": str(shm_dir), "PYTHONPATH": REPO}


def _wait_all(procs, logs, deadline_s=DEADLINE_S):
    """Join every process under one deadline; kill them all on failure."""
    deadline = time.monotonic() + deadline_s
    try:
        for p in procs:
            p.wait(timeout=max(0.1, deadline - time.monotonic()))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    errs = [open(log).read()[-3000:] for log in logs]
    assert all(p.returncode == 0 for p in procs), errs


def _run_world(root, world, model_parallelism, cases, files, **extra):
    """Run ``world`` ranks of :func:`helpers.pod_rank_main`; each rank's
    results."""
    out_dir = root / f"world{world}-{'-'.join(cases)}"
    out_dir.mkdir()
    spec = {"pod": True, "world": world, "model_parallelism": model_parallelism, "cases": cases,
            "init_method": f"tcp://localhost:{_free_port()}", "out_dir": str(out_dir), "files": files,
            "batch": BATCH, "seed": SEED, "columns": COLUMNS, "label": LABEL_COLUMN,
            "model_columns": MODEL_COLUMNS, "ragged_batch": RAGGED_BATCH, "indivisible_batch": INDIVISIBLE_BATCH,
            **extra}
    spec_path = str(out_dir / "spec.json")
    with open(spec_path, "w") as f:
        json.dump(spec, f)
    helper = os.path.join(REPO, "tests", "torch_port_helpers.py")
    logs = [str(out_dir / f"rank{r}.log") for r in range(world)]
    procs = []
    for r in range(world):
        with open(logs[r], "w") as log:
            procs.append(subprocess.Popen([sys.executable, helper, spec_path, str(r)], stdout=log,
                                          stderr=subprocess.STDOUT, env=_rank_env(root)))
    _wait_all(procs, logs)
    return [dict(np.load(str(out_dir / f"rank{r}.npz"))) for r in range(world)]


def _jax_mesh(model_parallelism):
    devices = np.array(jax.devices()[: 2 * model_parallelism])
    if model_parallelism == 1:
        return Mesh(devices, ("data",))
    return Mesh(devices.reshape(2, model_parallelism), ("data", "model"))


def _jax_batches(files, mesh, materialize, epoch, skip=0, batch=BATCH, drop_last=True, columns=COLUMNS):
    """The JAX pod stream's global batches as ``[n_cols + 1, B]`` int32."""
    ds = JaxResident(files, num_epochs=2, batch_size=batch, feature_columns=columns, label_column=LABEL_COLUMN,
                     seed=SEED, mesh=mesh, materialize_epoch=materialize, drop_last=drop_last)
    ds.set_epoch(epoch, skip)
    out = [np.stack([np.asarray(f[c]).view(np.int32) for c in columns] + [np.asarray(lab).view(np.int32)])
           for f, lab in ds]
    ds.close()
    return out


def _joined(ranks, key):
    """The data indices' shards of ``key`` joined along the batch, in
    data-index order (model index 0's)."""
    leads = sorted((r for r in ranks if int(r["model_index"]) == 0), key=lambda r: int(r["data_index"]))
    return np.concatenate([r[key] for r in leads], axis=-1)


@pytest.fixture(scope="module")
def pod_worlds(tmp_path_factory, pod_files):
    """Each world's ranks, run once, lazily: ``pod_worlds(model_parallelism)``
    -> per-rank results. 2 ranks (data 2) run every case; 4 ranks (data 2
    × model 2) the streams. The fused case starts from JAX's initial DLRM
    weights, whose losses come with them."""
    root = tmp_path_factory.mktemp("pod")
    cache = {}

    def run(model_parallelism):
        if model_parallelism not in cache:
            if model_parallelism == 1:
                cases = ["streams", "ragged", "indivisible", "fits", "fused", "mismatch"]
                jax_losses, state = _jax_fused(pod_files)
                torch.save(state, str(root / "state.pt"))
                cache[1] = (_run_world(root, 2, 1, cases, pod_files, state=str(root / "state.pt")), jax_losses)
            else:
                cache[model_parallelism] = (_run_world(root, 4, 2, ["streams", "ragged"], pod_files), None)
        return cache[model_parallelism]

    return run


# -- (a) the range decode ---------------------------------------------------------


def _range_columns(fn, runtime_mod, filename, lo, hi):
    ref = runtime_mod.submit(fn, filename, [KEY_COLUMN, LABEL_COLUMN, "embeddings_name3"], lo, hi, 2).result(60)
    try:
        cb = runtime_mod.get_columns(ref)
        return {c: np.asarray(cb[c]).copy() for c in cb}
    finally:
        runtime_mod.free(ref)


@pytest.mark.parametrize("lo, hi", [(0, 2666), (0, 1), (1000, 1700), (1332, 1334), (1333, 2666), (5, 1333)])
def test_range_decode_matches_jax(pod_files, lo, hi):
    """Ranges inside one row group and straddling the two (1,333 rows each
    in a 2,666-row file): the port's rows, narrowed, are JAX's, bit for
    bit, and the file's own rows."""
    got = _range_columns(_decode_narrow_range_to_store, port_runtime, pod_files[1], lo, hi)
    want = _range_columns(jax_range_decode, jax_runtime, pod_files[1], lo, hi)
    assert list(got) == list(want)
    whole = pq.read_table(pod_files[1], columns=[KEY_COLUMN]).column(KEY_COLUMN).to_numpy()
    np.testing.assert_array_equal(got[KEY_COLUMN], whole[lo:hi])
    for c in want:
        assert got[c].dtype == want[c].dtype and got[c].dtype.itemsize == 4
        np.testing.assert_array_equal(got[c], want[c])


@pytest.mark.parametrize("lo, hi", [(0, 2667), (-1, 10), (10, 10), (2666, 2667), (20, 5)])
def test_range_decode_raises_outside_the_file(pod_files, lo, hi):
    """Both packages check the range before they decode or touch a
    session, so the tasks are called here, in this process."""
    for fn in (_decode_narrow_range_to_store, jax_range_decode):
        with pytest.raises(ValueError, match="outside file"):
            fn(pod_files[1], [KEY_COLUMN], lo, hi, 1)


# -- (b) the joined shards against JAX's multi-device stream ----------------------


@pytest.mark.parametrize("model_parallelism", [1, 2])
@pytest.mark.parametrize("schedule, materialize", helpers.POD_SCHEDULES)
def test_joined_shards_are_jax_pod_stream(pod_worlds, pod_files, model_parallelism, schedule, materialize):
    ranks, _ = pod_worlds(model_parallelism)
    mesh = _jax_mesh(model_parallelism)
    for epoch in range(2):
        want = np.stack(_jax_batches(pod_files, mesh, materialize, epoch))
        got = _joined(ranks, f"{schedule}_epoch{epoch}")
        assert got.shape == want.shape == (NUM_ROWS // BATCH, len(COLUMNS) + 1, BATCH)
        np.testing.assert_array_equal(got, want)
    # Resumed mid-epoch.
    np.testing.assert_array_equal(_joined(ranks, f"{schedule}_skip3"),
                                  np.stack(_jax_batches(pod_files, mesh, materialize, 1, skip=3)))


@pytest.mark.parametrize("model_parallelism", [1, 2])
def test_pod_exactly_once_and_model_peers(pod_worlds, model_parallelism):
    ranks, _ = pod_worlds(model_parallelism)
    for schedule, _ in helpers.POD_SCHEDULES:
        epochs = [_joined(ranks, f"{schedule}_epoch{e}")[:, 0].reshape(-1) for e in range(2)]
        for keys in epochs:
            np.testing.assert_array_equal(np.sort(keys), np.arange(NUM_ROWS))
        assert not np.array_equal(epochs[0], epochs[1])
    for r in ranks:  # a model peer yields its lead's shards
        lead = next(x for x in ranks if int(x["data_index"]) == int(r["data_index"]) and int(x["model_index"]) == 0)
        for schedule, _ in helpers.POD_SCHEDULES:
            np.testing.assert_array_equal(r[f"{schedule}_epoch0"], lead[f"{schedule}_epoch0"])
        assert list(r["loaded_jax"]) == []


@pytest.mark.parametrize("model_parallelism", [1, 2])
def test_pod_staging_and_schedule(pod_worlds, model_parallelism):
    """Each rank stages its span's real rows (spans of 4,000 rows: the
    whole dataset over the data axis), the tiny dataset takes the
    materialized schedule on every rank, and both schedules count their
    batches."""
    ranks, _ = pod_worlds(model_parallelism)
    per_row = (len(COLUMNS) + 1) * 4
    for r in ranks:
        assert int(r["materialized_bytes_staged"]) == NUM_ROWS // 2 * per_row
        assert bool(r["materialized_materialize"]) and not bool(r["gather_materialize"])
        for schedule, _ in helpers.POD_SCHEDULES:
            assert int(r[f"{schedule}_batches_staged"]) == 2 * (NUM_ROWS // BATCH) + NUM_ROWS // BATCH - 3


@pytest.mark.parametrize("model_parallelism", [1, 2])
@pytest.mark.parametrize("schedule, materialize", helpers.POD_SCHEDULES)
def test_ragged_batch_matches_jax(pod_worlds, pod_files, model_parallelism, schedule, materialize):
    ranks, _ = pod_worlds(model_parallelism)
    want = _jax_batches(pod_files, _jax_mesh(model_parallelism), materialize, 0, batch=RAGGED_BATCH,
                        drop_last=False)
    assert [b.shape[1] for b in want] == [RAGGED_BATCH] * 5 + [NUM_ROWS % RAGGED_BATCH]
    np.testing.assert_array_equal(_joined(ranks, f"ragged_{schedule}_full"), np.stack(want[:-1]))
    np.testing.assert_array_equal(_joined(ranks, f"ragged_{schedule}_tail"), want[-1])


@pytest.mark.parametrize("schedule, materialize", helpers.POD_SCHEDULES)
def test_indivisible_batch_raises_as_jax(pod_worlds, pod_files, schedule, materialize):
    """A global batch the data axis does not divide: JAX's sharded batch
    raises ``ValueError`` (its size "should be divisible by 2"), and so
    does every rank of the port."""
    ranks, _ = pod_worlds(1)
    with pytest.raises(ValueError, match="divisible by 2"):
        _jax_batches(pod_files, _jax_mesh(1), materialize, 0, batch=INDIVISIBLE_BATCH)
    for r in ranks:
        assert "divisible by 2" in str(r[f"indivisible_{schedule}"])


# -- (c) a file list that differs --------------------------------------------------


def test_file_list_mismatch_raises_on_every_rank(pod_worlds):
    ranks, _ = pod_worlds(1)
    for r in ranks:
        assert "differs across processes" in str(r["mismatch"])


# -- (d) fits_device's vote --------------------------------------------------------


def test_fits_device_votes_over_the_pod(pod_worlds):
    ranks, _ = pod_worlds(1)
    for r in ranks:
        assert not bool(r["fits_not_declared"])  # no pod_consistent: never in a world above 1
        assert bool(r["fits_all_yes"])
        assert not bool(r["fits_one_no"])  # rank 1 voted no, so no rank goes resident


# -- (e) the fused epoch against JAX's multi-device fused epoch ------------------------


def _jax_fused(files):
    """JAX's multi-device fused epoch (the scan over the pre-sharded epoch
    tensor) on a data mesh of 2, both schedules, 2 epochs of the small
    fp32 DLRM from one initial state: ``({schedule: [2, 8] losses}, the
    port's state_dict of that initial state)``."""
    mesh = _jax_mesh(1)
    jmodel = jax_dlrm.dlrm_for_data_spec(**helpers.SMALL_DLRM, use_pallas_interaction=True).clone(
        compute_dtype=jnp.float32)
    feats = {c: jnp.zeros((BATCH,), jnp.int32) for c in MODEL_COLUMNS}
    params = jmodel.init(jax.random.key(3), feats)
    opt = optax.adam(1e-3)
    losses = {}
    for schedule, materialize in helpers.POD_SCHEDULES:
        ds = JaxResident(files, num_epochs=2, batch_size=BATCH, feature_columns=MODEL_COLUMNS,
                         label_column=LABEL_COLUMN, seed=SEED, mesh=mesh, materialize_epoch=materialize)
        state = TrainState(step=jnp.zeros((), jnp.int32), params=params, opt_state=opt.init(params))
        run = jax_make_fused_epoch(ds, make_step_body(jmodel, opt), donate_state=False)
        out = []
        for epoch in range(2):
            state, epoch_losses = run(state, epoch)
            out.append(np.asarray(epoch_losses))
        ds.close()
        losses[schedule] = np.stack(out)
    return losses, dlrm_state_dict_from_jax(jax.tree.map(np.asarray, params))


@pytest.mark.parametrize("schedule", [s for s, _ in helpers.POD_SCHEDULES])
def test_fused_epoch_matches_jax_multi_device(pod_worlds, schedule):
    ranks, jax_losses = pod_worlds(1)
    want = jax_losses[schedule]
    assert want.shape == (2, NUM_ROWS // BATCH)
    for r in ranks:
        got = r[f"fused_{schedule}"]
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, atol=FUSED_ATOL, rtol=0)
        assert int(r[f"fused_{schedule}_batches_staged"]) == 2 * (NUM_ROWS // BATCH)
    # The loss is the global batch's: the same on every rank.
    np.testing.assert_array_equal(ranks[0][f"fused_{schedule}"], ranks[1][f"fused_{schedule}"])


# -- (f) a preempted pod resumed from its cursor -----------------------------------------


def test_pod_preemption_resumes_exactly_once(tmp_path, pod_files):
    ckpt = str(tmp_path / "ckpt")
    before = _run_world(tmp_path, 2, 1, ["resume_a"], pod_files, ckpt=ckpt, stop_after=3)
    after = _run_world(tmp_path, 2, 1, ["resume_b"], pod_files, ckpt=ckpt)
    for r in after:
        assert list(r["cursor"]) == [0, 3]
    epoch0 = np.concatenate([r["epoch0"] for r in before] + [r["epoch0"] for r in after])
    np.testing.assert_array_equal(np.sort(epoch0), np.arange(NUM_ROWS))
    epoch1 = np.concatenate([r["epoch1"] for r in after])
    np.testing.assert_array_equal(np.sort(epoch1), np.arange(NUM_ROWS))


# -- (g) pod.py ------------------------------------------------------------------------


@pytest.mark.parametrize("loader", ["mapreduce", "resident"])
def test_pod_script_trains(tmp_path, loader):
    cmd = [sys.executable, "-m", "ray_shuffling_data_loader_tpu_torch.pod", "--simulate-pod", "2", "--device", "cpu",
           "--backend", "gloo", "--loader", loader, "--num-rows", str(NUM_ROWS), "--num-files", "3",
           "--batch-size", str(BATCH), "--epochs", "2", "--num-reducers", "4", "--num-workers", "2",
           "--rendezvous-dir", str(tmp_path / "rdv"), "--timeout", str(DEADLINE_S)]
    if loader == "resident":
        cmd += ["--fused-from-epoch", "1"]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=DEADLINE_S + 10, cwd=str(tmp_path),
                          env=_rank_env(tmp_path))
    out = proc.stdout + proc.stderr
    assert proc.returncode == 0, out[-4000:]
    for rank in (0, 1):
        for epoch in (0, 1):
            line = re.search(rf"\[pod\] rank {rank}: epoch {epoch} done, (\d+) steps, loss (nan|-?inf|-?[0-9.]+)", out)
            assert line, out[-4000:]
            assert int(line.group(1)) > 0 and math.isfinite(float(line.group(2)))
    assert "loss nan" not in out
