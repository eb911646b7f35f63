"""The port's process plane on the CPU: the shared-memory store, the
spawned worker pool, named actors across processes, and a session joined
through ``RSDL_RUNTIME_DIR``. Every child process runs under a deadline
and is killed on failure."""

import errno
import glob
import json
import mmap
import multiprocessing
import os
import subprocess
import sys
import textwrap
import threading
import time

import numpy as np
import pytest

import torch_port_helpers as helpers
from ray_shuffling_data_loader_tpu_torch import runtime
from ray_shuffling_data_loader_tpu_torch.runtime import store as store_mod

REPO = helpers.REPO
DEADLINE_S = 60


def _run(script, env=None):
    """Run ``script`` in a fresh interpreter under the deadline."""
    proc = subprocess.Popen(
        [sys.executable, "-c", textwrap.dedent(script)], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True, env=env,
    )
    try:
        out, err = proc.communicate(timeout=DEADLINE_S)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert proc.returncode == 0, err
    return out


def _segments(ctx):
    return glob.glob(os.path.join(ctx.store.shm_dir, f"{ctx.session}-*"))


@pytest.fixture
def session():
    runtime.shutdown()  # a session another test left behind
    ctx = runtime.init(num_workers=2)
    yield ctx
    runtime.shutdown()
    assert not _segments(ctx), "segments left after shutdown"
    assert not os.path.exists(ctx.runtime_dir)


def test_store_round_trip_zero_copy_and_free(session):
    cols = {"a": np.arange(1000, dtype=np.int32), "b": np.linspace(0, 1, 1000), "c": np.ones((1000, 3), np.float32)}
    ref = runtime.put_columns(cols)
    got = runtime.get_columns(ref)
    assert isinstance(got._keepalive, mmap.mmap)
    for k, v in cols.items():
        np.testing.assert_array_equal(got[k], v)
        assert got[k].dtype == v.dtype and not got[k].flags.owndata and not got[k].flags.writeable
        # Every column starts on a 64-byte boundary of the segment.
        assert got[k].ctypes.data % store_mod._ALIGN == 0
    assert runtime.store_stats().num_objects == 1 and session.store.exists(ref)
    # Row windows over one segment are hardlinks: one segment's bytes.
    pending = session.store.create_columns({"k": ((10,), np.int64)})
    pending.columns["k"][:] = np.arange(10)
    windows = pending.publish_slices([(0, 4), (4, 4), (4, 10)])
    stats = runtime.store_stats()
    assert stats.num_objects == 4
    np.testing.assert_array_equal(runtime.get_columns(windows[2])["k"], np.arange(4, 10))
    assert runtime.get_columns(windows[1]).num_rows == 0
    runtime.free([ref, *windows])
    # A mapping outlives the unlink of its segment.
    np.testing.assert_array_equal(got["a"], cols["a"])
    assert runtime.store_stats().num_objects == 0 and not _segments(session)
    with pytest.raises(runtime.ObjectLostError):
        runtime.get_columns(ref)


def test_serialized_segment_maps_back(tmp_path):
    cols = {"x": np.arange(7, dtype=np.int16), "y": np.zeros((7, 2), np.float64)}
    path = tmp_path / "seg"
    path.write_bytes(store_mod.serialize_columns(cols))
    got = store_mod.map_segment_file(str(path))
    for k, v in cols.items():
        np.testing.assert_array_equal(got[k], v)
    path.write_bytes(b"garbage" * 20)
    with pytest.raises(ValueError, match="corrupt"):
        store_mod.map_segment_file(str(path))


def test_put_that_does_not_fit_raises_the_store_error(session, monkeypatch):
    def no_room(fd, offset, length):
        raise OSError(errno.ENOSPC, "No space left on device")

    monkeypatch.setattr(store_mod.os, "posix_fallocate", no_room)
    with pytest.raises(runtime.StoreFullError, match="does not fit") as info:
        runtime.put_columns({"a": np.zeros(100)})
    assert info.value.errno == errno.ENOSPC and info.value.free_bytes >= 0
    assert not _segments(session)  # the half-made segment is gone


def test_shm_dir_from_environment(monkeypatch, tmp_path):
    monkeypatch.setenv("RSDL_SHM_DIR", str(tmp_path / "shm"))
    store = store_mod.ObjectStore("rsdl-test")
    assert store.shm_dir == str(tmp_path / "shm")
    ref = store.put_columns({"v": np.arange(3)})
    assert os.path.exists(tmp_path / "shm" / ref.object_id)
    store.cleanup()
    assert store.store_stats().num_objects == 0


def test_pool_submit_wait_and_remote_traceback(session):
    futs = [runtime.submit(helpers.square, i) for i in range(6)]
    done, pending = runtime.wait(futs, num_returns=len(futs), timeout=DEADLINE_S)
    assert not pending and [f.result() for f in done] == [i * i for i in range(6)]
    bad = runtime.submit(helpers.fail, "boom from a worker")
    with pytest.raises(runtime.TaskError) as info:
        bad.result(timeout=DEADLINE_S)
    assert info.value.error_type == "ValueError"
    assert "boom from a worker" in str(info.value) and "Traceback" in str(info.value)
    done, pending = runtime.wait([runtime.submit(helpers.square, 3)], timeout=DEADLINE_S)
    assert len(done) == 1 and not pending
    deadline = time.monotonic() + DEADLINE_S
    while session.pool.ready_s is None:  # every worker up, not just the busy one
        assert time.monotonic() < deadline
        time.sleep(0.05)


def test_workers_import_no_torch(session, tmp_path, monkeypatch):
    from ray_shuffling_data_loader_tpu_torch import data_generation
    from ray_shuffling_data_loader_tpu_torch.dataset import ShufflingDataset

    files, _ = data_generation.generate_data(2000, 2, 1, 0.0, str(tmp_path))
    # Every kind of task: the decoded-size estimate (the cache's default
    # policy), caching maps, packed reduces, the index schedule's plans
    # and gathers, and the resident loader's decode.
    monkeypatch.setenv("RSDL_INDEX_SHUFFLE", "on")
    ds = ShufflingDataset(
        files, 2, 1, 500, 0, num_reducers=2, queue_name="no-torch", device_layout={"batch": 500, "columns": ["key"]}
    )
    for epoch in range(2):
        ds.set_epoch(epoch)
        assert sum(b.num_rows for b in ds) == 2000
    ds.join(timeout=DEADLINE_S)
    assert ds.shuffle_stats["cache_decoded"] and ds.schedule_log == [(0, "mapreduce"), (1, "index")]
    # The device-resident loader's decode, on both workers.
    from ray_shuffling_data_loader_tpu_torch.shuffle import _decode_narrow_to_store

    refs = [runtime.submit(_decode_narrow_to_store, f, ["key"], 2) for f in files for _ in range(2)]
    runtime.free([fut.result(timeout=DEADLINE_S) for fut in refs])
    # The workers ran the tasks; they land on either.
    loaded = [runtime.submit(helpers.loaded_modules).result(timeout=DEADLINE_S) for _ in range(4)]
    assert any("ray_shuffling_data_loader_tpu_torch.shuffle" in mods for mods in loaded)
    for mods in loaded:
        assert not any(m == "torch" or m.startswith("torch.") for m in mods)


def test_actor_named_across_processes_get_does_not_stall_put(session):
    actor = runtime.spawn_actor(helpers.Mailbox, name="mailbox")
    got = []
    getter = threading.Thread(target=lambda: got.append(actor.call("get")), daemon=True)
    getter.start()  # blocks in the actor until someone puts
    time.sleep(0.2)
    env = dict(os.environ, RSDL_RUNTIME_DIR=session.runtime_dir)
    out = _run(
        f"""
        import sys
        sys.path.insert(0, {REPO!r})
        sys.path.insert(0, {os.path.join(REPO, "tests")!r})
        from ray_shuffling_data_loader_tpu_torch import runtime
        ctx = runtime.init()
        handle = runtime.connect_actor("mailbox")
        handle.call("put", "hello from another process")
        print(ctx.owner, ctx.session)
        runtime.shutdown()
        """,
        env=env,
    )
    assert out.split() == ["False", session.session]
    getter.join(DEADLINE_S)
    assert got == ["hello from another process"]
    with pytest.raises(KeyError):
        actor.call("boom")
    assert runtime.resolve_actor("mailbox").pid == actor.pid
    with pytest.raises(ValueError, match="already registered"):
        runtime.spawn_actor(helpers.Mailbox, name="mailbox")
    actor.terminate()
    assert not actor.ping(timeout=1.0)
    with pytest.raises(runtime.ActorDiedError):
        actor.call("get")
    with pytest.raises(ValueError, match="Unable to connect"):
        runtime.connect_actor("mailbox", num_retries=1)


def test_session_joined_through_environment(session):
    env = dict(os.environ, RSDL_RUNTIME_DIR=session.runtime_dir)
    out = _run(
        f"""
        import json, sys
        import numpy as np
        sys.path.insert(0, {REPO!r})
        from ray_shuffling_data_loader_tpu_torch import runtime
        ctx = runtime.init()
        ref = runtime.put_columns({{"v": np.arange(5) * 7}})
        print(json.dumps([ctx.owner, ctx.runtime_dir, ref.object_id, ref.nbytes, ref.session]))
        runtime.shutdown()  # a joined process leaves the session as it is
        """,
        env=env,
    )
    owner, runtime_dir, object_id, nbytes, ref_session = json.loads(out)
    assert not owner and runtime_dir == session.runtime_dir and ref_session == session.session
    ref = runtime.ObjectRef(object_id, nbytes, ref_session)
    np.testing.assert_array_equal(runtime.get_columns(ref)["v"], np.arange(5) * 7)
    # Its segment stays for the owner, whose shutdown (the fixture) takes it.
    assert _segments(session)


def test_owner_shutdown_leaves_no_process_or_segment():
    runtime.shutdown()
    ctx = runtime.init(num_workers=2)
    runtime.put_columns({"v": np.arange(3)})
    deadline = time.monotonic() + DEADLINE_S
    while ctx.pool.ready_s is None:  # every worker started
        assert time.monotonic() < deadline
        time.sleep(0.05)
    pids = [p.pid for p in multiprocessing.active_children()]
    assert len(pids) >= 2
    actor = runtime.spawn_actor(helpers.Mailbox)
    pids.append(actor.pid)
    runtime.shutdown()
    assert not _segments(ctx) and not os.path.exists(ctx.runtime_dir)
    deadline = time.monotonic() + 10
    while any(os.path.exists(f"/proc/{pid}") and _running(pid) for pid in pids):
        assert time.monotonic() < deadline, "a worker or actor survived shutdown"
        time.sleep(0.05)


def _running(pid):
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().split(")")[-1].split()[0] != "Z"
    except FileNotFoundError:
        return False


def test_environment_naming_another_runtime_is_not_joined(tmp_path, monkeypatch):
    runtime.shutdown()
    monkeypatch.setenv("RSDL_RUNTIME_DIR", str(tmp_path))  # no session marker
    ctx = runtime.init(num_workers=1)
    try:
        assert ctx.owner and ctx.runtime_dir != str(tmp_path)
    finally:
        runtime.shutdown()
    with pytest.raises(ValueError, match="no runtime session"):
        runtime.init(address=str(tmp_path))


def test_a_finished_dataset_frees_its_queue_name(session, tmp_path):
    """Two datasets one after the other under the default queue name: the
    first releases the name once every rank has acked its last epoch."""
    from ray_shuffling_data_loader_tpu_torch import data_generation
    from ray_shuffling_data_loader_tpu_torch.dataset import ShufflingDataset

    files, _ = data_generation.generate_data(1000, 2, 1, 0.0, str(tmp_path))
    for _ in range(2):
        ds = ShufflingDataset(files, 1, 1, 300, 0, num_reducers=2)
        ds.set_epoch(0)
        assert sum(b.num_rows for b in ds) == 1000
        ds.join(timeout=DEADLINE_S)
        assert runtime.resolve_actor("BatchQueue") is None


def test_package_root_is_lazy_and_resolves_every_name():
    out = _run(
        f"""
        import sys
        sys.path.insert(0, {REPO!r})
        import ray_shuffling_data_loader_tpu_torch as rsdl
        from ray_shuffling_data_loader_tpu_torch import runtime, shuffle
        print("torch" in sys.modules)
        for name in rsdl.__all__:
            assert getattr(rsdl, name) is not None, name
        print("torch" in sys.modules, rsdl.ColumnBatch is runtime.ColumnBatch, rsdl.runtime is runtime)
        """
    )
    assert out.split() == ["False", "True", "True", "True"]


def test_store_holds_no_more_than_the_epochs_in_flight(session, tmp_path):
    """With a window of two epochs and a consumer that has not started,
    the store holds the reducer outputs of two epochs and nothing else;
    consumed epochs leave nothing behind. (The decode cache, which the
    next test holds, is off here.)"""
    from ray_shuffling_data_loader_tpu_torch import data_generation
    from ray_shuffling_data_loader_tpu_torch.dataset import ShufflingDataset

    files, _ = data_generation.generate_data(4000, 2, 1, 0.0, str(tmp_path))
    ds = ShufflingDataset(
        files, 4, 1, 500, 0, num_reducers=2, max_concurrent_epochs=2, queue_name="window", cache_decoded=False
    )
    deadline = time.monotonic() + DEADLINE_S
    # The shuffle is at epoch 2 once epochs 0 and 1 are shuffled; epoch 2
    # waits in the window for epoch 0's acks.
    while ds.shuffle_stats.get("epoch") != 2:
        assert time.monotonic() < deadline
        time.sleep(0.05)
    stats = runtime.store_stats()
    ds.set_epoch(0)
    epoch_bytes = sum(b.nbytes for b in ds)
    assert stats.num_objects == 4
    assert 2 * epoch_bytes <= stats.total_bytes <= 2 * epoch_bytes + 4 * 4096  # rows + segment headers
    for epoch in range(1, 4):
        ds.set_epoch(epoch)
        assert sum(b.num_rows for b in ds) == 4000
    ds.join(timeout=DEADLINE_S)
    assert runtime.store_stats().num_objects == 0
    assert ds.shuffle_stats["store_peak_bytes"] <= 3 * epoch_bytes + 8 * 4096


def test_the_decode_cache_holds_one_segment_per_file_until_the_run_ends(session, tmp_path):
    """With the decode cache on, the store holds the two epochs in flight
    and one decoded segment per file; the run's end frees the cache."""
    from ray_shuffling_data_loader_tpu_torch import data_generation
    from ray_shuffling_data_loader_tpu_torch.dataset import ShufflingDataset

    files, _ = data_generation.generate_data(4000, 2, 1, 0.0, str(tmp_path))
    ds = ShufflingDataset(
        files, 4, 1, 500, 0, num_reducers=2, max_concurrent_epochs=2, queue_name="cache", cache_decoded=True
    )
    deadline = time.monotonic() + DEADLINE_S
    while ds.shuffle_stats.get("epoch") != 2:
        assert time.monotonic() < deadline
        time.sleep(0.05)
    stats = runtime.store_stats()
    ds.set_epoch(0)
    epoch_bytes = sum(b.nbytes for b in ds)
    assert stats.num_objects == 4 + len(files)
    # Two epochs' outputs and the files' decoded rows, one epoch's worth.
    assert 3 * epoch_bytes <= stats.total_bytes <= 3 * epoch_bytes + 6 * 4096
    for epoch in range(1, 4):
        ds.set_epoch(epoch)
        assert sum(b.num_rows for b in ds) == 4000
    ds.join(timeout=DEADLINE_S)
    assert ds.shuffle_stats["cache_decoded"] is True
    assert runtime.store_stats().num_objects == 0


def test_queue_window_full_and_empty(session):
    from ray_shuffling_data_loader_tpu_torch.batch_queue import BatchQueue, Empty, Full, connect_queue

    q = BatchQueue(3, 1, 1, maxsize=2, name="bounded")
    other = connect_queue("bounded")  # a second handle, by name
    with pytest.raises(Empty):
        other.get_batch(0, 0, timeout=0.1)
    with pytest.raises(Full):  # more than the queue can ever hold
        q.put_batch(0, 0, ["a", "b", "c"])
    q.put_batch(0, 0, ["a"])
    with pytest.raises(Full):  # all or nothing: no room for two
        q.put_batch(0, 0, ["b", "c"], timeout=0.1)
    assert q.qsize(0, 0) == 1
    q.new_epoch(0)
    q.producer_done(0, 0)
    assert other.get_batch(0, 0) == ["a", None]
    # The window holds one epoch: epoch 1 is admitted only once epoch 0 is
    # produced and acked.
    admitted = threading.Thread(target=q.new_epoch, args=(1,), daemon=True)
    admitted.start()
    admitted.join(0.3)
    assert admitted.is_alive()
    other.task_done(0, 0, 2)
    admitted.join(DEADLINE_S)
    assert not admitted.is_alive()
    q.shutdown()
