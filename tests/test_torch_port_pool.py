"""The port's worker pool (``runtime/tasks.py``) against the JAX
package's: a worker that dies under a task fails that task alone, with a
``TaskError`` naming its pid, and the pool goes on serving (the port's
also starts a worker in its place); ``add_workers`` and
``retire_workers`` change the membership as the JAX pool's do; a
``TaskError`` keeps the lost object's id through pickling; the workers
take the ``task`` role of the fault plane and import no torch."""

import pickle
import time

import pytest

from ray_shuffling_data_loader_tpu.runtime import tasks as jax_tasks
from ray_shuffling_data_loader_tpu_torch.runtime import tasks

import torch_port_helpers as helpers

DEADLINE_S = 60


@pytest.fixture
def pool():
    p = tasks.WorkerPool(2)
    yield p
    p.shutdown()


def _until(cond, what):
    deadline = time.monotonic() + DEADLINE_S
    while not cond():
        assert time.monotonic() < deadline, what
        time.sleep(0.05)


def test_a_killed_worker_fails_only_its_task_and_the_pool_serves_on(pool):
    _until(lambda: pool.ready_s is not None, "the pool never came up")
    assert pool.ready_s > 0 and pool.ready_at is not None
    slow = pool.submit(helpers.sleep_then, "kept", 1.5)
    _until(lambda: len(pool.in_flight()) == 1, "the slow task never started")
    (running,) = pool.in_flight()
    assert running["stage"] == "sleep_then" and running["age_s"] >= 0
    doomed = pool.submit(helpers.die)
    with pytest.raises(tasks.TaskError) as info:
        doomed.result(timeout=DEADLINE_S)
    assert info.value.error_type == "WorkerDied" and "died while running this task" in str(info.value)
    assert str(running["pid"]) not in str(info.value)  # the other worker's pid is not named
    assert slow.result(timeout=DEADLINE_S) == "kept"
    later = [pool.submit(helpers.square, i) for i in range(8)]
    assert [f.result(timeout=DEADLINE_S) for f in later] == [i * i for i in range(8)]
    assert pool.deaths == 1
    _until(lambda: pool.num_workers == 2, "the dead worker was not replaced")


def test_a_kill_fault_in_a_worker_is_a_death(tmp_path):
    # The workers run as role "task": a /task rule fires there and only there.
    p = tasks.WorkerPool(2, env={"RSDL_FAULTS": "pool.test/task:kill:1x1", "RSDL_FAULTS_SEED": "0"})
    try:
        with pytest.raises(tasks.TaskError) as info:
            p.submit(helpers.fire_fault, "pool.test").result(timeout=DEADLINE_S)
        assert info.value.error_type == "WorkerDied"
        pids = {p.submit(helpers.fire_fault, "other.site").result(timeout=DEADLINE_S) for _ in range(4)}
        assert pids and all(isinstance(pid, int) for pid in pids)
    finally:
        p.shutdown()


def test_task_error_keeps_the_lost_object_id_as_jax():
    port_pool, jax_pool = tasks.WorkerPool(1), jax_tasks.WorkerPool(1)
    try:
        errors = {}
        for pkg, p in (("port", port_pool), ("jax", jax_pool)):
            with pytest.raises(Exception) as info:
                p.submit(helpers.raise_lost, pkg, "seg-42").result(timeout=DEADLINE_S)
            errors[pkg] = info.value
        for err in errors.values():
            assert err.error_type == "ObjectLostError" and err.lost_object_id == "seg-42"
        again = pickle.loads(pickle.dumps(errors["port"]))
        assert isinstance(again, tasks.TaskError)
        assert (again.error_type, again.lost_object_id, str(again)) == (
            "ObjectLostError", "seg-42", str(errors["port"]))
        plain = port_pool.submit(helpers.fail, "no object").exception(timeout=DEADLINE_S)
        assert plain.lost_object_id is None and plain.error_type == "ValueError"
    finally:
        port_pool.shutdown()
        jax_pool.shutdown()


def _membership(p, retired_wait):
    """add 2 -> 4 workers; retire 1 -> 3; retire 10 -> never below 1."""
    out = [p.add_workers(2)]
    out.append(len(p.retire_workers(1, deadline_s=retired_wait)))
    _until(lambda: p.num_workers == 3, "the retiree did not leave")
    out.append(p.num_workers)
    out.append(len(p.retire_workers(10, deadline_s=retired_wait)))
    _until(lambda: p.num_workers == 1, "the retirees did not leave")
    out.append(p.num_workers)
    out.append(p.retire_workers(1))
    out.append(p.submit(helpers.square, 7).result(timeout=DEADLINE_S))
    out.append(p.add_workers(0))
    return out


def test_add_and_retire_workers_as_jax():
    port_pool, jax_pool = tasks.WorkerPool(2), jax_tasks.WorkerPool(2)
    try:
        got = _membership(port_pool, DEADLINE_S)
        assert got == _membership(jax_pool, DEADLINE_S) == [4, 1, 3, 2, 1, [], 49, 1]
        assert port_pool.deaths == 0  # retirements are clean exits, not deaths
    finally:
        port_pool.shutdown()
        jax_pool.shutdown()


def test_retirement_waits_behind_the_backlog(pool):
    backlog = [pool.submit(helpers.sleep_then, i, 0.2) for i in range(4)]
    retired = pool.retire_workers(1, deadline_s=DEADLINE_S)
    # The pill was taken after every task ahead of it: the retiree finished
    # its own, the other worker may still run the last one.
    assert len(retired) == 1 and sum(f.done() for f in backlog) >= 3
    assert [f.result(timeout=DEADLINE_S) for f in backlog] == list(range(4))
    assert pool.num_workers == 1


def test_shutdown_fails_what_is_outstanding():
    p = tasks.WorkerPool(1)
    running = p.submit(helpers.sleep_then, 1, 30)
    queued = p.submit(helpers.square, 3)
    _until(lambda: p.in_flight(), "the task never started")
    p.shutdown()
    for fut in (running, queued):
        with pytest.raises(tasks.TaskError, match="shut down"):
            fut.result(timeout=DEADLINE_S)
    with pytest.raises(RuntimeError, match="shut down"):
        p.submit(helpers.square, 1)


def test_workers_take_the_task_role_and_import_no_torch(pool):
    mods = pool.submit(helpers.loaded_modules).result(timeout=DEADLINE_S)
    assert not any(m == "torch" or m.startswith("torch.") for m in mods)
    assert "ray_shuffling_data_loader_tpu_torch.runtime.faults" in mods
    role = pool.submit(helpers.fault_role).result(timeout=DEADLINE_S)
    assert role == "task"
