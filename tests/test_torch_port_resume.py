"""The shuffle driver's write-ahead journal on the port, against the JAX
package: the journal as a unit (fold, carry, refusal), the zero-overhead
contract in a fresh interpreter, drivers killed (SIGKILL) or suspended
(SIGTERM) mid-window and resumed, the degraded resume whose segments are
gone, and the trainer (``train_dlrm``) killed after a checkpoint and
restarted, on both loaders.

The kill legs run whole child drivers in their own sessions and shm
directories; every child runs under a deadline."""

import glob
import json
import os
import signal
import subprocess
import sys
import textwrap

import numpy as np
import pytest

from ray_shuffling_data_loader_tpu.runtime import journal as jax_journal
from ray_shuffling_data_loader_tpu.shuffle import BatchConsumer as JaxBatchConsumer
from ray_shuffling_data_loader_tpu.shuffle import shuffle as jax_shuffle
from ray_shuffling_data_loader_tpu import runtime as jax_runtime
from ray_shuffling_data_loader_tpu_torch import runtime as port_runtime
from ray_shuffling_data_loader_tpu_torch.data_generation import generate_data
from ray_shuffling_data_loader_tpu_torch.runtime import journal as jmod
from ray_shuffling_data_loader_tpu_torch.shuffle import BatchConsumer, shuffle

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHILD_DEADLINE_S = 90
NUM_ROWS, NUM_FILES, NUM_REDUCERS, NUM_EPOCHS, SEED = 900, 3, 4, 3, 7


# -- the journal as a unit ---------------------------------------------------------


def _identity(**overrides):
    base = {
        "v": 1, "seed": SEED, "num_epochs": NUM_EPOCHS, "num_reducers": NUM_REDUCERS, "num_trainers": 1,
        "start_epoch": 0, "filenames": ["/data/a.parquet", "/data/b.parquet"], "narrow_to_32": False,
        "plan": "rowwise", "columns": None, "device_batch": None, "device_columns": None,
        "session": "sess-one", "faults": None, "faults_seed": None,
    }
    base.update(overrides)
    return base


def _write_run(mod, identity):
    """A journal with every barrier kind, closed but resumable, written by
    ``mod`` (the port's journal or the JAX package's)."""
    j = mod.begin_run(identity)
    j.append("epoch", epoch=0, schedule="mapreduce")
    j.append("map", epoch=0, file=0, refs=[{"id": "s-aa", "nbytes": 10, "session": "s", "rows": [0, 4]}] * 4)
    j.append("map", epoch=0, file=1, counts=[1, 2, 3, 4])
    j.append("reduce", epoch=0, reducer=0, refs=[{"id": "s-bb", "nbytes": 5, "session": "s"}])
    j.append("deliver", epoch=0, reducer=0, rank=0, rows=220, sampled=3)
    j.append("deliver", epoch=0, reducer=1, rank=0, rows=230, sampled=5)
    j.append("epoch", epoch=1, schedule="mapreduce")
    j.append("deliver", epoch=1, reducer=0, rank=0, rows=200, sampled=0)
    j.append("verdict", epoch=0, ok=True, delivered_seq="abc123")
    mod.end_run(j, status="failed")
    return j


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_journal_fold_and_carry(tmp_path, monkeypatch, writer):
    """A journal written by either package folds in the port; the fold
    carries into a successor whose own fold agrees, and the predecessor is
    superseded."""
    monkeypatch.setenv("RSDL_JOURNAL", str(tmp_path))
    identity = _identity()
    j = _write_run(jmod if writer == "port" else jax_journal, identity)
    st = jmod.load_run(j.path)
    assert st.resumable() and not st.done and not st.suspended
    e0 = st.epochs[0]
    assert e0.schedule == "mapreduce"
    assert e0.maps[0]["refs"][0]["id"] == "s-aa" and e0.maps[1]["counts"] == [1, 2, 3, 4]
    assert e0.reduces[0][0]["id"] == "s-bb"
    assert (e0.delivered, e0.rank_rows, e0.sampled, e0.done) == (2, {0: 450}, 5, False)
    assert st.epochs[1].delivered == 1
    assert st.verdicts[0]["delivered_seq"] == "abc123"
    ref = jmod.ref_from_json(e0.maps[0]["refs"][0])
    assert (ref.object_id, ref.nbytes, ref.session, ref.rows) == ("s-aa", 10, "s", (0, 4))
    assert jmod.ref_to_json(ref) == {"id": "s-aa", "nbytes": 10, "session": "s", "rows": [0, 4]}

    j2 = jmod.begin_run(identity, resume=st)
    jmod.end_run(j2, status="failed")
    st2 = jmod.load_run(j2.path)
    assert (st2.epochs[0].delivered, st2.epochs[0].rank_rows) == (2, {0: 450})
    assert st2.epochs[0].maps[1]["counts"] == [1, 2, 3, 4]
    assert st2.verdicts[0]["delivered_seq"] == "abc123"
    assert not jmod.load_run(j.path).resumable()
    found = jmod.find_resumable(str(tmp_path), identity)
    assert found is not None and found.run_id == j2.run_id
    # The JAX package folds the port's successor the same way.
    jst2 = jax_journal.load_run(j2.path)
    assert (jst2.epochs[0].delivered, jst2.epochs[0].maps[1]["counts"]) == (2, [1, 2, 3, 4])

    # redeliver: stages carried, every delivery forgotten.
    carried = list(st2.iter_records(carry_cursors=False))
    assert not any(r["kind"] in ("deliver", "epoch-done") for r in carried)
    assert any(r["kind"] == "map" for r in carried)
    monkeypatch.setenv("RSDL_RESUME", "redeliver")
    state, mode = jmod.resolve_resume(None, identity)
    assert mode == "redeliver" and state.run_id == j2.run_id
    assert all(e.delivered == 0 and not e.done for e in state.epochs.values())


def test_journal_done_runs_are_not_resumable(tmp_path, monkeypatch):
    monkeypatch.setenv("RSDL_JOURNAL", str(tmp_path))
    identity = _identity()
    j = jmod.begin_run(identity)
    jmod.end_run(j)
    assert jmod.load_run(j.path).done
    assert jmod.find_resumable(str(tmp_path), identity) is None
    monkeypatch.setenv("RSDL_RESUME", "auto")
    assert jmod.resolve_resume(None, identity) == (None, "cursor")
    with pytest.raises(ValueError, match="completed"):
        jmod.resolve_resume(j.path, identity)


def test_journal_torn_tail_and_header(tmp_path, monkeypatch):
    monkeypatch.setenv("RSDL_JOURNAL", str(tmp_path))
    j = jmod.begin_run(_identity())
    j.append("deliver", epoch=0, reducer=0, rank=0, rows=100, sampled=0)
    jmod.end_run(j, status="failed")
    with open(j.path, "a") as f:
        f.write('{"kind": "deliver", "epoch": 0, "reducer": 1')  # torn mid-append
    assert jmod.load_run(j.path).epochs[0].delivered == 1
    bad = tmp_path / "run-headerless.ndjson"
    bad.write_text('{"kind": "deliver", "epoch": 0}\n')
    with pytest.raises(ValueError, match="identity"):
        jmod.load_run(str(bad))
    empty = tmp_path / "run-empty.ndjson"
    empty.write_text("")
    with pytest.raises(ValueError, match="empty or torn"):
        jmod.load_run(str(empty))


def test_identity_refuses_a_stream_change_and_explicit_paths_raise(tmp_path, monkeypatch):
    recorded = _identity()
    jmod.validate_identity(recorded, _identity(session="sess-two", runtime_dir="/x", faults="a"))
    for key, val in (("seed", 8), ("num_reducers", 8), ("plan", "block:2"), ("start_epoch", 1),
                     ("filenames", ["/data/other.parquet"]), ("device_batch", 64)):
        with pytest.raises(ValueError, match=key):
            jmod.validate_identity(recorded, _identity(**{key: val}))
    # Discovery skips another run silently; an explicit path refuses.
    monkeypatch.setenv("RSDL_JOURNAL", str(tmp_path))
    j = jmod.begin_run(_identity(seed=99))
    jmod.end_run(j, status="failed")
    assert jmod.resolve_resume("auto", _identity()) == (None, "cursor")
    with pytest.raises(ValueError, match="seed"):
        jmod.resolve_resume(j.path, _identity())
    assert jmod.resolve_resume("off", _identity()) == (None, "cursor")
    assert jmod.resolve_resume(None, _identity()) == (None, "cursor")


class _Collect(BatchConsumer):
    """Every delivered reducer's keys, per ``(epoch, rank)``."""

    def __init__(self):
        self.keys = {}

    def consume(self, rank, epoch, batches):
        store = port_runtime.get_context().store
        for ref in batches:
            self.keys.setdefault((epoch, rank), []).extend(store.get_columns(ref)["key"].tolist())
        store.free(batches)

    def producer_done(self, rank, epoch):
        pass

    def wait_until_ready(self, epoch):
        pass

    def wait_until_all_epochs_done(self):
        pass


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    port_runtime.init(num_workers=2)
    names, _ = generate_data(NUM_ROWS, NUM_FILES, 1, 0.0, str(tmp_path_factory.mktemp("data")), seed=SEED)
    yield names
    port_runtime.shutdown()


def test_auto_without_a_journal_runs_fresh(files, tmp_path, monkeypatch):
    monkeypatch.delenv("RSDL_JOURNAL", raising=False)
    monkeypatch.delenv("RSDL_RESUME", raising=False)
    consumer = _Collect()
    shuffle(files, consumer, 1, NUM_REDUCERS, 1, seed=5, resume_from="auto")
    assert sorted(consumer.keys[(0, 0)]) == list(range(NUM_ROWS))
    assert not list(tmp_path.rglob("run-*.ndjson"))


def test_zero_overhead_off_in_a_fresh_interpreter(tmp_path):
    """With RSDL_JOURNAL unset and no resume_from, shuffle() never imports
    the journal, writes no journal and leaves SIGTERM alone."""
    script = textwrap.dedent(f"""
        import json, os, signal, sys
        sys.path.insert(0, {REPO!r})
        for k in ("RSDL_JOURNAL", "RSDL_RESUME"):
            os.environ.pop(k, None)
        from ray_shuffling_data_loader_tpu_torch import runtime
        from ray_shuffling_data_loader_tpu_torch.data_generation import generate_data
        from ray_shuffling_data_loader_tpu_torch.shuffle import BatchConsumer, shuffle

        class Drain(BatchConsumer):
            def consume(self, rank, epoch, batches):
                runtime.get_context().store.free(batches)
            def producer_done(self, rank, epoch): pass
            def wait_until_ready(self, epoch): pass
            def wait_until_all_epochs_done(self): pass

        if __name__ == "__main__":
            runtime.init(num_workers=1)
            files, _ = generate_data(120, 1, 1, 0.0, {str(tmp_path / "data")!r})
            shuffle(files, Drain(), 2, 2, 1, seed=3)
            print("OUT " + json.dumps({{
                "journal_imported": "ray_shuffling_data_loader_tpu_torch.runtime.journal" in sys.modules,
                "sigterm_is_default": signal.getsignal(signal.SIGTERM) == signal.SIG_DFL,
            }}))
            runtime.shutdown()
    """)
    path = tmp_path / "zo.py"
    path.write_text(script)
    env = {k: v for k, v in os.environ.items() if not k.startswith("RSDL_")}
    out = subprocess.run([sys.executable, str(path)], capture_output=True, text=True, timeout=CHILD_DEADLINE_S,
                         env=env, cwd=str(tmp_path))
    assert out.returncode == 0, out.stderr
    line = [ln for ln in out.stdout.splitlines() if ln.startswith("OUT ")][-1]
    assert json.loads(line[4:]) == {"journal_imported": False, "sigterm_is_default": True}
    assert not list(tmp_path.rglob("run-*.ndjson"))


# -- drivers killed and resumed ---------------------------------------------------------

_CHILD_DRIVER = r"""
import json, os, signal, sys, threading, time
sys.path.insert(0, os.environ["RESUME_REPO"])
import numpy as np
from ray_shuffling_data_loader_tpu_torch import runtime
from ray_shuffling_data_loader_tpu_torch.shuffle import BatchConsumer, shuffle

mode = os.environ["RESUME_MODE"]
out_dir = os.environ["RESUME_OUT"]
reducers = int(os.environ["RESUME_REDUCERS"])


def watch_journal(sig):
    # Signal ourselves once the journal holds one epoch fully delivered
    # and another partly: the state a preemption is tested in.
    jdir = os.environ["RSDL_JOURNAL"]
    while True:
        time.sleep(0.01)
        for path in os.listdir(jdir):
            if not path.endswith(".ndjson"):
                continue
            cursors = {}
            with open(os.path.join(jdir, path)) as f:
                for line in f:
                    if line.endswith("\n"):
                        rec = json.loads(line)
                        if rec.get("kind") == "deliver":
                            e = int(rec["epoch"])
                            cursors[e] = max(cursors.get(e, 0), int(rec["reducer"]) + 1)
            if any(c >= reducers for c in cursors.values()) and any(0 < c < reducers for c in cursors.values()):
                os.kill(os.getpid(), sig)
                return


class Record(BatchConsumer):
    def consume(self, rank, epoch, batches, seq=None):
        store = runtime.get_context().store
        keys = np.concatenate([store.get_columns(ref)["key"] for ref in batches])
        store.free(batches)
        n = len([f for f in os.listdir(out_dir) if f.startswith(f"{mode}-{epoch}-{rank}-")])
        np.save(os.path.join(out_dir, f"{mode}-{epoch}-{rank}-{n:03d}-{seq}.npy"), keys)
        if mode == "victim":
            time.sleep(0.1)  # widen the window the watcher kills in

    def producer_done(self, rank, epoch): pass
    def wait_until_ready(self, epoch): pass
    def wait_until_all_epochs_done(self): pass


if __name__ == "__main__":
    runtime.init(num_workers=2)
    if mode == "victim":
        threading.Thread(target=watch_journal, args=(getattr(signal, os.environ["RESUME_KILL"]),), daemon=True).start()
    stats = {}
    shuffle(json.loads(os.environ["RESUME_FILES"]), Record(), int(os.environ["RESUME_EPOCHS"]), reducers, 1,
            seed=int(os.environ["RESUME_SEED"]), stats=stats)
    print("RESULT " + json.dumps(stats.get("resume")), flush=True)
    runtime.shutdown()
"""


class _Harness:
    """A control run's stream, and the work directories of a victim and
    its resume."""

    def __init__(self, files, work):
        self.files, self.work = files, str(work)
        self.journal, self.shm, self.out = (os.path.join(self.work, d) for d in ("journal", "shm", "out"))
        for d in (self.journal, self.shm, self.out):
            os.makedirs(d)
        self.child("control", {"RSDL_SHM_DIR": os.path.join(self.work, "shm-control")})
        self.control = self.stream("control")

    def child(self, mode, extra):
        env = {k: v for k, v in os.environ.items() if not k.startswith("RSDL_")}
        env.update(RESUME_REPO=REPO, RESUME_MODE=mode, RESUME_OUT=self.out, RESUME_FILES=json.dumps(self.files),
                   RESUME_EPOCHS=str(NUM_EPOCHS), RESUME_REDUCERS=str(NUM_REDUCERS), RESUME_SEED=str(SEED),
                   RSDL_SHM_DIR=self.shm)
        env.update(extra)
        script = os.path.join(self.work, "child.py")
        with open(script, "w") as f:
            f.write(_CHILD_DRIVER)
        proc = subprocess.run([sys.executable, script], capture_output=True, text=True, env=env,
                              timeout=CHILD_DEADLINE_S, cwd=self.work)
        results = [ln for ln in proc.stdout.splitlines() if ln.startswith("RESULT ")]
        return proc, json.loads(results[-1][7:]) if results else None

    def victim(self, kill):
        proc, _ = self.child("victim", {"RSDL_JOURNAL": self.journal, "RESUME_KILL": kill})
        runs = sorted(glob.glob(os.path.join(self.journal, "run-*.ndjson")))
        assert runs, proc.stderr
        st = jmod.load_run(runs[-1])
        assert st.resumable(), proc.stderr
        return proc, st

    def resume(self):
        proc, stats = self.child("resume", {"RSDL_JOURNAL": self.journal, "RSDL_RESUME": "auto"})
        assert proc.returncode == 0, proc.stderr
        return stats

    def stream(self, mode, cursors=None):
        """``{epoch: keys}`` that ``mode`` delivered in order (rank 0),
        the victim's cut at its journaled cursors."""
        out = {}
        for e in range(NUM_EPOCHS):
            paths = sorted(glob.glob(os.path.join(self.out, f"{mode}-{e}-0-*.npy")))
            if cursors is not None:
                paths = [p for p in paths if int(p.rsplit("-", 1)[1][:-4]) < cursors.get(e, 0)]
            out[e] = np.concatenate([np.load(p) for p in paths]) if paths else np.zeros(0, np.int32)
        return out

    def journal_runs(self):
        return [jmod.load_run(p) for p in sorted(glob.glob(os.path.join(self.journal, "run-*.ndjson")))]


class _JaxCollect(JaxBatchConsumer):
    def __init__(self):
        self.keys = {}

    def consume(self, rank, epoch, batches):
        store = jax_runtime.get_context().store
        for ref in batches:
            self.keys.setdefault(epoch, []).extend(store.get_columns(ref)["key"].tolist())
            store.free(ref)

    def producer_done(self, rank, epoch):
        pass

    def wait_until_ready(self, epoch):
        pass

    def wait_until_all_epochs_done(self):
        pass


@pytest.fixture(scope="module")
def jax_stream(files, local_runtime):
    consumer = _JaxCollect()
    jax_shuffle(files, consumer, NUM_EPOCHS, NUM_REDUCERS, 1, seed=SEED)
    return {e: np.asarray(k) for e, k in consumer.keys.items()}


def _shm_segments(shm):
    return [n for n in os.listdir(shm) if n.startswith("rsdl-")]


@pytest.mark.parametrize("kill", ["SIGKILL", "SIGTERM"])
def test_killed_driver_resumes_the_same_stream(files, jax_stream, tmp_path, kill):
    """SIGKILL leaves a torn window, SIGTERM a suspended one (exit 0): the
    victim's stream up to its journaled cursor, then the resumed run's,
    is the uninterrupted run's and the JAX package's, epoch by epoch. The
    completed epoch runs no stage task, and no segment of either session
    is left."""
    h = _Harness(files, tmp_path)
    for e in range(NUM_EPOCHS):
        np.testing.assert_array_equal(h.control[e], jax_stream[e])
    proc, st = h.victim(kill)
    if kill == "SIGTERM":
        assert proc.returncode == 0, proc.stderr
        assert st.suspended
    else:
        assert proc.returncode == -signal.SIGKILL
    cursors = {e: s.delivered for e, s in st.epochs.items()}
    assert any(c >= NUM_REDUCERS for c in cursors.values())
    stats = h.resume()
    victim, resumed = h.stream("victim", cursors), h.stream("resume")
    for e in range(NUM_EPOCHS):
        np.testing.assert_array_equal(np.concatenate([victim[e], resumed[e]]), h.control[e], err_msg=f"epoch {e}")
    done = [e for e, c in cursors.items() if c >= NUM_REDUCERS]
    assert stats["epochs_skipped"] == len(done)
    runs = h.journal_runs()
    assert sum(r.done for r in runs) == 1 and sum(r.superseded for r in runs) == len(runs) - 1
    fresh = [json.loads(ln) for ln in open(next(r.path for r in runs if r.done))]
    assert not [r for r in fresh if r.get("kind") in ("map", "reduce") and r.get("epoch") in done
                and not r.get("carried")]
    assert _shm_segments(h.shm) == []


def test_resume_with_every_segment_gone_reexecutes(files, tmp_path):
    """A resume that finds none of the journaled segments runs the stages
    again from the seed: the stream is unchanged."""
    h = _Harness(files, tmp_path)
    _, st = h.victim("SIGKILL")
    for name in os.listdir(h.shm):
        os.unlink(os.path.join(h.shm, name))
    stats = h.resume()
    cursors = {e: s.delivered for e, s in st.epochs.items()}
    victim, resumed = h.stream("victim", cursors), h.stream("resume")
    for e in range(NUM_EPOCHS):
        np.testing.assert_array_equal(np.concatenate([victim[e], resumed[e]]), h.control[e], err_msg=f"epoch {e}")
    assert stats.get("maps_reattached", 0) == 0 and stats.get("reduces_reattached", 0) == 0
    assert _shm_segments(h.shm) == []


# -- the trainer killed after a checkpoint and restarted ------------------------------------

_TRAINER_CHILD = r"""
import os, signal, sys
sys.path.insert(0, os.environ["RESUME_REPO"])

if __name__ == "__main__":
    kill_after = int(os.environ.get("KILL_AFTER_STEP", "0"))
    if kill_after:
        import ray_shuffling_data_loader_tpu_torch.parallel as parallel

        make = parallel.make_train_step

        def make_train_step(*a, **k):
            step = make(*a, **k)
            count = [0]

            def killing_step(*sa, **sk):
                out = step(*sa, **sk)
                count[0] += 1
                if count[0] == kill_after:
                    float(out["loss"])
                    os.killpg(os.getpgid(0), signal.SIGKILL)  # the trainer and its workers
                return out

            return killing_step

        parallel.make_train_step = make_train_step
    from ray_shuffling_data_loader_tpu_torch import train_dlrm

    sys.exit(train_dlrm.main(sys.argv[1:]))
"""


def _start(work, name, loader, kill_after=0, extra_env=None):
    """Start one ``train_dlrm --smoke`` run on the CPU in its own session,
    on the data the ``smoke_data`` fixture wrote."""
    script = os.path.join(work, "trainer.py")
    with open(script, "w") as f:
        f.write(_TRAINER_CHILD)
    env = {k: v for k, v in os.environ.items() if not k.startswith("RSDL_")}
    # Two runs share the host at a time: two intra-op threads each.
    env.update(RESUME_REPO=REPO, KILL_AFTER_STEP=str(kill_after), RSDL_SHM_DIR=os.path.join(work, "shm"),
               OMP_NUM_THREADS="2", **(extra_env or {}))
    record = os.path.join(work, f"rec-{name}")
    proc = subprocess.Popen(
        [sys.executable, script, "--smoke", "--device", "cpu", "--loader", loader, "--num-workers", "2",
         "--data-dir", os.path.dirname(SMOKE_DATA[0]), "--checkpoint-dir", os.path.join(work, f"ckpt-{name}"),
         "--checkpoint-every", "4", "--record", record],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env, cwd=work, start_new_session=True,
    )
    return proc, record


def _finish(started):
    """Wait for a run: ``(returncode, stdout, stderr, {step: record})``."""
    proc, record = started
    try:
        out, err = proc.communicate(timeout=CHILD_DEADLINE_S)
    finally:
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()
    steps = {}
    if os.path.exists(os.path.join(record, "steps.jsonl")):
        for line in open(os.path.join(record, "steps.jsonl")):
            rec = json.loads(line)
            rec["keys"] = np.load(os.path.join(record, f"keys-{rec['step']:06d}.npy"))
            steps[rec["step"]] = rec
    return proc.returncode, out, err, steps


SMOKE_DATA = []


@pytest.fixture(scope="module")
def smoke_data(files, tmp_path_factory):
    """``train_dlrm --smoke``'s dataset, written once for every run."""
    from ray_shuffling_data_loader_tpu_torch import train_dlrm

    args = train_dlrm.parse_args(["--smoke", "--data-dir", str(tmp_path_factory.mktemp("train"))])
    os.makedirs(args.data_dir)
    SMOKE_DATA[:] = train_dlrm.get_data(args)
    return SMOKE_DATA


@pytest.mark.parametrize("loader", ["mapreduce", "resident"])
def test_trainer_killed_after_a_checkpoint_resumes_the_same_steps(smoke_data, tmp_path, loader):
    """Killed (SIGKILL, with its workers) after step 6, its last
    checkpoint at step 4, the trainer restarts from that checkpoint: steps
    5 on have the uninterrupted run's keys, bit for bit, and its losses."""
    work = str(tmp_path)
    journal = {"RSDL_JOURNAL": os.path.join(work, "journal")}
    control = _start(work, "control", loader, extra_env={"RSDL_JOURNAL": os.path.join(work, "journal-control")})
    victim = _start(work, "victim", loader, kill_after=6, extra_env=journal)
    rc, _, err, victim = _finish(victim)
    assert rc == -signal.SIGKILL, err
    assert max(victim) <= 6
    os.rename(os.path.join(work, "ckpt-victim"), os.path.join(work, "ckpt-resume"))
    rc, out, err, resumed = _finish(_start(work, "resume", loader, extra_env={**journal, "RSDL_RESUME": "redeliver"}))
    assert rc == 0, err
    rc, _, err, control = _finish(control)
    assert rc == 0, err
    assert sorted(control) == list(range(1, 25))  # 2 epochs of 12 batches
    assert "resuming from step 4" in out
    assert sorted(resumed) == list(range(5, 25))
    for s in range(5, 25):
        np.testing.assert_array_equal(resumed[s]["keys"], control[s]["keys"], err_msg=f"step {s}")
        assert abs(resumed[s]["loss"] - control[s]["loss"]) <= 1e-6, s
    result = json.loads([ln for ln in out.splitlines() if ln.startswith("RESULT ")][-1][7:])
    assert result["loader"] == loader
    if loader == "mapreduce":
        # The restart re-attached what the killed trainer's shuffle had
        # journaled, and left no segment of either session.
        assert result["resume"]["mode"] == "redeliver" and result["resume"]["from_run"]
        assert result["resume"].get("reduces_reattached", 0) + result["resume"].get("maps_reattached", 0) > 0
        assert _shm_segments(os.path.join(work, "shm")) == []
    else:
        from ray_shuffling_data_loader_tpu_torch.utils.prng import epoch_permutation

        perm = epoch_permutation(42, 0, 50_000, device="cpu").numpy()
        np.testing.assert_array_equal(resumed[5]["keys"], perm[4 * 4096:5 * 4096])
