"""The port stands alone: no JAX, flax, optax or JAX-package import, in
its sources, in ``chip_smoke.py``, or at run time; and its default
device is CUDA, never a silent CPU fallback."""

import ast
import os
import re
import subprocess
import sys
import textwrap

import pytest
import torch

import ray_shuffling_data_loader_tpu_torch as port
from ray_shuffling_data_loader_tpu_torch.utils.device import resolve_device

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_DIR = os.path.join(REPO, "ray_shuffling_data_loader_tpu_torch")
FORBIDDEN = {"jax", "flax", "optax", "ray_shuffling_data_loader_tpu"}


def _sources():
    for dirpath, _, filenames in os.walk(PORT_DIR):
        for fn in filenames:
            if fn.endswith(".py"):
                yield os.path.join(dirpath, fn)
    yield os.path.join(REPO, "chip_smoke.py")


def _imported_top_levels(path):
    tree = ast.parse(open(path).read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


def test_no_forbidden_imports_in_sources():
    paths = list(_sources())
    assert len(paths) >= 15
    bad = {
        (os.path.relpath(p, REPO), name)
        for p in paths
        for name in _imported_top_levels(p)
        if name in FORBIDDEN
    }
    assert not bad
    # The check compares whole names: the port's own name is allowed.
    assert "ray_shuffling_data_loader_tpu_torch" not in FORBIDDEN


# The audit plane runs in the pool's workers, which never load torch.
AUDIT_PLANE = ("telemetry/__init__.py", "telemetry/_env.py", "telemetry/audit.py", "replay.py")


def test_audit_plane_imports_no_torch():
    scanned = {os.path.relpath(p, PORT_DIR) for p in _sources()}
    for rel in AUDIT_PLANE:
        assert rel in scanned
        names = set(_imported_top_levels(os.path.join(PORT_DIR, rel)))
        assert "torch" not in names and not names & FORBIDDEN, (rel, names)
    script = textwrap.dedent(
        f"""
        import sys
        sys.path.insert(0, {REPO!r})
        from ray_shuffling_data_loader_tpu_torch import replay
        from ray_shuffling_data_loader_tpu_torch.telemetry import audit
        import ray_shuffling_data_loader_tpu_torch as port
        assert port.telemetry.audit is audit
        audit.StreamDigest().update([1, 2, 3], offset=0)
        print("LOADED", sorted({{m.split(".")[0] for m in sys.modules}} & {{"torch", *{sorted(FORBIDDEN)!r}}}))
        """
    )
    env = {k: v for k, v in os.environ.items() if not k.startswith(("JAX", "XLA"))}
    out = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True, timeout=120, env=env)
    assert out.returncode == 0, out.stderr
    assert "LOADED []" in out.stdout, out.stdout


def test_running_the_port_loads_no_jax(tmp_path):
    script = textwrap.dedent(
        f"""
        import sys
        sys.path.insert(0, {REPO!r})
        import torch
        import ray_shuffling_data_loader_tpu_torch as port
        port.runtime.init(num_workers=2)
        files, _ = port.generate_data(600, 2, 1, 0.0, {str(tmp_path)!r})
        cols = [c for c in port.DATA_SPEC if c != port.LABEL_COLUMN]
        ds = port.DeviceShufflingDataset(files, 1, 1, 200, 0, feature_columns=cols,
                                         label_column=port.LABEL_COLUMN, num_reducers=2,
                                         device="cpu")
        model = port.dlrm_for_data_spec(embed_dim=4, top_mlp=(8,), vocab_cap=64,
                                        compute_dtype=torch.float32, device="cpu")
        step = port.make_train_step(model, port.make_optimizer(model))
        ds.set_epoch(0)
        batches = list(ds)
        losses = [float(step(f, l)["loss"]) for f, l in batches]
        assert len(losses) == 3, losses
        tt = port.transformer_for_data_spec(embed_dim=8, num_layers=1, num_heads=2, vocab_cap=64,
                                            compute_dtype=torch.float32, device="cpu")
        tt_loss = float(port.make_train_step(tt, port.make_optimizer(tt))(*batches[0])["loss"])
        assert tt_loss == tt_loss, tt_loss
        port.runtime.shutdown()
        loaded = sorted({{m.split(".")[0] for m in sys.modules}} & set({sorted(FORBIDDEN)!r}))
        print("LOADED", loaded)
        """
    )
    env = {k: v for k, v in os.environ.items() if not k.startswith(("JAX", "XLA"))}
    out = subprocess.run(
        [sys.executable, "-c", script], capture_output=True, text=True, timeout=120, env=env
    )
    assert out.returncode == 0, out.stderr
    assert "LOADED []" in out.stdout, out.stdout


def test_checkpoint_journal_and_trainer_load_no_jax(tmp_path):
    """The checkpoint, the shuffle's journal and the trainer, driven
    through a journaled shuffle and a checkpoint round trip, load no JAX
    module."""
    script = textwrap.dedent(
        f"""
        import os, sys
        sys.path.insert(0, {REPO!r})
        os.environ["RSDL_JOURNAL"] = {str(tmp_path / "journal")!r}
        import torch
        import ray_shuffling_data_loader_tpu_torch as port
        from ray_shuffling_data_loader_tpu_torch import train_dlrm
        from ray_shuffling_data_loader_tpu_torch.runtime import journal

        if __name__ == "__main__":
            port.runtime.init(num_workers=1)
            files, _ = port.generate_data(400, 2, 1, 0.0, {str(tmp_path / "data")!r})
            ds = port.ShufflingDataset(files, 1, 1, 100, 0, num_reducers=2)
            ds.set_epoch(0)
            assert sum(b.num_rows for b in ds) == 400
            ds.join()
            assert journal.load_run(ds.shuffle_stats["journal"]).done
            model = port.dlrm_for_data_spec(embed_dim=4, top_mlp=(8,), vocab_cap=16, device="cpu")
            opt = port.make_optimizer(model)
            mgr = port.CheckpointManager({str(tmp_path / "ck")!r})
            mgr.save(1, cursor=port.BatchCursor(), state={{"model": model.state_dict(), "optimizer": opt.state_dict()}})
            mgr.restore(target={{"model": model, "optimizer": opt}})
            assert train_dlrm.parse_args(["--smoke"]).batch_size == 4096
            port.runtime.shutdown()
            loaded = sorted({{m.split(".")[0] for m in sys.modules}} & set({sorted(FORBIDDEN)!r}))
            print("LOADED", loaded)
        """
    )
    path = tmp_path / "drive.py"
    path.write_text(script)
    env = {k: v for k, v in os.environ.items() if not k.startswith(("JAX", "XLA", "RSDL_"))}
    out = subprocess.run([sys.executable, str(path)], capture_output=True, text=True, timeout=120, env=env)
    assert out.returncode == 0, out.stderr
    assert "LOADED []" in out.stdout, out.stdout


def test_sequence_parallel_path_loads_no_jax(tmp_path):
    """A rank of the long-context trainer (ring, Ulysses and dense attention,
    a world of one) and the ops over a two-rank group load no JAX module."""
    script = textwrap.dedent(
        f"""
        import json, socket, sys, time
        sys.path.insert(0, {REPO!r})
        import torch
        import torch.distributed as dist
        from ray_shuffling_data_loader_tpu_torch import train_long_context
        from ray_shuffling_data_loader_tpu_torch.ops import blockwise_attention, make_ulysses_attention

        with socket.socket() as s:
            s.bind(("localhost", 0))
            port = s.getsockname()[1]
        args = train_long_context.parse_args(["--backend", "gloo", "--device", "cpu", "--dp", "1", "--sp", "1",
                                              "--seq-len", "32", "--embed-dim", "16", "--steps", "2",
                                              "--attention", "ring", "ulysses", "dense"])
        spec = {{**vars(args), "init_method": f"tcp://localhost:{{port}}", "out_dir": {str(tmp_path)!r}}}
        assert train_long_context.run_rank(spec, 0, time.time()) == 0
        runs = json.load(open({str(tmp_path / "rank0.json")!r}))["runs"]
        assert [r["attention"] for r in runs] == ["ring", "ulysses", "dense"], runs
        q = torch.randn(1, 8, 2, 4, requires_grad=True)
        blockwise_attention(q, q, q, causal=True, kv_chunk=3).sum().backward()
        make_ulysses_attention(None, causal=True)(q, q, q).sum().backward()
        loaded = sorted({{m.split(".")[0] for m in sys.modules}} & set({sorted(FORBIDDEN)!r}))
        print("LOADED", loaded)
        """
    )
    env = {k: v for k, v in os.environ.items() if not k.startswith(("JAX", "XLA"))}
    out = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True, timeout=120, env=env)
    assert out.returncode == 0, out.stderr
    assert "LOADED []" in out.stdout, out.stdout


def test_default_device_is_cuda_and_raises_without_it(monkeypatch):
    model = port.dlrm_for_data_spec(embed_dim=4, top_mlp=(8,), vocab_cap=16, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        resolve_device()
    with pytest.raises(RuntimeError):
        resolve_device("cuda")
    with pytest.raises(RuntimeError):
        port.DeviceShufflingDataset([], 1, 1, 8, 0, feature_columns=["a"], label_column="b")
    # The model factories resolve their device the same way.
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port.dlrm_for_data_spec(embed_dim=4, top_mlp=(8,), vocab_cap=16)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port.example_features(model, 4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port.transformer_for_data_spec(embed_dim=4, num_layers=1, num_heads=2, vocab_cap=16)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port.CausalLM(16, 8, embed_dim=4, num_layers=1, num_heads=2)
    # The trainer, too, before it starts a session.
    from ray_shuffling_data_loader_tpu_torch import train_dlrm

    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_dlrm.main(["--smoke"])
    # The long-context trainer, before it spawns a rank.
    from ray_shuffling_data_loader_tpu_torch import train_long_context

    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_long_context.main(["--backend", "gloo"])
    assert resolve_device("cpu") == torch.device("cpu")
    assert port.example_features(model, 4, device="cpu")[model.columns[0]].device.type == "cpu"



# The cluster plane runs in the host agents, the store servers and their
# workers, which never load torch.
CLUSTER_PLANE = ("runtime/__init__.py", "runtime/transport.py", "runtime/actor.py", "runtime/cluster.py",
                 "runtime/store.py", "runtime/tasks.py", "runtime/retry.py", "runtime/journal.py", "shuffle.py",
                 "dataset.py", "batch_queue.py")


def test_cluster_plane_imports_no_torch(tmp_path):
    """The cluster plane's sources import no torch, no JAX and nothing of
    the JAX package; a cluster's head, its agent and a task on the
    agent's worker load none of them either."""
    scanned = {os.path.relpath(p, PORT_DIR) for p in _sources()}
    for rel in CLUSTER_PLANE:
        assert rel in scanned
        names = set(_imported_top_levels(os.path.join(PORT_DIR, rel)))
        assert "torch" not in names and not names & FORBIDDEN, (rel, names)
    script = textwrap.dedent(
        f"""
        import sys
        sys.path.insert(0, {REPO!r})
        sys.path.insert(0, {os.path.join(REPO, "tests")!r})

        def main():
            from ray_shuffling_data_loader_tpu_torch import runtime
            from ray_shuffling_data_loader_tpu_torch.runtime import cluster, transport  # noqa: F401
            import torch_port_helpers

            ctx = runtime.init_cluster(advertise_host="127.0.0.1", num_workers=1)
            worker = runtime.submit(torch_port_helpers.loaded_modules).result(timeout=60)
            runtime.shutdown()
            bad = {{"torch", *{sorted(FORBIDDEN)!r}}}
            print("LOADED", sorted({{m.split(".")[0] for m in sys.modules}} & bad),
                  sorted({{m.split(".")[0] for m in worker}} & bad))

        if __name__ == "__main__":
            main()
        """
    )
    path = tmp_path / "cluster_drive.py"
    path.write_text(script)
    env = {k: v for k, v in os.environ.items() if not k.startswith(("JAX", "XLA", "RSDL_"))}
    out = subprocess.run([sys.executable, str(path)], capture_output=True, text=True, timeout=120, env=env)
    assert out.returncode == 0, out.stderr
    assert "LOADED [] []" in out.stdout, out.stdout


# The fault plane and the pool run in the workers, which never load torch.
FAULT_PLANE = ("runtime/faults.py", "runtime/retry.py", "runtime/tasks.py", "shuffle.py")


def test_fault_plane_imports_no_torch(tmp_path):
    """The fault plane's sources import no torch, no JAX and nothing of the
    JAX package; a shuffle recovered through an armed schedule loads none
    of them in the driver or in the workers, and ``shuffle.StageFailedError``
    comes from the port."""
    scanned = {os.path.relpath(p, PORT_DIR) for p in _sources()}
    for rel in FAULT_PLANE:
        assert rel in scanned
        names = set(_imported_top_levels(os.path.join(PORT_DIR, rel)))
        assert "torch" not in names and not names & FORBIDDEN, (rel, names)
    script = textwrap.dedent(
        f"""
        import os, sys
        sys.path.insert(0, {REPO!r})
        sys.path.insert(0, {os.path.join(REPO, "tests")!r})
        os.environ["RSDL_FAULTS"] = "task.map/task:crash-entry:1x1,task.reduce/task:crash-exit:1x1"

        def main():
            from ray_shuffling_data_loader_tpu_torch import data_generation, runtime, shuffle
            import torch_port_helpers

            runtime.init(num_workers=2)
            files, _ = data_generation.generate_data(800, 2, 1, 0.0, {str(tmp_path)!r})
            stats = {{}}
            shuffle.shuffle(files, torch_port_helpers.Drain(runtime), 1, 2, 1, stats=stats)
            assert stats["stage_retries"]["map"] >= 1 and stats["stage_retries"]["reduce"] >= 1, stats
            worker = runtime.submit(torch_port_helpers.loaded_modules).result(timeout=60)
            assert issubclass(shuffle.StageFailedError, runtime.TaskError)
            runtime.shutdown()
            bad = {{"torch", *{sorted(FORBIDDEN)!r}}}
            print("LOADED", sorted({{m.split(".")[0] for m in sys.modules}} & bad),
                  sorted({{m.split(".")[0] for m in worker}} & bad))

        if __name__ == "__main__":
            main()
        """
    )
    path = tmp_path / "faults_drive.py"
    path.write_text(script)
    env = {k: v for k, v in os.environ.items() if not k.startswith(("JAX", "XLA", "RSDL_"))}
    out = subprocess.run([sys.executable, str(path)], capture_output=True, text=True, timeout=120, env=env)
    assert out.returncode == 0, out.stderr
    assert "LOADED [] []" in out.stdout, out.stdout


# The metrics and trace planes: the standard library only, as the JAX
# package's, so that the pool's workers load them without torch or numpy.
METRICS_TRACE_PLANES = ("metrics", "trace", "export", "events", "phases")


@pytest.mark.parametrize("name", METRICS_TRACE_PLANES)
def test_metrics_and_trace_planes_import_the_standard_library_only(name):
    path = os.path.join(PORT_DIR, "telemetry", f"{name}.py")
    assert path in set(_sources())
    names = set(_imported_top_levels(path))
    assert names <= set(sys.stdlib_module_names) | {"ray_shuffling_data_loader_tpu_torch"}, names
    assert not names & FORBIDDEN


def test_metrics_and_trace_planes_load_no_torch_numpy_or_jax(tmp_path):
    script = textwrap.dedent(
        f"""
        import os, sys
        sys.path.insert(0, {REPO!r})
        os.environ.update(RSDL_METRICS="1", RSDL_TRACE="1", RSDL_TRACE_DIR={str(tmp_path / "trace")!r},
                          RSDL_METRICS_DIR={str(tmp_path / "metrics")!r}, RSDL_EVENTS_DIR={str(tmp_path / "events")!r})
        from ray_shuffling_data_loader_tpu_torch import telemetry
        from ray_shuffling_data_loader_tpu_torch.telemetry import events, export, metrics, phases, trace
        heavy = {{"torch", "numpy", *{sorted(FORBIDDEN)!r}}}
        print("IMPORTED", sorted({{m.split(".")[0] for m in sys.modules}} & heavy))
        with telemetry.context(epoch=1), telemetry.trace_span("s"):
            with phases.stage_profiler("map").phase("decode:io"):
                metrics.safe_inc("c", 1.0)
        export.flush()
        trace.flush()
        print("RAN", sorted({{m.split(".")[0] for m in sys.modules}} & {{"torch", *{sorted(FORBIDDEN)!r}}}))
        """
    )
    env = {k: v for k, v in os.environ.items() if not k.startswith(("JAX", "XLA", "RSDL_"))}
    out = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True, timeout=120, env=env)
    assert out.returncode == 0, out.stderr
    assert "IMPORTED []" in out.stdout and "RAN []" in out.stdout, out.stdout


# The SLO engine, the obs server, the relay, the elastic control plane and
# the multi-job service: the standard library only, as the JAX package's;
# used, they load no torch and nothing of JAX.
OBS_PLANES = ("telemetry/slo", "telemetry/obs_server", "telemetry/relay", "runtime/elastic", "runtime/service")


@pytest.mark.parametrize("name", OBS_PLANES)
def test_obs_planes_import_the_standard_library_only(name):
    path = os.path.join(PORT_DIR, f"{name}.py")
    assert path in set(_sources())
    names = set(_imported_top_levels(path))
    assert names <= set(sys.stdlib_module_names) | {"ray_shuffling_data_loader_tpu_torch"}, names
    assert not names & FORBIDDEN


def test_obs_planes_load_no_torch_or_jax(tmp_path):
    # One tick of the elastic controller too: its signals, gauges and
    # evictor over a store of its own; and one job of the service, armed.
    script = textwrap.dedent(
        f"""
        import json, os, sys, urllib.request
        sys.path.insert(0, {REPO!r})
        os.environ.update(RSDL_METRICS="1", RSDL_METRICS_DIR={str(tmp_path / "metrics")!r})
        from ray_shuffling_data_loader_tpu_torch.telemetry import obs_server, relay, slo
        slo.evaluate()
        port = obs_server.start(0)
        for route in ("/metrics", "/status", "/healthz", "/alerts", "/jobs"):
            urllib.request.urlopen(f"http://127.0.0.1:{{port}}{{route}}", timeout=10).read()
        obs_server.stop()
        dirs = {{k: os.path.join({str(tmp_path)!r}, k) for k in relay._KINDS}}
        relay.RelaySink(dirs=dirs).ship("h:1", [])
        import types
        from ray_shuffling_data_loader_tpu_torch.runtime import elastic
        from ray_shuffling_data_loader_tpu_torch.runtime.store import ObjectStore
        store = ObjectStore("gate", shm_dir={str(tmp_path / "shm")!r})
        elastic.ElasticController(types.SimpleNamespace(store=store, scheduler=types.SimpleNamespace(width=1),
                                                        cluster=None, session="gate", runtime_dir=None)).tick()
        os.environ["RSDL_SERVICE"] = "auto"
        from ray_shuffling_data_loader_tpu_torch.runtime import service
        job = service.register_job(name="gate")
        with service.job_context(job):
            assert service.scoped_name("q") == "q--" + job.job_id
        service.end_job(job)
        assert service.live_jobs_count() == 0
        heavy = {{"torch", *{sorted(FORBIDDEN)!r}}}
        print("LOADED", sorted({{m.split(".")[0] for m in sys.modules}} & heavy))
        """
    )
    env = {k: v for k, v in os.environ.items() if not k.startswith(("JAX", "XLA", "RSDL_"))}
    out = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True, timeout=120, env=env)
    assert out.returncode == 0, out.stderr
    assert "LOADED []" in out.stdout, out.stdout


# The temporal and decision planes, the profiler, the run ledger and the
# knob registry: the standard library only, as the JAX package's.
DECISION_PLANES = ("telemetry/stragglers", "telemetry/critical", "telemetry/capacity", "telemetry/timeseries",
                   "telemetry/profiler", "telemetry/runledger", "analysis/knob_registry")


@pytest.mark.parametrize("name", DECISION_PLANES)
def test_decision_planes_import_the_standard_library_only(name):
    path = os.path.join(PORT_DIR, f"{name}.py")
    assert path in set(_sources())
    names = set(_imported_top_levels(path))
    assert names <= set(sys.stdlib_module_names) | {"ray_shuffling_data_loader_tpu_torch"}, names
    assert not names & FORBIDDEN


def test_decision_planes_load_no_torch_numpy_or_jax(tmp_path):
    script = textwrap.dedent(
        f"""
        import os, sys
        sys.path.insert(0, {REPO!r})
        os.environ.update(RSDL_METRICS="1", RSDL_PROFILE="1", RSDL_METRICS_DIR={str(tmp_path / "metrics")!r},
                          RSDL_PROFILE_DIR={str(tmp_path / "profiles")!r},
                          RSDL_RUN_LEDGER={str(tmp_path / "runs.ndjson")!r})
        from ray_shuffling_data_loader_tpu_torch.analysis import knob_registry
        from ray_shuffling_data_loader_tpu_torch.telemetry import (capacity, critical, profiler, runledger,
                                                                   stragglers, timeseries)
        heavy = {{"torch", "numpy", *{sorted(FORBIDDEN)!r}}}
        print("IMPORTED", sorted({{m.split(".")[0] for m in sys.modules}} & heavy))
        stragglers.record_task("shuffle_map", 0.1, epoch=0)
        capacity.note("create", "x", nbytes=8, tier="shm", epoch=0)
        profiler._tick()
        timeseries.sample_now()
        critical.analyze(), capacity.view(), stragglers.analyze()
        runledger.record_run("done", duration_s=1.0)
        # The spools' source identity reads the fault plane's role, whose
        # package loads numpy: as the metrics planes' does.
        print("RAN", sorted({{m.split(".")[0] for m in sys.modules}} & (heavy - {{"numpy"}})), len(runledger.read()))
        """
    )
    env = {k: v for k, v in os.environ.items() if not k.startswith(("JAX", "XLA", "RSDL_"))}
    out = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True, timeout=120, env=env)
    assert out.returncode == 0, out.stderr
    assert "IMPORTED []" in out.stdout and "RAN [] 1" in out.stdout, out.stdout


def _environment_reads(path):
    """The ``RSDL_*`` names a source file mentions in a string, its
    environment reads among them."""
    tree = ast.parse(open(path).read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Constant) and isinstance(node.value, str):
            yield from re.findall(r"\bRSDL_[A-Z0-9_]+", node.value)


# Variables the port reads and the JAX package does not: none so far.
PORT_ONLY_KNOBS = set()


def test_knob_registry_names_the_jax_package_s_knobs_and_every_port_read():
    """The port's registry is the JAX package's, knob for knob, plus
    :data:`PORT_ONLY_KNOBS`; every ``RSDL_*`` name in the port's sources
    is in it; its planned knobs are the planner's terms'."""
    from ray_shuffling_data_loader_tpu.analysis.knob_registry import KNOBS as JAX_KNOBS
    from ray_shuffling_data_loader_tpu_torch.analysis import knob_registry

    names = [k.name for k in knob_registry.KNOBS]
    assert len(names) == len(set(names))
    assert set(names) == {k.name for k in JAX_KNOBS} | PORT_ONLY_KNOBS
    assert [k for k in knob_registry.KNOBS if k.name not in PORT_ONLY_KNOBS] == [
        knob_registry.Knob(**{f: getattr(k, f) for f in ("name", "kind", "default", "scope", "help", "prefix",
                                                          "planned")}) for k in JAX_KNOBS]
    read = {name for path in _sources() if path.startswith(PORT_DIR) for name in _environment_reads(path)}
    unknown = {n for n in read if knob_registry.REGISTRY.lookup(n) is None
               and knob_registry.REGISTRY.lookup(n, is_prefix=True) is None}
    assert not unknown, unknown
    from ray_shuffling_data_loader_tpu_torch.analysis import planner

    assert set(planner.TERM_KNOBS.values()) == {k.name for k in knob_registry.KNOBS if k.planned}
