"""The re-planner on live signals: a metered, planned port run against
the JAX package's ``replan``.

A two-epoch ``RSDL_PLAN=auto`` shuffle with ``RSDL_METRICS`` on (the
capacity ledger and the critical-path view loaded, task records and
ledger ops spooled by the workers): the signals the port's ``replan``
read before epoch 1 (``shm_used_frac`` from ``capacity.view()``, the
critical path, its sole-active shares and the stalls from
``critical.analyze()``) must be real values, equal to those views at
that moment; the JAX ``replan``, handed the same signals on the same
plan, must make the changes the port's run made; and the run delivers
every key once an epoch whatever the re-planner changed.

Both planners read the store's budget and the host's cores: they are
pinned, as in ``test_torch_port_planner.py``."""

import copy
import importlib

import numpy as np

from ray_shuffling_data_loader_tpu.analysis import planner as jax_planner
from ray_shuffling_data_loader_tpu_torch.analysis import planner

BUDGET = 1 << 30
CORES = 8
ENV = list(planner.TERM_KNOBS.values()) + ["RSDL_PLAN", "RSDL_INDEX_SHUFFLE", "RSDL_DECODE_CACHE_SHARED",
                                           "RSDL_METRICS", "RSDL_METRICS_DIR", "RSDL_EVENTS_DIR", "RSDL_TS",
                                           "RSDL_TRACE", "RSDL_PROFILE"]


def test_replan_on_a_metered_run_s_live_signals_matches_jax(monkeypatch, tmp_path):
    import ray_shuffling_data_loader_tpu_torch as port
    from ray_shuffling_data_loader_tpu_torch import shuffle as sh
    from ray_shuffling_data_loader_tpu_torch.telemetry import capacity, critical, metrics, stragglers

    for key in ENV:
        monkeypatch.delenv(key, raising=False)
    for mod in (planner, jax_planner):
        monkeypatch.setattr(mod, "_store_budget", lambda: BUDGET)
        monkeypatch.setattr(mod, "_cores", lambda: CORES)
    for mod in (sh, importlib.import_module("ray_shuffling_data_loader_tpu.shuffle")):
        monkeypatch.setattr(mod, "_decode_cache_auto", lambda *a, **k: True)  # each store's own budget aside
    monkeypatch.setenv("RSDL_METRICS", "1")
    monkeypatch.setenv("RSDL_METRICS_DIR", str(tmp_path / "metrics"))
    monkeypatch.setenv("RSDL_EVENTS_DIR", str(tmp_path / "events"))
    monkeypatch.setenv("RSDL_PLAN", "auto")
    metrics.refresh_from_env()
    for mod in (metrics, stragglers, capacity, critical):
        mod.reset()
    seen = []
    live = planner._live_signals

    def recording():
        signals = live()
        seen.append((signals, capacity.view(), critical.analyze()))
        return signals

    monkeypatch.setattr(planner, "_live_signals", recording)
    port.runtime.init(num_workers=2)
    try:
        files, _ = port.generate_data(3000, 3, 8, 0.3, str(tmp_path / "data"))
        kwargs = dict(num_reducers=4, num_trainers=1, num_epochs=2, cache_decoded=True)
        before = planner.compile_plan(files, **kwargs)
        want = jax_planner.compile_plan(files, **kwargs)
        assert before.terms_dict() == want.terms_dict()
        keys, stats = [], {}

        class Consumer(sh.BatchConsumer):
            def consume(self, rank, epoch, batches):
                keys.append((epoch, np.concatenate([port.runtime.get_columns(b)["key"] for b in batches])))
                port.runtime.free(batches)

            def producer_done(self, rank, epoch):
                pass

            def wait_until_ready(self, epoch):
                pass

            def wait_until_all_epochs_done(self):
                pass

        sh.shuffle(files, Consumer(), 2, 4, 1, seed=5, cache_decoded=True, stats=stats)
    finally:
        port.runtime.shutdown()
        for mod in (stragglers, capacity, critical):
            mod.reset()
        metrics.reset()
    for epoch in range(2):
        got = np.concatenate([k for e, k in keys if e == epoch])
        assert np.array_equal(np.sort(got), np.arange(3000))
    (signals, view, analysis), = seen  # one replan: before epoch 1
    assert signals["shm_used_frac"] == view["shm_used_frac"] is not None
    assert signals["critical_path"] == analysis["current"]["critical_path"] is not None
    assert signals["sole_share"] == analysis["current"]["sole_share"]
    assert analysis["current"]["epoch"] == 0 and analysis["epochs"][0]["epoch"] == 0
    monkeypatch.setattr(jax_planner, "_live_signals", lambda: copy.deepcopy(signals))
    changes = jax_planner.replan(want, epoch=1)
    assert [{"epoch": 1, **c} for c in changes] == stats["plan_replans"]
    assert want.terms_dict() == stats["plan_terms"]
