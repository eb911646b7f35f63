"""The plan compiler (``RSDL_PLAN=auto``) on the port, against the JAX
package: the footer pass, every term of ``compile_plan`` under each
environment pin, the decode cache on and off, with and without a
staging layout; ``replan`` under the same injected signals; the
delivered stream and staged tensors of a planned run on a dataset of at
least 2R row groups a file; planned against hand-set runs; and a plane
that stays dark when ``RSDL_PLAN`` is unset.

Both planners read the store's budget and the host's cores: the tests
pin them (``_store_budget``, ``_cores``) and both stores' budgets, so
that the two runtimes in this process decide from the same figures."""

import collections
import importlib
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

from ray_shuffling_data_loader_tpu import native as jax_native
from ray_shuffling_data_loader_tpu import runtime as jax_runtime
from ray_shuffling_data_loader_tpu.analysis import planner as jax_planner
from ray_shuffling_data_loader_tpu.jax_dataset import JaxShufflingDataset
from ray_shuffling_data_loader_tpu.runtime import plan as jax_plan_state
from ray_shuffling_data_loader_tpu.runtime.store import logical_columns as jax_logical_columns
from ray_shuffling_data_loader_tpu_torch import native as port_native
from ray_shuffling_data_loader_tpu_torch import runtime as port_runtime
from ray_shuffling_data_loader_tpu_torch import shuffle as sh
from ray_shuffling_data_loader_tpu_torch.analysis import planner
from ray_shuffling_data_loader_tpu_torch.data_generation import KEY_COLUMN, LABEL_COLUMN, generate_data
from ray_shuffling_data_loader_tpu_torch.device_dataset import DeviceShufflingDataset
from ray_shuffling_data_loader_tpu_torch.runtime import plan as plan_state
from ray_shuffling_data_loader_tpu_torch.runtime import store as port_store

jax_sh = importlib.import_module("ray_shuffling_data_loader_tpu.shuffle")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NUM_REDUCERS, SEED = 4, 11
BUDGET = 1 << 30
CORES = 8
PLAN_KNOBS = list(planner.TERM_KNOBS.values()) + ["RSDL_PLAN", "RSDL_INDEX_SHUFFLE", "RSDL_DECODE_CACHE_SHARED"]


@pytest.fixture(autouse=True)
def pinned(monkeypatch):
    """Every planner-owned knob and the gate unset; both planners' budget
    and cores pinned."""
    for knob in PLAN_KNOBS:
        monkeypatch.delenv(knob, raising=False)
    for mod in (planner, jax_planner):
        monkeypatch.setattr(mod, "_store_budget", lambda: BUDGET)
        monkeypatch.setattr(mod, "_cores", lambda: CORES)


@pytest.fixture(scope="module")
def port_rt():
    port_runtime.init(num_workers=2)
    yield
    port_runtime.shutdown()


@pytest.fixture(scope="module")
def wide(tmp_path_factory, port_rt):
    """8 row groups a file: 8 >= 2R at R = 4, so the planner takes block:1."""
    names, _ = generate_data(3000, 3, 8, 0.3, str(tmp_path_factory.mktemp("wide")))
    return names


@pytest.fixture(scope="module")
def narrow(tmp_path_factory, port_rt):
    """5 row groups a file: fewer than 2R, so the plan stays rowwise."""
    names, _ = generate_data(800, 2, 5, 0.0, str(tmp_path_factory.mktemp("narrow")))
    return names


@pytest.fixture
def same_budgets(monkeypatch, local_runtime, port_rt):
    """Both stores' budgets equal, for the decode-cache policy the
    selective term consults."""
    for rt in (port_runtime, jax_runtime):
        monkeypatch.setattr(rt.get_context().store, "capacity_bytes", BUDGET)


def _datasets(wide, narrow):
    return {"wide": wide, "narrow": narrow}


LAYOUT = {"batch": 100, "columns": ["key", "embeddings_name3", "labels"]}

# Environment pins, each set alone: every planner-owned knob.
PINS = {
    "none": {},
    "plan_rowwise": {"RSDL_SHUFFLE_PLAN": "rowwise"},
    "plan_block2": {"RSDL_SHUFFLE_PLAN": "block:2"},
    "selective_auto": {"RSDL_SELECTIVE_READS": "auto"},
    "selective_off": {"RSDL_SELECTIVE_READS": "off"},
    "pushdown_on": {"RSDL_DECODE_PUSHDOWN": "on"},
    "rowgroups_3": {"RSDL_DECODE_ROWGROUPS": "3"},
    "window_7": {"RSDL_FETCH_WINDOW_DEPTH": "7"},
    "native_2": {"RSDL_NATIVE_THREADS": "2"},
}


def test_footer_stats_match_jax(wide, narrow):
    for name, files in _datasets(wide, narrow).items():
        for columns in (None, ["key", "labels"]):
            for narrow_to_32 in (False, True):
                got = planner.footer_stats(files, columns, narrow_to_32)
                assert got == jax_planner.footer_stats(files, columns, narrow_to_32), (name, columns)
        assert got["groups_min"] == (8 if name == "wide" else 5)
    assert planner.footer_stats(wide)["rows"] == 3000


@pytest.mark.parametrize("pin", sorted(PINS))
@pytest.mark.parametrize("layout", [None, LAYOUT])
@pytest.mark.parametrize("cache", [True, False])
@pytest.mark.parametrize("dataset", ["wide", "narrow"])
def test_compile_plan_matches_jax(wide, narrow, same_budgets, monkeypatch, dataset, cache, layout, pin):
    """Every term (value, source, knob, reason), the plan, the projection
    and the task knobs equal the JAX planner's."""
    files = _datasets(wide, narrow)[dataset]
    for k, v in PINS[pin].items():
        monkeypatch.setenv(k, v)
    port_native.refresh_threads_from_env()
    jax_native.refresh_threads_from_env()
    try:
        kwargs = dict(num_reducers=NUM_REDUCERS, num_trainers=2, num_epochs=2, device_layout=layout,
                      narrow_to_32=layout is not None, cache_decoded=cache)
        got = planner.compile_plan(files, **kwargs)
        want = jax_planner.compile_plan(files, **kwargs)
    finally:
        monkeypatch.undo()
        port_native.refresh_threads_from_env()
        jax_native.refresh_threads_from_env()
    assert got.terms_dict() == want.terms_dict()
    assert got.plan == want.plan and got.projection == want.projection
    assert got.task_knobs() == want.task_knobs() and got.effective_env() == want.effective_env()
    assert got.model == want.model
    if pin == "none":
        assert got.plan == (("block", 1) if dataset == "wide" else ("rowwise", 0))
        assert got.term_value("selective") is (dataset == "wide" and not cache)
        assert got.projection == (LAYOUT["columns"] if layout else None)


def test_compile_plan_with_a_caller_projection_matches_jax(wide, same_budgets):
    for columns in (["key", "labels"], ["labels"]):
        got = planner.compile_plan(wide, num_reducers=NUM_REDUCERS, num_epochs=2, columns=columns, device_layout=LAYOUT)
        want = jax_planner.compile_plan(wide, num_reducers=NUM_REDUCERS, num_epochs=2, columns=columns,
                                        device_layout=LAYOUT)
        assert got.terms_dict() == want.terms_dict() and got.projection is None
        assert got.terms["columns"].source == "env"


@pytest.mark.parametrize("budget", [1, 1 << 50, None])
def test_window_depth_against_the_budget_matches_jax(wide, monkeypatch, budget):
    for mod in (planner, jax_planner):
        monkeypatch.setattr(mod, "_store_budget", lambda: budget)
    got = planner.compile_plan(wide, num_reducers=2)
    assert got.terms_dict() == jax_planner.compile_plan(wide, num_reducers=2).terms_dict()
    want = {1: 1, 1 << 50: 8, None: planner.WINDOW_DEPTH_DEFAULT}[budget]
    assert got.term_value("fetch_window_depth") == want


# Injected live signals, and whether the window depth is pinned.
SIGNALS = {
    "reduce_headroom": {"shm_used_frac": 0.2, "critical_path": "reduce"},
    "reduce_unknown_shm": {"critical_path": "reduce"},
    "over_watermark": {"shm_used_frac": 0.95},
    "map_bound": {"critical_path": "map"},
    "map_over_watermark": {"shm_used_frac": 0.9, "critical_path": "map"},
    "quiet": {"shm_used_frac": 0.6, "critical_path": "reduce"},
    "none": {},
}


@pytest.mark.parametrize("depth_pin", [None, "2"])
@pytest.mark.parametrize("cache_friendly", [True, False])
@pytest.mark.parametrize("signals", sorted(SIGNALS))
def test_replan_matches_jax(wide, narrow, monkeypatch, signals, cache_friendly, depth_pin):
    """Under the same signals both re-planners make the same changes, in
    the same order, and leave the same terms; a pinned term never
    changes; no signal, no change."""
    if depth_pin:
        monkeypatch.setenv("RSDL_FETCH_WINDOW_DEPTH", depth_pin)
    monkeypatch.setattr(sh, "_decode_cache_auto", lambda *a, **k: cache_friendly)
    monkeypatch.setattr(jax_sh, "_decode_cache_auto", lambda *a, **k: cache_friendly)
    for mod in (planner, jax_planner):
        monkeypatch.setattr(mod, "_live_signals", lambda: dict(SIGNALS[signals]))
    for files in (wide, narrow):
        got = planner.compile_plan(files, num_reducers=2, num_epochs=2)
        want = jax_planner.compile_plan(files, num_reducers=2, num_epochs=2)
        for epoch in (1, 2):
            assert planner.replan(got, epoch=epoch) == jax_planner.replan(want, epoch=epoch)
        assert got.terms_dict() == want.terms_dict() and got.replans == want.replans
        if depth_pin:
            assert got.terms["fetch_window_depth"].value == 2
        if signals == "none":
            assert got.replans == 0


def test_port_replan_holds_without_telemetry(wide, monkeypatch):
    """With no telemetry plane loaded there is no live signal, and no
    change. The planes are taken out of ``sys.modules`` here: another test
    of this process may have loaded them."""
    for name in ("capacity", "critical", "timeseries"):
        monkeypatch.delitem(sys.modules, f"ray_shuffling_data_loader_tpu_torch.telemetry.{name}", raising=False)
    assert planner._live_signals() == {}
    rplan = planner.compile_plan(wide, num_reducers=2)
    assert planner.replan(rplan, epoch=1) == [] and rplan.replans == 0


# -- planned runs ------------------------------------------------------------------------


class _Collect(sh.BatchConsumer):
    def __init__(self):
        self.cols = collections.defaultdict(lambda: collections.defaultdict(list))
        self.live_terms = None

    def consume(self, rank, epoch, batches):
        if self.live_terms is None:
            self.live_terms = plan_state.current_terms()
        store = port_runtime.get_context().store
        for ref in batches:
            cb = store.get_columns(ref)
            views = list(port_store.iter_packed_batches(cb)) if port_store.is_device_batch(cb) else [cb.columns]
            for k in views[0]:
                self.cols[(epoch, rank)][k].append(np.concatenate([np.asarray(v[k]) for v in views]))
        store.free(batches)

    def producer_done(self, rank, epoch):
        pass

    def wait_until_ready(self, epoch):
        pass

    def wait_until_all_epochs_done(self):
        pass

    def streams(self):
        return {key: {k: np.concatenate(v) for k, v in cols.items()} for key, cols in self.cols.items()}


class _JaxCollect(jax_sh.BatchConsumer):
    def __init__(self):
        self.cols = collections.defaultdict(lambda: collections.defaultdict(list))

    def consume(self, rank, epoch, batches):
        store = jax_runtime.get_context().store
        for ref in batches:
            for k, v in jax_logical_columns(store.get_columns(ref)).items():
                self.cols[(epoch, rank)][k].append(np.asarray(v).copy())
            store.free(ref)

    def producer_done(self, rank, epoch):
        pass

    def wait_until_ready(self, epoch):
        pass

    def wait_until_all_epochs_done(self):
        pass

    def streams(self):
        return {key: {k: np.concatenate(v) for k, v in cols.items()} for key, cols in self.cols.items()}


def _assert_streams_equal(got, want):
    assert sorted(got) == sorted(want)
    for key in want:
        assert sorted(got[key]) == sorted(want[key])
        for k in want[key]:
            np.testing.assert_array_equal(got[key][k], want[key][k], err_msg=f"{key} {k}")


def _port_run(files, **kwargs):
    consumer, log, stats = _Collect(), [], {}
    sh.shuffle(list(files), consumer, 2, NUM_REDUCERS, 2, seed=SEED, schedule_log=log, stats=stats, **kwargs)
    return consumer, [s for _, s in log], stats


@pytest.mark.parametrize("layout", [None, LAYOUT])
@pytest.mark.parametrize("cache", [False, True])
def test_planned_stream_matches_jax(wide, same_budgets, monkeypatch, cache, layout):
    """``RSDL_PLAN=auto`` on a dataset of 2R row groups a file: the port
    plans ``block:1`` as the JAX package does and delivers its stream,
    every column, selective with the cache off, materialized with it on."""
    monkeypatch.setenv("RSDL_PLAN", "auto")
    kwargs = dict(cache_decoded=cache, device_layout=layout, narrow_to_32=layout is not None)
    want = _JaxCollect()
    jax_sh.shuffle(list(wide), want, 2, NUM_REDUCERS, 2, seed=SEED, **kwargs)
    got, schedules, stats = _port_run(wide, **kwargs)
    assert stats["plan"] == "block:1"
    assert stats["plan_terms"]["plan"]["value"] == ["block", 1] and stats["plan_replans"] == []
    assert got.live_terms == stats["plan_terms"]
    assert stats["columns"] == (LAYOUT["columns"] if layout else None)
    if cache:
        assert "selective" not in schedules and stats["selective_reads"] == "planned: off"
    else:
        assert schedules == ["selective"] * 2
    _assert_streams_equal(got.streams(), want.streams())
    assert plan_state.current() is None and jax_plan_state.current() is None


def test_planned_staged_tensors_match_jax(wide, same_budgets, monkeypatch):
    """A staging consumer under ``RSDL_PLAN=auto``: block:1, only the
    layout's columns decoded, and the JAX package's staged tensors."""
    monkeypatch.setenv("RSDL_PLAN", "auto")
    features = ["embeddings_name3", "embeddings_name0", KEY_COLUMN]
    spec = dict(feature_columns=features, label_column=LABEL_COLUMN, num_reducers=NUM_REDUCERS, seed=SEED,
                cache_decoded=False)
    jds = JaxShufflingDataset(wide, 2, 1, 200, 0, queue_name="planner-jax", **spec)
    pds = DeviceShufflingDataset(wide, 2, 1, 200, 0, queue_name="planner-port", device="cpu", **spec)
    for epoch in range(2):
        jds.set_epoch(epoch)
        pds.set_epoch(epoch)
        want = [({k: np.asarray(v) for k, v in f.items()}, np.asarray(l)) for f, l in jds]
        got = [(f, l) for f, l in pds]
        assert len(got) == len(want) == 15
        for (gf, gl), (wf, wl) in zip(got, want):
            for k in features:
                np.testing.assert_array_equal(gf[k].numpy(), wf[k], err_msg=k)
            np.testing.assert_array_equal(gl.numpy(), wl)
    pds.join()
    stats = pds.dataset.shuffle_stats
    assert stats["plan"] == "block:1" and stats["columns"] == features + [LABEL_COLUMN]
    assert stats["decode_bytes_pruned"] > 0
    assert [s for _, s in pds.dataset.schedule_log] == ["selective"] * 2


@pytest.mark.parametrize("cache", [False, True])
def test_planned_run_equals_hand_set(wide, same_budgets, monkeypatch, cache):
    """A planned run and a run with its terms set by hand (planner off)
    deliver the same stream, every column."""
    monkeypatch.setenv("RSDL_PLAN", "auto")
    planned, planned_log, stats = _port_run(wide, cache_decoded=cache)
    rplan = planner.compile_plan(wide, num_reducers=NUM_REDUCERS, num_trainers=2, num_epochs=2, cache_decoded=cache)
    assert rplan.terms_dict() == stats["plan_terms"]
    monkeypatch.delenv("RSDL_PLAN")
    for knob, value in rplan.effective_env().items():
        monkeypatch.setenv(knob, value)
    hand, hand_log, hand_stats = _port_run(wide, cache_decoded=cache)
    assert hand.live_terms is None and "plan_terms" not in hand_stats
    assert hand_stats["plan"] == stats["plan"] == "block:1"
    assert ("selective" in hand_log) == ("selective" in planned_log) == (not cache)
    _assert_streams_equal(planned.streams(), hand.streams())


def test_planned_rowwise_when_groups_are_too_few(narrow, same_budgets, monkeypatch):
    """Fewer than 2R row groups a file: rowwise, as unplanned, every key
    once an epoch."""
    monkeypatch.setenv("RSDL_PLAN", "on")
    got, schedules, stats = _port_run(narrow, cache_decoded=False)
    assert stats["plan"] == "rowwise" and "cannot meet" in stats["plan_terms"]["plan"]["why"]
    assert set(schedules) == {"mapreduce"}
    monkeypatch.delenv("RSDL_PLAN")
    unplanned, _, _ = _port_run(narrow, cache_decoded=False)
    _assert_streams_equal(got.streams(), unplanned.streams())
    for epoch in range(2):
        keys = np.concatenate([got.streams()[(epoch, r)]["key"] for r in range(2)])
        assert sorted(keys.tolist()) == list(range(800))


def test_plan_knobs_reach_every_stage_task(wide, same_budgets, monkeypatch):
    """The planned knobs ride every stage task's arguments, and the task
    wrapper applies the planned native threads in its process."""
    monkeypatch.setenv("RSDL_PLAN", "auto")
    submitted = []
    submit = sh._submit_stage

    def spy(pool, tally, native_on, knobs, fn, *args):
        submitted.append((fn.__name__, knobs))
        return submit(pool, tally, native_on, knobs, fn, *args)

    monkeypatch.setattr(sh, "_submit_stage", spy)
    _, _, stats = _port_run(wide, cache_decoded=False)
    want = {name: t["value"] for name, t in stats["plan_terms"].items()
            if name in ("decode_rowgroup_threads", "fetch_window_depth", "native_threads", "selective")}
    assert want["selective"] is True and len(want) == 4
    names = {name for name, _ in submitted}
    assert names == {"shuffle_selective_plan", "shuffle_selective_reduce"}
    assert all(knobs == want for _, knobs in submitted)
    before = port_native.num_threads()
    try:
        out, counts = sh._run_stage(port_native.num_threads, True, {"native_threads": 3}, ())
        assert out == 3 and counts["decode"] == {"rowgroups": 0, "bytes": 0, "bytes_pruned": 0}
    finally:
        port_native.set_num_threads(before)


def test_planner_stays_dark_when_unset(tmp_path):
    """With ``RSDL_PLAN`` unset (and ``off``), a shuffle in a fresh
    interpreter never imports the planner or the plan module."""
    script = textwrap.dedent(f"""
        import os, sys
        sys.path.insert(0, {REPO!r})
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
            files, _ = generate_data(400, 2, 8, 0.0, {str(tmp_path / "data")!r})
            for mode in (None, "off"):
                if mode:
                    os.environ["RSDL_PLAN"] = mode
                shuffle(files, Drain(), 2, 2, 1, seed=3, cache_decoded=False)
            loaded = [m for m in sys.modules if m.endswith(("analysis.planner", "runtime.plan"))]
            print("LOADED", loaded)
            runtime.shutdown()
    """)
    path = tmp_path / "dark.py"
    path.write_text(script)
    env = {k: v for k, v in os.environ.items() if not k.startswith("RSDL_")}
    env["RSDL_SHM_DIR"] = str(tmp_path / "shm")
    os.makedirs(env["RSDL_SHM_DIR"])
    out = subprocess.run([sys.executable, str(path)], capture_output=True, text=True, env=env, timeout=120,
                         cwd=str(tmp_path))
    assert out.returncode == 0, out.stderr
    assert "LOADED []" in out.stdout
