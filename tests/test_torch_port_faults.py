"""The port's fault plane (``runtime/faults.py``) and stage budget
(``runtime/retry.py``) against the JAX package's: the same specs parse and
the same ones are refused; for one spec and seed every invocation decides
alike; the role, epoch, point and ``xN`` filters; faults off is a no-op;
``stage_policy`` numbers its attempts as the JAX one does."""

import os
import subprocess
import sys
import textwrap

import pytest

from ray_shuffling_data_loader_tpu.runtime import faults as jax_faults
from ray_shuffling_data_loader_tpu.runtime import retry as jax_retry
from ray_shuffling_data_loader_tpu_torch.runtime import faults
from ray_shuffling_data_loader_tpu_torch.runtime import retry

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
INVOCATIONS = 1000


@pytest.fixture(autouse=True)
def clean_env(monkeypatch):
    for key in ("RSDL_FAULTS", "RSDL_FAULTS_SEED", "RSDL_STAGE_MAX_ATTEMPTS"):
        monkeypatch.delenv(key, raising=False)
    faults.refresh_from_env()
    jax_faults.refresh_from_env()
    yield
    monkeypatch.undo()
    for plane in (faults, jax_faults):
        plane.set_role("driver")
        plane.refresh_from_env()


def _arm(monkeypatch, spec, seed=None):
    monkeypatch.setenv("RSDL_FAULTS", spec)
    if seed is not None:
        monkeypatch.setenv("RSDL_FAULTS_SEED", str(seed))
    faults.refresh_from_env()
    jax_faults.refresh_from_env()


GOOD_SPECS = (
    "task.map:crash:0.5",
    "task.map/task:crash-entry:1.0@2x3",
    "store.get/task:lost:1x1, transport.send/driver:reset:0.25",
    "a.b:delay:1.0@0,c.d:stall:0.1x2,e.f:corrupt:1,g.h:fail:0.9,i.j:kill:0.01,k.l:wedge:1@3",
    "queue.producer:crash-exit:1.0",
    "",
    " , ",
    "task.reduce:crash:1e-3",
)
BAD_SPECS = (
    "nonsense",
    "a.b:frobnicate:0.5",
    "a.b:crash:1.5",
    "a.b:crash:0",
    "a.b:crash:-0.1",
    "a.b:crash:x",
    "a.b:crash:0.5@e",
    "a.b:crash:0.5xN",
    "a.b:crash",
    "a.b:crash:0.5:extra",
)


def _rules(plane, spec):
    return [(r.site, r.kind, r.prob, r.role, r.epoch, r.max_fires) for r in plane.parse_spec(spec)]


@pytest.mark.parametrize("spec", GOOD_SPECS)
def test_parse_spec_accepts_what_jax_accepts(spec):
    assert _rules(faults, spec) == _rules(jax_faults, spec)


@pytest.mark.parametrize("spec", BAD_SPECS)
def test_parse_spec_refuses_what_jax_refuses(spec):
    with pytest.raises(ValueError):
        jax_faults.parse_spec(spec)
    with pytest.raises(ValueError):
        faults.parse_spec(spec)


def test_kinds_are_the_jax_packages():
    assert set(faults.KINDS) == set(jax_faults._KINDS) and len(faults.KINDS) == 11


@pytest.mark.parametrize(
    "site,kind,prob,seed",
    [
        ("task.map", "crash-entry", 0.3, 0),
        ("task.reduce", "kill", 0.05, 7),
        ("store.get", "lost", 0.5, 12345),
        ("transport.send", "reset", 0.01, 2**40 + 3),
        ("queue.producer", "delay", 0.75, 99),
    ],
)
def test_decisions_equal_jax_for_a_thousand_invocations(monkeypatch, site, kind, prob, seed):
    point = kind.split("-", 1)[1] if "-" in kind else None
    _arm(monkeypatch, f"{site}:{kind}:{prob}", seed)
    got = [faults.should_fire(site, point=point) for _ in range(INVOCATIONS)]
    want = [jax_faults.should_fire(site, point=point) for _ in range(INVOCATIONS)]
    assert got == want
    base = kind.split("-", 1)[0]
    assert 0 < got.count(base) < INVOCATIONS  # the schedule fires some, not all
    assert faults.fired_counts() == jax_faults.fired_counts() == {(site, base): got.count(base)}
    for i in (0, 1, 17, 999):
        assert faults._decision(seed, site, kind, i) == jax_faults._decision(site, kind, i)


def test_the_seed_changes_the_schedule(monkeypatch):
    _arm(monkeypatch, "x.y:crash:0.3", 42)
    first = [faults.should_fire("x.y") for _ in range(64)]
    faults.refresh_from_env()
    assert [faults.should_fire("x.y") for _ in range(64)] == first  # the same seed replays
    _arm(monkeypatch, "x.y:crash:0.3", 43)
    assert [faults.should_fire("x.y") for _ in range(64)] != first


def test_role_epoch_point_and_cap_filters(monkeypatch):
    _arm(monkeypatch, "a.b/task:crash:1.0,c.d:crash:1.0@2,e.f:crash:1x1,t.s:crash-exit:1.0")
    for plane in (faults, jax_faults):
        assert plane.should_fire("a.b") is None  # a driver here
        plane.set_role("task")
        assert plane.should_fire("a.b") == "crash" and plane.role() == "task"
        plane.set_role("driver")
        assert plane.should_fire("c.d", epoch=1) is None
        assert plane.should_fire("c.d", epoch=2) == "crash"
        assert plane.should_fire("c.d") is None  # a site that knows no epoch
        assert plane.should_fire("e.f") == "crash"
        assert plane.should_fire("e.f") is None
        assert plane.should_fire("t.s", point="entry") is None
        assert plane.should_fire("t.s", point="exit") == "crash"
        assert plane.fired_counts()[("e.f", "crash")] == 1


def test_fire_acts_on_each_kind(monkeypatch):
    monkeypatch.setenv("RSDL_FAULTS_DELAY_S", "0.001")
    monkeypatch.setenv("RSDL_FAULTS_WEDGE_S", "0.001")
    _arm(monkeypatch, "c.c:crash:1,r.r:reset:1,f.f:fail:1,d.d:delay:1,w.w:wedge:1,l.l:lost:1")
    with pytest.raises(faults.FaultInjected) as info:
        faults.fire("c.c")
    assert (info.value.site, info.value.kind) == ("c.c", "crash")
    with pytest.raises(ConnectionResetError):
        faults.fire("r.r")
    with pytest.raises(OSError):
        faults.fire("f.f")
    faults.fire("d.d")
    faults.fire("w.w")
    with pytest.raises(faults.FaultInjected):  # a store kind on another site is loud
        faults.fire("l.l")
    import pickle

    again = pickle.loads(pickle.dumps(info.value))
    assert (again.site, again.kind, str(again)) == ("c.c", "crash", str(info.value))


def test_kill_exits_the_process():
    script = textwrap.dedent(
        f"""
        import os, sys
        sys.path.insert(0, {REPO!r})
        os.environ["RSDL_FAULTS"] = "k.k:kill:1"
        from ray_shuffling_data_loader_tpu_torch.runtime import faults
        faults.fire("k.k")
        print("survived")
        """
    )
    out = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True, timeout=60)
    assert out.returncode == 17 and "survived" not in out.stdout


def test_faults_off_is_a_no_op(monkeypatch):
    assert not faults.enabled()
    assert faults.should_fire("task.map") is None
    faults.fire("task.map", epoch=0, point="entry")
    assert faults.fired_counts() == {}


def test_a_malformed_environment_disarms_and_configure_refuses(monkeypatch):
    _arm(monkeypatch, "not a rule")
    assert faults.enabled() and faults.should_fire("not a rule") is None
    with pytest.raises(ValueError):
        faults.configure("a.b:crash:2")
    faults.configure("a.b:crash:1", seed=5)
    assert os.environ["RSDL_FAULTS"] == "a.b:crash:1" and os.environ["RSDL_FAULTS_SEED"] == "5"
    assert faults.should_fire("a.b") == "crash"
    faults.reset()
    assert "RSDL_FAULTS" not in os.environ and not faults.enabled()


def test_the_runtime_loads_the_plane_at_its_first_use():
    script = textwrap.dedent(
        f"""
        import sys
        sys.path.insert(0, {REPO!r})
        import ray_shuffling_data_loader_tpu_torch.runtime as rt
        name = "ray_shuffling_data_loader_tpu_torch.runtime.faults"
        before = name in sys.modules
        plane = rt.faults
        print(before, plane is sys.modules[name], plane.enabled())
        """
    )
    env = {k: v for k, v in os.environ.items() if not k.startswith("RSDL_")}
    out = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True, timeout=60, env=env)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["False", "True", "False"]


@pytest.mark.parametrize("attempts", [None, "1", "5"])
def test_stage_policy_numbers_attempts_as_jax(monkeypatch, attempts):
    if attempts is not None:
        monkeypatch.setenv("RSDL_STAGE_MAX_ATTEMPTS", attempts)
    port, jax = retry.stage_policy(), jax_retry.stage_policy()
    assert (port.max_attempts, port.base_delay_s, port.max_delay_s, port.multiplier, port.jitter, port.deadline_s) == (
        jax.max_attempts, jax.base_delay_s, jax.max_delay_s, jax.multiplier, jax.jitter, jax.deadline_s)
    assert [a for a, _ in port.attempts(site="stage.map")] == [a for a, _ in jax.attempts(site="stage.map")]
    assert port.max_attempts == int(attempts or 3)


def test_call_policy_is_cached_until_refreshed(monkeypatch):
    retry.refresh_policies()
    first = retry.call_policy()
    monkeypatch.setenv("RSDL_CALL_RETRIES", "7")
    assert retry.call_policy() is first
    retry.refresh_policies()
    assert retry.call_policy().max_attempts == 7
    monkeypatch.undo()
    retry.refresh_policies()
