"""The port's rsdl-lint, held to the JAX package's: the same findings on
every fixture tree of ``tests/test_rsdl_lint.py`` and on the JAX
package's own tree, a clean port with its reviewed suppressions, the
CLI's exit codes and ``--json``, the runtime twin of gate-integrity on
both packages, and a lint that loads no torch.

Fixture trees are built twice, once under each package name, and linted
in-process through each package's ``run_checks``; findings must agree in
check, line, column, suppression and reason, and in path and message up
to the package name.
"""

import json
import os
import re
import shutil
import subprocess
import sys
import textwrap

import pytest

from ray_shuffling_data_loader_tpu.analysis import Project as JaxProject
from ray_shuffling_data_loader_tpu.analysis import run_checks as jax_run_checks
from ray_shuffling_data_loader_tpu.analysis.core import LintCrash as JaxLintCrash
from ray_shuffling_data_loader_tpu_torch.analysis import LintCrash, Project, run_checks
from ray_shuffling_data_loader_tpu_torch.analysis.core import Finding

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_PKG = "ray_shuffling_data_loader_tpu"
PORT_PKG = "ray_shuffling_data_loader_tpu_torch"
_JAX_NAME = re.compile(r"\bray_shuffling_data_loader_tpu\b")

# The port's reviewed suppressions on the repo: a new one is a reviewed
# change of this number (chip_smoke.py's [lint] phase holds the same).
PORT_SUPPRESSED = 26


def to_port(text):
    return _JAX_NAME.sub(PORT_PKG, text)


def to_jax(text):
    return text.replace(PORT_PKG, JAX_PKG)


def write_tree(root, files):
    for rel, content in files.items():
        path = root / rel
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(content)
    return str(root)


def run_port_cli(*args, timeout=300):
    env = {k: v for k, v in os.environ.items() if not k.startswith("RSDL_")}
    return subprocess.run([sys.executable, "-m", f"{PORT_PKG}.rsdl_lint", *args], capture_output=True,
                          text=True, cwd=REPO, env=env, timeout=timeout)


def normalized(findings):
    return [(f.check, to_jax(f.path), f.line, f.col, to_jax(f.message), f.suppressed, f.suppress_reason)
            for f in findings]


# ---------------------------------------------------------------------------
# The fixture trees of tests/test_rsdl_lint.py, written under the JAX
# package's name: (id, files, select, expected active findings or "crash").
# ---------------------------------------------------------------------------

P = JAX_PKG
FIXTURES = [
    ("gate_integrity_violation", {
        f"{P}/__init__.py": "",
        f"{P}/telemetry/__init__.py": "",
        f"{P}/telemetry/events.py": "def emit(kind, **kw):\n    pass\n",
        f"{P}/shuffle.py": (
            "from ray_shuffling_data_loader_tpu.telemetry import events\n"
            "def go():\n    events.emit('x.y')\n"
        ),
    }, "gate-integrity", 1),
    ("gate_integrity_lazy_import_is_clean", {
        f"{P}/__init__.py": "",
        f"{P}/telemetry/__init__.py": "",
        f"{P}/telemetry/events.py": "def emit(kind, **kw):\n    pass\n",
        f"{P}/shuffle.py": (
            "def go():\n"
            "    from ray_shuffling_data_loader_tpu.telemetry import events\n"
            "    events.emit('x.y')\n"
        ),
    }, "gate-integrity", 0),
    ("gate_integrity_transitive_via_helper_module", {
        f"{P}/__init__.py": "",
        f"{P}/telemetry/__init__.py": "",
        f"{P}/telemetry/audit.py": "def enabled():\n    return False\n",
        f"{P}/helper.py": "from ray_shuffling_data_loader_tpu.telemetry import audit\n",
        f"{P}/dataset.py": "from ray_shuffling_data_loader_tpu import helper  # noqa\n",
    }, "gate-integrity", 1),
    ("knob_registry_violation", {
        f"{P}/__init__.py": "",
        f"{P}/config.py": (
            "import os\n"
            "def f():\n"
            "    return os.environ.get('RSDL_NOT_A_REAL_KNOB')\n"
        ),
    }, "knob-registry", 1),
    ("knob_registry_constant_and_helper_reads", {
        f"{P}/__init__.py": "",
        f"{P}/a.py": (
            "import os\n"
            "ENV_BAD = 'RSDL_BOGUS_CONST'\n"
            "def f():\n"
            "    return os.environ.get(ENV_BAD)\n"
        ),
        f"{P}/b.py": (
            "import os\n"
            "def read_flag(name):\n"
            "    return os.environ.get(name, '') == '1'\n"
            "def g():\n"
            "    return read_flag('RSDL_BOGUS_HELPER')\n"
        ),
    }, "knob-registry", 2),
    ("vocabulary_drift_violation", {
        f"{P}/__init__.py": "",
        f"{P}/m.py": (
            "from ray_shuffling_data_loader_tpu.telemetry import metrics as _metrics\n"
            "def f():\n"
            "    _metrics.safe_inc('totally.new_metric')\n"
        ),
        "docs/observability.md": "# vocabulary\n\nnothing here\n",
    }, "vocabulary-drift", 1),
    ("vocabulary_drift_rejects_substring_of_documented_name", {
        f"{P}/__init__.py": "",
        f"{P}/m.py": (
            "from ray_shuffling_data_loader_tpu.telemetry import metrics as _metrics\n"
            "def f():\n"
            "    _metrics.safe_inc('queue.dep')\n"
        ),
        "docs/observability.md": (
            "| `queue.depth{epoch=E,rank=R}` | gauge | queue |\n"
            "and the family `trial.start/done/failed` is expanded.\n"
        ),
    }, "vocabulary-drift", 1),
    ("vocabulary_drift_doc_alternation_and_labels_match", {
        f"{P}/__init__.py": "",
        f"{P}/m.py": (
            "from ray_shuffling_data_loader_tpu import telemetry\n"
            "from ray_shuffling_data_loader_tpu.telemetry import metrics as _metrics\n"
            "def f():\n"
            "    _metrics.safe_inc('queue.depth')\n"
            "    telemetry.emit_event('trial.failed')\n"
        ),
        "docs/observability.md": (
            "| `queue.depth{epoch=E,rank=R}` | gauge | queue |\n"
            "events: `trial.start/done/failed`.\n"
        ),
    }, "vocabulary-drift", 0),
    ("determinism_violation", {
        f"{P}/__init__.py": "",
        f"{P}/shuffle.py": (
            "import random\n"
            "def plan(files):\n"
            "    random.shuffle(files)\n"
            "    return files\n"
        ),
    }, "determinism-hygiene", 1),
    ("determinism_seeded_rng_is_clean", {
        f"{P}/__init__.py": "",
        f"{P}/shuffle.py": (
            "import random\n"
            "import numpy as np\n"
            "def plan(files, seed):\n"
            "    rng = random.Random(seed)\n"
            "    g = np.random.default_rng(seed)\n"
            "    rng.shuffle(files)\n"
            "    return files, g\n"
        ),
    }, "determinism-hygiene", 0),
    ("lock_discipline_violation", {
        f"{P}/__init__.py": "",
        f"{P}/state.py": (
            "import threading\n"
            "_TABLE = {}\n"
            "_lock = threading.Lock()\n"
            "def register(k, v):\n"
            "    _TABLE[k] = v\n"
            "def ok(k, v):\n"
            "    with _lock:\n"
            "        _TABLE[k] = v\n"
        ),
    }, "lock-discipline", 1),
    ("lock_order_violation", {
        f"{P}/__init__.py": "",
        f"{P}/order.py": (
            "import threading\n"
            "a_lock = threading.Lock()\n"
            "b_lock = threading.Lock()\n"
            "def one():\n"
            "    with a_lock:\n"
            "        with b_lock:\n"
            "            pass\n"
            "def two():\n"
            "    with b_lock:\n"
            "        with a_lock:\n"
            "            pass\n"
        ),
    }, "lock-discipline", 1),
    ("barrier_order_violation", {
        f"{P}/__init__.py": "",
        f"{P}/runtime/__init__.py": "",
        f"{P}/runtime/tasks.py": (
            "def _worker_main(result_q):\n"
            "    result_q.put(('done', 1, None, None))\n"
        ),
    }, "barrier-order", 1),
    ("barrier_order_flush_first_is_clean", {
        f"{P}/__init__.py": "",
        f"{P}/runtime/__init__.py": "",
        f"{P}/runtime/tasks.py": (
            "def _flush_telemetry_spools():\n"
            "    pass\n"
            "def _worker_main(result_q):\n"
            "    _flush_telemetry_spools()\n"
            "    result_q.put(('done', 1, None, None))\n"
        ),
    }, "barrier-order", 0),
    ("suppression_with_reason_is_honored", {
        f"{P}/__init__.py": "",
        f"{P}/telemetry/__init__.py": "",
        f"{P}/telemetry/events.py": "def emit(k):\n    pass\n",
        f"{P}/shuffle.py": (
            "from ray_shuffling_data_loader_tpu.telemetry import events"
            "  # rsdl-lint: disable=gate-integrity -- fixture exercising"
            " the suppression path\n"
        ),
    }, "gate-integrity", 0),
    ("suppression_comment_block_above_is_honored", {
        f"{P}/__init__.py": "",
        f"{P}/state.py": (
            "import threading\n"
            "_TABLE = {}\n"
            "def register(k, v):\n"
            "    # rsdl-lint: disable=lock-discipline -- import-time\n"
            "    # registration, threads start later\n"
            "    _TABLE[k] = v\n"
        ),
    }, "lock-discipline", 0),
    ("suppression_without_reason_is_a_finding", {
        f"{P}/__init__.py": "",
        f"{P}/x.py": "VAL = 1  # rsdl-lint: disable=lock-discipline\n",
    }, "lock-discipline", 1),
    ("unknown_select_crashes", {f"{P}/__init__.py": ""}, "no-such-check", "crash"),
    ("select_bad_suppression_is_valid", {
        f"{P}/__init__.py": "",
        f"{P}/x.py": "VAL = 1  # rsdl-lint: disable=lock-discipline\n",
    }, "bad-suppression", 1),
    ("json_round_trip", {
        f"{P}/__init__.py": "",
        f"{P}/runtime/__init__.py": "",
        f"{P}/runtime/tasks.py": (
            "def _worker_main(result_q):\n"
            "    result_q.put(('done', 1, None, None))\n"
        ),
    }, "barrier-order", 1),
]


def _lint(run, crash, root, select):
    try:
        return run(JaxProject(root) if run is jax_run_checks else Project(root), select=select.split(","))
    except crash as exc:
        return f"crash: {exc}"


@pytest.mark.parametrize("files,select,expected", [f[1:] for f in FIXTURES], ids=[f[0] for f in FIXTURES])
def test_fixture_findings_match_the_jax_linter(tmp_path, files, select, expected):
    jax_root = write_tree(tmp_path / "jax", files)
    port_root = write_tree(tmp_path / "port", {to_port(rel): to_port(text) for rel, text in files.items()})
    want = _lint(jax_run_checks, JaxLintCrash, jax_root, select)
    got = _lint(run_checks, LintCrash, port_root, select)
    if expected == "crash":
        assert isinstance(want, str) and isinstance(got, str) and to_jax(got) == want, (got, want)
        return
    assert normalized(got) == normalized(want)
    assert sum(not f.suppressed for f in got) == expected, normalized(got)


# ---------------------------------------------------------------------------
# The JAX package's own tree, renamed: the port's linter must find there
# what the JAX linter finds in the JAX package.
# ---------------------------------------------------------------------------


def test_jax_package_tree_findings_match_the_jax_linter(tmp_path):
    src = os.path.join(REPO, JAX_PKG)
    for dirpath, dirnames, filenames in os.walk(src):
        dirnames[:] = [d for d in dirnames if d != "__pycache__"]
        rel_dir = os.path.relpath(dirpath, src)
        for fn in filenames:
            if not fn.endswith(".py"):
                continue
            with open(os.path.join(dirpath, fn), encoding="utf-8") as f:
                text = f.read()
            renamed = to_port(text)
            assert renamed.count("\n") == text.count("\n")
            dest = tmp_path / PORT_PKG / rel_dir / fn
            dest.parent.mkdir(parents=True, exist_ok=True)
            dest.write_text(renamed, encoding="utf-8")
    (tmp_path / "docs").mkdir()
    for doc in ("TUNING.md", "observability.md"):
        shutil.copy(os.path.join(REPO, "docs", doc), tmp_path / "docs" / doc)

    want = [f for f in jax_run_checks(JaxProject(REPO)) if f.path.startswith(f"{JAX_PKG}/")]
    got = [f for f in run_checks(Project(str(tmp_path))) if f.path.startswith(f"{PORT_PKG}/")]
    assert normalized(got) == normalized(want)
    assert want and all(f.suppressed and f.suppress_reason for f in want)


# ---------------------------------------------------------------------------
# The port itself: clean, every suppression reasoned, the count pinned.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("as_json", [False, True])
def test_port_is_clean(as_json):
    res = run_port_cli(*(("--json",) if as_json else ()))
    assert res.returncode == 0, res.stdout[-4000:] + res.stderr[-2000:]
    if as_json:
        payload = json.loads(res.stdout)
        assert payload["version"] == 1
        assert payload["counts"] == {"active": 0, "suppressed": PORT_SUPPRESSED}
        for f in payload["findings"]:
            assert f.get("suppressed") and f.get("suppress_reason"), f
    else:
        assert f"rsdl-lint: 0 finding(s), {PORT_SUPPRESSED} suppressed" in res.stdout


def test_scope_is_the_port_s_files_only():
    paths = set(Project(REPO).sources)
    assert "chip_smoke.py" in paths
    assert f"{PORT_PKG}/rsdl_lint.py" in paths and f"{PORT_PKG}/analysis/core.py" in paths
    assert "tests/test_torch_port_lint.py" in paths and "tests/torch_port_helpers.py" in paths
    assert any(p.startswith("tools/torch_port_") for p in paths)
    outside = {p for p in paths if not (p == "chip_smoke.py" or p.startswith(f"{PORT_PKG}/")
                                        or re.fullmatch(r"tools/torch_port_\w+\.py", p)
                                        or re.fullmatch(r"tests/(test_torch_\w+|torch_port_helpers)\.py", p))}
    assert not outside, outside


# ---------------------------------------------------------------------------
# The CLI, end to end
# ---------------------------------------------------------------------------


def test_cli_exit_codes_and_json_round_trip(tmp_path):
    dirty = write_tree(tmp_path / "dirty", {to_port(rel): to_port(text) for rel, text in FIXTURES[-1][1].items()})
    clean = write_tree(tmp_path / "clean", {f"{PORT_PKG}/__init__.py": ""})
    human = run_port_cli("--root", dirty, "--select", "barrier-order")
    machine = run_port_cli("--root", dirty, "--select", "barrier-order", "--json")
    assert human.returncode == machine.returncode == 1, human.stdout + human.stderr
    payload = json.loads(machine.stdout)
    assert payload["version"] == 1 and payload["counts"] == {"active": 1, "suppressed": 0}
    findings = [Finding.from_json(obj) for obj in payload["findings"]]
    assert len(findings) == 1
    f = findings[0]
    assert f"{f.path}:{f.line}: [{f.check}]" in human.stdout
    assert f.path == f"{PORT_PKG}/runtime/tasks.py" and f.check == "barrier-order"
    assert f.to_json() == payload["findings"][0]
    assert run_port_cli("--root", clean, "--select", "barrier-order").returncode == 0
    crashed = run_port_cli("--root", clean, "--select", "no-such-check")
    assert crashed.returncode == 3 and "internal error" in crashed.stderr


def test_cli_explain_and_list_checks():
    res = run_port_cli("--list-checks")
    assert res.returncode == 0
    names = res.stdout.split()
    assert names == ["gate-integrity", "knob-registry", "vocabulary-drift", "determinism-hygiene",
                     "lock-discipline", "barrier-order"]
    for name in names + ["bad-suppression"]:
        ex = run_port_cli("--explain", name)
        assert ex.returncode == 0 and name in ex.stdout, name
    assert run_port_cli("--explain", "no-such-check").returncode == 2


# ---------------------------------------------------------------------------
# The runtime twin of gate-integrity, on both packages
# ---------------------------------------------------------------------------

PROBES = {
    PORT_PKG: ("from ray_shuffling_data_loader_tpu_torch import dataset, device_dataset, runtime, shuffle, telemetry\n"
               "from ray_shuffling_data_loader_tpu_torch.runtime import actor\n"
               "assert telemetry.outbound() is None\n"),
    JAX_PKG: ("from ray_shuffling_data_loader_tpu import dataset, runtime, shuffle\n"
              "from ray_shuffling_data_loader_tpu.runtime import actor\n"
              "assert actor._trace_ctx() is None\n"),
}


def gate_probe_script(imports):
    """With every ``RSDL_*`` unset: the core imports, one submit, result
    and shutdown cycle, and then no light gated plane in ``sys.modules``."""
    body = textwrap.indent(imports, "    ")
    return (
        "import os, sys\n"
        "for k in list(os.environ):\n"
        "    if k.startswith('RSDL_'):\n"
        "        del os.environ[k]\n"
        "os.environ['JAX_PLATFORMS'] = 'cpu'\n"
        "def main():\n"
        f"{body}"
        "    runtime.init(num_workers=1)\n"
        "    assert runtime.submit(len, [1, 2, 3]).result(timeout=120) == 3\n"
        "    runtime.shutdown()\n"
        "    bad = [m for m in sys.modules if m.endswith((\n"
        "        '.telemetry.trace', '.telemetry.audit',\n"
        "        '.telemetry.export', '.runtime.faults'))]\n"
        "    assert not bad, bad\n"
        "    print('IMPORT-FREE-OK')\n"
        "if __name__ == '__main__':\n"
        "    main()\n"
    )


@pytest.mark.parametrize("package", [PORT_PKG, JAX_PKG])
def test_disabled_run_stays_import_free_on_core_paths(tmp_path, package):
    path = tmp_path / "probe.py"
    path.write_text(gate_probe_script(PROBES[package]))
    env = {k: v for k, v in os.environ.items() if not k.startswith("RSDL_")}
    env["PYTHONPATH"] = REPO
    res = subprocess.run([sys.executable, str(path)], capture_output=True, text=True, cwd=REPO, env=env,
                         timeout=240)
    assert res.returncode == 0, res.stdout + res.stderr
    assert "IMPORT-FREE-OK" in res.stdout


def test_audit_gate_follows_the_audit_module(monkeypatch):
    """The core path's gate and :func:`.telemetry.audit.enabled` are one
    cached flag: enable, disable and a refresh move both."""
    from ray_shuffling_data_loader_tpu_torch import shuffle
    from ray_shuffling_data_loader_tpu_torch.telemetry import _env, audit

    monkeypatch.setattr(_env, "audit_flag", None)
    monkeypatch.setenv("RSDL_AUDIT", "1")
    assert shuffle._audit.enabled() and audit.enabled()
    monkeypatch.setattr(_env, "audit_flag", None)
    monkeypatch.delenv("RSDL_AUDIT")
    assert not shuffle._audit.enabled() and not audit.enabled()
    monkeypatch.setenv("RSDL_AUDIT", "1")
    assert not shuffle._audit.enabled()  # read once, until a refresh
    audit.refresh_from_env()
    assert shuffle._audit.enabled()
    audit.disable()
    assert not shuffle._audit.enabled() and "RSDL_AUDIT" not in os.environ
    assert shuffle._audit.key_column_name is audit.key_column_name


# ---------------------------------------------------------------------------
# The lint loads no torch; the planner loads no checker
# ---------------------------------------------------------------------------


def test_lint_loads_no_torch_and_the_planner_no_checker():
    lint = textwrap.dedent(
        f"""
        import sys
        sys.path.insert(0, {REPO!r})
        from ray_shuffling_data_loader_tpu_torch import rsdl_lint
        from ray_shuffling_data_loader_tpu_torch.analysis import Project, run_checks
        assert rsdl_lint.main(["--list-checks"]) == 0
        heavy = {{"torch", "numpy", "jax", "ray_shuffling_data_loader_tpu"}}
        print("LOADED", sorted({{m.split(".")[0] for m in sys.modules}} & heavy))
        """
    )
    planner = textwrap.dedent(
        f"""
        import sys
        sys.path.insert(0, {REPO!r})
        from ray_shuffling_data_loader_tpu_torch.analysis import planner
        print("LOADED", [m for m in sys.modules if ".analysis.checkers" in m or m.endswith((".analysis.core",
                                                                                            ".analysis.project"))])
        """
    )
    env = {k: v for k, v in os.environ.items() if not k.startswith(("JAX", "XLA", "RSDL_"))}
    for script in (lint, planner):
        out = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True, timeout=120, env=env)
        assert out.returncode == 0, out.stderr
        assert "LOADED []" in out.stdout, out.stdout


def test_decode_counts_come_from_the_calling_thread_only(tmp_path):
    """The lock-discipline suppressions on ``shuffle._DECODE_COUNTS`` rest
    on this: the ``rsdl-decode-rg`` threads decode but count nothing, so a
    threaded read counts what a single-threaded one does."""
    import numpy as np
    import pyarrow as pa
    import pyarrow.parquet as pq

    from ray_shuffling_data_loader_tpu_torch import shuffle

    path = str(tmp_path / "f.parquet")
    cols = {f"c{i}": np.arange(4000, dtype=np.int64) * i for i in range(6)}
    pq.write_table(pa.table(cols), path, row_group_size=500)
    counts = []
    for threads in (1, 4):
        before = dict(shuffle._DECODE_COUNTS)
        shuffle.read_parquet_columns(path, columns=["c1", "c2", "c5"], row_groups=[1, 3, 6],
                                     rowgroup_threads=threads)
        counts.append({k: shuffle._DECODE_COUNTS[k] - before[k] for k in before})
    assert counts[0] == counts[1] == {"rowgroups": 3, "bytes": 3 * 500 * 24,
                                      "bytes_pruned": 4000 * 24 + 5 * 500 * 24}
