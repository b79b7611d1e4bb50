"""The port's graftlint (`factorvae_tpu_torch.analysis`) against its seeded
fixtures and against the JAX analyzer.

The fixtures of `tests/graftlint_fixtures/` are read in place, never
edited. The module-local rules (JGL006-008, 012, 013) judge library code
only, which for the port is a path containing `factorvae_tpu_torch/`, so
each fixture is analyzed under a synthetic `factorvae_tpu_torch/...`
path; a `factorvae_tpu/...` path is not the port's library. The parity
cases put each seeded fixture under a `factorvae_tpu/` path for the JAX
analyzer and under a `factorvae_tpu_torch/` path for the port's: the
(rule, line, message) lists are equal and not empty. Then the
whole-program engine (JGL009-011), the suppressions, the CLI, and the
self-lint gates over `factorvae_tpu_torch/` and `scripts/torch_*.py` in
per-path and `--project` mode.
"""

from __future__ import annotations

import glob
import json
import os
import shutil
import subprocess
import sys

import pytest

from factorvae_tpu.analysis import analyze_paths as janalyze_paths
from factorvae_tpu.analysis import analyze_project as janalyze_project
from factorvae_tpu.analysis import analyze_source as janalyze_source
from factorvae_tpu_torch.analysis import (
    analyze_paths,
    analyze_project,
    analyze_source,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(REPO, "tests", "graftlint_fixtures")
LIB = "factorvae_tpu_torch/train/newmod.py"
PORT_RULES = {"JGL000", "JGL006", "JGL007", "JGL008", "JGL009", "JGL010", "JGL011",
              "JGL012", "JGL013"}


def _fixture(name):
    return os.path.join(FIXTURES, name)


def _read(name):
    with open(_fixture(name)) as fh:
        return fh.read()


def _active(findings):
    return [f for f in findings if not f.suppressed]


def _rules(findings):
    return sorted({f.rule for f in findings})


def _self_lint_paths():
    return ([os.path.join(REPO, "factorvae_tpu_torch")]
            + sorted(glob.glob(os.path.join(REPO, "scripts", "torch_*.py"))))


# ---------------------------------------------------------------------------
# the module-local rules


LOCAL_FIXTURES = [
    # (rule, bad file, expected findings, good file, library sub-path)
    ("JGL006", "jgl006_bad.py", 2, "jgl006_good.py", "train/newmod.py"),
    ("JGL007", "jgl007_bad.py", 4, "jgl007_good.py", "train/newmod.py"),
    ("JGL008", "jgl008_bad.py", 2, "jgl008_good.py", "train/newmod.py"),
    ("JGL012", "jgl012_bad.py", 4, "jgl012_good.py", "serve/newmod.py"),
    ("JGL013", "jgl013_bad.py", 2, "jgl013_good.py", "serve/newmod.py"),
]


class TestLocalRules:
    @pytest.mark.parametrize("rule,bad,count,good,sub", LOCAL_FIXTURES)
    def test_fires_on_seeded_violation_under_the_port(self, rule, bad, count, good, sub):
        findings = _active(analyze_source(_read(bad), f"factorvae_tpu_torch/{sub}"))
        assert len([f for f in findings if f.rule == rule]) == count, \
            [(f.line, f.message) for f in findings]
        assert _rules(findings) == [rule]          # no cross-rule noise

    @pytest.mark.parametrize("rule,bad,count,good,sub", LOCAL_FIXTURES)
    def test_silent_on_corrected_twin(self, rule, bad, count, good, sub):
        assert _active(analyze_source(_read(good), f"factorvae_tpu_torch/{sub}")) == []

    @pytest.mark.parametrize("rule,bad,count,good,sub", LOCAL_FIXTURES)
    def test_outside_the_port_is_exempt(self, rule, bad, count, good, sub):
        """scripts/, the tests and the JAX package's own path are not the
        port's library code (`factorvae_tpu_torch/` is not a substring of
        `factorvae_tpu/`, nor the reverse)."""
        for path in ("scripts/some_script.py", f"factorvae_tpu/{sub}"):
            assert _active(analyze_source(_read(bad), path)) == [], path
        assert _active(analyze_paths([_fixture(bad)])) == []

    def test_cli_dunder_main_and_logger_sink_exempt_from_jgl006(self):
        src = "print('usage')\n"
        for path in ("factorvae_tpu_torch/cli.py", "factorvae_tpu_torch/obs/__main__.py"):
            assert _active(analyze_source(src, path)) == []
        assert [f.rule for f in _active(analyze_source(
            src, "factorvae_tpu_torch/obs/newmod.py"))] == ["JGL006"]
        assert _active(analyze_source("def log(self):\n    print('[epoch] loss=1')\n",
                                      "factorvae_tpu_torch/utils/logging.py")) == []

    def test_jgl007_nested_defs_do_not_surface(self):
        for body in ("        def _noop():\n"
                     "            return None\n"
                     "        cb.append(_noop)\n",
                     "        cb.append(lambda: str(e))\n"):
            src = ("def f(fn, cb):\n    try:\n        fn()\n"
                   "    except Exception as e:\n" + body)
            assert [f.rule for f in _active(analyze_source(src, LIB))] == ["JGL007"]

    def test_jgl007_bound_exception_and_timeline_event_surface(self):
        value = ("def resolve(req):\n    out = {}\n    try:\n        out['v'] = req()\n"
                 "    except Exception as e:\n        out['error'] = str(e)\n    return out\n")
        event = ("def produce(i, fn):\n    try:\n        fn(i)\n"
                 "    except Exception:\n        timeline_event('retry', chunk=i)\n")
        for src in (value, event):
            assert _active(analyze_source(src, LIB)) == []

    def test_jgl008_timestamps_exempt_tracked_names_fire(self):
        stamps = ("import time\ndef log(logger, event, **fields):\n"
                  "    rec = {'ts': time.time(), 'event': event, **fields}\n"
                  "    logger.write(rec)\n    return round(time.time(), 3)\n")
        assert _active(analyze_source(stamps, LIB)) == []
        tracked = ("import time\ndef f(fn):\n    t0 = time.time()\n    fn()\n"
                   "    return time.perf_counter() - t0\n")
        assert [f.rule for f in _active(analyze_source(tracked, LIB))] == ["JGL008"]

    def test_jgl012_timed_wait_and_kwargs_splat_exempt(self):
        src = ("import threading\nimport urllib.request\ndef f(url, kw):\n"
               "    ev = threading.Event()\n    ev.wait(0.5)\n"
               "    return urllib.request.urlopen(url, **kw)\n")
        assert _active(analyze_source(src, "factorvae_tpu_torch/serve/newmod.py")) == []

    def test_jgl013_two_diagnoses_and_the_handoff(self):
        hits = _active(analyze_source(_read("jgl013_bad.py"),
                                      "factorvae_tpu_torch/serve/newmod.py"))
        assert sorted("hand-rolls" in f.message for f in hits) == [False, True]
        src = ("from factorvae_tpu_torch.utils.logging import "
               "timeline_span_begin, timeline_span_end\n"
               "def submit(q, req):\n"
               "    q.append((req, timeline_span_begin('serve_queue')))\n"
               "def drain(q):\n    for req, tok in q:\n        timeline_span_end(tok)\n")
        assert _active(analyze_source(src, "factorvae_tpu_torch/serve/newmod.py")) == []


# ---------------------------------------------------------------------------
# parity with the JAX analyzer


def _triples(findings):
    return [(f.rule, f.line, f.message) for f in findings
            if not f.suppressed and f.rule in PORT_RULES]


class TestParityWithJax:
    @pytest.mark.parametrize("rule,bad,count,good,sub", LOCAL_FIXTURES)
    def test_local_rule_findings_equal(self, rule, bad, count, good, sub):
        for name in (bad, good):
            want = _triples(janalyze_source(_read(name), f"factorvae_tpu/{sub}"))
            got = _triples(analyze_source(_read(name), f"factorvae_tpu_torch/{sub}"))
            assert got == want
        assert len(_triples(analyze_source(_read(bad), f"factorvae_tpu_torch/{sub}"))) == count

    @pytest.mark.parametrize("rule,bad,count", [("JGL009", "jgl009_bad.py", 4),
                                                ("JGL010", "jgl010_bad.py", 2),
                                                ("JGL011", "jgl011_bad.py", 1)])
    def test_project_rule_findings_equal(self, tmp_path, rule, bad, count):
        """Each concurrency fixture as `factorvae_tpu/<file>` for the JAX
        analyzer and `factorvae_tpu_torch/<file>` for the port's (where the
        library rules judge it too)."""
        out = {}
        for pkg, analyze in (("factorvae_tpu", janalyze_project),
                             ("factorvae_tpu_torch", analyze_project)):
            os.makedirs(tmp_path / pkg)
            path = tmp_path / pkg / bad
            shutil.copy(_fixture(bad), path)
            out[pkg] = [(f.rule, f.line, f.message, f.entry_point)
                        for f in analyze([str(path)]) if not f.suppressed]
        assert out["factorvae_tpu_torch"] == out["factorvae_tpu"]
        assert len([f for f in out["factorvae_tpu"] if f[0] == rule]) == count

    def test_suppressions_and_meta_findings_equal(self):
        for name in ("suppression_unjustified.py", "suppression_ok.py"):
            want = [(f.rule, f.line, f.suppressed) for f in janalyze_paths([_fixture(name)])
                    if f.rule in PORT_RULES]
            got = [(f.rule, f.line, f.suppressed) for f in analyze_paths([_fixture(name)])]
            assert got == want


# ---------------------------------------------------------------------------
# suppressions and the meta rule


class TestSuppressions:
    def test_justified_suppression_silences_inline_and_above(self):
        src = ("def f():\n"
               "    print('x')  # graftlint: disable=JGL006 fixture: demo suppression\n"
               "    # graftlint: disable=JGL006 fixture: the standalone form\n"
               "    print('y')\n")
        findings = analyze_source(src, LIB)
        assert _active(findings) == []
        sup = [f for f in findings if f.suppressed]
        assert [f.rule for f in sup] == ["JGL006", "JGL006"] and all(
            f.justification for f in sup)

    def test_unjustified_suppression_is_a_finding_and_does_not_silence(self):
        src = "def f():\n    print('x')  # graftlint: disable=JGL006\n"
        assert _rules(_active(analyze_source(src, LIB))) == ["JGL000", "JGL006"]
        assert "JGL000" in _rules(_active(analyze_paths([
            _fixture("suppression_unjustified.py")])))

    def test_unparseable_file_and_missing_paths_are_jgl000(self, tmp_path):
        assert [f.rule for f in analyze_source("def broken(:\n", "x.py")] == ["JGL000"]
        assert [f.rule for f in analyze_paths([str(tmp_path / "no_such_dir")])] == ["JGL000"]
        assert [f.rule for f in analyze_paths([os.path.join(REPO, "README.md")])] == ["JGL000"]
        (tmp_path / "empty").mkdir()
        assert [f.rule for f in analyze_paths([str(tmp_path / "empty")])] == ["JGL000"]

    def test_suppression_on_wrapped_statement_matches(self):
        src = ("def f(x):\n"
               "    print(\n"
               "        x)  # graftlint: disable=JGL006 a wrapped call's last line\n")
        findings = analyze_source(src, LIB)
        assert _active(findings) == []
        assert [f.rule for f in findings if f.suppressed] == ["JGL006"]

    def test_suppression_on_decorator_line_covers_def(self):
        src = ("import time\n"
               "@decorate(time.time() - 1)  # graftlint: disable=JGL008 a fixture's stamp\n"
               "def f():\n    pass\n")
        findings = analyze_source(src, LIB)
        assert _active(findings) == []
        assert [f.rule for f in findings if f.suppressed] == ["JGL008"]


# ---------------------------------------------------------------------------
# the whole-program engine and the concurrency rules


CONCURRENCY_FIXTURES = [
    ("JGL009", "jgl009_bad.py", 4, "jgl009_good.py"),
    ("JGL010", "jgl010_bad.py", 2, "jgl010_good.py"),
    ("JGL011", "jgl011_bad.py", 1, "jgl011_good.py"),
]


def _write(tmp_path, name, src):
    p = tmp_path / name
    p.write_text(src)
    return str(p)


class TestConcurrencyRules:
    @pytest.mark.parametrize("rule,bad,count,good", CONCURRENCY_FIXTURES)
    def test_fires_on_seeded_violation(self, rule, bad, count, good):
        findings = _active(analyze_project([_fixture(bad)]))
        hits = [f for f in findings if f.rule == rule]
        assert len(hits) == count and _rules(findings) == [rule]
        assert all(f.thread_reachable and f.entry_point for f in hits)

    @pytest.mark.parametrize("rule,bad,count,good", CONCURRENCY_FIXTURES)
    def test_silent_on_corrected_twin(self, rule, bad, count, good):
        assert _active(analyze_project([_fixture(good)])) == []

    @pytest.mark.parametrize("rule,bad,count,good", CONCURRENCY_FIXTURES)
    def test_per_path_mode_does_not_run_project_rules(self, rule, bad, count, good):
        assert _active(analyze_paths([_fixture(bad)])) == []

    def test_jgl009_infers_owning_lock_and_the_composite_read(self):
        findings = _active(analyze_project([_fixture("jgl009_bad.py")]))
        (bump,) = [f for f in findings if f.line == 36]
        assert "self._lock" in bump.message
        (peek,) = [f for f in findings if f.line == 39]
        assert "read here without its owning lock" in peek.message

    def test_jgl009_reader_not_double_reported_at_write_sites(self, tmp_path):
        src = ("import threading\nclass Box:\n    def __init__(self):\n"
               "        self._lock = threading.Lock()\n        self.d = {}\n"
               "    def _run(self):\n        with self._lock:\n            self.d[\"k\"] = 1\n"
               "    def poke(self):\n        self.d[\"k\"] = 2\n"
               "    def spawn(self):\n        threading.Thread(target=self._run).start()\n")
        findings = _active(analyze_project([_write(tmp_path, "box.py", src)]))
        assert [(f.rule, f.line) for f in findings] == [("JGL009", 10)]

    def test_module_name_collision_fails_loudly(self, tmp_path):
        src = ("import threading\nCOUNTS = {\"n\": 0}\ndef _tick():\n"
               "    COUNTS[\"n\"] += 1\ndef launch(ex):\n    return ex.submit(_tick)\n"
               "def scrape():\n    return dict(COUNTS)\n")
        (tmp_path / "a").mkdir()
        (tmp_path / "b").mkdir()
        paths = [_write(tmp_path / d, "mod.py", src) for d in ("a", "b")]
        findings = _active(analyze_project(paths))
        assert [f.rule for f in findings if f.rule == "JGL000"] == ["JGL000"]
        assert {os.path.dirname(f.path) for f in findings if f.rule == "JGL009"} == {
            str(tmp_path / "a"), str(tmp_path / "b")}

    def test_suppressible_with_justification(self, tmp_path):
        src = ("import threading\nCOUNTS = {\"n\": 0}\ndef _tick():\n"
               "    COUNTS[\"n\"] += 1  # graftlint: disable=JGL009 fixture: one writer\n"
               "def launch(ex):\n    return ex.submit(_tick)\n"
               "def scrape():\n    return dict(COUNTS)\n")
        findings = analyze_project([_write(tmp_path, "mod.py", src)])
        assert _active(findings) == []
        assert [f.rule for f in findings if f.suppressed] == ["JGL009"]

    def test_three_module_chain_reaches_thread_entry(self):
        findings = _active(analyze_project([_fixture("projpkg")]))
        assert [(f.rule, os.path.basename(f.path), f.line) for f in findings] == [
            ("JGL009", "c.py", 5)]
        assert findings[0].entry_point == "thread:projpkg.a.worker"
        for mod in ("a.py", "b.py", "c.py"):
            assert _active(analyze_project([os.path.join(_fixture("projpkg"), mod)])) == []

    def test_parent_root_anchors_names_at_the_package(self, tmp_path):
        pkg = tmp_path / "container" / "pkg"
        pkg.mkdir(parents=True)
        (pkg / "__init__.py").write_text("")
        (pkg / "a.py").write_text(
            "import threading\nfrom pkg.c import record\ndef worker():\n    record(1)\n"
            "def launch():\n    threading.Thread(target=worker).start()\n")
        (pkg / "c.py").write_text(
            "TALLY = {\"n\": 0}\ndef record(n):\n    TALLY[\"n\"] += n\n"
            "def snapshot():\n    return dict(TALLY)\n")
        for root in (str(pkg), str(tmp_path / "container")):
            findings = _active(analyze_project([root]))
            assert [(f.rule, os.path.basename(f.path), f.line) for f in findings] == [
                ("JGL009", "c.py", 3)], root
            assert findings[0].entry_point == "thread:pkg.a.worker"

    def test_file_reachable_twice_reports_once(self):
        once = _active(analyze_project([_fixture("jgl010_bad.py")]))
        twice = _active(analyze_project([FIXTURES, _fixture("jgl010_bad.py")]))
        mine = [f for f in twice if os.path.basename(f.path) == "jgl010_bad.py"]
        assert len(mine) == len(once) == 2

    def test_held_lock_propagates_through_call_graph(self, tmp_path):
        common = ("import threading\nclass Box:\n    def __init__(self):\n"
                  "        self._lock = threading.Lock()\n        self.n = 0\n"
                  "    def _bump(self):\n        self.n += 1\n    def tick(self):\n"
                  "        with self._lock:\n            self._bump()\n"
                  "    def run(self):\n        self.tick()\n    def snapshot(self):\n"
                  "        with self._lock:\n            return self.n\n"
                  "def spawn(box):\n    t = threading.Thread(target=box.run)\n"
                  "    t.start()\n    return t\n")
        assert _active(analyze_project([_write(tmp_path, "clean.py", common)])) == []
        findings = _active(analyze_project([_write(
            tmp_path, "dirty.py", common + "\ndef poke(box):\n    box._bump()\n")]))
        assert [(f.rule, f.line) for f in findings] == [("JGL009", 7)]
        assert "NO lock" in findings[0].message

    def test_http_handler_attrs_are_request_confined(self, tmp_path):
        src = ("from http.server import BaseHTTPRequestHandler\n"
               "class Handler(BaseHTTPRequestHandler):\n    def do_GET(self):\n"
               "        self._send()\n    def _send(self):\n        self.wfile.write(b'ok')\n")
        assert _active(analyze_project([_write(tmp_path, "h.py", src)])) == []

    @pytest.mark.parametrize("call_form", [
        "import subprocess\ndef probe():\n    return subprocess.run([\"true\"])\n",
        "from subprocess import run\ndef probe():\n    return run([\"true\"])\n",
    ], ids=["attribute", "bare_name"])
    def test_external_library_calls_do_not_name_match(self, tmp_path, call_form):
        src = ("import threading\n" + call_form +
               "class Flow:\n    def __init__(self):\n        self.state = {}\n"
               "    def run(self):\n        self.state[\"k\"] = 1\n"
               "def worker():\n    probe()\n"
               "def launch():\n    threading.Thread(target=worker).start()\n")
        assert _active(analyze_project([_write(tmp_path, "m.py", src)])) == []


# ---------------------------------------------------------------------------
# the gates over the port and the CLI


def _cli(*args):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    return subprocess.run([sys.executable, "-m", "factorvae_tpu_torch.analysis", *args],
                          cwd=REPO, env=env, capture_output=True, text=True, timeout=120)


class TestPortGates:
    @pytest.mark.parametrize("project", [False, True], ids=["per_path", "project"])
    def test_port_is_graftlint_clean(self, project):
        """Zero unsuppressed findings over the port and scripts/torch_*.py,
        every suppression justified, and the gate sees the port's modules
        (it is not a no-op: the library prefix matches them)."""
        paths = _self_lint_paths()
        findings = (analyze_project if project else analyze_paths)(paths)
        active = _active(findings)
        assert active == [], "\n".join(f"{f.path}:{f.line}: {f.rule} {f.message}"
                                       for f in active)
        assert all(f.justification for f in findings if f.suppressed)
        if project:
            assert sorted((os.path.basename(f.path), f.rule) for f in findings) == [
                ("autoscale.py", "JGL009"), ("checkpoint.py", "JGL011"),
                ("remote.py", "JGL011")]
        # the same source under a JAX path is not library code; under the
        # port's it is: a print added to a port module fires
        src = open(os.path.join(REPO, "factorvae_tpu_torch", "train", "loop.py")).read()
        assert [f.rule for f in _active(analyze_source(
            src + "\nprint('x')\n", "factorvae_tpu_torch/train/loop.py"))] == ["JGL006"]

    def test_cli_per_path_and_project_exit_zero(self):
        proc = _cli("factorvae_tpu_torch", *[os.path.relpath(p, REPO)
                                             for p in _self_lint_paths()[1:]])
        assert proc.returncode == 0, proc.stdout
        proc = _cli("--project")
        assert proc.returncode == 0, proc.stdout
        assert proc.stdout.strip().endswith("0 finding(s), 3 suppressed")
        assert _cli().returncode == 2          # paths are required without --project

    def test_cli_json_contract(self, tmp_path):
        proc = _cli("--project", _fixture("jgl009_bad.py"), "--format", "json")
        assert proc.returncode == 1
        payload = json.loads(proc.stdout)
        assert payload["counts"]["active"] == 4
        assert all(f["rule"] == "JGL009" and f["thread_reachable"] is True
                   and f["entry_point"].startswith(("thread:", "executor:"))
                   for f in payload["findings"])
        lib = tmp_path / "factorvae_tpu_torch"
        lib.mkdir()
        shutil.copy(_fixture("jgl006_bad.py"), lib / "newmod.py")
        proc = _cli(str(lib / "newmod.py"), "--format", "json")
        payload = json.loads(proc.stdout)
        assert proc.returncode == 1 and payload["counts"]["active"] == 2
        assert all(f["thread_reachable"] is False and f["entry_point"] == ""
                   for f in payload["findings"])
        shutil.copy(_fixture("jgl006_good.py"), lib / "newmod.py")
        assert _cli(str(lib / "newmod.py")).returncode == 0

    def test_show_suppressed_lists_the_justifications(self):
        proc = _cli("--project", "--show-suppressed")
        assert proc.returncode == 0
        assert proc.stdout.count("[suppressed: ") == 3

    def test_the_analyzer_imports_no_torch(self):
        probe = ("import sys\nfrom factorvae_tpu_torch.analysis import analyze_paths\n"
                 "analyze_paths(['factorvae_tpu_torch'])\n"
                 "print(sorted(m for m in sys.modules if m.split('.')[0] in "
                 "('torch', 'jax', 'factorvae_tpu')))\n")
        env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
        proc = subprocess.run([sys.executable, "-c", probe], cwd=REPO, env=env,
                              capture_output=True, text=True, timeout=120)
        assert proc.returncode == 0, proc.stderr
        assert proc.stdout.strip() == "[]"
