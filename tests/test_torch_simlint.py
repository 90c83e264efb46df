"""simlint in the port (``repro_torch.analysis.simlint``): one minimal
positive + one negative snippet per rule, the pragma/baseline workflow,
path scoping, and CLI exit codes — every case of ``tests/test_simlint.py``
with in-scope paths under ``src/repro_torch``.

The baseline-exactness test at the bottom is the port's gate: it fails on
any NEW finding in the port's sim path *and* on any stale baseline entry,
so the committed baseline (only the scenarios' bench timers) can only ever
shrink.
"""
import subprocess
import sys
import textwrap

import pytest

from repro_torch.analysis import simlint
from repro_torch.analysis.__main__ import main as cli_main

SIM_PATH = "src/repro_torch/net/snippet.py"  # virtual in-scope path for fixtures


def hits(source: str, path: str = SIM_PATH) -> list[str]:
    return [f.rule for f in simlint.lint_source(textwrap.dedent(source), path)]


# -- SIM001 wall clock -----------------------------------------------------------
def test_sim001_positive():
    src = """
    import time
    def service_ms():
        return time.time() * 1e3
    """
    assert hits(src) == ["SIM001"]


def test_sim001_positive_datetime_and_alias():
    src = """
    import datetime
    from time import perf_counter as clock
    def stamp():
        return datetime.datetime.now(), clock()
    """
    assert hits(src) == ["SIM001", "SIM001"]


def test_sim001_negative_loop_now():
    src = """
    def stamp(loop):
        return loop.now + 5.0
    """
    assert hits(src) == []


# -- SIM002 unseeded / global RNG ------------------------------------------------
def test_sim002_positive():
    src = """
    import random
    import numpy as np
    def pick(xs):
        np.random.shuffle(xs)
        rng = np.random.default_rng()
        return random.choice(xs)
    """
    assert hits(src) == ["SIM002", "SIM002", "SIM002"]


def test_sim002_negative_seeded_generator():
    src = """
    import numpy as np
    def pick(xs, seed):
        rng = np.random.default_rng(seed)
        return xs[rng.integers(0, len(xs))]
    """
    assert hits(src) == []


# -- SIM003 unordered iteration --------------------------------------------------
def test_sim003_positive():
    src = """
    def schedule(sps):
        out = []
        for sp in set(sps):
            out.append(sp)
        return list({1, 2, 3})
    """
    assert hits(src) == ["SIM003", "SIM003"]


def test_sim003_negative_sorted():
    src = """
    def schedule(sps):
        return [sp for sp in sorted(set(sps))]
    """
    assert hits(src) == []


# -- SIM004 identity tie-breaks --------------------------------------------------
def test_sim004_positive():
    src = """
    def key_for(task):
        return (task.t, id(task))
    """
    assert hits(src) == ["SIM004"]


def test_sim004_negative_seq_key():
    src = """
    def key_for(task, seq):
        return (task.t, seq)
    """
    assert hits(src) == []


# -- SIM005 acquire without guarded release --------------------------------------
def test_sim005_positive_no_finally():
    src = """
    def task(sp_id, slots, ms):
        yield Acquire(("sp", sp_id), slots)
        yield Sleep(ms)
        yield Release(("sp", sp_id))
    """
    assert hits(src) == ["SIM005"]


def test_sim005_positive_no_release_at_all():
    src = """
    def task(sp_id, slots, ms):
        yield Acquire(("sp", sp_id), slots)
        yield Sleep(ms)
    """
    assert hits(src) == ["SIM005"]


def test_sim005_negative_safe_release_in_finally():
    src = """
    def task(sp_id, slots, ms):
        yield Acquire(("sp", sp_id), slots)
        try:
            yield Sleep(ms)
        finally:
            yield from safe_release(Release(("sp", sp_id)))
    """
    assert hits(src) == []


# -- SIM006 swallowed GeneratorExit ----------------------------------------------
def test_sim006_positive_bare_except():
    src = """
    def harvest():
        try:
            work()
        except:
            pass
    """
    assert hits(src) == ["SIM006"]


def test_sim006_positive_broad_except_in_task():
    src = """
    def harvest(handles):
        for h in handles:
            try:
                out = yield Join(h)
            except Exception:
                continue
    """
    assert hits(src) == ["SIM006"]


def test_sim006_negative_control_flow_reraised():
    src = """
    def harvest(handles):
        for h in handles:
            try:
                out = yield Join(h)
            except (GeneratorExit, KeyboardInterrupt):
                raise
            except Exception:
                continue
    """
    assert hits(src) == []


# -- SIM007 dict-order float reductions ------------------------------------------
def test_sim007_positive():
    src = """
    def total(payments):
        return sum(payments.values())
    """
    assert hits(src) == ["SIM007"]


def test_sim007_negative_sorted_and_len():
    src = """
    def total(payments, queues):
        a = sum(payments[k] for k in sorted(payments))
        b = sum(len(q) for q in queues.values())
        return a + b
    """
    assert hits(src) == []


# -- SIM008 off-loop accounting mutation -----------------------------------------
def test_sim008_positive_outside_owner():
    src = """
    def hack(res):
        res.in_use -= 1
    """
    assert hits(src, path="src/repro_torch/storage/snippet.py") == ["SIM008"]


def test_sim008_negative_in_owner_module():
    src = """
    def engine_release(res):
        res.in_use -= 1
    """
    assert hits(src, path="src/repro_torch/net/events.py") == []


# -- pragma workflow -------------------------------------------------------------
def test_pragma_with_reason_suppresses():
    src = """
    import time
    def bench():
        return time.perf_counter()  # simlint: ok SIM001 wall telemetry only
    """
    assert hits(src) == []


def test_pragma_on_previous_line_suppresses():
    src = """
    import time
    def bench():
        # simlint: ok SIM001 wall telemetry only
        return time.perf_counter()
    """
    assert hits(src) == []


def test_pragma_without_reason_still_reports():
    src = """
    import time
    def bench():
        return time.perf_counter()  # simlint: ok SIM001
    """
    found = simlint.lint_source(textwrap.dedent(src), SIM_PATH)
    assert [f.rule for f in found] == ["SIM001"]
    assert "missing a" in found[0].message


def test_pragma_wrong_rule_does_not_suppress():
    src = """
    import time
    def bench():
        return time.perf_counter()  # simlint: ok SIM007 not the right rule
    """
    assert hits(src) == ["SIM001"]


# -- path scoping: sim path vs host path -----------------------------------------
def test_scope_excludes_host_path_modules():
    root = simlint.REPO_ROOT
    assert simlint.in_scope(root / "src/repro_torch/net/events.py")
    assert simlint.in_scope(root / "src/repro_torch/scenarios/serving.py")
    # launch/kernels/serve legitimately read wall clock: out of scope by PATH,
    # not by pragma (see docs/simlint.md)
    assert not simlint.in_scope(root / "src/repro_torch/launch/serve.py")
    assert not simlint.in_scope(root / "src/repro_torch/kernels/gf_matmul.py")
    assert not simlint.in_scope(root / "src/repro_torch/serve/engine.py")
    assert not simlint.in_scope(root / "tests/test_events.py")
    # the JAX package is the reference's own lint's business, not the port's
    assert not simlint.in_scope(root / "src/repro/net/events.py")


def test_target_files_stay_inside_sim_scope():
    for f in simlint.iter_target_files():
        rel = f.relative_to(simlint.REPO_ROOT / "src" / "repro_torch")
        assert rel.parts[0] in simlint.SIM_SCOPE_PACKAGES


# -- baseline workflow -----------------------------------------------------------
def test_committed_baseline_is_exact():
    """No new findings anywhere in the sim path AND no stale entries: the
    committed baseline matches the tree exactly."""
    findings = simlint.lint_paths()
    new, stale = simlint.diff_baseline(findings, simlint.load_baseline())
    assert not new, "unbaselined findings:\n" + "\n".join(
        f.render() for f in new)
    assert not stale, "stale baseline entries:\n" + "\n".join(stale)


def test_baseline_holds_only_the_scenarios_bench_timers():
    """The port's baseline is the JAX package's, re-keyed to the port's
    paths: only the scenario harness's wall timers and its integer
    link-byte delta.  Nothing of net/, storage/ or core/ is grandfathered."""
    from repro.analysis import simlint as ref

    port = simlint.load_baseline()
    assert all(key.startswith("src/repro_torch/scenarios/") for key in port)
    rekeyed = {key.replace("src/repro/", "src/repro_torch/", 1): n
               for key, n in ref.load_baseline().items()}
    assert port == rekeyed


def test_port_sim_path_has_no_finding_outside_the_scenarios():
    findings = simlint.lint_paths()
    assert findings and all(
        f.path.startswith("src/repro_torch/scenarios/") for f in findings)
    scanned = {f.relative_to(simlint.REPO_ROOT).parts[2]
               for f in simlint.iter_target_files()}
    assert scanned == set(simlint.SIM_SCOPE_PACKAGES)


def test_baseline_roundtrip(tmp_path):
    src = textwrap.dedent("""
    import time
    def bench():
        return time.time()
    """)
    findings = simlint.lint_source(src, SIM_PATH)
    bl = tmp_path / "bl"
    simlint.write_baseline(findings, bl)
    new, stale = simlint.diff_baseline(findings, simlint.load_baseline(bl))
    assert not new and not stale
    # a fixed finding leaves its entry stale; a fresh one is reported new
    new, stale = simlint.diff_baseline([], simlint.load_baseline(bl))
    assert not new and len(stale) == 1


# -- CLI exit codes: 0 clean / 1 findings / 2 internal error ---------------------
def test_cli_clean_tree_exits_zero(capsys):
    assert cli_main(["--check"]) == 0
    assert "clean" in capsys.readouterr().out


def test_cli_findings_exit_one(capsys):
    # ignoring the baseline resurfaces the grandfathered hits
    assert cli_main(["--no-baseline"]) == 1


def test_cli_bad_usage_exits_two():
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis", "--definitely-not-a-flag"],
        capture_output=True,
        cwd=str(simlint.REPO_ROOT),
        env={"PYTHONPATH": str(simlint.REPO_ROOT / "src"), "PATH": "/usr/bin:/bin"},
    )
    assert proc.returncode == 2


def test_unparseable_source_is_internal_error():
    # parse failures surface as exceptions (-> CLI exit 2), never findings
    with pytest.raises(SyntaxError):
        simlint.lint_source("def broken(:\n", SIM_PATH)


def test_cli_internal_error_exits_two():
    # crash the linter inside the CLI wrapper: must map to exit 2, so CI
    # can tell "the gate is broken" from "the gate found problems"
    prog = (
        "import repro_torch.analysis.simlint as s\n"
        "def boom(*a, **k): raise RuntimeError('boom')\n"
        "s.lint_paths = boom\n"
        "import runpy, sys\n"
        "sys.argv = ['prog', '--check']\n"
        "runpy.run_module('repro_torch.analysis', run_name='__main__')\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", prog],
        capture_output=True,
        cwd=str(simlint.REPO_ROOT),
        env={"PYTHONPATH": str(simlint.REPO_ROOT / "src"), "PATH": "/usr/bin:/bin"},
    )
    assert proc.returncode == 2
    assert b"boom" in proc.stderr
