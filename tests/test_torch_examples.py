"""The port's six examples and its two scenario scripts, held against the JAX package's.

Each example of ``examples/`` runs in a subprocess beside its port in
``examples/torch/`` (``--device cpu``).  The port's runs with
``sys.modules["jax"]`` and ``sys.modules["repro"]`` set to None, so that each
example also proves that it stands alone.  Their printed lines are compared
where they are deterministic: every line, but for ``video_streaming``
(run at ``VIDEO_SMOKE=1``) the wall-clock figure in brackets.  ``serve_llm``'s
weights come from other generators (``jax.random.PRNGKey(42)`` against a
``torch.Generator`` seeded 42); it prints no token, so its lines (the
published bytes, the crashed SP, the completion shapes, the payments and
the cache hits) are equal too, and the prompt prefix is its own assert.

Also: ``scripts/gen_scenario_catalog_torch.py --check`` passes against the
committed ``docs/CATALOG.md``, byte for byte (the two registries, their
SLOs, budgets and knob docs equal), and ``scripts/perf_hillclimb_torch.py``
gives the JAX script's result JSON (points, objective values, replay
digests, ``improved``) for ``tune_admission --sweep --axis
rpc_max_inflight_fetches=4,8``.  Every child runs on one thread; the
subprocesses run four at a time.
"""
import json
import os
import pathlib
import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
EXAMPLES = ("quickstart", "repair_storm", "audit_epoch", "multi_rpc_cdn", "video_streaming",
            "serve_llm")
WALL = re.compile(r" \[decode wall [0-9.]+s on [^\]]+\]")  # video_streaming's wall clock
HILLCLIMB = ("tune_admission", "--sweep", "--axis", "rpc_max_inflight_fetches=4,8")
# the port's example under runpy, with the JAX package and jax unimportable
_BLOCKED = ("import runpy, sys; sys.modules['jax'] = None; sys.modules['repro'] = None; "
            "import torch; torch.set_num_threads(1); sys.argv = sys.argv[1:]; "
            "runpy.run_path(sys.argv[0], run_name='__main__')")


def _env(**extra) -> dict:
    return dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
                OMP_NUM_THREADS="1", MKL_NUM_THREADS="1",
                XLA_FLAGS="--xla_cpu_multi_thread_eigen=false", VIDEO_SMOKE="1", **extra)


def _run(args: list) -> subprocess.CompletedProcess:
    return subprocess.run([sys.executable, *args], capture_output=True, text=True, env=_env(),
                          cwd=ROOT, timeout=300)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every subprocess's result, by name: ``("jax", example)``, ``("torch",
    example)``, ``"catalog"``, ``("hillclimb", "jax" | "torch")`` (with the
    JSON each wrote)."""
    tmp = tmp_path_factory.mktemp("examples")
    jobs = {}
    for name in EXAMPLES:
        jobs["jax", name] = [str(ROOT / "examples" / f"{name}.py")]
        jobs["torch", name] = ["-c", _BLOCKED, str(ROOT / "examples" / "torch" / f"{name}.py"),
                               "--device", "cpu"]
    jobs["catalog"] = [str(ROOT / "scripts" / "gen_scenario_catalog_torch.py"), "--check"]
    for pkg, script, extra in (("jax", "perf_hillclimb.py", []),
                               ("torch", "perf_hillclimb_torch.py", ["--device", "cpu"])):
        jobs["hillclimb", pkg] = [str(ROOT / "scripts" / script), *HILLCLIMB, *extra,
                                  "--out", str(tmp / f"{pkg}.json")]
    with ThreadPoolExecutor(4) as pool:
        done = dict(zip(jobs, pool.map(_run, jobs.values())))
    done["hillclimb_json"] = {pkg: json.loads((tmp / f"{pkg}.json").read_text())
                              for pkg in ("jax", "torch") if (tmp / f"{pkg}.json").exists()}
    return done


def _lines(proc: subprocess.CompletedProcess) -> list[str]:
    assert proc.returncode == 0, proc.stderr[-3000:]
    return [WALL.sub("", line) for line in proc.stdout.splitlines()]


@pytest.mark.parametrize("name", EXAMPLES)
def test_example_prints_what_the_jax_example_prints(runs, name):
    want, got = _lines(runs["jax", name]), _lines(runs["torch", name])
    assert want and got == want


def test_video_streaming_masks_only_its_wall_clock(runs):
    """The one line that differs carries the wall clock and the device."""
    line = next(x for x in runs["torch", "video_streaming"].stdout.splitlines()
                if x.startswith("streamed "))
    assert WALL.search(line) and WALL.search(line).group().endswith("on cpu]")


def test_catalog_check_passes_against_the_committed_catalog(runs):
    proc = runs["catalog"]
    assert proc.returncode == 0, proc.stdout + proc.stderr[-2000:]
    assert proc.stdout.startswith("fresh: ") and proc.stdout.rstrip().endswith("CATALOG.md")


def test_hillclimb_result_equals_the_jax_script(runs):
    for pkg in ("jax", "torch"):
        proc = runs["hillclimb", pkg]
        assert proc.returncode == 0, proc.stderr[-3000:]
    got = runs["hillclimb_json"]
    assert got["torch"] == got["jax"]
    assert got["torch"]["evaluations"] == 3 and got["torch"]["improved"] is True
    assert [p["digest"] for p in got["torch"]["history"]][0] == got["torch"]["baseline"]["digest"]
