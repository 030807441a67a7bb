"""The port's engine examples (`examples_torch/quickstart.py`,
`sql_ml_pipeline.py`, `multi_tenant.py`) against the reference's
`examples/`, each run in a subprocess on the CPU (the port's with
`--device cpu`, the reference's with the repo-root conftest's
`enable_x64` alias).  Their answer lines must be equal: rows and pruned
partitions, groups, the join result and `COUNT` after the kill; the two
accuracies and the k-means objective; the dashboard's errors.  Timings,
plans and server counters are not compared (the server's memory rungs
differ by design, ROADMAP C.6 and C.7).
"""

import os
import re
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_ALIAS = ("import sys, runpy, jax, jax.experimental\n"
          "if not hasattr(jax.experimental, 'enable_x64'):\n"
          "    jax.experimental.enable_x64 = jax.enable_x64\n"
          "sys.argv = [sys.argv[1]] + sys.argv[2:]\n"
          "runpy.run_path(sys.argv[0], run_name='__main__')\n")

# example -> the patterns of its answer lines (each must match once)
ANSWERS = {
    "quickstart": [r"day=7 rows: (\d+) +\(pruned (\d+)/16",
                   r"^(\d+) groups;", r"^join result: (.*)$",
                   r"COUNT = (\d+) "],
    "sql_ml_pipeline": [r"^SharkFrame columns: (.*)$",
                        r"after 5 iters: accuracy = ([0-9.]+)",
                        r"after failure \+ 10 more iters: accuracy = "
                        r"([0-9.]+)",
                        r"^k-means objective: (.*)$"],
    "multi_tenant": [r"^dashboard: (\d+) errors;",
                     r"^etl flood done: (\d+) heavy queries"],
}


def run_example(package: str, name: str, *args: str) -> str:
    """stdout of examples/<name>.py (package "repro", under the
    enable_x64 alias) or examples_torch/<name>.py (package "repro_torch")
    run from the repo root in a subprocess."""
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               JAX_PLATFORMS="cpu")
    if package == "repro":
        cmd = [sys.executable, "-c", _ALIAS,
               os.path.join(REPO, "examples", name + ".py"), *args]
    else:
        cmd = [sys.executable, os.path.join(REPO, "examples_torch",
                                            name + ".py"), *args]
    out = subprocess.run(cmd, capture_output=True, text=True, env=env,
                         cwd=REPO, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    return out.stdout


def answers(name: str, out: str) -> list:
    got = []
    for pat in ANSWERS[name]:
        found = re.findall(pat, out, flags=re.M)
        assert len(found) == 1, (pat, out)
        got.append(found[0])
    return got


@pytest.mark.parametrize("name", sorted(ANSWERS))
def test_engine_example_answers_equal_reference(name):
    port = run_example("repro_torch", name, "--device", "cpu")
    ref = run_example("repro", name)
    assert answers(name, port) == answers(name, ref)
