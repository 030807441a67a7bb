"""The torch port stands alone: importing it pulls in neither JAX nor any
module of the reference package, and a session computes on the GPU unless
the caller asks for the CPU."""

import subprocess
import sys
from pathlib import Path

import pytest

SRC = str(Path(__file__).resolve().parents[1] / "src")


def _run(code: str) -> str:
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, env={"PYTHONPATH": SRC,
                                                      "JAX_PLATFORMS": "cpu"})
    assert out.returncode == 0, out.stderr
    return out.stdout.strip()


def test_import_pulls_in_no_jax_and_no_reference():
    out = _run(
        "import sys, repro_torch, repro_torch.core, repro_torch.kernels.ops\n"
        "import repro_torch.kernels.ref\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith('jax.') or m == 'repro' or m.startswith('repro.'))\n"
        "print(bad)")
    assert out == "[]"


def test_session_without_device_needs_a_card():
    out = _run(
        "import torch\n"
        "from repro_torch.core import SharkSession\n"
        "if torch.cuda.is_available():\n"
        "    print('card')\n"
        "else:\n"
        "    try:\n"
        "        SharkSession()\n"
        "        print('no-raise')\n"
        "    except RuntimeError:\n"
        "        print('raised')\n")
    if out == "card":
        pytest.skip("a CUDA device is present")
    assert out == "raised"


def test_unported_paths_raise():
    from repro_torch.core import SharkSession
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        SharkSession(device="cpu", mesh=object())
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        SharkSession(device="cpu", server=object())
