"""Build and bind the hand-written CUDA kernels under `csrc/`.

Each `csrc/<name>.cu` exposes a plain C interface.  At first use every
source is compiled by its own `nvcc` process, all started together, into
`<name>-<source hash>.so` under the build directory (`_build/` beside this
file, or `$REPRO_TORCH_KERNEL_DIR`), and loaded with `ctypes`.  A library
whose source hash matches is reused, so a source edit rebuilds it.

Nothing here runs at import time: the CPU test suite imports every module
of the package on machines that have no `nvcc` and no card.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = ("scan", "group", "radix", "decode", "train", "topk", "flash",
           "ssd")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]

_vp, _i, _ll, _d, _ull = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                          ctypes.c_double, ctypes.c_ulonglong)
# C entry points and their argument types: every pointer and the stream as
# c_void_p, so ctypes never truncates them to 32 bits.  An entry lives in
# the library of its own name, or of the name LIBRARY gives it
SIGNATURES = {
    "scan": ("shark_scan", [_vp, _vp, _vp, _ll, _ull, _d, _d, _vp, _vp,
                            _vp]),
    "group": ("shark_group_reduce", [_vp, _vp, _ll, _i, _ll, _vp, _vp]),
    "radix": ("shark_radix", [_vp, _ll, ctypes.c_uint, _ull, _vp, _vp, _vp]),
    "decode": ("shark_decode", [_vp, _vp, _vp, _ll, _ll, _ull, _vp]),
    "bitpack": ("shark_bitpack", [_vp, _i, _ll, _ull, _vp]),
    "train": ("shark_train_grad",
              [_vp, _vp, _vp, _ll, _i, _ull, _vp, _vp, _vp]),
    "topk": ("shark_topk",
             [_vp, _i, _vp, _ll, _i, _i, _vp, _vp, _vp, _vp, _vp, _vp, _vp]),
    "topk_fused": ("shark_topk_fused",
                   [_vp, _vp, _i, _vp, _ll, _i, _i, _ull, _vp, _vp, _vp]),
    "flash": ("shark_flash_attention_fwd",
              [_vp, _vp, _vp, _vp, _vp, _i, _i, _i, _i, _i, _i, _i, _i, _i]
              + [_ll] * 12 + [_vp]),
    "ssd": ("shark_ssd_scan",
            [_vp, _i, _i, _ll, _ll, _vp, _vp, _vp, _vp, _ll, _ll, _vp, _ll,
             _ll, _i, _i, _i, _i, _i, _vp, _vp, _vp]),
}

LIBRARY = {"bitpack": "decode", "topk_fused": "topk"}

# dtype codes of the C interfaces (enum DType in every source)
DTYPE_CODES = {torch.int32: 0, torch.int64: 1, torch.float32: 2,
               torch.float64: 3, torch.bfloat16: 4}

_LOCK = threading.Lock()
_FUNCS: Dict[str, object] = {}


def build_dir() -> Path:
    return Path(os.environ.get("REPRO_TORCH_KERNEL_DIR")
                or Path(__file__).resolve().parent / "_build")


def _nvcc() -> str:
    found = os.environ.get("NVCC") or shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels build on a machine "
                       "with the CUDA toolkit (set $NVCC to its compiler)")


def _target(name: str) -> Path:
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return build_dir() / f"{name}-{digest[:16]}.so"


def build_all() -> Dict[str, Path]:
    """Compile every source whose library is missing, one `nvcc` each, in
    parallel; returns {name: library path}.  Raises with the compiler's
    output when a build fails."""
    out = build_dir()
    out.mkdir(parents=True, exist_ok=True)
    targets = {name: _target(name) for name in SOURCES}
    procs = {}
    for name, lib in targets.items():
        if lib.exists():
            continue
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, lib)
    failed = []
    for name, (proc, tmp, lib) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name}.cu:\n{log}")
            continue
        os.replace(tmp, lib)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return targets


def kernel_fn(name: str):
    """The bound C entry point `name`, building on first use."""
    fn = _FUNCS.get(name)
    if fn is not None:
        return fn
    with _LOCK:
        if name not in _FUNCS:
            libs = {lib: ctypes.CDLL(str(path))
                    for lib, path in build_all().items()}
            for entry, (symbol, argtypes) in SIGNATURES.items():
                f = getattr(libs[LIBRARY.get(entry, entry)], symbol)
                f.argtypes = argtypes
                f.restype = ctypes.c_int
                _FUNCS[entry] = f
        return _FUNCS[name]


def dtype_code(t) -> int:
    """The C interface's code for tensor `t`'s dtype; raises on the rest."""
    code = DTYPE_CODES.get(t.dtype)
    if code is None:
        raise TypeError(f"kernel does not take dtype {t.dtype}")
    return code


def check_launch(name: str, rc: int) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {rc}")


def stream_handle(device) -> int:
    """The raw handle of `device`'s current CUDA stream (no Stream object is
    built: this runs on every kernel call)."""
    return torch._C._cuda_getCurrentRawStream(device.index)
