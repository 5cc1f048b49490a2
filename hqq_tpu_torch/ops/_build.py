# SPDX-License-Identifier: Apache-2.0
"""Build and bind the CUDA kernels of `hqq_tpu_torch/csrc/`.

Each kernel source is compiled by ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface and loaded with `ctypes`. A build runs at
first use, into ``hqq_tpu_torch/_build/`` (listed in ``.gitignore``), and
is keyed by a hash of the sources and flags, so an edit rebuilds and an
unchanged tree loads what is there. `build_all` starts one ``nvcc`` per
source at once and waits for all of them.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
import tempfile

__all__ = ["KERNELS", "build_all", "library", "check"]

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
_HEADERS = ("hqq_common.cuh",)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
# kernel name -> (source file, C entry, argument types)
KERNELS = {
    "dequant": ("dequant.cu", "hqq_dequant", [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P]),
    "quant_matmul": (
        "quant_matmul.cu", "hqq_quant_matmul", [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    ),
    "w4a8_matmul": (
        "w4a8_matmul.cu", "hqq_w4a8_matmul",
        [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    ),
}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found: the kernels need nvcc")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def _lib_path(name: str) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in (KERNELS[name][0],) + _HEADERS:
        with open(os.path.join(_CSRC, f), "rb") as fh:
            h.update(fh.read())
    return os.path.join(BUILD_DIR, f"{name}-{h.hexdigest()[:16]}.so")


def build_all(names=None) -> dict:
    """Compile every kernel (or ``names``) that has no library for its
    current sources, one ``nvcc`` each, in parallel. Returns
    {name: compiler output} for what was built; raises if a build fails."""
    names = list(KERNELS if names is None else names)
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    jobs = {}
    for name in names:
        path = _lib_path(name)
        if os.path.exists(path):
            continue
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, os.path.join(_CSRC, KERNELS[name][0])]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        jobs[name] = (proc, tmp, path)
    logs, failed = {}, []
    for name, (proc, tmp, path) in jobs.items():
        out, _ = proc.communicate()
        logs[name] = out
        if proc.returncode == 0:
            os.replace(tmp, path)
        else:
            os.unlink(tmp)
            failed.append(f"{name} (exit {proc.returncode}):\n{out}")
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return logs


@functools.lru_cache(maxsize=None)
def library(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if needed, with
    the argument and return types of its C entry declared."""
    path = _lib_path(name)
    if not os.path.exists(path):
        build_all([name])
    lib = ctypes.CDLL(path)
    fn = getattr(lib, KERNELS[name][1])
    fn.argtypes = KERNELS[name][2]
    fn.restype = ctypes.c_int
    lib.hqq_error_string.argtypes = [ctypes.c_int]
    lib.hqq_error_string.restype = ctypes.c_char_p
    return lib


def check(name: str, code: int) -> None:
    """Raise if a C entry of kernel ``name`` returned a CUDA error."""
    if code != 0:
        msg = library(name).hqq_error_string(code).decode()
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {code}: {msg}")
