# SPDX-License-Identifier: Apache-2.0
"""Build and bind the CUDA kernels of `hqq_tpu_torch/csrc/`.

Each kernel source is compiled by ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface and loaded with `ctypes`; a source may
hold the C entries of several kernels. A build runs at first use, into
``hqq_tpu_torch/_build/`` (listed in ``.gitignore``), and is keyed by a hash
of the sources and flags, so an edit rebuilds and an unchanged tree loads
what is there. `build_all` starts one ``nvcc`` per source at once and waits
for all of them.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
import tempfile
import time

__all__ = ["KERNELS", "build_all", "library", "check"]

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
_HEADERS = ("hqq_common.cuh", "sm90_ptx.cuh", "qmm_sm90.cuh")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_U = ctypes.c_uint
# kernel name -> (source file, C entry, argument types)
KERNELS = {
    "dequant": ("dequant.cu", "hqq_dequant", [_P] * 4 + [_U] * 6 + [_I] * 4 + [_P]),
    "dequant_ax0": ("dequant.cu", "hqq_dequant_ax0", [_P] * 4 + [_I] * 11 + [_P]),
    "dequant_canonical": (
        "dequant.cu", "hqq_dequant_canonical", [_P] * 4 + [_U] * 13 + [_I] * 8 + [_P],
    ),
    "grouped_matmul": ("grouped_matmul.cu", "hqq_grouped_matmul", [_P] * 5 + [_I] * 7 + [_P]),
    "quant_matmul": ("quant_matmul.cu", "hqq_quant_matmul", [_P] * 6 + [_I] * 12 + [_P]),
    "quant_matmul_ax0": (
        "quant_matmul_ax0.cu", "hqq_quant_matmul_ax0", [_P] * 6 + [_I] * 13 + [_P],
    ),
    "quant_matmul_lora": (
        "quant_matmul_lora.cu", "hqq_quant_matmul_lora", [_P] * 8 + [_I] * 15 + [_P],
    ),
    "flash_attention": (
        "flash_prefill.cu", "hqq_flash_prefill",
        [_P] * 6 + [_I] * 5 + [ctypes.c_float] + [_I] * 7 + [_P],
    ),
    "flash_attention_fp32": (
        "flash_fp32_sm90.cu", "hqq_flash_fp32",
        [_P] * 6 + [_I] * 5 + [ctypes.c_float] + [_I] * 7 + [_P],
    ),
    "flash_attention_backward_dkv": (
        "flash_backward_sm90.cu", "hqq_flash_bwd_dkv",
        [_P] * 11 + [_I] * 5 + [ctypes.c_float] + [_I] * 6 + [_P],
    ),
    "flash_attention_backward_dq": (
        "flash_backward_sm90.cu", "hqq_flash_bwd_dq",
        [_P] * 8 + [_I] * 5 + [ctypes.c_float] + [_I] * 6 + [_P],
    ),
    "flash_attention_backward_dkv_fp32": (
        "flash_backward_fp32_sm90.cu", "hqq_flash_bwd_fp32_dkv",
        [_P] * 9 + [_I] * 5 + [ctypes.c_float] + [_I] * 6 + [_P],
    ),
    "flash_attention_backward_dq_fp32": (
        "flash_backward_fp32_sm90.cu", "hqq_flash_bwd_fp32_dq",
        [_P] * 8 + [_I] * 5 + [ctypes.c_float] + [_I] * 6 + [_P],
    ),
    "paged_attention": (
        "paged_attention.cu", "hqq_paged_attention", [_P] * 9 + [_I] * 17 + [_P],
    ),
    "qmm_fp32": ("qmm_fp32.cu", "hqq_qmm_fp32", [_P] * 8 + [_I] * 15 + [_P]),
    "rms_norm": (
        "rms_norm.cu", "hqq_rms_norm",
        [_P] * 3 + [_I] * 2 + [ctypes.c_float] * 2 + [_I] * 5 + [_P],
    ),
    "layer_norm": (
        "rms_norm.cu", "hqq_layer_norm",
        [_P] * 4 + [_I] * 3 + [ctypes.c_float] + [_I] * 5 + [_P],
    ),
    "w4a8_matmul": ("w4a8_matmul.cu", "hqq_w4a8_matmul", [_P] * 6 + [_I] * 14 + [_P]),
    "w4a8_lora_matmul": (
        "w4a8_matmul.cu", "hqq_w4a8_lora_matmul", [_P] * 8 + [_I] * 15 + [_P],
    ),
}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found: the kernels need nvcc")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def _lib_path(source: str) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in (source,) + _HEADERS:
        with open(os.path.join(_CSRC, f), "rb") as fh:
            h.update(fh.read())
    return os.path.join(BUILD_DIR, f"{source[:-3]}-{h.hexdigest()[:16]}.so")


def build_all(names=None) -> dict:
    """Compile the source of every kernel (or of ``names``) that has no
    library for its current sources, one ``nvcc`` each, in parallel. Returns
    {source: (seconds, compiler output)} for what was built, the seconds
    from the start to that compiler's exit; raises if a build fails."""
    sources = sorted({KERNELS[name][0] for name in (KERNELS if names is None else names)})
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    jobs = {}
    t0 = time.monotonic()
    for source in sources:
        path = _lib_path(source)
        if os.path.exists(path):
            continue
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        log = tempfile.TemporaryFile(mode="w+", dir=BUILD_DIR)
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, os.path.join(_CSRC, source)]
        proc = subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT, text=True)
        jobs[source] = (proc, tmp, path, log)
    done, failed = {}, []
    while len(done) < len(jobs):
        for source, (proc, tmp, path, log) in jobs.items():
            if source in done or proc.poll() is None:
                continue
            seconds = time.monotonic() - t0
            log.seek(0)
            out = log.read()
            log.close()
            done[source] = (seconds, out)
            if proc.returncode == 0:
                os.replace(tmp, path)
            else:
                os.unlink(tmp)
                failed.append(f"{source} (exit {proc.returncode}):\n{out}")
        time.sleep(0.05)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return done


@functools.lru_cache(maxsize=None)
def _load(source: str) -> ctypes.CDLL:
    path = _lib_path(source)
    if not os.path.exists(path):
        build_all([name for name, spec in KERNELS.items() if spec[0] == source])
    lib = ctypes.CDLL(path)
    for src, entry, argtypes in KERNELS.values():
        if src == source:
            fn = getattr(lib, entry)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
    lib.hqq_error_string.argtypes = [ctypes.c_int]
    lib.hqq_error_string.restype = ctypes.c_char_p
    return lib


def library(name: str) -> ctypes.CDLL:
    """The loaded library that holds kernel ``name``, built first if needed,
    with the argument and return types of its C entries declared."""
    return _load(KERNELS[name][0])


def check(name: str, code: int) -> None:
    """Raise if a C entry of kernel ``name`` returned a CUDA error."""
    if code != 0:
        msg = library(name).hqq_error_string(code).decode()
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {code}: {msg}")
