"""Build and load the hand-written CUDA kernels.

Each ``nano_tpu_torch/csrc/*.cu`` compiles with ``nvcc`` into its own
shared library with a plain C interface under ``build/torch_kernels/`` at
the repository root, and loads through ``ctypes``.  Nothing is built when
a module is imported: the first launch (or an explicit ``build_all()``)
builds, and every source is compiled in parallel, one ``nvcc`` each.  A
library built from the same source, the same headers (``csrc/*.cuh``) and
the same flags is reused.

IEEE division and square root, and denormals, are required
(``q80_act_quant``, ``q80_matvec_fq``, ``rms_norm_q80``, ``swiglu_q80``,
``rms_norm_q4k``, ``rms_norm_q4k_fq``, ``swiglu_q4k``, ``q4k_fake_quant``
and ``q4k_act_quant`` must reproduce the JAX package's integer decisions
bit for bit), so the flags never include ``--use_fast_math``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from functools import lru_cache
from typing import Dict, List

import torch

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "torch_kernels")

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

P, I, F, Q = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong

# C signature of every entry point: (argtypes, library stem)
SIGNATURES = {
    "q80_act_quant": ([P, I, P, P, I, I, I, P], "q80_matmul"),
    "q80_matmul_init": ([], "q80_matmul"),
    "q80_matmul_w8a8": ([P, P, P, P, P, I, I, I, I, I, I, I, I, I, P],
                        "q80_matmul"),
    "q80_matmul_rows": ([P, I, P, P, P, I, I, I, I, I, I, I, I, I, P],
                        "q80_matmul"),
    "q80_matmul_rows_warp": ([P, I, P, P, P, I, I, I, I, I, P], "q80_matmul"),
    "q80_matvec_rows": ([P, I, P, P, P, I, I, I, I, I, I, I, I, P],
                        "q80_matmul"),
    "q80_matvec_fq": ([P, I, P, P, P, I, P, P, I, I, I, I, I, I, I, I, P],
                      "q80_matmul"),
    "rms_norm_q80": ([P, P, P, P, P, P, P, I, I, I, F, I, I, I, I, P],
                     "norm_quant"),
    "swiglu_q80": ([P, P, P, P, I, I, I, I, I, I, I, P], "norm_quant"),
    "norm_quant_init": ([], "norm_quant"),
    "rms_norm_q4k": ([P, P, P, P, P, P, P, P, P, I, I, I, F, I, I, I, P],
                     "norm_quant"),
    "rms_norm_q4k_fq": ([P, P, P, P, P, P, I, I, I, F, I, I, I, P],
                        "norm_quant"),
    "swiglu_q4k": ([P, P, P, P, P, P, I, I, I, I, I, I, P], "norm_quant"),
    "decode_attention": ([P, P, P, P, P, P, I, P, P, P, I, Q, I, I, I, I, I,
                          I, F, I, I, P], "decode_attn"),
    "decode_attention_part_stride": ([I, I], "decode_attn"),
    "q4k_fake_quant": ([P, I, P, I, I, I, P], "q4k"),
    "q4k_matmul": ([P, P, P, P, P, I, I, I, I, I, P], "q4k"),
    "q4k_matvec_fq": ([P, P, P, P, P, P, P, I, P, I, I, I, I, I, I, I, P],
                      "q4k"),
    "q4k_matvec_fq_init": ([], "q4k"),
    "q4k_fast_div_check": ([P, P, I, P, P, P, P], "q4k"),
    "q4k_act_quant": ([P, I, P, P, P, P, I, I, I, P], "q4k"),
    "q4k_matmul_w4a4_init": ([], "q4k"),
    "q4k_matmul_w4a4": ([*[P] * 8, I, I, I, I, I, I, I, I, I, P], "q4k"),
    "flash_attn_fwd": ([P, P, P, P, P, *[I] * 8, *[Q] * 9, F, P],
                       "flash_attn"),
    "flash_attn_fwd_blocks_per_sm": ([I, I], "flash_attn"),
    "flash_attn_bwd": ([*[P] * 10, *[I] * 8, *[Q] * 9, F, P],
                       "flash_attn"),
    "flash_attn_bwd_blocks_per_sm": ([I, I], "flash_attn"),
    "flash_bwd_wgmma": ([*[P] * 10, *[I] * 11, *[Q] * 9, F, P],
                        "flash_bwd_wgmma"),
    "flash_bwd_wgmma_smem": ([I, I, I], "flash_bwd_wgmma"),
    "flash_bwd_wgmma_blocks_per_sm": ([I, I, I], "flash_bwd_wgmma"),
    "flash_fwd_wgmma": ([*[P] * 5, *[I] * 9, *[Q] * 9, F, P],
                        "flash_fwd_wgmma"),
    "flash_fwd_wgmma_smem": ([I, I], "flash_fwd_wgmma"),
    "flash_fwd_wgmma_blocks_per_sm": ([I, I], "flash_fwd_wgmma"),
}

# The SM count assumed where the device is not asked (an H100's): the
# kernels' work splits are functions of the shapes and the SM count.
H100_SMS = 132

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


@lru_cache(maxsize=None)
def sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def nvcc_path() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels of nano_tpu_torch "
                       "are built on the machine with the GPU")


def _stamp(src: str) -> str:
    """A hash of the source, every header beside it and the flags."""
    h = hashlib.sha256()
    headers = sorted(f for f in os.listdir(CSRC_DIR) if f.endswith(".cuh"))
    for path in [src] + [os.path.join(CSRC_DIR, f) for f in headers]:
        with open(path, "rb") as f:
            h.update(f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()


def _read(path: str) -> str:
    with open(path) as f:
        return f.read()


def _lib_path(stem: str) -> str:
    return os.path.join(BUILD_DIR, f"lib{stem}.so")


def build_all() -> Dict[str, str]:
    """Compile every stale source in parallel; -> {stem: ptxas log}."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    stems = sorted(f[:-3] for f in os.listdir(CSRC_DIR) if f.endswith(".cu"))
    procs: List = []
    logs: Dict[str, str] = {}
    for stem in stems:
        src = os.path.join(CSRC_DIR, stem + ".cu")
        stamp_file = _lib_path(stem) + ".stamp"
        stamp = _stamp(src)
        if (os.path.exists(_lib_path(stem)) and os.path.exists(stamp_file)
                and _read(stamp_file) == stamp):
            logs[stem] = "(up to date)"
            continue
        tmp = _lib_path(stem) + f".{os.getpid()}.tmp"
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp, src]
        procs.append((stem, tmp, stamp_file, stamp,
                      subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True)))
    failed = []
    for stem, tmp, stamp_file, stamp, proc in procs:
        out, _ = proc.communicate()
        logs[stem] = out
        if proc.returncode != 0:
            failed.append(f"{stem}.cu (rc {proc.returncode}):\n{out}")
            continue
        os.replace(tmp, _lib_path(stem))
        with open(stamp_file, "w") as f:
            f.write(stamp)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return logs


def lib(stem: str) -> ctypes.CDLL:
    """The loaded library ``lib<stem>.so``, building everything first if
    any source is stale."""
    with _lock:
        if stem not in _libs:
            build_all()
            handle = ctypes.CDLL(_lib_path(stem))
            for name, (argtypes, owner) in SIGNATURES.items():
                if owner == stem:
                    fn = getattr(handle, name)
                    fn.argtypes = argtypes
                    fn.restype = ctypes.c_int
            _libs[stem] = handle
        return _libs[stem]


def stream(t: torch.Tensor) -> int:
    """The current CUDA stream of t's device, as the int a kernel takes;
    raises when t is not on the current device."""
    if t.device.index != torch.cuda.current_device():
        raise ValueError(f"tensor on {t.device}, but the current CUDA device "
                         f"is {torch.cuda.current_device()}")
    return torch.cuda.current_stream(t.device).cuda_stream


def check(rc: int, name: str) -> None:
    """Raise when a launch reported a CUDA error."""
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc} at launch")
