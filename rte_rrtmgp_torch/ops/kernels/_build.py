"""Build and load the hand-written CUDA kernels of ``rte_rrtmgp_torch/csrc``.

The sources are compiled at first use with ``nvcc`` for ``sm_90a`` into one
shared library with a plain C interface, loaded with ``ctypes``.  Each
``.cu`` is compiled by its own ``nvcc`` process, all started together, and
the objects are linked into ``build/torch_kernels/<hash>/`` where the hash
covers the sources and the flags, so an edited source rebuilds and an
unchanged one loads at once.  Nothing here runs at import: a machine without
``nvcc`` or a card imports the package and uses the plain PyTorch twins.

Compiled without ``--use_fast_math`` and with ``--fmad=false``, so the
kernels use IEEE ``expf``/``sqrtf``/division and the operation order of
their PyTorch twins (no contraction into fused multiply-adds).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "torch_kernels"
SOURCES = ("gas_optics_interp.cu", "interp_rows.cu", "lw_sweep.cu",
           "sw_2stream.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# Shared memory a block may use on the H100 (and H200): 227 KB, opted into
# above 48 KB with cudaFuncAttributeMaxDynamicSharedMemorySize.
SMEM_PER_BLOCK = 232448

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float
# C signature of every entry point (all return cudaGetLastError()).
SIGNATURES = {
    "rrtmgp_gas_optics_interp_f32": (
        _P, _L, _L, _P, _L, _L, _I, _P, _I, _P, _I, _P, _P, _P, _P, _P, _P,
        _P, _P, _P, _P, _P, _I, _I, _P, _I, _P, _P, _I, _P, _P, _P, _I, _I,
        _I, _I, _I, _I, _I, _I, _I, _P),
    "rrtmgp_interp_rows_f32": (
        _I, _P, _L, _L, _P, _I, _P, _P, _P, _P, _L, _L, _P, _I, _P, _P, _P,
        _P, _P, _P, _P, _P, _P, _P, _L, _I, _P),
    "rrtmgp_lw_sweep_f32": (
        _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _F,
        _F, _F, _P),
    "rrtmgp_lw_sweep_lm_f32": (
        _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
        _F, _F, _F, _F, _P),
    "rrtmgp_sw_2stream_f32": (
        _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
        _F, _F, _P),
    "rrtmgp_sw_2stream_lm_f32": (
        _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
        _F, _F, _P),
    "rrtmgp_sw_2stream_fused_f32": (
        _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P, _P, _P, _P, _P,
        _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _F, _P),
    "rrtmgp_sw_2stream_fused_lm_f32": (
        _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P, _P, _P, _P, _P,
        _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _F, _P),
}

# Launches of each kernel, counted by its wrapper where it launches.
LAUNCHES = {"gas_optics_interp": 0, "interp_rows_multi": 0, "interp_rows": 0,
            "lw_sweep": 0, "sw_2stream": 0, "lw_sweep_lm": 0,
            "sw_2stream_lm": 0}

# What the launches did besides launching, summed over them:
# ``minor_scaled``, the minor intervals whose scaling the gas-optics kernel
# computed from the cells' inputs (134 a step of the published tables:
# 38 + 36 LW, 34 + 26 SW intervals, each in one spectral chunk);
# ``sw_fused_gpts``, the g-points whose SW optics (the gas optics combined,
# the per-band increments added) a launch of the SW kernel's fused entries
# formed itself (224 a step of the published tables, 448 with
# ``clear_sky=True``; 0 where the plain chain writes the planes: by-band
# or optical output, float64, the twins).
WORK = {"minor_scaled": 0, "sw_fused_gpts": 0}

_state = {"lib": None, "info": None}


def reset_launch_counts() -> None:
    """Zero :data:`LAUNCHES` and :data:`WORK`."""
    for counts in (LAUNCHES, WORK):
        for k in counts:
            counts[k] = 0


def launch_counts() -> dict:
    return dict(LAUNCHES)


def minor_scaled() -> int:
    """Minor intervals scaled inside the gas-optics kernel since the last
    :func:`reset_launch_counts`."""
    return WORK["minor_scaled"]


def sw_fused_gpts() -> int:
    """G-points whose SW optics a launch of the SW kernel formed itself
    since the last :func:`reset_launch_counts`."""
    return WORK["sw_fused_gpts"]


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def _source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def build() -> dict:
    """Compile the kernels if this source hash has no library yet.  Returns
    {"path", "seconds", "log", "cached"}; ``log`` holds nvcc's ``-Xptxas -v``
    report (registers, shared memory and spills of every kernel)."""
    if _state["info"] is not None:
        return _state["info"]
    out_dir = BUILD_ROOT / _source_hash()
    lib_path = out_dir / "librrtmgp_kernels.so"
    log_path = out_dir / "build.log"
    if lib_path.exists():
        info = dict(path=str(lib_path), seconds=0.0, cached=True,
                    log=log_path.read_text() if log_path.exists() else "")
        _state["info"] = info
        return info

    nvcc = _nvcc()
    BUILD_ROOT.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_ROOT) as tmp:
        procs = []
        for src in SOURCES:
            obj = os.path.join(tmp, src.replace(".cu", ".o"))
            cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", str(CSRC / src),
                   "-o", obj]
            procs.append((src, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        logs, failed = [], []
        for src, _, p in procs:
            out, _ = p.communicate()
            logs.append(f"== {src}\n{out}")
            if p.returncode != 0:
                failed.append(src)
        if failed:
            raise RuntimeError("nvcc failed for " + ", ".join(failed) + "\n"
                               + "\n".join(logs))
        tmp_lib = os.path.join(tmp, "librrtmgp_kernels.so")
        link = subprocess.run(
            [nvcc, "-shared", "-o", tmp_lib] + [o for _, o, _ in procs],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode != 0:
            raise RuntimeError("nvcc link failed\n" + link.stdout)
        out_dir.mkdir(parents=True, exist_ok=True)
        log = "\n".join(logs)
        log_path.write_text(log)
        os.replace(tmp_lib, lib_path)
    info = dict(path=str(lib_path), seconds=time.perf_counter() - t0,
                cached=False, log=log)
    _state["info"] = info
    return info


def library() -> ctypes.CDLL:
    """The loaded kernel library (built at first use)."""
    if _state["lib"] is None:
        lib = ctypes.CDLL(build()["path"])
        for name, args in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = list(args)
            fn.restype = ctypes.c_int
        _state["lib"] = lib
    return _state["lib"]


def check(rc: int, name: str) -> None:
    """Raise on a nonzero cudaError_t returned by a launch."""
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError {rc}")
