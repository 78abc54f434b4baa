"""Build and bind the hand-written CUDA kernels in ``csrc/``.

At first use, ``nvcc`` compiles every ``csrc/*.cu`` for Hopper (``sm_90a``),
one process per source, all started together, and links the objects into
one shared library with a plain C interface, which is loaded with
``ctypes``. The library's file name carries a hash of the sources and the
flags, so a stale build is never loaded. Nothing is downloaded or prebuilt.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from dataclasses import dataclass
from pathlib import Path

__all__ = ["Build", "build", "library"]

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"

# No --use_fast_math: approximate exp/log/division would move log-dets.
# -Xptxas -v reports registers and spills per kernel in the build log.
ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = ARCH + (
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
# Per source. rqs.cu and rqs_bf16.cu: --fmad=false, no a*b+c contraction, so the spline
# kernels round exactly as their plain torch versions (one op per
# elementwise kernel) do; near the 1e-3 derivative floor the spline
# amplifies single roundings far past the f32 tolerances, and the
# comparison on the card would measure that instead. coupling.cu and
# train.cu keep nvcc's FMA contraction: they are held to tolerances, their
# plain versions' matmuls summing in cuBLAS's order.
SOURCE_FLAGS = {"rqs.cu": ("--fmad=false",),
                "rqs_bf16.cu": ("--fmad=false",)}

_P, _I64, _I32, _F64 = (ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                        ctypes.c_double)
# entry name -> argtypes (see the extern "C" blocks of csrc/rqs.cu,
# csrc/rqs_bf16.cu, csrc/coupling.cu, csrc/coupling_bf16.cu, csrc/train.cu,
# csrc/train_bf16.cu and csrc/mma_probe.cu); int and double arrays and pointer
# tables go in as ctypes arrays
_FWD_ARGS = [_P, _P, _P, _P, _I64, _I64, _I64, _I32, _I32, _I32, _F64, _I32,
             _P]
_BWD_ARGS = [_P, _P, _P, _P, _P, _P, _I64, _I64, _I64, _I64, _I64, _I64,
             _I32, _I32, _I32, _I32, _F64, _P]
_CPL_FWD_ARGS = [_P, _P, _P, _I64, _I32, _I32, _I32, _P, _P, _P, _I32, _I32,
                 _P]
_CPL_BWD_ARGS = [_P, _P, _P, _P, _P, _I64, _I32, _I32, _I32, _P, _P, _P, _P,
                 _I32, _I32, _P]
_TRAIN_ARGS = [_P, _P, _P, _P, _P, _I64, _P, _P, _P, _I32, _I64, _I64, _I32,
               _I32, _I32, _P, _P, _I32, _P, _P]
_TRAIN_PLAN_ARGS = [_I32, _I32, _I32, _P, _P, _I64, _P]
ENTRIES = {
    "rqs_fwd_f32": _FWD_ARGS,
    "rqs_fwd_f64": _FWD_ARGS,
    "rqs_bwd_fwddir_f32": _BWD_ARGS,
    "rqs_bwd_fwddir_f64": _BWD_ARGS,
    "rqs_bwd_invdir_f32": _BWD_ARGS,
    "rqs_bwd_invdir_f64": _BWD_ARGS,
    "rqs_fwd_f32_rbf16": _FWD_ARGS,
    "rqs_fwd_bf16": _FWD_ARGS,
    "rqs_bwd_fwddir_f32_rbf16": _BWD_ARGS,
    "rqs_bwd_fwddir_bf16": _BWD_ARGS,
    "rqs_bwd_invdir_f32_rbf16": _BWD_ARGS,
    "rqs_bwd_invdir_bf16": _BWD_ARGS,
    "coupling_fwd_f32": _CPL_FWD_ARGS,
    "coupling_fwd_f64": _CPL_FWD_ARGS,
    "coupling_bwd_f32": _CPL_BWD_ARGS,
    "coupling_bwd_f64": _CPL_BWD_ARGS,
    "coupling_fwd_f32_cbf16": _CPL_FWD_ARGS,
    "coupling_fwd_bf16": _CPL_FWD_ARGS,
    "coupling_bwd_f32_cbf16": _CPL_BWD_ARGS,
    "coupling_bwd_bf16": _CPL_BWD_ARGS,
    "coupling_mma_plan": [_I32, _I32, _I32, _P, _I32, _P],
    "realnvp_train_f32": _TRAIN_ARGS,
    "realnvp_train_f64": _TRAIN_ARGS,
    "realnvp_train_bf16": _TRAIN_ARGS,
    "realnvp_train_plan_f32": _TRAIN_PLAN_ARGS,
    "realnvp_train_plan_f64": _TRAIN_PLAN_ARGS,
    "realnvp_train_plan_bf16": _TRAIN_PLAN_ARGS,
    "mma_probe_bf16": [_P, _P, _P, _P, _I32, _P],
    "mma_probe_f64": [_P, _P, _P, _P, _I32, _I32, _P],
}


@dataclass(frozen=True)
class Build:
    path: Path
    seconds: float  # 0.0 when the library was already built
    log: str        # nvcc's output (ptxas register and spill report), kept
                    # beside the library for a later call


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    nvcc = shutil.which("nvcc") or str(Path(cuda_home) / "bin" / "nvcc")
    if not Path(nvcc).exists():
        raise RuntimeError(
            "nvcc not found (looked on PATH and in $CUDA_HOME/bin): the "
            "CUDA kernels are built from csrc/ at first use")
    return nvcc


def build() -> Build:
    """Compile ``csrc/*.cu`` unless a library of these exact sources and
    flags is already in ``build/torch_kernels/`` (then its build's log is
    read back from beside it)."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    digest.update(repr(sorted(SOURCE_FLAGS.items())).encode())
    for src in _sources():
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    out = BUILD_DIR / f"lib{digest.hexdigest()[:16]}.so"
    log_path = out.with_suffix(".log")
    if out.exists():
        return Build(out, 0.0, log_path.read_text()
                     if log_path.exists() else "")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{out.stem}.{os.getpid()}"
    tmp = out.with_name(f"{tag}.tmp.so")
    nvcc = _nvcc()
    t0 = time.perf_counter()
    # one nvcc per source, all running at once; then one link
    jobs = []
    for src in (s for s in _sources() if s.suffix == ".cu"):
        obj = BUILD_DIR / f"{tag}.{src.stem}.o"
        jobs.append((obj, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, *SOURCE_FLAGS.get(src.name, ()), "-I",
             str(CSRC), "-c", "-o", str(obj), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    log, failed = "", []
    for obj, proc in jobs:
        text = proc.communicate()[0]
        log += text
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}):\n{text}")
    if not failed:
        link = subprocess.run(
            [nvcc, *ARCH, "-shared", "-o", str(tmp),
             *(str(obj) for obj, _ in jobs)],
            capture_output=True, text=True, check=False)
        log += link.stdout + link.stderr
        if link.returncode != 0:
            failed.append(f"nvcc link failed ({link.returncode}):\n"
                          f"{link.stdout}{link.stderr}")
    for obj, _ in jobs:
        obj.unlink(missing_ok=True)
    seconds = time.perf_counter() - t0
    if failed:
        tmp.unlink(missing_ok=True)
        raise RuntimeError("\n".join(failed))
    tmp_log = tmp.with_suffix(".log")
    tmp_log.write_text(log)
    os.replace(tmp_log, log_path)  # before the library, which readers test
    os.replace(tmp, out)  # atomic: a reader never sees a partial library
    return Build(out, seconds, log)


_LIB: ctypes.CDLL | None = None


def library() -> ctypes.CDLL:
    """The kernels' shared library, built on first call, with ``argtypes``
    and ``restype`` set for every entry."""
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(build().path))
        for name, argtypes in ENTRIES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _LIB = lib
    return _LIB
