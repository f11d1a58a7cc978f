"""Build and load the kernel libraries: nvcc -> shared library -> ctypes.

Each ``csrc/<name>.cu`` compiles, at first use, into
``bloomscene_tpu_torch/build/libbs_<name>_<digest>.so`` with a plain C
interface, and nvcc's output (the ptxas report) beside it as ``.log``;
the digest covers the source and the flags, so an edited source
rebuilds. All missing libraries compile in parallel (one ``nvcc``
each). There is no fallback: a missing ``nvcc`` or a failed build raises.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

PKG = Path(__file__).resolve().parents[2]
CSRC = PKG / "csrc"
BUILD_DIR = PKG / "build"
KERNELS = ("pairs", "expand", "blend", "blend_bwd", "hashgrid_bwd",
           "gather_rows_bwd", "hashgrid_encode", "stamp", "emission_sums")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

_loaded: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, "
                       "/usr/local/cuda/bin): the CUDA kernels cannot be "
                       "built")


def library_path(name: str) -> Path:
    digest = hashlib.sha256(
        (CSRC / f"{name}.cu").read_bytes()
        + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"libbs_{name}_{digest}.so"


def build_all() -> float:
    """Compile every kernel library that is not built yet, all in parallel.
    Returns the wall seconds spent."""
    t0 = time.perf_counter()
    todo = [n for n in KERNELS if not library_path(n).exists()]
    if not todo:
        return 0.0
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = []
    for name in todo:
        tmp = library_path(name).with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs.append((name, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    failed = []
    for name, tmp, proc in procs:
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name}.cu (rc {proc.returncode}):\n{out}")
            tmp.unlink(missing_ok=True)
        else:
            library_path(name).with_suffix(".log").write_text(out)
            os.replace(tmp, library_path(name))
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return time.perf_counter() - t0


def build_log(name: str) -> str:
    """nvcc's output for the built library ``name`` (the ptxas report:
    registers, shared memory, spills), or "" before it is built."""
    log = library_path(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def library(name: str) -> ctypes.CDLL:
    """The loaded kernel library ``name``, building all libraries first if
    this one is missing."""
    lib = _loaded.get(name)
    if lib is None:
        if not library_path(name).exists():
            build_all()
        lib = ctypes.CDLL(str(library_path(name)))
        _loaded[name] = lib
    return lib


def check(err: int, what: str) -> None:
    """Raise on a nonzero cudaError_t returned by a launch."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")


def require(t, dtype, shape: tuple, name: str, device) -> None:
    """Validate a tensor handed to a kernel: device, dtype, shape and
    contiguity."""
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")


def stream_ptr(device) -> int:
    import torch
    return torch.cuda.current_stream(device).cuda_stream
