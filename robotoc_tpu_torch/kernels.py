"""Build and load the port's hand-written CUDA kernels (csrc/).

Each `csrc/<name>.cu` compiles with nvcc into its own shared library with
a plain C interface (`lib<name>-<hash>.so`, loaded with ctypes). The
libraries go to `build/kernels/` at the repository root, keyed by a hash
of the sources and flags, and are built at first use; `build()` starts
one nvcc per source at once. Nothing is compiled when a module is
imported.

`host_library()` builds csrc/host_shim.cpp with g++ instead: the kernels'
per-stage arithmetic for the CPU, used by the tests.
`host_library("chain_flops")` builds the operation count of K6's function
(csrc/chain_flops.cpp) the same way.

`check_args`, `ptr` and `stream` are what a wrapper needs to hand CUDA
tensors to a library function.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "kernels"
SOURCES = ("condense", "riccati_bwd", "chain", "chain_icub")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
GXX_FLAGS = ("-O2", "-std=c++17", "-shared", "-fPIC")

# dtype code of the C interfaces: 0 = float, 1 = double
DTYPE_CODE = {torch.float32: 0, torch.float64: 1}

_loaded = {}


def check_args(name, tensors, shapes):
    """Device, dtype, shape and contiguity checks before passing pointers
    to a kernel; `shapes` gives each tensor's expected shape."""
    ref = tensors[0]
    if ref.device.type != "cuda":
        raise ValueError(f"{name}: kernels take CUDA tensors, got "
                         f"{ref.device}")
    if ref.dtype not in DTYPE_CODE:
        raise TypeError(f"{name}: dtype {ref.dtype} (float32/float64 only)")
    for t, shape in zip(tensors, shapes):
        if t.device != ref.device or t.dtype != ref.dtype:
            raise ValueError(f"{name}: mixed devices or dtypes")
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name}: shape {tuple(t.shape)} != {shape}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: non-contiguous input")


def ptr(t) -> ctypes.c_void_p:
    """Device pointer of a tensor, or NULL for None."""
    return ctypes.c_void_p(0 if t is None else t.data_ptr())


def stream(t) -> ctypes.c_void_p:
    """PyTorch's current stream on the tensor's device."""
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def nvcc_path() -> str:
    """nvcc from CUDA_HOME, PATH or /usr/local/cuda; raises if absent."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ([os.path.join(home, "bin", "nvcc")] if home else []) + [
            shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]:
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                       "machine with the CUDA toolkit")


def _digest(files, flags) -> str:
    h = hashlib.sha256()
    for f in sorted(files):
        h.update(f.name.encode())
        h.update(f.read_bytes())
    h.update(" ".join(flags).encode())
    return h.hexdigest()[:16]


def _headers():
    return list(CSRC.glob("*.cuh"))


def _target(name: str, flags) -> Path:
    src = CSRC / f"{name}.cu" if name in SOURCES else CSRC / f"{name}.cpp"
    return BUILD_DIR / f"lib{name}-{_digest([src] + _headers(), flags)}.so"


def _start(cmd, target: Path):
    """Start a compiler writing to a temporary name beside `target`."""
    tmp = target.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.Popen(cmd + ["-o", str(tmp)], cwd=CSRC,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    return proc, tmp


def _finish(proc, tmp: Path, target: Path, what: str) -> str:
    out, _ = proc.communicate()
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"building {what} failed:\n{out}")
    os.replace(tmp, target)
    (target.with_suffix(".log")).write_text(out)
    return out


def build(names=SOURCES) -> dict:
    """Compile every missing CUDA library in `names` in parallel (one nvcc
    per source). Returns {name: (seconds, compiler output)} for what was
    built."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    t0 = time.perf_counter()
    jobs = {}
    for name in names:
        target = _target(name, NVCC_FLAGS)
        if not target.exists():
            jobs[name] = (target,) + _start(
                [nvcc, *NVCC_FLAGS, f"{name}.cu"], target)
    done = {}
    for name, (target, proc, tmp) in jobs.items():
        out = _finish(proc, tmp, target, f"csrc/{name}.cu")
        done[name] = (time.perf_counter() - t0, out)
    return done


def library(name: str) -> ctypes.CDLL:
    """The loaded CUDA library `name` (built first if missing)."""
    if name not in _loaded:
        target = _target(name, NVCC_FLAGS)
        if not target.exists():
            build((name,))
        _loaded[name] = ctypes.CDLL(str(target))
    return _loaded[name]


def host_library(name: str = "host_shim") -> ctypes.CDLL:
    """csrc/<name>.cpp built with g++ (no CUDA, no torch headers)."""
    if name not in _loaded:
        gxx = shutil.which("g++")
        if gxx is None:
            raise RuntimeError("g++ not found")
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        target = _target(name, GXX_FLAGS)
        if not target.exists():
            proc, tmp = _start([gxx, *GXX_FLAGS, f"{name}.cpp"], target)
            _finish(proc, tmp, target, f"csrc/{name}.cpp")
        _loaded[name] = ctypes.CDLL(str(target))
    return _loaded[name]
