"""Builds and loads the port's CUDA kernels, and resolves devices.

The kernels are CUDA C++ sources under `ops/csrc/`, each with a plain C
launch function.  At first use every source is compiled by its own `nvcc`
process (all started together) for sm_90a into a shared library under
`build/kernels/` beside the package, and loaded with `ctypes`; pointers come
from `tensor.data_ptr()` and the stream from PyTorch's current stream.  The
libraries are keyed by a hash of their source and flags, so an edited source
is rebuilt and an unchanged one is reused.  A build or load failure raises:
nothing falls back to the plain PyTorch versions.

`torch.utils.cpp_extension.load` is not used: a source that includes
PyTorch's headers takes minutes to compile, a plain-C-interface source takes
seconds, and every fresh checkout builds anew.

`LAUNCHES` counts kernel launches per kernel name; each wrapper adds one
where it launches its kernel and nowhere else.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent
CSRC = _PKG / "ops" / "csrc"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
# --fmad=false: the float kernels are held bit-for-bit against plain PyTorch
# versions whose multiplies and adds round separately.
COMMON_FLAGS = ("-std=c++17", "-O3", "--fmad=false", "-shared",
                "-Xcompiler", "-fPIC", "-lineinfo")

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong

#: kernel name -> (source file, C launch function, argtypes).  A source may
#: hold several launch functions: it is compiled once.
KERNELS = {
    "align_banded": (
        "align_banded.cu", "align_banded_launch",
        [_P, _P, _P, _P, _P, _P, _L, _I, _I, _I, _P]),
    "anneal_chains": (
        "anneal_chains.cu", "anneal_chains_launch",
        [_P] * 12 + [_I] * 9 + [ctypes.c_float] * 3 + [_L, _P]),
    "minimizer_front_compact": (
        "minimizer_front.cu", "minimizer_front_compact_launch",
        [_P, _P, _P, _P, _P, _L, _I, _I, _I, _I, _P]),
    "minimizer_front_full": (
        "minimizer_front.cu", "minimizer_front_full_launch",
        [_P, _P, _P, _P, _L, _I, _I, _I, _P]),
}

LAUNCHES = {name: 0 for name in KERNELS}

_lock = threading.Lock()
_lib = None


class _Lib:
    """Attribute access to the launch functions of all kernel libraries."""

    def __init__(self, fns):
        self.__dict__.update(fns)


def resolve_device(device=None) -> torch.device:
    """`None` means CUDA and raises when there is none — an entry point
    never carries on on the CPU by itself.  Callers that want the plain
    PyTorch versions pass `device="cpu"`."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: pass device='cpu' to run the plain PyTorch "
                "versions of the kernels")
        return torch.device("cuda", torch.cuda.current_device())
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("device 'cuda' requested but no CUDA device "
                               "is available")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def build_dir() -> Path:
    return _PKG.parent / "build" / "kernels"


def _find_nvcc() -> str:
    cands = [shutil.which("nvcc")]
    for home in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"),
                 "/usr/local/cuda"):
        if home:
            cands.append(str(Path(home) / "bin" / "nvcc"))
    for c in cands:
        if c and Path(c).exists():
            return c
    raise RuntimeError("nvcc not found (PATH, CUDA_HOME, /usr/local/cuda): "
                       "the CUDA kernels cannot be built")


def load() -> _Lib:
    """Builds (if needed) and loads every kernel library; returns an object
    whose attributes are the C launch functions.  Raises on any failure."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        out_dir = build_dir()
        out_dir.mkdir(parents=True, exist_ok=True)
        procs, paths = {}, {}
        for src in sorted({src for src, _fn, _at in KERNELS.values()}):
            src_path = CSRC / src
            flags = (*ARCH_FLAGS, *COMMON_FLAGS)
            h = hashlib.sha256(src_path.read_bytes()
                               + " ".join(flags).encode()).hexdigest()[:16]
            so = out_dir / f"{src_path.stem}_{h}.so"
            paths[src] = so
            if so.exists():
                continue
            tmp = out_dir / f"{src_path.stem}_{h}.{os.getpid()}.tmp.so"
            cmd = [_find_nvcc(), *flags, "-o", str(tmp), str(src_path)]
            procs[src] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                           stderr=subprocess.STDOUT,
                                           text=True), tmp, cmd)
        for src, (proc, tmp, cmd) in procs.items():
            out, _ = proc.communicate()
            if proc.returncode != 0:
                for other, _t, _c in procs.values():
                    if other.poll() is None:
                        other.kill()
                raise RuntimeError(f"nvcc failed for {src}:\n"
                                   f"$ {' '.join(cmd)}\n{out}")
            os.replace(tmp, paths[src])
        dlls = {src: ctypes.CDLL(str(so)) for src, so in paths.items()}
        fns = {}
        for src, fn_name, argtypes in KERNELS.values():
            dll = dlls[src]
            fn = getattr(dll, fn_name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
            fns[fn_name] = fn
        _lib = _Lib(fns)
        return _lib


def check(err: int, what: str) -> None:
    """Raises if a launch function returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error {err} "
                           f"({_error_name(err)})")


def _error_name(err: int) -> str:
    known = {1: "invalid value", 2: "out of memory", 98: "invalid device function",
             209: "no kernel image for this device",
             701: "too many resources requested for launch",
             719: "launch failure"}
    return known.get(err, "see cudaError_t")


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0
