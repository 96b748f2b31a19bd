"""Build the port's CUDA kernels at first use and load them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled by ``nvcc``
for ``sm_90a`` into its own shared library under ``build/kernels/`` at the
repository root, named by a hash of the source, the shared headers
(``csrc/*.cuh``, which a source includes by its quoted name) and the flags,
so an edited source or header is rebuilt and an unchanged one is reused.
Nothing but the repository's sources, ``nvcc`` and the CUDA runtime is
needed.  Nothing here
runs at import time: the CPU tests import every module of the port and never
build a library.

A kernel that cannot be built or loaded raises ``KernelBuildError``: a
broken installation, which the engine's fallback chain never absorbs (a
failed launch raises a plain ``RuntimeError``).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
FLAGS = ("-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I, _D = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
#: every library's resource query (csrc/tile.cuh's func_attrs)
_ATTRS = ([_I, _I, _P, _P], _I)
#: exported C functions of each library: name -> (argtypes, restype)
SIGNATURES = {
    "fused_factor_syrk": {
        "fused_factor_syrk_launch": (
            [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P], _I),
        "fused_factor_syrk_guarded_launch": (
            [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _D, _D, _I,
             _P], _I),
        "fused_factor_syrk_error": ([_I], ctypes.c_char_p),
        "fused_factor_syrk_func_attrs": _ATTRS,
    },
    "tri_inv": {
        "tri_inv_lower_launch": (
            [_P, _I, _I, _P, _P, _I, _I, _I, _I, _P], _I),
        "tri_inv_lower_error": ([_I], ctypes.c_char_p),
        "tri_inv_func_attrs": _ATTRS,
    },
    "gemm_nt": {
        "gemm_nt_launch": ([_P, _I, _P, _I, _P, _I, _I, _I, _I, _I, _P], _I),
        "gemm_nt_error": ([_I], ctypes.c_char_p),
        "gemm_nt_func_attrs": _ATTRS,
    },
    "syrk_ln": {
        "syrk_ln_launch": ([_P, _I, _P, _I, _I, _I, _I, _P], _I),
        "syrk_ln_sub_launch": ([_P, _I, _P, _I, _I, _I, _I, _P], _I),
        "syrk_ln_error": ([_I], ctypes.c_char_p),
        "syrk_ln_func_attrs": _ATTRS,
    },
    "chol_tile": {
        "chol_tile_launch": ([_P, _I, _P, _I, _I, _I, _P], _I),
        "chol_tile_error": ([_I], ctypes.c_char_p),
        "chol_tile_func_attrs": _ATTRS,
    },
    "trsm_rlt": {
        "trsm_rlt_launch": ([_P, _I, _P, _I, _P, _I, _I, _I, _I, _P], _I),
        "trsm_rlt_error": ([_I], ctypes.c_char_p),
        "trsm_rlt_func_attrs": _ATTRS,
    },
}

_LIBS: dict = {}


class KernelBuildError(RuntimeError):
    """``nvcc`` is missing or failed, or a built library cannot be loaded."""


def nvcc() -> str:
    """Path of ``nvcc``: ``$CUDA_HOME/bin``, then ``/usr/local/cuda/bin``,
    then ``PATH``."""
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").exists():
            return str(Path(root) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise KernelBuildError(
            "nvcc not found: the CUDA kernels cannot be built")
    return found


def library_path(name: str) -> Path:
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build(names=None) -> dict:
    """Compile every missing library in ``names`` (default: all), one
    ``nvcc`` per source, all started together.  Returns the seconds each
    build took (0.0 for a library already built); raises with the compiler
    output if one fails.  The ``-Xptxas -v`` report is kept beside each
    library as ``<library>.log``."""
    names = list(SIGNATURES) if names is None else list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    secs = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            secs[name] = 0.0
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        log = open(out.with_suffix(".so.log"), "w")
        cmd = [nvcc(), *FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=log,
                                        stderr=subprocess.STDOUT),
                       log, tmp, out, time.perf_counter())
    failed = []
    for name, (proc, log, tmp, out, t0) in procs.items():
        rc = proc.wait()
        log.close()
        secs[name] = time.perf_counter() - t0
        if rc != 0:
            failed.append((name, out.with_suffix(".so.log").read_text()))
            continue
        os.replace(tmp, out)
    if failed:
        raise KernelBuildError("nvcc failed:\n" + "\n".join(
            f"--- {n} ---\n{text}" for n, text in failed))
    return secs


def load(name: str) -> ctypes.CDLL:
    """The loaded library ``name``.  If it is not built yet, every missing
    library is built at once (in parallel), so a program waits for one
    build and not for one per kernel it reaches."""
    lib = _LIBS.get(name)
    if lib is None:
        if not library_path(name).exists():
            build()
        try:
            lib = ctypes.CDLL(str(library_path(name)))
        except OSError as e:
            raise KernelBuildError(
                f"cannot load the {name} kernels: {e}") from e
        for fn, (argtypes, restype) in SIGNATURES[name].items():
            f = getattr(lib, fn)
            f.argtypes = argtypes
            f.restype = restype
        _LIBS[name] = lib
    return lib


def check(lib: ctypes.CDLL, error_fn: str, code: int, what: str) -> None:
    """Raise (a ``RuntimeError``: a failed launch, not a build error) if a
    C entry point returned a CUDA error code."""
    if code != 0:
        msg = getattr(lib, error_fn)(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")


def func_attrs(name: str) -> list:
    """The kernel functions of library ``name`` as its ``<name>_func_attrs``
    export lists them, each a dict: ``function``, ``static`` and
    ``max_threads`` and ``regs`` (from ``cudaFuncGetAttributes`` on the
    current CUDA device), and the ``dynamic`` shared bytes and ``threads``
    its launches give it."""
    import torch

    lib = load(name)
    device = torch.cuda.current_device()
    fn = getattr(lib, f"{name}_func_attrs")
    out, rows = (_I * 5)(), []
    while True:
        fname = ctypes.c_char_p()
        code = fn(len(rows), device, out, ctypes.byref(fname))
        if code == 1 and rows:  # cudaErrorInvalidValue: past the last
            return rows
        check(lib, next(f for f in SIGNATURES[name] if f.endswith("_error")),
              code, f"{name}_func_attrs")
        rows.append({"function": fname.value.decode(), "static": out[0],
                     "max_threads": out[1], "regs": out[2],
                     "dynamic": out[3], "threads": out[4]})


def check_matrix(name: str, t, device) -> None:
    """Raise unless ``t`` is a 2-D float64 tensor on ``device`` whose rows
    are contiguous (unit column stride, row stride at least the width and
    below 2**31): the layout the kernels take, with the row stride as their
    leading dimension, so row and column slices of a contiguous matrix pass
    without a copy."""
    import torch

    if t.device != device or t.dim() != 2 or t.dtype != torch.float64:
        raise ValueError(f"{name} must be a 2-D float64 tensor on {device}")
    if t.shape[1] > 1 and t.stride(1) != 1:
        raise ValueError(f"{name} must have contiguous rows")
    if not (t.shape[1] <= t.stride(0) < 2 ** 31) and t.shape[0] > 1:
        raise ValueError(f"{name} has an unsupported row stride {t.stride(0)}")


def stream(device) -> int:
    """Handle of the current CUDA stream of ``device`` (a CUDA tensor's
    device, so its index is set): what ``torch.cuda.current_stream(device)
    .cuda_stream`` gives, without building a Stream object, which costs a
    small kernel's launch several microseconds of host time."""
    import torch

    return torch._C._cuda_getCurrentRawStream(device.index)


def ld(t) -> int:
    """Leading dimension (row stride) of a matrix passed ``check_matrix``."""
    return max(t.stride(0), t.shape[1], 1)
