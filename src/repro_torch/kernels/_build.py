"""Build the CUDA sources with ``nvcc`` at first use and load them by ctypes.

Each source under ``csrc/`` becomes one shared library with a plain C
interface, compiled for Hopper only (``sm_90a``) into ``build/kernels/`` at
the root of the checkout.  A library's file name carries a hash of its
source and flags, so an edited source is rebuilt and a current build is
reused.  :func:`build` starts one ``nvcc`` per source, all together.

Every C entry point returns ``cudaGetLastError()`` after its launch; the
wrappers pass it to :func:`check`, which raises on anything but 0.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path

SOURCES = ("gather", "esicp_filter", "segment_update", "rho_gather",
           "sketch", "flash_attention")
CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    found = shutil.which("nvcc")
    if found:
        return found
    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (set CUDA_HOME or put nvcc on PATH)")


def library_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    tag = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"{name}-{tag}.so"


def build(names=SOURCES) -> dict[str, float]:
    """Compile every missing library among ``names`` in parallel.

    Returns {name: seconds} for the sources compiled (empty when all were
    current).  The compiler's resource report (``-Xptxas -v``) is kept
    beside each library as ``<lib>.log``.
    """
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        jobs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True),
                      out, tmp, time.perf_counter())
    seconds, failures = {}, []
    for name, (proc, out, tmp, t0) in jobs.items():
        log, _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        out.with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            failures.append(f"{name}.cu (exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, out)
    if failures:
        raise RuntimeError("nvcc failed for " + "\n".join(failures))
    return seconds


def load(name: str, signatures: dict) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use.

    ``signatures`` maps each C function to (restype, [argtypes]); pointers
    and the stream are ``c_void_p`` so no pointer is cut to 32 bits.
    """
    lib = _LIBS.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(library_path(name)))
        for fn, (restype, argtypes) in signatures.items():
            f = getattr(lib, fn)
            f.restype = restype
            f.argtypes = argtypes
        err = getattr(lib, f"{name}_error_string")
        err.restype = ctypes.c_char_p
        err.argtypes = [ctypes.c_int]
        _LIBS[name] = lib
    return lib


def ptxas_report(name: str) -> list[dict]:
    """Per kernel of ``csrc/<name>.cu``: its mangled name, registers and
    spill bytes, from the compiler's resource report kept beside the
    built library."""
    report, cur = [], None
    for line in library_path(name).with_suffix(".log").read_text().splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            cur = {"kernel": m.group(1)}
            report.append(cur)
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            cur["spill_stores"], cur["spill_loads"] = map(int, m.groups())
        m = re.search(r"Used (\d+) registers", line)
        if m:
            cur["registers"] = int(m.group(1))
    return report


def check(lib: ctypes.CDLL, name: str, rc: int) -> None:
    """Raise if a launch reported a CUDA error."""
    if rc != 0:
        msg = getattr(lib, f"{name}_error_string")(rc).decode()
        raise RuntimeError(f"CUDA kernel launch in {name}.cu failed: "
                           f"error {rc} ({msg})")


def stream_ptr(device) -> int:
    """The current PyTorch stream of ``device`` as an integer handle."""
    import torch

    return torch.cuda.current_stream(device).cuda_stream


ptr = ctypes.c_void_p
c_int = ctypes.c_int
c_uint = ctypes.c_uint
c_float = ctypes.c_float
c_longlong = ctypes.c_longlong
