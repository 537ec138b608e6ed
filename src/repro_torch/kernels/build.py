"""Build the port's CUDA kernels with ``nvcc`` and load them with ``ctypes``.

Each ``csrc/<name>.cu`` has a plain C interface (no PyTorch headers), so one
``nvcc`` call per source takes seconds.  Libraries are built at first use
into ``build/repro_torch/`` at the root of the checkout (listed in
``.gitignore``), named by a hash of the source and the flags, so an edited
source is rebuilt and an unchanged one is loaded as it is.  ``build`` starts
one ``nvcc`` per missing library, all at once, and waits for all of them.

Nothing here runs at import time: the CPU tests import every module of the
port on a machine without ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

# dlopen is process-wide, so the loaded libraries are too
_LIBS: dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    """Path of the CUDA compiler (``$CUDA_HOME/bin/nvcc``, else the
    toolkit's default location, else ``PATH``)."""
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found: the port's CUDA kernels build on a machine "
            "with the CUDA toolkit (set CUDA_HOME)")
    return found


def target(name: str) -> tuple[Path, Path]:
    """(source, library) paths of kernel source ``csrc/<name>.cu``."""
    src = CSRC / f"{name}.cu"
    h = hashlib.sha1(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return src, BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def build(names) -> dict[str, str]:
    """Compile every named source whose library is missing, in parallel.

    Returns ``{name: ptxas report}`` (registers, shared memory and spills
    per kernel, as ``-Xptxas -v`` prints them; kept beside the library so
    an already-built library still reports).  Raises on any failed build.
    """
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        src, lib = target(name)
        if lib.exists():
            continue
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        procs[name] = (subprocess.Popen(
            [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        ), tmp, lib)
    failed = []
    for name, (proc, tmp, lib) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name}:\n{log}")
            continue
        lib.with_suffix(".log").write_text(log)
        os.replace(tmp, lib)  # atomic: a concurrent loader sees all or none
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    out = {}
    for name in names:
        log = target(name)[1].with_suffix(".log")
        out[name] = log.read_text() if log.exists() else ""
    return out


def load(name: str, declare) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if missing;
    ``declare(lib)`` sets its functions' ``argtypes``/``restype`` once."""
    lib = _LIBS.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(target(name)[1]))
        declare(lib)
        _LIBS[name] = lib
    return lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise when a C entry point returned a CUDA error code (every source
    exports ``error_string``, the CUDA runtime's message for a code)."""
    if err != 0:
        lib.error_string.restype = ctypes.c_char_p
        lib.error_string.argtypes = [ctypes.c_int]
        msg = lib.error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")
