"""Build and load the port's CUDA kernels.

Each ``kernels/csrc/<name>.cu`` is compiled by ``nvcc`` into its own
shared library with a plain C interface and loaded with ``ctypes``::

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -o build/<name>-<hash>.so csrc/<name>.cu

The libraries go to ``build/`` at the repository root, named by a hash
of the sources and flags, so a changed source builds anew and an
unchanged one is loaded as it is.  Building happens at first use (or
all at once, one ``nvcc`` per source started together, through
:func:`build`), never at import.  PyTorch's cpp_extension loader is
not used: a source that includes ``torch/extension.h`` takes minutes
to compile, a plain C interface seconds.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Callable, Dict, List, Optional, Sequence, Tuple

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build"
NVCC_FLAGS: Tuple[str, ...] = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def sources() -> List[str]:
    """Names of the kernel sources (``csrc/<name>.cu``)."""
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def nvcc() -> str:
    """Path of ``nvcc``: ``$CUDA_HOME/bin`` as PyTorch finds it, else PATH."""
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME:
        cand = os.path.join(CUDA_HOME, "bin", "nvcc")
        if os.path.exists(cand):
            return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found: the CUDA kernels of repro_torch need the CUDA "
            "toolkit (set CUDA_HOME or put nvcc on PATH)"
        )
    return found


def library_path(name: str) -> Path:
    """Where the library built from ``csrc/<name>.cu`` lives."""
    h = hashlib.sha256()
    h.update((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def _start(name: str) -> Optional[Tuple[subprocess.Popen, Path, Path]]:
    out = library_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(
        cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
    )
    return proc, tmp, out


def _finish(name: str, job: Tuple[subprocess.Popen, Path, Path]) -> str:
    proc, tmp, out = job
    log, _ = proc.communicate()
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed on csrc/{name}.cu:\n{log}")
    os.replace(tmp, out)  # atomic: a concurrent loader never sees half a file
    return log


def build(names: Optional[Sequence[str]] = None) -> Dict[str, str]:
    """Compile every named source not yet built, one ``nvcc`` per source,
    all started together; wait for all of them.

    Returns ``nvcc``'s output per source that was compiled (register and
    shared-memory use from ``-Xptxas=-v``).  Raises if any build failed,
    after every started compiler has exited.
    """
    names = list(names) if names is not None else sources()
    jobs = {n: _start(n) for n in names}
    logs: Dict[str, str] = {}
    errors: List[str] = []
    for n, job in jobs.items():
        if job is None:
            continue
        try:
            logs[n] = _finish(n, job)
        except RuntimeError as e:
            errors.append(str(e))
    if errors:
        raise RuntimeError("\n".join(errors))
    return logs


def library(name: str, bind: Callable[[ctypes.CDLL], None]) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed.

    ``bind`` sets the ``argtypes``/``restype`` of its entry points; it
    runs once, when the library is loaded.
    """
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(str(library_path(name)))
            lib.tpp_error_string.argtypes = [ctypes.c_int]
            lib.tpp_error_string.restype = ctypes.c_char_p
            bind(lib)
            _libs[name] = lib
    return lib


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise if a kernel entry point returned a CUDA error."""
    if code != 0:
        msg = lib.tpp_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")
