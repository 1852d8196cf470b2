"""Build of the port's CUDA kernels at first use.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` into a shared library
with a plain C interface and loaded with ``ctypes`` (no PyTorch headers,
so a build takes seconds):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -o _build/<name>-<hash>.so csrc/<name>.cu -ldl

The output lands in ``pathway_tpu_torch/_build/`` (git-ignored), keyed by
a hash of the sources and flags, so an edited source rebuilds and an
unchanged one loads the library already there.  A failed build raises:
nothing falls back to a kernel's plain version.

Host code in ``csrc/host/<name>.cc`` (the batch tokenizer and row hash,
the native I/O runtime) builds the same way with the host's C++ compiler (``$CXX``, else ``g++``):

    g++ -std=c++17 -O3 -shared -fPIC -pthread -o _build/<name>-host-<hash>.so \
        csrc/host/<name>.cc

Each build writes a temporary file named by its process and renames it
into place, so concurrent processes (test workers) may race safely.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, List, Sequence

__all__ = ["BuildError", "build_all", "build_host", "load", "load_host"]

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)
LINK_FLAGS = ("-ldl",)  # after the source, so the linker keeps it
HOST_CSRC = CSRC / "host"
HOST_FLAGS = ("-std=c++17", "-O3", "-shared", "-fPIC", "-pthread")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


class BuildError(RuntimeError):
    """nvcc is missing or failed on a kernel source."""


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.exists(candidate):
        return candidate
    raise BuildError("nvcc not found (PATH, CUDA_HOME/bin, /usr/local/cuda/bin)")


def _target(name: str) -> Path:
    h = hashlib.sha256()
    for src in sorted(CSRC.glob("*.cu*")) + sorted(CSRC.glob("*.h")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS + LINK_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def _start(nvcc: str, name: str, target: Path):
    """Start nvcc for ``csrc/<name>.cu``; returns (target, tmp path,
    process, command)."""
    tmp = target.with_suffix(f".{os.getpid()}.tmp")
    return _spawn([nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu"), *LINK_FLAGS], target, tmp)


def _spawn(cmd: List[str], target: Path, tmp: Path):
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return target, tmp, proc, cmd


def _finish(job) -> None:
    target, tmp, proc, cmd = job
    output, _ = proc.communicate()
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise BuildError(f"{' '.join(cmd)} failed ({proc.returncode}):\n{output}")
    os.replace(tmp, target)  # atomic: a concurrent build sees all or nothing


def build_all(names: Sequence[str] | None = None) -> List[Path]:
    """Compile every kernel source (or ``names``) that has no current
    library, with all nvcc processes started together.  Returns the
    library paths."""
    if names is None:
        names = sorted(p.stem for p in CSRC.glob("*.cu"))
    targets = {n: _target(n) for n in names}
    with _lock:
        missing = [n for n in names if not targets[n].exists()]
        nvcc = _nvcc() if missing else ""
        jobs = [_start(nvcc, n, targets[n]) for n in missing]
        errors = []
        for job in jobs:
            try:
                _finish(job)
            except BuildError as exc:
                errors.append(str(exc))
        if errors:
            raise BuildError("\n".join(errors))
    return [targets[n] for n in names]


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    lib = _libs.get(name)
    if lib is None:
        (path,) = build_all([name])
        with _lock:
            lib = _libs.get(name)
            if lib is None:
                lib = _libs[name] = ctypes.CDLL(str(path))
    return lib


def _cxx() -> str:
    cxx = os.environ.get("CXX") or "g++"
    found = shutil.which(cxx)
    if not found:
        raise BuildError(f"host C++ compiler {cxx!r} not found (set CXX or install g++)")
    return found


def _host_target(name: str) -> Path:
    h = hashlib.sha256((HOST_CSRC / f"{name}.cc").read_bytes())
    h.update(" ".join(HOST_FLAGS).encode())
    return BUILD_DIR / f"{name}-host-{h.hexdigest()[:16]}.so"


def build_host(name: str, force: bool = False) -> Path:
    """Compile ``csrc/host/<name>.cc`` unless its library is current (or
    ``force``); returns the library path.  Raises ``BuildError`` on
    failure."""
    target = _host_target(name)
    with _lock:
        if force or not target.exists():
            tmp = target.with_suffix(f".{os.getpid()}.tmp")
            cmd = [_cxx(), *HOST_FLAGS, "-o", str(tmp), str(HOST_CSRC / f"{name}.cc")]
            _finish(_spawn(cmd, target, tmp))
    return target


def load_host(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/host/<name>.cc``, built first if
    needed."""
    key = "host:" + name
    lib = _libs.get(key)
    if lib is None:
        path = build_host(name)
        with _lock:
            lib = _libs.get(key)
            if lib is None:
                lib = _libs[key] = ctypes.CDLL(str(path))
    return lib
