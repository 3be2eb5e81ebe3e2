"""Build and load the port's CUDA kernels.

Each ``csrc/*.cu`` file is compiled by ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface and loaded with ``ctypes``: no
PyTorch headers are compiled, so a build takes seconds. Libraries go
into ``speechsplit_tpu_torch/_build/`` (listed in ``.gitignore``), named
by a hash of their source, the ``csrc/*.cuh`` headers it includes
(directly or through another header) and the flags, so an edited source or header is rebuilt and an unchanged
one is loaded as it is. The first call builds every source
at once, one ``nvcc`` process each.

The host library of ``csrc/rapt.cc`` (``ops.pitch_native``) is built
by ``g++`` instead (:func:`load_host`), on a machine with no card too,
into the same directory under the same naming; ``build_all`` compiles
only the ``*.cu`` sources.

Nothing is built at import time: the CPU tests import every module on
a machine with no ``nvcc`` and no card. :func:`source_constant` reads a
limit a kernel owns from its source text, so Python holds the same
value without building anything.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home and (Path(home) / "bin" / "nvcc").exists():
        return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _headers(source: Path) -> list[Path]:
    """The ``csrc/*.cuh`` headers a source includes (``#include "x.cuh"``),
    and those they include in turn."""
    found: list[Path] = []
    todo = [source]
    while todo:
        text = todo.pop().read_text()
        for name in re.findall(r'^#include "([\w.]+\.cuh)"', text, re.M):
            header = source.parent / name
            if header not in found:
                found.append(header)
                todo.append(header)
    return found


def _target(source: Path) -> Path:
    """The library of ``source``, named by a hash of the source, the
    headers it includes and the flags."""
    text = b"".join(p.read_bytes() for p in (source, *_headers(source)))
    digest = hashlib.sha256(
        text + " ".join(NVCC_FLAGS).encode()
    ).hexdigest()[:16]
    return BUILD_DIR / f"lib{source.stem}_{digest}.so"


def source_constant(stem: str, name: str) -> int:
    """The value ``N`` of the line ``constexpr int <name> = N;`` (a
    trailing ``//`` comment allowed) in ``csrc/<stem>.cu``."""
    text = (CSRC / f"{stem}.cu").read_text()
    match = re.search(rf"^constexpr int {name} = (\d+);(\s*//.*)?$", text,
                      re.M)
    if match is None:
        raise RuntimeError(f"csrc/{stem}.cu states no {name}")
    return int(match.group(1))


def build_all() -> float:
    """Compile every stale ``csrc/*.cu`` in parallel; returns seconds."""
    start = time.perf_counter()
    with _lock:
        jobs = []
        for source in sorted(CSRC.glob("*.cu")):
            target = _target(source)
            if target.exists():
                continue
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = target.with_suffix(f".{os.getpid()}.tmp")
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(source)]
            proc = subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True,
            )
            jobs.append((source, target, tmp, proc))
        failures = []
        for source, target, tmp, proc in jobs:
            out, _ = proc.communicate()
            if proc.returncode != 0:
                failures.append(f"{source.name}:\n{out}")
                continue
            os.replace(tmp, target)
        if failures:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failures))
    return time.perf_counter() - start


def load(stem: str) -> ctypes.CDLL:
    """The loaded library built from ``csrc/<stem>.cu`` (built if stale)."""
    lib = _libs.get(stem)
    if lib is not None:
        return lib
    target = _target(CSRC / f"{stem}.cu")
    if not target.exists():
        build_all()
    with _lock:
        if stem not in _libs:
            _libs[stem] = ctypes.CDLL(str(target))
        return _libs[stem]


def load_host(stem: str, flags: tuple) -> ctypes.CDLL:
    """The loaded host library built from ``csrc/<stem>.cc`` by ``g++``
    with ``flags``, named by a hash of the source and the flags and built
    at first use; a build in a temporary file of this process is moved
    into place, so concurrent processes each load a whole library."""
    key = f"{stem}.cc"
    lib = _libs.get(key)
    if lib is not None:
        return lib
    source = CSRC / key
    digest = hashlib.sha256(
        source.read_bytes() + " ".join(flags).encode()).hexdigest()[:16]
    target = BUILD_DIR / f"lib{stem}_{digest}.so"
    with _lock:
        if key not in _libs:
            if not target.exists():
                BUILD_DIR.mkdir(parents=True, exist_ok=True)
                tmp = target.with_suffix(f".{os.getpid()}.tmp")
                proc = subprocess.run(
                    ["g++", *flags, str(source), "-o", str(tmp)],
                    capture_output=True, text=True)
                if proc.returncode != 0:
                    raise RuntimeError(f"g++ failed on {key}:\n"
                                       f"{proc.stdout}{proc.stderr}")
                os.replace(tmp, target)
            _libs[key] = ctypes.CDLL(str(target))
        return _libs[key]


def check(err: int, what: str, describe) -> None:
    """Raise if a launch function returned a non-zero ``cudaError_t``;
    ``describe`` is the library's ``*_error_string`` function."""
    if err != 0:
        text = describe(err).decode(errors="replace")
        raise RuntimeError(f"{what}: CUDA error {err} ({text})")
