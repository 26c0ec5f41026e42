"""Build the CUDA kernels in ``csrc/`` at first use and load them.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled on its
own by ``nvcc`` for Hopper (``sm_90a``) into a shared library, which is
loaded with :mod:`ctypes`; the ``csrc/*.cuh`` headers (the shared Hopper
helpers) are included by the sources, not built on their own. No PyTorch
header is compiled: a source builds in seconds where
``torch.utils.cpp_extension`` takes minutes. Libraries are named by a
digest of their source, every header and the flags, so an edited source or
header rebuilds and an unchanged tree is reused. They land in ``ops/build/``
(listed in ``.gitignore``); the compiler's ``-Xptxas -v`` report (registers,
shared memory, spills per kernel) is kept beside each as ``<lib>.log``.

Each C entry point returns ``cudaGetLastError()`` after its launch; the
caller raises on a non-zero code. With no ``nvcc`` this module raises: it
never falls back to another implementation.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable, Optional

SRC_DIR = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "build"
DEFAULT_CUDA_HOME = "/usr/local/cuda"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def find_nvcc() -> str:
    """Path of ``nvcc``: on ``PATH``, else under ``$CUDA_HOME/bin``, else
    under ``/usr/local/cuda/bin``. Raises when none exists."""
    found = shutil.which("nvcc")
    if found:
        return found
    for home in (os.environ.get("CUDA_HOME"), DEFAULT_CUDA_HOME):
        if home and os.access(os.path.join(home, "bin", "nvcc"), os.X_OK):
            return os.path.join(home, "bin", "nvcc")
    raise RuntimeError(
        "nvcc not found (looked on PATH, in $CUDA_HOME/bin and in "
        f"{DEFAULT_CUDA_HOME}/bin): the CUDA kernels of dlrover_tpu_torch "
        "are compiled from dlrover_tpu_torch/ops/csrc at first use and "
        "need the CUDA toolkit"
    )


def sources() -> Dict[str, Path]:
    """Kernel name → source, one per ``csrc/*.cu``."""
    return {p.stem: p for p in sorted(SRC_DIR.glob("*.cu"))}


def library_path(name: str) -> Path:
    h = hashlib.sha256(sources()[name].read_bytes())
    for header in sorted(SRC_DIR.glob("*.cuh")):
        h.update(header.name.encode() + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    digest = h.hexdigest()[:12]
    return BUILD_DIR / f"{name}-{digest}.so"


def build(names: Optional[Iterable[str]] = None) -> Dict[str, Path]:
    """Compile the named kernels (default: all) that are not built yet,
    one ``nvcc`` per source, all started together. Returns name → library
    path. Raises with the compiler's output when a build fails."""
    srcs = sources()
    names = list(srcs) if names is None else list(names)
    unknown = [n for n in names if n not in srcs]
    if unknown:
        raise ValueError(f"no kernel source for {unknown} in {SRC_DIR}")
    targets = {n: library_path(n) for n in names}
    missing = {n: p for n, p in targets.items() if not p.exists()}
    if not missing:
        return targets
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, out in missing.items():
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        procs[name] = (tmp, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(srcs[name])],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        ))
    failures = []
    for name, (tmp, proc) in procs.items():
        log, _ = proc.communicate()
        out = missing[name]
        out.with_suffix(".so.log").write_bytes(log)
        if proc.returncode != 0:
            failures.append(
                f"{name}: nvcc exit {proc.returncode}\n"
                + log.decode(errors="replace")
            )
            continue
        os.replace(tmp, out)
    if failures:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failures))
    return targets


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build([name])[name]))
            _libs[name] = lib
        return lib


def check(rc: int, what: str) -> None:
    """Raise when a C entry point reported a CUDA error."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc} at launch")
