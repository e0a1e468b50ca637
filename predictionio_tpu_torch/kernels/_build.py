"""Build and load the port's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` is compiled with ``nvcc`` for Hopper (``sm_90a``)
into a shared library with a plain C interface and loaded with
``ctypes`` -- no PyTorch headers, so a build takes seconds. The build
runs at first use, from the sources in the package, into ``_build/``
beside them (listed in ``.gitignore``), or into
``$PIO_COMPILATION_CACHE_DIR`` when that is set (read at each
``load``): the fleet's services share one build directory there
(``cli/daemon.py service_env``), and pointing it at a directory that
already holds the builds spares every child the ``nvcc`` runs. The
library's name carries a hash of its source and of the shared headers
(``csrc/*.cuh``), so an edited kernel is rebuilt and a stale one is
never loaded. A failed build
raises; there is no fallback. Each build is counted in ``obs/device.py``
(``pio_jit_compiles_total{fn}``).

Nothing here runs at import: the CPU tests import every module, and a
machine without a GPU has no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

from predictionio_tpu_torch.obs import device as obs_device

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
_name_locks: dict[str, threading.Lock] = {}
#: per kernel source: {"seconds": build wall time, "log": nvcc's output}
build_info: dict[str, dict] = {}


class KernelBuildError(RuntimeError):
    """nvcc is missing or refused a kernel source."""


class LaunchCount:
    """Launches of one kernel wrapper: a plain integer, thread-safe (the
    engine server scores on several request threads)."""

    def __init__(self) -> None:
        self._n = 0
        self._lock = threading.Lock()

    def add(self, n: int = 1) -> None:
        with self._lock:
            self._n += n

    def reset(self) -> None:
        with self._lock:
            self._n = 0

    @property
    def value(self) -> int:
        return self._n


def nvcc_path() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise KernelBuildError(
        "nvcc not found (PATH, $CUDA_HOME/bin): the CUDA kernels build "
        "from source at first use"
    )


def build_dir() -> Path:
    """Where the libraries are built and loaded from:
    ``$PIO_COMPILATION_CACHE_DIR`` when set and not empty, else
    ``BUILD_DIR``."""
    env = os.environ.get("PIO_COMPILATION_CACHE_DIR", "").strip()
    return Path(env).expanduser() if env else BUILD_DIR


def _compile(src: Path, out: Path) -> dict:
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.tmp.{os.getpid()}.{threading.get_ident()}")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise KernelBuildError(
            f"nvcc failed ({proc.returncode}) on {src.name}:\n{log}"
        )
    os.replace(tmp, out)
    return {"seconds": seconds, "log": log, "cached": False}


def _digest(src: Path) -> str:
    """Hash of a source and of the headers beside it (``csrc/*.cuh``,
    which sources include), so an edited header rebuilds them."""
    h = hashlib.sha256(src.read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    return h.hexdigest()[:16]


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use.
    Different sources build concurrently (one lock per source)."""
    with _lock:
        lib = _libs.get(name)
        if lib is not None:
            return lib
        name_lock = _name_locks.setdefault(name, threading.Lock())
    with name_lock:
        with _lock:
            lib = _libs.get(name)
        if lib is not None:
            return lib
        src = CSRC / f"{name}.cu"
        digest = _digest(src)
        out = build_dir() / f"lib{name}-{digest}.so"
        if out.exists():
            info = {"seconds": 0.0, "log": "", "cached": True}
        else:
            info = _compile(src, out)
        lib = ctypes.CDLL(str(out))
        with _lock:
            build_info[name] = info
            _libs[name] = lib
        # pio_jit_compiles_total{fn=name}: flat once every source is loaded
        obs_device.count_build(name, info["seconds"], not info["cached"])
        return lib


def load_all(names) -> None:
    """Build and load several kernel sources at once: one ``nvcc`` per
    source, all started together. Raises the first build error."""
    errors: list[BaseException] = []

    def one(name: str) -> None:
        try:
            load(name)
        except BaseException as e:  # re-raised below, in the caller
            errors.append(e)

    threads = [threading.Thread(target=one, args=(n,)) for n in names]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]


def check(err: int, what: str) -> None:
    """Raise on a nonzero ``cudaError_t`` returned by a C entry point."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}")
