"""Device-level observability: kernel-build tracking, device memory and
transfer telemetry, and on-demand profiler capture.

Port of ``predictionio_tpu/obs/device.py`` for torch and CUDA. The JAX
module opens the device black box -- the telemetry ALX (arxiv
2112.02194) uses to attribute accelerator time between gather, solve,
and collectives, and that arxiv 2501.10546 treats as first-class
production signals:

- **Build tracking** -- the JAX module wraps jitted entry points and
  counts XLA compiles per distinct shape. The port compiles nothing per
  shape: its hand-written kernels take any batch size, and each CUDA
  source is built once, at first use, by ``kernels/_build.py``, which
  reports every build here (:func:`count_build`). A build that ran
  ``nvcc`` counts in ``pio_jit_compiles_total{fn=<source>}`` (and its
  wall time in ``pio_jit_compile_seconds``); a load of a library built
  earlier counts in ``pio_jit_cache_hits_total{fn}``. The metric names
  are the JAX package's, so dashboards keep one series. After warmup the
  count stays flat under any load.
- **Memory & transfer telemetry** -- per-device gauges evaluated at
  scrape time from ``torch.cuda.memory_stats(device)`` (allocated,
  reserved, peak) and the device's total memory, plus a ``supported``
  gauge. Nothing here initialises CUDA: a process that has not touched
  the card (every CPU test) exports zeros with ``supported = 0``, as the
  JAX module does on CPU backends. Byte-accounting counters
  (``pio_device_transfer_bytes_total{direction,op}``) are fed by the
  explicit host->device copy sites: the deploy model put
  (``serve.model_put``, each model's ``device_factors``).
- **On-demand profiling** -- :func:`profile_capture` runs a bounded
  ``torch.profiler`` capture (CPU activity, plus CUDA activity once the
  process uses the card) behind a process lock (one capture at a time),
  backing the ``POST /profile`` endpoint, and writes a Chrome trace.

All instruments honor the global ``PIO_OBS=0`` kill switch.
"""

from __future__ import annotations

import logging
import os
import sys
import threading
import time

from predictionio_tpu_torch.obs import metrics as _metrics

logger = logging.getLogger(__name__)

__all__ = [
    "count_build",
    "count_transfer",
    "transfer_totals",
    "compile_snapshot",
    "ensure_device_gauges",
    "device_block",
    "profile_capture",
    "profile_active",
]


# -- kernel-build tracking ----------------------------------------------------

_lock = threading.Lock()

_m_compile_seconds = _metrics.histogram(
    "pio_jit_compile_seconds",
    "nvcc wall time per CUDA kernel source built at first use",
)


class _BuildStats:
    """Per-source build counters (host-side; the source of truth for the
    compile counters and the /stats.json block)."""

    __slots__ = ("calls", "compiles", "cache_hits")

    def __init__(self) -> None:
        self.calls = 0
        self.compiles = 0
        self.cache_hits = 0


_build_stats: dict[str, _BuildStats] = {}


def count_build(name: str, seconds: float, compiled: bool) -> None:
    """Account one first-use build of the kernel source ``name``:
    ``compiled`` when ``nvcc`` ran (``seconds`` its wall time), else a
    load of a library an earlier process built."""
    if not _metrics.enabled():
        return
    with _lock:
        stats = _build_stats.setdefault(name, _BuildStats())
        stats.calls += 1
        if compiled:
            stats.compiles += 1
        else:
            stats.cache_hits += 1
    if compiled:
        _metrics.counter(
            "pio_jit_compiles_total",
            "CUDA kernel sources compiled by nvcc at first use",
            fn=name,
        ).inc()
        _m_compile_seconds.observe(seconds)
    else:
        _metrics.counter(
            "pio_jit_cache_hits_total",
            "CUDA kernel libraries loaded without a compile",
            fn=name,
        ).inc()


def compile_snapshot() -> dict[str, dict[str, int]]:
    """Per-kernel-source {calls, compiles, cache_hits} -- the /stats.json
    device block's build table."""
    with _lock:
        return {
            name: {
                "calls": s.calls,
                "compiles": s.compiles,
                "cache_hits": s.cache_hits,
            }
            for name, s in sorted(_build_stats.items())
        }


# -- transfer byte accounting -------------------------------------------------

_transfer_lock = threading.Lock()
_transfer_totals: dict[tuple[str, str], int] = {}


def count_transfer(direction: str, op: str, nbytes: int) -> None:
    """Account one host<->device copy: ``direction`` is ``h2d``/``d2h``,
    ``op`` names the site (serve.model_put, ...). Feeds
    ``pio_device_transfer_bytes_total`` and the stats block's transfer
    table."""
    if not _metrics.enabled() or nbytes <= 0:
        return
    _metrics.counter(
        "pio_device_transfer_bytes_total",
        "Bytes moved between host and device, by site",
        direction=direction, op=op,
    ).inc(int(nbytes))
    _metrics.counter(
        "pio_device_transfers_total",
        "Host<->device copies, by site",
        direction=direction, op=op,
    ).inc()
    with _transfer_lock:
        key = (direction, op)
        _transfer_totals[key] = _transfer_totals.get(key, 0) + int(nbytes)


def transfer_totals() -> dict[str, int]:
    with _transfer_lock:
        return {
            f"{d}.{op}": n for (d, op), n in sorted(_transfer_totals.items())
        }


# -- device memory gauges -----------------------------------------------------

_gauges_registered = False
# torch.cuda.memory_stats() keys worth exporting, by short gauge kind
_MEM_KINDS = (
    ("allocated_bytes.all.current", "in_use"),
    ("reserved_bytes.all.current", "reserved"),
    ("allocated_bytes.all.peak", "peak"),
)


def _cuda_live() -> bool:
    """True once this process has initialised CUDA. Never initialises it:
    a scrape must not create a CUDA context (nor make a later fork
    unsafe) in a process that has not used the card."""
    import torch

    return torch.cuda.is_available() and torch.cuda.is_initialized()


def _device_labels() -> list[str]:
    import torch

    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    return [f"cuda:{i}" for i in range(n)] or ["cpu:0"]


def _memory(label: str) -> dict[str, int] | None:
    """{in_use, reserved, peak, limit} bytes of a CUDA device, or None
    when the device is the CPU or CUDA is not initialised."""
    if not label.startswith("cuda:") or not _cuda_live():
        return None
    import torch

    ix = int(label.split(":", 1)[1])
    stats = torch.cuda.memory_stats(ix)
    out = {kind: int(stats.get(key, 0)) for key, kind in _MEM_KINDS}
    out["limit"] = int(torch.cuda.get_device_properties(ix).total_memory)
    return out


def _mem_stat(label: str, kind: str) -> float:
    try:
        mem = _memory(label)
    except Exception:  # pragma: no cover - a scrape must never fail
        logger.debug("memory stats read failed", exc_info=True)
        mem = None
    return float(mem[kind]) if mem else 0.0


def ensure_device_gauges() -> bool:
    """Register per-device memory gauges (scrape-time callbacks), once.

    The gauges read ``torch.cuda.memory_stats`` at scrape time, and only
    when CUDA is already initialised: before that (and on a machine
    without a card, labelled ``cpu:0``) they export zeros with
    ``pio_device_memory_stats_supported = 0``.

    A no-op until ``torch`` is already imported, as the JAX package's is
    until ``jax`` is: the /metrics route calls this on every scrape, and
    a torch-free server (the event server, the router, the supervisor's
    stats) never pays a torch import for a scrape. Returns True when the
    gauges are live."""
    global _gauges_registered
    if _gauges_registered:
        return True
    if sys.modules.get("torch") is None:
        return False
    with _lock:
        if _gauges_registered:
            return True
        labels = _device_labels()
        for label in labels:
            _metrics.gauge(
                "pio_device_memory_stats_supported",
                "1 when the CUDA allocator reports memory stats (0 on the "
                "CPU and before this process initialised CUDA)",
                device=label,
            ).set_function(
                lambda lb=label: 1.0 if lb.startswith("cuda:") and _cuda_live()
                else 0.0
            )
            for kind in ("in_use", "reserved", "peak", "limit"):
                _metrics.gauge(
                    "pio_device_memory_bytes",
                    "Device allocator memory, read at scrape time "
                    "(0 when no stats are reported)",
                    device=label, kind=kind,
                ).set_function(lambda lb=label, k=kind: _mem_stat(lb, k))
        platform = "cuda" if labels[0].startswith("cuda:") else "cpu"
        _metrics.gauge(
            "pio_device_count", "Local devices visible to this process",
            platform=platform,
        ).set(float(len(labels)))
        _gauges_registered = True
        return True


def device_block() -> dict:
    """The additive ``device`` block for ``/stats.json``: the torch and
    CUDA versions, per-device name and memory (None before CUDA is
    initialised), transfer byte totals, and the kernel-build table."""
    import torch

    ensure_device_gauges()
    devices = []
    for label in _device_labels():
        try:
            kind = (
                torch.cuda.get_device_name(int(label.split(":", 1)[1]))
                if label.startswith("cuda:") and _cuda_live() else ""
            )
            devices.append(
                {"device": label, "kind": kind, "memory": _memory(label)}
            )
        except Exception:  # pragma: no cover - stats must never 500
            logger.debug("device stats read failed", exc_info=True)
    return {
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "devices": devices,
        "transfer_bytes": transfer_totals(),
        "jit": compile_snapshot(),
    }


# -- on-demand profiling ------------------------------------------------------

_profile_lock = threading.Lock()
_profile_running = False

MAX_PROFILE_SECONDS = 120.0
TRACE_FILE = "trace.json"


def profile_active() -> bool:
    return _profile_running


def _default_profile_dir() -> str:
    base = os.path.join(
        os.path.expanduser(os.environ.get("PIO_RUN_DIR", "~/.pio_tpu/run")),
        "profiles",
    )
    return os.path.join(base, time.strftime("%Y%m%d-%H%M%S"))


def profile_capture(
    seconds: float, out_dir: str | None = None, burn: bool = False
) -> dict:
    """Capture a ``torch.profiler`` trace for ``seconds``, write it as a
    Chrome trace (``<trace_dir>/trace.json``) and return {trace_dir,
    seconds, files, bytes}.

    CUDA activity (every kernel launched on the card, from any thread)
    is recorded when this process has initialised CUDA; CPU activity
    always. One capture at a time (RuntimeError when one is already
    running -- the /profile route maps it to 409); seconds is clamped to
    ``MAX_PROFILE_SECONDS``. ``burn`` keeps a small matmul looping
    during the window so an otherwise-idle process still produces a
    non-empty trace; servers capture whatever traffic is running."""
    global _profile_running
    seconds = min(max(float(seconds), 0.05), MAX_PROFILE_SECONDS)
    trace_dir = out_dir or _default_profile_dir()
    if not _profile_lock.acquire(blocking=False):
        raise RuntimeError("a profile capture is already running")
    try:
        _profile_running = True
        import torch
        from torch.profiler import ProfilerActivity, profile

        cuda = _cuda_live()
        activities = [ProfilerActivity.CPU]
        if cuda:
            activities.append(ProfilerActivity.CUDA)
        os.makedirs(trace_dir, exist_ok=True)
        with profile(activities=activities) as prof:
            deadline = time.perf_counter() + seconds
            if burn:
                x = torch.ones((256, 256), device="cuda" if cuda else "cpu")
                while time.perf_counter() < deadline:
                    float((x @ x.T).sum())
            else:
                while time.perf_counter() < deadline:
                    time.sleep(min(0.05, max(deadline - time.perf_counter(), 0)))
        prof.export_chrome_trace(os.path.join(trace_dir, TRACE_FILE))
    finally:
        _profile_running = False
        _profile_lock.release()
    n_files = 0
    n_bytes = 0
    for root, _dirs, files in os.walk(trace_dir):
        for f in files:
            n_files += 1
            try:
                n_bytes += os.path.getsize(os.path.join(root, f))
            except OSError:
                pass
    return {
        "trace_dir": trace_dir,
        "seconds": round(seconds, 3),
        "files": n_files,
        "bytes": n_bytes,
    }
