"""Flight recorder: atomic incident bundles for post-hoc forensics.

When an SLO transitions to ``violated``, when an unhandled exception is
about to kill the process, or when an operator asks (``POST /incident``,
``pio incidents``), this module freezes the whole observability surface
into one directory under ``$PIO_RUN_DIR/incidents/<ts>-<reason>/``:

- ``meta.json``      — reason, timestamps, pid/host, trigger context
- ``history.json``   — the metrics history rings (:mod:`obs.history`)
- ``metrics.prom``   — current Prometheus text (every counter/gauge/histogram)
- ``traces.json``    — the slowest-trace ring, ``sloViolated`` traces split out
- ``slo.json``       — every objective's state + the full alert ring
- ``state.json``     — obs summary, device telemetry, freshness lineage,
  ingest stats (via history providers), live train progress
- ``config.json``    — redacted environment (``PIO_*``/``CUDA_*``/``TORCH_*``)
  and platform info; values whose key smells like a credential are dropped

Durability discipline matches the storage layer: every file is written
into a hidden ``.tmp-*`` staging directory, fsynced, the directory
fsynced, then published with one ``os.rename`` — a crash mid-dump
(kill -9 included, see the chaos test) leaves only an invisible ``.tmp``
husk, never a half bundle. Dumps are rate-limited per reason
(``PIO_INCIDENT_MIN_INTERVAL_S``, default 300 s) and the directory is
pruned to the newest ``PIO_INCIDENT_KEEP`` (default 20).

SLO-triggered dumps wait ``PIO_INCIDENT_SLO_DELAY_S`` (default 1.5 s)
before capturing: requests that finish *while* the objective is violated
get tagged into the trace ring (``obs.trace``), so the bundle records
the aftermath, not just the instant of transition.

Under ``PIO_OBS=0`` everything here is inert: no hooks installed, no
threads, no directories created, :func:`record` returns ``None``.
"""

from __future__ import annotations

import json
import os
import platform
import shutil
import socket
import sys
import threading
import time
import traceback
from pathlib import Path

from predictionio_tpu_torch.obs import metrics as _metrics

__all__ = [
    "record",
    "incidents_dir",
    "list_incidents",
    "load_incident",
    "prune",
    "install_crash_hooks",
    "reset_for_tests",
]

BUNDLE_FILES = (
    "meta.json",
    "history.json",
    "metrics.prom",
    "traces.json",
    "slo.json",
    "state.json",
    "config.json",
)

# substrings that mark an env key as a credential — value is dropped
_SECRET_MARKERS = ("KEY", "SECRET", "TOKEN", "PASS", "CRED", "AUTH")
# env prefixes worth recording alongside the PIO_* knobs
_ENV_PREFIXES = ("PIO_", "CUDA_", "TORCH_", "NVIDIA_")

_lock = threading.Lock()
_last_by_reason: dict[str, float] = {}
_hooks_installed = False
_prev_excepthook = None
_prev_threading_hook = None


def _env_float(name: str, default: float) -> float:
    raw = os.environ.get(name, "").strip()
    if not raw:
        return default
    try:
        return float(raw)
    except ValueError:
        return default


def incidents_dir() -> Path:
    """``$PIO_RUN_DIR/incidents`` (same run-dir convention as pidfiles
    and train progress). Not created until a bundle is written."""
    run = Path(os.environ.get("PIO_RUN_DIR", "~/.pio_tpu/run")).expanduser()
    return run / "incidents"


def _redact_env() -> dict:
    env = {}
    for k, v in sorted(os.environ.items()):
        if not any(k.startswith(p) for p in _ENV_PREFIXES):
            continue
        if any(m in k.upper() for m in _SECRET_MARKERS):
            env[k] = "[redacted]"
        else:
            env[k] = v
    return env


def _gather(reason: str, note: str | None, context: dict | None) -> dict:
    """Build the bundle's file map. Every section is best-effort — a
    broken reader yields an ``{"error": ...}`` stub, never a lost dump."""
    from predictionio_tpu_torch.obs import history as _history
    from predictionio_tpu_torch.obs import slo as _slo
    from predictionio_tpu_torch.obs import trace as _trace

    now = time.time()
    files: dict[str, object] = {}

    files["meta.json"] = {
        "reason": reason,
        "note": note,
        "context": context,
        "t_ms": int(now * 1e3),
        "iso": time.strftime("%Y-%m-%dT%H:%M:%S", time.localtime(now)),
        "pid": os.getpid(),
        "host": socket.gethostname(),
        "argv": sys.argv,
    }

    try:
        # capture one fresh sample so the rings include "right now"
        _history.sample_now()
        files["history.json"] = _history.snapshot()
    except Exception as e:
        files["history.json"] = {"error": f"{type(e).__name__}: {e}"}

    try:
        files["metrics.prom"] = _metrics.render_prometheus()
    except Exception as e:
        files["metrics.prom"] = f"# error: {type(e).__name__}: {e}\n".encode()

    try:
        traces = _trace.TRACES.snapshot()
        files["traces.json"] = {
            "slowest": traces,
            "sloViolated": [t for t in traces if t.get("sloViolated")],
        }
    except Exception as e:
        files["traces.json"] = {"error": f"{type(e).__name__}: {e}"}

    try:
        files["slo.json"] = _slo.REGISTRY.document()
    except Exception as e:
        files["slo.json"] = {"error": f"{type(e).__name__}: {e}"}

    state: dict[str, object] = {}
    try:
        state["obs"] = _metrics.stats_block()
    except Exception as e:
        state["obs"] = {"error": f"{type(e).__name__}: {e}"}
    try:
        from predictionio_tpu_torch.obs import device as _device

        state["device"] = _device.device_block()
    except Exception as e:
        state["device"] = {"error": f"{type(e).__name__}: {e}"}
    try:
        from predictionio_tpu_torch.obs import freshness as _freshness

        state["freshness"] = _freshness.block()
    except Exception as e:
        state["freshness"] = {"error": f"{type(e).__name__}: {e}"}
    try:
        from predictionio_tpu_torch.obs import progress as _progress

        state["progress"] = _progress.read_progress()
    except Exception as e:
        state["progress"] = {"error": f"{type(e).__name__}: {e}"}
    files["state.json"] = state

    files["config.json"] = {
        "env": _redact_env(),
        "python": sys.version.split()[0],
        "platform": platform.platform(),
        "cwd": os.getcwd(),
    }
    return files


def _fsync_dir(path: Path) -> None:
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def record(
    reason: str,
    note: str | None = None,
    context: dict | None = None,
    force: bool = False,
) -> Path | None:
    """Dump one incident bundle; returns its directory, or ``None`` when
    obs is disabled or the per-reason rate limit suppressed the dump
    (``force=True`` — operator-initiated paths — bypasses the limit)."""
    if not _metrics.enabled():
        return None
    reason = "".join(
        c if c.isalnum() or c in "._-" else "-" for c in (reason or "manual")
    ) or "manual"
    now = time.time()
    min_interval = _env_float("PIO_INCIDENT_MIN_INTERVAL_S", 300.0)
    with _lock:
        last = _last_by_reason.get(reason, 0.0)
        if not force and now - last < min_interval:
            return None
        _last_by_reason[reason] = now

    files = _gather(reason, note, context)
    root = incidents_dir()
    stamp = time.strftime("%Y%m%d-%H%M%S", time.localtime(now))
    name = f"{stamp}.{int(now * 1e3) % 1000:03d}-{reason}"
    final = root / name
    tmp = root / f".tmp-{name}-{os.getpid()}"
    tmp.mkdir(parents=True, exist_ok=True)
    try:
        for fname, payload in files.items():
            if isinstance(payload, bytes):
                data = payload
            else:
                data = json.dumps(
                    payload, indent=2, sort_keys=True, default=str
                ).encode("utf-8")
            fpath = tmp / fname
            with open(fpath, "wb") as f:
                f.write(data)
                f.flush()
                os.fsync(f.fileno())
            # chaos-test hook: widen the window between staged writes
            # and the publishing rename so kill -9 can land inside it
            hold = _env_float("PIO_INCIDENT_TEST_HOLD_S", 0.0)
            if hold > 0.0:
                time.sleep(hold)
        _fsync_dir(tmp)
        if final.exists():
            final = root / f"{name}-{os.getpid()}"
        os.rename(tmp, final)
        _fsync_dir(root)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    _metrics.counter(
        "pio_incidents_total", "Incident bundles written", reason=reason
    ).inc()
    try:
        prune()
    except Exception:
        pass
    return final


# -- inspection (CLI + tests) -------------------------------------------------


def list_incidents(root: Path | None = None) -> list[dict]:
    """Complete (published) bundles, newest first. ``.tmp-*`` staging
    husks from interrupted dumps are invisible by construction."""
    root = incidents_dir() if root is None else Path(root)
    if not root.is_dir():
        return []
    out = []
    for d in sorted(root.iterdir(), reverse=True):
        if not d.is_dir() or d.name.startswith("."):
            continue
        entry: dict = {"name": d.name, "path": str(d)}
        try:
            meta = json.loads((d / "meta.json").read_text())
            entry["reason"] = meta.get("reason")
            entry["iso"] = meta.get("iso")
            entry["t_ms"] = meta.get("t_ms")
        except Exception:
            entry["reason"] = d.name.split("-", 2)[-1]
        fs = sorted(p.name for p in d.iterdir() if p.is_file())
        entry["files"] = fs
        entry["bytes"] = sum((d / f).stat().st_size for f in fs)
        out.append(entry)
    return out


def load_incident(name: str, root: Path | None = None) -> dict:
    """File name -> parsed JSON (or text for ``.prom``) for one bundle."""
    root = incidents_dir() if root is None else Path(root)
    d = root / name
    if name.startswith(".") or not d.is_dir():
        raise FileNotFoundError(f"no incident bundle {name!r} under {root}")
    out: dict = {}
    for p in sorted(d.iterdir()):
        if not p.is_file():
            continue
        if p.suffix == ".json":
            try:
                out[p.name] = json.loads(p.read_text())
            except Exception as e:
                out[p.name] = {"error": f"{type(e).__name__}: {e}"}
        else:
            out[p.name] = p.read_text(errors="replace")
    return out


def prune(keep: int | None = None, root: Path | None = None) -> list[str]:
    """Delete the oldest bundles past ``keep`` (and any stale staging
    dirs from dead pids); returns the removed names."""
    root = incidents_dir() if root is None else Path(root)
    if keep is None:
        keep = int(_env_float("PIO_INCIDENT_KEEP", 20.0))
    if not root.is_dir():
        return []
    removed: list[str] = []
    bundles = sorted(
        d for d in root.iterdir() if d.is_dir() and not d.name.startswith(".")
    )
    for d in bundles[: max(0, len(bundles) - max(0, keep))]:
        shutil.rmtree(d, ignore_errors=True)
        removed.append(d.name)
    for d in root.iterdir():
        if d.is_dir() and d.name.startswith(".tmp-"):
            try:
                pid = int(d.name.rsplit("-", 1)[-1])
            except ValueError:
                continue
            if pid != os.getpid() and not _pid_alive(pid):
                shutil.rmtree(d, ignore_errors=True)
                removed.append(d.name)
    return removed


def _pid_alive(pid: int) -> bool:
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    except PermissionError:
        return True
    return True


# -- triggers -----------------------------------------------------------------


def _on_slo_violation(transition: dict) -> None:
    """SLO engine callback (``slo.REGISTRY.on_violation``): schedule a
    deferred dump so traces tagged while violated make the bundle."""
    reason = f"slo-{transition.get('slo', 'unknown')}"
    delay = _env_float("PIO_INCIDENT_SLO_DELAY_S", 1.5)
    if delay <= 0.0:
        try:
            record(reason, context={"alert": transition})
        except Exception:
            pass
        return
    t = threading.Timer(
        delay, _safe_record, args=(reason,), kwargs={"context": {"alert": transition}}
    )
    t.daemon = True
    t.name = "incident-dump"
    t.start()


def _safe_record(reason: str, **kw) -> None:
    try:
        record(reason, **kw)
    except Exception:
        pass


def _excepthook(exc_type, exc, tb):
    _safe_record(
        "crash",
        note="".join(traceback.format_exception(exc_type, exc, tb))[-8000:],
        force=True,
    )
    hook = _prev_excepthook or sys.__excepthook__
    hook(exc_type, exc, tb)


def _threading_hook(args):
    if args.exc_type is not SystemExit:
        _safe_record(
            "thread-crash",
            note="".join(
                traceback.format_exception(
                    args.exc_type, args.exc_value, args.exc_traceback
                )
            )[-8000:],
            context={"thread": getattr(args.thread, "name", None)},
        )
    hook = _prev_threading_hook or threading.__excepthook__
    hook(args)


def install_crash_hooks() -> None:
    """Chain the flight recorder into ``sys.excepthook`` /
    ``threading.excepthook`` and wire the SLO engine's violation
    callback. Idempotent; a no-op while obs is disabled."""
    global _hooks_installed, _prev_excepthook, _prev_threading_hook
    if not _metrics.enabled():
        return
    from predictionio_tpu_torch.obs import slo as _slo

    with _lock:
        _slo.REGISTRY.on_violation = _on_slo_violation
        if _hooks_installed:
            return
        _hooks_installed = True
        _prev_excepthook = sys.excepthook
        sys.excepthook = _excepthook
        _prev_threading_hook = threading.excepthook
        threading.excepthook = _threading_hook


def reset_for_tests() -> None:
    """Unchain the crash hooks and clear rate-limit state."""
    global _hooks_installed, _prev_excepthook, _prev_threading_hook
    from predictionio_tpu_torch.obs import slo as _slo

    with _lock:
        if _hooks_installed:
            sys.excepthook = _prev_excepthook or sys.__excepthook__
            threading.excepthook = _prev_threading_hook or threading.__excepthook__
            _prev_excepthook = None
            _prev_threading_hook = None
            _hooks_installed = False
        if getattr(_slo.REGISTRY, "on_violation", None) is _on_slo_violation:
            _slo.REGISTRY.on_violation = None
        _last_by_reason.clear()
