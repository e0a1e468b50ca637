"""Live training progress, published through an atomic file.

The JAX package's checkpointed trainers dispatch work in
``every``-iteration segments with a host sync at each boundary — the
natural places to say how far along a run is without breaking up the
donated-carry program. The port's trainer does not publish yet; the
flight recorder (``obs/incident.py``) reads the file. :class:`ProgressPublisher` writes a small JSON
document (tmp + fsync + ``os.replace``, same recipe as the checkpoint
saver) at each boundary; ``pio status`` / ``pio status --json`` and the
dashboard read it with :func:`read_progress` while the run is live.

The file lives at ``$PIO_PROGRESS_FILE`` when set, else
``$PIO_RUN_DIR``/``~/.pio_tpu/run`` + ``train_progress.json`` — the
same run dir the daemon pidfiles use, so a status probe on the training
host finds it with zero configuration. A reader can always tell a live
run from a stale file: :func:`is_live` checks the writer pid still
exists and the file was updated recently.

Publishing is gated on the global obs kill switch (``PIO_OBS=0`` trains
silently) and never raises — a full disk must not kill a training run.
"""

from __future__ import annotations

import json
import logging
import os
import tempfile
import time

from predictionio_tpu_torch.obs import metrics as _metrics

logger = logging.getLogger(__name__)

__all__ = ["ProgressPublisher", "progress_path", "read_progress", "is_live"]

PROGRESS_FILENAME = "train_progress.json"

#: A progress file older than this (seconds since its writer's last
#: update) is treated as stale even if a process with the recorded pid
#: still exists — pids recycle.
LIVE_MAX_AGE_S = 6 * 3600.0


def progress_path(path: str | None = None) -> str:
    """Resolve the progress-file path: explicit arg, then
    ``$PIO_PROGRESS_FILE``, then the daemon run dir."""
    if path:
        return os.fspath(path)
    env = os.environ.get("PIO_PROGRESS_FILE")
    if env:
        return env
    run_dir = os.path.expanduser(os.environ.get("PIO_RUN_DIR", "~/.pio_tpu/run"))
    return os.path.join(run_dir, PROGRESS_FILENAME)


class ProgressPublisher:
    """Publishes per-segment training progress atomically.

    ``publish(iteration, ...)`` rewrites the whole document each call —
    readers either see the previous complete snapshot or the new one,
    never a torn write. Typical cost is one tiny file write per
    checkpoint segment (seconds apart); bench obs/device gates it.
    """

    def __init__(
        self,
        total_iterations: int,
        path: str | None = None,
        tol: float = 0.0,
        **static,
    ) -> None:
        self.path = progress_path(path)
        self.total_iterations = int(total_iterations)
        self.configured_iterations = int(total_iterations)
        self.tol = float(tol or 0.0)
        self.early_stopped = False
        self.started_at = time.time()
        self.rmse_trajectory: list[float] = []
        self._static = static
        self.enabled = _metrics.enabled()

    def publish(
        self,
        iteration: int,
        *,
        state: str = "running",
        rmse: float | None = None,
        events_per_s: float | None = None,
        segment_wall_s: float | None = None,
        checkpoint_epoch: int | None = None,
    ) -> None:
        if not self.enabled:
            return
        if rmse is not None:
            self.rmse_trajectory.append(round(float(rmse), 6))
        now = time.time()
        elapsed = now - self.started_at
        eta_s = None
        if 0 < iteration < self.total_iterations and elapsed > 0:
            eta_s = round(
                elapsed / iteration * (self.total_iterations - iteration), 1
            )
        doc = {
            "state": state,
            "pid": os.getpid(),
            "started_at": round(self.started_at, 3),
            "updated_at": round(now, 3),
            "iteration": int(iteration),
            "total_iterations": self.total_iterations,
            "configured_iterations": self.configured_iterations,
            # under --tol the run may plateau out before the configured
            # count, so total/eta are upper bounds, not predictions
            "tol": self.tol or None,
            "eta_is_bound": bool(
                self.tol > 0 and state == "running" and eta_s is not None
            ),
            "early_stopped": self.early_stopped,
            "rmse": self.rmse_trajectory or None,
            "events_per_s": (
                round(float(events_per_s), 1) if events_per_s else None
            ),
            "segment_wall_s": (
                round(float(segment_wall_s), 3)
                if segment_wall_s is not None
                else None
            ),
            "eta_s": eta_s,
            "checkpoint_epoch": checkpoint_epoch,
        }
        doc.update(self._static)
        try:
            self._write_atomic(doc)
        except OSError:
            logger.debug("progress publish failed", exc_info=True)

    def done(
        self, iteration: int | None = None, early_stopped: bool = False,
        **final,
    ) -> None:
        """Terminal publish. ``early_stopped`` (a --tol plateau) pins
        ``total_iterations`` to the iteration actually reached, so the
        final document reports the true count instead of the stale
        configured one. ``final`` adds keys known only at the end (the
        run's kernel launches) to the terminal document."""
        self._static.update(final)
        if early_stopped and iteration is not None:
            self.early_stopped = True
            self.total_iterations = int(iteration)
        self.publish(
            iteration if iteration is not None else self.total_iterations,
            state="done",
        )

    def _write_atomic(self, doc: dict) -> None:
        directory = os.path.dirname(self.path) or "."
        os.makedirs(directory, exist_ok=True)
        fd, tmp = tempfile.mkstemp(
            prefix=".progress.", suffix=".tmp", dir=directory
        )
        try:
            with os.fdopen(fd, "w") as fh:
                json.dump(doc, fh, separators=(",", ":"))
                fh.flush()
                os.fsync(fh.fileno())
            os.replace(tmp, self.path)
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise


def read_progress(path: str | None = None) -> dict | None:
    """Read the current progress document, or None when absent or
    unparseable (a torn write is impossible by construction; a corrupt
    file from an older crash just reads as no-progress)."""
    try:
        with open(progress_path(path), "r") as fh:
            doc = json.load(fh)
    except (OSError, ValueError):
        return None
    return doc if isinstance(doc, dict) else None


def is_live(doc: dict | None, max_age_s: float = LIVE_MAX_AGE_S) -> bool:
    """True when the document describes a still-running training: the
    writer pid exists and the last update is fresh."""
    if not doc or doc.get("state") != "running":
        return False
    updated = doc.get("updated_at")
    if not isinstance(updated, (int, float)):
        return False
    if time.time() - updated > max_age_s:
        return False
    pid = doc.get("pid")
    if not isinstance(pid, int) or pid <= 0:
        return False
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    except PermissionError:
        return True
    except OSError:
        return False
    return True
