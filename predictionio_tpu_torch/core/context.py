"""WorkflowContext: the execution-substrate handle passed through DASE.

Port of ``predictionio_tpu/core/context.py``. Where the JAX context owns
a device mesh, this one carries the ``torch.device`` the run uses; it is
resolved once (``utils/device.py``: CUDA unless the caller asks for the
CPU) and passed down, never set as a global default.
"""

from __future__ import annotations

from typing import Any

import torch

from predictionio_tpu_torch.utils.device import resolve_device


class WorkflowContext:
    """Execution context for one train/eval/serve run."""

    def __init__(
        self,
        mode: str = "",
        batch: str = "",
        runtime_conf: dict[str, Any] | None = None,
        device: str | torch.device | None = None,
    ):
        self.mode = mode
        self.batch = batch
        self.runtime_conf = dict(runtime_conf or {})
        self.device = resolve_device(device)
