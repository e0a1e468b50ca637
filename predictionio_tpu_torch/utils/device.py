"""Device selection for the port's entry points.

Entry points take an explicit device and pass it down; nothing sets a
global default device. ``None`` means CUDA: on a machine without one
that is an error, never a silent run on the CPU. The CPU is used only
when asked for (``"cpu"``), which is how the tests run the kernels'
plain versions.
"""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``None``/``"cuda"``/``"cuda:N"``/``"cpu"`` -> a ``torch.device``.

    Raises RuntimeError when CUDA is asked for (explicitly or by default)
    and absent. On CUDA it also turns TF32 off for matmuls and cuDNN, so
    float32 stays float32 on the card."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' (--device cpu) "
                "to run on the CPU"
            )
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev
