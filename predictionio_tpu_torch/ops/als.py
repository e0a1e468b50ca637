"""ALS factor tables: int8 storage and the table helpers serving needs.

The serving subset of ``predictionio_tpu/ops/als.py:591-645``. A factor
table is either a dense ``[N, D]`` tensor (float32 or bfloat16) or, for
``storage_dtype="int8"``, the pair ``(values int8 [N, D], scales
float32 [N])`` with ``row_f32 = values * scales[:, None]`` -- per-row
max-abs/127 symmetric quantization. The arithmetic is the JAX package's,
operation for operation, so both packages quantize to the same bytes.

Training (bucket layout, solves, ``als_train``) is the next slice.
"""

from __future__ import annotations

import numpy as np
import torch

from predictionio_tpu_torch.models.modelfile import tensor_to_numpy

# ops/als.py DEFAULT_BUCKETS: the template's ``bucket_widths`` default
DEFAULT_BUCKETS = (8, 32, 128, 512, 2048)


def quantize_rows(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """f32 factors ``[..., N, D]`` -> ``(int8 [..., N, D], f32 [..., N])``
    per-row scales. All-zero rows get scale 1 (quantize to exact zeros)."""
    x = x.to(torch.float32)
    scale = x.abs().amax(dim=-1) / 127.0
    scale = torch.where(scale > 0, scale, torch.ones_like(scale))
    q = torch.round(x / scale[..., None]).to(torch.int8)
    return q, scale


def dequantize_rows(q: torch.Tensor, scale: torch.Tensor,
                    dt: torch.dtype = torch.float32) -> torch.Tensor:
    """Inverse of :func:`quantize_rows` in dtype ``dt``."""
    return q.to(dt) * scale[..., None].to(dt)


def host_factors(table) -> tuple[np.ndarray, np.ndarray | None]:
    """Factor table -> host arrays ``(values, scales)``: scales is the
    [N] f32 per-row array for the int8 pair, None for dense dtypes.
    bfloat16 values come back as :data:`~predictionio_tpu_torch.models.
    modelfile.BFLOAT16` (numpy has no bfloat16 of its own)."""
    if isinstance(table, tuple):
        return tensor_to_numpy(table[0]), tensor_to_numpy(table[1])
    return tensor_to_numpy(table), None


def table_rows(table) -> int:
    """Row count of a factor table in either representation."""
    return (table[0] if isinstance(table, tuple) else table).shape[0]


def table_dim(table) -> int:
    """Factor dimension (rank) of a table in either representation."""
    return (table[0] if isinstance(table, tuple) else table).shape[1]
