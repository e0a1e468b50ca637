"""Shared serve-time helpers for the cosine-scoring templates.

Port of ``predictionio_tpu/models/filters.py``. The self/whiteList/
blackList exclusion semantics are common to the similar-product,
recommended-user, and e-commerce templates (reference
examples/scala-parallel-similarproduct/multi/src/main/scala/
ALSAlgorithm.scala:193-244 and the recommended-user variant): query
entities are never recommended back, a whitelist restricts candidates to
its members, a blacklist removes its members.

The normalization runs on the host in numpy, operation for operation as
the JAX package runs it, so both packages put the same catalog bits on
their devices; the result goes to the ``torch.device`` the caller names.
"""

from __future__ import annotations

from typing import Iterable, Sequence

import numpy as np
import torch

from predictionio_tpu_torch.data.bimap import BiMap
from predictionio_tpu_torch.models.modelfile import BFLOAT16, host_array


def _host_values(factors: np.ndarray) -> np.ndarray:
    """Host factors as numpy arithmetic sees them in the JAX package: a
    bfloat16 table (``ml_dtypes`` there, :data:`BFLOAT16` bits here) is
    not an inexact numpy type, so ``np.linalg.norm`` and the division
    take it in float64; any other dtype is taken as it is."""
    a = host_array(np.asarray(factors))
    if a.dtype == BFLOAT16:
        bits = a.view(np.uint16).astype(np.uint32) << 16
        return bits.view(np.float32).astype(np.float64)
    return a


def normalized_device_factors(factors: np.ndarray, scales=None,
                              device: torch.device | str = "cpu"):
    """Row-normalize factors, place them on ``device``, and return
    ``(table, norms)`` (dot == cosine against ``table`` after this). The
    cosine-scoring models cache both per process.

    Dense storage: ``table`` is the float32 [I, D] row-normalized tensor
    (a bfloat16 model is normalized in float64 and rounded to float32, as
    the JAX package's host arithmetic does). int8 storage (``scales`` is
    the per-row f32 scale vector): cosine is invariant to the positive
    per-row scale, so normalization folds INTO the scale -- ``table`` is
    the (int8 values, f32 1/||values||) pair, which dequantizes to unit
    rows while keeping the device catalog 4x smaller than dense
    (``ops/topk.py`` scores the pair without densifying).

    ``norms`` is the [I] f32 tensor of stored-row norms."""
    if scales is not None:
        vals = np.asarray(factors)
        n = np.linalg.norm(vals.astype(np.float32), axis=1)
        inv = (1.0 / np.maximum(n, 1e-12)).astype(np.float32)
        return (
            (torch.from_numpy(np.array(vals)).to(device),
             torch.from_numpy(inv).to(device)),
            torch.from_numpy(n.astype(np.float32)).to(device),
        )
    values = _host_values(factors)
    norms = np.linalg.norm(values, axis=1, keepdims=True)
    table = (values / np.maximum(norms, 1e-12)).astype(np.float32)
    return (
        torch.from_numpy(table).to(device),
        torch.from_numpy(norms[:, 0].astype(np.float32)).to(device),
    )


def normalized_query_vectors(
    factors: np.ndarray, scales, row_ixs: np.ndarray, row_weights: np.ndarray
) -> np.ndarray:
    """Host-side [B, D] weighted sums of row-normalized catalog rows --
    the cosine templates' query vectors for the coarse shortlist pass of
    two-stage retrieval (the gathers are [B, L], so host math is cheaper
    than a device round-trip; the exact rescore rebuilds them on the
    device regardless, so this copy never touches final scores)."""
    rows = _host_values(factors)[row_ixs].astype(np.float32)  # [B, L, D]
    del scales  # cosine drops the positive per-row scale
    n = np.linalg.norm(rows, axis=2, keepdims=True)
    rows = rows / np.maximum(n, 1e-12)
    return (rows * np.asarray(row_weights, np.float32)[..., None]).sum(axis=1)


def entity_exclusion_mask(
    index: BiMap,
    self_entities: Iterable[str],
    white_list: Sequence[str] | None,
    black_list: Sequence[str] | None,
) -> np.ndarray:
    """[len(index)] bool mask; True = candidate may never be returned."""
    n = len(index)
    mask = np.zeros(n, dtype=bool)
    for ent in self_entities:
        if ent in index:
            mask[index[ent]] = True
    if white_list is not None:
        allowed = {index[e] for e in white_list if e in index}
        mask |= ~np.isin(np.arange(n), list(allowed))
    if black_list:
        for ent in black_list:
            if ent in index:
                mask[index[ent]] = True
    return mask
