"""Incremental ALS fold-in: solve touched user rows against fixed items.

Port of ``predictionio_tpu/realtime/foldin.py``. One ALS half-step
already solves every user row in closed form against the current item
factors (the ALX observation, arxiv 2112.02194), and that per-row least
squares is the "fold a new or changed user in without retraining"
primitive. The fold runs it on K1 (``ops/als.py
solve_bucket_explicit``, a float32 solve whatever the storage dtype) for
the users touched by tailed rating events:

- each touched user's FULL rating history is re-read from the event
  store (the new events are already ingested there), so the solve is
  the exact half-step the next retrain would take for that row;
- item factors stay fixed; the solve reads the served model's item
  table on the card (``device_factors``), int8 dequantized at the
  gather as in training, and uploads only the bucket arrays;
- the touched rows are grouped by the power of two of their own history
  length (floor 8), one unsegmented K1 bucket per width, rows in the JAX
  package's order within each: per row the same arithmetic as the JAX
  package's one ``(pow2(B), pow2(max history))`` bucket (a warp walks the
  row's entries in order; padding adds exact zeros), without padding a
  few thousand ratings to one heavy user's width
  (:func:`grouped_buckets`; :func:`padded_bucket` is the JAX layout);
- on CUDA the launches go on a stream of the fold's own, synchronized
  before the patch, so a query's launches never queue behind a fold;
- solved rows are written back on the host in the model's storage dtype
  exactly as the JAX package does: f32/bf16 cast, or int8 requantized
  with a fresh per-row scale; brand-new users are appended to the factor
  table and the id index;
- events naming items unseen at train time cannot be solved against (no
  factor row); they accumulate in ``cold_items`` (count + rating sum) as
  cold-start stats for the next retrain.

The patched model SHARES the item arrays with the old model, and on the
card its item table and coarse catalog too; its user table is uploaded
here, in the fold's thread, so the server's swap stays a pointer flip
under its lock. The fold never mutates served state. There is no
fallback: a K1 that fails to build or launch fails the fold.
"""

from __future__ import annotations

import contextlib
import dataclasses
import logging

import numpy as np
import torch

from predictionio_tpu_torch.data.bimap import BiMap
from predictionio_tpu_torch.data.event import Event
from predictionio_tpu_torch.models.modelfile import numpy_to_tensor
from predictionio_tpu_torch.models.recommendation import ALSModel
from predictionio_tpu_torch.ops import als as als_ops
from predictionio_tpu_torch.utils.device import resolve_device

logger = logging.getLogger(__name__)


@dataclasses.dataclass(frozen=True)
class FoldInConfig:
    """Rating-extraction + solve parameters; must match the deployed
    engine's datasource/algorithm params so the fold-in solves the same
    problem the batch trainer does (SpeedLayer derives one from the
    server's EngineParams)."""

    event_names: tuple[str, ...] = ("rate", "buy")
    rating_key: str | None = "rating"
    default_ratings: dict | None = None
    override_ratings: dict | None = None
    entity_type: str = "user"
    target_entity_type: str = "item"
    reg: float = 0.01
    weighted_reg: bool = True


@dataclasses.dataclass
class FoldInStats:
    """What one fold() call did."""

    events: int = 0
    rating_events: int = 0
    users_touched: int = 0
    users_added: int = 0
    users_skipped: int = 0  # touched but no trainable pairs
    cold_item_events: int = 0


def _pow2(n: int, floor: int = 1) -> int:
    out = floor
    while out < n:
        out *= 2
    return out


def _fill(pairs, B: int, K: int):
    """``(col_ids, ratings, mask)`` ``[B, K]`` of rows ``pairs`` (each a
    list of ``(item index, rating)``), zero-padded."""
    col_ids = np.zeros((B, K), dtype=np.int32)
    ratings = np.zeros((B, K), dtype=np.float32)
    mask = np.zeros((B, K), dtype=np.float32)
    for i, p in enumerate(pairs):
        if p:
            ix, v = zip(*p)
            col_ids[i, :len(p)] = ix
            ratings[i, :len(p)] = v
            mask[i, :len(p)] = 1.0
    return col_ids, ratings, mask


def padded_bucket(pairs):
    """The JAX package's fold layout: every row in one ``(pow2(B),
    pow2(max history, floor 8))`` bucket. Returns ``(col_ids, ratings,
    mask)``; row i is ``pairs[i]``."""
    B = _pow2(len(pairs))
    K = _pow2(max(len(p) for p in pairs), floor=8)
    return _fill(pairs, B, K)


def grouped_buckets(pairs) -> list[tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]]:
    """The port's fold layout: rows grouped by ``pow2(len(history),
    floor 8)``, widths ascending, rows in ``pairs``' order within a
    group. Returns ``[(rows, col_ids, ratings, mask)]``: ``rows`` int64
    indices into ``pairs``, the arrays ``[len(rows), width]``."""
    widths = np.array([_pow2(len(p), floor=8) for p in pairs], dtype=np.int64)
    out = []
    for K in np.unique(widths):
        rows = np.flatnonzero(widths == K)
        out.append((rows, *_fill([pairs[i] for i in rows], len(rows), int(K))))
    return out


class ALSFoldIn:
    """Folds batches of rating events into an ALSModel's user table, on
    ``device`` (CUDA unless the CPU is asked for)."""

    def __init__(
        self,
        events,
        app_id: int,
        channel_id: int | None = None,
        config: FoldInConfig | None = None,
        device: str | torch.device | None = None,
    ):
        self._events = events
        self._app_id = app_id
        self._channel_id = channel_id
        self.config = config or FoldInConfig()
        self.device = resolve_device(device)
        # item id -> [event count, rating sum]; unseen-at-train items
        self.cold_items: dict[str, list] = {}
        # the fold's own CUDA stream, made at the first solve on the card
        self._stream: torch.cuda.Stream | None = None

    # -- rating extraction (mirrors base.Events.scan_ratings) ---------------

    def _rating_of(self, e: Event) -> float | None:
        cfg = self.config
        if e.event not in cfg.event_names:
            return None
        if e.entity_type != cfg.entity_type:
            return None
        if e.target_entity_type != cfg.target_entity_type:
            return None
        if e.target_entity_id is None:
            return None
        v = (cfg.override_ratings or {}).get(e.event)
        if v is None:
            v = (
                e.properties.to_dict().get(cfg.rating_key)
                if cfg.rating_key is not None
                else None
            )
            if not isinstance(v, (int, float)) or isinstance(v, bool):
                v = (cfg.default_ratings or {}).get(e.event)
        if v is None:
            return None
        return float(v)

    # -- history reads ------------------------------------------------------

    def _histories(self, touched: list[str]) -> dict[str, list[Event]]:
        """Full rating-event history per touched user, including the
        events that triggered this fold (they are already ingested)."""
        cfg = self.config
        out: dict[str, list[Event]] = {u: [] for u in touched}
        if getattr(self._events, "entity_indexed", False):
            for uid in touched:
                out[uid] = self._events.find(
                    self._app_id,
                    self._channel_id,
                    entity_type=cfg.entity_type,
                    entity_id=uid,
                    event_names=list(cfg.event_names),
                    target_entity_type=cfg.target_entity_type,
                )
            return out
        # replay backends: one bulk scan amortizes across the batch
        touched_set = set(touched)
        for e in self._events.find(
            self._app_id,
            self._channel_id,
            entity_type=cfg.entity_type,
            event_names=list(cfg.event_names),
            target_entity_type=cfg.target_entity_type,
        ):
            if e.entity_id in touched_set:
                out[e.entity_id].append(e)
        return out

    # -- the fold -----------------------------------------------------------

    def fold(
        self, model: ALSModel, events: list[Event]
    ) -> tuple[ALSModel | None, FoldInStats]:
        """Fold a batch of tailed events into ``model``.

        Returns ``(patched_model, stats)`` -- patched_model is ``None``
        when the batch contained nothing foldable (stats says why). The
        input model is never mutated."""
        stats = FoldInStats(events=len(events))
        touched: list[str] = []
        touched_set: set[str] = set()
        self._collect_events(model, events, stats, touched, touched_set)
        if not touched:
            return None, stats
        return self._fold_touched(model, touched, stats)

    def fold_in_columnar(
        self, model: ALSModel, batch
    ) -> tuple[ALSModel | None, FoldInStats]:
        """Fold one :class:`~realtime.tailer.TailedBatch` -- columnar
        array segments and object-path Event segments, in delivery order
        -- without constructing an Event for any columnar row.

        The columnar rows were already shape-classified by the decoder
        (``colspans.decode_tail`` keeps exactly what :meth:`_rating_of`
        would accept), so collection reduces to touched-user and
        cold-item accumulation over arrays; the solve and patch are the
        same K1 path :meth:`fold` takes, hence bit-identical rows for
        every storage dtype."""
        stats = FoldInStats(events=batch.n_events)
        touched: list[str] = []
        touched_set: set[str] = set()
        for seg in batch.segments:
            if isinstance(seg, list):
                self._collect_events(model, seg, stats, touched, touched_set)
            else:
                self._collect_columnar(model, seg, stats, touched, touched_set)
        if not touched:
            return None, stats
        return self._fold_touched(model, touched, stats)

    def _collect_events(
        self, model, events, stats, touched, touched_set
    ) -> None:
        for e in events:
            v = self._rating_of(e)
            if v is None:
                continue
            stats.rating_events += 1
            if e.target_entity_id not in model.item_index:
                acc = self.cold_items.setdefault(e.target_entity_id, [0, 0.0])
                acc[0] += 1
                acc[1] += v
                stats.cold_item_events += 1
            if e.entity_id not in touched_set:
                touched_set.add(e.entity_id)
                touched.append(e.entity_id)

    def _collect_columnar(
        self, model, tail, stats, touched, touched_set
    ) -> None:
        n = tail.n_rows
        if n == 0:
            return
        stats.rating_events += n
        # cold-item accumulation per distinct item: the per-event loop's
        # counts and sums, from bincounts
        counts = np.bincount(tail.item_idx, minlength=len(tail.item_ids))
        sums = np.bincount(
            tail.item_idx, weights=tail.ratings,
            minlength=len(tail.item_ids),
        )
        for j, iid in enumerate(tail.item_ids):
            if iid in model.item_index:
                continue
            acc = self.cold_items.setdefault(iid, [0, 0.0])
            acc[0] += int(counts[j])
            acc[1] += float(sums[j])
            stats.cold_item_events += int(counts[j])
        for uid in tail.user_ids:  # first-appearance order, like events
            if uid not in touched_set:
                touched_set.add(uid)
                touched.append(uid)

    def touched_pairs(
        self, model: ALSModel, touched: list[str], stats: FoldInStats
    ) -> tuple[list[str], list[list[tuple[int, float]]]]:
        """The solvable touched users and each one's ``(item index,
        rating)`` history (replay order, last write wins; cold items
        dropped), from a re-read of the store."""
        histories = self._histories(touched)
        users: list[str] = []
        pairs: list[list[tuple[int, float]]] = []
        for uid in touched:
            seen: dict[int, float] = {}
            for e in histories.get(uid, ()):
                v = self._rating_of(e)
                if v is None:
                    continue
                ix = model.item_index.get(e.target_entity_id)
                if ix is None:
                    continue  # cold item: no factor row to solve against
                seen[ix] = v  # replay order: last write wins
            if not seen:
                stats.users_skipped += 1
                continue
            users.append(uid)
            pairs.append(list(seen.items()))
        return users, pairs

    def _fold_touched(
        self, model: ALSModel, touched: list[str], stats: FoldInStats
    ) -> tuple[ALSModel | None, FoldInStats]:
        """History re-read + solve + patch for the touched users."""
        users, pairs = self.touched_pairs(model, touched, stats)
        stats.users_touched = len(users)
        if not users:
            return None, stats
        with self._on_stream():
            solved = self._solve(model, pairs)
            patched = self._patch(model, users, solved, stats)
            patched.carry_device(model, self.device)
        if self._stream is not None:
            self._stream.synchronize()
        return patched, stats

    def _on_stream(self):
        """On CUDA, the fold's own stream as the current stream."""
        if self.device.type != "cuda":
            return contextlib.nullcontext()
        if self._stream is None:
            self._stream = torch.cuda.Stream(self.device)
        return torch.cuda.stream(self._stream)

    def _solve(self, model: ALSModel, pairs) -> np.ndarray:
        """Closed-form f32 solve of the touched rows on K1, one launch
        group per width of :func:`grouped_buckets`, against the served
        model's item table on ``self.device``. Returns ``[len(pairs), D]``
        float32 on the host."""
        V = model.device_factors(self.device)[1]
        D = als_ops.table_dim(V)
        out = torch.empty((len(pairs), D), dtype=torch.float32, device=self.device)
        for rows, col_ids, ratings, mask in grouped_buckets(pairs):
            x = als_ops.solve_bucket_explicit(
                V, col_ids, ratings, mask, reg=self.config.reg,
                weighted_reg=self.config.weighted_reg, compute_dtype="float32",
            )
            out[torch.from_numpy(rows).to(self.device)] = x
        return out.cpu().numpy()

    def _patch(
        self,
        model: ALSModel,
        users: list[str],
        solved: np.ndarray,
        stats: FoldInStats,
    ) -> ALSModel:
        """New ALSModel with the solved rows written back (appending
        brand-new users); item arrays are shared, nothing is mutated.
        Host numpy, as the JAX package writes it."""
        index = model.user_index.to_dict()
        new_ids = [u for u in users if u not in index]
        for uid in new_ids:
            index[uid] = len(index)
        stats.users_added = len(new_ids)
        user_index = (
            model.user_index if not new_ids else BiMap(index)
        )

        uf = model.user_factors
        if model.user_scales is not None:
            # int8 storage: requantize each solved row with a fresh
            # per-row scale (quantize_rows semantics, host-side)
            sc = np.max(np.abs(solved), axis=1) / 127.0
            sc[sc <= 0] = 1.0
            q = np.round(solved / sc[:, None]).astype(np.int8)
            values = np.concatenate(
                [uf, np.zeros((len(new_ids), uf.shape[1]), dtype=uf.dtype)]
            )
            scales = np.concatenate(
                [
                    model.user_scales,
                    np.ones(len(new_ids), dtype=model.user_scales.dtype),
                ]
            )
            for i, uid in enumerate(users):
                ix = index[uid]
                values[ix] = q[i]
                scales[ix] = sc[i]
            return ALSModel(
                user_index=user_index,
                item_index=model.item_index,
                user_factors=values,
                item_factors=model.item_factors,
                user_scales=scales,
                item_scales=model.item_scales,
            )
        values = np.concatenate(
            [uf, np.zeros((len(new_ids), uf.shape[1]), dtype=uf.dtype)]
        )
        rows = _cast_rows(solved, uf.dtype)
        for i, uid in enumerate(users):
            values[index[uid]] = rows[i]
        return ALSModel(
            user_index=user_index,
            item_index=model.item_index,
            user_factors=values,
            item_factors=model.item_factors,
            user_scales=None,
            item_scales=model.item_scales,
        )

    def cold_start_stats(self) -> dict[str, dict]:
        """Accumulated unseen-item stats: id -> {events, mean_rating}."""
        return {
            iid: {"events": c, "mean_rating": s / c if c else 0.0}
            for iid, (c, s) in self.cold_items.items()
        }


def _cast_rows(solved: np.ndarray, dtype: np.dtype) -> np.ndarray:
    """Solved f32 rows in a dense table's dtype: bfloat16 (held as
    ``modelfile.BFLOAT16``) rounds to nearest even as numpy's
    ``astype(bfloat16)`` does in the JAX package."""
    if dtype.fields is None:
        return solved.astype(dtype)
    t = numpy_to_tensor(solved, torch.device("cpu")).to(torch.bfloat16)
    return t.view(torch.int16).numpy().view(dtype)
