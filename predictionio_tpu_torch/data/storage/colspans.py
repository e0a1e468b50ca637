"""Shared span->array decoder: one implementation from log bytes to
numpy columns, used by the columnar segment cache's cold build
(:mod:`columnar_cache`), ``pio import``'s parse step
(:func:`parse_events`), and the speed layer's columnar tail path
(:func:`decode_tail`).

The write side of ingest already moves bytes at wire speed; the read
side used to re-materialize an :class:`Event` dataclass per line that
every consumer immediately flattened back into arrays. This module is
the Tensor Casting-shaped fix (arxiv 2010.13100): decode storage bytes
straight into the array layout the consumer wants — dense user/item
indices, a resolved float rating, epoch timestamps — reusing the native
scanner's span primitives (``scan_events``/``index_spans``/
``parse_times``/``extract_number``) so no per-record Python object is
ever built on the common path.

Semantics never change: :func:`decode_tail` carries a per-line shape
classifier whose keep-mask mirrors ``native.load_ratings_jsonl`` (the
dependency-free oracle the parity tests compare against) bit for bit,
and every line the classifier can't take — scanner-fallback syntax,
properties-rich ``$set``/``$unset`` shapes, non-rate events, missing
ids, unresolvable ratings — is routed to the existing object path by
line number, not dropped.

Port of ``predictionio_tpu/data/storage/colspans.py``, copied whole:
``import`` decodes through :func:`parse_events`, and the tailer's
columnar poll through :func:`decode_tail`.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from predictionio_tpu_torch import native

# int64-microsecond sentinel for rows without a parseable eventTime
# (the single definition; columnar_cache re-exports it)
TIME_ABSENT = np.int64(np.iinfo(np.int64).min)


@dataclasses.dataclass(frozen=True)
class DecodeConfig:
    """The rating-extraction shape the tail classifier keeps. Field
    meanings match ``realtime.foldin.FoldInConfig`` (the speed layer
    derives one from the other), but this module stays a storage-layer
    leaf: no realtime imports."""

    event_names: tuple[str, ...] = ("rate", "buy")
    rating_key: str | None = "rating"
    default_ratings: dict | None = None
    override_ratings: dict | None = None
    entity_type: str = "user"
    target_entity_type: str = "item"


def resolve_ratings(
    ratings: np.ndarray,
    ev_idx: np.ndarray,
    ev_names: list[str],
    default_ratings: dict | None,
    override_ratings: dict | None,
) -> np.ndarray:
    """Default/override resolution over extracted rating values, in
    float64 — the exact ``native.load_ratings_jsonl`` rule (defaults
    fill NaN; overrides force per event name). Shared by the columnar
    cache's :meth:`~columnar_cache.ColumnarBlocks.ratings` and the tail
    classifier so all array paths resolve identically."""
    ratings = np.asarray(ratings, dtype=np.float64)
    if default_ratings and len(ev_names):
        defaults = np.array(
            [default_ratings.get(name, np.nan) for name in ev_names],
            dtype=np.float64,
        )
        line_default = np.where(
            ev_idx >= 0, defaults[np.clip(ev_idx, 0, None)], np.nan
        )
        ratings = np.where(np.isnan(ratings), line_default, ratings)
    if override_ratings and len(ev_names):
        forced = np.array(
            [override_ratings.get(name, np.nan) for name in ev_names],
            dtype=np.float64,
        )
        line_forced = np.where(
            ev_idx >= 0, forced[np.clip(ev_idx, 0, None)], np.nan
        )
        ratings = np.where(np.isnan(line_forced), ratings, line_forced)
    return ratings


def decode_columns(buf: bytes, rating_key: str | None, scanned=None):
    """Filter-agnostic columns for one scanned buffer — the columnar
    cache's cold-build decode. Returns ``(cols, names)`` or None when
    any line needs the json fallback (the cache only ever holds fully
    span-decodable logs)."""
    if scanned is None:
        scanned = native.scan_events(buf)
    if ((scanned.flags & native.FLAG_FALLBACK) != 0).any():
        return None
    keep = (scanned.flags & native.FLAG_EMPTY) == 0
    offs = scanned.offs[keep]
    lens = scanned.lens[keep]

    cols: dict[str, np.ndarray] = {}
    names: dict[str, list[str]] = {}
    for col, field, dict_name in (
        ("ent_code", native.F_ENTITY_ID, "ent"),
        ("tgt_code", native.F_TARGET_ENTITY_ID, "tgt"),
        ("ev_code", native.F_EVENT, "ev"),
        ("etype_code", native.F_ENTITY_TYPE, "etype"),
        ("ttype_code", native.F_TARGET_ENTITY_TYPE, "ttype"),
    ):
        idx, ids = native.index_spans(buf, offs[:, field], lens[:, field])
        cols[col] = idx
        names[dict_name] = ids
    if rating_key is None:
        cols["rating"] = np.full(len(offs), np.nan, dtype=np.float32)
    else:
        cols["rating"] = native.extract_number(
            buf, offs[:, native.F_PROPERTIES], lens[:, native.F_PROPERTIES],
            rating_key,
        ).astype(np.float32)
    t = native.parse_times(
        buf, offs[:, native.F_EVENT_TIME], lens[:, native.F_EVENT_TIME]
    )
    with np.errstate(invalid="ignore"):
        cols["time_us"] = np.where(
            np.isnan(t), TIME_ABSENT, (t * 1e6)
        ).astype(np.int64)
    return cols, names


def parse_events(data: bytes, scanned=None) -> list:
    """JSONL buffer -> list[Event] — the object-path decode, routed
    through here so import, tailer fallback, and tests share one entry
    (``scanned`` reuses a prior scan of the same bytes)."""
    return native.parse_events_jsonl(data, scanned=scanned)


def _dense_select(
    codes: np.ndarray, ids: list[str]
) -> tuple[np.ndarray, list[str]]:
    """Re-compact a dense code column after rows were dropped:
    first-appearance rank remap (the order ``index_spans`` would have
    assigned over the surviving rows)."""
    uniq, first, inv = np.unique(codes, return_index=True, return_inverse=True)
    order = np.argsort(first, kind="stable")
    rank = np.empty(len(uniq), dtype=np.int32)
    rank[order] = np.arange(len(uniq), dtype=np.int32)
    return (
        rank[inv].astype(np.int32, copy=False),
        [ids[c] for c in uniq[order]],
    )


@dataclasses.dataclass
class ColumnarTail:
    """One polled chunk's rate-shaped rows as arrays, plus the line
    numbers the classifier routed to the object path.

    ``user_idx``/``item_idx`` densely index ``user_ids``/``item_ids``
    in first-appearance order; ``ratings`` are fully resolved float64;
    ``creation_ts`` are epoch seconds (NaN when the line carried no
    creationTime); ``event_ids`` align 1:1 with the kept rows for the
    tailer's seen-id dedupe (None when the line had no eventId)."""

    user_idx: np.ndarray
    user_ids: list[str]
    item_idx: np.ndarray
    item_ids: list[str]
    ratings: np.ndarray
    creation_ts: np.ndarray
    event_ids: list
    fallback_lines: np.ndarray

    @property
    def n_rows(self) -> int:
        return len(self.ratings)

    def select(self, keep: np.ndarray) -> "ColumnarTail":
        """A new tail with only ``keep``-masked rows (the tailer's
        duplicate-drop path); dense indices re-compact so downstream
        bincounts stay minimal."""
        user_idx, user_ids = _dense_select(self.user_idx[keep], self.user_ids)
        item_idx, item_ids = _dense_select(self.item_idx[keep], self.item_ids)
        kept = np.flatnonzero(keep)
        return ColumnarTail(
            user_idx=user_idx,
            user_ids=user_ids,
            item_idx=item_idx,
            item_ids=item_ids,
            ratings=self.ratings[keep],
            creation_ts=self.creation_ts[keep],
            event_ids=[self.event_ids[i] for i in kept],
            fallback_lines=self.fallback_lines,
        )


def decode_tail(
    chunk: bytes, cfg: DecodeConfig, scanned=None
) -> ColumnarTail:
    """Classify + decode one line-complete chunk for the tail path.

    The keep-mask is ``native.load_ratings_jsonl``'s, verbatim: clean
    scan, both id spans present, entity/target types match, event name
    allowed, rating resolvable (property -> default, override forces).
    Everything else that isn't blank lands in ``fallback_lines`` for
    the per-line object parser — so a mixed stream (rate events
    interleaved with ``$set`` payloads) splits losslessly."""
    if scanned is None:
        scanned = native.scan_events(chunk)
    n = len(scanned)
    keep = (scanned.flags == 0) & (
        scanned.offs[:, native.F_ENTITY_ID] >= 0
    ) & (scanned.offs[:, native.F_TARGET_ENTITY_ID] >= 0)
    keep &= native._span_type_mask(
        scanned, native.F_ENTITY_TYPE, cfg.entity_type
    )
    keep &= native._span_type_mask(
        scanned, native.F_TARGET_ENTITY_TYPE, cfg.target_entity_type
    )
    ev_idx, ev_names = native.index_spans(
        chunk, scanned.offs[:, native.F_EVENT], scanned.lens[:, native.F_EVENT]
    )
    allowed = np.array(
        [name in set(cfg.event_names) for name in ev_names], dtype=bool
    )
    if len(allowed):
        keep &= (ev_idx >= 0) & allowed[np.clip(ev_idx, 0, None)]
    else:
        keep &= False

    if cfg.rating_key is None:
        ratings = np.full(n, np.nan, dtype=np.float64)
    else:
        ratings = native.extract_number(
            chunk, scanned.offs[:, native.F_PROPERTIES],
            scanned.lens[:, native.F_PROPERTIES], cfg.rating_key,
        )
    ratings = resolve_ratings(
        ratings, ev_idx, ev_names, cfg.default_ratings, cfg.override_ratings
    )
    keep &= ~np.isnan(ratings)

    fallback = np.flatnonzero(
        ~keep & ((scanned.flags & native.FLAG_EMPTY) == 0)
    )
    kept = np.flatnonzero(keep)
    user_idx, user_ids = native.index_spans(
        chunk, scanned.offs[kept, native.F_ENTITY_ID],
        scanned.lens[kept, native.F_ENTITY_ID],
    )
    item_idx, item_ids = native.index_spans(
        chunk, scanned.offs[kept, native.F_TARGET_ENTITY_ID],
        scanned.lens[kept, native.F_TARGET_ENTITY_ID],
    )
    creation_ts = native.parse_times(
        chunk, scanned.offs[kept, native.F_CREATION_TIME],
        scanned.lens[kept, native.F_CREATION_TIME],
    )
    eo = scanned.offs[kept, native.F_EVENT_ID].tolist()
    el = scanned.lens[kept, native.F_EVENT_ID].tolist()
    event_ids = [
        chunk[o : o + ln].decode("utf-8") if o >= 0 else None
        for o, ln in zip(eo, el)
    ]
    return ColumnarTail(
        user_idx=user_idx,
        user_ids=user_ids,
        item_idx=item_idx,
        item_ids=item_ids,
        ratings=ratings[kept],
        creation_ts=creation_ts,
        event_ids=event_ids,
        fallback_lines=fallback,
    )
