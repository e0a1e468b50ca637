"""Binary columnar segment cache for the file-backed event stores.

Port of ``predictionio_tpu/data/storage/columnar_cache.py``, copied whole
with its imports rewritten: the files it writes are byte for byte
the JAX package's, so either package reads what the other wrote.

The jsonl/partitioned backends replay JSON rows; their ``scan_ratings``
fast path already parses the raw log natively, but every training read
still re-parses every byte. This module persists the *parse result* —
packed, dictionary-encoded numpy column blocks — next to each row log,
so a re-scan goes mmap -> arrays with zero per-event work (the ALX /
ads-infra observation: at 10^7-event scale the host input pipeline, not
the accelerator, bounds training wall-clock).

Design:

- One ``<log>.colcache`` file per source log file (a jsonl namespace
  log, a sealed partition segment, or a partition's active log). The
  row log stays the source of truth — the cache is derived data,
  rebuilt at will, and **durability is unchanged**: appends go to the
  row log first exactly as before; the cache is only ever written
  AFTER a scan proved the log replay-clean.
- Columns are filter-agnostic: entity/target/event-name/entity-type
  codes into per-file dictionaries, event times as int64 microseconds,
  and the ``rating_key`` property as float32 (NaN = absent). Only the
  rating column depends on a parameter, so the cache records which
  ``rating_key`` it extracted; a scan with a different key is a miss.
- Invalidation key: the source file's ``(mtime_ns, size)``, captured
  under the same lock as the bytes the blocks were built from. Any
  append (including a ``$delete`` marker) or compaction changes the
  stat, so a stale cache can never serve — no coordination needed.
- Publication is atomic (tmp + rename) and loads validate the magic,
  header, and block bounds; any corruption or truncation makes
  :func:`load` return None and the caller falls back to the row scan.
- Logs containing scanner-fallback lines (escaped ids, odd syntax) are
  not cached (:func:`build_blocks` returns None): the fallback rows
  would need per-line json anyway, and bailing keeps the cached path
  exactly equivalent to the vectorized native scan.

The decode in :meth:`ColumnarBlocks.ratings` reproduces
``native.load_ratings_jsonl`` semantics bit-for-bit on clean buffers
(same keep-mask, same default/override resolution in float64, same
first-appearance dense id order), so the row scan remains the
correctness oracle and the parity tests can require array equality.
"""

from __future__ import annotations

import json
import logging
import mmap
import os
from pathlib import Path

import numpy as np

from predictionio_tpu_torch import faults
from predictionio_tpu_torch.data.storage import colspans

logger = logging.getLogger(__name__)

MAGIC = b"PIOCOLC1"
SUFFIX = ".colcache"
_ALIGN = 64
# int64-microsecond sentinel for rows without a parseable eventTime
# (defined in colspans — the shared decoder — and re-exported here)
TIME_ABSENT = colspans.TIME_ABSENT

_FALSEY = ("0", "false", "no", "off")


def enabled(config: dict | None = None) -> bool:
    """Cache on/off: the ``columnar_cache`` storage-source property
    (``PIO_STORAGE_SOURCES_<NAME>_COLUMNAR_CACHE``), with the
    ``PIO_COLUMNAR_CACHE`` env var as a global kill switch."""
    env = os.environ.get("PIO_COLUMNAR_CACHE")
    if env is not None and env.strip().lower() in _FALSEY:
        return False
    v = (config or {}).get("columnar_cache")
    if v is None:
        return True
    return str(v).strip().lower() not in _FALSEY


def cache_path(source: Path) -> Path:
    return source.with_name(source.name + SUFFIX)


def drop(source: Path) -> None:
    """Remove the cache for a source log (compaction/remove hook)."""
    try:
        cache_path(source).unlink(missing_ok=True)
    except OSError:  # pragma: no cover - unlink race
        pass


def move(src: Path, dst: Path) -> None:
    """Carry a cache across a source rename (segment sealing renames
    ``active.jsonl`` to ``seg_NNNNNN.jsonl`` without changing its bytes,
    mtime, or size — the cache stays valid under its new name)."""
    try:
        cpath = cache_path(src)
        if cpath.exists():
            cpath.rename(cache_path(dst))
    except OSError:  # pragma: no cover - rename race
        drop(src)


# --------------------------------------------------------------------------
# build
# --------------------------------------------------------------------------

_ROW_BLOCKS = (
    ("ent_code", np.int32),
    ("tgt_code", np.int32),
    ("ev_code", np.int32),
    ("etype_code", np.int32),
    ("ttype_code", np.int32),
    ("rating", np.float32),
    ("time_us", np.int64),
)


def _build_chunk(buf: bytes, rating_key: str | None, scanned=None):
    """Columns for one scanned buffer, or None when any line needs the
    json fallback (the cache only ever holds fully span-decodable logs).
    The decode itself lives in :func:`colspans.decode_columns` — the
    same implementation the tailer's columnar poll and ``pio import``
    route through, so one set of parity tests covers all three."""
    return colspans.decode_columns(buf, rating_key, scanned=scanned)


def build_blocks(
    buf: bytes,
    rating_key: str | None = "rating",
    scanned=None,
    chunk_bytes: int | None = None,
):
    """Dictionary-encoded column blocks for a replay-clean log buffer.

    Returns ``{"n", "rating_key", columns..., "<dict>_ids": [str]}`` or
    None when the buffer can't be cached (fallback lines present — which
    includes degraded no-native mode, where every line is flagged).
    Large buffers build per line-aligned chunk so span tables stay
    O(chunk); chunk dictionaries merge through shared maps.
    """
    from predictionio_tpu_torch import native

    if chunk_bytes is None:
        chunk_bytes = native.SCAN_CHUNK_BYTES
    if len(buf) <= chunk_bytes:
        built = _build_chunk(buf, rating_key, scanned=scanned)
        if built is None:
            return None
        cols, names = built
        blocks = {"n": len(cols["ent_code"]), "rating_key": rating_key}
        blocks.update(cols)
        for d, ids in names.items():
            blocks[f"{d}_ids"] = ids
        return blocks

    maps: dict[str, dict[str, int]] = {
        d: {} for d in ("ent", "tgt", "ev", "etype", "ttype")
    }
    parts: dict[str, list[np.ndarray]] = {name: [] for name, _ in _ROW_BLOCKS}
    for chunk in native._line_aligned_chunks(buf, chunk_bytes):
        built = _build_chunk(chunk, rating_key)
        if built is None:
            return None
        cols, names = built
        for (col, d) in (
            ("ent_code", "ent"), ("tgt_code", "tgt"), ("ev_code", "ev"),
            ("etype_code", "etype"), ("ttype_code", "ttype"),
        ):
            m = maps[d]
            local = names[d]
            lut = np.fromiter(
                (m.setdefault(s, len(m)) for s in local),
                np.int32, len(local),
            )
            code = cols[col]
            if len(lut):
                cols[col] = np.where(
                    code >= 0, lut[np.clip(code, 0, None)], np.int32(-1)
                ).astype(np.int32)
        for name, _ in _ROW_BLOCKS:
            parts[name].append(cols[name])
    blocks = {"n": 0, "rating_key": rating_key}
    for name, dtype in _ROW_BLOCKS:
        blocks[name] = (
            np.concatenate(parts[name]).astype(dtype, copy=False)
            if parts[name] else np.empty(0, dtype)
        )
    blocks["n"] = len(blocks["ent_code"])
    for d, m in maps.items():
        blocks[f"{d}_ids"] = list(m)
    return blocks


def _encode_ids(ids: list[str]) -> tuple[np.ndarray, np.ndarray]:
    """utf-8 blob + [n+1] int64 offsets for one string dictionary."""
    enc = [s.encode("utf-8") for s in ids]
    offs = np.zeros(len(enc) + 1, dtype=np.int64)
    if enc:
        np.cumsum([len(b) for b in enc], out=offs[1:])
    blob = np.frombuffer(b"".join(enc), dtype=np.uint8).copy()
    return blob, offs


def store(
    path: Path,
    source_stat: tuple[int, int],
    blocks: dict,
) -> bool:
    """Atomically publish column blocks keyed by the source file's
    ``(mtime_ns, size)``. Best-effort: any OS error just means no cache
    (the row log stays authoritative)."""
    arrays: dict[str, np.ndarray] = {
        name: np.ascontiguousarray(blocks[name]) for name, _ in _ROW_BLOCKS
    }
    for d in ("ent", "tgt"):
        blob, offs = _encode_ids(blocks[f"{d}_ids"])
        arrays[f"{d}_blob"] = blob
        arrays[f"{d}_offs"] = offs
    header = {
        "mtime_ns": int(source_stat[0]),
        "size": int(source_stat[1]),
        "rating_key": blocks["rating_key"],
        "n": int(blocks["n"]),
        "ev_names": blocks["ev_ids"],
        "etype_names": blocks["etype_ids"],
        "ttype_names": blocks["ttype_ids"],
        "blocks": {},
    }
    offset = 0

    def _aligned(off: int) -> int:
        return (off + _ALIGN - 1) // _ALIGN * _ALIGN

    # lay out payload offsets relative to the end of the header; the
    # header's own length shifts them, so compute sizes first
    layout: list[tuple[str, np.ndarray, int]] = []
    for name, arr in arrays.items():
        offset = _aligned(offset)
        layout.append((name, arr, offset))
        offset += arr.nbytes
    for name, arr, off in layout:
        header["blocks"][name] = {
            "dtype": arr.dtype.str,
            "count": int(arr.size),
            "offset": off,  # relative; absolute = payload_base + offset
        }
    hdr = json.dumps(header).encode("utf-8")
    payload_base = _aligned(len(MAGIC) + 8 + len(hdr))
    tmp = path.with_name(path.name + f".tmp.{os.getpid()}")
    try:
        faults.fault_point("colcache.store")
        with open(tmp, "wb") as f:
            f.write(MAGIC)
            f.write(len(hdr).to_bytes(8, "little"))
            f.write(hdr)
            for name, arr, off in layout:
                f.seek(payload_base + off)
                f.write(arr.tobytes())
            f.flush()
            faults.fault_point("storage.fsync")
            os.fsync(f.fileno())
        faults.fault_point("storage.rename")
        tmp.replace(path)
        return True
    except OSError as e:  # pragma: no cover - disk full / perms
        logger.info("columnar cache not written (%s): %s", path, e)
        try:
            tmp.unlink(missing_ok=True)
        except OSError:
            pass
        return False


# --------------------------------------------------------------------------
# load + decode
# --------------------------------------------------------------------------


class ColumnarBlocks:
    """A loaded (mmap-backed) cache file. Arrays are read-only views
    into the mapping; the mapping stays valid even if the cache file is
    replaced on disk (rename keeps the mapped inode alive)."""

    def __init__(self, header: dict, mm, payload_base: int):
        self._header = header
        self._mm = mm
        self._base = payload_base
        self.n = int(header["n"])
        self.rating_key = header["rating_key"]
        self.ev_names: list[str] = header["ev_names"]
        self.etype_names: list[str] = header["etype_names"]
        self.ttype_names: list[str] = header["ttype_names"]

    def valid_for(self, source_stat: tuple[int, int]) -> bool:
        return (
            int(self._header["mtime_ns"]) == int(source_stat[0])
            and int(self._header["size"]) == int(source_stat[1])
        )

    def _arr(self, name: str) -> np.ndarray:
        spec = self._header["blocks"][name]
        return np.frombuffer(
            self._mm,
            dtype=np.dtype(spec["dtype"]),
            count=spec["count"],
            offset=self._base + spec["offset"],
        )

    def _decode_ids(self, d: str, codes: np.ndarray) -> list[str]:
        blob = self._arr(f"{d}_blob")
        offs = self._arr(f"{d}_offs")
        return [
            bytes(blob[offs[c]:offs[c + 1]]).decode("utf-8") for c in codes
        ]

    @staticmethod
    def _dense(codes: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """First-appearance dense remap — the same assignment order
        ``native.index_spans`` produces over the kept lines."""
        uniq, first, inv = np.unique(
            codes, return_index=True, return_inverse=True
        )
        order = np.argsort(first, kind="stable")
        rank = np.empty(len(uniq), dtype=np.int32)
        rank[order] = np.arange(len(uniq), dtype=np.int32)
        return rank[inv].astype(np.int32, copy=False), uniq[order]

    def _type_mask(self, col: str, names: list[str], wanted: str):
        code = self._arr(col)
        try:
            c = names.index(wanted)
        except ValueError:
            return np.zeros(self.n, dtype=bool)
        return code == c

    def ratings(
        self,
        event_names=None,
        entity_type: str | None = None,
        target_entity_type: str | None = None,
        rating_key: str | None = "rating",
        default_ratings: dict[str, float] | None = None,
        override_ratings: dict[str, float] | None = None,
    ):
        """Filtered ``(user_ids, item_ids, rows, cols, vals)`` from the
        blocks — semantics in lockstep with ``native.load_ratings_jsonl``.
        Returns None when the cache can't serve this ``rating_key``."""
        if rating_key is not None and rating_key != self.rating_key:
            return None
        ent = self._arr("ent_code")
        tgt = self._arr("tgt_code")
        ev = self._arr("ev_code")
        keep = (ent >= 0) & (tgt >= 0)
        if entity_type is not None:
            keep &= self._type_mask("etype_code", self.etype_names, entity_type)
        if target_entity_type is not None:
            keep &= self._type_mask(
                "ttype_code", self.ttype_names, target_entity_type
            )
        if event_names is not None:
            wanted = set(event_names)
            allowed = np.array(
                [name in wanted for name in self.ev_names], dtype=bool
            )
            if len(allowed):
                keep &= (ev >= 0) & allowed[np.clip(ev, 0, None)]
            else:
                keep &= False
        if rating_key is None:
            ratings = np.full(self.n, np.nan, dtype=np.float64)
        else:
            ratings = self._arr("rating").astype(np.float64)
        ratings = colspans.resolve_ratings(
            ratings, ev, self.ev_names, default_ratings, override_ratings
        )
        keep &= ~np.isnan(ratings)

        kept = np.flatnonzero(keep)
        rows, ucodes = self._dense(ent[kept])
        cols, icodes = self._dense(tgt[kept])
        return (
            self._decode_ids("ent", ucodes),
            self._decode_ids("tgt", icodes),
            rows,
            cols,
            ratings[kept].astype(np.float32),
        )


def load(path: Path) -> ColumnarBlocks | None:
    """mmap + validate a cache file; None on absence or any corruption
    (truncated payload, bad magic, unparseable header, out-of-bounds
    blocks) — the caller then falls back to the row scan."""
    try:
        with open(path, "rb") as f:
            mm = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ)
    except (OSError, ValueError):
        return None
    try:
        total = len(mm)
        if total < len(MAGIC) + 8 or mm[: len(MAGIC)] != MAGIC:
            raise ValueError("bad magic")
        hlen = int.from_bytes(mm[len(MAGIC):len(MAGIC) + 8], "little")
        if hlen <= 0 or len(MAGIC) + 8 + hlen > total:
            raise ValueError("bad header length")
        header = json.loads(mm[len(MAGIC) + 8:len(MAGIC) + 8 + hlen])
        payload_base = (
            (len(MAGIC) + 8 + hlen + _ALIGN - 1) // _ALIGN * _ALIGN
        )
        n = int(header["n"])
        specs = header["blocks"]
        for name, _ in _ROW_BLOCKS:
            if name not in specs or int(specs[name]["count"]) != n:
                raise ValueError(f"missing/short column {name}")
        for d in ("ent", "tgt"):
            if f"{d}_blob" not in specs or f"{d}_offs" not in specs:
                raise ValueError(f"missing dictionary {d}")
        for spec in specs.values():
            end = (
                payload_base
                + int(spec["offset"])
                + int(spec["count"]) * np.dtype(spec["dtype"]).itemsize
            )
            if end > total:
                raise ValueError("block out of bounds")
        return ColumnarBlocks(header, mm, payload_base)
    except (ValueError, KeyError, TypeError) as e:
        logger.info("columnar cache unreadable (%s): %s", path, e)
        mm.close()
        return None
