"""Delta wire format and the crash-safe publish journal.

Copy of ``lightgbm_tpu/publish/delta.py`` (pure Python) kept inside the
PyTorch port so the port never imports the JAX package.  The wire format
and the file names are the reference's byte for byte, so a journal
either package writes replays in the other.

A journal directory holds three kinds of entries:

* ``BASE.00004.txt`` — a full model-text file (exactly what
  ``Booster.save_model`` writes) anchoring the chain at round 4;
* ``DELTA.00007`` — a binary append record carrying the model-text
  fragment for rounds (base_round, round], crc-guarded and
  fingerprint-chained to its parent;
* ``HEAD`` — a pointer file naming the newest entry.

Every write goes through :func:`io_utils.atomic_write_bytes` and then
repoints ``HEAD`` — the same write-then-repoint ring discipline as
``resilience/checkpoint.py``, so a crash between the two leaves the
previous head intact and :meth:`DeltaJournal.head` falls back to a
directory scan when the pointer is stale or torn.

The fingerprint chain makes replay-onto-the-wrong-base a typed error
instead of silent corruption: a BASE's fingerprint is the sha256 of its
model text; each delta's fingerprint is the sha256 of its parent's
fingerprint plus its own payload, so any gap, reorder, or divergent
base surfaces as :class:`DeltaChainError` at validation time.

Record layout (all integers little-endian)::

    MAGIC(8) | u32 header_len | u32 payload_len |
    u32 crc32(header || payload) | header_json | payload_utf8
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import re
import struct
import threading
import zlib
from typing import List, NamedTuple, Optional, Tuple

from ..io_utils import atomic_write_bytes, atomic_write_text

__all__ = ["DeltaChainError", "DeltaRecord", "DeltaJournal",
           "fingerprint_text", "chain_fingerprint", "DELTA_FORMAT"]

MAGIC = b"LGTPDELT"
DELTA_FORMAT = "lgbm-tpu-delta-v1"
_HDR = struct.Struct("<III")            # header_len, payload_len, crc32

_BASE_RE = re.compile(r"^BASE\.(\d+)\.txt$")
_DELTA_RE = re.compile(r"^DELTA\.(\d+)$")
HEAD = "HEAD"


class DeltaChainError(ValueError):
    """The delta chain is broken: torn/corrupt record, round gap,
    fingerprint mismatch, or replay onto the wrong base model."""


def fingerprint_text(text: str) -> str:
    """Chain anchor for a full model text (a BASE entry)."""
    return hashlib.sha256(text.encode("utf-8")).hexdigest()


def chain_fingerprint(parent_fp: str, payload: str) -> str:
    """Chained fingerprint of one delta: binds the fragment bytes to the
    exact parent state, so replays detect gaps and reorders."""
    h = hashlib.sha256()
    h.update(parent_fp.encode("ascii"))
    h.update(b"\n")
    h.update(payload.encode("utf-8"))
    return h.hexdigest()


@dataclasses.dataclass(frozen=True)
class DeltaRecord:
    """One append record: the model-text fragment for boosting rounds
    ``(base_round, round]``, fingerprint-chained to its parent entry."""

    base_round: int          # chain position this record extends
    round: int               # rounds complete after applying this record
    parent_fp: str           # fingerprint of the parent entry
    fp: str                  # chain_fingerprint(parent_fp, payload)
    num_tree_per_iteration: int
    payload: str             # standalone model text of the new rounds

    def to_bytes(self) -> bytes:
        header = json.dumps({
            "format": DELTA_FORMAT,
            "base_round": self.base_round,
            "round": self.round,
            "parent_fp": self.parent_fp,
            "fp": self.fp,
            "num_tree_per_iteration": self.num_tree_per_iteration,
        }, sort_keys=True).encode("utf-8")
        payload = self.payload.encode("utf-8")
        crc = zlib.crc32(header + payload) & 0xFFFFFFFF
        return MAGIC + _HDR.pack(len(header), len(payload), crc) \
            + header + payload

    @classmethod
    def from_bytes(cls, data: bytes, source: str = "<bytes>"
                   ) -> "DeltaRecord":
        if len(data) < len(MAGIC) + _HDR.size:
            raise DeltaChainError(f"{source}: truncated delta record "
                                  f"({len(data)} bytes)")
        if data[:len(MAGIC)] != MAGIC:
            raise DeltaChainError(f"{source}: bad magic "
                                  f"{data[:len(MAGIC)]!r}")
        hlen, plen, crc = _HDR.unpack_from(data, len(MAGIC))
        body = data[len(MAGIC) + _HDR.size:]
        if len(body) != hlen + plen:
            raise DeltaChainError(
                f"{source}: torn record (expected {hlen + plen} body "
                f"bytes, got {len(body)})")
        if zlib.crc32(body) & 0xFFFFFFFF != crc:
            raise DeltaChainError(f"{source}: crc mismatch")
        try:
            header = json.loads(body[:hlen].decode("utf-8"))
        except (UnicodeDecodeError, json.JSONDecodeError) as exc:
            raise DeltaChainError(f"{source}: bad header: {exc}") from exc
        if header.get("format") != DELTA_FORMAT:
            raise DeltaChainError(
                f"{source}: format {header.get('format')!r} != "
                f"{DELTA_FORMAT!r}")
        payload = body[hlen:].decode("utf-8")
        rec = cls(base_round=int(header["base_round"]),
                  round=int(header["round"]),
                  parent_fp=str(header["parent_fp"]),
                  fp=str(header["fp"]),
                  num_tree_per_iteration=int(
                      header["num_tree_per_iteration"]),
                  payload=payload)
        if chain_fingerprint(rec.parent_fp, payload) != rec.fp:
            raise DeltaChainError(f"{source}: payload does not match "
                                  f"its declared fingerprint")
        if rec.round <= rec.base_round:
            raise DeltaChainError(
                f"{source}: non-monotonic rounds {rec.base_round} -> "
                f"{rec.round}")
        return rec


class HeadInfo(NamedTuple):
    round: int
    fp: str
    kind: str                # "base" | "delta"
    name: str                # entry filename


def _base_name(rnd: int) -> str:
    return f"BASE.{rnd:05d}.txt"


def _delta_name(rnd: int) -> str:
    return f"DELTA.{rnd:05d}"


class DeltaJournal:
    """Monotonic publish journal with checkpoint-ring crash discipline.

    Writers (one per journal) call :meth:`write_base` /
    :meth:`append_delta` / :meth:`compact`; readers call :meth:`head`,
    :meth:`chain` and :meth:`records_after`.  All mutation is
    lock-serialized and atomic: entry file first, ``HEAD`` repoint
    second, prune last."""

    def __init__(self, directory: str) -> None:
        self.directory = str(directory)
        self._lock = threading.Lock()

    # -- read side ----------------------------------------------------------

    def _entries(self) -> List[Tuple[int, str, str]]:
        """[(round, kind, name)] sorted by (round, kind) — deltas sort
        after a base at the same round (a base is folded state)."""
        out = []
        try:
            names = os.listdir(self.directory)
        except FileNotFoundError:
            return []
        for n in names:
            m = _BASE_RE.match(n)
            if m:
                out.append((int(m.group(1)), "base", n))
                continue
            m = _DELTA_RE.match(n)
            if m:
                out.append((int(m.group(1)), "delta", n))
        out.sort(key=lambda e: (e[0], e[1] == "delta"))
        return out

    def _read(self, name: str) -> bytes:
        with open(os.path.join(self.directory, name), "rb") as fh:
            return fh.read()

    def _info_of(self, name: str) -> Optional[HeadInfo]:
        m = _BASE_RE.match(name)
        if m:
            text = self._read(name).decode("utf-8")
            return HeadInfo(int(m.group(1)), fingerprint_text(text),
                            "base", name)
        m = _DELTA_RE.match(name)
        if m:
            rec = DeltaRecord.from_bytes(self._read(name), source=name)
            return HeadInfo(rec.round, rec.fp, "delta", name)
        return None

    def head(self) -> Optional[HeadInfo]:
        """Newest entry: the ``HEAD`` pointer when fresh, else the
        highest-round entry on disk (pointer-with-fallback, so a crash
        between entry write and repoint still resolves)."""
        ptr = os.path.join(self.directory, HEAD)
        try:
            with open(ptr) as fh:
                name = fh.read().strip()
            if name and os.path.exists(
                    os.path.join(self.directory, name)):
                info = self._info_of(name)
                if info is not None:
                    return info
        except (OSError, DeltaChainError):
            pass
        for rnd, kind, name in reversed(self._entries()):
            try:
                return self._info_of(name)
            except DeltaChainError:
                continue        # torn tail entry: fall back further
        return None

    def chain(self) -> Tuple[str, int, List[DeltaRecord]]:
        """(base_text, base_round, ordered records) — the full validated
        chain from the newest BASE to the head.  Raises
        :class:`DeltaChainError` on any gap, crc failure, or
        fingerprint mismatch."""
        entries = self._entries()
        bases = [e for e in entries if e[1] == "base"]
        if not bases:
            raise DeltaChainError(
                f"{self.directory}: journal has no BASE entry")
        base_round, _, base_name = bases[-1]
        base_text = self._read(base_name).decode("utf-8")
        fp = fingerprint_text(base_text)
        records: List[DeltaRecord] = []
        rnd = base_round
        for e_rnd, kind, name in entries:
            if kind != "delta" or e_rnd <= base_round:
                continue
            rec = DeltaRecord.from_bytes(self._read(name), source=name)
            if rec.base_round != rnd:
                raise DeltaChainError(
                    f"{name}: chain gap — record extends round "
                    f"{rec.base_round}, chain is at round {rnd}")
            if rec.parent_fp != fp:
                raise DeltaChainError(
                    f"{name}: fingerprint mismatch — record parent "
                    f"{rec.parent_fp[:12]}..., chain head {fp[:12]}...")
            records.append(rec)
            rnd, fp = rec.round, rec.fp
        return base_text, base_round, records

    def records_after(self, round: int) -> List[DeltaRecord]:
        """Validated chain records with ``round`` strictly past the
        given round (the fleet replay primitive)."""
        _, _, records = self.chain()
        return [r for r in records if r.round > round]

    def base_entry(self) -> Optional[Tuple[str, int]]:
        """(absolute path, round) of the newest BASE file — the
        full-reload anchor a subscriber that fell off the chain loads
        before replaying :meth:`records_after` forward."""
        bases = [e for e in self._entries() if e[1] == "base"]
        if not bases:
            return None
        rnd, _, name = bases[-1]
        return os.path.join(self.directory, name), rnd

    # -- write side ---------------------------------------------------------

    def write_base(self, model_text: str, round: int) -> str:
        """Anchor (or re-anchor) the chain with a full model text at
        ``round``; returns the base fingerprint."""
        with self._lock:
            os.makedirs(self.directory, exist_ok=True)
            name = _base_name(round)
            atomic_write_bytes(os.path.join(self.directory, name),
                               model_text.encode("utf-8"))
            atomic_write_text(os.path.join(self.directory, HEAD), name)
        return fingerprint_text(model_text)

    def append_delta(self, payload: str, round: int,
                     num_tree_per_iteration: int = 1) -> DeltaRecord:
        """Append the fragment for rounds ``(head, round]``.  The chain
        position and parent fingerprint come from the journal head, so
        concurrent/replayed writers cannot fork the chain silently."""
        with self._lock:
            h = self.head()
            if h is None:
                raise DeltaChainError(
                    f"{self.directory}: cannot append to an empty "
                    f"journal — write a BASE first")
            if round <= h.round:
                raise DeltaChainError(
                    f"{self.directory}: journal already at round "
                    f"{h.round}, refusing non-monotonic append to "
                    f"round {round}")
            rec = DeltaRecord(
                base_round=h.round, round=round, parent_fp=h.fp,
                fp=chain_fingerprint(h.fp, payload),
                num_tree_per_iteration=num_tree_per_iteration,
                payload=payload)
            name = _delta_name(round)
            atomic_write_bytes(os.path.join(self.directory, name),
                               rec.to_bytes())
            atomic_write_text(os.path.join(self.directory, HEAD), name)
        return rec

    def compact(self, model_text: str, round: int) -> str:
        """Fold the chain: write a full BASE at ``round`` and prune
        every entry it supersedes (older bases, deltas <= round).  A
        crash mid-prune leaves only redundant entries behind — the next
        :meth:`chain` still reads from the newest base."""
        with self._lock:
            os.makedirs(self.directory, exist_ok=True)
            name = _base_name(round)
            atomic_write_bytes(os.path.join(self.directory, name),
                               model_text.encode("utf-8"))
            atomic_write_text(os.path.join(self.directory, HEAD), name)
            for e_rnd, kind, e_name in self._entries():
                if e_name == name:
                    continue
                if kind == "base" and e_rnd <= round or \
                        kind == "delta" and e_rnd <= round:
                    try:
                        os.unlink(os.path.join(self.directory, e_name))
                    except OSError:
                        pass
        return fingerprint_text(model_text)

    def chain_length(self) -> int:
        """Deltas on top of the newest base (the compaction trigger)."""
        entries = self._entries()
        bases = [e for e in entries if e[1] == "base"]
        if not bases:
            return 0
        base_round = bases[-1][0]
        return sum(1 for e_rnd, kind, _ in entries
                   if kind == "delta" and e_rnd > base_round)
