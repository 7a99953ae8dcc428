"""Durable intake journal: the supervisor process as a failure domain
(own copy of the reference's ``serving/journal.py``; the record format is
the same byte for byte, so each package's :func:`scan_dir` reads the
other's directory).

The engine's self-healing, the fleet's replica restarts and the process
fleet's requeue all keep their exactly-once bookkeeping in the
supervisor's memory.  Kill the supervisor mid-storm and every parked,
in-flight and half-streamed request vanishes with no terminal answer.
This module is the write-ahead record that survives that death:

- **accept** records are appended (fsync'd, schema-stamped) *before*
  placement: once the supervisor has said yes to a request, a crash
  cannot unsay it;
- **mark** records journal each streamed chunk at send time (the
  supervisor-level watermark plus the chunk's tokens/text), so a
  relaunch resumes the stream prefix-consistently and can replay the
  journaled prefix to a reconnecting client;
- **term** records journal the terminal response at send time:
  a duplicate submit of an already-terminal idempotency key is answered
  from the record with zero decode work.

**Torn-tail tolerance**: records are framed one per line with a
content checksum; a crash mid-append leaves at most one torn final
line, which the scan drops — a SEALED record (checksummed + newline-
terminated) is never dropped and never double-applied.  Every journal
open starts a FRESH segment, so new appends never land after torn
bytes.

**Segment rotation + compaction bound disk**: when the active segment
passes ``segment_bytes`` it is sealed and a new one starts; with
compaction on, the sealed state is rewritten into one
``compact-<N>.wal`` (terminal records retire their accept/mark
entries; only a bounded tail of terminals is kept for idempotent
re-answers) published through ``integrity.durable_rename`` and the
retired segments are unlinked.  The scan order is: newest compact
file, then every ``seg-J.wal`` with ``J >=`` its covers-up-to counter.

Threading: all append/lookup paths are single-owner on the
supervisor's scheduler loop; only the small
stats/high-water view is shared with the exit-snapshot writer, under
the one declared journal lock.
"""

from __future__ import annotations

import hashlib
import json
import logging
import os
import re
import time
from typing import Any, Callable, Dict, List, Optional

from ..resilience.integrity import durable_rename, fsync_dir
from ..utils.locksan import declare_order, named_lock

log = logging.getLogger(__name__)

#: Journal record/file format version (schema-stamped on every record).
JOURNAL_SCHEMA = 1

#: Record kinds (a typo'd kind is a programming error, like lifecycle's
#: EVENT_KINDS).
RECORD_KINDS = ("accept", "mark", "term")

#: Bounded idempotency window: how many terminal responses stay
#: replayable for duplicate-id answering.  Terminals past the bound are
#: retired by compaction (and from memory), which bounds the disk; a
#: duplicate of a retired id is simply a fresh request.
TERMINAL_KEEP = 4096

_SEG_RE = re.compile(r"^seg-(\d{8})\.wal$")
_COMPACT_RE = re.compile(r"^compact-(\d{8})\.wal$")

#: Declared acquisition order (for the lock sanitizer): the journal's one shared structure — the stats/high-water
#: view read by the exit-snapshot writer — is a leaf; nothing nests
#: inside it.
LOCK_ORDER = ("serving.journal.state",)
declare_order(*LOCK_ORDER)


def _crc(payload: bytes) -> str:
    """Content checksum for one record line (sha256 prefix — torn-write
    detection, not cryptographic integrity)."""
    return hashlib.sha256(payload).hexdigest()[:12]


def _encode(rec: Dict[str, Any]) -> bytes:
    """One journal record -> one framed line: canonical JSON plus a
    checksum over the canonical bytes, newline-terminated.  The
    newline + checksum together make every sealed record provably
    whole under any byte-boundary truncation."""
    payload = json.dumps(rec, sort_keys=True, separators=(",", ":"))
    framed = json.dumps({"v": payload, "crc": _crc(payload.encode())},
                        sort_keys=True, separators=(",", ":"))
    return framed.encode() + b"\n"


def _decode_line(line: bytes) -> Optional[Dict[str, Any]]:
    """-> the record, or None for a torn/corrupt line."""
    try:
        frame = json.loads(line.decode("utf-8"))
        payload = frame["v"]
        if frame["crc"] != _crc(payload.encode()):
            return None
        rec = json.loads(payload)
    except (ValueError, KeyError, TypeError, UnicodeDecodeError):
        return None
    if not isinstance(rec, dict) or rec.get("kind") not in RECORD_KINDS:
        return None
    return rec


class JournalRecovery:
    """What a scan found: the replayable state plus the honesty
    counters (torn lines dropped, segments read)."""

    def __init__(self) -> None:
        self.terminals: Dict[str, Dict[str, Any]] = {}
        self.accepts: Dict[str, Dict[str, Any]] = {}
        self.marks: Dict[str, List[Dict[str, Any]]] = {}
        self.torn_records = 0
        self.segments_scanned = 0
        self.records = 0
        #: insertion order of terminal keys (compaction retention).
        self.terminal_order: List[str] = []

    def apply(self, rec: Dict[str, Any]) -> None:
        kind = rec["kind"]
        key = rec.get("key")
        self.records += 1
        if kind == "accept":
            # Idempotent on rescan: the FIRST accept wins (a compacted
            # rewrite precedes any later live appends in scan order).
            self.accepts.setdefault(key, rec)
        elif kind == "mark":
            self.marks.setdefault(key, []).append(rec)
        elif kind == "term":
            if key not in self.terminals:
                self.terminal_order.append(key)
            self.terminals[key] = rec
            # Terminal retires the stream marks: replay never needs
            # them once the full caption is on record.
            self.marks.pop(key, None)

    def open_requests(self) -> List[Dict[str, Any]]:
        """Accepted-but-unanswered records, intake order — the replay
        set."""
        return [rec for key, rec in self.accepts.items()
                if key not in self.terminals]


def _scan_segment(path: str, rec_out: JournalRecovery) -> bool:
    """Apply every sealed record in one segment; -> True when the
    segment ended in a torn line (counted, dropped).  A sealed record
    is newline-terminated with a matching checksum — anything else is
    the torn tail of a crashed append and scanning stops there (bytes
    after a torn line are unframed garbage by definition)."""
    try:
        with open(path, "rb") as f:
            data = f.read()
    except OSError:
        return False
    rec_out.segments_scanned += 1
    torn = False
    end = 0
    while end < len(data):
        nl = data.find(b"\n", end)
        if nl < 0:
            # Unterminated tail: the crash landed mid-append.
            torn = True
            break
        rec = _decode_line(data[end:nl])
        if rec is None:
            torn = True
            break
        rec_out.apply(rec)
        end = nl + 1
    if torn:
        rec_out.torn_records += 1
    return torn


def list_segments(root: str) -> List[str]:
    """Scan-ordered segment basenames: the newest compact file (if
    any), then every ``seg-J.wal`` at or after the counter it covers
    up to.  Older segments/compacts are superseded leftovers."""
    segs: Dict[int, str] = {}
    compacts: Dict[int, str] = {}
    try:
        names = os.listdir(root)
    except OSError:
        return []
    for name in names:
        m = _SEG_RE.match(name)
        if m:
            # cstlint-torch: disable=device-scalar-fetch -- regex group of a filename: a host string, never a tensor
            segs[int(m.group(1))] = name
            continue
        m = _COMPACT_RE.match(name)
        if m:
            # cstlint-torch: disable=device-scalar-fetch -- regex group of a filename: a host string, never a tensor
            compacts[int(m.group(1))] = name
    floor = max(compacts) if compacts else 0
    ordered: List[str] = []
    if compacts:
        ordered.append(compacts[floor])
    ordered.extend(segs[n] for n in sorted(segs) if n >= floor)
    return ordered


def scan_dir(root: str) -> JournalRecovery:
    """Read-only recovery scan (the fleet_report cross-check uses this
    without constructing a journal — no new segment is started)."""
    rec = JournalRecovery()
    for name in list_segments(root):
        _scan_segment(os.path.join(root, name), rec)
    return rec


class IntakeJournal:
    """The write-ahead intake journal (module docstring).

    ``wall`` is the injectable wall clock (arrival clocks must cross a
    process death, which no monotonic clock survives); ``clock`` is
    unused here but mirrors the supervisor's injection seam.  All
    mutating methods are scheduler-thread-only; :meth:`high_water` and
    :meth:`stats` are safe from the exit-snapshot writer."""

    def __init__(self, root: str, *, segment_bytes: int = 1 << 20,
                 compact: bool = True,
                 wall: Callable[[], float] = time.time):
        self.root = os.path.abspath(root)
        self.segment_bytes = max(1, int(segment_bytes))
        self.compact_enabled = bool(compact)
        self.wall = wall
        os.makedirs(self.root, exist_ok=True)
        #: What the pre-crash journal held — the supervisor's replay
        #: input (read once at construction; never mutated after).
        self.recovery = self._recover()
        # Live idempotency state, primed from recovery.  Scheduler-
        # owned: lookups and appends both happen on the one loop.
        self._terminals = dict(self.recovery.terminals)  # cstlint-torch: owned_by=scheduler
        self._terminal_order = list(self.recovery.terminal_order)  # cstlint-torch: owned_by=scheduler
        self._accepts = dict(self.recovery.accepts)  # cstlint-torch: owned_by=scheduler
        self._marks = {k: list(v) for k, v  # cstlint-torch: owned_by=scheduler
                       in self.recovery.marks.items()}
        self._trim_terminals()
        # The shared stats/high-water view (exit snapshot, health).
        self._state_lock = named_lock("serving.journal.state")
        self._hw: Dict[str, Any] = {}  # cstlint-torch: guarded_by=self._state_lock
        self._c = {"appends": 0, "rotations": 0, "compactions": 0,  # cstlint-torch: guarded_by=self._state_lock
                   "fsyncs": 0}
        # Every open starts a FRESH segment: appends never land after a
        # torn tail, and recovery evidence stays byte-frozen on disk.
        self._seg_n = self._next_counter()
        self._f = None
        self._offset = 0
        self._open_segment()

    # -- segment plumbing --------------------------------------------------

    def _next_counter(self) -> int:
        best = 0
        try:
            names = os.listdir(self.root)
        except OSError:
            names = []
        for name in names:
            for rx in (_SEG_RE, _COMPACT_RE):
                m = rx.match(name)
                if m:
                    # cstlint-torch: disable=device-scalar-fetch -- regex group of a filename: a host string, never a tensor
                    best = max(best, int(m.group(1)))
        return best + 1

    def _seg_name(self, n: int) -> str:
        return f"seg-{n:08d}.wal"

    def _open_segment(self) -> None:
        path = os.path.join(self.root, self._seg_name(self._seg_n))
        self._f = open(path, "ab")
        self._offset = 0
        fsync_dir(self.root)   # the segment's directory entry is durable
        self._publish_hw()

    def _recover(self) -> JournalRecovery:
        rec = JournalRecovery()
        for name in list_segments(self.root):
            _scan_segment(os.path.join(self.root, name), rec)
        return rec

    def _publish_hw(self) -> None:
        hw = {"segment": self._seg_name(self._seg_n),
              "offset": int(self._offset)}
        with self._state_lock:
            self._hw = hw

    # -- THE one append path -----------------------------------------------

    def _append(self, rec: Dict[str, Any]) -> None:
        """The ONE fsync'd journal append helper — every durable
        journal byte goes through here (no other module opens a
        ``*.wal`` for writing).  The
        record is schema-stamped, framed with a checksum, written,
        flushed, and fsync'd BEFORE the caller proceeds: when this
        returns, the record survives a SIGKILL."""
        rec = dict(rec)
        rec["schema"] = JOURNAL_SCHEMA
        data = _encode(rec)
        self._f.write(data)
        self._f.flush()
        os.fsync(self._f.fileno())
        self._offset += len(data)
        with self._state_lock:
            self._c["appends"] += 1
            self._c["fsyncs"] += 1
        self._publish_hw()
        if self._offset >= self.segment_bytes:
            self._rotate()

    def _rotate(self) -> None:
        """Seal the active segment and start the next; compaction (when
        enabled) folds every sealed segment into one compact file so
        terminal records retire their entries and disk stays bounded."""
        self._f.close()
        with self._state_lock:
            self._c["rotations"] += 1
        self._seg_n += 1
        self._open_segment()
        if self.compact_enabled:
            self._compact()

    def _compact(self) -> None:
        """Rewrite the sealed state (everything before the active
        segment) into ``compact-<active>.wal``: open requests keep
        their accept + marks, terminal keys keep ONLY their (bounded)
        terminal record.  Published through the one durable-rename
        discipline, then the superseded files are unlinked — a crash
        at any point leaves either the old segment set or the new
        compact file authoritative, never neither."""
        active = self._seg_name(self._seg_n)
        superseded = [n for n in list_segments(self.root) if n != active]
        tmp = os.path.join(self.root, f"compact-{self._seg_n:08d}.tmp")
        dst = os.path.join(self.root, f"compact-{self._seg_n:08d}.wal")
        with open(tmp, "wb") as f:
            for key, acc in self._accepts.items():
                if key in self._terminals:
                    continue
                f.write(_encode(acc))
                for m in self._marks.get(key, ()):
                    f.write(_encode(m))
            for key in self._terminal_order:
                term = self._terminals.get(key)
                if term is not None:
                    f.write(_encode(term))
            f.flush()
            os.fsync(f.fileno())
        durable_rename(tmp, dst)
        for name in superseded:
            try:
                os.unlink(os.path.join(self.root, name))
            except OSError:
                pass
        fsync_dir(self.root)
        with self._state_lock:
            self._c["compactions"] += 1
        log.info("journal: compacted %d segment(s) into %s",
                 len(superseded), os.path.basename(dst))

    # -- record writers (scheduler thread) ---------------------------------

    def accept(self, key: str, client_id: Any, video_id: str, *,
               stream: bool, ttl_ms: Optional[float], no_cache: bool,
               arrival_wall: Optional[float] = None) -> None:
        """Journal one accepted request BEFORE placement."""
        rec = {"kind": "accept", "key": str(key), "client_id": client_id,
               "video_id": str(video_id), "stream": bool(stream),
               "ttl_ms": (None if ttl_ms is None else float(ttl_ms)),
               "no_cache": bool(no_cache),
               "arrival_wall": (self.wall() if arrival_wall is None
                                else float(arrival_wall))}
        self._accepts.setdefault(rec["key"], rec)
        self._append(rec)

    def mark(self, key: str, seq: int, tokens: List[int],
             text: str, sent_tokens: int) -> None:
        """Journal one streamed chunk at send time: the watermark a
        relaunch resumes from, plus the chunk itself so a reconnecting
        client can be caught up from the record."""
        rec = {"kind": "mark", "key": str(key), "seq": int(seq),
               "tokens": [int(t) for t in tokens], "text": str(text),
               "sent_tokens": int(sent_tokens)}
        self._marks.setdefault(rec["key"], []).append(rec)
        self._append(rec)

    def terminal(self, key: str, resp: Dict[str, Any]) -> None:
        """Journal the terminal response at send time; retires the
        key's stream marks (the caption on record is authoritative)."""
        key = str(key)
        rec = {"kind": "term", "key": key, "resp": dict(resp)}
        if key not in self._terminals:
            self._terminal_order.append(key)
        self._terminals[key] = rec
        self._marks.pop(key, None)
        self._trim_terminals()
        self._append(rec)

    def _trim_terminals(self) -> None:
        while len(self._terminal_order) > TERMINAL_KEEP:
            old = self._terminal_order.pop(0)
            self._terminals.pop(old, None)
            self._accepts.pop(old, None)

    # -- lookups (scheduler thread) ----------------------------------------

    def terminal_for(self, key: str) -> Optional[Dict[str, Any]]:
        """The journaled terminal response for ``key`` (the idempotent
        duplicate-id answer), or None."""
        rec = self._terminals.get(str(key))
        return None if rec is None else dict(rec["resp"])

    def marks_for(self, key: str) -> List[Dict[str, Any]]:
        """The journaled chunks for an OPEN key, seq order — the
        catch-up replay a reconnecting stream client receives."""
        return [dict(m) for m in self._marks.get(str(key), ())]

    def is_open(self, key: str) -> bool:
        return (str(key) in self._accepts
                and str(key) not in self._terminals)

    def open_requests(self) -> List[Dict[str, Any]]:
        """Pre-crash accepts still unanswered (replay input)."""
        return self.recovery.open_requests()

    # -- shared views ------------------------------------------------------

    def high_water(self) -> Dict[str, Any]:
        """The durable high-water mark: the active segment + byte
        offset every sealed record lies at or below.  Safe off the
        scheduler thread (exit snapshot / fleet_report cross-check)."""
        with self._state_lock:
            return dict(self._hw)

    def stats(self) -> Dict[str, Any]:
        with self._state_lock:
            c = dict(self._c)
            hw = dict(self._hw)
        return {
            "schema": JOURNAL_SCHEMA,
            "dir": self.root,
            "high_water": hw,
            "appends": c["appends"],
            "fsyncs": c["fsyncs"],
            "rotations": c["rotations"],
            "compactions": c["compactions"],
            "open": sum(1 for k in self._accepts
                        if k not in self._terminals),
            "terminals": len(self._terminals),
            "recovered_open": len(self.recovery.open_requests()),
            "recovered_terminals": len(self.recovery.terminals),
            "torn_records": self.recovery.torn_records,
            "segments_scanned": self.recovery.segments_scanned,
        }

    def close(self) -> None:
        try:
            self._f.flush()
            os.fsync(self._f.fileno())
        except (OSError, ValueError):
            pass
        try:
            self._f.close()
        except OSError:
            pass
