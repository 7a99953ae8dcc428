"""Checkpoint integrity: per-step manifests, verification on restore
(own copy of the reference's ``resilience/integrity.py``; the manifest
format is the same, so each package's verifier accepts the other's step
directories).

``<step_dir>/manifest.json`` lists every payload file of a committed step
with its size and SHA-256, written AFTER the step's payload is on disk.
Verification has three outcomes:

- ``"verified"``   — manifest present, every file matches;
- ``"corrupt"``    — manifest present and a file is missing, resized or
  altered, OR the manifest is absent while the write marker says one was
  started (the save was torn between commit and manifest);
- ``"unverified"`` — no manifest and no marker (accepted, logged).

``training/checkpoint.py`` walks back to the newest step that is not
corrupt, so a resume never restores a torn state.
"""

from __future__ import annotations

import hashlib
import json
import logging
import os
from typing import Dict, Tuple

log = logging.getLogger(__name__)

MANIFEST_NAME = "manifest.json"
#: Written (fsync'd) BEFORE hashing starts, removed only by the manifest's
#: atomic replace: its presence without a manifest proves a torn save.
_MARKER_NAME = ".manifest.writing"


def manifest_path(step_dir: str) -> str:
    return os.path.join(step_dir, MANIFEST_NAME)


def _iter_payload_files(step_dir: str):
    """Every regular file under ``step_dir`` except the manifest artifacts,
    as (relpath, abspath), in sorted order for stable manifests."""
    out = []
    for root, _dirs, files in os.walk(step_dir):
        for name in files:
            rel = os.path.relpath(os.path.join(root, name), step_dir)
            if rel in (MANIFEST_NAME, _MARKER_NAME):
                continue
            out.append((rel, os.path.join(root, name)))
    return sorted(out)


def _sha256(path: str, chunk: int = 1 << 20) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        while True:
            block = f.read(chunk)
            if not block:
                break
            h.update(block)
    return h.hexdigest()


def write_manifest(step_dir: str) -> Dict[str, Dict]:
    """Checksum every payload file of a committed step and atomically write
    the manifest.  Crash-ordering: the marker is fsync'd first, so a save
    killed mid-hash leaves marker-without-manifest (= corrupt, walk back),
    never a silently manifest-less "legacy" step."""
    marker = os.path.join(step_dir, _MARKER_NAME)
    with open(marker, "w") as f:
        f.flush()
        os.fsync(f.fileno())
    try:
        files = {}
        for rel, path in _iter_payload_files(step_dir):
            files[rel] = {"bytes": os.path.getsize(path),
                          "sha256": _sha256(path)}
        manifest = {"version": 1, "files": files}
        atomic_json_write(manifest_path(step_dir), manifest,
                          indent=1, sort_keys=True)
    except BaseException:
        # A CLEAN failure (caught and handled by the caller) must remove
        # the marker too (atomic_json_write already cleaned its tmp file):
        # the checkpoint itself is whole, and marker-without-manifest
        # would otherwise read as "torn" and get a perfectly good step
        # quarantined on the next start.  Only a hard crash mid-hash —
        # where no cleanup can run — leaves the marker, which is exactly
        # the case it exists for.
        try:
            os.unlink(marker)
        except OSError:
            pass
        raise
    try:
        os.unlink(marker)
    except OSError:
        pass
    fsync_dir(step_dir)
    return manifest


def verify_step_dir(step_dir: str, level: str = "full") -> Tuple[str, str]:
    """-> (status, detail) with status in {verified, corrupt, unverified}.

    ``level="full"`` re-hashes every payload file against the manifest;
    ``level="stat"`` stops at existence + byte sizes — sufficient for the
    torn-write failure mode (truncation / missing files) at stat cost,
    used by the startup quarantine scan so healthy multi-GB checkpoints
    are not fully re-read on every manager construction.  Restore-time
    verification always runs full."""
    mpath = manifest_path(step_dir)
    if not os.path.exists(mpath):
        if os.path.exists(os.path.join(step_dir, _MARKER_NAME)):
            return "corrupt", "manifest write was torn (marker present)"
        return "unverified", "no manifest (pre-integrity-layer checkpoint)"
    try:
        with open(mpath) as f:
            manifest = json.load(f)
        files = manifest["files"]
    except (OSError, ValueError, KeyError) as e:
        return "corrupt", f"unreadable manifest: {e}"
    on_disk = dict(_iter_payload_files(step_dir))
    for rel, want in files.items():
        path = on_disk.get(rel)
        if path is None:
            return "corrupt", f"missing file {rel!r}"
        size = os.path.getsize(path)
        if size != want["bytes"]:
            return ("corrupt",
                    f"{rel!r} is {size} bytes, manifest says {want['bytes']}")
        if level == "full" and _sha256(path) != want["sha256"]:
            return "corrupt", f"{rel!r} content checksum mismatch"
    extra = set(on_disk) - set(files)
    if extra:
        # Tolerated but surfaced: they are not covered by the checksum.
        log.debug("step %s has %d file(s) outside its manifest: %s",
                  step_dir, len(extra), sorted(extra)[:3])
    return "verified", f"{len(files)} file(s) match"


def atomic_json_write(path: str, doc, **dump_kwargs) -> None:
    """The port's one durable-JSON discipline: write to ``path + ".tmp"``,
    fsync the data, atomically rename over ``path``, then fsync the
    directory so a crash can't lose the rename either.  A reader therefore
    sees the old complete document or the new complete document, never a
    torn one — the contract infos.json, telemetry.json, heartbeat.json,
    and the step manifests all rely on.  ``dump_kwargs`` pass through to
    :func:`json.dump`.  On failure the tmp file is removed and the
    published document is untouched."""
    path = os.path.abspath(path)
    tmp = path + ".tmp"
    try:
        with open(tmp, "w") as f:
            json.dump(doc, f, **dump_kwargs)
            # fsync before rename: a host crash can journal the rename
            # without the data, leaving an EMPTY file — worse than the
            # stale one the rename replaced.
            f.flush()
            os.fsync(f.fileno())
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
    os.replace(tmp, path)
    fsync_dir(os.path.dirname(path))


def durable_rename(src: str, dst: str) -> None:
    """The port's one durable-rename discipline: ``os.replace`` then
    fsync the destination directory, so a crash can't journal the
    rename away.  Every rename that PUBLISHES a durable artifact (part
    rotation, step promotion, quarantine moves) must go through here —
    a bare ``os.replace`` persists the data blocks but can lose the
    directory entry, which reads back as the file never existing."""
    os.replace(src, dst)
    fsync_dir(os.path.dirname(os.path.abspath(dst)))


def fsync_dir(path: str) -> None:
    """Persist directory-entry changes (renames, creates).  Best-effort:
    some filesystems refuse O_RDONLY-fsync on directories; the data-file
    fsyncs already happened, so a refusal only loses rename durability."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)
