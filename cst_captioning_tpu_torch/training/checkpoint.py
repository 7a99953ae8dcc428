"""Step checkpoints with integrity manifests, best-score bookkeeping and
resume (counterpart of the reference's ``training/checkpoint.py``, in
``torch.save`` form rather than orbax).

Layout of a stage directory::

    <dir>/<step>/state.pt            epoch-boundary saves, with a score
    <dir>/<step>/manifest.json       SHA-256 of every payload file
    <dir>/recovery/<step>/...        --save_every_steps, --save_interval_secs
                                     and preemption saves (the newest one)
    <dir>/infos.json                 best_step, best_score, step_scores,
                                     patience, last_step, history, opt

``state.pt`` is one ``torch.save`` of the trainer's payload (parameters,
optimizer, step, generator states, run state).  A step is written into a
temporary directory, fsynced, renamed into place, and sealed with its
manifest (``resilience/integrity.py``, the reference's format).

Scored steps are trimmed to the ``max_to_keep`` best scores, ties to the
newer step, as the reference's orbax manager trims them, so a best score
is always kept; when the recorded best step lost a tie, ``load(best=
True)`` restores the best retained step, as the reference does.  The
recovery set keeps its newest step.  A step
that fails verification is never restored: ``latest_verified_step`` and
``load`` walk back past it, and a manager that owns the directory
(``readonly=False``) renames torn steps aside as
``<step>.corrupt-quarantine`` at start and scrubs ``infos.json`` when the
best step was one of them.  Readers (``--start_from``, eval, serve,
``tools/bf16_parity.py``) use :func:`load`, which never writes.
"""

from __future__ import annotations

import json
import logging
import os
import shutil
import time
from typing import Any, Dict, List, Optional, Set, Tuple

import torch

from ..resilience import integrity
from ..resilience.faults import FaultPlan

log = logging.getLogger(__name__)

STATE_FILE = "state.pt"
INFOS_FILE = "infos.json"
#: Counters the manager keeps in its registry, declared at 0.
COUNTERS = ("checkpoints_saved", "checkpoints_quarantined",
            "checkpoint_walkbacks")


def _steps(base: str) -> List[int]:
    """The committed step numbers under ``base`` (digit-named dirs)."""
    if not os.path.isdir(base):
        return []
    return sorted(int(n) for n in os.listdir(base)
                  if n.isdigit() and os.path.isdir(os.path.join(base, n)))


class CheckpointManager:
    """Step-numbered checkpoints of one stage directory."""

    QUARANTINE_SUFFIX = ".corrupt-quarantine"

    def __init__(self, directory: str, max_to_keep: int = 2,
                 fault_plan: Optional[FaultPlan] = None,
                 readonly: bool = False, registry=None):
        """``readonly=True`` is for readers: no quarantine scan, no infos
        scrub, no directory created; a reader never renames a step out
        from under the trainer that owns the directory.  ``registry`` (a
        ``telemetry.registry.MetricsRegistry``) counts saves, walk-backs
        and quarantines and observes ``ckpt_save_ms`` and
        ``ckpt_verify_ms``.  ``fault_plan`` arms ``ckpt_torn``."""
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max(1, int(max_to_keep))
        self._faults = fault_plan
        self._registry = registry
        if registry is not None:
            registry.declare(*COUNTERS)
        self._verify_cache: Dict[tuple, Tuple[str, str]] = {}
        self._quarantined: List[Tuple[int, bool]] = []
        if not readonly:
            self._quarantine_torn_steps()
        self._infos_path = os.path.join(self.directory, INFOS_FILE)
        self.infos: Dict[str, Any] = {"best_step": None, "best_score": None}
        if os.path.exists(self._infos_path):
            with open(self._infos_path) as f:
                self.infos = json.load(f)
        if self._quarantined:
            self._scrub_infos_after_quarantine()

    # -- telemetry ---------------------------------------------------------

    def _inc(self, name: str) -> None:
        if self._registry is not None:
            self._registry.inc(name)

    def _observe_ms(self, name: str, t0: float) -> None:
        if self._registry is not None:
            self._registry.observe(name, (time.perf_counter() - t0) * 1e3)

    # -- save --------------------------------------------------------------

    def _base(self, recovery: bool) -> str:
        return (os.path.join(self.directory, "recovery") if recovery
                else self.directory)

    def _commit(self, step: int, payload: Dict[str, Any],
                recovery: bool) -> str:
        """Write ``payload`` as step ``step``: a temporary directory,
        fsynced and renamed into place, then sealed with its manifest;
        then the ``ckpt_torn`` hook.  -> the step directory."""
        t0 = time.perf_counter()
        base = self._base(recovery)
        os.makedirs(base, exist_ok=True)
        final = os.path.join(base, str(step))
        tmp = os.path.join(base, f".{step}.tmp-{os.getpid()}")
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        with open(os.path.join(tmp, STATE_FILE), "wb") as f:
            torch.save(payload, f)
            f.flush()
            os.fsync(f.fileno())
        if os.path.isdir(final):
            # A divergence rollback, or a resume that walked back past a
            # torn step, replays steps whose directories survive.
            log.warning("overwriting existing checkpoint step %d (replay "
                        "after rollback or walk-back)", step)
            shutil.rmtree(final)
        integrity.durable_rename(tmp, final)
        try:
            integrity.write_manifest(final)
        except OSError as e:
            # The payload is committed; a step without a manifest still
            # restores (as "unverified").
            log.warning("could not write integrity manifest for step %d: "
                        "%s", step, e)
        self._observe_ms("ckpt_save_ms", t0)
        self._inc("checkpoints_saved")
        if self._faults is not None and self._faults.fire("ckpt_torn", step):
            self._tear_step(final)
        return final

    def save(self, step: int, payload: Dict[str, Any], score: float,
             extra: Optional[Dict[str, Any]] = None) -> None:
        """A scored (epoch-boundary) save; updates the best bookkeeping,
        trims the scored steps to ``max_to_keep`` and rewrites
        ``infos.json`` with ``extra`` merged in."""
        self._commit(step, payload, recovery=False)
        score = float(score)
        if self.infos.get("best_score") is None \
                or score > self.infos["best_score"]:
            self.infos["best_score"] = score
            self.infos["best_step"] = int(step)
        on_disk = set(_steps(self.directory))
        scores = {int(s): float(v)
                  for s, v in self.infos.get("step_scores", {}).items()
                  if int(s) in on_disk}
        scores[int(step)] = score
        keep = sorted(scores, key=lambda s: (scores[s], s),
                      reverse=True)[:self.max_to_keep]
        for s in set(scores) - set(keep):
            shutil.rmtree(os.path.join(self.directory, str(s)),
                          ignore_errors=True)
        self.infos["step_scores"] = {str(s): scores[s] for s in sorted(keep)}
        if extra:
            self.infos.update(extra)
        self.infos["last_step"] = int(step)
        self._write_infos()

    def save_recovery(self, step: int, payload: Dict[str, Any],
                      verify: bool = False) -> None:
        """A recovery save (the newest one is kept).  ``verify=True`` (the
        preemption boundary) re-reads the step through the integrity
        layer and raises unless it verifies: exit 75 claims a resumable
        checkpoint, and the claim is proven first."""
        self._commit(step, payload, recovery=True)
        base = self._base(recovery=True)
        for s in _steps(base):
            if s != step:
                shutil.rmtree(os.path.join(base, str(s)), ignore_errors=True)
        if verify:
            status, detail = self._verify_dir(
                self._step_dir(step, recovery=True))
            if status != "verified":
                raise RuntimeError(
                    f"recovery checkpoint step {step} failed post-save "
                    f"integrity verification ({status}: {detail}); "
                    "refusing to exit as resumable on an unproven save")

    def _write_infos(self) -> None:
        integrity.atomic_json_write(self._infos_path, self.infos, indent=2,
                                    default=str)

    # -- integrity ---------------------------------------------------------

    def _quarantine_torn_steps(self) -> None:
        """Rename every step that fails a stat-level check (marker,
        missing or resized files) to ``<step>.corrupt-quarantine``."""
        for base in (self.directory, self._base(recovery=True)):
            for step in _steps(base):
                step_dir = os.path.join(base, str(step))
                status, detail = integrity.verify_step_dir(step_dir,
                                                           level="stat")
                if status != "corrupt":
                    continue
                dst = step_dir + self.QUARANTINE_SUFFIX
                try:
                    shutil.rmtree(dst, ignore_errors=True)
                    integrity.durable_rename(step_dir, dst)
                except OSError as e:
                    log.warning("could not quarantine torn step %s: %s",
                                step_dir, e)
                    continue
                self._quarantined.append((step, base != self.directory))
                self._inc("checkpoints_quarantined")
                log.warning("quarantined torn checkpoint step %d (%s) -> %s; "
                            "resume will use the newest verified step",
                            step, detail, os.path.basename(dst))

    def _scrub_infos_after_quarantine(self) -> None:
        """A quarantined scored step takes its score with it; when it was
        the best, the best becomes the best retained step."""
        gone = {step for step, recovery in self._quarantined if not recovery}
        if not gone:
            return
        scores = {int(s): float(v)
                  for s, v in self.infos.get("step_scores", {}).items()
                  if int(s) not in gone}
        if "step_scores" in self.infos:
            self.infos["step_scores"] = {str(s): v for s, v in scores.items()}
        best = self.infos.get("best_step")
        if best is not None and int(best) in gone:
            new_best = self._best_retained(scores)
            self.infos["best_step"] = new_best
            self.infos["best_score"] = (None if new_best is None
                                        else scores[new_best])
            log.warning("best checkpoint (step %d) was quarantined as torn; "
                        "best bookkeeping now %s", int(best), new_best)
        self._write_infos()

    @staticmethod
    def _best_retained(scores: Dict[int, float]) -> Optional[int]:
        """Highest score, ties to the smaller step."""
        if not scores:
            return None
        return min(scores, key=lambda s: (-scores[s], s))

    @staticmethod
    def _tear_step(step_dir: str) -> None:
        """``ckpt_torn``: truncate the largest payload file to half its
        size, the torn write a power cut leaves, which the manifest
        (listing the full size) must catch."""
        files = [(os.path.getsize(p), p)
                 for _rel, p in integrity._iter_payload_files(step_dir)]
        if not files:
            return
        size, victim = max(files)
        with open(victim, "r+b") as f:
            f.truncate(max(0, size // 2))
        log.warning("FAULT: tore checkpoint file %s (%d -> %d bytes)",
                    victim, size, max(0, size // 2))

    def _step_dir(self, step: int, recovery: Optional[bool] = None) -> str:
        """A step's directory; ``recovery=None`` prefers the scored set."""
        rec = os.path.join(self._base(recovery=True), str(step))
        if recovery is True:
            return rec
        main = os.path.join(self.directory, str(step))
        if recovery is False or os.path.isdir(main):
            return main
        return rec

    def _verify_dir(self, step_dir: str) -> Tuple[str, str]:
        """Full verification behind a cache keyed on the manifest's and
        every payload file's stat signature, so a resume does not hash
        the same step several times, while any truncation or rewrite
        (the ``ckpt_torn`` tear included) forces a fresh hash."""
        try:
            mkey = os.stat(integrity.manifest_path(step_dir)).st_mtime_ns
            sig = tuple(
                (rel, os.stat(path).st_size, os.stat(path).st_mtime_ns)
                for rel, path in integrity._iter_payload_files(step_dir))
        except OSError:
            return integrity.verify_step_dir(step_dir)
        key = (step_dir, mkey, sig)
        hit = self._verify_cache.get(key)
        if hit is None:
            t0 = time.perf_counter()
            hit = integrity.verify_step_dir(step_dir)
            self._observe_ms("ckpt_verify_ms", t0)
            self._verify_cache[key] = hit
        return hit

    def verify_step(self, step: int) -> Tuple[str, str]:
        """-> (status, detail): 'verified', 'unverified' or 'corrupt'."""
        return self._verify_dir(self._step_dir(step))

    def _available_steps(self) -> Set[int]:
        return (set(_steps(self.directory))
                | set(_steps(self._base(recovery=True))))

    @property
    def latest_step(self) -> Optional[int]:
        return max(self._available_steps(), default=None)

    @property
    def latest_verified_step(self) -> Optional[int]:
        """The newest step that does not fail verification (a step
        without a manifest passes); None when no intact step exists."""
        for step in sorted(self._available_steps(), reverse=True):
            if self.verify_step(step)[0] != "corrupt":
                return step
        return None

    @property
    def best_step(self) -> Optional[int]:
        s = self.infos.get("best_step")
        return int(s) if s is not None else None

    # -- restore -----------------------------------------------------------

    def _pick_step(self, best: bool, excluded: Set[int]) -> Optional[int]:
        avail = self._available_steps() - excluded
        if not avail:
            return None
        if best and self.best_step is not None:
            if self.best_step in avail:
                return self.best_step
            scores = {int(s): float(v)
                      for s, v in self.infos.get("step_scores", {}).items()
                      if int(s) in avail}
            step = self._best_retained(scores)
            if step is not None:
                log.warning("best step %d is unavailable (trimmed on a "
                            "tie, or failed verification); restoring the "
                            "best retained "
                            "step %d (score %s)", self.best_step, step,
                            scores[step])
                return step
        return max(avail)

    def _resolve_step(self, step: Optional[int], best: bool) -> int:
        if step is not None:
            # A step the caller names is never silently substituted.
            status, detail = self.verify_step(step)
            if status == "corrupt":
                raise ValueError(
                    f"checkpoint step {step} in {self.directory} failed "
                    f"integrity verification ({detail}); refusing to "
                    "restore a torn state")
            return step
        excluded: Set[int] = set()
        while True:
            cand = self._pick_step(best, excluded)
            if cand is None:
                if excluded:
                    raise FileNotFoundError(
                        f"every checkpoint in {self.directory} failed "
                        f"integrity verification ({sorted(excluded)}); "
                        "no intact state to restore")
                raise FileNotFoundError(f"no checkpoint in {self.directory}")
            status, detail = self.verify_step(cand)
            if status != "corrupt":
                if status == "unverified":
                    log.info("restoring step %d without a manifest", cand)
                if excluded:
                    log.warning("walked back past torn checkpoint step(s) %s "
                                "to verified step %d", sorted(excluded), cand)
                return cand
            log.warning("checkpoint step %d failed integrity verification "
                        "(%s); walking back", cand, detail)
            excluded.add(cand)
            self._inc("checkpoint_walkbacks")

    def load(self, step: Optional[int] = None,
             best: bool = False) -> Dict[str, Any]:
        """The payload of ``step``, else of the best step (``best=True``),
        else of the newest step; torn steps are walked past.  Tensors on
        the CPU."""
        step = self._resolve_step(step, best)
        path = os.path.join(self._step_dir(step), STATE_FILE)
        return torch.load(path, map_location="cpu", weights_only=True)


def load(directory: str, best: bool = True) -> Dict[str, Any]:
    """A reader's view of a stage directory: the payload of its best
    verified step (``best=False``: the newest).  Never writes."""
    return CheckpointManager(directory, readonly=True).load(best=best)
