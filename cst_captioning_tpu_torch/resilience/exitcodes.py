"""Exit-code table of the port's CLIs and stage harness (own copy of the
reference's ``resilience/exitcodes.py``: same codes, names, classes and
meanings, so a harness classifies either package's exits alike).

========  ==================  ==========  ==================================
code      name                class       meaning
========  ==================  ==========  ==================================
``0``     ok                  ok          stage ran to completion
``1``     failure             fatal       unhandled exception (traceback)
``2``     usage               fatal       CLI/config error (argparse)
``4``     advantage_abort     fatal       negative-advantage window abort
                                          (``--abort_on_negative_advantage_
                                          window``; retrying repeats it)
``75``    preempted           resumable   SIGTERM/SIGINT honored at a step
                                          boundary after a verified
                                          checkpoint save (sysexits.h
                                          ``EX_TEMPFAIL``)
``124``   wedge               wedge       no loop progress within
                                          ``--wedge_timeout`` (coreutils
                                          ``timeout(1)`` convention)
``130``   sigint_unwind       fatal       hard operator interrupt
``137``   sigkill             resumable   SIGKILL'd externally; the newest
                                          checkpoint resumes it
``143``   sigterm_unwind      resumable   SIGTERM death without the
                                          graceful handler
========  ==================  ==========  ==================================

Any other death-by-signal code (``128 < rc <= 192``, or the negative
``subprocess`` form) classifies as ``resumable``; any other code as
``fatal``.
"""

from __future__ import annotations

from typing import Dict, NamedTuple

# -- the codes (importable constants; keep CODES below in sync) -------------

EXIT_OK = 0
EXIT_FAILURE = 1
EXIT_USAGE = 2               # argparse usage errors
EXIT_ADVANTAGE_ABORT = 4     # --abort_on_negative_advantage_window
EXIT_PREEMPTED = 75          # sysexits.h EX_TEMPFAIL: checkpointed + exited
EXIT_WEDGE = 124             # utils/watchdog.py (coreutils timeout(1))
EXIT_SIGINT = 130            # 128 + SIGINT
EXIT_SIGKILL = 137           # 128 + SIGKILL
EXIT_SIGTERM = 143           # 128 + SIGTERM

# -- classification classes -------------------------------------------------

OK = "ok"                 #: ran to completion
RESUMABLE = "resumable"   #: restart the stage; it resumes from checkpoint
WEDGE = "wedge"           #: resumable once the device/transport heals
FATAL = "fatal"           #: retrying can only hide it; surface instead


class ExitCode(NamedTuple):
    name: str
    category: str
    meaning: str


CODES: Dict[int, ExitCode] = {
    EXIT_OK: ExitCode("ok", OK, "stage ran to completion"),
    EXIT_FAILURE: ExitCode("failure", FATAL,
                           "unhandled exception (traceback)"),
    EXIT_USAGE: ExitCode("usage", FATAL, "CLI/config error (argparse)"),
    EXIT_ADVANTAGE_ABORT: ExitCode(
        "advantage_abort", FATAL,
        "negative-advantage window abort (stage collapsing; reconfigure)"),
    EXIT_PREEMPTED: ExitCode(
        "preempted", RESUMABLE,
        "signal honored at a step boundary after a verified checkpoint"),
    EXIT_WEDGE: ExitCode(
        "wedge", WEDGE,
        "no loop progress within --wedge_timeout (device presumed wedged)"),
    EXIT_SIGINT: ExitCode(
        "sigint_unwind", FATAL,
        "hard operator interrupt (second Ctrl-C / no handler)"),
    EXIT_SIGKILL: ExitCode(
        "sigkill", RESUMABLE,
        "killed externally (scheduler grace expiry, OOM killer)"),
    EXIT_SIGTERM: ExitCode(
        "sigterm_unwind", RESUMABLE,
        "SIGTERM death without the graceful handler"),
}


def normalize(rc: int) -> int:
    """Map ``subprocess``'s negative died-to-signal form (``-15``) onto the
    shell's ``128 + signum`` convention (``143``) so both spellings of the
    same death classify identically."""
    rc = int(rc)
    return 128 - rc if rc < 0 else rc


def classify(rc: int) -> str:
    """-> ``"ok"`` | ``"resumable"`` | ``"wedge"`` | ``"fatal"``."""
    rc = normalize(rc)
    code = CODES.get(rc)
    if code is not None:
        return code.category
    if 128 < rc <= 192:  # died to an uncatalogued signal: external kill
        return RESUMABLE
    return FATAL


def describe(rc: int) -> str:
    """Human one-liner for logs/abort messages: name + meaning when the
    code is catalogued, the classification otherwise."""
    n = normalize(rc)
    code = CODES.get(n)
    if code is not None:
        return f"{code.name}: {code.meaning}"
    if n != rc:
        return f"died to signal {-int(rc)} ({classify(rc)})"
    return f"uncatalogued exit {rc} ({classify(rc)})"
