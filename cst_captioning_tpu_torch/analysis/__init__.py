"""cstlint-torch: the port's static analysis (own copy of the reference's
``analysis/`` package).

An AST rule engine (``engine.py``: registry, suppressions that carry a
written justification, human and JSON output) with twelve rules over
``cst_captioning_tpu_torch/`` and ``chip_smoke.py``:

- core (``rules.py``): ``device-scalar-fetch`` (no host fetch of a
  tensor inside a hot-path loop), ``atomic-write`` (durable JSON only
  through ``resilience.integrity.atomic_json_write``), ``journal-append``
  (write-ahead segments only through ``serving/journal.py``),
  ``declared-counters`` (counters declared at 0), ``exit-taxonomy``
  (exits through ``resilience/exitcodes.py``) and ``bare-except-swallow``
  (no silent broad except in ``serving/`` and ``resilience/``);
- concurrency (``concurrency.py``): ``guarded-by``, ``thread-ownership``,
  ``lock-order``, ``signal-safe-handler``, ``thread-discipline`` and
  ``monotonic-deadline``, over the ``# cstlint-torch: guarded_by=`` /
  ``owned_by=`` annotations and the modules' ``LOCK_ORDER`` tables.

The reference's thirteenth rule, ``donation-audit``, is not ported: it
checks JAX buffer donation in the lowered jaxpr of the jitted entry
points, and a torch program has no donation and no jaxpr.

``locksan.py`` re-exports the runtime lock sanitizer
(``utils/locksan.py``), whose ``named_lock`` and ``declare_order`` the
``lock-order`` rule reads statically.

Entry point: ``python -m cst_captioning_tpu_torch.lint``.
"""

from .engine import (  # noqa: F401
    LintResult,
    Project,
    RULES,
    SourceFile,
    Suppression,
    Violation,
    lint_sources,
    lint_tree,
    render_human,
    render_json,
    tree_files,
)

# Importing the rule modules registers every rule.
from . import rules  # noqa: F401,E402
from . import concurrency  # noqa: F401,E402
