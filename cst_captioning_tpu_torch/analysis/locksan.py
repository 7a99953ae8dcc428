"""Runtime lock sanitizer, re-exported under the analysis package.

The implementation lives in ``utils/locksan.py``, so that the modules
that create locks (telemetry, serving, the loader) depend on a
standard-library leaf module and never pull the lint engine into a
serving process.  The ``lock-order`` rule resolves lock expressions
through ``named_lock`` assignments and reads the same ``LOCK_ORDER``
tables that ``declare_order`` registers at runtime.
"""

from ..utils.locksan import (  # noqa: F401
    DEFAULT_RECEIPT,
    ENV_FLAG,
    ENV_RECEIPT,
    LOCKSAN_SCHEMA,
    LockOrderViolation,
    declare_order,
    enabled,
    named_lock,
    path_exists,
    reset_observed,
    violations,
)
