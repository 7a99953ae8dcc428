"""cstlint-torch: the port's static analysis from the command line (the
counterpart of the reference's ``scripts/cstlint.py``).

Runs the rules of ``analysis/`` over ``cst_captioning_tpu_torch/`` and
``chip_smoke.py`` (or the files named) and reports every violation that
no justified ``# cstlint-torch: disable=<rule> -- <why>`` comment covers.

Usage:
  python -m cst_captioning_tpu_torch.lint                # human output
  python -m cst_captioning_tpu_torch.lint --json         # JSON report
  python -m cst_captioning_tpu_torch.lint --rules exit-taxonomy,atomic-write
  python -m cst_captioning_tpu_torch.lint --list-rules
  python -m cst_captioning_tpu_torch.lint cst_captioning_tpu_torch/serve.py

Paths are relative to the repo root (the directory that holds the
package).  Exits (``resilience/exitcodes.py``): 0 clean, 1 violations,
2 usage (an unknown rule, an unreadable path).
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import List, Optional

from .analysis import RULES, lint_tree, render_human, render_json
from .resilience.exitcodes import EXIT_FAILURE, EXIT_OK

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m cst_captioning_tpu_torch.lint",
        description="the port's static analysis (cstlint-torch)")
    ap.add_argument("paths", nargs="*",
                    help="repo-relative files to lint (default: the "
                         "package and chip_smoke.py)")
    ap.add_argument("--json", action="store_true",
                    help="machine-readable report on stdout")
    ap.add_argument("--rules", default=None,
                    help="comma-separated rule subset (default: all)")
    ap.add_argument("--list-rules", action="store_true")
    args = ap.parse_args(argv)

    if args.list_rules:
        by_cat = {}
        for name in sorted(RULES):
            by_cat.setdefault(RULES[name].category, []).append(name)
        for cat in sorted(by_cat):
            print(f"[{cat}]")
            for name in by_cat[cat]:
                print(f"  {name:22s} {RULES[name].doc}")
        return EXIT_OK

    rules = None
    if args.rules:
        rules = [r.strip() for r in args.rules.split(",") if r.strip()]
    try:
        result = lint_tree(REPO, rules=rules, paths=args.paths or None)
    except KeyError as e:
        ap.error(str(e.args[0]) if e.args else str(e))
    except OSError as e:
        ap.error(f"cannot read lint target: {e}")

    print(render_json(result) if args.json else render_human(result))
    return EXIT_OK if result.clean else EXIT_FAILURE


if __name__ == "__main__":
    sys.exit(main())
