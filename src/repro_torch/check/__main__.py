"""CLI: ``python -m repro_torch.check [--plans] [--dataflow] [--github]``.

With no layer flag the plan verifier runs; ``--dataflow`` adds the
word-count certificates over whole search spaces (RPC04x). Exit status 1
iff any error-severity diagnostic fired; warnings print but do not fail.
``--github`` renders GitHub Actions ``::error``/``::warning`` annotations.
The codebase lint is the reference's: ``python -m repro.check --codebase``
lints ``src/repro_torch`` with the rest of ``src/``.
"""

from __future__ import annotations

import argparse
import sys
from typing import List, Optional, Sequence

from repro_torch.check.api import check_plans
from repro_torch.check.diagnostics import (CODES, Diagnostic, code_table,
                                           errors, render_all)
from repro_torch.core.cnn_zoo import PAPER_CNNS


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.check",
        description="static plan verifier, launch pre-flight and word-count "
                    "certificates of the PyTorch/CUDA port")
    ap.add_argument("--plans", action="store_true",
                    help="plan the zoo CNNs under both controllers and "
                         "verify every NetPlan")
    ap.add_argument("--dataflow", action="store_true",
                    help="certify the RPC04x word counts of the kernels' "
                         "launches over whole search spaces")
    ap.add_argument("--github", action="store_true",
                    help="render diagnostics as GitHub Actions annotations")
    ap.add_argument("--nets", nargs="*", default=list(PAPER_CNNS),
                    metavar="NET", help="CNNs to plan (default: all 8)")
    ap.add_argument("--controllers", nargs="*",
                    default=["passive", "active"], metavar="CTRL",
                    choices=["passive", "active"])
    ap.add_argument("--strategy", default="exact_opt")
    ap.add_argument("--budget", type=int, default=None)
    ap.add_argument("--kernels", action="store_true",
                    help="also pre-flight the launch of every executable "
                         "conv node under --plans")
    ap.add_argument("--codes", action="store_true",
                    help="print the diagnostic-code table and exit")
    args = ap.parse_args(argv)

    if args.codes:
        print(code_table())
        return 0

    diags: List[Diagnostic] = []
    if args.plans or not args.dataflow:
        found, timings = check_plans(args.nets, args.controllers,
                                     args.strategy, args.budget,
                                     with_kernels=args.kernels)
        print(f"repro_torch.check --plans: {len(found)} diagnostic(s) over "
              f"{len(timings)} netplan(s) in {sum(timings.values()):.2f}s")
        diags += found
    if args.dataflow:
        from repro_torch.check.dataflow import check_dataflow
        found, timings = check_dataflow(args.nets, args.controllers)
        n_cert = int(timings.pop("_certified", 0))
        print(f"repro_torch.check --dataflow: {len(found)} diagnostic(s), "
              f"{n_cert} space candidate(s) certified in "
              f"{sum(timings.values()):.2f}s")
        diags += found

    if diags:
        print(render_all(diags, github=args.github))
    n_err = len(errors(diags))
    codes = sorted({d.code for d in diags})
    tail = f" [{', '.join(codes)}]" if codes else ""
    print(f"repro_torch.check: {n_err} error(s), {len(diags) - n_err} "
          f"warning(s){tail}; {len(CODES)} codes registered")
    return 1 if n_err else 0


if __name__ == "__main__":
    sys.exit(main())
