"""``python -m repro_torch.faults``: run the chaos harness from the CLI.

Exits non-zero if any invariant is violated (word drift, replan divergence,
check diagnostics, availability-floor breach); see `repro_torch.faults.chaos`.
"""

from repro_torch.faults.chaos import _main

if __name__ == "__main__":
    raise SystemExit(_main())
