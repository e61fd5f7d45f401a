"""`repro_torch.roofline`: the card's machine numbers and the shared
per-access energy table (`constants`).

The reference's HLO roofline (``analysis``, ``report``) reads XLA's compiled
modules and the dry-run records; it waits for the dry run (ROADMAP A9).
"""

from repro_torch.roofline import constants

__all__ = ["constants"]
