"""Typed schedule vocabulary: `Strategy`, `Controller` and `Schedule`.

`Schedule` is the one execution-schedule type the kernels consume. For a
conv, ``bm``/``bn`` are the paper's m input maps and n output maps per
iteration (eq 1) and ``bk`` is 0 (space is never tiled by the planner). For a
GEMM, ``bm`` x ``bn`` is the output tile and ``bk`` the reduction block.
"""

from __future__ import annotations

import dataclasses
import enum


class Strategy(enum.Enum):
    """Partition-selection policy (paper Section II + exact searches)."""

    MAX_INPUT = "max_input"            # maximize m first (paper baseline 1)
    MAX_OUTPUT = "max_output"          # maximize n first (paper baseline 2)
    EQUAL = "equal"                    # m = n = sqrt(P)/K  (paper baseline 3)
    PAPER_OPT = "paper_opt"            # eq (7) closed form, snapped to factors
    EXACT_OPT = "exact_opt"            # integer-exact search
    FIRST_ORDER = "first_order"        # closed-form block rule (GEMM eq-7 analogue)
    EXHAUSTIVE_VMEM = "exhaustive_vmem"  # exact search over aligned GEMM blocks

    @classmethod
    def coerce(cls, value: "Strategy | str") -> "Strategy":
        if isinstance(value, cls):
            return value
        try:
            return cls(value)
        except ValueError:
            raise ValueError(
                f"unknown strategy {value!r}; known: {[s.value for s in cls]}"
            ) from None


class Controller(enum.Enum):
    """Memory-controller behaviour for partial sums (paper Section III)."""

    PASSIVE = "passive"   # read-before-update crosses the interconnect
    ACTIVE = "active"     # in-controller add; only new psums cross the bus

    @classmethod
    def coerce(cls, value: "Controller | str") -> "Controller":
        if isinstance(value, cls):
            return value
        try:
            return cls(value)
        except ValueError:
            raise ValueError(
                f"unknown controller {value!r}; known: {[c.value for c in cls]}"
            ) from None


@dataclasses.dataclass(frozen=True)
class Schedule:
    """One execution schedule, for either workload kind.

    kind == "conv":    bm = m (input-map block, the reduction axis),
                       bn = n (output-map block), bk = 0.
    kind == "matmul":  bm x bn output tile, bk reduction tile.
    """

    kind: str                                  # "conv" | "matmul"
    bm: int
    bn: int
    bk: int = 0
    controller: Controller = Controller.PASSIVE

    def __post_init__(self):
        if self.kind not in ("conv", "matmul"):
            raise ValueError(f"unknown schedule kind {self.kind!r}")
        if self.bm < 1 or self.bn < 1 or self.bk < 0:
            raise ValueError(f"non-positive blocks in {self}")
        if self.kind == "matmul" and self.bk < 1:
            raise ValueError(f"matmul schedule needs a reduction block: {self}")

    @property
    def m(self) -> int:
        """The paper's m (input feature maps per iteration)."""
        return self.bm

    @property
    def n(self) -> int:
        """The paper's n (output feature maps per iteration)."""
        return self.bn
