"""Typed schedule vocabulary: `Strategy`, `Controller` and `Schedule`.

`Schedule` is the one execution-schedule type the kernels consume. For a
conv, ``bm``/``bn`` are the paper's m input maps and n output maps per
iteration (eq 1) and ``bk`` is 0 (space is never tiled by the planner). For a
GEMM, ``bm`` x ``bn`` is the output tile and ``bk`` the reduction block.
`Partition` is the paper's bare (m, n) pair, which the meter
(`repro_torch.core.amc`) also takes; a conv `Schedule` round-trips through
it (``from_partition`` / ``as_partition``).
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
class Partition:
    """Channel partition: m input maps x n output maps per iteration."""

    m: int
    n: int

    def macs(self, k: int) -> int:
        return k * k * self.m * self.n


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

    def macs(self, k: int) -> int:
        """eq (1) left-hand side: K^2 * m * n."""
        return k * k * self.bm * self.bn

    @classmethod
    def from_partition(cls, part: Partition,
                       controller: "Controller | str" = Controller.PASSIVE
                       ) -> "Schedule":
        return cls(kind="conv", bm=part.m, bn=part.n, bk=0,
                   controller=Controller.coerce(controller))

    def as_partition(self) -> Partition:
        if self.kind != "conv":
            raise ValueError(f"not a conv schedule: {self}")
        return Partition(m=self.bm, n=self.bn)

    @classmethod
    def from_blocks(cls, blocks, controller: "Controller | str" = Controller.ACTIVE
                    ) -> "Schedule":
        """From a `gemm_model.MatmulBlocks` (or anything with bm/bn/bk)."""
        return cls(kind="matmul", bm=blocks.bm, bn=blocks.bn, bk=blocks.bk,
                   controller=Controller.coerce(controller))

    def as_blocks(self):
        if self.kind != "matmul":
            raise ValueError(f"not a matmul schedule: {self}")
        from repro_torch.plan.gemm_model import MatmulBlocks
        return MatmulBlocks(bm=self.bm, bn=self.bn, bk=self.bk)

    def vmem_bytes(self, in_bytes: int | None = None,
                   acc_bytes: int | None = None,
                   double_buffer: bool = True, *, workload=None) -> int:
        """The planner's on-chip bytes of a matmul schedule: the operand
        blocks (twice when double-buffered) plus the accumulator tile, the
        reference's formula (`gemm_model.MatmulBlocks.vmem_bytes`).

        Element widths resolve in order: explicit ``in_bytes``/``acc_bytes``
        > the ``workload``'s dtypes > bf16 operands and an fp32
        accumulator. These are the bytes the planner's budget bounds
        (RPC006), not what a kernel body holds: the card's ``tc_bf16``
        block keeps its accumulator in registers and stages k-chunks in
        shared memory (`repro_torch.check.kernels`, RPC032).
        """
        if workload is not None:
            in_bytes = workload.in_dtype.itemsize if in_bytes is None else in_bytes
            acc_bytes = workload.acc_dtype.itemsize if acc_bytes is None else acc_bytes
        in_bytes = 2 if in_bytes is None else in_bytes
        acc_bytes = 4 if acc_bytes is None else acc_bytes
        return self.as_blocks().vmem_bytes(in_bytes, acc_bytes, double_buffer)
