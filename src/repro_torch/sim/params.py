"""Hardware parameters for the cycle-approximate memory-hierarchy simulator.

The modelled system is the paper's SoC (Fig. 1):

    DRAM channel -- memory controller (+ accumulator SRAM) -- interconnect
                 -- compute engine (DMA + input SRAM + MAC array)

  * Feature maps / GEMM operands stream from the **DRAM channel** through the
    controller and over the interconnect into the engine's input SRAM. The
    channel is modelled with burst-size and open-page (row-buffer) accounting:
    a burst to an open row costs ``t_burst`` engine cycles, touching a new row
    adds ``t_row_miss`` (precharge + activate).
  * Partial sums accumulate in the **controller-side SRAM** (banked, with
    read/write ports). The passive vs. active controller is purely a port
    policy: passive round-trips the old value over the interconnect
    (read-before-update, eqs 2-3); active performs the read-modify-write at
    the controller so only the new partial sums cross the bus (Section III).
  * A **DMA engine** prefetches the next iteration's input block while the
    current one computes (double-buffered; disable with
    ``dma_double_buffer=False`` to serialize fetch and compute).

Weights are assumed engine-resident (the paper's model never counts them);
GEMM B-operand (weight) reads *are* counted, matching ``plan.gemm_model``.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class DramParams:
    """One DRAM/HBM channel with burst + open-page (row-buffer) accounting."""

    burst_bytes: int = 64       # BL8 x 64-bit bus: bytes moved per burst
    row_bytes: int = 2048       # open row (page) size per bank
    banks: int = 8              # concurrently open rows
    t_burst: int = 4            # engine cycles a burst occupies the channel
    t_row_miss: int = 40        # extra cycles per row activation (tRP + tRCD)

    def __post_init__(self) -> None:
        if self.burst_bytes < 1 or self.row_bytes < self.burst_bytes:
            raise ValueError(f"need row_bytes >= burst_bytes >= 1, got {self}")


@dataclasses.dataclass(frozen=True)
class SramParams:
    """A banked SRAM (controller accumulator / engine input buffer).

    Defaults model a dual-ported accumulator SRAM with 32-byte lines —
    wide enough that the interconnect, not the SRAM array, is the usual
    bottleneck. Set ``ports_per_bank=1`` to study the single-ported case:
    every read-modify-write pair then serializes on its bank and is counted
    as a bank conflict.
    """

    banks: int = 8
    ports_per_bank: int = 2     # 1 => a read-modify-write serializes its bank
    width_words: int = 8        # words per port access (a 32B line at fp32)

    @property
    def words_per_cycle(self) -> int:
        return self.banks * self.ports_per_bank * self.width_words


@dataclasses.dataclass(frozen=True)
class SimParams:
    """Full machine description for one simulation run."""

    dram: DramParams = DramParams()
    sram: SramParams = SramParams()
    bus_bytes_per_cycle: int = 16    # interconnect width (128-bit AXI-ish)
    macs_per_cycle: int = 2048       # the engine's P (eq 1's MAC budget)
    clock_ghz: float = 1.0
    dma_double_buffer: bool = True   # prefetch next input block during compute

    def __post_init__(self) -> None:
        if self.bus_bytes_per_cycle < 1 or self.macs_per_cycle < 1:
            raise ValueError(f"non-positive throughput in {self}")
        if self.clock_ghz <= 0:
            raise ValueError(f"non-positive clock in {self}")

    @property
    def cycle_s(self) -> float:
        return 1.0 / (self.clock_ghz * 1e9)


DEFAULT_PARAMS = SimParams()
