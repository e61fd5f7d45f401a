"""Energy accounting for the simulator, priced from the one shared table.

The base terms (interconnect bytes, SRAM bytes) use the constants
``repro_torch.plan.objectives.energy_bytes`` uses, so the two paths agree
whenever the word counts agree (`tests/test_torch_sim.py`). The simulator
adds the second-order DRAM terms the first-order objective cannot see:
per-byte burst movement and a fixed cost per row activation, so schedules
that thrash the row buffer pay for it in ``sim_energy``.

The table lives in `repro_torch.roofline.constants`; the reference's names
for its entries (``ENERGY_PJ_*``) are re-exported here.
"""

from __future__ import annotations

from repro_torch.roofline.constants import PJ_DRAM_BYTE as ENERGY_PJ_DRAM_BYTE
from repro_torch.roofline.constants import \
    PJ_DRAM_ROW_ACT as ENERGY_PJ_DRAM_ROW_ACT
from repro_torch.roofline.constants import \
    PJ_INTERCONNECT_BYTE as ENERGY_PJ_INTERCONNECT_BYTE
from repro_torch.roofline.constants import PJ_SRAM_BYTE as ENERGY_PJ_SRAM_BYTE

__all__ = [
    "ENERGY_PJ_DRAM_BYTE", "ENERGY_PJ_DRAM_ROW_ACT",
    "ENERGY_PJ_INTERCONNECT_BYTE", "ENERGY_PJ_SRAM_BYTE",
    "energy_breakdown",
]


def energy_breakdown(interconnect_bytes: float, sram_bytes: float,
                     dram_bytes: float, row_activations: float
                     ) -> dict[str, float]:
    """Per-component energy (pJ). ``interconnect + sram`` is bit for bit the
    first-order ``energy_bytes`` objective; the ``dram_*`` terms are the
    simulator's second-order extension."""
    return {
        "interconnect": interconnect_bytes * ENERGY_PJ_INTERCONNECT_BYTE,
        "sram": sram_bytes * ENERGY_PJ_SRAM_BYTE,
        "dram_bytes": dram_bytes * ENERGY_PJ_DRAM_BYTE,
        "dram_row_act": row_activations * ENERGY_PJ_DRAM_ROW_ACT,
    }
