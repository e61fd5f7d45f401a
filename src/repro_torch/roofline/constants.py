"""The card's machine numbers (the roofline's target) and the shared
per-access energy table every energy model of the port consumes.

The peak and the memory rate are the NVIDIA H100 80GB HBM3's (SXM, data
sheet, at its 700.00 W power limit, the card `PERF.md` reports on): dense
bf16 tensor-core operations and HBM3 bytes per second.
`repro_torch.plan.objectives.roofline_latency` prices a schedule with them.

The energy numbers are Horowitz-style (ISSCC'14 scale) relative weights of
the paper's SoC, not a measurement of any card: moving a byte across the SoC
interconnect costs about an order of magnitude more than an SRAM access, and
a DRAM access more still, with a large fixed cost per row activation. Only
the ratios matter for argmin-style planning. Both
`repro_torch.plan.objectives.energy_bytes` and the simulator
(`repro_torch.sim`) price bytes from this one table, so the two paths agree
by construction. It is defined here and nowhere else
(`tests/test_torch_lint.py` holds the rule).
"""

PEAK_FLOPS_BF16 = 989e12      # FLOP/s: H100 80GB HBM3, dense bf16
HBM_BW = 3.35e12              # bytes/s: H100 80GB HBM3

# --- shared energy table (pJ) -----------------------------------------------
PJ_SRAM_BYTE = 0.25           # engine/controller SRAM access
PJ_INTERCONNECT_BYTE = 2.0    # SoC interconnect / device-memory transfer
PJ_DRAM_BYTE = 4.0            # DRAM channel burst data movement
PJ_DRAM_ROW_ACT = 1500.0      # one row activation (precharge + activate)
