"""`repro_torch.check`: the port's static plan verifier, launch pre-flight
and word-count certificates.

One diagnostic currency (`Diagnostic`, the reference's stable ``RPC`` codes):

  * **IR verifier** (`check`, `verify`): Schedules satisfy eq (1) and the
    block/extent/on-chip budgets, Plans' recorded traffic matches the model
    word for word and byte for byte, NetworkGraph edges conserve words and
    carry consistent dtypes, NetPlans' residency sets fit their budget over
    live intervals. The ``checked=True`` modes of ``plan``, ``plan_graph``,
    ``NetPlan.replan`` and ``fleet.plan_graphs`` call it.
  * **Launch pre-flight** (`check.kernels`, RPC03x): a kernel's `LaunchPlan`
    (grid, operand blocks, shared memory, register tile) before anything
    runs; `run_network_kernels` always pre-flights its launches.
  * **Word-count certificates** (`check.dataflow`, RPC04x): the model-level
    words a launch moves, derived from its plan, equal eqs (2)/(3), for one
    launch or a whole search space, with the device-level words beside.

The reference's Pallas-body interpreter (``footprint.py``, RPC041 and
RPC044) has no counterpart: a CUDA body has no trace. Its codebase lint
(``repro.check.lint``) already lints this package.

CLI: ``python -m repro_torch.check [--plans] [--dataflow] [--github]``.
"""

from repro_torch.check.api import check_plans, verify
from repro_torch.check.dataflow import (DataflowReport, DeviceWords,
                                        SpaceCertificate, certify_conv_space,
                                        certify_matmul_space, check_dataflow,
                                        check_network_dataflow, conv_dataflow,
                                        flash_dataflow, matmul_dataflow,
                                        preflight_flash_dataflow)
from repro_torch.check.diagnostics import (CODES, CheckError, CodeInfo,
                                           Diagnostic, Severity, code_table,
                                           errors, raise_on_error, render_all)
from repro_torch.check.kernels import (check_conv_launch, check_flash_launch,
                                       check_launch, check_matmul_launch,
                                       check_network_kernels,
                                       clear_preflight_cache,
                                       preflight_flash_launch,
                                       preflight_network_kernels)
from repro_torch.check.passes import (check, check_graph, check_netplan,
                                      check_plan, check_schedule,
                                      check_traffic, check_workload, summarize)

__all__ = [
    "Diagnostic", "Severity", "CodeInfo", "CODES", "CheckError",
    "errors", "raise_on_error", "render_all", "code_table",
    "check", "verify", "summarize", "check_plans",
    "check_workload", "check_schedule", "check_traffic", "check_plan",
    "check_graph", "check_netplan",
    "check_launch", "check_conv_launch", "check_matmul_launch",
    "check_flash_launch", "check_network_kernels", "clear_preflight_cache",
    "preflight_network_kernels", "preflight_flash_launch",
    "DataflowReport", "DeviceWords", "SpaceCertificate",
    "conv_dataflow", "matmul_dataflow", "flash_dataflow",
    "certify_conv_space", "certify_matmul_space", "check_dataflow",
    "check_network_dataflow", "preflight_flash_dataflow",
]
