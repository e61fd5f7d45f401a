"""`LaunchPlan`: a kernel launch as data, and `run`, the one place that
executes one.

A plan names its CUDA grid, threads and shared memory, the in-block loops
that replace the reference's sequential grid axes, its (padded) operands and
its accumulator, plus two callables over the same padded operands:

  ``cuda``   launches the hand-written Hopper kernel(s) from ``csrc/``;
  ``plain``  the same loop nest in plain PyTorch.

`run` sends CUDA tensors to ``cuda`` and CPU tensors to ``plain``; there is
no fallback from one to the other. Each CUDA wrapper adds one to
``LAUNCHES[name]`` where it launches its kernel, and nowhere else, so a run
can show that it went through the kernels.

`run` is spanned as ``kernel.launch`` (`repro_torch.obs`; attributes
``plan``, ``grid``, ``device``, ``body`` and ``launches``, the plan's kernel
launches per call with its pack and combine passes). The span is a host
interval: it measures the checks, the wrapper and the launch calls, not the
card's execution, which runs on the stream after it. Under CUDA-graph
capture (`repro_torch.launch.graph`) the span records the capture; a replay
runs no Python and records nothing, as a span inside ``jax.jit`` records
only when the function is traced.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable, Iterator

import torch

from repro_torch.obs.trace import span

#: kernel launches per kernel name since the last `reset_launches`
LAUNCHES: dict[str, int] = {}


def count_launch(name: str) -> None:
    LAUNCHES[name] = LAUNCHES.get(name, 0) + 1


def reset_launches() -> None:
    LAUNCHES.clear()


def add_launches(counts: dict[str, int]) -> None:
    """Add a recorded set of launches: a CUDA graph's replay launches again
    every kernel its capture recorded, with no wrapper running."""
    for name, n in counts.items():
        LAUNCHES[name] = LAUNCHES.get(name, 0) + n


@contextlib.contextmanager
def recording() -> Iterator[dict[str, int]]:
    """The launches counted in the body, moved out of `LAUNCHES` into the
    dict this yields: a graph's warm-up, whose launches are not counted,
    and its capture, which launches nothing itself and whose count each
    replay adds (`add_launches`)."""
    before = dict(LAUNCHES)
    counted: dict[str, int] = {}
    try:
        yield counted
    finally:
        counted.update({name: n - before.get(name, 0)
                        for name, n in LAUNCHES.items()
                        if n != before.get(name, 0)})
        LAUNCHES.clear()
        LAUNCHES.update(before)


def resolve_device(device: "str | torch.device") -> torch.device:
    """The device an entry point runs on. Asking for CUDA where there is no
    GPU raises: nothing falls back to the CPU."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' requested but no CUDA device is "
                           "available; pass device='cpu' to run the plain "
                           "PyTorch path")
    return device


def check_operands(name: str, *ops: torch.Tensor, dtypes) -> None:
    """What every CUDA wrapper checks before it launches: one supported
    dtype, contiguous memory, one device."""
    if ops[0].dtype not in dtypes or any(op.dtype != ops[0].dtype for op in ops):
        raise ValueError(f"{name}: takes operands of one type out of "
                         f"{sorted(map(str, dtypes))}, got "
                         f"{[str(op.dtype) for op in ops]}")
    if not all(op.is_contiguous() for op in ops):
        raise ValueError(f"{name}: operands must be contiguous")
    if len({op.device for op in ops}) != 1:
        raise ValueError(f"{name}: operands on {[str(op.device) for op in ops]}")


@dataclasses.dataclass(frozen=True)
class OperandPlan:
    """One operand: its full (padded) shape and the block one step reads."""

    name: str
    array_shape: tuple[int, ...]
    block_shape: tuple[int, ...]


@dataclasses.dataclass(frozen=True)
class ScratchPlan:
    """One buffer a block keeps for the whole launch: on chip, or in device
    memory where the kernel spills its partial sums there."""

    name: str
    shape: tuple[int, ...]
    where: str = "registers"      # "registers" | "shared" | "device"


@dataclasses.dataclass(frozen=True)
class LaunchPlan:
    """A complete launch description.

    grid     CUDA grid (x, y), one block per output tile
    threads  threads per block; smem_bytes dynamic shared memory per block
    launches kernel launches per call (the passive GEMM launches once per
             k-step)
    loops    (axis, trip count) of the loops inside a block, outermost first
    body     which kernel body runs, where a source holds more than one
    """

    name: str
    grid: tuple[int, ...]
    threads: int
    smem_bytes: int
    launches: int
    loops: tuple[tuple[str, int], ...]
    inputs: tuple[OperandPlan, ...]
    outputs: tuple[OperandPlan, ...]
    scratch: tuple[ScratchPlan, ...]
    cuda: Callable[..., torch.Tensor]
    plain: Callable[..., torch.Tensor]
    body: str = ""


def run(plan: LaunchPlan, *operands: torch.Tensor, **extra) -> torch.Tensor:
    """Execute a plan on its operands' device. ``extra`` (values that are
    not operands, such as flash attention's device position) goes to
    either callable as it is."""
    if len(operands) != len(plan.inputs):
        raise ValueError(f"{plan.name}: got {len(operands)} operands, plan "
                         f"has {len(plan.inputs)} inputs")
    for op, spec in zip(operands, plan.inputs):
        if tuple(op.shape) != spec.array_shape:
            raise ValueError(f"{plan.name}: operand {spec.name} shaped "
                             f"{tuple(op.shape)}, plan needs {spec.array_shape}")
    devices = {op.device.type for op in operands}
    if devices in ({"cuda"}, {"cpu"}):
        (device,) = devices
        with span("kernel.launch", cat="kernel", plan=plan.name,
                  grid=plan.grid, device=device, body=plan.body,
                  launches=plan.launches):
            if device == "cuda":
                return plan.cuda(*operands, **extra)
            return plan.plain(*operands, **extra)
    raise ValueError(f"{plan.name}: operands on {sorted(devices)}; they must "
                     f"all be on one CUDA device or all on the CPU")
