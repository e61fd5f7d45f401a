"""Behavioural model of the paper's active memory controller (Section III),
with its SRAM and values as tensors on a device.

The controller owns an SRAM region and accepts commands over the
interconnect (the paper signals them through AXI4 'awuser' sideband bits):

  NORMAL   plain read/write (passive behaviour)
  ADD      read-update-write inside the controller: the compute engine ships
           only the new partial sum; the old value never crosses the
           interconnect
  ACT      like ADD, with an activation (ReLU here) after the final update

Every word crossing the interconnect and every SRAM access is tallied as a
Python int, so the model (`repro_torch.plan.TrafficReport`,
`plan.netplan.network_report`) is checked against an executable
implementation word for word (`validate_schedule`, `validate_network`), and
the convolution against a plain one.

The block conv is an unfold and one ``torch.matmul`` per (cout block, cin
block), TF32 off: the loop nest's arithmetic, not a kernel of the port.
Inputs and weights are drawn from ``np.random.default_rng(rng_seed)`` in the
reference's order, then moved to ``device``, so a walk's values are the
reference meter's on the same seed. Entry points run on ``device="cuda"``
unless the caller passes the CPU; nothing falls back.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Iterator

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core.cnn_zoo import ConvLayer
from repro_torch.kernels.launch import resolve_device
from repro_torch.plan.schedule import Controller, Partition, Schedule
from repro_torch.plan.traffic import TrafficReport, conv_traffic
from repro_torch.plan.workload import ConvWorkload


@dataclasses.dataclass
class TrafficMeter:
    interconnect_words: int = 0   # words crossing the bus (the paper's "BW")
    sram_reads: int = 0
    sram_writes: int = 0

    def as_dict(self) -> dict[str, int]:
        return dataclasses.asdict(self)


@dataclasses.dataclass(frozen=True)
class AccessEvent:
    """One metered access burst of the loop nest; the per-field counts of a
    stream sum to the `TrafficMeter` totals."""

    op: str                   # "fetch" | "read" | "write" | "add" | "act"
    target: str               # "input" | "acc"
    words: int
    interconnect_words: int
    sram_reads: int
    sram_writes: int


@contextlib.contextmanager
def _exact_fp32() -> Iterator[None]:
    """float32 products in float32, not TF32, for the body of a walk."""
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


class MemoryController:
    """SRAM + controller with optional active (in-controller add) support.
    The SRAM is a float32 tensor on ``device``. Pass ``trace=[]`` to also
    record every access burst as an `AccessEvent`."""

    def __init__(self, shape: tuple[int, ...], active: bool,
                 trace: "list[AccessEvent] | None" = None, device="cuda"):
        self.sram = torch.zeros(shape, dtype=torch.float32,
                                device=resolve_device(device))
        self.active = active
        self.meter = TrafficMeter()
        self.trace = trace

    def _record(self, op: str, words: int, bus: int, reads: int,
                writes: int) -> None:
        if self.trace is not None:
            self.trace.append(AccessEvent(op=op, target="acc", words=words,
                                          interconnect_words=bus,
                                          sram_reads=reads,
                                          sram_writes=writes))

    # -- passive interface ---------------------------------------------------
    def read(self, idx) -> torch.Tensor:
        vals = self.sram[idx]
        n = vals.numel()
        self.meter.sram_reads += n
        self.meter.interconnect_words += n
        self._record("read", n, n, n, 0)
        return vals.clone()

    def write(self, idx, vals: torch.Tensor) -> None:
        self.sram[idx] = vals
        n = vals.numel()
        self.meter.sram_writes += n
        self.meter.interconnect_words += n
        self._record("write", n, n, 0, n)

    # -- accumulate: routed through the controller when active ----------------
    def accumulate(self, idx, vals: torch.Tensor, first: bool,
                   last: bool = False, act: bool = False) -> None:
        """Add a partial-sum tile. Passive: the engine reads the old value
        over the bus, adds, writes back. Active: a single ADD command carries
        only the new values; the read-modify-write stays inside the SRAM."""
        n = vals.numel()
        if first:
            self.write(idx, vals)
        elif self.active:
            self.sram[idx] += vals
            self.meter.sram_reads += n          # internal, not on the bus
            self.meter.sram_writes += n
            self.meter.interconnect_words += n  # only the new partial sums
            self._record("add", n, n, n, n)
        else:
            old = self.read(idx)                # read-back over the bus
            self.write(idx, old + vals)
        if last and act:
            # activation offload: in-controller ReLU, no bus words when
            # active; a passive engine reads and writes once more
            if self.active:
                self.sram[idx] = torch.relu(self.sram[idx])
                self.meter.sram_reads += n
                self.meter.sram_writes += n
                self._record("act", n, 0, n, n)
            else:
                self.write(idx, torch.relu(self.read(idx)))


def _im2col(x: torch.Tensor, k: int, stride: int, pad: int) -> torch.Tensor:
    """(cin * k * k, ho * wo) columns of one (cin, h, w) image, rows in the
    (channel, dy, dx) order of an OIHW weight's flattening."""
    return F.unfold(x[None], k, padding=pad, stride=stride)[0]


def _conv2d_block(x: torch.Tensor, w: torch.Tensor, stride: int,
                  pad: int) -> torch.Tensor:
    """Plain conv (cin block -> cout block), CHW / OIHW, float32."""
    cout, _, kh, _ = w.shape
    ho = (x.shape[1] + 2 * pad - kh) // stride + 1
    wo = (x.shape[2] + 2 * pad - kh) // stride + 1
    with _exact_fp32():
        out = w.reshape(cout, -1) @ _im2col(x, kh, stride, pad)
    return out.reshape(cout, ho, wo)


def _as_schedule(part: "Schedule | Partition", active: bool | None
                 ) -> tuple[Partition, bool]:
    if isinstance(part, Schedule):
        if active is None:
            active = part.controller is Controller.ACTIVE
        return part.as_partition(), active
    if active is None:
        raise TypeError("active= is required when part is a bare Partition")
    return part, active


def run_partitioned_conv(layer: ConvLayer, part: "Schedule | Partition",
                         x, w, active: bool | None = None,
                         pad: int | None = None, act: bool = False,
                         trace: "list[AccessEvent] | None" = None,
                         device="cuda") -> tuple[torch.Tensor, TrafficMeter]:
    """Execute the paper's partitioned loop nest with an instrumented memory
    controller on ``device``, returning (output, traffic). ``x``: (cin, hi,
    wi) float32, ``w``: (cout, cin, k, k), numpy arrays or tensors. Input
    reads are metered too (input SRAM).

    ``part`` is a `Schedule` (whose controller selects the behaviour) or a
    bare `Partition` (then ``active`` must be given); an explicit ``active``
    always wins. ``trace=[]`` records the access-event stream."""
    if layer.groups != 1:
        raise ValueError("the meter models dense convs (groups == 1)")
    part, active = _as_schedule(part, active)
    device = resolve_device(device)
    x = torch.as_tensor(x, dtype=torch.float32).to(device)
    w = torch.as_tensor(w, dtype=torch.float32).to(device)
    pad = layer.k // 2 if pad is None else pad
    m, n = min(part.m, layer.cin), min(part.n, layer.cout)
    kk = layer.k * layer.k
    out_ctrl = MemoryController((layer.cout, layer.ho, layer.wo), active,
                                trace=trace, device=device)
    in_meter = TrafficMeter()
    cols = _im2col(x, layer.k, layer.stride, pad)
    n_in_blocks = math.ceil(layer.cin / m)
    with _exact_fp32():
        for co0 in range(0, layer.cout, n):
            co1 = min(co0 + n, layer.cout)
            for bi, ci0 in enumerate(range(0, layer.cin, m)):
                ci1 = min(ci0 + m, layer.cin)
                size = (ci1 - ci0) * layer.hi * layer.wi
                in_meter.interconnect_words += size
                in_meter.sram_reads += size
                if trace is not None:
                    trace.append(AccessEvent(op="fetch", target="input",
                                             words=size,
                                             interconnect_words=size,
                                             sram_reads=size, sram_writes=0))
                psum = (w[co0:co1, ci0:ci1].reshape(co1 - co0, -1)
                        @ cols[ci0 * kk:ci1 * kk]).reshape(
                            co1 - co0, layer.ho, layer.wo)
                out_ctrl.accumulate(slice(co0, co1), psum, first=(bi == 0),
                                    last=(bi == n_in_blocks - 1), act=act)
    return out_ctrl.sram.clone(), TrafficMeter(
        interconnect_words=in_meter.interconnect_words
        + out_ctrl.meter.interconnect_words,
        sram_reads=in_meter.sram_reads + out_ctrl.meter.sram_reads,
        sram_writes=out_ctrl.meter.sram_writes)


def _draw_layer(layer: ConvLayer, rng_seed: int) -> tuple[np.ndarray, np.ndarray]:
    rng = np.random.default_rng(rng_seed)
    x = rng.standard_normal((layer.cin, layer.hi, layer.wi)).astype(np.float32)
    w = rng.standard_normal((layer.cout, layer.cin, layer.k,
                             layer.k)).astype(np.float32)
    return x, w


def access_trace(layer: ConvLayer, part: "Schedule | Partition",
                 active: bool | None = None, rng_seed: int = 0,
                 device="cuda") -> list[AccessEvent]:
    """The access-event stream the partitioned loop nest generates for a
    schedule on seeded data; its field sums equal the `TrafficMeter` (and
    so the model's `TrafficReport`)."""
    x, w = _draw_layer(layer, rng_seed)
    trace: list[AccessEvent] = []
    run_partitioned_conv(layer, part, x, w, active=active, trace=trace,
                         device=device)
    return trace


def analytical_report(layer: ConvLayer, part: "Schedule | Partition",
                      active: bool | None = None) -> TrafficReport:
    """The `TrafficReport` the model predicts for the metered loop (ceil
    iteration counts)."""
    if isinstance(part, Schedule):
        sched = part if active is None else dataclasses.replace(
            part, controller=Controller.ACTIVE if active else Controller.PASSIVE)
    else:
        if active is None:
            raise TypeError("active= is required when part is a bare Partition")
        sched = Schedule.from_partition(
            part, Controller.ACTIVE if active else Controller.PASSIVE)
    return conv_traffic(ConvWorkload.from_layer(layer), sched, exact_iters=True)


def analytical_interconnect_words(layer: ConvLayer,
                                  part: "Schedule | Partition",
                                  active: bool | None = None) -> float:
    """What the model predicts for the metered loop's bus words."""
    return analytical_report(layer, part, active).interconnect_words


def validate_sweep(rows, spatial: int = 8, max_rows: int | None = None,
                   device="cuda") -> int:
    """Hold a ``dse.sweep(per_layer=True)`` result against the meter: every
    dense conv row's schedule runs through the metered loop nest, whose
    interconnect and SRAM counts must equal the model's `TrafficReport`.
    Layers are shrunk to ``spatial`` x ``spatial`` maps (channels stay
    real); the model is exact at any spatial size. Grouped convs are
    skipped. Returns the number of rows validated."""
    checked = 0
    for row in rows:
        schedule = row.get("schedule")
        workload = row.get("workload")
        if schedule is None or workload is None:
            raise ValueError(
                "validate_sweep needs per-layer rows: call "
                "dse.sweep(..., per_layer=True)")
        if schedule.kind != "conv" or workload.groups > 1:
            continue
        if max_rows is not None and checked >= max_rows:
            break
        layer = dataclasses.replace(workload.to_layer(), wi=spatial,
                                    hi=spatial, wo=spatial, ho=spatial,
                                    stride=1)
        validate_schedule(layer, schedule, device=device)
        checked += 1
    return checked


def draw_network(graph, rng_seed: int = 0, device="cuda"
                 ) -> tuple[dict[str, torch.Tensor], dict[str, torch.Tensor]]:
    """The inputs and weights a metered walk of ``graph`` draws: ({input
    tensor: (C, H, W)}, {conv node: (Cout, Cin, K, K) fan-in scaled}), from
    ``np.random.default_rng(rng_seed)`` in node order, as the reference's
    ``run_network`` draws them, moved to ``device``. Handing them to
    `run_network_kernels` runs the same network on the card's kernels."""
    device = resolve_device(device)
    rng = np.random.default_rng(rng_seed)
    inputs, weights = {}, {}
    for node in graph.nodes:
        if node.op == "input":
            t = graph.tensors[node.out]
            inputs[node.out] = torch.from_numpy(rng.standard_normal(
                (t.channels, t.h, t.w)).astype(np.float32)).to(device)
        elif node.workload is not None:
            wl = node.workload
            weights[node.name] = torch.from_numpy((rng.standard_normal(
                (wl.cout, wl.cin, wl.k, wl.k))
                / math.sqrt(wl.cin * wl.k * wl.k)).astype(np.float32)).to(device)
    return inputs, weights


def _virtual(graph, node, values: dict) -> torch.Tensor:
    """A virtual node of the walk (a residual add or a shape-preserving
    pool), which moves no modelled traffic."""
    ins = [values[t] for t in node.ins]
    if node.op == "add":
        return ins[0] + ins[1]
    if node.op == "pool":
        t = graph.tensors[node.out]
        if tuple(ins[0].shape) != (t.channels, t.h, t.w):
            raise NotImplementedError(
                f"{node.name}: shape-changing pools are not executable; "
                f"shrink() the graph first")
        return ins[0]
    raise NotImplementedError(f"virtual op {node.op!r}")


def run_network(graph, schedules: dict[str, Schedule],
                resident=frozenset(), active: bool | None = None,
                rng_seed: int = 0, device="cuda"
                ) -> tuple[dict[str, torch.Tensor], TrafficMeter]:
    """Walk a conv `NetworkGraph` through instrumented memory on ``device``,
    with tensor residency: every conv node runs the partitioned loop nest
    against a `MemoryController`, and tensors in ``resident`` live in an
    engine-side residency buffer: their reads and writes are local accesses
    (counted in the SRAM tallies) that never cross the interconnect. Virtual
    nodes (pool / add / input) move no modelled traffic, as in
    `plan.netplan.network_report`, which this walk equals word for word.

    The graph must be dense (groups == 1) with "same"-padded shapes: use
    ``NetworkGraph.shrink()`` on zoo nets. Inputs and weights are
    `draw_network`'s. Returns ({tensor name: value}, total TrafficMeter).
    """
    device = resolve_device(device)
    resident = frozenset(resident)
    if active is None:
        active = any(s.controller is Controller.ACTIVE
                     for s in schedules.values())
    inputs, weights = draw_network(graph, rng_seed, device)
    values: dict[str, torch.Tensor] = {}
    meter = TrafficMeter()
    with _exact_fp32():
        for node in graph.nodes:
            if node.op == "input":
                values[node.out] = inputs[node.out]
                continue
            if node.workload is None:
                values[node.out] = _virtual(graph, node, values)
                continue
            wl = node.workload
            sched = schedules[node.name]
            if wl.groups != 1:
                raise ValueError(f"{node.name}: the meter models dense convs")
            pad = wl.k // 2
            if (wl.hi + 2 * pad - wl.k) // wl.stride + 1 != wl.ho:
                raise ValueError(f"{node.name}: not 'same'-padded; shrink() "
                                 f"first")
            x = torch.cat([values[t] for t in node.ins], dim=0)
            w = weights[node.name]
            m, n = min(sched.m, wl.cin), min(sched.n, wl.cout)
            kk = wl.k * wl.k
            # input channel ranges of each in-edge, for per-edge bus words
            spans, off = [], 0
            for tname in node.ins:
                c = graph.tensors[tname].channels
                spans.append((off, off + c, tname in resident))
                off += c
            cols = _im2col(x, wl.k, wl.stride, pad)
            out_ctrl = MemoryController((wl.cout, wl.ho, wl.wo), active,
                                        device=device)
            n_in_blocks = math.ceil(wl.cin / m)
            for co0 in range(0, wl.cout, n):
                co1 = min(co0 + n, wl.cout)
                for bi, ci0 in enumerate(range(0, wl.cin, m)):
                    ci1 = min(ci0 + m, wl.cin)
                    for lo, hi, res in spans:
                        ov = min(ci1, hi) - max(ci0, lo)
                        if ov <= 0:
                            continue
                        sz = ov * wl.hi * wl.wi
                        meter.sram_reads += sz      # input SRAM / residency
                        if not res:
                            meter.interconnect_words += sz
                    psum = (w[co0:co1, ci0:ci1].reshape(co1 - co0, -1)
                            @ cols[ci0 * kk:ci1 * kk]).reshape(
                                co1 - co0, wl.ho, wl.wo)
                    out_ctrl.accumulate(slice(co0, co1), psum,
                                        first=(bi == 0),
                                        last=(bi == n_in_blocks - 1))
            # a resident output does the same accesses in the engine-side
            # buffer; only the interconnect charge disappears
            meter.sram_reads += out_ctrl.meter.sram_reads
            meter.sram_writes += out_ctrl.meter.sram_writes
            if node.out not in resident:
                meter.interconnect_words += out_ctrl.meter.interconnect_words
            values[node.out] = out_ctrl.sram
    return values, meter


def _reference_network(graph, inputs: dict, weights: dict) -> dict:
    """Unpartitioned evaluation of the same graph (one conv a node)."""
    values = dict(inputs)
    for node in graph.nodes:
        if node.op == "input":
            continue
        if node.workload is None:
            values[node.out] = _virtual(graph, node, values)
            continue
        wl = node.workload
        x = torch.cat([values[t] for t in node.ins], dim=0)
        values[node.out] = _conv2d_block(x, weights[node.name], wl.stride,
                                         wl.k // 2)
    return values


def _assert_close(got: torch.Tensor, want: torch.Tensor, tol: float,
                  what: str) -> None:
    if got.shape != want.shape or not torch.allclose(got, want, rtol=tol,
                                                     atol=tol):
        raise AssertionError(f"{what}: values differ from the unpartitioned "
                             f"conv (max abs err "
                             f"{(got - want).abs().max().item():.3g})")


def validate_network(graph_or_name, p_macs: int = 2048,
                     strategy="exact_opt", controller="passive",
                     residency_bytes: int | None = None, spatial: int = 8,
                     channel_div: int = 8, rng_seed: int = 0, device="cuda"):
    """Plan a network graph with the fused-residency planner, walk it
    through the meter and hold the network totals against the model:
    interconnect words, SRAM reads and SRAM writes must equal
    `network_report`'s, and the outputs the unpartitioned walk's. Zoo
    names are shrunk (``spatial`` x ``spatial``, channels /
    ``channel_div``); the model is exact at any spatial size.

    ``residency_bytes=None`` takes a third of the graph's tensor bytes,
    which holds some edges resident and spills others. Returns (NetPlan,
    TrafficMeter, TrafficReport); raises AssertionError on any mismatch.
    """
    from repro_torch.plan.graph import NetworkGraph
    from repro_torch.plan.netplan import network_report, plan_graph

    if isinstance(graph_or_name, str):
        graph = NetworkGraph.from_cnn(graph_or_name).shrink(spatial,
                                                            channel_div)
    else:
        graph = graph_or_name
    if residency_bytes is None:
        residency_bytes = sum(t.nbytes for t in graph.tensors.values()) // 3
    netp = plan_graph(graph, p_macs, strategy, controller,
                      residency_bytes=residency_bytes)
    ctrl = Controller.coerce(controller)
    values, meter = run_network(graph, netp.schedules, netp.resident_tensors,
                                active=ctrl is Controller.ACTIVE,
                                rng_seed=rng_seed, device=device)
    report = network_report(graph, netp.schedules, netp.resident_tensors)
    for field, got in (("interconnect_words", meter.interconnect_words),
                       ("sram_reads", meter.sram_reads),
                       ("sram_writes", meter.sram_writes)):
        want = getattr(report, field)
        assert got == want, (
            f"{graph.name} [{ctrl.value}]: metered {field}={got} != "
            f"model {want}")
    inputs, weights = draw_network(graph, rng_seed, device)
    ref = _reference_network(graph, inputs, weights)
    for tname in graph.outputs:
        _assert_close(values[tname], ref[tname], 1e-2,
                      f"{graph.name} [{ctrl.value}] {tname}")
    return netp, meter, report


def validate_schedule(layer: ConvLayer, schedule: Schedule,
                      rng_seed: int = 0, device="cuda"
                      ) -> tuple[TrafficMeter, TrafficReport]:
    """Execute a `Schedule` on seeded data and hold the meter against the
    model's `TrafficReport` (interconnect words, SRAM reads and writes, with
    ``==``) and the conv against the unpartitioned one. Raises
    AssertionError on any mismatch; returns (meter, report)."""
    x, w = _draw_layer(layer, rng_seed)
    out, meter = run_partitioned_conv(layer, schedule, x, w, device=device)
    report = analytical_report(layer, schedule)
    for field, got in (("interconnect_words", meter.interconnect_words),
                       ("sram_reads", meter.sram_reads),
                       ("sram_writes", meter.sram_writes)):
        want = getattr(report, field)
        assert got == want, (
            f"{layer.name} {schedule}: metered {field}={got} != model {want}")
    ref = _conv2d_block(torch.from_numpy(x).to(out.device),
                        torch.from_numpy(w).to(out.device), layer.stride,
                        layer.k // 2)
    _assert_close(out, ref, 1e-3, f"{layer.name} {schedule}")
    return meter, report
