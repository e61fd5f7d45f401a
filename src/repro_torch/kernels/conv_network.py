"""Whole-network kernel runner: chain `conv2d_psum` over a `NetworkGraph`.

`run_network_kernels` walks a planned graph (a `NetPlan`, or a {conv node
name: Schedule} mapping) and runs every conv node through the kernel under
its planned channel partition, materializing the branch structure the graph
records: residual adds, fire/inception concats (a multi-input conv reads the
channel-concatenated branch tensors) and shape-preserving pools.
`run_network_reference` walks the same graph with the library oracle
`ref.conv2d_ref`.

Graphs must be dense (groups == 1) with "same"-padded shapes: use
``NetworkGraph.shrink()`` on zoo nets. Both run on ``device`` ("cuda" unless
the caller passes "cpu"); nothing falls back from one to the other.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Mapping

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.kernels.conv2d_psum import conv2d_psum, conv_refusal
from repro_torch.kernels.launch import resolve_device
from repro_torch.kernels.ref import conv2d_ref


def init_network_params(graph, seed: int = 0, device="cuda"
                        ) -> dict[str, torch.Tensor]:
    """Fan-in-scaled random weights for every conv node: {node name:
    (Cout, Cin, K, K) float32}."""
    device = resolve_device(device)
    gen = torch.Generator(device="cpu").manual_seed(seed)
    params = {}
    for node in graph.workload_nodes:
        wl = node.workload
        wt = torch.randn((wl.cout, wl.cin, wl.k, wl.k), generator=gen,
                         dtype=torch.float32)
        params[node.name] = (wt / math.sqrt(wl.cin * wl.k * wl.k)).to(device)
    return params


def params_from_jax(params: Mapping[str, np.ndarray], device="cuda"
                    ) -> dict[str, torch.Tensor]:
    """The reference package's ``init_network_params`` output, as numpy
    arrays, turned into this package's float32 tensors on ``device``."""
    device = resolve_device(device)
    return {name: torch.from_numpy(np.array(value, dtype=np.float32)).to(device)
            for name, value in params.items()}


def _schedules_of(plan) -> Mapping:
    """{conv node name: Schedule} from a `NetPlan` or such a mapping."""
    return plan.schedules if hasattr(plan, "schedules") else plan


def check_network(graph, schedules, params: Mapping,
                  inputs: Mapping | None = None) -> None:
    """Reject a plan (a `NetPlan` or a {conv node name: Schedule} mapping)
    the runner cannot execute, before the first launch: a conv node without
    a schedule or weights, weights of the wrong shape, a grouped conv, a
    conv that is not "same"-padded, a schedule no kernel body takes at the
    runner's float32 (`conv2d_psum.conv_refusal`), or an input of the wrong
    shape."""
    schedules = _schedules_of(schedules)
    problems = []
    for name, value in (inputs or {}).items():
        t = graph.tensors.get(name)
        if t is None or tuple(value.shape) != (t.channels, t.h, t.w):
            want = None if t is None else (t.channels, t.h, t.w)
            problems.append(f"input tensor {name}: shaped "
                            f"{tuple(value.shape)}, graph needs {want}")
    for node in graph.workload_nodes:
        wl = node.workload
        if node.name not in schedules:
            problems.append(f"{node.name}: conv node has no schedule")
        elif schedules[node.name].kind != "conv":
            problems.append(f"{node.name}: needs a conv schedule, got "
                            f"{schedules[node.name]}")
        else:
            sched, pad = schedules[node.name], wl.k // 2
            refusal = conv_refusal(cin=wl.cin, hp=wl.hi + 2 * pad,
                                   wp=wl.wi + 2 * pad, cout=wl.cout, kk=wl.k,
                                   stride=wl.stride, block_m=sched.m,
                                   block_n=sched.n, dtype=torch.float32)
            if refusal:
                problems.append(f"{node.name}: {refusal}")
        if node.name not in params:
            problems.append(f"{node.name}: conv node has no weights")
        elif tuple(params[node.name].shape) != (wl.cout, wl.cin, wl.k, wl.k):
            problems.append(f"{node.name}: weights shaped "
                            f"{tuple(params[node.name].shape)}, workload needs "
                            f"{(wl.cout, wl.cin, wl.k, wl.k)}")
        if wl.groups != 1:
            problems.append(f"{node.name}: groups={wl.groups}; the runner "
                            f"executes dense convs only")
        pad = wl.k // 2
        if (wl.hi + 2 * pad - wl.k) // wl.stride + 1 != wl.ho:
            problems.append(f"{node.name}: not 'same'-padded; shrink() first")
    if problems:
        raise ValueError("network plan rejected before launch:\n  "
                         + "\n  ".join(problems))


def _walk(graph, params, inputs, seed, device,
          conv: Callable[[torch.Tensor, Any, torch.Tensor], torch.Tensor]
          ) -> dict[str, torch.Tensor]:
    values: dict[str, torch.Tensor] = {}
    gen = torch.Generator(device="cpu").manual_seed(seed)
    for node in graph.nodes:
        if node.op == "input":
            if inputs is not None and node.out in inputs:
                values[node.out] = torch.as_tensor(
                    inputs[node.out], dtype=torch.float32).to(device)
            else:
                t = graph.tensors[node.out]
                values[node.out] = torch.randn(
                    (t.channels, t.h, t.w), generator=gen).to(device)
            continue
        if node.workload is None:
            ins = [values[t] for t in node.ins]
            if node.op == "add":
                values[node.out] = ins[0] + ins[1]
            elif node.op == "pool":
                t = graph.tensors[node.out]
                if tuple(ins[0].shape) != (t.channels, t.h, t.w):
                    raise NotImplementedError(
                        f"{node.name}: shape-changing pools are not "
                        f"executable; shrink() the graph first")
                values[node.out] = ins[0]
            else:
                raise NotImplementedError(f"virtual op {node.op!r}")
            continue
        pad = node.workload.k // 2
        x = torch.cat([values[t] for t in node.ins], dim=0)
        if pad:
            x = F.pad(x, (pad, pad, pad, pad))
        values[node.out] = conv(x, node, params[node.name].to(device))
    return values


def run_network_kernels(graph, schedules, params: Mapping,
                        inputs: Mapping | None = None, seed: int = 0,
                        device="cuda") -> dict[str, torch.Tensor]:
    """Execute every conv of a planned graph with `conv2d_psum`.

    ``schedules`` is a `NetPlan` (its ``schedules``; the feature maps it
    holds resident are the SoC model's, and every launch writes its output
    to device memory) or a {conv node name: Schedule} mapping (conv-kind
    schedules; the kernel always keeps the partial sums on chip). Inputs not
    given are drawn from ``seed``. Returns {tensor name: value} for every
    tensor in the graph. The plan is checked (`check_network`) before the
    first launch.
    """
    device = resolve_device(device)
    schedules = _schedules_of(schedules)
    check_network(graph, schedules, params, inputs)
    return _walk(graph, params, inputs, seed, device,
                 lambda x, node, wt: conv2d_psum(
                     x, wt, schedule=schedules[node.name],
                     stride=node.workload.stride))


def run_network_reference(graph, params: Mapping,
                          inputs: Mapping | None = None, seed: int = 0,
                          device="cuda") -> dict[str, torch.Tensor]:
    """The same walk with the library oracle `ref.conv2d_ref` for each conv
    (a reference for the runner, not part of the kernels' path)."""
    device = resolve_device(device)
    return _walk(graph, params, inputs, seed, device,
                 lambda x, node, wt: conv2d_ref(x, wt, node.workload.stride))
