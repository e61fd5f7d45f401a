#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`src/repro_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py        # from the root of a checkout; needs one GPU

1. Builds the port's CUDA kernels from ``src/repro_torch/kernels/csrc`` with
   nvcc for sm_90a, one nvcc per source, all at once.
2. Prints the card's name and power limit as nvidia-smi reports them.
3. Holds each kernel against its plain PyTorch version on the card, at the
   main path's shapes, and times kernel, plain version, one library call
   (a yardstick the port never calls) and the card's lower bound:
     psum_matmul active/passive  4096 x 1536 x 8960 (the Qwen2-1.5B FFN
                                 up-projection at 4096 tokens), fp32
                                 (tc_3xtf32 body, its pack pass included,
                                 and cuda_core asked for by name) and bf16
                                 (tc_bf16 body); kernel and torch.matmul
                                 times are replays of a CUDA graph of 20
                                 calls, so the 12 ctypes launches of a
                                 passive call do not count; the passive
                                 rows add the bound of their own C round
                                 trips, the tc_3xtf32 rows the bound of
                                 three TF32 passes beside the fp32 cores';
                                 the pack pass's four arrays are held bit
                                 for bit against `tf32_split`
     conv2d_psum                 the 512 -> 512 3x3 layer of ResNet-18 at
                                 56 x 56 px under its exact_opt schedule,
                                 fp32 (cuda_core body) and bf16 (tc_bf16
                                 body), the pack pass included; kernel and
                                 cuDNN times are graph replays, eager
                                 times beside them; then every ResNet-18
                                 layer in both bodies against the plain
                                 version, timed
     flash_attention             Qwen2-1.5B's attention (12 q heads over 2
                                 kv heads, head dim 128, batch 4): prefill
                                 at 1024 tokens (tc_bf16 body in bf16;
                                 tc_3xtf32 in fp32, its pack pass
                                 included, and cuda_core asked for by
                                 name) and decode of one token against 1056
                                 keys (split_kv body and its combine), fp32
                                 and bf16; kernel and SDPA times are
                                 replays of a CUDA graph of 20 calls, so
                                 the wrapper's Python does not count; the
                                 tc_3xtf32 row adds the bound of three TF32
                                 passes beside the fp32 cores'; its pack
                                 pass's four arrays are held bit for bit
                                 against `tf32_split`
   and runs the kernels' other cases at small shapes (every activation,
   padded edges, odd channel blocks, stride 2, K in {1, 3, 7}; for the conv
   blocks of n in {8, 13, 17, 24, 64} and 1x1 blocks of 1280 and 2048
   channels, wider than one thread block; for tc_bf16 and tc_3xtf32
   ragged M, N and K, blocks of 64 and 128, a block under 64 rows, K of one
   chunk, K not a multiple of a chunk, odd bn, each plan's body checked;
   padded q and
   kv tails, decode, GQA, head dims 32 to 256 and StableLM-12B's 160 (padded
   to 256), for each flash body; tc_3xtf32 at head dims 32, 64, 100 and
   128, GQA 4:1 and 6:1, non-causal, a q offset, odd lengths, and V = I so
   that the output is softmax(S) key by key; split_kv at Sq 1 and 8, GQA
   4:1 and 6:1, fewer keys than a tile, keys not a multiple of the split)
   against the plain versions on the CPU, and fails unless the
   psum_matmul, conv2d_psum and flash libraries' SASS hold tensor-core
   (HGMMA) instructions, and psum_matmul's and flash's TF32 ones.
4. Drives the main paths, each with every launch count set to 0 just before
   it and read just after:
   a. ResNet-18 at full channel width
      (``NetworkGraph.from_cnn("resnet18").shrink(56, 1)``, exact_opt/active
      schedules at P = 2048 MACs) answers 4 seeded images through
      ``run_network_kernels`` (fp32: every conv on the cuda_core body and
      its pack pass), and the GEMM above runs through ``ops.matmul``
      under both controllers in fp32 (tc_3xtf32 and its pack pass) and
      bf16 (tc_bf16);
   b. ``repro_torch.launch.serve`` serves 8 requests of Qwen2-1.5B at full
      width (28 layers, bf16, seeded weights) in batches of 4, prompt 1024,
      32 generated tokens: every attention layer of prefill runs the flash
      kernel's one-pass body, and every decode layer its split_kv body and
      combine.
   c. the same model in fp32 (``dtype="float32"``, 28 layers, full width)
      runs one forward over the serve batch (4 prompts of 1024): every
      attention layer runs the flash kernel's tc_3xtf32 body and its pack
      pass (28 launches each).
   d. the paper's strategies on the card: the port's ``dse.sweep`` plans
      Tables I-III on the host (timed; it fails if any Table II cell has
      more active words than passive); then, for each dense zoo CNN
      (alexnet, vgg16, squeezenet, googlenet, resnet18, resnet50) and each
      of max_input, max_output, equal, paper_opt and exact_opt, the
      per-layer schedules of the full-size network at P = 2048 are applied
      by node name to ``shrink(56, 1)`` and one seeded fp32 image runs
      through ``run_network_kernels`` after a warm-up walk (one conv2d_psum
      and one pack launch a conv node; every tensor within 1e-3 of the
      reference walk; 3 walks timed, one walk replayed as a CUDA graph);
      last, Qwen2-1.5B's five GEMMs at 4096 tokens
      (``NetworkGraph.from_transformer``) run under their paper_opt plans
      at one block's shared memory through ``psum_matmul`` in bf16, both
      controllers (one active launch, ceil(K / bk) passive launches),
      within 2e-2 of ``matmul_ref``. mobilenet and mnasnet have grouped
      convs, which the runner refuses: they are planned, not run.
   e. the fused-residency network planner: ``plan.plan_graph`` plans the
      eight zoo CNNs under both controllers (exact_opt, P = 2048, the 2 MiB
      residency of the paper's SoC) on the host, timed; it fails unless
      every plan holds an edge resident, carries fewer words than its
      per-layer baseline and stays within the residency budget, and unless
      ``fleet.plan_graphs`` over the eight gives each sequential plan's
      traffic. Then the NetPlan of ``resnet18.shrink(56, 1)`` (exact_opt,
      active) itself goes to ``run_network_kernels`` with one seeded fp32
      image, beside ``plan_many``'s schedules for the same graph: a warm-up
      walk, 3 walks timed, one replayed as a CUDA graph; each walk must
      launch 20 conv2d_psum and 20 pack passes and give every tensor within
      1e-3 of the reference walk. Each layer whose schedule the NetPlan
      changed is then timed under both schedules. The card holds no feature
      map resident: the plan's peak resident bytes are printed beside the
      card's L2 size.
   f. the verifier and the active memory controller's meter: on the same
      graph, the per-layer baseline (``plan_many``) and the 2 MiB NetPlan
      under both controllers pass ``check.verify`` and their word-count
      certificates (``check.check_network_dataflow``), every layer's search
      space certifies (``certify_conv_space``), and so do Qwen2-1.5B's five
      GEMMs at one block's shared memory; the pre-flight's host ms on a
      graph's first and a later walk are printed. ``amc.run_network`` then
      meters each of the four plans on the card, its interconnect words and
      SRAM reads and writes equal to ``network_report``'s with ``==``, and
      the active plans' metered tensors are held (1e-3) against
      ``run_network_kernels`` on the meter's own input and weights (20 + 20
      launches a walk). Last, ``amc.validate_network`` on the six dense zoo
      CNNs under both controllers and ``core.planner.plan_network`` over the
      eight.
   Every output is checked against a library reference (the served logits
   against the model with `ref.attention_ref` as its attention, and against
   one full forward of prompt plus generated tokens; the fp32 forward's
   logits against the same forward with `ref.attention_ref`), and every
   kernel of a path must have launched on it.
5. Prints ``{"kernels": [...]}`` and, last, ``{"ok": true, "device": ...}``.

Any failed check exits non-zero. Without a CUDA device, or without the
repository's ``src/repro_torch`` beside it, it exits non-zero and prints no
result.
"""

from __future__ import annotations

import dataclasses
import json
import math
import pathlib
import re
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent

M, K, N = 4096, 1536, 8960          # Qwen2-1.5B: d_model 1536, d_ff 8960
P_MACS = 2048                       # the paper's central MAC budget
IMAGES = 4
HBM_BYTES_PER_S = 3.35e12           # H100 SXM data sheet
MATMUL_TOL = {"float32": 1e-3, "bfloat16": 2e-2}
CONV_TOL = 1e-4
NETWORK_REL_TOL = 1e-3
FLASH_TOL = {"float32": 2e-4, "bfloat16": 3e-2}
SERVE_ARCH, REQUESTS, SERVE_BATCH, PROMPT, GEN = "qwen2-1.5b", 8, 4, 1024, 32
SERVE_REL_TOL = 5e-2


# 4d: the paper's strategies on the card
TABLE1_P = (512, 2048, 16384)
TABLE2_P = (512, 1024, 2048, 4096, 8192, 16384)
TABLE_STRATEGIES = ("max_input", "max_output", "equal", "paper_opt")
WALK_STRATEGIES = TABLE_STRATEGIES + ("exact_opt",)
WALK_PX, WALKS = 56, 3
LM_ARCH, LM_SEQ, LM_TOL = "qwen2-1.5b", 4096, 2e-2


def body_work(torch, wl, sc) -> int:
    """The fp32 ``cuda_core`` body's work for one conv under a schedule:
    every block's accumulator tile (channel lanes x output positions) over
    the padded cin walk, in MACs; narrow or uneven blocks pad it."""
    from repro_torch.kernels import conv2d_psum
    pad = wl.k // 2
    lp = conv2d_psum.conv_launch_plan(
        cin=wl.cin, hp=wl.hi + 2 * pad, wp=wl.wi + 2 * pad, cout=wl.cout,
        kk=wl.k, block_m=sc.m, block_n=sc.n, dtype=torch.float32)
    acc = next(sp.shape for sp in lp.scratch if sp.name == "acc")
    return (lp.grid[0] * lp.grid[1] * acc[0] * acc[1]
            * lp.inputs[0].array_shape[0] * wl.k ** 2)


def paper_strategies(torch, dev, graph_ms, bound) -> dict[str, int]:
    """Phase 4d. (i) The paper's Tables I-III from the port's DSE, planned
    on the host and timed. (ii) Table I's schedules at P = 2048 for each
    dense zoo CNN and each of five strategies, planned at full size and
    applied by node name to ``shrink(56, 1)``, one seeded fp32 image through
    `run_network_kernels` against `run_network_reference`. (iii) Qwen2-1.5B's
    five GEMMs at 4096 tokens under their paper_opt (first-order) plans
    through `psum_matmul` in bf16, both controllers, against `matmul_ref`.
    Returns the launches the kernels made in (ii) and (iii)."""
    from repro_torch import plan
    from repro_torch.configs import get_config
    from repro_torch.core.cnn_zoo import PAPER_CNNS, PAPER_TABLE3
    from repro_torch.kernels import launch, psum_matmul, ref
    from repro_torch.kernels.conv_network import (init_network_params,
                                                  run_network_kernels,
                                                  run_network_reference)
    from repro_torch.plan import dse
    from repro_torch.plan.graph import NetworkGraph

    # (i) the tables, planned on the host
    t0 = time.perf_counter()
    t1 = dse.sweep(PAPER_CNNS, TABLE1_P, TABLE_STRATEGIES, ("passive",),
                   paper_convention=True)
    t1_ms = 1e3 * (time.perf_counter() - t0)
    t0 = time.perf_counter()
    t2 = dse.sweep(PAPER_CNNS, TABLE2_P, ("paper_opt",), ("passive", "active"),
                   paper_convention=True)
    t2_ms = 1e3 * (time.perf_counter() - t0)
    t0 = time.perf_counter()
    t3 = {net: plan.min_network_traffic(net) for net in PAPER_CNNS}
    t3_ms = 1e3 * (time.perf_counter() - t0)
    words = {(r["network"], r["budget"], r["strategy"], r["controller"]):
             r["interconnect_words"] for r in t1 + t2}
    print(f"paper tables planned on the host by dse.sweep: Table I "
          f"({len(t1)} cells) {t1_ms:.1f} ms, Table II ({len(t2)} cells) "
          f"{t2_ms:.1f} ms, Table III {t3_ms:.3f} ms")
    for net in PAPER_CNNS:
        print(f"table I {net} (M words, passive, paper convention): " + "; ".join(
            f"P{p} " + " ".join(f"{s} {words[(net, p, s, 'passive')] / 1e6:.2f}"
                                for s in TABLE_STRATEGIES) for p in TABLE1_P))
    for net in PAPER_CNNS:
        cells = []
        for p in TABLE2_P:
            pas = words[(net, p, "paper_opt", "passive")]
            act = words[(net, p, "paper_opt", "active")]
            if act > pas:
                fail(f"table II {net} P{p}: active {act} words > passive {pas}")
            cells.append(f"P{p} {pas / 1e6:.2f}/{act / 1e6:.2f} "
                         f"({100 * (1 - act / pas):.1f} %)")
        print(f"table II / fig. 2 {net} (M words passive/active, paper_opt; "
              f"active saving): " + "; ".join(cells))
    for net in PAPER_CNNS:
        val, pub = t3[net] / 1e6, PAPER_TABLE3[net]
        print(f"table III {net}: {val:.3f} M words (published {pub}, "
              f"deviation {100 * (val - pub) / pub:.1f} %)")

    # (ii) Table I's schedules through conv2d_psum, by node name
    dense = [net for net in PAPER_CNNS
             if all(w.groups == 1 for w in plan.conv_workloads(net))]
    grouped = [net for net in PAPER_CNNS if net not in dense]
    print(f"strategy walks: {', '.join(grouped)} have grouped convs, which "
          f"run_network_kernels refuses (dense convs only); their schedules "
          f"are planned above and not run")
    gen = torch.Generator().manual_seed(20)
    phase = {"conv2d_psum": 0, "conv2d_psum/pack": 0}
    for net in dense:
        g = NetworkGraph.from_cnn(net).shrink(WALK_PX, 1)
        nodes = g.workload_nodes
        params = init_network_params(g, seed=0, device=dev)
        # on the card already, so that a walk can be captured as a CUDA graph
        inputs = {g.inputs[0]: torch.randn(3, WALK_PX, WALK_PX,
                                           generator=gen).to(dev)}
        want = run_network_reference(g, params, inputs=inputs, device=dev)
        for s in WALK_STRATEGIES:
            rows = dse.sweep(net, P_MACS, (s,), ("passive",), per_layer=True)
            by_name = {r["layer"]: r for r in rows}
            if len(by_name) != len(rows) or set(by_name) != {n.name for n in nodes}:
                fail(f"{net} {s}: the sweep's layer names do not name the "
                     f"graph's conv nodes one to one")
            schedules = {}
            for node in nodes:
                wl, full = node.workload, by_name[node.name]["workload"]
                if (wl.cin, wl.cout, wl.k) != (full.cin, full.cout, full.k):
                    fail(f"{net} {node.name}: shrunk node {(wl.cin, wl.cout, wl.k)}"
                         f" != its row's workload {(full.cin, full.cout, full.k)}")
                schedules[node.name] = by_name[node.name]["schedule"]
            padded = (sum(body_work(torch, n.workload, schedules[n.name])
                          for n in nodes)
                      / sum(node.workload.macs for node in nodes))
            full_words = {c: dse.sweep(net, P_MACS, (s,), (c,))[0]["interconnect_words"]
                          for c in ("passive", "active")}
            small_words = {c: sum(plan.traffic_report(n.workload, dataclasses.replace(
                schedules[n.name], controller=plan.Controller(c))).interconnect_words
                for n in nodes) for c in ("passive", "active")}
            run_network_kernels(g, schedules, params, inputs=inputs, device=dev)
            walk_ms = []
            for i in range(WALKS):
                torch.cuda.synchronize()
                if i == 0:
                    launch.reset_launches()
                t0 = time.perf_counter()
                got = run_network_kernels(g, schedules, params, inputs=inputs,
                                          device=dev)
                torch.cuda.synchronize()
                walk_ms.append(1e3 * (time.perf_counter() - t0))
                if i == 0:
                    counts = dict(launch.LAUNCHES)
                    expect = {"conv2d_psum": len(nodes),
                              "conv2d_psum/pack": len(nodes)}
                    if counts != expect:
                        fail(f"{net} {s}: a walk launched {counts}, expected "
                             f"{expect} (one conv and one pack a conv node)")
                    for key in phase:
                        phase[key] += counts[key]
                    worst = 0.0
                    for name, value in want.items():
                        out = got[name]
                        if out.shape != value.shape or not torch.isfinite(out).all():
                            fail(f"{net} {s} {name}: shape or non-finite values")
                        rel = ((out - value).abs().max() / value.abs().max()).item()
                        if rel > NETWORK_REL_TOL:
                            fail(f"{net} {s} {name}: max abs err / max abs = {rel}")
                        worst = max(worst, rel)
                del got
            # the walk's device time: one walk captured as a CUDA graph and
            # replayed, without the host's time between launches
            dev_ms = graph_ms(lambda: run_network_kernels(
                g, schedules, params, inputs=inputs, device=dev), calls=1, reps=3)
            ms_, ns_ = ([schedules[n.name].m for n in nodes],
                        [schedules[n.name].n for n in nodes])
            print(f"strategy walk {net} {s} (P {P_MACS}, {len(nodes)} convs, "
                  f"{WALK_PX} px, fp32): words full size passive "
                  f"{full_words['passive'] / 1e6:.3f} M, active "
                  f"{full_words['active'] / 1e6:.3f} M; shrunk graph passive "
                  f"{small_words['passive'] / 1e6:.3f} M, active "
                  f"{small_words['active'] / 1e6:.3f} M; walk median "
                  f"{sorted(walk_ms)[WALKS // 2]:.3f} ms (walks "
                  f"{', '.join(f'{t:.3f}' for t in walk_ms)}), replayed "
                  f"{dev_ms:.3f} ms (idle share of the median walk "
                  f"{1 - dev_ms / sorted(walk_ms)[WALKS // 2]:.3f}); m {min(ms_)}-"
                  f"{max(ms_)}, n {min(ns_)}-{max(ns_)}, cuda_core work "
                  f"{padded:.3f} x the MACs; worst rel err "
                  f"{worst:.3g} (limit {NETWORK_REL_TOL})")
        del params, want

    # (iii) a transformer's GEMMs through psum_matmul, first-order plans
    cfg = get_config(LM_ARCH)
    tg = NetworkGraph.from_transformer(cfg, seq_len=LM_SEQ)
    dgen = torch.Generator(device=dev).manual_seed(21)
    phase.update({"psum_matmul/active": 0, "psum_matmul/passive": 0})
    for node in tg.workload_nodes:
        wl = node.workload
        x = torch.randn(wl.m, wl.k, generator=dgen, device=dev).to(torch.bfloat16)
        w = torch.randn(wl.k, wl.n, generator=dgen, device=dev).to(torch.bfloat16)
        want = ref.matmul_ref(x, w)
        for c in ("active", "passive"):
            p = plan.plan(wl, plan.SMEM_BUDGET, "paper_opt", c)
            exact = plan.plan(wl, plan.SMEM_BUDGET, "exact_opt", c).schedule
            sched = p.schedule
            torch.cuda.synchronize()
            launch.reset_launches()
            y = psum_matmul.psum_matmul(x, w, schedule=sched)
            torch.cuda.synchronize()
            counts = dict(launch.LAUNCHES)
            expect = {f"psum_matmul/{c}": 1 if c == "active" else -(-wl.k // sched.bk)}
            if counts != expect:
                fail(f"{wl.name} {c}: launched {counts}, expected {expect}")
            phase[f"psum_matmul/{c}"] += counts[f"psum_matmul/{c}"]
            err = (y.float() - want.float()).abs().max().item()
            if (y.shape != want.shape or not torch.isfinite(y).all()
                    or not torch.allclose(y.float(), want.float(), rtol=LM_TOL,
                                          atol=LM_TOL)):
                fail(f"{wl.name} {c}: differs from matmul_ref, max abs err {err}")
            del y
            out_size = 4 if c == "passive" else x.element_size()
            b_ms, b_by = bound(float(wl.flops), (wl.m * wl.k + wl.k * wl.n)
                               * x.element_size() + wl.m * wl.n * out_size,
                               torch.bfloat16)
            ms = graph_ms(lambda: psum_matmul.psum_matmul(x, w, schedule=sched),
                          calls=3, reps=3)
            lib = graph_ms(lambda: torch.matmul(x, w), calls=3, reps=3)
            print(f"transformer gemm {wl.name} {wl.m}x{wl.n}x{wl.k} bf16 {c}: "
                  f"paper_opt blocks {sched.bm}x{sched.bn}x{sched.bk} (exact_opt "
                  f"{exact.bm}x{exact.bn}x{exact.bk}); words "
                  f"{p.traffic.interconnect_words / 1e6:.3f} M; ms={ms:.4f} "
                  f"(graph replays) library_ms={lib:.4f} bound_ms={b_ms:.4f} "
                  f"({b_by}); launches {counts}; max_abs_err={err:.3g} "
                  f"(rtol = atol = {LM_TOL})")
        del x, w, want
    return phase


# 4e: the fused-residency network planner
NETPLAN_NET, NETPLAN_WALKS = "resnet18", 3


def netplan_on_card(torch, dev, graph_ms, card: str) -> dict[str, int]:
    """Phase 4e. (a) `plan.plan_graph` on the eight zoo CNNs under both
    controllers, and `fleet.plan_graphs` over them, on the host and timed.
    (b) The NetPlan of ResNet-18 at ``shrink(56, 1)`` passed itself to
    `run_network_kernels` in fp32, beside the same graph's `plan_many`
    schedules, against `run_network_reference`. Returns the launches of the
    NetPlan's timed walks."""
    from repro_torch import plan
    from repro_torch.core.cnn_zoo import PAPER_CNNS
    from repro_torch.kernels import launch
    from repro_torch.kernels.conv_network import (init_network_params,
                                                  run_network_kernels,
                                                  run_network_reference)
    from repro_torch.plan import fleet
    from repro_torch.plan.graph import NetworkGraph

    def same(a, b) -> bool:
        return (a.traffic == b.traffic and a.schedules == b.schedules
                and a.resident_tensors == b.resident_tensors
                and a.peak_resident_bytes == b.peak_resident_bytes)

    # (a) the zoo, planned on the host; the cache is cleared before each
    # call so that every time is a plan, not a lookup
    for c in ("passive", "active"):
        seq, seq_ms = {}, 0.0
        for net in PAPER_CNNS:
            plan.clear_plan_graph_cache()
            t0 = time.perf_counter()
            p = plan.plan_graph(net, P_MACS, "exact_opt", c)
            ms = 1e3 * (time.perf_counter() - t0)
            seq[net], seq_ms = p, seq_ms + ms
            resident = [e for e in p.edges if e.resident]
            if not resident:
                fail(f"netplan {net} {c}: no edge resident")
            if not p.total_words < p.baseline_words:
                fail(f"netplan {net} {c}: {p.total_words} words, not under the "
                     f"per-layer baseline's {p.baseline_words}")
            if p.peak_resident_bytes > p.residency_bytes:
                fail(f"netplan {net} {c}: peak resident {p.peak_resident_bytes}"
                     f" B over the budget {p.residency_bytes} B")
            print(f"netplan {net} {c} (exact_opt, P {P_MACS}, residency "
                  f"{p.residency_bytes} B): host {ms:.3f} ms; "
                  f"{len(resident)} of {len(p.edges)} edges resident; words "
                  f"{p.baseline_words / 1e6:.3f} M per layer -> "
                  f"{p.total_words / 1e6:.3f} M fused (saving "
                  f"{p.saving_pct:.2f} %); peak resident "
                  f"{p.peak_resident_bytes} B ({card})")
        plan.clear_plan_graph_cache()
        t0 = time.perf_counter()
        batch = fleet.plan_graphs(PAPER_CNNS, P_MACS, "exact_opt", c)
        fleet_ms = 1e3 * (time.perf_counter() - t0)
        for net, p in zip(PAPER_CNNS, batch):
            if not same(p, seq[net]):
                fail(f"fleet.plan_graphs {net} {c}: differs from plan_graph "
                     f"(traffic {p.traffic} vs {seq[net].traffic})")
        print(f"fleet.plan_graphs {c} ({len(PAPER_CNNS)} CNNs): host "
              f"{fleet_ms:.3f} ms against {seq_ms:.3f} ms for the sequential "
              f"plan_graph calls; every plan's traffic, schedules and residency "
              f"equal ({card})")
    plan.clear_plan_graph_cache()

    # (b) the NetPlan on the card, beside plan_many's schedules
    g = NetworkGraph.from_cnn(NETPLAN_NET).shrink(WALK_PX, 1)
    nodes = g.workload_nodes
    netp = plan.plan_graph(g, P_MACS, "exact_opt", "active")
    per_layer = {n.name: q.schedule for n, q in zip(
        nodes, plan.plan_many(g.workloads, P_MACS, "exact_opt", "active"))}
    differ = [n.name for n in nodes if netp.schedules[n.name] != per_layer[n.name]]
    l2 = torch.cuda.get_device_properties(dev).L2_cache_size
    print(f"netplan {g.name} (exact_opt, active, P {P_MACS}): {len(differ)} of "
          f"{len(nodes)} conv schedules differ from plan_many's "
          f"({', '.join(differ)}); resident set "
          f"{sorted(netp.resident_tensors)}; saving {netp.saving_pct:.2f} % of "
          f"the words; peak resident {netp.peak_resident_bytes} B of the "
          f"model's {netp.residency_bytes} B SoC buffer, against the card's L2 "
          f"of {l2} B. The resident edges are the model's, not the card's: "
          f"every conv2d_psum launch writes its output to device memory")
    params = init_network_params(g, seed=0, device=dev)
    gen = torch.Generator().manual_seed(22)
    inputs = {g.inputs[0]: torch.randn(3, WALK_PX, WALK_PX, generator=gen).to(dev)}
    want = run_network_reference(g, params, inputs=inputs, device=dev)
    expect = {"conv2d_psum": len(nodes), "conv2d_psum/pack": len(nodes)}
    phase = {key: 0 for key in expect}
    for label, plan_ in (("NetPlan", netp), ("plan_many", per_layer)):
        run_network_kernels(g, plan_, params, inputs=inputs, device=dev)
        walk_ms, worst_rel, worst_abs = [], 0.0, 0.0
        for _ in range(NETPLAN_WALKS):
            torch.cuda.synchronize()
            launch.reset_launches()
            t0 = time.perf_counter()
            got = run_network_kernels(g, plan_, params, inputs=inputs,
                                      device=dev)
            torch.cuda.synchronize()
            walk_ms.append(1e3 * (time.perf_counter() - t0))
            counts = dict(launch.LAUNCHES)
            if counts != expect:
                fail(f"{label} walk of {g.name}: launched {counts}, expected "
                     f"{expect}")
            if plan_ is netp:
                for key in phase:
                    phase[key] += counts[key]
            for name, value in want.items():
                out = got[name]
                if out.shape != value.shape or not torch.isfinite(out).all():
                    fail(f"{label} {name}: shape or non-finite values")
                err = (out - value).abs().max().item()
                rel = err / value.abs().max().item()
                if rel > NETWORK_REL_TOL:
                    fail(f"{label} {name}: max abs err / max abs = {rel}")
                worst_rel, worst_abs = max(worst_rel, rel), max(worst_abs, err)
            del got
        dev_ms = graph_ms(lambda: run_network_kernels(
            g, plan_, params, inputs=inputs, device=dev), calls=1, reps=3)
        med = sorted(walk_ms)[NETPLAN_WALKS // 2]
        print(f"netplan walk {g.name} {label} schedules (fp32, one image): "
              f"walk median {med:.3f} ms (walks "
              f"{', '.join(f'{t:.3f}' for t in walk_ms)}), replayed "
              f"{dev_ms:.3f} ms (idle share of the median walk "
              f"{1 - dev_ms / med:.3f}); launches a walk {expect}; worst max "
              f"abs err {worst_abs:.3g}, worst rel err {worst_rel:.3g} (limit "
              f"{NETWORK_REL_TOL}) ({card})")

    # where the two walks differ: each layer whose schedule the NetPlan
    # changed, on the reference walk's input, under both schedules
    import torch.nn.functional as F
    from repro_torch.kernels.conv2d_psum import conv2d_psum
    sums = {"plan_many": 0.0, "NetPlan": 0.0}
    for node in nodes:
        if node.name not in differ:
            continue
        wl, pad = node.workload, node.workload.k // 2
        x = F.pad(torch.cat([want[t] for t in node.ins], dim=0),
                  (pad, pad, pad, pad)).contiguous()
        cells = []
        for label, sc in (("plan_many", per_layer[node.name]),
                          ("NetPlan", netp.schedules[node.name])):
            ms = graph_ms(lambda: conv2d_psum(x, params[node.name], schedule=sc,
                                              stride=wl.stride))
            sums[label] += ms
            cells.append(f"{label} m {sc.m} n {sc.n}: {ms:.4f} ms, body work "
                         f"{body_work(torch, wl, sc) / wl.macs:.2f} x the MACs")
        print(f"netplan layer {node.name} ({wl.cin} -> {wl.cout}, {wl.k}x{wl.k}, "
              f"{WALK_PX} px, fp32, graph replays): " + "; ".join(cells)
              + f" ({card})")
    print(f"netplan layers changed: {len(differ)} convs sum to "
          f"{sums['plan_many']:.4f} ms under plan_many's schedules and "
          f"{sums['NetPlan']:.4f} ms under the NetPlan's ({card})")
    return phase


# 4f: the verifier, the certificates and the active memory controller's meter
AMC_NET = "resnet18"
DENSE_CNNS = ("alexnet", "vgg16", "squeezenet", "googlenet", "resnet18",
              "resnet50")


def amc_on_card(torch, dev, card: str) -> dict[str, int]:
    """Phase 4f. On ResNet-18 at ``shrink(56, 1)``, P = 2048, exact_opt,
    the per-layer baseline (`plan_many`) and the 2 MiB NetPlan under both
    controllers: (a) `check.verify` and the word-count certificates clean,
    every layer's search space certified, Qwen2-1.5B's GEMM spaces at one
    block's shared memory, the pre-flight's host ms on a first and a later
    walk; (b) `amc.run_network` on the card meters each plan, its words
    equal to `network_report`'s with ``==``; (c) the active plans' metered
    tensors against `run_network_kernels` on the meter's own input and
    weights (fp32 conv2d_psum, 20 + 20 launches a walk, counted); (d)
    `amc.validate_network` on the six dense zoo CNNs under both
    controllers, and `core.planner.plan_network` over the eight. Returns
    the launches of (c)."""
    from repro_torch import check, plan
    from repro_torch.configs import get_config
    from repro_torch.core import amc, planner
    from repro_torch.core.cnn_zoo import PAPER_CNNS
    from repro_torch.kernels import launch
    from repro_torch.kernels.conv_network import run_network_kernels
    from repro_torch.plan.graph import NetworkGraph

    g = NetworkGraph.from_cnn(AMC_NET).shrink(WALK_PX, 1)
    nodes = g.workload_nodes
    plans = {}
    for c in ("passive", "active"):
        base = plan.plan_many(g.workloads, P_MACS, "exact_opt", c)
        plans[("baseline", c)] = ({n.name: q.schedule for n, q in zip(nodes, base)},
                                  frozenset(), base)
        netp = plan.plan_graph(g, P_MACS, "exact_opt", c)
        plans[("NetPlan", c)] = (netp.schedules, netp.resident_tensors, netp)

    # (a) the verifier and the certificates, on the host
    for (label, c), (sched, _, obj) in plans.items():
        t0 = time.perf_counter()
        if label == "baseline":
            for q in obj:
                check.verify(q)
        else:
            check.verify(obj)
        verify_ms = 1e3 * (time.perf_counter() - t0)
        check.clear_preflight_cache()
        t0 = time.perf_counter()
        found = check.check_network_dataflow(g, sched)
        cert_ms = 1e3 * (time.perf_counter() - t0)
        if found:
            fail(f"certificates of {label} {c}: {check.render_all(found)}")
        print(f"check {AMC_NET} {label} {c}: verify {verify_ms:.3f} ms, "
              f"{len(nodes)} launch certificates clean in {cert_ms:.3f} ms "
              f"(host)")
    for c in ("passive", "active"):
        t0 = time.perf_counter()
        tally = dict.fromkeys(("n_candidates", "n_equal_hbm", "n_bounded_hbm",
                               "n_exceeding", "n_unlaunchable"), 0)
        for wl in g.workloads:
            cert = check.certify_conv_space(wl, P_MACS, c)
            if not cert.ok or cert.diagnostics:
                fail(f"certify_conv_space {wl.name} {c}: "
                     f"{check.render_all(cert.diagnostics)}")
            for key in tally:
                tally[key] += getattr(cert, key)
        ms = 1e3 * (time.perf_counter() - t0)
        print(f"certify_conv_space {AMC_NET} {c} ({len(nodes)} layers, "
              f"ConvExactSpace at P {P_MACS}): {tally['n_candidates']} "
              f"candidates certified, x read the model's number of times by "
              f"{tally['n_equal_hbm']}, fewer by {tally['n_bounded_hbm']}, more "
              f"by {tally['n_exceeding']}, {tally['n_unlaunchable']} that no "
              f"body takes; host {ms:.3f} ms")
        t0 = time.perf_counter()
        n_gemm = 0
        for wl in plan.transformer_matmuls(get_config(LM_ARCH), seq_len=LM_SEQ):
            cert = check.certify_matmul_space(wl, plan.SMEM_BUDGET, c)
            if not cert.ok or cert.diagnostics:
                fail(f"certify_matmul_space {wl.name} {c}: "
                     f"{check.render_all(cert.diagnostics)}")
            n_gemm += cert.n_candidates
        ms = 1e3 * (time.perf_counter() - t0)
        print(f"certify_matmul_space {LM_ARCH} {c} (5 GEMMs at "
              f"{plan.SMEM_BUDGET} B): {n_gemm} candidates certified; host "
              f"{ms:.3f} ms")
    sched_a = plans[("NetPlan", "active")][0]
    inputs, weights = amc.draw_network(g, 0, dev)
    check.clear_preflight_cache()
    walls = []
    for _ in range(2):
        t0 = time.perf_counter()
        check.preflight_network_kernels(g, sched_a, weights, inputs)
        walls.append(1e3 * (time.perf_counter() - t0))
    print(f"preflight {AMC_NET} NetPlan active (launch checks and certificates "
          f"of {len(nodes)} convs): first walk {walls[0]:.3f} ms, a later walk "
          f"{walls[1]:.3f} ms (host)")

    # (b) the meter on the card, held against the model with ==
    meters = {}
    for (label, c), (sched, resident, _) in plans.items():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        values, meter = amc.run_network(g, sched, resident, rng_seed=0,
                                        device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        report = plan.network_report(g, sched, resident)
        for field in ("interconnect_words", "sram_reads", "sram_writes"):
            if getattr(meter, field) != getattr(report, field):
                fail(f"meter {label} {c}: {field} {getattr(meter, field)} != "
                     f"network_report {getattr(report, field)}")
        meters[(label, c)] = (meter, values)
        print(f"meter {AMC_NET} {label} {c} (P {P_MACS}, exact_opt, "
              f"{len(resident)} tensors resident): interconnect words "
              f"{meter.interconnect_words}, SRAM reads {meter.sram_reads}, "
              f"SRAM writes {meter.sram_writes}, equal to network_report; "
              f"walk {wall:.2f} s on {dev} ({card})")
    for label in ("baseline", "NetPlan"):
        pas = meters[(label, "passive")][0].interconnect_words
        act = meters[(label, "active")][0].interconnect_words
        if act > pas:
            fail(f"meter {label}: active {act} words over passive {pas}")
        print(f"meter {AMC_NET} {label}: the active controller saves "
              f"{100 * (1 - act / pas):.2f} % of the interconnect words")

    # (c) the active plans' metered tensors against the card's kernels, on
    #     the meter's own input and weights
    expect = {"conv2d_psum": len(nodes), "conv2d_psum/pack": len(nodes)}
    phase = {key: 0 for key in expect}
    for label in ("baseline", "NetPlan"):
        sched = plans[(label, "active")][0]
        want = meters[(label, "active")][1]
        torch.cuda.synchronize()
        launch.reset_launches()
        got = run_network_kernels(g, sched, weights, inputs=inputs,
                                  device=dev)
        torch.cuda.synchronize()
        counts = dict(launch.LAUNCHES)
        if counts != expect:
            fail(f"kernel walk of the {label} schedules: launched {counts}, "
                 f"expected {expect}")
        for key in phase:
            phase[key] += counts[key]
        worst = 0.0
        for name, value in want.items():
            out = got[name]
            if out.shape != value.shape or not torch.isfinite(out).all():
                fail(f"meter vs kernels {label} {name}: shape or non-finite")
            rel = ((out - value).abs().max() / value.abs().max()).item()
            if rel > NETWORK_REL_TOL:
                fail(f"meter vs kernels {label} {name}: max abs err / max abs "
                     f"= {rel}")
            worst = max(worst, rel)
        print(f"meter vs conv2d_psum {AMC_NET} {label} active (fp32, the "
              f"meter's input and weights): {len(want)} tensors, worst max abs "
              f"err / max abs {worst:.3g} (limit {NETWORK_REL_TOL}); launches "
              f"{counts} ({card})")
    del meters

    # (d) validate_network on the dense zoo, and plan_network on the eight
    for net in DENSE_CNNS:
        for c in ("passive", "active"):
            t0 = time.perf_counter()
            netp, meter, _ = amc.validate_network(net, controller=c, device=dev)
            ms = 1e3 * (time.perf_counter() - t0)
            print(f"validate_network {net} {c} (shrink(8, 8), residency a third "
                  f"of the tensor bytes): {meter.interconnect_words} words, "
                  f"{len(netp.resident_tensors)} tensors resident, equal to the "
                  f"model; {ms:.1f} ms on {dev} ({card})")
    for net in PAPER_CNNS:
        t0 = time.perf_counter()
        npl = planner.plan_network(net, P_MACS, "exact_opt")
        ms = 1e3 * (time.perf_counter() - t0)
        print(f"plan_network {net} (exact_opt, P {P_MACS}): passive "
              f"{npl.total_passive / 1e6:.3f} M words, active "
              f"{npl.total_active / 1e6:.3f} M (saving {npl.saving_pct:.2f} %); "
              f"host {ms:.3f} ms")
    return phase


def kernel_name(mangled: str) -> str:
    """A kernel's mangled name without its anonymous namespace's token."""
    m = re.match(r"_ZN(\d+)_GLOBAL__N_", mangled)
    return mangled[m.end(1) + int(m.group(1)):][:72] if m else mangled[:72]


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        fail("no CUDA device (torch.cuda.is_available() is False)")
    if not (ROOT / "src" / "repro_torch" / "kernels" / "csrc").is_dir():
        fail(f"src/repro_torch not found beside {ROOT / 'chip_smoke.py'}")
    sys.path.insert(0, str(ROOT / "src"))

    from repro_torch import plan
    from repro_torch.configs import get_config
    from repro_torch.kernels import (_build, conv2d_psum, flash_attention,
                                     launch, ops, psum_matmul, ref)
    from repro_torch.kernels.conv_network import (init_network_params,
                                                  run_network_kernels,
                                                  run_network_reference)
    from repro_torch.plan.graph import NetworkGraph

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # H100 SXM, dense; "tf32x3" is three TF32 passes (tc_3xtf32)
    peak = {torch.float32: 67e12, torch.bfloat16: 989e12, "tf32x3": 494.7e12 / 3}
    dev = torch.device("cuda", 0)

    # 1. build
    t0 = time.perf_counter()
    paths = _build.build()
    print(f"build: {len(paths)} libraries in {time.perf_counter() - t0:.1f} s")
    for name, path in paths.items():
        log = path.with_suffix(".log").read_text().splitlines()
        regs, spills, fn = {}, {}, ""
        for line in log:
            if m := re.search(r"Function properties for (\S+)", line):
                fn = m.group(1)
            elif m := re.search(r"(\d+) bytes spill stores", line):
                spills[fn] = int(m.group(1))
            elif m := re.search(r"Used (\d+) registers", line):
                regs[fn] = int(m.group(1))
        print(f"  {name}: {len(regs)} kernels, at most {max(regs.values())} "
              f"registers a thread")
        for fn, n in spills.items():
            if n:
                print(f"  {name}: {kernel_name(fn)}: {regs.get(fn)} registers, "
                      f"{n} bytes spill stores")
        # ptxas serializes wgmmas whose accumulator other code writes
        # between their issue and their wait (C7515)
        serialized = [line.rsplit("'", 2)[-2] for line in log if "C7515" in line]
        print(f"  {name}: {len(serialized)} kernels with serialized wgmma (C7515)"
              + "".join(f"\n    {kernel_name(fn)}" for fn in serialized))

    cuobjdump = pathlib.Path(_build.nvcc()).with_name("cuobjdump")
    for name in ("psum_matmul", "conv2d_psum", "flash_attention"):
        sass = subprocess.run([str(cuobjdump), "-sass", str(paths[name])],
                              capture_output=True, text=True, timeout=300,
                              check=True).stdout
        hgmma = [line for line in sass.splitlines() if "HGMMA" in line]
        if not hgmma:
            fail(f"{name}: no HGMMA instruction in the library's SASS")
        print(f"{name} SASS: {len(hgmma)} HGMMA instructions")
        if name in ("psum_matmul", "flash_attention"):
            tf32 = [line for line in hgmma if "TF32" in line]
            if not tf32:
                fail(f"{name}: no TF32 HGMMA instruction in the library's SASS")
            print(f"{name} SASS: {len(tf32)} TF32 HGMMA instructions, e.g. "
                  f"{tf32[0].split(';')[0].strip()}")

    # 2. the card
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(smi)

    def time_ms(fn, reps: int = 5) -> float:
        fn()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / reps

    def graph_ms(fn, calls: int = 20, reps: int = 5) -> float:
        """Per-call time of a CUDA graph of `calls` calls of fn, replayed:
        the device's time, without the host's per-call launch cost."""
        fn()
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(calls):
                fn()
        graph.replay()
        ms = time_ms(graph.replay, reps) / calls
        del graph
        return ms

    def bound(flops: float, nbytes: float, dtype) -> tuple[float, str]:
        """The card's least time: the larger of the operations at the
        dtype's peak rate and the bytes at the memory's."""
        t_ops, t_mem = flops / peak[dtype], nbytes / HBM_BYTES_PER_S
        return (1e3 * max(t_ops, t_mem), "operations" if t_ops >= t_mem else "bytes")

    gen = torch.Generator(device="cpu").manual_seed(0)
    rows: dict[str, dict] = {}

    # 3a. psum_matmul at the GEMM's planned blocks, as ops.matmul plans them
    wl = plan.MatmulWorkload(m=M, n=N, k=K)
    sched = ops.matmul_schedule(M, K, N, vmem_budget=plan.SMEM_BUDGET)
    print(f"gemm {M}x{K}x{N}: blocks bm={sched.bm} bn={sched.bn} bk={sched.bk}")
    # the body each dtype's plan takes, then bodies asked for by name
    body_for = {torch.float32: "tc_3xtf32", torch.bfloat16: "tc_bf16"}
    forced = {torch.float32: ("cuda_core",), torch.bfloat16: ()}
    gk = -(-K // sched.bk)
    gemm_in = {}
    for dtype in (torch.float32, torch.bfloat16):
        x = torch.randn(M, K, generator=gen).to(dev, dtype)
        w = torch.randn(K, N, generator=gen).to(dev, dtype)
        gemm_in[dtype] = (x, w)
        dname = str(dtype).removeprefix("torch.")
        for controller in ("active", "passive"):
            for body in (None, *forced[dtype]):
                lp = psum_matmul.matmul_launch_plan(m=M, k=K, n=N, bm=sched.bm,
                                                    bn=sched.bn, bk=sched.bk,
                                                    controller=controller,
                                                    dtype=dtype, body=body)
                if lp.body != (body or body_for[dtype]):
                    fail(f"{lp.name} {dname}: body {lp.body}, expected "
                         f"{body or body_for[dtype]}")
                got = lp.cuda(x, w)
                want = lp.plain(x, w)
                torch.cuda.synchronize()
                tol = MATMUL_TOL[dname]
                err = (got.float() - want.float()).abs().max().item()
                if not torch.allclose(got.float(), want.float(), rtol=tol, atol=tol):
                    fail(f"{lp.name} {dname} {lp.body}: kernel vs plain max abs err {err}")
                out_size = 4 if controller == "passive" else x.element_size()
                nbytes = (M * K + K * N) * x.element_size() + M * N * out_size
                b_ms, b_by = bound(float(wl.flops), nbytes, dtype)
                stats = {"max_abs_err": err, "ms": graph_ms(lambda: lp.cuda(x, w)),
                         "plain_ms": time_ms(lambda: lp.plain(x, w)),
                         "bound_ms": b_ms, "bound_by": b_by,
                         "library_ms": graph_ms(lambda: torch.matmul(x, w)),
                         "eager_ms": time_ms(lambda: lp.cuda(x, w)),
                         "eager_library_ms": time_ms(lambda: torch.matmul(x, w)),
                         "body": lp.body, "threads": lp.threads,
                         "smem_bytes": lp.smem_bytes,
                         "launches_per_call": lp.launches}
                if lp.body == "tc_3xtf32":
                    # three TF32 passes bound this body; the fp32 cores'
                    # bound beside it
                    t_ms, t_by = bound(float(wl.flops), nbytes, "tf32x3")
                    stats.update(bound_ms=t_ms, bound_by=t_by,
                                 fp32_bound_ms=b_ms, fp32_bound_by=b_by,
                                 pack_ms=graph_ms(lambda: psum_matmul.tf32_pack(x, w)),
                                 pack_bound_ms=1e3 * 3 * (M * K + K * N) * 4
                                 / HBM_BYTES_PER_S)
                if controller == "passive":
                    # the passive schedule's own traffic: X and W once, and the
                    # fp32 C tile through device memory at every k-step,
                    # (2 gk - 1) M N words
                    s_ms, s_by = bound(float(wl.flops),
                                       (M * K + K * N) * x.element_size()
                                       + (2 * gk - 1) * M * N * 4,
                                       "tf32x3" if lp.body == "tc_3xtf32" else dtype)
                    stats.update(spill_bound_ms=s_ms, spill_bound_by=s_by)
                print(f"{lp.name} {dname}: " + " ".join(
                    f"{k}={v:.4g}" if isinstance(v, float) else f"{k}={v}"
                    for k, v in stats.items()))
                key = dname if body is None else f"{dname}/{body}"
                rows.setdefault(lp.name, {})[key] = stats
                del got, want

    # the pack pass's four arrays, bit for bit against tf32_split: at the
    # GEMM's operands, and at rounding ties, zeros, subnormals and infinities
    def int32_words(words):
        return torch.tensor([v - (1 << 32) if v >= 1 << 31 else v for v in words],
                            dtype=torch.int32)

    special = int32_words([0x00000000, 0x80000000, 0x00000001, 0x80000FFF,
                           0x00001000, 0x00001001, 0x00002FFF, 0x007FFFFF,
                           0x807FF000, 0x3F801000, 0xBF801000, 0x3F800FFF,
                           0x3F803000, 0xC0001001, 0x7F800000, 0xFF800000])
    xs_small = torch.randn(64, 96, generator=gen)
    ws_small = torch.randn(96, 80, generator=gen)
    for t in (xs_small, ws_small):
        t.view(-1).view(torch.int32)[:special.numel()] = special
    for what, (xa, wa) in {"gemm": gemm_in[torch.float32],
                           "specials": (xs_small.to(dev), ws_small.to(dev))}.items():
        xs, wts = psum_matmul.tf32_pack(xa, wa)
        want = (*psum_matmul.tf32_split(xa), *psum_matmul.tf32_split(wa.t()))
        for part, got, ref_part in zip(("X_hi", "X_lo", "Wt_hi", "Wt_lo"),
                                       (*xs, *wts), want):
            if not torch.equal(got.view(torch.int32),
                               ref_part.contiguous().view(torch.int32)):
                bad = (got.view(torch.int32)
                       != ref_part.contiguous().view(torch.int32)).sum().item()
                fail(f"psum_matmul/pack {what}: {part} differs from tf32_split "
                     f"in {bad} words")
        del xs, wts, want
    print("psum_matmul/pack: X_hi, X_lo, Wt_hi, Wt_lo equal tf32_split bit for "
          "bit (GEMM operands and special values)")

    # 3b. conv2d_psum on the 512 -> 512 3x3 layer at 56 px
    graph = NetworkGraph.from_cnn("resnet18").shrink(56, 1)
    plans = plan.plan_many(graph.workloads, P_MACS, "exact_opt", "active")
    schedules = {node.name: p.schedule
                 for node, p in zip(graph.workload_nodes, plans)}
    big = next(p for p in plans if p.workload.cin == p.workload.cout == 512
               and p.workload.k == 3)
    cw = big.workload
    pad = cw.k // 2
    xc = torch.nn.functional.pad(
        torch.randn(cw.cin, cw.hi, cw.wi, generator=gen), (pad,) * 4).to(dev)
    wc = (torch.randn(cw.cout, cw.cin, cw.k, cw.k, generator=gen)
          / (cw.cin * cw.k * cw.k) ** 0.5).to(dev)
    cp = conv2d_psum.conv_launch_plan(cin=cw.cin, hp=cw.hi + 2 * pad,
                                      wp=cw.wi + 2 * pad, cout=cw.cout, kk=cw.k,
                                      block_m=big.schedule.m,
                                      block_n=big.schedule.n)
    xcp = torch.nn.functional.pad(xc, (0, 0, 0, 0, 0, cp.inputs[0].array_shape[0] - cw.cin))
    wcp = torch.nn.functional.pad(
        wc, (0, 0, 0, 0, 0, cp.inputs[1].array_shape[1] - cw.cin,
             0, cp.inputs[1].array_shape[0] - cw.cout)).contiguous()
    conv_body = {torch.float32: "cuda_core", torch.bfloat16: "tc_bf16"}
    for dtype, tol in ((torch.float32, CONV_TOL), (torch.bfloat16, 5e-2)):
        dname = str(dtype).removeprefix("torch.")
        cp = conv2d_psum.conv_launch_plan(
            cin=cw.cin, hp=cw.hi + 2 * pad, wp=cw.wi + 2 * pad, cout=cw.cout,
            kk=cw.k, block_m=big.schedule.m, block_n=big.schedule.n, dtype=dtype)
        print(f"conv {cw.name} {cw.cin}->{cw.cout} k{cw.k} at {cw.hi}px {dname}: "
              f"m={big.schedule.m} n={big.schedule.n} body={cp.body} "
              f"grid={cp.grid} threads={cp.threads} smem={cp.smem_bytes} "
              f"loops={cp.loops}")
        if cp.body != conv_body[dtype]:
            fail(f"conv2d_psum {dname}: body {cp.body}, expected {conv_body[dtype]}")
        xd, wd, xpd, wpd = (t.to(dtype) for t in (xc, wc, xcp, wcp))
        got = cp.cuda(xpd, wpd)
        want = cp.plain(xpd, wpd)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        if not torch.allclose(got.float(), want.float(), rtol=tol, atol=tol):
            fail(f"conv2d_psum {dname}: kernel vs plain max abs err {err}")
        b_ms, b_by = bound(2.0 * cw.macs, xd.element_size() * (
            xd.numel() + wd.numel() + cw.cout * cw.ho * cw.wo), dtype)
        def cudnn():
            return torch.nn.functional.conv2d(xd[None], wd)
        stats = {"max_abs_err": err, "ms": graph_ms(lambda: cp.cuda(xpd, wpd)),
                 "plain_ms": time_ms(lambda: cp.plain(xpd, wpd)),
                 "bound_ms": b_ms, "bound_by": b_by,
                 "library_ms": graph_ms(cudnn),
                 "eager_ms": time_ms(lambda: cp.cuda(xpd, wpd), reps=20),
                 "eager_library_ms": time_ms(cudnn, reps=20),
                 "body": cp.body, "threads": cp.threads,
                 "smem_bytes": cp.smem_bytes, "launches_per_call": cp.launches}
        print(f"conv2d_psum {dname}: " + " ".join(
            f"{k}={v:.4g}" if isinstance(v, float) else f"{k}={v}"
            for k, v in stats.items()))
        rows.setdefault("conv2d_psum", {})[dname] = stats
        del got, want

    # 3c. the kernels' other cases, small: every activation, padded edges,
    #     odd channel blocks, stride 2, K in {1, 3, 7}, both dtypes; the
    #     kernel on the card against the plain version on the CPU
    cases = 0
    for dname, dtype in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
        xs = torch.randn(50, 160, generator=gen).to(dtype)
        ws = torch.randn(160, 150, generator=gen).to(dtype)
        for controller in ("active", "passive"):
            for act in psum_matmul.ACTIVATIONS:
                kw = dict(bm=32, bn=64, bk=64, act=act, controller=controller)
                got = psum_matmul.psum_matmul(xs.to(dev), ws.to(dev), **kw).cpu()
                want = psum_matmul.psum_matmul(xs, ws, **kw)
                tol = MATMUL_TOL[dname]
                if not torch.allclose(got.float(), want.float(), rtol=tol, atol=tol):
                    fail(f"psum_matmul {controller} {act} {dname} at 50x160x150")
                cases += 1
        # the 50 x 160 x 150 cases above take tc_bf16 in bf16 and tc_3xtf32
        # in fp32 (a 32-row block, under one wgmma tile); these add ragged M,
        # N and K at blocks of 64 and 128, K of one chunk, and (fp32) K and
        # k-steps that are not a multiple of a chunk and odd bn. In bf16, W's
        # blocks of 13 columns start off 16 bytes, and in fp32 k-steps of 90
        # columns do, so those plans take cuda_core.
        small_gemms = {
            torch.bfloat16: (((200, 320, 300), (128, 128, 128), "tc_bf16"),
                             ((200, 320, 300), (64, 128, 64), "tc_bf16"),
                             ((100, 64, 72), (128, 128, 64), "tc_bf16"),
                             ((8, 40, 24), (8, 8, 40), "tc_bf16"),
                             ((70, 200, 104), (48, 13, 96), "cuda_core")),
            torch.float32: (((200, 320, 300), (128, 128, 128), "tc_3xtf32"),
                            ((200, 300, 300), (64, 128, 100), "tc_3xtf32"),
                            ((100, 36, 72), (128, 128, 36), "tc_3xtf32"),
                            ((8, 40, 24), (8, 8, 40), "tc_3xtf32"),
                            ((70, 200, 104), (50, 13, 100), "tc_3xtf32"),
                            ((50, 90, 77), (50, 77, 90), "cuda_core"))}
        for (m_, k_, n_), (bm_, bn_, bk_), body in small_gemms[dtype]:
            xs = torch.randn(m_, k_, generator=gen).to(dtype)
            ws = torch.randn(k_, n_, generator=gen).to(dtype)
            for controller in ("active", "passive"):
                got_body = psum_matmul.matmul_launch_plan(
                    m=m_, k=k_, n=n_, bm=bm_, bn=bn_, bk=bk_,
                    controller=controller, dtype=dtype).body
                if got_body != body:
                    fail(f"psum_matmul {(m_, k_, n_)} blocks "
                         f"{(bm_, bn_, bk_)} {dname}: body {got_body}, expected {body}")
                for act in psum_matmul.ACTIVATIONS:
                    kw = dict(bm=bm_, bn=bn_, bk=bk_, act=act,
                              controller=controller)
                    got = psum_matmul.psum_matmul(xs.to(dev), ws.to(dev), **kw).cpu()
                    want = psum_matmul.psum_matmul(xs, ws, **kw)
                    tol = MATMUL_TOL[dname]
                    if not torch.allclose(got.float(), want.float(), rtol=tol, atol=tol):
                        fail(f"psum_matmul {body} {controller} {act} {dname} at "
                             f"{(m_, k_, n_)} blocks {(bm_, bn_, bk_)}: max abs "
                             f"err {(got.float() - want.float()).abs().max().item()}")
                    cases += 1
        # conv: stride 1 and 2, K in {1, 3, 7}, every activation at (13, 17)
        # blocks; blocks of n in {8, 13, 17, 24, 64} over ragged cout; 1x1
        # blocks of 1280 and 2048 channels, wider than one thread block
        conv_cases = [(30, 40, kk, 9, stride, 13, 17, act) for stride in (1, 2)
                      for kk in (1, 3, 7) for act in psum_matmul.ACTIVATIONS]
        conv_cases += [(40, 2 * n + 3, 3, 12, 1, 20, n, "relu")
                       for n in (8, 13, 17, 24, 64)]
        conv_cases += [(64, 1280, 1, 7, 1, 64, 1280, "gelu"),
                       (48, 2048, 1, 5, 1, 48, 2048, "none")]
        for cin, cout, kk, hw, stride, bm, bn, act in conv_cases:
            hp = hw + 2 * (kk // 2)
            xs = torch.randn(cin, hp, hp, generator=gen).to(dtype)
            ws = (torch.randn(cout, cin, kk, kk, generator=gen)
                  / (cin * kk * kk) ** 0.5).to(dtype)
            kw = dict(block_m=bm, block_n=bn, stride=stride, act=act)
            body = conv2d_psum.conv_launch_plan(
                cin=cin, hp=hp, wp=hp, cout=cout, kk=kk, stride=stride,
                block_m=bm, block_n=bn, act=act, dtype=dtype).body
            if body != conv_body[dtype]:
                fail(f"conv2d_psum {(cin, cout, kk, stride, bm, bn)} {dname}: "
                     f"body {body}")
            got = conv2d_psum.conv2d_psum(xs.to(dev), ws.to(dev), **kw).cpu()
            want = conv2d_psum.conv2d_psum(xs, ws, **kw)
            tol = CONV_TOL if dtype == torch.float32 else 5e-2
            if not torch.allclose(got.float(), want.float(), rtol=tol, atol=tol):
                fail(f"conv2d_psum {body} {(cin, cout, kk, hw, stride, bm, bn, act)} "
                     f"{dname}: max abs err "
                     f"{(got.float() - want.float()).abs().max().item()}")
            cases += 1
    # 3d. flash_attention at Qwen2-1.5B's serving shapes: the body each
    #     plan takes, and fp32 prefill on cuda_core asked for by name
    qcfg = get_config(SERVE_ARCH)
    hq, hkv, hd = qcfg.n_heads, qcfg.n_kv_heads, qcfg.hd
    flash_body_for = {("prefill", torch.float32): "tc_3xtf32",
                      ("prefill", torch.bfloat16): "tc_bf16",
                      ("decode", torch.float32): "split_kv",
                      ("decode", torch.bfloat16): "split_kv"}
    for case, (sq, skv, q_off) in {"prefill": (PROMPT, PROMPT, 0),
                                   "decode": (1, PROMPT + GEN, PROMPT + GEN - 1)
                                   }.items():
        for dtype in (torch.float32, torch.bfloat16):
            dname = str(dtype).removeprefix("torch.")
            q = torch.randn(SERVE_BATCH * hq, sq, hd, generator=gen).to(dev, dtype)
            k, v = (torch.randn(SERVE_BATCH * hkv, skv, hd, generator=gen)
                    .to(dev, dtype) for _ in range(2))
            forced_flash = ("cuda_core",) if (case, dtype) == ("prefill", torch.float32) \
                else ()
            for body in (None, *forced_flash):
                fp = flash_attention.flash_launch_plan(
                    bh=SERVE_BATCH * hq, sq=sq, skv=skv, d=hd, q_offset=q_off,
                    kv_group=hq // hkv, dtype=dtype, body=body)
                want_body = body or flash_body_for[(case, dtype)]
                if fp.body != want_body:
                    fail(f"flash_attention {case} {dname}: body {fp.body}, expected "
                         f"{want_body}")
                print(f"flash {case} {dname}: B={SERVE_BATCH} Hq={hq} Hkv={hkv} "
                      f"Sq={sq} Skv={skv} D={hd} q_offset={q_off} body={fp.body} "
                      f"grid={fp.grid} threads={fp.threads} smem={fp.smem_bytes} "
                      f"loops={fp.loops}")
                kp, vp = (torch.nn.functional.pad(
                    t, (0, 0, 0, fp.inputs[1].array_shape[1] - skv)).contiguous()
                    for t in (k, v))
                got = fp.cuda(q, kp, vp)
                want = fp.plain(q, kp, vp)
                torch.cuda.synchronize()
                tol = FLASH_TOL[dname]
                err = (got.float() - want.float()).abs().max().item()
                if not torch.allclose(got.float(), want.float(), rtol=tol, atol=tol):
                    fail(f"flash_attention {case} {dname} {fp.body}: kernel vs plain "
                         f"max abs err {err}")
                # SDPA, the yardstick: q heads grouped over repeated kv heads
                q4 = q.view(SERVE_BATCH, hq, sq, hd)
                k4, v4 = (t.view(SERVE_BATCH, hkv, skv, hd)
                          .repeat_interleave(hq // hkv, dim=1) for t in (k, v))
                flops = 4.0 * SERVE_BATCH * hq * sq * skv * hd
                if case == "prefill":
                    flops /= 2                                  # causal
                nbytes = q.element_size() * (2 * q.numel() + k.numel() + v.numel())
                b_ms, b_by = bound(flops, nbytes, dtype)
                def sdpa():
                    return torch.nn.functional.scaled_dot_product_attention(
                        q4, k4, v4, is_causal=case == "prefill")
                stats = {"max_abs_err": err, "ms": graph_ms(lambda: fp.cuda(q, kp, vp)),
                         "plain_ms": time_ms(lambda: fp.plain(q, kp, vp)),
                         "bound_ms": b_ms, "bound_by": b_by,
                         "library_ms": graph_ms(sdpa),
                         "eager_ms": time_ms(lambda: fp.cuda(q, kp, vp), reps=20),
                         "eager_library_ms": time_ms(sdpa, reps=20),
                         "body": fp.body, "launches_per_call": fp.launches}
                if fp.body == "tc_3xtf32":
                    # three TF32 passes bound this body; the fp32 cores'
                    # bound beside it. The pack reads K and V once and
                    # writes K_hi, K_lo, Vt_hi and Vt_lo.
                    skv_t = -(-kp.shape[1] // flash_attention.TF_KT) * flash_attention.TF_KT
                    t_ms, t_by = bound(flops, nbytes, "tf32x3")
                    stats.update(bound_ms=t_ms, bound_by=t_by,
                                 fp32_bound_ms=b_ms, fp32_bound_by=b_by,
                                 pack_ms=graph_ms(lambda: flash_attention.tf32_pack_kv(
                                     kp, vp, skv_t=skv_t)),
                                 pack_bound_ms=1e3 * 3 * 4 * (k.numel() + v.numel())
                                 / HBM_BYTES_PER_S)
                print(f"flash_attention {case} {dname}: " + " ".join(
                    f"{k}={v:.4g}" if isinstance(v, float) else f"{k}={v}"
                    for k, v in stats.items()))
                key = dname if body is None else f"{dname}/{body}"
                rows.setdefault("flash_attention", {}).setdefault(case, {})[key] = stats
                del got, want, kp, vp, q4, k4, v4
            if (case, dtype) == ("prefill", torch.float32):
                flash_kv = (k, v)
            del q, k, v

    # tc_3xtf32's pack pass, bit for bit against tf32_split: at the prefill's
    # K and V, and at rounding ties, zeros, subnormals and infinities
    ks_small = torch.randn(2, 40, 64, generator=gen)
    vs_small = torch.randn(2, 40, 64, generator=gen)
    for t in (ks_small, vs_small):
        t.view(-1).view(torch.int32)[:special.numel()] = special
    for what, (ka, va) in {"prefill": flash_kv,
                           "specials": (ks_small.to(dev), vs_small.to(dev))}.items():
        skv_t = -(-ka.shape[1] // flash_attention.TF_KT) * flash_attention.TF_KT
        got = flash_attention.tf32_pack_kv(ka, va, skv_t=skv_t)
        want = flash_attention.tf32_pack_kv(ka.cpu(), va.cpu(), skv_t=skv_t)
        for part, g, w in zip(("K", "Vt"), got, want):
            for half, gh, wh in zip(("hi", "lo"), g.cpu(), w):
                if not torch.equal(gh.view(torch.int32), wh.contiguous().view(torch.int32)):
                    bad = (gh.view(torch.int32) != wh.contiguous().view(torch.int32)).sum()
                    fail(f"flash_attention/pack {what}: {part}_{half} differs from "
                         f"tf32_split in {bad.item()} words")
        del got, want
    del flash_kv
    print("flash_attention/pack: K_hi, K_lo, Vt_hi, Vt_lo equal tf32_split bit for "
          "bit (prefill K and V, and special values)")

    # 3d'. split_kv with a device position, as the compiled decode step runs
    #      it: K and V are a whole cache of PROMPT + GEN keys, unpadded, and
    #      pass 1 reads (q_offset, valid length) from device memory. At the
    #      prompt's end, the last slot, each side of the last split boundary
    #      and inside the first split (the other splits see no key); timed
    #      at the last slot, where every key is valid
    cap = PROMPT + GEN
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).removeprefix("torch.")
        fp = flash_attention.flash_launch_plan(
            bh=SERVE_BATCH * hq, sq=1, skv=cap, d=hd, kv_group=hq // hkv,
            dtype=dtype, device_pos=True)
        if fp.body != "split_kv" or fp.inputs[1].array_shape[1] != cap:
            fail(f"flash_attention decode/device {dname}: body {fp.body}, keys "
                 f"{fp.inputs[1].array_shape}")
        splits = fp.loops[1][1]
        split_len = -(-cap // splits)
        edge = split_len * (splits - 1)
        q = torch.randn(SERVE_BATCH * hq, 1, hd, generator=gen).to(dev, dtype)
        k, v = (torch.randn(SERVE_BATCH * hkv, cap, hd, generator=gen).to(dev, dtype)
                for _ in range(2))
        errs = {}
        for at in (PROMPT, cap - 1, edge - 1, edge, split_len // 2):
            pos = torch.tensor([at, at + 1], dtype=torch.int32, device=dev)
            got = fp.cuda(q, k, v, pos=pos)
            want = fp.plain(q, k, v, pos=pos)
            torch.cuda.synchronize()
            errs[at] = (got.float() - want.float()).abs().max().item()
            tol = FLASH_TOL[dname]
            if not torch.allclose(got.float(), want.float(), rtol=tol, atol=tol):
                fail(f"flash_attention decode/device {dname} at position {at}: "
                     f"kernel vs plain max abs err {errs[at]}")
        pos = torch.tensor([cap - 1, cap], dtype=torch.int32, device=dev)
        q4 = q.view(SERVE_BATCH, hq, 1, hd)
        k4, v4 = (t.view(SERVE_BATCH, hkv, cap, hd).repeat_interleave(hq // hkv, dim=1)
                  for t in (k, v))
        flops = 4.0 * SERVE_BATCH * hq * cap * hd
        nbytes = q.element_size() * (2 * q.numel() + k.numel() + v.numel())
        b_ms, b_by = bound(flops, nbytes, dtype)
        def sdpa():
            return torch.nn.functional.scaled_dot_product_attention(q4, k4, v4)
        stats = {"max_abs_err": max(errs.values()),
                 "ms": graph_ms(lambda: fp.cuda(q, k, v, pos=pos)),
                 "plain_ms": time_ms(lambda: fp.plain(q, k, v, pos=pos)),
                 "bound_ms": b_ms, "bound_by": b_by, "library_ms": graph_ms(sdpa),
                 "eager_ms": time_ms(lambda: fp.cuda(q, k, v, pos=pos), reps=20),
                 "body": fp.body, "splits": splits, "split_len": split_len,
                 "launches_per_call": fp.launches,
                 "max_abs_err_at": {str(a): e for a, e in errs.items()}}
        print(f"flash_attention decode/device {dname}: Skv={cap} (a cache; "
              f"positions {list(errs)}) " + " ".join(
                  f"{k}={v:.4g}" if isinstance(v, float) else f"{k}={v}"
                  for k, v in stats.items()))
        rows["flash_attention"].setdefault("decode_device", {})[dname] = stats
        del q, k, v, q4, k4, v4

    # 3e. flash_attention's other cases, small: the reference's cases
    #     (tests/test_kernels.py), odd blocks, GQA, head dims 32 to 256
    flash_small = [(2, 128, 128, 64, True, 64, 64, 1), (1, 64, 64, 32, False, 32, 32, 1),
                   (3, 100, 100, 64, True, 32, 32, 1), (2, 1, 256, 64, True, 1, 64, 1),
                   (2, 8, 384, 128, True, 8, 128, 1), (1, 17, 17, 32, True, 16, 32, 1),
                   (8, 20, 52, 64, True, 16, 16, 4), (2, 40, 40, 256, True, 16, 16, 1),
                   (8, 200, 200, 160, True, 128, 128, 4)]
    for dname, dtype in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
        for bh, sq, skv, d, causal, bq, bk, grp in flash_small:
            q = torch.randn(bh, sq, d, generator=gen).to(dtype)
            k, v = (torch.randn(bh // grp, skv, d, generator=gen).to(dtype)
                    for _ in range(2))
            kw = dict(causal=causal, bq=bq, bk=bk, q_offset=skv - sq if causal else 0)
            got = flash_attention.flash_attention(q.to(dev), k.to(dev), v.to(dev),
                                                  **kw).cpu()
            want = flash_attention.flash_attention(q, k, v, **kw)
            tol = FLASH_TOL[dname]
            if not torch.allclose(got.float(), want.float(), rtol=tol, atol=tol):
                fail(f"flash_attention {(bh, sq, skv, d, causal, bq, bk, grp)} "
                     f"{dname}: max abs err "
                     f"{(got.float() - want.float()).abs().max().item()}")
            cases += 1
    # 3f. tc_bf16, small: every head dim, padded q and kv tails, GQA, a
    #     non-causal call, a q offset, 64-row heads in a grid of 200
    tc_small = [(2, 128, 128, 32, True, 1), (2, 128, 128, 64, True, 1),
                (2, 128, 128, 128, True, 1), (2, 512, 512, 256, True, 1),
                (4, 300, 300, 128, True, 2), (4, 256, 256, 128, False, 1),
                (2, 256, 1000, 128, True, 2), (200, 64, 64, 64, True, 1),
                (8, 300, 300, 160, True, 4)]
    for bh, sq, skv, d, causal, grp in tc_small:
        q_off = skv - sq if causal else 0
        tp = flash_attention.flash_launch_plan(bh=bh, sq=sq, skv=skv, d=d,
                                               causal=causal, q_offset=q_off,
                                               kv_group=grp, dtype=torch.bfloat16)
        if tp.body != "tc_bf16":
            fail(f"flash_attention {(bh, sq, skv, d, causal, grp)}: body {tp.body}")
        q = torch.randn(bh, sq, d, generator=gen).to(torch.bfloat16)
        k, v = (torch.randn(bh // grp, skv, d, generator=gen).to(torch.bfloat16)
                for _ in range(2))
        kw = dict(causal=causal, q_offset=q_off)
        got = flash_attention.flash_attention(q.to(dev), k.to(dev), v.to(dev),
                                              **kw).cpu()
        want = flash_attention.flash_attention(q, k, v, **kw)
        tol = FLASH_TOL["bfloat16"]
        if not torch.allclose(got.float(), want.float(), rtol=tol, atol=tol):
            fail(f"flash_attention tc_bf16 {(bh, sq, skv, d, causal, grp)}: max "
                 f"abs err {(got.float() - want.float()).abs().max().item()}")
        cases += 1

    # 3g. tc_3xtf32, small: head dims 32, 64, 100 (padded to 128) and 128,
    #     padded q and kv tails, GQA 4:1 and 6:1, a non-causal call, a q
    #     offset, 64-row heads in a grid of 200; and V = I (one kv head per
    #     q head), where the output is softmax(S) itself, so a wrong map of
    #     P's registers onto V^T's permuted keys shows as errors of order 1
    tf_small = [(2, 128, 128, 32, True, 1), (2, 128, 128, 64, True, 1),
                (2, 128, 128, 128, True, 1), (4, 300, 300, 128, True, 2),
                (4, 256, 256, 128, False, 1), (2, 256, 1000, 128, True, 2),
                (200, 64, 64, 64, True, 1), (8, 300, 300, 100, True, 4),
                (12, 130, 170, 128, True, 6), (8, 77, 77, 32, True, 4),
                (2, 128, 128, 128, False, "eye")]
    for bh, sq, skv, d, causal, grp in tf_small:
        q_off = skv - sq if causal else 0
        eye = grp == "eye"
        grp = 1 if eye else grp
        tp = flash_attention.flash_launch_plan(bh=bh, sq=sq, skv=skv, d=d,
                                               causal=causal, q_offset=q_off,
                                               kv_group=grp, dtype=torch.float32)
        if tp.body != "tc_3xtf32":
            fail(f"flash_attention {(bh, sq, skv, d, causal, grp)}: body {tp.body}")
        q = torch.randn(bh, sq, d, generator=gen)
        k, v = (torch.randn(bh // grp, skv, d, generator=gen) for _ in range(2))
        if eye:
            v = torch.eye(skv, d).expand(bh, skv, d).contiguous()
        kw = dict(causal=causal, q_offset=q_off)
        got = flash_attention.flash_attention(q.to(dev), k.to(dev), v.to(dev),
                                              **kw).cpu()
        want = flash_attention.flash_attention(q, k, v, **kw)
        if eye:
            s = q @ k.mT / d ** 0.5
            want_p = torch.softmax(s, -1)
            if not torch.allclose(want.float(), want_p, rtol=1e-5, atol=1e-5):
                fail("flash_attention plain version with V = I is not softmax(S)")
        tol = FLASH_TOL["float32"]
        if not torch.allclose(got.float(), want.float(), rtol=tol, atol=tol):
            fail(f"flash_attention tc_3xtf32 {(bh, sq, skv, d, causal, grp, eye)}: "
                 f"max abs err {(got.float() - want.float()).abs().max().item()}")
        cases += 1

    # 3h. split_kv, small: Sq 1 and 8, GQA 4:1 and 6:1 over 2 kv heads,
    #     fewer keys than a staged tile, keys not a multiple of the split,
    #     head dims 64 to 256; each call must take the split_kv body
    split_small = [(1, 20, 64, 4), (8, 20, 128, 6), (1, 1001, 128, 6),
                   (8, 1001, 256, 4), (1, 300, 256, 6), (8, 77, 64, 4),
                   (1, 1056, 128, 4), (8, 1056, 64, 6), (1, 1056, 160, 4)]
    for dname, dtype in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
        for sq, skv, d, grp in split_small:
            bh, q_off = 2 * grp, skv - sq
            sp = flash_attention.flash_launch_plan(bh=bh, sq=sq, skv=skv, d=d,
                                                   q_offset=q_off, kv_group=grp,
                                                   dtype=dtype)
            if sp.body != "split_kv":
                fail(f"flash_attention {(sq, skv, d, grp)}: body {sp.body}")
            q = torch.randn(bh, sq, d, generator=gen).to(dtype)
            k, v = (torch.randn(2, skv, d, generator=gen).to(dtype)
                    for _ in range(2))
            got = flash_attention.flash_attention(q.to(dev), k.to(dev), v.to(dev),
                                                  q_offset=q_off).cpu()
            want = flash_attention.flash_attention(q, k, v, q_offset=q_off)
            tol = FLASH_TOL[dname]
            if not torch.allclose(got.float(), want.float(), rtol=tol, atol=tol):
                fail(f"flash_attention split_kv {(sq, skv, d, grp)} {dname} "
                     f"({sp.loops}): max abs err "
                     f"{(got.float() - want.float()).abs().max().item()}")
            cases += 1
    print(f"small cases: {cases} kernel launches on the card match the plain "
          f"versions on the CPU")

    # 4. the main path, counted (one image first, uncounted, loads every
    #    kernel variant and warms the allocator). The GEMM's plans, as
    #    ops.matmul makes them: bf16 on tc_bf16, fp32 on tc_3xtf32.
    for dtype in gemm_in:
        for controller in ("active", "passive"):
            s = ops.matmul_schedule(M, K, N, controller=controller,
                                    vmem_budget=plan.SMEM_BUDGET)
            body = psum_matmul.matmul_launch_plan(
                m=M, k=K, n=N, bm=s.bm, bn=s.bn, bk=s.bk, controller=controller,
                dtype=dtype).body
            if body != body_for[dtype]:
                fail(f"ops.matmul {controller} {dtype}: plan takes {body}")
    params = init_network_params(graph, seed=0, device=dev)
    images = [torch.randn(3, 56, 56, generator=torch.Generator().manual_seed(s))
              for s in range(IMAGES)]
    image_in = graph.inputs[0]
    net_out = graph.outputs[0]
    run_network_kernels(graph, schedules, params, seed=IMAGES, device=dev)
    launch.reset_launches()
    answers, image_ms = [], []
    for img in images:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        values = run_network_kernels(graph, schedules, params,
                                     inputs={image_in: img}, device=dev)
        torch.cuda.synchronize()
        image_ms.append(1e3 * (time.perf_counter() - t0))
        answers.append(values[net_out])
        del values
    gemm_out = {}
    for dtype, (x, w) in gemm_in.items():
        for controller in ("active", "passive"):
            gemm_out[(dtype, controller)] = ops.matmul(
                x, w, controller=controller, vmem_budget=plan.SMEM_BUDGET)
    torch.cuda.synchronize()
    counts = dict(launch.LAUNCHES)
    print(f"main path launches: {counts}")

    convs = len(graph.workload_nodes)
    expect = {"conv2d_psum": convs * IMAGES, "conv2d_psum/pack": convs * IMAGES,
              "psum_matmul/active": 2, "psum_matmul/passive": 2 * gk,
              "psum_matmul/pack": 2}            # once per fp32 call
    for name, n in expect.items():
        if counts.get(name, 0) != n:
            fail(f"{name} launched {counts.get(name, 0)} times on the main "
                 f"path, expected {n}")

    # checks of what came out: each image's answer against the reference
    # walk, and every tensor of image 0 (run again, outside the count)
    def rel_err(got, want, what):
        if got.shape != want.shape or not torch.isfinite(got).all():
            fail(f"{what}: shape {tuple(got.shape)} or non-finite values")
        rel = ((got - want).abs().max() / want.abs().max()).item()
        if rel > NETWORK_REL_TOL:
            fail(f"{what}: max abs err / max abs = {rel}")
        return rel

    worst, ref_ms = 0.0, []
    for i, (img, got) in enumerate(zip(images, answers)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want = run_network_reference(graph, params, inputs={image_in: img},
                                     device=dev)
        torch.cuda.synchronize()
        ref_ms.append(1e3 * (time.perf_counter() - t0))
        worst = max(worst, rel_err(got, want[net_out], f"image {i} output"))
        print(f"image {i}: {image_ms[i]:.3f} ms (reference walk "
              f"{ref_ms[i]:.3f} ms), output {tuple(got.shape)}, "
              f"mean {got.mean().item():.6f}")
        if i == 0:
            again = run_network_kernels(graph, schedules, params,
                                        inputs={image_in: img}, device=dev)
            for name, value in want.items():
                worst = max(worst, rel_err(again[name], value, f"image 0 {name}"))
            del again
        del want
    print(f"network: {IMAGES} images x {convs} convs, worst max-abs-err/max-abs "
          f"{worst:.3g} (limit {NETWORK_REL_TOL}); image ms {image_ms}")

    # where one image's time goes on the device
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run_network_kernels(graph, schedules, params, inputs={image_in: images[0]},
                            device=dev)
        torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - t0)
    # busy time sums the kernels themselves: a CPU op such as aten::cat
    # also reports the device time of the kernels it launched
    busy, all_events, conv_busy, pack_busy = 0.0, 0.0, 0.0, 0.0
    for evt in prof.key_averages():
        dev_us = getattr(evt, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(evt, "self_cuda_time_total", 0.0)
        all_events += dev_us / 1e3
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        busy += dev_us / 1e3
        if "conv_core" in evt.key or "conv_tc" in evt.key:
            conv_busy += dev_us / 1e3
        elif "::pack" in evt.key:
            pack_busy += dev_us / 1e3
    median_ms = sorted(image_ms)[len(image_ms) // 2]
    print(f"profile (one image): device busy {busy:.3f} ms (kernel events; "
          f"{all_events:.3f} ms summed over all events), conv2d_psum kernels "
          f"{conv_busy:.3f} ms ({conv_busy / busy:.3f} of busy) and their pack "
          f"passes {pack_busy:.3f} ms ({pack_busy / busy:.3f}); wall "
          f"{wall:.3f} ms profiled, {median_ms:.3f} ms unprofiled (median "
          f"image); idle share of the unprofiled wall {1 - busy / median_ms:.3f}")
    # every layer in both bodies: held against the plain version on the
    # same inputs, and timed (graph replays, the pack pass included)
    layer_ms = {"float32": 0.0, "bfloat16": 0.0}
    for node, p in zip(graph.workload_nodes, plans):
        wl, pad = node.workload, node.workload.k // 2
        for dtype, tol in ((torch.float32, CONV_TOL), (torch.bfloat16, 5e-2)):
            dname = str(dtype).removeprefix("torch.")
            lp = conv2d_psum.conv_launch_plan(
                cin=wl.cin, hp=wl.hi + 2 * pad, wp=wl.wi + 2 * pad, cout=wl.cout,
                kk=wl.k, block_m=p.schedule.m, block_n=p.schedule.n, dtype=dtype)
            if lp.body != conv_body[dtype]:
                fail(f"layer {node.name} {dname}: body {lp.body}")
            xl = torch.randn(lp.inputs[0].array_shape, generator=gen).to(dev, dtype)
            wt = (torch.randn(lp.inputs[1].array_shape, generator=gen)
                  / (wl.cin * wl.k ** 2) ** 0.5).to(dev, dtype)
            got, want = lp.cuda(xl, wt), lp.plain(xl, wt)
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs().max().item()
            if not torch.allclose(got.float(), want.float(), rtol=tol, atol=tol):
                fail(f"layer {node.name} {dname}: kernel vs plain max abs err {err}")
            ms = graph_ms(lambda: lp.cuda(xl, wt))
            lib = graph_ms(lambda: torch.nn.functional.conv2d(
                xl[None, :wl.cin], wt[:wl.cout, :wl.cin]))
            layer_ms[dname] += ms
            print(f"layer {node.name} {dname}: {wl.cin}->{wl.cout} k{wl.k} "
                  f"m={p.schedule.m} n={p.schedule.n} body={lp.body} "
                  f"grid={lp.grid} threads={lp.threads} smem={lp.smem_bytes} "
                  f"ms={ms:.4f} cudnn_ms={lib:.4f} tflops={2e-9 * wl.macs / ms:.2f} "
                  f"max_abs_err={err:.3g}")
            del got, want, xl, wt
    print(f"layers summed (graph replays): fp32 {layer_ms['float32']:.4f} ms, "
          f"bf16 {layer_ms['bfloat16']:.4f} ms")

    for (dtype, controller), y in gemm_out.items():
        x, w = gemm_in[dtype]
        want = ref.matmul_ref(x, w)
        tol = MATMUL_TOL[str(dtype).removeprefix("torch.")]
        if y.shape != (M, N) or y.dtype != dtype or not torch.isfinite(y).all():
            fail(f"ops.matmul {controller} {dtype}: bad shape/type/values")
        if not torch.allclose(y.float(), want.float(), rtol=tol, atol=tol):
            fail(f"ops.matmul {controller} {dtype}: differs from matmul_ref, "
                 f"max abs err {(y.float() - want.float()).abs().max().item()}")
    print("ops.matmul: active and passive, fp32 and bf16, match matmul_ref")

    # 4b. the serving path, counted: Qwen2-1.5B at full width
    from unittest import mock

    from repro_torch.launch import serve
    from repro_torch.models import steps as model_steps
    from repro_torch.models.transformer import forward
    record: dict = {}
    torch.cuda.synchronize()
    launch.reset_launches()
    report = serve.main(["--arch", SERVE_ARCH, "--requests", str(REQUESTS),
                         "--batch", str(SERVE_BATCH), "--prompt-len", str(PROMPT),
                         "--gen-len", str(GEN), "--device", "cuda"], record=record)
    torch.cuda.synchronize()
    serve_counts = dict(launch.LAUNCHES)
    print(f"serve path launches: {serve_counts}")
    scfg, sparams = record["cfg"], record["params"]
    n_batches = -(-REQUESTS // SERVE_BATCH)
    expect = {"flash_attention": scfg.n_layers * GEN * n_batches,
              "flash_attention/combine": scfg.n_layers * (GEN - 1) * n_batches}
    if serve_counts != expect:
        fail(f"serve path launched {serve_counts}, expected {expect} "
             f"({scfg.n_layers} layers x {GEN} steps x {n_batches} batches; "
             f"every decode step combines its splits)")
    print(f"serve report: {json.dumps(report)}")
    print(f"serve card: {smi}")

    # checks of batch 0: its prefill logits against the same model with
    # `ref.attention_ref` as its attention, and its decode logits
    # (teacher-forced with the generated tokens) against one full forward of
    # prompt plus generated tokens
    def ref_attention(q, k, v, *, causal, q_offset=0, **_):
        b, h, sq, d = q.shape
        k, v = (t.repeat_interleave(h // t.shape[1], dim=1) for t in (k, v))
        out = ref.attention_ref(q.reshape(b * h, sq, d), k.reshape(b * h, -1, d),
                                v.reshape(b * h, -1, d), causal, q_offset)
        return out.reshape(b, h, sq, d)

    def serve_err(got, want, what):
        got, want = got.float(), want.float()
        if got.shape != want.shape or not torch.isfinite(got).all():
            fail(f"{what}: shape {tuple(got.shape)} vs {tuple(want.shape)} or "
                 f"non-finite values")
        rel = ((got - want).abs().max() / want.abs().max()).item()
        if rel > SERVE_REL_TOL:
            fail(f"{what}: max abs err / max abs = {rel}")
        return rel

    b0 = record["batches"][0]
    with torch.inference_mode():
        with mock.patch.object(ops, "gqa_flash_attention", ref_attention):
            ref_logits = forward(sparams, scfg, b0["prompts"])[0][:, -1]
        pre_rel = serve_err(b0["logits"][:, 0], ref_logits, "prefill logits")
        del ref_logits
        full = forward(sparams, scfg, torch.cat(
            [b0["prompts"], b0["tokens"][:, :-1]], 1))[0][:, PROMPT - 1:]
        dec_rel = serve_err(b0["logits"], full, "decode logits")
        del full
    print(f"serve checks (batch 0, bf16): prefill logits vs attention_ref "
          f"{pre_rel:.3g}, decode logits vs full forward {dec_rel:.3g} "
          f"(max-abs-err/max-abs, limit {SERVE_REL_TOL})")

    # 4b'. the compiled steps against the eager step bodies, on batch 0's
    #      prompts and weights: prefill logits and caches, and three decode
    #      steps (one captured graph each), then where each one's time goes
    from repro_torch.launch import graph
    cap = PROMPT + GEN
    prefill_e = model_steps.make_prefill_step(scfg, cap)
    decode_e = model_steps.make_decode_step(scfg)
    prefill_c = graph.compile_prefill(model_steps.make_prefill_step(scfg, cap))
    decode_c = graph.compile_decode(model_steps.make_decode_step(scfg))

    def rel(got, want):
        got, want = got.float(), want.float()
        if got.shape != want.shape or not torch.isfinite(got).all():
            fail(f"compiled vs eager: shape {tuple(got.shape)} vs "
                 f"{tuple(want.shape)} or non-finite values")
        return ((got - want).abs().max() / want.abs().max()).item()

    def kv(caches):
        return [c[n] for c in caches["layers"] for n in ("k", "v")]

    with torch.inference_mode():
        cmp, same = {}, True
        le, ce = prefill_e(sparams, {"tokens": b0["prompts"]})
        lc, cc = prefill_c(sparams, {"tokens": b0["prompts"]})
        cmp["prefill logits"] = rel(lc, le)
        cmp["prefill caches"] = max(rel(a, b) for a, b in zip(kv(cc), kv(ce)))
        same &= torch.equal(lc, le) and all(map(torch.equal, kv(cc), kv(ce)))
        tok = torch.argmax(le, -1)[:, None]
        for i in range(3):
            le, ce = decode_e(sparams, ce, tok)
            lc, cc = decode_c(sparams, cc, tok)
            cmp[f"decode {i} logits"] = rel(lc, le)
            same &= torch.equal(lc, le)
            tok = torch.argmax(le, -1)[:, None]
        cmp["decode caches"] = max(rel(a, b) for a, b in zip(kv(cc), kv(ce)))
        same &= all(map(torch.equal, kv(cc), kv(ce)))
        if int(cc["pos"]) != int(ce["pos"]) or cc[graph.HOST_POS] != int(ce["pos"]):
            fail(f"compiled decode: position {int(cc['pos'])} (host "
                 f"{cc[graph.HOST_POS]}), eager {int(ce['pos'])}")
        # a cache other than the one the decode graph was captured on
        try:
            decode_c(sparams, ce, tok)
        except ValueError as err:
            print(f"compiled decode on a foreign cache raises: {err}")
        else:
            fail("compiled decode ran on a cache it was not captured on")
    for what, r in cmp.items():
        if r > FLASH_TOL["bfloat16"]:
            fail(f"compiled vs eager {what}: max abs err / max abs = {r}")
    print(f"compiled vs eager (Qwen2-1.5B, bf16, batch {SERVE_BATCH}): "
          + ", ".join(f"{k} {v:.3g}" for k, v in cmp.items())
          + f" (max-abs-err/max-abs, limit {FLASH_TOL['bfloat16']}); bit for "
          f"bit: {same}")

    def profiled(fn, record_shapes=False):
        """Wall of one call under the profiler, the kernels' device busy
        time (a CPU op such as aten::mm also reports the device time of the
        kernels it launched, so summing every event would count those
        twice), the flash kernels' share, and the kernels by time."""
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     record_shapes=record_shapes) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = 1e3 * (time.perf_counter() - t0)
        busy, flash_busy, by_kernel = 0.0, 0.0, []
        for evt in prof.key_averages():
            if evt.device_type != torch.autograd.DeviceType.CUDA:
                continue
            dev_us = getattr(evt, "self_device_time_total", None)
            if dev_us is None:
                dev_us = getattr(evt, "self_cuda_time_total", 0.0)
            busy += dev_us / 1e3
            if "flash_kernel" in evt.key:
                flash_busy += dev_us / 1e3
            by_kernel.append((dev_us / 1e3, evt.count, evt.key[:70]))
        return wall, busy, flash_busy, sorted(by_kernel, reverse=True), prof

    def walls(fn, n):
        out = []
        for _ in range(n):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            out.append(1e3 * (time.perf_counter() - t0))
        return sorted(out)[n // 2]

    # one layer's K cache: a copy or pad of this size in the decode step
    # would be the per-layer cache copy the eager port used to make
    kv_numel = SERVE_BATCH * scfg.n_kv_heads * cap * scfg.hd
    serve_profile = {}
    with torch.inference_mode():
        for mode, pre, dec in (("eager", prefill_e, decode_e),
                               ("compiled", prefill_c, decode_c)):
            wall, busy, fl, top, _ = profiled(
                lambda: pre(sparams, {"tokens": b0["prompts"]}))
            prefill_wall = walls(lambda: pre(sparams, {"tokens": b0["prompts"]}), 5)
            logits, caches = pre(sparams, {"tokens": b0["prompts"]})
            tok = torch.argmax(logits, -1)[:, None]
            serve_profile[("prefill", mode)] = (wall, busy, fl, top, prefill_wall)
            d_wall, d_busy, d_fl, d_top, prof = profiled(
                lambda: dec(sparams, caches, tok), record_shapes=mode == "eager")
            if mode == "eager":
                copies = [e for e in prof.events()
                          if e.name in ("aten::copy_", "aten::constant_pad_nd")
                          and e.input_shapes and e.input_shapes[0]]
                sizes = [math.prod(e.input_shapes[0]) for e in copies]
                big = [(e.name, e.input_shapes[0]) for e, n in zip(copies, sizes)
                       if n >= kv_numel]
                print(f"decode step: {len(copies)} copy/pad ops, the largest "
                      f"{max(sizes, default=0)} elements; one layer's K cache "
                      f"is {kv_numel}")
                if big:
                    fail(f"decode step copies or pads cache-sized tensors: {big[:4]}")
            state = {"caches": caches}

            def step():
                lg, state["caches"] = dec(sparams, state["caches"], tok)
                return lg
            decode_wall = walls(step, 20)
            serve_profile[("decode", mode)] = (d_wall, d_busy, d_fl, d_top, decode_wall)
            del logits, caches, state
    # the card's least time for each step: decode reads every weight and
    # the valid keys and values once (bytes); prefill's projections and
    # head do 2 x params x tokens operations at the bf16 peak (attention's
    # 2-3 % of prefill's busy time aside)
    from repro_torch.models.transformer import count_params
    n_params = count_params(scfg)
    elem = sparams["embed"]["w"].element_size()
    kv_bytes = 2 * scfg.n_layers * kv_numel * elem * PROMPT // cap
    step_bounds = {
        "decode": 1e3 * (n_params * elem + kv_bytes) / HBM_BYTES_PER_S,
        "prefill": 1e3 * 2.0 * n_params * SERVE_BATCH * PROMPT / peak[torch.bfloat16]}
    print(f"step bounds (Qwen2-1.5B, {n_params} parameters, batch "
          f"{SERVE_BATCH}): decode {step_bounds['decode']:.3f} ms (bytes: "
          f"weights {n_params * elem / 1e9:.3f} GB and cache {kv_bytes / 1e9:.3f} "
          f"GB once), prefill {step_bounds['prefill']:.3f} ms (operations)")
    for (phase, mode), (wall, busy, fl, top, unprof) in serve_profile.items():
        print(f"profile ({phase}, {mode}, batch {SERVE_BATCH}): device busy "
              f"{busy:.3f} ms (kernel events), flash_attention kernels "
              f"{fl:.3f} ms ({fl / busy:.3f} of busy); wall {wall:.3f} ms "
              f"profiled, {unprof:.3f} ms unprofiled (median); idle share "
              f"{1 - busy / wall:.3f} profiled, {max(0.0, 1 - busy / unprof):.3f} "
              f"unprofiled; bound {step_bounds[phase]:.3f} ms, "
              f"{step_bounds[phase] / unprof:.3f} of the unprofiled wall")
        for ms, n, key in top[:8]:
            print(f"  {phase} {mode} device time {ms:.3f} ms in {n} calls: {key}")

    # the same serve run with the steps left eager (each call runs the step
    # body op by op), uncounted: the yardstick of the compiled serve above
    with mock.patch.object(graph, "compile_prefill", lambda step: step), \
            mock.patch.object(graph, "compile_decode", lambda step: step):
        eager_report = serve.main(
            ["--arch", SERVE_ARCH, "--requests", str(REQUESTS), "--batch",
             str(SERVE_BATCH), "--prompt-len", str(PROMPT), "--gen-len",
             str(GEN), "--device", "cuda"])
    print(f"serve report, eager steps: {json.dumps(eager_report)}")
    print(f"serve report, compiled steps: {json.dumps(report)}")
    del prefill_c, decode_c, cc, ce, lc, le

    # 4b''. one decode step of every ported dense arch at smoke size (bf16;
    #       StableLM at its own head dim 160, which the flash wrapper pads
    #       to 256), captured and replayed: against the eager step, and
    #       counted, one split_kv pass and one combine a layer
    from repro_torch.configs import get_smoke
    from repro_torch.models.transformer import init_lm
    for arch in ("qwen2-1.5b", "gemma-2b", "granite-8b", "stablelm-12b"):
        acfg = get_smoke(arch)
        if arch == "stablelm-12b":
            acfg = dataclasses.replace(acfg, head_dim=get_config(arch).hd)
        aparams = init_lm(acfg, seed=1, device=dev)
        aprompt = torch.randint(0, acfg.vocab, (2, 16), generator=gen).to(dev)
        with torch.inference_mode():
            le, ce = model_steps.make_prefill_step(acfg, 24)(
                aparams, {"tokens": aprompt})
            lc, cc = graph.compile_prefill(model_steps.make_prefill_step(acfg, 24))(
                aparams, {"tokens": aprompt})
            pre_err = rel(lc, le)
            tok = torch.argmax(le, -1)[:, None]
            le, ce = model_steps.make_decode_step(acfg)(aparams, ce, tok)
            decode_a = graph.compile_decode(model_steps.make_decode_step(acfg))
            launch.reset_launches()
            lc, cc = decode_a(aparams, cc, tok)
            torch.cuda.synchronize()
            a_counts = dict(launch.LAUNCHES)
            dec_err = rel(lc, le)
        want = {"flash_attention": acfg.n_layers,
                "flash_attention/combine": acfg.n_layers}
        if a_counts != want:
            fail(f"{arch} smoke: one compiled decode step launched {a_counts}, "
                 f"expected {want}")
        if max(pre_err, dec_err) > FLASH_TOL["bfloat16"]:
            fail(f"{arch} smoke: compiled vs eager prefill {pre_err}, decode "
                 f"{dec_err} (max-abs-err/max-abs)")
        print(f"{arch} smoke (hd {acfg.hd}, {acfg.n_layers} layers): compiled vs "
              f"eager prefill {pre_err:.3g}, decode {dec_err:.3g}; one decode "
              f"replay launched {a_counts}")
        del aparams, le, ce, lc, cc, decode_a

    # 4c. the fp32 model, counted: Qwen2-1.5B at full width in float32 (the
    #     config's dtype field), one forward over batch 0's prompts. Every
    #     attention layer runs tc_3xtf32 and its pack pass; the logits are
    #     held against the same forward with `ref.attention_ref`.
    prompts = b0["prompts"]
    del record, sparams, b0
    fcfg = dataclasses.replace(scfg, dtype="float32")
    with torch.inference_mode():
        fparams = init_lm(fcfg, seed=0, device=dev)
        torch.cuda.synchronize()
        launch.reset_launches()
        t0 = time.perf_counter()
        f_logits = forward(fparams, fcfg, prompts)[0]
        torch.cuda.synchronize()
        f_wall = 1e3 * (time.perf_counter() - t0)
        fp32_counts = dict(launch.LAUNCHES)
        print(f"fp32 forward launches: {fp32_counts}")
        expect = {"flash_attention": fcfg.n_layers,
                  "flash_attention/pack": fcfg.n_layers}
        if fp32_counts != expect:
            fail(f"fp32 forward launched {fp32_counts}, expected {expect} (one "
                 f"tc_3xtf32 launch and one pack a layer)")
        with mock.patch.object(ops, "gqa_flash_attention", ref_attention):
            f_rel = serve_err(f_logits, forward(fparams, fcfg, prompts)[0],
                              "fp32 forward logits")
        del f_logits
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            forward(fparams, fcfg, prompts)
            torch.cuda.synchronize()
            wall = 1e3 * (time.perf_counter() - t0)
        busy, flash_busy, pack_busy = 0.0, 0.0, 0.0
        for evt in prof.key_averages():
            if evt.device_type != torch.autograd.DeviceType.CUDA:
                continue
            dev_us = getattr(evt, "self_device_time_total", None)
            if dev_us is None:
                dev_us = getattr(evt, "self_cuda_time_total", 0.0)
            busy += dev_us / 1e3
            if "flash_kernel" in evt.key:
                flash_busy += dev_us / 1e3
            elif "::pack" in evt.key:
                pack_busy += dev_us / 1e3
        del fparams
    print(f"fp32 forward (Qwen2-1.5B, {fcfg.n_layers} layers, batch "
          f"{SERVE_BATCH} x {PROMPT}): logits vs attention_ref {f_rel:.3g} "
          f"(max-abs-err/max-abs, limit {SERVE_REL_TOL}); wall {f_wall:.3f} ms "
          f"unprofiled; device busy {busy:.3f} ms (kernel events), "
          f"flash_attention kernels {flash_busy:.3f} ms ({flash_busy / busy:.3f} "
          f"of busy) and their pack passes {pack_busy:.3f} ms "
          f"({pack_busy / busy:.3f}); wall {wall:.3f} ms profiled; idle share "
          f"{1 - busy / wall:.3f}")

    # 4d. the paper's strategies on the card: Table I's schedules through
    #     conv2d_psum, a transformer's first-order GEMM plans through
    #     psum_matmul (counted per walk and per GEMM inside)
    t0 = time.perf_counter()
    strategy_launches = paper_strategies(torch, dev, graph_ms, bound)
    print(f"paper strategies phase: {time.perf_counter() - t0:.1f} s, launches "
          f"{strategy_launches}")

    # 4e. the fused-residency network planner, and its NetPlan on the card
    t0 = time.perf_counter()
    netplan_launches = netplan_on_card(torch, dev, graph_ms, smi)
    print(f"netplan phase: {time.perf_counter() - t0:.1f} s, launches "
          f"{netplan_launches}")

    # 4f. the verifier, the certificates and the active memory controller's
    #     meter, its ResNet-18 walk held against conv2d_psum's
    t0 = time.perf_counter()
    amc_launches = amc_on_card(torch, dev, smi)
    print(f"amc phase: {time.perf_counter() - t0:.1f} s, launches "
          f"{amc_launches}")

    # 5. result lines
    sources = {"psum_matmul/active": ("psum_matmul", "src/repro/kernels/psum_matmul.py:48"),
               "psum_matmul/passive": ("psum_matmul", "src/repro/kernels/psum_matmul.py:66"),
               "conv2d_psum": ("conv2d_psum", "src/repro/kernels/conv2d_psum.py:31")}
    kernels = []
    for name, (src, replaces) in sources.items():
        by_dtype = rows[name]
        first = by_dtype["float32"]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{src}.cu",
            "replaces": replaces, "launches": counts[name],
            "max_abs_err": first["max_abs_err"], "ms": first["ms"],
            "plain_ms": first["plain_ms"], "bound_ms": first["bound_ms"],
            "bound_by": first["bound_by"], "library_ms": first["library_ms"],
            **{k: first[k] for k in ("spill_bound_ms", "spill_bound_by")
               if k in first},
            "pack_launches": counts[f"{name.split('/')[0]}/pack"],
            # phase 4d's launches: Table I's schedules (conv) and the
            # transformer's GEMMs (bf16, first-order plans)
            "strategy_launches": strategy_launches[name],
            **({"strategy_pack_launches": strategy_launches[f"{name}/pack"]}
               if f"{name}/pack" in strategy_launches else {}),
            # phase 4e's launches: the NetPlan's ResNet-18 walks (conv)
            **({"netplan_launches": netplan_launches[name],
                "netplan_pack_launches": netplan_launches[f"{name}/pack"]}
               if name in netplan_launches else {}),
            # phase 4f's launches: the meter's plans walked on the kernels
            **({"amc_launches": amc_launches[name],
                "amc_pack_launches": amc_launches[f"{name}/pack"]}
               if name in amc_launches else {}),
            "dtype": "float32",
            "body_by_dtype": {d: v["body"] for d, v in by_dtype.items()},
            "by_dtype": by_dtype})
    fl = rows["flash_attention"]
    head = fl["prefill"]["bfloat16"]            # the serving path's dtype
    kernels.append({
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:26",
        "launches": serve_counts["flash_attention"],
        "combine_launches": serve_counts["flash_attention/combine"],
        "max_abs_err": head["max_abs_err"], "ms": head["ms"],
        "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"],
        "bound_by": head["bound_by"], "library_ms": head["library_ms"],
        "dtype": "bfloat16", "case": "prefill", "by_case": fl})
    tf = fl["prefill"]["float32"]               # the fp32 model's body
    kernels.append({
        "name": "flash_attention/tc_3xtf32", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:26",
        "launches": fp32_counts["flash_attention"],
        "pack_launches": fp32_counts["flash_attention/pack"],
        **{key: tf[key] for key in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                    "bound_by", "library_ms", "fp32_bound_ms",
                                    "pack_ms", "eager_ms")},
        "dtype": "float32", "case": "prefill", "body": tf["body"]})
    dd = fl["decode_device"]["bfloat16"]        # the compiled decode's call
    kernels.append({
        "name": "flash_attention/split_kv", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:26",
        # every decode layer-step launches pass 1 once and the combine once
        "launches": serve_counts["flash_attention/combine"],
        "combine_launches": serve_counts["flash_attention/combine"],
        **{key: dd[key] for key in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                    "bound_by", "library_ms", "eager_ms")},
        "dtype": "bfloat16", "case": "decode, device position",
        "body": dd["body"]})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
