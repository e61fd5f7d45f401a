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
   g. observability: the port's tracer (``repro_torch.obs``) over the card's
      paths. Phase 4's image walls (tracer off), then 21 walks without and 21
      with a tracer, in turns (the enabled overhead a span). Under one
      tracer: one walk of (a)'s graph, (a)'s GEMM under both controllers in
      both dtypes, and one eager prefill and two eager decode steps of
      (b)'s model; every ``launch.run`` call must give one ``kernel.launch``
      span, the spans' ``launches`` must sum per kernel to the window's
      launch counts, and the walk must give one ``kernel.preflight`` span
      with no diagnostics. One replay of the compiled decode step must give
      no ``kernel.launch`` span and add its capture's counts. The spans go
      to ``build/obs_trace.json`` (Perfetto), read back and checked;
      the host time inside the walk's launch spans is printed beside its
      wall. Last, the planner service (``launch.planserve``) at smoke size
      on the card's host, with no word mismatch.
   h. the mixture of experts: ``launch.serve`` serves Qwen1.5-MoE-A2.7B at
      its published widths (24 layers, d_model 2048, 16 heads, 60 routed
      experts top-4 of ff 1408 and a gated shared expert of 5632, bf16,
      seeded weights, capacity dispatch) as (b) serves Qwen2-1.5B: 8
      requests in batches of 4, prompt 1024, 32 new tokens, each step a
      graph replay (24 ``flash_attention`` a prefill, 24 split_kv and 24
      combines a decode step), every step of batch 0 equal to the eager
      step bodies bit for bit; the steps' device busy time and the MoE's
      share (routing, dispatch, expert products, combine, shared expert),
      peak memory and the steps' bounds. Then the reference's cache-plumbing
      check at full width on the first 4 layers (fp32, ragged dispatch,
      eager: tc_3xtf32 prefill and split_kv decode steps against one full
      forward, 1e-3), one full-width MoE block of 1024 tokens in fp32 on
      the card against the same function on the CPU (routes equal but at
      near-ties, which are counted; aux 1e-5, outputs 1e-3) and in bf16,
      timed, and the flash kernel at the MoE's attention beside SDPA.
   i. multi-head latent attention: ``launch.serve`` serves DeepSeek-V2-Lite
      at its published widths (27 layers: one dense of ff 10944 and 26 MoE
      of 64 routed experts top-6 and 2 shared; MLA with kv_lora 512, 16
      heads, q/k 192 and v 128 in prefill; bf16, seeded weights, capacity
      dispatch) as (h) serves its model, each step a graph replay (the
      replays counted): 27 ``flash_attention`` a prefill (the expanded
      form; v padded to 192, the kernel at its built dim 256) and none in
      decode (the absorbed form: ``chunked_attention``, the reference's
      plain path, over the latent cache), every step of batch 0 equal to
      the eager steps bit for bit; device busy, wall and idle share, the
      MLA's and the MoE's parts, peak memory and the decode's bounds with
      all experts and with the routed ones only. Then the cache plumbing
      on the dense layer and one MoE layer (fp32, ragged, eager: an
      expanded cuda_core prefill and absorbed decode steps against one
      expanded forward, 1e-3), one full-width MLA block (prefill of 1024,
      8 absorbed decode steps, fp32) on the card against the CPU (1e-3)
      and in bf16, timed, and the flash kernel at MLA's prefill shapes
      beside its plain version and SDPA.
   j. the Mamba-2 SSM stack: ``launch.serve`` serves Mamba2-1.3B at its
      published widths and depth (48 mamba layers, d_model 2048, 64 heads of
      64, d_state 128, chunk 256, no FFN, tied embedding) and Jamba-v0.1 at
      its published widths **reduced to 2 of its 4 periods** (16 layers: 2
      attention of 32/8 heads, 14 mamba of 128 heads, d_state 16; 8 MoE of
      16 experts top-2 and 8 dense FFNs of 14336; 52.0 of 102.9 GB), bf16,
      seeded weights, as (h) serves its model: each step a graph replay
      (the replays counted), every step of batch 0 equal to the eager steps
      bit for bit. Mamba2 launches no repo kernel (the SSD is plain
      PyTorch, as the reference's is plain XLA); Jamba launches 2
      ``flash_attention`` a prefill and 2 split_kv passes and 2 combines a
      decode step. Device busy, wall and idle share of a fresh compiled
      prefill and decode; the SSD's parts from the eager steps; peak
      memory; the decode's bytes bound (Jamba's with every expert and with
      the routed ones) and the prefill's operations bound. Then the cache
      plumbing (fp32, eager: a prefill of 596 tokens over three chunks, the
      last padded, and 4 recurrent steps against one forward, 1e-3) on
      Mamba2's first 4 layers and Jamba's first 5 sublayers (through its
      attention, MoE ragged), one full-width mamba block of each (prefill
      1024 + 8 recurrent steps, fp32) on the card against the CPU (1e-4)
      and in bf16, timed, and the flash kernel at Jamba's attention beside
      its plain version and SDPA.
   k. cross-attention, the encoder and the modality inputs: ``launch.serve``
      serves SeamlessM4T at its published widths and depth (24 encoder
      layers over 1024 stubbed frames of 1024, 24 "attn+cross" decoder
      layers, d_model 1024, 16/16 heads of 64, layernorm, ReLU FFN 8192,
      vocab 256206) and Llama-3.2-Vision at its published widths **reduced
      to 5 of its 20 periods** (25 layers: 20 self-attention, 5
      cross-attention over 1664 stubbed vision tokens of 8192; 64/8 heads of
      128, FFN 28672; 47.0 of 175.3 GB), bf16, seeded weights with every
      cross-attention gate set nonzero (the reference's init, 0, would hide
      cross-attention), as (h) serves its model: each step a graph replay
      (counted), every step of batch 0 equal to the eager steps bit for
      bit; a prefill launches the flash kernel once an encoder, self- and
      cross-attention layer (72 and 25), a decode step split_kv and its
      combine once a self- and cross-attention layer (48 and 25). A fresh
      compiled prefill serves batch 0's prompts with other frames or vision
      tokens: its logits differ from the served ones and equal the eager
      step's, as do decode steps on the new cross caches. Device busy, wall,
      idle share and top kernels of the compiled steps; the encoder's,
      cross-attention's and flash's device ms from the eager steps; peak
      memory; the decode's bytes bound and the prefill's operations bound.
      Then the first layers in fp32 at full width (seamless: one encoder
      layer over 1000 frames, a ragged length, and one decoder layer;
      Llama: its first period), a prefill of 128 tokens and 2 decode steps
      through the caches, on the card against the CPU (1e-3), and the flash
      kernel at the encoder's prefill, cross-attention's prefill and decode
      (split_kv, as served, and the one-pass body) and a ragged non-causal
      1000 x 1000 beside its plain version and SDPA.
   l. training on one card: (a) the attention Function
      (`layers.FlashAttention`: the flash kernel forward, `chunked_attention`
      recomputed as the backward) at Qwen2-1.5B's attention (B 2, 12/2
      heads of 128, 1024 tokens, causal), a ragged non-causal 1000 x 1000
      and MLA's q/k 192, v 128, bf16: one ``flash_attention`` launch
      forward and none backward, the forward within phase 4k's flash limits
      of `chunked_attention`'s, dq, dk, dv equal to autograd through
      `chunked_attention` bit for bit, both timed. (b)
      ``repro_torch.launch.train`` trains Qwen2-1.5B at its published
      widths and depth (28 layers, bf16, tied embedding, 1,543,910,912
      parameters) for 4 steps of 8 x 1024 tokens, 4 microbatches of 2 x
      1024 whose gradients are summed in fp32, AdamW with fp32 master
      weights in place: 112 ``flash_attention`` launches a step, losses
      finite, near ln(vocab) at first and falling; the final blocking
      checkpoint (21.6 GB) into a temporary directory under ``build/``,
      deleted afterwards; peak memory, tokens/s, one step profiled (device
      busy, top kernels, the attention backward, AdamW) and the step's
      bound. (c) One layer at full width in fp32: loss and every gradient
      leaf, the card against the CPU (1e-3). (d) qwen2-1.5b, qwen2-moe,
      deepseek-v2-lite, mamba2 and seamless-m4t at smoke size trained 8
      steps each on the card (losses falling, flash launches counted), the
      first resumed from its checkpoint.
   m. the SoC simulator (``repro_torch.sim``) and the objectives that rest
      on it: on the host, ``NetPlan.simulate`` on the eight zoo CNNs'
      exact_opt NetPlans under both controllers (words equal to
      ``NetPlan.traffic``), ``plan_graph(..., objective="sim_latency")`` on
      the eight, timed, and at ``residency_bytes=0`` the per-layer
      ``plan(strategy="sim_latency")`` schedules; on the card,
      ``simulate_batch`` over ResNet-18's widest conv layer's exact grid
      (both controllers, all spilled and 64 beam states, both residency
      variants) in torch float64 against numpy on the host (integer-valued
      columns ==, the others within 1e-12), both timed; then ResNet-18 at
      ``shrink(56, 1)`` walked in fp32 through ``run_network_kernels`` under
      the sim_latency and sim_energy strategies' ``plan_many`` schedules and
      the sim_latency NetPlan (3 walks each, 20 conv2d_psum and 20 pack
      launches a walk, every tensor within 1e-3 of the reference walk),
      beside exact_opt's, each replayed as a CUDA graph and printed beside
      the simulator's latency for the same schedules (the modelled SoC at
      1 GHz, not card time), the strategies' order by both; last, the
      roofline_latency objective at the port's H100 constants beside each
      layer's measured conv2d_psum time.
   n. the fault harness (``repro_torch.faults``): the fault schedules of
      seeds 0-7 (``generate_schedule``) degrade the exact_opt/active NetPlan
      of ResNet-18 at ``shrink(56, 1)`` (``apply_to_plan``: a halved or
      quartered MAC budget, a shrunk residency, a passive re-plan); each
      distinct degraded NetPlan is walked in fp32 through
      ``run_network_kernels`` (20 conv2d_psum and 20 pack launches a walk,
      every tensor within 1e-3 of the cuDNN walk), replayed as a CUDA
      graph, beside its words and the simulator's latency; then
      ``run_chaos(8, smoke=True)`` on the host must hold every invariant.
   o. the tensor-parallel partial-sum combines (``repro_torch.sharding``):
      Qwen1.5-MoE-A2.7B at its published widths and depth (24 layers, bf16,
      seeded weights) served eagerly to 4 prompts of 1024 for 8 tokens, on
      a (1, 2) mesh whose two ranks are two processes on this card talking
      through gloo, each holding half the routed experts' ff: the experts'
      partial sums combined actively (all-reduce) and passively (all-gather
      and a local add), with flash decoding off and on (each rank attends
      over its half of the cache, split_kv's pass 1 with its partials
      handed back, the blocks combined across the ranks). A one-process
      baseline runs first in a process of its own, unsplit and with each
      MoE layer's experts split in two halves as the ranks split them:
      both ranks' logits equal, without flash decoding bit for bit the
      split, with it the split's prefill bit for bit and its decode within
      5e-2 where the MoE routes agree; against the unsplit baseline within
      5e-2 where the routes agree, route flips counted; the bytes of each
      collective per decode step, decode ms and the collectives' share;
      then two fp32 layers, active against passive and one process within
      2e-4.
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

import contextlib
import dataclasses
import functools
import json
import math
import os
import pathlib
import re
import statistics
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


# 4g: observability on the card
OBS_WALKS = 21                      # untraced and traced walks, in turns
OBS_TRACE = ROOT / "build" / "obs_trace.json"    # git-ignored


def obs_on_card(torch, dev, card: str, walk, gemm, lm: dict,
                image_ms: list) -> dict[str, int]:
    """Phase 4g. The port's tracer (`repro_torch.obs`) over the card's paths.
    (a) Tracer off: phase 4's image walls, and ``OBS_WALKS`` walks without
    and with a tracer, in turns. (b) Tracer on, eager: one ResNet-18 walk
    (``walk``), the GEMM under both controllers in both dtypes (``gemm``),
    and one eager prefill and two eager decode steps of the served model
    (``lm``); every `launch.run` call must give one ``kernel.launch`` span,
    the spans' ``launches`` must sum per kernel to the `launch.LAUNCHES`
    counts of the window, and the walk must give one ``kernel.preflight``
    span with no diagnostics. (c) One replay of the compiled decode step
    under the tracer: no ``kernel.launch`` span, and `launch.LAUNCHES` grows
    by the capture's recorded counts. (d) (b)'s spans exported as a
    Perfetto trace to ``build/obs_trace.json`` and read back; the
    host time inside the walk's launch spans against its wall. (e) The
    planner service on the card's host: `planserve.run_load` and
    `planserve.run_speedup` at smoke size, no word mismatch. Returns the
    launches of (b)."""
    import collections
    from unittest import mock

    from repro_torch import obs
    from repro_torch.kernels import launch
    from repro_torch.launch import planserve

    def timed(fn) -> float:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return 1e3 * (time.perf_counter() - t0)

    def median(xs):
        return sorted(xs)[len(xs) // 2]

    # (a) the tracer off, and off and on in turns
    off, on, spans_a_walk = [], [], set()
    for _ in range(OBS_WALKS):
        off.append(timed(walk))
        with obs.tracing() as tr:
            on.append(timed(walk))
        spans_a_walk.add(len(tr))
    if obs.enabled() or len(spans_a_walk) != 1:
        fail(f"obs (a): tracer left on, or walks gave {spans_a_walk} spans")
    n_spans = spans_a_walk.pop()
    print(f"obs (a) tracer off: phase 4's image walls {image_ms} ms, median "
          f"{median(image_ms):.3f} ms ({card})")
    print(f"obs (a) in turns: untraced walks {[round(x, 3) for x in off]} ms "
          f"(median {median(off):.3f}), traced {[round(x, 3) for x in on]} ms "
          f"(median {median(on):.3f}, {n_spans} spans a walk): "
          f"{1e3 * (median(on) - median(off)) / n_spans:.2f} us a span, "
          f"{100 * (median(on) / median(off) - 1):.2f} % of a walk ({card})")

    # (b) the tracer on, eager: every run call counted beside its span
    params, prompts = lm["params"], lm["prompts"]

    def lm_steps():
        with torch.inference_mode():
            logits, caches = lm["prefill"](params, {"tokens": prompts})
            for _ in range(2):
                tok = torch.argmax(logits, -1)[:, None]
                logits, caches = lm["decode"](params, caches, tok)

    runs = []
    real_run = launch.run

    def counted_run(plan, *operands, **extra):
        runs.append(plan.name)
        return real_run(plan, *operands, **extra)

    torch.cuda.synchronize()
    launch.reset_launches()
    walls = {}
    with mock.patch.object(launch, "run", counted_run), \
            obs.tracing() as tr:
        for what, fn in (("walk", walk), ("gemm", gemm), ("lm", lm_steps)):
            n0 = len(tr)
            walls[what] = (timed(fn), len(tr) - n0)
    counts = dict(launch.LAUNCHES)
    spans = [s for s in tr.spans if s.name == "kernel.launch"]
    attrs = [dict(s.attrs) for s in spans]
    if len(spans) != len(runs) or collections.Counter(
            a["plan"] for a in attrs) != collections.Counter(runs):
        fail(f"obs (b): {len(runs)} launch.run calls gave {len(spans)} "
             f"kernel.launch spans")
    if {a["device"] for a in attrs} != {dev.type} or any("error" in a
                                                        for a in attrs):
        fail(f"obs (b): launch spans on {sorted({a['device'] for a in attrs})}"
             f" or with errors")
    by_span, by_count = collections.Counter(), collections.Counter()
    for a in attrs:
        by_span[a["plan"].split("/")[0]] += a["launches"]
    for name, n in counts.items():
        by_count[name.split("/")[0]] += n
    kernels = {"conv2d_psum", "psum_matmul", "flash_attention"}
    if by_span != by_count or set(by_count) != kernels:
        fail(f"obs (b): the spans' launches {dict(by_span)} against "
             f"LAUNCHES {counts}")
    pre = [dict(s.attrs) for s in tr.spans if s.name == "kernel.preflight"]
    if len(pre) != 1 or pre[0]["diagnostics"] != 0:
        fail(f"obs (b): kernel.preflight spans {pre}")
    print(f"obs (b) tracer on: {len(runs)} launch.run calls, {len(spans)} "
          f"kernel.launch spans; launches by span {dict(by_span)} == "
          f"LAUNCHES {counts}; kernel.preflight {pre[0]}; walls "
          + ", ".join(f"{k} {ms:.3f} ms ({n} spans)"
                      for k, (ms, n) in walls.items()) + f" ({card})")

    # (c) a compiled replay records no span and adds its recorded counts
    with torch.inference_mode():
        logits, caches = lm["prefill_c"](params, {"tokens": prompts})
        tok = torch.argmax(logits, -1)[:, None]
        recorded = lm["decode_c"].graphs[(tuple(tok.shape), tok.dtype)][
            "graph"].launches
        torch.cuda.synchronize()
        before = dict(launch.LAUNCHES)
        with obs.tracing() as tr_c:
            lm["decode_c"](params, caches, tok)
            torch.cuda.synchronize()
    added = {k: n - before.get(k, 0) for k, n in launch.LAUNCHES.items()
             if n != before.get(k, 0)}
    replay_spans = [s.name for s in tr_c.spans if s.name == "kernel.launch"]
    if replay_spans or added != recorded:
        fail(f"obs (c): a replay gave {len(replay_spans)} kernel.launch spans "
             f"and added {added}, recorded {recorded}")
    print(f"obs (c) compiled decode replay: 0 kernel.launch spans, LAUNCHES "
          f"grew by the recorded {recorded}")
    del logits, caches

    # (d) the Perfetto export, read back
    events = obs.spans_to_trace(tr, process_name="chip_smoke 4g")
    OBS_TRACE.parent.mkdir(parents=True, exist_ok=True)
    with open(OBS_TRACE, "w") as fp:
        obs.write_trace(events, fp)
    back = json.loads(OBS_TRACE.read_text())["traceEvents"]
    bad = [e for e in back if e["ph"] not in ("X", "M") or (
        e["ph"] == "X" and (e["ts"] < 0 or e["dur"] < 0))]
    if bad or len(back) != len(events) or sum(
            e["ph"] == "X" for e in back) != len(tr):
        fail(f"obs (d): {len(back)} events read back, {len(bad)} invalid, "
             f"e.g. {bad[:2]}")
    conv = [s for s, a in zip(spans, attrs) if a["plan"] == "conv2d_psum"]
    host_ms = 1e3 * sum(s.dur_s for s in conv)
    walk_ms = walls["walk"][0]
    print(f"obs (d) export: {len(events)} events ({len(tr)} spans) to "
          f"{OBS_TRACE.relative_to(ROOT)}; walk: host {host_ms:.3f} ms inside "
          f"{len(conv)} conv kernel.launch spans of a {walk_ms:.3f} ms wall, "
          f"{host_ms / len(conv):.4f} ms a conv call; traced walk "
          f"{walk_ms:.3f} ms against phase 4's median "
          f"{median(image_ms):.3f} ms ({card})")
    # the walk's host timeline: the pre-flight, the runner before the first
    # launch, inside the launches, and between them
    (pre_span,) = [s for s in tr.spans if s.name == "kernel.preflight"]
    conv.sort(key=lambda s: s.t0_s)
    ends = [s.t0_s + s.dur_s for s in conv]
    before = conv[0].t0_s - (pre_span.t0_s + pre_span.dur_s)
    between = sum(b.t0_s - e for e, b in zip(ends, conv[1:]))
    print(f"obs (d) walk host timeline: pre-flight {1e3 * pre_span.dur_s:.3f} "
          f"ms, runner before the first launch {1e3 * before:.3f} ms, inside "
          f"the launches {host_ms:.3f} ms (first {1e3 * conv[0].dur_s:.3f}, "
          f"median {1e3 * median([s.dur_s for s in conv]):.4f}), between them "
          f"{1e3 * between:.3f} ms ({1e3 * between / (len(conv) - 1):.4f} ms a "
          f"gap); first span to last end {1e3 * (ends[-1] - pre_span.t0_s):.3f}"
          f" ms of the {walk_ms:.3f} ms wall ({card})")
    for plan_name in ("psum_matmul/active", "psum_matmul/passive",
                      "flash_attention"):
        durs = {}
        for s, a in zip(spans, attrs):
            if a["plan"] == plan_name:
                durs.setdefault(a["body"], []).append(1e3 * s.dur_s)
        print(f"obs (d) host ms inside kernel.launch, {plan_name}: "
              + ", ".join(f"{body} {len(d)} calls, median {median(d):.4f}, "
                          f"max {max(d):.4f}" for body, d in durs.items())
              + f" ({card})")

    # (e) the planner service on the card's host
    load = planserve.run_load(smoke=True)
    speed = planserve.run_speedup(passes=1, smoke=True)
    if speed["word_mismatches"] != 0:
        fail(f"obs (e): planserve word_mismatches {speed['word_mismatches']}")
    print(f"obs (e) planserve (host, smoke catalog of {load['catalog_size']}):"
          f" {load['requests']} requests in {load['batches']} batches, "
          f"{load['plans_per_s']:.1f} plans/s, p50 {load['p50_ms']:.3f} ms, "
          f"p99 {load['p99_ms']:.3f} ms (histogram {load['p50_ms_hist']:.3f} /"
          f" {load['p99_ms_hist']:.3f}); batched "
          f"{speed['batched_vs_sequential']:.2f}x sequential, "
          f"word_mismatches 0, fleet "
          f"{speed['fleet_total_mwords']:.6f} M words; REGISTRY "
          f"{len(obs.REGISTRY.families())} families")
    return counts


# shared by phases 4h and 4i
def card_sync(torch, dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def device_ms(evt, total: bool = False) -> float:
    """A profiler event's device ms (its own, or with its children's)."""
    name = "device_time_total" if total else "self_device_time_total"
    us = getattr(evt, name, None)
    if us is None:
        us = getattr(evt, name.replace("device", "cuda"), 0.0)
    return us / 1e3


def profiled_parts(torch, dev, fn, prefixes: tuple, top: int = 0) -> dict:
    """Device busy ms of one call of ``fn`` (kernel events: a profiler
    range is not a kernel) and the device ms of each range whose name
    starts with one of ``prefixes``; with ``top``, also the ``top``
    kernels by device ms as (ms, calls, name) under "top"."""
    from torch.profiler import ProfilerActivity, profile

    card_sync(torch, dev)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        card_sync(torch, dev)
    out = {"busy": 0.0}
    kernels = []
    for evt in prof.key_averages():
        if evt.key.startswith(prefixes):
            if evt.device_type != torch.autograd.DeviceType.CUDA:
                out[evt.key] = device_ms(evt, total=True)
        elif evt.device_type == torch.autograd.DeviceType.CUDA:
            out["busy"] += device_ms(evt)
            kernels.append((device_ms(evt), evt.count, kernel_name(evt.key)))
    if top:
        out["top"] = sorted(kernels, reverse=True)[:top]
    return out


def scoped_parts(torch, module, parts: dict) -> list:
    """Patches (not started) that put each function of ``module`` named in
    ``parts`` in a profiler range of the label given there."""
    from unittest import mock

    patches = []
    for fn_name, label in parts.items():
        def run(*args, _fn=getattr(module, fn_name), _label=label, **kwargs):
            with torch.profiler.record_function(_label):
                return _fn(*args, **kwargs)
        patches.append(mock.patch.object(module, fn_name, run))
    return patches


def recording_routes(moe, where: list, shape_of=None):
    """A patch of `moe.route` as it stands (in its profiler range, where one
    is patched in) that keeps each call's expert ids in ``where``."""
    from unittest import mock

    current = moe.route

    def run(*args, **kwargs):
        out = current(*args, **kwargs)
        where.append(out[1] if shape_of is None else out[1].view(*shape_of, -1))
        return out
    return mock.patch.object(moe, "route", run)


def tree_map(fn, tree, key=""):
    """``fn(leaf, key)`` over nested dicts and lists, key "router" under a
    router."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, k if k == "router" else key)
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_map(fn, v, key) for v in tree]
    return fn(tree, key)


def rel_err(torch, got, want, what: str) -> float:
    """max |got - want| / max |want|; fails on another shape or a
    non-finite value."""
    got, want = got.float(), want.float()
    if got.shape != want.shape or not torch.isfinite(got).all():
        fail(f"{what}: shape {tuple(got.shape)} vs {tuple(want.shape)} or "
             f"non-finite values")
    return ((got - want).abs().max() / want.abs().max()).item()


def served_equal_eager(torch, cfg, params, b0: dict, cap_len: int, what: str,
                       extras: dict | None = None):
    """Every step of batch 0 as `launch.serve` recorded it (graph replays)
    against the eager step bodies teacher-forced with the served tokens
    (and the batch's ``extras``, a vlm's vision tokens or an enc-dec arch's
    frames), bit for bit; fails otherwise. Returns the eager (prefill,
    decode)."""
    from repro_torch.models import steps as model_steps

    gen_len = b0["tokens"].shape[1]
    prefill_e = model_steps.make_prefill_step(cfg, cap_len)
    decode_e = model_steps.make_decode_step(cfg)
    with torch.inference_mode():
        logits, caches = prefill_e(params, {"tokens": b0["prompts"],
                                            **(extras or {})})
        eager = [logits]
        for i in range(gen_len - 1):
            logits, caches = decode_e(params, caches, b0["tokens"][:, i:i + 1])
            eager.append(logits)
        eager = torch.stack(eager, 1)
        differ = [i for i in range(gen_len)
                  if not torch.equal(b0["logits"][:, i], eager[:, i])]
        if differ:
            fail(f"{what} serve: steps {differ} of batch 0 differ from the "
                 f"eager steps (max-abs-err/max-abs "
                 f"{rel_err(torch, b0['logits'], eager, what):.3g})")
        if not torch.equal(torch.argmax(eager, -1), b0["tokens"]):
            fail(f"{what} serve: batch 0's tokens are not the eager steps' argmax")
    print(f"{what} serve: batch 0's {gen_len} steps (prefill and {gen_len - 1} "
          f"decodes, graph replays) equal the eager steps bit for bit")
    return prefill_e, decode_e


def median_wall_ms(torch, dev, fn, calls: int = 5) -> float:
    """The median host wall of ``calls`` calls, the card synchronised
    before and after each."""
    walls = []
    for _ in range(calls):
        card_sync(torch, dev)
        t0 = time.perf_counter()
        fn()
        card_sync(torch, dev)
        walls.append(1e3 * (time.perf_counter() - t0))
    return sorted(walls)[calls // 2]


# 4h: the mixture of experts, Qwen1.5-MoE-A2.7B at its published widths
MOE_ARCH = "qwen2-moe-a2.7b"
MOE_SMOKE = False                    # True only in a CPU rehearsal
MOE_SERVE = (8, 4, 1024, 32)         # requests, batch, prompt, new tokens
MOE_PLUMB = (4, 2, 128, 8)           # layers, batch, tokens, decode steps
MOE_BLOCK_T = 1024
MOE_TIE = 1e-5                       # k-th vs (k+1)-th probability
MOE_OUT_TOL, MOE_AUX_TOL, MOE_PLUMB_TOL = 1e-3, 1e-5, 1e-3
MOE_PARTS = {"route": "moe/route", "_capacity_ffn": "moe/ffn",
             "_dispatch": "moe/dispatch", "_expert_products": "moe/experts",
             "moe_apply": "moe/apply"}


def moe_on_card(torch, dev, card: str, graph_ms, time_ms, bound) -> dict:
    """Phase 4h. (a) `launch.serve` serves Qwen1.5-MoE-A2.7B at full width
    and depth in bf16 with capacity dispatch, each step a graph replay: the
    run's launch counts, and every step of batch 0 against the eager step
    bodies bit for bit; then a fresh compiled prefill and decode step,
    counted one call at a time (24 `flash_attention`; 24 split_kv and 24
    combines) and profiled: device busy, wall, and from the eager steps
    the MoE's routing, dispatch, expert products, combine and shared
    expert; peak memory and the steps' bounds. (b) The reference's
    cache-plumbing check at full width on the first ``MOE_PLUMB[0]``
    layers, fp32, ragged, eager: prefill on tc_3xtf32 and teacher-forced
    split_kv decode steps against one full forward. (c) One full-width MoE
    block of ``MOE_BLOCK_T`` tokens in fp32 on the card against the same
    function on the CPU (routes equal but at near-ties, which are counted;
    aux and outputs), then in bf16, timed. (d) The flash kernel at the
    MoE's attention, timed beside its plain version and SDPA. Returns the
    launch counts of (a)."""
    from repro_torch.configs import get_config, get_smoke
    from repro_torch.kernels import launch
    from repro_torch.launch import graph, serve
    from repro_torch.models import moe
    from repro_torch.models import steps as model_steps
    from repro_torch.models.transformer import (count_params, forward,
                                                init_caches, init_lm)

    cfg = (get_smoke if MOE_SMOKE else get_config)(MOE_ARCH)
    mc, n_layers = cfg.moe, cfg.n_layers
    requests, batch, prompt, gen_len = MOE_SERVE
    n_batches = -(-requests // batch)
    on_card = dev.type == "cuda"

    def sync():
        card_sync(torch, dev)

    def profiled(fn) -> dict:
        return profiled_parts(torch, dev, fn, ("moe/",))

    def scoped():
        return scoped_parts(torch, moe, MOE_PARTS)

    def recording(where: list, shape_of=None):
        return recording_routes(moe, where, shape_of)

    def rel(got, want) -> float:
        return rel_err(torch, got, want, "moe")

    # (a) serving, counted
    sync()
    base_gb = 0.0
    if on_card:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        base_gb = torch.cuda.memory_allocated(dev) / 1e9
    record: dict = {}
    launch.reset_launches()
    report = serve.main(["--arch", MOE_ARCH, *(["--smoke"] if MOE_SMOKE else []),
                         "--requests", str(requests), "--batch", str(batch),
                         "--prompt-len", str(prompt), "--gen-len", str(gen_len),
                         "--device", dev.type], record=record)
    sync()
    counts = dict(launch.LAUNCHES)
    expect = {"flash_attention": n_layers * gen_len * n_batches,
              "flash_attention/combine": n_layers * (gen_len - 1) * n_batches}
    if counts != expect:
        fail(f"moe serve launched {counts}, expected {expect} ({n_layers} "
             f"layers x {gen_len} steps x {n_batches} batches)")
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9 if on_card else 0.0
    params = record["params"]
    n_params = count_params(cfg)
    print(f"moe serve ({MOE_ARCH}, {n_layers} layers, d {cfg.d_model}, "
          f"{mc.n_routed} experts top-{mc.top_k}, {cfg.dtype}, {mc.impl}, "
          f"{n_params} parameters, {count_params(cfg, active_only=True)} "
          f"active): launches {counts}; report {json.dumps(report)}; peak "
          f"memory {peak_gb:.3f} GB ({base_gb:.3f} GB before the phase) ({card})")

    b0 = record["batches"][0]
    cap_len = prompt + gen_len
    prefill_e, decode_e = served_equal_eager(torch, cfg, params, b0, cap_len,
                                             "moe")

    # a fresh compiled prefill and decode, counted one call at a time, and
    # where each step's device time goes
    prefill_c = graph.compile_prefill(model_steps.make_prefill_step(cfg, cap_len))
    decode_c = graph.compile_decode(model_steps.make_decode_step(cfg))
    tok = b0["tokens"][:, :1]
    rows = {}
    with torch.inference_mode():
        launch.reset_launches()
        _, caches = prefill_c(params, {"tokens": b0["prompts"]})
        sync()
        got = dict(launch.LAUNCHES)
        if got != {"flash_attention": n_layers}:
            fail(f"moe compiled prefill launched {got}, expected "
                 f"{n_layers} flash_attention")
        step_counts = []
        for i in range(3):
            launch.reset_launches()
            _, caches = decode_c(params, caches, b0["tokens"][:, i:i + 1])
            sync()
            step_counts.append(dict(launch.LAUNCHES))
        want = {"flash_attention": n_layers, "flash_attention/combine": n_layers}
        if any(c != want for c in step_counts):
            fail(f"moe compiled decode steps launched {step_counts}, expected {want}")
        # the prefill's calls zero the static cache; the decode's then
        # advance it one token a call
        for name, fn in (("prefill", lambda: prefill_c(params, {"tokens": b0["prompts"]})),
                         ("decode", lambda: decode_c(params, caches, tok))):
            rows[(name, "compiled")] = profiled(fn)
            rows[(name, "compiled")]["wall"] = median_wall_ms(torch, dev, fn)
        # the eager steps, each MoE part in a profiler range; the experts
        # each decode layer routes to, for a grouped GEMM's bound
        routed: list = []
        eager_caches = {}
        patches = scoped()
        for patch in patches:
            patch.start()
        try:
            rows[("prefill", "eager")] = profiled(lambda: eager_caches.update(
                c=prefill_e(params, {"tokens": b0["prompts"]})[1]))
            with recording(routed):
                rows[("decode", "eager")] = profiled(
                    lambda: decode_e(params, eager_caches["c"], tok))
        finally:
            for patch in patches:
                patch.stop()
        touched = [int(torch.unique(idx).numel()) for idx in routed]
        del caches, eager_caches
    elem = params["lm_head"]["w"].element_size()
    kv_bytes = 2 * n_layers * batch * cfg.n_kv_heads * prompt * cfg.hd * elem
    unread = (cfg.padded_vocab - batch) * cfg.d_model * elem   # embedding rows
    expert_bytes = 3 * cfg.d_model * mc.expert_ff * elem
    weight_bytes = n_params * elem - unread
    grouped_bytes = weight_bytes - (n_layers * mc.n_routed - sum(touched)) * expert_bytes
    bounds = {
        "decode": 1e3 * (weight_bytes + kv_bytes) / HBM_BYTES_PER_S,
        "prefill": bound(2.0 * count_params(cfg, active_only=True) * batch * prompt,
                         n_params * elem, torch.bfloat16)[0]}
    grouped_ms = 1e3 * (grouped_bytes + kv_bytes) / HBM_BYTES_PER_S
    print(f"moe step bounds (batch {batch}): decode {bounds['decode']:.3f} ms "
          f"(bytes: {weight_bytes / 1e9:.3f} GB of weights, all "
          f"{mc.n_routed} experts of every layer, and {kv_bytes / 1e9:.3f} GB "
          f"of cache, once); a grouped GEMM reading only the routed experts "
          f"{grouped_ms:.3f} ms ({grouped_bytes / 1e9:.3f} GB of weights; "
          f"experts routed a layer {touched}); prefill {bounds['prefill']:.3f} "
          f"ms (operations, active parameters) ({card})")
    for (name, mode), row in rows.items():
        busy = max(row["busy"], 1e-9)
        parts = ""
        if mode == "eager":
            ffn, apply = row.get("moe/ffn", 0.0), row.get("moe/apply", 0.0)
            share = {"routing": row.get("moe/route", 0.0),
                     "dispatch": row.get("moe/dispatch", 0.0),
                     "expert products": row.get("moe/experts", 0.0),
                     "combine": ffn - row.get("moe/dispatch", 0.0)
                     - row.get("moe/experts", 0.0),
                     "shared expert": apply - ffn - row.get("moe/route", 0.0)}
            parts = (f"; MoE {apply:.3f} ms ({apply / busy:.3f} of busy): "
                     + ", ".join(f"{k} {v:.3f} ms ({v / busy:.3f})"
                                 for k, v in share.items()))
        wall = f", wall {row['wall']:.3f} ms (median of 5)" if "wall" in row else ""
        print(f"moe profile ({name}, {mode}, batch {batch}): device busy "
              f"{row['busy']:.3f} ms (kernel events){wall}{parts}; bound "
              f"{bounds[name]:.3f} ms ({card})")
    del prefill_c, decode_c, record, b0, params
    if on_card:
        torch.cuda.empty_cache()

    # (b) cache plumbing: the first layers at full width, fp32, ragged,
    #     eager; prefill + teacher-forced decode against one full forward
    p_layers, p_batch, p_len, p_steps = MOE_PLUMB
    pcfg = dataclasses.replace(cfg, n_periods=p_layers, dtype="float32",
                               moe=dataclasses.replace(mc, impl="ragged"))
    n_pre = p_len - p_steps
    gen = torch.Generator(device="cpu").manual_seed(7)
    toks = torch.randint(0, pcfg.vocab, (p_batch, p_len), generator=gen).to(dev)
    full_routes, step_routes = [], []
    with torch.inference_mode():
        pparams = init_lm(pcfg, seed=3, device=dev)

        def run(where, tokens, **kw):
            launch.reset_launches()
            with recording(where, tokens.shape):
                out = forward(pparams, pcfg, tokens, **kw)
            sync()
            return out, dict(launch.LAUNCHES)

        (full, _, _), full_counts = run(full_routes, toks)
        caches = init_caches(pcfg, p_batch, p_len, device=dev)
        (pre, caches, _), pre_counts = run(step_routes, toks[:, :n_pre],
                                           caches=caches, start=0)
        errs = [rel(pre[:, -1], full[:, n_pre - 1])]
        step_counts = []
        for i in range(n_pre, p_len):
            (lg, caches, _), c = run(step_routes, toks[:, i:i + 1], caches=caches)
            step_counts.append(c)
            errs.append(rel(lg[:, 0], full[:, i]))
        one_pass = {"flash_attention": p_layers, "flash_attention/pack": p_layers}
        if full_counts != one_pass or pre_counts != one_pass:
            fail(f"moe plumbing: forward launched {full_counts}, prefill "
                 f"{pre_counts}, expected {one_pass} (tc_3xtf32 and its pack)")
        split = {"flash_attention": p_layers, "flash_attention/combine": p_layers}
        if any(c != split for c in step_counts):
            fail(f"moe plumbing: decode steps launched {step_counts}, expected {split}")
        # the routes of each layer, prefill and steps side by side
        steps_idx = [torch.cat(step_routes[layer::p_layers], 1)
                     for layer in range(p_layers)]
        moved = sum(int((a.sort(-1).values != b.sort(-1).values).any(-1).sum())
                    for a, b in zip(full_routes, steps_idx))
        if max(errs) > MOE_PLUMB_TOL:
            fail(f"moe plumbing: prefill + decode vs full forward max-abs-err/"
                 f"max-abs {max(errs)} (limit {MOE_PLUMB_TOL}); {moved} token "
                 f"routes differ")
        print(f"moe plumbing ({p_layers} layers, full width, fp32, ragged, "
              f"batch {p_batch}, prefill {n_pre} + {p_steps} decode steps): "
              f"vs one full forward, max-abs-err/max-abs {max(errs):.3g} (limit "
              f"{MOE_PLUMB_TOL}), prefill {errs[0]:.3g}; {moved} of "
              f"{p_layers * p_batch * p_len} token routes differ; launches: "
              f"forward {full_counts}, prefill {pre_counts}, decode "
              f"{step_counts[0]} a step ({card})")
        del pparams, full, pre, caches, lg
    if on_card:
        torch.cuda.empty_cache()

    # (c) one full-width MoE block in fp32: the card against the CPU, same
    #     weights and inputs; then in bf16, timed
    bcfg = dataclasses.replace(cfg, dtype="float32")
    cpu = torch.device("cpu")
    with torch.inference_mode():
        bp = moe.moe_init(torch.Generator(device=dev).manual_seed(11), bcfg, dev)
        x = torch.randn(1, MOE_BLOCK_T, cfg.d_model, generator=gen).to(dev)
        bp_cpu = tree_map(lambda w, _: w.to(cpu), bp)
        got, aux = moe.moe_apply(bp, x, bcfg)
        idx = moe.route(bp["router"]["w"], x[0], mc)[1].cpu()
        want, aux_cpu = moe.moe_apply(bp_cpu, x.cpu(), bcfg)
        idx_cpu = moe.route(bp_cpu["router"]["w"], x[0].cpu(), mc)[1]
        got = got[0].cpu()
        want = want[0]
        top = torch.softmax(x[0].cpu() @ bp_cpu["router"]["w"], -1).sort(
            -1, descending=True).values
        ties = (top[:, mc.top_k - 1] - top[:, mc.top_k]) < MOE_TIE
        flipped = (idx.sort(-1).values != idx_cpu.sort(-1).values).any(-1)
        if (flipped & ~ties).any():
            fail(f"moe block: {int((flipped & ~ties).sum())} tokens routed "
                 f"differently with no near-tie (< {MOE_TIE})")
        # a flipped token moves rows between experts, so later tokens of
        # those experts may keep or drop other slots: they are not compared
        comparable = ~flipped
        if flipped.any():
            moved = torch.unique(torch.cat([idx[flipped].ravel(),
                                            idx_cpu[flipped].ravel()]))
            later = torch.arange(MOE_BLOCK_T) > int(flipped.nonzero()[0])
            comparable &= ~(later & torch.isin(idx_cpu, moved).any(-1))
        out_err = (got - want)[comparable].abs().max().item()
        aux_err = abs(float(aux) - float(aux_cpu))
        if not torch.allclose(got[comparable], want[comparable],
                              rtol=MOE_OUT_TOL, atol=MOE_OUT_TOL):
            fail(f"moe block: card vs CPU max abs err {out_err} (limit "
                 f"{MOE_OUT_TOL}) at {int(comparable.sum())} tokens")
        if aux_err > MOE_AUX_TOL:
            fail(f"moe block: aux {float(aux)} vs {float(aux_cpu)} on the CPU")
        cap = moe.capacity(MOE_BLOCK_T, mc)
        dropped = int((moe.expert_counts(idx_cpu.reshape(-1), mc.n_routed) - cap)
                      .clamp(min=0).sum())
        print(f"moe block (T {MOE_BLOCK_T}, fp32, capacity {cap} slots, "
              f"{dropped} of {MOE_BLOCK_T * mc.top_k} rows dropped): card vs "
              f"CPU routes: {int(ties.sum())} near-ties (k-th vs (k+1)-th "
              f"probability < {MOE_TIE}), {int(flipped.sum())} tokens routed "
              f"differently, {int((~comparable).sum())} not compared; outputs "
              f"max abs err {out_err:.3g} (limit {MOE_OUT_TOL}), aux "
              f"{float(aux):.6g} vs {float(aux_cpu):.6g}, err {aux_err:.3g} "
              f"(limit {MOE_AUX_TOL}) ({card})")
        del got, want, bp_cpu

        # the same block in bf16 (router fp32), timed as graph replays and
        # eager; its least time reads every weight once and does the routed
        # rows' products, the shared expert's and the router's
        hcfg = dataclasses.replace(cfg, dtype="bfloat16")
        hp = tree_map(lambda w, key: w if key == "router" else w.to(torch.bfloat16), bp)
        xh = x.to(torch.bfloat16)
        del bp, x
        sizes = []
        tree_map(lambda w, _: sizes.append(w.numel() * w.element_size()), hp)
        w_bytes = sum(sizes)
        shared_ff = mc.shared_ff or mc.expert_ff * mc.n_shared
        flops = 2.0 * MOE_BLOCK_T * cfg.d_model * (
            mc.n_routed + 3 * mc.top_k * mc.expert_ff + 3 * shared_ff + 1)
        b_ms, b_by = bound(flops, w_bytes + 2 * xh.numel() * xh.element_size(),
                           torch.bfloat16)
        block = {"ms": graph_ms(lambda: moe.moe_apply(hp, xh, hcfg), calls=5),
                 "eager_ms": time_ms(lambda: moe.moe_apply(hp, xh, hcfg)),
                 "bound_ms": b_ms, "bound_by": b_by}
        print(f"moe block bf16 (T {MOE_BLOCK_T}, capacity): " + " ".join(
            f"{k}={v:.4g}" if isinstance(v, float) else f"{k}={v}"
            for k, v in block.items()) + f" ({card})")
        del hp, xh

    # (d) the flash kernel at the MoE's attention: prefill (tc_bf16) and the
    #     compiled decode's split_kv against a whole cache, bf16
    flash_rows(torch, dev, card, "moe", cfg, (batch, prompt, cap_len),
               {"prefill": n_layers * n_batches,
                "decode": counts["flash_attention/combine"]},
               gen, graph_ms, time_ms, bound)
    return counts


def flash_rows(torch, dev, card: str, what: str, cfg, shape: tuple,
               launches: dict, gen, graph_ms, time_ms, bound) -> dict:
    """The flash kernel at ``cfg``'s GQA attention in bf16, ``shape`` (batch,
    prompt, cache length): the prefill (tc_bf16, Sq = Skv = prompt) and the
    compiled decode's split_kv at a device position against the whole
    cache, each against its plain version, timed beside SDPA (the kv heads
    repeated to the q heads beforehand) and the card's bound. ``launches``
    gives each case's count on the served path. Returns the two rows."""
    from repro_torch.kernels import flash_attention

    on_card = dev.type == "cuda"
    batch, prompt, cap_len = shape
    hq, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    rows = {}
    for case, (sq, skv) in (("prefill", (prompt, prompt)),
                            ("decode", (1, cap_len))):
        fp = flash_attention.flash_launch_plan(
            bh=batch * hq, sq=sq, skv=skv, d=hd, kv_group=hq // hkv,
            dtype=torch.bfloat16, device_pos=case == "decode")
        q = torch.randn(batch * hq, sq, hd, generator=gen).to(dev, torch.bfloat16)
        k, v = (torch.randn(batch * hkv, skv, hd, generator=gen)
                .to(dev, torch.bfloat16) for _ in range(2))
        extra = ({"pos": torch.tensor([skv - 1, skv], dtype=torch.int32, device=dev)}
                 if case == "decode" else {})
        k, v = (torch.nn.functional.pad(
            t, (0, 0, 0, fp.inputs[1].array_shape[1] - skv)).contiguous()
            for t in (k, v))
        if on_card and fp.body != ("split_kv" if case == "decode" else "tc_bf16"):
            fail(f"flash at the {what} attention, {case}: body {fp.body}")
        call = fp.cuda if on_card else fp.plain
        got, want = call(q, k, v, **extra), fp.plain(q, k, v, **extra)
        err = (got.float() - want.float()).abs().max().item()
        if not torch.allclose(got.float(), want.float(), rtol=FLASH_TOL["bfloat16"],
                              atol=FLASH_TOL["bfloat16"]):
            fail(f"flash at the {what} attention, {case}: max abs err {err}")
        q4 = q.view(batch, hq, sq, hd)
        k4, v4 = (t[:, :skv].reshape(batch, hkv, skv, hd) for t in (k, v))
        flops = 4.0 * batch * hq * sq * skv * hd / (2 if case == "prefill" else 1)
        b_ms, b_by = bound(flops, 2 * (2 * q.numel() + k4.numel() + v4.numel()),
                           torch.bfloat16)
        kr, vr = (t.repeat_interleave(hq // hkv, dim=1) for t in (k4, v4))
        rows[case] = row = {
            "body": fp.body, "max_abs_err": err,
            "ms": graph_ms(lambda: call(q, k, v, **extra)),
            "plain_ms": time_ms(lambda: fp.plain(q, k, v, **extra)),
            "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": graph_ms(
                lambda: torch.nn.functional.scaled_dot_product_attention(
                    q4, kr, vr, is_causal=case == "prefill")),
            "launches": launches[case]}
        print(f"{what} flash {case} bf16 (B {batch}, {hq}/{hkv} heads, d {hd}, "
              f"Sq {sq}, Skv {skv}): " + " ".join(
                  f"{k}={v:.4g}" if isinstance(v, float) else f"{k}={v}"
                  for k, v in row.items()) + f" ({card})")
        del q, k, v, q4, k4, v4, kr, vr, got, want
    return rows


# 4i: multi-head latent attention, DeepSeek-V2-Lite at its published widths
MLA_ARCH = "deepseek-v2-lite-16b"
MLA_SMOKE = False                    # True only in a CPU rehearsal
MLA_PLUMB = (1, 2, 128, 8)           # MoE periods, batch, tokens, decode steps
MLA_BLOCK = (2, 1024, 8)             # batch, prefill tokens, decode steps
MLA_BLOCK_TOL = 1e-3
MLA_PARTS = {"_mla_expand": "mla/expand", "_mla_absorbed": "mla/absorbed"}


def mla_on_card(torch, dev, card: str, graph_ms, time_ms, bound) -> dict:
    """Phase 4i. (a) `launch.serve` serves DeepSeek-V2-Lite at full width
    and depth in bf16 (27 layers: one dense, 26 MoE with capacity
    dispatch), ``MOE_SERVE`` as in phase 4h: every step a graph replay (the
    replays are counted), 27 `flash_attention` launches a prefill (MLA's
    expanded form) and none in decode (the absorbed form runs
    `chunked_attention`, the reference's plain path), every step of batch 0
    equal to the eager steps bit for bit; then a fresh compiled prefill and
    decode step, counted one call at a time and profiled: device busy,
    wall, idle share, and from the eager steps the MLA's expansion, flash
    call and absorbed attention and the MoE's parts; peak memory, the
    decode's bytes bound with all experts and with the routed ones only,
    and the prefill's operations bound. (b) The reference's cache-plumbing
    check at full width on the dense layer and ``MLA_PLUMB[0]`` MoE layers,
    fp32, ragged, eager: an expanded prefill (the flash kernel's cuda_core
    body at built dim 256) and teacher-forced absorbed decode steps against
    one expanded full forward. (c) One full-width MLA block, a prefill of
    ``MLA_BLOCK[1]`` tokens and ``MLA_BLOCK[2]`` absorbed decode steps in
    fp32, on the card against the CPU; then in bf16, timed. (d) The flash
    kernel at MLA's prefill shapes (q/k 192, v 128 padded to 192) against
    its plain version and SDPA. Returns the launch counts of (a) and the
    row of (d)."""
    from unittest import mock

    from repro_torch.configs import get_config, get_smoke
    from repro_torch.kernels import flash_attention, launch, ops
    from repro_torch.launch import graph, serve
    from repro_torch.models import layers, moe
    from repro_torch.models import steps as model_steps
    from repro_torch.models.transformer import (count_params, forward,
                                                init_caches, init_lm)

    cfg = (get_smoke if MLA_SMOKE else get_config)(MLA_ARCH)
    m, mc, n_layers = cfg.mla, cfg.moe, cfg.n_layers
    requests, batch, prompt, gen_len = MOE_SERVE
    n_batches = -(-requests // batch)
    on_card = dev.type == "cuda"
    dq = m.qk_nope + m.qk_rope

    def sync():
        card_sync(torch, dev)

    def rel(got, want) -> float:
        return rel_err(torch, got, want, "mla")

    def scoped():
        """Profiler ranges round the MLA's parts (the flash call as
        "mla/flash": only MLA calls it in this model) and the MoE's."""
        flash_run = ops.gqa_flash_attention

        def flash(*args, **kwargs):
            with torch.profiler.record_function("mla/flash"):
                return flash_run(*args, **kwargs)
        return (scoped_parts(torch, layers, MLA_PARTS)
                + scoped_parts(torch, moe, MOE_PARTS)
                + [mock.patch.object(ops, "gqa_flash_attention", flash)])

    # (a) serving, counted, each step's graph replay counted too
    sync()
    base_gb = 0.0
    if on_card:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        base_gb = torch.cuda.memory_allocated(dev) / 1e9
    record: dict = {}
    replays = []
    replay = graph.CapturedStep.replay

    def counted_replay(self):
        replays.append(self)
        return replay(self)

    launch.reset_launches()
    with mock.patch.object(graph.CapturedStep, "replay", counted_replay):
        report = serve.main(["--arch", MLA_ARCH, *(["--smoke"] if MLA_SMOKE else []),
                             "--requests", str(requests), "--batch", str(batch),
                             "--prompt-len", str(prompt), "--gen-len", str(gen_len),
                             "--device", dev.type], record=record)
    sync()
    counts = dict(launch.LAUNCHES)
    expect = {"flash_attention": n_layers * n_batches}
    if counts != expect:
        fail(f"mla serve launched {counts}, expected {expect} ({n_layers} "
             f"layers x {n_batches} prefills; the absorbed decode launches "
             f"no flash kernel)")
    if on_card and len(replays) != n_batches * gen_len:
        fail(f"mla serve: {len(replays)} graph replays, expected "
             f"{n_batches * gen_len} (a prefill and {gen_len - 1} decodes a batch)")
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9 if on_card else 0.0
    params = record["params"]
    n_params = count_params(cfg)
    print(f"mla serve ({MLA_ARCH}, {n_layers} layers ({cfg.first_dense_layers} "
          f"dense of ff {cfg.first_dense_ff}), d {cfg.d_model}, {cfg.n_heads} "
          f"heads, MLA kv_lora {m.kv_lora} rope {m.qk_rope} nope {m.qk_nope} "
          f"v {m.v_head}, {mc.n_routed} experts top-{mc.top_k} + "
          f"{mc.n_shared} shared, {cfg.dtype}, {mc.impl}, {n_params} "
          f"parameters, {count_params(cfg, active_only=True)} active): "
          f"launches {counts}; {len(replays)} graph replays; report "
          f"{json.dumps(report)}; peak memory {peak_gb:.3f} GB "
          f"({base_gb:.3f} GB before the phase) ({card})")

    b0 = record["batches"][0]
    cap_len = prompt + gen_len
    prefill_e, decode_e = served_equal_eager(torch, cfg, params, b0, cap_len,
                                             "mla")

    # a fresh compiled prefill and decode, counted one call at a time, and
    # where each step's device time goes
    prefill_c = graph.compile_prefill(model_steps.make_prefill_step(cfg, cap_len))
    decode_c = graph.compile_decode(model_steps.make_decode_step(cfg))
    tok = b0["tokens"][:, :1]
    rows = {}
    with torch.inference_mode():
        launch.reset_launches()
        _, caches = prefill_c(params, {"tokens": b0["prompts"]})
        sync()
        got = dict(launch.LAUNCHES)
        if got != {"flash_attention": n_layers}:
            fail(f"mla compiled prefill launched {got}, expected "
                 f"{n_layers} flash_attention")
        step_counts = []
        for i in range(3):
            launch.reset_launches()
            _, caches = decode_c(params, caches, b0["tokens"][:, i:i + 1])
            sync()
            step_counts.append(dict(launch.LAUNCHES))
        if any(step_counts):
            fail(f"mla compiled decode steps launched {step_counts}, expected "
                 f"none (no split_kv, no combine)")
        for name, fn in (("prefill", lambda: prefill_c(params, {"tokens": b0["prompts"]})),
                         ("decode", lambda: decode_c(params, caches, tok))):
            rows[(name, "compiled")] = profiled_parts(torch, dev, fn, ("mla/",))
            rows[(name, "compiled")]["wall"] = median_wall_ms(torch, dev, fn)
        # the eager steps, each MLA and MoE part in a profiler range; the
        # experts each decode layer routes to, for a grouped GEMM's bound
        routed: list = []
        eager_caches = {}
        patches = scoped()
        for patch in patches:
            patch.start()
        try:
            rows[("prefill", "eager")] = profiled_parts(
                torch, dev, lambda: eager_caches.update(
                    c=prefill_e(params, {"tokens": b0["prompts"]})[1]),
                ("mla/", "moe/"))
            with recording_routes(moe, routed):
                rows[("decode", "eager")] = profiled_parts(
                    torch, dev, lambda: decode_e(params, eager_caches["c"], tok),
                    ("mla/", "moe/"))
        finally:
            for patch in patches:
                patch.stop()
        touched = [int(torch.unique(idx).numel()) for idx in routed]
        del caches, eager_caches
    elem = params["lm_head"]["w"].element_size()
    latent_bytes = n_layers * batch * cap_len * (m.kv_lora + m.qk_rope) * elem
    unread = (cfg.padded_vocab - batch) * cfg.d_model * elem   # embedding rows
    expert_bytes = 3 * cfg.d_model * mc.expert_ff * elem
    weight_bytes = n_params * elem - unread
    moe_layers = n_layers - cfg.first_dense_layers
    grouped_bytes = weight_bytes - (moe_layers * mc.n_routed - sum(touched)) * expert_bytes
    # prefill: the active parameters' products on every token, and the
    # causal attention of the expanded form (q k^T 192 wide, p v 128)
    attn_flops = (n_layers * 2.0 * batch * cfg.n_heads * prompt * prompt
                  * (dq + m.v_head) / 2)
    bounds = {
        "decode": 1e3 * (weight_bytes + latent_bytes) / HBM_BYTES_PER_S,
        "prefill": bound(2.0 * count_params(cfg, active_only=True) * batch * prompt
                         + attn_flops, n_params * elem, torch.bfloat16)[0]}
    grouped_ms = 1e3 * (grouped_bytes + latent_bytes) / HBM_BYTES_PER_S
    print(f"mla step bounds (batch {batch}): decode {bounds['decode']:.3f} ms "
          f"(bytes: {weight_bytes / 1e9:.3f} GB of weights, all "
          f"{mc.n_routed} experts of {moe_layers} MoE layers, and "
          f"{latent_bytes / 1e9:.4f} GB of latent cache, {cap_len} positions "
          f"a layer, once); a grouped GEMM reading only the routed experts "
          f"{grouped_ms:.3f} ms ({grouped_bytes / 1e9:.3f} GB of weights; "
          f"experts routed a layer {touched}, mean "
          f"{sum(touched) / max(1, len(touched)):.2f}); prefill "
          f"{bounds['prefill']:.3f} ms (operations: active parameters and "
          f"{attn_flops / 1e9:.1f} GFLOP of causal attention) ({card})")
    for (name, mode), row in rows.items():
        busy = max(row["busy"], 1e-9)
        parts = ""
        if mode == "eager":
            mla = {"expansion einsum": row.get("mla/expand", 0.0),
                   "flash call": row.get("mla/flash", 0.0),
                   "absorbed attention": row.get("mla/absorbed", 0.0)}
            ffn, apply = row.get("moe/ffn", 0.0), row.get("moe/apply", 0.0)
            share = {"routing": row.get("moe/route", 0.0),
                     "dispatch": row.get("moe/dispatch", 0.0),
                     "expert products": row.get("moe/experts", 0.0),
                     "combine": ffn - row.get("moe/dispatch", 0.0)
                     - row.get("moe/experts", 0.0),
                     "shared experts": apply - ffn - row.get("moe/route", 0.0)}
            parts = ("; MLA " + ", ".join(f"{k} {v:.3f} ms ({v / busy:.3f})"
                                          for k, v in mla.items())
                     + f"; MoE {apply:.3f} ms ({apply / busy:.3f} of busy): "
                     + ", ".join(f"{k} {v:.3f} ms ({v / busy:.3f})"
                                 for k, v in share.items()))
        wall = ""
        if "wall" in row:
            wall = (f", wall {row['wall']:.3f} ms (median of 5), idle share "
                    f"{1 - row['busy'] / max(row['wall'], 1e-9):.3f}")
        print(f"mla profile ({name}, {mode}, batch {batch}): device busy "
              f"{row['busy']:.3f} ms (kernel events){wall}{parts}; bound "
              f"{bounds[name]:.3f} ms ({card})")
    del prefill_c, decode_c, record, b0, params
    if on_card:
        torch.cuda.empty_cache()

    # (b) cache plumbing: the dense layer and the first MoE layers at full
    #     width, fp32, ragged, eager; an expanded prefill and teacher-forced
    #     absorbed decode steps against one expanded full forward
    p_periods, p_batch, p_len, p_steps = MLA_PLUMB
    pcfg = dataclasses.replace(cfg, n_periods=p_periods, dtype="float32",
                               moe=dataclasses.replace(mc, impl="ragged"))
    p_layers = pcfg.n_layers
    n_pre = p_len - p_steps
    gen = torch.Generator(device="cpu").manual_seed(7)
    toks = torch.randint(0, pcfg.vocab, (p_batch, p_len), generator=gen).to(dev)
    pre_body = flash_attention.flash_launch_plan(
        bh=p_batch * cfg.n_heads, sq=n_pre, skv=n_pre, d=dq,
        dtype=torch.float32).body
    if not MLA_SMOKE and pre_body != "cuda_core":
        fail(f"mla plumbing: the fp32 prefill's flash plan takes {pre_body}")
    with torch.inference_mode():
        pparams = init_lm(pcfg, seed=3, device=dev)

        def run(tokens, **kw):
            launch.reset_launches()
            out = forward(pparams, pcfg, tokens, **kw)
            sync()
            return out, dict(launch.LAUNCHES)

        (full, _, _), full_counts = run(toks)
        caches = init_caches(pcfg, p_batch, p_len, device=dev)
        (pre, caches, _), pre_counts = run(toks[:, :n_pre], caches=caches, start=0)
        errs = [rel(pre[:, -1], full[:, n_pre - 1])]
        step_counts = []
        for i in range(n_pre, p_len):
            (lg, caches, _), c = run(toks[:, i:i + 1], caches=caches)
            step_counts.append(c)
            errs.append(rel(lg[:, 0], full[:, i]))
        one_pass = {"flash_attention": p_layers,
                    **({"flash_attention/pack": p_layers}
                       if pre_body == "tc_3xtf32" else {})}
        if full_counts != one_pass or pre_counts != one_pass:
            fail(f"mla plumbing: forward launched {full_counts}, prefill "
                 f"{pre_counts}, expected {one_pass} ({pre_body})")
        if any(step_counts):
            fail(f"mla plumbing: absorbed decode steps launched {step_counts}")
        if max(errs) > MOE_PLUMB_TOL:
            fail(f"mla plumbing: prefill + absorbed decode vs expanded full "
                 f"forward max-abs-err/max-abs {max(errs)} (limit {MOE_PLUMB_TOL})")
        print(f"mla plumbing ({p_layers} layers: {pcfg.first_dense_layers} dense "
              f"+ {p_periods} MoE, full width, fp32, ragged, batch {p_batch}, "
              f"prefill {n_pre} + {p_steps} absorbed decode steps): vs one "
              f"expanded full forward, max-abs-err/max-abs {max(errs):.3g} "
              f"(limit {MOE_PLUMB_TOL}), prefill {errs[0]:.3g}; flash body "
              f"{pre_body}; launches: forward {full_counts}, prefill "
              f"{pre_counts}, decode {step_counts[0]} a step ({card})")
        del pparams, full, pre, caches, lg
    if on_card:
        torch.cuda.empty_cache()

    # (c) one full-width MLA block in fp32: a prefill and absorbed decode
    #     steps, the card against the CPU, same weights and inputs; then in
    #     bf16, timed
    bsz, t_pre, t_dec = MLA_BLOCK
    t_all = t_pre + t_dec
    bcfg = dataclasses.replace(cfg, dtype="float32")
    cpu = torch.device("cpu")
    block_body = flash_attention.flash_launch_plan(
        bh=bsz * cfg.n_heads, sq=t_pre, skv=t_pre, d=dq, dtype=torch.float32).body

    def block(p, x, where):
        cache = layers.init_mla_cache(bcfg, bsz, t_all, where)
        zero = torch.zeros((), dtype=torch.int32, device=where)
        outs = [layers.mla_apply(p, x[:, :t_pre], bcfg,
                                 positions=torch.arange(t_pre, device=where),
                                 cache=cache, cache_pos=zero, start=0)[0]]
        for i in range(t_pre, t_all):
            pos = zero + i
            outs.append(layers.mla_apply(
                p, x[:, i:i + 1], bcfg, positions=pos + torch.arange(1, device=where),
                cache=cache, cache_pos=pos)[0])
        return torch.cat(outs, 1), cache[layers.MLA_CACHE]

    with torch.inference_mode():
        bp = layers.mla_init(torch.Generator(device=dev).manual_seed(11), bcfg, dev)
        x = torch.randn(bsz, t_all, cfg.d_model, generator=gen).to(dev)
        launch.reset_launches()
        got, got_cache = block(bp, x, dev)
        sync()
        block_counts = dict(launch.LAUNCHES)
        want, want_cache = block(tree_map(lambda w, _: w.to(cpu), bp), x.cpu(), cpu)
        got, got_cache = got.cpu(), got_cache.cpu()
        errs = {what: (a - b).abs().max().item()
                for what, a, b in (("prefill", got[:, :t_pre], want[:, :t_pre]),
                                   ("decode", got[:, t_pre:], want[:, t_pre:]),
                                   ("cache", got_cache, want_cache))}
        for a, b in ((got, want), (got_cache, want_cache)):
            if not torch.allclose(a, b, rtol=MLA_BLOCK_TOL, atol=MLA_BLOCK_TOL):
                fail(f"mla block: card vs CPU max abs err {errs} (limit "
                     f"{MLA_BLOCK_TOL})")
        if block_counts != {"flash_attention": 1, **(
                {"flash_attention/pack": 1} if block_body == "tc_3xtf32" else {})}:
            fail(f"mla block: launched {block_counts}, expected one flash "
                 f"prefill ({block_body}) and no launch in decode")
        print(f"mla block (batch {bsz}, prefill {t_pre} + {t_dec} absorbed "
              f"decode steps, fp32, flash body {block_body}): card vs CPU max "
              f"abs err " + ", ".join(f"{k} {v:.3g}" for k, v in errs.items())
              + f" (limit {MLA_BLOCK_TOL}); launches {block_counts} ({card})")
        del got, want, got_cache, want_cache

        # the same block in bf16: a prefill into a fresh cache and an
        # absorbed decode step at the cache's last position, timed
        hcfg = dataclasses.replace(cfg, dtype="bfloat16")
        hp = tree_map(lambda w, _: w.to(torch.bfloat16), bp)
        xh = x.to(torch.bfloat16)
        del bp, x
        cache = layers.init_mla_cache(hcfg, bsz, t_all, dev)
        buf = cache[layers.MLA_CACHE]
        zero = torch.zeros((), dtype=torch.int32, device=dev)
        last = zero + (t_all - 1)
        pre_pos = torch.arange(t_pre, device=dev)
        last_pos = last + torch.arange(1, device=dev)
        q_abs = torch.randn(bsz, cfg.n_heads, 1, m.kv_lora + m.qk_rope,
                            generator=gen).to(dev, torch.bfloat16)
        timed = {
            "prefill_ms": graph_ms(lambda: layers.mla_apply(
                hp, xh[:, :t_pre], hcfg, positions=pre_pos, cache=cache,
                cache_pos=zero, start=0), calls=5),
            "decode_ms": graph_ms(lambda: layers.mla_apply(
                hp, xh[:, -1:], hcfg, positions=last_pos, cache=cache,
                cache_pos=last)),
            "chunked_attention_ms": graph_ms(lambda: layers.chunked_attention(
                q_abs, buf[:, None], buf[:, None, :, :m.kv_lora], causal=True,
                q_offset=last, kv_valid_len=last + 1, chunk=cfg.attn_chunk))}
        print(f"mla block bf16 (batch {bsz}, cache {t_all}, graph replays): "
              + " ".join(f"{k}={v:.4g}" for k, v in timed.items()) + f" ({card})")
        del hp, xh, cache, buf, q_abs

    # (d) the flash kernel at MLA's prefill shapes: q and k 192 wide, v 128
    #     (padded to 192 by the wrapper), the kernel at its built dim 256
    hq = cfg.n_heads
    fp = flash_attention.flash_launch_plan(bh=batch * hq, sq=prompt, skv=prompt,
                                           d=dq, dtype=torch.bfloat16)
    if on_card and fp.body != "tc_bf16":
        fail(f"flash at MLA's prefill: body {fp.body}")
    q4, k4 = (torch.randn(batch, hq, prompt, dq, generator=gen)
              .to(dev, torch.bfloat16) for _ in range(2))
    v4 = torch.randn(batch, hq, prompt, m.v_head, generator=gen).to(dev, torch.bfloat16)
    pad_q = fp.inputs[0].array_shape[1] - prompt
    flat = [torch.nn.functional.pad(t.reshape(batch * hq, prompt, dq),
                                    (0, 0, 0, pad_q)).contiguous()
            for t in (q4, k4, torch.nn.functional.pad(v4, (0, dq - m.v_head)))]

    # the kernel alone at its built dim, on operands padded beforehand: the
    # wrapper's time less its three pad copies
    d_run = flash_attention.built_head_dim(dq)
    fp_run = flash_attention.flash_launch_plan(
        bh=batch * hq, sq=prompt, skv=prompt, d=d_run, dtype=torch.bfloat16)
    flat_run = [torch.nn.functional.pad(t, (0, d_run - dq)) for t in flat]
    run_call = fp_run.cuda if on_card else fp_run.plain

    def plain():
        return fp.plain(*flat)[:, :prompt, :m.v_head].reshape(
            batch, hq, prompt, m.v_head)

    with torch.inference_mode():
        launch.reset_launches()
        got = ops.gqa_flash_attention(q4, k4, v4, causal=True)
        sync()
        if on_card and dict(launch.LAUNCHES) != {"flash_attention": 1}:
            fail(f"flash at MLA's prefill launched {dict(launch.LAUNCHES)}")
        want = plain()
        err = (got.float() - want.float()).abs().max().item()
        if got.shape != want.shape or not torch.allclose(
                got.float(), want.float(), rtol=FLASH_TOL["bfloat16"],
                atol=FLASH_TOL["bfloat16"]):
            fail(f"flash at MLA's prefill: max abs err {err}")
        flops = 2.0 * batch * hq * prompt * prompt * (dq + m.v_head) / 2
        b_ms, b_by = bound(flops, 2 * (q4.numel() + k4.numel() + 2 * v4.numel()),
                           torch.bfloat16)
        row = {"body": fp.body, "built_head_dim": flash_attention.built_head_dim(dq),
               "max_abs_err": err,
               "ms": graph_ms(lambda: ops.gqa_flash_attention(q4, k4, v4, causal=True)),
               "kernel_ms": graph_ms(lambda: run_call(*flat_run)),
               "plain_ms": time_ms(plain),
               "bound_ms": b_ms, "bound_by": b_by,
               "library_ms": graph_ms(
                   lambda: torch.nn.functional.scaled_dot_product_attention(
                       q4, k4, v4, is_causal=True)),
               "launches": counts["flash_attention"]}
    print(f"mla flash prefill bf16 (B {batch}, {hq}/{hq} heads, q/k {dq}, v "
          f"{m.v_head} padded to {dq}, Sq = Skv = {prompt}): " + " ".join(
              f"{k}={v:.4g}" if isinstance(v, float) else f"{k}={v}"
              for k, v in row.items()) + f" ({card})")
    del q4, k4, v4, flat, flat_run, got, want
    return {"counts": counts, "flash": row}


# 4j: the Mamba-2 SSM stack: Mamba2-1.3B at its published widths and depth,
#     Jamba-v0.1 at its published widths, reduced to 2 of its 4 periods
SSM_ARCHS = ("mamba2-1.3b", "jamba-v0.1-52b")
SSM_SMOKE = False                    # True only in a CPU rehearsal
JAMBA_PERIODS = 2                    # of 4: 52.0 of 102.9 GB of bf16 weights
SSM_PLUMB = (2, 600, 4)              # batch, tokens, decode steps
SSM_PLUMB_CUT = {"mamba2-1.3b": 4, "jamba-v0.1-52b": 5}    # layers kept
SSM_BLOCK = (2, 1024, 8)             # batch, prefill tokens, decode steps
SSM_BLOCK_TOL = 1e-4
SSM_PARTS = {"_project_in": "ssm/proj", "_project_out": "ssm/proj",
             "_causal_conv": "ssm/conv", "_conv_step": "ssm/conv",
             "_in_chunk": "ssm/in_chunk", "_chunk_states": "ssm/states",
             "_chunk_scan": "ssm/chunk_loop", "_off_chunk": "ssm/y_off",
             "_gated_norm": "ssm/gated_norm", "_recurrent_step": "ssm/recurrent",
             "mamba_apply": "ssm/mamba"}


def ssm_config(name: str):
    """The config phase 4j runs: the published one (the smoke one in a CPU
    rehearsal), Jamba cut to ``JAMBA_PERIODS`` periods."""
    from repro_torch.configs import get_config, get_smoke

    cfg = (get_smoke if SSM_SMOKE else get_config)(name)
    if name == "jamba-v0.1-52b":
        cfg = dataclasses.replace(cfg, n_periods=min(cfg.n_periods, JAMBA_PERIODS))
    return cfg


def ssd_flops(cfg, batch: int, s: int) -> tuple[float, float]:
    """One mamba layer's chunked-SSD products on (batch, s) tokens, as the
    reference computes them (full L x L chunks): (the C B^T scores, in the
    config's dtype; the in-chunk output, the chunk states and y_off, in
    fp32 by promotion)."""
    sc = cfg.ssm
    h = sc.expand * cfg.d_model // sc.head_dim
    lc = min(sc.chunk, s)
    c = -(-s // lc)
    scores = 2.0 * batch * c * sc.n_groups * lc * lc * sc.d_state
    fp32 = 2.0 * batch * c * h * lc * (lc * sc.head_dim
                                       + 2 * sc.head_dim * sc.d_state)
    return scores, fp32


def ssm_on_card(torch, dev, card: str, graph_ms, time_ms, bound) -> dict:
    """Phase 4j. (a) `launch.serve` serves Mamba2-1.3B at full width and
    depth (48 mamba layers, no FFN, tied embedding) and (b) Jamba-v0.1 at
    full width, reduced to ``JAMBA_PERIODS`` periods (16 layers: 2
    attention, 14 mamba, 8 MoE of 16 experts top-2, 8 dense FFNs), both in
    bf16, ``MOE_SERVE`` as in phase 4h: every step a graph replay (the
    replays counted) and every step of batch 0 equal to the eager steps bit
    for bit. Mamba2 launches no repo kernel; Jamba launches the flash kernel
    in its 2 attention layers, tc_bf16 in prefill, split_kv and its combine
    in decode. A fresh compiled prefill and decode step, counted one call at
    a time and profiled (device busy, wall, idle share), and from the eager
    steps the SSD's parts (projections, conv, in-chunk, states, chunk loop,
    y_off, gated norm, the recurrent update) and Jamba's MoE; peak memory;
    the decode's bytes bound (Jamba's with every expert read and with the
    routed ones only) and the prefill's operations bound. (c) The
    reference's cache-plumbing check, fp32, eager: a prefill of S - 4
    tokens and 4 teacher-forced decode steps against one full forward, on
    Mamba2's first 4 layers and Jamba's first 5 sublayers (through its
    attention; MoE ragged). (d) One full-width mamba block of each arch, a
    prefill of ``SSM_BLOCK[1]`` tokens and ``SSM_BLOCK[2]`` recurrent steps
    in fp32, on the card against the CPU; then in bf16, timed. (e) The
    flash kernel at Jamba's attention (32 q heads over 8 kv heads, d 128).
    Returns each arch's launch counts and the rows of (e)."""
    from unittest import mock

    from repro_torch.launch import graph, serve
    from repro_torch.kernels import flash_attention, launch
    from repro_torch.models import moe, ssm
    from repro_torch.models import steps as model_steps
    from repro_torch.models.transformer import (count_params, forward,
                                                init_caches, init_lm,
                                                layer_kinds)

    requests, batch, prompt, gen_len = MOE_SERVE
    n_batches = -(-requests // batch)
    cap_len = prompt + gen_len
    on_card = dev.type == "cuda"
    gen = torch.Generator(device="cpu").manual_seed(13)

    def sync():
        card_sync(torch, dev)

    def rel(got, want, what) -> float:
        return rel_err(torch, got, want, what)

    def attn_launches(n_attn: int, prefills: int, decodes: int) -> dict:
        out = {"flash_attention": n_attn * (prefills + decodes),
               "flash_attention/combine": n_attn * decodes}
        return {k: v for k, v in out.items() if v}

    # (a), (b) serving, counted, each step's graph replay counted too
    served = {}
    for name in SSM_ARCHS:
        cfg = ssm_config(name)
        kinds = layer_kinds(cfg)
        n_attn = sum(mixer == "attn" for mixer, _ in kinds)
        n_mamba = len(kinds) - n_attn
        sync()
        base_gb = 0.0
        if on_card:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(dev)
            base_gb = torch.cuda.memory_allocated(dev) / 1e9
        record: dict = {}
        replays = []
        replay = graph.CapturedStep.replay

        def counted_replay(self, _replay=replay, _replays=replays):
            _replays.append(self)
            return _replay(self)

        launch.reset_launches()
        with mock.patch.object(graph.CapturedStep, "replay", counted_replay), \
                mock.patch.object(serve, "get_config", ssm_config), \
                mock.patch.object(serve, "get_smoke", ssm_config):
            report = serve.main(["--arch", name, "--requests", str(requests),
                                 "--batch", str(batch), "--prompt-len", str(prompt),
                                 "--gen-len", str(gen_len), "--device", dev.type],
                                record=record)
        sync()
        counts = dict(launch.LAUNCHES)
        expect = attn_launches(n_attn, n_batches, n_batches * (gen_len - 1))
        if counts != expect:
            fail(f"ssm serve {name}: launched {counts}, expected {expect} "
                 f"({n_attn} attention layers, {n_batches} prefills)")
        if on_card and len(replays) != n_batches * gen_len:
            fail(f"ssm serve {name}: {len(replays)} graph replays, expected "
                 f"{n_batches * gen_len} (a prefill and {gen_len - 1} decodes a batch)")
        peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9 if on_card else 0.0
        params = record["params"]
        n_params = count_params(cfg)
        sc, mc = cfg.ssm, cfg.moe
        reduced = ("" if name != "jamba-v0.1-52b" else
                   f", reduced to {cfg.n_periods} of 4 periods")
        print(f"ssm serve ({name}, {len(kinds)} layers{reduced}: {n_mamba} "
              f"mamba (d_state {sc.d_state}, head_dim {sc.head_dim}, expand "
              f"{sc.expand}, chunk {sc.chunk}), {n_attn} attention"
              + (f" ({cfg.n_heads}/{cfg.n_kv_heads} heads)" if n_attn else "")
              + (f", {sum(f == 'moe' for _, f in kinds)} MoE of {mc.n_routed} "
                 f"experts top-{mc.top_k} ({mc.impl})" if mc else "")
              + f", d {cfg.d_model}, {cfg.dtype}, {n_params} parameters, "
              f"{count_params(cfg, active_only=True)} active): launches "
              f"{counts}" + ("" if n_attn else " (no repo kernel: the SSD is "
                             "plain PyTorch, as the reference's is plain XLA)")
              + f"; {len(replays)} graph replays; report {json.dumps(report)}; "
              f"peak memory {peak_gb:.3f} GB ({base_gb:.3f} GB before) ({card})")

        b0 = record["batches"][0]
        prefill_e, decode_e = served_equal_eager(torch, cfg, params, b0, cap_len,
                                                 name)

        # a fresh compiled prefill and decode, counted one call at a time,
        # and where each step's device time goes
        prefill_c = graph.compile_prefill(model_steps.make_prefill_step(cfg, cap_len))
        decode_c = graph.compile_decode(model_steps.make_decode_step(cfg))
        tok = b0["tokens"][:, :1]
        rows = {}
        with torch.inference_mode():
            launch.reset_launches()
            _, caches = prefill_c(params, {"tokens": b0["prompts"]})
            sync()
            got = dict(launch.LAUNCHES)
            if got != attn_launches(n_attn, 1, 0):
                fail(f"ssm {name} compiled prefill launched {got}")
            step_counts = []
            for i in range(3):
                launch.reset_launches()
                _, caches = decode_c(params, caches, b0["tokens"][:, i:i + 1])
                sync()
                step_counts.append(dict(launch.LAUNCHES))
            if any(c != attn_launches(n_attn, 0, 1) for c in step_counts):
                fail(f"ssm {name} compiled decode steps launched {step_counts}")
            for step, fn in (("prefill", lambda: prefill_c(params, {"tokens": b0["prompts"]})),
                             ("decode", lambda: decode_c(params, caches, tok))):
                rows[(step, "compiled")] = profiled_parts(torch, dev, fn, ("ssm/",))
                rows[(step, "compiled")]["wall"] = median_wall_ms(torch, dev, fn)
            routed: list = []
            eager_caches = {}
            patches = (scoped_parts(torch, ssm, SSM_PARTS)
                       + scoped_parts(torch, moe, MOE_PARTS))
            for patch in patches:
                patch.start()
            try:
                rows[("prefill", "eager")] = profiled_parts(
                    torch, dev, lambda: eager_caches.update(
                        c=prefill_e(params, {"tokens": b0["prompts"]})[1]),
                    ("ssm/", "moe/"))
                with recording_routes(moe, routed):
                    rows[("decode", "eager")] = profiled_parts(
                        torch, dev, lambda: decode_e(params, eager_caches["c"], tok),
                        ("ssm/", "moe/"))
            finally:
                for patch in patches:
                    patch.stop()
            touched = [int(torch.unique(idx).numel()) for idx in routed]
            del caches, eager_caches

        # the bounds: decode reads every weight once (not the embedding's
        # unread rows where it is not tied), every mamba layer's state and
        # conv window in and out, and every attention layer's kv cache;
        # prefill does the active parameters' products, the SSD's and the
        # attention's
        elem = params["embed"]["w"].element_size()
        table = cfg.padded_vocab * cfg.d_model
        weight_bytes = n_params * elem - (0 if cfg.tie_embed
                                          else (table - batch * cfg.d_model) * elem)
        state = init_caches(cfg, batch, cap_len, device="meta")
        state_bytes = sum(t.numel() * t.element_size() * (2 if mixer == "mamba" else 1)
                          for (mixer, _), c in zip(kinds, state["layers"])
                          for t in c.values())
        scores, ssd32 = ssd_flops(cfg, batch, prompt)
        f_bf16 = (2.0 * (count_params(cfg, active_only=True)
                         - (0 if cfg.tie_embed else table)) * batch * prompt
                  + n_mamba * scores
                  + n_attn * 2.0 * batch * cfg.n_heads * prompt * prompt * cfg.hd)
        t_ops = (bound(f_bf16, 0, torch.bfloat16)[0]
                 + bound(n_mamba * ssd32, 0, torch.float32)[0])
        bounds = {"decode": 1e3 * (weight_bytes + state_bytes) / HBM_BYTES_PER_S,
                  "prefill": max(t_ops, 1e3 * n_params * elem / HBM_BYTES_PER_S)}
        grouped = ""
        if mc:
            expert_bytes = 3 * cfg.d_model * mc.expert_ff * elem
            n_moe = sum(f == "moe" for _, f in kinds)
            grouped_bytes = weight_bytes - (n_moe * mc.n_routed - sum(touched)) * expert_bytes
            grouped = (f"; a grouped GEMM reading only the routed experts "
                       f"{1e3 * (grouped_bytes + state_bytes) / HBM_BYTES_PER_S:.3f} ms "
                       f"({grouped_bytes / 1e9:.3f} GB of weights; experts routed "
                       f"a layer {touched}, mean {sum(touched) / max(1, len(touched)):.2f})")
        print(f"ssm step bounds ({name}, batch {batch}): decode "
              f"{bounds['decode']:.3f} ms (bytes: {weight_bytes / 1e9:.3f} GB of "
              f"weights" + (f", all {mc.n_routed} experts of every MoE layer" if mc else "")
              + f", {state_bytes / 1e9:.4f} GB of state: SSM state and conv "
              f"window in and out" + (", kv cache in" if n_attn else "")
              + f"){grouped}; prefill {bounds['prefill']:.3f} ms (operations: "
              f"{f_bf16 / 1e9:.1f} GFLOP bf16 (active parameters"
              + (", causal attention" if n_attn else "")
              + f", C B^T) and {n_mamba * ssd32 / 1e9:.1f} GFLOP of fp32 SSD "
              f"products) ({card})")
        for (step, mode), row in rows.items():
            busy = max(row["busy"], 1e-9)
            parts = ""
            if mode == "eager":
                names = {"projections": "ssm/proj", "conv": "ssm/conv",
                         "in-chunk": "ssm/in_chunk", "states": "ssm/states",
                         "chunk loop": "ssm/chunk_loop", "y_off": "ssm/y_off",
                         "gated norm": "ssm/gated_norm",
                         "recurrent update": "ssm/recurrent"}
                mamba = row.get("ssm/mamba", 0.0)
                parts = (f"; mamba blocks {mamba:.3f} ms ({mamba / busy:.3f} of "
                         f"busy): " + ", ".join(
                             f"{k} {row.get(v, 0.0):.3f} ms ({row.get(v, 0.0) / busy:.3f})"
                             for k, v in names.items()))
                if mc:
                    apply = row.get("moe/apply", 0.0)
                    parts += (f"; MoE {apply:.3f} ms ({apply / busy:.3f}): expert "
                              f"products {row.get('moe/experts', 0.0):.3f}, dispatch "
                              f"{row.get('moe/dispatch', 0.0):.3f}, routing "
                              f"{row.get('moe/route', 0.0):.3f}")
            wall = ""
            if "wall" in row:
                wall = (f", wall {row['wall']:.3f} ms (median of 5), idle share "
                        f"{1 - row['busy'] / max(row['wall'], 1e-9):.3f}")
            print(f"ssm profile ({name}, {step}, {mode}, batch {batch}): device "
                  f"busy {row['busy']:.3f} ms (kernel events){wall}{parts}; "
                  f"bound {bounds[step]:.3f} ms ({card})")
        served[name] = counts
        del prefill_c, decode_c, record, b0, params, prefill_e, decode_e
        if on_card:
            torch.cuda.empty_cache()

    # (c) cache plumbing at full width, fp32, eager: Mamba2's first layers,
    #     Jamba's first sublayers through its attention (MoE ragged); a
    #     prefill over chunks and a padded one, then recurrent steps
    p_batch, p_len, p_steps = SSM_PLUMB
    n_pre = p_len - p_steps
    for name in SSM_ARCHS:
        cfg = ssm_config(name)
        keep = SSM_PLUMB_CUT[name]
        layout = cfg.period_layout
        pcfg = dataclasses.replace(
            cfg, dtype="float32",
            n_periods=keep if len(layout) == 1 else 1,
            period_layout=layout if len(layout) == 1 else layout[:keep],
            moe=cfg.moe and dataclasses.replace(cfg.moe, impl="ragged"))
        n_attn = sum(mixer == "attn" for mixer, _ in layer_kinds(pcfg))
        body = flash_attention.flash_launch_plan(
            bh=p_batch * cfg.n_heads, sq=n_pre, skv=n_pre, d=cfg.hd,
            kv_group=cfg.n_heads // cfg.n_kv_heads, dtype=torch.float32).body
        toks = torch.randint(0, pcfg.vocab, (p_batch, p_len), generator=gen).to(dev)
        with torch.inference_mode():
            pparams = init_lm(pcfg, seed=3, device=dev)

            def run(tokens, **kw):
                launch.reset_launches()
                out = forward(pparams, pcfg, tokens, **kw)
                sync()
                return out, dict(launch.LAUNCHES)

            (full, _, _), full_counts = run(toks)
            caches = init_caches(pcfg, p_batch, p_len, device=dev)
            (pre, caches, _), pre_counts = run(toks[:, :n_pre], caches=caches, start=0)
            errs = [rel(pre[:, -1], full[:, n_pre - 1], name)]
            step_counts = []
            for i in range(n_pre, p_len):
                (lg, caches, _), c = run(toks[:, i:i + 1], caches=caches)
                step_counts.append(c)
                errs.append(rel(lg[:, 0], full[:, i], name))
            one_pass = attn_launches(n_attn, 1, 0)
            if n_attn and body == "tc_3xtf32":
                one_pass["flash_attention/pack"] = n_attn
            if full_counts != one_pass or pre_counts != one_pass:
                fail(f"ssm plumbing {name}: forward launched {full_counts}, "
                     f"prefill {pre_counts}, expected {one_pass} ({body})")
            if any(c != attn_launches(n_attn, 0, 1) for c in step_counts):
                fail(f"ssm plumbing {name}: decode steps launched {step_counts}")
            if max(errs) > MOE_PLUMB_TOL:
                fail(f"ssm plumbing {name}: prefill + decode vs full forward "
                     f"max-abs-err/max-abs {max(errs)} (limit {MOE_PLUMB_TOL})")
            print(f"ssm plumbing ({name}, {pcfg.n_layers} layers "
                  f"{[m + '+' + f for m, f in layer_kinds(pcfg)]}, full width, "
                  f"fp32, batch {p_batch}, prefill {n_pre} ({-(-n_pre // cfg.ssm.chunk)} "
                  f"chunks of {cfg.ssm.chunk}, the last padded) + {p_steps} decode "
                  f"steps): vs one full forward, max-abs-err/max-abs "
                  f"{max(errs):.3g} (limit {MOE_PLUMB_TOL}), prefill {errs[0]:.3g}; "
                  f"launches: forward {full_counts}, prefill {pre_counts}, decode "
                  f"{step_counts[0]} a step" + (f"; flash body {body}" if n_attn else "")
                  + f" ({card})")
            del pparams, full, pre, caches, lg
        if on_card:
            torch.cuda.empty_cache()

    # (d) one full-width mamba block of each arch in fp32: a prefill into a
    #     cache and recurrent steps, the card against the CPU, same weights
    #     and inputs; then in bf16, timed
    bsz, t_pre, t_dec = SSM_BLOCK
    t_all = t_pre + t_dec
    cpu = torch.device("cpu")
    for name in SSM_ARCHS:
        bcfg = dataclasses.replace(ssm_config(name), dtype="float32")

        def block(p, x, where, bcfg=bcfg):
            cache = ssm.init_ssm_cache(bcfg, bsz, where)
            outs = [ssm.mamba_apply(p, x[:, :t_pre], bcfg, cache=cache)[0]]
            for i in range(t_pre, t_all):
                outs.append(ssm.mamba_apply(p, x[:, i:i + 1], bcfg, cache=cache)[0])
            return torch.cat(outs, 1), cache

        with torch.inference_mode():
            bp = ssm.mamba_init(torch.Generator(device=dev).manual_seed(11), bcfg, dev)
            x = torch.randn(bsz, t_all, bcfg.d_model, generator=gen).to(dev)
            launch.reset_launches()
            got, got_cache = block(bp, x, dev)
            sync()
            if launch.LAUNCHES:
                fail(f"ssm block {name}: launched {dict(launch.LAUNCHES)}")
            want, want_cache = block(tree_map(lambda w, _: w.to(cpu), bp), x.cpu(), cpu)
            errs = {"prefill": rel(got[:, :t_pre].cpu(), want[:, :t_pre], name),
                    "decode": rel(got[:, t_pre:].cpu(), want[:, t_pre:], name),
                    **{f"cache {k}": rel(got_cache[k].cpu(), want_cache[k], name)
                       for k in ssm.STATE}}
            if max(errs.values()) > SSM_BLOCK_TOL:
                fail(f"ssm block {name}: card vs CPU max-abs-err/max-abs {errs} "
                     f"(limit {SSM_BLOCK_TOL})")
            print(f"ssm block ({name} widths: d {bcfg.d_model}, "
                  f"{ssm._dims(bcfg)[1]} heads of {bcfg.ssm.head_dim}, d_state "
                  f"{bcfg.ssm.d_state}; batch {bsz}, prefill {t_pre} + {t_dec} "
                  f"recurrent steps, fp32): card vs CPU max-abs-err/max-abs "
                  + ", ".join(f"{k} {v:.3g}" for k, v in errs.items())
                  + f" (limit {SSM_BLOCK_TOL}) ({card})")
            del got, want, got_cache, want_cache

            # the same block in bf16 (A_log, D, dt_bias fp32), timed as graph
            # replays: a prefill into a cache and one recurrent step
            hcfg = dataclasses.replace(bcfg, dtype="bfloat16")
            hp = {k: w if k in ("A_log", "D", "dt_bias")
                  else tree_map(lambda t, _: t.to(torch.bfloat16), w)
                  for k, w in bp.items()}
            xh = x.to(torch.bfloat16)
            del bp, x
            cache = ssm.init_ssm_cache(hcfg, bsz, dev)
            sizes = []
            tree_map(lambda w, _: sizes.append(w.numel() * w.element_size()), hp)
            w_bytes = sum(sizes)
            s_bytes = sum(t.numel() * t.element_size() for t in cache.values())
            scores, ssd32 = ssd_flops(hcfg, bsz, t_pre)
            n_proj = sum(hp[k]["w"].numel() for k in ("wx", "wz", "wbc", "wdt", "wo"))
            pre_ops = (bound(2.0 * n_proj * bsz * t_pre + scores, 0, torch.bfloat16)[0]
                       + bound(ssd32, 0, torch.float32)[0])
            timed = {
                "prefill_ms": graph_ms(lambda: ssm.mamba_apply(
                    hp, xh[:, :t_pre], hcfg, cache=cache), calls=5),
                "prefill_bound_ms": max(pre_ops, 1e3 * (w_bytes + s_bytes)
                                        / HBM_BYTES_PER_S),
                "decode_ms": graph_ms(lambda: ssm.mamba_apply(
                    hp, xh[:, -1:], hcfg, cache=cache)),
                "decode_bound_ms": 1e3 * (w_bytes + 2 * s_bytes) / HBM_BYTES_PER_S}
            print(f"ssm block bf16 ({name} widths, batch {bsz}, prefill {t_pre}, "
                  f"graph replays): " + " ".join(f"{k}={v:.4g}" for k, v in timed.items())
                  + f" (prefill bound: operations, decode bound: bytes) ({card})")
            del hp, xh, cache
        if on_card:
            torch.cuda.empty_cache()

    # (e) the flash kernel at Jamba's attention: 32 q heads over 8 kv heads
    jamba = ssm_config("jamba-v0.1-52b")
    counts = served["jamba-v0.1-52b"]
    rows = flash_rows(torch, dev, card, "jamba", jamba, (batch, prompt, cap_len),
                      {"prefill": counts["flash_attention"]
                       - counts["flash_attention/combine"],
                       "decode": counts["flash_attention/combine"]},
                      gen, graph_ms, time_ms, bound)
    return {"counts": served, "flash": rows}


# 4k: cross-attention, the encoder and the modality inputs: SeamlessM4T at
#     its published widths and depth, Llama-3.2-Vision at its published
#     widths reduced to LLAMA_PERIODS periods
CROSS_ARCHS = ("seamless-m4t-large-v2", "llama-3.2-vision-90b")
CROSS_SMOKE = False                  # True only in a CPU rehearsal
LLAMA_PERIODS = 5                    # of 20: 47.0 of 175.3 GB of bf16 weights
CROSS_BLOCK = (2, 128, 2)            # batch, prefill tokens, decode steps
CROSS_FRAMES = 1000                  # the block's encoder frames: ragged
CROSS_BLOCK_TOL = 1e-3
CROSS_GATE_SEED = 29
#: phase 4k's flash rows, bf16, against the plain version and against SDPA
#: in fp32 on the same inputs: elementwise, and the relative L2 error
#: ||got - want|| / ||want||. Set from the error that bf16 rounding gives
#: at these shapes (about 2.4e-3 relative, 2e-3 absolute), so that a kernel
#: that left the ragged case's 24 padded keys unmasked (1.4e-2 relative,
#: under the elementwise limit) or dropped a block of 128 keys (above 0.25)
#: fails (tests/test_torch_cross.py holds the check to that on the CPU)
CROSS_FLASH_TOL = {"rtol": 1e-2, "atol": 4e-3}
CROSS_FLASH_REL = 5e-3
CROSS_PARTS = {"layers": {"cross_apply": "cross/attn"},
               "steps": {"encode": "cross/encoder"},
               "ops": {"gqa_flash_attention": "cross/flash"}}


def flash_disagreement(torch, got, want) -> str | None:
    """Why ``got`` is not ``want`` at phase 4k's flash limits
    (`CROSS_FLASH_TOL`, `CROSS_FLASH_REL`), or None where it is."""
    got, want = got.float(), want.float()
    err = (got - want).abs().max().item()
    rel = ((got - want).norm() / want.norm()).item()
    if not torch.allclose(got, want, **CROSS_FLASH_TOL):
        return f"max abs err {err:.4g} over rtol/atol {CROSS_FLASH_TOL}"
    if not rel <= CROSS_FLASH_REL:
        return f"relative L2 err {rel:.4g} over {CROSS_FLASH_REL}"
    return None


def cross_config(name: str):
    """The config phase 4k runs: the published one (the smoke one in a CPU
    rehearsal), Llama-3.2-Vision cut to ``LLAMA_PERIODS`` periods."""
    from repro_torch.configs import get_config, get_smoke

    cfg = (get_smoke if CROSS_SMOKE else get_config)(name)
    if name == "llama-3.2-vision-90b":
        cfg = dataclasses.replace(cfg, n_periods=min(cfg.n_periods, LLAMA_PERIODS))
    return cfg


def set_gates(torch, layers: list, seed: int) -> list[float]:
    """Every cross layer's tanh gate set in place to a seeded value in [0.3,
    1.0): the reference's init (0) would hide cross-attention from every
    check. Returns the values."""
    gen = torch.Generator(device="cpu").manual_seed(seed)
    values = []
    for layer in layers:
        if "cross" in layer:
            values.append(0.3 + 0.7 * torch.rand((), generator=gen).item())
            layer["cross"]["gate"].fill_(values[-1])
    return values


def cross_layers(cfg) -> tuple[int, int, int]:
    """(encoder layers, self-attention layers, cross-attention layers)."""
    from repro_torch.models.transformer import layer_kinds

    mixers = [mixer for mixer, _ in layer_kinds(cfg)]
    return (cfg.encoder.n_layers if cfg.encoder else 0,
            sum(m in ("attn", "attn+cross") for m in mixers),
            sum(m in ("cross", "attn+cross") for m in mixers))


def cross_on_card(torch, dev, card: str, graph_ms, time_ms, bound) -> dict:
    """Phase 4k. (a) `launch.serve` serves SeamlessM4T at full width and
    depth (24 encoder layers, 24 "attn+cross" decoder layers) and
    Llama-3.2-Vision at full width reduced to ``LLAMA_PERIODS`` periods
    (4 self-attention layers and a "cross" layer a period), bf16, seeded
    weights with every gate set nonzero (`set_gates`), ``MOE_SERVE`` as in
    phase 4h, the batch's frames or vision tokens from
    `data.make_extra_inputs`: every step a graph replay (counted), every
    step of batch 0 equal to the eager steps bit for bit; a prefill
    launches the flash kernel once an encoder, self- and cross-attention
    layer, a decode step split_kv and its combine once a self- and
    cross-attention layer. (b) A fresh compiled prefill serves batch 0's
    prompts with the served extras (logits equal to the served ones) and
    then with others (logits that differ, equal to the eager step's), and
    decode steps on the new cross caches equal the eager ones, each call
    counted; device busy, wall and idle share and the top kernels of a
    compiled prefill and decode step, the encoder's, cross-attention's and
    the flash calls' device ms from the eager steps; peak memory; the
    decode's bytes bound and the prefill's operations bound. (c) The first
    layers (seamless: one encoder layer over ``CROSS_FRAMES`` frames and
    one decoder layer; Llama: its first period, 4 self-attention layers and
    the cross layer) in fp32 at full width: a prefill of ``CROSS_BLOCK[1]``
    tokens and ``CROSS_BLOCK[2]`` decode steps through the caches, on the
    card against the CPU. (d) The flash kernel at the slice's new shapes
    (`cross_flash_rows`). Returns each arch's launch counts and the rows of
    (d)."""
    from unittest import mock

    from repro_torch.data import make_extra_inputs
    from repro_torch.kernels import launch, ops
    from repro_torch.launch import graph, serve
    from repro_torch.models import layers, transformer
    from repro_torch.models import steps as model_steps

    requests, batch, prompt, gen_len = MOE_SERVE
    n_batches = -(-requests // batch)
    cap_len = prompt + gen_len
    on_card = dev.type == "cuda"
    gen = torch.Generator(device="cpu").manual_seed(17)
    modules = {"layers": layers, "steps": model_steps, "ops": ops}

    def sync():
        card_sync(torch, dev)

    def rel(got, want, what) -> float:
        return rel_err(torch, got, want, what)

    def flash_counts(n_enc: int, n_self: int, n_cross: int, prefills: int,
                     decodes: int) -> dict:
        out = {"flash_attention": (n_enc + n_self + n_cross) * prefills
               + (n_self + n_cross) * decodes,
               "flash_attention/combine": (n_self + n_cross) * decodes}
        return {k: v for k, v in out.items() if v}

    def gated_init(cfg, *, seed: int = 0, device="cuda"):
        params = transformer.init_lm(cfg, seed=seed, device=device)
        set_gates(torch, params["layers"], CROSS_GATE_SEED)
        return params

    served = {}
    for name in CROSS_ARCHS:
        cfg = cross_config(name)
        n_enc, n_self, n_cross = cross_layers(cfg)
        sync()
        base_gb = 0.0
        if on_card:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(dev)
            base_gb = torch.cuda.memory_allocated(dev) / 1e9
        record: dict = {}
        replays = []
        replay = graph.CapturedStep.replay

        def counted_replay(self, _replay=replay, _replays=replays):
            _replays.append(self)
            return _replay(self)

        launch.reset_launches()
        with mock.patch.object(graph.CapturedStep, "replay", counted_replay), \
                mock.patch.object(serve, "get_config", cross_config), \
                mock.patch.object(serve, "get_smoke", cross_config), \
                mock.patch.object(serve, "init_lm", gated_init):
            report = serve.main(["--arch", name, "--requests", str(requests),
                                 "--batch", str(batch), "--prompt-len", str(prompt),
                                 "--gen-len", str(gen_len), "--device", dev.type],
                                record=record)
        sync()
        counts = dict(launch.LAUNCHES)
        expect = flash_counts(n_enc, n_self, n_cross, n_batches,
                              n_batches * (gen_len - 1))
        if counts != expect:
            fail(f"cross serve {name}: launched {counts}, expected {expect} "
                 f"({n_enc} encoder, {n_self} self- and {n_cross} "
                 f"cross-attention layers, {n_batches} prefills)")
        if on_card and len(replays) != n_batches * gen_len:
            fail(f"cross serve {name}: {len(replays)} graph replays, expected "
                 f"{n_batches * gen_len} (a prefill and {gen_len - 1} decodes a batch)")
        peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9 if on_card else 0.0
        params, extras = record["params"], record["extras"]
        gates = [float(l["cross"]["gate"]) for l in params["layers"] if "cross" in l]
        if not gates or min(abs(g) for g in gates) == 0:
            fail(f"cross serve {name}: gates {gates}")
        n_params = transformer.count_params(cfg)
        mem_len = next(iter(extras.values())).shape[1]
        reduced = ("" if name != "llama-3.2-vision-90b" else
                   f", reduced to {cfg.n_periods} of 20 periods")
        print(f"cross serve ({name}, {cfg.n_layers} decoder layers{reduced}: "
              f"{n_enc} encoder, {n_self} self-attention, {n_cross} "
              f"cross-attention ({cfg.n_heads}/{cfg.n_kv_heads} heads of "
              f"{cfg.hd}), d {cfg.d_model}, ff {cfg.d_ff}, {cfg.norm}, "
              f"{cfg.act}, {cfg.dtype}, {n_params} parameters; memory "
              f"{', '.join(f'{k} {tuple(v.shape)}' for k, v in extras.items())}; "
              f"gates {min(gates):.3f}-{max(gates):.3f}): launches {counts}; "
              f"{len(replays)} graph replays; report {json.dumps(report)}; peak "
              f"memory {peak_gb:.3f} GB ({base_gb:.3f} GB before) ({card})")

        b0 = record["batches"][0]
        prefill_e, decode_e = served_equal_eager(torch, cfg, params, b0, cap_len,
                                                 name, extras)

        # (b) a fresh compiled prefill on the served extras and on others,
        #     decode steps on the new cross caches, each call counted
        prefill_c = graph.compile_prefill(model_steps.make_prefill_step(cfg, cap_len))
        decode_c = graph.compile_decode(model_steps.make_decode_step(cfg))
        other = {k: torch.randn(v.shape, generator=gen).to(dev, v.dtype)
                 for k, v in extras.items()}
        tok = b0["tokens"][:, :1]
        rows = {}
        with torch.inference_mode():
            launch.reset_launches()
            first, _ = prefill_c(params, {"tokens": b0["prompts"], **extras})
            sync()
            pre_counts = dict(launch.LAUNCHES)
            if pre_counts != flash_counts(n_enc, n_self, n_cross, 1, 0):
                fail(f"cross {name} compiled prefill launched {pre_counts}")
            if not torch.equal(first, b0["logits"][:, 0]):
                fail(f"cross {name}: the compiled prefill's logits differ from "
                     f"the served ones on the same request")
            swapped, caches = prefill_c(params, {"tokens": b0["prompts"], **other})
            want, want_caches = prefill_e(params, {"tokens": b0["prompts"], **other})
            if torch.equal(swapped, first) or not torch.equal(swapped, want):
                fail(f"cross {name}: the prefill on other extras is "
                     f"{'the first one' if torch.equal(swapped, first) else 'not the eager step'}"
                     f" (max-abs-err/max-abs {rel(swapped, want, name):.3g})")
            step_counts = []
            for i in range(3):
                launch.reset_launches()
                got, caches = decode_c(params, caches, b0["tokens"][:, i:i + 1])
                sync()
                step_counts.append(dict(launch.LAUNCHES))
                want, want_caches = decode_e(params, want_caches,
                                             b0["tokens"][:, i:i + 1])
                if not torch.equal(got, want):
                    fail(f"cross {name}: decode step {i} on the other extras' "
                         f"caches differs from the eager step")
            if any(c != flash_counts(0, n_self, n_cross, 0, 1) for c in step_counts):
                fail(f"cross {name} compiled decode steps launched {step_counts}")
            print(f"cross extras swap ({name}): batch 0's prompts with the served "
                  f"{'/'.join(extras)} give the served prefill logits, with others "
                  f"logits that differ (max-abs-diff/max-abs "
                  f"{rel(first, swapped, name):.3g}) and equal the eager step's bit "
                  f"for bit, as do 3 decode steps on the new cross caches; launches "
                  f"a prefill {pre_counts}, a decode step {step_counts[0]} ({card})")
            del want_caches

            batch0 = {"tokens": b0["prompts"], **extras}
            for step, fn in (("prefill", lambda: prefill_c(params, batch0)),
                             ("decode", lambda: decode_c(params, caches, tok))):
                rows[(step, "compiled")] = profiled_parts(torch, dev, fn, (), top=6)
                rows[(step, "compiled")]["wall"] = median_wall_ms(torch, dev, fn)
            eager_caches = {}
            patches = [p for mod, parts in CROSS_PARTS.items()
                       for p in scoped_parts(torch, modules[mod], parts)]
            for patch in patches:
                patch.start()
            try:
                rows[("prefill", "eager")] = profiled_parts(
                    torch, dev, lambda: eager_caches.update(
                        c=prefill_e(params, batch0)[1]), ("cross/",))
                rows[("decode", "eager")] = profiled_parts(
                    torch, dev, lambda: decode_e(params, eager_caches["c"], tok),
                    ("cross/",))
            finally:
                for patch in patches:
                    patch.stop()
            del caches, eager_caches

        # the bounds: decode reads every weight it uses once (not the
        # encoder's, not the cross layers' wk and wv, whose keys and values
        # are cached, not the embedding's unread rows), the self-attention
        # caches up to the first decode's position and the cross caches;
        # prefill does every weight's products on its tokens (the cross
        # layers' wk and wv on the memory, the encoder's on the frames), the
        # attention's on every prompt position, and the head's on the last
        # position only: the step returns the last position's logits (the
        # port, as the reference, runs the head on every position)
        elem = params["embed"]["w"].element_size()
        d, hq, hkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd

        def numel(tree) -> int:
            sizes = []
            tree_map(lambda w, _: sizes.append(w.numel()), tree)
            return sum(sizes)

        enc_n = sum(numel(params[k]) for k in ("enc_proj", "enc_layers", "enc_norm")
                    if k in params)
        cross_kv_n = sum(numel(l["cross"][w]) for l in params["layers"]
                         if "cross" in l for w in ("wk", "wv"))
        table = cfg.padded_vocab * d
        unread = 0 if cfg.tie_embed else table - batch * d
        weight_bytes = (n_params - enc_n - cross_kv_n) * elem - unread * elem
        self_kv = n_self * 2 * batch * hkv * (prompt + 1) * hd * elem
        cross_kv = n_cross * 2 * batch * hkv * mem_len * hd * elem
        dec_n = n_params - enc_n - cross_kv_n - (0 if cfg.tie_embed else table)
        f_pre = (2.0 * (dec_n - table) * batch * prompt + 2.0 * table * batch
                 + 2.0 * cross_kv_n * batch * mem_len
                 + 2.0 * enc_n * batch * mem_len
                 + n_self * 2.0 * batch * hq * prompt * prompt * hd
                 + n_enc * 4.0 * batch * hq * mem_len * mem_len * hd
                 + n_cross * 4.0 * batch * hq * prompt * mem_len * hd)
        bounds = {"decode": 1e3 * (weight_bytes + self_kv + cross_kv) / HBM_BYTES_PER_S,
                  "prefill": max(bound(f_pre, 0, torch.bfloat16)[0],
                                 1e3 * n_params * elem / HBM_BYTES_PER_S)}
        print(f"cross step bounds ({name}, batch {batch}): decode "
              f"{bounds['decode']:.3f} ms (bytes: {weight_bytes / 1e9:.3f} GB of "
              f"weights, not the encoder's {enc_n * elem / 1e9:.3f} GB nor the "
              f"cross wk/wv's {cross_kv_n * elem / 1e9:.3f} GB; self-attention "
              f"caches at {prompt + 1} keys {self_kv / 1e9:.4f} GB; cross caches of "
              f"{mem_len} keys {cross_kv / 1e9:.4f} GB); prefill "
              f"{bounds['prefill']:.3f} ms (operations: {f_pre / 1e12:.2f} TFLOP "
              f"bf16: the weights' products, causal self-, non-causal encoder and "
              f"cross-attention, the head on the last position only) ({card})")
        for (step, mode), row in rows.items():
            busy = max(row["busy"], 1e-9)
            parts = ""
            if mode == "eager":
                parts = "; " + ", ".join(
                    f"{label} {row.get(label, 0.0):.3f} ms "
                    f"({row.get(label, 0.0) / busy:.3f} of busy)"
                    for parts in CROSS_PARTS.values() for label in parts.values())
            wall = ""
            if "wall" in row:
                wall = (f", wall {row['wall']:.3f} ms (median of 5), idle share "
                        f"{1 - row['busy'] / max(row['wall'], 1e-9):.3f}")
            print(f"cross profile ({name}, {step}, {mode}, batch {batch}): device "
                  f"busy {row['busy']:.3f} ms (kernel events){wall}{parts}; "
                  f"bound {bounds[step]:.3f} ms ({card})")
            for ms, calls, kname in row.get("top", ()):
                print(f"  cross {name} {step} {mode} device time {ms:.3f} ms in "
                      f"{calls} calls: {kname}")
        served[name] = {"counts": counts, "report": report, "peak_gb": peak_gb,
                        "bounds": bounds}
        del prefill_c, decode_c, record, b0, params, extras, other
        del prefill_e, decode_e, batch0, first, swapped, got, want
        if on_card:
            torch.cuda.empty_cache()

    # (c) the first layers in fp32 at full width, card against CPU: a
    #     prefill through the caches (the encoder's frames ragged), then
    #     decode steps that read them
    bsz, t_pre, t_dec = CROSS_BLOCK
    t_all = t_pre + t_dec
    cpu = torch.device("cpu")
    for name in CROSS_ARCHS:
        cfg = cross_config(name)
        bcfg = dataclasses.replace(
            cfg, dtype="float32", n_periods=1,
            encoder=cfg.encoder and dataclasses.replace(cfg.encoder, n_layers=1))
        n_enc, n_self, n_cross = cross_layers(bcfg)
        kinds = transformer.layer_kinds(bcfg)
        mem_len = CROSS_FRAMES if bcfg.encoder else bcfg.n_vision_tokens

        def block(p, x, extra, where, bcfg=bcfg, kinds=kinds):
            memory = (transformer.encode(p, bcfg, extra) if bcfg.encoder else extra)
            caches = transformer.init_caches(bcfg, bsz, t_all, mem_len=mem_len,
                                             device=where)["layers"]
            h = x[:, :t_pre]
            positions = torch.arange(t_pre, device=where)
            for lp, c in zip(p["layers"], caches):
                h, _, _ = transformer._layer_apply(
                    lp, h, bcfg, positions=positions, cache=c, cache_pos=None,
                    start=0, memory=memory)
            outs = [h]
            for i in range(t_pre, t_all):
                pos = torch.full((), i, dtype=torch.int32, device=where)
                h = x[:, i:i + 1]
                for lp, c in zip(p["layers"], caches):
                    h, _, _ = transformer._layer_apply(
                        lp, h, bcfg, positions=pos + torch.arange(1, device=where),
                        cache=c, cache_pos=pos, start=None)
                outs.append(h)
            return memory, torch.cat(outs, 1), caches

        with torch.inference_mode():
            bgen = torch.Generator(device=dev).manual_seed(23)
            bp = {"layers": [transformer._layer_init(bgen, bcfg, mixer, ffn, dev)
                             for mixer, ffn in kinds]}
            if bcfg.encoder:
                bp["enc_proj"] = layers.dense_init(bgen, bcfg.encoder.frontend_dim,
                                                   bcfg.d_model, torch.float32, dev)
                bp["enc_layers"] = [transformer._layer_init(bgen, bcfg, "attn",
                                                            "dense", dev)]
                bp["enc_norm"] = layers.norm_init(bcfg.d_model, torch.float32, dev,
                                                  bcfg.norm)
            set_gates(torch, bp["layers"], CROSS_GATE_SEED + 1)
            x = torch.randn(bsz, t_all, bcfg.d_model, generator=gen).to(dev)
            extra = torch.randn(bsz, mem_len, bcfg.encoder.frontend_dim
                                if bcfg.encoder else bcfg.d_model, generator=gen).to(dev)
            launch.reset_launches()
            got_mem, got, got_caches = block(bp, x, extra, dev)
            sync()
            counts = dict(launch.LAUNCHES)
            want_mem, want, want_caches = block(
                tree_map(lambda w, _: w.to(cpu), bp), x.cpu(), extra.cpu(), cpu)
            errs = {"memory": rel(got_mem.cpu(), want_mem, name),
                    "prefill": rel(got[:, :t_pre].cpu(), want[:, :t_pre], name),
                    "decode": rel(got[:, t_pre:].cpu(), want[:, t_pre:], name),
                    "cross caches": max(rel(g[n].cpu(), w[n], name)
                                        for g, w in zip(got_caches, want_caches)
                                        for n in (layers.CROSS_K, layers.CROSS_V)
                                        if n in g)}
            calls = n_enc + n_self + n_cross
            expect = {"flash_attention": calls + t_dec * (n_self + n_cross),
                      "flash_attention/pack": calls,
                      "flash_attention/combine": t_dec * (n_self + n_cross)}
            if on_card and counts != expect:
                fail(f"cross block {name}: launched {counts}, expected {expect} "
                     f"(tc_3xtf32 and its pack a prefill call, split_kv and its "
                     f"combine a decode call)")
            if max(errs.values()) > CROSS_BLOCK_TOL:
                fail(f"cross block {name}: card vs CPU max-abs-err/max-abs {errs} "
                     f"(limit {CROSS_BLOCK_TOL})")
            print(f"cross block ({name}, the first layers {[m + '+' + f for m, f in kinds]}"
                  + (f" after {n_enc} encoder layer over {mem_len} frames (ragged)"
                     if n_enc else f" over {mem_len} vision tokens")
                  + f", full width, fp32, batch {bsz}, prefill {t_pre} + {t_dec} "
                  f"decode steps): card vs CPU max-abs-err/max-abs "
                  + ", ".join(f"{k} {v:.3g}" for k, v in errs.items())
                  + f" (limit {CROSS_BLOCK_TOL}); launches {counts} ({card})")
            del bp, x, extra, got, want, got_mem, want_mem, got_caches, want_caches
        if on_card:
            torch.cuda.empty_cache()

    # (d) the flash kernel at the slice's new shapes
    rows = cross_flash_rows(torch, dev, card, gen, graph_ms, time_ms, bound)
    return {"counts": {k: v["counts"] for k, v in served.items()}, "flash": rows}


def cross_flash_rows(torch, dev, card: str, gen, graph_ms, time_ms,
                     bound) -> dict:
    """The flash kernel at phase 4k's shapes, bf16, each against its plain
    version, timed beside SDPA (the kv heads repeated to the q heads
    beforehand) and the card's bound: SeamlessM4T's encoder (B 4, 16/16
    heads, d 64, 1024 frames, not causal; tc_bf16); Llama-3.2-Vision's
    cross-attention prefill (B 4, 64/8 heads, d 128, 1024 queries over the
    1664 vision keys, not causal; tc_bf16) and decode (one query over the
    1664 keys: split_kv with the valid length on the device, as the served
    decode runs it, and the one-pass body an integer call takes); and one
    ragged non-causal shape, 1000 queries over 1000 keys at the encoder's
    heads, run as ``ops.gqa_flash_attention`` runs it: causal at q_offset
    1000, the 24 padded keys masked. ``launches`` are each case's counts on
    the served path."""
    from repro_torch.kernels import flash_attention

    on_card = dev.type == "cuda"
    requests, batch, prompt, gen_len = MOE_SERVE
    n_batches = -(-requests // batch)
    seam, llama = (cross_config(n) for n in CROSS_ARCHS)
    n_enc, _, seam_cross = cross_layers(seam)
    _, _, llama_cross = cross_layers(llama)
    sm = llama.n_vision_tokens
    cases = {
        "encoder prefill": (seam, prompt, prompt, dict(causal=False), "tc_bf16",
                            n_enc * n_batches),
        "cross prefill": (llama, prompt, sm, dict(causal=False), "tc_bf16",
                          llama_cross * n_batches),
        "cross decode, split_kv": (llama, 1, sm, dict(causal=False, device_pos=True),
                                   "split_kv", llama_cross * n_batches * (gen_len - 1)),
        "cross decode, one pass": (llama, 1, sm, dict(causal=False), "tc_bf16", 0),
        "ragged non-causal": (seam, CROSS_FRAMES, CROSS_FRAMES,
                              dict(causal=True, q_offset=CROSS_FRAMES), "tc_bf16", 0)}
    rows = {}
    for case, (cfg, sq, skv, kw, body, n_launch) in cases.items():
        hq, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
        fp = flash_attention.flash_launch_plan(
            bh=batch * hq, sq=sq, skv=skv, d=hd, kv_group=hq // hkv,
            dtype=torch.bfloat16, **kw)
        if on_card and fp.body != body:
            fail(f"flash at {case}: body {fp.body}, expected {body}")
        q = torch.randn(batch * hq, sq, hd, generator=gen).to(dev, torch.bfloat16)
        k, v = (torch.randn(batch * hkv, skv, hd, generator=gen)
                .to(dev, torch.bfloat16) for _ in range(2))
        extra = ({"pos": torch.tensor([0, skv], dtype=torch.int32, device=dev)}
                 if kw.get("device_pos") else {})
        pq = fp.inputs[0].array_shape[1] - sq
        qp = torch.nn.functional.pad(q, (0, 0, 0, pq)).contiguous()
        kp, vp = (torch.nn.functional.pad(
            t, (0, 0, 0, fp.inputs[1].array_shape[1] - skv)).contiguous()
            for t in (k, v))
        call = fp.cuda if on_card else fp.plain
        got, want = call(qp, kp, vp, **extra), fp.plain(qp, kp, vp, **extra)
        got, want = got[:, :sq], want[:, :sq]
        err = (got.float() - want.float()).abs().max().item()
        rel = ((got.float() - want.float()).norm() / want.float().norm()).item()
        why = flash_disagreement(torch, got, want)
        if why:
            fail(f"flash at {case}, against the plain version: {why}")
        q4 = q.view(batch, hq, sq, hd)
        k4, v4 = (t.view(batch, hkv, skv, hd) for t in (k, v))
        kr, vr = (t.repeat_interleave(hq // hkv, dim=1) for t in (k4, v4))
        exact = torch.nn.functional.scaled_dot_product_attention(
            q4.float(), kr.float(), vr.float())
        why = flash_disagreement(torch, got.reshape(batch, hq, sq, hd), exact)
        if why:
            fail(f"flash at {case}: the kernel is not non-causal attention over "
                 f"the {skv} real keys (fp32 SDPA on the same inputs): {why}")
        rel_sdpa = ((got.float().reshape(batch, hq, sq, hd) - exact).norm()
                    / exact.norm()).item()
        del exact
        flops = 4.0 * batch * hq * sq * skv * hd
        b_ms, b_by = bound(flops, 2 * (2 * q.numel() + k.numel() + v.numel()),
                           torch.bfloat16)
        rows[case] = row = {
            "body": fp.body, "max_abs_err": err, "rel_err": rel,
            "rel_err_fp32_sdpa": rel_sdpa,
            "ms": graph_ms(lambda: call(qp, kp, vp, **extra)),
            "plain_ms": time_ms(lambda: fp.plain(qp, kp, vp, **extra)),
            "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": graph_ms(
                lambda: torch.nn.functional.scaled_dot_product_attention(q4, kr, vr)),
            "launches": n_launch}
        print(f"cross flash {case} bf16 (B {batch}, {hq}/{hkv} heads, d {hd}, "
              f"Sq {sq}, Skv {skv}" + (", device position" if extra else "")
              + f"): " + " ".join(
                  f"{k}={v:.4g}" if isinstance(v, float) else f"{k}={v}"
                  for k, v in row.items()) + f" ({card})")
        del q, k, v, qp, kp, vp, q4, k4, v4, kr, vr, got, want
    return rows


# 4l: training on one card, Qwen2-1.5B at its published widths and depth
TRAIN_ARCH = "qwen2-1.5b"
TRAIN_SMOKE = False                  # True only in a CPU rehearsal
TRAIN_ATTN = (2, 1024, 1000)         # batch, tokens, the ragged case's tokens
TRAIN_RUN = (4, 8, 1024)             # steps, batch, tokens
TRAIN_LR = 1e-3
TRAIN_LAYER = (2, 256)               # the fp32 layer's batch and tokens
TRAIN_LAYER_TOL = 1e-3
TRAIN_SMOKE_ARCHS = ("qwen2-1.5b", "qwen2-moe-a2.7b", "deepseek-v2-lite-16b",
                     "mamba2-1.3b", "seamless-m4t-large-v2")
TRAIN_SMOKE_RUN = (8, 4, 64, 5e-3)   # steps, batch, tokens, lr
TRAIN_RESUME_STEPS = 4               # steps past the checkpoint
TRAIN_PARTS = {"update": "train/adamw"}


def train_attention_rows(torch, dev, card: str, time_ms) -> dict:
    """Phase 4l (a): `layers.attention` with a gradient (the
    `FlashAttention` Function), bf16, at Qwen2-1.5B's attention (B 2, 12/2
    heads of 128, causal), a ragged non-causal call (1000 x 1000, which the
    flash wrapper runs as causal at q_offset 1000) and MLA's q/k 192, v 128
    (16/16 heads). Each: one `flash_attention` launch in the forward and
    none in the backward; the forward held against `chunked_attention`'s
    output by `flash_disagreement`; given the same upstream gradient, dq,
    dk and dv equal those of autograd through `chunked_attention` on the
    card bit for bit; the forward, the backward and autograd through
    `chunked_attention` timed."""
    from repro_torch.kernels import launch
    from repro_torch.models import layers

    batch, tokens, ragged = TRAIN_ATTN
    gen = torch.Generator(device="cpu").manual_seed(41)
    cases = {
        "causal": (12, 2, tokens, tokens, 128, 128, True),
        "ragged non-causal": (12, 2, ragged, ragged, 128, 128, False),
        "mla 192/128": (16, 16, tokens, tokens, 192, 128, True)}
    rows = {}
    for case, (hq, hkv, sq, skv, d, dv, causal) in cases.items():
        def draw(*shape):
            return torch.randn(shape, generator=gen).to(dev, torch.bfloat16)

        q0, k0, v0 = draw(batch, hq, sq, d), draw(batch, hkv, skv, d), \
            draw(batch, hkv, skv, dv)
        g = draw(batch, hq, sq, dv)

        def run(fn):
            q, k, v = (t.clone().requires_grad_() for t in (q0, k0, v0))
            out = fn(q, k, v, causal=causal, chunk=1024)
            out.backward(g)
            return out.detach(), [t.grad for t in (q, k, v)]

        card_sync(torch, dev)
        launch.reset_launches()
        q, k, v = (t.clone().requires_grad_() for t in (q0, k0, v0))
        out = layers.attention(q, k, v, causal=causal, chunk=1024)
        card_sync(torch, dev)
        fwd_counts = dict(launch.LAUNCHES)
        out.backward(g)
        card_sync(torch, dev)
        bwd_counts = {n: c - fwd_counts.get(n, 0)
                      for n, c in launch.LAUNCHES.items()
                      if c != fwd_counts.get(n, 0)}
        if fwd_counts != {"flash_attention": 1} or bwd_counts:
            fail(f"train attention {case}: forward launched {fwd_counts}, "
                 f"backward {bwd_counts}; expected one flash_attention and none")
        grads = [t.grad for t in (q, k, v)]
        want_out, want_grads = run(layers.chunked_attention)
        why = flash_disagreement(torch, out.detach(), want_out)
        if why:
            fail(f"train attention {case}: the forward against "
                 f"chunked_attention's: {why}")
        for name, got, want in zip("qkv", grads, want_grads):
            if not torch.isfinite(got).all():
                fail(f"train attention {case}: d{name} not finite")
            if not torch.equal(got, want):
                fail(f"train attention {case}: d{name} differs from autograd "
                     f"through chunked_attention (max abs err "
                     f"{(got.float() - want.float()).abs().max().item():.3g})")
        q, k, v = (t.clone().requires_grad_() for t in (q0, k0, v0))

        def forward():
            with torch.no_grad():
                layers.attention(q, k, v, causal=causal)

        def backward():
            layers.FlashAttention.apply(q, k, v, causal, 0, None, 1024).backward(g)

        with launch.recording():
            rows[case] = row = {
                "forward_ms": time_ms(forward) if dev.type == "cuda" else 0.0,
                "function_ms": time_ms(backward) if dev.type == "cuda" else 0.0,
                "chunked_ms": (time_ms(lambda: run(layers.chunked_attention))
                               if dev.type == "cuda" else 0.0),
                "max_abs_err_fwd": (out.float() - want_out.float()).abs().max().item(),
                "grads_bit_for_bit": True}
        print(f"train attention {case} bf16 (B {batch}, {hq}/{hkv} heads, "
              f"q/k {d}, v {dv}, Sq {sq}, Skv {skv}, causal {causal}): 1 flash "
              f"launch forward, 0 backward; dq, dk, dv equal autograd through "
              f"chunked_attention bit for bit; " + " ".join(
                  f"{k}={v:.4g}" if isinstance(v, float) else f"{k}={v}"
                  for k, v in row.items()) + f" ({card})")
        del q0, k0, v0, g, q, k, v, out, grads, want_out, want_grads
    return rows


def train_config():
    """The config phase 4l trains: the published one (the smoke one in a
    CPU rehearsal)."""
    from repro_torch.configs import get_config, get_smoke

    return (get_smoke if TRAIN_SMOKE else get_config)(TRAIN_ARCH)


def train_on_card(torch, dev, card: str, time_ms, bound) -> dict:
    """Phase 4l. (a) `train_attention_rows`. (b) `launch.train` trains
    Qwen2-1.5B at full width and depth (28 layers, bf16, tied embedding)
    for ``TRAIN_RUN`` (4 steps of 8 x 1024 tokens, the config's 4
    microbatches of 2 x 1024 summed into fp32 gradient buffers), AdamW with
    fp32 master weights, in place: each step's loss, grad norm and wall,
    tokens/s, 112 `flash_attention` launches a step (28 layers x 4
    microbatches, none in the backward), losses finite, near ln(vocab) at
    first and falling; the final blocking checkpoint (about 21.6 GB) into a
    temporary directory under ``build/`` (its free space checked first),
    its bytes and write time, deleted afterwards; peak memory; one step
    profiled (device busy, the top kernels, the backward's attention and
    AdamW); the step's bound and the wall's share of it. (c) One layer of
    Qwen2-1.5B at full width in fp32: loss and every gradient leaf, the
    card against the CPU, within ``TRAIN_LAYER_TOL`` max-abs-err / max-abs.
    (d) One arch of each mixer kind at smoke size (`TRAIN_SMOKE_ARCHS`)
    trained on the card: losses falling, grad norms finite, the flash
    calls counted and the launches equal to what their plans launch (one
    more a call for split_kv's combine or tc_3xtf32's pack); the first
    resumed from its checkpoint. The launcher runs with its trainer set to
    log every step, so its history holds each step. Returns the
    launch counts and the rows of (a)."""
    import shutil
    import tempfile
    from unittest import mock

    from repro_torch import tree
    from repro_torch.configs import get_smoke
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.kernels import launch
    from repro_torch.launch import train
    from repro_torch.models import layers
    from repro_torch.models import steps as model_steps
    from repro_torch.models.transformer import count_params, init_lm
    from repro_torch.optim import adamw

    on_card = dev.type == "cuda"

    def every_step_logged():
        # the trainer's history keeps every step's loss, grad norm and wall
        return mock.patch.object(train, "TrainLoopConfig", functools.partial(
            train.TrainLoopConfig, log_every=1))

    def flash_bodies(bodies: list):
        # the body of each flash call's plan, in call order
        real = launch.run

        def spy(plan, *operands, **extra):
            if plan.name == "flash_attention":
                bodies.append(plan.body)
            return real(plan, *operands, **extra)
        return mock.patch.object(launch, "run", spy)

    out: dict = {"attention": train_attention_rows(torch, dev, card, time_ms)}

    # (b) Qwen2-1.5B, full width and depth, through the launcher
    cfg = train_config()
    steps, batch, seq = TRAIN_RUN
    n_params = count_params(cfg)
    mb = cfg.train_microbatches if batch % cfg.train_microbatches == 0 else 1
    build = ROOT / "build"
    build.mkdir(exist_ok=True)
    ckpt_gb = (n_params * (2 + 3 * 4) + 4) / 1e9
    free_gb = shutil.disk_usage(build).free / 1e9
    print(f"train checkpoint: {ckpt_gb:.3f} GB to write under {build}, "
          f"{free_gb:.1f} GB free there")
    if free_gb < 1.2 * ckpt_gb:
        fail(f"train checkpoint: {ckpt_gb:.3f} GB does not fit the "
             f"{free_gb:.1f} GB free under {build}")
    workdir = tempfile.mkdtemp(prefix="train_ckpt_", dir=build)
    try:
        card_sync(torch, dev)
        base_gb = 0.0
        if on_card:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(dev)
            base_gb = torch.cuda.memory_allocated(dev) / 1e9
        launch.reset_launches()
        record: dict = {}
        t0 = time.perf_counter()
        with every_step_logged():
            result = train.main([
                "--arch", TRAIN_ARCH, *(["--smoke"] if TRAIN_SMOKE else []),
                "--steps", str(steps), "--batch", str(batch), "--seq", str(seq),
                "--lr", str(TRAIN_LR), "--ckpt-dir",
                os.path.join(workdir, "main"), "--ckpt-every", str(10 * steps),
                "--device", dev.type], record=record)
        card_sync(torch, dev)
        run_s = time.perf_counter() - t0
        counts = dict(launch.LAUNCHES)
        peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9 if on_card else 0.0
        n_flash = (cfg.n_layers * mb) * steps
        if counts != {"flash_attention": n_flash}:
            fail(f"train: launched {counts}, expected {n_flash} flash_attention "
                 f"({cfg.n_layers} layers x {mb} microbatches x {steps} steps, "
                 f"none in the backward)")
        hist = result["history"]
        losses = [h["loss"] for h in hist]
        if (result["final_step"] != steps or len(hist) != steps
                or not all(math.isfinite(h["loss"]) and math.isfinite(h["grad_norm"])
                           for h in hist)):
            fail(f"train: {result['final_step']} steps, history {hist}")
        ln_v = math.log(cfg.padded_vocab)
        if abs(losses[0] - ln_v) > 1.0 or not losses[-1] < losses[0]:
            fail(f"train: losses {losses} do not start near ln(vocab) "
                 f"{ln_v:.3f} and fall")
        for h in hist:
            print(f"train step {h['step']}: loss {h['loss']:.6f} grad_norm "
                  f"{h['grad_norm']:.6f} wall {1e3 * h['dt_s']:.3f} ms")
        walls = sorted(h["dt_s"] for h in hist[1:]) or [hist[0]["dt_s"]]
        step_s = walls[len(walls) // 2]
        tok_s = batch * seq / step_s
        nbytes, write_s = record["trainer"].ckpt.last_write
        print(f"train (b) {cfg.name} full width and depth ({cfg.n_layers} layers, "
              f"{n_params:,} parameters, {cfg.dtype}): {steps} steps of {batch} x "
              f"{seq} tokens, {mb} microbatches of {batch // mb}; flash launches "
              f"{counts['flash_attention']} ({counts['flash_attention'] // steps} "
              f"a step); median step wall (steps 2-{steps}) {1e3 * step_s:.3f} ms, "
              f"{tok_s:.1f} tokens/s; first step {1e3 * hist[0]['dt_s']:.3f} ms; "
              f"launcher {run_s:.1f} s; peak memory {peak_gb:.3f} GB "
              f"({base_gb:.3f} GB before) ({card})")
        snap_s = record["trainer"].ckpt.last_snapshot_s
        print(f"train checkpoint (final, blocking): {nbytes:,} bytes "
              f"({nbytes / 1e9:.3f} GB): the host copy {snap_s:.2f} s, then "
              f"written in {write_s:.2f} s ({nbytes / 1e9 / max(write_s, 1e-9):.3f} "
              f"GB/s, the crc32s included; warm page cache, not synced)")
        out.update(counts=counts, losses=losses, step_ms=1e3 * step_s,
                   tokens_per_s=tok_s, peak_gb=peak_gb, ckpt_bytes=nbytes,
                   ckpt_s=write_s, ckpt_snapshot_s=snap_s)

        # one more step, profiled: device busy, the top kernels, the
        # backward's attention (recompute and grad) and AdamW
        trainer, step_fn = record["trainer"], record["step_fn"]
        b0 = record["batch_fn"](0)
        parts = scoped_parts(torch, adamw, TRAIN_PARTS)
        real_bwd = layers.FlashAttention.backward

        def bwd(ctx, grad_out):
            with torch.profiler.record_function("train/attn_backward"):
                return real_bwd(ctx, grad_out)

        parts.append(mock.patch.object(layers.FlashAttention, "backward",
                                       staticmethod(bwd)))
        for p in parts:
            p.start()
        try:
            def one_step():
                trainer.params, trainer.opt_state, _ = step_fn(
                    trainer.params, trainer.opt_state, b0)

            with launch.recording():
                prof = profiled_parts(torch, dev, one_step, ("train/",),
                                      top=100000)
            with launch.recording():
                wall_ms = median_wall_ms(torch, dev, one_step, calls=3)
        finally:
            for p in parts:
                p.stop()
        busy = prof["busy"]
        kinds = {"flash": 0.0, "gemm": 0.0, "other": 0.0}
        for ms, _, name in prof["top"]:
            kind = ("flash" if "flash" in name else "gemm" if any(
                w in name for w in ("gemm", "nvjet", "xmma", "cutlass"))
                else "other")
            kinds[kind] += ms
        n_kernels = sum(calls for _, calls, _ in prof["top"])
        print(f"train profile (one step, {batch} x {seq} tokens, {n_kernels} "
              f"kernel calls): device busy "
              f"{busy:.3f} ms (GEMMs {kinds['gemm']:.3f}, flash "
              f"{kinds['flash']:.3f}, other kernels {kinds['other']:.3f}), "
              f"unprofiled wall {wall_ms:.3f} ms (median of 3), idle share "
              f"{1 - busy / wall_ms if wall_ms else 0.0:.3f}; attention "
              f"backward {prof.get('train/attn_backward', 0.0):.3f} ms, AdamW "
              f"{prof.get('train/adamw', 0.0):.3f} ms ({card})")
        for ms, calls, name in prof["top"][:10]:
            print(f"train top kernel: {ms:.3f} ms in {calls} calls: {name}")
        # the bound: the dense work 6 N T, attention's forward and backward
        # (3 causal forwards, half the squares), then AdamW's bytes
        t_all = batch * seq
        attn_flops = 3 * 4.0 * batch * cfg.n_heads * seq * seq * cfg.hd / 2 \
            * cfg.n_layers
        dense_ms, _ = bound(6.0 * n_params * t_all + attn_flops, 0.0,
                            torch.bfloat16)
        adam_bytes = n_params * (4 + 3 * 8 + 2)
        adam_ms, _ = bound(0.0, adam_bytes, torch.bfloat16)
        step_bound = dense_ms + adam_ms
        print(f"train step bound: {dense_ms:.3f} ms of operations "
              f"({6.0 * n_params * t_all / 1e12:.2f} TFLOP dense + "
              f"{attn_flops / 1e12:.2f} TFLOP attention at the bf16 peak) + "
              f"{adam_ms:.3f} ms of AdamW bytes ({adam_bytes / 1e9:.2f} GB) = "
              f"{step_bound:.3f} ms; median wall {1e3 * step_s:.3f} ms, the "
              f"bound's share of it {step_bound / (1e3 * step_s):.3f}")
        out.update(busy_ms=busy, wall_ms=wall_ms, bound_ms=step_bound,
                   kinds=kinds, n_kernels=n_kernels,
                   attn_backward_ms=prof.get("train/attn_backward", 0.0),
                   adamw_ms=prof.get("train/adamw", 0.0))
        del record, trainer, step_fn, b0, result
        if on_card:
            torch.cuda.empty_cache()

        # (c) one layer at full width in fp32: the card against the CPU
        lcfg = dataclasses.replace(cfg, n_periods=1, dtype="float32")
        lb, ls = TRAIN_LAYER
        cpu = torch.device("cpu")
        p_cpu = init_lm(lcfg, seed=3, device=cpu)
        data = SyntheticLM(DataConfig(vocab=lcfg.vocab, seq_len=ls,
                                      global_batch=lb, seed=3))
        b_cpu = data.torch_batch(0, cpu)
        with launch.recording():
            loss_c, parts_c, g_c = model_steps.loss_and_grads(p_cpu, lcfg, b_cpu)
            loss_d, parts_d, g_d = model_steps.loss_and_grads(
                tree.tree_map(lambda t: t.to(dev), p_cpu), lcfg,
                data.torch_batch(0, dev))
        errs = {"loss": rel_err(torch, loss_d.cpu(), loss_c, "train layer loss")}
        for key, want in tree.flatten_with_keys(g_c).items():
            errs[key] = rel_err(torch, tree.flatten_with_keys(g_d)[key].cpu(),
                                want, f"train layer grad {key}")
        worst = max(errs, key=errs.get)
        if errs[worst] > TRAIN_LAYER_TOL:
            fail(f"train layer fp32: {worst} max-abs-err/max-abs "
                 f"{errs[worst]:.3g} over {TRAIN_LAYER_TOL}")
        print(f"train layer fp32 (1 of {cfg.n_layers} layers at full width, "
              f"{lb} x {ls} tokens): loss {loss_d.item():.6f} card, "
              f"{loss_c.item():.6f} CPU; {len(errs) - 1} gradient leaves, "
              f"the worst {worst} at max-abs-err/max-abs {errs[worst]:.3g} "
              f"(limit {TRAIN_LAYER_TOL})")
        out["layer_worst"] = errs[worst]
        del p_cpu, g_c, g_d

        # (d) one arch of each mixer kind at smoke size, and a resume
        from repro_torch.models.transformer import layer_kinds

        sm_steps, sm_batch, sm_seq, sm_lr = TRAIN_SMOKE_RUN
        smoke = {}
        for name in TRAIN_SMOKE_ARCHS:
            scfg = get_smoke(name)
            smb = (scfg.train_microbatches
                   if scfg.train_microbatches > 1
                   and sm_batch % scfg.train_microbatches == 0 else 1)
            mixers = [m for m, _ in layer_kinds(scfg)]
            per_fwd = (sum(m in ("attn", "attn+cross") for m in mixers)
                       + sum(m in ("cross", "attn+cross") for m in mixers)
                       + (scfg.encoder.n_layers if scfg.encoder else 0))
            args = ["--arch", name, "--smoke", "--steps", str(sm_steps),
                    "--batch", str(sm_batch), "--seq", str(sm_seq), "--lr",
                    str(sm_lr), "--ckpt-dir", os.path.join(workdir, name),
                    "--ckpt-every", str(sm_steps // 2), "--device", dev.type]
            launch.reset_launches()
            bodies: list = []
            with every_step_logged(), flash_bodies(bodies):
                res = train.main(args)
            card_sync(torch, dev)
            got = dict(launch.LAUNCHES)
            n_flash = per_fwd * smb * sm_steps
            losses = [h["loss"] for h in res["history"]]
            gn = [h["grad_norm"] for h in res["history"]]
            # each flash call is one launch, and one more where its plan
            # took split_kv (a grid too small to fill the card: the
            # combine) or tc_3xtf32 (the pack)
            want = {"flash_attention": len(bodies),
                    "flash_attention/combine": bodies.count("split_kv"),
                    "flash_attention/pack": bodies.count("tc_3xtf32")}
            want = {k: v for k, v in want.items() if v}
            if len(bodies) != n_flash or got != want:
                fail(f"train smoke {name}: launched {got}, expected {want} "
                     f"from the {len(bodies)} flash calls' plans; {n_flash} "
                     f"calls expected ({per_fwd} a forward x {smb} "
                     f"microbatches x {sm_steps} steps)")
            if not all(map(math.isfinite, losses + gn)) or not (
                    sum(losses[-2:]) < sum(losses[:2])):
                fail(f"train smoke {name}: losses {losses}, grad norms {gn}")
            smoke[name] = {"losses": losses, "launches": got}
            print(f"train smoke {name} ({scfg.n_layers} layers, {smb} "
                  f"microbatches, {sm_steps} steps of {sm_batch} x {sm_seq}): "
                  f"loss {losses[0]:.4f} -> {losses[-1]:.4f}, grad norms "
                  f"finite ({min(gn):.3f}-{max(gn):.3f}), launches {got} ({card})")
        name = TRAIN_SMOKE_ARCHS[0]
        launch.reset_launches()
        record = {}
        with every_step_logged():
            res = train.main([
                "--arch", name, "--smoke", "--steps",
                str(sm_steps + TRAIN_RESUME_STEPS), "--batch", str(sm_batch),
                "--seq", str(sm_seq), "--lr", str(sm_lr), "--ckpt-dir",
                os.path.join(workdir, name), "--ckpt-every", str(sm_steps // 2),
                "--resume", "--device", dev.type], record=record)
        if (record["trainer"].start_step != sm_steps
                or res["final_step"] != sm_steps + TRAIN_RESUME_STEPS
                or len(res["history"]) != TRAIN_RESUME_STEPS):
            fail(f"train resume {name}: from {record['trainer'].start_step}, "
                 f"final step {res['final_step']}")
        smoke["resume"] = {"from": sm_steps, "final_step": res["final_step"],
                           "launches": dict(launch.LAUNCHES)}
        print(f"train resume {name}: from step {sm_steps} to "
              f"{res['final_step']}, losses "
              f"{[round(h['loss'], 4) for h in res['history']]}")
        out["smoke"] = smoke
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    return out


# 4m: the SoC simulator and the objectives that rest on it, its schedules on
#     the card
SIM_NET = "resnet18"
SIM_WALKS = 3
SIM_STATES = 64                     # beam states of 4m(b)'s vector batch
SIM_REL_TOL = 1e-12                 # 4m(b): torch on the card vs numpy
SIM_METRICS = ("cycles", "latency_s", "energy_pj", "interconnect_words",
               "input_words", "output_words", "sram_reads", "sram_writes",
               "interconnect_bytes", "dram_words", "dram_bytes", "row_hits",
               "row_misses", "bank_conflicts", "avg_bw_bytes_s",
               "peak_bw_bytes_s", "row_miss_rate")
#: integer-valued columns, held with ==; the others at SIM_REL_TOL
SIM_EXACT = ("cycles", "interconnect_words", "input_words", "output_words",
             "sram_reads", "sram_writes", "interconnect_bytes", "dram_words",
             "dram_bytes", "row_hits", "row_misses", "bank_conflicts")


def sim_on_card(torch, dev, graph_ms, card: str) -> dict[str, int]:
    """Phase 4m. (a) On the host: `NetPlan.simulate` on the eight zoo CNNs'
    exact_opt NetPlans under both controllers (words == `NetPlan.traffic`),
    `plan_graph(..., objective="sim_latency")` on the eight, timed, and at
    ``residency_bytes=0`` the per-layer ``plan(strategy="sim_latency")``
    schedules. (b) `simulate_batch` over ResNet-18's widest conv layer's
    exact grid, both controllers, in torch float64 on the card against numpy
    on the host, both timed. (c) ResNet-18 at ``shrink(56, 1)`` walked in
    fp32 through `run_network_kernels` under the sim_latency and sim_energy
    strategies' `plan_many` schedules and the sim_latency NetPlan, each
    against `run_network_reference`, beside exact_opt's walk, with the
    simulator's modelled latency of the same schedules. (d) The
    roofline_latency objective at the port's H100 constants beside each
    layer's measured conv2d_psum time. Returns the sim walks' launches."""
    import numpy as np

    from repro_torch import plan, sim
    from repro_torch.core.cnn_zoo import PAPER_CNNS
    from repro_torch.kernels import launch
    from repro_torch.kernels.conv2d_psum import conv2d_psum
    from repro_torch.kernels.conv_network import (init_network_params,
                                                  run_network_kernels,
                                                  run_network_reference)
    from repro_torch.plan import objectives
    from repro_torch.plan.graph import NetworkGraph
    from repro_torch.roofline import constants

    soc = (f"modelled SoC at {sim.DEFAULT_PARAMS.clock_ghz:g} GHz, not card "
           f"time")
    # (a) the zoo on the host
    words = ("interconnect_words", "input_words", "output_words",
             "sram_reads", "sram_writes")
    for c in ("passive", "active"):
        sim_ms = 0.0
        for net in PAPER_CNNS:
            netp = plan.plan_graph(net, P_MACS, "exact_opt", c)
            sim.clear_node_report_cache()
            t0 = time.perf_counter()
            rep = netp.simulate()
            sim_ms += 1e3 * (time.perf_counter() - t0)
            got = tuple(getattr(rep, f) for f in words) + (rep.interconnect_bytes,)
            want = tuple(getattr(netp.traffic, f) for f in words) + (
                netp.traffic.bytes,)
            if got != want:
                fail(f"sim {net} {c}: simulated words {got} != NetPlan.traffic "
                     f"{want}")
            print(f"sim {net} {c} (exact_opt NetPlan, P {P_MACS}): words == "
                  f"NetPlan.traffic ({rep.interconnect_words:.0f} on the bus); "
                  f"latency {rep.latency_s * 1e3:.4f} ms, energy "
                  f"{rep.energy_pj / 1e6:.3f} uJ, row misses {rep.row_misses}, "
                  f"peak bus {rep.peak_bw_bytes_s / 1e9:.2f} GB/s ({soc})")
        print(f"sim zoo {c}: NetPlan.simulate on {len(PAPER_CNNS)} CNNs, host "
              f"{sim_ms:.3f} ms ({card})")
        plan.clear_plan_graph_cache()
        t0 = time.perf_counter()
        for net in PAPER_CNNS:
            netp = plan.plan_graph(net, P_MACS, "exact_opt", c,
                                   objective="sim_latency")
            rep = netp.simulate()
            if rep.interconnect_words != netp.traffic.interconnect_words:
                fail(f"sim_latency NetPlan {net} {c}: words differ")
        sl_ms = 1e3 * (time.perf_counter() - t0)
        print(f"plan_graph objective=sim_latency {c}: {len(PAPER_CNNS)} CNNs "
              f"planned and simulated on the host in {sl_ms:.3f} ms ({card})")
        for net in PAPER_CNNS:
            netp = plan.plan_graph(net, P_MACS, "exact_opt", c,
                                   residency_bytes=0, objective="sim_latency")
            for node in netp.graph.workload_nodes:
                want = plan.plan(node.workload, P_MACS, "sim_latency",
                                 c).schedule
                if netp.schedules[node.name] != want:
                    fail(f"sim_latency NetPlan {net} {c} residency 0: "
                         f"{node.name} {netp.schedules[node.name]} != "
                         f"plan's {want}")
        print(f"plan_graph residency 0 objective=sim_latency {c}: every layer "
              f"of the {len(PAPER_CNNS)} CNNs takes plan(strategy="
              f"'sim_latency')'s schedule")
    plan.clear_plan_graph_cache()

    # (b) the batch on the card against numpy on the host
    g = NetworkGraph.from_cnn(SIM_NET).shrink(WALK_PX, 1)
    nodes = g.workload_nodes
    wide = max(g.workloads, key=lambda w: (w.cout, w.cin, w.k))
    cands = plan.space.ConvExactSpace()(wide, P_MACS)
    rng = np.random.default_rng(32)
    states = np.sort(rng.integers(0, wide.in_acts + 1, SIM_STATES))
    worst = {}
    sim.simulate_batch(wide, cands, "active", xp=torch, device=dev).metric(
        "energy_pj")                # loads the card's kernels, untimed
    for c in ("passive", "active"):
        for spilled in (None, states):
            for out_spilled in (True, False):
                kw = dict(spilled_in_words=spilled, out_spilled=out_spilled)
                t0 = time.perf_counter()
                host = sim.simulate_batch(wide, cands, c, **kw)
                want = {f: host.metric(f) for f in SIM_METRICS}
                host_ms = 1e3 * (time.perf_counter() - t0)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                card_res = sim.simulate_batch(wide, cands, c, xp=torch,
                                              device=dev, **kw)
                got = {f: card_res.metric(f) for f in SIM_METRICS}
                torch.cuda.synchronize()
                card_ms = 1e3 * (time.perf_counter() - t0)
                for f in SIM_METRICS:
                    g_col = got[f]
                    if g_col.device.type != dev.type:
                        fail(f"simulate_batch torch {f}: on {g_col.device}")
                    g_col = g_col.cpu().numpy()
                    w_col = want[f]
                    if g_col.shape != w_col.shape or g_col.dtype != w_col.dtype:
                        fail(f"simulate_batch torch {f}: {g_col.dtype} "
                             f"{g_col.shape} vs numpy {w_col.dtype} "
                             f"{w_col.shape}")
                    if f in SIM_EXACT:
                        if not np.array_equal(g_col, w_col):
                            fail(f"simulate_batch torch {f} {c}: integer "
                                 f"column differs from numpy")
                        rel = 0.0
                    else:
                        den = np.maximum(np.abs(w_col), np.finfo(float).tiny)
                        rel = float((np.abs(g_col - w_col) / den).max())
                        if rel > SIM_REL_TOL:
                            fail(f"simulate_batch torch {f} {c}: rel err {rel} "
                                 f"> {SIM_REL_TOL}")
                    worst[f] = max(worst.get(f, 0.0), rel)
                shape = tuple(got["cycles"].shape)
                equal = sum(np.array_equal(got[f].cpu().numpy(), want[f])
                            for f in SIM_METRICS)
                print(f"simulate_batch {wide.name} ({wide.cin} -> {wide.cout}, "
                      f"{len(cands)} candidates) {c} "
                      f"{'states ' + str(len(states)) if spilled is not None else 'all spilled'}"
                      f" out_spilled={out_spilled}: columns {shape}; torch "
                      f"float64 on the card {card_ms:.3f} ms, numpy on the host "
                      f"{host_ms:.3f} ms; {equal} of {len(SIM_METRICS)} "
                      f"columns bit-equal ({card})")
    print(f"simulate_batch torch vs numpy: worst rel err per column "
          f"{ {f: v for f, v in worst.items() if v} or 'none (all equal)'} "
          f"(limit {SIM_REL_TOL}; integer and word columns ==)")

    # (c) the simulator's schedules through conv2d_psum
    plans = {
        "exact_opt": {n.name: p.schedule for n, p in zip(
            nodes, plan.plan_many(g.workloads, P_MACS, "exact_opt", "active"))},
        "sim_latency": {n.name: p.schedule for n, p in zip(
            nodes, plan.plan_many(g.workloads, P_MACS, "sim_latency", "active"))},
        "sim_energy": {n.name: p.schedule for n, p in zip(
            nodes, plan.plan_many(g.workloads, P_MACS, "sim_energy", "active"))},
        "sim_latency NetPlan": plan.plan_graph(g, P_MACS, "sim_latency",
                                               "active"),
    }
    params = init_network_params(g, seed=0, device=dev)
    gen = torch.Generator().manual_seed(32)
    inputs = {g.inputs[0]: torch.randn(3, WALK_PX, WALK_PX, generator=gen).to(dev)}
    want = run_network_reference(g, params, inputs=inputs, device=dev)
    expect = {"conv2d_psum": len(nodes), "conv2d_psum/pack": len(nodes)}
    phase = {key: 0 for key in expect}
    card_ms, model_ms = {}, {}
    for label, plan_ in plans.items():
        scheds = plan_.schedules if label.endswith("NetPlan") else plan_
        rep = (plan_.simulate() if label.endswith("NetPlan")
               else sim.simulate_network(g, scheds))
        model_ms[label] = rep.latency_s * 1e3
        run_network_kernels(g, plan_, params, inputs=inputs, device=dev)
        worst_rel = 0.0
        for _ in range(SIM_WALKS):
            torch.cuda.synchronize()
            launch.reset_launches()
            got = run_network_kernels(g, plan_, params, inputs=inputs,
                                      device=dev)
            torch.cuda.synchronize()
            counts = dict(launch.LAUNCHES)
            if counts != expect:
                fail(f"sim walk {label}: launched {counts}, expected {expect}")
            if label != "exact_opt":
                for key in phase:
                    phase[key] += counts[key]
            for name, value in want.items():
                out = got[name]
                if out.shape != value.shape or not torch.isfinite(out).all():
                    fail(f"sim walk {label} {name}: shape or non-finite values")
                rel = ((out - value).abs().max() / value.abs().max()).item()
                if rel > NETWORK_REL_TOL:
                    fail(f"sim walk {label} {name}: max abs err / max abs = "
                         f"{rel}")
                worst_rel = max(worst_rel, rel)
            del got
        card_ms[label] = graph_ms(lambda: run_network_kernels(
            g, plan_, params, inputs=inputs, device=dev), calls=1, reps=3)
        differ = sum(scheds[n.name] != plans["exact_opt"][n.name] for n in nodes)
        resident = (f"; the model holds {len(plan_.resident_tensors)} edges "
                    f"resident on chip, the card none"
                    if label.endswith("NetPlan") else "")
        print(f"sim walk {g.name} {label} (fp32, active, P {P_MACS}): replayed "
              f"{card_ms[label]:.3f} ms on the card ({card}); the simulator's "
              f"latency for the same schedules {model_ms[label]:.4f} ms "
              f"({soc}{resident}); {differ} of {len(nodes)} schedules differ from "
              f"exact_opt's; launches a walk {expect}; worst rel err "
              f"{worst_rel:.3g} (limit {NETWORK_REL_TOL})")
    by_model = sorted(plans, key=lambda k: model_ms[k])
    by_card = sorted(plans, key=lambda k: card_ms[k])
    print(f"sim order of the four schedules, fastest first: by the simulator "
          f"{by_model}; by the card {by_card} "
          f"({'the same' if by_model == by_card else 'different'}; a finding, "
          f"not a limit)")

    # (d) the roofline objective at the card's numbers, per layer
    sums = {"roofline": 0.0, "card": 0.0}
    scheds = plans["sim_latency"]
    for node in nodes:
        wl, pad, sc = node.workload, node.workload.k // 2, scheds[node.name]
        cand = plan.Candidates(kind="conv", bm=np.asarray([sc.m]),
                               bn=np.asarray([sc.n]), bk=np.asarray([0]))
        roof = 1e3 * float(objectives.roofline_latency(
            wl, cand, plan.Controller.ACTIVE)[0])
        x = torch.nn.functional.pad(torch.cat([want[t] for t in node.ins], dim=0),
                                    (pad, pad, pad, pad)).contiguous()
        ms = graph_ms(lambda: conv2d_psum(x, params[node.name], schedule=sc,
                                          stride=wl.stride))
        sums["roofline"] += roof
        sums["card"] += ms
        print(f"sim roofline {node.name} ({wl.cin} -> {wl.cout}, {wl.k}x{wl.k}, "
              f"{WALK_PX} px, sim_latency m {sc.m} n {sc.n}): roofline_latency "
              f"{roof:.6f} ms at the H100's {constants.PEAK_FLOPS_BF16:.3g} "
              f"FLOP/s and {constants.HBM_BW:.3g} B/s; conv2d_psum fp32 "
              f"{ms:.4f} ms ({ms / roof:.1f} x) ({card})")
    print(f"sim roofline: {len(nodes)} layers sum to {sums['roofline']:.4f} ms "
          f"by the objective and {sums['card']:.4f} ms measured ({card})")
    return phase


FAULT_NET = "resnet18"
FAULT_SEEDS = 8                      # generate_schedule seeds 0 .. 7


def faults_on_card(torch, dev, graph_ms, card: str) -> dict[str, int]:
    """Phase 4n. ResNet-18 at ``shrink(56, 1)``, exact_opt, active, P =
    2048: the fault schedules of seeds 0-7 (`faults.generate_schedule`),
    each schedule's plan faults applied to the NetPlan
    (`faults.apply_to_plan`: EngineDegrade halves or quarters the MAC
    budget, VmemShrink the residency, ControllerFallback re-plans passive);
    each distinct degraded NetPlan walked in fp32 through
    `run_network_kernels` (conv2d_psum on the card, every tensor within 1e-3
    of `run_network_reference`, launches counted), beside its words, its
    replayed device ms and the simulator's latency for it. The conv body
    keeps its partial sums on chip whatever the plan's controller, as the
    reference's does: a passive plan differs in its schedules and its
    modelled words. Then `faults.run_chaos(8, smoke=True)` on the host,
    which must report ok. Returns the counted walks' launches."""
    from repro_torch import faults, plan
    from repro_torch.kernels import launch
    from repro_torch.kernels.conv_network import (init_network_params,
                                                  run_network_kernels,
                                                  run_network_reference)
    from repro_torch.plan.graph import NetworkGraph

    g = NetworkGraph.from_cnn(FAULT_NET).shrink(WALK_PX, 1)
    nodes = g.workload_nodes
    base = plan.plan_graph(g, P_MACS, "exact_opt", "active")
    degraded: dict[tuple, tuple] = {}
    for seed in range(FAULT_SEEDS):
        sched = faults.generate_schedule(seed)
        plan_faults = sched.plan_faults()
        netp = faults.apply_to_plan(base, plan_faults)
        args = faults.degraded_plan_args(plan_faults, faults.plan_args_of(base))
        key = (args.budget, args.residency_bytes, args.controller.value)
        kinds = [type(e.fault).__name__ for e in sched]
        print(f"fault schedule seed {seed}: {kinds} at "
              f"{[e.t_s for e in sched]} s; plan faults "
              f"{[type(f).__name__ for f in plan_faults]} -> budget "
              f"{args.budget}, residency {args.residency_bytes} B, "
              f"{args.controller.value}"
              f"{' (the base plan itself)' if netp is base else ''}")
        degraded.setdefault(key, (netp, []))[1].append(seed)
    params = init_network_params(g, seed=0, device=dev)
    gen = torch.Generator().manual_seed(34)
    inputs = {g.inputs[0]: torch.randn(3, WALK_PX, WALK_PX, generator=gen).to(dev)}
    want = run_network_reference(g, params, inputs=inputs, device=dev)
    expect = {"conv2d_psum": len(nodes), "conv2d_psum/pack": len(nodes)}
    phase = {key: 0 for key in expect}
    for (budget, residency, ctrl), (netp, seeds) in degraded.items():
        run_network_kernels(g, netp, params, inputs=inputs, device=dev)
        torch.cuda.synchronize()
        launch.reset_launches()
        got = run_network_kernels(g, netp, params, inputs=inputs, device=dev)
        torch.cuda.synchronize()
        counts = dict(launch.LAUNCHES)
        if counts != expect:
            fail(f"fault walk seeds {seeds}: launched {counts}, expected {expect}")
        for key in phase:
            phase[key] += counts[key]
        worst = 0.0
        for name, value in want.items():
            out = got[name]
            if out.shape != value.shape or not torch.isfinite(out).all():
                fail(f"fault walk seeds {seeds} {name}: shape or non-finite")
            rel = ((out - value).abs().max() / value.abs().max()).item()
            if rel > NETWORK_REL_TOL:
                fail(f"fault walk seeds {seeds} {name}: max abs err / max abs "
                     f"= {rel}")
            worst = max(worst, rel)
        del got
        ms = graph_ms(lambda: run_network_kernels(g, netp, params,
                                                  inputs=inputs, device=dev),
                      calls=1, reps=3)
        rep = netp.simulate()
        differ = sum((netp.schedules[n.name].m, netp.schedules[n.name].n)
                     != (base.schedules[n.name].m, base.schedules[n.name].n)
                     for n in nodes)
        print(f"fault walk {g.name} seeds {seeds} (fp32, P {budget or P_MACS} "
              f"MACs, residency {residency} B, {ctrl}): words "
              f"{netp.total_words} (base {base.total_words}); {differ} of "
              f"{len(nodes)} (m, n) partitions differ from the healthy "
              f"plan's; "
              f"replayed {ms:.4f} ms on the card ({card}); the simulator's "
              f"latency {rep.latency_s * 1e3:.4f} ms (modelled SoC, not card "
              f"time); launches {counts}; worst rel err vs cuDNN {worst:.3g} "
              f"(limit {NETWORK_REL_TOL})")
    t0 = time.perf_counter()
    rep = faults.run_chaos(n_schedules=FAULT_SEEDS, smoke=True)
    chaos_s = time.perf_counter() - t0
    print(rep.summary())
    if not rep.ok:
        fail(f"run_chaos: {len(rep.violations)} violations")
    print(f"fault chaos: run_chaos({FAULT_SEEDS}, smoke=True) ok on the host "
          f"in {chaos_s:.2f} s; {len(degraded)} distinct degraded NetPlans "
          f"walked, launches {phase}")
    return phase


TP_ARCH = "qwen2-moe-a2.7b"
TP_SMOKE = False                     # True only in a CPU rehearsal
TP_SERVE = (4, 1024, 8)              # batch, prompt, new tokens
TP_WORLD = 2                         # ranks of the (1, 2) mesh, on one card
TP_BLOCK = (2, 2, 128, 3)            # the fp32 block: layers, batch, tokens,
                                     # decodes (a capacity of 132 cuts in two)
TP_BLOCK_TOL = 2e-4                  # tests/test_distributed.py's, fp32
TP_SETTINGS = (("active", False), ("passive", False),
               ("active", True), ("passive", True))
TP_TIMEOUT = 900                     # seconds a worker may take
TP_DIR = ROOT / "build" / "tp_phase"   # git-ignored


def _tp_common(spec: dict):
    """A phase 4o worker's torch, device and config."""
    import torch

    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs import get_config, get_smoke

    dev = torch.device(spec["device"], 0) if spec["device"] == "cuda" else \
        torch.device("cpu")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    cfg = (get_smoke if spec["smoke"] else get_config)(TP_ARCH)
    return torch, dev, cfg


def _tp_generate(torch, dev, cfg, params, prompts, forced, gen, parallel,
                 timed: bool) -> dict:
    """Prefill the prompts and decode ``gen - 1`` steps, greedy, or
    teacher-forced with ``forced`` (the baseline's greedy tokens) where
    given: every step's logits (fp32,
    on the host), the step's own greedy tokens, host ms of the prefill and
    of each decode step (the card synchronised around each), the launch
    counts and the collectives of the decode steps, and every MoE layer's
    routes (top-k expert ids), prefill (layers, B S, k) and decode
    (steps, layers, B, k)."""
    from unittest import mock

    from repro_torch.kernels import launch
    from repro_torch.models import moe
    from repro_torch.models import steps as model_steps
    from repro_torch.sharding import collectives

    max_len = prompts.shape[1] + gen
    prefill = model_steps.make_prefill_step(cfg, max_len, parallel)
    decode = model_steps.make_decode_step(cfg, parallel)
    out: dict = {}
    routes: list = []

    def recorded(w, x2, mc):
        weights, idx, aux = route(w, x2, mc)
        routes.append(idx.cpu())
        return weights, idx, aux

    route = moe.route
    with torch.inference_mode(), mock.patch.object(moe, "route", recorded):
        collectives.reset()
        launch.reset_launches()
        card_sync(torch, dev)
        t0 = time.perf_counter()
        logits, caches = prefill(params, {"tokens": prompts})
        card_sync(torch, dev)
        out["prefill_ms"] = 1e3 * (time.perf_counter() - t0)
        out["prefill_launches"] = dict(launch.LAUNCHES)
        out["prefill_collectives"] = {k: dict(v) for k, v in
                                      collectives.COLLECTIVES.items()}
        out["kv_sharded"] = bool(caches.get("kv_sharded", False))
        out["prefill_routes"] = torch.stack(routes)
        routes.clear()
        steps, own = [logits.float().cpu()], [torch.argmax(logits, -1).cpu()]
        collectives.reset()
        launch.reset_launches()
        out["decode_ms"] = []
        ctx = collectives.timed() if timed else contextlib.nullcontext()
        with ctx:
            for i in range(gen - 1):
                card_sync(torch, dev)
                t0 = time.perf_counter()
                tok = (own[-1].to(dev)[:, None] if forced is None
                       else forced[:, i:i + 1])
                logits, caches = decode(params, caches, tok)
                card_sync(torch, dev)
                out["decode_ms"].append(1e3 * (time.perf_counter() - t0))
                steps.append(logits.float().cpu())
                own.append(torch.argmax(logits, -1).cpu())
        out["decode_launches"] = dict(launch.LAUNCHES)
        out["decode_collectives"] = {k: dict(v) for k, v in
                                     collectives.COLLECTIVES.items()}
        out["logits"] = torch.stack(steps)
        out["tokens"] = torch.stack(own, 1)
        out["decode_routes"] = torch.stack(routes).reshape(
            gen - 1, -1, *routes[0].shape)
        del caches
    return out


def tp_baseline(spec: dict) -> None:
    """Phase 4o's one-process baseline (``parallel=None``), in its own
    process: the whole model's seeded weights, greedy decoding from seeded
    prompts; then the same prompts teacher-forced with its tokens, each
    MoE layer's routed experts run as the two ranks run them, over each
    half of ff, the halves' bf16 outputs added (the split, one process).
    Saves both for the ranks."""
    import numpy as np
    from unittest import mock

    torch, dev, cfg = _tp_common(spec)
    from repro_torch.models import moe
    from repro_torch.models.transformer import init_lm

    batch, prompt, gen = spec["serve"]
    params = init_lm(cfg, seed=0, device=dev)
    prompts = torch.from_numpy(np.random.default_rng(34).integers(
        0, cfg.vocab, (batch, prompt))).to(dev)
    run = _tp_generate(torch, dev, cfg, params, prompts, None, gen, None,
                       timed=False)
    forced = run["tokens"].to(dev)
    ffn = moe._capacity_ffn
    half = cfg.moe.expert_ff // spec["world"]

    def split_ffn(routed, mc, x, weights, idx, act):
        parts = [ffn({n: routed[n].narrow(1 if n == "wo" else 2, r * half,
                                          half).contiguous()
                      for n in ("wg", "wi", "wo")}, mc, x, weights, idx, act)
                 for r in range(spec["world"])]
        return functools.reduce(lambda a, b: a + b, parts)

    with mock.patch.object(moe, "_capacity_ffn", split_ffn):
        split = _tp_generate(torch, dev, cfg, params, prompts, forced, gen,
                             None, timed=False)
    run.update(prompts=prompts.cpu(), forced=forced.cpu(),
               split={k: split[k] for k in ("logits", "tokens",
                                            "prefill_routes", "decode_routes")},
               held_gb=(torch.cuda.memory_allocated(dev) / 1e9
                        if dev.type == "cuda" else 0.0))
    torch.save(run, pathlib.Path(spec["dir"]) / "baseline.pt")


def tp_rank(spec: dict) -> None:
    """One rank of phase 4o's (1, 2) mesh: gloo over a file rendezvous,
    the seeded weights made one rank at a time and cut to this rank's ff
    block of the routed experts (`rules.routed_specs`), then the baseline's
    prompts served under each `TP_SETTINGS` (psum_strategy x flash_decode),
    teacher-forced with the baseline's tokens; then the fp32 first-layers
    block under both strategies and in one process. A peer that does not
    come raises within the rendezvous's timeout."""
    import datetime

    torch, dev, cfg = _tp_common(spec)
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models.transformer import init_lm
    from repro_torch.sharding import collectives, rules
    from repro_torch.sharding.api import make_parallel

    rank, world, out_dir = spec["rank"], spec["world"], pathlib.Path(spec["dir"])
    dist.init_process_group("gloo", init_method=f"file://{out_dir / 'rdzv'}",
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=300))
    mesh = make_test_mesh(1, world, device_type=dev.type)
    base = torch.load(out_dir / "baseline.pt")
    batch, prompt, gen = spec["serve"]
    res: dict = {"rank": rank, "coord": list(mesh.get_coordinate())}

    def held(tree_fn):
        """Weights made one rank at a time (the whole tree, then the cut), so
        that two whole trees never share the card."""
        params = None
        for r in range(world):
            if r == rank:
                whole = tree_fn()
                params = rules.shard_tree(whole, rules.routed_specs(whole, mesh),
                                          mesh)
                del whole
                if dev.type == "cuda":
                    torch.cuda.empty_cache()
            dist.barrier()
        return params

    params = held(lambda: init_lm(cfg, seed=0, device=dev))
    res["held_gb"] = (torch.cuda.memory_allocated(dev) / 1e9
                      if dev.type == "cuda" else 0.0)
    res["routed_ff"] = params["layers"][0]["moe"]["routed"]["wg"].shape[-1]

    # how gloo moves a CUDA tensor: the profiler's events around one call
    if dev.type == "cuda":
        t = torch.ones(batch, cfg.d_model, dtype=torch.bfloat16, device=dev)
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            collectives.all_reduce(t, mesh.get_group("model"), site="probe")
            torch.cuda.synchronize(dev)
        res["gloo_events"] = sorted(
            (e.key, e.count) for e in prof.key_averages()
            if any(w in e.key.lower() for w in ("memcpy", "gloo", "allreduce",
                                                "all_reduce", "copy_")))
    prompts, forced = base["prompts"].to(dev), base["forced"].to(dev)
    runs = {}
    for strategy, flash in TP_SETTINGS:
        par = make_parallel(mesh, psum_strategy=strategy, flash_decode=flash)
        run = _tp_generate(torch, dev, cfg, params, prompts, forced, gen, par,
                           timed=True)
        key = f"{strategy}{' flash_decode' if flash else ''}"
        torch.save({k: run.pop(k) for k in ("logits", "prefill_routes",
                                            "decode_routes")},
                   out_dir / f"logits_{rank}_{key}.pt")
        run["tokens"] = run["tokens"].tolist()
        runs[key] = run
    res["runs"] = runs
    del params
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    # the fp32 block: the first layers at full width, sharded under both
    # strategies (flash decoding on) and whole in one process
    layers, b, t_len, steps = spec["block"]
    cfg32 = dataclasses.replace(cfg, dtype="float32", n_periods=layers)
    whole = init_lm(cfg32, seed=1, device=dev)
    cut = rules.shard_tree(whole, rules.routed_specs(whole, mesh), mesh)
    gen_ = torch.Generator().manual_seed(35)
    toks = torch.randint(0, cfg.vocab, (b, t_len + steps), generator=gen_).to(dev)
    block = {}
    for label, params32, par in (
            ("one process", whole, None),
            ("active", cut, make_parallel(mesh, psum_strategy="active",
                                          flash_decode=True)),
            ("passive", cut, make_parallel(mesh, psum_strategy="passive",
                                           flash_decode=True))):
        run = _tp_generate(torch, dev, cfg32, params32, toks[:, :t_len],
                           toks[:, t_len:], steps + 1, par, timed=False)
        block[label] = run["logits"]
        if par is not None and not run["kv_sharded"]:
            fail(f"tp fp32 block {label}: the caches were not cut for flash "
                 f"decoding")
    res["block"] = {
        "active_vs_passive": (block["active"] - block["passive"]).abs().max().item(),
        "active_vs_one": (block["active"] - block["one process"]).abs().max().item(),
        "passive_vs_one": (block["passive"] - block["one process"]).abs().max().item(),
        "max_abs": block["one process"].abs().max().item(),
    }
    (out_dir / f"rank{rank}.json").write_text(json.dumps(res))
    dist.barrier()
    dist.destroy_process_group()


def tp_partials_rows(torch, dev, card: str, cfg, graph_ms, time_ms,
                     bound) -> dict:
    """split_kv's pass 1 with its partials handed back (no combine), as one
    rank's flash decoding calls it: ``cfg``'s heads, batch TP_SERVE[0],
    over half of a cache of prompt + new tokens, at a local position
    inside the block, at its last key and before the block (valid length
    0: the rank sees no key), each against the plain version's (m, l,
    acc) on the card's inputs; the whole block's case timed. Returns its
    row."""
    from repro_torch.kernels import flash_attention

    on_card = dev.type == "cuda"
    batch, prompt, gen = TP_SERVE
    s_loc = (prompt + gen) // TP_WORLD
    hq, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    fp = flash_attention.flash_launch_plan(
        bh=batch * hq, sq=1, skv=s_loc, d=hd, kv_group=hq // hkv,
        dtype=torch.bfloat16, device_pos=True, partials=True)
    if fp.launches != 1 or (on_card and fp.body != "split_kv"):
        fail(f"tp partials: plan {fp.body} with {fp.launches} launches")
    gen_ = torch.Generator().manual_seed(36)
    q = torch.randn(batch * hq, 1, hd, generator=gen_).to(dev, torch.bfloat16)
    k, v = (torch.randn(batch * hkv, s_loc, hd, generator=gen_)
            .to(dev, torch.bfloat16) for _ in range(2))
    call = fp.cuda if on_card else fp.plain
    worst = 0.0
    for label, off in (("inside", s_loc // 3), ("last key", s_loc - 1),
                       ("before the block", -s_loc // 2)):
        pos = torch.tensor([off, min(max(off + 1, 0), s_loc)], dtype=torch.int32,
                           device=dev)
        got, want = call(q, k, v, pos=pos), fp.plain(q, k, v, pos=pos)
        for name, g, w in zip(("m", "l", "acc"), got, want):
            if g.dtype != torch.float32 or g.shape != w.shape:
                fail(f"tp partials {label} {name}: {g.dtype} {tuple(g.shape)}")
            err = ((g - w).abs().max() / max(1.0, w.abs().max().item())).item()
            if err > FLASH_TOL["float32"]:
                fail(f"tp partials {label} {name}: err {err}")
            worst = max(worst, err)
        if off < 0 and not (torch.all(got[0] == flash_attention.NEG_INF)
                            and torch.all(got[1] == 0) and torch.all(got[2] == 0)):
            fail("tp partials before the block: a rank that sees no key must "
                 "give m = NEG_INF, l = 0, acc = 0")
    pos = torch.tensor([s_loc - 1, s_loc], dtype=torch.int32, device=dev)
    b_ms, b_by = bound(4.0 * batch * hq * s_loc * hd,
                       2 * (q.numel() + k.numel() + v.numel())
                       + 4 * batch * hq * (hd + 2), torch.bfloat16)
    row = {"body": fp.body, "max_abs_err": worst,
           "ms": graph_ms(lambda: call(q, k, v, pos=pos)),
           "plain_ms": time_ms(lambda: fp.plain(q, k, v, pos=pos)),
           "bound_ms": b_ms, "bound_by": b_by, "library_ms": None}
    print(f"tp partials (split_kv pass 1 alone, bf16, B {batch}, {hq}/{hkv} "
          f"heads, d {hd}, one query over a block of {s_loc} keys; the rank "
          f"before the block sees none): " + " ".join(
              f"{key}={val:.4g}" if isinstance(val, float) else f"{key}={val}"
              for key, val in row.items()) + f" ({card})")
    return row


def tp_on_card(torch, dev, card: str, graph_ms, time_ms,
               bound) -> dict:
    """Phase 4o. Qwen1.5-MoE-A2.7B at full width and depth, bf16, seeded
    weights, served on a (1, 2) mesh whose two ranks are two processes on
    the one card, talking through gloo: first the one-process baseline in a
    process of its own (its logits and greedy tokens saved), then the two
    ranks (`tp_rank`), each holding half the routed experts' ff and the
    rest whole, under the active and the passive combine, with flash
    decoding off and on. Both ranks' logits and MoE routes equal; without
    flash decoding equal bit for bit to the same split in one process
    (`tp_baseline`), with it the prefill bit for bit and the decode within
    `SERVE_REL_TOL` (bf16 max-abs-err / max-abs, per row) where the routes
    agree; against the unsplit baseline within `SERVE_REL_TOL` where the
    routes agree, greedy tokens equal where its top-2 margin exceeds twice
    that, route flips counted (the bf16 split flips near-tie routes); the bytes through each collective per decode step, the
    decode ms a step and the share in the collectives; split_kv's pass 1
    with no combine in the flash-decoding steps. Then the fp32 first-layers
    block: active against passive and against one process within 2e-4.
    Before the processes start, `tp_partials_rows` holds the pass-1
    partials against their plain version in this process. Returns the
    ranks' decode launches under flash decoding and the partials' row."""
    import shutil

    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs import get_config, get_smoke
    cfg = (get_smoke if TP_SMOKE else get_config)(TP_ARCH)
    n_layers = cfg.n_layers
    partials = tp_partials_rows(torch, dev, card, cfg, graph_ms, time_ms, bound)

    batch, prompt, gen = TP_SERVE
    if TP_DIR.exists():
        shutil.rmtree(TP_DIR)
    TP_DIR.mkdir(parents=True)
    spec = {"dir": str(TP_DIR), "device": dev.type, "smoke": TP_SMOKE,
            "serve": list(TP_SERVE), "block": list(TP_BLOCK),
            "world": TP_WORLD}
    if dev.type == "cuda":
        torch.cuda.empty_cache()
        print(f"tp phase: the main process holds "
              f"{torch.cuda.memory_allocated(dev) / 1e9:.3f} GB allocated, "
              f"{torch.cuda.memory_reserved(dev) / 1e9:.3f} GB reserved")

    def spawn(role: str, extra: dict) -> subprocess.Popen:
        return subprocess.Popen(
            [sys.executable, str(ROOT / "chip_smoke.py"), role,
             json.dumps({**spec, **extra})],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)

    def finish(procs: list, what: str) -> None:
        logs = []
        try:
            for proc in procs:
                logs.append(proc.communicate(timeout=TP_TIMEOUT)[0])
        finally:
            for proc in procs:
                if proc.poll() is None:
                    proc.kill()
                    proc.communicate()
        for i, (proc, log) in enumerate(zip(procs, logs)):
            if proc.returncode != 0:
                fail(f"{what} {i} exited {proc.returncode}:\n{log[-6000:]}")

    t0 = time.perf_counter()
    finish([spawn("--tp-baseline", {})], "tp baseline")
    base_s = time.perf_counter() - t0
    base = torch.load(TP_DIR / "baseline.pt")
    t0 = time.perf_counter()
    finish([spawn("--tp-rank", {"rank": r}) for r in range(TP_WORLD)], "tp rank")
    ranks_s = time.perf_counter() - t0
    ranks = [json.loads((TP_DIR / f"rank{r}.json").read_text())
             for r in range(TP_WORLD)]
    want = base["logits"]
    on_card = dev.type == "cuda"
    print(f"tp baseline ({TP_ARCH}, one process, parallel=None, batch {batch}, "
          f"prompt {prompt}, {gen} new tokens, eager): prefill "
          f"{base['prefill_ms']:.2f} ms, decode "
          f"{statistics.median(base['decode_ms']):.3f} ms a step (median of "
          f"{len(base['decode_ms'])}); held {base['held_gb']:.2f} GB; "
          f"launches prefill {base['prefill_launches']}, decode "
          f"{base['decode_launches']}; {base_s:.1f} s with its start ({card})")
    if "gloo_events" in ranks[0]:
        print(f"tp gloo path for a CUDA tensor (one all-reduce of {batch} x "
              f"d_model bf16, profiled): {ranks[0]['gloo_events']}")
    split = base["split"]

    def consistent(run: dict, ref: dict):
        """(steps + 1, B): the logits whose every MoE route equals ``ref``'s:
        all of the prefill's (capacity dispatch couples its rows) and the
        row's own in the decode steps up to that logit (decode rows do not
        drop, so they are independent)."""
        same = (run["decode_routes"] == ref["decode_routes"]).all(-1).all(1)
        rows = torch.cat([torch.ones_like(same[:1]), same]).cumprod(0).bool()
        return rows & torch.equal(run["prefill_routes"], ref["prefill_routes"])

    def flips(run: dict, ref: dict) -> str:
        pre = (run["prefill_routes"] != ref["prefill_routes"]).any(-1)
        dec = (run["decode_routes"] != ref["decode_routes"]).any(-1)
        return (f"{int(pre.sum())} of {pre.numel()} prefill and "
                f"{int(dec.sum())} of {dec.numel()} decode (layer, token) "
                f"routes differ")

    def row_rel(got, ref):
        return (got - ref).abs().amax(-1) / ref.abs().amax(-1)

    def worst(rel, mask) -> float:
        return float(rel[mask].max()) if mask.any() else 0.0

    intrinsic = row_rel(split["logits"], want)
    ok = consistent(split, base)
    print(f"tp split in one process (each MoE layer's routed experts over "
          f"{TP_WORLD} halves of ff, the halves' bf16 outputs added) against "
          f"the baseline: max abs err / max abs {float(intrinsic.max()):.4g} "
          f"over all {intrinsic.numel()} logit rows, {worst(intrinsic, ok):.4g} "
          f"over the {int(ok.sum())} whose routes all equal the baseline's "
          f"(limit {SERVE_REL_TOL}); {flips(split, base)}")
    if worst(intrinsic, ok) > SERVE_REL_TOL:
        fail("tp split: logits beyond the bf16 limit where every route equals "
             "the baseline's")
    launches: dict[str, int] = {}
    for key in ranks[0]["runs"]:
        got = [torch.load(TP_DIR / f"logits_{r}_{key}.pt") for r in range(TP_WORLD)]
        if not all(torch.equal(g[k], got[0][k]) for g in got[1:] for k in got[0]):
            fail(f"tp {key}: the ranks' logits or routes differ")
        run = got[0]
        logits = run["logits"]
        if logits.shape != want.shape or not torch.isfinite(logits).all():
            fail(f"tp {key}: logits {tuple(logits.shape)} vs "
                 f"{tuple(want.shape)}, or non-finite")
        flash = key.endswith("flash_decode")
        if not flash and not all(torch.equal(run[k], split[k]) for k in run):
            fail(f"tp {key}: logits or routes differ from the split run in "
                 f"one process")
        if flash and not torch.equal(logits[0], split["logits"][0]):
            fail(f"tp {key}: prefill logits differ from the split run's")
        vs_split = row_rel(logits, split["logits"])
        ok_split = consistent(run, split)
        if worst(vs_split, ok_split) > SERVE_REL_TOL:
            fail(f"tp {key}: logits vs the split run beyond {SERVE_REL_TOL} "
                 f"where the routes agree")
        vs_base = row_rel(logits, want)
        ok_base = consistent(run, base)
        if worst(vs_base, ok_base) > SERVE_REL_TOL:
            fail(f"tp {key}: logits vs the baseline beyond {SERVE_REL_TOL} "
                 f"where the routes agree")
        top2 = want.topk(2, dim=-1).values
        sure = ok_base & (top2[..., 0] - top2[..., 1]
                          > 2 * SERVE_REL_TOL * want.abs().amax(-1))
        toks = torch.tensor(ranks[0]["runs"][key]["tokens"])
        if not torch.equal(toks.T[sure], base["tokens"].T[sure]):
            fail(f"tp {key}: greedy tokens differ from the baseline's where "
                 f"its routes agree and its top-2 margin is clear")
        print(f"tp logits {key}: both ranks equal bit for bit; "
              f"{'against the split run: prefill bit for bit, decode ' + format(worst(vs_split, ok_split), '.4g') + ' at ' + str(int(ok_split.sum())) + ' rows whose routes agree (' + flips(run, split) + ')' if flash else 'bit for bit the split run in one process'}; "
              f"against the baseline: {float(vs_base.max()):.4g} over all "
              f"rows, {worst(vs_base, ok_base):.4g} over the "
              f"{int(ok_base.sum())} whose routes agree (limit "
              f"{SERVE_REL_TOL}); greedy tokens equal at all {int(sure.sum())} "
              f"of those whose baseline top-2 margin exceeds "
              f"{2 * SERVE_REL_TOL} x max |logit|")
        for r in ranks:
            run = r["runs"][key]
            flash = key.endswith("flash_decode")
            n = gen - 1
            dec = run["decode_launches"]
            per_step = {k: v / n for k, v in dec.items()}
            expect = ({"flash_attention": n_layers} if flash else
                      {"flash_attention": n_layers,
                       "flash_attention/combine": n_layers})
            if on_card and per_step != expect:
                fail(f"tp {key} rank {r['rank']}: decode launched {dec} in {n} "
                     f"steps, expected {expect} a step")
            if flash != run["kv_sharded"]:
                fail(f"tp {key} rank {r['rank']}: caches cut {run['kv_sharded']}")
            coll = run["decode_collectives"]
            coll_s = sum(v["s"] for v in coll.values())
            dec_ms = run["decode_ms"]
            print(f"tp serve rank {r['rank']} {key} ({TP_WORLD} ranks on one "
                  f"card, gloo): decode {statistics.median(dec_ms):.3f} ms a step (median "
                  f"of {n}), {1e3 * coll_s / n:.3f} ms a step in the "
                  f"collectives ({coll_s / (sum(dec_ms) / 1e3):.3f} of the "
                  f"steps); prefill {run['prefill_ms']:.2f} ms; bytes a decode "
                  f"step {{{', '.join(f'{k}: {v['bytes'] / n:.0f} B in {v['calls'] / n:.0f} calls' for k, v in coll.items())}}}; "
                  f"prefill collectives {{{', '.join(f'{k}: {v['bytes']} B' for k, v in run['prefill_collectives'].items())}}}; "
                  f"launches a decode step {per_step}, prefill "
                  f"{run['prefill_launches']}; held {r['held_gb']:.2f} GB, "
                  f"routed ff {r['routed_ff']} of a whole "
                  f"{'smoke' if TP_SMOKE else 1408} ({card})")
            if flash:
                for k, v in dec.items():
                    launches[k] = launches.get(k, 0) + v
    for r in ranks:
        blk = r["block"]
        tol = TP_BLOCK_TOL * max(1.0, blk["max_abs"])
        worst = max(blk["active_vs_passive"], blk["active_vs_one"],
                    blk["passive_vs_one"])
        if worst > tol:
            fail(f"tp fp32 block rank {r['rank']}: {blk} beyond {tol}")
        print(f"tp fp32 block rank {r['rank']} ({TP_BLOCK[0]} layers at full "
              f"width, batch {TP_BLOCK[1]}, {TP_BLOCK[2]} tokens + "
              f"{TP_BLOCK[3]} flash-decoded steps): max abs err active vs "
              f"passive {blk['active_vs_passive']:.3g}, active vs one process "
              f"{blk['active_vs_one']:.3g}, passive vs one process "
              f"{blk['passive_vs_one']:.3g} (limit {TP_BLOCK_TOL} x max(1, "
              f"{blk['max_abs']:.3g}))")
    print(f"tp phase: baseline {base_s:.1f} s, ranks {ranks_s:.1f} s; flash "
          f"decoding's decode launches over both ranks {launches}")
    return {"launches": launches, "partials": partials}


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
    # image 0's walk again, for phase 4g (``graph`` names a module from 4b on)
    image_walk = functools.partial(run_network_kernels, graph, schedules, params,
                                   inputs={image_in: images[0]}, device=dev)

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
    del cc, ce, lc, le              # the compiled steps serve phase 4g

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
    del record, b0
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

    # 4g. observability on the card: the port's tracer over phase 4's walk
    #     and GEMM and the served model's eager and compiled steps
    def gemm_calls():
        for dtype, (x, w) in gemm_in.items():
            for controller in ("active", "passive"):
                ops.matmul(x, w, controller=controller,
                           vmem_budget=plan.SMEM_BUDGET)

    t0 = time.perf_counter()
    obs_launches = obs_on_card(
        torch, dev, smi, image_walk, gemm_calls,
        {"params": sparams, "prompts": prompts, "prefill": prefill_e,
         "decode": decode_e, "prefill_c": prefill_c, "decode_c": decode_c},
        image_ms)
    print(f"obs phase: {time.perf_counter() - t0:.1f} s, launches "
          f"{obs_launches}")
    del sparams, prefill_c, decode_c, image_walk, gemm_in, gemm_out

    # 4h. the mixture of experts: Qwen1.5-MoE-A2.7B served at full width,
    #     its cache plumbing and one MoE block against the CPU
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    moe_launches = moe_on_card(torch, dev, smi, graph_ms, time_ms, bound)
    print(f"moe phase: {time.perf_counter() - t0:.1f} s, launches {moe_launches}")

    # 4i. multi-head latent attention: DeepSeek-V2-Lite served at full width
    #     (4h's model and caches are freed with its frame), its cache
    #     plumbing, one MLA block against the CPU, flash at MLA's prefill
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    mla = mla_on_card(torch, dev, smi, graph_ms, time_ms, bound)
    print(f"mla phase: {time.perf_counter() - t0:.1f} s, launches {mla['counts']}")

    # 4j. the Mamba-2 SSM stack: Mamba2-1.3B and Jamba-v0.1 (2 periods)
    #     served at full width (4i's model and caches are freed with its
    #     frame), their cache plumbing, one mamba block against the CPU,
    #     flash at Jamba's attention
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ssm_run = ssm_on_card(torch, dev, smi, graph_ms, time_ms, bound)
    print(f"ssm phase: {time.perf_counter() - t0:.1f} s, launches {ssm_run['counts']}")
    jamba_counts = ssm_run["counts"]["jamba-v0.1-52b"]

    # 4k. cross-attention, the encoder and the modality inputs: SeamlessM4T
    #     and Llama-3.2-Vision (5 periods) served at full width (4j's models
    #     are freed with its frame), their first layers in fp32 against the
    #     CPU, flash at the slice's new shapes
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    cross = cross_on_card(torch, dev, smi, graph_ms, time_ms, bound)
    print(f"cross phase: {time.perf_counter() - t0:.1f} s, launches {cross['counts']}")

    # 4l. training on one card: the attention Function alone, Qwen2-1.5B
    #     trained at full width and depth through the launcher (4k's models
    #     are freed with its frame), one fp32 layer against the CPU, five
    #     smoke archs trained and one resumed
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    training = train_on_card(torch, dev, smi, time_ms, bound)
    print(f"train phase: {time.perf_counter() - t0:.1f} s, launches "
          f"{training['counts']}")

    # 4m. the SoC simulator: the zoo's NetPlans simulated and sim-planned on
    #     the host, the batched evaluator in torch on the card against numpy,
    #     the sim strategies' ResNet-18 schedules through conv2d_psum, and
    #     the roofline objective beside each layer's time
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    sim_launches = sim_on_card(torch, dev, graph_ms, smi)
    print(f"sim phase: {time.perf_counter() - t0:.1f} s, launches "
          f"{sim_launches}")

    # 4n. the fault harness: seeded fault schedules degrade ResNet-18's
    #     NetPlan, each degraded plan walked through conv2d_psum against
    #     cuDNN; the chaos harness on the host
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    fault_launches = faults_on_card(torch, dev, graph_ms, smi)
    print(f"fault phase: {time.perf_counter() - t0:.1f} s, launches "
          f"{fault_launches}")

    # 4o. the tensor-parallel partial-sum combines: Qwen1.5-MoE-A2.7B on a
    #     (1, 2) mesh of two processes on the card, active and passive, flash
    #     decoding off and on, against a one-process baseline
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    tp = tp_on_card(torch, dev, smi, graph_ms, time_ms, bound)
    tp_launches = tp["launches"]
    print(f"tp phase: {time.perf_counter() - t0:.1f} s, launches {tp_launches}")

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
            # phase 4g's launches: the traced walk and GEMM
            "obs_launches": obs_launches.get(name, 0),
            # phase 4m's launches: the sim strategies' and the sim NetPlan's
            # ResNet-18 walks (conv)
            **({"sim_launches": sim_launches[name],
                "sim_pack_launches": sim_launches[f"{name}/pack"]}
               if name in sim_launches else {}),
            # phase 4n's launches: the fault-degraded NetPlans' walks (conv)
            **({"fault_launches": fault_launches[name],
                "fault_pack_launches": fault_launches[f"{name}/pack"]}
               if name in fault_launches else {}),
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
        # phase 4g's launches: the traced eager prefill and decode steps
        "obs_launches": obs_launches["flash_attention"],
        # phase 4h's launches: Qwen1.5-MoE-A2.7B served
        "moe_launches": moe_launches["flash_attention"],
        "moe_combine_launches": moe_launches["flash_attention/combine"],
        # phase 4i's launches: DeepSeek-V2-Lite served (MLA's prefill), and
        # the kernel at MLA's prefill shapes
        "mla_launches": mla["counts"]["flash_attention"],
        "mla_prefill": mla["flash"],
        # phase 4j's launches: Jamba-v0.1 (2 periods) served, its 2
        # attention layers (Mamba2 launches none), and the kernel at
        # Jamba's attention
        "ssm_launches": jamba_counts["flash_attention"],
        "ssm_combine_launches": jamba_counts["flash_attention/combine"],
        "ssm_prefill": ssm_run["flash"]["prefill"],
        "ssm_decode": ssm_run["flash"]["decode"],
        # phase 4k's launches: SeamlessM4T (encoder, self- and
        # cross-attention) and Llama-3.2-Vision (5 periods) served, and the
        # kernel at the encoder's, cross-attention's and a ragged
        # non-causal shape
        "cross_launches": {name: c["flash_attention"]
                           for name, c in cross["counts"].items()},
        "cross_combine_launches": {name: c["flash_attention/combine"]
                                   for name, c in cross["counts"].items()},
        "cross_rows": cross["flash"],
        # phase 4l's launches: Qwen2-1.5B trained (one a layer and
        # microbatch, the forward only), the smoke archs trained, and the
        # attention Function alone at the training shapes
        "train_launches": training["counts"]["flash_attention"],
        "train_smoke_launches": {
            name: run["launches"].get("flash_attention", 0)
            for name, run in training["smoke"].items()},
        "train_attention": training["attention"],
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
        # phase 4o's launches: pass 1 alone, its partials handed back, in
        # both ranks' flash-decoding steps (no combine)
        "tp_flash_decode_launches": tp_launches.get("flash_attention", 0),
        "tp_flash_decode_combine_launches": tp_launches.get(
            "flash_attention/combine", 0),
        "tp_partials": tp["partials"],
        **{key: dd[key] for key in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                    "bound_by", "library_ms", "eager_ms")},
        "dtype": "bfloat16", "case": "decode, device position",
        "body": dd["body"]})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] in ("--tp-baseline", "--tp-rank"):
        if not (ROOT / "src" / "repro_torch").is_dir():
            fail(f"src/repro_torch not found beside {ROOT / 'chip_smoke.py'}")
        (tp_baseline if sys.argv[1] == "--tp-baseline" else tp_rank)(
            json.loads(sys.argv[2]))
    else:
        main()
