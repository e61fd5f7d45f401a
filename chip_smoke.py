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
                                 up-projection at 4096 tokens), fp32 and bf16
     conv2d_psum                 the 512 -> 512 3x3 layer of ResNet-18 at
                                 56 x 56 px under its exact_opt schedule,
                                 fp32 and bf16
   and runs both kernels' other cases at small shapes (every activation,
   padded edges, odd channel blocks, stride 2, K in {1, 3, 7}) against the
   plain versions on the CPU.
4. Drives the main path with every launch count set to 0 first: ResNet-18 at
   full channel width (``NetworkGraph.from_cnn("resnet18").shrink(56, 1)``,
   exact_opt/active schedules at P = 2048 MACs) answers 4 seeded images
   through ``run_network_kernels``, and the GEMM above runs through
   ``ops.matmul`` under both controllers in fp32 and bf16. Every output is
   checked against a library reference, and every kernel must have launched.
5. Prints ``{"kernels": [...]}`` and, last, ``{"ok": true, "device": ...}``.

Any failed check exits non-zero. Without a CUDA device, or without the
repository's ``src/repro_torch`` beside it, it exits non-zero and prints no
result.
"""

from __future__ import annotations

import json
import pathlib
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
    from repro_torch.kernels import _build, conv2d_psum, launch, ops, psum_matmul, ref
    from repro_torch.kernels.conv_network import (init_network_params,
                                                  run_network_kernels,
                                                  run_network_reference)
    from repro_torch.plan.graph import NetworkGraph

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    peak = {torch.float32: 67e12, torch.bfloat16: 989e12}  # H100 SXM, dense
    dev = torch.device("cuda", 0)

    # 1. build
    t0 = time.perf_counter()
    paths = _build.build()
    print(f"build: {len(paths)} libraries in {time.perf_counter() - t0:.1f} s")
    for name, path in paths.items():
        for line in path.with_suffix(".log").read_text().splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")

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

    def bound(flops: float, nbytes: float, dtype) -> tuple[float, str]:
        t_ops, t_mem = flops / peak[dtype], nbytes / HBM_BYTES_PER_S
        return (1e3 * max(t_ops, t_mem), "operations" if t_ops >= t_mem else "bytes")

    gen = torch.Generator(device="cpu").manual_seed(0)
    rows: dict[str, dict] = {}

    # 3a. psum_matmul at the GEMM's planned blocks
    wl = plan.MatmulWorkload(m=M, n=N, k=K)
    sched = plan.plan(wl, plan.SMEM_BUDGET, "exhaustive_vmem", "active").schedule
    print(f"gemm {M}x{K}x{N}: blocks bm={sched.bm} bn={sched.bn} bk={sched.bk}")
    gemm_in = {}
    for dtype in (torch.float32, torch.bfloat16):
        x = torch.randn(M, K, generator=gen).to(dev, dtype)
        w = torch.randn(K, N, generator=gen).to(dev, dtype)
        gemm_in[dtype] = (x, w)
        dname = str(dtype).removeprefix("torch.")
        for controller in ("active", "passive"):
            lp = psum_matmul.matmul_launch_plan(m=M, k=K, n=N, bm=sched.bm,
                                                bn=sched.bn, bk=sched.bk,
                                                controller=controller)
            got = lp.cuda(x, w)
            want = lp.plain(x, w)
            torch.cuda.synchronize()
            tol = MATMUL_TOL[dname]
            err = (got.float() - want.float()).abs().max().item()
            if not torch.allclose(got.float(), want.float(), rtol=tol, atol=tol):
                fail(f"{lp.name} {dname}: kernel vs plain max abs err {err}")
            out_size = 4 if controller == "passive" else x.element_size()
            b_ms, b_by = bound(float(wl.flops),
                               (M * K + K * N) * x.element_size() + M * N * out_size,
                               dtype)
            stats = {"max_abs_err": err, "ms": time_ms(lambda: lp.cuda(x, w)),
                     "plain_ms": time_ms(lambda: lp.plain(x, w)),
                     "bound_ms": b_ms, "bound_by": b_by,
                     "library_ms": time_ms(lambda: torch.matmul(x, w)),
                     "launches_per_call": lp.launches}
            print(f"{lp.name} {dname}: " + " ".join(
                f"{k}={v:.4g}" if isinstance(v, float) else f"{k}={v}"
                for k, v in stats.items()))
            rows.setdefault(lp.name, {})[dname] = stats
            del got, want

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
    print(f"conv {cw.name} {cw.cin}->{cw.cout} k{cw.k} at {cw.hi}px: "
          f"m={big.schedule.m} n={big.schedule.n} grid={cp.grid} "
          f"threads={cp.threads} smem={cp.smem_bytes}")
    for dtype, tol in ((torch.float32, CONV_TOL), (torch.bfloat16, 5e-2)):
        dname = str(dtype).removeprefix("torch.")
        xd, wd, xpd, wpd = (t.to(dtype) for t in (xc, wc, xcp, wcp))
        got = cp.cuda(xpd, wpd)
        want = cp.plain(xpd, wpd)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        if not torch.allclose(got.float(), want.float(), rtol=tol, atol=tol):
            fail(f"conv2d_psum {dname}: kernel vs plain max abs err {err}")
        b_ms, b_by = bound(2.0 * cw.macs, xd.element_size() * (
            xd.numel() + wd.numel() + cw.cout * cw.ho * cw.wo), dtype)
        stats = {"max_abs_err": err, "ms": time_ms(lambda: cp.cuda(xpd, wpd)),
                 "plain_ms": time_ms(lambda: cp.plain(xpd, wpd)),
                 "bound_ms": b_ms, "bound_by": b_by,
                 "library_ms": time_ms(
                     lambda: torch.nn.functional.conv2d(xd[None], wd)),
                 "launches_per_call": cp.launches}
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
        for stride in (1, 2):
            for kk in (1, 3, 7):
                hp = 9 + 2 * (kk // 2)
                xs = torch.randn(30, hp, hp, generator=gen).to(dtype)
                ws = torch.randn(40, 30, kk, kk, generator=gen).to(dtype)
                kw = dict(block_m=13, block_n=17, stride=stride, act="silu")
                got = conv2d_psum.conv2d_psum(xs.to(dev), ws.to(dev), **kw).cpu()
                want = conv2d_psum.conv2d_psum(xs, ws, **kw)
                tol = CONV_TOL if dtype == torch.float32 else 5e-2
                if not torch.allclose(got.float(), want.float(), rtol=tol, atol=tol):
                    fail(f"conv2d_psum stride {stride} k{kk} {dname}")
                cases += 1
    print(f"small cases: {cases} kernel launches on the card match the plain "
          f"versions on the CPU")

    # 4. the main path, counted (one image first, uncounted, loads every
    #    kernel variant and warms the allocator)
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
    gk = -(-K // sched.bk)
    expect = {"conv2d_psum": convs * IMAGES, "psum_matmul/active": 2,
              "psum_matmul/passive": 2 * gk}
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
    busy, conv_busy = 0.0, 0.0
    for evt in prof.key_averages():
        dev_us = getattr(evt, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(evt, "self_cuda_time_total", 0.0)
        busy += dev_us / 1e3
        if "conv_kernel" in evt.key:
            conv_busy += dev_us / 1e3
    median_ms = sorted(image_ms)[len(image_ms) // 2]
    print(f"profile (one image): device busy {busy:.3f} ms, conv2d_psum kernels "
          f"{conv_busy:.3f} ms ({conv_busy / busy:.3f} of busy); wall "
          f"{wall:.3f} ms profiled, {median_ms:.3f} ms unprofiled (median "
          f"image); idle share of the unprofiled wall {1 - busy / median_ms:.3f}")
    for node, p in zip(graph.workload_nodes, plans):
        wl, pad = node.workload, node.workload.k // 2
        lp = conv2d_psum.conv_launch_plan(
            cin=wl.cin, hp=wl.hi + 2 * pad, wp=wl.wi + 2 * pad, cout=wl.cout,
            kk=wl.k, block_m=p.schedule.m, block_n=p.schedule.n)
        xl = torch.zeros(lp.inputs[0].array_shape, device=dev)
        wt = torch.zeros(lp.inputs[1].array_shape, device=dev)
        ms = time_ms(lambda: lp.cuda(xl, wt), reps=10)
        print(f"layer {node.name}: {wl.cin}->{wl.cout} k{wl.k} m={p.schedule.m} "
              f"n={p.schedule.n} grid={lp.grid} threads={lp.threads} "
              f"ms={ms:.4f} gflops={2e-6 * wl.macs / ms:.1f}")

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
            "dtype": "float32",
            "by_dtype": by_dtype})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
