#!/usr/bin/env python3
"""Time variants of conv2d_psum's two bodies on one GPU, at the main path's
512 -> 512 3x3 layer of ResNet-18 (56 px, exact_opt at P = 2048: m = 14,
n = 16), beside one cuDNN call of the same operands.

    python3 tools/conv_variants.py          # from the root of a checkout

Each source variant is ``csrc/conv2d_psum.cu`` with one edit, built by
nvcc into ``build/conv_variants/`` (one nvcc per variant, all at once) and
called through its C entry points as the port calls the shipped library,
tc_bf16 in bf16 and cuda_core in fp32:

  shipped     the source as it is: the pack pass, then the body
  pack_only   the pack pass alone (the body is not launched)
  no_pack     the body alone, on whatever the scratch holds
  no_copies   the body without its bulk copies: thread 0 only arrives on
              the stage's barrier, and the products run on whatever shared
              memory holds; what the products, fragments and barriers cost
              without the slab and weights' trip into shared memory
  core_unroll1  cuda_core's channel loop not unrolled (shipped: by two)
  core smem S   the shipped library with cuda_core blocks of at most S KiB
              of shared memory (`conv2d_psum.CORE_SMEM`)
  cout blocks C  the shipped library with C cout blocks per tc_bf16
              thread block (the plan takes the widest of
              `conv2d_psum.TC_GROUPS` whose grid has TC_MIN_BLOCKS blocks)

Only ``shipped`` and the geometry rows (cout blocks, core smem) are checked,
against `conv_plain` on the card (bf16 5e-2, fp32 1e-4); the ``core_``
variant runs in fp32 only. Times are replays of a CUDA graph of 20 calls,
as ``chip_smoke.py`` times the kernels. Prints one JSON line per variant and
the card's name and power limit.
"""

from __future__ import annotations

import ctypes
import json
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
CIN = COUT = 512
HW, KK, BM, BN = 56, 3, 14, 16
TOL = {"float32": 1e-4, "bfloat16": 5e-2}

PACK_THEN_BODY = ("  if (const int rc = (int)cudaGetLastError()) return rc;\n"
                  "  switch (")
EDITS = {
    "shipped": [],
    "pack_only": [(PACK_THEN_BODY, "  return (int)cudaGetLastError();\n  switch (")],
    "no_pack": [("  pack<T><<<", "  if (0) pack<T><<<"), ("  pack<<<", "  if (0) pack<<<")],
    "no_copies": [
        ("    mbar_expect_tx(full + st, nc * row_bytes + w_bytes);\n"
         "    for (int c = 0; c < nc; ++c)\n",
         "    mbar_arrive(full + st);\n    for (int c = 0; c < 0; ++c)\n"),
        ("    bulk_load(ws, wt", "    if (0) bulk_load(ws, wt"),
        ("    mbar_expect_tx(full + st, 2 * ng * row_bytes + w_bytes);\n"
         "    for (int h = 0; h < 2 * ng; ++h)\n",
         "    mbar_arrive(full + st);\n    for (int h = 0; h < 0; ++h)\n"),
        ("    bulk_load(wb, wt", "    if (0) bulk_load(wb, wt"),
    ],


    "core_unroll1": [("#pragma unroll 2\n      for (int c = 0; c < nc; ++c) {",
                      "#pragma unroll 1\n      for (int c = 0; c < nc; ++c) {")],

}
GROUPS = (8, 4, 2, 1)


def build_variants(build, out_dir: pathlib.Path) -> dict[str, pathlib.Path]:
    """One library per variant, compiled in parallel."""
    src = (build.CSRC / "conv2d_psum.cu").read_text()
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, edits in EDITS.items():
        text = src
        for old, new in edits:
            if old not in text:
                raise SystemExit(f"{name}: the source no longer holds {old!r}")
            text = text.replace(old, new)
        cu = out_dir / f"conv2d_psum_{name}.cu"
        cu.write_text(text)
        so = cu.with_suffix(".so")
        cmd = [build.nvcc(), *build.NVCC_FLAGS, "-I", str(build.CSRC), "-o",
               str(so), str(cu)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True), so)
    libs = {}
    for name, (proc, so) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"{name}: nvcc exited {proc.returncode}\n{log}")
        libs[name] = so
    return libs


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("conv_variants: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build
    from repro_torch.kernels import conv2d_psum as conv

    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(smi)
    libs = build_variants(_build, ROOT / "build" / "conv_variants")
    dev = torch.device("cuda", 0)
    gen = torch.Generator().manual_seed(0)
    hp = HW + KK - 1

    def time_ms(fn, reps: int) -> float:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / reps

    def graph_ms(fn, calls: int = 20, reps: int = 5) -> float:
        fn()
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(calls):
                fn()
        graph.replay()
        torch.cuda.synchronize()
        return time_ms(graph.replay, reps) / calls

    def plan_for(dtype, cpb=None, core_smem=None):
        saved = conv.TC_GROUPS, conv.TC_MIN_BLOCKS, conv.CORE_SMEM
        if cpb is not None:
            conv.TC_GROUPS, conv.TC_MIN_BLOCKS = (cpb,), 0
        if core_smem is not None:
            conv.CORE_SMEM = core_smem
        conv.conv_launch_plan.cache_clear()      # plans are cached per arguments
        try:
            return conv.conv_launch_plan(cin=CIN, hp=hp, wp=hp, cout=COUT,
                                         kk=KK, block_m=BM, block_n=BN,
                                         dtype=dtype)
        finally:
            conv.TC_GROUPS, conv.TC_MIN_BLOCKS, conv.CORE_SMEM = saved
            conv.conv_launch_plan.cache_clear()

    def caller(so, lp, x, w, out):
        geo = lp.cuda.keywords["geo"]
        cin_p = x.shape[0]
        scratch = torch.empty(
            conv.scratch_bytes(lp.body, geo, cin_p=cin_p, hp=hp, kk=KK, bm=BM,
                               wp=hp), dtype=torch.uint8, device=dev)
        lib = ctypes.CDLL(str(so))
        shape = (cin_p, hp, hp, w.shape[0], HW, HW, KK, 1, BM, BN)
        ptrs = (x.data_ptr(), w.data_ptr(), out.data_ptr(), scratch.data_ptr())
        if lp.body == "tc_bf16":
            fn = lib.conv2d_psum_tc_launch
            fn.argtypes = conv._C_ARGS["conv2d_psum_tc_launch"]
            args = (*ptrs, *shape, geo["cpb"], geo["nb"], geo["nt"], geo["nw"],
                    geo["n_split"], geo["rows_in"], geo["gcs"],
                    geo["smem_bytes"], 0)
        else:
            fn = lib.conv2d_psum_core_launch
            fn.argtypes = conv._C_ARGS["conv2d_psum_core_launch"]
            args = (*ptrs, conv.DTYPE_CODES[x.dtype], *shape, geo["ti"],
                    geo["gpb"], geo["n_split"], geo["rows_in"], geo["pitch"],
                    geo["mc"], geo["smem_bytes"], geo["n_tiles"], 0)
        fn.restype = ctypes.c_int

        def call(_keep=scratch):              # the call holds its scratch
            rc = fn(*args, torch.cuda.current_stream(dev).cuda_stream)
            if rc:
                raise RuntimeError(f"{so.name}: CUDA error {rc}")
        return call

    for dtype in (torch.bfloat16, torch.float32):
        dname = str(dtype).removeprefix("torch.")
        lp = plan_for(dtype)
        x = torch.randn(lp.inputs[0].array_shape, generator=gen).to(dev, dtype)
        w = (torch.randn(lp.inputs[1].array_shape, generator=gen)
             / (CIN * KK * KK) ** 0.5).to(dev, dtype)
        want = lp.plain(x, w).float()
        print(json.dumps({"variant": "cudnn", "dtype": dname, "ms": graph_ms(
            lambda: torch.nn.functional.conv2d(x[None, :CIN], w[:COUT, :CIN]))}))
        runs = [(name, so, lp) for name, so in libs.items()
                if dtype == torch.float32 or not name.startswith("core_")]
        if dtype == torch.bfloat16:
            runs += [(f"cout blocks {c}", libs["shipped"], plan_for(dtype, cpb=c))
                     for c in GROUPS]
        else:
            runs += [(f"core smem {kib}", libs["shipped"],
                      plan_for(dtype, core_smem=kib * 1024)) for kib in (80, 32)]
        for name, so, plan in runs:
            out = torch.empty(plan.outputs[0].array_shape, dtype=dtype, device=dev)
            call = caller(so, plan, x, w, out)
            row = {"variant": name, "dtype": dname, "body": plan.body,
                   "grid": plan.grid, "threads": plan.threads,
                   "smem_bytes": plan.smem_bytes, "ms": graph_ms(call)}
            if name == "shipped" or name.startswith(("cout blocks", "core smem")):
                call()
                torch.cuda.synchronize()
                err = (out.float() - want).abs().max().item()
                if not torch.allclose(out.float(), want, rtol=TOL[dname],
                                      atol=TOL[dname]):
                    raise SystemExit(f"{name} {dname}: max abs err {err}")
                row["max_abs_err"] = err
            print(json.dumps(row), flush=True)
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
