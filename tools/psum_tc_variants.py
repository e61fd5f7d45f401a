#!/usr/bin/env python3
"""Time variants of psum_matmul's tc_bf16 body on one GPU, at the main
path's GEMM (4096 x 1536 x 8960 in bf16, 128 x 128 x 128 blocks), beside
one `torch.matmul` of the same operands.

    python3 tools/psum_tc_variants.py       # from the root of a checkout

Each variant is ``csrc/psum_matmul.cu`` with one edit, built by nvcc into
``build/psum_tc_variants/`` (one nvcc per variant, all at once) and called
through its C entry point as the port calls the shipped library:

  shipped       the source as it is (3 stages, two blocks an SM)
  stages2       a 2-stage ring, two blocks an SM
  stages4       a 4-stage ring, one block an SM
  stages6       a 6-stage ring, one block an SM
  no_loads      the shipped ring, but the producer issues no TMA copy and
                only arrives on the stage's barrier: the consumers run the
                same wgmmas on whatever shared memory holds. Its time is
                what the products, barriers and C stores cost without the
                operands' trip from L2 (or device memory); its result is
                not checked.

Times are replays of a CUDA graph of 20 calls (as ``chip_smoke.py`` times
the kernels), the passive call's 12 launches included. Each checked
variant's result is held against an fp32 `torch.matmul` of the bf16
operands. Prints one JSON line per variant and the card's name and power
limit.
"""

from __future__ import annotations

import ctypes
import json
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
M, K, N, BLOCK = 4096, 1536, 8960, 128
TOL = 2e-2

STAGES = "constexpr int STAGES = 3;"
MIN_BLOCKS = "constexpr int MIN_BLOCKS = 2;"
LOADS = """        mbar_expect_tx(full + s, bytes);
        tma_load_2d(as + s * C::A_BYTES, &tx, k0, row0, full + s);
#pragma unroll
        for (int c = 0; c < BN / 64; ++c)
          tma_load_2d(bs + s * C::B_BYTES + c * KC * SW, &tw, col0 + 64 * c, k0, full + s);
"""
EDITS = {
    "shipped": [],
    "stages2": [(STAGES, "constexpr int STAGES = 2;")],
    "stages4": [(STAGES, "constexpr int STAGES = 4;"),
                (MIN_BLOCKS, "constexpr int MIN_BLOCKS = 1;")],
    "stages6": [(STAGES, "constexpr int STAGES = 6;"),
                (MIN_BLOCKS, "constexpr int MIN_BLOCKS = 1;")],
    "no_loads": [(LOADS, "        mbar_arrive(full + s);\n")],
}


def build_variants(build, out_dir: pathlib.Path) -> dict[str, pathlib.Path]:
    """One library per variant, compiled in parallel."""
    src = (build.CSRC / "psum_matmul.cu").read_text()
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, edits in EDITS.items():
        text = src
        for old, new in edits:
            if old not in text:
                raise SystemExit(f"{name}: the source no longer holds {old!r}")
            text = text.replace(old, new)
        cu = out_dir / f"psum_matmul_{name}.cu"
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
        print("psum_tc_variants: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build, psum_matmul

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(smi)
    libs = build_variants(_build, ROOT / "build" / "psum_tc_variants")
    dev = torch.device("cuda", 0)
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(M, K, generator=gen).to(dev, torch.bfloat16)
    w = torch.randn(K, N, generator=gen).to(dev, torch.bfloat16)
    want = torch.matmul(x.float(), w.float())

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

    print(json.dumps({"variant": "torch.matmul",
                      "ms": graph_ms(lambda: torch.matmul(x, w))}))
    for name, so in libs.items():
        fn = ctypes.CDLL(str(so)).psum_matmul_launch
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 11 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        row = {"variant": name}
        for passive in (0, 1):
            out = torch.empty(M, N, device=dev,
                              dtype=torch.float32 if passive else torch.bfloat16)
            steps = ([(k0, k0 + BLOCK) for k0 in range(0, K, BLOCK)] if passive
                     else [(0, K)])

            def call():
                stream = torch.cuda.current_stream(dev).cuda_stream
                for k_begin, k_end in steps:
                    rc = fn(x.data_ptr(), w.data_ptr(), out.data_ptr(),
                            psum_matmul.DTYPE_CODES[torch.bfloat16],
                            psum_matmul.BODY_CODES["tc_bf16"], passive, 0, M,
                            N, K, BLOCK, BLOCK, k_begin, k_end, stream)
                    if rc:
                        raise RuntimeError(f"{name}: CUDA error {rc}")

            key = "passive" if passive else "active"
            row[f"{key}_ms"] = graph_ms(call)
            if name != "no_loads":
                call()
                torch.cuda.synchronize()
                err = (out.float() - want).abs().max().item()
                if not torch.allclose(out.float(), want, rtol=TOL, atol=TOL):
                    raise SystemExit(f"{name} {key}: max abs err {err}")
                row[f"{key}_max_abs_err"] = err
        print(json.dumps(row), flush=True)
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
