#!/usr/bin/env python3
"""Time variants of flash_attention's tc_3xtf32 body on one GPU, at
Qwen2-1.5B's prefill (batch 4, 12 q heads over 2 kv heads, S 1024, D 128,
causal, fp32), beside the library's cuda_core body and one fp32 SDPA call
of the same operands.

    python3 tools/flash_tf32_variants.py               # every variant
    python3 tools/flash_tf32_variants.py shipped kt64  # some of them

Each variant is ``csrc/flash_attention.cu`` with some edits, built by nvcc
into ``build/flash_tf32_variants/`` (one nvcc per variant, all at once) and
called through its C entry points as the port calls the shipped library:
the pack pass, then the body.

  shipped    the source as it is: 128 q rows a block (two consumer
             warpgroups), tiles of KT = 32 keys, one stage of K_hi, K_lo,
             Vt_hi and Vt_lo at D = 128; Q split in shared memory by the
             block; hi = rna(v); O accumulated in place by the tensor cores
  o_folded   O += PV summed from zero per tile in a second register tile
             and added into O in fp32 (64 registers more a thread)
  kt16       tiles of 16 keys (V^T rows 64-byte swizzled), two stages
  kt64       tiles of 64 keys; only one warpgroup of 64 q rows fits beside
             them
  wg1        one warpgroup of 64 q rows, KT = 32, two stages
  q_packed   Q split by a pass of its own into Q_hi and Q_lo in device
             memory (25 MB more read, 50 MB more written at this shape),
             both loaded by TMA; the block splits nothing
  raw_hi     hi = v unrounded (the tensor cores drop its low 13 bits) and
             lo = rna(v - trunc(v)), for K, V, Q and P
  no_loads   the producer issues no TMA copy and only arrives on each
             barrier: the consumers run the same products on whatever
             shared memory holds. Its time is what products, softmax and
             barriers cost without the operands' trip from L2; its result
             is not checked.

Times are replays of a CUDA graph of 20 calls (as ``chip_smoke.py`` times
the kernels): ``ms`` with the pack pass, ``body_ms`` without it. Each
variant's result but no_loads' is compared with the plain version
(`flash_plain` on the card): max abs error, and whether it holds 2e-4
(rtol = atol). ptxas's registers, spill stores and serialized-wgmma
warnings (C7515) of the D = 128 body are printed for each variant. Prints
one JSON line per variant and the card's name and power limit; exits 1 if
a checked variant misses 2e-4 or an edit no longer applies to the source.
"""

from __future__ import annotations

import ctypes
import json
import pathlib
import re
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
B, HQ, HKV, S, D = 4, 12, 2, 1024, 128
TOL = 2e-4


def wgmma_tf32_ss(n: int) -> str:
    """A TF32 ss wgmma wrapper of width n, in namespace hopper."""
    regs = n // 2
    d = ", ".join(f"%{i}" for i in range(regs))
    outs = ", ".join(f'"+f"(d[{i}])' for i in range(regs))
    return (f"namespace hopper {{\ntemplate <> struct WgmmaTf32<{n}> {{\n"
            f"  static __device__ __forceinline__ void ss(float (&d)[{regs}], "
            f"uint64_t da, uint64_t db, int acc) {{\n"
            f'    asm volatile("{{\\n.reg .pred p;\\nsetp.ne.b32 p, %{regs + 2}, 0;\\n"\n'
            f'        "wgmma.mma_async.sync.aligned.m64n{n}k8.f32.tf32.tf32 "\n'
            f'        "{{{d}}}, %{regs}, %{regs + 1}, p, 1, 1;\\n}}\\n"\n'
            f'        : {outs}\n        : "l"(da), "l"(db), "r"(acc));\n  }}\n}};\n}}\n')


INCLUDE = '#include "hopper.cuh"\n'
KT = "constexpr int KT = 32;         // keys per K and V^T tile"
WGS = "constexpr int WGS = 2;         // consumer warpgroups of 64 q rows a block"
PV = """    fence_regs(oacc);
    fence_regs(ph);
    fence_regs(pl);
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < KT / 8; ++j) {
      const uint64_t vh = vt_desc<D>(v_hi, j), vl = vt_desc<D>(v_lo, j);
      WgmmaTf32<D>::rs(oacc, pl[j], vh, 1);
      WgmmaTf32<D>::rs(oacc, ph[j], vl, 1);
      WgmmaTf32<D>::rs(oacc, ph[j], vh, 1);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(oacc);
"""
PV_FOLDED = """    float opart[D / 2];
    fence_regs(opart);
    fence_regs(ph);
    fence_regs(pl);
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < KT / 8; ++j) {
      const uint64_t vh = vt_desc<D>(v_hi, j), vl = vt_desc<D>(v_lo, j);
      WgmmaTf32<D>::rs(opart, pl[j], vh, j > 0);
      WgmmaTf32<D>::rs(opart, ph[j], vl, 1);
      WgmmaTf32<D>::rs(opart, ph[j], vh, 1);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(opart);
#pragma unroll
    for (int j = 0; j < D / 2; ++j) oacc[j] += opart[j];
"""
Q_LOAD = """      mbar_expect_tx(q_full, C::Q_BYTES);
      for (int c = 0; c < D / 32; ++c)
        tma_load(qs + c * C::QROWS * 128, &tq, c * 32, row0, bh, q_full);
"""
Q_LOAD_PACKED = """      mbar_expect_tx(q_full, 2 * C::Q_BYTES);
      for (int c = 0; c < D / 32; ++c) {
        tma_load(qs + c * C::QROWS * 128, &tq, c * 32, row0, bh, q_full);
        tma_load(qs + C::Q_BYTES + c * C::QROWS * 128, &tq, c * 32, row0, gridDim.x + bh, q_full);
      }
"""
Q_SPLIT_START = "  mbar_wait(q_full, 0);\n#pragma unroll\n  for (int c = 0; c < D / 32; ++c) {\n"
Q_SPLIT_END = "  fence_proxy_async();\n  bar_sync(1 + wg, 128);\n"
TQ = "tensor_map_3d(&tq, q, F32, 4, bh, sq_p, D, C::QROWS, 128)"
END = '}  // extern "C"\n'
# q_packed's Q pass: q (n floats) -> qs = Q_hi, Q_lo, each n floats
Q_PASS = """namespace {
__global__ void split_q(const float4* __restrict__ q, float4* __restrict__ qs, size_t n4) {
  for (size_t u = (size_t)blockIdx.x * blockDim.x + threadIdx.x; u < n4;
       u += (size_t)gridDim.x * blockDim.x) {
    const float4 x = q[u];
    float4 h, l;
    hopper::tf32_split(x.x, h.x, l.x);
    hopper::tf32_split(x.y, h.y, l.y);
    hopper::tf32_split(x.z, h.z, l.z);
    hopper::tf32_split(x.w, h.w, l.w);
    qs[u] = h;
    qs[n4 + u] = l;
  }
}
}  // namespace
extern "C" int flash_split_q(const void* q, void* qs, long long n, void* stream) {
  split_q<<<132 * 8, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(q), static_cast<float4*>(qs), (size_t)n / 4);
  return (int)cudaGetLastError();
}
"""
RAW_SPLIT = """namespace hopper {
// hi = v unrounded (the tensor cores drop its low 13 bits), lo = rna(v - trunc(v))
__device__ __forceinline__ void raw_split(float v, float& hi, float& lo) {
  hi = v;
  lo = isinf(v) ? 0.f : tf32_rna(v - __uint_as_float(__float_as_uint(v) & 0xFFFFE000u));
}
}
"""
PRODUCER_LOADS = [
    (Q_LOAD, "      mbar_arrive(q_full);\n"),
    ("""        mbar_expect_tx(k_full + s, 2 * C::KV_BYTES);
        for (int c = 0; c < D / 32; ++c) {
          tma_load(st + c * KT * 128, &tk, c * 32, i * KT, hk, k_full + s);
          tma_load(st + C::KV_BYTES + c * KT * 128, &tk, c * 32, i * KT, hkv + hk, k_full + s);
        }
""", "        mbar_arrive(k_full + s);\n"),
    ("""        mbar_expect_tx(v_full + s, 2 * C::KV_BYTES);
        for (int c = 0; c < 4 * KT / C::VSW; ++c) {
          const int key = i * KT + c * C::VSW / 4;
          tma_load(st + 2 * C::KV_BYTES + c * D * C::VSW, &tv, key, 0, hk, v_full + s);
          tma_load(st + 3 * C::KV_BYTES + c * D * C::VSW, &tv, key, 0, hkv + hk, v_full + s);
        }
""", "        mbar_arrive(v_full + s);\n"),
]


def _q_split_removed(text: str) -> str:
    """The consumers' in-block split of Q, cut out (q_packed)."""
    start = text.index(Q_SPLIT_START)
    end = text.index(Q_SPLIT_END, start) + len(Q_SPLIT_END)
    return text[:start] + "  mbar_wait(q_full, 0);\n" + text[end:]


EDITS = {
    "shipped": [],
    "o_folded": [(PV, PV_FOLDED)],
    "kt16": [(KT, "constexpr int KT = 16;"), (INCLUDE, INCLUDE + wgmma_tf32_ss(16))],
    "kt64": [(KT, "constexpr int KT = 64;"), (WGS, "constexpr int WGS = 1;")],
    "wg1": [(WGS, "constexpr int WGS = 1;")],
    "q_packed": [(Q_LOAD, Q_LOAD_PACKED), (TQ, TQ.replace(", bh,", ", 2 * bh,")),
                 (END, END + Q_PASS), (Q_SPLIT_START, None)],
    "raw_hi": [(INCLUDE, INCLUDE + RAW_SPLIT), ("tf32_split(", "raw_split(")],
    "no_loads": PRODUCER_LOADS,
}
KEY_TILE = {"kt64": 64}
UNCHECKED = {"no_loads"}


def _apply(name: str, text: str) -> str:
    for old, new in EDITS[name]:
        count = text.count(old)
        if count == 0 or (count > 1 and old != "tf32_split("):
            raise SystemExit(f"{name}: the source holds {count} copies of "
                             f"{old[:60]!r}, not one")
        text = _q_split_removed(text) if new is None else text.replace(old, new)
    return text


def _ptxas(log: str) -> dict:
    """Registers, spill stores and C7515 warnings of flash_kernel_tf32<128>."""
    out, fn = {"registers": None, "spill_stores": None}, ""
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line) or \
            re.search(r"Function properties for (\S+)", line)
        if m:
            fn = m.group(1)
        if "flash_kernel_tf32ILi128" not in fn:
            continue
        if m := re.search(r"(\d+) bytes spill stores", line):
            out["spill_stores"] = int(m.group(1))
        if m := re.search(r"Used (\d+) registers", line):
            out["registers"] = int(m.group(1))
    out["c7515"] = sum("C7515" in line and "flash_kernel_tf32" in line
                       for line in log.splitlines())
    return out


def build_variants(build, names, out_dir: pathlib.Path) -> dict:
    """One library per variant, compiled in parallel."""
    src = (build.CSRC / "flash_attention.cu").read_text()
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        cu = out_dir / f"flash_attention_{name}.cu"
        cu.write_text(_apply(name, src))
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
        print(f"{name}: ptxas {json.dumps(_ptxas(log))}", flush=True)
        libs[name] = so
    return libs


def main(argv: list[str]) -> int:
    import torch

    if not torch.cuda.is_available():
        print("flash_tf32_variants: no CUDA device", file=sys.stderr)
        return 1
    names = argv or list(EDITS)
    unknown = [n for n in names if n not in EDITS]
    if unknown:
        print(f"flash_tf32_variants: unknown variants {unknown}", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build, flash_attention

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(smi)
    libs = build_variants(_build, names, ROOT / "build" / "flash_tf32_variants")
    dev = torch.device("cuda", 0)
    gen = torch.Generator().manual_seed(0)
    q = torch.randn(B * HQ, S, D, generator=gen).to(dev)
    k, v = (torch.randn(B * HKV, S, D, generator=gen).to(dev) for _ in range(2))
    want = flash_attention.flash_plain(q, k, v, bq=128, bk=128, causal=True,
                                       q_offset=0, skv=S)
    scale = 1.0 / D ** 0.5

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

    q4 = q.view(B, HQ, S, D)
    k4, v4 = (t.view(B, HKV, S, D).repeat_interleave(HQ // HKV, 1) for t in (k, v))
    print(json.dumps({"variant": "sdpa", "ms": graph_ms(
        lambda: torch.nn.functional.scaled_dot_product_attention(
            q4, k4, v4, is_causal=True))}), flush=True)
    out = torch.empty_like(q)
    wrong = []
    for name, so in libs.items():
        lib = ctypes.CDLL(str(so))
        body = lib.flash_tf32_launch
        body.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 9 + [
            ctypes.c_float, ctypes.c_void_p]
        pack = lib.flash_attention_pack
        pack.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        skv_t = -(-S // KEY_TILE.get(name, 32)) * KEY_TILE.get(name, 32)
        ks = torch.empty(2, B * HKV, S, D, device=dev)
        vts = torch.empty(2, B * HKV, D, skv_t, device=dev)
        qs = torch.empty(2, B * HQ, S, D, device=dev) if name == "q_packed" else q

        def check(rc: int, what: str) -> None:
            if rc:
                raise RuntimeError(f"{name}: {what}: CUDA error {rc}")

        def run_pack() -> None:
            stream = torch.cuda.current_stream(dev).cuda_stream
            check(pack(k.data_ptr(), v.data_ptr(), ks.data_ptr(), vts.data_ptr(),
                       B * HKV, S, skv_t, D, stream), "pack")
            if name == "q_packed":
                lib.flash_split_q.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                              ctypes.c_longlong, ctypes.c_void_p]
                check(lib.flash_split_q(q.data_ptr(), qs.data_ptr(), q.numel(),
                                        stream), "split_q")

        def run_body() -> None:
            check(body(qs.data_ptr(), ks.data_ptr(), vts.data_ptr(), out.data_ptr(),
                       B * HQ, S, S, skv_t, S, D, HQ // HKV, 1, 0, scale,
                       torch.cuda.current_stream(dev).cuda_stream), "body")

        def call() -> None:
            run_pack()
            run_body()

        row = {"variant": name, "ms": graph_ms(call), "body_ms": graph_ms(run_body)}
        if name == "shipped":
            row["pack_ms"] = graph_ms(run_pack)
            core = lib.flash_attention_launch
            core.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 9 + [
                ctypes.c_float, ctypes.c_void_p]
            row["cuda_core_ms"] = graph_ms(lambda: check(core(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), 0, B * HQ,
                S, S, S, D, HQ // HKV, 1, 0, scale,
                torch.cuda.current_stream(dev).cuda_stream), "cuda_core"))
        if name not in UNCHECKED:
            out.zero_()
            call()
            torch.cuda.synchronize()
            row["max_abs_err"] = (out - want).abs().max().item()
            row["holds_tol"] = torch.allclose(out, want, rtol=TOL, atol=TOL)
            if not row["holds_tol"]:
                wrong.append(f"{name}: max abs err {row['max_abs_err']}")
        print(json.dumps(row), flush=True)
    print(smi)
    for line in wrong:
        print(f"flash_tf32_variants: WRONG: {line}", file=sys.stderr)
    return 1 if wrong else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
