#!/usr/bin/env python3
"""Time variants of psum_matmul's tc_3xtf32 body on one GPU, at the main
path's GEMM (4096 x 1536 x 8960 in fp32, 128 x 128 x 128 blocks), beside
one `torch.matmul` (SGEMM, TF32 off) of the same operands.

    python3 tools/psum_tf32_variants.py     # from the root of a checkout

Each variant is ``csrc/psum_matmul.cu`` with some edits, built by nvcc into
``build/psum_tf32_variants/`` (one nvcc per variant, all at once) and
called through its C entry points as the port calls the shipped library:
the pack pass, then the body once (active) or once per k-step (passive).

  shipped    the source as it is: 3 stages of four operand boxes (X_hi,
             X_lo, Wt_hi, Wt_lo; 64 KiB a stage), one block an SM; the
             tensor cores sum FOLD = 4 chunks from zero, and the block adds
             each sum into its accumulator in fp32; active blocks take their
             tiles in groups of 8 tile rows, passive ones in launch order
  fold1, fold2, fold12
             FOLD = 1, 2, 12: more folds cost waits on the tensor cores,
             fewer let their truncating sums grow
  unfolded   no fold: the tensor cores sum all of K into one accumulator
             (the body's first version); misses 1e-3 at K = 1536
  pingpong   two partial tiles, so no fold waits for the tensor cores: a
             group's sum is added after the next group's first chunk is
             issued
  launch_order     active blocks too take their tiles in launch order (a
                   wave reads 1.9 tile rows of X and all 110 MB of Wt)
  grouped_passive  passive blocks too take them in groups of 8 tile rows
  stages2    a 2-stage ring
  no_loads   the shipped ring, but the producer issues no TMA copy and only
             arrives on the stage's barrier: the consumers run the same
             wgmmas on whatever shared memory holds. Its time is what the
             products, barriers and C stores cost without the operands'
             trip from L2; its result is not checked.
  wide       blocks of 128 x 256 (two warpgroups of m64n256k8, grid 35 x
             32), 2 stages of 96 KiB: X's boxes are shared by twice the
             columns, so L2 -> shared traffic falls by a quarter
  a_regs     X staged once in fp32 (the pack leaves X unsplit) and split
             into hi and lo in registers after an ldmatrix per k8 step;
             wgmma takes A from registers. Three boxes a stage, not four,
             so that traffic also falls by a quarter
  wide and a_regs sum as unfolded does: a second 128-column tile (wide) or
  two chunks' fragments (a_regs) beside a folded pair of accumulators would
  not fit the registers, so they time the traffic they save against
  unfolded's time, and their error is printed, not held.

Times are replays of a CUDA graph of 20 calls (as ``chip_smoke.py`` times
the kernels): ``*_ms`` with the pack pass, ``*_body_ms`` without it. Each
variant's result but no_loads' is compared with the SGEMM: max abs error,
and whether it holds 1e-3 (rtol = atol). Prints one JSON line per variant
and the card's name and power limit; exits 1 if a folding variant misses
1e-3 or an edit no longer applies to the source.
"""

from __future__ import annotations

import ctypes
import json
import pathlib
import re
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
M, K, N, BLOCK = 4096, 1536, 8960, 128
TOL = 1e-3


def wgmma_tf32(n: int, name: str, a_regs: bool) -> str:
    """A TF32 wgmma wrapper of width n in namespace hopper: ``ss`` (A by
    descriptor) or ``rs`` (A from four registers)."""
    regs = n // 2
    d = ", ".join(f"%{i}" for i in range(regs))
    outs = ", ".join(f'"+f"(d[{i}])' for i in range(regs))
    if a_regs:
        a, db, p = (f"{{%{regs}, %{regs + 1}, %{regs + 2}, %{regs + 3}}}",
                    f"%{regs + 4}", regs + 5)
        sig = f"float (&d)[{regs}], const uint32_t (&a)[4], uint64_t db"
        ins = ('"r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1)')
        fn = "rs"
    else:
        a, db, p = f"%{regs}", f"%{regs + 1}", regs + 2
        sig = f"float (&d)[{regs}], uint64_t da, uint64_t db, int acc"
        ins = '"l"(da), "l"(db), "r"(acc)'
        fn = "ss"
    return (f"namespace hopper {{\ntemplate <int N> struct {name};\n"
            f"template <> struct {name}<{n}> {{\n"
            f"  static __device__ __forceinline__ void {fn}({sig}) {{\n"
            f'    asm volatile("{{\\n.reg .pred p;\\nsetp.ne.b32 p, %{p}, 0;\\n"\n'
            f'        "wgmma.mma_async.sync.aligned.m64n{n}k8.f32.tf32.tf32 "\n'
            f'        "{{{d}}}, {a}, {db}, p, 1, 1;\\n}}\\n"\n'
            f"        : {outs}\n        : {ins});\n  }}\n}};\n}}\n")


INCLUDE = '#include "hopper.cuh"\n'
STAGES = "constexpr int STAGES = 3;      // ring depth of tc_3xtf32"
LOADS = """        mbar_expect_tx(full + s, bytes);
        tma_load_2d(st, &tx, k0, row0, full + s);
        tma_load_2d(st + C::A_BYTES, &tx, k0, mp + row0, full + s);
        tma_load_2d(st + 2 * C::A_BYTES, &tw, k0, col0, full + s);
        tma_load_2d(st + 2 * C::A_BYTES + C::B_BYTES, &tw, k0, np + col0, full + s);
"""
DISPATCH = """int launch_blocks(const float* xs, const float* wts, float* out, int passive, int act, int mp,
                  int np, int kp, int bm, int bn, int k_begin, int k_end, cudaStream_t s) {
"""
ENTRY_CHECK = "  if (bm < 1 || bm > TILE || bn < 1 || bn > TILE || mp % bm || np % bn ||"
CONSUMER = """  // The tensor cores sum a group of FOLD chunks into part, from zero; acc
  // takes each group's sum with an fp32 add that rounds to nearest.
  float part[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) part[i] = 0.f;
  for (int i = 0; i < n_chunks; ++i) {
    const int s = i % STAGES;
    mbar_wait(full + s, (i / STAGES) & 1);
    const uint32_t xh = smem_u32(ring + s * C::STAGE) + wg * 64 * SW;
    const uint32_t xl = xh + C::A_BYTES;
    const uint32_t wh = smem_u32(ring + s * C::STAGE + 2 * C::A_BYTES);
    const uint32_t wl = wh + C::B_BYTES;
    fence_regs(part);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KC / 8; ++kk) {
      // k-step kk is 32 bytes into each 128-byte row of every operand;
      // 8-row groups 1024 bytes apart. The small terms first; a group's
      // first product overwrites part.
      const uint64_t dxh = mat_desc<SW>(xh + kk * 32, 16, 8 * SW);
      const uint64_t dxl = mat_desc<SW>(xl + kk * 32, 16, 8 * SW);
      const uint64_t dwh = mat_desc<SW>(wh + kk * 32, 16, 8 * SW);
      const uint64_t dwl = mat_desc<SW>(wl + kk * 32, 16, 8 * SW);
      WgmmaTf32<BN>::ss(part, dxl, dwh, kk > 0 || i % FOLD > 0);
      WgmmaTf32<BN>::ss(part, dxh, dwl, 1);
      WgmmaTf32<BN>::ss(part, dxh, dwh, 1);
    }
    wgmma_commit();
    if (i % FOLD == FOLD - 1 || i == n_chunks - 1) {
      wgmma_wait<0>();   // the group is summed: fold it
      fence_regs(part);
#pragma unroll
      for (int j = 0; j < BN / 2; ++j) acc[j] += part[j];
    } else {
      wgmma_wait<1>();   // the previous chunk's products are done
      fence_regs(part);
    }
    if (i > 0) mbar_arrive(empty + (i - 1) % STAGES);   // free its stage
  }

"""
# unfolded: the tensor cores sum all of K into the block's accumulator, as
# the body's first version did
UNFOLDED = """  for (int i = 0; i < n_chunks; ++i) {
    const int s = i % STAGES;
    mbar_wait(full + s, (i / STAGES) & 1);
    const uint32_t xh = smem_u32(ring + s * C::STAGE) + wg * 64 * SW;
    const uint32_t xl = xh + C::A_BYTES;
    const uint32_t wh = smem_u32(ring + s * C::STAGE + 2 * C::A_BYTES);
    const uint32_t wl = wh + C::B_BYTES;
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KC / 8; ++kk) {
      // k-step kk is 32 bytes into each 128-byte row of every operand;
      // 8-row groups 1024 bytes apart. The small terms first.
      const uint64_t dxh = mat_desc<SW>(xh + kk * 32, 16, 8 * SW);
      const uint64_t dxl = mat_desc<SW>(xl + kk * 32, 16, 8 * SW);
      const uint64_t dwh = mat_desc<SW>(wh + kk * 32, 16, 8 * SW);
      const uint64_t dwl = mat_desc<SW>(wl + kk * 32, 16, 8 * SW);
      WgmmaTf32<BN>::ss(acc, dxl, dwh, 1);
      WgmmaTf32<BN>::ss(acc, dxh, dwl, 1);
      WgmmaTf32<BN>::ss(acc, dxh, dwh, 1);
    }
    wgmma_commit();
    wgmma_wait<1>();   // the previous chunk's products are done: free its stage
    fence_regs(acc);
    if (i > 0) mbar_arrive(empty + (i - 1) % STAGES);
  }
  wgmma_wait<0>();
  fence_regs(acc);
"""
# a_regs: the A fragment of a k8 step (rows 16 w + g and + 8, columns t and
# t + 4 of the warp's 16 rows) is one ldmatrix.x4 of 8 x 16-byte rows: lane
# l addresses row l % 8 + 8 (l / 8 % 2) of 16-byte column 2 kk + l / 16,
# at its place in the 128-byte swizzle. The fragments of two chunks are in
# flight at once (the loop is unrolled by two), so a chunk's registers are
# rewritten only after its wgmmas are done.
A_REGS_CONSUMER = """  uint32_t ah0[KC / 8][4], al0[KC / 8][4], ah1[KC / 8][4], al1[KC / 8][4];
  auto chunk = [&](int i, uint32_t (&fh)[KC / 8][4], uint32_t (&fl)[KC / 8][4],
                   uint32_t (&gh)[KC / 8][4], uint32_t (&gl)[KC / 8][4]) {
    const int s = i % STAGES;
    mbar_wait(full + s, (i / STAGES) & 1);
    const uint32_t xh = smem_u32(ring + s * C::STAGE) + wg * 64 * SW;
    const uint32_t wh = smem_u32(ring + s * C::STAGE + 2 * C::A_BYTES);
    const uint32_t wl = wh + C::B_BYTES;
    const int rr = lane % 8 + 8 * (lane / 8 % 2);
#pragma unroll
    for (int kk = 0; kk < KC / 8; ++kk) {
      const int ch = 2 * kk + lane / 16;
      const uint32_t addr = xh + ((tid / 32) * 16 + rr) * SW + ((ch ^ (rr % 8)) * 16);
      uint32_t v[4];
      asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
                   : "=r"(v[0]), "=r"(v[1]), "=r"(v[2]), "=r"(v[3]) : "r"(addr) : "memory");
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float h, l;
        tf32_split(__uint_as_float(v[j]), h, l);
        fh[kk][j] = __float_as_uint(h);
        fl[kk][j] = __float_as_uint(l);
      }
    }
    fence_regs(acc);
    fence_regs(fh);
    fence_regs(fl);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KC / 8; ++kk) {
      const uint64_t dwh = mat_desc<SW>(wh + kk * 32, 16, 8 * SW);
      const uint64_t dwl = mat_desc<SW>(wl + kk * 32, 16, 8 * SW);
      WgmmaTf32Rs<BN>::rs(acc, fl[kk], dwh);
      WgmmaTf32Rs<BN>::rs(acc, fh[kk], dwl);
      WgmmaTf32Rs<BN>::rs(acc, fh[kk], dwh);
    }
    wgmma_commit();
    wgmma_wait<1>();
    fence_regs(acc);
    fence_regs(gh);     // the previous chunk's fragments are free from here
    fence_regs(gl);
    if (i > 0) mbar_arrive(empty + (i - 1) % STAGES);
  };
  for (int i = 0; i < n_chunks; i += 2) {
    chunk(i, ah0, al0, ah1, al1);
    if (i + 1 < n_chunks) chunk(i + 1, ah1, al1, ah0, al0);
  }
  wgmma_wait<0>();
  fence_regs(acc);
  fence_regs(ah0);
  fence_regs(al0);
  fence_regs(ah1);
  fence_regs(al1);
"""

FOLD = "constexpr int FOLD = 4;"
GROUPED = "  if (!PASSIVE) {\n    const int span"   # active blocks walk grouped tiles
# pingpong: two partial tiles, so no fold waits for the tensor cores: a
# group's sum is folded after the next group's first chunk is issued
PINGPONG = """  float part0[BN / 2], part1[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) part0[i] = part1[i] = 0.f;
  auto group = [&](int g, float (&part)[BN / 2], float (&done)[BN / 2]) {
    const int last = min(n_chunks, (g + 1) * FOLD);
    for (int i = g * FOLD; i < last; ++i) {
      const int s = i % STAGES;
      mbar_wait(full + s, (i / STAGES) & 1);
      const uint32_t xh = smem_u32(ring + s * C::STAGE) + wg * 64 * SW;
      const uint32_t xl = xh + C::A_BYTES;
      const uint32_t wh = smem_u32(ring + s * C::STAGE + 2 * C::A_BYTES);
      const uint32_t wl = wh + C::B_BYTES;
      fence_regs(part);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < KC / 8; ++kk) {
        const uint64_t dxh = mat_desc<SW>(xh + kk * 32, 16, 8 * SW);
        const uint64_t dxl = mat_desc<SW>(xl + kk * 32, 16, 8 * SW);
        const uint64_t dwh = mat_desc<SW>(wh + kk * 32, 16, 8 * SW);
        const uint64_t dwl = mat_desc<SW>(wl + kk * 32, 16, 8 * SW);
        WgmmaTf32<BN>::ss(part, dxl, dwh, kk > 0 || i % FOLD > 0);
        WgmmaTf32<BN>::ss(part, dxh, dwl, 1);
        WgmmaTf32<BN>::ss(part, dxh, dwh, 1);
      }
      wgmma_commit();
      wgmma_wait<1>();
      fence_regs(part);
      if (i == g * FOLD && g > 0) {     // the previous group is summed
        fence_regs(done);
#pragma unroll
        for (int j = 0; j < BN / 2; ++j) acc[j] += done[j];
      }
      if (i > 0) mbar_arrive(empty + (i - 1) % STAGES);
    }
  };
  const int groups = (n_chunks + FOLD - 1) / FOLD;
  for (int g = 0; g < groups; g += 2) {
    group(g, part0, part1);
    if (g + 1 < groups) group(g + 1, part1, part0);
  }
  wgmma_wait<0>();
  fence_regs(part0);
  fence_regs(part1);
#pragma unroll
  for (int j = 0; j < BN / 2; ++j) acc[j] += groups % 2 ? part0[j] : part1[j];
"""
EDITS = {
    "shipped": [],
    "fold1": [(FOLD, "constexpr int FOLD = 1;")],
    "fold2": [(FOLD, "constexpr int FOLD = 2;")],
    "fold12": [(FOLD, "constexpr int FOLD = 12;")],
    "unfolded": [(CONSUMER, UNFOLDED)],
    "pingpong": [(CONSUMER, PINGPONG)],
    "launch_order": [(GROUPED, "  if (false) {\n    const int span")],
    "grouped_passive": [(GROUPED, "  if (true) {\n    const int span")],
    "stages2": [(STAGES, "constexpr int STAGES = 2;")],
    "no_loads": [(LOADS, "        mbar_arrive(full + s);\n")],
    "wide": [(CONSUMER, UNFOLDED),
             (INCLUDE, INCLUDE + wgmma_tf32(256, "WgmmaTf32", False)),
             (STAGES, "constexpr int STAGES = 2;"),
             (DISPATCH, DISPATCH + "  if (bn > 128)\n    return launch<2, 256>("
                        "xs, wts, out, passive, act, mp, np, kp, bm, bn, k_begin, "
                        "k_end, s);\n"),
             (ENTRY_CHECK, ENTRY_CHECK.replace("bn > TILE", "bn > (body == 2 ? 256 : TILE)"))],
    "a_regs": [(INCLUDE, INCLUDE + wgmma_tf32(64, "WgmmaTf32Rs", True)
                + wgmma_tf32(128, "WgmmaTf32Rs", True).replace(
                    "template <int N> struct WgmmaTf32Rs;\n", "")),
               ("      hi[u] = h;\n      lo[u] = l;\n", "      hi[u] = v;\n      lo[u] = l;\n"),
               ("      const int bytes = 2 * (bm + bn) * SW;\n",
                "      const int bytes = (bm + 2 * bn) * SW;\n"),
               ("        tma_load_2d(st + C::A_BYTES, &tx, k0, mp + row0, full + s);\n", ""),
               (CONSUMER, A_REGS_CONSUMER)],
}
BLOCK_N = {"wide": 256}
UNCHECKED = {"no_loads"}
# these sum all of K in the tensor cores, which truncate: their error is
# printed, not held (the shipped body folds, as fold1 to fold12 do)
UNFOLDED_SUMS = {"unfolded", "wide", "a_regs"}


def build_variants(build, out_dir: pathlib.Path) -> dict[str, pathlib.Path]:
    """One library per variant, compiled in parallel."""
    src = (build.CSRC / "psum_matmul.cu").read_text()
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, edits in EDITS.items():
        text = src
        for old, new in edits:
            if text.count(old) != 1:
                raise SystemExit(f"{name}: the source holds {text.count(old)} "
                                 f"copies of {old[:60]!r}, not one")
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
        regs = [int(w) for line in log.splitlines() if "Used" in line
                for w, nxt in zip(line.split(), line.split()[1:]) if nxt.startswith("registers")]
        spills = [int(m.group(1)) for m in re.finditer(r"(\d+) bytes spill stores", log)]
        serial = sum("C7515" in line and "psum_mm_tf32" in line for line in log.splitlines())
        print(f"{name}: most registers {max(regs)}, most spill stores "
              f"{max(spills)} bytes, {serial} tf32 kernels with serialized wgmma")
        libs[name] = so
    return libs


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("psum_tf32_variants: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build, psum_matmul

    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(smi)
    libs = build_variants(_build, ROOT / "build" / "psum_tf32_variants")
    dev = torch.device("cuda", 0)
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(M, K, generator=gen).to(dev)
    w = torch.randn(K, N, generator=gen).to(dev)
    want = torch.matmul(x, w)

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
    xs = torch.empty(2, M, K, device=dev)
    wts = torch.empty(2, N, K, device=dev)
    wrong = []
    for name, so in libs.items():
        lib = ctypes.CDLL(str(so))
        fn = lib.psum_matmul_launch
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 11 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        pack = lib.psum_matmul_pack
        pack.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
        pack.restype = ctypes.c_int
        bn = BLOCK_N.get(name, BLOCK)
        row = {"variant": name, "grid": [N // bn, M // BLOCK]}

        def run_pack():
            rc = pack(x.data_ptr(), w.data_ptr(), xs.data_ptr(), wts.data_ptr(), M,
                      N, K, torch.cuda.current_stream(dev).cuda_stream)
            if rc:
                raise RuntimeError(f"{name}: pack: CUDA error {rc}")

        if name == "shipped":
            row["pack_ms"] = graph_ms(run_pack)
        for passive in (0, 1):
            out = torch.empty(M, N, device=dev)
            steps = ([(k0, k0 + BLOCK) for k0 in range(0, K, BLOCK)] if passive
                     else [(0, K)])

            def body():
                stream = torch.cuda.current_stream(dev).cuda_stream
                for k_begin, k_end in steps:
                    rc = fn(xs.data_ptr(), wts.data_ptr(), out.data_ptr(),
                            psum_matmul.DTYPE_CODES[torch.float32],
                            psum_matmul.BODY_CODES["tc_3xtf32"], passive, 0, M,
                            N, K, BLOCK, bn, k_begin, k_end, stream)
                    if rc:
                        raise RuntimeError(f"{name}: CUDA error {rc}")

            def call():
                run_pack()
                body()

            key = "passive" if passive else "active"
            row[f"{key}_ms"] = graph_ms(call)
            row[f"{key}_body_ms"] = graph_ms(body)
            if name not in UNCHECKED:
                call()
                torch.cuda.synchronize()
                err = (out - want).abs().max().item()
                row[f"{key}_max_abs_err"] = err
                row[f"{key}_holds_tol"] = torch.allclose(out, want, rtol=TOL, atol=TOL)
                if name not in UNFOLDED_SUMS and not row[f"{key}_holds_tol"]:
                    wrong.append(f"{name} {key}: max abs err {err}")
        print(json.dumps(row), flush=True)
    print(smi)
    for line in wrong:
        print(f"psum_tf32_variants: WRONG: {line}", file=sys.stderr)
    return 1 if wrong else 0


if __name__ == "__main__":
    sys.exit(main())
