// psum_matmul for NVIDIA Hopper (sm_90a): C = act(X @ W) with the partial
// sums kept where the schedule says.
//
// Replaces the TPU kernels `_active_kernel` and `_passive_kernel` of
// src/repro/kernels/psum_matmul.py (launched through `matmul_launch_plan`).
//
//   active   one launch; one block per (i, j) output tile of bm x bn; the K
//            loop runs inside the block and the fp32 accumulator stays in
//            registers for all of it; the activation epilogue writes the
//            tile once, in the input type. Words: M*N for C.
//   passive  one launch per k-step of bk. Each launch loads the fp32 C tile
//            from device memory, adds this k-block's product and stores it
//            back, so the partial sums cross device memory at every step:
//            (2*gk - 1)*M*N words for C, as the traffic model charges. The
//            activation runs afterwards, outside the kernel.
//
// Three bodies, chosen by `matmul_launch_plan` (src/repro_torch/kernels/
// psum_matmul.py) from the dtype and the blocks, serve both controllers:
//
// tc_bf16 (bf16 with bm, bn <= 128 and bn, bk multiples of 8). TMA takes a
// box only where its first column lies on a 16-byte boundary (a box of W at
// column 13 faults with an illegal instruction), so the blocks' first
// columns of X (multiples of bk) and of W (multiples of bn) must, and so
// must the rows. At the main path's shapes (M=4096, K=1536, N=8960) the
// active product is bound by tensor-core operations (about 1,000 flops per
// byte moved once, against the card's ridge of 295); the passive schedule
// is bound by the bytes of its C round trips (3.4 GB over 12 launches).
//   block    the schedule's bm x bn tile. bm <= 64 takes one consumer
//            warpgroup of 64 rows, else two; bn <= 64 takes wgmma n64, else
//            n128. Rows and columns past bm and bn are computed from
//            whatever the tile holds there and never stored. Two blocks
//            share an SM, so one block's epilogue overlaps the other's
//            products.
//   loads    one producer warp, whose lane 0 issues TMA copies of k-chunks
//            of 64 (one 128-byte swizzle span of bf16): a bm x 64 box of X
//            and 64 x 64 boxes of W, into a ring of STAGES stages with full
//            and empty mbarriers. The tensor maps end at k_end and at the
//            padded rows and columns; TMA fills zeros past them.
//   product  wgmma m64nBNk16, A = X K-major and B = W MN-major, both from
//            shared memory; each warpgroup keeps its 64 x BN fp32 tile in
//            registers for the whole k range, one wgmma group in flight.
//   C        active: act(acc) rounded to bf16 and stored once. Passive:
//            the fp32 tile is read into the accumulator fragment before
//            the first chunk (skipped at k_begin == 0) and stored back.
//
// tc_3xtf32 (fp32 with bm, bn <= 128 and kp, bk multiples of 4): the
// product on TF32 tensor cores in three passes. One TF32 pass rounds every
// operand to 11 significant bits and misses the reference's 1e-3 tolerance
// at K = 1536 (errors up to 0.05); splitting each operand v = hi + lo
// (hi = tf32(v), lo = tf32(v - hi)) and summing lo*hi + hi*lo + hi*hi keeps
// about 22 bits of each operand (1e-5 in exact sums). The three passes run
// at 495 / 3 TFLOP/s, over twice the fp32 cores' 67.
//   pack     one launch a call, before the body's (once for all the passive
//            launches): X -> X_hi, X_lo, each (mp, kp); W -> Wt_hi, Wt_lo,
//            each (np, kp), transposed through shared memory, because TF32
//            wgmma takes both operands K-major and has no transpose. The
//            rounding happens here: the tensor cores drop a TF32 operand's
//            low 13 bits rather than round them.
//   block    as tc_bf16's (consumer warpgroups of 64 rows, n64 or n128, one
//            producer warp), but one block an SM: a stage holds a bm x 32
//            box of X_hi and of X_lo and a bn x 32 box of Wt_hi and of Wt_lo,
//            64 KiB at 128 x 128, in a ring of three. Active blocks take
//            their tiles in groups of 8 tile rows, so a wave's operands stay
//            in L2; passive ones in launch order, which keeps their C
//            traffic in neighbouring rows.
//   product  per k8 step three wgmma m64nBNk8.tf32, A and B both K-major from
//            shared memory by the same descriptor form, the small terms
//            first: lo*hi, hi*lo, hi*hi. The tensor cores' fp32 adds
//            truncate, so they sum FOLD chunks (128 of k) from zero into a
//            second register tile, and the block adds that into its
//            accumulator with fp32 adds that round: the error then stays
//            near an fp32 FMA loop's.
//   C        stored as tc_bf16's, in fp32. A passive launch loads its C
//            tile into the accumulator before the first wait on the ring,
//            so it travels while the first chunks land; the tensor cores
//            never write that tile, so ptxas does not serialize the wgmmas
//            as it does tc_bf16's passive ones (C7515).
// At the main shape the four operand boxes bring about 7 GB from L2 into
// shared memory in an active call (2240 blocks x 48 chunks x 64 KiB), four
// times tc_bf16's traffic, yet on an H100 they cost under 0.1 ms of the
// call's 1.2: without any operand load the body still takes 1.02 ms
// against the 0.684 ms of three TF32 passes at the card's peak
// (tools/psum_tf32_variants.py).
//
// cuda_core (fp32 and bf16 outside the tensor-core bodies' constraints, or
// when asked for by name): fp32 CUDA cores. 256 threads each hold an 8 x 8
// register tile of a 128 x 128 block tile, fed from shared memory in
// k-chunks of 16; bf16 is converted to fp32 as it is staged.
//
// Operands arrive padded to block multiples: x (mp, kp), w (kp, np), row
// major. C interface, loaded with ctypes; every entry point returns
// cudaGetLastError() after its launch. The Hopper building blocks (mbarriers,
// TMA, wgmma, tensor maps) come from hopper.cuh.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int TILE = 128;   // bm, bn <= TILE in every body

// 0 none, 1 relu, 2 silu, 3 gelu (tanh approximation, as jax.nn.gelu)
__device__ __forceinline__ float activate(float v, int act) {
  switch (act) {
    case 1: return v > 0.f ? v : 0.f;
    case 2: return v / (1.f + expf(-v));
    case 3: {
      const float u = 0.7978845608028654f * (v + 0.044715f * v * v * v);
      return 0.5f * v * (1.f + tanhf(u));
    }
    default: return v;
  }
}

// -------------------------------------------------------------- cuda_core
namespace core {

constexpr int KC = 16;         // k-chunk staged in shared memory per step
constexpr int THREADS = 256;   // 16 x 16 threads
constexpr int RT = 8;          // each thread: RT x RT outputs
constexpr int APAD = 4;        // pad the transposed A tile against bank conflicts

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

template <typename T, bool PASSIVE>
__global__ void __launch_bounds__(THREADS)
psum_mm_core(const T* __restrict__ x, const T* __restrict__ w,
             void* __restrict__ out, int np, int kp, int bm, int bn,
             int k_begin, int k_end, int act) {
  __shared__ __align__(16) float As[KC][TILE + APAD];   // A chunk, transposed
  __shared__ __align__(16) float Bs[KC][TILE];
  const int row0 = blockIdx.y * bm;
  const int col0 = blockIdx.x * bn;
  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;

  float acc[RT][RT];
  if (PASSIVE && k_begin > 0) {
    // Read-before-update: the partial sums come back from device memory.
    const float* c = static_cast<const float*>(out);
#pragma unroll
    for (int i = 0; i < RT; ++i) {
      const int r = ty * RT + i;
#pragma unroll
      for (int j = 0; j < RT; ++j) {
        const int cc = tx * RT + j;
        acc[i][j] = (r < bm && cc < bn) ? c[(size_t)(row0 + r) * np + col0 + cc] : 0.f;
      }
    }
  } else {
#pragma unroll
    for (int i = 0; i < RT; ++i)
#pragma unroll
      for (int j = 0; j < RT; ++j) acc[i][j] = 0.f;
  }

  for (int k0 = k_begin; k0 < k_end; k0 += KC) {
    for (int i = tid; i < TILE * KC; i += THREADS) {
      const int r = i / KC, c = i % KC;
      float v = 0.f;
      if (r < bm && k0 + c < k_end) v = to_f(x[(size_t)(row0 + r) * kp + k0 + c]);
      As[c][r] = v;
    }
    for (int i = tid; i < KC * TILE; i += THREADS) {
      const int c = i / TILE, n = i % TILE;
      float v = 0.f;
      if (n < bn && k0 + c < k_end) v = to_f(w[(size_t)(k0 + c) * np + col0 + n]);
      Bs[c][n] = v;
    }
    __syncthreads();
#pragma unroll
    for (int c = 0; c < KC; ++c) {
      float a[RT], b[RT];
      const float4 a0 = *reinterpret_cast<const float4*>(&As[c][ty * RT]);
      const float4 a1 = *reinterpret_cast<const float4*>(&As[c][ty * RT + 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&Bs[c][tx * RT]);
      const float4 b1 = *reinterpret_cast<const float4*>(&Bs[c][tx * RT + 4]);
      a[0] = a0.x; a[1] = a0.y; a[2] = a0.z; a[3] = a0.w;
      a[4] = a1.x; a[5] = a1.y; a[6] = a1.z; a[7] = a1.w;
      b[0] = b0.x; b[1] = b0.y; b[2] = b0.z; b[3] = b0.w;
      b[4] = b1.x; b[5] = b1.y; b[6] = b1.z; b[7] = b1.w;
#pragma unroll
      for (int i = 0; i < RT; ++i)
#pragma unroll
        for (int j = 0; j < RT; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < RT; ++i) {
    const int r = ty * RT + i;
    if (r >= bm) continue;
#pragma unroll
    for (int j = 0; j < RT; ++j) {
      const int cc = tx * RT + j;
      if (cc >= bn) continue;
      const size_t at = (size_t)(row0 + r) * np + col0 + cc;
      if (PASSIVE) {
        static_cast<float*>(out)[at] = acc[i][j];
      } else {
        static_cast<T*>(out)[at] = from_f<T>(activate(acc[i][j], act));
      }
    }
  }
}

template <typename T>
void launch(const void* x, const void* w, void* out, int passive, int act,
            int mp, int np, int kp, int bm, int bn, int k_begin, int k_end,
            cudaStream_t stream) {
  const dim3 grid(np / bn, mp / bm);
  const T* xt = static_cast<const T*>(x);
  const T* wt = static_cast<const T*>(w);
  if (passive) {
    psum_mm_core<T, true><<<grid, THREADS, 0, stream>>>(
        xt, wt, out, np, kp, bm, bn, k_begin, k_end, act);
  } else {
    psum_mm_core<T, false><<<grid, THREADS, 0, stream>>>(
        xt, wt, out, np, kp, bm, bn, k_begin, k_end, act);
  }
}

}  // namespace core

// ---------------------------------------------------------------- tc_bf16
namespace tc {

constexpr int KC = 64;         // k per staged chunk: 128 bytes of bf16
constexpr int SW = 128;        // swizzle span, bytes
constexpr int STAGES = 3;      // ring depth
constexpr int MIN_BLOCKS = 2;  // blocks an SM holds at once: one's epilogue
                               // overlaps the other's products

template <int WGS, int BN>
struct Cfg {
  static constexpr int BM = 64 * WGS;            // rows the consumers cover
  static constexpr int CONSUMERS = 128 * WGS;    // one warpgroup per 64 rows
  static constexpr int THREADS = CONSUMERS + 32; // and one producer warp
  static constexpr int A_BYTES = BM * SW;        // X: BM rows x 64 k
  static constexpr int B_BYTES = BN * KC * 2;    // W: BN / 64 chunks of 64 k x 128 B
  // 1024 bytes of slack to align the stages to the swizzle pattern, the
  // stages, then the barriers full[STAGES] and empty[STAGES]
  static constexpr int SMEM = 1024 + STAGES * (A_BYTES + B_BYTES) + 16 * STAGES;
};

template <int WGS, int BN, bool PASSIVE>
__global__ void __launch_bounds__(Cfg<WGS, BN>::THREADS, MIN_BLOCKS)
psum_mm_tc(const __grid_constant__ CUtensorMap tx, const __grid_constant__ CUtensorMap tw,
           void* __restrict__ out, int np, int bm, int bn, int k_begin, int k_end, int act) {
  using C = Cfg<WGS, BN>;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* as = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* bs = as + STAGES * C::A_BYTES;
  uint64_t* full = reinterpret_cast<uint64_t*>(bs + STAGES * C::B_BYTES);
  uint64_t* empty = full + STAGES;

  const int row0 = blockIdx.y * bm, col0 = blockIdx.x * bn;
  const int n_chunks = (k_end - k_begin + KC - 1) / KC;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, C::CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= C::CONSUMERS) {
    // producer warp: its lane 0 issues every copy, chunk i into stage
    // i % STAGES once the consumers have freed it
    if (threadIdx.x == C::CONSUMERS) {
      const int bytes = bm * SW + C::B_BYTES;
      for (int i = 0; i < n_chunks; ++i) {
        const int s = i % STAGES;
        if (i >= STAGES) mbar_wait(empty + s, ((i / STAGES) - 1) & 1);
        const int k0 = k_begin + i * KC;
        mbar_expect_tx(full + s, bytes);
        tma_load_2d(as + s * C::A_BYTES, &tx, k0, row0, full + s);
#pragma unroll
        for (int c = 0; c < BN / 64; ++c)
          tma_load_2d(bs + s * C::B_BYTES + c * KC * SW, &tw, col0 + 64 * c, k0, full + s);
      }
    }
    return;
  }

  // consumer warpgroup wg owns tile rows 64 wg .. 64 wg + 63; in the wgmma
  // fragment a thread holds rows r and r + 8 of them, columns 8j + c2 and
  // 8j + c2 + 1
  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128, lane = tid % 32;
  const int r = wg * 64 + (tid / 32) * 16 + lane / 4;
  const int c2 = (lane % 4) * 2;   // even, and bn a multiple of 8: a pair is
                                   // in the tile or out of it

  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
  if (PASSIVE && k_begin > 0) {
    // read-before-update: the partial sums come back from device memory
    const float* c = static_cast<const float*>(out);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (r + 8 * h >= bm) continue;
      const float* crow = c + (size_t)(row0 + r + 8 * h) * np + col0;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int col = 8 * j + c2;
        if (col < bn) {
          const float2 v = *reinterpret_cast<const float2*>(crow + col);
          acc[4 * j + 2 * h] = v.x;
          acc[4 * j + 2 * h + 1] = v.y;
        }
      }
    }
  }

  for (int i = 0; i < n_chunks; ++i) {
    const int s = i % STAGES;
    mbar_wait(full + s, (i / STAGES) & 1);
    const uint32_t a_tile = smem_u32(as + s * C::A_BYTES) + wg * 64 * SW;
    const uint32_t b_tile = smem_u32(bs + s * C::B_BYTES);
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KC / 16; ++kk)
      // A: k-step kk is 32 bytes into each 128-byte row; 8-row groups 1024
      // bytes apart. B: k-step kk is 16 rows further; 8-row groups 1024
      // bytes apart, the 64-column chunks KC * SW bytes apart.
      Wgmma<BN>::template ss<1>(acc, mat_desc<SW>(a_tile + kk * 32, 16, 8 * SW),
                                mat_desc<SW>(b_tile + kk * 16 * SW, KC * SW, 8 * SW), 1);
    wgmma_commit();
    wgmma_wait<1>();   // the previous chunk's products are done: free its stage
    fence_regs(acc);
    if (i > 0) mbar_arrive(empty + (i - 1) % STAGES);
  }
  wgmma_wait<0>();
  fence_regs(acc);

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (r + 8 * h >= bm) continue;
    const size_t at = (size_t)(row0 + r + 8 * h) * np + col0;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int col = 8 * j + c2;
      if (col >= bn) continue;
      const float v0 = acc[4 * j + 2 * h], v1 = acc[4 * j + 2 * h + 1];
      if (PASSIVE)
        *reinterpret_cast<float2*>(static_cast<float*>(out) + at + col) = make_float2(v0, v1);
      else
        *reinterpret_cast<__nv_bfloat162*>(static_cast<__nv_bfloat16*>(out) + at + col) =
            __floats2bfloat162_rn(activate(v0, act), activate(v1, act));
    }
  }
}

template <int WGS, int BN>
int launch(const void* x, const void* w, void* out, int passive, int act, int mp, int np,
           int kp, int bm, int bn, int k_begin, int k_end, cudaStream_t stream) {
  using C = Cfg<WGS, BN>;
  // X's columns and W's rows end at k_end: the chunk past it reads zeros
  CUtensorMap tx, tw;
  int rc = tensor_map_2d(&tx, x, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, mp, k_end, kp, bm);
  if (!rc) rc = tensor_map_2d(&tw, w, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, k_end, np, np, KC);
  static bool configured[2] = {false, false};
  if (!rc) rc = passive ? allow_smem(psum_mm_tc<WGS, BN, true>, C::SMEM, configured[1])
                        : allow_smem(psum_mm_tc<WGS, BN, false>, C::SMEM, configured[0]);
  if (rc) return rc;
  const dim3 grid(np / bn, mp / bm);
  if (passive)
    psum_mm_tc<WGS, BN, true><<<grid, C::THREADS, C::SMEM, stream>>>(
        tx, tw, out, np, bm, bn, k_begin, k_end, act);
  else
    psum_mm_tc<WGS, BN, false><<<grid, C::THREADS, C::SMEM, stream>>>(
        tx, tw, out, np, bm, bn, k_begin, k_end, act);
  return (int)cudaGetLastError();
}

int launch_blocks(const void* x, const void* w, void* out, int passive, int act, int mp,
                  int np, int kp, int bm, int bn, int k_begin, int k_end, cudaStream_t s) {
  if (bm <= 64 && bn <= 64)
    return launch<1, 64>(x, w, out, passive, act, mp, np, kp, bm, bn, k_begin, k_end, s);
  if (bm <= 64)
    return launch<1, 128>(x, w, out, passive, act, mp, np, kp, bm, bn, k_begin, k_end, s);
  if (bn <= 64)
    return launch<2, 64>(x, w, out, passive, act, mp, np, kp, bm, bn, k_begin, k_end, s);
  return launch<2, 128>(x, w, out, passive, act, mp, np, kp, bm, bn, k_begin, k_end, s);
}

}  // namespace tc

// -------------------------------------------------------------- tc_3xtf32
namespace tf {

constexpr int KC = 32;         // k per staged chunk: 128 bytes of fp32
constexpr int SW = 128;        // swizzle span, bytes
constexpr int STAGES = 3;      // ring depth of tc_3xtf32
constexpr int MIN_BLOCKS = 1;  // a 128 x 128 block's three stages fill an SM
// The tensor cores' fp32 sums drop bits rather than round (a bias toward
// zero at each add): summed over all 48 chunks of K = 1536 in one
// accumulator, it reaches 2.8e-3 of a product of about 40 and misses 1e-3.
// So they sum FOLD chunks at a time, from zero, and the block adds each sum
// into its accumulator in fp32.
constexpr int FOLD = 4;
constexpr int GROUP = 8;       // tile rows an active launch walks together
constexpr int PACK_THREADS = 256;
constexpr int PACK_BLOCKS = 132 * 8;

// The pack pass, one launch a call. blockIdx.y 0: x (mp, kp) -> xs = X_hi,
// X_lo, each (mp, kp), four elements a thread a step. blockIdx.y 1: w (kp,
// np) -> wts = Wt_hi, Wt_lo, each (np, kp): the transpose goes through 32 x
// 32 tiles of shared memory, so reads and writes both run along memory.
__global__ void __launch_bounds__(PACK_THREADS)
pack(const float* __restrict__ x, const float* __restrict__ w, float* __restrict__ xs,
     float* __restrict__ wts, int mp, int np, int kp) {
  if (blockIdx.y == 0) {
    const size_t n4 = (size_t)mp * kp / 4;
    const float4* src = reinterpret_cast<const float4*>(x);
    float4* hi = reinterpret_cast<float4*>(xs);
    float4* lo = hi + n4;
    for (size_t u = (size_t)blockIdx.x * blockDim.x + threadIdx.x; u < n4;
         u += (size_t)gridDim.x * blockDim.x) {
      const float4 v = src[u];
      float4 h, l;
      tf32_split(v.x, h.x, l.x);
      tf32_split(v.y, h.y, l.y);
      tf32_split(v.z, h.z, l.z);
      tf32_split(v.w, h.w, l.w);
      hi[u] = h;
      lo[u] = l;
    }
  } else {
    __shared__ float tile[32][33];
    const int tx = threadIdx.x % 32, ty = threadIdx.x / 32;
    const int tn = (np + 31) / 32;
    float* hi = wts;
    float* lo = wts + (size_t)np * kp;
    for (size_t t = blockIdx.x; t < (size_t)((kp + 31) / 32) * tn; t += gridDim.x) {
      const int k0 = (int)(t / tn) * 32, n0 = (int)(t % tn) * 32;
      for (int r = ty; r < 32; r += 8) {           // rows k0 + r of w, columns n0 + tx
        const int k = k0 + r, n = n0 + tx;
        tile[r][tx] = k < kp && n < np ? w[(size_t)k * np + n] : 0.f;
      }
      __syncthreads();
      for (int r = ty; r < 32; r += 8) {           // rows n0 + r of Wt, columns k0 + tx
        const int n = n0 + r, k = k0 + tx;
        if (n < np && k < kp) {
          float h, l;
          tf32_split(tile[tx][r], h, l);
          hi[(size_t)n * kp + k] = h;
          lo[(size_t)n * kp + k] = l;
        }
      }
      __syncthreads();
    }
  }
}

template <int WGS, int BN>
struct Cfg {
  static constexpr int BM = 64 * WGS;            // rows the consumers cover
  static constexpr int CONSUMERS = 128 * WGS;    // one warpgroup per 64 rows
  static constexpr int THREADS = CONSUMERS + 32; // and one producer warp
  static constexpr int A_BYTES = BM * SW;        // X_hi or X_lo: BM rows x 32 k
  static constexpr int B_BYTES = BN * SW;        // Wt_hi or Wt_lo: BN rows x 32 k
  static constexpr int STAGE = 2 * (A_BYTES + B_BYTES);
  // 1024 bytes of slack to align the stages to the swizzle pattern, the
  // stages, then the barriers full[STAGES] and empty[STAGES]
  static constexpr int SMEM = 1024 + STAGES * STAGE + 16 * STAGES;
};

// A stage holds [X_hi | X_lo | Wt_hi | Wt_lo]. The tensor map tx covers the
// X pair as one (2 mp, k_end) array, tw the Wt pair as one (2 np, k_end)
// array: the lo halves start mp (np) rows further.
template <int WGS, int BN, bool PASSIVE>
__global__ void __launch_bounds__(Cfg<WGS, BN>::THREADS, MIN_BLOCKS)
psum_mm_tf32(const __grid_constant__ CUtensorMap tx, const __grid_constant__ CUtensorMap tw,
             float* __restrict__ out, int mp, int np, int bm, int bn, int k_begin, int k_end,
             int act) {
  using C = Cfg<WGS, BN>;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* ring = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + STAGES * C::STAGE);
  uint64_t* empty = full + STAGES;

  // The block's tile. A passive launch takes them in launch order, so that
  // neighbouring blocks read and write neighbouring C rows. An active one
  // takes them in groups of GROUP tile rows, column by column, so that a
  // wave's X and Wt rows stay in L2: in launch order a wave of 132 blocks
  // reads 1.9 tile rows of X and all of Wt (110 MB at the main shape).
  int ti = blockIdx.y, tj = blockIdx.x;
  if (!PASSIVE) {
    const int span = GROUP * gridDim.x;
    const int b = blockIdx.y * gridDim.x + blockIdx.x;
    const int first = b / span * GROUP, rows = min((int)gridDim.y - first, GROUP);
    ti = first + b % span % rows;
    tj = b % span / rows;
  }
  const int row0 = ti * bm, col0 = tj * bn;
  const int n_chunks = (k_end - k_begin + KC - 1) / KC;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, C::CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= C::CONSUMERS) {
    // producer warp: its lane 0 issues every copy, chunk i into stage
    // i % STAGES once the consumers have freed it
    if (threadIdx.x == C::CONSUMERS) {
      const int bytes = 2 * (bm + bn) * SW;
      for (int i = 0; i < n_chunks; ++i) {
        const int s = i % STAGES;
        if (i >= STAGES) mbar_wait(empty + s, ((i / STAGES) - 1) & 1);
        const int k0 = k_begin + i * KC;
        uint8_t* st = ring + s * C::STAGE;
        mbar_expect_tx(full + s, bytes);
        tma_load_2d(st, &tx, k0, row0, full + s);
        tma_load_2d(st + C::A_BYTES, &tx, k0, mp + row0, full + s);
        tma_load_2d(st + 2 * C::A_BYTES, &tw, k0, col0, full + s);
        tma_load_2d(st + 2 * C::A_BYTES + C::B_BYTES, &tw, k0, np + col0, full + s);
      }
    }
    return;
  }

  // consumer warpgroup wg owns tile rows 64 wg .. 64 wg + 63; in the wgmma
  // fragment a thread holds rows r and r + 8 of them, columns 8j + c2 and
  // 8j + c2 + 1
  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128, lane = tid % 32;
  const int r = wg * 64 + (tid / 32) * 16 + lane / 4;
  const int c2 = (lane % 4) * 2;
  const bool pairs = ((np | bn) & 1) == 0;   // a column pair is one 8-byte word

  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
  if (PASSIVE && k_begin > 0) {
    // read-before-update: the partial sums come back from device memory.
    // The loads are issued before the first wait on the ring, so they
    // travel while the first chunks land.
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (r + 8 * h >= bm) continue;
      const float* crow = out + (size_t)(row0 + r + 8 * h) * np + col0;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int col = 8 * j + c2;
        if (pairs && col < bn) {
          const float2 v = *reinterpret_cast<const float2*>(crow + col);
          acc[4 * j + 2 * h] = v.x;
          acc[4 * j + 2 * h + 1] = v.y;
        } else if (!pairs) {
          if (col < bn) acc[4 * j + 2 * h] = crow[col];
          if (col + 1 < bn) acc[4 * j + 2 * h + 1] = crow[col + 1];
        }
      }
    }
  }

  // The tensor cores sum a group of FOLD chunks into part, from zero; acc
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

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (r + 8 * h >= bm) continue;
    float* crow = out + (size_t)(row0 + r + 8 * h) * np + col0;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int col = 8 * j + c2;
      float v0 = acc[4 * j + 2 * h], v1 = acc[4 * j + 2 * h + 1];
      if (!PASSIVE) {
        v0 = activate(v0, act);
        v1 = activate(v1, act);
      }
      if (pairs) {
        if (col < bn) *reinterpret_cast<float2*>(crow + col) = make_float2(v0, v1);
      } else {
        if (col < bn) crow[col] = v0;
        if (col + 1 < bn) crow[col + 1] = v1;
      }
    }
  }
}

template <int WGS, int BN>
int launch(const float* xs, const float* wts, float* out, int passive, int act, int mp,
           int np, int kp, int bm, int bn, int k_begin, int k_end, cudaStream_t stream) {
  using C = Cfg<WGS, BN>;
  // the packed columns end at k_end: the chunk past it reads zeros
  CUtensorMap tx, tw;
  int rc = tensor_map_2d(&tx, xs, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, 2 * mp, k_end, kp, bm);
  if (!rc) rc = tensor_map_2d(&tw, wts, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, 2 * np, k_end, kp, bn);
  static bool configured[2] = {false, false};
  if (!rc) rc = passive ? allow_smem(psum_mm_tf32<WGS, BN, true>, C::SMEM, configured[1])
                        : allow_smem(psum_mm_tf32<WGS, BN, false>, C::SMEM, configured[0]);
  if (rc) return rc;
  const dim3 grid(np / bn, mp / bm);
  if (passive)
    psum_mm_tf32<WGS, BN, true><<<grid, C::THREADS, C::SMEM, stream>>>(
        tx, tw, out, mp, np, bm, bn, k_begin, k_end, act);
  else
    psum_mm_tf32<WGS, BN, false><<<grid, C::THREADS, C::SMEM, stream>>>(
        tx, tw, out, mp, np, bm, bn, k_begin, k_end, act);
  return (int)cudaGetLastError();
}

int launch_blocks(const float* xs, const float* wts, float* out, int passive, int act, int mp,
                  int np, int kp, int bm, int bn, int k_begin, int k_end, cudaStream_t s) {
  if (bm <= 64 && bn <= 64)
    return launch<1, 64>(xs, wts, out, passive, act, mp, np, kp, bm, bn, k_begin, k_end, s);
  if (bm <= 64)
    return launch<1, 128>(xs, wts, out, passive, act, mp, np, kp, bm, bn, k_begin, k_end, s);
  if (bn <= 64)
    return launch<2, 64>(xs, wts, out, passive, act, mp, np, kp, bm, bn, k_begin, k_end, s);
  return launch<2, 128>(xs, wts, out, passive, act, mp, np, kp, bm, bn, k_begin, k_end, s);
}

}  // namespace tf

}  // namespace

extern "C" {

// dtype: 0 float32, 1 bfloat16. body: 0 cuda_core; 1 tc_bf16 (bfloat16
// only; bn, kp, np and k_begin multiples of 8; x, w and out 16-byte
// aligned); 2 tc_3xtf32 (float32 only; kp and k_begin multiples of 4; x, w
// and out 16-byte aligned): x is then the pack's X pair (X_hi, then X_lo,
// each (mp, kp)) and w its Wt pair (Wt_hi, then Wt_lo, each (np, kp)), as
// psum_matmul_pack writes them. passive: 0 -> out is (mp, np) in the input
// type; 1 -> out is the (mp, np) float32 partial sums, updated in place over
// [k_begin, k_end).
int psum_matmul_launch(const void* x, const void* w, void* out, int dtype, int body,
                       int passive, int act, int mp, int np, int kp, int bm,
                       int bn, int k_begin, int k_end, void* stream) {
  if (bm < 1 || bm > TILE || bn < 1 || bn > TILE || mp % bm || np % bn ||
      mp / bm > 65535 || k_begin < 0 || k_end > kp || k_begin >= k_end ||
      act < 0 || act > 3)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (body == 1) {
    if (dtype != 1 || bn % 8 || kp % 8 || np % 8 || k_begin % 8 || !aligned16(x) ||
        !aligned16(w) || !aligned16(out))
      return (int)cudaErrorInvalidValue;
    return tc::launch_blocks(x, w, out, passive, act, mp, np, kp, bm, bn, k_begin, k_end, s);
  }
  if (body == 2) {
    if (dtype != 0 || kp % 4 || k_begin % 4 || !aligned16(x) || !aligned16(w) ||
        !aligned16(out))
      return (int)cudaErrorInvalidValue;
    return tf::launch_blocks(static_cast<const float*>(x), static_cast<const float*>(w),
                             static_cast<float*>(out), passive, act, mp, np, kp, bm, bn,
                             k_begin, k_end, s);
  }
  if (body != 0) return (int)cudaErrorInvalidValue;
  if (dtype == 0) {
    core::launch<float>(x, w, out, passive, act, mp, np, kp, bm, bn, k_begin, k_end, s);
  } else if (dtype == 1) {
    core::launch<__nv_bfloat16>(x, w, out, passive, act, mp, np, kp, bm, bn, k_begin, k_end, s);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// tc_3xtf32's pack pass: x (mp, kp) and w (kp, np), float32, row major ->
// xs = X_hi, X_lo (each (mp, kp)) and wts = Wt_hi, Wt_lo (each (np, kp)),
// hi = tf32_rna(v), lo = tf32_rna(v - hi). kp a multiple of 4; x, xs and
// wts 16-byte aligned.
int psum_matmul_pack(const void* x, const void* w, void* xs, void* wts, int mp, int np,
                     int kp, void* stream) {
  if (mp < 1 || np < 1 || kp < 4 || kp % 4 || !aligned16(x) || !aligned16(xs) ||
      !aligned16(wts))
    return (int)cudaErrorInvalidValue;
  tf::pack<<<dim3(tf::PACK_BLOCKS, 2), tf::PACK_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(w), static_cast<float*>(xs),
      static_cast<float*>(wts), mp, np, kp);
  return (int)cudaGetLastError();
}

const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
