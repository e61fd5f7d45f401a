// conv2d_psum for NVIDIA Hopper (sm_90a): the paper's channel-partitioned
// direct convolution of one image, with the partial sums kept on chip.
//
// Replaces the TPU kernel `_conv_kernel` of src/repro/kernels/conv2d_psum.py
// (launched through `conv_launch_plan`). There the grid is (cout/n, cin/m)
// with cin innermost and an fp32 (n, Ho*Wo) accumulator carried from one
// grid step to the next. Blocks on Hopper run in parallel and carry nothing,
// so here:
//
//   * grid.y walks the schedule's output-channel blocks of n, each split
//     along N over n_split thread blocks where it is wider than one thread
//     block holds (each keeps its share of the block's partial sums);
//   * grid.x walks spatial tiles of output positions (the reference never
//     tiles space, but a whole 56 x 56 map of accumulators does not fit one
//     block);
//   * inside the block, the cin loop walks the schedule's input-channel
//     blocks of m in order (the reference's cin-innermost order), staging
//     each through shared memory in chunks; the cin reduction is never split
//     across thread blocks, which would send partial sums through device
//     memory (the passive schedule);
//   * the fp32 accumulators stay in registers for the whole cin loop, and
//     the activation is fused into the single store.
//
// Two bodies, chosen by `conv_launch_plan` (src/repro_torch/kernels/
// conv2d_psum.py) from the dtype and a geometry computed there:
//
// Both take their operands from a pack pass (one launch, device scratch)
// that lays x and w out as the body reads them, and pull each chunk of a
// thread block's slab and weights with one-dimensional bulk copies (TMA)
// into one of two shared-memory stages, so the next chunk lands while this
// one is multiplied. Operands cannot go through tiled TMA at 56 px (a row
// of 58 bf16 is 116 bytes, not a multiple of 16).
//
// tc_bf16 (bf16): an implicit GEMM on wgmma tensor cores. A thread block is
// one warpgroup: M is 64 output positions, N the thread block's rows at a
// built wgmma width NW (up to 8 cout blocks of a narrow layer, each with
// its own accumulator columns, or a share of one wide block), K each cin
// block's channels padded to groups of 16, times the K^2 taps, tap-major.
// At the main path's 512 -> 512 3 x 3 layer the conv does about 1,300 MACs
// per byte it must move, far above the card's ridge, so it is bound by
// operations; its blocks are 14-17 channels wide, so one cout block alone
// would make a narrow product (wgmma n16): eight make an n128.
//   slab     the tile's input rows (halo included), channel-innermost: plane
//            2g + h holds channels 16 g + 8 h .. + 7 of a chunk, 16 bytes a
//            position.
//   A        from registers: for a k16 step (tap, group) a warp's fragment
//            is one ldmatrix.x4, each lane addressing one position's
//            16-byte row at its precomputed offset. Fragments are double
//            buffered: step s + 1's are loaded while step s's wgmma runs.
//   B        the (K x NW) weights, K-major without swizzle: per k16 step two
//            8-channel halves of NW rows x 16 bytes.
//   product  wgmma m64nNWk16; the fp32 tile stays in registers for the
//            whole cin walk.
//
// cuda_core (fp32, and bf16 where tc_bf16's stages do not fit): the fp32
// CUDA cores. Each thread holds NC = 8 channels x R = 4 consecutive output
// columns of one row. Per (input channel, kernel row) it loads the R + K - 1
// inputs of that row once (one 16-byte load and K - 1 scalars, at stride 1)
// and reuses them across the K kernel columns; the weights are warp-uniform
// 16-byte broadcasts. That is 3 K shared loads for 32 K FMAs, where the
// body it replaced issued 9 K. fp32 stays off the tensor cores: TF32 would
// not hold the reference's 1e-4 tolerance.
//
// Operands arrive padded: x (cin_p, hp, wp) spatially pre-padded, w (cout_p,
// cin_p, K, K), channels padded to multiples of the schedule's (m, n) with
// zeros. C interface, loaded with ctypes; each entry point returns
// cudaGetLastError() after its launches. The wgmma, mbarrier and bulk-copy
// wrappers come from hopper.cuh.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using namespace hopper;

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

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

constexpr int PACK_BLOCKS = 132 * 8;   // blocks of 256 threads per pack row

// The grid-stride range of one pack launch: every thread of the grid's
// blockIdx.y row walks [0, n).
#define GRID_STRIDE(u, n)                                                         \
  for (size_t u = (size_t)blockIdx.x * blockDim.x + threadIdx.x; u < (size_t)(n); \
       u += (size_t)gridDim.x * blockDim.x)

// -------------------------------------------------------------- cuda_core
namespace core {

constexpr int NC = 8;              // output channels per thread
constexpr int R = 4;               // consecutive output columns per thread
constexpr int MAX_THREADS = 256;

struct Args {
  int cin_p, hp, wp, ho, wo, stride, kk, bm, bn;
  int cols;      // items per output row: ceil(wo / R)
  int ti;        // items per channel group of a block (a multiple of 32)
  int gpb;       // channel groups of NC per block
  int n_split;   // thread blocks per cout block along N
  int rows_in;   // input rows a block's slab can span, halo included
  int pitch;     // floats between packed rows (a multiple of 4)
  int mc;        // input channels staged per chunk
  int act;
};

// Floats of one stage: mc channels of slab and their (taps x ncb) weights.
__host__ __device__ inline int stage_floats(const Args& a) {
  return a.mc * (a.rows_in * a.pitch + a.kk * a.kk * a.gpb * NC);
}

// The pack pass, one launch. blockIdx.y 0: x (cin_p, hp, wp) -> xt (cin_p,
// hp, pitch) in fp32, zero past wp. blockIdx.y 1: w (cout_p, cin_p, K, K) ->
// wt (cout block x N split, cin_p, taps, ncb) in fp32, zero past the thread
// block's channels: each chunk of a thread block is then contiguous.
template <typename T>
__global__ void pack(const T* __restrict__ x, const T* __restrict__ w, float* __restrict__ xt,
                     float* __restrict__ wt, Args a, int n_cos) {
  const int taps = a.kk * a.kk, ncb = a.gpb * NC;
  if (blockIdx.y == 0) {
    GRID_STRIDE(u, (size_t)a.cin_p * a.hp * a.pitch) {
      const size_t row = u / a.pitch;
      const int col = (int)(u - row * a.pitch);
      xt[u] = col < a.wp ? to_f(x[row * a.wp + col]) : 0.f;
    }
  } else {
    // per thread block along N, a transpose of (ncb channels) x (cin_p x
    // taps) through 32 x 32 tiles of shared memory, so that reads and
    // writes both run along memory (the launch has 256 threads: 32 x 8)
    __shared__ float tile[32][33];
    const int ct_n = a.cin_p * taps;                  // (c, tap) pairs
    const int jt = (ncb + 31) / 32, ctt = (ct_n + 31) / 32;
    const int tx = threadIdx.x % 32, ty = threadIdx.x / 32;
    for (size_t t = blockIdx.x; t < (size_t)n_cos * jt * ctt; t += gridDim.x) {
      const int ct0 = (int)(t % ctt) * 32;
      const size_t r = t / ctt;
      const int j0 = (int)(r % jt) * 32, cos = (int)(r / jt);
      const int split = cos % a.n_split;
      for (int k = ty; k < 32; k += 8) {              // rows j0 + k, columns ct0 + tx
        const int j = j0 + k, ct = ct0 + tx;
        const int co = (cos / a.n_split) * a.bn + split * ncb + j;
        tile[k][tx] = j < ncb && ct < ct_n && split * ncb + j < a.bn
                          ? to_f(w[(size_t)co * ct_n + ct]) : 0.f;
      }
      __syncthreads();
      for (int k = ty; k < 32; k += 8) {              // rows ct0 + k, columns j0 + tx
        const int ct = ct0 + k, j = j0 + tx;
        if (ct < ct_n && j < ncb) wt[((size_t)cos * ct_n + ct) * ncb + j] = tile[tx][k];
      }
      __syncthreads();
    }
  }
}

// KS is the kernel size when known at compile time, 0 for any (read from kk).
template <typename T, int KS>
__global__ void __launch_bounds__(MAX_THREADS)
conv_core(const float* __restrict__ xt, const float* __restrict__ wt, T* __restrict__ out,
          Args a) {
  extern __shared__ __align__(16) float smem[];
  const int kk = KS > 0 ? KS : a.kk;
  const int taps = kk * kk;
  const int ncb = a.gpb * NC;               // channels of this thread block
  const int chan = a.rows_in * a.pitch;     // floats a staged channel takes
  const int stage = stage_floats(a);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + 2 * stage);

  const int cos = blockIdx.y;               // cout block x N split
  const int co0 = (cos / a.n_split) * a.bn + (cos % a.n_split) * ncb;
  const int nco = min(ncb, a.bn - (cos % a.n_split) * ncb);
  const int hw = a.ho * a.wo;
  const int items = a.ho * a.cols;
  const int item0 = blockIdx.x * a.ti;
  const int tid = threadIdx.x;
  const int tc = tid / a.ti;                // warp-uniform: ti is a multiple of 32
  const int item = item0 + tid % a.ti;
  const bool busy = item < items && tc * NC < nco;

  const int oy0 = item0 / a.cols;
  const int iy0 = oy0 * a.stride;
  const int last = min(item0 + a.ti, items) - 1;
  const int rows = min((last / a.cols - oy0) * a.stride + kk, a.hp - iy0);
  const int oy = item / a.cols, ox0 = (item - oy * a.cols) * R;
  const int base = busy ? (oy * a.stride - iy0) * a.pitch + ox0 * a.stride : 0;
  const bool reuse = KS > 0 && a.stride == 1;

  // chunks: the schedule's cin blocks in order, each in pieces of mc channels
  const int per_block = (a.bm + a.mc - 1) / a.mc;
  const int chunks = (a.cin_p / a.bm) * per_block;
  auto chunk_c0 = [&](int q) { return (q / per_block) * a.bm + (q % per_block) * a.mc; };
  auto chunk_nc = [&](int q) { return min(a.mc, a.bm - (q % per_block) * a.mc); };
  // thread 0 brings chunk q into stage q % 2: one bulk copy per channel's
  // rows and one of its weights
  auto fetch = [&](int q) {
    const int st = q & 1, c0 = chunk_c0(q), nc = chunk_nc(q);
    float* xs = smem + st * stage;
    float* ws = xs + a.mc * chan;
    const int row_bytes = rows * a.pitch * 4, w_bytes = nc * taps * ncb * 4;
    mbar_expect_tx(full + st, nc * row_bytes + w_bytes);
    for (int c = 0; c < nc; ++c)
      bulk_load(xs + c * chan, xt + ((size_t)(c0 + c) * a.hp + iy0) * a.pitch, row_bytes,
                full + st);
    bulk_load(ws, wt + ((size_t)cos * a.cin_p + c0) * taps * ncb, w_bytes, full + st);
  };
  if (tid == 0) {
    mbar_init(full, 1);
    mbar_init(full + 1, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    fetch(0);
    if (chunks > 1) fetch(1);
  }
  __syncthreads();

  float acc[NC][R];
#pragma unroll
  for (int i = 0; i < NC; ++i)
#pragma unroll
    for (int r = 0; r < R; ++r) acc[i][r] = 0.f;

  for (int q = 0; q < chunks; ++q) {
    const int st = q & 1, nc = chunk_nc(q);
    mbar_wait(full + st, (q >> 1) & 1);
    const float* xs = smem + st * stage;
    const float* ws = xs + a.mc * chan;
    if (busy) {
#pragma unroll 2
      for (int c = 0; c < nc; ++c) {   // two channels' loads in flight
        const float* xc = xs + c * chan + base;
        const float* wc = ws + c * taps * ncb + tc * NC;
        if (reuse) {
          constexpr int KR = KS > 0 ? KS : 1;
#pragma unroll
          for (int ky = 0; ky < KR; ++ky) {
            const float* row = xc + ky * a.pitch;
            float in[R + KR - 1];
            const float4 v = *reinterpret_cast<const float4*>(row);
            in[0] = v.x; in[1] = v.y; in[2] = v.z; in[3] = v.w;
#pragma unroll
            for (int e = R; e < R + KR - 1; ++e) in[e] = row[e];
#pragma unroll
            for (int kx = 0; kx < KR; ++kx) {
              const float* wq = wc + (ky * KR + kx) * ncb;
              const float4 w0 = *reinterpret_cast<const float4*>(wq);
              const float4 w1 = *reinterpret_cast<const float4*>(wq + 4);
              const float wv[NC] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
#pragma unroll
              for (int i = 0; i < NC; ++i)
#pragma unroll
                for (int r = 0; r < R; ++r) acc[i][r] = fmaf(wv[i], in[r + kx], acc[i][r]);
            }
          }
        } else {
          for (int ky = 0; ky < kk; ++ky) {
            for (int kx = 0; kx < kk; ++kx) {
              const float* p = xc + ky * a.pitch + kx;
              float in[R];
#pragma unroll
              for (int r = 0; r < R; ++r) in[r] = p[r * a.stride];
              const float* wq = wc + (ky * kk + kx) * ncb;
              const float4 w0 = *reinterpret_cast<const float4*>(wq);
              const float4 w1 = *reinterpret_cast<const float4*>(wq + 4);
              const float wv[NC] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
#pragma unroll
              for (int i = 0; i < NC; ++i)
#pragma unroll
                for (int r = 0; r < R; ++r) acc[i][r] = fmaf(wv[i], in[r], acc[i][r]);
            }
          }
        }
      }
    }
    __syncthreads();                          // stage q % 2 is free again
    if (tid == 0 && q + 2 < chunks) fetch(q + 2);
  }

  if (!busy) return;
#pragma unroll
  for (int i = 0; i < NC; ++i) {
    const int co = tc * NC + i;
    if (co >= nco) continue;
    T* orow = out + (size_t)(co0 + co) * hw + oy * a.wo;
#pragma unroll
    for (int r = 0; r < R; ++r)
      if (ox0 + r < a.wo) orow[ox0 + r] = from_f<T>(activate(acc[i][r], a.act));
  }
}

template <typename T, int KS>
int launch_ks(const float* xt, const float* wt, void* out, const Args& a, int threads,
              int n_tiles, int n_cos, int smem_bytes, cudaStream_t stream) {
  static bool configured = false;
  if (const int rc = allow_smem(conv_core<T, KS>, 232448, configured)) return rc;
  conv_core<T, KS><<<dim3(n_tiles, n_cos), threads, smem_bytes, stream>>>(
      xt, wt, static_cast<T*>(out), a);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* x, const void* w, void* out, float* xt, float* wt, const Args& a,
           int threads, int n_tiles, int n_cos, int smem_bytes, cudaStream_t s) {
  pack<T><<<dim3(PACK_BLOCKS, 2), 256, 0, s>>>(static_cast<const T*>(x), static_cast<const T*>(w), xt,
                                       wt, a, n_cos);
  if (const int rc = (int)cudaGetLastError()) return rc;
  switch (a.kk) {
    case 1: return launch_ks<T, 1>(xt, wt, out, a, threads, n_tiles, n_cos, smem_bytes, s);
    case 3: return launch_ks<T, 3>(xt, wt, out, a, threads, n_tiles, n_cos, smem_bytes, s);
    case 7: return launch_ks<T, 7>(xt, wt, out, a, threads, n_tiles, n_cos, smem_bytes, s);
    default: return launch_ks<T, 0>(xt, wt, out, a, threads, n_tiles, n_cos, smem_bytes, s);
  }
}

}  // namespace core

// ---------------------------------------------------------------- tc_bf16
namespace tc {

constexpr int KG = 16;       // channels per k16 step
constexpr int ROWS_M = 64;   // output positions per block: one warpgroup's M

struct Args {
  int cin_p, hp, wp, ho, wo, stride, kk, bm, bn;
  int n_co;      // the schedule's cout blocks
  int cpb;       // cout blocks per thread block, nb rows of N apart
  int nb;
  int nt;        // channels of a cout block per thread block (bn, or a share)
  int n_split;   // thread blocks per cout block along N (cpb = 1 then)
  int rows_in;   // input rows a block's slab can span, halo included
  int gcs;       // groups of KG channels staged per chunk
  int act;
};

// The output channel of row n of thread block cy's N, or -1 where the row
// holds none: cpb cout blocks of nb rows each, or (n_split > 1) a share of
// nt channels of one cout block.
__device__ __forceinline__ int out_channel(const Args& a, int cy, int n) {
  const int j = n / a.nb, c = n - j * a.nb;
  const int blk = (cy / a.n_split) * a.cpb + j, off = (cy % a.n_split) * a.nt + c;
  return c < a.nt && off < a.bn && blk < a.n_co ? blk * a.bn + off : -1;
}

// Bytes of one stage: per group of a chunk, the slab (two planes of
// rows_in * wp positions x 16 bytes) and the weights (taps k16 steps of 2
// halves x NW rows x 16 bytes).
__host__ __device__ inline int stage_bytes(const Args& a, int nw) {
  return a.gcs * 2 * KG * (a.rows_in * a.wp + a.kk * a.kk * nw);
}

// The pack pass, one launch; every thread writes 16 bytes (8 channels).
// blockIdx.y 0: x (cin_p, hp, wp) -> xt (cin block, group, half, hp * wp, 8):
// channel 16 group + 8 half + e of a cin block, zero past its m channels.
// blockIdx.y 1: w (cout_p, cin_p, K, K) -> wt (cout block x N split, cin
// block, group, tap, half, nw, 8): the B operand of each k16 step (row n
// is `out_channel`), zero where a row holds no channel and past the cin
// block's channels.
__global__ void pack(const uint16_t* __restrict__ x, const uint16_t* __restrict__ w,
                     uint4* __restrict__ xt, uint4* __restrict__ wt, Args a, int nw, int n_cos) {
  const int taps = a.kk * a.kk, kg = (a.bm + KG - 1) / KG, n_cb = a.cin_p / a.bm;
  const int hw_p = a.hp * a.wp;
  uint32_t v[4];
  if (blockIdx.y == 0) {
    GRID_STRIDE(u, (size_t)n_cb * kg * 2 * hw_p) {
      const int pos = (int)(u % hw_p);
      const int plane = (int)(u / hw_p);               // (cb, group, half)
      const int cb = plane / (2 * kg), cl = (plane % (2 * kg)) * 8;
#pragma unroll
      for (int e = 0; e < 8; e += 2) {
        const int c = cb * a.bm + cl + e;
        const uint32_t lo = cl + e < a.bm ? x[(size_t)c * hw_p + pos] : 0u;
        const uint32_t hi = cl + e + 1 < a.bm ? x[(size_t)(c + 1) * hw_p + pos] : 0u;
        v[e / 2] = lo | (hi << 16);
      }
      xt[u] = make_uint4(v[0], v[1], v[2], v[3]);
    }
  } else {
    // taps fastest, so neighbouring threads read neighbouring weights
    GRID_STRIDE(u, (size_t)n_cos * n_cb * kg * taps * 2 * nw) {
      const int tap = (int)(u % taps);
      size_t r = u / taps;
      const int n = (int)(r % nw);
      r /= nw;
      const int half = (int)(r % 2);
      r /= 2;
      const int grp = (int)(r % kg);
      r /= kg;
      const int cb = (int)(r % n_cb), cos = (int)(r / n_cb);
      const int co = out_channel(a, cos, n);
      const bool row_ok = co >= 0;
      const int cl = grp * KG + half * 8;
#pragma unroll
      for (int e = 0; e < 8; e += 2) {
        const size_t at = ((size_t)co * a.cin_p + cb * a.bm + cl + e) * taps + tap;
        const uint32_t lo = row_ok && cl + e < a.bm ? w[at] : 0u;
        const uint32_t hi = row_ok && cl + e + 1 < a.bm ? w[at + taps] : 0u;
        v[e / 2] = lo | (hi << 16);
      }
      wt[((((size_t)cos * n_cb + cb) * kg + grp) * taps + tap) * 2 * nw + half * nw + n] =
          make_uint4(v[0], v[1], v[2], v[3]);
    }
  }
}

// K-major operand without swizzle: 8-row groups of 16-byte rows, `sbo`
// bytes apart; the two 8-element halves of a k16 step `lbo` bytes apart.
__device__ __forceinline__ uint64_t kmajor_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32);
}

// One warp's A fragment of a k16 step: the four 8 x 8 matrices of
// ldmatrix.x4 are (rows 0-7 | 8-15 of the warp's 16 positions) x (channels
// 0-7 of plane 2g | 8-15 of plane 2g + 1), each matrix row one position's 16
// bytes; lane l gives the address of row l % 8 of matrix l / 8.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&fr)[4], const uint8_t* row) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(fr[0]), "=r"(fr[1]), "=r"(fr[2]), "=r"(fr[3])
               : "r"(smem_u32(row)));
}

// One k16 step's product as one committed wgmma group: acc (64 x NW) +=
// A (the warpgroup's fragments) x B (K-major in shared memory).
template <int NW>
__device__ __forceinline__ void mma_step(float (&acc)[NW / 2], const uint32_t (&fr)[4],
                                         uint64_t db) {
  wgmma_fence();
  Wgmma<NW>::template rs<0>(acc, fr, db);
  wgmma_commit();
}

template <int NW>
__global__ void __launch_bounds__(128)
conv_tc(const uint4* __restrict__ xt, const uint4* __restrict__ wt,
        __nv_bfloat16* __restrict__ out, Args a) {
  extern __shared__ __align__(16) uint8_t smem[];
  constexpr int STEP_BYTES = 2 * NW * 16;     // B of one k16 step
  const int kk = a.kk, taps = kk * kk;
  const int kg = (a.bm + KG - 1) / KG, n_cb = a.cin_p / a.bm;
  const int hw = a.ho * a.wo, hw_p = a.hp * a.wp;
  const int p0 = blockIdx.x * ROWS_M;
  const int cos = blockIdx.y;                 // cout blocks, or an N split of one
  const int oy0 = p0 / a.wo, iy0 = oy0 * a.stride;
  const int p_last = min(p0 + ROWS_M, hw) - 1;
  const int rows = min((p_last / a.wo - oy0) * a.stride + kk, a.hp - iy0);
  const int plane_bytes = a.rows_in * a.wp * 16;
  const int stage = stage_bytes(a, NW);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + 2 * stage);

  // chunks: the schedule's cin blocks in order, each in pieces of gcs groups
  const int per_block = (kg + a.gcs - 1) / a.gcs;
  const int chunks = n_cb * per_block;
  // thread 0 brings chunk q into stage q % 2: per group two planes of the
  // slab's rows, and the chunk's weights, each one bulk copy
  auto fetch = [&](int q) {
    const int st = q & 1, cb = q / per_block, g0 = (q % per_block) * a.gcs;
    const int ng = min(a.gcs, kg - g0);
    uint8_t* xs = smem + st * stage;
    uint8_t* wb = xs + 2 * a.gcs * plane_bytes;
    const int row_bytes = rows * a.wp * 16, w_bytes = ng * taps * STEP_BYTES;
    mbar_expect_tx(full + st, 2 * ng * row_bytes + w_bytes);
    for (int h = 0; h < 2 * ng; ++h)
      bulk_load(xs + h * plane_bytes,
                xt + ((size_t)(cb * kg + g0) * 2 + h) * hw_p + (size_t)iy0 * a.wp, row_bytes,
                full + st);
    bulk_load(wb, wt + (((size_t)cos * n_cb + cb) * kg + g0) * taps * 2 * NW, w_bytes,
              full + st);
  };
  if (threadIdx.x == 0) {
    mbar_init(full, 1);
    mbar_init(full + 1, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    fetch(0);
    if (chunks > 1) fetch(1);
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, tig = lane % 4;
  // The row this lane addresses for ldmatrix: position 8 ((lane / 8) % 2) +
  // lane % 8 of its warp's 16, in plane lane / 16 of a group. off: the byte
  // offset of that position's tap (0, 0) input. Positions past the map read
  // position 0.
  int off;
  {
    const int p = p0 + warp * 16 + 8 * ((lane / 8) % 2) + lane % 8;
    int o = 0;
    if (p < hw) {
      const int oy = p / a.wo, ox = p - oy * a.wo;
      o = (oy * a.stride - iy0) * a.wp + ox * a.stride;
    }
    off = o * 16 + (lane / 16) * plane_bytes;
  }

  float acc[NW / 2];
#pragma unroll
  for (int i = 0; i < NW / 2; ++i) acc[i] = 0.f;

  // A fragments in two buffers: the next step's load into one while the
  // wgmma of the other runs
  uint32_t af[2][4];
  for (int q = 0; q < chunks; ++q) {
    const int st = q & 1, g0 = (q % per_block) * a.gcs;
    const int ng = min(a.gcs, kg - g0);
    const uint8_t* xs = smem + st * stage;
    const uint32_t wb = smem_u32(xs + 2 * a.gcs * plane_bytes);
    mbar_wait(full + st, (q >> 1) & 1);
    // k16 steps s = tap * ng + group: A at the tap's offset in plane 2 group
    // (and the next plane for channels 8-15), B the (group * taps + tap)-th
    // step of the chunk's weights
    const int steps = taps * ng;
    auto load = [&](uint32_t (&fr)[4], int s) {
      const int tap = s / ng, grp = s - tap * ng, ky = tap / kk;
      ldmatrix_x4(fr, xs + 2 * grp * plane_bytes + (ky * a.wp + tap - ky * kk) * 16 + off);
    };
    auto b_desc = [&](int s) {
      const int tap = s / ng, grp = s - tap * ng;
      return kmajor_desc(wb + (grp * taps + tap) * STEP_BYTES, NW * 16, 128);
    };
    fence_regs(acc);
    load(af[0], 0);
    for (int s = 0; s < steps; s += 2) {
      mma_step<NW>(acc, af[0], b_desc(s));
      wgmma_wait<1>();          // step s - 1 is done: its fragments are free
      fence_regs(af[1]);
      if (s + 1 < steps) {
        load(af[1], s + 1);
        mma_step<NW>(acc, af[1], b_desc(s + 1));
        wgmma_wait<1>();        // step s is done
        fence_regs(af[0]);
        if (s + 2 < steps) load(af[0], s + 2);
      }
    }
    wgmma_wait<0>();
    fence_regs(af);
    fence_regs(acc);
    __syncthreads();                          // stage q % 2 is free again
    if (threadIdx.x == 0 && q + 2 < chunks) fetch(q + 2);
  }

  // accumulator fragment: rows 16 warp + g (+ 8), columns 8 j + 2 tig (+ 1)
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int p = p0 + warp * 16 + g + 8 * h;
    if (p >= hw) continue;
#pragma unroll
    for (int j = 0; j < NW / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int co = out_channel(a, cos, 8 * j + 2 * tig + e);
        if (co >= 0)
          out[(size_t)co * hw + p] = __float2bfloat16(activate(acc[4 * j + 2 * h + e], a.act));
      }
  }
}

template <int NW>
int launch_width(const uint4* xt, const uint4* wt, void* out, const Args& a, int n_tiles,
                 int n_cos, int smem, cudaStream_t stream) {
  static bool configured = false;
  if (const int rc = allow_smem(conv_tc<NW>, 232448, configured)) return rc;
  conv_tc<NW><<<dim3(n_tiles, n_cos), 128, smem, stream>>>(
      xt, wt, static_cast<__nv_bfloat16*>(out), a);
  return (int)cudaGetLastError();
}

int launch(const void* x, const void* w, void* out, uint4* xt, uint4* wt, const Args& a,
           int nw, int n_tiles, int n_cos, int smem, cudaStream_t s) {
  pack<<<dim3(PACK_BLOCKS, 2), 256, 0, s>>>(static_cast<const uint16_t*>(x),
                                            static_cast<const uint16_t*>(w), xt, wt, a, nw, n_cos);
  if (const int rc = (int)cudaGetLastError()) return rc;
  switch (nw) {
    case 8: return launch_width<8>(xt, wt, out, a, n_tiles, n_cos, smem, s);
    case 16: return launch_width<16>(xt, wt, out, a, n_tiles, n_cos, smem, s);
    case 24: return launch_width<24>(xt, wt, out, a, n_tiles, n_cos, smem, s);
    case 32: return launch_width<32>(xt, wt, out, a, n_tiles, n_cos, smem, s);
    case 48: return launch_width<48>(xt, wt, out, a, n_tiles, n_cos, smem, s);
    case 64: return launch_width<64>(xt, wt, out, a, n_tiles, n_cos, smem, s);
    case 96: return launch_width<96>(xt, wt, out, a, n_tiles, n_cos, smem, s);
    case 128: return launch_width<128>(xt, wt, out, a, n_tiles, n_cos, smem, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace tc

bool bad_shape(int cin_p, int hp, int wp, int cout_p, int ho, int wo, int kk, int stride,
               int bm, int bn, int act) {
  return bm < 1 || bn < 1 || kk < 1 || stride < 1 || cin_p % bm || cout_p % bn ||
         (hp - kk) / stride + 1 != ho || (wp - kk) / stride + 1 != wo || ho < 1 || wo < 1 ||
         act < 0 || act > 3;
}

}  // namespace

extern "C" {

// cuda_core. dtype: 0 float32, 1 bfloat16. out is (cout_p, ho, wo) in the
// input type; scratch is the pack pass's output, (cin_p, hp, pitch) floats
// of x and then (n_cos, cin_p, K * K, gpb * 8) floats of w, 16-byte aligned.
// The geometry (ti, gpb, n_split, rows_in, pitch, mc, smem_bytes, n_tiles)
// comes from the Python launch plan (`core_geometry`); it is checked here
// against what the kernel needs.
int conv2d_psum_core_launch(const void* x, const void* w, void* out, void* scratch, int dtype,
                            int cin_p, int hp, int wp, int cout_p, int ho, int wo, int kk,
                            int stride, int bm, int bn, int ti, int gpb, int n_split,
                            int rows_in, int pitch, int mc, int smem_bytes, int n_tiles,
                            int act, void* stream) {
  const int cols = (wo + core::R - 1) / core::R;
  const int out_rows = min(ho, (ti + cols - 2) / cols + 1);
  if (bad_shape(cin_p, hp, wp, cout_p, ho, wo, kk, stride, bm, bn, act) || ti < 32 ||
      ti % 32 || gpb < 1 || ti * gpb > core::MAX_THREADS ||
      n_split * gpb * core::NC < bn || (n_split - 1) * gpb * core::NC >= bn ||
      rows_in > hp || rows_in < (out_rows - 1) * stride + kk || pitch % 4 || pitch < wp ||
      pitch < (cols * core::R - 1) * stride + kk || mc < 1 || mc > bm ||
      (long long)n_tiles * ti < (long long)ho * cols || (cout_p / bn) * n_split > 65535 ||
      !aligned16(scratch))
    return (int)cudaErrorInvalidValue;
  const core::Args a{cin_p, hp, wp, ho, wo, stride, kk, bm, bn, cols, ti, gpb, n_split,
                     rows_in, pitch, mc, act};
  if (smem_bytes < 8 * core::stage_floats(a) + 16 || smem_bytes > 232448)
    return (int)cudaErrorInvalidValue;
  float* xt = static_cast<float*>(scratch);
  float* wt = xt + (size_t)cin_p * hp * pitch;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n_cos = (cout_p / bn) * n_split;
  if (dtype == 0)
    return core::launch<float>(x, w, out, xt, wt, a, ti * gpb, n_tiles, n_cos, smem_bytes, s);
  if (dtype == 1)
    return core::launch<__nv_bfloat16>(x, w, out, xt, wt, a, ti * gpb, n_tiles, n_cos,
                                       smem_bytes, s);
  return (int)cudaErrorInvalidValue;
}

// tc_bf16 (bfloat16 only). out is (cout_p, ho, wo); scratch is the pack
// pass's output, (cin_p / bm, kg, 2, hp * wp, 8) bf16 of x and then (n_cos,
// cin_p / bm, kg, K * K, 2, nw, 8) bf16 of w, kg = ceil(bm / 16), n_cos the
// grid's thread blocks along N, 16-byte aligned. The geometry (cpb, nb, nt,
// nw, n_split, rows_in, gcs, smem_bytes) comes from the Python launch plan
// (`tc_geometry`); it is checked here against what the kernel needs.
int conv2d_psum_tc_launch(const void* x, const void* w, void* out, void* scratch, int cin_p,
                          int hp, int wp, int cout_p, int ho, int wo, int kk, int stride,
                          int bm, int bn, int cpb, int nb, int nt, int nw, int n_split,
                          int rows_in, int gcs, int smem_bytes, int act, void* stream) {
  const int out_rows = min(ho, (tc::ROWS_M + wo - 2) / wo + 1);
  const int n_co = cout_p / bn;
  const bool split_ok = n_split > 1 ? cpb == 1 && nb == nw && nt <= nw && n_split * nt >= bn &&
                                          (n_split - 1) * nt < bn
                                    : nt == bn && nb >= bn && cpb * nb <= nw;
  if (bad_shape(cin_p, hp, wp, cout_p, ho, wo, kk, stride, bm, bn, act) || cpb < 1 ||
      nb < 1 || !split_ok || gcs < 1 || gcs > (bm + tc::KG - 1) / tc::KG || rows_in > hp ||
      rows_in < (out_rows - 1) * stride + kk ||
      (long long)((n_co + cpb - 1) / cpb) * n_split > 65535 || !aligned16(scratch))
    return (int)cudaErrorInvalidValue;
  const tc::Args a{cin_p, hp, wp, ho, wo, stride, kk, bm, bn, n_co, cpb, nb, nt, n_split,
                   rows_in, gcs, act};
  if (smem_bytes < 2 * tc::stage_bytes(a, nw) + 16 || smem_bytes > 232448)
    return (int)cudaErrorInvalidValue;
  const int kg = (bm + tc::KG - 1) / tc::KG;
  uint4* xt = static_cast<uint4*>(scratch);
  uint4* wt = xt + (size_t)(cin_p / bm) * kg * 2 * hp * wp;
  return tc::launch(x, w, out, xt, wt, a, nw, (ho * wo + tc::ROWS_M - 1) / tc::ROWS_M,
                    (n_co + cpb - 1) / cpb * n_split, smem_bytes,
                    static_cast<cudaStream_t>(stream));
}

const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
