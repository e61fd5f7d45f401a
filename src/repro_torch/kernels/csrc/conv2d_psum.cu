// conv2d_psum for NVIDIA Hopper (sm_90a): the paper's channel-partitioned
// direct convolution of one image, with the partial sums kept on chip.
//
// Replaces the TPU kernel `_conv_kernel` of src/repro/kernels/conv2d_psum.py
// (launched through `conv_launch_plan`). There the grid is (cout/n, cin/m)
// with cin innermost and an fp32 (n, Ho*Wo) accumulator carried from one
// grid step to the next. Blocks on Hopper run in parallel and carry nothing,
// so here:
//
//   * grid.y walks the schedule's output-channel blocks of n;
//   * grid.x walks spatial tiles of `tile` output positions (the reference
//     never tiles space, but a whole 56 x 56 map of accumulators does not fit
//     one block); the tile size is this kernel's own choice;
//   * inside the block, the cin loop walks the schedule's input-channel
//     blocks of m in order (the reference's cin-innermost order); each block
//     is staged through shared memory in chunks of at most `mc` channels: the
//     input slab of the tile with its halo rows, and the (n, chunk, K, K)
//     weights;
//   * the fp32 accumulators stay in registers for the whole cin loop: each
//     thread owns CPT = 4 output channels x PPT = 8 positions, unrolled over
//     the K x K taps, and the activation is fused into the single store.
//
// Bound on an H100: at the main path's shapes (ResNet-18 at 56 x 56, fp32)
// the conv is compute-bound on the fp32 CUDA cores (a 512 -> 512 3 x 3 layer
// does about 1,300 MACs per word it must move). Per tap a thread reads 4 weights (one
// broadcast 16-byte load) and 8 inputs from shared memory for 32 FMAs, so
// shared-memory bandwidth, not device memory, is the first limit.
//
// Operands arrive padded: x (cin_p, hp, wp) spatially pre-padded, w (cout_p,
// cin_p, K, K), channels padded to multiples of the schedule's (m, n) with
// zeros. C interface, loaded with ctypes; the entry point returns
// cudaGetLastError() after its launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int THREADS = 256;   // most threads a block takes (blockDim.x may be fewer)
constexpr int CPT = 4;   // output channels per thread
constexpr int PPT = 8;   // output positions per thread

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

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

struct ConvArgs {
  int cin_p, hp, wp, ho, wo, stride;
  int bm, bn;              // the schedule's channel blocks (m, n)
  int g_c, g_s;            // thread grid: g_c channel groups x g_s position lanes
  int tile;                // output positions per block (g_s * PPT)
  int rows_in;             // input rows a tile's slab can span, halo included
  int mc;                  // input channels staged per chunk
  int act;
};

// KS is the kernel size when known at compile time, 0 for any (read from kk).
template <typename T, int KS>
__global__ void __launch_bounds__(THREADS)
conv_kernel(const T* __restrict__ x, const T* __restrict__ w, T* __restrict__ out,
            ConvArgs a, int kk_rt) {
  extern __shared__ __align__(16) float smem[];
  const int kk = KS > 0 ? KS : kk_rt;
  const int taps = kk * kk;
  const int bn4 = a.g_c * CPT;
  const int chan_words = a.rows_in * a.wp;
  float* xs = smem;                                          // [mc][rows_in][wp]
  float* ws = smem + ((a.mc * chan_words + 3) & ~3);        // [mc][taps][bn4]

  const int hw = a.ho * a.wo;
  const int p0 = blockIdx.x * a.tile;
  const int co0 = blockIdx.y * a.bn;
  const int tid = threadIdx.x;
  const int tc = tid / a.g_s, ts = tid % a.g_s;
  const bool busy = tc < a.g_c;

  const int p_last = min(p0 + a.tile, hw) - 1;
  const int oy0 = p0 / a.wo;
  const int iy0 = oy0 * a.stride;
  const int slab = ((p_last / a.wo - oy0) * a.stride + kk) * a.wp;  // words/channel

  int off[PPT];
#pragma unroll
  for (int j = 0; j < PPT; ++j) {
    const int p = p0 + ts + a.g_s * j;
    off[j] = 0;
    if (busy && p < hw) {
      const int oy = p / a.wo, ox = p - oy * a.wo;
      off[j] = (oy * a.stride - iy0) * a.wp + ox * a.stride;
    }
  }

  float acc[CPT][PPT];
#pragma unroll
  for (int i = 0; i < CPT; ++i)
#pragma unroll
    for (int j = 0; j < PPT; ++j) acc[i][j] = 0.f;

  for (int ci0 = 0; ci0 < a.cin_p; ci0 += a.bm) {        // the schedule's cin blocks
    for (int c0 = ci0; c0 < ci0 + a.bm; c0 += a.mc) {    // staged chunks of one block
      const int nc = min(a.mc, ci0 + a.bm - c0);
      __syncthreads();
      for (int i = tid; i < nc * slab; i += blockDim.x) {
        const int c = i / slab, r = i - c * slab;
        xs[c * chan_words + r] = to_f(x[((size_t)(c0 + c) * a.hp + iy0) * a.wp + r]);
      }
      const int wrow = nc * taps;   // contiguous (channel, tap) run of one cout
      for (int i = tid; i < a.bn * wrow; i += blockDim.x) {
        const int co = i / wrow, rem = i - co * wrow;
        ws[rem * bn4 + co] = to_f(w[((size_t)(co0 + co) * a.cin_p + c0) * taps + rem]);
      }
      __syncthreads();
      if (!busy) continue;
      for (int c = 0; c < nc; ++c) {
        const float* xc = xs + c * chan_words;
        const float* wc = ws + c * taps * bn4 + tc * CPT;
#pragma unroll
        for (int y = 0; y < kk; ++y) {
#pragma unroll
          for (int xx = 0; xx < kk; ++xx) {
            const float4 wv = *reinterpret_cast<const float4*>(wc + (y * kk + xx) * bn4);
            const float* xt = xc + y * a.wp + xx;
            float xv[PPT];
#pragma unroll
            for (int j = 0; j < PPT; ++j) xv[j] = xt[off[j]];
#pragma unroll
            for (int j = 0; j < PPT; ++j) {
              acc[0][j] = fmaf(wv.x, xv[j], acc[0][j]);
              acc[1][j] = fmaf(wv.y, xv[j], acc[1][j]);
              acc[2][j] = fmaf(wv.z, xv[j], acc[2][j]);
              acc[3][j] = fmaf(wv.w, xv[j], acc[3][j]);
            }
          }
        }
      }
    }
  }

  if (!busy) return;
#pragma unroll
  for (int i = 0; i < CPT; ++i) {
    const int co = tc * CPT + i;
    if (co >= a.bn) continue;
#pragma unroll
    for (int j = 0; j < PPT; ++j) {
      const int p = p0 + ts + a.g_s * j;
      if (p < hw) out[(size_t)(co0 + co) * hw + p] = from_f<T>(activate(acc[i][j], a.act));
    }
  }
}

template <typename T, int KS>
int launch_ks(const void* x, const void* w, void* out, const ConvArgs& a, int kk,
              int threads, int n_tiles, int n_co, int smem_bytes, cudaStream_t stream) {
  auto kernel = conv_kernel<T, KS>;
  if (smem_bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (e != cudaSuccess) return (int)e;
  }
  kernel<<<dim3(n_tiles, n_co), threads, smem_bytes, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<T*>(out), a, kk);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* x, const void* w, void* out, const ConvArgs& a, int kk,
           int threads, int n_tiles, int n_co, int smem_bytes, cudaStream_t stream) {
  switch (kk) {
    case 1: return launch_ks<T, 1>(x, w, out, a, kk, threads, n_tiles, n_co, smem_bytes, stream);
    case 3: return launch_ks<T, 3>(x, w, out, a, kk, threads, n_tiles, n_co, smem_bytes, stream);
    case 7: return launch_ks<T, 7>(x, w, out, a, kk, threads, n_tiles, n_co, smem_bytes, stream);
    default: return launch_ks<T, 0>(x, w, out, a, kk, threads, n_tiles, n_co, smem_bytes, stream);
  }
}

}  // namespace

extern "C" {

// dtype: 0 float32, 1 bfloat16. out is (cout_p, ho, wo) in the input type.
// The geometry (g_c, g_s, threads, tile, rows_in, mc, smem_bytes, n_tiles) comes from
// the Python launch plan; it is checked here against what the kernel needs.
int conv2d_psum_launch(const void* x, const void* w, void* out, int dtype,
                       int cin_p, int hp, int wp, int cout_p, int ho, int wo,
                       int kk, int stride, int bm, int bn, int g_c, int g_s,
                       int threads, int tile, int rows_in, int mc, int smem_bytes,
                       int n_tiles, int act, void* stream) {
  const int hw = ho * wo;
  if (bm < 1 || bn < 1 || cin_p % bm || cout_p % bn || g_c * CPT < bn ||
      g_c * g_s > threads || threads > THREADS || threads % 32 || tile != g_s * PPT || mc < 1 || mc > bm ||
      (long long)n_tiles * tile < hw || (hp - kk) / stride + 1 != ho ||
      (wp - kk) / stride + 1 != wo || rows_in > hp || act < 0 || act > 3 ||
      smem_bytes < 4 * (((mc * rows_in * wp + 3) & ~3) + mc * kk * kk * g_c * CPT))
    return (int)cudaErrorInvalidValue;
  const ConvArgs a{cin_p, hp, wp, ho, wo, stride, bm, bn, g_c, g_s, tile,
                   rows_in, mc, act};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n_co = cout_p / bn;
  if (dtype == 0) return launch<float>(x, w, out, a, kk, threads, n_tiles, n_co, smem_bytes, s);
  if (dtype == 1) return launch<__nv_bfloat16>(x, w, out, a, kk, threads, n_tiles, n_co, smem_bytes, s);
  return (int)cudaErrorInvalidValue;
}

const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
