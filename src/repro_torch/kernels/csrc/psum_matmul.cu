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
// Bound on an H100: at the shapes of the main path (M=4096, K=1536, N=8960)
// the product is compute-bound (about 500 flops per byte moved once in
// fp32, 1,000 in bf16, against ridges of 20 and 295 on this card). This
// first version runs on the fp32 CUDA cores for both fp32 and bf16 inputs:
// 256 threads each hold an 8 x 8 register tile of a 128 x 128 block tile,
// fed from shared memory in k-chunks of 16. Tensor cores (wgmma) and TMA
// staging are later work.
//
// Operands arrive padded to block multiples: x (mp, kp), w (kp, np), row
// major. C interface, loaded with ctypes; every entry point returns
// cudaGetLastError() after its launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int TILE = 128;      // the register tile: bm, bn <= TILE
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

template <typename T, bool PASSIVE>
__global__ void __launch_bounds__(THREADS)
psum_mm_kernel(const T* __restrict__ x, const T* __restrict__ w,
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
    psum_mm_kernel<T, true><<<grid, THREADS, 0, stream>>>(
        xt, wt, out, np, kp, bm, bn, k_begin, k_end, act);
  } else {
    psum_mm_kernel<T, false><<<grid, THREADS, 0, stream>>>(
        xt, wt, out, np, kp, bm, bn, k_begin, k_end, act);
  }
}

}  // namespace

extern "C" {

// dtype: 0 float32, 1 bfloat16. passive: 0 -> out is (mp, np) in the input
// type; 1 -> out is the (mp, np) float32 partial sums, updated in place over
// [k_begin, k_end).
int psum_matmul_launch(const void* x, const void* w, void* out, int dtype,
                       int passive, int act, int mp, int np, int kp, int bm,
                       int bn, int k_begin, int k_end, void* stream) {
  if (bm < 1 || bm > TILE || bn < 1 || bn > TILE || mp % bm || np % bn ||
      k_begin < 0 || k_end > kp || k_begin >= k_end || act < 0 || act > 3)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    launch<float>(x, w, out, passive, act, mp, np, kp, bm, bn, k_begin, k_end, s);
  } else if (dtype == 1) {
    launch<__nv_bfloat16>(x, w, out, passive, act, mp, np, kp, bm, bn, k_begin, k_end, s);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
