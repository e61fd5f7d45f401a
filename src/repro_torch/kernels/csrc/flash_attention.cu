// flash_attention for NVIDIA Hopper (sm_90a): online-softmax attention with
// the fp32 (m, l, acc) partial sums of every q row kept on chip across all
// kv blocks.
//
// Replaces the TPU kernel `_flash_kernel` of
// src/repro/kernels/flash_attention.py (launched through `flash_launch_plan`).
// There the kv blocks are the sequential, innermost grid axis and (m, l, acc)
// live in VMEM scratch from one grid step to the next. Hopper blocks carry
// nothing between them, so here the kv axis is a loop inside the block:
//
//   grid     (row tiles of QT = 32 q rows, BH); 128 threads = 8 row groups
//            x 16 lanes. Thread (ty, tx) owns rows ty + 8i (i < 4), and for
//            each row its fp32 m, l and D/16 columns of acc in registers.
//   kv loop  tiles of KT keys (64, or 32 at D = 256) in order, K and V staged
//            in shared memory and converted to fp32 there (bf16 inputs are
//            computed in fp32 as the reference's astype does). Per tile:
//              s = q k^T * scale           thread: 4 rows x KT/16 keys
//              masks: k_id <= q_id and k_id < skv (causal)
//              m' = max(m, rowmax s); p = exp(s - m'); alpha = exp(m - m')
//              l = l alpha + sum p;  acc = acc alpha + p V (p via shared mem)
//            Row max and sum reduce over the 16 lanes that share a row.
//   skip     a causal block stops at the last key its last row sees, and at
//            skv: the reference gives those keys weight exp(-1e30 - m) = 0.
//   epilogue acc / max(l, 1e-30), written once in q's type.
//
// GQA: query head bh reads kv head bh / group; no kv head is copied.
//
// Bound on an H100: prefill at Qwen2-1.5B's shapes (S = 1024, D = 128) is
// compute-bound (about 440 flops per byte in bf16); decode (one q row per
// head against the cache) is bound by the bytes of K and V. This first
// version runs on the fp32 CUDA cores for both types, with register tiles
// fed from padded shared-memory rows (conflict-free 16-byte reads). Tensor
// cores (wgmma), TMA staging and a split-kv decode are later work.
//
// Operands arrive padded to block multiples: q (BH, sq_p, D), k/v
// (BH / group, skv_p, D), row major, 16-byte aligned. C interface, loaded
// with ctypes; the entry point returns cudaGetLastError() after its launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;   // 8 row groups x 16 lanes
constexpr int QT = 32;         // q rows per block
constexpr int RPT = 4;         // rows per thread: ty + 8 * i
constexpr float NEG_INF = -1e30f;

template <int D>
struct Tile {
  static constexpr int KT = D > 128 ? 32 : 64;   // keys staged per step
  static constexpr int KPT = KT / 16;            // keys per thread: tx + 16 * j
  static constexpr int LD = D + 4;               // padded q/k/v row, floats
  static constexpr int PLD = KT + 4;             // padded p row, floats
  static constexpr int VEC = D >= 64 ? 4 : 2;    // acc columns per chunk
  static constexpr int CH = D / (16 * VEC);      // chunks per thread
  static constexpr int SMEM_FLOATS = QT * LD + 2 * KT * LD + QT * PLD;
};

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// rows x D elements from src (row stride D) into dst (row stride D + 4) as
// fp32; rows at or beyond `valid` are zero.
template <typename T, int D>
__device__ __forceinline__ void stage(float* dst, const T* src, int rows, int valid) {
  constexpr int V = D / 4;
  for (int i = threadIdx.x; i < rows * V; i += THREADS) {
    const int r = i / V, c = (i % V) * 4;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < valid) val = load4(src + (size_t)r * D + c);
    *reinterpret_cast<float4*>(dst + r * (D + 4) + c) = val;
  }
}

__device__ __forceinline__ float row_max16(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float row_sum16(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ o, int sq_p, int skv_p,
             int skv, int group, int causal, int q_offset, float scale) {
  using P = Tile<D>;
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;                     // QT x LD
  float* Ks = Qs + QT * P::LD;          // KT x LD
  float* Vs = Ks + P::KT * P::LD;       // KT x LD
  float* Ps = Vs + P::KT * P::LD;       // QT x PLD

  const int bh = blockIdx.y;
  const int row0 = blockIdx.x * QT;
  const int rows = min(QT, sq_p - row0);
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const T* kb = k + (size_t)(bh / group) * skv_p * D;
  const T* vb = v + (size_t)(bh / group) * skv_p * D;

  // keys this block needs: a causal row sees keys <= its id and < skv
  const int kv_end = causal ? min(skv, q_offset + row0 + rows) : skv_p;

  stage<T, D>(Qs, q + ((size_t)bh * sq_p + row0) * D, QT, rows);

  float m[RPT], l[RPT], acc[RPT][P::CH][P::VEC];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < P::CH; ++c)
#pragma unroll
      for (int e = 0; e < P::VEC; ++e) acc[i][c][e] = 0.f;
  }

  for (int k0 = 0; k0 < kv_end; k0 += P::KT) {
    const int kt = min(P::KT, kv_end - k0);   // keys of this tile in range
    __syncthreads();                          // the last tile is read out
    stage<T, D>(Ks, kb + (size_t)k0 * D, P::KT, kt);
    stage<T, D>(Vs, vb + (size_t)k0 * D, P::KT, kt);
    __syncthreads();

    float s[RPT][P::KPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < P::KPT; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      float4 a[RPT], b[P::KPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) a[i] = load4(Qs + (ty + 8 * i) * P::LD + d);
#pragma unroll
      for (int j = 0; j < P::KPT; ++j) b[j] = load4(Ks + (tx + 16 * j) * P::LD + d);
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int j = 0; j < P::KPT; ++j) {
          float t = s[i][j];
          t = fmaf(a[i].x, b[j].x, t);
          t = fmaf(a[i].y, b[j].y, t);
          t = fmaf(a[i].z, b[j].z, t);
          t = fmaf(a[i].w, b[j].w, t);
          s[i][j] = t;
        }
    }

#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int q_id = row0 + ty + 8 * i + q_offset;
      bool ok[P::KPT];
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < P::KPT; ++j) {
        const int col = tx + 16 * j;
        ok[j] = col < kt && (!causal || k0 + col <= q_id);
        s[i][j] = ok[j] ? s[i][j] * scale : NEG_INF;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max16(mx));
      const float alpha = expf(m[i] - m_new);   // rescale the old partial sums
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < P::KPT; ++j) {
        const float p = ok[j] ? expf(s[i][j] - m_new) : 0.f;
        sum += p;
        Ps[(ty + 8 * i) * P::PLD + tx + 16 * j] = p;
      }
      l[i] = l[i] * alpha + row_sum16(sum);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < P::CH; ++c)
#pragma unroll
        for (int e = 0; e < P::VEC; ++e) acc[i][c][e] *= alpha;
    }
    __syncthreads();

    // acc += p V over the whole tile: keys past kt have p = 0 and V = 0
#pragma unroll 2
    for (int kk = 0; kk < P::KT; kk += 4) {
      float4 pr[RPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) pr[i] = load4(Ps + (ty + 8 * i) * P::PLD + kk);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float* vrow = Vs + (kk + u) * P::LD;
#pragma unroll
        for (int c = 0; c < P::CH; ++c) {
          const int col = (tx + 16 * c) * P::VEC;
          float vv[P::VEC];
          if constexpr (P::VEC == 4) {
            const float4 t = load4(vrow + col);
            vv[0] = t.x; vv[1] = t.y; vv[2] = t.z; vv[3] = t.w;
          } else {
            const float2 t = *reinterpret_cast<const float2*>(vrow + col);
            vv[0] = t.x; vv[1] = t.y;
          }
#pragma unroll
          for (int i = 0; i < RPT; ++i) {
            const float p = u == 0 ? pr[i].x : u == 1 ? pr[i].y : u == 2 ? pr[i].z : pr[i].w;
#pragma unroll
            for (int e = 0; e < P::VEC; ++e) acc[i][c][e] = fmaf(p, vv[e], acc[i][c][e]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int r = ty + 8 * i;
    if (r >= rows) continue;
    const float den = fmaxf(l[i], 1e-30f);
    T* orow = o + ((size_t)bh * sq_p + row0 + r) * D;
#pragma unroll
    for (int c = 0; c < P::CH; ++c)
#pragma unroll
      for (int e = 0; e < P::VEC; ++e)
        orow[(tx + 16 * c) * P::VEC + e] = from_f<T>(acc[i][c][e] / den);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, int bh,
           int sq_p, int skv_p, int skv, int group, int causal, int q_offset,
           float scale, cudaStream_t stream) {
  const size_t smem = sizeof(float) * Tile<D>::SMEM_FLOATS;
  static bool configured = false;
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  const dim3 grid((sq_p + QT - 1) / QT, bh);
  flash_kernel<T, D><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), sq_p, skv_p, skv, group, causal, q_offset, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_d(int d, const void* q, const void* k, const void* v, void* o, int bh,
             int sq_p, int skv_p, int skv, int group, int causal, int q_offset,
             float scale, cudaStream_t s) {
  switch (d) {
    case 32: return launch<T, 32>(q, k, v, o, bh, sq_p, skv_p, skv, group, causal, q_offset, scale, s);
    case 64: return launch<T, 64>(q, k, v, o, bh, sq_p, skv_p, skv, group, causal, q_offset, scale, s);
    case 128: return launch<T, 128>(q, k, v, o, bh, sq_p, skv_p, skv, group, causal, q_offset, scale, s);
    case 256: return launch<T, 256>(q, k, v, o, bh, sq_p, skv_p, skv, group, causal, q_offset, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace

extern "C" {

// dtype: 0 float32, 1 bfloat16. q and o are (bh, sq_p, d); k and v are
// (bh / group, skv_p, d); keys at or beyond skv are padding (causal only).
int flash_attention_launch(const void* q, const void* k, const void* v, void* o,
                           int dtype, int bh, int sq_p, int skv_p, int skv,
                           int d, int group, int causal, int q_offset,
                           float scale, void* stream) {
  if (bh < 1 || sq_p < 1 || skv < 1 || skv > skv_p || group < 1 || bh % group ||
      bh > 65535 || (causal && q_offset < 0) || (!causal && skv != skv_p) ||
      !aligned16(q) || !aligned16(k) || !aligned16(v) || !aligned16(o))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_d<float>(d, q, k, v, o, bh, sq_p, skv_p, skv, group, causal, q_offset, scale, s);
  if (dtype == 1)
    return launch_d<__nv_bfloat16>(d, q, k, v, o, bh, sq_p, skv_p, skv, group, causal, q_offset, scale, s);
  return (int)cudaErrorInvalidValue;
}

const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
