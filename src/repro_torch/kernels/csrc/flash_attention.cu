// flash_attention for NVIDIA Hopper (sm_90a): online-softmax attention with
// the fp32 (m, l, acc) partial sums of every q row kept on chip across the
// kv walk. Four bodies, chosen by `flash_launch_plan`
// (src/repro_torch/kernels/flash_attention.py) from the dtype and the shape;
// all four replace the TPU kernel `_flash_kernel` of
// src/repro/kernels/flash_attention.py, where the kv blocks are the
// sequential, innermost grid axis and (m, l, acc) live in VMEM scratch from
// one grid step to the next. Hopper blocks carry nothing between them, so
// here the kv axis is a loop inside the block.
//
// tc_bf16 (bf16 prefill; bound by tensor-core operations: about 440 flops
// per byte at Qwen2-1.5B's S = 1024, D = 128)
//   grid     (BH, q tiles of 128 rows), the tiles with the longest causal
//            walk first. 288 threads: two consumer warpgroups of 64 q rows
//            each and one producer warp.
//   loads    the producer's lane 0 issues TMA copies: Q once, then K and V
//            tiles of KT keys (128, or 32 at D = 256) into a ring of 2
//            stages, each signalled on its own mbarrier; the consumers free
//            a stage on an `empty` mbarrier. Tiles land 128-byte swizzled
//            (64-byte at D = 32) in chunks one swizzle span wide, the layout
//            wgmma's shared-memory descriptors read.
//   S = QK^T wgmma m64nKTk16, A = Q and B = K (K-major) in shared memory,
//            S in fp32 registers; scaled, and masked (k_id <= q_id, k_id <
//            skv) only on tiles that hold a masked key.
//   softmax  in registers: a row's max reduces over the 4 lanes that share
//            it; its sum stays per lane until the epilogue.
//   O += PV  wgmma m64nDk16 with A = P from registers (the S fragment packed
//            to bf16 pairs is wgmma's A-fragment layout) and B = V read
//            MN-major from the same tiles; O stays in fp32 registers for the
//            whole walk. P is rounded to bf16 here: the one place where this
//            body rounds differently from the reference, which keeps P in
//            fp32.
//   skip     a block stops at the last key its last row sees; a warpgroup
//            skips the math of a tile none of its rows sees.
//   epilogue O / max(l, 1e-30), written once in bf16.
//
// tc_3xtf32 (fp32 one pass at d 32, 64 or 128; bound by tensor-core
// operations: three TF32 passes of 12.9 GFLOP take 0.078 ms at Qwen2-1.5B's
// prefill, the fp32 cores' one pass 0.192 ms). One TF32 pass keeps 11
// significant bits of each operand and misses the reference's fp32
// tolerance of 2e-4 (9e-4 at S = 1024, D = 128); splitting each operand
// v = hi + lo (hi = tf32(v), lo = tf32(v - hi)) and summing lo*hi + hi*lo +
// hi*hi keeps about 22 bits and holds it.
//   pack     one launch a call, before the body: K -> K_hi, K_lo, each
//            (hkv, skv_p, D); V -> Vt_hi, Vt_lo, each (hkv, D, skv_t),
//            transposed because TF32 wgmma takes B only K-major and the
//            keys are the PV product's K, with each group of 8 keys
//            stored in the order 0, 2, 4, 6, 1, 3, 5, 7 (key_at) and zero
//            past skv_p. Q is not packed: a block splits its Q tile in
//            shared memory, as it reads it once (K and V tiles are read by
//            every q tile of their q heads).
//   grid     as tc_bf16's: (BH, q tiles of 128 rows), longest causal walks
//            first; 288 threads, two consumer warpgroups of 64 q rows and
//            one producer warp.
//   smem     Q_hi and Q_lo (128 KiB at D = 128), then STAGES stages of
//            K_hi, K_lo, Vt_hi and Vt_lo tiles of KT = 32 keys (64 KiB at
//            D = 128): one stage at D = 128 (197,672 bytes), two below.
//            With one stage K and V^T have their own barriers: K of tile
//            i + 1 lands during the softmax and PV of tile i, V^T of tile
//            i + 1 during the S product of tile i + 1.
//   S = QK^T per k8 step three wgmma m64nKTk8.tf32, A and B by descriptor
//            (128-byte swizzle, as TMA lands them), the small terms first
//            (lo hi, hi lo, hi hi), summed from zero per tile.
//   softmax  as tc_bf16's, on S's own columns (masks before any split).
//   P        split into TF32 hi and lo in registers (cvt.rna); the S
//            accumulator's registers of a group of 8 keys are wgmma's A
//            fragment against V^T's permuted keys as they stand.
//   O += PV  three wgmma m64nDk8.tf32 per k8 step, A = P from registers, B
//            = V^T by descriptor; O stays in fp32 registers, accumulated in
//            place by the tensor cores over the whole walk.
//   skip     as tc_bf16's. K and V^T have barriers of their own, so a
//            warpgroup that skips a tile still waits for its V^T before it
//            frees the stage: its arrival then counts toward that tile.
//   epilogue O / max(l, 1e-30), written once in fp32.
// Kept out: lo*lo and the split's residue (2^-22 of each operand), and the
// tensor cores' sums, which truncate rather than round.
//
// cuda_core (fp32 one pass outside tc_3xtf32's head dims, i.e. 256, or
// when asked for by name; exact fp32 on the fp32 cores: 67 TFLOP/s)
//   grid     (row tiles of QT = 32 q rows, BH); 128 threads = 8 row groups
//            x 16 lanes. Thread (ty, tx) owns rows ty + 8i (i < 4), and for
//            each row its fp32 m, l and D/16 columns of acc in registers.
//   kv loop  tiles of 64 keys (32 at D = 256) staged in shared memory, rows
//            padded by 4 floats (conflict-free 16-byte reads); per tile
//            s = q k^T * scale, the masks, m' = max(m, rowmax s),
//            p = exp(s - m'), alpha = exp(m - m'), l = l alpha + sum p,
//            acc = acc alpha + p V (p via shared memory). Row max and sum
//            reduce over the 16 lanes that share a row.
//   skip     a causal block stops at the last key its last row sees, and at
//            skv: the reference gives those keys weight exp(-1e30 - m) = 0.
//
// split_kv (decode, both dtypes; bound by the bytes of K and V: one query
// row per head reads the whole cache). Taken when the one-pass grid would
// not fill the card: at most 64 rows (q heads of a kv head x q positions)
// and fewer one-pass blocks than the 132 SMs.
//   pass 1   grid (splits, BH / group), 128 threads. A block serves all
//            group x sq_p rows of one kv head over one contiguous key range
//            [split * split_len, ...) of [0, skv), so each key is read once
//            and not once per q head. K and V tiles of 32 keys are staged
//            with cp.async, double-buffered; the arithmetic is fp32. A warp
//            owns rows w + 4i with one key per lane, so a row's max and sum
//            are warp shuffles. The kernel is instantiated for at most 8,
//            16, 32 or 64 rows, and a thread past the last row repeats the
//            last row and keeps nothing: no loop carries a branch per row.
//            The block writes its fp32 (m, l, acc) per row to device
//            scratch: the passive half of the trade, rows x (D + 2) words
//            per split, written once and read once.
//   pass 2   grid (rows, BH / group): m* = max m_s, w_s = exp(m_s - m*),
//            l = sum l_s w_s, acc = sum acc_s w_s, out = acc / max(l, 1e-30)
//            (the combine of src/repro/sharding/flash_decode.py). A split
//            that sees no key of a row has m_s = -1e30 and weight exactly 0.
//   position a serving step captured as a CUDA graph passes a pointer to
//            two int32 on the device, (q_offset, valid length), which every
//            block of pass 1 reads when it starts (the reference's traced
//            `pos` and `kv_valid_len = pos + s`). K and V are then the whole
//            cache (skv_p = its capacity), the ranges cut the capacity, and
//            a range past the valid length sees no key: it writes (m, l,
//            acc) = (-1e30, 0, 0), and pass 2 gives it weight 0. One graph
//            serves every step of a request.
//
// GQA everywhere: query head bh reads kv head bh / group; no kv head is
// copied.
//
// Operands arrive padded to the reference's block multiples: q (BH, sq_p, D),
// k/v (BH / group, skv_p, D), row major, 16-byte aligned; split_kv's loads
// mask the key tail themselves, so its K and V come unpadded (skv_p = the
// keys there are, a cache's capacity in a serving step). C interface, loaded
// with ctypes; each entry point returns cudaGetLastError() after its launch.
// TMA descriptors are encoded through the runtime's entry-point lookup, so
// the library is not linked against libcuda. The Hopper building blocks
// (mbarriers, TMA, wgmma, the TF32 split) come from hopper.cuh, shared
// with psum_matmul.cu and conv2d_psum.cu.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr float NEG_INF = -1e30f;

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

__device__ __forceinline__ float fma4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

// ---------------------------------------------------------------- cuda_core
namespace core {

constexpr int THREADS = 128;   // 8 row groups x 16 lanes
constexpr int QT = 32;         // q rows per block
constexpr int RPT = 4;         // rows per thread: ty + 8 * i

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
  if (const int rc = allow_smem(flash_kernel<T, D>, smem, configured)) return rc;
  const dim3 grid((sq_p + QT - 1) / QT, bh);
  flash_kernel<T, D><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), sq_p, skv_p, skv, group, causal, q_offset, scale);
  return (int)cudaGetLastError();
}

}  // namespace core

// ------------------------------------------------------------------ tc_bf16
namespace tc {

constexpr int QROWS = 128;               // q rows per block
constexpr int CONSUMERS = 256;           // two warpgroups of 64 rows
constexpr int THREADS = CONSUMERS + 32;  // and one producer warp
constexpr int STAGES = 2;                // K/V ring depth

template <int D>
struct Cfg {
  static constexpr int KT = D > 128 ? 32 : 128;   // keys per K/V tile
  static constexpr int SW = D >= 64 ? 128 : 64;   // swizzle span: bytes of a staged row
  static constexpr int CW = SW / 2;               // bf16 columns per chunk
  static constexpr int NCH = D / CW;              // chunks of a row
  static constexpr int Q_BYTES = QROWS * D * 2;
  static constexpr int KV_BYTES = KT * D * 2;
  // 1024 bytes of slack to align the tiles to the swizzle pattern, then the
  // barriers: q_full, k_full[STAGES], v_full[STAGES], empty[STAGES]
  static constexpr int SMEM = 1024 + Q_BYTES + 2 * STAGES * KV_BYTES + 8 * (1 + 3 * STAGES);
};

// A tile of `rows` rows is staged as D / CW chunks of rows x SW bytes. The
// K-major operand (Q or K) of k-step kk (16 columns) starts in chunk
// 16 kk / CW, 32 bytes further per k-step inside the swizzle span; its
// 8-row groups are SW * 8 bytes apart.
template <int D>
__device__ __forceinline__ uint64_t kmajor_desc(uint32_t tile, int rows, int kk) {
  using C = Cfg<D>;
  return mat_desc<C::SW>(tile + (kk * 16 / C::CW) * rows * C::SW + (kk * 16 % C::CW) * 2,
                         16, 8 * C::SW);
}

// V read MN-major (its columns are the product's N): k-step kk is keys
// 16 kk.., 16 rows further; 8-key groups are SW * 8 bytes apart and the
// column chunks KT * SW bytes apart.
template <int D>
__device__ __forceinline__ uint64_t mnmajor_desc(uint32_t tile, int kk) {
  using C = Cfg<D>;
  return mat_desc<C::SW>(tile + kk * 16 * C::SW, C::KT * C::SW, 8 * C::SW);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}


template <int D>
__global__ void __launch_bounds__(THREADS, 1)
flash_kernel_tc(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                const __grid_constant__ CUtensorMap tv, __nv_bfloat16* __restrict__ o,
                int sq_p, int skv, int group, int causal, int q_offset, float scale_log2) {
  using C = Cfg<D>;
  constexpr int KT = C::KT;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* qs = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* ks = qs + C::Q_BYTES;                 // STAGES K tiles
  uint8_t* vs = ks + STAGES * C::KV_BYTES;       // STAGES V tiles
  uint64_t* q_full = reinterpret_cast<uint64_t*>(vs + STAGES * C::KV_BYTES);
  uint64_t* k_full = q_full + 1;
  uint64_t* v_full = k_full + STAGES;
  uint64_t* empty = v_full + STAGES;

  const int bh = blockIdx.x;
  const int row0 = (gridDim.y - 1 - blockIdx.y) * QROWS;   // longest causal walks first
  const int kv_end = causal ? min(skv, q_offset + min(row0 + QROWS, sq_p)) : skv;
  const int n_tiles = (kv_end + KT - 1) / KT;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(k_full + s, 1);
      mbar_init(v_full + s, 1);
      mbar_init(empty + s, CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= CONSUMERS) {
    // producer warp: its lane 0 issues every copy, KV tile i into stage
    // i % STAGES once the consumers have freed it
    if (threadIdx.x == CONSUMERS) {
      const int hk = bh / group;
      mbar_expect_tx(q_full, C::Q_BYTES);
      for (int c = 0; c < C::NCH; ++c)
        tma_load(qs + c * QROWS * C::SW, &tq, c * C::CW, row0, bh, q_full);
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % STAGES;
        if (i >= STAGES) mbar_wait(empty + s, ((i / STAGES) - 1) & 1);
        mbar_expect_tx(k_full + s, C::KV_BYTES);
        for (int c = 0; c < C::NCH; ++c)
          tma_load(ks + s * C::KV_BYTES + c * KT * C::SW, &tk, c * C::CW, i * KT, hk, k_full + s);
        mbar_expect_tx(v_full + s, C::KV_BYTES);
        for (int c = 0; c < C::NCH; ++c)
          tma_load(vs + s * C::KV_BYTES + c * KT * C::SW, &tv, c * C::CW, i * KT, hk, v_full + s);
      }
    }
    return;
  }

  // consumer warpgroup wg owns rows wrow0 .. wrow0 + 63; in the wgmma
  // fragments a thread holds rows r_a and r_a + 8 of them, columns
  // 8j + c2 and 8j + c2 + 1
  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;
  const int lane = tid % 32;
  const int wrow0 = row0 + wg * 64;
  const int r_a = (tid / 32) * 16 + lane / 4;
  const int c2 = (lane % 4) * 2;
  const int q_id[2] = {q_offset + wrow0 + r_a, q_offset + wrow0 + r_a + 8};
  const int wg_last = q_offset + wrow0 + 63;   // the last key a causal row here sees
  const uint32_t q_tile = smem_u32(qs) + wg * 64 * C::SW;

  float oacc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) oacc[i] = 0.f;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};

  mbar_wait(q_full, 0);
  for (int i = 0; i < n_tiles; ++i) {
    const int s = i % STAGES;
    const uint32_t phase = (i / STAGES) & 1;
    const int k0 = i * KT;
    mbar_wait(k_full + s, phase);
    if (!causal || k0 <= wg_last) {
      // S = Q K^T in fp32 registers
      float sacc[KT / 2];
#pragma unroll
      for (int j = 0; j < KT / 2; ++j) sacc[j] = 0.f;
      const uint32_t k_tile = smem_u32(ks + s * C::KV_BYTES);
      fence_regs(sacc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        Wgmma<KT>::ss(sacc, kmajor_desc<D>(q_tile, QROWS, kk), kmajor_desc<D>(k_tile, KT, kk), 1);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(sacc);

      // scale into the log2 domain, mask, and the online softmax
      const bool edge = k0 + KT > skv || (causal && k0 + KT - 1 > q_offset + wrow0);
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int j = 0; j < KT / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = sacc[4 * j + e] * scale_log2;
          if (edge) {
            const int col = k0 + 8 * j + c2 + (e & 1);
            if (col >= skv || (causal && col > q_id[e / 2])) x = NEG_INF;
          }
          sacc[4 * j + e] = x;
          mx[e / 2] = fmaxf(mx[e / 2], x);
        }
      float alpha[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
        alpha[h] = exp2f(m[h] - mx[h]);   // rescale the old partial sums
        m[h] = mx[h];
        l[h] *= alpha[h];
      }
      // P in bf16 pairs: k-step kk takes columns 16kk.. of rows r_a, r_a + 8
      uint32_t pa[KT / 16][4];
#pragma unroll
      for (int j = 0; j < KT / 8; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float p0 = exp2f(sacc[4 * j + 2 * h] - m[h]);
          const float p1 = exp2f(sacc[4 * j + 2 * h + 1] - m[h]);
          l[h] += p0 + p1;
          pa[j / 2][(j % 2) * 2 + h] = pack_bf16(p0, p1);
        }
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) oacc[4 * j + e] *= alpha[e / 2];

      // O += P V
      const uint32_t v_tile = smem_u32(vs + s * C::KV_BYTES);
      mbar_wait(v_full + s, phase);
      fence_regs(oacc);
      fence_regs(pa);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < KT / 16; ++kk) Wgmma<D>::rs(oacc, pa[kk], mnmajor_desc<D>(v_tile, kk));
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(oacc);
      fence_regs(pa);
    }
    mbar_arrive(empty + s);
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    const int r = wrow0 + r_a + 8 * h;
    if (r >= sq_p) continue;
    const float den = fmaxf(l[h], 1e-30f);
    __nv_bfloat16* orow = o + ((size_t)bh * sq_p + r) * D + c2;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j) =
          __floats2bfloat162_rn(oacc[4 * j + 2 * h] / den, oacc[4 * j + 2 * h + 1] / den);
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, int bh, int sq_p, int skv_p,
           int skv, int group, int causal, int q_offset, float scale, cudaStream_t stream) {
  using C = Cfg<D>;
  constexpr CUtensorMapDataType BF16 = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  CUtensorMap tq, tk, tv;
  int rc = tensor_map_3d(&tq, q, BF16, 2, bh, sq_p, D, QROWS, C::SW);
  if (!rc) rc = tensor_map_3d(&tk, k, BF16, 2, bh / group, skv_p, D, C::KT, C::SW);
  if (!rc) rc = tensor_map_3d(&tv, v, BF16, 2, bh / group, skv_p, D, C::KT, C::SW);
  static bool configured = false;
  if (!rc) rc = allow_smem(flash_kernel_tc<D>, C::SMEM, configured);
  if (rc) return rc;
  const dim3 grid(bh, (sq_p + QROWS - 1) / QROWS);
  flash_kernel_tc<D><<<grid, THREADS, C::SMEM, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), sq_p, skv, group, causal, q_offset,
      scale * 1.4426950408889634f);
  return (int)cudaGetLastError();
}

}  // namespace tc

// ---------------------------------------------------------------- tc_3xtf32
namespace tf {

constexpr int KT = 32;         // keys per K and V^T tile
constexpr int WGS = 2;         // consumer warpgroups of 64 q rows a block
constexpr int PACK_THREADS = 256;
constexpr int PACK_BLOCKS = 132 * 8;

// The key the pack stores at position pos of V^T's rows. The S accumulator
// holds columns 2t and 2t + 1 of each group of 8 keys (t = lane % 4); the
// TF32 A fragment of a k8 step holds columns t and t + 4. Stored in the
// order 0, 2, 4, 6, 1, 3, 5, 7, A's column c is key 2c (c < 4) or
// 2(c - 4) + 1, so the S registers (d0, d2, d1, d3) of a group are the A
// registers (a0, a1, a2, a3) as they stand: P stays in registers without a
// shuffle, and no quad shuffle is needed.
__device__ __forceinline__ int key_at(int pos) {
  const int c = pos & 7;
  return (pos & ~7) + (c < 4 ? 2 * c : 2 * c - 7);
}

// The pack pass, one launch a call. blockIdx.y 0: k (hkv, skv_p, d) -> ks =
// K_hi, K_lo, each (hkv, skv_p, d), four elements a thread a step.
// blockIdx.y 1: v (hkv, skv_p, d) -> vts = Vt_hi, Vt_lo, each (hkv, d,
// skv_t): transposed through 32 x 32 tiles of shared memory, each group of
// 8 keys in the order of key_at, zero from skv_p on. hi = tf32_rna(x), lo =
// tf32_rna(x - hi).
__global__ void __launch_bounds__(PACK_THREADS)
pack(const float* __restrict__ k, const float* __restrict__ v, float* __restrict__ ks,
     float* __restrict__ vts, int hkv, int skv_p, int skv_t, int d) {
  if (blockIdx.y == 0) {
    const size_t n4 = (size_t)hkv * skv_p * d / 4;
    const float4* src = reinterpret_cast<const float4*>(k);
    float4* hi = reinterpret_cast<float4*>(ks);
    float4* lo = hi + n4;
    for (size_t u = (size_t)blockIdx.x * blockDim.x + threadIdx.x; u < n4;
         u += (size_t)gridDim.x * blockDim.x) {
      const float4 x = src[u];
      float4 h, l;
      tf32_split(x.x, h.x, l.x);
      tf32_split(x.y, h.y, l.y);
      tf32_split(x.z, h.z, l.z);
      tf32_split(x.w, h.w, l.w);
      hi[u] = h;
      lo[u] = l;
    }
  } else {
    __shared__ float tile[32][33];
    const int tx = threadIdx.x % 32, ty = threadIdx.x / 32;
    const int tk = skv_t / 32, td = d / 32;
    float* hi = vts;
    float* lo = vts + (size_t)hkv * d * skv_t;
    for (size_t t = blockIdx.x; t < (size_t)hkv * tk * td; t += gridDim.x) {
      const int h = (int)(t / ((size_t)tk * td));
      const int k0 = (int)(t / td % tk) * 32, d0 = (int)(t % td) * 32;
      const float* vb = v + (size_t)h * skv_p * d;
      for (int r = ty; r < 32; r += 8) {           // keys k0 + r, columns d0 + tx of v
        const int key = k0 + r;
        tile[r][tx] = key < skv_p ? vb[(size_t)key * d + d0 + tx] : 0.f;
      }
      __syncthreads();
      for (int r = ty; r < 32; r += 8) {           // row d0 + r of Vt, position k0 + tx
        float hv, lv;
        tf32_split(tile[key_at(tx)][r], hv, lv);
        const size_t at = ((size_t)h * d + d0 + r) * skv_t + k0 + tx;
        hi[at] = hv;
        lo[at] = lv;
      }
      __syncthreads();
    }
  }
}

template <int D>
struct Cfg {
  static constexpr int QROWS = 64 * WGS;              // q rows per block
  static constexpr int CONSUMERS = 128 * WGS;         // one warpgroup per 64 rows
  static constexpr int THREADS = CONSUMERS + 32;      // and one producer warp
  static constexpr int VSW = KT >= 32 ? 128 : 4 * KT; // swizzle span of a V^T row
  static constexpr int Q_BYTES = QROWS * D * 4;       // Q_hi or Q_lo
  static constexpr int KV_BYTES = KT * D * 4;         // K_hi, K_lo, Vt_hi or Vt_lo
  static constexpr int STAGE = 4 * KV_BYTES;
  // 1024 bytes of slack to align the tiles to the swizzle pattern, Q_hi and
  // Q_lo, STAGES stages of (K_hi, K_lo, Vt_hi, Vt_lo), then the barriers
  // q_full, k_full[STAGES], v_full[STAGES], k_empty[STAGES], v_empty[STAGES].
  // Two stages where they fit in one block's 232,448 bytes, else one.
  static constexpr int fixed = 1024 + 2 * Q_BYTES;
  static constexpr int STAGES = fixed + 2 * STAGE + 8 * 9 <= 232448 ? 2 : 1;
  static constexpr int SMEM = fixed + STAGES * STAGE + 8 * (1 + 4 * STAGES);
};

// A K-major operand (Q of `rows` rows, or K of KT) staged as D / 32 chunks of
// rows x 128 bytes: k-step kk (8 columns) starts in chunk kk / 4, 32 bytes
// further per k-step inside the swizzle span; 8-row groups 1024 bytes apart.
__device__ __forceinline__ uint64_t kmajor_desc(uint32_t tile, int rows, int kk) {
  return mat_desc<128>(tile + (kk / 4) * rows * 128 + (kk % 4) * 32, 16, 1024);
}

// V^T (D rows of KT keys) staged as chunks of D rows x VSW bytes: k-step kk
// (8 keys) starts in chunk kk / (VSW / 32), 32 bytes further per k-step.
template <int D>
__device__ __forceinline__ uint64_t vt_desc(uint32_t tile, int kk) {
  constexpr int VSW = Cfg<D>::VSW, PER = VSW / 32;
  return mat_desc<VSW>(tile + (kk / PER) * D * VSW + (kk % PER) * 32, 16, 8 * VSW);
}

template <int D>
__global__ void __launch_bounds__(Cfg<D>::THREADS, 1)
flash_kernel_tf32(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                  const __grid_constant__ CUtensorMap tv, float* __restrict__ o, int sq_p,
                  int skv, int hkv, int group, int causal, int q_offset, float scale_log2) {
  using C = Cfg<D>;
  constexpr int STAGES = C::STAGES;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* qs = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);   // Q_hi, Q_lo
  uint8_t* kv = qs + 2 * C::Q_BYTES;             // stage s: K_hi, K_lo, Vt_hi, Vt_lo
  uint64_t* q_full = reinterpret_cast<uint64_t*>(kv + STAGES * C::STAGE);
  uint64_t* k_full = q_full + 1;
  uint64_t* v_full = k_full + STAGES;
  uint64_t* k_empty = v_full + STAGES;
  uint64_t* v_empty = k_empty + STAGES;

  const int bh = blockIdx.x;
  const int row0 = (gridDim.y - 1 - blockIdx.y) * C::QROWS;   // longest causal walks first
  const int kv_end = causal ? min(skv, q_offset + min(row0 + C::QROWS, sq_p)) : skv;
  const int n_tiles = (kv_end + KT - 1) / KT;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(k_full + s, 1);
      mbar_init(v_full + s, 1);
      mbar_init(k_empty + s, C::CONSUMERS);
      mbar_init(v_empty + s, C::CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= C::CONSUMERS) {
    // producer warp: its lane 0 issues every copy. K of tile i goes into
    // stage i % STAGES once the consumers' S products have read the tile
    // before it there, V^T once their PV products have: with one stage, K
    // of tile i + 1 lands during the softmax and PV of tile i.
    if (threadIdx.x == C::CONSUMERS) {
      const int hk = bh / group;
      mbar_expect_tx(q_full, C::Q_BYTES);
      for (int c = 0; c < D / 32; ++c)
        tma_load(qs + c * C::QROWS * 128, &tq, c * 32, row0, bh, q_full);
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % STAGES;
        uint8_t* st = kv + s * C::STAGE;
        if (i >= STAGES) mbar_wait(k_empty + s, ((i / STAGES) - 1) & 1);
        mbar_expect_tx(k_full + s, 2 * C::KV_BYTES);
        for (int c = 0; c < D / 32; ++c) {
          tma_load(st + c * KT * 128, &tk, c * 32, i * KT, hk, k_full + s);
          tma_load(st + C::KV_BYTES + c * KT * 128, &tk, c * 32, i * KT, hkv + hk, k_full + s);
        }
        if (i >= STAGES) mbar_wait(v_empty + s, ((i / STAGES) - 1) & 1);
        mbar_expect_tx(v_full + s, 2 * C::KV_BYTES);
        for (int c = 0; c < 4 * KT / C::VSW; ++c) {
          const int key = i * KT + c * C::VSW / 4;
          tma_load(st + 2 * C::KV_BYTES + c * D * C::VSW, &tv, key, 0, hk, v_full + s);
          tma_load(st + 3 * C::KV_BYTES + c * D * C::VSW, &tv, key, 0, hkv + hk, v_full + s);
        }
      }
    }
    return;
  }

  // consumer warpgroup wg owns rows wrow0 .. wrow0 + 63; in the wgmma
  // fragments a thread holds rows r_a and r_a + 8 of them, columns
  // 8j + c2 and 8j + c2 + 1
  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;
  const int lane = tid % 32;
  const int wrow0 = row0 + wg * 64;
  const int r_a = (tid / 32) * 16 + lane / 4;
  const int c2 = (lane % 4) * 2;
  const int q_id[2] = {q_offset + wrow0 + r_a, q_offset + wrow0 + r_a + 8};
  const int wg_last = q_offset + wrow0 + 63;   // the last key a causal row here sees
  const uint32_t q_hi = smem_u32(qs) + wg * 64 * 128;
  const uint32_t q_lo = q_hi + C::Q_BYTES;

  // Q lands in fp32 where Q_hi goes; each warpgroup splits its own 64 rows
  // in place, element by element (the swizzle places Q_hi's and Q_lo's
  // elements alike), and hands them to the tensor cores' proxy
  mbar_wait(q_full, 0);
#pragma unroll
  for (int c = 0; c < D / 32; ++c) {
    float4* hi = reinterpret_cast<float4*>(qs + c * C::QROWS * 128 + wg * 64 * 128);
    float4* lo = reinterpret_cast<float4*>(qs + C::Q_BYTES + c * C::QROWS * 128 + wg * 64 * 128);
#pragma unroll
    for (int u = tid; u < 64 * 128 / 16; u += 128) {
      const float4 x = hi[u];
      float4 h, l;
      tf32_split(x.x, h.x, l.x);
      tf32_split(x.y, h.y, l.y);
      tf32_split(x.z, h.z, l.z);
      tf32_split(x.w, h.w, l.w);
      hi[u] = h;
      lo[u] = l;
    }
  }
  fence_proxy_async();
  bar_sync(1 + wg, 128);

  float oacc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) oacc[i] = 0.f;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};

  for (int i = 0; i < n_tiles; ++i) {
    const int s = i % STAGES;
    const uint32_t phase = (i / STAGES) & 1;
    const int k0 = i * KT;
    mbar_wait(k_full + s, phase);
    if (causal && k0 > wg_last) {
      // no row of this warpgroup sees the tile. It still waits for the
      // tile's V^T: that lands only once both warpgroups have freed the
      // stage's previous V^T, so this arrival on v_empty counts toward this
      // tile's phase and not toward one the other warpgroup is still in
      mbar_wait(v_full + s, phase);
      mbar_arrive(k_empty + s);
      mbar_arrive(v_empty + s);
      continue;
    }
    // S = Q K^T in fp32 registers: per k8 step three TF32 products, the
    // small terms first (lo hi, hi lo, hi hi), summed from zero per tile
    const uint32_t k_hi = smem_u32(kv + s * C::STAGE), k_lo = k_hi + C::KV_BYTES;
    float sacc[KT / 2];
#pragma unroll
    for (int j = 0; j < KT / 2; ++j) sacc[j] = 0.f;
    fence_regs(sacc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 8; ++kk) {
      const uint64_t qh = kmajor_desc(q_hi, C::QROWS, kk), ql = kmajor_desc(q_lo, C::QROWS, kk);
      const uint64_t kh = kmajor_desc(k_hi, KT, kk), kl = kmajor_desc(k_lo, KT, kk);
      WgmmaTf32<KT>::ss(sacc, ql, kh, kk > 0);
      WgmmaTf32<KT>::ss(sacc, qh, kl, 1);
      WgmmaTf32<KT>::ss(sacc, qh, kh, 1);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(sacc);
    mbar_arrive(k_empty + s);   // this warpgroup is done with K_hi and K_lo

    // scale into the log2 domain, mask, and the online softmax, all on S's
    // own columns: a masked or padded key gets p = 0
    const bool edge = k0 + KT > skv || (causal && k0 + KT - 1 > q_offset + wrow0);
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int j = 0; j < KT / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = sacc[4 * j + e] * scale_log2;
        if (edge) {
          const int col = k0 + 8 * j + c2 + (e & 1);
          if (col >= skv || (causal && col > q_id[e / 2])) x = NEG_INF;
        }
        sacc[4 * j + e] = x;
        mx[e / 2] = fmaxf(mx[e / 2], x);
      }
    float alpha[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      alpha[h] = exp2f(m[h] - mx[h]);   // rescale the old partial sums
      m[h] = mx[h];
      l[h] *= alpha[h];
    }
    // P split into TF32 hi and lo in registers; k-step j takes keys
    // 8j .. 8j + 7, and the S registers (d0, d2, d1, d3) of that group are
    // the A registers (a0, a1, a2, a3) against V^T's permuted keys (key_at)
    uint32_t ph[KT / 8][4], pl[KT / 8][4];
#pragma unroll
    for (int j = 0; j < KT / 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float p0 = exp2f(sacc[4 * j + 2 * h] - m[h]);
        const float p1 = exp2f(sacc[4 * j + 2 * h + 1] - m[h]);
        l[h] += p0 + p1;
        float h0, l0, h1, l1;
        tf32_split(p0, h0, l0);
        tf32_split(p1, h1, l1);
        ph[j][h] = __float_as_uint(h0);
        pl[j][h] = __float_as_uint(l0);
        ph[j][2 + h] = __float_as_uint(h1);
        pl[j][2 + h] = __float_as_uint(l1);
      }
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) oacc[4 * j + e] *= alpha[e / 2];

    // O += P V in place: three TF32 products per k8 step, A from registers
    const uint32_t v_hi = k_hi + 2 * C::KV_BYTES, v_lo = k_hi + 3 * C::KV_BYTES;
    mbar_wait(v_full + s, phase);
    fence_regs(oacc);
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
    fence_regs(ph);
    fence_regs(pl);
    mbar_arrive(v_empty + s);
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    const int r = wrow0 + r_a + 8 * h;
    if (r >= sq_p) continue;
    const float den = fmaxf(l[h], 1e-30f);
    float* orow = o + ((size_t)bh * sq_p + r) * D + c2;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<float2*>(orow + 8 * j) =
          make_float2(oacc[4 * j + 2 * h] / den, oacc[4 * j + 2 * h + 1] / den);
  }
}

template <int D>
int launch(const void* q, const void* ks, const void* vts, void* o, int bh, int sq_p,
           int skv_p, int skv_t, int skv, int group, int causal, int q_offset, float scale,
           cudaStream_t stream) {
  using C = Cfg<D>;
  constexpr CUtensorMapDataType F32 = CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  const int hkv = bh / group;
  // Q (bh, sq_p, D); the K pair as one (2 hkv, skv_p, D) array and the V^T
  // pair as one (2 hkv, D, skv_t) array: the lo halves start hkv heads on
  CUtensorMap tq, tk, tv;
  int rc = tensor_map_3d(&tq, q, F32, 4, bh, sq_p, D, C::QROWS, 128);
  if (!rc) rc = tensor_map_3d(&tk, ks, F32, 4, 2 * hkv, skv_p, D, KT, 128);
  if (!rc) rc = tensor_map_3d(&tv, vts, F32, 4, 2 * hkv, D, skv_t, D, C::VSW);
  static bool configured = false;
  if (!rc) rc = allow_smem(flash_kernel_tf32<D>, C::SMEM, configured);
  if (rc) return rc;
  const dim3 grid(bh, (sq_p + C::QROWS - 1) / C::QROWS);
  flash_kernel_tf32<D><<<grid, C::THREADS, C::SMEM, stream>>>(
      tq, tk, tv, static_cast<float*>(o), sq_p, skv, hkv, group, causal, q_offset,
      scale * 1.4426950408889634f);
  return (int)cudaGetLastError();
}

}  // namespace tf

// ----------------------------------------------------------------- split_kv
namespace split {

constexpr int THREADS = 128;     // 4 warps
constexpr int KT = 32;           // keys per staged tile: one per lane
constexpr int MAX_ROWS = 64;     // q heads of a kv head x q positions
constexpr int MAX_SPLITS = 1024;

template <typename T, int D, int MAXR>
struct Cfg {
  static constexpr int EPC = 16 / sizeof(T);   // elements per 16-byte copy
  static constexpr int LD = D + EPC;           // staged K/V row, elements (16 B padding)
  static constexpr int RW = MAXR / 4;          // rows per warp in q k^T and softmax
  static constexpr int CPR = D / 4;            // 4-column groups of a row
  static constexpr int RG = THREADS / CPR;     // row groups of the p V product
  static constexpr int RPT = (MAXR + RG - 1) / RG;   // rows per thread there
  static constexpr int PLD = KT + 4;           // p row, floats
  // fp32 q rows, 2 stages of K and V, p rows, and m, l, alpha per row
  static size_t smem(int rows) {
    return sizeof(float) * (size_t)rows * (D + 4 + PLD + 3) + sizeof(T) * 2 * 2 * KT * LD;
  }
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;"
               :: "r"(smem_u32(dst)), "l"(src), "r"(valid ? 16 : 0) : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" :: "n"(N) : "memory");
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Pass 1: the (m, l, acc) of rows r = j * sq_p + pos (q head hk * group + j,
// position pos) over keys [split * split_len, ...) of kv head hk. MAXR >=
// rows bounds the rows per thread at compile time; a thread whose row index
// passes the last row computes on the last row and keeps nothing, so the
// loops carry no per-row branch.
template <typename T, int D, int MAXR>
__global__ void __launch_bounds__(THREADS)
flash_kernel_split(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                   float* __restrict__ part_acc, float* __restrict__ part_ml,
                   const int* __restrict__ dev_pos, int sq_p, int skv_p, int skv, int group,
                   int causal, int q_offset, int split_len, float scale) {
  using C = Cfg<T, D, MAXR>;
  extern __shared__ __align__(16) float smem_f[];
  const int rows = group * sq_p;
  float* Qs = smem_f;                                          // rows x (D + 4)
  T* Ks = reinterpret_cast<T*>(Qs + rows * (D + 4));           // 2 x KT x LD
  T* Vs = Ks + 2 * KT * C::LD;                                 // 2 x KT x LD
  float* Ps = reinterpret_cast<float*>(Vs + 2 * KT * C::LD);   // rows x PLD
  float* Ms = Ps + rows * C::PLD;
  float* Ls = Ms + rows;
  float* As = Ls + rows;

  const int split = blockIdx.x, hk = blockIdx.y;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  if (dev_pos) {   // q_offset and the valid length from device memory
    q_offset = dev_pos[0];
    skv = min(dev_pos[1], skv_p);
  }
  const int k_begin = split * split_len;
  int k_end = min(skv, k_begin + split_len);
  if (causal) k_end = min(k_end, q_offset + sq_p);   // no row sees a later key
  const int n_tiles = k_end > k_begin ? (k_end - k_begin + KT - 1) / KT : 0;
  const T* kb = k + (size_t)hk * skv_p * D;
  const T* vb = v + (size_t)hk * skv_p * D;

  // tile t into stage buf; keys past k_end are zero-filled
  auto stage = [&](int t, int buf) {
    constexpr int CH = D / C::EPC;
    const int k0 = k_begin + t * KT, kt = min(KT, k_end - k0);
    for (int i = tid; i < KT * CH; i += THREADS) {
      const int r = i / CH, c = (i % CH) * C::EPC;
      const size_t src = (size_t)(k0 + min(r, kt - 1)) * D + c;
      cp_async16(Ks + (buf * KT + r) * C::LD + c, kb + src, r < kt);
      cp_async16(Vs + (buf * KT + r) * C::LD + c, vb + src, r < kt);
    }
    cp_async_commit();
  };
  if (n_tiles > 0) stage(0, 0);

  for (int i = tid; i < rows * (D / 4); i += THREADS) {
    const int r = i / (D / 4), c = (i % (D / 4)) * 4;
    const T* src = q + ((size_t)(hk * group + r / sq_p) * sq_p + r % sq_p) * D + c;
    *reinterpret_cast<float4*>(Qs + r * (D + 4) + c) = load4(src);
  }
  for (int r = tid; r < rows; r += THREADS) {
    Ms[r] = NEG_INF;
    Ls[r] = 0.f;
  }

  // q k^T and softmax: warp w owns rows w + 4i, lane = key, so a row's max
  // and sum are warp shuffles. p V: thread (rg, c4) owns rows rg + RG i,
  // columns 4 c4 .. 4 c4 + 3.
  int sr[C::RW], pr[C::RPT];
#pragma unroll
  for (int i = 0; i < C::RW; ++i) sr[i] = min(warp + 4 * i, rows - 1);
  const int c4 = tid % C::CPR, rg = tid / C::CPR;
#pragma unroll
  for (int i = 0; i < C::RPT; ++i) pr[i] = min(rg + C::RG * i, rows - 1);
  float acc[C::RPT][4];
#pragma unroll
  for (int i = 0; i < C::RPT; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;

  for (int t = 0; t < n_tiles; ++t) {
    const int buf = t & 1;
    if (t + 1 < n_tiles) {
      stage(t + 1, buf ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const T* Kt = Ks + buf * KT * C::LD;
    const T* Vt = Vs + buf * KT * C::LD;
    const int k0 = k_begin + t * KT, kt = min(KT, k_end - k0);
    const int k_id = k0 + lane;

    float s[C::RW];
#pragma unroll
    for (int i = 0; i < C::RW; ++i) s[i] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      const float4 kx = load4(Kt + lane * C::LD + d);
#pragma unroll
      for (int i = 0; i < C::RW; ++i)
        s[i] = fma4(*reinterpret_cast<const float4*>(Qs + sr[i] * (D + 4) + d), kx, s[i]);
    }
#pragma unroll
    for (int i = 0; i < C::RW; ++i) {
      const int r = sr[i];
      const bool ok = lane < kt && (!causal || k_id <= q_offset + r % sq_p);
      const float x = ok ? s[i] * scale : NEG_INF;
      const float m_old = Ms[r];
      const float m_new = fmaxf(m_old, warp_max(x));
      const float p = ok ? expf(x - m_new) : 0.f;
      const float sum = warp_sum(p);
      if (warp + 4 * i < rows) {   // the row's owner; a clamped copy keeps nothing
        Ps[r * C::PLD + lane] = p;
        if (lane == 0) {
          const float alpha = expf(m_old - m_new);   // rescale the old partial sums
          Ms[r] = m_new;
          Ls[r] = Ls[r] * alpha + sum;
          As[r] = alpha;
        }
      }
    }
    __syncthreads();

    // acc = acc alpha + p V over the whole tile: keys past kt have p = 0
#pragma unroll
    for (int i = 0; i < C::RPT; ++i) {
      const float a = As[pr[i]];
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][e] *= a;
    }
#pragma unroll 2
    for (int kk = 0; kk < KT; kk += 4) {
      float4 vx[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) vx[u] = load4(Vt + (kk + u) * C::LD + 4 * c4);
#pragma unroll
      for (int i = 0; i < C::RPT; ++i) {
        const float4 p = *reinterpret_cast<const float4*>(Ps + pr[i] * C::PLD + kk);
        const float pu[4] = {p.x, p.y, p.z, p.w};
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          acc[i][0] = fmaf(pu[u], vx[u].x, acc[i][0]);
          acc[i][1] = fmaf(pu[u], vx[u].y, acc[i][1]);
          acc[i][2] = fmaf(pu[u], vx[u].z, acc[i][2]);
          acc[i][3] = fmaf(pu[u], vx[u].w, acc[i][3]);
        }
      }
    }
    __syncthreads();   // the stage and p rows are read out
  }
  __syncthreads();

  // the partials: (BH / group, splits, rows, D) and (..., rows, 2) in fp32
  const size_t row_base = ((size_t)hk * gridDim.x + split) * rows;
#pragma unroll
  for (int i = 0; i < C::RPT; ++i)
    if (rg + C::RG * i < rows)
      *reinterpret_cast<float4*>(part_acc + (row_base + pr[i]) * D + 4 * c4) =
          make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
  for (int r = tid; r < rows; r += THREADS)
    *reinterpret_cast<float2*>(part_ml + (row_base + r) * 2) = make_float2(Ms[r], Ls[r]);
}

// Pass 2: one block per row of one kv head combines that row's splits.
template <typename T>
__global__ void __launch_bounds__(THREADS)
flash_kernel_combine(const float* __restrict__ part_acc, const float* __restrict__ part_ml,
                     T* __restrict__ o, int splits, int d, int sq_p, int group) {
  __shared__ float w[MAX_SPLITS];
  const int r = blockIdx.x, hk = blockIdx.y, rows = gridDim.x;
  const size_t first = (size_t)hk * splits * rows + r;   // split s at first + s * rows
  float m_star = NEG_INF;
  for (int s = 0; s < splits; ++s) m_star = fmaxf(m_star, part_ml[(first + (size_t)s * rows) * 2]);
  for (int s = threadIdx.x; s < splits; s += THREADS)
    w[s] = expf(part_ml[(first + (size_t)s * rows) * 2] - m_star);
  __syncthreads();
  float l = 0.f;
  for (int s = 0; s < splits; ++s) l += part_ml[(first + (size_t)s * rows) * 2 + 1] * w[s];
  const float den = fmaxf(l, 1e-30f);
  T* orow = o + ((size_t)(hk * group + r / sq_p) * sq_p + r % sq_p) * d;
  for (int c = threadIdx.x; c < d; c += THREADS) {
    float acc = 0.f;
    for (int s = 0; s < splits; ++s) acc += part_acc[(first + (size_t)s * rows) * d + c] * w[s];
    orow[c] = from_f<T>(acc / den);
  }
}

template <typename T, int D, int MAXR>
int launch(const void* q, const void* k, const void* v, float* part_acc, float* part_ml,
           const int* pos, int bh, int sq_p, int skv_p, int skv, int group, int causal,
           int q_offset, int splits, int split_len, float scale, cudaStream_t stream) {
  using C = Cfg<T, D, MAXR>;
  static bool configured = false;
  if (const int rc = allow_smem(flash_kernel_split<T, D, MAXR>, C::smem(MAXR), configured))
    return rc;
  const dim3 grid(splits, bh / group);
  flash_kernel_split<T, D, MAXR><<<grid, THREADS, C::smem(group * sq_p), stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), part_acc,
      part_ml, pos, sq_p, skv_p, skv, group, causal, q_offset, split_len, scale);
  return (int)cudaGetLastError();
}

// The instantiation for the rows of one kv head: 8, 16, 32 or 64 at most.
template <typename T, int D>
int launch_rows(const void* q, const void* k, const void* v, float* pa, float* pm,
                const int* pos, int bh, int sq_p, int skv_p, int skv, int group, int causal,
                int q_offset, int splits, int split_len, float scale, cudaStream_t s) {
  const int rows = group * sq_p;
  if (rows <= 8)
    return launch<T, D, 8>(q, k, v, pa, pm, pos, bh, sq_p, skv_p, skv, group, causal, q_offset, splits, split_len, scale, s);
  if (rows <= 16)
    return launch<T, D, 16>(q, k, v, pa, pm, pos, bh, sq_p, skv_p, skv, group, causal, q_offset, splits, split_len, scale, s);
  if (rows <= 32)
    return launch<T, D, 32>(q, k, v, pa, pm, pos, bh, sq_p, skv_p, skv, group, causal, q_offset, splits, split_len, scale, s);
  return launch<T, D, MAX_ROWS>(q, k, v, pa, pm, pos, bh, sq_p, skv_p, skv, group, causal, q_offset, splits, split_len, scale, s);
}

template <typename T>
int launch_d(int d, const void* q, const void* k, const void* v, float* pa, float* pm,
             const int* pos, int bh, int sq_p, int skv_p, int skv, int group, int causal,
             int q_offset, int splits, int split_len, float scale, cudaStream_t s) {
  switch (d) {
    case 32: return launch_rows<T, 32>(q, k, v, pa, pm, pos, bh, sq_p, skv_p, skv, group, causal, q_offset, splits, split_len, scale, s);
    case 64: return launch_rows<T, 64>(q, k, v, pa, pm, pos, bh, sq_p, skv_p, skv, group, causal, q_offset, splits, split_len, scale, s);
    case 128: return launch_rows<T, 128>(q, k, v, pa, pm, pos, bh, sq_p, skv_p, skv, group, causal, q_offset, splits, split_len, scale, s);
    case 256: return launch_rows<T, 256>(q, k, v, pa, pm, pos, bh, sq_p, skv_p, skv, group, causal, q_offset, splits, split_len, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace split

template <int D>
int launch_one_pass(int dtype, const void* q, const void* k, const void* v, void* o, int bh,
                    int sq_p, int skv_p, int skv, int group, int causal, int q_offset,
                    float scale, cudaStream_t s) {
  if (dtype == 0)
    return core::launch<float, D>(q, k, v, o, bh, sq_p, skv_p, skv, group, causal, q_offset, scale, s);
  if (dtype == 1) return tc::launch<D>(q, k, v, o, bh, sq_p, skv_p, skv, group, causal, q_offset, scale, s);
  return (int)cudaErrorInvalidValue;
}

bool bad_shape(int bh, int sq_p, int skv_p, int skv, int group, int causal, int q_offset) {
  return bh < 1 || sq_p < 1 || skv < 1 || skv > skv_p || group < 1 || bh % group ||
         bh > 65535 || sq_p > 65535 * 128 || (causal && q_offset < 0) || (!causal && skv != skv_p);
}

}  // namespace

extern "C" {

// One pass over the keys: dtype 0 (float32) runs the cuda_core body, dtype 1
// (bfloat16) the tc_bf16 body. q and o are (bh, sq_p, d); k and v are
// (bh / group, skv_p, d); keys at or beyond skv are padding (causal only).
int flash_attention_launch(const void* q, const void* k, const void* v, void* o,
                           int dtype, int bh, int sq_p, int skv_p, int skv,
                           int d, int group, int causal, int q_offset,
                           float scale, void* stream) {
  if (bad_shape(bh, sq_p, skv_p, skv, group, causal, q_offset) || !aligned16(q) ||
      !aligned16(k) || !aligned16(v) || !aligned16(o))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 32: return launch_one_pass<32>(dtype, q, k, v, o, bh, sq_p, skv_p, skv, group, causal, q_offset, scale, s);
    case 64: return launch_one_pass<64>(dtype, q, k, v, o, bh, sq_p, skv_p, skv, group, causal, q_offset, scale, s);
    case 128: return launch_one_pass<128>(dtype, q, k, v, o, bh, sq_p, skv_p, skv, group, causal, q_offset, scale, s);
    case 256: return launch_one_pass<256>(dtype, q, k, v, o, bh, sq_p, skv_p, skv, group, causal, q_offset, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// One pass on the tc_3xtf32 body (float32; d 32, 64 or 128): q and o are
// (bh, sq_p, d); ks is the pack's K_hi then K_lo, each (bh / group, skv_p,
// d), and vts its Vt_hi then Vt_lo, each (bh / group, d, skv_t) with skv_t
// a multiple of the key tile, at least skv_p, as flash_attention_pack
// writes them.
int flash_tf32_launch(const void* q, const void* ks, const void* vts, void* o, int bh,
                      int sq_p, int skv_p, int skv_t, int skv, int d, int group, int causal,
                      int q_offset, float scale, void* stream) {
  if (bad_shape(bh, sq_p, skv_p, skv, group, causal, q_offset) || skv_t < skv_p ||
      skv_t % tf::KT || !aligned16(q) || !aligned16(ks) || !aligned16(vts) || !aligned16(o))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 32: return tf::launch<32>(q, ks, vts, o, bh, sq_p, skv_p, skv_t, skv, group, causal, q_offset, scale, s);
    case 64: return tf::launch<64>(q, ks, vts, o, bh, sq_p, skv_p, skv_t, skv, group, causal, q_offset, scale, s);
    case 128: return tf::launch<128>(q, ks, vts, o, bh, sq_p, skv_p, skv_t, skv, group, causal, q_offset, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// tc_3xtf32's pack pass: k and v (hkv, skv_p, d), float32, row major -> ks
// = K_hi, K_lo (each (hkv, skv_p, d)) and vts = Vt_hi, Vt_lo (each (hkv, d,
// skv_t)), V transposed, each group of 8 keys in the order 0, 2, 4, 6, 1,
// 3, 5, 7, zero from key skv_p on. d and skv_t multiples of 32; k and ks
// 16-byte aligned.
int flash_attention_pack(const void* k, const void* v, void* ks, void* vts, int hkv, int skv_p,
                         int skv_t, int d, void* stream) {
  if (hkv < 1 || skv_p < 1 || skv_t < skv_p || skv_t % 32 || d < 32 || d % 32 ||
      !aligned16(k) || !aligned16(ks))
    return (int)cudaErrorInvalidValue;
  tf::pack<<<dim3(tf::PACK_BLOCKS, 2), tf::PACK_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(k), static_cast<const float*>(v), static_cast<float*>(ks),
      static_cast<float*>(vts), hkv, skv_p, skv_t, d);
  return (int)cudaGetLastError();
}

// split_kv pass 1 (dtype 0 float32, 1 bfloat16): the fp32 partials of
// `splits` key ranges of split_len keys into part_acc (bh / group, splits,
// group * sq_p, d) and part_ml (..., 2). With pos (two int32 on the device,
// or null) every block reads q_offset = pos[0] and the valid length skv =
// min(pos[1], skv_p) when it starts, in place of the integer arguments, so
// one launch (or one captured graph) serves every position: the host's skv
// is then the capacity skv_p, the ranges cut the capacity, and a range that
// starts at or past the valid length sees no key and writes (m, l, acc) =
// (NEG_INF, 0, 0), which the combine weighs by exp(NEG_INF - m*) = 0.
int flash_split_launch(const void* q, const void* k, const void* v, void* part_acc,
                       void* part_ml, const void* pos, int dtype, int bh, int sq_p, int skv_p,
                       int skv, int d, int group, int causal, int q_offset, int splits,
                       int split_len, float scale, void* stream) {
  if (bad_shape(bh, sq_p, skv_p, skv, group, causal, q_offset) ||
      group * sq_p > split::MAX_ROWS || splits < 1 || splits > split::MAX_SPLITS ||
      bh / group > 65535 || split_len < 1 || (long long)splits * split_len < skv ||
      !aligned16(q) || !aligned16(k) || !aligned16(v) || !aligned16(part_acc) ||
      !aligned16(part_ml))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* pa = static_cast<float*>(part_acc);
  float* pm = static_cast<float*>(part_ml);
  const int* dp = static_cast<const int*>(pos);
  if (dtype == 0)
    return split::launch_d<float>(d, q, k, v, pa, pm, dp, bh, sq_p, skv_p, skv, group, causal, q_offset, splits, split_len, scale, s);
  if (dtype == 1)
    return split::launch_d<__nv_bfloat16>(d, q, k, v, pa, pm, dp, bh, sq_p, skv_p, skv, group, causal, q_offset, splits, split_len, scale, s);
  return (int)cudaErrorInvalidValue;
}

// split_kv pass 2: combines the partials into o (bh, sq_p, d), bh = hkv * group.
int flash_combine_launch(const void* part_acc, const void* part_ml, void* o, int dtype,
                         int hkv, int sq_p, int d, int group, int splits, void* stream) {
  if (hkv < 1 || hkv > 65535 || sq_p < 1 || group < 1 || group * sq_p > split::MAX_ROWS ||
      d < 1 || splits < 1 || splits > split::MAX_SPLITS)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(group * sq_p, hkv);
  const float* pa = static_cast<const float*>(part_acc);
  const float* pm = static_cast<const float*>(part_ml);
  if (dtype == 0)
    split::flash_kernel_combine<float><<<grid, split::THREADS, 0, s>>>(
        pa, pm, static_cast<float*>(o), splits, d, sq_p, group);
  else if (dtype == 1)
    split::flash_kernel_combine<__nv_bfloat16><<<grid, split::THREADS, 0, s>>>(
        pa, pm, static_cast<__nv_bfloat16*>(o), splits, d, sq_p, group);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
