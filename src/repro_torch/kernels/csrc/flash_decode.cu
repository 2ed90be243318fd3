// One-token GQA decode attention over a KV cache, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `flash_decode` of
// src/repro/kernels/flash_decode.py (function :116, body `_kernel` :81,
// call :126).  q is (B, KV, G, hd): the G query heads that share each of
// the KV cache heads; k and v are (B, L, KV, hd); `pos` is the last valid
// cache index, read from device memory (the TPU kernel's scalar prefetch).
// The output (B, KV, G, hd) is in q's dtype.
//
// What it computes, in float32, as the TPU kernel and the plain version
// `flash_decode_ref` (kernels/ref.py) do: scores s = (q . k) / sqrtf(hd)
// (a correctly rounded division by the float32 root), every position
// idx > pos masked to -1e30, an online softmax with running m (from
// -1e30) and l, acc += p * v, and out = acc / l, rounded once to q's
// dtype.  Exponentials are `expf`, not `__expf`.  Sums run in another order
// than the plain version's 512-position blocks, so the two agree to float32
// rounding, not bit for bit.
//
// Bound: bytes.  A step reads the cache rows up to `pos` once: at
// (B, L, KV, hd) = (4, 32768, 8, 128) bf16 that is 537 MB, 0.160 ms at
// 3.35 TB/s, against 2.15 GFLOP of float32 work (0.032 ms at 67 TFLOP/s).
// The TPU kernel walks L in one sequential grid dimension with its
// accumulators in VMEM; one block per (b, kv) here would give 32 blocks to
// 132 SMs.  So L is split: block (split, kv, b) walks `chunk` positions and
// writes a float32 partial (m, l, acc[G][hd]); a second kernel combines the
// partials of each (b, kv, g) row.  A block streams its positions through
// shared memory in tiles of 16 KB of K and 16 KB of V (64 positions at
// hd 128 in bf16), two stages deep: `cp.async` copies tile j + 1 while the
// block computes on tile j, so each block keeps 32 KB of loads in flight.
// Per tile, each warp scores 32 / KG positions at a time, KG being G
// rounded up to a power of two (a template parameter): a lane holds hd/32
// values of each key row and of each query row, and the 32 partial dot
// products are reduced across the warp by recursive halving, 31 shuffles
// for all 32, after which lane i holds product i.  Then one warp per query
// row updates m and l and turns the tile's scores into p in shared memory,
// and thread d adds p * v[., d] into its G accumulators.  Splits and tiles
// past `pos` are not read: their p would be exp(-1e30 - m) = 0 exactly.
// Offsets are 64-bit: a 32k cache of granite-8b holds 2^28 values a layer
// and batch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxG = 8;          // query heads per KV head
constexpr int kStageBytes = 16384;  // of K (and of V) a tile holds
constexpr int kMaxTile = 128;     // positions a tile holds at most
constexpr float kMask = -1e30f;   // the TPU kernel's mask and initial max

template <typename T>
__device__ __forceinline__ float to_f32(T x);
template <>
__device__ __forceinline__ float to_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// VEC consecutive values of type T, moved as one access.
template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Pack {
  T v[VEC];
};

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

// The tile of one stage: positions, and 16-byte copies per row.
template <typename T, int HD>
struct Tile {
  static constexpr int kRowBytes = HD * static_cast<int>(sizeof(T));
  static constexpr int kPositions = kStageBytes / kRowBytes;
  static constexpr int kCopiesPerRow = kRowBytes / 16;
  static_assert(kPositions <= kMaxTile, "tile");
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Issue the copies of n cache rows, each HD values, from src (row stride
// row_stride values) into the stage dst (rows packed).
template <typename T, int HD>
__device__ __forceinline__ void copy_rows(T* dst, const T* src, int n,
                                          int64_t row_stride) {
  using G = Tile<T, HD>;
  for (int c = threadIdx.x; c < n * G::kCopiesPerRow; c += HD) {
    const int r = c / G::kCopiesPerRow, w = c % G::kCopiesPerRow;
    cp_async16(reinterpret_cast<char*>(dst) + r * G::kRowBytes + w * 16,
               reinterpret_cast<const char*>(src + r * row_stride) + w * 16);
  }
}

// One step of the warp's reduce-scatter: 2H values a lane -> H, lane
// halves exchanged with the lane H away.
template <int H>
__device__ __forceinline__ void halve(float* v, int lane) {
  const bool up = lane & H;
#pragma unroll
  for (int i = 0; i < H; ++i) {
    const float keep = up ? v[i + H] : v[i];
    const float send = up ? v[i] : v[i + H];
    v[i] = keep + __shfl_xor_sync(0xffffffffu, send, H);
  }
}

// Block (split, kv, b) of HD threads: the partial softmax of positions
// [split * chunk, min((split + 1) * chunk, L)) for the G query rows of
// (b, kv), G <= KG (a power of two: a warp scores 32 / KG positions at
// once).  Partials are laid out (B, KV, nsplit, G) and (B, KV, nsplit, G,
// HD).  Dynamic shared memory: two stages of K, then two of V.
template <typename T, int HD, int KG>
__global__ void __launch_bounds__(HD)
    flash_decode_split(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, const int* __restrict__ pos_p,
                       float* __restrict__ part_m, float* __restrict__ part_l,
                       float* __restrict__ part_acc, int length, int kv_heads,
                       int g_heads, int chunk, int nsplit) {
  constexpr int kWarps = HD / 32;
  constexpr int kVpl = HD / 32;  // values of a row per lane
  constexpr int kGroup = 32 / KG;  // positions a warp scores at once
  constexpr int kTile = Tile<T, HD>::kPositions;
  constexpr int kStage = kStageBytes / static_cast<int>(sizeof(T));
  using P = Pack<T, kVpl>;
  extern __shared__ __align__(128) unsigned char smem[];
  T* k_stage = reinterpret_cast<T*>(smem);
  T* v_stage = k_stage + 2 * kStage;
  __shared__ __align__(16) float s_p[kMaxG][kMaxTile];
  __shared__ float s_m[kMaxG], s_l[kMaxG], s_alpha[kMaxG];

  const int split = blockIdx.x, kv = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int pos = *pos_p;
  const int start = split * chunk;
  const int end = min(start + chunk, length);
  // positions past pos add exp(-1e30 - m) = 0 once m holds a real score;
  // with pos < 0 every position is masked and all are read
  const int last = (pos >= 0 && pos < end) ? pos + 1 : end;
  const int ntiles = last > start ? (last - start + kTile - 1) / kTile : 0;

  const int64_t row_stride = static_cast<int64_t>(kv_heads) * HD;
  const int64_t base = (static_cast<int64_t>(b) * length * kv_heads + kv) * HD;
  const T* kb = k + base;
  const T* vb = v + base;
  if (ntiles > 0) {
    const int n = min(kTile, last - start);
    copy_rows<T, HD>(k_stage, kb + start * row_stride, n, row_stride);
    copy_rows<T, HD>(v_stage, vb + start * row_stride, n, row_stride);
    cp_async_commit();
  }

  const int64_t bk = static_cast<int64_t>(b) * kv_heads + kv;
  float qr[KG][kVpl];
  {
    const T* qb = q + bk * g_heads * HD + lane * kVpl;
#pragma unroll
    for (int g = 0; g < KG; ++g)
#pragma unroll
      for (int j = 0; j < kVpl; ++j)
        qr[g][j] = g < g_heads ? to_f32(qb[g * HD + j]) : 0.0f;
  }
  float acc[KG];
#pragma unroll
  for (int g = 0; g < KG; ++g) acc[g] = 0.0f;
  if (tid < kMaxG) {
    s_m[tid] = kMask;
    s_l[tid] = 0.0f;
  }
  const float scale = sqrtf(static_cast<float>(HD));

  for (int j = 0; j < ntiles; ++j) {
    const int t0 = start + j * kTile;
    const int n = min(kTile, last - t0);
    if (j + 1 < ntiles) {  // the next tile's copies, into the other stage
      const int t1 = t0 + kTile;
      const int n1 = min(kTile, last - t1);
      const int s1 = (j + 1) & 1;
      copy_rows<T, HD>(k_stage + s1 * kStage, kb + t1 * row_stride, n1,
                       row_stride);
      copy_rows<T, HD>(v_stage + s1 * kStage, vb + t1 * row_stride, n1,
                       row_stride);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const T* ks = k_stage + (j & 1) * kStage;
    const T* vs = v_stage + (j & 1) * kStage;
    // scores: warp w takes positions w * kGroup + [0, kGroup), then the
    // next kWarps * kGroup; value r * KG + g of a lane is its part of
    // q_g . k_r, and after the halving lane r * KG + g holds the whole
    for (int i0 = warp * kGroup; i0 < n; i0 += kWarps * kGroup) {
      float part[32];
#pragma unroll
      for (int r = 0; r < kGroup; ++r) {
        P kr;
        if (i0 + r < n) {
          kr = *reinterpret_cast<const P*>(ks + (i0 + r) * HD + lane * kVpl);
        } else {
#pragma unroll
          for (int jj = 0; jj < kVpl; ++jj) kr.v[jj] = from_f32<T>(0.0f);
        }
#pragma unroll
        for (int g = 0; g < KG; ++g) {
          float d = 0.0f;
#pragma unroll
          for (int jj = 0; jj < kVpl; ++jj)
            d = fmaf(qr[g][jj], to_f32(kr.v[jj]), d);
          part[r * KG + g] = d;
        }
      }
      halve<16>(part, lane);
      halve<8>(part, lane);
      halve<4>(part, lane);
      halve<2>(part, lane);
      halve<1>(part, lane);
      const int r = lane / KG, g = lane % KG;
      if (g < g_heads && i0 + r < n)
        s_p[g][i0 + r] = t0 + i0 + r <= pos ? part[0] / scale : kMask;
    }
    __syncthreads();
    // online softmax: warp w updates the rows g = w, w + kWarps, ...
    for (int g = warp; g < g_heads; g += kWarps) {
      float mx = kMask;
      for (int i = lane; i < n; i += 32) mx = fmaxf(mx, s_p[g][i]);
      mx = warp_max(mx);
      const float m_prev = s_m[g];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.0f;
      for (int i = lane; i < n; i += 32) {
        const float p = expf(s_p[g][i] - m_new);
        s_p[g][i] = p;
        sum += p;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        s_alpha[g] = alpha;
        s_l[g] = s_l[g] * alpha + sum;
        s_m[g] = m_new;
      }
    }
    __syncthreads();
    // acc[g] = acc[g] * alpha[g] + sum_i p[g][i] * v[i][tid]
#pragma unroll
    for (int g = 0; g < KG; ++g)
      if (g < g_heads) acc[g] *= s_alpha[g];
    const T* vt = vs + tid;
    int i = 0;
    for (; i + 4 <= n; i += 4) {
      float x[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) x[u] = to_f32(vt[(i + u) * HD]);
#pragma unroll
      for (int g = 0; g < KG; ++g) {
        if (g < g_heads) {
          const float4 p = *reinterpret_cast<const float4*>(&s_p[g][i]);
          acc[g] = fmaf(p.x, x[0], acc[g]);
          acc[g] = fmaf(p.y, x[1], acc[g]);
          acc[g] = fmaf(p.z, x[2], acc[g]);
          acc[g] = fmaf(p.w, x[3], acc[g]);
        }
      }
    }
    for (; i < n; ++i) {
      const float x = to_f32(vt[i * HD]);
#pragma unroll
      for (int g = 0; g < KG; ++g)
        if (g < g_heads) acc[g] = fmaf(s_p[g][i], x, acc[g]);
    }
    __syncthreads();  // s_p and this stage are rewritten after this
  }

  const int64_t part = bk * nsplit + split;
  if (tid < g_heads) {
    part_m[part * g_heads + tid] = s_m[tid];
    part_l[part * g_heads + tid] = s_l[tid];
  }
  float* pa = part_acc + part * g_heads * HD + tid;
#pragma unroll
  for (int g = 0; g < KG; ++g)
    if (g < g_heads) pa[g * HD] = acc[g];
}

// Block (b * KV + kv) * G + g of HD threads: the output row from the
// nsplit partials, out = sum_s acc_s w_s / sum_s l_s w_s with
// w_s = exp(m_s - max_s m_s).  A split that read nothing has m = -1e30 and
// l = acc = 0: its weight is 0 once another split holds a real score.
template <typename T, int HD>
__global__ void __launch_bounds__(HD)
    flash_decode_combine(const float* __restrict__ part_m,
                         const float* __restrict__ part_l,
                         const float* __restrict__ part_acc,
                         T* __restrict__ out, int g_heads, int nsplit) {
  const int64_t row = blockIdx.x;
  const int64_t bk = row / g_heads;
  const int g = static_cast<int>(row % g_heads);
  const int tid = threadIdx.x;
  const float* m = part_m + bk * nsplit * g_heads + g;
  const float* l = part_l + bk * nsplit * g_heads + g;
  const float* a = part_acc + (bk * nsplit * g_heads + g) * HD + tid;
  float mx = kMask;
  for (int s = 0; s < nsplit; ++s) mx = fmaxf(mx, m[s * g_heads]);
  float den = 0.0f, num = 0.0f;
  for (int s = 0; s < nsplit; ++s) {
    const float w = expf(m[s * g_heads] - mx);
    den = fmaf(l[s * g_heads], w, den);
    num = fmaf(a[static_cast<int64_t>(s) * g_heads * HD], w, num);
  }
  out[row * HD + tid] = from_f32<T>(num / den);
}

template <typename T, int HD, int KG>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const int* pos, float* part_m, float* part_l,
                   float* part_acc, void* out, int b, int length,
                   int kv_heads, int g_heads, int chunk, int nsplit,
                   cudaStream_t stream) {
  const dim3 grid(nsplit, kv_heads, b);
  constexpr int kSmem = 4 * kStageBytes;  // two stages of K and of V
  cudaError_t err = cudaFuncSetAttribute(
      flash_decode_split<T, HD, KG>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return err;
  flash_decode_split<T, HD, KG><<<grid, HD, kSmem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), pos, part_m, part_l, part_acc, length,
      kv_heads, g_heads, chunk, nsplit);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int rows = b * kv_heads * g_heads;
  flash_decode_combine<T, HD><<<rows, HD, 0, stream>>>(
      part_m, part_l, part_acc, static_cast<T*>(out), g_heads, nsplit);
  return cudaGetLastError();
}

template <typename T, int HD>
cudaError_t dispatch_group(const void* q, const void* k, const void* v,
                           const int* pos, float* part_m, float* part_l,
                           float* part_acc, void* out, int b, int length,
                           int kv_heads, int g_heads, int chunk, int nsplit,
                           cudaStream_t s) {
  if (g_heads <= 1)
    return launch<T, HD, 1>(q, k, v, pos, part_m, part_l, part_acc, out, b,
                            length, kv_heads, g_heads, chunk, nsplit, s);
  if (g_heads <= 2)
    return launch<T, HD, 2>(q, k, v, pos, part_m, part_l, part_acc, out, b,
                            length, kv_heads, g_heads, chunk, nsplit, s);
  if (g_heads <= 4)
    return launch<T, HD, 4>(q, k, v, pos, part_m, part_l, part_acc, out, b,
                            length, kv_heads, g_heads, chunk, nsplit, s);
  return launch<T, HD, kMaxG>(q, k, v, pos, part_m, part_l, part_acc, out,
                              b, length, kv_heads, g_heads, chunk, nsplit,
                              s);
}

template <typename T>
cudaError_t dispatch(int hd, const void* q, const void* k, const void* v,
                     const int* pos, float* part_m, float* part_l,
                     float* part_acc, void* out, int b, int length,
                     int kv_heads, int g_heads, int chunk, int nsplit,
                     cudaStream_t s) {
  switch (hd) {
    case 64:
      return dispatch_group<T, 64>(q, k, v, pos, part_m, part_l, part_acc,
                                   out, b, length, kv_heads, g_heads, chunk,
                                   nsplit, s);
    case 128:
      return dispatch_group<T, 128>(q, k, v, pos, part_m, part_l, part_acc,
                                    out, b, length, kv_heads, g_heads, chunk,
                                    nsplit, s);
    case 256:
      return dispatch_group<T, 256>(q, k, v, pos, part_m, part_l, part_acc,
                                    out, b, length, kv_heads, g_heads, chunk,
                                    nsplit, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype codes: 0 float32, 1 bfloat16 (q, k, v and out alike).  q (B, KV,
// G, hd), k and v (B, L, KV, hd) and out (B, KV, G, hd) contiguous, k and
// v on 16-byte boundaries; pos one int32 on the device; part_m and part_l (B, KV, nsplit, G) and part_acc
// (B, KV, nsplit, G, hd) float32 scratch, with nsplit * chunk >= L.  hd is
// 64, 128 or 256 and G at most 8.  Returns a cudaError_t; the kernels run
// on `stream` and the call does not synchronise.
extern "C" int repro_flash_decode(const void* q, const void* k, const void* v,
                                  int dtype, const int* pos, float* part_m,
                                  float* part_l, float* part_acc, void* out,
                                  int b, int length, int kv_heads,
                                  int g_heads, int hd, int chunk, int nsplit,
                                  void* stream) {
  if (b < 1 || length < 1 || kv_heads < 1 || g_heads < 1 ||
      g_heads > kMaxG || chunk < 1 || nsplit < 1 ||
      static_cast<int64_t>(chunk) * nsplit < length ||
      static_cast<int64_t>(chunk) * (nsplit - 1) >= length)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch<float>(hd, q, k, v, pos, part_m, part_l, part_acc, out,
                           b, length, kv_heads, g_heads, chunk, nsplit, s);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(hd, q, k, v, pos, part_m, part_l,
                                   part_acc, out, b, length, kv_heads,
                                   g_heads, chunk, nsplit, s);
  return cudaErrorInvalidValue;
}
