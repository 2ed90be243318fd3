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
// -1e30) and l, acc += p * v with p in float32, and out = acc / l, rounded
// once to q's dtype.  Exponentials are `expf`, not `__expf`.  Sums run in
// another order than the plain version's 512-position blocks, so the two
// agree to float32 rounding, not bit for bit.
//
// Bound: bytes.  A step reads the cache rows up to `pos` once: at
// (B, L, KV, hd) = (4, 32768, 8, 128) bf16 that is 524 MB, 0.157 ms at
// 3.35 TB/s, against 2.1 GFLOP of float32 work (0.031 ms at 67 TFLOP/s).
// The TPU kernel walks L in one sequential grid dimension with its
// accumulators in VMEM; one block per (b, kv) here would give 32 blocks to
// 132 SMs.  So L is split: block (split, kv, b) walks `chunk` positions of
// one (b, kv) row and ends in a float32 partial (m, l, acc[G][hd]).
// Splits and tiles past `pos` are not read: their p would be
// exp(-1e30 - m) = 0 exactly.  Offsets are 64-bit: a 32k cache of
// granite-8b holds 2^28 values a layer and batch.
//
// bfloat16 (the serving path): a warp-specialised block of 4 consumer
// warps and 1 producer warp, one launch a call.
//  - One thread of the producer keeps a ring of 3 or 4 stages in shared
//    memory full.  A stage holds 64 positions of K and of V; each is asked
//    for as ceil(hd / 64) boxes of 64 positions x 64 values (8 KB) through a
//    tensor map, a 3-d view (KV * hd, L, B) of the cache that the host
//    encodes for each call, and the Tensor Memory
//    Accelerator completes the bytes on the stage's `mbarrier`.  No
//    consumer instruction is spent on copies; at hd 128 up to 3 x 32 KB
//    are in flight a block, two blocks an SM.  One KV head's positions
//    lie 2 KB apart in the (B, L, KV, hd) layout, so a copy per 256-byte
//    row was the alternative; its issue rate, not the bytes, bounded it.
//    The map's 128-byte swizzle puts the 8 rows an `ldmatrix` reads on 8
//    different bank groups.  The first stage is asked for before `pos`
//    has arrived, and positions past L read as zeros.
//  - Consumer warp w takes positions 16w .. 16w + 15 of each stage and
//    scores them on the tensor cores: `mma.sync` m16n8k16 with bf16
//    inputs and float32 accumulation, scores^T = K q^T (M = 16 positions,
//    N = G padded to 8, K = hd), q's fragments kept in registers for the
//    whole call.  A bf16 product is exact in float32, so these are the
//    products the float32 reference forms, summed in another order.
//  - The softmax runs on the mma's accumulator fragment (a lane holds 2
//    positions x 2 query heads; 3 shuffles a reduction), and p goes
//    through a 16 x 8 float32 tile of the warp in shared memory to
//    `p . v`, which stays float32 FMAs on the CUDA cores: a lane holds
//    1/32 of the stage's columns of v for every query head.  p is never
//    rounded.  (A tensor-core `p . v` with p split into two bf16 terms held the
//    tolerances too, but moved more outputs by a bf16 ulp and saved no
//    time: the copies, not the FMAs, bound the call.)
//  - Each warp keeps its own (m, l, acc); at the end the four are merged
//    in shared memory (in warp order) into the block's partial.  The last
//    block of a (b, kv) row to finish, counted by a ticket in device
//    memory, merges the row's partials in split order and writes the
//    output, then resets its ticket to 0 for the next call; a row of one
//    split writes its output directly.  So the combine costs no second
//    launch and no launch tail.  The wrapper's plan (`ring_plan`) gives a
//    row whose tiles all fit the ring one split, else one wave of splits.
// The partial contract (`lse` given, a data shard's slice of a KV sequence
// split over devices): the row's log-sum-exp m + log(l), in the scale the
// scores are in, is written beside the output by whichever block finalises
// the row (the last ticket holder, a one-split row's block, or the float32
// combine); the output acc / l is written in float32, unrounded, whatever
// the dtype of q, k and v, so that the slices' outputs combine and round
// once, as one call's would; and `pos` is read as `*pos - pos_offset`,
// the slice's local position, on the card.  A row with no position <= pos
// (pos < 0 included) reads nothing and gives out = 0 and lse = -inf;
// without `lse` such a row (pos < 0) reads every position, the TPU
// kernel's mean of v, as before.  A nonempty row's l is at least 1 (its
// largest score's p is 1), so the guard `l > 0` that gives the empty row
// its 0 changes no output of the old contract.
// float32 (the reduced-size checks): the CUDA-core path below: blocks of
// hd threads (rounded up to a warp), 16 KB tiles of K and V staged two
// deep by `cp.async` from every thread, scores by FMAs and warp shuffles,
// and a second kernel that combines the partials.  TF32 is never used.
//
// Head dims: 64, 80 (zamba2's shared attention), 112 (kimi-k2), 128 and
// 256, as the TPU kernel takes any.  80 and 112 are multiples of 16 but not
// of 32 or 64.  The ring asks for two 64-value boxes of
// an 80- or 112-value row, laid out in the stage as at hd 128.  The tensor
// map views the cache as 3-d (KV * hd, L, B), all heads of a position in
// one row, so the second box of head kv holds its last 16 (hd 80) or 48
// (hd 112) values and the first 48 or 16 of head kv + 1 (zeros past the
// last head).  A 4-d map whose innermost dimension is 112 had the Tensor
// Memory Accelerator fill those 16 columns with zeros instead, and took
// 0.27 ms against this view's 0.23 at decode_32k with kimi-k2's heads
// (H100 80GB HBM3, 700 W).  No score and no output reads those columns:
// the score mma walks hd / 16 k-steps of 16 values (5 at 80, 7 at 112; q
// is not padded), and p . v adds 4 columns a lane as at 128 but only hd
// columns are merged and written.  The boxes start 2 * hd * kv + 128 h
// bytes into a position's row, off the 128-byte lines they keep at hd 64,
// 128 and 256, which bounds these two head dims below the others
// (PERF.md).  The f32 path launches 128 threads at both, 4 values a lane
// (96 threads would give 3, which do not divide 80): lanes past column
// hd - 1 load zeros for their share of q and k, and threads hd to 127 add
// into no column.  Scores are divided by sqrtf(80.f) or sqrtf(112.f).
//
// float32 path detail: a block streams its positions through shared
// memory in tiles of 16 KB of K and 16 KB of V (32 positions at hd 128 in
// float32), two stages deep: `cp.async` copies tile j + 1 while the block
// computes on tile j.  Per tile, each warp scores 32 / KG positions at a
// time, KG being G rounded up to a power of two (a template parameter): a
// lane holds hd/32 values of each key row and of each query row, and the
// 32 partial dot products are reduced across the warp by recursive
// halving, 31 shuffles for all 32, after which lane i holds product i.
// Then one warp per query row updates m and l and turns the tile's scores
// into p in shared memory, and thread d adds p * v[., d] into its G
// accumulators.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxG = 8;          // query heads per KV head
constexpr int kStageBytes = 16384;  // of K (and of V) a tile holds
constexpr int kMaxTile = 128;     // positions a tile holds at most
constexpr float kMask = -1e30f;   // the TPU kernel's mask and initial max

// -inf: the log-sum-exp of a row that read nothing
__device__ __forceinline__ float neg_inf() {
  return __int_as_float(static_cast<int>(0xff800000u));
}

template <typename T>
__device__ __forceinline__ float to_f32(T x);
template <>
__device__ __forceinline__ float to_f32<float>(float x) { return x; }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }

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
// row_stride values) into the stage dst (rows packed), from every thread
// of the block.
template <typename T, int HD>
__device__ __forceinline__ void copy_rows(T* dst, const T* src, int n,
                                          int64_t row_stride) {
  using G = Tile<T, HD>;
  for (int c = threadIdx.x; c < n * G::kCopiesPerRow; c += blockDim.x) {
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

// Threads of a float32 split block: HD rounded up to whole warps, and up
// again until the warps' count (a lane's values of a row) divides HD: 128
// at hd 80 and 112.
constexpr int split_threads(int hd) {
  int t = (hd + 31) / 32 * 32;
  while (hd % (t / 32)) t += 32;
  return t;
}
template <int HD>
constexpr int kSplitThreads = split_threads(HD);

// Block (split, kv, b) of kSplitThreads<HD> threads: the partial softmax
// of positions [split * chunk, min((split + 1) * chunk, L)) for the G
// query rows of (b, kv), G <= KG (a power of two: a warp scores 32 / KG
// positions at once).  Thread d < HD adds column d of p . v; a lane holds
// values lane * kVpl .. + kVpl - 1 of a q and a k row, zeros past HD.
// Partials are laid out (B, KV, nsplit, G) and (B, KV, nsplit, G, HD).
// Dynamic shared memory: two stages of K, then two of V.
template <typename T, int HD, int KG>
__global__ void __launch_bounds__(kSplitThreads<HD>)
    flash_decode_split(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, const int* __restrict__ pos_p,
                       int pos_offset, bool partial,
                       float* __restrict__ part_m, float* __restrict__ part_l,
                       float* __restrict__ part_acc, int length, int kv_heads,
                       int g_heads, int chunk, int nsplit) {
  constexpr int kThreads = kSplitThreads<HD>;
  constexpr int kWarps = kThreads / 32;
  constexpr int kVpl = kThreads / 32;  // values of a row per lane
  static_assert(HD % kVpl == 0, "a lane's values lie wholly in the row");
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
  // this lane's share of a row lies inside it (always, but at hd 80 for
  // lanes 20-31 and at hd 112 for lanes 28-31)
  const bool in_row = lane * kVpl < HD;
  const int pos = *pos_p - pos_offset;
  const int start = split * chunk;
  const int end = min(start + chunk, length);
  // positions past pos add exp(-1e30 - m) = 0 once m holds a real score;
  // with pos < 0 every position is masked and all are read, or, under
  // the partial contract, none
  const int last = (pos >= 0 && pos < end) ? pos + 1
                   : (pos < 0 && partial ? start : end);
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
        qr[g][j] = g < g_heads && in_row ? to_f32(qb[g * HD + j]) : 0.0f;
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
        if (i0 + r < n && in_row) {
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
    // acc[g] = acc[g] * alpha[g] + sum_i p[g][i] * v[i][tid]; a thread
    // past HD reads column HD - 1 and writes nothing
#pragma unroll
    for (int g = 0; g < KG; ++g)
      if (g < g_heads) acc[g] *= s_alpha[g];
    const T* vt = vs + min(tid, HD - 1);
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
  if (tid >= HD) return;
  float* pa = part_acc + part * g_heads * HD + tid;
#pragma unroll
  for (int g = 0; g < KG; ++g)
    if (g < g_heads) pa[g * HD] = acc[g];
}

// Block (b * KV + kv) * G + g of HD threads: the output row from the
// nsplit partials, out = sum_s acc_s w_s / sum_s l_s w_s with
// w_s = exp(m_s - max_s m_s), and with `lse` its log-sum-exp
// max_s m_s + log(sum_s l_s w_s).  A split that read nothing has m = -1e30
// and l = acc = 0: its weight is 0 once another split holds a real score.
// A row that read nothing (the partial contract's empty row) has l = 0:
// out 0, lse -inf.
template <typename T, int HD>
__global__ void __launch_bounds__(HD)
    flash_decode_combine(const float* __restrict__ part_m,
                         const float* __restrict__ part_l,
                         const float* __restrict__ part_acc,
                         T* __restrict__ out, float* __restrict__ lse,
                         int g_heads, int nsplit) {
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
  out[row * HD + tid] = from_f32<T>(den > 0.0f ? num / den : 0.0f);
  if (lse != nullptr && tid == 0)
    lse[row] = den > 0.0f ? mx + logf(den) : neg_inf();
}

// One call's arguments, as `repro_flash_decode` takes them.
struct Call {
  const void* q;
  const void* k;
  const void* v;
  const int* pos;
  int pos_offset;
  float* part_m;
  float* part_l;
  float* part_acc;
  int* tickets;
  void* out;
  float* lse;
  int b, length, kv_heads, g_heads, chunk, nsplit, stages;
  cudaStream_t stream;
};

template <typename T, int HD, int KG>
cudaError_t launch(const Call& c) {
  const dim3 grid(c.nsplit, c.kv_heads, c.b);
  constexpr int kSmem = 4 * kStageBytes;  // two stages of K and of V
  constexpr int kThreads = kSplitThreads<HD>;
  cudaError_t err = cudaFuncSetAttribute(
      flash_decode_split<T, HD, KG>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return err;
  flash_decode_split<T, HD, KG><<<grid, kThreads, kSmem, c.stream>>>(
      static_cast<const T*>(c.q), static_cast<const T*>(c.k),
      static_cast<const T*>(c.v), c.pos, c.pos_offset, c.lse != nullptr,
      c.part_m, c.part_l, c.part_acc, c.length, c.kv_heads, c.g_heads,
      c.chunk, c.nsplit);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int rows = c.b * c.kv_heads * c.g_heads;
  flash_decode_combine<T, HD><<<rows, HD, 0, c.stream>>>(
      c.part_m, c.part_l, c.part_acc, static_cast<T*>(c.out), c.lse,
      c.g_heads, c.nsplit);
  return cudaGetLastError();
}

template <typename T, int HD>
cudaError_t dispatch_group(const Call& c) {
  if (c.g_heads <= 1) return launch<T, HD, 1>(c);
  if (c.g_heads <= 2) return launch<T, HD, 2>(c);
  if (c.g_heads <= 4) return launch<T, HD, 4>(c);
  return launch<T, HD, kMaxG>(c);
}

template <typename T>
cudaError_t dispatch(int hd, const Call& c) {
  switch (hd) {
    case 64:
      return dispatch_group<T, 64>(c);
    case 80:
      return dispatch_group<T, 80>(c);
    case 112:
      return dispatch_group<T, 112>(c);
    case 128:
      return dispatch_group<T, 128>(c);
    case 256:
      return dispatch_group<T, 256>(c);
    default:
      return cudaErrorInvalidValue;
  }
}


// ---------------------------------------------------------------------------
// bfloat16: warp-specialised ring, tensor-core scores, combine in-launch

constexpr int kConsumers = 4;   // consumer warps a block
constexpr int kSlice = 16;      // positions a consumer warp takes a stage
constexpr int kRingTile = kConsumers * kSlice;  // positions a stage holds
constexpr int kRingThreads = (kConsumers + 1) * 32;
constexpr int kMaxStages = 4;
constexpr int kMaxSplits = 256;  // partials the last block weighs at once
constexpr int kMaxDevices = 64;

// One stage: ceil(HD / 64) boxes of K, then as many of V.  A box is 64
// positions x 64 values (128 bytes a row), laid out by the tensor map's
// 128-byte swizzle: 16-byte piece c of row r sits at piece c ^ (r % 8), so
// the 8 rows an `ldmatrix` reads fall on 8 different bank groups.  A box
// starts on a 1024-byte boundary, where the swizzle pattern starts.  The
// columns of the last box past HD (48 at hd 80, 16 at hd 112) belong to
// the next head and are never read.
template <int HD>
struct Ring {
  static_assert(HD % 16 == 0, "whole k-steps of the score mma");
  static constexpr int kBoxes = (HD + 63) / 64;
  static constexpr int kCols = kBoxes * 64;  // HD padded to whole boxes
  static constexpr int kBoxBytes = kRingTile * 128;
  static constexpr int kHalfBytes = kBoxes * kBoxBytes;  // K, or V
  static constexpr int kStageBytes = 2 * kHalfBytes;
};

// Dynamic shared memory of a launch: room to align the ring to 1024
// bytes, the stages, the consumers' 16 x 8 p tiles, a full and an empty
// barrier a stage, and the last-block flag.  The wrapper plans with a
// Python copy of this sum (its plan is tested on the CPU, where no kernel
// is built); `repro_flash_decode_ring_smem_bytes` exports this one, and a
// card test holds the two equal.
size_t ring_smem_bytes(int hd, int stages) {
  const size_t cols = static_cast<size_t>(hd + 63) / 64 * 64;
  const size_t stage = static_cast<size_t>(2) * kRingTile * cols * 2;
  return 1024 + stages * (stage + 16) +
         kConsumers * kSlice * 8 * sizeof(float) + 16;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ void prefetch_map(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                   reinterpret_cast<uint64_t>(map))
               : "memory");
}

// Wait until the barrier's phase of the given parity has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

// One box of a 3-d tensor map at coordinates (c0, c1, c2), innermost
// first, copied by the Tensor Memory Accelerator; its bytes complete on
// `bar`.  Coordinates past the tensor's end read as zeros.
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            int c0, int c1, int c2,
                                            uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.tile.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(
          smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&a)[4],
                                            const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
      : "r"(smem_u32(p))
      : "memory");
}

// c += a b: a 16 x 16 bf16 (row), b 16 x 8 bf16 (col), c 16 x 8 float32.
__device__ __forceinline__ void mma_bf16(float (&c)[4],
                                         const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The bf16 values of a word, exactly, as float32: low half first.
__device__ __forceinline__ void unpack2(uint32_t w, float* x) {
  x[0] = __uint_as_float(w << 16);
  x[1] = __uint_as_float(w & 0xffff0000u);
}

// acc[g][j] += p[g] * v[j] for one position: VPL values of its v row (this
// lane's columns, in one 16-byte piece) and the G probabilities of the
// warp's p tile row.
template <int KG, int VPL>
__device__ __forceinline__ void pv_step(float (&acc)[KG][VPL],
                                        const float* __restrict__ p,
                                        const unsigned char* vrow) {
  float x[VPL];
  if constexpr (VPL == 2) {
    unpack2(*reinterpret_cast<const uint32_t*>(vrow), x);
  } else if constexpr (VPL == 4) {
    const uint2 w = *reinterpret_cast<const uint2*>(vrow);
    unpack2(w.x, x);
    unpack2(w.y, x + 2);
  } else {
    const uint4 w = *reinterpret_cast<const uint4*>(vrow);
    unpack2(w.x, x);
    unpack2(w.y, x + 2);
    unpack2(w.z, x + 4);
    unpack2(w.w, x + 6);
  }
  float pg[KG];
  if constexpr (KG >= 4) {
#pragma unroll
    for (int g = 0; g < KG; g += 4) {
      const float4 t = *reinterpret_cast<const float4*>(p + g);
      pg[g] = t.x;
      pg[g + 1] = t.y;
      pg[g + 2] = t.z;
      pg[g + 3] = t.w;
    }
  } else if constexpr (KG == 2) {
    const float2 t = *reinterpret_cast<const float2*>(p);
    pg[0] = t.x;
    pg[1] = t.y;
  } else {
    pg[0] = p[0];
  }
#pragma unroll
  for (int g = 0; g < KG; ++g)
#pragma unroll
    for (int j = 0; j < VPL; ++j) acc[g][j] = fmaf(pg[g], x[j], acc[g][j]);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 4));
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 8));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 16));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 4);
  x += __shfl_xor_sync(0xffffffffu, x, 8);
  return x + __shfl_xor_sync(0xffffffffu, x, 16);
}

// Element i of a bfloat16 launch's output: rounded to bf16 under the old
// contract, float32 under the partial one.
__device__ __forceinline__ void store_out(void* out, bool partial,
                                          int64_t i, float x) {
  if (partial)
    static_cast<float*>(out)[i] = x;
  else
    static_cast<__nv_bfloat16*>(out)[i] = __float2bfloat16_rn(x);
}

// Block (split, kv, b) of kRingThreads threads: positions [split * chunk,
// min((split + 1) * chunk, L)) of row (b, kv), G <= KG query heads (a
// power of two, the accumulators' count).  k_map and v_map view the
// (B, L, KV, HD) caches as 3-d tensors (KV * HD, L, B) in boxes of (64,
// 64, 1) (`cache_map`).  Partials are laid out (B, KV, nsplit, G) and
// (B, KV, nsplit, G, HD); tickets (B, KV) start at 0 and are left at 0;
// `lse` (B, KV, G), or null for the old contract; `out` is bf16 under the
// old contract, float32 under the partial one.
template <int HD, int KG>
__global__ void __launch_bounds__(kRingThreads)
    flash_decode_ring(const __nv_bfloat16* __restrict__ q,
                      const __grid_constant__ CUtensorMap k_map,
                      const __grid_constant__ CUtensorMap v_map,
                      const int* __restrict__ pos_p, int pos_offset,
                      float* __restrict__ part_m, float* __restrict__ part_l,
                      float* __restrict__ part_acc, int* __restrict__ tickets,
                      void* __restrict__ out, float* __restrict__ lse,
                      int length, int kv_heads, int g_heads, int chunk,
                      int nsplit, int stages) {
  using R = Ring<HD>;
  constexpr int kVpl = R::kCols / 32;  // columns of v a lane adds
  constexpr int kSteps = HD / 16;      // k-steps of the score mma
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
  // a consumer's p tile: (16 positions, 8 heads) float32
  float* ptile = reinterpret_cast<float*>(
      smem + static_cast<size_t>(stages) * R::kStageBytes);
  uint64_t* full = reinterpret_cast<uint64_t*>(ptile + kConsumers * kSlice *
                                                           8);
  uint64_t* empty = full + stages;
  int* last_flag = reinterpret_cast<int*>(empty + stages);

  const int split = blockIdx.x, kv = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int pos = *pos_p - pos_offset;
  const int start = split * chunk;
  const int end = length - start > chunk ? start + chunk : length;
  const int64_t bk = static_cast<int64_t>(b) * kv_heads + kv;
  // tile j of the split into its stage: K's boxes, then V's
  auto issue = [&](int j) {
    const int s = j % stages;
    const int t0 = start + j * kRingTile;
    unsigned char* st = smem + static_cast<size_t>(s) * R::kStageBytes;
    mbar_expect_tx(&full[s], R::kStageBytes);
#pragma unroll
    for (int h = 0; h < R::kBoxes; ++h) {
      tma_load_3d(st + h * R::kBoxBytes, &k_map, kv * HD + 64 * h, t0, b,
                  &full[s]);
      tma_load_3d(st + R::kHalfBytes + h * R::kBoxBytes, &v_map,
                  kv * HD + 64 * h, t0, b, &full[s]);
    }
  };

  if (tid == kConsumers * 32) {  // the producer's thread
    prefetch_map(&k_map);
    prefetch_map(&v_map);
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumers);
    }
    mbar_fence_init();
    // the first tile is asked for while pos is on its way: a split wholly
    // past pos waits for it and does not read it
    issue(0);
  }
  __syncthreads();
  // positions past pos add exp(-1e30 - m) = 0 once m holds a real score;
  // with pos < 0 every position is masked and all are read, or, under
  // the partial contract, none
  const int last = (pos >= 0 && pos < end) ? pos + 1
                   : (pos < 0 && lse != nullptr ? start : end);
  const int ntiles = last > start ? (last - start + kRingTile - 1) / kRingTile
                                  : 0;

  // a lane's share of the softmax state: query heads 2 * (lane & 3) + 0,
  // 1; of acc: columns lane * kVpl .. + kVpl - 1 of every head
  const int gq = lane >> 2, t4 = lane & 3;
  float m_run[2] = {kMask, kMask}, l_run[2] = {0.0f, 0.0f};
  float acc[KG][kVpl];
#pragma unroll
  for (int g = 0; g < KG; ++g)
#pragma unroll
    for (int j = 0; j < kVpl; ++j) acc[g][j] = 0.0f;

  if (warp == kConsumers) {  // the producer: one thread issues every box
    if (lane == 0) {
      for (int j = 1; j < ntiles; ++j) {
        if (j >= stages) mbar_wait(&empty[j % stages], ((j / stages) - 1) & 1);
        issue(j);
      }
      if (ntiles == 0) mbar_wait(&full[0], 0);
    }
  } else {  // a consumer
    // B fragments of q^T: column gq is query head gq, rows 2 * t4 + {0, 1}
    // and + 8 of each 16-value step
    uint32_t qf[kSteps][2];
    const __nv_bfloat16* qrow = q + (bk * g_heads + gq) * HD + 2 * t4;
#pragma unroll
    for (int st = 0; st < kSteps; ++st) {
      qf[st][0] = gq < g_heads
                      ? *reinterpret_cast<const uint32_t*>(qrow + 16 * st)
                      : 0u;
      qf[st][1] = gq < g_heads
                      ? *reinterpret_cast<const uint32_t*>(qrow + 16 * st + 8)
                      : 0u;
    }
    const float scale = sqrtf(static_cast<float>(HD));
    float* pw = ptile + warp * kSlice * 8;
    // ldmatrix x4: lanes 8i .. 8i + 7 address matrix i's rows; matrices
    // are (positions 0-7, values 0-7), (8-15, 0-7), (0-7, 8-15), (8-15,
    // 8-15) of a 16-value step.  Row r's 16-byte piece c lies at piece
    // c ^ (r % 8), and r % 8 = lane % 8.
    const int mat = lane >> 3, x7 = lane & 7;
    const int k_row = (warp * kSlice + x7 + ((mat & 1) << 3)) * 128;
    const int k_hi = (mat >> 1) & 1;
    // p . v: this lane's kVpl values of a v row lie in one 16-byte piece
    const int v_box = (lane * kVpl) >> 6, v_piece = ((lane * kVpl) & 63) >> 3;
    const int v_byte = ((lane * kVpl) & 7) * 2;
    for (int j = 0; j < ntiles; ++j) {
      const int s = j % stages;
      mbar_wait(&full[s], (j / stages) & 1);
      const int t0 = start + j * kRingTile + warp * kSlice;
      const int nw = min(kSlice, last - t0);  // this warp's positions
      if (nw > 0) {
        const unsigned char* ks = smem + static_cast<size_t>(s) *
                                             R::kStageBytes;
        const unsigned char* vs = ks + R::kHalfBytes + v_box * R::kBoxBytes +
                                  warp * kSlice * 128 + v_byte;
        // even and odd k-steps in two accumulators: half the mma chain
        float c[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        float c_odd[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
        for (int st = 0; st < kSteps; ++st) {
          uint32_t a[4];
          ldmatrix_x4(a, ks + (st >> 2) * R::kBoxBytes + k_row +
                             (((((st & 3) << 1) | k_hi) ^ x7) << 4));
          mma_bf16(st & 1 ? c_odd : c, a, qf[st][0], qf[st][1]);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) c[i] += c_odd[i];
        // c[0], c[1]: position gq, heads 2 t4, 2 t4 + 1; c[2], c[3]: gq + 8
        const bool ok0 = gq < nw, ok1 = gq + 8 < nw;
        const bool in0 = t0 + gq <= pos, in1 = t0 + gq + 8 <= pos;
        const float s00 = in0 ? c[0] / scale : kMask;
        const float s01 = in0 ? c[1] / scale : kMask;
        const float s10 = in1 ? c[2] / scale : kMask;
        const float s11 = in1 ? c[3] / scale : kMask;
        const float mx0 = quad_max(fmaxf(ok0 ? s00 : kMask, ok1 ? s10 : kMask));
        const float mx1 = quad_max(fmaxf(ok0 ? s01 : kMask, ok1 ? s11 : kMask));
        const float mn0 = fmaxf(m_run[0], mx0), mn1 = fmaxf(m_run[1], mx1);
        const float al0 = expf(m_run[0] - mn0), al1 = expf(m_run[1] - mn1);
        const float p00 = ok0 ? expf(s00 - mn0) : 0.0f;
        const float p01 = ok0 ? expf(s01 - mn1) : 0.0f;
        const float p10 = ok1 ? expf(s10 - mn0) : 0.0f;
        const float p11 = ok1 ? expf(s11 - mn1) : 0.0f;
        l_run[0] = l_run[0] * al0 + quad_sum(p00 + p10);
        l_run[1] = l_run[1] * al1 + quad_sum(p01 + p11);
        m_run[0] = mn0;
        m_run[1] = mn1;
        *reinterpret_cast<float2*>(pw + gq * 8 + 2 * t4) =
            make_float2(p00, p01);
        *reinterpret_cast<float2*>(pw + (gq + 8) * 8 + 2 * t4) =
            make_float2(p10, p11);
        __syncwarp();
        // head g's alpha is held by lane g / 2 (and every lane 4i + g / 2)
#pragma unroll
        for (int g = 0; g < KG; ++g) {
          const float al =
              __shfl_sync(0xffffffffu, (g & 1) ? al1 : al0, g >> 1);
#pragma unroll
          for (int jj = 0; jj < kVpl; ++jj) acc[g][jj] *= al;
        }
        // position i of the slice: row i, piece v_piece ^ (i % 8); rows
        // past nw are not read
        if (nw == kSlice) {
#pragma unroll
          for (int i = 0; i < kSlice; ++i)
            pv_step<KG, kVpl>(acc, pw + i * 8,
                              vs + i * 128 + ((v_piece ^ (i & 7)) << 4));
        } else {
          for (int i = 0; i < nw; ++i)
            pv_step<KG, kVpl>(acc, pw + i * 8,
                              vs + i * 128 + ((v_piece ^ (i & 7)) << 4));
        }
      }
      __syncwarp();  // the stage and the p tile are read
      if (lane == 0) mbar_arrive(&empty[s]);
    }
  }

  __syncthreads();  // every stage is consumed: the ring is scratch now
  float* w_m = reinterpret_cast<float*>(smem);  // (kConsumers, 8)
  float* w_l = w_m + kConsumers * 8;             // (kConsumers, 8)
  float* w_acc = w_l + kConsumers * 8;  // (kConsumers, KG, R::kCols)
  if (warp < kConsumers) {
    if (gq == 0) {
      w_m[warp * 8 + 2 * t4] = m_run[0];
      w_m[warp * 8 + 2 * t4 + 1] = m_run[1];
      w_l[warp * 8 + 2 * t4] = l_run[0];
      w_l[warp * 8 + 2 * t4 + 1] = l_run[1];
    }
#pragma unroll
    for (int g = 0; g < KG; ++g)
#pragma unroll
      for (int jj = 0; jj < kVpl; ++jj)
        w_acc[(warp * KG + g) * R::kCols + lane * kVpl + jj] = acc[g][jj];
  }
  __syncthreads();
  // the block's partial: the warps' states weighed by exp(m_w - max m);
  // a row of one split is its output
  const int64_t part = bk * nsplit + split;
  for (int e = tid; e < g_heads * HD; e += kRingThreads) {
    const int g = e / HD, d = e % HD;
    float mx = kMask;
#pragma unroll
    for (int w = 0; w < kConsumers; ++w) mx = fmaxf(mx, w_m[w * 8 + g]);
    float den = 0.0f, num = 0.0f;
#pragma unroll
    for (int w = 0; w < kConsumers; ++w) {
      const float wt = expf(w_m[w * 8 + g] - mx);
      den = fmaf(w_l[w * 8 + g], wt, den);
      num = fmaf(w_acc[(w * KG + g) * R::kCols + d], wt, num);
    }
    if (nsplit == 1) {  // a row that read nothing has den = 0
      store_out(out, lse != nullptr, (bk * g_heads + g) * HD + d,
                den > 0.0f ? num / den : 0.0f);
      if (lse != nullptr && d == 0)
        lse[bk * g_heads + g] = den > 0.0f ? mx + logf(den) : neg_inf();
      continue;
    }
    part_acc[(part * g_heads + g) * HD + d] = num;
    if (d == 0) {
      part_m[part * g_heads + g] = mx;
      part_l[part * g_heads + g] = den;
    }
  }
  if (nsplit == 1) return;
  __threadfence();
  __syncthreads();
  if (tid == 0) *last_flag = atomicAdd(&tickets[bk], 1) == nsplit - 1;
  __syncthreads();
  if (!*last_flag) return;
  __threadfence();
  // the last block of the row: out = sum_s acc_s w_s / sum_s l_s w_s with
  // w_s = exp(m_s - max_s m_s), in split order.  A split that read nothing
  // has m = -1e30 and l = acc = 0: its weight is 0 once another split
  // holds a real score; a row that read nothing has den = 0 (out 0, lse
  // -inf).
  float* wts = reinterpret_cast<float*>(smem);  // (nsplit, 8)
  float* dens = wts + kMaxSplits * 8;           // (8,)
  float* maxes = dens + 8;                      // (8,)
  if (tid < g_heads) {
    const float* pm = part_m + bk * nsplit * g_heads + tid;
    const float* pl = part_l + bk * nsplit * g_heads + tid;
    float mx = kMask;
    for (int s = 0; s < nsplit; ++s) mx = fmaxf(mx, __ldcg(pm + s * g_heads));
    float den = 0.0f;
    for (int s = 0; s < nsplit; ++s) {
      const float w = expf(__ldcg(pm + s * g_heads) - mx);
      wts[s * 8 + tid] = w;
      den = fmaf(__ldcg(pl + s * g_heads), w, den);
    }
    dens[tid] = den;
    maxes[tid] = mx;
    if (lse != nullptr)
      lse[bk * g_heads + tid] = den > 0.0f ? mx + logf(den) : neg_inf();
  }
  __syncthreads();
  for (int e = tid; e < g_heads * HD; e += kRingThreads) {
    const int g = e / HD, d = e % HD;
    const float* pa = part_acc + (bk * nsplit * g_heads + g) * HD + d;
    float num = 0.0f;
    for (int s = 0; s < nsplit; ++s)
      num = fmaf(__ldcg(pa + static_cast<int64_t>(s) * g_heads * HD),
                 wts[s * 8 + g], num);
    store_out(out, lse != nullptr, (bk * g_heads + g) * HD + d,
              dens[g] > 0.0f ? num / dens[g] : 0.0f);
  }
  if (tid == 0) tickets[bk] = 0;
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up once through the runtime's entry-point
// query, so the library needs no link against libcuda.
EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &found) != cudaSuccess ||
        found != cudaDriverEntryPointSuccess)
      return static_cast<EncodeTiled>(nullptr);
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

// A (B, L, KV, hd) bf16 cache as the 3-d tensor (KV * hd, L, B),
// innermost first, in boxes of (64, kRingTile, 1) with the 128-byte
// swizzle: a box holds 64 values of one head's row, or at hd 80 the
// row's last 16 and the next head's first 48, at hd 112 the row's last 48
// and the next head's first 16.  Positions past L, and
// values past the last head, read as zeros.
bool cache_map(CUtensorMap* map, const void* base, int b, int length,
               int kv_heads, int hd) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t row = static_cast<cuuint64_t>(hd) * kv_heads;
  const cuuint64_t dims[3] = {row, static_cast<cuuint64_t>(length),
                              static_cast<cuuint64_t>(b)};
  const cuuint64_t strides[2] = {row * 2,
                                 row * 2 * static_cast<cuuint64_t>(length)};
  const cuuint32_t box[3] = {64, kRingTile, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                const_cast<void*>(base), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int HD, int KG>
cudaError_t launch_ring(const Call& c) {
  CUtensorMap k_map, v_map;
  if (!cache_map(&k_map, c.k, c.b, c.length, c.kv_heads, HD) ||
      !cache_map(&v_map, c.v, c.b, c.length, c.kv_heads, HD))
    return cudaErrorInvalidValue;
  // the dynamic shared memory limit is raised once a device and size
  static size_t raised[kMaxDevices] = {};
  const size_t smem = ring_smem_bytes(HD, c.stages);
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidValue;
  if (raised[device] < smem) {
    err = cudaFuncSetAttribute(flash_decode_ring<HD, KG>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    raised[device] = smem;
  }
  const dim3 grid(c.nsplit, c.kv_heads, c.b);
  flash_decode_ring<HD, KG><<<grid, kRingThreads, smem, c.stream>>>(
      static_cast<const __nv_bfloat16*>(c.q), k_map, v_map, c.pos,
      c.pos_offset, c.part_m, c.part_l, c.part_acc, c.tickets,
      c.out, c.lse, c.length, c.kv_heads,
      c.g_heads, c.chunk, c.nsplit, c.stages);
  return cudaGetLastError();
}

template <int HD>
cudaError_t ring_group(const Call& c) {
  if (c.g_heads <= 1) return launch_ring<HD, 1>(c);
  if (c.g_heads <= 2) return launch_ring<HD, 2>(c);
  if (c.g_heads <= 4) return launch_ring<HD, 4>(c);
  return launch_ring<HD, kMaxG>(c);
}

}  // namespace

// Shared memory of the current device, in bytes: what a block may use
// (opt-in), what an SM holds, and what CUDA keeps back for each resident
// block.  Returns a cudaError_t.
extern "C" int repro_flash_decode_smem(int* per_block, int* per_sm,
                                       int* reserved) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(
        per_block, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(
        per_sm, cudaDevAttrMaxSharedMemoryPerMultiprocessor, device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(
        reserved, cudaDevAttrReservedSharedMemoryPerBlock, device);
  return err;
}

// The dynamic shared memory of a bfloat16 launch of `stages` stages at
// head dim `hd`, in bytes.
extern "C" int repro_flash_decode_ring_smem_bytes(int hd, int stages) {
  return static_cast<int>(ring_smem_bytes(hd, stages));
}

// dtype codes: 0 float32, 1 bfloat16 (q, k, v and out alike, but out is
// float32 under the partial contract).  q (B, KV,
// G, hd), k and v (B, L, KV, hd) and out (B, KV, G, hd) contiguous, k and
// v on 16-byte boundaries; pos one int32 on the device, read as
// *pos - pos_offset; part_m and part_l (B, KV, nsplit, G) and part_acc
// (B, KV, nsplit, G, hd) float32 scratch, with nsplit * chunk >= L.  hd
// is 64, 80, 112, 128 or 256 and G at most 8.  `lse`, (B, KV, G)
// float32 or null, asks for the partial contract (the header's).
// bfloat16 also takes `tickets`, B * KV int32 that are 0 and are left 0,
// and `stages` (1 to 4) of its ring; chunk is then a multiple of 64 and
// nsplit at most 256.  float32 ignores both.  Returns a cudaError_t; the
// kernels run on `stream` and the call does not synchronise.
extern "C" int repro_flash_decode(const void* q, const void* k, const void* v,
                                  int dtype, const int* pos, int pos_offset,
                                  float* part_m, float* part_l,
                                  float* part_acc, int* tickets, void* out,
                                  float* lse, int b, int length,
                                  int kv_heads, int g_heads, int hd,
                                  int chunk, int nsplit, int stages,
                                  void* stream) {
  if (b < 1 || length < 1 || kv_heads < 1 || g_heads < 1 ||
      g_heads > kMaxG || chunk < 1 || nsplit < 1 ||
      static_cast<int64_t>(chunk) * nsplit < length ||
      static_cast<int64_t>(chunk) * (nsplit - 1) >= length)
    return cudaErrorInvalidValue;
  const Call c{q,       k,      v,        pos,      pos_offset, part_m,
               part_l,  part_acc, tickets, out,     lse,        b,
               length,  kv_heads, g_heads, chunk,   nsplit,     stages,
               static_cast<cudaStream_t>(stream)};
  if (dtype == 0) return dispatch<float>(hd, c);
  if (dtype != 1 || tickets == nullptr || stages < 1 ||
      stages > kMaxStages || nsplit > kMaxSplits || chunk % kRingTile)
    return cudaErrorInvalidValue;
  switch (hd) {
    case 64:
      return ring_group<64>(c);
    case 80:
      return ring_group<80>(c);
    case 112:
      return ring_group<112>(c);
    case 128:
      return ring_group<128>(c);
    case 256:
      return ring_group<256>(c);
    default:
      return cudaErrorInvalidValue;
  }
}
