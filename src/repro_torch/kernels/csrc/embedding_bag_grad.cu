// Segment sum of gradient rows with per-id contributor counts
// (embedding_bag_grad) for Hopper, sm_90a: two kernels, one for the counts
// alone (D = 0) and one for a gradient of width D > 0.
//
// Replaces repro/kernels/embedding_bag.py::_embedding_bag_grad_streamed
// (:459, call :472) and its Pallas body _bwd_kernel (:386).  There XLA sorts
// the ids outside the kernel (_sorted_entries) and each (vocab block x D
// block) tile reduces its run of sorted entries as a one-hot matmul,
// because a TPU core cannot scatter into VMEM.  Hopper can scatter into
// device memory, so the sort is kept only where the contract needs it.
//
// Contract: ids (B, F) int32, grad_out (B, D) float32 -> gtable (V, D)
// float32 and counts (V,) float32.  Entry (b, f) adds grad_out[b] to row
// ids[b, f] and 1 to its count; ids outside [0, V) add nothing.  Each row
// is summed in float32 from 0.0f in entry order, so the result equals a
// sequential scatter-add in entry order bit for bit (the plain version on
// a CPU tensor, and embedding_bag_grad_resident.cu).  Every output element
// is written by these kernels: no memset, no library call.
//
// D = 0, the replay's presence counts (one launch a global step, E =
// 53,248 ids over V = 1,600,048 rows; counts_kernel): counts alone, from
// the raw ids, no sort.  A count is an integer, and an integer sum is the
// same in any order, so nothing is ordered.  One cooperative launch of one
// block an SM: each block zeroes its slice of the counts with 16-byte
// stores, the grid synchronises (cooperative_groups::this_grid().sync()),
// the E ids are split over the grid and each valid id adds 1.0f to its
// row with red.global.add.f32 (the lanes of a warp that hold one id add
// their number once, so a row repeated E times costs E / 32 atomics).
// Every partial sum is a whole number of at most E, and float32 holds each
// of those exactly while E <= 2^24, so the counts are exact and the same
// in any order; the wrapper refuses more ids in one call (the replay's
// are 53,248).  A lane's first ids are loaded before the zeros and the
// barrier, so their latency hides behind them.  Counting in int32 would
// be exact for any E, but would cost a second barrier and a pass that
// converts the counts, more than the kernel's own write at this shape.
//
// D > 0 (segment_kernel): the entry-order sum needs each row's entries
// together, so the wrapper sorts: ids outside [0, V) become the sentinel
// V, a stable sort, the permutation kept (`sort_ids`).  A block owns a
// tile of `tile_rows` rows (about 16 KB of output) and first stores the
// whole tile's zeros, rows and counts, with coalesced 16-byte stores, so
// no store waits on a search.  Meanwhile one warp bounds the tile's span
// of sorted entries by a 32-way search (32 lanes probe at once, a load
// round per factor of 32).  The span is walked in chunks of one entry a
// thread: an entry whose id differs from the one before it starts a run,
// a block-wide prefix count of the marks lists the runs' starts, one warp
// search finds where the chunk's last run ends, and the runs are dealt to
// groups of lanes across D (4 floats a lane where D % 4 == 0).  A group
// sums its run in ascending entry order from 0.0f, with up to kUnroll
// loads in flight before the adds, and stores the row and its count over
// the zeros.  Because the sort is stable, ascending sorted position is
// ascending entry order.
//
// Bound: device-memory bytes.  The (V, D) and (V,) outputs are written
// whole, and at the training paths' shapes they dwarf the inputs (E ids,
// the touched grad_out rows).  D > 0 stores its zeros at the rate of a
// memset.  At D = 0 the write is 6.4 MB at the replay's shape, about a
// launch's own cost; the grid barrier between the zeros and the atomics
// is what the design cannot hide.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxThreads = 1024;
constexpr int kUnroll = 8;     // loads of a run in flight before its adds
constexpr unsigned kFull = 0xffffffffu;

// First position in [lo, hi) whose id is >= v (hi if none), found by the
// 32 lanes of a warp together: each round probes 32 evenly spaced ids and
// keeps the stretch between the last probe below v and the next.
__device__ __forceinline__ int warp_lower_bound(
    const int32_t* __restrict__ ids, int lo, int hi, int64_t v, int lane) {
  while (hi - lo > 32) {
    const int step = (hi - lo + 31) / 32;
    const int p = lo + lane * step;
    const bool less = p < hi && ids[p] < v;
    const int c = __popc(__ballot_sync(kFull, less));
    if (c == 0) return lo;
    const int next_hi = lo + c * step;
    lo += (c - 1) * step + 1;
    if (next_hi < hi) hi = next_hi;
  }
  const bool less = lo + lane < hi && ids[lo + lane] < v;
  return lo + __popc(__ballot_sync(kFull, less));
}

// Calls f(x, valid) for the E ids at `ids`, four at a time (x.x .. x.w),
// the 32 lanes of every warp together (f may use warp votes): warp `gw` of
// `nw` takes every nw-th run of 32 16-byte loads, and each run's next load
// is in flight while f takes the run.  The first load is issued before
// `before()` (which all threads call, barriers and all), so its latency
// hides behind it.  The ids before the first 16-byte boundary and after
// the last whole load go to warp 0, one a lane, padded with -1.
template <typename Before, typename Fn>
__device__ __forceinline__ void for_each_id(const int32_t* __restrict__ ids,
                                            int E, int64_t gw, int64_t nw,
                                            int lane, Before before, Fn f) {
  const int skew = static_cast<int>(reinterpret_cast<uintptr_t>(ids) % 16);
  const int head = (16 - skew) % 16 / 4 < E ? (16 - skew) % 16 / 4 : E;
  const int64_t nvec = (E - head) / 4;
  const int tail = (E - head) % 4;
  const int4* vec = reinterpret_cast<const int4*>(ids + head);
  const int64_t step = nw * 32;
  const int4 none = make_int4(-1, -1, -1, -1);
  int4 x = gw * 32 + lane < nvec ? __ldg(vec + gw * 32 + lane) : none;
  before();
  if (gw == 0) {
    const bool h = lane < head, t = lane < tail;
    f(make_int4(h ? ids[lane] : -1, -1, -1, -1), h);
    f(make_int4(t ? ids[head + nvec * 4 + lane] : -1, -1, -1, -1), t);
  }
  for (int64_t base = gw * 32; base < nvec; base += step) {
    const int64_t i = base + lane;
    const int4 cur = x;
    if (i + step < nvec) x = __ldg(vec + i + step);
    f(cur, i < nvec);
  }
}

// Adds the number of lanes holding `key` (those with `in` set) to
// counts[key] by the first of them: one atomic a distinct key of the warp.
// All 32 lanes call it together.
__device__ __forceinline__ void warp_add(float* counts, int32_t key, bool in,
                                         int lane) {
  const unsigned m = __ballot_sync(kFull, in);
  if (in) {
    const unsigned same = __match_any_sync(m, key);
    if (lane == __ffs(same) - 1)
      atomicAdd(counts + key, static_cast<float>(__popc(same)));
  }
}

// Zeros n floats at p (16-byte aligned), threads tid of T.
__device__ __forceinline__ void zero_fill(float* __restrict__ p, int64_t n,
                                          int tid, int T) {
  const int64_t n4 = n / 4;
  for (int64_t i = tid; i < n4; i += T)
    reinterpret_cast<float4*>(p)[i] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  for (int64_t i = n4 * 4 + tid; i < n; i += T) p[i] = 0.0f;
}

// D = 0, a cooperative launch: block b zeroes rows [b * tile_rows, ...)
// of the counts, the grid synchronises, then every valid id adds 1.0f.
// tile_rows % 4 == 0 and counts 16-byte aligned.
__global__ void __launch_bounds__(kMaxThreads)
    counts_kernel(const int32_t* __restrict__ ids, float* __restrict__ counts,
                  int E, int V, int tile_rows) {
  const int tid = threadIdx.x, T = blockDim.x, lane = tid & 31;
  const int64_t v0 = static_cast<int64_t>(blockIdx.x) * tile_rows;
  const int64_t gw = (static_cast<int64_t>(blockIdx.x) * T + tid) >> 5;
  const int64_t nw = (static_cast<int64_t>(gridDim.x) * T) >> 5;
  const unsigned n = V;
  for_each_id(
      ids, E, gw, nw, lane,
      [&] {
        zero_fill(counts + v0,
                  V - v0 < tile_rows ? V - v0 : static_cast<int64_t>(tile_rows),
                  tid, T);
        cg::this_grid().sync();
      },
      [&](int4 x, bool ok) {
        warp_add(counts, x.x, ok && static_cast<unsigned>(x.x) < n, lane);
        warp_add(counts, x.y, ok && static_cast<unsigned>(x.y) < n, lane);
        warp_add(counts, x.z, ok && static_cast<unsigned>(x.z) < n, lane);
        warp_add(counts, x.w, ok && static_cast<unsigned>(x.w) < n, lane);
      });
}

template <int VEC>
__device__ __forceinline__ void load_vec(float (&x)[VEC], const float* p) {
  if constexpr (VEC == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    x[0] = t.x;
    x[1] = t.y;
    x[2] = t.z;
    x[3] = t.w;
  } else {
    x[0] = p[0];
  }
}

template <int VEC>
__device__ __forceinline__ void store_vec(float* p, const float (&x)[VEC]) {
  if constexpr (VEC == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
  } else {
    p[0] = x[0];
  }
}

// "segment", D > 0: the sorted entries of rows [v0, v0 + rows) summed into
// gtable and counted.  VEC is 4 (D % 4 == 0 and 16-byte aligned grad_out)
// or 1; blockDim.x is a multiple of 32, lanes a power of two dividing 32,
// tile_rows % 4 == 0 and gtable, counts 16-byte aligned.
template <int VEC>
__global__ void __launch_bounds__(kMaxThreads)
    segment_kernel(const int32_t* __restrict__ sorted_ids,
                   const int64_t* __restrict__ perm,
                   const float* __restrict__ grad_out,
                   float* __restrict__ gtable, float* __restrict__ counts,
                   int E, int F, int V, int D, int tile_rows, int lanes) {
  __shared__ int run[kMaxThreads + 1];  // run starts, then the last's end
  __shared__ int wsum[32];              // the warps' mark totals
  __shared__ int scal[4];               // the tile's entries [lo, hi), runs
  const int tid = threadIdx.x, T = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nwarps = T >> 5;
  const int64_t v0 = static_cast<int64_t>(blockIdx.x) * tile_rows;
  const int rows = static_cast<int>(
      V - v0 < tile_rows ? V - v0 : static_cast<int64_t>(tile_rows));

  zero_fill(gtable + v0 * D, static_cast<int64_t>(rows) * D, tid, T);
  zero_fill(counts + v0, rows, tid, T);
  if (warp == 0) {
    // the sentinel V sorts past every row, so the span stops at v0 + rows
    const int lo = warp_lower_bound(sorted_ids, 0, E, v0, lane);
    const int hi = warp_lower_bound(sorted_ids, lo, E, v0 + rows, lane);
    if (lane == 0) {
      scal[0] = lo;
      scal[1] = hi;
    }
  }
  __syncthreads();  // the span; the zeros, before any sum lands on them
  const int lo = scal[0], hi = scal[1];
  const int gl = tid & (lanes - 1), ngroups = T / lanes;
  // Every chunk starts on a run's first entry: at lo, and after each chunk
  // at the later of its end and its last run's end.
  for (int c0 = lo; c0 < hi;) {
    const int e = c0 + tid;
    const bool mark =
        e < hi && (e == c0 || sorted_ids[e - 1] != sorted_ids[e]);
    const unsigned ballot = __ballot_sync(kFull, mark);
    if (lane == 0) wsum[warp] = __popc(ballot);
    __syncthreads();
    if (warp == 0) {  // exclusive prefix count of the warps' totals
      const int mine = lane < nwarps ? wsum[lane] : 0;
      int incl = mine;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const int up = __shfl_up_sync(kFull, incl, off);
        if (lane >= off) incl += up;
      }
      wsum[lane] = incl - mine;
      if (lane == 31) scal[2] = incl;
    }
    __syncthreads();
    if (mark) run[wsum[warp] + __popc(ballot & ((1u << lane) - 1u))] = e;
    __syncthreads();
    const int nruns = scal[2];
    if (warp == 0) {  // the last run may go on past the chunk
      const int s = run[nruns - 1];
      const int end = warp_lower_bound(
          sorted_ids, s, hi, static_cast<int64_t>(sorted_ids[s]) + 1, lane);
      if (lane == 0) run[nruns] = end;
    }
    __syncthreads();
    for (int j = tid / lanes; j < nruns; j += ngroups) {
      const int s = run[j], end = run[j + 1];
      const int64_t r = sorted_ids[s];
      if (gl == 0) counts[r] = static_cast<float>(end - s);
      for (int col = gl * VEC; col < D; col += lanes * VEC) {
        float a[VEC];
#pragma unroll
        for (int c = 0; c < VEC; ++c) a[c] = 0.0f;
        for (int e0 = s; e0 < end; e0 += kUnroll) {
          const int m = end - e0 < kUnroll ? end - e0 : kUnroll;
          float x[kUnroll][VEC];
#pragma unroll
          for (int u = 0; u < kUnroll; ++u)
            if (u < m) {
              const int row = static_cast<int>(perm[e0 + u]) / F;
              load_vec<VEC>(x[u], grad_out + static_cast<int64_t>(row) * D +
                                      col);
            }
#pragma unroll
          for (int u = 0; u < kUnroll; ++u)
            if (u < m) {
#pragma unroll
              for (int c = 0; c < VEC; ++c) a[c] += x[u][c];
            }
        }
        store_vec<VEC>(gtable + r * D + col, a);
      }
    }
    const int next = max(c0 + T, run[nruns]);
    __syncthreads();  // the next chunk rewrites run
    c0 = next;
  }
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// The plan's numbers, as both entry points take them: `blocks` blocks of
// `threads` threads and `tile_rows` rows cover [0, V) exactly once.
bool plan_ok(int V, int threads, int tile_rows, int blocks) {
  return V >= 1 && threads >= 32 && threads <= kMaxThreads &&
         threads % 32 == 0 && tile_rows >= 4 && tile_rows % 4 == 0 &&
         blocks >= 1 && static_cast<int64_t>(blocks) * tile_rows >= V &&
         static_cast<int64_t>(blocks - 1) * tile_rows < V;
}

}  // namespace

// D = 0: counts (V,) float32 of the E raw ids at `ids` (int32, any
// alignment), a cooperative launch that fails with
// cudaErrorCooperativeLaunchTooLarge if its blocks cannot all be resident.
// E >= 0, counts 16-byte aligned, and the plan's numbers as plan_ok takes
// them.  Returns the launch's cudaError_t (0 on success); the kernel runs
// on `stream` and the call does not synchronise.
extern "C" int repro_embedding_bag_grad_counts(const void* ids, void* counts,
                                               int E, int V, int threads,
                                               int tile_rows, int blocks,
                                               void* stream) {
  if (E < 0 || !aligned16(counts) || !plan_ok(V, threads, tile_rows, blocks))
    return cudaErrorInvalidValue;
  const auto* i = static_cast<const int32_t*>(ids);
  auto* c = static_cast<float*>(counts);
  void* args[] = {&i, &c, &E, &V, &tile_rows};
  const cudaError_t err = cudaLaunchCooperativeKernel(
      reinterpret_cast<void*>(counts_kernel), dim3(blocks), dim3(threads),
      args, 0, static_cast<cudaStream_t>(stream));
  return err != cudaSuccess ? err : cudaGetLastError();
}

// D > 0: sorted_ids (E,) int32 ascending, perm (E,) int64 (entry e of the
// sorted order is flat entry perm[e] = b*F + f), grad_out (B, D) float32
// -> gtable (V, D) and counts (V,) float32, both 16-byte aligned.  E >= 0,
// F >= 1 when E > 0, D >= 1, and the plan's numbers as plan_ok takes them.
// Returns the launch's cudaError_t (0 on success); the kernel runs on
// `stream` and the call does not synchronise.
extern "C" int repro_embedding_bag_grad(const void* sorted_ids,
                                        const void* perm,
                                        const void* grad_out, void* gtable,
                                        void* counts, int E, int F, int V,
                                        int D, int threads, int tile_rows,
                                        int blocks, void* stream) {
  if (E < 0 || D < 1 || (E > 0 && F < 1) || !aligned16(gtable) ||
      !aligned16(counts) || !plan_ok(V, threads, tile_rows, blocks))
    return cudaErrorInvalidValue;
  const auto* g = static_cast<const float*>(grad_out);
  const bool wide = D % 4 == 0 && aligned16(g);
  const int vec = wide ? 4 : 1;
  int lanes = 1;
  while (lanes < D / vec && lanes < 32) lanes *= 2;
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* ids = static_cast<const int32_t*>(sorted_ids);
  const auto* p = static_cast<const int64_t*>(perm);
  auto* gt = static_cast<float*>(gtable);
  auto* cnt = static_cast<float*>(counts);
  if (wide) {
    segment_kernel<4><<<blocks, threads, 0, s>>>(ids, p, g, gt, cnt, E, F, V,
                                                 D, tile_rows, lanes);
  } else {
    segment_kernel<1><<<blocks, threads, 0, s>>>(ids, p, g, gt, cnt, E, F, V,
                                                 D, tile_rows, lanes);
  }
  return cudaGetLastError();
}
