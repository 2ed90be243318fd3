// Sorted segment sum of gradient rows with per-id contributor counts, with
// each vocab block's accumulator resident in shared memory
// (embedding_bag_grad_resident), for Hopper (sm_90a).
//
// Replaces repro/kernels/embedding_bag.py::_embedding_bag_grad_resident
// (:553, call :561) and its Pallas body _bwd_kernel_resident (:516): the
// first backward of the embedding lookup, which the JAX package keeps as
// the bit-exactness oracle of the streamed backward.  As there, one program
// owns one block of BLOCK_V = 512 vocab rows, keeps the block's (512, D)
// float32 accumulator and its counts on chip for the whole segment (VMEM
// there, shared memory here), walks the block's run of sorted entries in
// chunks, and writes the accumulator out once.  The TPU reduced a chunk as
// a one-hot matmul; here each chunk's runs of equal ids are added into the
// accumulator directly.  The wrapper sorts outside the kernel (`sort_ids`:
// ids outside [0, V) become the sentinel V, a stable sort, the permutation
// kept), as the JAX package sorts with XLA.
//
// Contract: sorted_ids (E,) int32 ascending, perm (E,) int64 (entry e of
// the sorted order is flat entry perm[e] = b*F + f), grad_out (B, D)
// float32 -> gtable (V, D) float32 and counts (V,) float32.  Row v receives
// the sum of grad_out[perm[e] / F] over the entries e with sorted_ids[e] ==
// v, taken in float32 from 0.0f in ascending e; counts[v] is their number.
// That is the order of the streamed kernel (embedding_bag_grad.cu) and of
// the plain version `embedding_bag_grad_ref`: the three agree bit for bit.
// D = 0 writes the counts alone.  Every row is written; no atomics.
//
// Ordering without atomics, and without a serial scan: the ids are sorted,
// so the entries of one row in a chunk are one contiguous run.  Each chunk
// (one entry a thread) marks where a run starts (its id differs from the
// entry before it), and a block-wide prefix count of the marks (warp
// ballots, then one warp over the warps' totals) lists the runs' starts in
// shared memory.  Runs are dealt to groups of `lanes` threads, the lanes
// across D (four floats a lane where D % 4 == 0): one group adds one run
// into its row of the accumulator, in entry order, so every accumulator
// element is written by one thread at a time, and chunks follow each other
// in order.  A group issues the loads of up to kUnroll entries of its run
// before it adds the first, so a chunk costs a few memory latencies, not
// one per entry.
//
// Bound: device-memory bytes.  The (V, D) and (V,) outputs are written
// once and dwarf the inputs at every shape the port runs.  A vocab block
// with no entry (most blocks at V = 1,000,000) writes its zeros straight to
// device memory, and one warp bounds a block's entries by a 32-way search
// (a load round per factor of 32).  The launch plan is the wrapper's
// (`resident_plan`): 1024 threads a block when the vocab blocks do not
// fill the card (the one-block case), 256 otherwise, and the chunk as large
// as the threads and the shared memory the accumulator leaves allow.  The
// accumulator takes 512 * D * 4 bytes, so D is limited by the 227 KB a
// block may use (D <= 111 with a chunk of at least 256 entries); the
// wrapper refuses a wider D, as the JAX kernel was "only viable for
// VMEM-sized configs".
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kBlockV = 512;
constexpr int kMaxThreads = 1024;
constexpr int kUnroll = 8;    // loads of a run in flight before its adds
constexpr int kMaxDevices = 64;

// Shared memory of a launch: the accumulator, the int counts, then per
// chunk entry its batch row (int) and local row and run start (uint16),
// then the warps' mark totals and three scalars.  The wrapper plans with
// a Python copy of this sum (its plan is tested on the CPU, where no
// kernel is built); `repro_embedding_bag_grad_resident_smem_bytes`
// exports this one, and a card test holds the two equal.
size_t smem_bytes(int D, int chunk) {
  return static_cast<size_t>(kBlockV) * D * sizeof(float) +
         kBlockV * sizeof(int) + static_cast<size_t>(chunk) * 8 +
         (32 + 4) * sizeof(int);
}

// First position in [lo, hi) whose id is >= v (hi if none), found by the
// 32 lanes of a warp together: each round probes 32 evenly spaced ids and
// keeps the stretch between the last probe below v and the next.
__device__ __forceinline__ int warp_lower_bound(
    const int32_t* __restrict__ ids, int lo, int hi, int64_t v, int lane) {
  while (hi - lo > 32) {
    const int step = (hi - lo + 31) / 32;
    const int p = lo + lane * step;
    const bool less = p < hi && ids[p] < v;
    const int c = __popc(__ballot_sync(0xffffffffu, less));
    if (c == 0) return lo;
    const int next_hi = lo + c * step;
    lo += (c - 1) * step + 1;
    if (next_hi < hi) hi = next_hi;
  }
  const bool less = lo + lane < hi && ids[lo + lane] < v;
  return lo + __popc(__ballot_sync(0xffffffffu, less));
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

// VEC is 4 (D % 4 == 0 and 16-byte aligned rows) or 1.  blockDim.x is a
// multiple of 32 no larger than kMaxThreads, chunk <= blockDim.x, and
// lanes a power of two dividing 32.
template <int VEC>
__global__ void __launch_bounds__(kMaxThreads)
    embedding_bag_grad_resident_kernel(const int32_t* __restrict__ sorted_ids,
                                       const int64_t* __restrict__ perm,
                                       const float* __restrict__ grad_out,
                                       float* __restrict__ gtable,
                                       float* __restrict__ counts, int E,
                                       int F, int V, int D, int chunk,
                                       int lanes) {
  extern __shared__ __align__(16) float smem[];
  float* acc = smem;                                        // (kBlockV, D)
  int* cnt = reinterpret_cast<int*>(acc + kBlockV * D);     // (kBlockV,)
  int* src = cnt + kBlockV;                                 // (chunk,)
  uint16_t* row = reinterpret_cast<uint16_t*>(src + chunk);  // (chunk,)
  uint16_t* run = row + chunk;                               // (chunk,)
  int* wsum = reinterpret_cast<int*>(run + chunk);           // (32,)
  int* scal = wsum + 32;  // the block's entries [lo, hi), runs in a chunk

  const int tid = threadIdx.x, T = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nwarps = T >> 5;
  const int64_t v0 = static_cast<int64_t>(blockIdx.x) * kBlockV;
  const int rows = static_cast<int>(
      V - v0 < kBlockV ? V - v0 : static_cast<int64_t>(kBlockV));
  const int n_acc = rows * D;

  if (warp == 0) {
    // the sentinel V sorts past every row, so the run stops at v0 + rows
    const int lo = warp_lower_bound(sorted_ids, 0, E, v0, lane);
    const int hi = warp_lower_bound(sorted_ids, lo, E, v0 + rows, lane);
    if (lane == 0) {
      scal[0] = lo;
      scal[1] = hi;
    }
  }
  __syncthreads();
  const int lo = scal[0], hi = scal[1];
  float* out = gtable + v0 * D;
  if (lo == hi) {  // no entry in this block: zeros, without the accumulator
    const float zero[VEC] = {};
    for (int i = tid * VEC; i < n_acc; i += T * VEC) store_vec<VEC>(out + i, zero);
    for (int i = tid; i < rows; i += T) counts[v0 + i] = 0.0f;
    return;
  }
  for (int i = tid * VEC; i < n_acc; i += T * VEC) {
    const float zero[VEC] = {};
    store_vec<VEC>(acc + i, zero);
  }
  for (int i = tid; i < rows; i += T) cnt[i] = 0;

  const int gl = tid & (lanes - 1), ngroups = T / lanes;
  for (int c0 = lo; c0 < hi; c0 += chunk) {
    const int n = hi - c0 < chunk ? hi - c0 : chunk;
    bool mark = false;
    if (tid < n) {
      const int32_t id = sorted_ids[c0 + tid];
      row[tid] = static_cast<uint16_t>(id - v0);
      src[tid] = static_cast<int>(perm[c0 + tid]) / F;
      mark = tid == 0 || sorted_ids[c0 + tid - 1] != id;
    }
    const unsigned ballot = __ballot_sync(0xffffffffu, mark);
    if (lane == 0) wsum[warp] = __popc(ballot);
    __syncthreads();  // the marks' totals; the zeroed accumulator
    if (warp == 0) {  // exclusive prefix count of the warps' totals
      const int mine = lane < nwarps ? wsum[lane] : 0;
      int incl = mine;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const int up = __shfl_up_sync(0xffffffffu, incl, off);
        if (lane >= off) incl += up;
      }
      wsum[lane] = incl - mine;
      if (lane == 31) scal[2] = incl;
    }
    __syncthreads();
    if (mark) run[wsum[warp] + __popc(ballot & ((1u << lane) - 1u))] = tid;
    __syncthreads();
    const int nruns = scal[2];
    for (int j = tid / lanes; j < nruns; j += ngroups) {
      const int s = run[j];
      const int e = j + 1 < nruns ? run[j + 1] : n;
      const int r = row[s];
      if (gl == 0) cnt[r] += e - s;
      for (int col = gl * VEC; col < D; col += lanes * VEC) {
        float a[VEC];
        load_vec<VEC>(a, acc + r * D + col);
        for (int e0 = s; e0 < e; e0 += kUnroll) {
          const int m = e - e0 < kUnroll ? e - e0 : kUnroll;
          float x[kUnroll][VEC];
#pragma unroll
          for (int u = 0; u < kUnroll; ++u)
            if (u < m)
              load_vec<VEC>(x[u], grad_out +
                                      static_cast<int64_t>(src[e0 + u]) * D +
                                      col);
#pragma unroll
          for (int u = 0; u < kUnroll; ++u)
            if (u < m) {
#pragma unroll
              for (int c = 0; c < VEC; ++c) a[c] += x[u][c];
            }
        }
        store_vec<VEC>(acc + r * D + col, a);
      }
    }
    __syncthreads();  // the next chunk rewrites row, src and run
  }

  for (int i = tid * VEC; i < n_acc; i += T * VEC) {
    float a[VEC];
    load_vec<VEC>(a, acc + i);
    store_vec<VEC>(out + i, a);
  }
  for (int i = tid; i < rows; i += T)
    counts[v0 + i] = static_cast<float>(cnt[i]);
}

// Set each kernel's dynamic shared memory limit once per device, to all a
// block may use, so that a launch needs no attribute call.
int limit_of(int device) {
  static int limits[kMaxDevices] = {};
  if (device < 0 || device >= kMaxDevices) return -1;
  if (limits[device] == 0) {
    int optin = 0;
    if (cudaDeviceGetAttribute(&optin,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               device) != cudaSuccess ||
        cudaFuncSetAttribute(embedding_bag_grad_resident_kernel<1>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             optin) != cudaSuccess ||
        cudaFuncSetAttribute(embedding_bag_grad_resident_kernel<4>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             optin) != cudaSuccess)
      return -1;
    limits[device] = optin;
  }
  return limits[device];
}

}  // namespace

// The dynamic shared memory a block of the current device may use, in
// bytes (the kernel has no static shared memory), or -1 on an error.
extern "C" int repro_embedding_bag_grad_resident_smem_limit() {
  int device = 0;
  if (cudaGetDevice(&device) != cudaSuccess) return -1;
  return limit_of(device);
}

// The dynamic shared memory of a launch at width D with `chunk` entries a
// chunk, in bytes.
extern "C" int repro_embedding_bag_grad_resident_smem_bytes(int D,
                                                           int chunk) {
  return static_cast<int>(smem_bytes(D, chunk));
}

// E >= 0, F >= 1 when E > 0, V >= 1, D >= 0, threads a multiple of 32 in
// [32, 1024], chunk in [1, threads] and the launch's shared memory within
// the limit above.  Returns the launch's cudaError_t (0 on success); the
// kernel runs on `stream` and the call does not synchronise.
extern "C" int repro_embedding_bag_grad_resident(
    const void* sorted_ids, const void* perm, const void* grad_out,
    void* gtable, void* counts, int E, int F, int V, int D, int threads,
    int chunk, void* stream) {
  if (V < 1 || D < 0 || threads < 32 || threads > kMaxThreads ||
      threads % 32 || chunk < 1 || chunk > threads)
    return cudaErrorInvalidValue;
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  const int limit = limit_of(device);
  const size_t smem = smem_bytes(D, chunk);
  if (limit < 0 || smem > static_cast<size_t>(limit))
    return cudaErrorInvalidValue;
  const auto* g = static_cast<const float*>(grad_out);
  auto* gt = static_cast<float*>(gtable);
  const bool wide = D > 0 && D % 4 == 0 &&
                    reinterpret_cast<uintptr_t>(g) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(gt) % 16 == 0;
  const int vec = wide ? 4 : 1;
  int cols = D / vec;
  if (cols < 1) cols = 1;  // D = 0: one thread a run adds its count
  int lanes = 1;
  while (lanes < cols && lanes < 32) lanes *= 2;
  const unsigned grid =
      static_cast<unsigned>((static_cast<int64_t>(V) + kBlockV - 1) / kBlockV);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* ids = static_cast<const int32_t*>(sorted_ids);
  const auto* p = static_cast<const int64_t*>(perm);
  auto* cnt = static_cast<float*>(counts);
  if (wide) {
    embedding_bag_grad_resident_kernel<4><<<grid, threads, smem, s>>>(
        ids, p, g, gt, cnt, E, F, V, D, chunk, lanes);
  } else {
    embedding_bag_grad_resident_kernel<1><<<grid, threads, smem, s>>>(
        ids, p, g, gt, cnt, E, F, V, D, chunk, lanes);
  }
  return cudaGetLastError();
}
