// Sorted segment sum of gradient rows with per-id contributor counts
// (embedding_bag_grad) for Hopper, sm_90a.
//
// Replaces repro/kernels/embedding_bag.py::_embedding_bag_grad_streamed and
// its Pallas body _bwd_kernel.  As there, the sort runs outside the kernel:
// the wrapper maps every id outside [0, V) to the sentinel V and sorts the
// B*F flat ids stably, keeping the permutation (the JAX package sorts with
// XLA in _sorted_entries).  The TPU kernel reduced each vocab block's run
// as a one-hot matmul, because a TPU core cannot scatter into VMEM; here
// each output row is owned by one group of threads that finds its run in
// the sorted ids and sums it directly.
//
// Contract: sorted_ids (E,) int32 ascending, perm (E,) int64 (entry e of
// the sorted order is flat entry perm[e] = b*F + f), grad_out (B, D)
// float32 -> gtable (V, D) float32 and counts (V,) float32.  Row v receives
// the sum of grad_out[perm[e] / F] over the entries e with sorted_ids[e] ==
// v, taken in float32 from 0.0f in ascending e; counts[v] is the number of
// those entries.  D = 0 writes the counts alone (the replay's presence
// counts).  Because the sort is stable, ascending e is ascending
// entry order, so the result is deterministic and equal bit for bit to a
// sequential scatter-add in entry order.  Sentinel entries sort past every
// row and add nothing.  Every row is written: there are no atomics and no
// memset.
//
// Bound: device-memory bytes.  The outputs (V*D + V floats) are written
// whole, and at the training path's shapes they dwarf the inputs (E ids,
// the touched grad_out rows): E = 53,248 entries against V = 1,600,048 rows
// for the replay's presence counts.  The design writes each output row once
// with 16-byte stores where D allows, neighbouring threads on neighbouring
// pieces, and spends little on finding the runs: one thread of each block
// bounds the block's rows' entries by two binary searches over the sorted
// ids, so each row searches only that (usually empty) stretch.
//
// The longest run sets the kernel's time: Zipf-skewed ids put hundreds of
// entries on one row, and a row is summed by one thread, in order.  So the
// run's end comes from a second binary search and the sum is a counted
// loop, unrolled, whose loads do not wait on each other (only the adds
// do); the batch row of an entry is a 32-bit division (perm[e] < E <=
// INT_MAX).
//
// Layout: threadIdx.x runs across D (VEC floats each), threadIdx.y across
// vocab rows, so D = 0, 1 and 16 still fill a 128-thread block.
// blockIdx.x tiles the vocab, blockIdx.y tiles D.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 128;

// First position in [lo, hi) whose id is >= v (hi if none).
__device__ __forceinline__ int lower_bound(const int32_t* __restrict__ ids,
                                           int lo, int hi, int64_t v) {
  while (lo < hi) {
    const int mid = lo + (hi - lo) / 2;
    if (ids[mid] < v) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

// VEC is 4 (one 16-byte load or store per row piece) or 1.
template <int VEC>
__global__ void __launch_bounds__(kThreads)
    embedding_bag_grad_kernel(const int32_t* __restrict__ sorted_ids,
                              const int64_t* __restrict__ perm,
                              const float* __restrict__ grad_out,
                              float* __restrict__ gtable,
                              float* __restrict__ counts, int E, int F, int V,
                              int D) {
  __shared__ int block_run[2];
  const int64_t v0 = static_cast<int64_t>(blockIdx.x) * blockDim.y;
  if (threadIdx.x == 0 && threadIdx.y == 0) {
    const int lo = lower_bound(sorted_ids, 0, E, v0);
    block_run[0] = lo;
    block_run[1] = lower_bound(sorted_ids, lo, E, v0 + blockDim.y);
  }
  __syncthreads();

  const int64_t v = v0 + threadIdx.y;
  if (v >= V) return;
  const int col = (blockIdx.y * blockDim.x + threadIdx.x) * VEC;
  const bool has_col = col < D;

  float acc[VEC];
#pragma unroll
  for (int k = 0; k < VEC; ++k) acc[k] = 0.0f;

  const int start = lower_bound(sorted_ids, block_run[0], block_run[1], v);
  const int end = lower_bound(sorted_ids, start, block_run[1], v + 1);
  if (has_col) {
#pragma unroll 4
    for (int e = start; e < end; ++e) {
      const int row = static_cast<int>(perm[e]) / F;
      const float* src = grad_out + static_cast<int64_t>(row) * D + col;
      if constexpr (VEC == 1) {
        acc[0] += src[0];
      } else {
        const float4 x = *reinterpret_cast<const float4*>(src);
        acc[0] += x.x;
        acc[1] += x.y;
        acc[2] += x.z;
        acc[3] += x.w;
      }
    }

    float* dst = gtable + v * D + col;
    if constexpr (VEC == 1) {
      dst[0] = acc[0];
    } else {
      *reinterpret_cast<float4*>(dst) =
          make_float4(acc[0], acc[1], acc[2], acc[3]);
    }
  }
  if (blockIdx.y == 0 && threadIdx.x == 0) {
    counts[v] = static_cast<float>(end - start);
  }
}

}  // namespace

// E >= 0, F >= 1 when E > 0, V >= 1, D >= 0.  Returns the launch's cudaError_t (0 on
// success); the kernel runs on `stream` and the call does not synchronise.
extern "C" int repro_embedding_bag_grad(const void* sorted_ids,
                                        const void* perm,
                                        const void* grad_out, void* gtable,
                                        void* counts, int E, int F, int V,
                                        int D, void* stream) {
  const auto* ids = static_cast<const int32_t*>(sorted_ids);
  const auto* p = static_cast<const int64_t*>(perm);
  const auto* g = static_cast<const float*>(grad_out);
  auto* gt = static_cast<float*>(gtable);
  auto* cnt = static_cast<float*>(counts);
  const auto s = static_cast<cudaStream_t>(stream);

  const bool wide = D % 4 == 0 && reinterpret_cast<uintptr_t>(g) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(gt) % 16 == 0;
  const int per_thread = wide ? 4 : 1;
  int cols = (D + per_thread - 1) / per_thread;
  if (cols < 1) cols = 1;  // D = 0: one thread per row writes its count
  int tx = 1;
  while (tx < cols && tx < kThreads) tx *= 2;
  const dim3 block(tx, kThreads / tx);
  const dim3 grid(
      static_cast<unsigned>((static_cast<int64_t>(V) + block.y - 1) / block.y),
      (cols + tx - 1) / tx);
  if (wide) {
    embedding_bag_grad_kernel<4>
        <<<grid, block, 0, s>>>(ids, p, g, gt, cnt, E, F, V, D);
  } else {
    embedding_bag_grad_kernel<1>
        <<<grid, block, 0, s>>>(ids, p, g, gt, cnt, E, F, V, D);
  }
  return cudaGetLastError();
}
