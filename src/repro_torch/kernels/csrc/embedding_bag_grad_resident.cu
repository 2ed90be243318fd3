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
// chunks of CHUNK_E = 256, and writes the accumulator out once.  The TPU
// reduced a chunk as a one-hot matmul; here each chunk's local rows and
// batch rows are staged in shared memory and added into the accumulator
// directly.  The wrapper sorts outside the kernel (`sort_ids`: ids outside
// [0, V) become the sentinel V, a stable sort, the permutation kept), as
// the JAX package sorts with XLA.
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
// Ordering without atomics: the block's threads are TY groups of TX
// threads; group y owns the local rows r with r % TY == y, and its TX
// threads split the row's D columns.  Each group scans the whole chunk
// (ids in shared memory) in ascending e and adds only the entries of its
// own rows, so every accumulator element is written by one thread, in
// entry order.
//
// Bound: device-memory bytes.  The (V, D) and (V,) outputs are written
// once and dwarf the inputs at every shape the port runs.  The kernel
// writes them with neighbouring threads on neighbouring floats.  The
// accumulator takes 512 * D * 4 bytes of shared memory, so D is limited by
// the 227 KB a block may use (D <= 111 here); the wrapper refuses a wider
// D, as the JAX kernel was "only viable for VMEM-sized configs".
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kBlockV = 512;
constexpr int kChunkE = 256;
constexpr int kThreads = 256;

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

size_t smem_bytes(int D) {
  return (static_cast<size_t>(kBlockV) * D + kBlockV) * sizeof(float) +
         2 * kChunkE * sizeof(int);
}

__global__ void __launch_bounds__(kThreads)
    embedding_bag_grad_resident_kernel(const int32_t* __restrict__ sorted_ids,
                                       const int64_t* __restrict__ perm,
                                       const float* __restrict__ grad_out,
                                       float* __restrict__ gtable,
                                       float* __restrict__ counts, int E,
                                       int F, int V, int D) {
  extern __shared__ float smem[];
  float* acc = smem;                                   // (kBlockV, D)
  float* cnt = acc + static_cast<int64_t>(kBlockV) * D;  // (kBlockV,)
  int* chunk_row = reinterpret_cast<int*>(cnt + kBlockV);  // local row
  int* chunk_src = chunk_row + kChunkE;                     // batch row
  __shared__ int seg[2];

  const int tx = threadIdx.x, ty = threadIdx.y;
  const int TX = blockDim.x, TY = blockDim.y;
  const int tid = ty * TX + tx;
  const int64_t v0 = static_cast<int64_t>(blockIdx.x) * kBlockV;
  const int rows = static_cast<int>(
      V - v0 < kBlockV ? V - v0 : static_cast<int64_t>(kBlockV));

  for (int i = tid; i < kBlockV * D + kBlockV; i += kThreads) smem[i] = 0.0f;
  if (tid == 0) {
    // the sentinel V sorts past every row, so the run stops at v0 + rows
    const int lo = lower_bound(sorted_ids, 0, E, v0);
    seg[0] = lo;
    seg[1] = lower_bound(sorted_ids, lo, E, v0 + rows);
  }
  __syncthreads();

  for (int c0 = seg[0]; c0 < seg[1]; c0 += kChunkE) {
    const int n = seg[1] - c0 < kChunkE ? seg[1] - c0 : kChunkE;
    for (int k = tid; k < n; k += kThreads) {
      chunk_row[k] = static_cast<int>(sorted_ids[c0 + k] - v0);
      chunk_src[k] = static_cast<int>(perm[c0 + k]) / F;
    }
    __syncthreads();
    for (int k = 0; k < n; ++k) {
      const int r = chunk_row[k];
      if (r % TY != ty) continue;
      const float* src = grad_out + static_cast<int64_t>(chunk_src[k]) * D;
      float* dst = acc + r * D;
      for (int c = tx; c < D; c += TX) dst[c] += src[c];
      if (tx == 0) cnt[r] += 1.0f;
    }
    __syncthreads();
  }

  float* out = gtable + v0 * D;
  for (int i = tid; i < rows * D; i += kThreads) out[i] = acc[i];
  for (int i = tid; i < rows; i += kThreads) counts[v0 + i] = cnt[i];
}

}  // namespace

// The largest D whose accumulator fits the shared memory a block of the
// current device may use.
extern "C" int repro_embedding_bag_grad_resident_max_d() {
  int device = 0, optin = 0;
  if (cudaGetDevice(&device) != cudaSuccess ||
      cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             device) != cudaSuccess)
    return -1;
  // the dynamic accumulator and chunk, and the static run bounds `seg`
  const size_t fixed = smem_bytes(0) + 2 * sizeof(int);
  if (static_cast<size_t>(optin) < fixed) return -1;
  return static_cast<int>((optin - fixed) / (kBlockV * sizeof(float)));
}

// E >= 0, F >= 1 when E > 0, V >= 1, 0 <= D <= the largest D above.
// Returns the launch's cudaError_t (0 on success); the kernel runs on
// `stream` and the call does not synchronise.
extern "C" int repro_embedding_bag_grad_resident(
    const void* sorted_ids, const void* perm, const void* grad_out,
    void* gtable, void* counts, int E, int F, int V, int D, void* stream) {
  if (V < 1 || D < 0) return cudaErrorInvalidValue;
  const int max_d = repro_embedding_bag_grad_resident_max_d();
  if (max_d < 0 || D > max_d) return cudaErrorInvalidValue;
  const size_t smem = smem_bytes(D);
  cudaError_t err = cudaFuncSetAttribute(
      embedding_bag_grad_resident_kernel,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  int tx = 1;
  while (tx < D && tx < 32) tx *= 2;
  const dim3 block(tx, kThreads / tx);
  const unsigned grid =
      static_cast<unsigned>((static_cast<int64_t>(V) + kBlockV - 1) / kBlockV);
  embedding_bag_grad_resident_kernel<<<grid, block, smem,
                                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(sorted_ids),
      static_cast<const int64_t*>(perm), static_cast<const float*>(grad_out),
      static_cast<float*>(gtable), static_cast<float*>(counts), E, F, V, D);
  return cudaGetLastError();
}
