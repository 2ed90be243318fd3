// Sum-pooled embedding lookup (embedding_bag forward) for Hopper, sm_90a.
//
// Replaces repro/kernels/embedding_bag.py::_embedding_bag_streamed and its
// Pallas body _fwd_kernel.  The TPU kernel sorted the (id, batch row)
// entries and pooled them as one-hot matmuls because a TPU core cannot
// gather rows dynamically out of VMEM; Hopper can, so there is no sort.
//
// Contract: ids (B, F) int32, table (V, D) float32 or bfloat16 -> out (B, D)
// in the table's dtype.  Sums are taken in float32, starting from 0.0f and
// adding the F rows in order, so a pool of one id returns its row exactly.
// Every id outside [0, V) (negative ids, the padding sentinel V) adds
// nothing.
//
// Bound: device-memory bytes.  The work is B*F*D adds against
// (valid ids * D + B*D) table-dtype bytes plus B*F*4 id bytes, far below
// one operation per byte.  Each gathered row is read once, with 16-byte
// loads where D allows: neighbouring threads of a warp read neighbouring
// 16-byte pieces of the same row, so every row read is coalesced.
//
// Layout: threadIdx.x runs across D (VEC elements each), threadIdx.y across
// batch rows, so narrow tables (D = 64 in f32 is 16 threads) still fill a
// 128-thread block.  blockIdx.x tiles the batch, blockIdx.y tiles D.  Each
// thread keeps its VEC sums in registers and writes them once.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 128;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even
}

// VEC is 16 / sizeof(T) (one 16-byte load per row piece) or 1.
template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
    embedding_bag_fwd_kernel(const int32_t* __restrict__ ids,
                             const T* __restrict__ table, T* __restrict__ out,
                             int B, int F, int V, int D) {
  const int b = blockIdx.x * blockDim.y + threadIdx.y;
  const int col = (blockIdx.y * blockDim.x + threadIdx.x) * VEC;
  if (b >= B || col >= D) return;

  float acc[VEC];
#pragma unroll
  for (int k = 0; k < VEC; ++k) acc[k] = 0.0f;

  const int32_t* bag = ids + static_cast<int64_t>(b) * F;
  for (int f = 0; f < F; ++f) {
    const int32_t id = bag[f];
    if (id < 0 || id >= V) continue;
    const T* src = table + static_cast<int64_t>(id) * D + col;
    if constexpr (VEC == 1) {
      acc[0] += to_f32(src[0]);
    } else {
      const uint4 raw = *reinterpret_cast<const uint4*>(src);
      const T* v = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int k = 0; k < VEC; ++k) acc[k] += to_f32(v[k]);
    }
  }

  T* dst = out + static_cast<int64_t>(b) * D + col;
  if constexpr (VEC == 1) {
    dst[0] = from_f32<T>(acc[0]);
  } else {
    uint4 raw;
    T* v = reinterpret_cast<T*>(&raw);
#pragma unroll
    for (int k = 0; k < VEC; ++k) v[k] = from_f32<T>(acc[k]);
    *reinterpret_cast<uint4*>(dst) = raw;
  }
}

template <typename T>
cudaError_t launch(const int32_t* ids, const T* table, T* out, int B, int F,
                   int V, int D, cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);
  const bool wide = D % kVec == 0 &&
                    reinterpret_cast<uintptr_t>(table) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const int per_thread = wide ? kVec : 1;
  const int cols = (D + per_thread - 1) / per_thread;
  int tx = 1;
  while (tx < cols && tx < kThreads) tx *= 2;
  const dim3 block(tx, kThreads / tx);
  const dim3 grid((B + block.y - 1) / block.y, (cols + tx - 1) / tx);
  if (wide) {
    embedding_bag_fwd_kernel<T, kVec>
        <<<grid, block, 0, stream>>>(ids, table, out, B, F, V, D);
  } else {
    embedding_bag_fwd_kernel<T, 1>
        <<<grid, block, 0, stream>>>(ids, table, out, B, F, V, D);
  }
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  B and D must be positive.  Returns the
// launch's cudaError_t (0 on success); the kernel runs on `stream` and the
// call does not synchronise.
extern "C" int repro_embedding_bag_fwd(const void* ids, const void* table,
                                       void* out, int B, int F, int V, int D,
                                       int dtype, void* stream) {
  const auto* id_ptr = static_cast<const int32_t*>(ids);
  const auto s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch(id_ptr, static_cast<const float*>(table),
                    static_cast<float*>(out), B, F, V, D, s);
    case 1:
      return launch(id_ptr, static_cast<const __nv_bfloat16*>(table),
                    static_cast<__nv_bfloat16*>(out), B, F, V, D, s);
    default:
      return cudaErrorInvalidValue;
  }
}
