// GBA's Eq. (1) decayed mean of an (M, D) gradient buffer (Alg. 2 l.20/22)
// for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `gba_aggregate` of
// src/repro/kernels/gba_aggregate.py (function :76, body `_kernel` :63,
// call :87).  The TPU kernel walks (M, 2048) column blocks with the tokens
// in SMEM and reduces each block over M in VMEM; here every thread owns
// columns through a grid-stride loop and sums its column's M slots in
// registers, so nothing carries over between blocks.  The pytree GBA path
// launches it once per leaf (`ops.gba_aggregate_tree`).
//
// Per column c, in float32:
//   w[j] = ((step - tokens[j]) <= iota) / M        (Eq. 1; divisor M)
//   g    = +0 (-0 at M = 1);  g = fma(buf[j][c], w[j], g)   (j = 0 .. M-1)
// and g is written in the buffer's dtype, rounded once.  That is what XLA
// computes for the reference on the CPU, and every operation is a
// correctly rounded `__f*_rn` intrinsic, which nvcc never contracts or
// reorders, in the order of the plain version `gba_aggregate_ref`
// (kernels/ref.py): the two agree bit for bit.
//
// Bound: bytes.  Each column reads its M buffer values and writes one
// output, (M + 1) * D * itemsize bytes, against 2M float operations: 2.01
// GB for the largest leaf of granite-8b at depth 2 (M = 4, D = 201,326,592
// bf16), at least 0.60 ms at 3.35 TB/s.  The design streams: the M weights
// are computed once per block into shared memory, and where D is a
// multiple of 4 and the buffer and output are aligned a thread moves 4
// columns per access (16-byte loads at float32, 8-byte at bfloat16);
// otherwise one column at a time.  Offsets are 64-bit: a full-depth leaf
// has D > 2^31.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

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

template <typename T, int VEC>
__global__ void gba_aggregate_kernel(const T* __restrict__ grads,
                                     const int* __restrict__ tokens,
                                     T* __restrict__ out, int m, int64_t d,
                                     int step, int iota) {
  extern __shared__ float w[];
  const float inv_m = __fdiv_rn(1.0f, static_cast<float>(m));
  for (int j = threadIdx.x; j < m; j += blockDim.x) {
    // int32 subtraction that wraps, as the reference's does
    const int age = static_cast<int>(static_cast<unsigned>(step) -
                                     static_cast<unsigned>(tokens[j]));
    w[j] = age <= iota ? inv_m : 0.0f;
  }
  __syncthreads();
  // the sum starts from +0.0, as XLA's reduction does; at M = 1 XLA keeps
  // the product itself, and fma(b, w, -0.0) == b * w, signed zeros too
  const float zero = m == 1 ? -0.0f : 0.0f;

  using P = Pack<T, VEC>;
  const int64_t groups = d / VEC;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       i < groups; i += stride) {
    float g[VEC];
    {
      const P b = reinterpret_cast<const P*>(grads)[i];
#pragma unroll
      for (int k = 0; k < VEC; ++k)
        g[k] = __fmaf_rn(to_f32(b.v[k]), w[0], zero);
    }
#pragma unroll 4
    for (int j = 1; j < m; ++j) {
      const P b = reinterpret_cast<const P*>(grads + j * d)[i];
#pragma unroll
      for (int k = 0; k < VEC; ++k)
        g[k] = __fmaf_rn(to_f32(b.v[k]), w[j], g[k]);
    }
    P o;
#pragma unroll
    for (int k = 0; k < VEC; ++k) o.v[k] = from_f32<T>(g[k]);
    reinterpret_cast<P*>(out)[i] = o;
  }
}

bool aligned(const void* ptr, size_t bytes) {
  return reinterpret_cast<uintptr_t>(ptr) % bytes == 0;
}

template <typename T>
cudaError_t launch(const void* grads, const int* tokens, void* out, int m,
                   int64_t d, int step, int iota, cudaStream_t stream) {
  constexpr int kThreads = 256;
  constexpr int kVec = 4;
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                 device);
  if (err != cudaSuccess) return err;
  const bool vec = d % kVec == 0 && aligned(grads, kVec * sizeof(T)) &&
                   aligned(out, kVec * sizeof(T));
  const int64_t groups = vec ? d / kVec : d;
  // enough blocks to fill every SM several times over; the loop strides
  const int64_t want = (groups + kThreads - 1) / kThreads;
  const int blocks = static_cast<int>(want < 16LL * sms ? want : 16LL * sms);
  const size_t smem = static_cast<size_t>(m) * sizeof(float);
  const T* g = static_cast<const T*>(grads);
  T* o = static_cast<T*>(out);
  if (vec)
    gba_aggregate_kernel<T, kVec><<<blocks, kThreads, smem, stream>>>(
        g, tokens, o, m, d, step, iota);
  else
    gba_aggregate_kernel<T, 1><<<blocks, kThreads, smem, stream>>>(
        g, tokens, o, m, d, step, iota);
  return cudaGetLastError();
}

}  // namespace

// dtype codes: 0 float32, 1 bfloat16 (the buffer's and the output's).
// grads (M, D) contiguous, tokens (M,) int32, out (D,).  Returns a
// cudaError_t; the kernel runs on `stream` and the call does not
// synchronise.
extern "C" int repro_gba_aggregate(const void* grads, int dtype,
                                   const int* tokens, void* out, int m,
                                   int64_t d, int step, int iota,
                                   void* stream) {
  if (m < 1 || d < 1) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(grads, tokens, out, m, d, step, iota, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(grads, tokens, out, m, d, step, iota, s);
  return cudaErrorInvalidValue;
}
