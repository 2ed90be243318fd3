// GBA's fused decay-aggregate and Adagrad apply (Alg. 2 l.20/22 and the
// optimizer step) over a flat (M, N) gradient buffer, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `gba_apply` of
// src/repro/kernels/gba_apply.py (function :95, body `_kernel` :80, call
// :115).  The TPU kernel walks (M, 2048) column blocks on a sequential
// grid with the weights in SMEM; here every thread owns columns of the
// flat vector through a grid-stride loop, so nothing carries over between
// blocks.
//
// Per column c, all in float32:
//   w[j]  = ((step - tokens[j]) <= iota) / M        (Eq. 1; divisor M)
//   g     = +0 (-0 at M = 1);  g = fma(buf[j][c], w[j], g)   (j = 0 .. M-1)
//   a'    = fma(g, g, accum[c])
//   p'    = p[c] - (lr * g) / (sqrt(a') + eps)
// and p' is written back in the param's dtype, a' as float32, both in
// place.  The two fused multiply-adds are what XLA computes for the
// reference on the CPU.  Every operation is a correctly rounded float32
// `__f*_rn` intrinsic, which nvcc never contracts or reorders, in the
// order of the plain version `gba_apply_ref` (kernels/ref.py): the two
// agree bit for bit.
//
// Bound: bytes.  Each column reads M buffer values, the param and the
// accumulator and writes the param and the accumulator once: (M + 4) * N
// * 4 bytes at float32, against some 2M + 7 float operations: 26.8 GB for
// the fused LM step's apply (M = 4, N = 838,881,280), at least 8.0 ms at
// the 3.35 TB/s of an H100 SXM at its 700 W limit (NVIDIA's data sheet).
// The design streams: the M weights are computed once per block into
// shared memory, and where N is a multiple of 4 and every row is 16-byte
// aligned a thread moves 4 columns per access (16-byte loads at float32,
// 8-byte at bfloat16); otherwise one column at a time.
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

template <typename P, typename B, int VEC>
__global__ void gba_apply_kernel(P* __restrict__ param,
                                 float* __restrict__ accum,
                                 const B* __restrict__ buffer,
                                 const int* __restrict__ tokens, int m,
                                 int n, int step, int iota, float lr,
                                 float eps) {
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

  using PP = Pack<P, VEC>;
  using PB = Pack<B, VEC>;
  using PA = Pack<float, VEC>;
  const int64_t groups = n / VEC;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       i < groups; i += stride) {
    float g[VEC];
    {
      const PB b = reinterpret_cast<const PB*>(buffer)[i];
#pragma unroll
      for (int k = 0; k < VEC; ++k)
        g[k] = __fmaf_rn(to_f32(b.v[k]), w[0], zero);
    }
#pragma unroll 4
    for (int j = 1; j < m; ++j) {
      const PB b = reinterpret_cast<const PB*>(
          buffer + static_cast<int64_t>(j) * n)[i];
#pragma unroll
      for (int k = 0; k < VEC; ++k)
        g[k] = __fmaf_rn(to_f32(b.v[k]), w[j], g[k]);
    }
    PA a = reinterpret_cast<const PA*>(accum)[i];
    PP p = reinterpret_cast<const PP*>(param)[i];
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      a.v[k] = __fmaf_rn(g[k], g[k], a.v[k]);
      const float den = __fadd_rn(__fsqrt_rn(a.v[k]), eps);
      const float upd = __fdiv_rn(__fmul_rn(lr, g[k]), den);
      p.v[k] = from_f32<P>(__fsub_rn(to_f32(p.v[k]), upd));
    }
    reinterpret_cast<PA*>(accum)[i] = a;
    reinterpret_cast<PP*>(param)[i] = p;
  }
}

bool aligned(const void* ptr, size_t bytes) {
  return reinterpret_cast<uintptr_t>(ptr) % bytes == 0;
}

template <typename P, typename B>
cudaError_t launch(void* param, float* accum, const void* buffer,
                   const int* tokens, int m, int n, int step, int iota,
                   float lr, float eps, cudaStream_t stream) {
  constexpr int kThreads = 256;
  constexpr int kVec = 4;
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                 device);
  if (err != cudaSuccess) return err;
  const bool vec = n % kVec == 0 && aligned(param, kVec * sizeof(P)) &&
                   aligned(accum, kVec * sizeof(float)) &&
                   aligned(buffer, kVec * sizeof(B));
  const int64_t groups = vec ? n / kVec : n;
  // enough blocks to fill every SM several times over; the loop strides
  const int64_t want = (groups + kThreads - 1) / kThreads;
  const int blocks = static_cast<int>(want < 16LL * sms ? want : 16LL * sms);
  const size_t smem = static_cast<size_t>(m) * sizeof(float);
  P* p = static_cast<P*>(param);
  const B* b = static_cast<const B*>(buffer);
  if (vec)
    gba_apply_kernel<P, B, kVec><<<blocks, kThreads, smem, stream>>>(
        p, accum, b, tokens, m, n, step, iota, lr, eps);
  else
    gba_apply_kernel<P, B, 1><<<blocks, kThreads, smem, stream>>>(
        p, accum, b, tokens, m, n, step, iota, lr, eps);
  return cudaGetLastError();
}

}  // namespace

// dtype codes: 0 float32, 1 bfloat16.  Returns a cudaError_t.
extern "C" int repro_gba_apply(void* param, int param_dtype, void* accum,
                               const void* buffer, int buf_dtype,
                               const int* tokens, int m, int n, int step,
                               int iota, float lr, float eps, void* stream) {
  if (m < 1 || n < 1) return cudaErrorInvalidValue;
  float* a = static_cast<float*>(accum);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (param_dtype == 0 && buf_dtype == 0)
    return launch<float, float>(param, a, buffer, tokens, m, n, step, iota,
                                lr, eps, s);
  if (param_dtype == 0 && buf_dtype == 1)
    return launch<float, __nv_bfloat16>(param, a, buffer, tokens, m, n, step,
                                        iota, lr, eps, s);
  if (param_dtype == 1 && buf_dtype == 0)
    return launch<__nv_bfloat16, float>(param, a, buffer, tokens, m, n, step,
                                        iota, lr, eps, s);
  if (param_dtype == 1 && buf_dtype == 1)
    return launch<__nv_bfloat16, __nv_bfloat16>(param, a, buffer, tokens, m,
                                                n, step, iota, lr, eps, s);
  return cudaErrorInvalidValue;
}
