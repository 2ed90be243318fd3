// Fused Adagrad update, in place, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `fused_adagrad` of
// src/repro/kernels/fused_adagrad.py (function :75, body `_kernel` :64,
// call :87), which walks 4096-element blocks and aliases param and accum
// to its outputs.  Here every thread owns elements through a grid-stride
// loop and writes param and accum back in place, as the TPU kernel's
// aliases do.  The pytree GBA path launches it once per leaf
// (`ops.adagrad_apply_tree`).
//
// Per element, in float32:
//   g  = grad[i]
//   a' = fma(g, g, accum[i])
//   p' = p[i] - (lr * g) / (sqrt(a') + eps)
// and p' is written in the param's dtype, a' as float32.  XLA fuses the
// reference's `accum + g * g` into that multiply-add on the CPU.  Every
// operation is a correctly rounded `__f*_rn` intrinsic (the root
// included), which nvcc never contracts or reorders, in the order of the
// plain version `fused_adagrad_ref` (kernels/ref.py): the two agree bit for
// bit.
//
// Bound: bytes.  Each element reads param, grad and accum and writes param
// and accum: 2 * (param + accum) + grad bytes, 14 B an element with a
// bfloat16 param and grad, against 7 float operations: 2.82 GB for the
// largest leaf of granite-8b at depth 2 (201,326,592 elements), at least
// 0.84 ms at 3.35 TB/s.  The design streams: where N is a multiple of 4 and
// every array is aligned a thread moves 4 elements per access; otherwise
// one at a time.  Offsets are 64-bit.
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

template <typename P, typename G, int VEC>
__global__ void fused_adagrad_kernel(P* __restrict__ param,
                                     const G* __restrict__ grad,
                                     float* __restrict__ accum, int64_t n,
                                     float lr, float eps) {
  using PP = Pack<P, VEC>;
  using PG = Pack<G, VEC>;
  using PA = Pack<float, VEC>;
  const int64_t groups = n / VEC;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       i < groups; i += stride) {
    const PG g = reinterpret_cast<const PG*>(grad)[i];
    PA a = reinterpret_cast<const PA*>(accum)[i];
    PP p = reinterpret_cast<const PP*>(param)[i];
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      const float gk = to_f32(g.v[k]);
      a.v[k] = __fmaf_rn(gk, gk, a.v[k]);
      const float den = __fadd_rn(__fsqrt_rn(a.v[k]), eps);
      const float upd = __fdiv_rn(__fmul_rn(lr, gk), den);
      p.v[k] = from_f32<P>(__fsub_rn(to_f32(p.v[k]), upd));
    }
    reinterpret_cast<PA*>(accum)[i] = a;
    reinterpret_cast<PP*>(param)[i] = p;
  }
}

bool aligned(const void* ptr, size_t bytes) {
  return reinterpret_cast<uintptr_t>(ptr) % bytes == 0;
}

template <typename P, typename G>
cudaError_t launch(void* param, const void* grad, float* accum, int64_t n,
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
                   aligned(grad, kVec * sizeof(G)) &&
                   aligned(accum, kVec * sizeof(float));
  const int64_t groups = vec ? n / kVec : n;
  // enough blocks to fill every SM several times over; the loop strides
  const int64_t want = (groups + kThreads - 1) / kThreads;
  const int blocks = static_cast<int>(want < 16LL * sms ? want : 16LL * sms);
  P* p = static_cast<P*>(param);
  const G* g = static_cast<const G*>(grad);
  if (vec)
    fused_adagrad_kernel<P, G, kVec><<<blocks, kThreads, 0, stream>>>(
        p, g, accum, n, lr, eps);
  else
    fused_adagrad_kernel<P, G, 1><<<blocks, kThreads, 0, stream>>>(
        p, g, accum, n, lr, eps);
  return cudaGetLastError();
}

}  // namespace

// dtype codes: 0 float32, 1 bfloat16.  param (N,), grad (N,), accum (N,)
// float32, all contiguous; param and accum are updated in place.  Returns
// a cudaError_t; the kernel runs on `stream` and the call does not
// synchronise.
extern "C" int repro_fused_adagrad(void* param, int param_dtype,
                                   const void* grad, int grad_dtype,
                                   void* accum, int64_t n, float lr,
                                   float eps, void* stream) {
  if (n < 1) return cudaErrorInvalidValue;
  float* a = static_cast<float*>(accum);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (param_dtype == 0 && grad_dtype == 0)
    return launch<float, float>(param, grad, a, n, lr, eps, s);
  if (param_dtype == 0 && grad_dtype == 1)
    return launch<float, __nv_bfloat16>(param, grad, a, n, lr, eps, s);
  if (param_dtype == 1 && grad_dtype == 0)
    return launch<__nv_bfloat16, float>(param, grad, a, n, lr, eps, s);
  if (param_dtype == 1 && grad_dtype == 1)
    return launch<__nv_bfloat16, __nv_bfloat16>(param, grad, a, n, lr, eps,
                                                s);
  return cudaErrorInvalidValue;
}
