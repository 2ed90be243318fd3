// Wire quantization of the worker-parallel PS step, for Hopper (sm_90a):
// min-max int8 and sign quantize, each writing its error-feedback residual
// in the same pass, and the matching dequantize.
//
// Replaces the Pallas TPU kernels of src/repro/kernels/quantize.py:
// `quantize_minmax` (:173, body `_minmax_kernel` :131), `quantize_sign`
// (:201, body `_sign_kernel` :149) and `dequantize` (:224, bodies
// `_dequant_minmax_kernel` :160 and `_dequant_sign_kernel` :167).  The TPU
// kernels walk (R, tile) column blocks on a sequential grid with the
// (R, C / tile) sidebands resident in VMEM.  Here one thread block of 256
// threads owns one (row, tile) slice, so nothing carries over between
// blocks: it reduces its slice in shared memory, writes the slice's
// sideband words, then its codes and residual.  The dequantize block owns
// one (row, tile) slice too and reads its sideband words once.
//
// Every operand is a row-major (R, C) view with unit column stride and its
// own leading-dimension stride, and offsets are 64-bit: the path hands the
// quantizer group g of worker w as a strided (S, group_shard) view of the
// worker's (S, shard_size) residual row, and the quantizer reads the
// payload from it and writes the new residual back into it, in place.  So
// the payload and residual pointers alias, and neither is `__restrict__`:
// each element is read, then written by the same thread, after the slice's
// reduction has read all of it.
//
// Per (row, tile) slice x of the float32 payload:
//   minmax: mn = min x (-0.0 ranks below +0.0), mx = max x,
//           scale = (mx - mn) * f32(1/255), safe = scale > 0 ? scale : 1,
//           code = clamp(rint((x - mn) / safe), 0, 255), q = code - 128,
//           residual = x - fma(code, scale, mn);
//   sign:   scale = f32(sum |x| / tile), the sum in float64 in a fixed
//           order: thread t adds |x[t]|, |x[t + 256]|, ... from 0.0, then
//           thread t adds thread t + s's sum for s = 128, 64, ..., 1;
//           q = x >= 0 ? +1 : -1, residual = x - q * scale;
//   dequantize: fma(q + 128, scale, zero) (minmax) or q * scale (sign).
// Every float operation is an `__f*_rn` / `__d*_rn` intrinsic or `rintf`,
// which nvcc never contracts or reorders, so the kernels agree bit for bit
// with the plain versions in kernels/ref.py, which do the same correctly
// rounded operations in the same order.  The fma and the reciprocal of 255
// are what XLA computes for the reference on the CPU.  The sign of max x
// at zero cannot change the scale (mx - mn is +0.0 for every pair of
// zeros with mn ranked as above), so max is `fmaxf`.
//
// Bound: bytes.  A quantize reads the payload once and writes the int8
// code and the float32 residual once, 9 bytes an element, against about
// ten float operations (the sign quantize: one float64 add); a dequantize
// reads 1 byte and writes 4.  The quantize block reads its 8 KB slice a
// second time for the codes, which the L1 or L2 cache serves.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;   // ref.SIGN_LANES
constexpr int kMinMax = 0;
constexpr int kSign = 1;

__device__ __forceinline__ float min_signed(float a, float b) {
  return (b < a || (b == a && signbit(b))) ? b : a;
}

template <int MODE>
__global__ void __launch_bounds__(kThreads)
    quantize_kernel(float* x, int64_t ldx, int8_t* __restrict__ q,
                    int64_t ldq, float* __restrict__ scale_out,
                    float* __restrict__ zero_out, int64_t lds, int tile,
                    int64_t n_tiles, float inv255) {
  __shared__ float s_lo[kThreads];
  __shared__ float s_hi[kThreads];
  __shared__ double s_sum[kThreads];
  const int t = threadIdx.x;
  const int64_t row = blockIdx.x / n_tiles;
  const int64_t k = blockIdx.x - row * n_tiles;
  float* xs = x + row * ldx + k * tile;
  int8_t* qs = q + row * ldq + k * tile;

  if (MODE == kMinMax) {
    float lo = __int_as_float(0x7f800000), hi = __int_as_float(0xff800000);
    for (int i = t; i < tile; i += kThreads) {
      const float v = xs[i];
      lo = min_signed(lo, v);
      hi = fmaxf(hi, v);
    }
    s_lo[t] = lo;
    s_hi[t] = hi;
    __syncthreads();
    for (int s = kThreads / 2; s > 0; s >>= 1) {
      if (t < s) {
        s_lo[t] = min_signed(s_lo[t], s_lo[t + s]);
        s_hi[t] = fmaxf(s_hi[t], s_hi[t + s]);
      }
      __syncthreads();
    }
    const float zero = s_lo[0];
    const float scale = __fmul_rn(__fsub_rn(s_hi[0], zero), inv255);
    if (t == 0) {
      scale_out[row * lds + k] = scale;
      zero_out[row * lds + k] = zero;
    }
    const float safe = scale > 0.0f ? scale : 1.0f;
    for (int i = t; i < tile; i += kThreads) {
      const float v = xs[i];
      const float code = fminf(
          fmaxf(rintf(__fdiv_rn(__fsub_rn(v, zero), safe)), 0.0f), 255.0f);
      qs[i] = static_cast<int8_t>(static_cast<int>(code) - 128);
      xs[i] = __fsub_rn(v, __fmaf_rn(code, scale, zero));
    }
  } else {
    double sum = 0.0;
    for (int i = t; i < tile; i += kThreads)
      sum = __dadd_rn(sum, static_cast<double>(fabsf(xs[i])));
    s_sum[t] = sum;
    __syncthreads();
    for (int s = kThreads / 2; s > 0; s >>= 1) {
      if (t < s) s_sum[t] = __dadd_rn(s_sum[t], s_sum[t + s]);
      __syncthreads();
    }
    const float scale =
        __double2float_rn(__ddiv_rn(s_sum[0], static_cast<double>(tile)));
    if (t == 0) scale_out[row * lds + k] = scale;
    for (int i = t; i < tile; i += kThreads) {
      const float v = xs[i];
      const float sgn = v >= 0.0f ? 1.0f : -1.0f;
      qs[i] = static_cast<int8_t>(sgn);
      xs[i] = __fsub_rn(v, __fmul_rn(sgn, scale));
    }
  }
}

template <int MODE>
__global__ void __launch_bounds__(kThreads)
    dequantize_kernel(const int8_t* __restrict__ q, int64_t ldq,
                      const float* __restrict__ scale,
                      const float* __restrict__ zero, int64_t lds,
                      float* __restrict__ out, int64_t ldo, int tile,
                      int64_t n_tiles) {
  const int64_t row = blockIdx.x / n_tiles;
  const int64_t k = blockIdx.x - row * n_tiles;
  const int8_t* qs = q + row * ldq + k * tile;
  float* os = out + row * ldo + k * tile;
  const float sc = scale[row * lds + k];
  if (MODE == kMinMax) {
    const float zp = zero[row * lds + k];
    for (int i = threadIdx.x; i < tile; i += kThreads)
      os[i] = __fmaf_rn(__fadd_rn(static_cast<float>(qs[i]), 128.0f), sc,
                        zp);
  } else {
    for (int i = threadIdx.x; i < tile; i += kThreads)
      os[i] = __fmul_rn(static_cast<float>(qs[i]), sc);
  }
}

}  // namespace

// x: (rows, cols) float32 with leading stride ldx, the payload, which the
// residual overwrites; q: int8 codes, leading stride ldq; scale and zero:
// (rows, cols / tile) float32 with leading stride lds (mode 0, minmax,
// writes both; mode 1, sign, writes scale alone).  rows * (cols / tile)
// blocks, at most INT_MAX (the wrapper checks).  Returns a cudaError_t.
extern "C" int repro_quantize(float* x, long long ldx, int8_t* q,
                              long long ldq, float* scale, float* zero,
                              long long lds, long long rows, long long cols,
                              int tile, int mode, float inv255,
                              void* stream) {
  if (rows < 1 || cols < 1 || tile < 1 || cols % tile) return 1;
  const int64_t n_tiles = cols / tile;
  if (rows * n_tiles > 0x7fffffffLL) return 1;
  const unsigned blocks = static_cast<unsigned>(rows * n_tiles);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (mode == kMinMax)
    quantize_kernel<kMinMax><<<blocks, kThreads, 0, s>>>(
        x, ldx, q, ldq, scale, zero, lds, tile, n_tiles, inv255);
  else if (mode == kSign)
    quantize_kernel<kSign><<<blocks, kThreads, 0, s>>>(
        x, ldx, q, ldq, scale, zero, lds, tile, n_tiles, inv255);
  else
    return 1;
  return cudaGetLastError();
}

// q: (rows, cols) int8, leading stride ldq; scale (and zero for mode 0):
// (rows, cols / tile) float32, leading stride lds; out: (rows, cols)
// float32, leading stride ldo.  Returns a cudaError_t.
extern "C" int repro_dequantize(const int8_t* q, long long ldq,
                                const float* scale, const float* zero,
                                long long lds, float* out, long long ldo,
                                long long rows, long long cols, int tile,
                                int mode, void* stream) {
  if (rows < 1 || cols < 1 || tile < 1 || cols % tile) return 1;
  const int64_t n_tiles = cols / tile;
  if (rows * n_tiles > 0x7fffffffLL) return 1;
  const unsigned blocks = static_cast<unsigned>(rows * n_tiles);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (mode == kMinMax)
    dequantize_kernel<kMinMax><<<blocks, kThreads, 0, s>>>(
        q, ldq, scale, zero, lds, out, ldo, tile, n_tiles);
  else if (mode == kSign)
    dequantize_kernel<kSign><<<blocks, kThreads, 0, s>>>(
        q, ldq, scale, zero, lds, out, ldo, tile, n_tiles);
  else
    return 1;
  return cudaGetLastError();
}
