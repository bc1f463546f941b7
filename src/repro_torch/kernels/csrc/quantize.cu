// Scaled FP8 quantization for Hopper (sm_90a): y = q(x * (1/scale)) onto
// the E4M3 or E5M2 grid, fp32 values out.
//
// Replaces the TPU kernel repro/kernels/quantize.py `_quantize_kernel`,
// bit for bit (its `_quant_body`):
//   * the reciprocal of scale[0] once (IEEE division: this file is built
//     without --use_fast_math, so -prec-div=true and -ftz=false), then one
//     multiply per element;
//   * round to nearest even on the uint32 pattern of the product;
//   * flush to +0 below the format's normal range, after rounding;
//   * E4M3 saturates to +-448, E5M2 overflows to +-Inf;
//   * a NaN product passes.
// Bound by bytes: 8 per fp32 element (6 for bf16 in) against one multiply
// and ~12 integer operations. Each thread moves 16 bytes per load (4 fp32
// or 8 bf16 values) with a grid-stride loop; `scale` is read from device
// memory so the caller needs no host sync.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

template <int MAN, bool SAT>
__device__ __forceinline__ float quant1(float x, float inv) {
  constexpr int kShift = 23 - MAN;
  constexpr uint32_t kHalf = 1u << (kShift - 1);
  constexpr uint32_t kMask = ~((1u << kShift) - 1u);
  constexpr float kMinNormal = SAT ? 0.015625f : 6.103515625e-05f;
  constexpr float kMax = SAT ? 448.f : 57344.f;
  const float p = __fmul_rn(x, inv);
  const uint32_t bits = __float_as_uint(p);
  const uint32_t lsb = (bits >> kShift) & 1u;
  float y = __uint_as_float((bits + kHalf - 1u + lsb) & kMask);
  const float ay = fabsf(y);
  if (ay < kMinNormal) y = 0.f;
  if (SAT) {
    y = fminf(fmaxf(y, -kMax), kMax);
  } else if (ay > kMax) {
    y = copysignf(__int_as_float(0x7f800000), y);
  }
  return isnan(p) ? p : y;
}

__device__ __forceinline__ float load1(const float* x, long long i) {
  return x[i];
}
__device__ __forceinline__ float load1(const __nv_bfloat16* x, long long i) {
  return __bfloat162float(x[i]);
}

// Vector of 16 bytes: 4 fp32 or 8 bf16 values.
template <typename T>
struct Vec;
template <>
struct Vec<float> {
  static constexpr int kN = 4;
  __device__ static void load(const float* x, long long v, float* f) {
    const float4 q = reinterpret_cast<const float4*>(x)[v];
    f[0] = q.x; f[1] = q.y; f[2] = q.z; f[3] = q.w;
  }
};
template <>
struct Vec<__nv_bfloat16> {
  static constexpr int kN = 8;
  __device__ static void load(const __nv_bfloat16* x, long long v, float* f) {
    const uint4 q = reinterpret_cast<const uint4*>(x)[v];
    const uint32_t w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      f[2 * i] = __uint_as_float(w[i] << 16);            // low half first
      f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
};

template <int MAN, bool SAT, typename T>
__global__ void __launch_bounds__(256)
quantize_fp8(const T* __restrict__ x, const float* __restrict__ scale,
             float* __restrict__ out, long long n, int vec) {
  const float inv = __fdiv_rn(1.f, scale[0]);
  constexpr int kN = Vec<T>::kN;
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  long long done = 0;
  if (vec) {
    const long long nv = n / kN;
    for (long long v = tid; v < nv; v += stride) {
      float f[kN];
      Vec<T>::load(x, v, f);
      float4* o = reinterpret_cast<float4*>(out) + v * (kN / 4);
#pragma unroll
      for (int j = 0; j < kN / 4; ++j) {
        o[j] = make_float4(quant1<MAN, SAT>(f[4 * j], inv),
                           quant1<MAN, SAT>(f[4 * j + 1], inv),
                           quant1<MAN, SAT>(f[4 * j + 2], inv),
                           quant1<MAN, SAT>(f[4 * j + 3], inv));
      }
    }
    done = nv * kN;
  }
  for (long long i = done + tid; i < n; i += stride) {
    out[i] = quant1<MAN, SAT>(load1(x, i), inv);
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* scale, void* out, long long n,
                   int e4m3, cudaStream_t st) {
  const T* xp = static_cast<const T*>(x);
  // 16-byte loads need a 16-byte aligned input; the output is a fresh
  // allocation
  const int vec = (reinterpret_cast<uintptr_t>(x) % 16 == 0) &&
                  (reinterpret_cast<uintptr_t>(out) % 16 == 0);
  const long long work = vec ? n / Vec<T>::kN + 1 : n;
  const int threads = 256;
  const int blocks =
      static_cast<int>(std::min<long long>((work + threads - 1) / threads,
                                           4096));
  if (e4m3) {
    quantize_fp8<3, true, T><<<blocks, threads, 0, st>>>(
        xp, static_cast<const float*>(scale), static_cast<float*>(out), n,
        vec);
  } else {
    quantize_fp8<2, false, T><<<blocks, threads, 0, st>>>(
        xp, static_cast<const float*>(scale), static_cast<float*>(out), n,
        vec);
  }
  return cudaGetLastError();
}

}  // namespace

// in_dtype: 0 fp32, 1 bf16. e4m3: 1 for E4M3 (saturating), 0 for E5M2.
extern "C" int quantize_fp8_launch(const void* x, const void* scale,
                                   void* out, long long n, int in_dtype,
                                   int e4m3, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      in_dtype == 1
          ? launch<__nv_bfloat16>(x, scale, out, n, e4m3, st)
          : launch<float>(x, scale, out, n, e4m3, st);
  return static_cast<int>(err);
}
