// SA GEMM for Hopper (sm_90a): (M, K) @ (K, N), bf16 in, fp32 chain,
// fused epilogue, one fp32 write.
//
// Replaces the TPU kernel repro/kernels/sa_matmul.py `_matmul_kernel`.
// Bound by bytes at the serving shapes (decode M = batch): every bf16
// weight is read once and feeds only 2*M flops. So:
//   * a block owns 64 output columns x up to 8 rows of A; each warp reads
//     whole 64-column rows of W (two coalesced 64-byte requests), so W is
//     read once per 8 rows of A;
//   * K is split over gridDim.z (deterministic split-K: each slice writes
//     its partial sums to a workspace, a second kernel adds the slices in
//     order 0..KS-1) so narrow N still puts two blocks on every SM;
//   * the 8 warps of a block stride over the K slice and their partials
//     are added in warp order through shared memory.
// Every product of two bf16 values is exact in fp32 and is accumulated
// with fp32 FMA; nothing is rounded below fp32 until the epilogue.
//
// Epilogue (second kernel), in the TPU kernel's order: truncate the low 3
// mantissa bits (RTZ, approx mode only) -> x scale -> + bias -> act
// (none / relu / gelu-tanh / silu) -> one fp32 store.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kCols = 64;   // output columns per block (2 per lane)
constexpr int kRows = 8;    // rows of A per block
constexpr int kChunk = 256; // K rows staged in shared memory at a time

__global__ void __launch_bounds__(kThreads)
sa_gemm_partial(const __nv_bfloat16* __restrict__ a,
                const __nv_bfloat16* __restrict__ w,
                float* __restrict__ ws, int M, int N, int K, int kslice) {
  __shared__ float a_s[kRows][kChunk];
  __shared__ float red[kWarps][kRows][kCols];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int m0 = blockIdx.x * kRows;      // rows fastest: blocks that share
  const int n0 = blockIdx.y * kCols;      // W columns run side by side
  const int ks = blockIdx.z;
  const int k_begin = ks * kslice;
  const int k_end = min(K, k_begin + kslice);
  const int c0 = n0 + lane, c1 = n0 + 32 + lane;
  const bool ok0 = c0 < N, ok1 = c1 < N;

  float acc0[kRows], acc1[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) acc0[r] = acc1[r] = 0.f;

  for (int kc = k_begin; kc < k_end; kc += kChunk) {
    const int len = min(kChunk, k_end - kc);
    __syncthreads();
    for (int i = threadIdx.x; i < kRows * kChunk; i += kThreads) {
      const int r = i / kChunk, kk = i % kChunk;
      const int m = m0 + r;
      a_s[r][kk] = (m < M && kk < len)
                       ? __bfloat162float(a[(size_t)m * K + kc + kk])
                       : 0.f;
    }
    __syncthreads();
    int kk = warp;
    // four rows in flight per warp before their FMAs
    for (; kk + 3 * kWarps < len; kk += 4 * kWarps) {
      float w0[4], w1[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const size_t row = (size_t)(kc + kk + u * kWarps) * N;
        w0[u] = ok0 ? __bfloat162float(w[row + c0]) : 0.f;
        w1[u] = ok1 ? __bfloat162float(w[row + c1]) : 0.f;
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          const float av = a_s[r][kk + u * kWarps];
          acc0[r] = fmaf(av, w0[u], acc0[r]);
          acc1[r] = fmaf(av, w1[u], acc1[r]);
        }
      }
    }
    for (; kk < len; kk += kWarps) {
      const size_t row = (size_t)(kc + kk) * N;
      const float w0 = ok0 ? __bfloat162float(w[row + c0]) : 0.f;
      const float w1 = ok1 ? __bfloat162float(w[row + c1]) : 0.f;
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float av = a_s[r][kk];
        acc0[r] = fmaf(av, w0, acc0[r]);
        acc1[r] = fmaf(av, w1, acc1[r]);
      }
    }
  }
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    red[warp][r][lane] = acc0[r];
    red[warp][r][32 + lane] = acc1[r];
  }
  __syncthreads();
  for (int i = threadIdx.x; i < kRows * kCols; i += kThreads) {
    const int r = i / kCols, c = i % kCols;
    const int m = m0 + r, n = n0 + c;
    if (m >= M || n >= N) continue;
    float s = 0.f;
#pragma unroll
    for (int q = 0; q < kWarps; ++q) s += red[q][r][c];
    ws[((size_t)ks * M + m) * N + n] = s;
  }
}

__device__ __forceinline__ float truncate3(float y) {
  return __int_as_float(__float_as_int(y) & ~7);
}

__device__ __forceinline__ float act_apply(float y, int act) {
  switch (act) {
    case 1:
      return fmaxf(y, 0.f);
    case 2: {  // tanh-approximate gelu (jax.nn.gelu's default)
      const float inner = 0.7978845608028654f * (y + 0.044715f * y * y * y);
      return 0.5f * y * (1.f + tanhf(inner));
    }
    case 3:
      return y / (1.f + expf(-y));
    default:
      return y;
  }
}

__global__ void sa_gemm_epilogue(const float* __restrict__ ws,
                                 const float* __restrict__ bias,
                                 float* __restrict__ out, float scale,
                                 const float* __restrict__ scale_dev, int M,
                                 int N, int KS, int act, int approx) {
  // a scale computed on the card (the FP8 GEMM's sa * sw) is read here, so
  // its caller never waits on the host
  if (scale_dev != nullptr) scale = scale_dev[0];
  const size_t total = (size_t)M * N;
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < total;
       i += (size_t)gridDim.x * blockDim.x) {
    float s = 0.f;
    for (int q = 0; q < KS; ++q) s += ws[(size_t)q * total + i];
    if (approx) s = truncate3(s);
    float y = s * scale;
    if (bias != nullptr) y += bias[i % N];
    out[i] = act_apply(y, act);
  }
}

}  // namespace

extern "C" int sa_matmul_launch(const void* a, const void* w,
                                const void* bias, void* ws, void* out,
                                float scale, const void* scale_dev, int M,
                                int N, int K, int KS,
                                int kslice, int act, int approx,
                                void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  dim3 grid((M + kRows - 1) / kRows, (N + kCols - 1) / kCols, KS);
  sa_gemm_partial<<<grid, kThreads, 0, st>>>(
      static_cast<const __nv_bfloat16*>(a),
      static_cast<const __nv_bfloat16*>(w), static_cast<float*>(ws), M, N,
      K, kslice);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t total = (size_t)M * N;
  const int threads = 256;
  const int blocks =
      static_cast<int>(std::min<size_t>((total + threads - 1) / threads, 4096));
  sa_gemm_epilogue<<<blocks, threads, 0, st>>>(
      static_cast<const float*>(ws), static_cast<const float*>(bias),
      static_cast<float*>(out), scale, static_cast<const float*>(scale_dev),
      M, N, KS, act, approx);
  return static_cast<int>(cudaGetLastError());
}
