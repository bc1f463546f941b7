// SA GEMM for Hopper (sm_90a): (M, K) @ (K, N), bf16 or fp32 operands,
// fp32 chain, fused epilogue, one fp32 write (and optionally the raw fp32
// accumulator beside it).
//
// Replaces the TPU kernel repro/kernels/sa_matmul.py `_matmul_kernel`,
// forward and backward: its custom VJP runs dA = dY·Wᵀ and dW = Aᵀ·dY
// through the same kernel with fp32 operands, and its `save_raw` output
// keeps the accumulator (after the approx truncation, before the scale)
// for the activation jacobian and dscale.
//
// Two kernels, chosen by the wrapper from the shapes:
//
// * sa_gemm_partial — decode and short prefill (M < 256). Bound by bytes:
//   every weight is read once and feeds only 2*M flops. A block owns 64
//   output columns x up to 8 rows of A; each warp reads whole 64-column
//   rows of W (coalesced), so W is read once per 8 rows of A. K is split
//   over gridDim.z (deterministic split-K: each slice writes its partial
//   sums to a workspace, the epilogue kernel adds the slices in order
//   0..KS-1) so narrow N still puts two blocks on every SM; the 8 warps of
//   a block stride over the K slice and their partials are added in warp
//   order through shared memory. Operands row-major.
// * sa_gemm_tiled — training shapes (M >= 256: 1024 tokens a microbatch)
//   and every backward GEMM. Bound by fp32 FMAs (SIMT, no tensor cores:
//   the backward's products are fp32 x bf16). A block of 256 threads owns
//   a 128 x 128 output tile, each thread an 8 x 8 register tile; 16-deep K
//   tiles of A and W are staged in shared memory as fp32 (double-buffered,
//   the next tile's global loads in flight during the current tile's 1024
//   FMAs a thread), so each staged value feeds 8 FMAs. Either operand may
//   be a transposed view (Aᵀ, Wᵀ of a row-major tensor): the stage reads
//   along whichever dimension is contiguous, so no transpose is copied and
//   W is never upcast in memory. Each output's chain runs k = 0..K-1 in
//   order in one thread; a K split (when the grid is under two waves)
//   goes through the same ordered workspace sum.
//
// A product of two bf16 values is exact in fp32; a product with an fp32
// operand is fused into the FMA. Nothing is rounded below fp32 until the
// epilogue.
//
// Epilogue, in the TPU kernel's order: truncate the low 3 mantissa bits
// (RTZ, approx mode only) -> [raw store] -> x scale -> + bias -> act
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

constexpr int kTBM = 128;   // tiled: output rows per block
constexpr int kTBN = 128;   // tiled: output columns per block
constexpr int kTBK = 16;    // tiled: K depth of a staged tile
constexpr int kTPad = 4;    // keeps float4 rows 16-byte aligned

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
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

struct Epilogue {
  const float* bias;       // (N,) or null
  float* out;              // (M, N)
  float* raw;              // (M, N) or null: the chain before the scale
  float scale;
  const float* scale_dev;  // one value on the card, or null
  int act;
  int approx;
};

__device__ __forceinline__ void epilogue_store(float s, size_t i, int n,
                                               const Epilogue& e,
                                               float scale) {
  if (e.approx) s = truncate3(s);
  if (e.raw != nullptr) e.raw[i] = s;
  float y = s * scale;
  if (e.bias != nullptr) y += e.bias[n];
  e.out[i] = act_apply(y, e.act);
}

template <typename TA, typename TW>
__global__ void __launch_bounds__(kThreads)
sa_gemm_partial(const TA* __restrict__ a, const TW* __restrict__ w,
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
      a_s[r][kk] = (m < M && kk < len) ? to_f32(a[(size_t)m * K + kc + kk])
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
        w0[u] = ok0 ? to_f32(w[row + c0]) : 0.f;
        w1[u] = ok1 ? to_f32(w[row + c1]) : 0.f;
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
      const float w0 = ok0 ? to_f32(w[row + c0]) : 0.f;
      const float w1 = ok1 ? to_f32(w[row + c1]) : 0.f;
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

// A (M, K): element (m, k) at a[m * lda + k] (A_KCONT) or a[k * lda + m];
// W (K, N): element (k, n) at w[k * ldw + n] (W_NCONT) or w[n * ldw + k].
template <typename TA, typename TW, bool A_KCONT, bool W_NCONT>
__global__ void __launch_bounds__(kThreads, 2)
sa_gemm_tiled(const TA* __restrict__ a, const TW* __restrict__ w, int lda,
              int ldw, float* __restrict__ ws, Epilogue epi, int M, int N,
              int K, int kslice) {
  __shared__ __align__(16) float a_s[2][kTBK][kTBM + kTPad];
  __shared__ __align__(16) float w_s[2][kTBK][kTBN + kTPad];
  constexpr int kPer = kTBM * kTBK / kThreads;  // staged values per thread
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.y * kTBM, n0 = blockIdx.x * kTBN;
  const int k_begin = blockIdx.z * kslice;
  const int k_end = min(K, k_begin + kslice);

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  float ra[kPer], rw[kPer];

  // element e of a staged tile: along the operand's contiguous dimension
  // first, so a warp's loads are coalesced
#define SA_A_POS(e, r, kk) \
  const int r = A_KCONT ? (e) / kTBK : (e) % kTBM;   \
  const int kk = A_KCONT ? (e) % kTBK : (e) / kTBM;
#define SA_W_POS(e, c, kk) \
  const int c = W_NCONT ? (e) % kTBN : (e) / kTBK;   \
  const int kk = W_NCONT ? (e) / kTBN : (e) % kTBK;

  auto load = [&](int kc) {
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int e = j * kThreads + tid;
      SA_A_POS(e, r, kk)
      const int m = m0 + r, k = kc + kk;
      ra[j] = (m < M && k < k_end)
                  ? to_f32(A_KCONT ? a[(size_t)m * lda + k]
                                   : a[(size_t)k * lda + m])
                  : 0.f;
    }
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int e = j * kThreads + tid;
      SA_W_POS(e, c, kk)
      const int n = n0 + c, k = kc + kk;
      rw[j] = (n < N && k < k_end)
                  ? to_f32(W_NCONT ? w[(size_t)k * ldw + n]
                                   : w[(size_t)n * ldw + k])
                  : 0.f;
    }
  };
  auto stage = [&](int buf) {
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int e = j * kThreads + tid;
      SA_A_POS(e, r, kk)
      a_s[buf][kk][r] = ra[j];
    }
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int e = j * kThreads + tid;
      SA_W_POS(e, c, kk)
      w_s[buf][kk][c] = rw[j];
    }
  };
#undef SA_A_POS
#undef SA_W_POS

  if (k_begin < k_end) {
    load(k_begin);
    stage(0);
  }
  __syncthreads();
  int buf = 0;
  for (int kc = k_begin; kc < k_end; kc += kTBK) {
    const bool more = kc + kTBK < k_end;
    if (more) load(kc + kTBK);
#pragma unroll
    for (int kk = 0; kk < kTBK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(&a_s[buf][kk][ty * 4]);
      const float4 a1 =
          *reinterpret_cast<const float4*>(&a_s[buf][kk][64 + ty * 4]);
      const float4 w0 = *reinterpret_cast<const float4*>(&w_s[buf][kk][tx * 4]);
      const float4 w1 =
          *reinterpret_cast<const float4*>(&w_s[buf][kk][64 + tx * 4]);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float wv[8] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], wv[j], acc[i][j]);
    }
    // the other buffer was last read before the previous barrier
    if (more) stage(buf ^ 1);
    __syncthreads();
    buf ^= 1;
  }

  const bool split = gridDim.z > 1;
  const float scale = epi.scale_dev != nullptr ? epi.scale_dev[0] : epi.scale;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int m = m0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + i - 4);
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int n = n0 + (j < 4 ? tx * 4 + j : 64 + tx * 4 + j - 4);
      if (n >= N) continue;
      if (split) {
        ws[((size_t)blockIdx.z * M + m) * N + n] = acc[i][j];
      } else {
        epilogue_store(acc[i][j], (size_t)m * N + n, n, epi, scale);
      }
    }
  }
}

// Adds the K slices in order 0..KS-1 and applies the epilogue. With KS == 1
// the workspace may be the output itself (each element is read, then
// written, by one thread), so neither pointer is __restrict__.
__global__ void sa_gemm_epilogue(const float* ws, Epilogue epi, int M, int N,
                                 int KS) {
  // a scale computed on the card (the FP8 GEMM's sa * sw) is read here, so
  // its caller never waits on the host
  const float scale = epi.scale_dev != nullptr ? epi.scale_dev[0] : epi.scale;
  const size_t total = (size_t)M * N;
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < total;
       i += (size_t)gridDim.x * blockDim.x) {
    float s = 0.f;
    for (int q = 0; q < KS; ++q) s += ws[(size_t)q * total + i];
    epilogue_store(s, i, static_cast<int>(i % N), epi, scale);
  }
}

template <typename TA, typename TW>
cudaError_t launch_partial(const void* a, const void* w, float* ws, int M,
                           int N, int K, int KS, int kslice,
                           cudaStream_t st) {
  dim3 grid((M + kRows - 1) / kRows, (N + kCols - 1) / kCols, KS);
  sa_gemm_partial<TA, TW><<<grid, kThreads, 0, st>>>(
      static_cast<const TA*>(a), static_cast<const TW*>(w), ws, M, N, K,
      kslice);
  return cudaGetLastError();
}

template <typename TA, typename TW, bool AK, bool WN>
cudaError_t launch_tiled(const void* a, const void* w, int lda, int ldw,
                         float* ws, const Epilogue& epi, int M, int N, int K,
                         int KS, int kslice, cudaStream_t st) {
  dim3 grid((N + kTBN - 1) / kTBN, (M + kTBM - 1) / kTBM, KS);
  sa_gemm_tiled<TA, TW, AK, WN><<<grid, kThreads, 0, st>>>(
      static_cast<const TA*>(a), static_cast<const TW*>(w), lda, ldw, ws,
      epi, M, N, K, kslice);
  return cudaGetLastError();
}

template <typename TA, typename TW>
cudaError_t launch_tiled_layout(const void* a, const void* w, int a_kcont,
                                int w_ncont, int lda, int ldw, float* ws,
                                const Epilogue& epi, int M, int N, int K,
                                int KS, int kslice, cudaStream_t st) {
  if (a_kcont && w_ncont)
    return launch_tiled<TA, TW, true, true>(a, w, lda, ldw, ws, epi, M, N, K,
                                            KS, kslice, st);
  if (a_kcont)
    return launch_tiled<TA, TW, true, false>(a, w, lda, ldw, ws, epi, M, N,
                                             K, KS, kslice, st);
  if (w_ncont)
    return launch_tiled<TA, TW, false, true>(a, w, lda, ldw, ws, epi, M, N,
                                             K, KS, kslice, st);
  return launch_tiled<TA, TW, false, false>(a, w, lda, ldw, ws, epi, M, N, K,
                                            KS, kslice, st);
}

}  // namespace

// dtype codes: 0 = fp32, 1 = bf16. tiled = 0 runs sa_gemm_partial (both
// operands row-major with lda = K, ldw = N), 1 runs sa_gemm_tiled. `ws`
// holds KS (M, N) partial sums; with KS == 1 it may be `out`.
extern "C" int sa_matmul_launch(const void* a, int a_dt, int a_kcont, int lda,
                                const void* w, int w_dt, int w_ncont, int ldw,
                                const void* bias, void* ws, void* out,
                                void* raw, float scale, const void* scale_dev,
                                int M, int N, int K, int KS, int kslice,
                                int act, int approx, int tiled,
                                void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  Epilogue epi{static_cast<const float*>(bias), static_cast<float*>(out),
               static_cast<float*>(raw), scale,
               static_cast<const float*>(scale_dev), act, approx};
  float* wsf = static_cast<float*>(ws);
  const int combo = a_dt * 2 + w_dt;
  cudaError_t err;
  if (tiled) {
    switch (combo) {
      case 0:
        err = launch_tiled_layout<float, float>(a, w, a_kcont, w_ncont, lda,
                                                ldw, wsf, epi, M, N, K, KS,
                                                kslice, st);
        break;
      case 1:
        err = launch_tiled_layout<float, __nv_bfloat16>(
            a, w, a_kcont, w_ncont, lda, ldw, wsf, epi, M, N, K, KS, kslice,
            st);
        break;
      case 2:
        err = launch_tiled_layout<__nv_bfloat16, float>(
            a, w, a_kcont, w_ncont, lda, ldw, wsf, epi, M, N, K, KS, kslice,
            st);
        break;
      case 3:
        err = launch_tiled_layout<__nv_bfloat16, __nv_bfloat16>(
            a, w, a_kcont, w_ncont, lda, ldw, wsf, epi, M, N, K, KS, kslice,
            st);
        break;
      default:
        return static_cast<int>(cudaErrorInvalidValue);
    }
    if (err != cudaSuccess || KS == 1) return static_cast<int>(err);
  } else {
    switch (combo) {
      case 0:
        err = launch_partial<float, float>(a, w, wsf, M, N, K, KS, kslice, st);
        break;
      case 1:
        err = launch_partial<float, __nv_bfloat16>(a, w, wsf, M, N, K, KS,
                                                   kslice, st);
        break;
      case 2:
        err = launch_partial<__nv_bfloat16, float>(a, w, wsf, M, N, K, KS,
                                                   kslice, st);
        break;
      case 3:
        err = launch_partial<__nv_bfloat16, __nv_bfloat16>(a, w, wsf, M, N, K,
                                                           KS, kslice, st);
        break;
      default:
        return static_cast<int>(cudaErrorInvalidValue);
    }
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const size_t total = (size_t)M * N;
  const int threads = 256;
  const int blocks =
      static_cast<int>(std::min<size_t>((total + threads - 1) / threads, 4096));
  sa_gemm_epilogue<<<blocks, threads, 0, st>>>(wsf, epi, M, N, KS);
  return static_cast<int>(cudaGetLastError());
}
