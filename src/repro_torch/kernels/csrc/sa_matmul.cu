// SA GEMM for Hopper (sm_90a): (M, K) @ (K, N), bf16 or fp32 operands,
// fp32 chain, fused epilogue, one fp32 write (and optionally the raw fp32
// accumulator beside it).
//
// Replaces the TPU kernel repro/kernels/sa_matmul.py `_matmul_kernel`,
// forward and backward: its custom VJP runs dA = dY·Wᵀ and dW = Aᵀ·dY
// through the same kernel with fp32 dY, and its `save_raw` output keeps
// the accumulator (after the approx truncation, before the scale) for the
// activation jacobian and dscale.
//
// Four routes, chosen by the wrapper (kernels/sa_matmul.py `gemm_route`)
// from the rows and the operand types, each counted apart:
//
// * partial: sa_gemm_partial — fp32 decode (M < 8, row-major operands, at
//   least one operand fp32: the fp32 policy and mixed pairs). Bound by
//   bytes: every weight is read once and feeds only 2*M flops. A thread
//   owns one output column and up to 8 rows of A, a block 128 columns and
//   one K slice (gridDim.z = the slices): each slice's sum is one in-order
//   FMA chain in one thread, written to a workspace, and the epilogue kernel
//   folds the slices (see "Each output's sum"). The slices, not the rows,
//   fill the SMs: a narrow N still puts blocks on every SM.
// * mma: bf16 x bf16 at every M (the forward under the bf16 and FP8
//   policies, decode included), fp32 accumulate on the tensor cores. At
//   training shapes it is bound by the tensor cores and by the step sums'
//   adds (a layer's 7 GEMMs at M = 1024: 0.570 ms at 989 TFLOP/s, 0.527 ms
//   of FADDs; see TileLarge). At prefill's M it is bound by W's bytes and
//   by how many blocks fill the 132 SMs; at decode's (M <= 16) by W's
//   bytes alone: every weight feeds 2*M flops. Three tiles, chosen by the
//   wrapper's `mma_plan`: TileLarge (sa_gemm_wgmma: warp-specialized, TMA
//   into a 128-byte-swizzled ring read by wgmma m64n128k16) where its
//   128 x 128 blocks pay (`large_pays`); below that TileSmall, and TileDecode
//   for M <= 16, whose blocks each stream a 64-column strip of W (see
//   TileDecode); both sa_gemm_mma, one piece: mma.sync.m16n8k16 on
//   operand tiles copied by cp.async (TileDecode's W by TMA) into a ring
//   of XOR-swizzled bf16 tiles and read by ldmatrix: .trans for a
//   row-contiguous operand (W as stored, Aᵀ of a row-major A), plain for a
//   K-contiguous one (Wᵀ, A). Either operand is read in place through its
//   strides on every tile, no transpose copied. The epilogue runs on the
//   accumulator fragments: one launch a GEMM, no workspace.
// * split3: sa_gemm_mma, three pieces — one fp32 and one bf16 operand: both
//   backward GEMMs. The fp32 operand is split once (sa_split3, shared by
//   dA and dW) into three bf16 planes with hi + mid + lo == x exactly (see
//   split3 below). Each piece x bf16 product is exact in fp32, so the
//   tensor cores form exactly the reference's products (fp32 x bf16) and
//   only the order of the sums differs. Each fragment of the bf16 operand
//   is loaded once and feeds three mma, one a piece. The split runs as its
//   own pass, not while staging or loading fragments: it is done once per
//   element (not once per block or per warp that reads it), both backward
//   GEMMs share it, the GEMM's A loads stay pure cp.async with no
//   registers held across the pipeline (the accumulators take 64 a
//   thread), and it costs 10 bytes an element of dY against 3 x 2 K flops.
//   Bound by the tensor cores at three times the mma route's products.
//   With the fp32 operand on the weight side the wrapper transposes the
//   problem (C^T = W^T A^T) and the epilogue writes through strides.
// * simt: sa_gemm_tiled — fp32 x fp32 (the fp32 policy; fp32 has no exact
//   tensor-core type). Bound by fp32 FMAs: a 128 x 128 output tile per
//   block, 8 x 8 per thread, 16-deep K tiles staged in shared memory as
//   fp32 (double-buffered), either operand read through its strides. A
//   block sums one part of K (gridDim.z = the parts): each slice's chain
//   from zero, folded in the thread into the part's sum (kept in dynamic
//   shared memory, 64 a thread); several parts go through the workspace
//   and the epilogue kernel.
//
// The fp32 routes' order (ROADMAP F2b): K is cut into slices of kSlice =
// 256 (the last one ragged), each summed from zero as an in-order FMA
// chain; a part is `per_part` consecutive slices, its sum the slices folded
// left in order from zero; the output is the parts folded left in order
// from zero. The slices and parts depend on N and K only (the wrapper's
// fp32_k_plan), never on M, so partial (M < 8) and simt give every fp32 x
// fp32 output the same bits, and a row's bits do not depend on the rows
// beside it. partial writes every slice and the epilogue folds both
// levels; simt folds the slices of its part in the thread.
//
// Each output's sum on the tensor-core routes (sa_gemm_mma and
// sa_gemm_wgmma): one thread accumulates its k16 steps in order k = 0, 16,
// ..., whatever M, N or the tile: K is never split there, so a row's result does not depend on the other rows, and a bf16
// GEMM gives every row the same bits at every M (ROADMAP F2). A step's 16
// products (48 under split3: the pieces lo, mid, hi) are summed by the
// tensor cores from zero, and the step's sum is added to the fp32
// accumulator with one rounding to nearest. A product of two bf16 values is exact
// in fp32; in the SIMT kernels a product with an fp32 operand is fused into
// the FMA. The tensor cores do not round each addition: they align a group
// of products and the running sum to the largest exponent, truncate, add,
// and truncate the sum (Fasi, Higham, Mikaitis and Pranesh, PeerJ CS 2021);
// with each step summed from zero, that truncation is relative to one
// step's terms, not to the running sum. Left on the running sum it would
// grow with K, toward zero: about (3K / 16) / 4 units of 2^-23 of the
// partial sums under split3, which at the lm_head's K = 153600 is as large
// as rounding dY once to bf16. The wrapper's `error_bound` charges both
// per route. Nothing is rounded below fp32 until the epilogue.
//
// Epilogue, in the TPU kernel's order: truncate the low 3 mantissa bits
// (RTZ, approx mode only) -> [raw store] -> x scale -> + bias -> act
// (none / relu / gelu-tanh / silu) -> one fp32 store.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kThreads = 256;   // tiled (simt): threads per block
constexpr int kRows = 8;    // partial: rows of A per block
constexpr int kPCols = 128; // partial: output columns per block (one a thread)
constexpr int kSlice = 256; // fp32 routes: K depth of a slice (one FMA chain)

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
__global__ void __launch_bounds__(kPCols)
sa_gemm_partial(const TA* __restrict__ a, const TW* __restrict__ w,
                float* __restrict__ ws, int M, int N, int K) {
  __shared__ float a_s[kRows][kSlice];
  const int m0 = blockIdx.x * kRows;
  const int n = blockIdx.y * kPCols + threadIdx.x;
  const int s = blockIdx.z;
  const int k0 = s * kSlice;
  const int len = min(kSlice, K - k0);
  for (int i = threadIdx.x; i < kRows * kSlice; i += kPCols) {
    const int r = i / kSlice, kk = i % kSlice;
    const int m = m0 + r;
    a_s[r][kk] = (m < M && kk < len) ? to_f32(a[(size_t)m * K + k0 + kk])
                                     : 0.f;
  }
  __syncthreads();
  if (n >= N) return;
  // the slice's chain, k in order; sixteen rows of W in flight before
  // their FMAs (at decode each thread streams its column)
  float acc[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) acc[r] = 0.f;
  const TW* wp = w + (size_t)k0 * N + n;
  int kk = 0;
  for (; kk + 16 <= len; kk += 16) {
    float wv[16];
#pragma unroll
    for (int u = 0; u < 16; ++u) wv[u] = to_f32(wp[(size_t)(kk + u) * N]);
#pragma unroll
    for (int u = 0; u < 16; ++u) {
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        acc[r] = fmaf(a_s[r][kk + u], wv[u], acc[r]);
      }
    }
  }
  for (; kk < len; ++kk) {
    const float wv = to_f32(wp[(size_t)kk * N]);
#pragma unroll
    for (int r = 0; r < kRows; ++r) acc[r] = fmaf(a_s[r][kk], wv, acc[r]);
  }
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int m = m0 + r;
    if (m < M) ws[((size_t)s * M + m) * N + n] = acc[r];
  }
}

// A (M, K): element (m, k) at a[m * lda + k] (A_KCONT) or a[k * lda + m];
// W (K, N): element (k, n) at w[k * ldw + n] (W_NCONT) or w[n * ldw + k].
template <typename TA, typename TW, bool A_KCONT, bool W_NCONT>
__global__ void __launch_bounds__(kThreads, 2)
sa_gemm_tiled(const TA* __restrict__ a, const TW* __restrict__ w, int lda,
              int ldw, float* __restrict__ ws, Epilogue epi, int M, int N,
              int K, int per_part) {
  __shared__ __align__(16) float a_s[2][kTBK][kTBM + kTPad];
  __shared__ __align__(16) float w_s[2][kTBK][kTBN + kTPad];
  // the part's running sum of each of the thread's 64 outputs: output j at
  // u_s[j * kThreads + tid] (dynamic shared memory, 64 KB)
  extern __shared__ float u_s[];
  constexpr int kPer = kTBM * kTBK / kThreads;  // staged values per thread
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.y * kTBM, n0 = blockIdx.x * kTBN;
  const int k_begin = blockIdx.z * per_part * kSlice;
  const int k_end = min(K, k_begin + per_part * kSlice);

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

  // a slice's chain ends: fold it into the part's sum (from zero at the
  // part's first slice) and start the next chain from zero
  bool first = true;
  auto fold = [&]() {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        float& u = u_s[(i * 8 + j) * kThreads + tid];
        u = __fadd_rn(first ? 0.f : u, acc[i][j]);
        acc[i][j] = 0.f;
      }
    }
    first = false;
  };

  if (k_begin < k_end) {
    load(k_begin);
    stage(0);
  }
  __syncthreads();
  int buf = 0;
  int tiles_left = kSlice / kTBK;   // K tiles left in the slice
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
    if (--tiles_left == 0 || !more) {
      fold();
      tiles_left = kSlice / kTBK;
    }
    // the other buffer was last read before the previous barrier
    if (more) stage(buf ^ 1);
    __syncthreads();
    buf ^= 1;
  }
  if (first) fold();   // an empty K: the sum of nothing, +0

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
      const float u = u_s[(i * 8 + j) * kThreads + tid];
      if (split) {
        ws[((size_t)blockIdx.z * M + m) * N + n] = u;
      } else {   // one part: the outer fold is 0 + u
        epilogue_store(__fadd_rn(0.f, u), (size_t)m * N + n, n, epi, scale);
      }
    }
  }
}

// Folds the workspace's S partial sums in the fp32 routes' order: parts of
// `per_part` consecutive entries, each folded left from zero, the parts
// folded left from zero; then the epilogue. With S == 1 the workspace may be
// the output itself (each element is read, then written, by one thread),
// so neither pointer is __restrict__.
__global__ void sa_gemm_epilogue(const float* ws, Epilogue epi, int M, int N,
                                 int S, int per_part) {
  // a scale computed on the card (the FP8 GEMM's sa * sw) is read here, so
  // its caller never waits on the host
  const float scale = epi.scale_dev != nullptr ? epi.scale_dev[0] : epi.scale;
  const size_t total = (size_t)M * N;
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < total;
       i += (size_t)gridDim.x * blockDim.x) {
    float t = 0.f;
    for (int p0 = 0; p0 < S; p0 += per_part) {
      float u = 0.f;
      for (int q = p0; q < min(S, p0 + per_part); ++q) {
        u = __fadd_rn(u, ws[(size_t)q * total + i]);
      }
      t = __fadd_rn(t, u);
    }
    epilogue_store(t, i, static_cast<int>(i % N), epi, scale);
  }
}

template <typename TA, typename TW>
cudaError_t launch_partial(const void* a, const void* w, float* ws, int M,
                           int N, int K, int S, cudaStream_t st) {
  dim3 grid((M + kRows - 1) / kRows, (N + kPCols - 1) / kPCols, S);
  sa_gemm_partial<TA, TW><<<grid, kPCols, 0, st>>>(
      static_cast<const TA*>(a), static_cast<const TW*>(w), ws, M, N, K);
  return cudaGetLastError();
}

constexpr int kTiledDynSmem = 64 * kThreads * 4;   // u_s

template <typename TA, typename TW, bool AK, bool WN>
cudaError_t launch_tiled(const void* a, const void* w, int lda, int ldw,
                         float* ws, const Epilogue& epi, int M, int N, int K,
                         int parts, int per_part, cudaStream_t st) {
  // set on every launch: the attribute belongs to the current device
  cudaError_t attr = cudaFuncSetAttribute(
      sa_gemm_tiled<TA, TW, AK, WN>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, kTiledDynSmem);
  if (attr != cudaSuccess) return attr;
  dim3 grid((N + kTBN - 1) / kTBN, (M + kTBM - 1) / kTBM, parts);
  sa_gemm_tiled<TA, TW, AK, WN><<<grid, kThreads, kTiledDynSmem, st>>>(
      static_cast<const TA*>(a), static_cast<const TW*>(w), lda, ldw, ws,
      epi, M, N, K, per_part);
  return cudaGetLastError();
}

template <typename TA, typename TW>
cudaError_t launch_tiled_layout(const void* a, const void* w, int a_kcont,
                                int w_ncont, int lda, int ldw, float* ws,
                                const Epilogue& epi, int M, int N, int K,
                                int parts, int per_part, cudaStream_t st) {
  if (a_kcont && w_ncont)
    return launch_tiled<TA, TW, true, true>(a, w, lda, ldw, ws, epi, M, N, K,
                                            parts, per_part, st);
  if (a_kcont)
    return launch_tiled<TA, TW, true, false>(a, w, lda, ldw, ws, epi, M, N,
                                             K, parts, per_part, st);
  if (w_ncont)
    return launch_tiled<TA, TW, false, true>(a, w, lda, ldw, ws, epi, M, N,
                                             K, parts, per_part, st);
  return launch_tiled<TA, TW, false, false>(a, w, lda, ldw, ws, epi, M, N, K,
                                            parts, per_part, st);
}

// ---------------------------------------------------------------------------
// tensor-core routes: mma (bf16 x bf16) and split3 (fp32 x bf16)
// ---------------------------------------------------------------------------

// A block tile: BM x BN outputs over WARPS_M x WARPS_N warps, K staged BK
// deep (BK / 16 k16 steps) in a ring of STAGES stages. A's tiles are copied
// by cp.async; B's too, or (TMA_B, for B as stored (K, N)) by the tensor
// memory accelerator: one bulk copy a stage, issued by one thread,
// completing on the stage's mbarrier, in the same swizzled layout (TMA's
// 32-, 64- or 128-byte swizzle is swz_off's, for tile rows of that many
// bytes, on a 1024-byte aligned tile).
template <int BM_, int BN_, int WARPS_M_, int WARPS_N_, int BK_, int STAGES_,
          bool TMA_B_ = false>
struct TcTile {
  static constexpr int BM = BM_, BN = BN_, WARPS_M = WARPS_M_,
                       WARPS_N = WARPS_N_, BK = BK_, STAGES = STAGES_,
                       THREADS = 32 * WARPS_M_ * WARPS_N_;
  static constexpr bool TMA_B = TMA_B_;
  // the ring, then (TMA_B) the stages' mbarriers and room to align the
  // ring to 1024 bytes
  static constexpr int smem(int npiece) {
    return STAGES * (npiece * BM + BN) * BK * 2 + (TMA_B ? 1024 + 8 * STAGES
                                                          : 0);
  }
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; bytes past `src_bytes` are zero-filled
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// a barrier whose phase completes on `count` arrivals (and, where a copy
// expects bytes, when they have landed)
__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count = 1) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}


// the one arrival of a stage's barrier, expecting `bytes` from the copy
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar), "r"(bytes)
               : "memory");
}

// until the barrier's phase `parity` has completed; a copy that never
// lands traps (the launch fails and the wrapper raises) instead of hanging
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  const long long t0 = clock64();
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (!done && clock64() - t0 > (1LL << 32)) __trap();
  }
}

// mbar_wait for the wgmma consumers: every lane polls and the warp leaves
// the loop together (a vote), with the same trap after 2^32 cycles. With
// mbar_wait's per-lane exit here, and the arrive below in a branch, the
// large tile ran a layer's GEMMs three times slower on the H100.
__device__ __forceinline__ void mbar_wait_wg(uint32_t bar, uint32_t parity) {
  const long long t0 = clock64();
  for (;;) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (__all_sync(0xffffffff, done)) break;
    if (__any_sync(0xffffffff, clock64() - t0 > (1LL << 32))) __trap();
  }
}

// an arrival where `pred` holds, predicated inside the asm: no branch
// between the consumers' wgmma (see mbar_wait_wg)
__device__ __forceinline__ void mbar_arrive_if(uint32_t bar, bool pred) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.u32 p, %1, 0;\n"
      "@p mbarrier.arrive.shared::cta.b64 _, [%0];\n}\n" ::"r"(bar),
      "r"(static_cast<uint32_t>(pred))
      : "memory");
}

// a (c1, c0)-cornered box of a 2-D tensor map into shared memory, counted
// against `bar`
__device__ __forceinline__ void tma_load_2d(uint32_t dst,
                                            const CUtensorMap* map, int c0,
                                            int c1, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// d += a . b, m16n8k16, bf16 operands, fp32 accumulate
__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// A wgmma shared-memory descriptor of a tile stored in 128-byte rows with
// the 128-byte swizzle (chunk c of row r at c ^ (r & 7), the tile
// 1024-byte aligned, so the base offset is 0): the start address, the
// leading byte offset (an M- or N-contiguous tile: between its 64-element
// column blocks; a K-contiguous one does not read it) and the stride byte
// offset (between groups of 8 rows: 1024), each in 16-byte units; the
// swizzle mode 1 (128 bytes) in bits 62-63.
__device__ __forceinline__ uint64_t wg_desc(uint32_t addr, uint32_t lbo,
                                            uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         static_cast<uint64_t>((lbo & 0x3FFFF) >> 4) << 16 |
         static_cast<uint64_t>((sbo & 0x3FFFF) >> 4) << 32 | 1ull << 62;
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// until at most N of this warpgroup's committed wgmma groups are pending
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// A fragment that an asynchronous wgmma wrote is read only after the wait
// that covers it: the empty asm "writes" each register here, so the
// compiler cannot move a read of it above this point.
__device__ __forceinline__ void fence_regs(float (&r)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// d = a . b for one k16 step of a warpgroup: wgmma m64n128k16, bf16
// operands read from shared memory through their descriptors, fp32 out,
// scale-d = 0 (the step is summed from zero; d's old values are not
// read). TA, TB: the transpose bits (1: an M- or N-contiguous tile).
// d[i] is output (16 * warp + g + 8 * ((i >> 1) & 1), 8 * (i >> 2) + 2q +
// (i & 1)) of the warpgroup's 64 x 128, mma.sync's fragment layout
// repeated over 16 column blocks.
template <int TA, int TB>
__device__ __forceinline__ void wgmma_k16(float (&d)[64], uint64_t da,
                                          uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, "
      "%43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, "
      "%57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, %67, %68;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(0), "n"(TA), "n"(TB));
}

// Byte offset of 16-byte chunk `c` of row `r` in a staged tile of ROW-byte
// rows: K-contiguous tiles ([rows][BK] bf16) have BK * 2-byte rows,
// row-contiguous ones ([BK][W] bf16) W * 2. The chunk is XORed with the
// row's index among the rows that share a 128-byte bank line's chunk
// slots (c ^ (r & 7) for rows of 128 bytes or more, c ^ ((r >> 1) & 3) for
// 64, c ^ ((r >> 2) & 1) for 32), so the 8 rows an ldmatrix phase reads
// fill all 8 16-byte slots of a bank line.
template <int ROW>
__device__ __forceinline__ int swz_off(int r, int c) {
  constexpr int kXor = ROW / 16 < 8 ? ROW / 16 : 8;  // chunk slots permuted
  constexpr int kLine = 8 / kXor;                    // rows a bank line
  return r * ROW + ((c ^ ((r / kLine) % kXor)) << 4);
}

template <bool KCONT, int W, int BK>
__device__ __forceinline__ int tile_off(int r, int c) {
  return swz_off<KCONT ? BK * 2 : W * 2>(r, c);
}

struct TcEpilogue {
  const float* bias;       // null, or indexed by the output column (or row)
  float* out;              // element (m, n) at m * ldo_m + n * ldo_n
  float* raw;              // null, or the chain before the scale, same layout
  float scale;
  const float* scale_dev;  // one value on the card, or null
  long long ldo_m, ldo_n;
  int act, approx, bias_on_m;
};

// The epilogue of outputs (m, n) and (m, n + 1) from their chains v0, v1:
// the approx truncation, the raw store, x scale, + bias, act, one fp32
// store each; a float2 store where the output is row-major with an even
// leading dimension, else one by one, n + 1 skipped past N.
__device__ __forceinline__ void store_pair(const TcEpilogue& epi, float scale,
                                           bool pair, int m, int n, int N,
                                           float v0, float v1) {
  float v[2] = {v0, v1};
#pragma unroll
  for (int e = 0; e < 2; ++e)
    if (epi.approx) v[e] = truncate3(v[e]);
  const size_t o = (size_t)m * epi.ldo_m + (size_t)n * epi.ldo_n;
  if (pair && n + 1 < N) {
    if (epi.raw != nullptr)
      *reinterpret_cast<float2*>(epi.raw + o) = make_float2(v[0], v[1]);
    float y[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      y[e] = v[e] * scale;
      if (epi.bias != nullptr) y[e] += epi.bias[epi.bias_on_m ? m : n + e];
      y[e] = act_apply(y[e], epi.act);
    }
    *reinterpret_cast<float2*>(epi.out + o) = make_float2(y[0], y[1]);
    return;
  }
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    if (n + e >= N) continue;
    const size_t oe = o + e * epi.ldo_n;
    if (epi.raw != nullptr) epi.raw[oe] = v[e];
    float y = v[e] * scale;
    if (epi.bias != nullptr) y += epi.bias[epi.bias_on_m ? m : n + e];
    epi.out[oe] = act_apply(y, epi.act);
  }
}

// C (M, N) = sum over pieces p of A_p (M, K) . B (K, N), fp32 accumulators,
// then the fused epilogue. A_p is bf16 plane p of A (NPIECE = 3: the hi,
// mid, lo split of an fp32 operand, planes `a_plane` elements apart), read
// at a[m * lda + k] (A_KCONT) or a[k * lda + m]; B at b[n * ldb + k]
// (B_KCONT) or b[k * ldb + n]. Every pointer and leading dimension is 16-byte
// aligned (the wrapper's check). A block owns BM x BN outputs, its WARPS_M x
// WARPS_N warps (BM / WARPS_M) x (BN / WARPS_N) each; each output's
// products are accumulated by one
// thread in k16 steps k = 0, 16, ..., in order, and the pieces of a step
// hi, mid, lo: the order does not depend on M, N or the tile.
// At most 128 registers a thread, so two 8-warp (or four 4-warp) blocks
// share an SM: on the card the step sums' extra registers otherwise left
// one block an SM and cost more than the few bytes of spill this takes.
template <class Tile, int NPIECE, bool A_KCONT, bool B_KCONT>
__global__ void __launch_bounds__(Tile::THREADS, 512 / Tile::THREADS)
sa_gemm_mma(const __nv_bfloat16* __restrict__ a, long long a_plane, int lda,
            const __nv_bfloat16* __restrict__ b, int ldb, TcEpilogue epi,
            int M, int N, int K, const __grid_constant__ CUtensorMap tmap_b) {
  constexpr int BM = Tile::BM, BN = Tile::BN, kTcBK = Tile::BK;
  constexpr int kTcStages = Tile::STAGES, kTcThreads = Tile::THREADS;
  constexpr int WM = BM / Tile::WARPS_M, WN = BN / Tile::WARPS_N;  // a warp
  constexpr int MT = WM / 16, NT = WN / 8;  // m16 and n8 tiles a warp
  constexpr int kATile = BM * kTcBK * 2;    // bytes of one A plane's stage
  constexpr int kBTile = BN * kTcBK * 2;
  constexpr int kStage = NPIECE * kATile + kBTile;
  // B's fragments come two n8 tiles an ldmatrix; a row-contiguous tile row
  // holds at least the two 16-byte chunks an ldmatrix phase reads
  static_assert(NT % 2 == 0 && BM % 16 == 0 && BN % 16 == 0, "tile");
  static_assert((BM * kTcBK / 8) % kTcThreads == 0 &&
                    (BN * kTcBK / 8) % kTcThreads == 0,
                "whole chunks a thread");
  // TMA takes B as stored (K, N) (the weights); a K-contiguous view (Wᵀ)
  // keeps cp.async, whose tile rows may be wider than TMA's swizzle
  constexpr bool kTmaB = Tile::TMA_B && !B_KCONT;
  extern __shared__ __align__(128) unsigned char smem[];
  // TMA's swizzle follows the address bits: its ring starts 1024-aligned
  const uint32_t smem0 =
      kTmaB ? (smem_u32(smem) + 1023) & ~1023u : smem_u32(smem);
  const uint32_t bar0 = smem0 + kTcStages * kStage;  // kTmaB: the barriers

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int wm = warp / Tile::WARPS_N, wn = warp % Tile::WARPS_N;
  const int g = lane >> 2, q = lane & 3;
  const int mi = lane >> 3, r8 = lane & 7;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int nk = (K + kTcBK - 1) / kTcBK;
  if constexpr (kTmaB) {
    if (tid == 0) {
      for (int s = 0; s < kTcStages; ++s) mbar_init(bar0 + 8 * s);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
  }

  // one stage: every plane of A's tile and B's tile, 16-byte chunks
  auto load_stage = [&](int slot, int kt) {
    const int k0 = kt * kTcBK;
    const uint32_t base = smem0 + slot * kStage;
#pragma unroll
    for (int p = 0; p < NPIECE; ++p) {
      const __nv_bfloat16* ap = a + p * a_plane;
      constexpr int kChunks = BM * kTcBK / 8;
#pragma unroll
      for (int it = 0; it < kChunks / kTcThreads; ++it) {
        const int i = it * kTcThreads + tid;
        int r, c, bytes;
        const __nv_bfloat16* src;
        if constexpr (A_KCONT) {  // rows m, BK / 8 chunks of k
          r = i / (kTcBK / 8);
          c = i % (kTcBK / 8);
          const int m = m0 + r, k = k0 + c * 8;
          bytes = m < M ? max(0, min(16, (K - k) * 2)) : 0;
          src = bytes ? ap + (size_t)m * lda + k : ap;
        } else {                  // rows k, BM / 8 chunks of m
          r = i / (BM / 8);
          c = i % (BM / 8);
          const int k = k0 + r, m = m0 + c * 8;
          bytes = k < K ? max(0, min(16, (M - m) * 2)) : 0;
          src = bytes ? ap + (size_t)k * lda + m : ap;
        }
        cp_async16(base + p * kATile + tile_off<A_KCONT, BM, kTcBK>(r, c), src,
                   bytes);
      }
    }
    if constexpr (kTmaB) {
      // B's whole stage in one bulk copy: the box at (k0, n0), zero past K
      // and N as the cp.async path fills it
      if (tid == 0) {
        const uint32_t bar = bar0 + 8 * slot;
        mbar_expect_tx(bar, kBTile);
        tma_load_2d(base + NPIECE * kATile, &tmap_b, n0, k0, bar);
      }
    } else {
      constexpr int kChunks = BN * kTcBK / 8;
#pragma unroll
      for (int it = 0; it < kChunks / kTcThreads; ++it) {
        const int i = it * kTcThreads + tid;
        int r, c, bytes;
        const __nv_bfloat16* src;
        if constexpr (B_KCONT) {  // rows n, BK / 8 chunks of k
          r = i / (kTcBK / 8);
          c = i % (kTcBK / 8);
          const int n = n0 + r, k = k0 + c * 8;
          bytes = n < N ? max(0, min(16, (K - k) * 2)) : 0;
          src = bytes ? b + (size_t)n * ldb + k : b;
        } else {                  // rows k, BN / 8 chunks of n
          r = i / (BN / 8);
          c = i % (BN / 8);
          const int k = k0 + r, n = n0 + c * 8;
          bytes = k < K ? max(0, min(16, (N - n) * 2)) : 0;
          src = bytes ? b + (size_t)k * ldb + n : b;
        }
        cp_async16(base + NPIECE * kATile + tile_off<B_KCONT, BN, kTcBK>(r, c),
                   src, bytes);
      }
    }
  };

  float acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

#pragma unroll
  for (int s = 0; s < kTcStages - 1; ++s) {
    if (s < nk) load_stage(s, s);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<kTcStages - 2>();
    if constexpr (kTmaB)
      mbar_wait(bar0 + 8 * (kt % kTcStages), (kt / kTcStages) & 1);
    // stage kt has landed for every thread; every warp is done with stage
    // kt - 1, whose slot the next load reuses
    __syncthreads();
    const int nxt = kt + kTcStages - 1;
    if constexpr (kTmaB) {
      // the slot's generic-proxy reads (ldmatrix) before the bulk copy
      // overwrites it
      if (tid == 0)
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    }
    if (nxt < nk) load_stage(nxt % kTcStages, nxt);
    cp_async_commit();

    const uint32_t base = smem0 + (kt % kTcStages) * kStage;
    const uint32_t b_base = base + NPIECE * kATile;
#pragma unroll
    for (int kk = 0; kk < kTcBK; kk += 16) {
      // B's fragments once, reused by every piece and row tile
      uint32_t bf[NT][2];
#pragma unroll
      for (int j = 0; j < NT; j += 2) {
        uint32_t r[4];
        const int nb = wn * WN + j * 8;
        if constexpr (B_KCONT) {
          ldsm_x4(b_base + tile_off<true, BN, kTcBK>(nb + (mi >> 1) * 8 + r8,
                                                      kk / 8 + (mi & 1)),
                  r);
        } else {
          ldsm_x4_t(b_base + tile_off<false, BN, kTcBK>(kk + (mi & 1) * 8 + r8,
                                                         nb / 8 + (mi >> 1)),
                    r);
        }
        bf[j][0] = r[0];
        bf[j][1] = r[1];
        bf[j + 1][0] = r[2];
        bf[j + 1][1] = r[3];
      }
      // a k16 step's products (every piece) are summed by the tensor cores
      // from zero and the step's sum added to the accumulator in fp32
      // (round to nearest): their truncation acts on one step's terms, not
      // on the running sum
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        const int mb = wm * WM + i * 16;
        uint32_t af[NPIECE][4];  // lo, mid, hi: the smallest summed first
#pragma unroll
        for (int p = 0; p < NPIECE; ++p) {
          const uint32_t a_base = base + (NPIECE - 1 - p) * kATile;
          if constexpr (A_KCONT) {
            ldsm_x4(a_base + tile_off<true, BM, kTcBK>(mb + (mi & 1) * 8 + r8,
                                                        kk / 8 + (mi >> 1)),
                    af[p]);
          } else {
            ldsm_x4_t(a_base + tile_off<false, BM, kTcBK>(
                                   kk + (mi >> 1) * 8 + r8, mb / 8 + (mi & 1)),
                      af[p]);
          }
        }
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          float t[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
          for (int p = 0; p < NPIECE; ++p)
            mma16816(t, af[p], bf[j][0], bf[j][1]);
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[i][j][e] += t[e];
        }
      }
    }
  }
  cp_async_wait<0>();

  // the epilogue on the accumulator fragments: c0, c1 at (g, 2q, 2q + 1),
  // c2, c3 eight rows below
  const float scale = epi.scale_dev != nullptr ? epi.scale_dev[0] : epi.scale;
  const bool pair = epi.ldo_n == 1 && (epi.ldo_m & 1) == 0;
#pragma unroll
  for (int i = 0; i < MT; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + wm * WM + i * 16 + g + h * 8;
      if (m >= M) continue;
#pragma unroll
      for (int j = 0; j < NT; ++j)
        store_pair(epi, scale, pair, m, n0 + wn * WN + j * 8 + 2 * q, N,
                   acc[i][j][2 * h], acc[i][j][2 * h + 1]);
    }
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, fetched through the runtime's entry-point query
// (no libcuda link)
static_assert(CUDART_VERSION >= 12050,
              "cudaGetDriverEntryPointByVersion needs CUDA 12.5 or later");
EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
    return e == cudaSuccess && q == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// A bf16 matrix of `outer` rows of `inner` elements, rows ld elements
// apart, as a 2-D tensor map whose box is box_outer rows x box_inner. The
// swizzle is the box row's width (32, 64 or 128 bytes), which is
// tile_off's layout and, at 128 bytes, wgmma's. A box past the matrix's
// edge lands zero-filled.
cudaError_t tensor_map_2d(CUtensorMap* map, const void* p, int inner,
                          int outer, int ld, int box_inner, int box_outer) {
  const int row = box_inner * 2;  // bytes
  if (row != 32 && row != 64 && row != 128) return cudaErrorInvalidValue;
  const EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(inner),
                              static_cast<cuuint64_t>(outer)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(ld) * 2};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(box_inner),
                             static_cast<cuuint32_t>(box_outer)};
  const cuuint32_t elem[2] = {1, 1};
  const CUtensorMapSwizzle swz = row == 128  ? CU_TENSOR_MAP_SWIZZLE_128B
                                 : row == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                             : CU_TENSOR_MAP_SWIZZLE_32B;
  const CUresult r = enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                         const_cast<void*>(p), dims, strides, box, elem,
                         CU_TENSOR_MAP_INTERLEAVE_NONE, swz,
                         CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// B (K, N) bf16 stored as (K, N) rows of ldb elements, as a 2-D tensor map
// whose box is one stage's tile, BK rows x BN.
template <class Tile>
cudaError_t b_tensor_map(CUtensorMap* map, const void* b, int ldb, int N,
                         int K) {
  return tensor_map_2d(map, b, N, K, ldb, Tile::BN, Tile::BK);
}

template <class Tile, int NPIECE, bool AK, bool BK_>
cudaError_t launch_mma(const void* a, long long a_plane, int lda,
                       const void* b, int ldb, const TcEpilogue& epi, int M,
                       int N, int K, cudaStream_t st) {
  auto kern = sa_gemm_mma<Tile, NPIECE, AK, BK_>;
  const int smem = Tile::smem(NPIECE);
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  CUtensorMap map{};  // read by TMA tiles' B as stored only
  if constexpr (Tile::TMA_B && !BK_) {
    e = b_tensor_map<Tile>(&map, b, ldb, N, K);
    if (e != cudaSuccess) return e;
  }
  dim3 grid((N + Tile::BN - 1) / Tile::BN, (M + Tile::BM - 1) / Tile::BM);
  kern<<<grid, Tile::THREADS, smem, st>>>(
      static_cast<const __nv_bfloat16*>(a), a_plane, lda,
      static_cast<const __nv_bfloat16*>(b), ldb, epi, M, N, K, map);
  return cudaGetLastError();
}

template <class Tile, int NPIECE>
cudaError_t launch_mma_layout(int a_kcont, int b_kcont, const void* a,
                              long long a_plane, int lda, const void* b,
                              int ldb, const TcEpilogue& epi, int M, int N,
                              int K, cudaStream_t st) {
  if (a_kcont && b_kcont)
    return launch_mma<Tile, NPIECE, true, true>(a, a_plane, lda, b, ldb, epi,
                                                M, N, K, st);
  if (a_kcont)
    return launch_mma<Tile, NPIECE, true, false>(a, a_plane, lda, b, ldb, epi,
                                                 M, N, K, st);
  if (b_kcont)
    return launch_mma<Tile, NPIECE, false, true>(a, a_plane, lda, b, ldb, epi,
                                                 M, N, K, st);
  return launch_mma<Tile, NPIECE, false, false>(a, a_plane, lda, b, ldb, epi,
                                                M, N, K, st);
}

// ---------------------------------------------------------------------------
// TileLarge: the forward's large tile on wgmma (bf16 x bf16, sa_gemm_wgmma)
// ---------------------------------------------------------------------------
//
// It computes what sa_gemm_mma computes, bit for bit: each output's k16
// steps in order k = 0, 16, ..., each step's 16 products summed by the
// tensor cores from zero, the step's sum added to the fp32 accumulator with
// one rounding to nearest (acc + t, as sa_gemm_mma's `acc += t`). K is never
// split, so the rows fold as every other tile's do (ROADMAP F2). That
// wgmma's k16 sum from zero carries mma.sync's bits is not given by the
// hardware's documentation: sa_k16_probe below tests it (chip_smoke's probe
// phase, 0 mismatches).
//
// Bound, a layer's 7 forward GEMMs at M = 1024 (2 M sum(N) K = 563.7
// GFLOP): the tensor cores, 0.570 ms at 989 TFLOP/s, and the step sums'
// adds, one FADD an output a k16 step, M sum(N) K / 16 = 17.6 G, 0.527 ms
// at 132 SMs x 128 lanes x 1.98 GHz; the two are nearly equal, so the
// design overlaps them. wgmma reads both operands from shared memory: no
// ldmatrix, and the issue slots that mma.sync spent on fragments and on
// one mma a 16 x 8 block go to the adds.
//
// A block owns 128 x 128 outputs. One producer warpgroup (one thread of it
// issuing) keeps TMA copies of A's and W's 64-deep K tiles in flight into
// a ring of STAGES stages, each with a full mbarrier (the copy's bytes) and
// an empty one (one arrival a consumer warp). Tiles are stored in 128-byte
// rows with the 128-byte swizzle that both the copy and wgmma's
// descriptors use: a K-contiguous operand (A as (M, K), W as Wᵀ) as one
// box of 128 rows of 64 K values, an M- or N-contiguous one (A as (K, M),
// W as stored (K, N)) as two boxes of 64 K rows of 64 columns, read with
// wgmma's transpose bit. Boxes past M, N and K land zero-filled, as
// cp.async fills them in sa_gemm_mma, so a ragged edge sums the same zero
// products. Two consumer warpgroups own 64 x 128 outputs each: for step s
// a warpgroup issues wgmma m64n128k16 with scale-d = 0 into one of two
// step fragments, waits until only that wgmma is pending (the step s - 1
// wgmma is done), and adds step s - 1's fragment into the accumulator while
// the tensor cores run step s; the other warpgroup's steps interleave with
// these. setmaxnreg moves registers from the producer (40 a thread) to the
// consumers (232: 64 accumulators and 2 x 64 step sums). The epilogue
// runs on wgmma's fragment layout (store_pair), the ragged edge masked.
struct TileLarge {
  static constexpr int BM = 128, BN = 128, BK = 64, STAGES = 6;
  static constexpr int CONSUMERS = 2;                 // warpgroups
  static constexpr int THREADS = 128 * (CONSUMERS + 1);
  static constexpr int A_BYTES = BM * BK * 2, B_BYTES = BN * BK * 2;
  static constexpr int STAGE = A_BYTES + B_BYTES;
  static constexpr int BOX = 64 * BK * 2;  // a 64-column box of K rows
  // the ring, its full and empty mbarriers, room to align it to 1024
  static constexpr int smem() { return STAGES * STAGE + 16 * STAGES + 1024; }
};

template <bool A_KCONT, bool B_KCONT>
__global__ void __launch_bounds__(TileLarge::THREADS, 1)
sa_gemm_wgmma(TcEpilogue epi, int M, int N, int K,
              const __grid_constant__ CUtensorMap tmap_a,
              const __grid_constant__ CUtensorMap tmap_b) {
  using T = TileLarge;
  static_assert(T::BK == 64, "4 k16 steps a stage: the step fragments "
                             "alternate within a stage");
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t ring = (smem_u32(smem) + 1023) & ~1023u;
  const uint32_t full0 = ring + T::STAGES * T::STAGE;
  const uint32_t empty0 = full0 + 8 * T::STAGES;
  const int nk = (K + T::BK - 1) / T::BK;
  // the warpgroup, broadcast from lane 0 so the compiler knows the role
  // branch warp-uniform
  const int wg = __shfl_sync(0xffffffff, threadIdx.x / 128, 0);
  // blocks in column-strip order: the row blocks of one 128-column strip
  // of W are consecutive, so they run together and W streams from memory
  // once (A, 10-28 MB at M = 1024, stays in L2); in the grid's own order
  // each row block would stream all of W
  const int bid = blockIdx.y * gridDim.x + blockIdx.x;
  const int m0 = (bid % gridDim.y) * T::BM, n0 = (bid / gridDim.y) * T::BN;
  if (threadIdx.x == 0) {
    for (int s = 0; s < T::STAGES; ++s) {
      mbar_init(full0 + 8 * s);
      mbar_init(empty0 + 8 * s, 4 * T::CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == T::CONSUMERS) {  // the producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x % 128 == 0) {
      for (int kt = 0; kt < nk; ++kt) {
        const int s = kt % T::STAGES;
        // the slot's previous round has been read (the first round's wait
        // passes at once)
        mbar_wait(empty0 + 8 * s, ((kt / T::STAGES) & 1) ^ 1);
        const uint32_t bar = full0 + 8 * s;
        const uint32_t a_st = ring + s * T::STAGE, b_st = a_st + T::A_BYTES;
        const int k0 = kt * T::BK;
        mbar_expect_tx(bar, T::STAGE);
        if constexpr (A_KCONT) {
          tma_load_2d(a_st, &tmap_a, k0, m0, bar);
        } else {
          tma_load_2d(a_st, &tmap_a, m0, k0, bar);
          tma_load_2d(a_st + T::BOX, &tmap_a, m0 + 64, k0, bar);
        }
        if constexpr (B_KCONT) {
          tma_load_2d(b_st, &tmap_b, k0, n0, bar);
        } else {
          tma_load_2d(b_st, &tmap_b, n0, k0, bar);
          tma_load_2d(b_st + T::BOX, &tmap_b, n0 + 64, k0, bar);
        }
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  const int tid = threadIdx.x % 128, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, q = lane & 3;
  // the descriptors of stage 0's first step: this warpgroup's 64 rows of
  // A's tile and all of B's. A step or a stage moves only the start
  // address (its low 14 bits, in 16 bytes: no carry out of them, shared
  // memory being under 256 KB): a k16 step is 32 bytes along a
  // K-contiguous row or 16 rows down a column box.
  const uint64_t da0 = wg_desc(ring + (A_KCONT ? wg * 64 * 128 : wg * T::BOX),
                               A_KCONT ? 16 : T::BOX, 1024);
  const uint64_t db0 = wg_desc(ring + T::A_BYTES, B_KCONT ? 16 : T::BOX,
                               1024);
  constexpr uint64_t kAStep = (A_KCONT ? 32 : 16 * 128) >> 4;
  constexpr uint64_t kBStep = (B_KCONT ? 32 : 16 * 128) >> 4;
  float acc[64], t0[64], t1[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = t0[i] = t1[i] = 0.f;

  // step kk of the stage `so` (its offset, in 16 bytes) into t; then step
  // kk - 1's sum u (the wait leaves only this step's wgmma pending) into
  // the accumulator. The first step adds t1's initial +0 to +0: +0, as no
  // add.
  auto step = [&](uint64_t so, int kk, float(&t)[64], float(&u)[64]) {
    wg_fence();
    wgmma_k16<A_KCONT ? 0 : 1, B_KCONT ? 0 : 1>(t, da0 + so + kk * kAStep,
                                                db0 + so + kk * kBStep);
    wg_commit();
    wg_wait<1>();
    fence_regs(u);
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = __fadd_rn(acc[i], u[i]);
  };
  int s = 0, prev = T::STAGES - 1;
  uint32_t phase = 0;
  for (int kt = 0; kt < nk; ++kt) {
    mbar_wait_wg(full0 + 8 * s, phase);
    const uint64_t so = static_cast<uint64_t>(s * T::STAGE) >> 4;
    step(so, 0, t0, t1);
    // the previous stage's last wgmma is done: each warp frees its slot
    mbar_arrive_if(empty0 + 8 * prev, kt > 0 && lane == 0);
    step(so, 1, t1, t0);
    step(so, 2, t0, t1);
    step(so, 3, t1, t0);
    prev = s;
    if (++s == T::STAGES) {
      s = 0;
      phase ^= 1;
    }
  }
  // the last step's sum (for an empty K, t1's +0: the sum of nothing is
  // +0). The wait is unconditional: one that only some paths take leaves
  // the compiler a wait of its own to insert in a divergent path, and then
  // it serializes every wgmma.
  wg_wait<0>();
  fence_regs(t1);
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = __fadd_rn(acc[i], t1[i]);

  const float scale = epi.scale_dev != nullptr ? epi.scale_dev[0] : epi.scale;
  const bool pair = epi.ldo_n == 1 && (epi.ldo_m & 1) == 0;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int m = m0 + wg * 64 + warp * 16 + g + 8 * h;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 16; ++j)
      store_pair(epi, scale, pair, m, n0 + 8 * j + 2 * q, N,
                 acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
  }
}

template <bool AK, bool BK_>
cudaError_t launch_wgmma(const void* a, int lda, const void* b, int ldb,
                         const TcEpilogue& epi, int M, int N, int K,
                         cudaStream_t st) {
  using T = TileLarge;
  auto kern = sa_gemm_wgmma<AK, BK_>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, T::smem());
  if (e != cudaSuccess) return e;
  // a map's extents are at least 1 (K = 0 loads nothing: the sum of
  // nothing, +0)
  const int k = std::max(K, 1);
  CUtensorMap ma{}, mb{};
  e = AK ? tensor_map_2d(&ma, a, k, M, lda, T::BK, T::BM)
         : tensor_map_2d(&ma, a, M, k, lda, 64, T::BK);
  if (e != cudaSuccess) return e;
  e = BK_ ? tensor_map_2d(&mb, b, k, N, ldb, T::BK, T::BN)
          : tensor_map_2d(&mb, b, N, k, ldb, 64, T::BK);
  if (e != cudaSuccess) return e;
  dim3 grid((N + T::BN - 1) / T::BN, (M + T::BM - 1) / T::BM);
  kern<<<grid, T::THREADS, T::smem(), st>>>(epi, M, N, K, ma, mb);
  return cudaGetLastError();
}

cudaError_t launch_wgmma_layout(int a_kcont, int b_kcont, const void* a,
                                int lda, const void* b, int ldb,
                                const TcEpilogue& epi, int M, int N, int K,
                                cudaStream_t st) {
  if (a_kcont && b_kcont)
    return launch_wgmma<true, true>(a, lda, b, ldb, epi, M, N, K, st);
  if (a_kcont)
    return launch_wgmma<true, false>(a, lda, b, ldb, epi, M, N, K, st);
  if (b_kcont)
    return launch_wgmma<false, true>(a, lda, b, ldb, epi, M, N, K, st);
  return launch_wgmma<false, false>(a, lda, b, ldb, epi, M, N, K, st);
}

__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat16 lo,
                                              __nv_bfloat16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16;
}

// The k16 probe: step s's 16 products of A_s (64 x 16, K-contiguous) and
// B_s (16 x 128, N-contiguous), summed from zero two ways and both written
// out (steps, 64, 128) fp32, for a bit-for-bit comparison: by
// mma.sync.m16n8k16 with C = 0, as sa_gemm_mma sums a step (fragments
// loaded from global memory), and by wgmma m64n128k16 with scale-d = 0 on
// the same data staged in shared memory in the 128-byte swizzle, read
// through wgmma_k16 and wg_desc as sa_gemm_wgmma reads W as stored (two
// 64-column boxes). A block a step, one warpgroup.
__global__ void __launch_bounds__(128)
sa_k16_probe(const __nv_bfloat16* __restrict__ a,
             const __nv_bfloat16* __restrict__ b, float* __restrict__ out_mma,
             float* __restrict__ out_wg) {
  constexpr int kBBox = 16 * 128;   // bytes of a 64-column box of 16 K rows
  __shared__ __align__(1024) unsigned char sm[64 * 128 + 2 * kBBox];
  const int s = blockIdx.x, tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, q = lane & 3;
  const __nv_bfloat16* as = a + (size_t)s * 64 * 16;
  const __nv_bfloat16* bs = b + (size_t)s * 16 * 128;
  // A: row r's two 16-byte chunks c at c ^ (r & 7) of its 128-byte row;
  // B: K row k of box h (columns 64h..64h + 63), chunk c at c ^ (k & 7)
  for (int i = tid; i < 64 * 2; i += 128) {
    const int r = i >> 1, c = i & 1;
    *reinterpret_cast<uint4*>(sm + r * 128 + ((c ^ (r & 7)) << 4)) =
        *reinterpret_cast<const uint4*>(as + r * 16 + c * 8);
  }
  for (int i = tid; i < 16 * 16; i += 128) {
    const int k = i >> 4, cn = i & 15, h = cn >> 3, c = cn & 7;
    *reinterpret_cast<uint4*>(sm + 64 * 128 + h * kBBox + k * 128 +
                              ((c ^ (k & 7)) << 4)) =
        *reinterpret_cast<const uint4*>(bs + k * 128 + cn * 8);
  }
  // the generic-proxy stores, visible to wgmma's reads
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
  float d[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) d[i] = 0.f;
  const uint32_t sa = smem_u32(sm);
  wg_fence();
  wgmma_k16<0, 1>(d, wg_desc(sa, 16, 1024), wg_desc(sa + 64 * 128, kBBox,
                                                    1024));
  wg_commit();
  wg_wait<0>();
  fence_regs(d);

  const int r0 = warp * 16 + g;
  auto pa = [&](int r, int k) {
    return pack_bf16(as[r * 16 + k], as[r * 16 + k + 1]);
  };
  const uint32_t af[4] = {pa(r0, 2 * q), pa(r0 + 8, 2 * q), pa(r0, 2 * q + 8),
                          pa(r0 + 8, 2 * q + 8)};
  float* om = out_mma + (size_t)s * 64 * 128;
  float* ow = out_wg + (size_t)s * 64 * 128;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int n = 8 * j + g;
    const uint32_t b0 = pack_bf16(bs[2 * q * 128 + n], bs[(2 * q + 1) * 128 + n]);
    const uint32_t b1 =
        pack_bf16(bs[(2 * q + 8) * 128 + n], bs[(2 * q + 9) * 128 + n]);
    float t[4] = {0.f, 0.f, 0.f, 0.f};
    mma16816(t, af, b0, b1);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const size_t o = (size_t)(r0 + 8 * (e >> 1)) * 128 + 8 * j + 2 * q + (e & 1);
      om[o] = t[e];
      ow[o] = d[4 * j + e];
    }
  }
}

// The mma.sync tiles the wrapper's `mma_plan` chooses from beside
// TileLarge (sweeps on the H100 chose them; PERF.md): below where the
// large tile pays, 4 warps of 32 x 32 over 64 x 64; the
// split's three A pieces take 8 warps of 32 x 64 over 128 x 128, 32-deep
// stages three deep, so two 96 KB blocks share an SM.
//
// TileDecode, M <= 16: one m16 row of A (zero-filled past M) and four warps
// of 16 columns over 64, 128-deep stages six deep, W by TMA (123 KB a
// block, one an SM). Decode is bound by W's bytes, and K is never split, so
// a GEMM's parallelism is its N / BN column strips, each streamed through
// one SM. Sweeps on the H100 (PERF.md §6) found a strip's pace set by
// the number of W row segments its SM fetches, not by their bytes, the
// ring's depth or the products: cp.async reached ~14 GB/s a block with
// 64-byte rows and ~23 GB/s with 128-byte ones whatever the depth; TMA, one
// bulk copy a stage, and 128-deep stages (half the waits) raised that, and
// 128-byte rows (BN = 64, the widest TMA swizzles) halve the segments a
// byte. So: 16 strips for wk and wv, 80 for wq, wo and wd, 216 for gate
// and up, 2400 for the lm_head. A is restaged from L2 with every stage
// (its rows, 40-110 KB, would not fit beside the ring).
using TileSmall = TcTile<64, 64, 2, 2, 64, 3>;
using TileSplit = TcTile<128, 128, 4, 2, 32, 3>;
using TileDecode = TcTile<16, 64, 1, 4, 128, 6, true>;

// hi = bf16_rn(x), mid = bf16_rn(x - hi), lo = bf16_rn(x - hi - mid): both
// differences are exact in fp32, and hi + mid + lo == x exactly wherever
// lo's last bit, 2^(e - 23) for x in [2^e, 2^(e + 1)), is at or above
// bf16's smallest subnormal 2^-133: for |x| >= 2^-110 (and for any x whose
// low bits are zero). A finite x that would round to a bf16 infinity takes
// hi toward zero instead, and the split stays exact; a non-finite x gives
// (x, 0, 0).
__device__ __forceinline__ void split3(float x, __nv_bfloat16& hi,
                                       __nv_bfloat16& mid,
                                       __nv_bfloat16& lo) {
  const __nv_bfloat16 zero = __float2bfloat16_rn(0.f);
  hi = __float2bfloat16_rn(x);
  if (!isfinite(x)) {
    mid = lo = zero;
    return;
  }
  if (isinf(__bfloat162float(hi))) hi = __float2bfloat16_rz(x);
  const float r1 = x - __bfloat162float(hi);
  mid = __float2bfloat16_rn(r1);
  lo = __float2bfloat16_rn(r1 - __bfloat162float(mid));
}

// x: rows x cols fp32 at x[r * ldx + c]; planes: three bf16 (rows, ldp)
// planes, `plane` elements apart, the same layout with leading dim ldp
__global__ void sa_split3(const float* __restrict__ x, int rows, int cols,
                          long long ldx, __nv_bfloat16* __restrict__ planes,
                          long long ldp, long long plane) {
  const size_t total = (size_t)rows * cols;
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < total;
       i += (size_t)gridDim.x * blockDim.x) {
    const size_t r = i / cols, c = i % cols;
    __nv_bfloat16 hi, mid, lo;
    split3(x[r * ldx + c], hi, mid, lo);
    const size_t o = r * ldp + c;
    planes[o] = hi;
    planes[plane + o] = mid;
    planes[2 * plane + o] = lo;
  }
}

}  // namespace

// dtype codes: 0 = fp32, 1 = bf16. tiled = 0 runs sa_gemm_partial (both
// operands row-major with lda = K, ldw = N, at least one fp32: bf16 x bf16
// takes the tensor cores at every M, sa_mma_launch), 1 runs sa_gemm_tiled
// (the simt route: fp32 operands only). K is cut into S slices of kSlice,
// `per_part` slices a part (the wrapper's fp32_k_plan). `ws` holds S (M, N)
// slice sums (partial) or one per part (simt); with one it may be `out`.
extern "C" int sa_matmul_launch(const void* a, int a_dt, int a_kcont, int lda,
                                const void* w, int w_dt, int w_ncont, int ldw,
                                const void* bias, void* ws, void* out,
                                void* raw, float scale, const void* scale_dev,
                                int M, int N, int K, int S, int per_part,
                                int act, int approx, int tiled,
                                void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  Epilogue epi{static_cast<const float*>(bias), static_cast<float*>(out),
               static_cast<float*>(raw), scale,
               static_cast<const float*>(scale_dev), act, approx};
  float* wsf = static_cast<float*>(ws);
  const int combo = a_dt * 2 + w_dt;
  if (S < 1 || per_part < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err;
  int fold_s = S, fold_per = per_part;
  if (tiled) {
    // the simt route: fp32 x fp32 (bf16 operands take the tensor cores,
    // sa_mma_launch)
    if (combo != 0) return static_cast<int>(cudaErrorInvalidValue);
    const int parts = (S + per_part - 1) / per_part;
    err = launch_tiled_layout<float, float>(a, w, a_kcont, w_ncont, lda, ldw,
                                            wsf, epi, M, N, K, parts,
                                            per_part, st);
    if (err != cudaSuccess || parts == 1) return static_cast<int>(err);
    fold_s = parts;   // the workspace holds the parts' sums
    fold_per = 1;
  } else {
    switch (combo) {
      case 0:
        err = launch_partial<float, float>(a, w, wsf, M, N, K, S, st);
        break;
      case 1:
        err = launch_partial<float, __nv_bfloat16>(a, w, wsf, M, N, K, S, st);
        break;
      case 2:
        err = launch_partial<__nv_bfloat16, float>(a, w, wsf, M, N, K, S, st);
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
  sa_gemm_epilogue<<<blocks, threads, 0, st>>>(wsf, epi, M, N, fold_s,
                                               fold_per);
  return static_cast<int>(cudaGetLastError());
}

// The tensor-core routes. npiece 1: bf16 A (mma); 3: A's hi, mid, lo
// planes `a_plane` elements apart (split3). Output (m, n) at m * ldo_m + n *
// ldo_n, the bias indexed by m when bias_on_m (a transposed problem). tile
// (the `code` of sa_matmul.py's MMA_TILES entry): 0 TileLarge (wgmma), 1
// TileSmall, 2 TileDecode (npiece 1), 3 TileSplit (npiece 3). Any other
// pair, an unaligned operand or a tensor map that cuTensorMapEncodeTiled
// refuses returns cudaErrorInvalidValue: the wrapper raises.
extern "C" int sa_mma_launch(const void* a, int npiece, int a_kcont, int lda,
                             long long a_plane, const void* b, int b_kcont,
                             int ldb, const void* bias, int bias_on_m,
                             void* out, void* raw, long long ldo_m,
                             long long ldo_n, float scale,
                             const void* scale_dev, int M, int N, int K,
                             int act, int approx, int tile, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  TcEpilogue epi{static_cast<const float*>(bias), static_cast<float*>(out),
                 static_cast<float*>(raw), scale,
                 static_cast<const float*>(scale_dev), ldo_m, ldo_n, act,
                 approx, bias_on_m};
  if (lda % 8 || ldb % 8 || a_plane % 8 ||
      reinterpret_cast<uintptr_t>(a) % 16 || reinterpret_cast<uintptr_t>(b) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err;
  if (npiece == 1 && tile == 0)
    err = launch_wgmma_layout(a_kcont, b_kcont, a, lda, b, ldb, epi, M, N, K,
                              st);
  else if (npiece == 1 && tile == 1)
    err = launch_mma_layout<TileSmall, 1>(a_kcont, b_kcont, a, a_plane, lda,
                                          b, ldb, epi, M, N, K, st);
  else if (npiece == 1 && tile == 2)
    err = launch_mma_layout<TileDecode, 1>(a_kcont, b_kcont, a, a_plane, lda,
                                           b, ldb, epi, M, N, K, st);
  else if (npiece == 3 && tile == 3)
    err = launch_mma_layout<TileSplit, 3>(a_kcont, b_kcont, a, a_plane, lda,
                                          b, ldb, epi, M, N, K, st);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(err);
}

// a (steps, 64, 16) and b (steps, 16, 128) bf16, contiguous and 16-byte
// aligned -> each step's sums from zero by mma.sync (out_mma) and by wgmma
// (out_wg), (steps, 64, 128) fp32 each
extern "C" int sa_k16_probe_launch(const void* a, const void* b,
                                   void* out_mma, void* out_wg, int steps,
                                   void* stream) {
  if (steps < 1 || reinterpret_cast<uintptr_t>(a) % 16 ||
      reinterpret_cast<uintptr_t>(b) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  sa_k16_probe<<<steps, 128, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(a),
      static_cast<const __nv_bfloat16*>(b), static_cast<float*>(out_mma),
      static_cast<float*>(out_wg));
  return static_cast<int>(cudaGetLastError());
}

// x (rows, cols) fp32 at x[r * ldx + c] -> three bf16 planes (hi, mid, lo)
// of (rows, ldp), `plane` elements apart
extern "C" int sa_split3_launch(const void* x, int rows, int cols,
                                long long ldx, void* planes, long long ldp,
                                long long plane, void* stream) {
  const size_t total = (size_t)rows * cols;
  if (total == 0) return 0;
  const int threads = 256;
  const int blocks =
      static_cast<int>(std::min<size_t>((total + threads - 1) / threads, 8192));
  sa_split3<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), rows, cols, ldx,
      static_cast<__nv_bfloat16*>(planes), ldp, plane);
  return static_cast<int>(cudaGetLastError());
}
