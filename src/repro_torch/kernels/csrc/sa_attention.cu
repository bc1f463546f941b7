// Prefill flash attention for Hopper (sm_90a) under the SA contract.
//
// Replaces the TPU kernel repro/kernels/sa_attention.py `_attn_kernel`, and
// follows the contract of repro/models/layers.py `blockwise_attention`:
//   s   = (cast_in(q) . cast_in(k)) in fp32, x scale, optional softcap
//         cap * tanh(s / cap), causal / window masks (q_pos = q_offset + t);
//   online softmax per query row: running max m, normalizer l (fp32 p),
//   unnormalized accumulator acc = acc * corr + sum_j cast_in(p_j) cast_in(v_j);
//   one normalization acc / max(l, 1e-30) at the end.
// GQA: query head h reads kv head h / (H / KVH).
//
// Design: one block of 4 warps per (16-query tile, head, batch row); each
// warp owns 4 query rows. Key tiles of 32 rows are staged cast-in in shared
// memory (K padded by one column so lane j reading row j hits distinct
// banks); lane j scores key j, the warp reduces max and sum with shuffles,
// and for P.V lane owns output columns lane + 32 i. At prompt lengths of a
// few hundred the kernel is bound by these SIMT fp32 flops (no tensor cores
// yet). Causal tiles past the block's last query are skipped: an all-masked
// tile leaves (m, l, acc) unchanged, so skipping it is exact.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kWarps = 4;
constexpr int kRowsPerWarp = 4;
constexpr int kBQ = kWarps * kRowsPerWarp;  // 16 query rows per block
constexpr int kBK = 32;                      // keys per tile
constexpr int kMaxChunks = 4;                // hd <= 128, lane owns hd / 32

__device__ __forceinline__ float cast_in(float x, int fmt) {
  if (fmt == 1) return __bfloat162float(__float2bfloat16_rn(x));
  if (fmt == 2) return __half2float(__float2half_rn(x));
  return x;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(~0u, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(~0u, v, o);
  return v;
}

__global__ void __launch_bounds__(kWarps * 32)
sa_attention_fwd(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ out, int H,
                 int KVH, int T, int S, int hd, float scale, float cap,
                 int causal, int window, int q_offset, int fmt) {
  extern __shared__ float smem[];
  float* q_s = smem;                      // [kBQ][hd]
  float* k_s = q_s + kBQ * hd;            // [kBK][hd + 1]
  float* v_s = k_s + kBK * (hd + 1);      // [kBK][hd]
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int t0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / KVH);
  const int nchunks = hd / 32;
  const float* qb = q + ((size_t)b * H + h) * T * hd;
  const float* kb = k + ((size_t)b * KVH + kvh) * S * hd;
  const float* vb = v + ((size_t)b * KVH + kvh) * S * hd;

  for (int i = threadIdx.x; i < kBQ * hd; i += blockDim.x) {
    const int r = i / hd, d = i % hd;
    q_s[i] = (t0 + r < T) ? cast_in(qb[(size_t)(t0 + r) * hd + d], fmt) : 0.f;
  }

  float m[kRowsPerWarp], l[kRowsPerWarp], acc[kRowsPerWarp][kMaxChunks];
#pragma unroll
  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    m[rr] = -INFINITY;
    l[rr] = 0.f;
#pragma unroll
    for (int c = 0; c < kMaxChunks; ++c) acc[rr][c] = 0.f;
  }
  // the last query position of this block: later key tiles are all masked
  const int last_q = q_offset + min(T, t0 + kBQ) - 1;

  for (int kv0 = 0; kv0 < S; kv0 += kBK) {
    if (causal && kv0 > last_q) break;
    __syncthreads();
    for (int i = threadIdx.x; i < kBK * hd; i += blockDim.x) {
      const int j = i / hd, d = i % hd;
      const bool in = kv0 + j < S;
      k_s[j * (hd + 1) + d] =
          in ? cast_in(kb[(size_t)(kv0 + j) * hd + d], fmt) : 0.f;
      v_s[j * hd + d] = in ? cast_in(vb[(size_t)(kv0 + j) * hd + d], fmt) : 0.f;
    }
    __syncthreads();
    const int kv = kv0 + lane;
#pragma unroll
    for (int rr = 0; rr < kRowsPerWarp; ++rr) {
      const int r = warp * kRowsPerWarp + rr;
      const float* qr = q_s + r * hd;
      const float* kr = k_s + lane * (hd + 1);
      float dot = 0.f;
      for (int d = 0; d < hd; ++d) dot = fmaf(qr[d], kr[d], dot);
      float s = dot * scale;
      if (cap != 0.f) s = cap * tanhf(s / cap);
      const int qpos = q_offset + t0 + r;
      bool ok = kv < S;
      if (causal) ok = ok && qpos >= kv;
      if (window) ok = ok && qpos - kv < window;
      s = ok ? s : -INFINITY;
      const float m_new = fmaxf(m[rr], warp_max(s));
      const float m_safe = isinf(m_new) ? 0.f : m_new;
      const float p = expf(s - m_safe);
      const float corr = expf(m[rr] - m_safe);
      l[rr] = l[rr] * corr + warp_sum(p);
      m[rr] = m_new;
      const float pq = cast_in(p, fmt);
      float pv[kMaxChunks];
#pragma unroll
      for (int c = 0; c < kMaxChunks; ++c) pv[c] = 0.f;
      for (int j = 0; j < kBK; ++j) {
        const float pj = __shfl_sync(~0u, pq, j);
#pragma unroll
        for (int c = 0; c < kMaxChunks; ++c)
          if (c < nchunks) pv[c] = fmaf(pj, v_s[j * hd + lane + 32 * c], pv[c]);
      }
#pragma unroll
      for (int c = 0; c < kMaxChunks; ++c) acc[rr][c] = acc[rr][c] * corr + pv[c];
    }
  }
#pragma unroll
  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    const int t = t0 + warp * kRowsPerWarp + rr;
    if (t >= T) continue;
    const float denom = fmaxf(l[rr], 1e-30f);
    float* o = out + (((size_t)b * H + h) * T + t) * hd;
#pragma unroll
    for (int c = 0; c < kMaxChunks; ++c)
      if (c < nchunks) o[lane + 32 * c] = acc[rr][c] / denom;
  }
}

}  // namespace

extern "C" int sa_attention_launch(const void* q, const void* k,
                                   const void* v, void* out, int B, int H,
                                   int KVH, int T, int S, int hd, float scale,
                                   float cap, int causal, int window,
                                   int q_offset, int fmt, void* stream) {
  const size_t smem =
      sizeof(float) * ((size_t)kBQ * hd + (size_t)kBK * (hd + 1) +
                       (size_t)kBK * hd);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        sa_attention_fwd, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  dim3 grid((T + kBQ - 1) / kBQ, H, B);
  sa_attention_fwd<<<grid, kWarps * 32, smem,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), H, KVH, T, S,
      hd, scale, cap, causal, window, q_offset, fmt);
  return static_cast<int>(cudaGetLastError());
}
