// Paged decode attention for Hopper (sm_90a) under the SA contract.
//
// Replaces the TPU kernel repro/kernels/sa_decode_attention.py
// `_decode_kernel`, and computes what repro/models/layers.py `gather_pages`
// + `decode_attention` compute, without the gathered dense view:
//   * walk slot b's block-table row; entries with page id <= 0 (unmapped -1
//     and the trash page 0) are masked and never read;
//   * s = cast_in(q) . cast_in(k) in fp32 per query head, then the approx
//     truncation (low 3 mantissa bits, RTZ), then cap * tanh(s * (scale /
//     cap)) or s * scale with the constants folded on the host, then the
//     position mask (0 <= kv_pos <= pos, and kv_pos > pos - window);
//   * deferred softmax with the all-masked guard: m_safe = 0 when the row
//     max is -inf, p = exp(s - m_safe) / max(sum, 1e-30), p cast in;
//   * out = sum_k p_k cast_in(v_k) in fp32, then the approx truncation.
//
// Design: one block of 4 warps per (slot, KV head) serves the g query heads
// that share the KV head, so every K and V row is read once per step. Warps
// take one key each (lanes split hd) and reduce the g dots with shuffles;
// the scores of the g heads stay in shared memory (g * S fp32), so the
// softmax needs no second pass over the pool. That holds while
// g * (S + hd) * 4 bytes fits the 227 KB a block may use: for g = 5 and
// hd = 128, up to about 11,500 cached tokens per slot (the launcher raises
// the dynamic limit above 48 KB and refuses what does not fit). Bound by
// bytes: the K and V rows of the mapped pages are the traffic.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kWarps = 4;
constexpr int kMaxG = 16;      // query heads per KV head
constexpr int kMaxChunks = 8;  // hd <= 256: lane owns hd / 32 columns

__device__ __forceinline__ float cast_in(float x, int fmt) {
  if (fmt == 1) return __bfloat162float(__float2bfloat16_rn(x));
  if (fmt == 2) return __half2float(__float2half_rn(x));
  return x;
}

__device__ __forceinline__ float truncate3(float y) {
  return __int_as_float(__float_as_int(y) & ~7);
}

__global__ void __launch_bounds__(kWarps * 32)
paged_decode(const float* __restrict__ q, const float* __restrict__ k_pool,
             const float* __restrict__ v_pool, const int* __restrict__ ppos,
             const int* __restrict__ bt, const int* __restrict__ pos,
             float* __restrict__ out, int KVH, int g, int hd, int psz, int P,
             float scale, float scale_over_cap, float cap, int window, int fmt,
             int approx) {
  extern __shared__ float smem[];
  const int S = P * psz;
  float* q_s = smem;            // [g][hd]
  float* s_buf = smem + g * hd;  // [g][S]
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int b = blockIdx.x;
  const int kvh = blockIdx.y;
  const int H = KVH * g;
  const int nchunks = hd / 32;
  const int my_pos = pos[b];
  const int* bt_row = bt + (size_t)b * P;

  for (int i = threadIdx.x; i < g * hd; i += blockDim.x) {
    const int h = i / hd, d = i % hd;
    q_s[i] = cast_in(q[((size_t)b * H + kvh * g + h) * hd + d], fmt);
  }
  __syncthreads();

  // scores: one key per warp at a time
  for (int idx = warp; idx < S; idx += kWarps) {
    const int j = idx / psz, off = idx % psz;
    const int pid = bt_row[j];
    if (pid <= 0) {  // unmapped or trash page: masked, never read
      if (lane < g) s_buf[lane * S + idx] = -INFINITY;
      continue;
    }
    const int kvp = ppos[(size_t)pid * psz + off];
    bool ok = kvp >= 0 && kvp <= my_pos;
    if (window) ok = ok && kvp > my_pos - window;
    const float* kr = k_pool + (((size_t)pid * psz + off) * KVH + kvh) * hd;
    float kv[kMaxChunks];
#pragma unroll
    for (int c = 0; c < kMaxChunks; ++c)
      kv[c] = c < nchunks ? cast_in(kr[lane + 32 * c], fmt) : 0.f;
    for (int h = 0; h < g; ++h) {
      float part = 0.f;
#pragma unroll
      for (int c = 0; c < kMaxChunks; ++c)
        if (c < nchunks) part = fmaf(q_s[h * hd + lane + 32 * c], kv[c], part);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) part += __shfl_xor_sync(~0u, part, o);
      if (lane == 0) {
        float s = approx ? truncate3(part) : part;
        s = cap != 0.f ? cap * tanhf(s * scale_over_cap) : s * scale;
        s_buf[h * S + idx] = ok ? s : -INFINITY;
      }
    }
  }
  __syncthreads();

  // deferred softmax, one warp per head
  for (int h = warp; h < g; h += kWarps) {
    float* row = s_buf + (size_t)h * S;
    float mx = -INFINITY;
    for (int i = lane; i < S; i += 32) mx = fmaxf(mx, row[i]);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(~0u, mx, o));
    const float m_safe = isinf(mx) ? 0.f : mx;
    float sum = 0.f;
    for (int i = lane; i < S; i += 32) {
      const float p = expf(row[i] - m_safe);
      row[i] = p;
      sum += p;
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(~0u, sum, o);
    const float denom = fmaxf(sum, 1e-30f);
    for (int i = lane; i < S; i += 32) row[i] = cast_in(row[i] / denom, fmt);
  }
  __syncthreads();

  // P.V over the mapped pages; thread d owns output column d of every head
  for (int d = threadIdx.x; d < hd; d += blockDim.x) {
    float acc[kMaxG];
#pragma unroll
    for (int h = 0; h < kMaxG; ++h) acc[h] = 0.f;
    for (int j = 0; j < P; ++j) {
      const int pid = bt_row[j];
      if (pid <= 0) continue;
      for (int off = 0; off < psz; ++off) {
        const int idx = j * psz + off;
        const float vv = cast_in(
            v_pool[(((size_t)pid * psz + off) * KVH + kvh) * hd + d], fmt);
#pragma unroll
        for (int h = 0; h < kMaxG; ++h)
          if (h < g) acc[h] = fmaf(s_buf[h * S + idx], vv, acc[h]);
      }
    }
#pragma unroll
    for (int h = 0; h < kMaxG; ++h)
      if (h < g)
        out[((size_t)b * H + kvh * g + h) * hd + d] =
            approx ? truncate3(acc[h]) : acc[h];
  }
}

}  // namespace

extern "C" int paged_decode_launch(const void* q, const void* k_pool,
                                   const void* v_pool, const void* ppos,
                                   const void* bt, const void* pos, void* out,
                                   int B, int KVH, int g, int hd, int psz,
                                   int P, float scale, float scale_over_cap,
                                   float cap, int window, int fmt, int approx,
                                   void* stream) {
  const size_t smem = sizeof(float) * (size_t)g * ((size_t)P * psz + hd);
  if (smem > 227 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        paged_decode, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  dim3 grid(B, KVH);
  paged_decode<<<grid, kWarps * 32, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(k_pool),
      static_cast<const float*>(v_pool), static_cast<const int*>(ppos),
      static_cast<const int*>(bt), static_cast<const int*>(pos),
      static_cast<float*>(out), KVH, g, hd, psz, P, scale, scale_over_cap, cap,
      window, fmt, approx);
  return static_cast<int>(cudaGetLastError());
}
