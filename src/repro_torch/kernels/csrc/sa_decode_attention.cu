// Paged decode attention for Hopper (sm_90a) under the SA contract.
//
// Replaces the TPU kernel repro/kernels/sa_decode_attention.py
// `_decode_kernel`, and computes what repro/models/layers.py `gather_pages`
// + `decode_attention` compute, without the gathered dense view:
//   * walk slot b's block-table row; entries with a page id below `min_page`
//     are masked and never read: 1 for the pool (unmapped -1 and the trash
//     page 0), 0 for dense per-slot rows presented as a pool (a ring, or
//     the gathered view: -1 marks what the pool would not read);
//   * s = cast_in(q) . cast_in(k) in fp32 per query head, then the approx
//     truncation (low 3 mantissa bits, RTZ), then cap * tanh(s * (scale /
//     cap)) or s * scale with the constants folded on the host, then the
//     position mask (0 <= kv_pos <= pos, and kv_pos > pos - window);
//   * deferred softmax with the all-masked guard: m_safe = 0 when the row
//     max is -inf, p = exp(s - m_safe) / max(sum, 1e-30), p cast in: P is
//     normalized by the whole row's max and sum before it is rounded;
//   * out = sum_k p_k cast_in(v_k) in fp32, then the approx truncation;
//   * optionally (`lse` not null) each query row's log-sum-exp of its
//     scores, m + log(sum), or -inf where every key is masked (the output
//     is then zeros): the fold of attentions over rows split across ranks
//     (repro_torch/models/layers.py `fold_partials`).
//
// Design: a thread-block cluster per (slot, KV head) splits the slot's keys
// into n_split contiguous runs, one per block (grid (B, KVH, n_split),
// cluster (1, 1, n_split), launched with cudaLaunchKernelEx; the wrapper's
// `split_plan` picks n_split and the keys a block, a multiple of kRun). The
// g query heads of the KV head share every K and V row a block reads. A
// block stages its block-table entries in shared memory, then each of its 8
// warps takes 8 keys at a time: 8 independent 16-byte loads a lane (one K
// row a warp-load at hd = 128) are in flight together, each lane forms the
// g partial dots of its columns for all 8 keys, and one butterfly reduces
// the 8 g partials in 9 g shuffles (the keys are halved across lanes 16, 8
// and 4 apart, then summed across the quad), instead of 5 g a key. The
// block's g x (its keys) scores stay in its shared memory.
//
// The order of every sum is a function of the slot alone, not of n_split
// (ROADMAP F9): the slot's keys fall into fixed runs of kRun = 64 keys (key
// k in run k / 64), and a block holds whole runs. The row max is exact in
// any order. The denominator: each run's sum of exp(s - m) is formed by one
// warp in an order fixed by the run (lane l adds keys l and l + 32 of the
// run, then a butterfly), and the runs' sums are folded in run order 0, 1,
// 2, ... from whichever block holds each (distributed shared memory). P.V:
// in run j warp w takes the run's keys 8 w .. 8 w + 7 (an fma chain from
// zero in key order), the run's partial is its warps' added in warp order,
// written to a global workspace, and after the cluster barrier each block
// finishes a slice of the g x hd outputs by folding every run's partial in
// run order (read through L2). n_split decides only which block computes
// which run. Every block holds the same m and denominator, so P is the
// reference's P; only the order of the fp32 sums differs from it (the
// bound's 2 S 2^-24), and the result is deterministic and the same for
// every cluster size.
//
// Pools: fp32, bf16 or fp16, the pool type a template parameter of the
// row loads. A 16-bit row stays packed two values to a register while its
// loads are in flight (the 85-register budget holds 8 rows of K, and of V
// across the exchanges); each value is widened to fp32 exactly when read
// and then cast in as above, so the order of every sum is the same for
// every pool type. A
// 16-bit pool holds the fp32 K/V rounded once to nearest even on the
// write, which is what cast_in does to an fp32 pool's values: under the
// bf16 policy a bf16 pool gives the fp32 pool's output bit for bit, and an
// fp16 pool is rounded to bf16 on the read, as the reference casts each
// page in.
//
// What bounds it on the H100: latency. At the serving shape (B = 4,
// 144-token slots) a call moves 2.4 MB (0.75 us at 3.35 TB/s), less than
// one cold read plus three cluster barriers take. At 2048-token slots it
// moves 67 MB of an fp32 pool (20 us at the byte rate; a bf16 pool half
// that, 10 us) in two dependent passes over the pool, K then V, each warp holding 8 rows in flight; on the card that
// reaches about 38 % of the byte rate (PERF.md). A block holds
// g * keys_per_block scores and g sums a run, so a slot's length is limited
// only by the cluster's shared memory (16 blocks of at most 227 KB: 164,864
// tokens at g = 5, hd = 128, page 16; 80,896 at g = 8, hd = 256). The
// runs' P.V partials (g * hd fp32 a run, 40 B a key at g = 5, hd = 128) go
// to the workspace, not to shared memory, so they do not bound the slot.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>

#include <type_traits>

namespace cg = cooperative_groups;

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kNK = 8;  // keys a warp has in flight
constexpr int kRun = kWarps * kNK;  // keys a run: one batch of every warp

__device__ __forceinline__ float cast_in(float x, int fmt) {
  if (fmt == 1) return __bfloat162float(__float2bfloat16_rn(x));
  if (fmt == 2) return __half2float(__float2half_rn(x));
  return x;
}

__device__ __forceinline__ float truncate3(float y) {
  return __int_as_float(__float_as_int(y) & ~7);
}

// a 16-bit pool value's bits widened to fp32 (exact)
template <typename T>
__device__ __forceinline__ float widen(unsigned int bits) {
  if constexpr (std::is_same<T, __half>::value)
    return __half2float(__ushort_as_half(static_cast<unsigned short>(bits)));
  return __uint_as_float(bits << 16);  // bf16: the high half of an fp32
}

// Lane `lane` owns VEC columns of an hd = 32 VEC row: 2 lane, 2 lane + 1 for
// VEC = 2; 4 lane + {0..3} + 128 i for VEC = 4, 8, so every warp-load is one
// contiguous run (256 or 512 bytes of an fp32 row, half that of a 16-bit
// one). A 16-bit pool's values are widened to fp32 exactly.
template <int VEC>
__device__ __forceinline__ int col(int lane, int e) {
  return VEC == 2 ? 2 * lane + e : 128 * (e >> 2) + 4 * lane + (e & 3);
}

template <int VEC>
__device__ __forceinline__ void load_row(const float* __restrict__ p, int lane,
                                         float (&x)[VEC]) {
  if constexpr (VEC == 2) {
    const float2 t = __ldg(reinterpret_cast<const float2*>(p) + lane);
    x[0] = t.x;
    x[1] = t.y;
  } else {
#pragma unroll
    for (int i = 0; i < VEC / 4; ++i) {
      const float4 t =
          __ldg(reinterpret_cast<const float4*>(p + 128 * i) + lane);
      x[4 * i] = t.x;
      x[4 * i + 1] = t.y;
      x[4 * i + 2] = t.z;
      x[4 * i + 3] = t.w;
    }
  }
}

// A K or V row's VEC values a lane while its loads are in flight: fp32 as
// loaded; a 16-bit pool's kept packed two to a register (half the
// registers across the batch and the cluster exchanges) and widened
// exactly when read.
template <typename T, int VEC>
struct Row {
  static constexpr bool kWide = std::is_same<T, float>::value;
  typename std::conditional<kWide, float, unsigned int>::type
      v[kWide ? VEC : VEC / 2];

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int i = 0; i < (kWide ? VEC : VEC / 2); ++i) v[i] = 0;
  }
  __device__ __forceinline__ void load(const T* __restrict__ p, int lane) {
    if constexpr (kWide) {
      load_row<VEC>(p, lane, v);
    } else if constexpr (VEC == 2) {
      v[0] = __ldg(reinterpret_cast<const unsigned int*>(p) + lane);
    } else {
#pragma unroll
      for (int i = 0; i < VEC / 4; ++i) {
        const uint2 t =
            __ldg(reinterpret_cast<const uint2*>(p + 128 * i) + lane);
        v[2 * i] = t.x;
        v[2 * i + 1] = t.y;
      }
    }
  }
  __device__ __forceinline__ float get(int e) const {
    if constexpr (kWide) {
      return v[e];
    } else {
      return widen<T>(e & 1 ? v[e >> 1] >> 16 : v[e >> 1] & 0xffffu);
    }
  }
};

// Three blocks an SM (at most 85 registers a thread) keep the clusters of
// long slots in one wave (at B = 4, KVH = 8: 32 clusters of 8 blocks); on
// the card, variants that needed more registers ran markedly slower at
// 2048-token slots. The wider instantiations would spill under that cap,
// so they keep the compiler's choice.
template <int G, int VEC, typename T>
__global__ void __launch_bounds__(kThreads, G * VEC <= 20 ? 3 : 1)
paged_decode_split(const float* __restrict__ q, const T* __restrict__ k_pool,
                   const T* __restrict__ v_pool, const int* __restrict__ ppos,
                   const int* __restrict__ bt, const int* __restrict__ pos,
                   float* __restrict__ out, float* __restrict__ ws,
                   float* __restrict__ lse, int KVH, int psz, int P, int kpc,
                   int min_page, float scale, float scale_over_cap, float cap,
                   int window, int fmt, int approx) {
  constexpr int HD = 32 * VEC;
  cg::cluster_group cluster = cg::this_cluster();
  const int nsplit = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  extern __shared__ float4 smem4[];
  float* s_buf = reinterpret_cast<float*>(smem4);  // [G][kpc] scores, then P
  float* o_w = s_buf + G * kpc;                    // [kWarps][G][HD]
  float* red = o_w + kWarps * G * HD;  // [4][G]: local max, m, m_safe, denom
  float* run_den = red + 4 * G;        // [kpc / kRun][G]: each run's sum
  int* bt_s = reinterpret_cast<int*>(run_den + (kpc / kRun) * G);  // pages

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int b = blockIdx.x;
  const int kvh = blockIdx.y;
  const int H = KVH * G;
  const int S = P * psz;
  const int k0 = rank * kpc;
  const int n_local = max(0, min(S, k0 + kpc) - k0);
  const int rpb = kpc / kRun;                      // runs a block
  const int n_run = (n_local + kRun - 1) / kRun;   // this block's, with keys
  const int n_runs = (S + kRun - 1) / kRun;        // the slot's
  const int j0 = k0 / psz;
  const int n_pg = n_local ? (k0 + n_local - 1) / psz - j0 + 1 : 0;
  const int my_pos = pos[b];
  for (int i = threadIdx.x; i < n_pg; i += kThreads)
    bt_s[i] = bt[(size_t)b * P + j0 + i];

  float qv[G][VEC];
#pragma unroll
  for (int h = 0; h < G; ++h) {
    load_row<VEC>(q + ((size_t)b * H + kvh * G + h) * HD, lane, qv[h]);
#pragma unroll
    for (int e = 0; e < VEC; ++e) qv[h][e] = cast_in(qv[h][e], fmt);
  }
  __syncthreads();

  // scores, kNK keys a warp at a time: every load of the batch is issued
  // before any mask is formed, so the kNK rows are in flight together
  const bool hi16 = lane & 16, hi8 = lane & 8, hi4 = lane & 4;
  for (int base = warp * kNK; base < n_local; base += kWarps * kNK) {
    Row<T, VEC> kx[kNK];
    int kvp[kNK];
#pragma unroll
    for (int i = 0; i < kNK; ++i) {
      const int key = k0 + base + i;
      const int pid = base + i < n_local ? bt_s[key / psz - j0] : -1;
      const size_t row = (size_t)pid * psz + (key - (key / psz) * psz);
      kvp[i] = -1;
      kx[i].zero();
      if (pid >= min_page) {  // mapped: read; pages below never are
        kx[i].load(k_pool + (row * KVH + kvh) * HD, lane);
        kvp[i] = __ldg(ppos + row);
      }
    }
    unsigned okm = 0;
#pragma unroll
    for (int i = 0; i < kNK; ++i) {
      bool ok = kvp[i] >= 0 && kvp[i] <= my_pos;
      if (window) ok = ok && kvp[i] > my_pos - window;
      okm |= static_cast<unsigned>(ok) << i;
    }
    float part[kNK][G];
#pragma unroll
    for (int i = 0; i < kNK; ++i) {
      float xk[VEC];
#pragma unroll
      for (int e = 0; e < VEC; ++e) xk[e] = cast_in(kx[i].get(e), fmt);
#pragma unroll
      for (int h = 0; h < G; ++h) {
        float a = 0.f;
#pragma unroll
        for (int e = 0; e < VEC; ++e) a = fmaf(qv[h][e], xk[e], a);
        part[i][h] = a;
      }
    }
    // butterfly: halve the keys across lanes 16, 8, 4 apart, then sum the
    // quad; lane l ends with the full dots of key (l >> 2) & 7
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int h = 0; h < G; ++h) {
        const float keep = hi16 ? part[i + 4][h] : part[i][h];
        const float send = hi16 ? part[i][h] : part[i + 4][h];
        part[i][h] = keep + __shfl_xor_sync(~0u, send, 16);
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
#pragma unroll
      for (int h = 0; h < G; ++h) {
        const float keep = hi8 ? part[i + 2][h] : part[i][h];
        const float send = hi8 ? part[i][h] : part[i + 2][h];
        part[i][h] = keep + __shfl_xor_sync(~0u, send, 8);
      }
    }
#pragma unroll
    for (int h = 0; h < G; ++h) {
      const float keep = hi4 ? part[1][h] : part[0][h];
      const float send = hi4 ? part[0][h] : part[1][h];
      float a = keep + __shfl_xor_sync(~0u, send, 4);
      a += __shfl_xor_sync(~0u, a, 2);
      part[0][h] = a + __shfl_xor_sync(~0u, a, 1);
    }
    const int kk = (lane >> 2) & 7;
    const int idx = base + kk;
    const bool ok = (okm >> kk) & 1u;
    if (idx < n_local) {
#pragma unroll
      for (int h = 0; h < G; ++h) {
        if ((h & 3) != (lane & 3)) continue;
        float s = approx ? truncate3(part[0][h]) : part[0][h];
        s = cap != 0.f ? cap * tanhf(s * scale_over_cap) : s * scale;
        s_buf[h * kpc + idx] = ok ? s : -INFINITY;
      }
    }
  }
  __syncthreads();

  // the V rows of this warp's first batch (fp32 cast in at once; 16-bit
  // packed, cast in when used): their loads run under the first two
  // exchanges
  using VRow = Row<T, VEC>;
  auto load_v = [&](int base, VRow (&vx)[kNK]) {
#pragma unroll
    for (int i = 0; i < kNK; ++i) {
      const int key = k0 + base + i;
      const int pid = base + i < n_local ? bt_s[key / psz - j0] : -1;
      vx[i].zero();
      if (pid >= min_page)
        vx[i].load(v_pool + (((size_t)pid * psz + key - (key / psz) * psz) *
                                 KVH + kvh) * HD,
                   lane);
    }
    if constexpr (VRow::kWide) {
#pragma unroll
      for (int i = 0; i < kNK; ++i)
#pragma unroll
        for (int e = 0; e < VEC; ++e) vx[i].v[e] = cast_in(vx[i].v[e], fmt);
    }
  };
  VRow vx[kNK];
  if (warp * kNK < n_local) load_v(warp * kNK, vx);

  // exchange 1: the row max over the cluster
  if (warp < G) {
    float mx = -INFINITY;
    for (int i = lane; i < n_local; i += 32) mx = fmaxf(mx, s_buf[warp * kpc + i]);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(~0u, mx, o));
    if (lane == 0) red[warp] = mx;
  }
  cluster.sync();
  if (threadIdx.x < G) {
    float m = -INFINITY;
    for (int r = 0; r < nsplit; ++r)
      m = fmaxf(m, cluster.map_shared_rank(red, r)[threadIdx.x]);
    red[G + threadIdx.x] = m;
    red[2 * G + threadIdx.x] = isfinite(m) ? m : 0.f;
  }
  __syncthreads();

  // exchange 2: the denominator. Each run's sum by one warp, in an order
  // fixed by the run; then the runs' sums folded in run order across the
  // cluster
  for (int pr = warp; pr < G * n_run; pr += kWarps) {
    const int h = pr / n_run, j = pr - h * n_run;
    const float ms = red[2 * G + h];
    float* row = s_buf + h * kpc + j * kRun;
    float e0 = 0.f, e1 = 0.f;
    if (j * kRun + lane < n_local) row[lane] = e0 = expf(row[lane] - ms);
    if (j * kRun + lane + 32 < n_local)
      row[lane + 32] = e1 = expf(row[lane + 32] - ms);
    float sum = e0 + e1;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(~0u, sum, o);
    if (lane == 0) run_den[j * G + h] = sum;
  }
  cluster.sync();
  if (threadIdx.x < G) {
    float den = 0.f;
#pragma unroll 8
    for (int j = 0; j < n_runs; ++j) {
      const int r = j / rpb;
      den += cluster.map_shared_rank(run_den, r)[(j - r * rpb) * G +
                                                 threadIdx.x];
    }
    red[3 * G + threadIdx.x] = fmaxf(den, 1e-30f);
    // the row's log-sum-exp: the max key's term is exp(0) = 1, so den >= 1
    // wherever m is finite
    if (lse != nullptr && rank == 0) {
      const float m = red[G + threadIdx.x];
      lse[(size_t)b * H + kvh * G + threadIdx.x] =
          isfinite(m) ? m + logf(den) : -INFINITY;
    }
  }
  __syncthreads();
  for (int t = threadIdx.x; t < G * kpc; t += kThreads) {
    const int h = t / kpc, i = t - h * kpc;
    if (i < n_local) s_buf[t] = cast_in(s_buf[t] / red[3 * G + h], fmt);
  }
  __syncthreads();

  // P.V a run at a time (the first run's rows already in flight): in run j
  // warp w's fma chain over keys 8 w .. 8 w + 7 of the run from zero, the
  // run's partial its warps' added in warp order, to the workspace
  float* ws_s = ws + (size_t)(b * KVH + kvh) * (nsplit * rpb) * (G * HD);
  for (int j = 0; j < n_run; ++j) {
    const int base = j * kRun + warp * kNK;
    float acc[G][VEC];
#pragma unroll
    for (int h = 0; h < G; ++h)
#pragma unroll
      for (int e = 0; e < VEC; ++e) acc[h][e] = 0.f;
#pragma unroll
    for (int i = 0; i < kNK; ++i) {
      if (base + i >= n_local) break;
      float xv[VEC];
#pragma unroll
      for (int e = 0; e < VEC; ++e)
        xv[e] = VRow::kWide ? vx[i].get(e) : cast_in(vx[i].get(e), fmt);
#pragma unroll
      for (int h = 0; h < G; ++h) {
        const float p = s_buf[h * kpc + base + i];
#pragma unroll
        for (int e = 0; e < VEC; ++e) acc[h][e] = fmaf(p, xv[e], acc[h][e]);
      }
    }
    if (j + 1 < n_run) load_v(base + kRun, vx);  // the next run's rows
#pragma unroll
    for (int h = 0; h < G; ++h)
#pragma unroll
      for (int e = 0; e < VEC; ++e)
        o_w[(warp * G + h) * HD + col<VEC>(lane, e)] = acc[h][e];
    __syncthreads();
    float* dst = ws_s + (size_t)(rank * rpb + j) * (G * HD);
    for (int t = threadIdx.x; t < G * HD; t += kThreads) {
      float sum = 0.f;
      for (int w = 0; w < kWarps; ++w) sum += o_w[w * G * HD + t];
      __stcg(dst + t, sum);
    }
    __syncthreads();
  }

  // exchange 3: after the barrier (its release and acquire order the
  // workspace writes of every block before these reads, which bypass L1)
  // each block finishes a slice of the outputs, every run's partial folded
  // in run order. No distributed shared memory is read after it, so a
  // block may leave when done.
  cluster.sync();
  const int chunk = (G * HD + nsplit - 1) / nsplit;
  const int end = min(G * HD, (rank + 1) * chunk);
  for (int t = rank * chunk + threadIdx.x; t < end; t += kThreads) {
    float y = 0.f;
#pragma unroll 8
    for (int j = 0; j < n_runs; ++j)
      y += __ldcg(ws_s + (size_t)j * (G * HD) + t);
    const int h = t / HD, d = t - h * HD;
    out[((size_t)b * H + kvh * G + h) * HD + d] = approx ? truncate3(y) : y;
  }
}

template <int G, int VEC, typename T>
int launch(const float* q, const T* k_pool, const T* v_pool,
           const int* ppos, const int* bt, const int* pos, float* out,
           float* ws, float* lse, int B,
           int KVH, int psz, int P, int n_split, int kpc, int smem,
           int min_page, float scale, float scale_over_cap, float cap,
           int window, int fmt, int approx, cudaStream_t stream) {
  auto kern = paged_decode_split<G, VEC, T>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (n_split > 8) {
    e = cudaFuncSetAttribute(kern, cudaFuncAttributeNonPortableClusterSizeAllowed,
                             1);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(B, KVH, n_split);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = n_split;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, kern, q, k_pool, v_pool, ppos, bt, pos, out, ws,
                         lse, KVH, psz, P, kpc, min_page, scale, scale_over_cap,
                         cap, window, fmt, approx);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

// The library's pool type: the source builds once a pool type (nvcc
// -DREPRO_POOL_DT=0 fp32, 1 bf16, 2 fp16), 24 instantiations each, in three
// nvcc processes at once.
#if !defined(REPRO_POOL_DT)
#error "build with -DREPRO_POOL_DT=0 (fp32), 1 (bf16) or 2 (fp16)"
#elif REPRO_POOL_DT == 1
using Pool = __nv_bfloat16;
#elif REPRO_POOL_DT == 2
using Pool = __half;
#else
using Pool = float;
#endif

}  // namespace

// `n_split`, `kpc` (keys a block) and `smem` come from the wrapper's
// `split_plan`; a plan whose shared memory is smaller than this layout
// needs, or larger than a block may have, is refused. `pool_dt` is the K/V
// pools' element type: 0 fp32, 1 bf16, 2 fp16 (both pools the same), the
// library's own (REPRO_POOL_DT) or refused.
// `min_page` is the lowest page id the kernel reads: 1 for the pool, whose
// page 0 is the trash page, 0 for dense rows presented as a pool. `ws` is
// the runs' P.V workspace: B * KVH * n_split * (kpc / 64) * g * hd fp32.
// `lse`, null or B * KVH * g fp32: each query row's log-sum-exp.
extern "C" int paged_decode_launch(const void* q, const void* k_pool,
                                   const void* v_pool, const void* ppos,
                                   const void* bt, const void* pos, void* out,
                                   void* ws, void* lse,
                                   int B, int KVH, int g, int hd, int psz,
                                   int P, int n_split, int kpc, int smem,
                                   int min_page, float scale,
                                   float scale_over_cap,
                                   float cap, int window, int fmt, int approx,
                                   int pool_dt, void* stream) {
  const long long need =
      4LL * ((long long)g * kpc + (long long)kWarps * g * hd + 4 * g +
             (long long)(kpc / kRun) * g) +
      4LL * (kpc / psz + 2);
  if (n_split < 1 || n_split > 16 || kpc < 1 || kpc % kRun || smem < need ||
      smem > 227 * 1024 || (long long)n_split * kpc < (long long)P * psz ||
      pool_dt != REPRO_POOL_DT || min_page < 0 || min_page > 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const float* qf = static_cast<const float*>(q);
  const int* pp = static_cast<const int*>(ppos);
  const int* btp = static_cast<const int*>(bt);
  const int* ps = static_cast<const int*>(pos);
  float* of = static_cast<float*>(out);
  float* wsf = static_cast<float*>(ws);
  float* lsef = static_cast<float*>(lse);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define REPRO_CASE(G_, VEC_)                                              \
  if (g == G_ && hd == 32 * VEC_)                                         \
    return launch<G_, VEC_>(qf, static_cast<const Pool*>(k_pool),         \
                            static_cast<const Pool*>(v_pool), pp, btp, ps, \
                            of, wsf, lsef, B, KVH, psz, P, n_split, kpc,   \
                            smem,                                          \
                            min_page, scale, scale_over_cap, cap, window,  \
                            fmt, approx, s);
#define REPRO_G(G_) \
  REPRO_CASE(G_, 2); \
  REPRO_CASE(G_, 4); \
  REPRO_CASE(G_, 8)
  REPRO_G(1);
  REPRO_G(2);
  REPRO_G(3);
  REPRO_G(4);
  REPRO_G(5);
  REPRO_G(6);
  REPRO_G(7);
  REPRO_G(8);
#undef REPRO_G
#undef REPRO_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}
