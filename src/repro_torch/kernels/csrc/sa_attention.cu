// Prefill flash attention for Hopper (sm_90a) under the SA contract.
//
// Replaces the TPU kernel repro/kernels/sa_attention.py `_attn_kernel`, and
// follows the contract of repro/models/layers.py `blockwise_attention`:
//   s   = (cast_in(q) . cast_in(k)) in fp32, x scale, optional softcap
//         cap * tanh(s / cap), causal / window masks (q_pos = q_offset + t);
//   online softmax per query row: running max m, normalizer l (fp32 p),
//   unnormalized accumulator acc = acc * corr + sum_j cast_in(p_j) cast_in(v_j);
//   one normalization acc / max(l, 1e-30) at the end.
// GQA: query head h reads kv head h / (H / KVH). q (B, T, H, hd) and k, v
// (B, S, KVH, hd) are read through their strides (the last one 1); out is
// (B, T, H, hd) contiguous, so nothing around the kernel copies a layout.
//
// Two routes, chosen by the policy's input format (kernels/sa_attention.py):
//
// mma (bf16, fp16). Every operand of both products is cast in to a 16-bit
// type before its dot: exactly what mma.sync.m16n8k16 consumes, with fp32
// accumulation. A block of 8 warps (the wrapper's plan; 1 to 8 run) owns
// 16 query rows a warp of one head: the block converts each key tile once
// for all its warps, and on the card 8 and 4 warps beat 2 and 1 at every
// T measured (8 is faster at T = 1024), though T = 128 with 40 heads then
// gives 40 blocks on 132 SMs. Each warp converts its q rows to
// 16-bit A fragments once (round to nearest even, which is cast_in) and
// keeps them in registers (HD = 256: in shared memory, below). Key tiles of
// 64 rows (32 at HD = 256) of K and V come in fp32
// through cp.async (16-byte pieces, only the rows below S), are converted
// once by the whole block into 16-bit tiles in shared memory
// (16-byte chunks XOR-swizzled by row, so ldmatrix reads without bank
// conflicts) and read with ldmatrix (.trans for V). K and V that arrive in
// the policy's 16-bit type (KV16) skip the fp32 staging: cp.async copies
// their rows straight into the swizzled tiles, two tiles deep, and rows
// past S are zero-filled by the copy; their bits are what the conversion
// of the fp32 values would give, so the result is the same. The next tile's copy is
// in flight while the current one computes. The S fragments feed the
// softmax through quad shuffles; P is rounded to 16 bits (the contract's
// cast_in(p)) and used directly as the A operand of P.V, as in
// FlashAttention-2. Tiles past the block's last query (causal) or before
// its first window are skipped: an all-masked tile leaves (m, l, acc)
// unchanged, so skipping it is exact.
//
// What bounds it on the H100: at serving lengths (T <= 128, 40/8 heads,
// hd 128) the products are 1.7e8 flop (0.17 us at 989 TFLOP/s) against
// 6.3 MB of fp32 q, k, v and out (1.9 us at 3.35 TB/s), so neither bounds a
// call of a few microseconds: latency does (launch, one cold read of q and
// of each key tile, its conversion to 16 bits, two block barriers a tile).
// The design keeps each block's loads in flight together (cp.async, no
// register staging) and shares each converted tile among 8 warps. wgmma
// and TMA would raise the flop ceiling, which is not the limit here. At
// T = 1024 each head's blocks re-read its kv head's K and V from L2 (g = 5
// heads share them) and convert them again.
//
// Head dim 256 (gemma2, gemma3). A warp's 16 x 256 output alone is 128
// fp32 registers a thread; with the q fragments in registers too (64) and
// a 16 x 64 score tile (32) ptxas would spill past 255. At HD = 256 each
// warp therefore keeps its 16 query rows in shared memory, cast in once to
// 16 bits in the same swizzled layout as the key tiles, and reads the A
// fragment of each k-step with ldmatrix inside the q.k loop; and the key
// tile is halved to 32 rows (16 score registers), which also keeps the
// fp32 staging, the 16-bit tiles and the 8 warps' q rows within one SM's
// shared memory (163,840 B with fp32 K/V, 131,072 B with 16-bit K/V). The
// arithmetic is the HD <= 128 kernel's: the same cast-in operands, online
// max and normalizer, one 1e-30-floored normalization; only the key tile,
// hence the points where P is rounded against the running max, differs.
//
// simt (fp32). fp32 operands have no exact tensor-core type (TF32 drops 13
// bits), so this route keeps fp32 FMA chains: one block of 4 warps per
// (16-query tile, head, batch row), each warp 4 query rows; key tiles of 32
// rows staged in shared memory (K padded by one column); lane j scores key j
// and owns output columns lane + 32 i (hd up to 256: 8 columns a lane).
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

// ---------------------------------------------------------------------------
// mma route
// ---------------------------------------------------------------------------

constexpr int kMaxWarps = 8;

// keys a tile, and whether a warp's q rows live in shared memory: the
// HD = 256 layout (see the head of the file)
template <int HD>
struct MmaShape {
  static constexpr int kKeyTile = HD > 128 ? 32 : 64;
  static constexpr bool kQSmem = HD > 128;
};

// dynamic shared memory of the mma route (the wrapper's `launch_plan`):
// fp32 staging of a K and a V tile and their 16-bit copies, or two 16-bit
// (K, V) pairs (kv16); plus 16 q rows a warp in 16 bits where kQSmem
int mma_smem(int hd, int kv16, int warps) {
  const int tile = hd > 128 ? 32 : 64;
  return tile * hd * (kv16 ? 8 : 12) + (hd > 128 ? warps * 16 * hd * 2 : 0);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

template <bool F16>
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  if constexpr (F16) {
    __half2 h = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&h);
  } else {
    __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&h);
  }
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t& r0,
                                        uint32_t& r1, uint32_t& r2,
                                        uint32_t& r3) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
      : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t addr, uint32_t& r0,
                                          uint32_t& r1, uint32_t& r2,
                                          uint32_t& r3) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
      : "r"(addr));
}

// d += a . b, m16n8k16, 16-bit operands, fp32 accumulate
template <bool F16>
__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  if constexpr (F16) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 {%0, %1, %2, %3}, "
        "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  } else {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, "
        "%3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(~0u, v, 1));
  return fmaxf(v, __shfl_xor_sync(~0u, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(~0u, v, 1);
  return v + __shfl_xor_sync(~0u, v, 2);
}

__device__ __forceinline__ float2 ld_row2(const float* p, bool in) {
  return in ? __ldg(reinterpret_cast<const float2*>(p)) : make_float2(0.f, 0.f);
}

// KV16: k and v arrive in the policy's 16-bit type (a 16-bit cache read
// back), so their tiles are copied by cp.async straight into the swizzled
// 16-bit layout, two buffers deep, with no fp32 staging and no conversion;
// otherwise k and v are fp32 and each tile is staged and converted once.
template <int HD, bool F16, bool KV16>
__global__ void __launch_bounds__(kMaxWarps * 32)
attn_mma(const float* __restrict__ q,
         const typename std::conditional<KV16, uint16_t, float>::type*
             __restrict__ k,
         const typename std::conditional<KV16, uint16_t, float>::type*
             __restrict__ v,
         float* __restrict__ out, int H, int KVH,
         int T, int S, long long sqb, long long sqt, long long sqh,
         long long skb, long long sks, long long skh, long long svb,
         long long svs, long long svh, float scale, float cap, int causal,
         int window, int q_offset) {
  constexpr int kKeyTile = MmaShape<HD>::kKeyTile;
  constexpr bool kQSmem = MmaShape<HD>::kQSmem;
  constexpr int kChunks = HD / 8;      // 16-byte chunks of a 16-bit row
  constexpr int kPieces = HD / 4;      // 16-byte pieces of an fp32 row
  constexpr int kNT = kKeyTile / 8;    // n-tiles of S per key tile
  constexpr int kKS = HD / 16;         // k-steps of q.k
  constexpr int kOT = HD / 8;          // n-tiles of the output
  constexpr int kTile16 = kKeyTile * HD * 2;  // bytes of a 16-bit tile
  extern __shared__ __align__(16) unsigned char smem[];
  // fp32 K/V: [kKeyTile][HD] fp32 staging of K and V, then one 16-bit K
  // and V tile; KV16: two (K, V) pairs of 16-bit tiles, no staging; then
  // (kQSmem) each warp's 16 q rows in 16 bits, swizzled as the key tiles
  float* stage_k = reinterpret_cast<float*>(smem);
  float* stage_v = stage_k + kKeyTile * HD;
  unsigned char* k16 =
      KV16 ? smem : reinterpret_cast<unsigned char*>(stage_v + kKeyTile * HD);
  unsigned char* v16 = k16 + kTile16 * (KV16 ? 2 : 1);  // 16-bit, swizzled
  const uint32_t k16_base = smem_u32(k16), v16_base = smem_u32(v16);
  unsigned char* q16 = v16 + kTile16 * (KV16 ? 2 : 1);

  const int nthreads = blockDim.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int grp = lane >> 2, qd = lane & 3;
  const int rows = nthreads >> 1;      // 16 query rows a warp
  const int t0 = blockIdx.x * rows;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / KVH);
  const float* qb = q + b * sqb + h * sqh;
  const auto* kb = k + b * skb + kvh * skh;
  const auto* vb = v + b * svb + kvh * svh;

  // the key tiles this block needs: up to its last query (causal), from
  // its first query's window start
  const int first_q = q_offset + t0;
  const int last_q = q_offset + min(T, t0 + rows) - 1;
  int j_end = (S + kKeyTile - 1) / kKeyTile;
  if (causal) j_end = min(j_end, last_q / kKeyTile + 1);
  const int j_begin =
      window ? max(0, first_q - window + 1) / kKeyTile : 0;

  // copy the tile's keys below S; rows past S are never staged (KV16:
  // zero-filled, since P is 0 there and 0 * V must stay 0)
  auto issue = [&](int kv0, int buf) {
    if constexpr (KV16) {
      const int n_keys = min(kKeyTile, S - kv0);
      for (int i = threadIdx.x; i < kKeyTile * kChunks; i += nthreads) {
        const int r = i / kChunks, c = i % kChunks;
        const int dst = buf * kTile16 + r * HD * 2 + ((c ^ (r & 7)) << 4);
        const bool in = r < n_keys;
        const long long key = kv0 + (in ? r : 0);
        cp_async16(k16_base + dst, kb + key * sks + c * 8, in ? 16 : 0);
        cp_async16(v16_base + dst, vb + key * svs + c * 8, in ? 16 : 0);
      }
    } else {
      const int n = min(kKeyTile, S - kv0) * kPieces;
      for (int i = threadIdx.x; i < n; i += nthreads) {
        const int r = i / kPieces, c = i % kPieces;
        const long long key = kv0 + r;
        cp_async16(smem_u32(stage_k + r * HD + c * 4), kb + key * sks + c * 4,
                   16);
        cp_async16(smem_u32(stage_v + r * HD + c * 4), vb + key * svs + c * 4,
                   16);
      }
    }
    cp_async_commit();
  };
  if (j_begin < j_end) issue(j_begin * kKeyTile, 0);

  // this warp's query rows, cast in once: as A fragments in registers, or
  // (kQSmem) as 16-bit rows in shared memory read back by ldmatrix
  const int ra = t0 + warp * 16 + grp, rb = ra + 8;
  uint32_t qa[kQSmem ? 1 : kKS][4];
  unsigned char* q16w = q16 + warp * 16 * HD * 2;
  const uint32_t q16_u = smem_u32(q16w);
  if constexpr (kQSmem) {
    for (int i = lane; i < 16 * kChunks; i += 32) {
      const int r = i / kChunks, c = i % kChunks;
      const int t = t0 + warp * 16 + r;
      uint4 x = make_uint4(0, 0, 0, 0);
      if (t < T) {
        const float4 a0 =
            __ldg(reinterpret_cast<const float4*>(qb + t * sqt + c * 8));
        const float4 a1 =
            __ldg(reinterpret_cast<const float4*>(qb + t * sqt + c * 8 + 4));
        x = make_uint4(pack2<F16>(a0.x, a0.y), pack2<F16>(a0.z, a0.w),
                       pack2<F16>(a1.x, a1.y), pack2<F16>(a1.z, a1.w));
      }
      *reinterpret_cast<uint4*>(q16w + r * HD * 2 + ((c ^ (r & 7)) << 4)) = x;
    }
    __syncwarp();
  } else {
#pragma unroll
    for (int ks = 0; ks < kKS; ++ks) {
      const int c = ks * 16 + 2 * qd;
      const float2 x0 = ld_row2(qb + ra * sqt + c, ra < T);
      const float2 x1 = ld_row2(qb + rb * sqt + c, rb < T);
      const float2 x2 = ld_row2(qb + ra * sqt + c + 8, ra < T);
      const float2 x3 = ld_row2(qb + rb * sqt + c + 8, rb < T);
      qa[ks][0] = pack2<F16>(x0.x, x0.y);
      qa[ks][1] = pack2<F16>(x1.x, x1.y);
      qa[ks][2] = pack2<F16>(x2.x, x2.y);
      qa[ks][3] = pack2<F16>(x3.x, x3.y);
    }
  }
  const int pa_pos = q_offset + ra, pb_pos = q_offset + rb;
  const int warp_first = q_offset + t0 + warp * 16;
  const int warp_last = q_offset + min(T, t0 + warp * 16 + 16) - 1;
  const bool warp_live = t0 + warp * 16 < T;

  float o[kOT][4];
#pragma unroll
  for (int n = 0; n < kOT; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;

  for (int j = j_begin; j < j_end; ++j) {
    const int kv0 = j * kKeyTile;
    cp_async_wait_all();
    __syncthreads();  // tile j staged; every warp is done with tile j - 1
    const int buf = KV16 ? (j - j_begin) & 1 : 0;
    const uint32_t k16_u = k16_base + buf * kTile16;
    const uint32_t v16_u = v16_base + buf * kTile16;
    if constexpr (KV16) {
      // the other buffer held tile j - 1, which every warp has finished
      if (j + 1 < j_end) issue(kv0 + kKeyTile, buf ^ 1);
    } else {
      const int n_keys = min(kKeyTile, S - kv0);
      for (int i = threadIdx.x; i < kKeyTile * kChunks; i += nthreads) {
        const int r = i / kChunks, c = i % kChunks;
        const int dst = r * HD * 2 + ((c ^ (r & 7)) << 4);
        if (r >= n_keys) {  // past S: P is 0 there, and 0 * V must stay 0
          *reinterpret_cast<uint4*>(v16 + dst) = make_uint4(0, 0, 0, 0);
          continue;
        }
        const float4 a0 = *reinterpret_cast<const float4*>(stage_k + r * HD + c * 8);
        const float4 a1 =
            *reinterpret_cast<const float4*>(stage_k + r * HD + c * 8 + 4);
        *reinterpret_cast<uint4*>(k16 + dst) =
            make_uint4(pack2<F16>(a0.x, a0.y), pack2<F16>(a0.z, a0.w),
                       pack2<F16>(a1.x, a1.y), pack2<F16>(a1.z, a1.w));
        const float4 b0 = *reinterpret_cast<const float4*>(stage_v + r * HD + c * 8);
        const float4 b1 =
            *reinterpret_cast<const float4*>(stage_v + r * HD + c * 8 + 4);
        *reinterpret_cast<uint4*>(v16 + dst) =
            make_uint4(pack2<F16>(b0.x, b0.y), pack2<F16>(b0.z, b0.w),
                       pack2<F16>(b1.x, b1.y), pack2<F16>(b1.z, b1.w));
      }
      __syncthreads();  // 16-bit tile ready; the staging buffer is free
      if (j + 1 < j_end) issue(kv0 + kKeyTile, 0);
    }
    if (!warp_live || (causal && kv0 > warp_last) ||
        (window && kv0 + kKeyTile - 1 <= warp_first - window))
      continue;  // every score of this warp in the tile is masked

    // s = q . k over the tile's keys; each s[n] sums its k-steps in order
    float s[kNT][4];
#pragma unroll
    for (int n = 0; n < kNT; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
    const int mi = lane >> 3, ri = lane & 7;
    if constexpr (kQSmem) {
      const int qr = lane & 15;
#pragma unroll
      for (int ks = 0; ks < kKS; ++ks) {
        uint32_t a[4];
        const int qch = 2 * ks + (lane >> 4);
        ldsm_x4(q16_u + qr * HD * 2 + ((qch ^ (qr & 7)) << 4), a[0], a[1],
                a[2], a[3]);
#pragma unroll
        for (int np = 0; np < kNT; np += 2) {
          const int key = (np + (mi >> 1)) * 8 + ri;
          const int ch = 2 * ks + (mi & 1);
          uint32_t b0, b1, b2, b3;
          ldsm_x4(k16_u + key * HD * 2 + ((ch ^ ri) << 4), b0, b1, b2, b3);
          mma16816<F16>(s[np], a, b0, b1);
          mma16816<F16>(s[np + 1], a, b2, b3);
        }
      }
    } else {
#pragma unroll
      for (int np = 0; np < kNT; np += 2) {
#pragma unroll
        for (int ks = 0; ks < kKS; ++ks) {
          const int key = (np + (mi >> 1)) * 8 + ri;
          const int ch = 2 * ks + (mi & 1);
          uint32_t b0, b1, b2, b3;
          ldsm_x4(k16_u + key * HD * 2 + ((ch ^ ri) << 4), b0, b1, b2, b3);
          mma16816<F16>(s[np], qa[ks], b0, b1);
          mma16816<F16>(s[np + 1], qa[ks], b2, b3);
        }
      }
    }

    // scale, softcap, masks; online max and normalizer
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int n = 0; n < kNT; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = kv0 + n * 8 + 2 * qd + (e & 1);
        const int qp = e < 2 ? pa_pos : pb_pos;
        float x = s[n][e] * scale;
        if (cap != 0.f) x = cap * tanhf(x / cap);
        bool ok = key < S;
        if (causal) ok = ok && qp >= key;
        if (window) ok = ok && qp - key < window;
        x = ok ? x : -INFINITY;
        s[n][e] = x;
        if (e < 2) mx0 = fmaxf(mx0, x);
        else mx1 = fmaxf(mx1, x);
      }
    }
    const float mn0 = fmaxf(m0, quad_max(mx0));
    const float mn1 = fmaxf(m1, quad_max(mx1));
    // a row with no unmasked key so far keeps m = -inf; the guard keeps
    // exp() at exactly 0 instead of NaN
    const float ms0 = isfinite(mn0) ? mn0 : 0.f;
    const float ms1 = isfinite(mn1) ? mn1 : 0.f;
    const float corr0 = expf(m0 - ms0), corr1 = expf(m1 - ms1);
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int n = 0; n < kNT; ++n) {
      s[n][0] = expf(s[n][0] - ms0);
      s[n][1] = expf(s[n][1] - ms0);
      s[n][2] = expf(s[n][2] - ms1);
      s[n][3] = expf(s[n][3] - ms1);
      sum0 += s[n][0] + s[n][1];
      sum1 += s[n][2] + s[n][3];
    }
    l0 = l0 * corr0 + quad_sum(sum0);
    l1 = l1 * corr1 + quad_sum(sum1);
    m0 = mn0;
    m1 = mn1;
#pragma unroll
    for (int n = 0; n < kOT; ++n) {
      o[n][0] *= corr0;
      o[n][1] *= corr0;
      o[n][2] *= corr1;
      o[n][3] *= corr1;
    }

    // acc += cast_in(p) . cast_in(v): P's fragments are the A operand
#pragma unroll
    for (int ks = 0; ks < kNT / 2; ++ks) {
      uint32_t pa[4];
      pa[0] = pack2<F16>(s[2 * ks][0], s[2 * ks][1]);
      pa[1] = pack2<F16>(s[2 * ks][2], s[2 * ks][3]);
      pa[2] = pack2<F16>(s[2 * ks + 1][0], s[2 * ks + 1][1]);
      pa[3] = pack2<F16>(s[2 * ks + 1][2], s[2 * ks + 1][3]);
      const int key = ks * 16 + (mi & 1) * 8 + ri;
#pragma unroll
      for (int np = 0; np < kOT; np += 2) {
        const int ch = np + (mi >> 1);
        uint32_t b0, b1, b2, b3;
        ldsm_x4_t(v16_u + key * HD * 2 + ((ch ^ ri) << 4), b0, b1, b2, b3);
        mma16816<F16>(o[np], pa, b0, b1);
        mma16816<F16>(o[np + 1], pa, b2, b3);
      }
    }
  }

  const float den0 = fmaxf(l0, 1e-30f), den1 = fmaxf(l1, 1e-30f);
#pragma unroll
  for (int n = 0; n < kOT; ++n) {
    const int c = n * 8 + 2 * qd;
    if (ra < T)
      *reinterpret_cast<float2*>(out + ((size_t)(b * T + ra) * H + h) * HD + c) =
          make_float2(o[n][0] / den0, o[n][1] / den0);
    if (rb < T)
      *reinterpret_cast<float2*>(out + ((size_t)(b * T + rb) * H + h) * HD + c) =
          make_float2(o[n][2] / den1, o[n][3] / den1);
  }
}

template <int HD, bool F16, bool KV16, typename KVT>
int launch_mma(const float* q, const KVT* k, const KVT* v, float* out,
               int B, int H, int KVH, int T, int S, const long long* st,
               float scale, float cap, int causal, int window, int q_offset,
               int warps, int smem, cudaStream_t stream) {
  auto kern = attn_mma<HD, F16, KV16>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int rows = warps * 16;
  dim3 grid((T + rows - 1) / rows, H, B);
  kern<<<grid, warps * 32, smem, stream>>>(
      q, k, v, out, H, KVH, T, S, st[0], st[1], st[2], st[3], st[4], st[5],
      st[6], st[7], st[8], scale, cap, causal, window, q_offset);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// simt route (fp32 operands)
// ---------------------------------------------------------------------------

constexpr int kSimtWarps = 4;
constexpr int kRowsPerWarp = 4;
constexpr int kBQ = kSimtWarps * kRowsPerWarp;  // 16 query rows per block
constexpr int kBK = 32;                          // keys per tile
constexpr int kMaxChunks = 8;                    // hd <= 256, lane owns hd / 32

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

// NCH = hd / 32 output columns a lane: a template parameter, so the
// accumulators are registers at every hd (no guarded, spilled array)
template <int NCH>
__global__ void __launch_bounds__(kSimtWarps * 32)
attn_simt(const float* __restrict__ q, const float* __restrict__ k,
          const float* __restrict__ v, float* __restrict__ out, int H, int KVH,
          int T, int S, int hd, long long sqb, long long sqt, long long sqh,
          long long skb, long long sks, long long skh, long long svb,
          long long svs, long long svh, float scale, float cap, int causal,
          int window, int q_offset) {
  extern __shared__ float smem_f[];
  float* q_s = smem_f;                    // [kBQ][hd]
  float* k_s = q_s + kBQ * hd;            // [kBK][hd + 1]
  float* v_s = k_s + kBK * (hd + 1);      // [kBK][hd]
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int t0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / KVH);
  const float* qb = q + b * sqb + h * sqh;
  const float* kb = k + b * skb + kvh * skh;
  const float* vb = v + b * svb + kvh * svh;

  for (int i = threadIdx.x; i < kBQ * hd; i += blockDim.x) {
    const int r = i / hd, d = i % hd;
    q_s[i] = (t0 + r < T) ? qb[(t0 + r) * sqt + d] : 0.f;
  }

  float m[kRowsPerWarp], l[kRowsPerWarp], acc[kRowsPerWarp][NCH];
#pragma unroll
  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    m[rr] = -INFINITY;
    l[rr] = 0.f;
#pragma unroll
    for (int c = 0; c < NCH; ++c) acc[rr][c] = 0.f;
  }
  // the last query position of this block: later key tiles are all masked
  const int last_q = q_offset + min(T, t0 + kBQ) - 1;

  for (int kv0 = 0; kv0 < S; kv0 += kBK) {
    if (causal && kv0 > last_q) break;
    __syncthreads();
    for (int i = threadIdx.x; i < kBK * hd; i += blockDim.x) {
      const int j = i / hd, d = i % hd;
      const bool in = kv0 + j < S;
      k_s[j * (hd + 1) + d] = in ? kb[(kv0 + j) * sks + d] : 0.f;
      v_s[j * hd + d] = in ? vb[(kv0 + j) * svs + d] : 0.f;
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
      const float m_safe = isfinite(m_new) ? m_new : 0.f;
      const float p = expf(s - m_safe);
      const float corr = expf(m[rr] - m_safe);
      l[rr] = l[rr] * corr + warp_sum(p);
      m[rr] = m_new;
      float pv[NCH];
#pragma unroll
      for (int c = 0; c < NCH; ++c) pv[c] = 0.f;
      for (int j = 0; j < kBK; ++j) {
        const float pj = __shfl_sync(~0u, p, j);
#pragma unroll
        for (int c = 0; c < NCH; ++c)
          pv[c] = fmaf(pj, v_s[j * hd + lane + 32 * c], pv[c]);
      }
#pragma unroll
      for (int c = 0; c < NCH; ++c) acc[rr][c] = acc[rr][c] * corr + pv[c];
    }
  }
#pragma unroll
  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    const int t = t0 + warp * kRowsPerWarp + rr;
    if (t >= T) continue;
    const float denom = fmaxf(l[rr], 1e-30f);
    float* o = out + ((size_t)(b * T + t) * H + h) * hd;
#pragma unroll
    for (int c = 0; c < NCH; ++c) o[lane + 32 * c] = acc[rr][c] / denom;
  }
}

}  // namespace

// strides: q (b, t, h), k (b, s, h), v (b, s, h) in elements; the last
// dimension is contiguous. `smem` is the wrapper's plan; it is refused when
// it is smaller than the kernel's layout.
// kv16: k and v are 16-bit values of the policy's type (bf16, or fp16 with
// fp16 = 1), read without an fp32 copy; otherwise fp32.
extern "C" int sa_attention_mma_launch(
    const void* q, const void* k, const void* v, void* out, int B, int H,
    int KVH, int T, int S, int hd, long long sqb, long long sqt, long long sqh,
    long long skb, long long sks, long long skh, long long svb, long long svs,
    long long svh, float scale, float cap, int causal, int window,
    int q_offset, int fp16, int kv16, int warps, int smem, void* stream) {
  const long long st[9] = {sqb, sqt, sqh, skb, sks, skh, svb, svs, svh};
  if (warps < 1 || warps > kMaxWarps || smem < mma_smem(hd, kv16, warps))
    return static_cast<int>(cudaErrorInvalidValue);
  const float* qf = static_cast<const float*>(q);
  float* of = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define REPRO_MMA(HD_, F16_)                                                  \
  {                                                                           \
    if (kv16)                                                                 \
      return launch_mma<HD_, F16_, true>(                                     \
          qf, static_cast<const uint16_t*>(k),                                \
          static_cast<const uint16_t*>(v), of, B, H, KVH, T, S, st, scale,    \
          cap, causal, window, q_offset, warps, smem, s);                     \
    return launch_mma<HD_, F16_, false>(                                      \
        qf, static_cast<const float*>(k), static_cast<const float*>(v), of,   \
        B, H, KVH, T, S, st, scale, cap, causal, window, q_offset, warps,     \
        smem, s);                                                             \
  }
  if (hd == 256) {
    if (fp16) REPRO_MMA(256, true);
    REPRO_MMA(256, false);
  }
  if (hd == 128) {
    if (fp16) REPRO_MMA(128, true);
    REPRO_MMA(128, false);
  }
  if (hd == 64) {
    if (fp16) REPRO_MMA(64, true);
    REPRO_MMA(64, false);
  }
#undef REPRO_MMA
  return static_cast<int>(cudaErrorInvalidValue);
}

template <int NCH>
int launch_simt(const float* q, const float* k, const float* v, float* out,
                int B, int H, int KVH, int T, int S, const long long* st,
                float scale, float cap, int causal, int window, int q_offset,
                int smem, cudaStream_t stream) {
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        attn_simt<NCH>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  dim3 grid((T + kBQ - 1) / kBQ, H, B);
  attn_simt<NCH><<<grid, kSimtWarps * 32, smem, stream>>>(
      q, k, v, out, H, KVH, T, S, 32 * NCH, st[0], st[1], st[2], st[3],
      st[4], st[5], st[6], st[7], st[8], scale, cap, causal, window,
      q_offset);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int sa_attention_simt_launch(
    const void* q, const void* k, const void* v, void* out, int B, int H,
    int KVH, int T, int S, int hd, long long sqb, long long sqt, long long sqh,
    long long skb, long long sks, long long skh, long long svb, long long svs,
    long long svh, float scale, float cap, int causal, int window,
    int q_offset, int smem, void* stream) {
  const int need =
      static_cast<int>(sizeof(float)) * (kBQ * hd + kBK * (hd + 1) + kBK * hd);
  if (hd % 32 || hd > 32 * kMaxChunks || smem < need)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long st[9] = {sqb, sqt, sqh, skb, sks, skh, svb, svs, svh};
  const float* qf = static_cast<const float*>(q);
  const float* kf = static_cast<const float*>(k);
  const float* vf = static_cast<const float*>(v);
  float* of = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (hd / 32) {
#define REPRO_SIMT(N_)                                                       \
  case N_:                                                                   \
    return launch_simt<N_>(qf, kf, vf, of, B, H, KVH, T, S, st, scale, cap,  \
                           causal, window, q_offset, smem, s);
    REPRO_SIMT(1)
    REPRO_SIMT(2)
    REPRO_SIMT(3)
    REPRO_SIMT(4)
    REPRO_SIMT(5)
    REPRO_SIMT(6)
    REPRO_SIMT(7)
    REPRO_SIMT(8)
#undef REPRO_SIMT
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
