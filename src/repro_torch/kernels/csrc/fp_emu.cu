// The paper's skewed integer datapath (§III.B, Figs. 5/6) for Hopper
// (sm_90a): (M, K) @ (K, N) through one column of PEs per output, bit-exact.
//
// Replaces the TPU kernel repro/kernels/fp_emu.py `_fma_emu_kernel`, step
// for step: the exact multiply into the 27-bit accumulator, the
// speculative exponent compare against the unnormalized ê, the fix with the
// previous PE's LZA count L, the retimed net shift of the incoming sum,
// truncating alignment, the LZA (coarsened to a multiple of APPROX_COARSE
// in approx mode), and at the column end the deferred normalization and
// one RNE rounding to fp32 (FTZ keeping the sign, saturate to Inf).
//
// Bound. Each output's K chain is serial (truncating alignment does not
// associate, so K is never split), so a GEMM takes at least K times the
// latency of one PE step's dependent instructions; with many outputs in
// flight (prefill) it is bound by instruction issue instead. The design
// shortens both: the dependent path of a step, and the instructions a step.
//
// The carried state is rewritten, not the arithmetic. The TPU kernel
// carries (s, ê, S, L) and computes d = e_m − ê ± L by a compare, an abs
// and a select; in integers d is e_m − (ê − L) in both branches. This
// kernel carries the sum already normalized by its LZA count, T = S << (L +
// 4) (its msb at bit 31 in exact mode, 0 for a zero sum), the exponent tag
// H = e_max + 5 of the step that made it and the count q = L + 4 (T's
// leading zeros, 0xffffffff for a zero sum), so that e_t = ê − L = H − q.
// The retimed normalize || align of S by L − 1 − max(d, 0) is then one
// logical right shift of T by 5 + max(d, 0): the same bits, truncated in
// the same place. The product's significand is carried in one's complement
// when negative, so an arithmetic shift aligns it and truncates its
// magnitude (~x >> n == ~(x >> n)). A zero sum needs no select: q's
// unsigned 0xffffffff, capped at 2^22, puts e_t below every product, which
// then neither shifts nor loses its exponent, as ê = E_ZERO does.
//
// Off the chain, and so free to issue ahead of it: the operands' fields
// (staged per K chunk), the product m_a·m_w·2^c (c pre-applied to A's
// significand, so its msb lands at bit 26 or 27), its sign, its exponent.
// On the chain, per step: the shift amounts (two max), the two aligning
// shifts, one xor, one three-input add, abs, the LZA (bfind), the
// normalizing shift. The state update is four values.
//
// Layout: two kernels, chosen by the wrapper's launch plan from (M, N).
// At decode few chains are in flight, and one warp's in-order issue cannot
// fill a chain's latency with its own off-chain work: fp_emu_pc_kernel
// gives each row of 32 outputs a consumer warp that runs only the chain
// and two producer warps that compute every step's product ahead into a
// shared-memory ring. At prefill issue bounds: fp_emu_kernel gives each
// thread R rows of one column (R chains interleaved, sharing W's field),
// a block four warps of adjacent columns, each warp staging its own
// operands per 32-deep K chunk. Every plan gives every output the same
// bits: an output is one chain, walked k = 0..K-1 in one thread.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kGuard = 3;
constexpr int kAccMsb = 23 + kGuard;   // msb of a normalized significand
constexpr int kEZero = -(1 << 20);     // exponent of an exact zero operand
constexpr uint32_t kBig = 1u << 22;    // LZA count that stands for a zero sum
constexpr int kKC = 32;                // K steps staged per chunk
constexpr int kWarps = 4;              // warps a block (interleaved kernel)
constexpr int kProducers = 2;          // producer warps a consumer

// PTX shifts: an amount of 32 or more gives 0 (logical) or the sign
// (arithmetic). The TPU kernel clamps amounts to 31; on these operands
// (below 2^28, or the one's complement of such) the two agree.
__device__ __forceinline__ uint32_t shr_u(uint32_t x, uint32_t n) {
  uint32_t r;
  asm("shr.u32 %0, %1, %2;" : "=r"(r) : "r"(x), "r"(n));
  return r;
}
__device__ __forceinline__ int shr_s(int x, uint32_t n) {
  int r;
  asm("shr.s32 %0, %1, %2;" : "=r"(r) : "r"(x), "r"(n));
  return r;
}
__device__ __forceinline__ uint32_t shl(uint32_t x, uint32_t n) {
  uint32_t r;
  asm("shl.b32 %0, %1, %2;" : "=r"(r) : "r"(x), "r"(n));
  return r;
}
// leading zeros of x (31 - msb), 0xffffffff for x == 0
__device__ __forceinline__ uint32_t lza(uint32_t x) {
  uint32_t r;
  asm("bfind.shiftamt.u32 %0, %1;" : "=r"(r) : "r"(x));
  return r;
}

// W's container: its raw bits (staged as they are) and their value
template <typename TW>
struct Raw {
  using type = float;
  static __device__ __forceinline__ float value(float x) { return x; }
};
template <>
struct Raw<__nv_bfloat16> {
  using type = unsigned short;
  static __device__ __forceinline__ float value(unsigned short x) {
    return __uint_as_float(static_cast<uint32_t>(x) << 16);
  }
};
template <>
struct Raw<__half> {
  using type = unsigned short;
  static __device__ __forceinline__ float value(unsigned short x) {
    return __half2float(__ushort_as_half(x));
  }
};

__device__ __forceinline__ float load(const void* p, int dt, size_t i) {
  if (dt == 1) return __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i]);
  if (dt == 2) return __half2float(static_cast<const __half*>(p)[i]);
  return static_cast<const float*>(p)[i];
}

// (significand with its hidden bit or 0, unbiased exponent or E_ZERO, sign
// mask) of a value on the format's grid: the fraction is truncated to
// man_bits, as the TPU kernel's _fields does
struct Field {
  int m, e, s;
};
__device__ __forceinline__ Field field(float v, int man_bits) {
  const uint32_t bits = __float_as_uint(v);
  const int e32 = static_cast<int>((bits >> 23) & 0xffu);
  const int frac =
      static_cast<int>((bits >> (23 - man_bits)) & ((1u << man_bits) - 1u));
  return {e32 ? (frac | (1 << man_bits)) : 0, e32 ? e32 - 127 : kEZero,
          static_cast<int>(bits) >> 31};
}

// One chain's carried state: the sum normalized by its LZA count, its sign
// (a mask), H = e_max + 5 of the step that made it, q = L + 4.
struct Chain {
  uint32_t T;
  int sp, H;
  uint32_t q;
};

// Stage 1 of a PE step, the multiplier: none of it depends on the carried
// state. fa: A's (m_a << c, e_a, s_a); fw: W's field.
struct Product {
  int mmc;   // the significand m_a·m_w·2^c (msb at 26 or 27), ~ if negative
  int e_m;   // the exponent
  int e0;    // e_m − hi, hi the significand's bit 27
};
__device__ __forceinline__ Product product(int4 fa, Field fw) {
  const int mm = fa.x * fw.m;      // 0 for a zero operand
  const int e0 = fa.y + fw.e;
  return {mm ^ fa.z ^ fw.s, e0 + (mm >> 27), e0};
}

// Stages 1-2 of a PE step, on the chain: align, add, LZA, normalize. What
// the previous step left before its LZA comes first: with e_t = ê − L = H −
// q (q capped for the exponent: a zero sum lies below every product), d =
// e_m − e_t; the sum aligns by 5 + max(d, 0) (its normalization by L − 1
// included) = max(g + q, 5), the product by max(−d, 0) (with its own
// normalization by hi) = max(p − q, hi).
template <bool APPROX>
__device__ __forceinline__ void pe_chain(Chain& st, Product pr) {
  const int hi = pr.e_m - pr.e0;
  const int sm = pr.mmc >> 31;     // the product's sign, a mask
  const int g = pr.e_m + 5 - st.H;
  const int p = st.H - pr.e0;
  const int nss = -(sm + st.sp);
  const uint32_t qc = min(st.q, kBig);
  const uint32_t sh_s =
      static_cast<uint32_t>(max(g + static_cast<int>(st.q), 5));
  const uint32_t sh_m =
      static_cast<uint32_t>(max(p - static_cast<int>(qc), hi));
  const int e_max = max(pr.e_m, st.H - static_cast<int>(qc));
  const uint32_t sa = shr_u(st.T, sh_s);
  const int mp = shr_s(pr.mmc, sh_m);
  // adder: (±mp) + (±sa), each one's complement plus its sign's 1
  const int v =
      mp + static_cast<int>(sa ^ static_cast<uint32_t>(st.sp)) + nss;
  // LZA and the normalizing shift for the next PE
  const uint32_t so = static_cast<uint32_t>(abs(v));
  uint32_t q = lza(so);
  if (APPROX) q &= ~3u;            // L coarsened to a multiple of 4
  st.T = shl(so, q);
  st.sp = v >> 31;
  st.H = e_max + 5;
  st.q = q;
}

// Column end: the deferred final normalization and the single RNE
// rounding to fp32, FTZ below the normal range keeping the sign, Inf above.
__device__ __forceinline__ float column_end(const Chain& st) {
  const uint32_t sgn = static_cast<uint32_t>(st.sp) << 31;
  if (st.T == 0) return __uint_as_float(sgn);
  const uint32_t c0 = lza(st.T);   // 0 in exact mode
  int e = st.H - static_cast<int>(st.q) - static_cast<int>(c0);
  const int mn = static_cast<int>((st.T << c0) >> 5);
  const int low = mn & ((1 << kGuard) - 1);
  int keep = mn >> kGuard;
  const int half = 1 << (kGuard - 1);
  keep += (low > half) || (low == half && (keep & 1));
  const int ovf = (keep >> 24) != 0;
  keep = ovf ? keep >> 1 : keep;
  e += ovf;
  const int e32 = e + 127;
  uint32_t bits = sgn | (static_cast<uint32_t>(min(max(e32, 0), 255)) << 23) |
                  (static_cast<uint32_t>(keep) & 0x7fffffu);
  if (e32 >= 255) bits = sgn | 0x7f800000u;
  if (e32 <= 0) bits = sgn;
  return __uint_as_float(bits);
}

// One chunk of W down column n into registers: one pointer step a row;
// past K (the last chunk only) a valid element that no step reads.
template <typename WRaw>
__device__ __forceinline__ void fetch_w(WRaw (&w_r)[kKC],
                                        const WRaw* __restrict__ w, int k0,
                                        int K, int N, int n) {
  const WRaw* p = w + (size_t)k0 * N + min(n, N - 1);
  if (k0 + kKC <= K) {
#pragma unroll
    for (int j = 0; j < kKC; ++j, p += N) w_r[j] = *p;
  } else {
#pragma unroll
    for (int j = 0; j < kKC; ++j) {
      w_r[j] = *p;
      if (k0 + j + 1 < K) p += N;
    }
  }
}

template <typename TW, int R, bool APPROX>
__global__ void __launch_bounds__(32 * kWarps)
fp_emu_kernel(const void* __restrict__ a,
              const typename Raw<TW>::type* __restrict__ w,
              float* __restrict__ out, int M, int N, int K, int a_dt,
              int man_bits) {
  using WRaw = typename Raw<TW>::type;
  // per warp: A's fields of its R rows and W's raw values of its 32
  // columns, for one K chunk
  __shared__ int4 a_s[kWarps][R][kKC];
  __shared__ WRaw w_s[kWarps][kKC][32];
  const int lane = threadIdx.x, wy = threadIdx.y;
  const int n = (blockIdx.x * kWarps + wy) * 32 + lane;
  const int m0 = blockIdx.y * R;
  if ((blockIdx.x * kWarps + wy) * 32 >= N) return;   // a spare warp
  const bool col = n < N;
  // A's significand pre-shifted so that a product's msb lands at 26 or 27
  const int c = kAccMsb - 2 * man_bits;

  float a_r[R];
  WRaw w_r[kKC];
  auto fetch = [&](int k0) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int m = m0 + r, k = k0 + lane;
      a_r[r] = (m < M && k < K) ? load(a, a_dt, (size_t)m * K + k) : 0.f;
    }
    fetch_w<WRaw>(w_r, w, k0, K, N, n);
  };

  Chain st[R];
#pragma unroll
  for (int r = 0; r < R; ++r) st[r] = {0u, 0, 0, 0xffffffffu};

  fetch(0);
  for (int k0 = 0; k0 < K; k0 += kKC) {
    const int len = min(kKC, K - k0);
    __syncwarp();   // every lane is done with the previous chunk
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const Field f = field(a_r[r], man_bits);
      a_s[wy][r][lane] = make_int4(f.m << c, f.e, f.s, 0);
    }
#pragma unroll
    for (int j = 0; j < kKC; ++j) w_s[wy][j][lane] = w_r[j];
    __syncwarp();
    // the next chunk's loads fly while this chunk's steps run
    if (k0 + kKC < K) fetch(k0 + kKC);
    // exactly K steps: a zero product is not a no-op (it normalizes the
    // carried sum)
#pragma unroll 4
    for (int kk = 0; kk < len; ++kk) {
      const Field fw = field(Raw<TW>::value(w_s[wy][kk][lane]), man_bits);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        pe_chain<APPROX>(st[r], product(a_s[wy][r][kk], fw));
      }
    }
  }
  if (!col) return;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    if (m0 + r < M) out[(size_t)(m0 + r) * N + n] = column_end(st[r]);
  }
}

// Named barriers of the producer/consumer kernel (0 is __syncthreads'):
// bar.arrive releases what the arriving warps wrote or read in shared
// memory to the warps that bar.sync on the same barrier.
constexpr int kRing = 2;              // chunks in flight between the warps
constexpr int kBarFull = 1;           // kBarFull + b: chunk b of the ring full
constexpr int kBarEmpty = 1 + kRing;  // kBarEmpty + b: chunk b read
__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(threads) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

// The warp-specialized form for the plans where few chains are in flight
// (decode), so each chain's latency, not issue, sets the time: a block is
// one row of 32 outputs, one consumer warp and P producer warps (the
// launch uses kProducers). Producer p stages A's and W's fields and
// computes steps [p·32/P, (p+1)·32/P) of every 32-deep chunk — each
// step's product: significand, exponent,
// exponent − hi, 8 bytes, the zero product's exponent saturated at -2^14,
// which still lies below every sum — into a ring of kRing chunks in shared
// memory; warp 0, the consumer, runs only the chain on them. Each warp's
// instruction stream is then its own part, and neither stalls the other's
// in-order issue; P producers keep up with the chain's pace.
template <typename TW, bool APPROX, int P>
__global__ void __launch_bounds__(32 * (1 + P))
fp_emu_pc_kernel(const void* __restrict__ a,
                 const typename Raw<TW>::type* __restrict__ w,
                 float* __restrict__ out, int M, int N, int K, int a_dt,
                 int man_bits) {
  using WRaw = typename Raw<TW>::type;
  constexpr int kSteps = kKC / P;       // a producer's steps of a chunk
  constexpr int kThreads = 32 * (1 + P);
  __shared__ int2 ring[kRing][kKC][32];
  __shared__ int4 a_s[P][kKC];
  const int lane = threadIdx.x;
  const int n = blockIdx.x * 32 + lane;
  const int m = blockIdx.y;
  const int chunks = (K + kKC - 1) / kKC;
  if (threadIdx.y > 0) {                // producer p
    const int p = threadIdx.y - 1, kb = p * kSteps;
    const int c = kAccMsb - 2 * man_bits;
    WRaw w_r[kSteps], w_c[kSteps];
    float a_r = lane < K ? load(a, a_dt, (size_t)m * K + lane) : 0.f;
    auto fetch = [&](int k0) {          // this producer's rows of W
      const WRaw* q = w + (size_t)min(k0 + kb, K - 1) * N + min(n, N - 1);
      if (k0 + kb + kSteps <= K) {
#pragma unroll
        for (int j = 0; j < kSteps; ++j, q += N) w_r[j] = *q;
      } else {                          // the last chunk: stop at K - 1
#pragma unroll
        for (int j = 0; j < kSteps; ++j) {
          w_r[j] = *q;
          if (k0 + kb + j + 1 < K) q += N;
        }
      }
    };
    // one step's product into the ring, its exponents in 16 bits
    auto produce = [&](int b, int j) {
      const Product pr = product(
          a_s[p][kb + j], field(Raw<TW>::value(w_c[j]), man_bits));
      const int e_m = max(pr.e_m, -(1 << 14));
      const int e0 = max(pr.e0, -(1 << 14));
      ring[b][kb + j][lane] = make_int2(
          pr.mmc, static_cast<int>((static_cast<uint32_t>(e_m) << 16) |
                                   (static_cast<uint32_t>(e0) & 0xffffu)));
    };
    // a chunk's set-up: A's fields, the next chunk's loads in flight, the
    // ring's slot b free again
    auto begin = [&](int ci) {
      const int k0 = ci * kKC, b = ci % kRing;
      __syncwarp();
      const Field fa = field(a_r, man_bits);
      a_s[p][lane] = make_int4(fa.m << c, fa.e, fa.s, 0);
      __syncwarp();
#pragma unroll
      for (int j = 0; j < kSteps; ++j) w_c[j] = w_r[j];
      if (ci + 1 < chunks) {
        const int k = k0 + kKC + lane;
        a_r = k < K ? load(a, a_dt, (size_t)m * K + k) : 0.f;
        fetch(k0 + kKC);
      }
      if (ci >= kRing) bar_sync(kBarEmpty + b, kThreads);
      return b;
    };
    fetch(0);
    const int full = K / kKC;           // chunks of kKC steps
    for (int ci = 0; ci < full; ++ci) {
      const int b = begin(ci);
#pragma unroll
      for (int j = 0; j < kSteps; ++j) produce(b, j);
      bar_arrive(kBarFull + b, kThreads);
    }
    if (full < chunks) {                // the ragged last chunk
      const int b = begin(full), len = K - full * kKC;
#pragma unroll
      for (int j = 0; j < kSteps; ++j) {
        if (kb + j < len) produce(b, j);
      }
      bar_arrive(kBarFull + b, kThreads);
    }
    return;
  }
  Chain st{0u, 0, 0, 0xffffffffu};      // the consumer
  for (int ci = 0; ci < chunks; ++ci) {
    const int len = min(kKC, K - ci * kKC), b = ci % kRing;
    bar_sync(kBarFull + b, kThreads);
#pragma unroll 4
    for (int kk = 0; kk < len; ++kk) {
      const int2 d = ring[b][kk][lane];
      pe_chain<APPROX>(
          st, {d.x, d.y >> 16,
               static_cast<int>(static_cast<uint32_t>(d.y) << 16) >> 16});
    }
    if (ci + kRing < chunks) bar_arrive(kBarEmpty + b, kThreads);
  }
  if (n < N) out[(size_t)m * N + n] = column_end(st);
}

template <typename TW>
cudaError_t launch_pc(dim3 grid, cudaStream_t st, const void* a,
                      const void* w, float* out, int M, int N, int K,
                      int a_dt, int man_bits, int approx) {
  const auto* wt = static_cast<const typename Raw<TW>::type*>(w);
  const dim3 block(32, 1 + kProducers);
  if (approx) {
    fp_emu_pc_kernel<TW, true, kProducers><<<grid, block, 0, st>>>(
        a, wt, out, M, N, K, a_dt, man_bits);
  } else {
    fp_emu_pc_kernel<TW, false, kProducers><<<grid, block, 0, st>>>(
        a, wt, out, M, N, K, a_dt, man_bits);
  }
  return cudaGetLastError();
}

template <typename TW, int R>
cudaError_t launch_rows(dim3 grid, dim3 block, cudaStream_t st,
                        const void* a, const void* w, float* out, int M,
                        int N, int K, int a_dt, int man_bits, int approx) {
  const auto* wt = static_cast<const typename Raw<TW>::type*>(w);
  if (approx) {
    fp_emu_kernel<TW, R, true><<<grid, block, 0, st>>>(a, wt, out, M, N, K,
                                                       a_dt, man_bits);
  } else {
    fp_emu_kernel<TW, R, false><<<grid, block, 0, st>>>(a, wt, out, M, N, K,
                                                        a_dt, man_bits);
  }
  return cudaGetLastError();
}

template <typename TW>
cudaError_t launch_typed(int rows, dim3 grid, dim3 block, cudaStream_t st,
                         const void* a, const void* w, float* out, int M,
                         int N, int K, int a_dt, int man_bits, int approx) {
  switch (rows) {
    case 1:
      return launch_rows<TW, 1>(grid, block, st, a, w, out, M, N, K, a_dt,
                                man_bits, approx);
    case 2:
      return launch_rows<TW, 2>(grid, block, st, a, w, out, M, N, K, a_dt,
                                man_bits, approx);
    case 4:
      return launch_rows<TW, 4>(grid, block, st, a, w, out, M, N, K, a_dt,
                                man_bits, approx);
    default:
      return cudaErrorInvalidValue;
  }
}

// The chain's latency, for the bound: one thread walks `steps` PE steps
// of one output with the same product at every step, read from memory, so
// the multiplier's work is loop-invariant and leaves the loop, and what the
// loop runs is the chain's dependent path alone (exact mode). clock64
// cycles a step go to cycles[0], the final sum to cycles[1] (keeping the
// chain alive).
__global__ void fp_emu_chain_probe(const int* __restrict__ in, int steps,
                                   long long* __restrict__ cycles) {
  const Product pr =
      product(make_int4(in[0], in[1], in[2], 0), {in[3], in[4], in[5]});
  Chain st{0u, 0, 0, 0xffffffffu};
  const long long t0 = clock64();
  for (int i = 0; i < steps; ++i) pe_chain<false>(st, pr);
  const long long t1 = clock64();
  cycles[0] = t1 - t0;
  cycles[1] = static_cast<long long>(__float_as_uint(column_end(st)));
}

}  // namespace

// a (M, K), w (K, N) contiguous; dtype codes 0 fp32, 1 bf16, 2 fp16;
// pc = 1: the producer/consumer kernel (a block a row of 32 outputs), else
// the interleaved one with rows = chains a thread (1, 2 or 4), kWarps
// warps a block. The wrapper's launch plan picks them. Returns
// cudaGetLastError().
extern "C" int fp_emu_launch(const void* a, const void* w, void* out, int M,
                             int N, int K, int a_dt, int w_dt, int man_bits,
                             int approx, int pc, int rows, void* stream) {
  if (K < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int strips = (N + 31) / 32;
  float* o = static_cast<float*>(out);
  cudaError_t err = cudaErrorInvalidValue;
  if (pc) {
    const dim3 grid(strips, M);
    if (w_dt == 0) {
      err = launch_pc<float>(grid, st, a, w, o, M, N, K, a_dt, man_bits,
                             approx);
    } else if (w_dt == 1) {
      err = launch_pc<__nv_bfloat16>(grid, st, a, w, o, M, N, K, a_dt,
                                     man_bits, approx);
    } else if (w_dt == 2) {
      err = launch_pc<__half>(grid, st, a, w, o, M, N, K, a_dt, man_bits,
                              approx);
    }
    return static_cast<int>(err);
  }
  const dim3 block(32, kWarps);
  const dim3 grid((strips + kWarps - 1) / kWarps, (M + rows - 1) / rows);
  if (w_dt == 0) {
    err = launch_typed<float>(rows, grid, block, st, a, w, o, M, N, K, a_dt,
                              man_bits, approx);
  } else if (w_dt == 1) {
    err = launch_typed<__nv_bfloat16>(rows, grid, block, st, a, w, o, M, N,
                                      K, a_dt, man_bits, approx);
  } else if (w_dt == 2) {
    err = launch_typed<__half>(rows, grid, block, st, a, w, o, M, N, K,
                               a_dt, man_bits, approx);
  }
  return static_cast<int>(err);
}

// The chain-latency probe: in = (m_a << c, e_a, s_a, m_w, e_w, s_w) int32 on
// the card, cycles = 2 int64. Returns cudaGetLastError().
extern "C" int fp_emu_chain_probe_launch(const void* in, int steps,
                                         void* cycles, void* stream) {
  fp_emu_chain_probe<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(in), steps, static_cast<long long*>(cycles));
  return static_cast<int>(cudaGetLastError());
}
