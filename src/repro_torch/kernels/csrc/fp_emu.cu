// The paper's skewed integer datapath (§III.B, Figs. 5/6) for Hopper
// (sm_90a): (M, K) @ (K, N) through one column of PEs per output, bit-exact.
//
// Replaces the TPU kernel repro/kernels/fp_emu.py `_fma_emu_kernel`, step
// for step: the exact multiply into the 27-bit accumulator, the
// speculative exponent compare against the unnormalized ê, the fix with the
// previous PE's LZA count L (d = d' + L or L - d'), the retimed net shift of
// the incoming sum, truncating alignment, the LZA (coarsened to a multiple
// of APPROX_COARSE in approx mode), and at the column end the deferred
// normalization and one RNE rounding to fp32 (FTZ keeping the sign,
// saturate to Inf). All state is int32, as on the TPU.
//
// Design. One thread per output (m, n) walks K in order: the chain along K
// is the paper's subject, and truncating alignment does not associate, so
// K is never split. A block is 32 columns (one warp) x TM rows (TM = 1, 2,
// 4 or 8 = blockDim.y, a template parameter). It stages KC = 32 rows of K
// at a time in shared memory as pre-extracted fields, so each operand's
// (s, e, m) is decoded once per block rather than once per use: a warp
// reads one A field (broadcast) and 32 consecutive W fields per step. The
// next chunk's loads are issued before the current chunk's steps.
//
// Bound. Each PE step is ~60 dependent int32 operations in the source
// below (fp_emu.py OPS_PER_STEP; fewer in SASS, which chip_smoke.py counts):
// the kernel is bound by instruction issue when enough outputs are in
// flight (prefill), and by the latency of the serial K chain when few are
// (decode, M = 2: 2*N threads each walking K dependent steps).
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kGuard = 3;
constexpr int kAccMsb = 23 + kGuard;      // P: msb of a normalized significand
constexpr int kQ = kAccMsb + 1;           // anchor of unnormalized sums
constexpr int kEZero = -(1 << 20);        // exponent of an exact zero
constexpr int kApproxCoarse = kGuard + 1; // coarse-LZA shift quantum
constexpr int kKC = 32;                   // K rows per shared-memory stage
constexpr int kTN = 32;                   // output columns per block

// floor(log2(x)) for x > 0 (the TPU kernel's _msb(max(x, 1)) for x >= 1)
__device__ __forceinline__ int msb(int x) { return 31 - __clz(x); }
__device__ __forceinline__ int clamp31(int n) { return min(max(n, 0), 31); }
// shifts of non-negative values, amounts clamped to [0, 31] as on the TPU
// (a C++ shift by 32 or more is undefined); left shifts on uint32
__device__ __forceinline__ int shl(int x, int n) {
  return static_cast<int>(static_cast<uint32_t>(x) << clamp31(n));
}
__device__ __forceinline__ int shr(int x, int n) { return x >> clamp31(n); }
// the retimed bidirectional normalize || align shifter of Fig. 6
__device__ __forceinline__ int net_shift(int x, int left) {
  return left >= 0 ? shl(x, left) : shr(x, -left);
}

__device__ __forceinline__ float load(const void* p, int dt, size_t i) {
  if (dt == 1) return __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i]);
  if (dt == 2) return __half2float(static_cast<const __half*>(p)[i]);
  return static_cast<const float*>(p)[i];
}

// Pre-extracted operand: x = e - man_bits (so that a product's exponent is
// xa + xb + msb(ma * mb)), y = s << 16 | m (m with its hidden bit, 0 for a
// zero). Values must already lie on the format's grid: the fraction is
// truncated, as the TPU kernel's _fields does.
__device__ __forceinline__ int2 field(float v, int man_bits) {
  const uint32_t bits = __float_as_uint(v);
  const int s = static_cast<int>(bits >> 31);
  const int e32 = static_cast<int>((bits >> 23) & 0xffu);
  const int frac =
      static_cast<int>((bits >> (23 - man_bits)) & ((1u << man_bits) - 1u));
  const int m = e32 > 0 ? (frac | (1 << man_bits)) : 0;
  const int e = m == 0 ? kEZero : e32 - 127;
  return make_int2(e - man_bits, (s << 16) | m);
}

// Fields of one staged operand value; 0 stands for an element past the
// edge of A or W, whose field is never read.
__device__ __forceinline__ int2 staged(float v, bool in, int man_bits) {
  return in ? field(v, man_bits) : make_int2(0, 0);
}

template <int TM>
__global__ void __launch_bounds__(kTN * TM)
fp_emu_kernel(const void* __restrict__ a, const void* __restrict__ w,
              float* __restrict__ out, int M, int N, int K, int a_dt,
              int w_dt, int man_bits, int approx) {
  // per chunk each thread moves one element of A (row ty, k = tx) and
  // kWPer of W (k = ty + j * TM, column tx)
  constexpr int kWPer = kKC / TM;
  __shared__ int2 a_s[TM][kKC];
  __shared__ int2 w_s[kKC][kTN];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int m0 = blockIdx.y * TM, n0 = blockIdx.x * kTN;
  const int L_mask = approx ? ~(kApproxCoarse - 1) : ~0;
  const bool a_row = m0 + ty < M, w_col = n0 + tx < N;

  // The next chunk's raw values are fetched into registers before the
  // current chunk's PE steps run, so the global loads are in flight
  // during the chain instead of stalling it (at decode each SM holds one
  // or two warps and nothing else hides them).
  float a_r, w_r[kWPer];
  auto fetch = [&](int k0) {
    a_r = (a_row && k0 + tx < K)
              ? load(a, a_dt, (size_t)(m0 + ty) * K + k0 + tx) : 0.f;
#pragma unroll
    for (int j = 0; j < kWPer; ++j) {
      const int k = k0 + ty + j * TM;
      w_r[j] = (w_col && k < K) ? load(w, w_dt, (size_t)k * N + n0 + tx)
                                : 0.f;
    }
  };

  // the unnormalized partial (s, ê, S) and the LZA count L forwarded to
  // the next PE
  int s_p = 0, ehat = kEZero, S = 0, L = 0;

  fetch(0);
  for (int k0 = 0; k0 < K; k0 += kKC) {
    const int len = min(kKC, K - k0);
    __syncthreads();
    a_s[ty][tx] = staged(a_r, a_row && tx < len, man_bits);
#pragma unroll
    for (int j = 0; j < kWPer; ++j) {
      w_s[ty + j * TM][tx] = staged(w_r[j], w_col && ty + j * TM < len,
                                    man_bits);
    }
    __syncthreads();
    if (k0 + kKC < K) fetch(k0 + kKC);
    // only the real K rows: a zero product is not a no-op (it normalizes
    // the carried sum), so the chain takes exactly K steps
#pragma unroll 4
    for (int kk = 0; kk < len; ++kk) {
      const int2 fa = a_s[ty][kk];
      const int2 fw = w_s[kk][tx];
      // stage 1: multiplier, exact in the wide register
      const int mm = (fa.y & 0xffff) * (fw.y & 0xffff);
      const int pm_msb = msb(max(mm, 1));
      const int e_m = mm == 0 ? kEZero : fa.x + fw.x + pm_msb;
      const int m_m = shl(mm, kAccMsb - pm_msb);
      const int s_m = (fa.y ^ fw.y) >> 16;
      // stage 1: speculative exponent compute against ê
      const bool ge = e_m >= ehat;
      const int d_spec = abs(e_m - ehat);
      // stage 2: fix with the forwarded L of the previous PE
      const int d_fix = ge ? d_spec + L : L - d_spec;
      const bool zero_prev = S == 0;
      const int e_max = zero_prev ? e_m : (d_fix > 0 ? e_m : ehat - L);
      // retimed normalize || align: one net shift of the incoming sum
      const int acc_net_left = (L - 1) - max(d_fix, 0);
      const int Sa = zero_prev ? 0 : net_shift(S, acc_net_left);
      const int mp = e_m == kEZero ? 0 : shr(m_m, max(-d_fix, 0));
      // adder + LZA
      const int v = (s_m ? -mp : mp) + (s_p ? -Sa : Sa);
      const int S_o = abs(v);
      const int L_o = (kQ - msb(max(S_o, 1))) & L_mask;
      const bool z = S_o == 0;
      s_p = z ? 0 : (v < 0);
      ehat = z ? kEZero : e_max + 1;
      S = S_o;
      L = z ? 0 : L_o;
    }
  }

  const int m = m0 + ty, n = n0 + tx;
  if (m >= M || n >= N) return;
  // column end: deferred final normalization + the single rounding stage
  const int Ln = kQ - msb(max(S, 1));
  int e = ehat - Ln;
  const int mn = net_shift(S, Ln - 1);
  const int low = mn & ((1 << kGuard) - 1);
  int keep = mn >> kGuard;
  const int half = 1 << (kGuard - 1);
  keep += (low > half) || (low == half && (keep & 1));
  const int ovf = (keep >> 24) != 0;
  keep = ovf ? keep >> 1 : keep;
  e += ovf;
  // bit-exact fp32 construction: FTZ below the normal range keeping the
  // sign, Inf above it
  const int e32 = e + 127;
  const uint32_t sgn = static_cast<uint32_t>(s_p) << 31;
  uint32_t bits = sgn | (static_cast<uint32_t>(min(max(e32, 0), 255)) << 23) |
                  (static_cast<uint32_t>(keep) & 0x7fffffu);
  if (e32 >= 255) bits = sgn | 0x7f800000u;
  if (S == 0 || e32 <= 0) bits = sgn;
  out[(size_t)m * N + n] = __uint_as_float(bits);
}

}  // namespace

// a (M, K), w (K, N) contiguous; dtype codes 0 fp32, 1 bf16, 2 fp16;
// tm = rows per block (1, 2, 4 or 8). Returns cudaGetLastError().
extern "C" int fp_emu_launch(const void* a, const void* w, void* out, int M,
                             int N, int K, int a_dt, int w_dt, int man_bits,
                             int approx, int tm, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  dim3 block(kTN, tm);
  dim3 grid((N + kTN - 1) / kTN, (M + tm - 1) / tm);
  float* o = static_cast<float*>(out);
  switch (tm) {
    case 1:
      fp_emu_kernel<1><<<grid, block, 0, st>>>(a, w, o, M, N, K, a_dt, w_dt,
                                               man_bits, approx);
      break;
    case 2:
      fp_emu_kernel<2><<<grid, block, 0, st>>>(a, w, o, M, N, K, a_dt, w_dt,
                                               man_bits, approx);
      break;
    case 4:
      fp_emu_kernel<4><<<grid, block, 0, st>>>(a, w, o, M, N, K, a_dt, w_dt,
                                               man_bits, approx);
      break;
    case 8:
      fp_emu_kernel<8><<<grid, block, 0, st>>>(a, w, o, M, N, K, a_dt, w_dt,
                                               man_bits, approx);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
