// Exact f32 integer arithmetic and the shared building blocks of the block
// kernels (mlp_block.cu, and the attention chain of attn_chain.cuh; ivit.cuh
// adds the ivit nonlinearities for them and for nonlinear.cu).
//
// Every helper reproduces the JAX construction of ivit_tpu/ops/quant.py and
// ivit_tpu/ops/pallas/block.py operation for operation, so the kernels give
// the reference's bits:
//   * rdiv / exact_fma keep the Dekker residual and two-product, written with
//     the _rn intrinsics, which are never contracted into an FMA; the whole
//     file is also built with --fmad=false, so plain `a * b + c` rounds twice
//     as written (the fast_poly form and the residual products rely on it);
//   * the two-limb sums keep their int32 limbs and their fixed f32
//     recombination order (they round twice above 2**24);
//   * round is rintf (half to even), 2**k is a bit construction, sqrt is the
//     IEEE __fsqrt_rn, int32 -> f32 is round to nearest;
//   * a NaN LN output (an ibert all-zero padding row) is pinned to 0 before
//     its int8 requant, as the plain version does;
//   * where every f32 step of a chain is an exact integer (ln_row_i32, the
//     attention cores' exps), it runs in int32 to the same bits.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace ivit {

constexpr int kThreads = 256;   // 8 warps per block
constexpr int kTileK = 64;      // K depth per staged weight tile (32 for
                                // the 96-column pass)
constexpr int kBsLd = kTileK + 16;  // weight tile row stride: conflict-free fragments
constexpr int kMaxLnVals = 32;  // C <= 1024: 32 values per lane

// The ibert constants of ivit_tpu/ops/ibert.py, each the f32 rounding of the
// double the Python source writes (decimal -> double -> f32), as both
// frameworks round them.
constexpr float kGeluK = (float)1.4142;
constexpr float kGeluA = (float)-0.2888;
constexpr float kGeluB = (float)-1.769;
constexpr float kGeluC = (float)(1.0 / -0.2888);
constexpr float kExpX0 = (float)-0.6931;
constexpr float kExpB = (float)(0.96963238 / 0.35815147);
constexpr float kExpC = (float)(1.0 / 0.35815147);

__device__ __forceinline__ float split_hi(float x) {
  return __int_as_float(__float_as_int(x) & -4096);
}

// Correctly rounded a / b plus JAX's Dekker residual step (quant.rdiv).
__device__ __forceinline__ float rdiv(float a, float b) {
  float q = __fdiv_rn(a, b);
  float qh = split_hi(q), ql = __fsub_rn(q, qh);
  float bh = split_hi(b), bl = __fsub_rn(b, bh);
  float r = __fsub_rn(a, __fmul_rn(qh, bh));
  r = __fsub_rn(r, __fmul_rn(qh, bl));
  r = __fsub_rn(r, __fmul_rn(ql, bh));
  r = __fsub_rn(r, __fmul_rn(ql, bl));
  return __fadd_rn(q, __fdiv_rn(r, b));
}

__device__ __forceinline__ void two_sum(float x, float y, float& s, float& e) {
  s = __fadd_rn(x, y);
  float yy = __fsub_rn(s, x);
  e = __fadd_rn(__fsub_rn(x, __fsub_rn(s, yy)), __fsub_rn(y, yy));
}

// a * b + c rounded once, as quant.exact_fma builds it.
__device__ __forceinline__ float exact_fma(float a, float b, float c) {
  float ah = split_hi(a), al = __fsub_rn(a, ah);
  float bh = split_hi(b), bl = __fsub_rn(b, bh);
  float s, e1, e2, e3, e4;
  two_sum(c, __fmul_rn(ah, bh), s, e1);
  two_sum(s, __fmul_rn(ah, bl), s, e2);
  two_sum(s, __fmul_rn(al, bh), s, e3);
  two_sum(s, __fmul_rn(al, bl), s, e4);
  return __fadd_rn(s, __fadd_rn(__fadd_rn(e1, e2), __fadd_rn(e3, e4)));
}

// Exact floor(x / b) for f32-held integers (quant.floor_div_int).
__device__ __forceinline__ float floor_div_int(float x, float b) {
  float q = floorf(x * __fdiv_rn(1.0f, b));
  float r = x - q * b;
  float sgn = b > 0.f ? 1.f : (b < 0.f ? -1.f : 0.f);
  float rs = r * sgn;
  return (q - (rs < 0.f ? 1.f : 0.f)) + (rs >= fabsf(b) ? 1.f : 0.f);
}

// Exact 2**k for integer-valued k (quant.pow2).
__device__ __forceinline__ float pow2(float k) {
  int ki = (int)fminf(fmaxf(k, -126.f), 127.f);
  return __int_as_float((ki + 127) << 23);
}

// The LN shift's exact power 2**shift, its inverse and the shift as pow2
// clamps it (bits: pw's exponent, ln_row_i32's arithmetic shift), from the
// spec's 0-d shift leaf.
struct LnShift {
  float pw, inv_pw;
  int bits;
};
__device__ __forceinline__ LnShift ln_shift_of(const float* shift) {
  const float pw = pow2(__ldg(shift));
  return {pw, __fdiv_rn(1.f, pw), ((__float_as_int(pw) >> 23) & 255) - 127};
}

__device__ __forceinline__ float clampf(float v, float lo, float hi) {
  return fminf(fmaxf(v, lo), hi);
}

// clip(round(acc * m)) to the signed range [-lim, lim - 1].
__device__ __forceinline__ float requant(float acc, float m, float lim) {
  return clampf(rintf(acc * m), -lim, lim - 1.f);
}

__device__ __forceinline__ float bits_lim(int bits) {
  return (float)(1 << (bits - 1));
}

// Sum over the L-lane group of this lane (lanes L g .. L g + L - 1; L a
// power of two, the whole warp by default).  Every lane of the warp takes
// part.
template <int L = 32>
__device__ __forceinline__ int warp_sum(int v) {
  for (int o = L / 2; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// The same over the four lanes of a quad (lanes 4g .. 4g + 3), which hold
// one row of an mma accumulator tile.
__device__ __forceinline__ int quad_sum(int v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

// Two-limb exact sum of integer-valued f32 (quant.exact_int_sum): each lane
// adds its values' limbs into sh / sl, limb_total reduces them over the warp
// and recombines once in f32.
__device__ __forceinline__ void limb_add(int& sh, int& sl, float x) {
  x = clampf(x, -2147483648.f, 2147483648.f);
  const float h = floorf(x * 0.00390625f);
  sh += (int)h;
  sl += (int)(x - h * 256.f);
}

template <int L = 32>
__device__ __forceinline__ float limb_total(int sh, int sl) {
  sh = warp_sum<L>(sh);
  sl = warp_sum<L>(sl);
  return __fadd_rn(__fmul_rn(__int2float_rn(sh), 256.f), __int2float_rn(sl));
}

// The LayerNorms of the kernels (the wrappers' codes): the ibert LN with
// floor(sqrt), I-LayerNorm, the ibert LN with I-BERT's integer sqrt.
constexpr int kLnIbert = 0, kLnIvit = 1, kLnIbertIntSqrt = 2;

// floor(log2(n)) of an f32 n >= 1 with log2 correctly rounded to f32
// (ops/ibert.py floor_log2_rn): n's exponent e, plus one where its 24-bit
// mantissa lies within the slack of 2**24 for k = e + 1, i.e. log2(n)
// within half the f32 spacing below k, which rounds up to k.
__device__ __forceinline__ int floor_log2_rn(float n) {
  const int b = __float_as_int(n);
  const int e = ((b >> 23) & 255) - 127, k = e + 1;
  const int m = (b & 0x7fffff) | 0x800000;
  const int slack = k <= 2    ? 0
                    : k <= 4  ? 1
                    : k <= 8  ? 2
                    : k <= 16 ? 5
                    : k <= 32 ? 11
                    : k <= 64 ? 22
                              : 44;
  return e + (m >= 0x1000000 - slack ? 1 : 0);
}

// I-BERT's integer sqrt of the f32-held integer n >= 0 (ibert.py
// int_bitlength_sqrt): the seed 2**ceil(bits / 2), bits = floor_log2_rn(n)
// + 1, then 4 steps x = floor((x + floor(n / x)) / 2), each the f32
// operation of the plain version, so the same root for every n; 0 for
// n = 0.
__device__ __noinline__ float int_bitlength_sqrt(float n) {
  if (!(n > 0.f)) return 0.f;
  const float bits = (float)(floor_log2_rn(fmaxf(n, 1.f)) + 1);
  float x = pow2(ceilf(bits * 0.5f));
  for (int i = 0; i < 4; ++i)
    x = floorf(__fmul_rn(__fadd_rn(x, floorf(rdiv(n, fmaxf(x, 1.f)))), 0.5f));
  return x;
}

// The ibert LN's root: floor(sqrt(var)), or with isqrt I-BERT's integer
// sqrt.
__device__ __forceinline__ float ibert_root(float var, bool isqrt) {
  return floorf(isqrt ? int_bitlength_sqrt(var) : __fsqrt_rn(var));
}

// ivit integer Newton sqrt: 10 steps k = floor((k + floor(v / k)) / 2) from
// k = 2**16 (block.py _newton_sqrt; ivit.int_newton_sqrt).
__device__ __forceinline__ float newton_sqrt(float v) {
  float k = 65536.f;
#pragma unroll
  for (int i = 0; i < 10; ++i) k = floorf((k + floorf(rdiv(v, k))) * 0.5f);
  return k;
}

// One warp: LayerNorm of one row of C activations (XT: int8, or int16 on
// Swin's stream; C % 32 == 0, C <= 1024), plus its bias and int8 requant,
// into out_row.  IVIT: I-LayerNorm (block.py _i_layernorm, Newton sqrt, no
// shift); else the ibert LN with the frozen shift 2**shift = pw (block.py
// _ibert_layernorm, floor(sqrt), or with isqrt the integer sqrt of the
// unfused engine).  Both end in _ln_requant.  On the 16-bit
// stream |y| < 2**16: the limbs a = floor(y / 256) (|a| <= 256) and b keep
// every square sum an exact int32 up to C = 1024.
template <bool IVIT, typename XT>
__device__ __forceinline__ void ln_row(const XT* __restrict__ xrow, int C,
                                       const float* __restrict__ bias,
                                       const float* __restrict__ m_ln,
                                       float pw, float inv_pw, int8_t* out_row,
                                       int lane, bool isqrt = false) {
  float v[kMaxLnVals];
  const int nv = C >> 5;
  int sh = 0, sl = 0;
#pragma unroll
  for (int i = 0; i < kMaxLnVals; ++i) {
    if (i < nv) {
      v[i] = (float)xrow[lane + 32 * i];
      limb_add(sh, sl, v[i]);
    }
  }
  float mean = rintf(rdiv(limb_total(sh, sl), (float)C));
  int saa = 0, sab = 0, sbb = 0;
#pragma unroll
  for (int i = 0; i < kMaxLnVals; ++i) {
    if (i < nv) {
      float y = IVIT ? v[i] - mean : floorf((v[i] - mean) * inv_pw);
      float a = floorf(y * 0.00390625f);
      float b = y - a * 256.f;
      saa += (int)(a * a);
      sab += (int)(a * b);
      sbb += (int)(b * b);
    }
  }
  saa = warp_sum(saa);
  sab = warp_sum(sab);
  sbb = warp_sum(sbb);
  float var = __fadd_rn(__fmul_rn(__int2float_rn(saa), 65536.f),
                        __fadd_rn(__fmul_rn(__int2float_rn(sab), 512.f),
                                  __int2float_rn(sbb)));
  float stdv = IVIT ? newton_sqrt(var) : ibert_root(var, isqrt) * pw;
  float factor = floorf(rdiv(2147483648.f, stdv));
#pragma unroll
  for (int i = 0; i < kMaxLnVals; ++i) {
    if (i < nv) {
      int c = lane + 32 * i;
      float o = floorf((v[i] - mean) * factor * 0.5f) + __ldg(bias + c);
      if (o != o) o = 0.f;
      out_row[c] = (int8_t)(int)requant(o, __ldg(m_ln + c), 128.f);
    }
  }
}

// ln_row for one group of L lanes (lane: the lane in the group; every lane
// of the warp runs a row at once; C % L == 0), in int32 where ln_row's f32
// steps are exact integers: the stream's values are ints, so limb_add's
// limbs are v >> 8 and v & 255, y = v - mean (ibert: floored by 2**shift,
// an arithmetic shift), y's limbs y >> 8 and y & 255 and their products
// exact ints.  Only the mean, the sqrt, the factor and the output run in
// f32, as in ln_row: the same bits, with a third of its conversions.  The
// group sums do not depend on how the row is split.  The row is read three
// times (from L1) instead of held in registers.  out_row[c] gives the byte
// of column c (a pointer or a row writer).
template <bool IVIT, int L, typename XT, typename Out>
__device__ __forceinline__ void ln_row_i32(const XT* __restrict__ xrow, int C,
                                           const float* __restrict__ bias,
                                           const float* __restrict__ m_ln,
                                           float pw, int shift, Out out_row,
                                           int lane, bool isqrt = false) {
  int sh = 0, sl = 0;
#pragma unroll 4
  for (int c = lane; c < C; c += L) {
    const int v = xrow[c];
    sh += v >> 8;
    sl += v & 255;
  }
  const float mean = rintf(rdiv(limb_total<L>(sh, sl), (float)C));
  const int mi = (int)mean;
  int saa = 0, sab = 0, sbb = 0;
#pragma unroll 4
  for (int c = lane; c < C; c += L) {
    const int d = xrow[c] - mi;
    const int y = IVIT ? d : (shift >= 0 ? d >> min(shift, 31) : d << -shift);
    const int a = y >> 8, b = y & 255;
    saa += a * a;
    sab += a * b;
    sbb += b * b;
  }
  saa = warp_sum<L>(saa);
  sab = warp_sum<L>(sab);
  sbb = warp_sum<L>(sbb);
  float var = __fadd_rn(__fmul_rn(__int2float_rn(saa), 65536.f),
                        __fadd_rn(__fmul_rn(__int2float_rn(sab), 512.f),
                                  __int2float_rn(sbb)));
  float stdv = IVIT ? newton_sqrt(var) : ibert_root(var, isqrt) * pw;
  float factor = floorf(rdiv(2147483648.f, stdv));
#pragma unroll 4
  for (int c = lane; c < C; c += L) {
    float o = floorf(__int2float_rn(xrow[c] - mi) * factor * 0.5f) + __ldg(bias + c);
    if (o != o) o = 0.f;
    out_row[c] = (int8_t)(int)requant(o, __ldg(m_ln + c), 128.f);
  }
}

// The TM rows r0.. of an int8 [R, C] matrix into As (row stride lda,
// 16-byte aligned rows, C % 16 == 0); rows past R are zero.
template <int TM>
__device__ __forceinline__ void copy_tile(const int8_t* __restrict__ src,
                                          int R, int C, int r0, int8_t* As,
                                          int lda) {
  const int cw = C >> 4;
  for (int i = threadIdx.x; i < TM * cw; i += kThreads) {
    int row = i / cw, w = i - row * cw;
    int4 v = make_int4(0, 0, 0, 0);
    if (r0 + row < R)
      v = *reinterpret_cast<const int4*>(src + (size_t)(r0 + row) * C + 16 * w);
    *reinterpret_cast<int4*>(As + row * lda + 16 * w) = v;
  }
}

// The block's LN input tile: LN of the TM rows r0.. of x (XT: int8 or
// int16) into As (row stride lda), of the ln_kind form; or, where the
// caller hoisted the LN (ln_in != nullptr, block.py hoisted_ln), ln_in's
// rows as they are.  Rows past R are zero.  Warp w takes rows
// w * TM/8 .. (w + 1) * TM/8 - 1.
template <int TM, typename XT>
__device__ __forceinline__ void ln_tile(const XT* __restrict__ x,
                                        const int8_t* __restrict__ ln_in,
                                        int R, int C, int r0, int ln_kind,
                                        const float* __restrict__ bias,
                                        const float* __restrict__ m_ln,
                                        float pw, float inv_pw, int8_t* As,
                                        int lda) {
  if (ln_in != nullptr) {
    copy_tile<TM>(ln_in, R, C, r0, As, lda);
    return;
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int rr = 0; rr < TM / 8; ++rr) {
    int row = warp * (TM / 8) + rr;
    int gr = r0 + row;
    if (gr >= R) {
      for (int c = lane; c < C; c += 32) As[row * lda + c] = 0;
    } else if (ln_kind == kLnIvit) {
      ln_row<true>(x + (size_t)gr * C, C, bias, m_ln, 1.f, 1.f,
                   As + row * lda, lane);
    } else {
      ln_row<false>(x + (size_t)gr * C, C, bias, m_ln, pw, inv_pw,
                    As + row * lda, lane, ln_kind == kLnIbertIntSqrt);
    }
  }
}

__device__ __forceinline__ void mma_s8(int (&c)[4], int a0, int a1, int a2,
                                       int a3, int b0, int b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// The same product with an unsigned A: u8 x s8 -> s32.
__device__ __forceinline__ void mma_u8s8(int (&c)[4], int a0, int a1, int a2,
                                         int a3, int b0, int b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.u8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Bytes of shared memory gemm_tile stages weights through (two buffers).
__host__ __device__ constexpr int gemm_stage_bytes(int BN) {
  return 2 * BN * kBsLd;
}

// The warp layout of a TM x BN output tile: WM x WN warps, each owning 16
// rows and BN / WN columns as NT m16n8k32 tiles.
template <int BN, int TM>
struct GemmShape {
  static_assert(TM == 32 || TM == 64, "TM rows: 32 or 64");
  static constexpr int WM = TM / 16;
  static constexpr int WN = (kThreads / 32) / WM;
  static constexpr int NT = BN / (8 * WN);
  static_assert(BN % (8 * WN) == 0, "BN columns split over WN warps");
};

// int8 x int8 -> int32 tile: acc = As[0:TM, 0:K] @ Wt[n0:n0+BN, 0:K]^T.
//   As: shared, row-major, row stride lda (lda = C + 16 keeps the eight
//       fragment rows of a warp in distinct banks);
//   Wt: global [N, K] row-major, the weight transposed once by the wrapper
//       (torch's Linear layout), N % BN == 0 and K % BN == 0 (the pass width
//       divides both widths of every GEMM of the block kernels).  Each
//       BK-deep slice of the BN weight rows, BK = 64 (32 for the 96-column
//       pass of Swin-T's C = 96 and 192), is copied with cp.async into one
//       of two shared buffers while the tensor cores work on the other.
// Warp w owns rows (w % WM) * 16 .. +16 and columns (w / WM) * BN/WN ..
// +BN/WN; acc[j][e] is row tile_row<TM>(e), column tile_col<BN, TM>(j, e).
template <int BN, int TM>
__device__ __forceinline__ void gemm_tile(
    const int8_t* As, int lda, const int8_t* __restrict__ Wt, int K, int n0,
    int8_t* Bs, int (&acc)[GemmShape<BN, TM>::NT][4]) {
  using S = GemmShape<BN, TM>;
  // unsigned: the divisions by the powers of two below are shifts and masks
  const unsigned tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp % S::WM, wn = warp / S::WM;
#pragma unroll
  for (int j = 0; j < S::NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0;
  constexpr int BK = BN % 64 ? 32 : kTileK, PARTS = BK / 16;
  const int nk = K / BK;
  auto stage = [&](int kt) {
    int8_t* buf = Bs + (kt & 1) * BN * kBsLd;
    for (unsigned c = tid; c < BN * PARTS; c += kThreads) {
      const unsigned n = c / PARTS, part = c % PARTS;
      cp_async16(buf + n * kBsLd + part * 16,
                 Wt + (size_t)(n0 + n) * K + kt * BK + part * 16);
    }
    cp_async_commit();
  };
  __syncthreads();  // As is written and nobody still reads Bs
  stage(0);
  for (int kt = 0; kt < nk; ++kt) {
    if (kt + 1 < nk) {
      stage(kt + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int8_t* buf = Bs + (kt & 1) * BN * kBsLd;
    const int k0 = kt * BK;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 32) {
      const int8_t* ar = As + (wm * 16 + g) * lda + k0 + kk + t * 4;
      int a0 = *reinterpret_cast<const int*>(ar);
      int a1 = *reinterpret_cast<const int*>(ar + 8 * lda);
      int a2 = *reinterpret_cast<const int*>(ar + 16);
      int a3 = *reinterpret_cast<const int*>(ar + 8 * lda + 16);
#pragma unroll
      for (int j = 0; j < S::NT; ++j) {
        const int8_t* br =
            buf + (wn * (BN / S::WN) + j * 8 + g) * kBsLd + kk + t * 4;
        mma_s8(acc[j], a0, a1, a2, a3, *reinterpret_cast<const int*>(br),
               *reinterpret_cast<const int*>(br + 16));
      }
    }
    __syncthreads();  // buffer kt & 1 is free for stage kt + 2
  }
}

template <int TM>
__device__ __forceinline__ int tile_row(int e) {
  const unsigned lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  return (int)(warp % (TM / 16)) * 16 + (int)(lane >> 2) + 8 * (e >> 1);
}

template <int BN, int TM>
__device__ __forceinline__ int tile_col(int j, int e) {
  using S = GemmShape<BN, TM>;
  const unsigned lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  return (int)(warp / S::WM) * (BN / S::WN) + 8 * j + 2 * (int)(lane & 3) +
         (e & 1);
}

// The widest output pass of 128, 96 or 64 columns that divides both
// widths, or 0 if none does.
__host__ __device__ constexpr int pass_width(int n1, int n2) {
  return (n1 % 128 == 0 && n2 % 128 == 0)  ? 128
         : (n1 % 96 == 0 && n2 % 96 == 0) ? 96
         : (n1 % 64 == 0 && n2 % 64 == 0) ? 64
                                           : 0;
}

// Shared-memory row stride for an int8 tile of width C: C + 16 keeps the
// eight fragment rows of a warp in distinct banks.
__host__ __device__ constexpr int tile_ld(int C) { return C + 16; }

}  // namespace ivit

extern "C" const char* ivit_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
