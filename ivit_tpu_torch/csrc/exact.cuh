// Exact f32 integer arithmetic and the shared building blocks of the
// ibert block kernels (mlp_block.cu, attn_block.cu).
//
// Every helper reproduces the JAX construction of ivit_tpu/ops/quant.py and
// ivit_tpu/ops/pallas/block.py operation for operation, so the kernels give
// the reference's bits:
//   * rdiv / exact_fma keep the Dekker residual and two-product, written with
//     the _rn intrinsics, which are never contracted into an FMA; the whole
//     file is also built with --fmad=false, so plain `a * b + c` rounds twice
//     as written (the fast_poly form and the residual products rely on it);
//   * the two-limb LN sums keep their int32 limbs and their fixed f32
//     recombination order (they round twice above 2**24);
//   * round is rintf (half to even), 2**k is a bit construction, sqrt is the
//     IEEE __fsqrt_rn, int32 -> f32 is round to nearest;
//   * a NaN LN output (an all-zero padding row) is pinned to 0 before its
//     int8 requant, as the plain version does.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace ivit {

constexpr int kThreads = 256;   // 8 warps per block
constexpr int kTileM = 64;      // token rows per GEMM block
constexpr int kTileK = 64;      // K depth per staged weight tile
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

// The LN shift's exact power 2**shift and its inverse, from the spec's
// 0-d shift leaf.
struct LnShift {
  float pw, inv_pw;
};
__device__ __forceinline__ LnShift ln_shift_of(const float* shift) {
  const float pw = pow2(__ldg(shift));
  return {pw, __fdiv_rn(1.f, pw)};
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

__device__ __forceinline__ int warp_sum(int v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// One warp: ibert LayerNorm of one int8 row of C (C % 32 == 0, C <= 1024),
// plus its bias and int8 requant, into out_row (block.py _ibert_layernorm +
// _ln_requant; the engine's ibert_layernorm_int).
__device__ __forceinline__ void ln_row_ibert(const int8_t* __restrict__ xrow,
                                             int C,
                                             const float* __restrict__ bias,
                                             const float* __restrict__ m_ln,
                                             float pw, float inv_pw,
                                             int8_t* out_row, int lane) {
  float v[kMaxLnVals];
  const int nv = C >> 5;
  int sh = 0, sl = 0;
#pragma unroll
  for (int i = 0; i < kMaxLnVals; ++i) {
    if (i < nv) {
      float x = (float)xrow[lane + 32 * i];
      v[i] = x;
      float h = floorf(x * 0.00390625f);
      sh += (int)h;
      sl += (int)(x - h * 256.f);
    }
  }
  sh = warp_sum(sh);
  sl = warp_sum(sl);
  float s = __fadd_rn(__fmul_rn(__int2float_rn(sh), 256.f), __int2float_rn(sl));
  float mean = rintf(rdiv(s, (float)C));
  int saa = 0, sab = 0, sbb = 0;
#pragma unroll
  for (int i = 0; i < kMaxLnVals; ++i) {
    if (i < nv) {
      float y = floorf((v[i] - mean) * inv_pw);
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
  float stdv = floorf(__fsqrt_rn(var)) * pw;
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

// LN of the block's kTileM rows into As (row stride lda); rows past R are
// zero.  Warp w takes rows w*8 .. w*8+7.
__device__ __forceinline__ void ln_tile_ibert(const int8_t* __restrict__ x,
                                              int R, int C, int r0,
                                              const float* __restrict__ bias,
                                              const float* __restrict__ m_ln,
                                              float pw, float inv_pw,
                                              int8_t* As, int lda) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int rr = 0; rr < kTileM / 8; ++rr) {
    int row = warp * (kTileM / 8) + rr;
    int gr = r0 + row;
    if (gr < R) {
      ln_row_ibert(x + (size_t)gr * C, C, bias, m_ln, pw, inv_pw,
                   As + row * lda, lane);
    } else {
      for (int c = lane; c < C; c += 32) As[row * lda + c] = 0;
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

// Bytes of shared memory gemm_tile<BN> stages weights through (two buffers).
__host__ __device__ constexpr int gemm_stage_bytes(int BN) {
  return 2 * BN * kBsLd;
}

// int8 x int8 -> int32 tile: acc = As[0:64, 0:K] @ Wt[n0:n0+BN, 0:K]^T.
//   As: shared, row-major, row stride lda (lda = C + 16 keeps the eight
//       fragment rows of a warp in distinct banks);
//   Wt: global [N, K] row-major, the weight transposed once by the wrapper
//       (torch's Linear layout), K % 64 == 0, N % BN == 0.  Each 64-deep
//       slice of the BN weight rows is copied with cp.async into one of two
//       shared buffers while the tensor cores work on the other.
// Warp w owns rows (w & 3) * 16 .. +16 and columns (w >> 2) * BN/2 .. +BN/2
// as BN/16 m16n8k32 tiles; acc[j][e] is row tile_row(e), column
// tile_col<BN>(j, e).
template <int BN>
__device__ __forceinline__ void gemm_tile(const int8_t* As, int lda,
                                          const int8_t* __restrict__ Wt, int K,
                                          int n0, int8_t* Bs,
                                          int (&acc)[BN / 16][4]) {
  constexpr int NT = BN / 16;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp & 3, wn = warp >> 2;
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0;
  const int nk = K / kTileK;
  auto stage = [&](int kt) {
    int8_t* buf = Bs + (kt & 1) * BN * kBsLd;
#pragma unroll
    for (int c = tid; c < BN * 4; c += kThreads) {
      int n = c >> 2, part = c & 3;
      cp_async16(buf + n * kBsLd + part * 16,
                 Wt + (size_t)(n0 + n) * K + kt * kTileK + part * 16);
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
    const int k0 = kt * kTileK;
#pragma unroll
    for (int kk = 0; kk < kTileK; kk += 32) {
      const int8_t* ar = As + (wm * 16 + g) * lda + k0 + kk + t * 4;
      int a0 = *reinterpret_cast<const int*>(ar);
      int a1 = *reinterpret_cast<const int*>(ar + 8 * lda);
      int a2 = *reinterpret_cast<const int*>(ar + 16);
      int a3 = *reinterpret_cast<const int*>(ar + 8 * lda + 16);
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int8_t* br = buf + (wn * (BN / 2) + j * 8 + g) * kBsLd + kk + t * 4;
        mma_s8(acc[j], a0, a1, a2, a3, *reinterpret_cast<const int*>(br),
               *reinterpret_cast<const int*>(br + 16));
      }
    }
    __syncthreads();  // buffer kt & 1 is free for stage kt + 2
  }
}

__device__ __forceinline__ int tile_row(int e) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  return (warp & 3) * 16 + (lane >> 2) + 8 * (e >> 1);
}

template <int BN>
__device__ __forceinline__ int tile_col(int j, int e) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  return (warp >> 2) * (BN / 2) + 8 * j + 2 * (lane & 3) + (e & 1);
}

// Shared-memory row stride for an int8 tile of width C: C + 16 keeps the
// eight fragment rows of a warp in distinct banks.
__host__ __device__ constexpr int tile_ld(int C) { return C + 16; }

}  // namespace ivit

extern "C" const char* ivit_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
