// The launches that the two attention kernels share (attn_block.cu for ViT,
// swin_attn_block.cu for Swin's windows): each is a chain of three kernels
// on one stream, counted as one,
//   1. ln_qkv_kernel: LN + qkv GEMM + requant over flat token rows;
//   2. a softmax attention core per (head, image) or (window, head), whose
//      row code is softmax_pv_row below;
//   3. proj_kernel: proj GEMM + requant + integer residual.
// The token stream is int8 (ViT) or int16 (Swin), read and written as it
// is; the LN shift and the exp constants are derived in every thread from
// the spec's scalar leaves.
#pragma once

#include "ivit.cuh"

namespace ivit {

// ibert integer exp of x = score - row max (block.py _ibert_int_exp).
__device__ __forceinline__ float ibert_exp(float x, float x0, float b_int,
                                           float c_int, int fast_q,
                                           int fast_poly) {
  x = fmaxf(x, 30.f * x0);
  float q = fast_q ? floor_div_int(x, x0) : floorf(rdiv(x, x0));
  float r = x - x0 * q;
  float z = fast_poly ? r * (r + b_int) + c_int : exact_fma(r, r + b_int, c_int);
  return fmaxf(floorf(z * pow2(30.f - q)), 0.f);
}

// The chain's scalar operands: device pointers to the spec's 0-d f32
// leaves, read by every thread (no wrapper-side arithmetic).  m_attn2 is
// Swin's second score requant (null for ViT).
struct AttnScalars {
  const float *ln_shift, *m_attn, *m_attn2, *s_attn, *s_exp_act, *m_av,
      *m_res_x, *m_res_id;
};

// ibert exp constants at score scale s_attn, as ibert.int_exp and
// int_polynomial derive them: x0 = floor(-ln2 / s), b_int and c_int.
struct ExpConsts {
  float x0, b, c;
};
__device__ __forceinline__ ExpConsts exp_consts_of(float s) {
  return {floorf(rdiv(kExpX0, s)), floorf(rdiv(kExpB, s)),
          floorf(rdiv(kExpC, __fmul_rn(s, s)))};
}

// The softmax constants of one block: Shiftmax's x0, or the ibert exp's
// constants and the reciprocal of its 16-bit requant scale.
struct SoftmaxConsts {
  float x0, m_exp_act;
  ExpConsts ec;
};
template <bool SHIFTMAX>
__device__ __forceinline__ SoftmaxConsts softmax_consts_of(AttnScalars sp) {
  const float s_attn = __ldg(sp.s_attn);
  SoftmaxConsts k{};
  if (SHIFTMAX) {
    k.x0 = exp_shift_x0(s_attn);
  } else {
    k.m_exp_act = rdiv(1.f, __ldg(sp.s_exp_act));
    k.ec = exp_consts_of(s_attn);
  }
  return k;
}

// Stage one (image, head)'s or (window, head)'s keys and values in shared
// memory: k rows [Np][Dh + 4] (an odd word stride, so the 32 lanes reading
// 32 keys hit 32 banks) and v transposed [Dh][np4 + 4] with np4 = Np rounded
// up to 4 and zero-filled, so probs @ v runs as dp4a over 4 keys at a time.
// base: the first token's q columns of this head in the int8 qkv rows.
__device__ __forceinline__ void stage_kv(const int8_t* __restrict__ base,
                                         int Np, int C, int Dh, int8_t* Ks,
                                         int8_t* Vt) {
  const int N3 = 3 * C, dw = Dh >> 2, ldk = Dh + 4;
  const int np4 = (Np + 3) & ~3, ldv = np4 + 4;
  for (int i = threadIdx.x; i < np4 * dw; i += kThreads) {
    int j = i / dw, w = i - j * dw;
    int kv = 0, vv = 0;
    if (j < Np) {
      const int8_t* src = base + (size_t)j * N3 + 4 * w;
      kv = *reinterpret_cast<const int*>(src + C);
      vv = *reinterpret_cast<const int*>(src + 2 * C);
      *reinterpret_cast<int*>(Ks + j * ldk + 4 * w) = kv;
    }
#pragma unroll
    for (int d = 0; d < 4; ++d) Vt[(4 * w + d) * ldv + j] = (int8_t)(vv >> (8 * d));
  }
}

// Shared memory of a softmax attention core: Ks, Vt, one query row and one
// probs row per warp.
__host__ __device__ constexpr size_t core_smem(int Np, int Dh) {
  return (size_t)Np * (Dh + 4) + (size_t)Dh * (((Np + 3) & ~3) + 4) +
         8 * (size_t)Dh + 8 * (size_t)((Np + 3) & ~3);
}

// One warp: the i-th query row of this core's head into q (Dh int8).
__device__ __forceinline__ void load_q(const int8_t* __restrict__ base, int i,
                                       int C, int Dh, int8_t* q, int lane) {
  for (int w = lane; w < (Dh >> 2); w += 32)
    reinterpret_cast<int*>(q)[w] =
        *reinterpret_cast<const int*>(base + (size_t)i * 3 * C + 4 * w);
  __syncwarp();
}

// One warp: q . k_j for this lane's key j, by dp4a.
__device__ __forceinline__ int qk_dot(const int8_t* q, const int8_t* Ks, int j,
                                      int Dh) {
  const int* kr = reinterpret_cast<const int*>(Ks + j * (Dh + 4));
  const int* qr = reinterpret_cast<const int*>(q);
  int dot = 0;
  for (int w = 0; w < (Dh >> 2); ++w) dot = __dp4a(qr[w], kr[w], dot);
  return dot;
}

// One warp: the softmax of one query row's f32 scores s[t] (key lane + 32 t,
// the first n_valid keys real; smax: this lane's max over its real keys)
// into 8-bit probabilities (Shiftmax: shift exp, exact two-limb row sum,
// 2**31 reciprocal; or ibert: int exp, 16-bit exp requant, 2**32
// reciprocal), stored as int8 in p (keys up to np4, padding 0); then
// ctx_row[d] = requant(p . v[:, d], m_av) for the Dh channels, by dp4a
// over 4 keys at a time (one output channel per lane).  The scores may lie
// far below the int8 range (Swin's shift mask): they stay f32 throughout.
template <bool SHIFTMAX, int MAXV>
__device__ __forceinline__ void softmax_pv_row(
    float (&s)[MAXV], float smax, int n_valid, const SoftmaxConsts& k,
    int fast_q, int fast_poly, int8_t* p, const int8_t* Vt, int np4, int Dh,
    float m_av, int8_t* __restrict__ ctx_row, int lane) {
  if (SHIFTMAX) {
    shiftmax_row(s, n_valid, k.x0, shift_out_scale(8), fast_q, lane);
  } else {
    smax = warp_max(smax);
    int esum = 0;
#pragma unroll
    for (int t = 0; t < MAXV; ++t) {
      int j = lane + 32 * t;
      float e16 = 0.f;
      if (j < n_valid) {
        float e = ibert_exp(s[t] - smax, k.ec.x0, k.ec.b, k.ec.c, fast_q,
                            fast_poly);
        e16 = clampf(rintf(e * k.m_exp_act), -32768.f, 32767.f);
        esum += (int)e16;
      }
      s[t] = e16;
    }
    esum = warp_sum(esum);
    float factor = floorf(rdiv(4294967296.f, __int2float_rn(esum)));
#pragma unroll
    for (int t = 0; t < MAXV; ++t) s[t] = floorf(s[t] * factor * 0x1p-25f);
  }
#pragma unroll
  for (int t = 0; t < MAXV; ++t) {
    int j = lane + 32 * t;
    if (j < np4) p[j] = (int8_t)(int)s[t];
  }
  __syncwarp();
  const int* p4 = reinterpret_cast<const int*>(p);
  const int ldv = np4 + 4;
  for (int d = lane; d < Dh; d += 32) {
    const int* v4 = reinterpret_cast<const int*>(Vt + d * ldv);
    int a = 0;
    for (int w = 0; w < (np4 >> 2); ++w) a = __dp4a(p4[w], v4[w], a);
    ctx_row[d] = (int8_t)(int)requant(__int2float_rn(a), m_av, 128.f);
  }
  __syncwarp();
}

// 1. LN + qkv GEMM + requant.  x: [R, C] int8 or (x16) int16; wqkv_t: the
// qkv weight transposed, [3C, C]; ln_in: the hoisted LN output [R, C], or
// null to run the LN here.
template <int BN>
__global__ void __launch_bounds__(kThreads)
ln_qkv_kernel(const void* __restrict__ x, const int8_t* __restrict__ ln_in,
              const float* __restrict__ ln_bias,
              const float* __restrict__ m_ln, const int8_t* __restrict__ wqkv_t,
              const int32_t* __restrict__ bqkv, const float* __restrict__ mqkv,
              AttnScalars sp, int8_t* __restrict__ qkv, int R, int C, int x16,
              int ln_ivit) {
  constexpr int NT = GemmShape<BN, kTileM>::NT;
  extern __shared__ __align__(16) int8_t smem[];
  const int lda = tile_ld(C);
  int8_t* As = smem;
  int8_t* Bs = As + kTileM * lda;
  const int r0 = blockIdx.x * kTileM, N3 = 3 * C;
  const LnShift ln = ln_shift_of(sp.ln_shift);
  ln_tile_any<kTileM>(x, x16, ln_in, R, C, r0, ln_ivit, ln_bias, m_ln, ln.pw,
                      ln.inv_pw, As, lda);
  int acc[NT][4];
  for (int n0 = 0; n0 < N3; n0 += BN) {
    gemm_tile<BN, kTileM>(As, lda, wqkv_t, C, n0, Bs, acc);
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        int gr = r0 + tile_row<kTileM>(e), col = n0 + tile_col<BN, kTileM>(j, e);
        if (gr >= R) continue;
        qkv[(size_t)gr * N3 + col] = (int8_t)(int)requant(
            __int2float_rn(acc[j][e] + __ldg(bqkv + col)), __ldg(mqkv + col),
            128.f);
      }
  }
}

// 3. proj GEMM + requant to proj_bits + residual to out_bits.  wp_t: the
// proj weight transposed, [C, C]; x and out: [R, C], int8 or (x16 / o16)
// int16.
template <int BN>
__global__ void __launch_bounds__(kThreads)
proj_kernel(const void* __restrict__ x, const int8_t* __restrict__ ctx,
            const int8_t* __restrict__ wp_t, const int32_t* __restrict__ bp,
            const float* __restrict__ mp, AttnScalars sp,
            void* __restrict__ out, int R, int C, int proj_bits, int out_bits,
            int x16, int o16) {
  constexpr int NT = GemmShape<BN, kTileM>::NT;
  extern __shared__ __align__(16) int8_t smem[];
  const int lda = tile_ld(C);
  int8_t* As = smem;
  int8_t* Bs = As + kTileM * lda;
  const int r0 = blockIdx.x * kTileM;
  copy_tile<kTileM>(ctx, R, C, r0, As, lda);
  const float m_res_x = __ldg(sp.m_res_x), m_res_id = __ldg(sp.m_res_id);
  const float lim_p = bits_lim(proj_bits), lim_o = bits_lim(out_bits);
  int acc[NT][4];
  for (int n0 = 0; n0 < C; n0 += BN) {
    gemm_tile<BN, kTileM>(As, lda, wp_t, C, n0, Bs, acc);
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        int gr = r0 + tile_row<kTileM>(e), col = n0 + tile_col<BN, kTileM>(j, e);
        if (gr >= R) continue;
        float y2 = requant(__int2float_rn(acc[j][e] + __ldg(bp + col)),
                           __ldg(mp + col), lim_p);
        size_t idx = (size_t)gr * C + col;
        float o = rintf(y2 * m_res_x) + rintf(load_act(x, idx, x16) * m_res_id);
        store_act(out, idx, clampf(o, -lim_o, lim_o - 1.f), o16);
      }
  }
}

// Shared memory of ln_qkv_kernel and proj_kernel: a 64-row int8 tile and
// the weight ring.
__host__ __device__ constexpr size_t gemm_smem(int C, int BN) {
  return (size_t)kTileM * tile_ld(C) + gemm_stage_bytes(BN);
}

// Raise the dynamic shared memory limit of ln_qkv_kernel<BN> and
// proj_kernel<BN> to gemm_smem(C, BN).
template <int BN>
cudaError_t allow_gemm_smem(int C) {
  const int bytes = (int)gemm_smem(C, BN);
  cudaError_t err = cudaFuncSetAttribute(
      ln_qkv_kernel<BN>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(
      proj_kernel<BN>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

}  // namespace ivit
