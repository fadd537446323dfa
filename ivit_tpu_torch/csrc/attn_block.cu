// Fused attention half-block, ibert family, for sm_90a.
//
// Replaces ivit_tpu/ops/pallas/block.py::attn_block_p (body _attn_kernel):
//   ibert LN -> int8 requant -> qkv GEMM + bias -> requant -> per head int32
//   q k^T -> requant by m_attn -> ibert softmax over the n_valid columns
//   (int exp, 16-bit exp requant, 2**32 reciprocal) -> probs @ v -> requant
//   by m_av -> proj GEMM + bias -> requant -> integer residual.
//
// Bound on this card: operations.  At DeiT-S (B 256, N 197, C 384, 6 heads)
// one call does 2 * B * N * (3C * C + C * C) + 2 * 2 * B * N * N * C = 75 G
// int8 ops (~38 us at 1,979 TOPS) and moves ~39 MB of operands (~12 us at
// 3.35 TB/s); the softmax adds ~60 M elementwise exp chains on the CUDA
// cores.
//
// Design: one image's int8 qkv is 197 x 1152 = 230 KB, more than a block's
// 227 KB of shared memory, so the TPU kernel's single body becomes a chain
// of three launches on one stream, counted as one kernel:
//   1. ln_qkv_kernel: 64 token rows per block, LN into shared memory, qkv
//      GEMM on mma.sync m16n8k32 s8 with the weight rows streamed by
//      double-buffered cp.async (exact.cuh gemm_tile), requant, int8 qkv to
//      global memory;
//   2. attn_core_kernel: one block per (head, image) with that head's k and
//      v (transposed) in shared memory; each warp takes one query row at a
//      time: scores by dp4a (one key per lane), softmax with warp
//      reductions, probs @ v by dp4a over 4 keys at a time (one output
//      channel per lane).  The [N, N] matrix is never stored;
//   3. proj_kernel: 64 rows of ctx per block, proj GEMM, requant, residual.
// The LN shift and the exp constants are derived in every thread from the
// spec's scalar leaves, with the plain version's rdiv, so a call costs the
// host no arithmetic launches of its own.

#include "exact.cuh"

namespace ivit {

constexpr int kMaxKeysPerLane = 8;  // N <= 256

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
// leaves, read by every thread (no wrapper-side arithmetic).
struct AttnScalars {
  const float *ln_shift, *m_attn, *s_attn, *s_exp_act, *m_av, *m_res_x,
      *m_res_id;
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

// 1. LN + qkv GEMM + requant.  wqkv_t: the qkv weight transposed, [3C, C].
template <int BN>
__global__ void __launch_bounds__(kThreads)
ln_qkv_kernel(const int8_t* __restrict__ x, const float* __restrict__ ln_bias,
              const float* __restrict__ m_ln, const int8_t* __restrict__ wqkv_t,
              const int32_t* __restrict__ bqkv, const float* __restrict__ mqkv,
              AttnScalars sp, int8_t* __restrict__ qkv, int R, int C) {
  extern __shared__ __align__(16) int8_t smem[];
  const int lda = tile_ld(C);
  int8_t* As = smem;
  int8_t* Bs = As + kTileM * lda;
  const int r0 = blockIdx.x * kTileM, N3 = 3 * C;
  const LnShift ln = ln_shift_of(sp.ln_shift);
  ln_tile_ibert(x, R, C, r0, ln_bias, m_ln, ln.pw, ln.inv_pw, As, lda);
  int acc[BN / 16][4];
  for (int n0 = 0; n0 < N3; n0 += BN) {
    gemm_tile<BN>(As, lda, wqkv_t, C, n0, Bs, acc);
#pragma unroll
    for (int j = 0; j < BN / 16; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        int gr = r0 + tile_row(e), col = n0 + tile_col<BN>(j, e);
        if (gr >= R) continue;
        qkv[(size_t)gr * N3 + col] = (int8_t)(int)requant(
            __int2float_rn(acc[j][e] + __ldg(bqkv + col)), __ldg(mqkv + col),
            128.f);
      }
  }
}

// 2. Softmax attention for one (head, image).
// Shared memory: k rows [Np][Dh + 4] (an odd word stride, so the 32 lanes
// reading 32 keys hit 32 banks); v transposed [Dh][Np4 + 4] with Np4 = Np
// rounded up to 4 and zero-filled, so probs @ v runs as dp4a over 4 keys at
// a time; one query row and one probs row per warp.
__global__ void __launch_bounds__(kThreads)
attn_core_kernel(const int8_t* __restrict__ qkv, AttnScalars sp,
                 int8_t* __restrict__ ctx, int Np, int C, int Dh, int n_valid,
                 int attn_bits, int fast_q, int fast_poly) {
  extern __shared__ __align__(16) int8_t smem[];
  const int ldk = Dh + 4;
  const int np4 = (Np + 3) & ~3, ldv = np4 + 4;
  int8_t* Ks = smem;
  int8_t* Vt = Ks + Np * ldk;
  int8_t* Qs = Vt + Dh * ldv;      // [8][Dh]
  int8_t* Ps = Qs + 8 * Dh;        // [8][np4]
  const int h = blockIdx.x, b = blockIdx.y;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int N3 = 3 * C, dw = Dh >> 2;
  const int8_t* base = qkv + (size_t)b * Np * N3 + h * Dh;

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
  __syncthreads();

  const float m_attn = __ldg(sp.m_attn), m_av = __ldg(sp.m_av);
  const float m_exp_act = rdiv(1.f, __ldg(sp.s_exp_act));
  const ExpConsts ec = exp_consts_of(__ldg(sp.s_attn));
  const float lim_a = bits_lim(attn_bits);
  int8_t* q = Qs + warp * Dh;
  int8_t* p = Ps + warp * np4;

  for (int i = warp; i < Np; i += 8) {
    for (int w = lane; w < dw; w += 32)
      reinterpret_cast<int*>(q)[w] =
          *reinterpret_cast<const int*>(base + (size_t)i * N3 + 4 * w);
    __syncwarp();
    float s[kMaxKeysPerLane];
    float smax = -8388608.f;  // -2**23, the reference's pad-column fill
#pragma unroll
    for (int t = 0; t < kMaxKeysPerLane; ++t) {
      int j = lane + 32 * t;
      s[t] = -8388608.f;
      if (j < n_valid) {
        const int* kr = reinterpret_cast<const int*>(Ks + j * ldk);
        const int* qr = reinterpret_cast<const int*>(q);
        int dot = 0;
        for (int w = 0; w < dw; ++w) dot = __dp4a(qr[w], kr[w], dot);
        s[t] = requant(__int2float_rn(dot), m_attn, lim_a);
        smax = fmaxf(smax, s[t]);
      }
    }
    smax = warp_max(smax);
    float e16[kMaxKeysPerLane];
    int esum = 0;
#pragma unroll
    for (int t = 0; t < kMaxKeysPerLane; ++t) {
      int j = lane + 32 * t;
      e16[t] = 0.f;
      if (j < n_valid) {
        float e = ibert_exp(s[t] - smax, ec.x0, ec.b, ec.c, fast_q, fast_poly);
        e16[t] = clampf(rintf(e * m_exp_act), -32768.f, 32767.f);
        esum += (int)e16[t];
      }
    }
    esum = warp_sum(esum);
    float factor = floorf(rdiv(4294967296.f, __int2float_rn(esum)));
#pragma unroll
    for (int t = 0; t < kMaxKeysPerLane; ++t) {
      int j = lane + 32 * t;
      if (j < np4) p[j] = (int8_t)(int)floorf(e16[t] * factor * 0x1p-25f);
    }
    __syncwarp();
    const int* p4 = reinterpret_cast<const int*>(p);
    for (int d = lane; d < Dh; d += 32) {
      const int* v4 = reinterpret_cast<const int*>(Vt + d * ldv);
      int a = 0;
      for (int w = 0; w < (np4 >> 2); ++w) a = __dp4a(p4[w], v4[w], a);
      ctx[((size_t)b * Np + i) * C + h * Dh + d] =
          (int8_t)(int)requant(__int2float_rn(a), m_av, 128.f);
    }
    __syncwarp();
  }
}

// 3. proj GEMM + requant + residual.  wp_t: the proj weight transposed, [C, C].
template <int BN>
__global__ void __launch_bounds__(kThreads)
proj_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ ctx,
            const int8_t* __restrict__ wp_t, const int32_t* __restrict__ bp,
            const float* __restrict__ mp, AttnScalars sp,
            int8_t* __restrict__ out, int R, int C, int proj_bits,
            int out_bits) {
  extern __shared__ __align__(16) int8_t smem[];
  const int lda = tile_ld(C);
  int8_t* As = smem;
  int8_t* Bs = As + kTileM * lda;
  const int r0 = blockIdx.x * kTileM, cw = C >> 4;
  for (int i = threadIdx.x; i < kTileM * cw; i += kThreads) {
    int row = i / cw, w = i - row * cw;
    int4 v = make_int4(0, 0, 0, 0);
    if (r0 + row < R)
      v = *reinterpret_cast<const int4*>(ctx + (size_t)(r0 + row) * C + 16 * w);
    *reinterpret_cast<int4*>(As + row * lda + 16 * w) = v;
  }
  const float m_res_x = __ldg(sp.m_res_x), m_res_id = __ldg(sp.m_res_id);
  const float lim_p = bits_lim(proj_bits), lim_o = bits_lim(out_bits);
  int acc[BN / 16][4];
  for (int n0 = 0; n0 < C; n0 += BN) {
    gemm_tile<BN>(As, lda, wp_t, C, n0, Bs, acc);
#pragma unroll
    for (int j = 0; j < BN / 16; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        int gr = r0 + tile_row(e), col = n0 + tile_col<BN>(j, e);
        if (gr >= R) continue;
        float y2 = requant(__int2float_rn(acc[j][e] + __ldg(bp + col)),
                           __ldg(mp + col), lim_p);
        size_t idx = (size_t)gr * C + col;
        float o = rintf(y2 * m_res_x) + rintf((float)x[idx] * m_res_id);
        out[idx] = (int8_t)(int)clampf(o, -lim_o, lim_o - 1.f);
      }
  }
}

template <int BN>
int launch_attn(const int8_t* x, const float* ln_bias, const float* m_ln,
                const int8_t* wqkv_t, const int32_t* bqkv, const float* mqkv,
                const int8_t* wp_t, const int32_t* bp, const float* mp,
                AttnScalars sp, int8_t* qkv, int8_t* ctx, int8_t* out, int B,
                int Np, int C, int H, int n_valid, int attn_bits, int proj_bits,
                int out_bits, int fast_q, int fast_poly, cudaStream_t stream) {
  const int R = B * Np, Dh = C / H, np4 = (Np + 3) & ~3;
  const size_t smem_gemm = (size_t)kTileM * tile_ld(C) + gemm_stage_bytes(BN);
  const size_t smem_core = (size_t)Np * (Dh + 4) + (size_t)Dh * (np4 + 4) +
                           8 * (size_t)Dh + 8 * (size_t)np4;
  cudaError_t err;
  if ((err = cudaFuncSetAttribute(ln_qkv_kernel<BN>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)smem_gemm)) != cudaSuccess ||
      (err = cudaFuncSetAttribute(proj_kernel<BN>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)smem_gemm)) != cudaSuccess ||
      (err = cudaFuncSetAttribute(attn_core_kernel,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)smem_core)) != cudaSuccess)
    return (int)err;
  const dim3 row_grid((R + kTileM - 1) / kTileM);
  ln_qkv_kernel<BN><<<row_grid, kThreads, smem_gemm, stream>>>(
      x, ln_bias, m_ln, wqkv_t, bqkv, mqkv, sp, qkv, R, C);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  attn_core_kernel<<<dim3(H, B), kThreads, smem_core, stream>>>(
      qkv, sp, ctx, Np, C, Dh, n_valid, attn_bits, fast_q, fast_poly);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  proj_kernel<BN><<<row_grid, kThreads, smem_gemm, stream>>>(
      x, ctx, wp_t, bp, mp, sp, out, R, C, proj_bits, out_bits);
  return (int)cudaGetLastError();
}

}  // namespace ivit

// Pointers in the wrapper's argument order; ln_shift, m_attn, s_attn,
// s_exp_act, m_av, m_res_x and m_res_id point at one f32 each.  qkv
// [B * Np, 3C] and ctx [B * Np, C] are int8 scratch.
extern "C" int ivit_attn_block(const int8_t* x, const float* ln_bias,
                               const float* m_ln, const float* ln_shift,
                               const int8_t* wqkv_t, const int32_t* bqkv,
                               const float* mqkv, const float* m_attn,
                               const float* s_attn, const float* s_exp_act,
                               const float* m_av, const int8_t* wp_t,
                               const int32_t* bp, const float* mp,
                               const float* m_res_x, const float* m_res_id,
                               int8_t* qkv, int8_t* ctx, int8_t* out, int B,
                               int Np, int C, int H, int n_valid, int attn_bits,
                               int proj_bits, int out_bits, int fast_q,
                               int fast_poly, cudaStream_t stream) {
  const ivit::AttnScalars sp{ln_shift, m_attn, s_attn, s_exp_act,
                             m_av, m_res_x, m_res_id};
  // 128-column passes where C allows (DeiT-S: 3C = 1152, C = 384), else 64
  auto launch = C % 128 == 0 ? ivit::launch_attn<128> : ivit::launch_attn<64>;
  return launch(x, ln_bias, m_ln, wqkv_t, bqkv, mqkv, wp_t, bp, mp, sp, qkv,
                ctx, out, B, Np, C, H, n_valid, attn_bits, proj_bits, out_bits,
                fast_q, fast_poly, stream);
}
