// Fused attention half-block, ivit and ibert families, for sm_90a.
//
// Replaces ivit_tpu/ops/pallas/block.py::attn_block_p (body _attn_kernel):
//   LN (I-LayerNorm or ibert LN; or the hoisted int8 ln_in) -> int8
//   requant -> qkv GEMM + bias -> requant -> per head int32 q k^T ->
//   requant by m_attn -> softmax over the n_valid columns (Shiftmax: shift
//   exp, exact two-limb row sum, 2**31 reciprocal; or ibert: int exp,
//   16-bit exp requant, 2**32 reciprocal) -> probs @ v -> requant by m_av
//   -> proj GEMM + bias -> requant -> integer residual.
//
// Bound on this card: operations.  At DeiT-S (B 256, N 197, C 384, 6 heads)
// one call does 2 * B * N * (3C * C + C * C) + 2 * 2 * B * N * N * C = 75 G
// int8 ops (~38 us at 1,979 TOPS) and moves ~39 MB of operands (~12 us at
// 3.35 TB/s); the softmax adds ~60 M elementwise exp chains on the CUDA
// cores.
//
// Design: one image's int8 qkv is 197 x 1152 = 230 KB, more than a block's
// 227 KB of shared memory, so the TPU kernel's single body becomes a chain
// of three launches on one stream, counted as one kernel (the first and the
// last, and the softmax row code, shared with swin_attn_block.cu in
// attn_chain.cuh):
//   1. ln_qkv_kernel: 64 token rows per block, LN into shared memory, qkv
//      GEMM on mma.sync m16n8k32 s8 with the weight rows streamed by
//      double-buffered cp.async (exact.cuh gemm_tile), requant, int8 qkv to
//      global memory;
//   2. attn_core_kernel: one block per (head, image) with that head's k and
//      v (transposed) in shared memory; each warp takes one query row at a
//      time: scores by dp4a (one key per lane), softmax with warp
//      reductions (Shiftmax through ivit.cuh shiftmax_row, the standalone
//      kernel's row code), probs @ v by dp4a over 4 keys at a time (one output
//      channel per lane).  The [N, N] matrix is never stored;
//   3. proj_kernel: 64 rows of ctx per block, proj GEMM, requant, residual.
// The LN shift and the exp constants are derived in every thread from the
// spec's scalar leaves, with the plain version's rdiv, so a call costs the
// host no arithmetic launches of its own.

#include "attn_chain.cuh"

namespace ivit {

constexpr int kMaxKeysPerLane = 8;  // N <= 256

// 2. Softmax attention for one (head, image); SHIFTMAX: the ivit softmax,
// else the ibert one.  Keys and values staged by stage_kv; one query row
// and one probs row per warp.
template <bool SHIFTMAX>
__global__ void __launch_bounds__(kThreads)
attn_core_kernel(const int8_t* __restrict__ qkv, AttnScalars sp,
                 int8_t* __restrict__ ctx, int Np, int C, int Dh, int n_valid,
                 int attn_bits, int fast_q, int fast_poly) {
  extern __shared__ __align__(16) int8_t smem[];
  const int np4 = (Np + 3) & ~3;
  int8_t* Ks = smem;
  int8_t* Vt = Ks + Np * (Dh + 4);
  int8_t* Qs = Vt + Dh * (np4 + 4);  // [8][Dh]
  int8_t* Ps = Qs + 8 * Dh;          // [8][np4]
  const int h = blockIdx.x, b = blockIdx.y;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int8_t* base = qkv + (size_t)b * Np * 3 * C + h * Dh;
  stage_kv(base, Np, C, Dh, Ks, Vt);
  __syncthreads();

  const float m_attn = __ldg(sp.m_attn), m_av = __ldg(sp.m_av);
  const SoftmaxConsts k = softmax_consts_of<SHIFTMAX>(sp);
  const float lim_a = bits_lim(attn_bits);
  int8_t* q = Qs + warp * Dh;
  int8_t* p = Ps + warp * np4;
  for (int i = warp; i < Np; i += 8) {
    load_q(base, i, C, Dh, q, lane);
    float s[kMaxKeysPerLane];
    float smax = -8388608.f;  // -2**23, the reference's pad-column fill
#pragma unroll
    for (int t = 0; t < kMaxKeysPerLane; ++t) {
      int j = lane + 32 * t;
      s[t] = -8388608.f;
      if (j < n_valid) {
        s[t] = requant(__int2float_rn(qk_dot(q, Ks, j, Dh)), m_attn, lim_a);
        smax = fmaxf(smax, s[t]);
      }
    }
    softmax_pv_row<SHIFTMAX>(s, smax, n_valid, k, fast_q, fast_poly, p, Vt,
                             np4, Dh, m_av, ctx + ((size_t)b * Np + i) * C + h * Dh,
                             lane);
  }
}

template <int BN, bool SHIFTMAX>
int launch_attn(const int8_t* x, const int8_t* ln_in, const float* ln_bias,
                const float* m_ln, const int8_t* wqkv_t, const int32_t* bqkv,
                const float* mqkv, const int8_t* wp_t, const int32_t* bp,
                const float* mp, AttnScalars sp, int8_t* qkv, int8_t* ctx,
                int8_t* out, int B, int Np, int C, int H, int n_valid,
                int attn_bits, int proj_bits, int out_bits, int ln_ivit,
                int fast_q, int fast_poly, cudaStream_t stream) {
  const int R = B * Np, Dh = C / H;
  const size_t smem_gemm = gemm_smem(C, BN), smem_core = core_smem(Np, Dh);
  cudaError_t err;
  if ((err = allow_gemm_smem<BN>(C)) != cudaSuccess ||
      (err = cudaFuncSetAttribute(attn_core_kernel<SHIFTMAX>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)smem_core)) != cudaSuccess)
    return (int)err;
  const dim3 row_grid((R + kTileM - 1) / kTileM);
  ln_qkv_kernel<BN><<<row_grid, kThreads, smem_gemm, stream>>>(
      x, ln_in, ln_bias, m_ln, wqkv_t, bqkv, mqkv, sp, qkv, R, C, 0, ln_ivit);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  attn_core_kernel<SHIFTMAX><<<dim3(H, B), kThreads, smem_core, stream>>>(
      qkv, sp, ctx, Np, C, Dh, n_valid, attn_bits, fast_q, fast_poly);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  proj_kernel<BN><<<row_grid, kThreads, smem_gemm, stream>>>(
      x, ctx, wp_t, bp, mp, sp, out, R, C, proj_bits, out_bits, 0, 0);
  return (int)cudaGetLastError();
}

}  // namespace ivit

// Pointers in the wrapper's argument order; ln_in may be null (LN in the
// kernel) and s_exp_act is read by the ibert softmax only; ln_shift,
// m_attn, s_attn, s_exp_act, m_av, m_res_x and m_res_id point at one f32
// each.  qkv [B * Np, 3C] and ctx [B * Np, C] are int8 scratch.  ln_ivit /
// sm_ivit pick the ivit LN / softmax over the ibert ones.
extern "C" int ivit_attn_block(const int8_t* x, const int8_t* ln_in,
                               const float* ln_bias,
                               const float* m_ln, const float* ln_shift,
                               const int8_t* wqkv_t, const int32_t* bqkv,
                               const float* mqkv, const float* m_attn,
                               const float* s_attn, const float* s_exp_act,
                               const float* m_av, const int8_t* wp_t,
                               const int32_t* bp, const float* mp,
                               const float* m_res_x, const float* m_res_id,
                               int8_t* qkv, int8_t* ctx, int8_t* out, int B,
                               int Np, int C, int H, int n_valid, int attn_bits,
                               int proj_bits, int out_bits, int ln_ivit,
                               int sm_ivit, int fast_q, int fast_poly,
                               cudaStream_t stream) {
  using namespace ivit;
  const AttnScalars sp{ln_shift, m_attn, nullptr, s_attn, s_exp_act,
                       m_av,     m_res_x, m_res_id};
  // 128-column passes where C allows (DeiT-S: 3C = 1152, C = 384), else 96
  // or 64
  const int bn = pass_width(3 * C, C);
  if (bn == 0) return (int)cudaErrorInvalidValue;
  auto launch = sm_ivit ? (bn == 128  ? launch_attn<128, true>
                           : bn == 96 ? launch_attn<96, true>
                                      : launch_attn<64, true>)
                        : (bn == 128  ? launch_attn<128, false>
                           : bn == 96 ? launch_attn<96, false>
                                      : launch_attn<64, false>);
  return launch(x, ln_in, ln_bias, m_ln, wqkv_t, bqkv, mqkv, wp_t, bp, mp, sp,
                qkv, ctx, out, B, Np, C, H, n_valid, attn_bits, proj_bits,
                out_bits, ln_ivit, fast_q, fast_poly, stream);
}
