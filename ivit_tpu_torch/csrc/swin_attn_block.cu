// Fused Swin window-attention half-block, ivit and ibert families, for
// sm_90a.
//
// Replaces ivit_tpu/ops/pallas/block.py::swin_attn_block_p (body
// _swin_attn_kernel), per window of the rolled, window-partitioned token
// stream xw [B * nW, n, C] (int16, or int8 where PatchMerging feeds the
// first block of a stage):
//   LN (I-LayerNorm or ibert LN with its frozen shift; or the hoisted int8
//   ln_in) -> int8 requant -> qkv GEMM + bias -> requant -> per (window,
//   head) int32 q k^T -> clip(round(clip(round(s * m_attn)) * m_attn2) +
//   rel_addend) to int8, then + mask_addend (shifted blocks) after the clip
//   -> Shiftmax or the ibert softmax over the n keys -> probs @ v ->
//   requant by m_av -> proj GEMM + bias -> requant to 16 bits -> integer
//   residual to int16.
//
// Bound on this card: bytes.  At Swin-T, batch 64, every stage has R =
// B * nW * n = 200,704 / 4**stage rows of C = 96 * 2**stage channels, so
// each call reads and writes 2 * R * C * 2 = 77 MB of the 16-bit stream
// (~23 us at 3.35 TB/s) for 2 * R * 4C * C = 14.8 G int8 ops of qkv and
// proj GEMM plus 0.5-3.8 G of window products (~8-10 us at 1,979 TOPS).
//
// Design: the chain of attn_chain.cuh, three launches on one stream
// counted as one kernel, over the flat [B * nW * n, C] rows:
//   1. ln_qkv_kernel: 64 rows per block (windows need not align with the
//      blocks: LN and the GEMM are row-local), LN of the int16 rows into
//      shared memory, qkv GEMM on mma.sync s8, requant, int8 qkv to global;
//   2. swin_core_kernel: one block per (window, head), that head's k and v
//      in shared memory; each warp takes one query row at a time: scores
//      by dp4a (keys j and j + 32 per lane, n <= 64), the two requants and
//      the rel-pos addend, the int8 clip, then the shift mask of the
//      window's index within its image (window w % nW).  The masked scores,
//      about -100 / s_attn2, stay f32 through the softmax, whose exp clamps
//      them as the reference does (Shiftmax at n * x0, ibert at 30 * x0);
//   3. proj_kernel: 64 rows of ctx per block, proj GEMM, requant to 16 bits,
//      residual against the int16 (or int8) input, int16 out.
// One window's qkv (49 x 2304 = 113 KB at stage 3) would fit a block's
// shared memory, so a single launch per window tile is possible; the chain
// reuses the two GEMM kernels that ViT already holds bitwise, and runs the
// GEMMs over 64 full rows instead of 49 of 64.  The window pad n = 49 -> 56,
// head packing, pad_kv, win_tile and the f32 scratches of the TPU kernel are
// Mosaic workarounds, not semantics: the port runs the 49 tokens as they are.
// Rolling and window partition stay outside, in torch, as the JAX engine
// runs them; folding the permutation into the kernel's indexing, wgmma and
// TMA are later steps for speed.

#include "attn_chain.cuh"

namespace ivit {

constexpr int kSwinKeysPerLane = 2;  // n <= 64: ws <= 8

// 2. Window attention for one (window, head); SHIFTMAX: the ivit softmax,
// else the ibert one.  rel: [H, n, n] f32 rel-pos addends; mask: [nW, n, n]
// f32 shift-mask addends, or null for an unshifted block.
template <bool SHIFTMAX>
__global__ void __launch_bounds__(kThreads)
swin_core_kernel(const int8_t* __restrict__ qkv, const float* __restrict__ rel,
                 const float* __restrict__ mask, AttnScalars sp,
                 int8_t* __restrict__ ctx, int n, int C, int Dh,
                 int n_windows, int fast_q, int fast_poly) {
  extern __shared__ __align__(16) int8_t smem[];
  const int np4 = (n + 3) & ~3;
  int8_t* Ks = smem;
  int8_t* Vt = Ks + n * (Dh + 4);
  int8_t* Qs = Vt + Dh * (np4 + 4);  // [8][Dh]
  int8_t* Ps = Qs + 8 * Dh;          // [8][np4]
  const int w = blockIdx.x, h = blockIdx.y;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int8_t* base = qkv + (size_t)w * n * 3 * C + h * Dh;
  stage_kv(base, n, C, Dh, Ks, Vt);
  __syncthreads();

  const float m_attn = __ldg(sp.m_attn), m_attn2 = __ldg(sp.m_attn2);
  const float m_av = __ldg(sp.m_av);
  const SoftmaxConsts k = softmax_consts_of<SHIFTMAX>(sp);
  const float* rel_h = rel + (size_t)h * n * n;
  const float* mask_w =
      mask == nullptr ? nullptr : mask + (size_t)(w % n_windows) * n * n;
  int8_t* q = Qs + warp * Dh;
  int8_t* p = Ps + warp * np4;
  for (int i = warp; i < n; i += 8) {
    load_q(base, i, C, Dh, q, lane);
    float s[kSwinKeysPerLane];
    float smax = -8388608.f;
#pragma unroll
    for (int t = 0; t < kSwinKeysPerLane; ++t) {
      int j = lane + 32 * t;
      s[t] = -8388608.f;
      if (j < n) {
        float a = requant(__int2float_rn(qk_dot(q, Ks, j, Dh)), m_attn, 128.f);
        a = clampf(rintf(a * m_attn2) + __ldg(rel_h + i * n + j), -128.f, 127.f);
        if (mask_w != nullptr) a += __ldg(mask_w + i * n + j);
        s[t] = a;
        smax = fmaxf(smax, a);
      }
    }
    softmax_pv_row<SHIFTMAX>(s, smax, n, k, fast_q, fast_poly, p, Vt, np4, Dh,
                             m_av, ctx + ((size_t)w * n + i) * C + h * Dh,
                             lane);
  }
}

template <int BN, bool SHIFTMAX>
int launch_swin(const void* x, int x16, const int8_t* ln_in,
                const float* ln_bias, const float* m_ln, const int8_t* wqkv_t,
                const int32_t* bqkv, const float* mqkv, const float* rel,
                const float* mask, const int8_t* wp_t, const int32_t* bp,
                const float* mp, AttnScalars sp, int8_t* qkv, int8_t* ctx,
                int16_t* out, int BW, int n, int C, int H, int n_windows,
                int ln_ivit, int fast_q, int fast_poly, cudaStream_t stream) {
  const int R = BW * n, Dh = C / H;
  const size_t smem_gemm = gemm_smem(C, BN), smem_core = core_smem(n, Dh);
  cudaError_t err;
  if ((err = allow_gemm_smem<BN>(C)) != cudaSuccess ||
      (err = cudaFuncSetAttribute(swin_core_kernel<SHIFTMAX>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)smem_core)) != cudaSuccess)
    return (int)err;
  const dim3 row_grid((R + kTileM - 1) / kTileM);
  ln_qkv_kernel<BN><<<row_grid, kThreads, smem_gemm, stream>>>(
      x, ln_in, ln_bias, m_ln, wqkv_t, bqkv, mqkv, sp, qkv, R, C, x16,
      ln_ivit);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  swin_core_kernel<SHIFTMAX><<<dim3(BW, H), kThreads, smem_core, stream>>>(
      qkv, rel, mask, sp, ctx, n, C, Dh, n_windows, fast_q, fast_poly);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  proj_kernel<BN><<<row_grid, kThreads, smem_gemm, stream>>>(
      x, ctx, wp_t, bp, mp, sp, out, R, C, 16, 16, x16, 1);
  return (int)cudaGetLastError();
}

}  // namespace ivit

// Pointers in the wrapper's argument order.  x: [BW, n, C] int8 or (x16)
// int16; ln_in may be null (LN in the kernel); rel [H, n, n] and, for a
// shifted block, mask [n_windows, n, n] f32 (else null); ln_shift, m_attn,
// m_attn2, s_attn, s_exp_act (ibert softmax only), m_av, m_res_x and
// m_res_id point at one f32 each.  qkv [BW * n, 3C] and ctx [BW * n, C] are
// int8 scratch; out [BW, n, C] int16.  ln_ivit / sm_ivit pick the ivit LN /
// softmax over the ibert ones.  C % 32 == 0 and C <= 1024 with a pass
// width (ivit::pass_width of 3C and C), C / H a multiple of 4 up to 128,
// n <= 64; else cudaErrorInvalidValue.
extern "C" int ivit_swin_attn_block(
    const void* x, const int8_t* ln_in, const float* ln_bias, const float* m_ln,
    const float* ln_shift, const int8_t* wqkv_t, const int32_t* bqkv,
    const float* mqkv, const float* m_attn, const float* m_attn2,
    const float* rel, const float* mask, const float* s_attn,
    const float* s_exp_act, const float* m_av, const int8_t* wp_t,
    const int32_t* bp, const float* mp, const float* m_res_x,
    const float* m_res_id, int8_t* qkv, int8_t* ctx, int16_t* out, int BW,
    int n, int C, int H, int n_windows, int x16, int ln_ivit, int sm_ivit,
    int fast_q, int fast_poly, cudaStream_t stream) {
  using namespace ivit;
  const AttnScalars sp{ln_shift, m_attn, m_attn2, s_attn, s_exp_act,
                       m_av,     m_res_x, m_res_id};
  const int bn = pass_width(3 * C, C), dh = H > 0 ? C / H : 0;
  if (bn == 0 || C % 32 || C > 32 * kMaxLnVals || dh * H != C || dh % 4 ||
      dh > 128 || n < 1 || n > 32 * kSwinKeysPerLane || n_windows < 1)
    return (int)cudaErrorInvalidValue;
  auto launch = sm_ivit ? (bn == 128  ? launch_swin<128, true>
                           : bn == 96 ? launch_swin<96, true>
                                      : launch_swin<64, true>)
                        : (bn == 128  ? launch_swin<128, false>
                           : bn == 96 ? launch_swin<96, false>
                                      : launch_swin<64, false>);
  return launch(x, x16, ln_in, ln_bias, m_ln, wqkv_t, bqkv, mqkv, rel, mask,
                wp_t, bp, mp, sp, qkv, ctx, out, BW, n, C, H, n_windows,
                ln_ivit, fast_q, fast_poly, stream);
}
