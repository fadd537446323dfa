// Fused Swin window-attention half-block, ivit, ibert and ppoly softmax,
// for sm_90a.
//
// Replaces ivit_tpu/ops/pallas/block.py::swin_attn_block_p (body
// _swin_attn_kernel), per window of the rolled, window-partitioned token
// stream xw [B * nW, n, C] (int16, or int8 where PatchMerging feeds the
// first block of a stage):
//   LN (I-LayerNorm or ibert LN with its frozen shift; or the hoisted int8
//   ln_in) -> int8 requant -> qkv GEMM + bias -> requant -> per (window,
//   head) int32 q k^T -> clip(round(clip(round(s * m_attn)) * m_attn2) +
//   rel_addend) to int8, then + mask_addend (shifted blocks) after the clip
//   -> Shiftmax, the ibert or the ppoly softmax over the n keys -> probs @ v ->
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
//   1. ln_qkv_wgmma_kernel: 64 rows per block (windows need not align with
//      the blocks: LN and the GEMM are row-local), LN of the int16 rows in
//      int32 (8 lanes a row at C 96 and 192, so a warp runs 4 rows at once)
//      into the swizzled A tile under the first TMA weight slices, qkv GEMM
//      on wgmma s8, requant, int8 qkv to global;
//   2. swin_core_mma_kernel: each warp owns one (window, head) pair, 8 pairs
//      a block: it stages that head's k and v in its own slice of shared
//      memory (3 KB each at Dh 32; a warp barrier, no block barrier) and
//      runs the window's 49 query rows as 4 tiles of 16 on mma.sync m16n8k32
//      s8 against 64 padded keys: the two requants and the rel-pos addend,
//      the int8 clip, then the shift mask of the window's index within its
//      image (window w % nW).  The masked scores, about -100 / s_attn2,
//      stay exact through the softmax, whose exp clamps them as the
//      reference does (Shiftmax at n * x0, ibert at 30 * x0); the ppoly
//      exp has no clamp, so a masked score, whose offset lies below the
//      call's 256-entry table, runs the polynomial itself (ppoly_exp), and
//      the row sum stays exact in two int32 limbs;
//   3. proj_wgmma_kernel: 64 rows of ctx per block, proj GEMM on wgmma,
//      requant to 16 bits, residual against the int16 (or int8) input,
//      int16 out; the passes split over blocks at the last stages, whose
//      row blocks (49 at stage 3) would leave SMs idle.
// The table forms (a spec's freeze-time sm_lut, block.py _softmax_lut with
// the gate of :1486): the ivit and ibert cores of their own copy the 1 KB
// table into shared memory before the pairs start, and each exp is one
// lookup there; on a shifted block every position whose mask is negative
// takes the spec's sm_sat instead (the freeze verified that the tower is
// that one constant over the whole masked range); the ppoly core reads
// the spec's table in place of the call's (shifted ppoly blocks keep the
// tower: the freeze gives them no sm_sat).
// A warp per pair: a window has 49 rows, 4 query tiles, and its k and v of
// one head are 3 KB, so nothing is shared between pairs; a block per pair
// would leave most of its warps idle past the 49 rows (12,288 blocks at
// stage 0), 8 pairs a block keep every warp busy.  One window's qkv (49 x 2304
// = 113 KB at stage 3) would fit a block's shared memory, so a single
// launch per window tile is possible; the chain reuses the two GEMM kernels
// that ViT holds bitwise.  The window pad n = 49 -> 56, head packing,
// pad_kv, win_tile and the f32 scratches of the TPU kernel are Mosaic
// workarounds, not semantics: the port runs the 49 tokens as they are.
// Rolling and window partition stay outside, in torch, as the JAX engine
// runs them.

#include <type_traits>

#include "attn_chain.cuh"

namespace ivit {

constexpr int kSwinPairsPerBlock = 8;  // one (window, head) pair a warp

// 2. Window attention, one (window, head) pair a warp; SM: the softmax
// family (kSmShift the ivit one, kSmIbert, kSmPpoly; kSmShiftLut and
// kSmIbertLut their table forms); MAXD: chunks of 32 channels (1: Dh <= 32,
// Swin-T; 4: Dh <= 128).  rel: [H, n, n] f32 rel-pos addends; mask: [nW, n,
// n] f32 shift-mask addends, or null for an unshifted block.
template <int SM, int MAXD>
__global__ void __launch_bounds__(32 * kSwinPairsPerBlock, MAXD > 1 ? 2 : 3)
swin_core_mma_kernel(const int8_t* __restrict__ qkv, const float* __restrict__ rel,
                     const float* __restrict__ mask, AttnScalars sp,
                     int8_t* __restrict__ ctx, int n, int C, int Dh, int H,
                     int pairs, int n_windows, int fast_q, int fast_poly,
                     SoftmaxTable ps) {
  extern __shared__ __align__(16) int8_t smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int p = blockIdx.x * kSwinPairsPerBlock + warp;
  if (is_lut_core(SM)) {  // every warp of the block, before any leaves
    stage_lut(ps, reinterpret_cast<float*>(smem + kSwinPairsPerBlock * kv_bytes(n, Dh)),
              threadIdx.x, 32 * kSwinPairsPerBlock);
    __syncthreads();
  }
  if (p >= pairs) return;
  const int w = p / H, h = p - w * H;
  int8_t* Ks = smem + warp * kv_bytes(n, Dh);
  int8_t* Vt = Ks + ((n + 31) & ~31) * kv_ld(Dh);
  const int8_t* base = qkv + (size_t)w * n * 3 * C + h * Dh;
  stage_kv(base, n, C, Dh, Ks, Vt, lane, 32);
  __syncwarp();

  const float m_attn = __ldg(sp.m_attn), m_attn2 = __ldg(sp.m_attn2);
  const float m_av = __ldg(sp.m_av);
  const SoftmaxConsts k = softmax_consts_of<SM>(sp);
  const float* rel_h = rel + (size_t)h * n * n;
  const float* mask_w =
      mask == nullptr ? nullptr : mask + (size_t)(w % n_windows) * n * n;
  auto score = [&](int i, int j, int dot) {
    float a = requant(__int2float_rn(dot), m_attn, 128.f);
    a = clampf(rintf(a * m_attn2) + __ldg(rel_h + i * n + j), -128.f, 127.f);
    if (mask_w != nullptr) a += __ldg(mask_w + i * n + j);
    return a;
  };
  const bool sat = mask_w != nullptr && ps.sat != nullptr;
  auto masked = [&](int i, int j) { return sat && __ldg(mask_w + i * n + j) < 0.f; };
  int8_t* cbase = ctx + (size_t)w * n * C + h * Dh;
  QuadReduce red{0, 0};
  for (int i0 = 0; i0 < n; i0 += 16)
    attn_tile<SM, 2, MAXD>(base, 3 * C, i0, n, Dh, n, Ks, Vt, score, masked, k,
                           ps, fast_q, fast_poly, m_av, cbase, C, red);
}

template <int BN, int SM>
int launch_swin(const void* x, int x16, const int8_t* ln_in,
                const float* ln_bias, const float* m_ln, const int8_t* wqkv_t,
                const int32_t* bqkv, const float* mqkv, const float* rel,
                const float* mask, const int8_t* wp_t, const int32_t* bp,
                const float* mp, AttnScalars sp, SoftmaxTable ps, int8_t* qkv,
                int8_t* ctx,
                int16_t* out, int BW, int n, int C, int H, int n_windows,
                int ln_kind, int fast_q, int fast_poly, cudaStream_t stream) {
  const int R = BW * n, Dh = C / H, pairs = BW * H;
  const size_t smem_gemm = wg_smem(C, BN);
  const size_t smem_core = kSwinPairsPerBlock * kv_bytes(n, Dh) +
                           (is_lut_core(SM) ? 256 * sizeof(float) : 0);
  CUtensorMap mq, mpj;
  cudaError_t err;
  if ((err = prepare_gemms<BN>(wqkv_t, wp_t, C, &mq, &mpj)) != cudaSuccess ||
      (err = cudaFuncSetAttribute(swin_core_mma_kernel<SM, 1>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)smem_core)) != cudaSuccess ||
      (err = cudaFuncSetAttribute(swin_core_mma_kernel<SM, 4>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)smem_core)) != cudaSuccess)
    return (int)err;
  const int row_blocks = (R + kGemmRows - 1) / kGemmRows;
  ln_qkv_wgmma_kernel<BN><<<row_blocks, kGemmThreads, smem_gemm, stream>>>(
      mq, x, ln_in, ln_bias, m_ln, bqkv, mqkv, sp, qkv, R, C, x16, ln_kind);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const int blocks = (pairs + kSwinPairsPerBlock - 1) / kSwinPairsPerBlock;
  const int threads = 32 * kSwinPairsPerBlock;
  if (Dh <= 32)  // Swin-T's heads
    swin_core_mma_kernel<SM, 1><<<blocks, threads, smem_core, stream>>>(
        qkv, rel, mask, sp, ctx, n, C, Dh, H, pairs, n_windows, fast_q,
        fast_poly, ps);
  else
    swin_core_mma_kernel<SM, 4><<<blocks, threads, smem_core, stream>>>(
        qkv, rel, mask, sp, ctx, n, C, Dh, H, pairs, n_windows, fast_q,
        fast_poly, ps);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  proj_wgmma_kernel<BN><<<gemm_grid(R, C, BN), kGemmThreads, smem_gemm,
                          stream>>>(mpj, x, ctx, bp, mp, sp, out, R, C, 16, 16,
                                    x16, 1);
  return (int)cudaGetLastError();
}

}  // namespace ivit

// Pointers in the wrapper's argument order.  x: [BW, n, C] int8 or (x16)
// int16; ln_in may be null (LN in the kernel); rel [H, n, n] and, for a
// shifted block, mask [n_windows, n, n] f32 (else null); ln_shift, m_attn,
// m_attn2, s_attn, s_exp_act (ibert softmax only), m_av, m_res_x and
// m_res_id point at one f32 each.  qkv [BW * n, 3C] and ctx [BW * n, C] are
// int8 scratch; out [BW, n, C] int16.  ln_kind: the LayerNorm (0 ibert, 1
// ivit, 2 ibert with I-BERT's integer sqrt); sm the softmax (0 ibert, 1
// Shiftmax, 2 ppoly); for ppoly, pp describes the fitted table (host
// memory; null otherwise) and exp_table is 256 f32 of scratch for its exp
// table, whose launch runs first.  lut: as ivit_attn_block's (exp_table
// then the spec's sm_lut); sat: with lut on a shifted ivit or ibert block,
// the spec's sm_sat (one f32 on the card), else null.  C % 32 == 0 and C
// <= 1024 with a pass width (ivit::pass_width of 3C and C), C / H a
// multiple of 4 up to 128, n <= 64, a ppoly table within ppoly.cuh's
// limits; else cudaErrorInvalidValue.
extern "C" int ivit_swin_attn_block(
    const void* x, const int8_t* ln_in, const float* ln_bias, const float* m_ln,
    const float* ln_shift, const int8_t* wqkv_t, const int32_t* bqkv,
    const float* mqkv, const float* m_attn, const float* m_attn2,
    const float* rel, const float* mask, const float* s_attn,
    const float* s_exp_act, const float* m_av, const int8_t* wp_t,
    const int32_t* bp, const float* mp, const float* m_res_x,
    const float* m_res_id, int8_t* qkv, int8_t* ctx, int16_t* out, int BW,
    int n, int C, int H, int n_windows, int x16, int ln_kind, int sm,
    int fast_q, int fast_poly, const ivit::PpolyArgs* pp, float* exp_table,
    int lut, const float* sat, cudaStream_t stream) {
  using namespace ivit;
  const AttnScalars sp{ln_shift, m_attn, m_attn2, s_attn, s_exp_act,
                       m_av,     m_res_x, m_res_id};
  SoftmaxTable ps{exp_table, {}, lut == 2, sat, nullptr};
  const int bn = pass_width(3 * C, C), dh = H > 0 ? C / H : 0;
  if (bn == 0 || C % 32 || C > 1024 || dh * H != C || dh % 4 ||
      dh > 128 || n < 1 || n > 64 || n_windows < 1 || sm < 0 || sm > 2 ||
      (sm == kSmPpoly && !ppoly_args_ok(pp, false)) || ln_kind < 0 ||
      ln_kind > 2 || lut < 0 || lut > 2 || (lut != 0 && exp_table == nullptr) ||
      (sat != nullptr && (lut == 0 || sm == kSmPpoly || mask == nullptr)))
    return (int)cudaErrorInvalidValue;
  if (sm == kSmPpoly) {
    ps.pp = *pp;
    if (lut == 0) {
      const cudaError_t err = launch_ppoly_table(ps.pp, false, nullptr, exp_table, stream);
      if (err != cudaSuccess) return (int)err;
    }
  }
  auto pick = [&](auto sm_tag) {
    constexpr int S = decltype(sm_tag)::value;
    return bn == 128 ? launch_swin<128, S> : bn == 96 ? launch_swin<96, S>
                                                      : launch_swin<64, S>;
  };
  auto launch =
      sm == kSmPpoly ? pick(std::integral_constant<int, kSmPpoly>{})
      : sm == kSmShift
          ? (lut ? pick(std::integral_constant<int, kSmShiftLut>{})
                 : pick(std::integral_constant<int, kSmShift>{}))
          : (lut ? pick(std::integral_constant<int, kSmIbertLut>{})
                 : pick(std::integral_constant<int, kSmIbert>{}));
  return launch(x, x16, ln_in, ln_bias, m_ln, wqkv_t, bqkv, mqkv, rel, mask,
                wp_t, bp, mp, sp, ps, qkv, ctx, out, BW, n, C, H, n_windows,
                ln_kind, fast_q, fast_poly, stream);
}
