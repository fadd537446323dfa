// Fused attention half-block, ivit, ibert and ppoly softmax, for sm_90a.
//
// Replaces ivit_tpu/ops/pallas/block.py::attn_block_p (body _attn_kernel):
//   LN (I-LayerNorm or ibert LN; or the hoisted int8 ln_in) -> int8
//   requant -> qkv GEMM + bias -> requant -> per head int32 q k^T ->
//   requant by m_attn -> softmax over the n_valid columns (Shiftmax: shift
//   exp, exact two-limb row sum, 2**31 reciprocal; ibert: int exp, 16-bit
//   exp requant, 2**32 reciprocal; ppoly: the fitted polynomial exp on the
//   exp_bits grid, exact row sum, 2**32 reciprocal) -> probs @ v -> requant
//   by m_av -> proj GEMM + bias -> requant -> integer residual.
// The token stream in and out is int8 or int16, each read and written as
// it is: the reference's INT16 configuration (softmax and norm2_in at 16
// bits) takes int8 x to an int16 out.  The probabilities are 8 or 16 bits
// (sm_bit); the 16-bit ones go through P v exactly as two 8-bit products
// (attn_chain.cuh attn_tile), each softmax family's core an instantiation
// of its own.
//
// Bound on this card: operations.  At DeiT-S (B 256, N 197, C 384, 6 heads)
// one call does 2 * B * N * (3C * C + C * C) + 2 * 2 * B * N * N * C = 75 G
// int8 ops (~38 us at 1,979 TOPS) and moves ~39 MB of operands (~12 us at
// 3.35 TB/s); the softmax adds ~60 M elementwise exp chains on the CUDA
// cores, which bound the core launch: the exps run in exact int32 (the
// integer and conversion pipes, not the tensor cores, set its pace).
//
// Design: one image's int8 qkv is 197 x 1152 = 230 KB, more than a block's
// 227 KB of shared memory, so the TPU kernel's single body becomes a chain
// of three launches on one stream, counted as one kernel (the first and the
// last, and the core's tile code, shared with swin_attn_block.cu in
// attn_chain.cuh):
//   1. ln_qkv_wgmma_kernel: 64 token rows per block, LN (exact.cuh
//      ln_row_i32, 16 lanes a row) written straight into the swizzled
//      K-major A tile while TMA brings the first weight slices, qkv GEMM on
//      wgmma m64nNk32 s8 (wgmma_gemm.cuh), requant, 4-byte stores of qkv;
//   2. attn_core_mma_kernel: one block per (head, image) with that head's k
//      and v (transposed, keys permuted) staged once in shared memory; each
//      group of 4 warps takes 16 query rows at a time on mma.sync m16n8k32
//      s8, warp p against keys 64 p .. 64 p + 63: scores in int32
//      registers, requant, softmax on the accumulator layout (a row in a
//      quad of lanes of each warp, maxima and exact sums exchanged through
//      shared memory; Shiftmax through ivit.cuh shiftmax_quad), the int8
//      probabilities packed from those registers into the A fragments of
//      probs @ v, the other warps' int32 partial sums added into the
//      first's.  Four warps a tile keep 32 scores a thread, so two or
//      three blocks fit an SM.  The [N, N] matrix is never stored.  The
//      ppoly exps are lookups in the call's 256-entry table (ppoly.cuh,
//      one small launch before this one): int8 scores have offsets x - max
//      + 127 in [-128, 127] only;
//   3. proj_wgmma_kernel: 64 rows of ctx per block, proj GEMM on wgmma,
//      requant, residual, the passes split over blocks where the row blocks
//      would leave SMs idle.
// The table forms (a spec's freeze-time sm_lut, block.py _softmax_lut):
// the ivit and ibert cores of their own (kSmShiftLut, kSmIbertLut) copy the
// 1 KB table into shared memory with k and v, and each exp is one lookup
// there (attn_chain.cuh lut_softmax_quad); the ppoly core reads the spec's
// table in place of the call's, whose launch is then skipped.
// The LN shift and the exp constants are derived in every thread from the
// spec's scalar leaves, with the plain version's rdiv, so a call costs the
// host no arithmetic launches of its own.

#include <type_traits>

#include "attn_chain.cuh"

namespace ivit {

constexpr int kCoreThreads = 256;  // 8 warps
constexpr int kSplit = 4;          // warps a query tile: keys split 4 ways
constexpr int kCoreGroups = kCoreThreads / (32 * kSplit);

// Shared memory of one core block: k and v, the split exchanges, and for a
// table-form core its 1 KB exp table.
__host__ __device__ constexpr size_t core_smem(int Np, int Dh, bool lut) {
  return kv_bytes(Np, Dh) + kCoreGroups * split_xchg_bytes(kSplit, Dh) +
         (lut ? 256 * sizeof(float) : 0);
}

// 2. Softmax attention for one (head, image); SM: the softmax family
// (kSmShift the ivit one, kSmIbert, kSmPpoly; kSmShiftLut and kSmIbertLut
// their table forms); SB: the probabilities' bits, 8 or 16.  Each group of kSplit warps takes 16 query rows at a
// time, warp p of it keys 64 p .. 64 p + 63 (Np <= 256), so that a thread
// holds at most 32 scores; MAXD: chunks of 32 channels (2: Dh <= 64, 4:
// Dh <= 128).  Three blocks an SM (80 registers a thread) hold the 8-bit
// Shiftmax core at Dh <= 64; the ibert core, whose exp keeps more
// constants live, the ppoly core, Dh 128 and the 16-bit cores, whose
// probabilities stay live through P v, take two (128 registers), spilling
// nothing.  The 8-bit table-form cores at Dh <= 64 take three blocks, as
// Shiftmax's.
template <int SM, int MAXD, int SB>
__global__ void __launch_bounds__(kCoreThreads,
                                  (SM == kSmShift || is_lut_core(SM)) && MAXD <= 2 &&
                                          SB == 8
                                      ? 3
                                      : 2)
attn_core_mma_kernel(const int8_t* __restrict__ qkv, AttnScalars sp,
                     int8_t* __restrict__ ctx, int Np, int C, int Dh,
                     int n_valid, int attn_bits, int fast_q, int fast_poly,
                     SoftmaxTable ps) {
  extern __shared__ __align__(16) int8_t smem[];
  const int h = blockIdx.x, b = blockIdx.y, warp = threadIdx.x >> 5;
  const int group = warp / kSplit;
  int8_t* Ks = smem;
  int8_t* Vt = Ks + ((Np + 31) & ~31) * kv_ld(Dh);
  int* xch = reinterpret_cast<int*>(smem + kv_bytes(Np, Dh) +
                                    group * split_xchg_bytes(kSplit, Dh));
  const int8_t* base = qkv + (size_t)b * Np * 3 * C + h * Dh;
  stage_kv(base, Np, C, Dh, Ks, Vt, threadIdx.x, kCoreThreads);
  if (is_lut_core(SM))
    stage_lut(ps, reinterpret_cast<float*>(smem + core_smem(Np, Dh, false)),
              threadIdx.x, kCoreThreads);
  __syncthreads();

  const float m_attn = __ldg(sp.m_attn), m_av = __ldg(sp.m_av);
  const SoftmaxConsts k = softmax_consts_of<SM>(sp);
  const float lim_a = bits_lim(attn_bits);
  auto score = [&](int, int, int dot) {
    return requant(__int2float_rn(dot), m_attn, lim_a);
  };
  auto unmasked = [](int, int) { return false; };
  int8_t* cbase = ctx + (size_t)b * Np * C + h * Dh;
  SplitReduce<kSplit> red{xch, warp % kSplit, 1 + group, 0, 0};
  for (int i0 = 16 * group; i0 < Np; i0 += 16 * kCoreGroups)
    attn_tile<SM, 8 / kSplit, MAXD, SB>(base, 3 * C, i0, Np, Dh, n_valid, Ks,
                                        Vt, score, unmasked, k, ps, fast_q,
                                        fast_poly, m_av, cbase, C, red);
}

template <int BN, int SM, int SB>
int launch_attn(const void* x, int x16, const int8_t* ln_in,
                const float* ln_bias, const float* m_ln, const int8_t* wqkv_t,
                const int32_t* bqkv, const float* mqkv, const int8_t* wp_t,
                const int32_t* bp, const float* mp, AttnScalars sp,
                SoftmaxTable ps, int8_t* qkv, int8_t* ctx, void* out, int B,
                int Np, int C, int H, int n_valid, int attn_bits,
                int proj_bits, int out_bits, int ln_kind, int fast_q,
                int fast_poly, cudaStream_t stream) {
  const int R = B * Np, Dh = C / H;
  const size_t smem_gemm = wg_smem(C, BN);
  const size_t smem_core = core_smem(Np, Dh, is_lut_core(SM));
  CUtensorMap mq, mpj;
  cudaError_t err;
  if ((err = prepare_gemms<BN>(wqkv_t, wp_t, C, &mq, &mpj)) != cudaSuccess ||
      (err = cudaFuncSetAttribute(attn_core_mma_kernel<SM, 2, SB>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)smem_core)) != cudaSuccess ||
      (err = cudaFuncSetAttribute(attn_core_mma_kernel<SM, 4, SB>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)smem_core)) != cudaSuccess)
    return (int)err;
  const int row_blocks = (R + kGemmRows - 1) / kGemmRows;
  ln_qkv_wgmma_kernel<BN><<<row_blocks, kGemmThreads, smem_gemm, stream>>>(
      mq, x, ln_in, ln_bias, m_ln, bqkv, mqkv, sp, qkv, R, C, x16, ln_kind);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const dim3 core_grid(H, B);
  if (Dh <= 64)
    attn_core_mma_kernel<SM, 2, SB><<<core_grid, kCoreThreads, smem_core, stream>>>(
        qkv, sp, ctx, Np, C, Dh, n_valid, attn_bits, fast_q, fast_poly, ps);
  else
    attn_core_mma_kernel<SM, 4, SB><<<core_grid, kCoreThreads, smem_core, stream>>>(
        qkv, sp, ctx, Np, C, Dh, n_valid, attn_bits, fast_q, fast_poly, ps);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  proj_wgmma_kernel<BN><<<gemm_grid(R, C, BN), kGemmThreads, smem_gemm,
                          stream>>>(mpj, x, ctx, bp, mp, sp, out, R, C,
                                    proj_bits, out_bits, x16, out_bits > 8);
  return (int)cudaGetLastError();
}

}  // namespace ivit

// Pointers in the wrapper's argument order; ln_in may be null (LN in the
// kernel); the scalar operands point at one f32 each (s_exp_act: the ibert
// softmax only).  x: int8, or int16 with x16; out: int8, or int16 where
// out_bits > 8.  ln_kind: the LayerNorm (0 ibert, 1 ivit, 2 ibert with
// I-BERT's integer sqrt).  sm picks the softmax (0 ibert, 1 Shiftmax, 2
// ppoly) and sm_bit its probabilities' bits (8 or 16); for ppoly, pp
// describes the fitted table (host memory; null otherwise) and exp_table is
// 256 f32 of scratch for its exp table, whose launch runs first.  lut: 0
// the towers; 1 or 2 the table form, exp_table then the spec's sm_lut (256
// f32 on the card, no table launch), the ivit row sum in two limbs (1) or
// one int32 reduction (2).  qkv [B * Np, 3C] and ctx [B * Np, C] are int8
// scratch.  Shapes, bits or a ppoly table the kernels do not take:
// cudaErrorInvalidValue.
extern "C" int ivit_attn_block(const void* x, const int8_t* ln_in,
                               const float* ln_bias,
                               const float* m_ln, const float* ln_shift,
                               const int8_t* wqkv_t, const int32_t* bqkv,
                               const float* mqkv, const float* m_attn,
                               const float* s_attn, const float* s_exp_act,
                               const float* m_av, const int8_t* wp_t,
                               const int32_t* bp, const float* mp,
                               const float* m_res_x, const float* m_res_id,
                               int8_t* qkv, int8_t* ctx, void* out, int B,
                               int Np, int C, int H, int n_valid, int sm_bit,
                               int attn_bits, int proj_bits, int out_bits,
                               int x16, int ln_kind, int sm, int fast_q,
                               int fast_poly,
                               const ivit::PpolyArgs* pp, float* exp_table,
                               int lut, cudaStream_t stream) {
  using namespace ivit;
  const AttnScalars sp{ln_shift, m_attn, nullptr, s_attn, s_exp_act,
                       m_av,     m_res_x, m_res_id};
  SoftmaxTable ps{exp_table, {}, lut == 2, nullptr, nullptr};
  // 128-column passes where C allows (DeiT-S: 3C = 1152, C = 384), else 96
  // or 64
  const int bn = pass_width(3 * C, C), dh = H > 0 ? C / H : 0;
  if (bn == 0 || C % 32 || C > 1024 || dh * H != C || dh % 4 ||
      dh > 128 || Np < 1 || Np > 256 || n_valid < 1 || n_valid > Np ||
      (sm_bit != 8 && sm_bit != 16) || attn_bits < 2 || attn_bits > 8 ||
      proj_bits < 2 || proj_bits > 16 || out_bits < 2 || out_bits > 16 ||
      sm < 0 || sm > 2 || (sm == kSmPpoly && !ppoly_args_ok(pp, false)) ||
      ln_kind < 0 || ln_kind > 2 || lut < 0 || lut > 2 ||
      (lut != 0 && exp_table == nullptr))
    return (int)cudaErrorInvalidValue;
  if (sm == kSmPpoly) {
    ps.pp = *pp;
    if (lut == 0) {
      const cudaError_t err = launch_ppoly_table(ps.pp, false, nullptr, exp_table, stream);
      if (err != cudaSuccess) return (int)err;
    }
  }
  auto pick_bn = [&](auto sm_tag, auto sb_tag) {
    constexpr int S = decltype(sm_tag)::value, P = decltype(sb_tag)::value;
    return bn == 128 ? launch_attn<128, S, P> : bn == 96 ? launch_attn<96, S, P>
                                                         : launch_attn<64, S, P>;
  };
  auto pick = [&](auto sm_tag) {
    return sm_bit == 16 ? pick_bn(sm_tag, std::integral_constant<int, 16>{})
                        : pick_bn(sm_tag, std::integral_constant<int, 8>{});
  };
  auto launch =
      sm == kSmPpoly ? pick(std::integral_constant<int, kSmPpoly>{})
      : sm == kSmShift
          ? (lut ? pick(std::integral_constant<int, kSmShiftLut>{})
                 : pick(std::integral_constant<int, kSmShift>{}))
          : (lut ? pick(std::integral_constant<int, kSmIbertLut>{})
                 : pick(std::integral_constant<int, kSmIbert>{}));
  return launch(x, x16, ln_in, ln_bias, m_ln, wqkv_t, bqkv, mqkv, wp_t, bp, mp,
                sp, ps, qkv, ctx, out, B, Np, C, H, n_valid, attn_bits,
                proj_bits, out_bits, ln_kind, fast_q, fast_poly, stream);
}
