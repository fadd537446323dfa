// The two standalone ivit nonlinearity kernels, for sm_90a.
//
// ivit_shiftmax replaces ivit_tpu/ops/pallas/nonlinear.py::shiftmax_p
// (body _shiftmax_kernel): row Shiftmax over the last axis of int8 scores
// [rows, N], columns >= n_valid masked (probability 0), into int8 probs
// (output_bit <= 8) or int16 (up to 16).
//
// ivit_shift_gelu_requant replaces shift_gelu_requant_p (body
// _shift_gelu_kernel): row ShiftGELU over the last axis of int8 [rows, H]
// (the max runs over the whole row) and the requant clip(round(y * m_out))
// to the next activation scale, int8 out.
//
// Bound on this card: bytes.  Each reads its int8 input once and writes its
// output once: at DeiT-S, Shiftmax on [256, 6, 197, 197] moves 2 x 59.6 MB
// (35.6 us at 3.35 TB/s), ShiftGELU on [50,432, 1536] 2 x 77.5 MB (46.2 us).
// The exp chains (a divide-free or correctly rounded quotient, a bit-built
// power of two, a Dekker-corrected reciprocal per row or, for ShiftGELU,
// per element) run on the f32 units, some tens of operations an element;
// they are not counted in that bound.
//
// Design: one warp per row, 8 rows per block of 256 threads.  A Shiftmax
// row (N <= 1024) is held in registers, a column per lane per step; a
// ShiftGELU row is read twice from global memory, once for its max and once
// for the values, a 4-byte word per lane, the second read from L1/L2.  The
// row code is ivit.cuh's shiftmax_row / shift_gelu_row, which the block
// kernels run too.  The scale operands are device pointers to one f32 each
// (the spec's 0-d leaves); every thread derives x0 and s_gelu * 1.702 from
// them, so a call is one launch.

#include "ivit.cuh"

namespace ivit {

constexpr int kRowsPerBlock = kThreads / 32;

template <int MAXV, typename OutT>
__global__ void __launch_bounds__(kThreads)
shiftmax_kernel(const int8_t* __restrict__ x, const float* __restrict__ s_attn,
                OutT* __restrict__ out, int rows, int N, int n_valid,
                int output_bit, int fast_q) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kRowsPerBlock + (threadIdx.x >> 5);
  if (row >= rows) return;  // whole warps leave together
  const int8_t* xr = x + (size_t)row * N;
  float v[MAXV];
#pragma unroll
  for (int t = 0; t < MAXV; ++t) {
    const int j = lane + 32 * t;
    v[t] = j < N ? (float)xr[j] : 0.f;
  }
  shiftmax_row(v, n_valid, exp_shift_x0(__ldg(s_attn)),
               shift_out_scale(output_bit), fast_q, lane);
  OutT* orow = out + (size_t)row * N;
#pragma unroll
  for (int t = 0; t < MAXV; ++t) {
    const int j = lane + 32 * t;
    if (j < N) orow[j] = (OutT)(int)v[t];
  }
}

__global__ void __launch_bounds__(kThreads)
shift_gelu_requant_kernel(const int8_t* __restrict__ x,
                          const float* __restrict__ s_gelu,
                          const float* __restrict__ m_out,
                          int8_t* __restrict__ out, int rows, int H,
                          int output_bit, int n, int out_bits, int fast_q) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kRowsPerBlock + (threadIdx.x >> 5);
  if (row >= rows) return;
  shift_gelu_row(x + (size_t)row * H, out + (size_t)row * H, H,
                 shift_gelu_x0(__ldg(s_gelu)), (float)n,
                 shift_out_scale(output_bit), __ldg(m_out), bits_lim(out_bits),
                 fast_q, lane);
}

template <int MAXV, typename OutT>
int launch_shiftmax(const int8_t* x, const float* s_attn, void* out, int rows,
                    int N, int n_valid, int output_bit, int fast_q,
                    cudaStream_t stream) {
  const dim3 grid((rows + kRowsPerBlock - 1) / kRowsPerBlock);
  shiftmax_kernel<MAXV, OutT><<<grid, kThreads, 0, stream>>>(
      x, s_attn, static_cast<OutT*>(out), rows, N, n_valid, output_bit, fast_q);
  return (int)cudaGetLastError();
}

}  // namespace ivit

// scores int8 [rows, N], N <= 1024; out int8 [rows, N] for output_bit <= 8,
// else int16; s_attn points at one f32.
extern "C" int ivit_shiftmax(const int8_t* x, const float* s_attn, void* out,
                             int rows, int N, int n_valid, int output_bit,
                             int fast_q, cudaStream_t stream) {
  if (rows == 0) return 0;
  using namespace ivit;
  // registers for 8 columns a lane where the row allows (N <= 256: ViT's
  // 197 tokens), 32 otherwise
  auto launch = output_bit <= 8
                    ? (N <= 256 ? launch_shiftmax<8, int8_t>
                                : launch_shiftmax<32, int8_t>)
                    : (N <= 256 ? launch_shiftmax<8, int16_t>
                                : launch_shiftmax<32, int16_t>);
  return launch(x, s_attn, out, rows, N, n_valid, output_bit, fast_q, stream);
}

// x, out int8 [rows, H]; s_gelu and m_out point at one f32 each; output_bit
// is the sigmoid's, n the exp's shift budget, out_bits the requant's.
extern "C" int ivit_shift_gelu_requant(const int8_t* x, const float* s_gelu,
                                       const float* m_out, int8_t* out,
                                       int rows, int H, int output_bit, int n,
                                       int out_bits, int fast_q,
                                       cudaStream_t stream) {
  if (rows == 0) return 0;
  using namespace ivit;
  const dim3 grid((rows + kRowsPerBlock - 1) / kRowsPerBlock);
  shift_gelu_requant_kernel<<<grid, kThreads, 0, stream>>>(
      x, s_gelu, m_out, out, rows, H, output_bit, n, out_bits, fast_q);
  return (int)cudaGetLastError();
}
