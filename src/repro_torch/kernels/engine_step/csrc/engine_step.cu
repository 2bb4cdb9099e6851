// Engine-step kernels of the fluid RoCE simulator, hand-written for Hopper
// (sm_90a).  Built by repro_torch/kernels/build.py with nvcc into a shared
// library with a plain C interface and loaded with ctypes; the wrappers in
// repro_torch/kernels/engine_step/ops.py check shapes and types, allocate
// the outputs and launch on PyTorch's current stream.
//
// fused_signals_policy   replaces the Pallas kernel
//     repro/kernels/engine_step/engine_step.py::fused_signals_policy_tiled
//     (body _signals_policy_kernel): engine stages 1+2.  One thread per
//     (lane, flow); the MAXHOP hop loop is unrolled.  Inputs are hop-major
//     (B, H, F) and flat (B, F) float32, so neighbouring threads read
//     neighbouring flows; state is (B, K, F) in cc.kernel_state_keys order,
//     params a (B, P) row per lane in cc.kernel_param_keys order.  The
//     policy's update is a device function picked by a template on its id
//     (cc.KERNEL_POLICY_ID), defined in ../../csrc/cc_policy.cuh.  Bound:
//     device-memory bytes, about (8*H + 3 + K) * 4 read and (K + 2) * 4
//     written per flow; the design reads each input once, keeps the
//     signals in registers, and writes only state', rate and win (the
//     engine discards ecn, rtt and util).
//     The last block is masked, so every F is right (the Pallas grid of
//     N8 // 8 tiles dropped the tail tiles).
//
// segment_reduce         replaces engine_step.py::segment_reduce_tiled
//     (_seg_kernel): out[b, s] = sum_c vals[b, idx[s, c]], where an index
//     outside [0, n_in) reads 0 (the plan's "+0" slot is n_in).  One warp
//     per segment row: the C <= 64 members are gathered as <= 2 per lane
//     into shared memory, then added in the reference's order by one lane.
//     Bound: bytes (idx and the gathered values); at the main path's
//     widths (n_out <= 641) the launch itself dominates.
//
// segment_reduce_pfc     replaces engine_step.py::segment_reduce_pfc_tiled
//     (_seg_pfc_kernel): the same per-ingress-port sum, then the PFC
//     hysteresis paused' = (q > xoff & can) ? 1 : (q < xon) ? 0 : prev.
//
// Arithmetic follows the reference bit for bit, as the op path does
// (repro_torch/core/arith.py): build without --use_fast_math and with
// --fmad=false, so that nothing is contracted implicitly; the multiply-adds
// that the reference's CPU backend contracts are explicit fmaf calls with
// the result's subnormals flushed (fma_ftz); exp is Cephes' expf
// (cephes_expf); the segment sums add in the reference's order
// (ordered_row_sum).  DCQCN's p_cnp > ecn_thresh and TIMELY's rtt bands
// are thresholds that results hinge on, and the simulator amplifies an ulp
// into a different cut or pause step.

#include <cuda_runtime.h>
#include <stdint.h>

#include "../../csrc/cc_policy.cuh"

namespace {

constexpr int MAXHOP = 4;
constexpr int MAXK = 8;          // largest policy state (DCQCN)

template <int POL>
__global__ void __launch_bounds__(256) fused_signals_policy_kernel(
    const float* __restrict__ q_d, const float* __restrict__ tx_d,
    const float* __restrict__ caps, const float* __restrict__ ecn_mask,
    const float* __restrict__ hopmask, const float* __restrict__ kmin,
    const float* __restrict__ kmax, const float* __restrict__ pmax,
    const float* __restrict__ base_rtt, const float* __restrict__ line,
    const float* __restrict__ loss, const float* __restrict__ state,
    const float* __restrict__ params, float t, float t_base_util, float dt,
    int F, int K, int P, float* __restrict__ state_out,
    float* __restrict__ rate_out, float* __restrict__ win_out) {
  const int f = blockIdx.x * blockDim.x + threadIdx.x;
  const int b = blockIdx.y;
  if (f >= F) return;
  const int64_t flat = (int64_t)b * F + f;

  // stage 1: ECN-mark product, queueing RTT, INT utilisation over hops;
  // sums and products run hop by hop, as the op path's reductions do
  float qsum = 0.0f, unmarked = 1.0f, util = 0.0f;
#pragma unroll
  for (int h = 0; h < MAXHOP; ++h) {
    const int64_t i = ((int64_t)b * MAXHOP + h) * F + f;
    const float q = q_d[i], tx = tx_d[i], cap = caps[i], hm = hopmask[i];
    const float lo = kmin[i];
    float mark = vclip((q - lo) / vmax(kmax[i] - lo, 1.0f), 0.0f, 1.0f)
                 * pmax[i];
    mark = mark * ecn_mask[i];
    unmarked = unmarked * (1.0f - mark);
    qsum = qsum + q / cap * hm;
    const float util_l = tx / cap + q / (cap * t_base_util);
    util = vmax(util, hm != 0.0f ? util_l : 0.0f);
  }
  Sig sig;
  sig.base_rtt = base_rtt[flat];
  sig.rtt = sig.base_rtt + qsum;
  sig.ecn = 1.0f - unmarked;
  sig.util = util;
  sig.t = t;
  sig.dt = dt;
  sig.line = line[flat];
  sig.loss = loss[flat];

  // stage 2: the policy's state update
  float s[MAXK];
#pragma unroll
  for (int k = 0; k < MAXK; ++k)
    s[k] = (k < K) ? state[((int64_t)b * K + k) * F + f] : 0.0f;
  float rate, win;
  policy_update<POL>(params + (int64_t)b * P, s, sig, rate, win);
#pragma unroll
  for (int k = 0; k < MAXK; ++k)
    if (k < K) state_out[((int64_t)b * K + k) * F + f] = s[k];
  rate_out[flat] = rate;
  win_out[flat] = win;
}

// The reference's order for a power-of-two row of C <= 64 values
// (repro_torch.core.arith.row_sum): C <= 16 left to right; C == 32 eight
// strided partial sums, then a halving tree; C == 64 two blocks of 32,
// each left to right, then their totals.
__device__ __forceinline__ float ordered_row_sum(const float* v, int C) {
  if (C <= 16) {
    float s = v[0];
    for (int k = 1; k < C; ++k) s = s + v[k];
    return s;
  }
  if (C == 32) {
    float acc[8];
#pragma unroll
    for (int k = 0; k < 8; ++k)
      acc[k] = ((v[k] + v[k + 8]) + v[k + 16]) + v[k + 24];
#pragma unroll
    for (int k = 0; k < 4; ++k) acc[k] = acc[k] + acc[k + 4];
    acc[0] = acc[0] + acc[2];
    acc[1] = acc[1] + acc[3];
    return acc[0] + acc[1];
  }
  float lo = v[0], hi = v[32];
  for (int k = 1; k < 32; ++k) {
    lo = lo + v[k];
    hi = hi + v[32 + k];
  }
  return lo + hi;
}

// One warp per segment row: the lanes gather the row's (up to 64) values
// into shared memory in parallel, then lane 0 adds them in the order above.
template <bool PFC_OUT>
__global__ void __launch_bounds__(256) segment_reduce_kernel(
    const float* __restrict__ vals, const int32_t* __restrict__ idx,
    int n_in, int n_out, int C, float* __restrict__ out,
    const float* __restrict__ xoff, const float* __restrict__ xon,
    const uint8_t* __restrict__ can, const uint8_t* __restrict__ prev,
    uint8_t* __restrict__ paused) {
  __shared__ float row[8][64];
  const int warp = threadIdx.x >> 5;
  const int seg = blockIdx.x * 8 + warp;
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.y;
  if (seg >= n_out) return;          // uniform across the warp
  const float* v = vals + (int64_t)b * n_in;
  const int32_t* ids = idx + (int64_t)seg * C;
#pragma unroll
  for (int c = lane; c < 64; c += 32) {
    if (c < C) {
      const int j = ids[c];
      row[warp][c] = (j >= 0 && j < n_in) ? v[j] : 0.0f;
    }
  }
  __syncwarp();
  if (lane == 0) {
    const float q = ordered_row_sum(row[warp], C);
    const int64_t o = (int64_t)b * n_out + seg;
    out[o] = q;
    if (PFC_OUT) {
      const bool over = (q > xoff[o]) && (can[o] != 0);
      const bool under = q < xon[o];
      paused[o] = over ? 1 : (under ? 0 : (prev[o] != 0 ? 1 : 0));
    }
  }
}

template <int POL>
cudaError_t launch_fused(const float* const* in, const float* state,
                         const float* params, float t, float t_base_util,
                         float dt, int B, int F, int K, int P,
                         float* state_out, float* rate_out, float* win_out,
                         cudaStream_t stream) {
  const dim3 block(256);
  const dim3 grid((F + 255) / 256, B);
  fused_signals_policy_kernel<POL><<<grid, block, 0, stream>>>(
      in[0], in[1], in[2], in[3], in[4], in[5], in[6], in[7], in[8], in[9],
      in[10], state, params, t, t_base_util, dt, F, K, P, state_out,
      rate_out, win_out);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Returns a cudaError_t: 0 when the launch was accepted.  The 8 hop-major
// (B, 4, F) inputs q_d, tx_d, caps, ecn_mask, hopmask, kmin, kmax, pmax
// (pmax with any ECN scale folded in) and the 3 (B, F) inputs base_rtt,
// line, loss; t is the step's time and dt its size.
int fused_signals_policy(int policy_id, const float* q_d, const float* tx_d,
                         const float* caps, const float* ecn_mask,
                         const float* hopmask, const float* kmin,
                         const float* kmax, const float* pmax,
                         const float* base_rtt, const float* line,
                         const float* loss, const float* state,
                         const float* params, float t, float t_base_util,
                         float dt, int B, int F, int K, int P,
                         float* state_out, float* rate_out, float* win_out,
                         void* stream) {
  const float* in[11] = {q_d, tx_d, caps, ecn_mask, hopmask, kmin, kmax,
                         pmax, base_rtt, line, loss};
  if (K < 1 || K > MAXK || F < 1 || B < 1 || B > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
#define LAUNCH(ID)                                                         \
  case ID:                                                                 \
    return (int)launch_fused<ID>(in, state, params, t, t_base_util, dt, B, \
                                 F, K, P, state_out, rate_out, win_out, s);
  switch (policy_id) {
    LAUNCH(PFC)
    LAUNCH(DCQCN)
    LAUNCH(DCTCP)
    LAUNCH(TIMELY)
    LAUNCH(HPCC)
    LAUNCH(HPCC_PINT)
    LAUNCH(STATIC_WINDOW)
    LAUNCH(MLP)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef LAUNCH
}

int segment_reduce(const float* vals, const int32_t* idx, int B, int n_in,
                   int n_out, int C, float* out, void* stream) {
  if (C < 1 || C > 64 || (C & (C - 1)) || n_out < 1 || B < 1 || B > 65535)
    return (int)cudaErrorInvalidValue;
  const dim3 block(256);                       // 8 segments per block
  const dim3 grid((n_out + 7) / 8, B);
  segment_reduce_kernel<false><<<grid, block, 0, (cudaStream_t)stream>>>(
      vals, idx, n_in, n_out, C, out, nullptr, nullptr, nullptr, nullptr,
      nullptr);
  return (int)cudaGetLastError();
}

int segment_reduce_pfc(const float* vals, const int32_t* idx, int B,
                       int n_in, int n_out, int C, const float* xoff,
                       const float* xon, const uint8_t* can,
                       const uint8_t* prev, float* q_out, uint8_t* paused_out,
                       void* stream) {
  if (C < 1 || C > 64 || (C & (C - 1)) || n_out < 1 || B < 1 || B > 65535)
    return (int)cudaErrorInvalidValue;
  const dim3 block(256);
  const dim3 grid((n_out + 7) / 8, B);
  segment_reduce_kernel<true><<<grid, block, 0, (cudaStream_t)stream>>>(
      vals, idx, n_in, n_out, C, q_out, xoff, xon, can, prev, paused_out);
  return (int)cudaGetLastError();
}

}  // extern "C"
