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
//     (cc.KERNEL_POLICY_ID).  Bound: device-memory bytes, about
//     (8*H + 3 + K) * 4 read and (K + 2) * 4 written per flow; the design
//     reads each input once, keeps the signals in registers, and writes
//     only state', rate and win (the engine discards ecn, rtt and util).
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

namespace {

constexpr int MAXHOP = 4;
constexpr int MAXK = 8;          // largest policy state (DCQCN)
constexpr float INF_WIN = 1e18f;

// NaN-propagating min/max, as jnp.minimum/maximum and torch.clamp
__device__ __forceinline__ float vmax(float a, float b) {
  return (a != a) ? a : ((b != b) ? b : (a > b ? a : b));
}
__device__ __forceinline__ float vmin(float a, float b) {
  return (a != a) ? a : ((b != b) ? b : (a < b ? a : b));
}
__device__ __forceinline__ float vclip(float x, float lo, float hi) {
  return vmin(vmax(x, lo), hi);
}

__device__ __forceinline__ float fma_ftz(float a, float b, float c) {
  const float r = fmaf(a, b, c);
  return fabsf(r) < 1.17549435e-38f ? r * 0.0f : r;
}

// Cephes expf: range reduction by ln2 in two parts, degree-7 polynomial,
// results below the smallest normal float flushed to zero
__device__ __forceinline__ float cephes_expf(float x) {
  x = (x < -0x1.5f3334p+6f) ? -0x1.5f3334p+6f : x;
  x = (x > 0x1.633334p+6f) ? 0x1.633334p+6f : x;
  float n = floorf(fma_ftz(x, 0x1.715476p+0f, 0.5f));
  n = (n < -127.0f) ? -127.0f : n;
  n = (n > 127.0f) ? 127.0f : n;
  float r = fma_ftz(-0x1.63p-1f, n, x);
  r = fma_ftz(0x1.bd0106p-13f, n, r);
  float p = fma_ftz(r, 0x1.a0d2cep-13f, 0x1.6e879cp-10f);
  p = fma_ftz(p, r, 0x1.111210p-7f);
  p = fma_ftz(p, r, 0x1.555382p-5f);
  p = fma_ftz(p, r, 0x1.555554p-3f);
  p = fma_ftz(p, r, 0.5f);
  const float y = 1.0f + fma_ftz(p, r * r, r);
  const float scale = __int_as_float(((n == n ? (int)n : 0) + 127) << 23);
  const float out = y * scale;
  return out < 1.17549435e-38f ? 0.0f : out;
}

struct Sig {
  float ecn, rtt, util, t, line, base_rtt, loss;
};

// Policy ids: cc.KERNEL_POLICY_ID.  State and param slots are the sorted
// key orders of cc.kernel_state_keys / cc.kernel_param_keys; ops.py checks
// them against the Python tables before the first launch.
enum { PFC = 0, DCQCN = 1, DCTCP = 2, TIMELY = 3, HPCC = 4, HPCC_PINT = 5,
       STATIC_WINDOW = 6 };

template <int POL>
__device__ __forceinline__ void policy_update(const float* __restrict__ p,
                                              float* s, const Sig& sig,
                                              float& rate, float& win);

// pfc: no state (one dummy zero row), no params
template <>
__device__ __forceinline__ void policy_update<PFC>(const float*, float* s,
                                                   const Sig& sig,
                                                   float& rate, float& win) {
  s[0] = 0.f;
  rate = sig.line;
  win = INF_WIN;
}

// dcqcn  state: alpha inc_count jit rc rt t_alpha t_cut t_inc
//        params: cut_gap ecn_thresh fast_rounds g hai_after mss rai_frac
//                rhai_frac timer
template <>
__device__ __forceinline__ void policy_update<DCQCN>(
    const float* __restrict__ p, float* s, const Sig& sig, float& rate,
    float& win) {
  const float cut_gap = p[0], ecn_thresh = p[1], fast_rounds = p[2],
              g = p[3], hai_after = p[4], mss = p[5], rai_frac = p[6],
              rhai_frac = p[7], timer = p[8];
  const float alpha0 = s[0], inc0 = s[1], jit = s[2], rc0 = s[3],
              rt0 = s[4], t_alpha0 = s[5], t_cut0 = s[6], t_inc0 = s[7];
  const float t = sig.t, line = sig.line;
  const float pkts = rc0 * cut_gap / mss;
  const float ecn_eff =
      (sig.loss > 0.f) ? vmin(sig.ecn + 2.0f * sig.loss, 1.0f) : sig.ecn;
  const float p_cnp = 1.0f - cephes_expf(-pkts * ecn_eff);
  const bool cong = p_cnp > ecn_thresh;
  const bool docut = cong && ((t - t_cut0) >= cut_gap * jit);
  float rt = docut ? rc0 : rt0;
  float rc = docut ? rc0 * fma_ftz(-(alpha0 / 2.0f), p_cnp, 1.0f) : rc0;
  float alpha =
      docut ? fma_ftz(fma_ftz(-g, p_cnp, 1.0f), alpha0, g * p_cnp) : alpha0;
  const float t_cut = docut ? t : t_cut0;
  float inc_count = docut ? 0.0f : inc0;
  float t_inc = docut ? t : t_inc0;

  const bool dodec = (!cong) && ((t - t_alpha0) >= timer * jit);
  alpha = dodec ? (1.0f - g) * alpha : alpha;
  const float t_alpha = (dodec || docut) ? t : t_alpha0;

  const bool doinc = (t - t_inc) >= timer * jit;
  inc_count = doinc ? inc_count + 1.0f : inc_count;
  const bool additive = inc_count > fast_rounds;
  const bool hyper = inc_count > fast_rounds + hai_after;
  rt = (doinc && additive) ? fma_ftz(hyper ? rhai_frac : rai_frac, line, rt)
                           : rt;
  rc = doinc ? 0.5f * (rt + rc) : rc;
  t_inc = doinc ? t : t_inc;

  rc = vclip(rc, 0.001f * line, line);
  rt = vclip(rt, 0.001f * line, line);
  s[0] = alpha; s[1] = inc_count; s[2] = jit; s[3] = rc; s[4] = rt;
  s[5] = t_alpha; s[6] = t_cut; s[7] = t_inc;
  rate = rc;
  win = INF_WIN;
}

// dctcp  state: alpha bdp t_rtt w       params: ecn_thresh g mss wmax_bdp
template <>
__device__ __forceinline__ void policy_update<DCTCP>(
    const float* __restrict__ p, float* s, const Sig& sig, float& rate,
    float& win) {
  const float ecn_thresh = p[0], g = p[1], mss = p[2], wmax_bdp = p[3];
  const float alpha0 = s[0], bdp = s[1], t_rtt0 = s[2], w0 = s[3];
  const float t = sig.t;
  const float rtt = vmax(sig.rtt, 1e-6f);
  const bool d = (t - t_rtt0) >= rtt;
  const float ecn_eff =
      (sig.loss > 0.f) ? vmin(sig.ecn + 2.0f * sig.loss, 1.0f) : sig.ecn;
  const float alpha = d ? fma_ftz(1.0f - g, alpha0, g * ecn_eff) : alpha0;
  const bool marked = ecn_eff > ecn_thresh;
  float w = (d && marked) ? w0 * (1.0f - alpha / 2.0f) : w0;
  w = (d && !marked) ? w + mss : w;
  const float t_rtt = d ? t : t_rtt0;
  w = vclip(w, mss, wmax_bdp * bdp);
  s[0] = alpha; s[1] = bdp; s[2] = t_rtt; s[3] = w;
  rate = sig.line;
  win = w;
}

// timely state: grad neg_count rate rtt_prev t_upd
//        params: add_frac beta ewma hai_thresh thigh tlow
template <>
__device__ __forceinline__ void policy_update<TIMELY>(
    const float* __restrict__ p, float* s, const Sig& sig, float& rate,
    float& win) {
  const float add_frac = p[0], beta = p[1], ewma = p[2], hai_thresh = p[3],
              thigh = p[4], tlow = p[5];
  const float grad0 = s[0], neg0 = s[1], r = s[2], rtt_prev0 = s[3],
              t_upd0 = s[4];
  const float t = sig.t, line = sig.line, rtt = sig.rtt;
  const float minrtt = vmax(sig.base_rtt, 1e-6f);
  const float period = vmax(minrtt, 20e-6f);
  const bool d = (t - t_upd0) >= period;
  const float grad_new = (rtt - rtt_prev0) / minrtt;
  const float grad = d ? fma_ftz(1.0f - ewma, grad0, ewma * grad_new) : grad0;
  const float delta = add_frac * line;
  const float neg = (d && (grad <= 0.0f)) ? neg0 + 1.0f : 0.0f;
  const bool hai = neg >= hai_thresh;
  const float r_low = r + (hai ? 5.0f * delta : delta);
  const float r_high =
      r * fma_ftz(-beta, 1.0f - thigh / vmax(rtt, thigh), 1.0f);
  const float gnorm = vclip(grad, 0.0f, 1.0f);
  const float r_grad = (grad <= 0.0f) ? fma_ftz(hai ? 5.0f : 1.0f, delta, r)
                                      : r * fma_ftz(-beta, gnorm, 1.0f);
  const float r_new = (rtt < tlow) ? r_low : ((rtt > thigh) ? r_high : r_grad);
  float new_rate = d ? vclip(r_new, 0.001f * line, line) : r;
  if ((sig.loss > 0.f) && d)
    new_rate = vclip(
        new_rate * fma_ftz(-beta, vmin(2.0f * sig.loss, 1.0f), 1.0f),
        0.001f * line, line);
  s[0] = grad; s[1] = neg; s[2] = new_rate;
  s[3] = d ? rtt : rtt_prev0;
  s[4] = d ? t : t_upd0;
  rate = new_rate;
  win = INF_WIN;
}

// hpcc / hpcc_pint  state: bdp stage t_rtt w wc
//                   params: eta max_stage wai_frac
template <bool PINT>
__device__ __forceinline__ void hpcc_update(const float* __restrict__ p,
                                            float* s, const Sig& sig,
                                            float& rate, float& win) {
  const float eta = p[0], max_stage = p[1], wai_frac = p[2];
  const float bdp = s[0], stage0 = s[1], t_rtt0 = s[2], wc0 = s[4];
  const float t = sig.t;
  float u = vmax(sig.util, 1e-3f);
  if (sig.loss > 0.f) u = vmax(u, 1.0f + 2.0f * sig.loss);
  const float wai = wai_frac * bdp;
  const float mult = wc0 * (eta / u) + wai;     // not contracted (see cc.py)
  const float addv = fma_ftz(wai_frac, bdp, wc0);
  const bool use_mult = (u >= eta) || (stage0 >= max_stage);
  float w = use_mult ? mult : addv;
  w = vclip(w, wai, 16.0f * bdp);
  // hpcc_pint: probabilistic INT refreshes the reference window half as
  // often (base_rtt * 2 in the update only)
  const float base_rtt = PINT ? sig.base_rtt * 2.0f : sig.base_rtt;
  const float rtt = vmax(base_rtt, 1e-6f);
  const bool d = (t - t_rtt0) >= rtt;
  s[0] = bdp;
  s[1] = d ? (use_mult ? 0.0f : stage0 + 1.0f) : stage0;
  s[2] = d ? t : t_rtt0;
  s[3] = w;
  s[4] = d ? w : wc0;
  rate = vmin(w / rtt, sig.line);
  win = w;
}

template <>
__device__ __forceinline__ void policy_update<HPCC>(
    const float* __restrict__ p, float* s, const Sig& sig, float& rate,
    float& win) {
  hpcc_update<false>(p, s, sig, rate, win);
}

template <>
__device__ __forceinline__ void policy_update<HPCC_PINT>(
    const float* __restrict__ p, float* s, const Sig& sig, float& rate,
    float& win) {
  hpcc_update<true>(p, s, sig, rate, win);
}

// static_window  state: w (baked by init)   params: none tunable
template <>
__device__ __forceinline__ void policy_update<STATIC_WINDOW>(
    const float*, float* s, const Sig& sig, float& rate, float& win) {
  rate = sig.line;
  win = s[0];
}

template <int POL>
__global__ void __launch_bounds__(256) fused_signals_policy_kernel(
    const float* __restrict__ q_d, const float* __restrict__ tx_d,
    const float* __restrict__ caps, const float* __restrict__ ecn_mask,
    const float* __restrict__ hopmask, const float* __restrict__ kmin,
    const float* __restrict__ kmax, const float* __restrict__ pmax,
    const float* __restrict__ base_rtt, const float* __restrict__ line,
    const float* __restrict__ loss, const float* __restrict__ state,
    const float* __restrict__ params, float t, float t_base_util, int F,
    int K, int P, float* __restrict__ state_out,
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
                         int B, int F, int K, int P, float* state_out,
                         float* rate_out, float* win_out,
                         cudaStream_t stream) {
  const dim3 block(256);
  const dim3 grid((F + 255) / 256, B);
  fused_signals_policy_kernel<POL><<<grid, block, 0, stream>>>(
      in[0], in[1], in[2], in[3], in[4], in[5], in[6], in[7], in[8], in[9],
      in[10], state, params, t, t_base_util, F, K, P, state_out, rate_out,
      win_out);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Returns a cudaError_t: 0 when the launch was accepted.  `hop` points to
// the 8 hop-major (B, 4, F) inputs q_d, tx_d, caps, ecn_mask, hopmask,
// kmin, kmax, pmax; `flat` to the 3 (B, F) inputs base_rtt, line, loss.
int fused_signals_policy(int policy_id, const float* q_d, const float* tx_d,
                         const float* caps, const float* ecn_mask,
                         const float* hopmask, const float* kmin,
                         const float* kmax, const float* pmax,
                         const float* base_rtt, const float* line,
                         const float* loss, const float* state,
                         const float* params, float t, float t_base_util,
                         int B, int F, int K, int P, float* state_out,
                         float* rate_out, float* win_out, void* stream) {
  const float* in[11] = {q_d, tx_d, caps, ecn_mask, hopmask, kmin, kmax,
                         pmax, base_rtt, line, loss};
  if (K < 1 || K > MAXK || F < 1 || B < 1 || B > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
#define LAUNCH(ID)                                                         \
  case ID:                                                                 \
    return (int)launch_fused<ID>(in, state, params, t, t_base_util, B, F, \
                                 K, P, state_out, rate_out, win_out, s);
  switch (policy_id) {
    LAUNCH(PFC)
    LAUNCH(DCQCN)
    LAUNCH(DCTCP)
    LAUNCH(TIMELY)
    LAUNCH(HPCC)
    LAUNCH(HPCC_PINT)
    LAUNCH(STATIC_WINDOW)
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
