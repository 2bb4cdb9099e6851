// The CC policies' per-flow updates as CUDA device functions, shared by
// the kernels that run a policy's update: engine_step.cu's fused signals +
// policy kernel (every registered policy; a persistent kernel whose
// threads each compute one flow of a tile staged in shared memory, the
// params p a row in shared memory) and cc_update.cu's DCQCN update.
// One definition, so the two kernels compute the same bits, and the same
// bits as the op path (repro_torch/core/cc.py): the two-input
// multiply-adds the reference's CPU backend contracts are explicit fmaf
// calls with subnormal results flushed (fma_ftz), exp is Cephes' expf
// (cephes_expf), and the including source is built with --fmad=false so
// that nothing else is contracted.  The learned policy's tanh and
// logistic are the reference's expansions (xla_tanhf, xla_sigmoidf), as
// repro_torch/core/arith.py computes them.  The scalar functions are
// shortened where the bits allow (plain fmaf in exp and tanh, an integer n
// in exp, one compare for tanh's small and NaN inputs, one flush-to-zero
// multiply for the flush of fma_ftz) and proven equal to their plain
// versions over every float32 input on the card (engine_step.cu:
// scalar_fn; chip_smoke.py: scalar_exhaustive).  The fused kernel loads
// only the inputs of the signals a policy reads (policy_signals).
#pragma once

#include <cuda_runtime.h>

namespace {

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

// a subnormal to the zero of its sign, as `fabsf(r) < FLT_MIN ? r * 0.0f
// : r` (arith.ftz): one flush-to-zero multiply by 1, proven equal in bits
// over every float32 input (any NaN equal to any NaN)
__device__ __forceinline__ float ftz(float r) {
  float out;
  asm("mul.rn.ftz.f32 %0, %1, 0f3F800000;" : "=f"(out) : "f"(r));
  return out;
}

__device__ __forceinline__ float fma_ftz(float a, float b, float c) {
  return ftz(fmaf(a, b, c));
}

// The three scalar functions below take one float32 and are proven equal
// to their plain versions (arith.expf, tanhf, sigmoidf) in bits over all
// 2^32 inputs on the card (chip_smoke.py: scalar_exhaustive).  Their
// multiply-adds are plain fmaf: none of their results can be subnormal
// where it matters (Cephes' reduced argument, the Horner sums near their
// constants), so the flush of fma_ftz would never fire.

// Cephes expf: range reduction by ln2 in two parts, degree-7 polynomial,
// results below the smallest normal float flushed to zero.  n = floor(x *
// log2e + 0.5) as an int (a NaN converts to 0, and x's clamp keeps n >=
// -127, so only the top needs a clamp).
__device__ __forceinline__ float cephes_expf(float x) {
  x = (x < -0x1.5f3334p+6f) ? -0x1.5f3334p+6f : x;
  x = (x > 0x1.633334p+6f) ? 0x1.633334p+6f : x;
  const int ni = min(__float2int_rd(fmaf(x, 0x1.715476p+0f, 0.5f)), 127);
  const float n = (float)ni;
  float r = fmaf(-0x1.63p-1f, n, x);
  r = fmaf(0x1.bd0106p-13f, n, r);
  float p = fmaf(r, 0x1.a0d2cep-13f, 0x1.6e879cp-10f);
  p = fmaf(p, r, 0x1.111210p-7f);
  p = fmaf(p, r, 0x1.555382p-5f);
  p = fmaf(p, r, 0x1.555554p-3f);
  p = fmaf(p, r, 0.5f);
  const float y = 1.0f + fmaf(p, r * r, r);
  const float out = y * __int_as_float((ni + 127) << 23);
  return out < 1.17549435e-38f ? 0.0f : out;
}

// tanh as the reference's CPU backend expands it: x * P(x^2) / Q(x^2) on x
// clamped to +-7.99881172, every Horner step one multiply-add, and x
// itself where |x| < 0.0004 or x is NaN (arith.tanhf)
__device__ __forceinline__ float xla_tanhf(float x) {
  const float y =
      fminf(fmaxf(x, -7.99881172180175781f), 7.99881172180175781f);
  const float y2 = y * y;
  float p = fmaf(y2, -2.76076847742355e-16f, 2.00018790482477e-13f);
  p = fmaf(y2, p, -8.60467152213735e-11f);
  p = fmaf(y2, p, 5.12229709037114e-08f);
  p = fmaf(y2, p, 1.48572235717979e-05f);
  p = fmaf(y2, p, 6.37261928875436e-04f);
  p = fmaf(y2, p, 4.89352455891786e-03f);
  float q = fmaf(y2, 1.19825839466702e-06f, 1.18534705686654e-04f);
  q = fmaf(y2, q, 2.26843463243900e-03f);
  q = fmaf(y2, q, 4.89352518554385e-03f);
  return !(fabsf(x) >= 0.0004f) ? x : y * p / q;
}

// the logistic as 1 / (1 + exp(-x)), subnormal results flushed
// (arith.sigmoidf); the quotient is never negative
__device__ __forceinline__ float xla_sigmoidf(float x) {
  const float r = 1.0f / (1.0f + cephes_expf(-x));
  return r < 1.17549435e-38f ? 0.0f : r;
}

struct Sig {
  float ecn, rtt, util, t, dt, line, base_rtt, loss;
};

// Policy ids: cc.KERNEL_POLICY_ID.  State and param slots are the sorted
// key orders of cc.kernel_state_keys / cc.kernel_param_keys; ops.py checks
// them against the Python tables before the first launch.
enum { PFC = 0, DCQCN = 1, DCTCP = 2, TIMELY = 3, HPCC = 4, HPCC_PINT = 5,
       STATIC_WINDOW = 6, MLP = 7 };

// The signals each policy's update reads, so that the fused kernel loads
// only the rows they need (as a compiler drops dead loads): USE_ECN the
// marking product (q, ecn_mask, kmin, kmax, pmax), USE_RTT the queueing RTT
// (q, caps, hopmask, base_rtt), USE_UTIL the INT utilisation (q, tx, caps,
// hopmask), USE_BASE base_rtt alone, USE_LOSS the loss signal, USE_STATE
// the state rows.  Every policy reads line.  Kept in step with the
// policy_update bodies below: a signal left out reads as 0, which the
// bit-equality checks of every policy would show.
enum : unsigned { USE_ECN = 1, USE_RTT = 2, USE_UTIL = 4, USE_BASE = 8,
                  USE_LOSS = 16, USE_STATE = 32 };

__host__ __device__ constexpr unsigned policy_signals(int pol) {
  return pol == PFC             ? 0u
         : pol == DCQCN         ? USE_ECN | USE_LOSS | USE_STATE
         : pol == DCTCP         ? USE_ECN | USE_RTT | USE_LOSS | USE_STATE
         : pol == TIMELY        ? USE_RTT | USE_BASE | USE_LOSS | USE_STATE
         : pol == HPCC || pol == HPCC_PINT
             ? USE_UTIL | USE_BASE | USE_LOSS | USE_STATE
         : pol == STATIC_WINDOW ? USE_STATE
                                : USE_ECN | USE_RTT | USE_UTIL | USE_BASE |
                                      USE_LOSS | USE_STATE;
}

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

// mlp (repro_torch/learn/net.py)  state: bdp fanin rate win
//   params (40): b1_0..b1_3 b2_0 b2_1 loss_cut out_gain w1_00..w1_35
//   w2_00..w2_13.  Six features -> 4 tanh units -> rate and window
//   targets, tracked at dt / RTT; a loss-scaled cut where loss > 0.
template <>
__device__ __forceinline__ void policy_update<MLP>(
    const float* __restrict__ p, float* s, const Sig& sig, float& rate,
    float& win) {
  const float* b1 = p;
  const float b2_0 = p[4], b2_1 = p[5], loss_cut = p[6], out_gain = p[7];
  const float* w1 = p + 8;       // w1_{j}{i} at w1[6 * j + i]
  const float* w2 = p + 32;      // w2_{o}{j} at w2[4 * o + j]
  const float bdp0 = s[0], fanin0 = s[1], rate0 = s[2], win0 = s[3];
  const float line = vmax(sig.line, 1.0f);
  const float base = vmax(sig.base_rtt, 1e-7f);
  const float bdp = vmax(bdp0, 1.0f);
  const float qdel = vmax(sig.rtt - sig.base_rtt, 0.0f);
  const float qd = qdel / base;
  const float u = vmax(sig.util, 0.0f);
  const float fan = vmax(fanin0, 1.0f);
  const float x[6] = {sig.ecn,
                      qdel / (base * (1.0f + qd)),
                      u / (1.0f + u),
                      rate0 / line,
                      win0 / fma_ftz(4.0f, bdp, win0),
                      1.0f / fan};
  // dot products: the first product fused into the second, every later
  // one into the running sum
  float h[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float* w = w1 + 6 * j;
    float acc = fma_ftz(w[0], x[0], w[1] * x[1]);
#pragma unroll
    for (int i = 2; i < 6; ++i) acc = fma_ftz(w[i], x[i], acc);
    h[j] = xla_tanhf(acc + b1[j]);
  }
  float sr = fma_ftz(w2[0], h[0], w2[1] * h[1]);
  float sw = fma_ftz(w2[4], h[0], w2[5] * h[1]);
#pragma unroll
  for (int j = 2; j < 4; ++j) {
    sr = fma_ftz(w2[j], h[j], sr);
    sw = fma_ftz(w2[4 + j], h[j], sw);
  }
  sr = sr + b2_0;
  sw = sw + b2_1;
  const float win_prior = vmax(2.0f * bdp / fan + 0.5e6f / fan, 4000.0f);
  const float a = vclip((out_gain * sig.dt) / vmax(base, sig.dt), 0.0f,
                        1.0f);
  float r = fma_ftz(a, fma_ftz(line, xla_sigmoidf(sr + 4.0f), -rate0), rate0);
  r = vmin(vmax(r, 1e-3f * line), line);
  float w = fma_ftz(
      a, fma_ftz(win_prior, cephes_expf(2.5f * xla_tanhf(sw)), -win0), win0);
  w = vmin(vmax(w, 1000.0f), 32.0f * bdp);
  if (sig.loss > 0.f) {
    const float cut =
        fma_ftz(-0.5f, vmin((2.0f * loss_cut) * sig.loss, 1.0f), 1.0f);
    r = vmax(r * cut, 1e-3f * line);
    w = vmax(w * cut, 1000.0f);
  }
  s[0] = bdp0; s[1] = fanin0; s[2] = r; s[3] = w;
  rate = r;
  win = w;
}

}  // namespace
