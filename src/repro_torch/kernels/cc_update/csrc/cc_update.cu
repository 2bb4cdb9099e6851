// DCQCN per-flow state update, hand-written for Hopper (sm_90a).  Built by
// repro_torch/kernels/build.py with nvcc into a shared library with a
// plain C interface and loaded with ctypes; the wrapper in
// repro_torch/kernels/cc_update/ops.py checks shapes and types, allocates
// the outputs and launches on PyTorch's current stream.
//
// dcqcn_update   replaces the Pallas kernel
//     repro/kernels/cc_update/cc_update.py::dcqcn_update_tiled (body
//     _kernel): eight state arrays plus the ECN signal and the line rate
//     in, seven updated state arrays out (jit passes through).  One thread
//     per flow over flat (F,) float32 arrays, 256 threads a block, the last
//     block masked: every flow is computed for every F (the Pallas grid of
//     N8 // min(8, N8) tiles of (8, 128) never computes the tail tiles
//     when ceil(F / 128) is above 8 and not a multiple of 8).  The time t
//     and the nine parameters are passed by value.
//
//     What it computes is the policy's update, bit for bit: the device
//     function policy_update<DCQCN> of ../../csrc/cc_policy.cuh, which the
//     fused engine-step kernel runs too, with no loss signal.  The Pallas
//     body writes the multiply-adds unfused and differs from the policy in
//     the last bits (rtol 1e-5); the port's kernel, its plain version
//     (cc.make_dcqcn's update) and the fused kernel's DCQCN agree exactly.
//
//     Bound: device-memory bytes, 10 float32 reads and 7 writes a flow (68
//     bytes); about 60 float32 operations a flow, so far below the card's
//     balance point.  The design reads and writes each array once, with
//     neighbouring threads on neighbouring flows (coalesced 128-byte
//     lines), and keeps the update in registers.

#include <cuda_runtime.h>
#include <stdint.h>

#include "../../csrc/cc_policy.cuh"

namespace {

// kernel_param_keys order of make_dcqcn, the slots policy_update<DCQCN>
// reads: cut_gap ecn_thresh fast_rounds g hai_after mss rai_frac
// rhai_frac timer
struct DcqcnParams {
  float p[9];
};

__global__ void __launch_bounds__(256) dcqcn_update_kernel(
    const float* __restrict__ rc, const float* __restrict__ rt,
    const float* __restrict__ alpha, const float* __restrict__ t_cut,
    const float* __restrict__ t_inc, const float* __restrict__ t_alpha,
    const float* __restrict__ inc_count, const float* __restrict__ jit,
    const float* __restrict__ ecn, const float* __restrict__ line, float t,
    DcqcnParams prm, int F, float* __restrict__ o_rc,
    float* __restrict__ o_rt, float* __restrict__ o_alpha,
    float* __restrict__ o_t_cut, float* __restrict__ o_t_inc,
    float* __restrict__ o_t_alpha, float* __restrict__ o_inc_count) {
  const int f = blockIdx.x * blockDim.x + threadIdx.x;
  if (f >= F) return;
  // the device function's state slots (cc.kernel_state_keys order):
  // alpha inc_count jit rc rt t_alpha t_cut t_inc
  float s[8] = {alpha[f], inc_count[f], jit[f], rc[f],
                rt[f],    t_alpha[f],   t_cut[f], t_inc[f]};
  Sig sig;
  sig.ecn = ecn[f];
  sig.line = line[f];
  sig.t = t;
  sig.dt = 0.0f;
  sig.loss = 0.0f;
  sig.rtt = 0.0f;
  sig.util = 0.0f;
  sig.base_rtt = 0.0f;
  float rate, win;
  policy_update<DCQCN>(prm.p, s, sig, rate, win);
  o_alpha[f] = s[0];
  o_inc_count[f] = s[1];
  o_rc[f] = s[3];
  o_rt[f] = s[4];
  o_t_alpha[f] = s[5];
  o_t_cut[f] = s[6];
  o_t_inc[f] = s[7];
}

}  // namespace

extern "C" {

// Returns a cudaError_t: 0 when the launch was accepted.  The eight (F,)
// state inputs come in ops.ORDER (rc rt alpha t_cut t_inc t_alpha
// inc_count jit), then ecn, line, t, the nine parameters in
// kernel_param_keys order, F, and the seven outputs in ops.ORDER[:7].
int dcqcn_update(const float* rc, const float* rt, const float* alpha,
                 const float* t_cut, const float* t_inc, const float* t_alpha,
                 const float* inc_count, const float* jit, const float* ecn,
                 const float* line, float t, float cut_gap, float ecn_thresh,
                 float fast_rounds, float g, float hai_after, float mss,
                 float rai_frac, float rhai_frac, float timer, int F,
                 float* o_rc, float* o_rt, float* o_alpha, float* o_t_cut,
                 float* o_t_inc, float* o_t_alpha, float* o_inc_count,
                 void* stream) {
  if (F < 1) return (int)cudaErrorInvalidValue;
  const DcqcnParams prm = {{cut_gap, ecn_thresh, fast_rounds, g, hai_after,
                            mss, rai_frac, rhai_frac, timer}};
  const dim3 block(256);
  const dim3 grid((F + 255) / 256);
  dcqcn_update_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      rc, rt, alpha, t_cut, t_inc, t_alpha, inc_count, jit, ecn, line, t,
      prm, F, o_rc, o_rt, o_alpha, o_t_cut, o_t_inc, o_t_alpha,
      o_inc_count);
  return (int)cudaGetLastError();
}

}  // extern "C"
