// Engine-step kernels of the fluid RoCE simulator, hand-written for Hopper
// (sm_90a).  Built by repro_torch/kernels/build.py with nvcc into a shared
// library with a plain C interface and loaded with ctypes; the wrappers in
// repro_torch/kernels/engine_step/ops.py check shapes and types, allocate
// the outputs, compute the launch plan and launch on PyTorch's current
// stream.
//
// fused_signals_policy   replaces the Pallas kernel
//     repro/kernels/engine_step/engine_step.py::fused_signals_policy_tiled
//     (body _signals_policy_kernel): engine stages 1+2.  Inputs are
//     hop-major (B, H, F) and flat (B, F) float32; state is (B, K, F) in
//     cc.kernel_state_keys order, params a (B, P) row per lane in
//     cc.kernel_param_keys order.  The policy's update is a device
//     function picked by a template on its id (cc.KERNEL_POLICY_ID),
//     defined in ../../csrc/cc_policy.cuh.
//     Bound: device-memory bytes, 4 per row read and written per flow:
//     the input rows the policy reads (all 39 for mlp, 22 of the 35 and
//     the 8 state rows for DCQCN) and K + 2 written: 7.04 us for mlp and
//     6.26 us for DCQCN at the 128-GPU path's 131,072 flows on an H100.
//     What held the one-thread-per-flow version back was not the bytes:
//     each thread's ~40 loads were interleaved with its arithmetic, a few
//     dependent round trips to memory per warp, and mlp's arithmetic (five
//     tanh, a logistic, an exp, 31 IEEE divisions a flow) came on top.
//     The design:
//     - persistent: ops.fused_plan launches the blocks the card keeps
//       resident (fused_signals_policy_resident), each
//       walking the work items blockIdx.x, + gridDim.x, ... of the
//       B * ceil(F / TILE) tiles, lane-major; a tile is TILE flows of one
//       lane, one thread a flow, the lane's last tile masked;
//     - a tile's rows, contiguous float32 slices, reach shared memory by
//       cp.async issued by the whole block before any arithmetic, 16
//       bytes a lane where every row is 16-byte aligned (F % 4 == 0 and
//       aligned bases: the wrapper's `vec`), else 4 bytes, and complete
//       on an mbarrier; the arithmetic reads shared memory, and the SM's
//       other blocks keep the memory busy meanwhile (1D bulk copies, TMA,
//       issued by one thread were slower: PERF.md);
//     - only the rows of the signals the policy reads are copied
//       (policy_signals), as the compiler dropped the others' loads
//       before;
//     - the lane's params row is copied into shared memory with the tile
//       (P threads), not read by every thread from global memory;
//     - outputs go straight from registers to global memory: only
//       state', rate and win (the engine discards ecn, rtt and util).
//
// segment_reduce         replaces engine_step.py::segment_reduce_tiled
//     (_seg_kernel): out[b, s] = the sum of segment s's members of lane b,
//     where a member index outside [0, n_in) reads 0 (the plan's "+0"
//     slot is n_in).  It takes both plan kinds of engine._reduce_plan in
//     one launch: "gather" (a padded row of C <= 64 members a segment, the
//     only kind the Pallas kernel took) and the split row "gather2" (a
//     segment of any length as 64-wide blocks of perm, whose block sums
//     are then added over a second level C2 wide), which the TPU's
//     128-lane rows forced into two gathers and two sums.  A gather plan
//     runs one warp a segment (segment_gather_kernel); a split row runs
//     CTAs of consecutive segments packed to about 2,048 members each on
//     the host (ops.split_ctas), which gather their members into shared
//     memory with coalesced index loads, add each block in one thread,
//     then each segment's block partials (segment_split_kernel).  No
//     atomics: every sum adds in the reference's order (arith.row_sum),
//     so it is the reference's to the bit.
//     Bound: bytes (the member indices and the gathered values, 3.9 MB at
//     the 128-GPU step's qlink plan, 1.2 us at 3.35 TB/s); the launch
//     itself (about 1.4 us) dominates the gather plans.  The split rows'
//     values are scattered (a link's members are flows far apart), so
//     about one 32-byte sector moves through the L2 per 4-byte member:
//     that, not the byte bound, sets their time (PERF.md).  Measured and
//     dropped (scripts/time_segment.py): one thread a block gathering its
//     own 64 members (1.8x slower on the gather plans, each load a cache
//     line of its own), one CTA of 256 threads a segment (1.5-3x slower
//     at 9 lanes: mostly idle threads in 5,000 CTAs).
//
// segment_reduce_pfc     replaces engine_step.py::segment_reduce_pfc_tiled
//     (_seg_pfc_kernel): the same per-ingress-port sum, then the PFC
//     hysteresis paused' = (q > xoff & can) ? 1 : (q < xon) ? 0 : prev.
//
// scalar_fn              not a kernel of the simulator: the policies'
//     scalar device functions (cephes_expf, xla_tanhf, xla_sigmoidf, and
//     ftz, the flush of every two-input multiply-add) elementwise, so that
//     a check can hold each against its plain version over every float32
//     input (chip_smoke.py: scalar_exhaustive).
//
// Arithmetic follows the reference bit for bit, as the op path does
// (repro_torch/core/arith.py): build without --use_fast_math and with
// --fmad=false, so that nothing is contracted implicitly; the multiply-adds
// that the reference's CPU backend contracts are explicit fmaf calls with
// the result's subnormals flushed (fma_ftz); exp is Cephes' expf
// (cephes_expf); the segment sums add in the reference's order
// (first_level_sum, lanes_sum).  DCQCN's p_cnp > ecn_thresh and TIMELY's
// rtt bands are thresholds that results hinge on, and the simulator
// amplifies an ulp into a different cut or pause step.

#include <cuda_runtime.h>
#include <stdint.h>

#include <utility>

#include "../../csrc/cc_policy.cuh"

namespace {

constexpr int MAXHOP = 4;
constexpr int MAXK = 8;          // largest policy state (DCQCN)
constexpr int MAXP = 40;         // largest policy param row (mlp)
constexpr int TILE = 128;        // flows per work item = threads per block
constexpr int WARPS = TILE / 32;
static_assert(TILE == 32 * 4, "a warp copies a tile row, 16 bytes a lane");
// tiles in shared memory per block.  One: a block copies a tile, computes
// it and copies its next, and the SM's other resident blocks (as many as
// registers and shared memory allow, 7-8 under mlp and DCQCN) keep the
// memory busy meanwhile; two cut the blocks an SM holds and were slower
// under both policies (PERF.md)
constexpr int STAGES = 1;
constexpr int N_HOP_IN = 8;       // hop-major inputs, MAXHOP rows each
constexpr int N_IN = N_HOP_IN + 3;   // then base_rtt, line, loss

struct FusedArgs {
  const float* in[N_IN];  // q_d tx_d caps ecn_mask hopmask kmin kmax pmax
                          // base_rtt line loss
  const float* state;
  const float* params;
  float* state_out;
  float* rate_out;
  float* win_out;
  float t, t_base_util, dt;
  int F, K, P, tiles_per_lane, items, vec;
};

// The signals (cc_policy.cuh: USE_*) input i feeds; line feeds every
// policy.  A policy's tile holds only the rows of the inputs that feed a
// signal it reads: hop inputs first, MAXHOP rows each, then the flat ones,
// then the state rows.
constexpr unsigned ANY_POLICY = 1u << 31;

__host__ __device__ constexpr unsigned input_feeds(int i) {
  return i == 0   ? USE_ECN | USE_RTT | USE_UTIL   // q_d
         : i == 1 ? USE_UTIL                       // tx_d
         : i == 2 ? USE_RTT | USE_UTIL             // caps
         : i == 3 ? USE_ECN                        // ecn_mask
         : i == 4 ? USE_RTT | USE_UTIL             // hopmask
         : i <= 7 ? USE_ECN                        // kmin, kmax, pmax
         : i == 8 ? USE_RTT | USE_BASE             // base_rtt
         : i == 9 ? ANY_POLICY                     // line
                  : USE_LOSS;                      // loss
}

template <int POL>
__host__ __device__ constexpr bool loads(int i) {
  return (input_feeds(i) & (policy_signals(POL) | ANY_POLICY)) != 0;
}

// first tile row of input i
template <int POL>
__host__ __device__ constexpr int row_of(int i) {
  int r = 0;
  for (int j = 0; j < i; ++j)
    if (loads<POL>(j)) r += j < N_HOP_IN ? MAXHOP : 1;
  return r;
}

template <int POL>
__host__ __device__ constexpr int state_rows(int K) {
  return (policy_signals(POL) & USE_STATE) ? K : 0;
}

template <int POL>
__host__ __device__ constexpr int tile_rows(int K) {
  return row_of<POL>(N_IN) + state_rows<POL>(K);
}

template <int POL>
__host__ __device__ constexpr size_t ring_bytes(int K) {
  return (size_t)STAGES * tile_rows<POL>(K) * TILE * sizeof(float);
}

// input I of policy POL as compile-time constants: whether it is loaded,
// its first tile row, its rows (MAXHOP for a hop-major input)
template <int POL, int I>
struct In {
  static constexpr bool used = loads<POL>(I);
  static constexpr int row = row_of<POL>(I);
  static constexpr int rows = I < N_HOP_IN ? MAXHOP : 1;
};

// ---- mbarrier and cp.async primitives (PTX, sm_90) ----------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(
                   smem_addr(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile(
      "{\n\t.reg .b64 st;\n\t"
      "mbarrier.arrive.shared::cta.b64 st, [%0];\n\t}" ::"r"(
          smem_addr(bar)) : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint64_t* bar,
                                              uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n\t.reg .pred p;\n\t"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
      "selp.u32 %0, 1, 0, p;\n\t}"
      : "=r"(done) : "r"(smem_addr(bar)), "r"(parity) : "memory");
  return done != 0;
}

// Wait for the phase of the given parity to complete.  A wait that spins
// for seconds is a fault of the kernel: trap, so the launch fails rather
// than hangs.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  for (uint32_t spins = 0; !mbar_try_wait(bar, parity); ++spins)
    if (spins > (1u << 24)) __trap();
}

// the mbarrier's current phase also waits for this thread's earlier
// cp.async copies (no arrival of its own)
__device__ __forceinline__ void cp_async_track(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.shared::cta.b64 [%0];" ::"r"(
                   smem_addr(bar)) : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(
                   smem_addr(dst)), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(
                   smem_addr(dst)), "l"(src) : "memory");
}

// ---- the fused kernel ----------------------------------------------------

struct Tile {
  int b, f0, n;       // lane, first flow, flows
};

__device__ __forceinline__ Tile item_tile(const FusedArgs& a, int item) {
  Tile w;
  w.b = item / a.tiles_per_lane;
  w.f0 = (item - w.b * a.tiles_per_lane) * TILE;
  w.n = min(TILE, a.F - w.f0);
  return w;
}

// The copies of input I's rows of a tile.  16-byte route: warp r % WARPS
// copies row r, 4 floats a lane.  4-byte route: each thread its own flow.
template <int POL, int I>
__device__ __forceinline__ void copy_input16(const FusedArgs& a,
                                             const Tile& w, float* ring,
                                             int warp, int e) {
  if constexpr (In<POL, I>::used) {
    const float* src =
        a.in[I] + (int64_t)w.b * In<POL, I>::rows * a.F + w.f0 + e;
#pragma unroll
    for (int h = 0; h < In<POL, I>::rows; ++h)
      if ((In<POL, I>::row + h) % WARPS == warp && e < w.n)
        cp_async16(ring + (In<POL, I>::row + h) * TILE + e,
                   src + (int64_t)h * a.F);
  }
}

template <int POL, int I>
__device__ __forceinline__ void copy_input4(const FusedArgs& a,
                                            const Tile& w, float* ring,
                                            int tid) {
  if constexpr (In<POL, I>::used) {
    const float* src =
        a.in[I] + (int64_t)w.b * In<POL, I>::rows * a.F + w.f0 + tid;
#pragma unroll
    for (int h = 0; h < In<POL, I>::rows; ++h)
      cp_async4(ring + (In<POL, I>::row + h) * TILE + tid,
                src + (int64_t)h * a.F);
  }
}

template <int POL, int... I>
__device__ __forceinline__ void copy_inputs16(
    const FusedArgs& a, const Tile& w, float* ring, int warp, int e,
    std::integer_sequence<int, I...>) {
  (copy_input16<POL, I>(a, w, ring, warp, e), ...);
}

template <int POL, int... I>
__device__ __forceinline__ void copy_inputs4(
    const FusedArgs& a, const Tile& w, float* ring, int tid,
    std::integer_sequence<int, I...>) {
  (copy_input4<POL, I>(a, w, ring, tid), ...);
}

// Issue the copies of one work item into a ring stage (the rows of
// row_of, the state rows after them) and of the lane's params into prm.
// Every thread arrives on the stage's mbarrier once, and the phase
// completes when every thread's copies have landed.
template <int POL>
__device__ __forceinline__ void load_item(const FusedArgs& a, const Tile& w,
                                          float* ring, float* prm,
                                          uint64_t* bar) {
  constexpr int S0 = row_of<POL>(N_IN);          // first state row
  constexpr auto inputs = std::make_integer_sequence<int, N_IN>{};
  const int tid = threadIdx.x;
  const int K = state_rows<POL>(a.K);
  const float* state = a.state + (int64_t)w.b * a.K * a.F + w.f0;
  if (tid < a.P) cp_async4(prm + tid, a.params + (int64_t)w.b * a.P + tid);
  if (a.vec) {
    const int warp = tid / 32, e = (tid % 32) * 4;
    copy_inputs16<POL>(a, w, ring, warp, e, inputs);
    for (int k = (warp - S0 % WARPS + WARPS) % WARPS; k < K; k += WARPS)
      if (e < w.n)
        cp_async16(ring + (S0 + k) * TILE + e, state + (int64_t)k * a.F + e);
  } else if (tid < w.n) {
    copy_inputs4<POL>(a, w, ring, tid, inputs);
    for (int k = 0; k < K; ++k)
      cp_async4(ring + (S0 + k) * TILE + tid, state + (int64_t)k * a.F + tid);
  }
  cp_async_track(bar);
  mbar_arrive(bar);
}

// input I at hop h of this thread's flow, from the tile; 0 where the
// policy reads no signal the input feeds
template <int POL, int I>
__device__ __forceinline__ float tile_in(const float* col, int h) {
  if constexpr (In<POL, I>::used)
    return col[(In<POL, I>::row + h) * TILE];
  else
    return 0.0f;
}

// Stages 1+2 for this thread's flow of a tile whose rows are in ring.
template <int POL>
__device__ __forceinline__ void compute_item(const FusedArgs& a,
                                             const Tile& w,
                                             const float* ring,
                                             const float* prm) {
  constexpr int S0 = row_of<POL>(N_IN);          // first state row
  const int tid = threadIdx.x;
  if (tid >= w.n) return;
  const float* col = ring + tid;

  // stage 1: ECN-mark product, queueing RTT, INT utilisation over hops;
  // sums and products run hop by hop, as the op path's reductions do
  float qsum = 0.0f, unmarked = 1.0f, util = 0.0f;
#pragma unroll
  for (int h = 0; h < MAXHOP; ++h) {
    const float q = tile_in<POL, 0>(col, h);
    const float tx = tile_in<POL, 1>(col, h);
    const float cap = tile_in<POL, 2>(col, h);
    const float em = tile_in<POL, 3>(col, h);
    const float hm = tile_in<POL, 4>(col, h);
    const float lo = tile_in<POL, 5>(col, h);
    const float hi = tile_in<POL, 6>(col, h);
    const float pm = tile_in<POL, 7>(col, h);
    float mark = vclip((q - lo) / vmax(hi - lo, 1.0f), 0.0f, 1.0f) * pm;
    mark = mark * em;
    unmarked = unmarked * (1.0f - mark);
    qsum = qsum + q / cap * hm;
    const float util_l = tx / cap + q / (cap * a.t_base_util);
    util = vmax(util, hm != 0.0f ? util_l : 0.0f);
  }
  Sig sig;
  sig.base_rtt = tile_in<POL, 8>(col, 0);
  sig.rtt = sig.base_rtt + qsum;
  sig.ecn = 1.0f - unmarked;
  sig.util = util;
  sig.t = a.t;
  sig.dt = a.dt;
  sig.line = tile_in<POL, 9>(col, 0);
  sig.loss = tile_in<POL, 10>(col, 0);

  // stage 2: the policy's state update
  float s[MAXK];
#pragma unroll
  for (int k = 0; k < MAXK; ++k)
    s[k] = (k < state_rows<POL>(a.K)) ? col[(S0 + k) * TILE] : 0.0f;
  float rate, win;
  policy_update<POL>(prm, s, sig, rate, win);
  const int64_t F = a.F;
  const int64_t f = w.f0 + tid;
#pragma unroll
  for (int k = 0; k < MAXK; ++k)
    if (k < a.K) a.state_out[((int64_t)w.b * a.K + k) * F + f] = s[k];
  a.rate_out[w.b * F + f] = rate;
  a.win_out[w.b * F + f] = win;
}

template <int POL>
__global__ void __launch_bounds__(TILE, 4) fused_signals_policy_kernel(
    const FusedArgs a) {
  extern __shared__ __align__(128) float ring[];  // STAGES x rows x TILE
  __shared__ float prm[STAGES][MAXP];
  __shared__ __align__(8) uint64_t full[STAGES];
  const int stage_floats = tile_rows<POL>(a.K) * TILE;
  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < STAGES; ++s) mbar_init(&full[s], TILE);
  }
  __syncthreads();
#pragma unroll
  for (int s = 0; s < STAGES; ++s) {
    const int item = blockIdx.x + s * gridDim.x;
    if (item < a.items)
      load_item<POL>(a, item_tile(a, item), ring + s * stage_floats, prm[s],
                     &full[s]);
  }
  for (int k = 0;; ++k) {
    const int item = blockIdx.x + k * gridDim.x;
    if (item >= a.items) break;
    const int s = k % STAGES;
    mbar_wait(&full[s], (k / STAGES) & 1);
    compute_item<POL>(a, item_tile(a, item), ring + s * stage_floats,
                      prm[s]);
    __syncthreads();                  // stage s is free again
    const int next = item + STAGES * gridDim.x;
    if (next < a.items)
      load_item<POL>(a, item_tile(a, next), ring + s * stage_floats, prm[s],
                     &full[s]);
  }
}

// ---- the segment sums -----------------------------------------------------

constexpr int MAX_C2 = 4096;     // widest second level (ops.MAX_C2)
constexpr int SPLIT_W = 64;      // members a split-row block (engine._SPLIT_C)
constexpr int SEG_BATCH = 8;     // member loads a thread keeps in flight
// threads of a split-row CTA, for second levels up to 32 blocks and wider;
// a CTA gathers SEG_BATCH members a thread at once, split_chunk blocks
constexpr int SPLIT_THREADS = 256;
constexpr int SPLIT_THREADS_WIDE = 1024;

__host__ __device__ constexpr int split_threads(int C2) {
  return C2 <= 32 ? SPLIT_THREADS : SPLIT_THREADS_WIDE;
}

__host__ __device__ constexpr int split_chunk(int C2) {
  return split_threads(C2) * SEG_BATCH / SPLIT_W;
}

// Row sums in the reference's order (repro_torch.core.arith.row_sum), over
// a power-of-two row of C values v(0) .. v(C - 1).  The first level of a
// plan (a gather row, or a 64-wide block of a split row) sums in the order
// of row_sum(lanes=False): C <= 16 left to right, else as the second
// level.  The second level of a split row, over its block partials padded
// with +0.0 to C2, sums in the order of row_sum(lanes=True):
//   C <= 32   min(C, 8) strided partial sums (partial k adds v(k),
//             v(k + 8), ... left to right), then a halving tree over them,
//             so C = 4 is (v0 + v2) + (v1 + v3);
//   C >= 64   runs of 32 left to right, then the run totals left to right.
template <class V>
__device__ __forceinline__ float run32(const V& v, int r0) {
  float s = v(r0);
#pragma unroll
  for (int k = 1; k < 32; ++k) s = s + v(r0 + k);
  return s;
}

template <class V>
__device__ __forceinline__ float lanes_sum(const V& v, int C) {
  if (C >= 64) {
    float s = run32(v, 0);
    for (int r = 32; r < C; r += 32) s = s + run32(v, r);
    return s;
  }
  const int P = C < 8 ? C : 8;
  float acc[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) acc[k] = k < P ? v(k) : 0.0f;
  for (int j = P; j < C; j += P) {
#pragma unroll
    for (int k = 0; k < 8; ++k)
      if (k < P) acc[k] = acc[k] + v(j + k);
  }
#pragma unroll
  for (int h = 4; h >= 1; h >>= 1) {
#pragma unroll
    for (int k = 0; k < 4; ++k)
      if (k < h && 2 * h <= P) acc[k] = acc[k] + acc[k + h];
  }
  return acc[0];
}

// row_sum(lanes=False) of a first-level row of C values in shared memory
template <int C>
__device__ __forceinline__ float first_level_sum(const float* row) {
  const auto v = [row](int j) { return row[j]; };
  if constexpr (C <= 16) {
    float s = row[0];
#pragma unroll
    for (int k = 1; k < C; ++k) s = s + row[k];
    return s;
  } else {
    return lanes_sum(v, C);
  }
}

struct SegArgs {
  const float* vals;          // vals[b * lane_stride + j * stride]
  int64_t lane_stride, stride;
  const int32_t* idx;         // a block's members, n_in (or any index
                              // outside [0, n_in)) = "+0"
  const int32_t* boff;        // split row: segment s = blocks boff[s] ..
                              // boff[s + 1] - 1; null: a gather plan
  const int32_t* ctas;        // split row: CTA i takes segments ctas[i] ..
                              // ctas[i + 1] - 1
  int n_in, n_out, C2;
  float* out;
  const float* xoff;          // the PFC variant's per-segment inputs
  const float* xon;
  const uint8_t* can;
  const uint8_t* prev;
  uint8_t* paused;
};

template <bool PFC_OUT>
__device__ __forceinline__ void write_sum(const SegArgs& a, int seg,
                                          float q) {
  const int64_t o = (int64_t)blockIdx.y * a.n_out + seg;
  a.out[o] = q;
  if (PFC_OUT) {
    const bool over = (q > a.xoff[o]) && (a.can[o] != 0);
    const bool under = q < a.xon[o];
    a.paused[o] = over ? 1 : (under ? 0 : (a.prev[o] != 0 ? 1 : 0));
  }
}

// A gather plan, lane blockIdx.y: one warp a segment, 8 a CTA.  The lanes
// gather the segment's W <= 64 members into shared memory, then lane 0
// adds them in the first level's order; the launch's fixed cost sets the
// time on the plans the main path runs.
template <int W, bool PFC_OUT>
__global__ void __launch_bounds__(256) segment_gather_kernel(
    const SegArgs a) {
  __shared__ float row[8][W];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int seg = blockIdx.x * 8 + warp;
  if (seg >= a.n_out) return;             // uniform across the warp
  const float* v = a.vals + (int64_t)blockIdx.y * a.lane_stride;
  const int32_t* ids = a.idx + (int64_t)seg * W;
#pragma unroll
  for (int c = lane; c < W; c += 32) {
    const int j = __ldg(ids + c);
    row[warp][c] = (unsigned)j < (unsigned)a.n_in
                       ? __ldg(v + (int64_t)j * a.stride)
                       : 0.0f;
  }
  __syncwarp();
  if (lane == 0) write_sum<PFC_OUT>(a, seg, first_level_sum<W>(row[warp]));
}

// Gather split-row members [e0, e0 + n) into rows of SPLIT_W + 1 floats
// (odd, so that thread k reading row k hits bank k + j: no conflicts):
// coalesced index loads by the whole CTA, SEG_BATCH in flight a thread,
// then the values they name (+0.0 for a padding slot).
template <int T>
__device__ __forceinline__ void load_rows(const SegArgs& a, const float* v,
                                          int64_t e0, int n, float* rows) {
  for (int base = threadIdx.x; base < n; base += SEG_BATCH * T) {
    int j[SEG_BATCH];
    float x[SEG_BATCH];
#pragma unroll
    for (int u = 0; u < SEG_BATCH; ++u) {
      const int e = base + u * T;
      j[u] = e < n ? __ldg(a.idx + e0 + e) : -1;
    }
#pragma unroll
    for (int u = 0; u < SEG_BATCH; ++u)
      x[u] = (unsigned)j[u] < (unsigned)a.n_in
                 ? __ldg(v + (int64_t)j[u] * a.stride)
                 : 0.0f;
#pragma unroll
    for (int u = 0; u < SEG_BATCH; ++u) {
      const int e = base + u * T;
      if (e < n) rows[(e / SPLIT_W) * (SPLIT_W + 1) + e % SPLIT_W] = x[u];
    }
  }
}

// A split-row plan, lane blockIdx.y.  CTA i takes the consecutive
// segments ctas[i] .. ctas[i + 1] - 1 (ops.split_ctas: together at most
// split_chunk(C2) blocks, or one wider segment alone), whose blocks are
// contiguous in perm.  It gathers their members into shared memory,
// split_chunk blocks at a time (load_rows); thread k adds block k's row in
// the first level's order into the block partials; then each segment's
// partials, padded with +0.0 to C2, are added in the second level's
// order: by one thread a segment, or for a CTA of one segment with C2 >=
// 64 by thread r for run r of 32 and thread 0 for the run totals.  Every
// member and padding zero is added in the plain version's order, so the
// sum is its sum to the bit (backlogs, frames and finish flags are >= 0,
// so no -0.0 arises anyway).  A segment of more than C2 blocks, or a CTA
// of more blocks than it holds, is a fault of the plan: its sums are NaN.
template <int T, bool PFC_OUT>
__global__ void __launch_bounds__(T) segment_split_kernel(const SegArgs a) {
  extern __shared__ float rows[];
  constexpr int CH = T * SEG_BATCH / SPLIT_W;
  const int t = threadIdx.x;
  const float* v = a.vals + (int64_t)blockIdx.y * a.lane_stride;
  const int s0 = a.ctas[blockIdx.x], s1 = a.ctas[blockIdx.x + 1];
  const int b0 = a.boff[s0];
  const int nblk = a.boff[s1] - b0;
  const int held = CH > a.C2 ? CH : a.C2;       // partials' slots
  float* part = rows + CH * (SPLIT_W + 1);
  if (nblk < 0 || nblk > (s1 - s0 == 1 ? a.C2 : CH)) {
    for (int s = s0 + t; s < s1; s += T)
      write_sum<PFC_OUT>(a, s, __int_as_float(0x7fc00000));
    return;
  }
  for (int c0 = 0; c0 < nblk; c0 += CH) {
    const int nb = min(CH, nblk - c0);
    load_rows<T>(a, v, (int64_t)(b0 + c0) * SPLIT_W, nb * SPLIT_W, rows);
    __syncthreads();
    for (int k = t; k < nb; k += T)
      part[c0 + k] = first_level_sum<SPLIT_W>(rows + k * (SPLIT_W + 1));
    __syncthreads();
  }
  if (s1 - s0 == 1 && a.C2 >= 64) {
    float* runs = part + held;
    for (int k = nblk + t; k < a.C2; k += T) part[k] = 0.0f;
    __syncthreads();
    for (int r = t; r < a.C2 / 32; r += T)
      runs[r] = run32([part](int j) { return part[j]; }, 32 * r);
    __syncthreads();
    if (t == 0) {
      float q = runs[0];
      for (int r = 1; r < a.C2 / 32; ++r) q = q + runs[r];
      write_sum<PFC_OUT>(a, s0, q);
    }
    return;
  }
  for (int s = s0 + t; s < s1; s += T) {
    const int off = a.boff[s] - b0, nb = a.boff[s + 1] - a.boff[s];
    const float* p = part + off;
    const float q = lanes_sum(
        [p, nb](int j) { return j < nb ? p[j] : 0.0f; }, a.C2);
    write_sum<PFC_OUT>(a, s, nb > a.C2 ? __int_as_float(0x7fc00000) : q);
  }
}

// shared memory of a split-row launch: CH rows, the partials, the runs
__host__ __device__ constexpr size_t split_smem(int C2) {
  return sizeof(float) *
         ((size_t)split_chunk(C2) * (SPLIT_W + 1) +
          (split_chunk(C2) > C2 ? split_chunk(C2) : C2) + C2 / 32);
}

template <int T, bool PFC_OUT>
cudaError_t launch_split(const SegArgs& a, int B, int n_cta,
                         cudaStream_t stream) {
  // above 48 KB of shared memory needs the attribute, set once to the
  // most a plan of this CTA size takes
  static const cudaError_t prep = cudaFuncSetAttribute(
      segment_split_kernel<T, PFC_OUT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)split_smem(T == SPLIT_THREADS ? 32 : MAX_C2));
  if (prep != cudaSuccess) return prep;
  segment_split_kernel<T, PFC_OUT>
      <<<dim3(n_cta, B), T, split_smem(a.C2), stream>>>(a);
  return cudaGetLastError();
}

template <bool PFC_OUT>
cudaError_t launch_segment(const SegArgs& a, int B, int C, int n_cta,
                           cudaStream_t stream) {
  if (a.boff != nullptr)
    return split_threads(a.C2) == SPLIT_THREADS
               ? launch_split<SPLIT_THREADS, PFC_OUT>(a, B, n_cta, stream)
               : launch_split<SPLIT_THREADS_WIDE, PFC_OUT>(a, B, n_cta,
                                                           stream);
  const dim3 grid((a.n_out + 7) / 8, B);
#define SEG_CASE(W)                                                    \
  case W:                                                              \
    segment_gather_kernel<W, PFC_OUT><<<grid, 256, 0, stream>>>(a);    \
    break;
  switch (C) {
    SEG_CASE(1) SEG_CASE(2) SEG_CASE(4) SEG_CASE(8) SEG_CASE(16) SEG_CASE(32)
    SEG_CASE(64)
    default:
      return cudaErrorInvalidValue;
  }
#undef SEG_CASE
  return cudaGetLastError();
}

bool segment_args_ok(const SegArgs& a, int B, int C, int n_cta) {
  const bool split = a.boff != nullptr;
  const bool widths =
      split ? C == SPLIT_W && a.C2 >= 1 && a.C2 <= MAX_C2 &&
                  !(a.C2 & (a.C2 - 1)) && a.ctas != nullptr && n_cta >= 1
            : C >= 1 && C <= 64 && !(C & (C - 1)) && a.C2 == 1;
  return widths && a.n_out >= 1 && a.n_in >= 0 && B >= 1 && B <= 65535 &&
         a.stride >= 1 && a.lane_stride >= 0;
}

// The shared memory above 48 KB needs the attribute, set once per
// template; the carve-out asks for the most shared memory per SM.
template <int POL>
cudaError_t prepare_fused() {
  static cudaError_t err = [] {
    const cudaError_t e = cudaFuncSetAttribute(
        fused_signals_policy_kernel<POL>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)ring_bytes<POL>(MAXK));
    if (e != cudaSuccess) return e;
    return cudaFuncSetAttribute(fused_signals_policy_kernel<POL>,
                                cudaFuncAttributePreferredSharedMemoryCarveout,
                                (int)cudaSharedmemCarveoutMaxShared);
  }();
  return err;
}

template <int POL>
cudaError_t resident_fused(int K, int* blocks) {
  cudaError_t err = prepare_fused<POL>();
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess)
    return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, fused_signals_policy_kernel<POL>, TILE, ring_bytes<POL>(K));
  *blocks = sms * per_sm;
  return err;
}

template <int POL>
cudaError_t launch_fused(const FusedArgs& a, int blocks,
                         cudaStream_t stream) {
  const cudaError_t err = prepare_fused<POL>();
  if (err != cudaSuccess) return err;
  fused_signals_policy_kernel<POL>
      <<<blocks, TILE, ring_bytes<POL>(a.K), stream>>>(a);
  return cudaGetLastError();
}

// One thread per element, grid-stride.
__global__ void scalar_fn_kernel(int which, const float* __restrict__ x,
                                 float* __restrict__ y, long n) {
  for (long i = blockIdx.x * (long)blockDim.x + threadIdx.x; i < n;
       i += (long)gridDim.x * blockDim.x) {
    const float v = x[i];
    y[i] = which == 0   ? cephes_expf(v)
           : which == 1 ? xla_tanhf(v)
           : which == 2 ? xla_sigmoidf(v)
                        : ftz(v);
  }
}

}  // namespace

#define POLICY_SWITCH(ID, CALL) \
  switch (ID) {                  \
    case PFC: CALL(PFC)          \
    case DCQCN: CALL(DCQCN)      \
    case DCTCP: CALL(DCTCP)      \
    case TIMELY: CALL(TIMELY)    \
    case HPCC: CALL(HPCC)        \
    case HPCC_PINT: CALL(HPCC_PINT) \
    case STATIC_WINDOW: CALL(STATIC_WINDOW) \
    case MLP: CALL(MLP)          \
    default:                     \
      return (int)cudaErrorInvalidValue; \
  }

extern "C" {

// The blocks of the fused kernel for policy_id and K state rows that the
// current card keeps resident at once (SMs x blocks per SM), into
// *blocks.  Returns a cudaError_t.
int fused_signals_policy_resident(int policy_id, int K, int* blocks) {
  if (K < 1 || K > MAXK) return (int)cudaErrorInvalidValue;
#define RESIDENT(ID) return (int)resident_fused<ID>(K, blocks);
  POLICY_SWITCH(policy_id, RESIDENT)
#undef RESIDENT
}

// The float32 rows a launch for policy_id with K state rows reads per
// flow: the inputs its update reads (policy_signals) and its state; -1
// for an unknown policy or K.
int fused_signals_policy_rows(int policy_id, int K) {
  if (K < 1 || K > MAXK) return -1;
#define ROWS(ID) return tile_rows<ID>(K);
  switch (policy_id) {
    case PFC: ROWS(PFC)
    case DCQCN: ROWS(DCQCN)
    case DCTCP: ROWS(DCTCP)
    case TIMELY: ROWS(TIMELY)
    case HPCC: ROWS(HPCC)
    case HPCC_PINT: ROWS(HPCC_PINT)
    case STATIC_WINDOW: ROWS(STATIC_WINDOW)
    case MLP: ROWS(MLP)
    default: return -1;
  }
#undef ROWS
}

// Returns a cudaError_t: 0 when the launch was accepted.  The 8 hop-major
// (B, 4, F) inputs q_d, tx_d, caps, ecn_mask, hopmask, kmin, kmax, pmax
// (pmax with any ECN scale folded in) and the 3 (B, F) inputs base_rtt,
// line, loss; t is the step's time and dt its size.  The launch plan
// (ops.fused_plan): `blocks` persistent blocks over B * tiles_per_lane
// work items, tiles_per_lane = ceil(F / TILE); vec != 0 copies the tile
// rows 16 bytes at a time, which needs F % 4 == 0 and 16-byte aligned
// inputs and state.
int fused_signals_policy(int policy_id, const float* q_d, const float* tx_d,
                         const float* caps, const float* ecn_mask,
                         const float* hopmask, const float* kmin,
                         const float* kmax, const float* pmax,
                         const float* base_rtt, const float* line,
                         const float* loss, const float* state,
                         const float* params, float t, float t_base_util,
                         float dt, int B, int F, int K, int P,
                         float* state_out, float* rate_out, float* win_out,
                         int blocks, int tiles_per_lane, int vec,
                         void* stream) {
  FusedArgs a = {{q_d, tx_d, caps, ecn_mask, hopmask, kmin, kmax, pmax,
                  base_rtt, line, loss},
                 state, params, state_out, rate_out, win_out, t,
                 t_base_util, dt, F, K, P, tiles_per_lane, 0, vec != 0};
  const int64_t items = (int64_t)B * tiles_per_lane;
  if (K < 1 || K > MAXK || P < 1 || P > MAXP || F < 1 || B < 1 ||
      tiles_per_lane != (F + TILE - 1) / TILE || items > 0x7fffffff ||
      blocks < 1)
    return (int)cudaErrorInvalidValue;
  a.items = (int)items;
  if (a.vec) {
    bool aligned = F % 4 == 0 && (uintptr_t)state % 16 == 0;
    for (const float* p : a.in) aligned = aligned && (uintptr_t)p % 16 == 0;
    if (!aligned) return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = (cudaStream_t)stream;
#define LAUNCH(ID) return (int)launch_fused<ID>(a, blocks, s);
  POLICY_SWITCH(policy_id, LAUNCH)
#undef LAUNCH
}

// y[i] = f(x[i]) for i < n, f the scalar device function `which`
// (ops.SCALAR_FNS: 0 cephes_expf, 1 xla_tanhf, 2 xla_sigmoidf, 3 ftz).
int scalar_fn(int which, const float* x, float* y, long n, void* stream) {
  if (which < 0 || which > 3 || n < 1) return (int)cudaErrorInvalidValue;
  scalar_fn_kernel<<<132 * 16, 256, 0, (cudaStream_t)stream>>>(which, x, y,
                                                                n);
  return (int)cudaGetLastError();
}

// The segment sums of a reduction plan for B lanes: out[b, s] = the sum of
// segment s's members of lane b (vals[b * lane_stride + j * stride] for
// member j), in the reference's order.  boff null: a "gather" plan, idx
// the (n_out, C) member matrix, C2 = 1.  Else a split-row plan: idx is
// perm, blocks of C = 64 members, segment s is blocks boff[s] ..
// boff[s + 1] - 1 (at most C2 of them, a power of two <= MAX_C2), and
// CTA i of the n_cta takes segments ctas[i] .. ctas[i + 1] - 1
// (ops.split_ctas).  Returns a cudaError_t: 0 when the launch was
// accepted.
int segment_reduce(const float* vals, int64_t lane_stride, int64_t stride,
                   const int32_t* idx, const int32_t* boff,
                   const int32_t* ctas, int n_cta, int B, int n_in,
                   int n_out, int C, int C2, float* out, void* stream) {
  const SegArgs a = {vals, lane_stride, stride,  idx,     boff,
                     ctas, n_in,        n_out,   C2,      out,
                     nullptr, nullptr,  nullptr, nullptr, nullptr};
  if (!segment_args_ok(a, B, C, n_cta)) return (int)cudaErrorInvalidValue;
  return (int)launch_segment<false>(a, B, C, n_cta, (cudaStream_t)stream);
}

// The same sums, then the PFC hysteresis per segment:
// paused' = (q > xoff & can) ? 1 : (q < xon) ? 0 : prev, all (B, n_out).
int segment_reduce_pfc(const float* vals, int64_t lane_stride,
                       int64_t stride, const int32_t* idx,
                       const int32_t* boff, const int32_t* ctas, int n_cta,
                       int B, int n_in, int n_out, int C, int C2,
                       const float* xoff, const float* xon,
                       const uint8_t* can, const uint8_t* prev, float* q_out,
                       uint8_t* paused_out, void* stream) {
  const SegArgs a = {vals, lane_stride, stride, idx,  boff,
                     ctas, n_in,        n_out,  C2,   q_out,
                     xoff, xon,         can,    prev, paused_out};
  if (!segment_args_ok(a, B, C, n_cta)) return (int)cudaErrorInvalidValue;
  return (int)launch_segment<true>(a, B, C, n_cta, (cudaStream_t)stream);
}

// The blocks a split-row CTA gathers at once for second-level width C2
// (ops.split_ctas packs segments into CTAs by it); -1 for a C2 the kernels
// do not take.
int segment_split_chunk(int C2) {
  if (C2 < 1 || C2 > MAX_C2 || (C2 & (C2 - 1))) return -1;
  return split_chunk(C2);
}

}  // extern "C"
