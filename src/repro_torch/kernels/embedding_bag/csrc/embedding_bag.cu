// Embedding-bag sum pooling of the DLRM forward, hand-written for Hopper
// (sm_90a).  Built by repro_torch/kernels/build.py with nvcc into a shared
// library with a plain C interface and loaded with ctypes; the wrappers in
// repro_torch/kernels/embedding_bag/ops.py check shapes and types, allocate
// the output and launch on PyTorch's current stream.
//
// embedding_bag   replaces the Pallas kernel
//     repro/kernels/embedding_bag/embedding_bag.py::embedding_bag_rows
//     (body _kernel) and the padding/cast of its wrapper
//     repro/kernels/embedding_bag/ops.py::embedding_bag_stacked:
//         out[i, :] = sum_{j = 0..P-1} table[(i % T) * R + ids[i, j], :]
//     over bags i < n_bags of a bf16 table of D columns, accumulated in
//     float32 in the order j = 0, 1, ..., P-1 (the order in which the Pallas
//     grid revisits its output block) and written once, as float32 or
//     rounded to bf16 (round to nearest even).  T = 1 and R = rows of the
//     table give embedding_bag_rows; T tables of R rows stacked as (T*R, D)
//     give embedding_bag_stacked, bag i reading table i % T.
//
//     One warp per bag.  The warp reads 32 ids at a time, one per lane,
//     and broadcasts each with a shuffle; the lanes cover the row's columns
//     as bf16 pairs (4-byte loads, so a D = 64 row is one 128-byte read by
//     the warp), or one column each where D is odd or the table is not
//     4-byte aligned.  Rows are loaded eight ahead of their adds, so each
//     warp keeps eight row reads in flight while the adds stay in order.
//
//     Bound: device-memory bytes, n_bags * P rows of 2 * D bytes gathered
//     at random from the table, plus 4 bytes per id and the output; nothing
//     is reused, so the design reads each row once, straight from the
//     (T*R, D) table with no padded copy (the TPU version padded D to 128
//     lanes, doubling the gathered bytes).  Row offsets are 64-bit: T*R*D
//     elements pass 2^31 at the paper's sizes.
//
//     Ids outside [0, R) are not supported.  The kernel clamps each one to
//     [0, R - 1] within its table, as jnp's gather does, so it never reads
//     outside the table; the wrapper checks the range on the CPU path only.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 8;       // bags per block of 256 threads
constexpr int AHEAD = 8;       // rows loaded before their adds
constexpr unsigned FULL = 0xffffffffu;

// PAIRS: each lane owns column pairs (c, c + 1), c = c0 + 2 * (lane + 32 u);
// otherwise single columns c = c0 + lane + 32 u.  NV: units per lane per
// pass over the columns.
template <bool PAIRS, int NV, bool OUT_BF16>
__global__ void __launch_bounds__(WARPS * 32)
embedding_bag_kernel(const __nv_bfloat16* __restrict__ table,
                     const int32_t* __restrict__ ids, int64_t n_bags, int P,
                     int D, int T, int64_t R, void* __restrict__ out) {
  constexpr int W = PAIRS ? 2 : 1;            // columns per unit
  constexpr int PASS = 32 * NV * W;           // columns per pass
  const int lane = threadIdx.x & 31;
  const int64_t bag = (int64_t)blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (bag >= n_bags) return;                  // whole warps leave together
  const int64_t base = (bag % T) * R;
  const int32_t* __restrict__ bag_ids = ids + bag * (int64_t)P;

  for (int c0 = 0; c0 < D; c0 += PASS) {
    float acc[NV][W];
#pragma unroll
    for (int u = 0; u < NV; ++u)
#pragma unroll
      for (int w = 0; w < W; ++w) acc[u][w] = 0.0f;

    for (int j0 = 0; j0 < P; j0 += 32) {
      const int n = min(32, P - j0);
      int64_t my = (lane < n) ? (int64_t)bag_ids[j0 + lane] : 0;
      my = my < 0 ? 0 : (my >= R ? R - 1 : my);
      const int my_row = (int)my;             // R <= 2^31 (checked)
      for (int k = 0; k < n; k += AHEAD) {
        float v[AHEAD][NV][W];
#pragma unroll
        for (int b = 0; b < AHEAD; ++b) {
          const int r = __shfl_sync(FULL, my_row, (k + b) & 31);
          const __nv_bfloat16* row = table + (base + r) * (int64_t)D;
#pragma unroll
          for (int u = 0; u < NV; ++u) {
            const int c = c0 + W * (lane + 32 * u);
            if (k + b < n && c < D) {
              if (PAIRS) {
                const float2 f = __bfloat1622float2(
                    *reinterpret_cast<const __nv_bfloat162*>(row + c));
                v[b][u][0] = f.x;
                v[b][u][W - 1] = f.y;
              } else {
                v[b][u][0] = __bfloat162float(row[c]);
              }
            } else {
#pragma unroll
              for (int w = 0; w < W; ++w) v[b][u][w] = 0.0f;
            }
          }
        }
#pragma unroll
        for (int b = 0; b < AHEAD; ++b) {
          if (k + b < n) {                    // warp-uniform
#pragma unroll
            for (int u = 0; u < NV; ++u)
#pragma unroll
              for (int w = 0; w < W; ++w) acc[u][w] += v[b][u][w];
          }
        }
      }
    }

#pragma unroll
    for (int u = 0; u < NV; ++u) {
      const int c = c0 + W * (lane + 32 * u);
      if (c >= D) continue;
      const int64_t o = bag * (int64_t)D + c;
      if (OUT_BF16) {
        __nv_bfloat16* dst = static_cast<__nv_bfloat16*>(out) + o;
        if (PAIRS)
          *reinterpret_cast<__nv_bfloat162*>(dst) =
              __floats2bfloat162_rn(acc[u][0], acc[u][W - 1]);
        else
          *dst = __float2bfloat16_rn(acc[u][0]);
      } else {
        float* dst = static_cast<float*>(out) + o;
        if (PAIRS)
          *reinterpret_cast<float2*>(dst) =
              make_float2(acc[u][0], acc[u][W - 1]);
        else
          *dst = acc[u][0];
      }
    }
  }
}

template <bool PAIRS, bool OUT_BF16>
cudaError_t launch_nv(int nv, const __nv_bfloat16* table, const int32_t* ids,
                      int64_t n_bags, int P, int D, int T, int64_t R,
                      void* out, cudaStream_t s) {
  const dim3 block(WARPS * 32);
  const dim3 grid((unsigned)((n_bags + WARPS - 1) / WARPS));
  switch (nv) {
    case 1:
      embedding_bag_kernel<PAIRS, 1, OUT_BF16><<<grid, block, 0, s>>>(
          table, ids, n_bags, P, D, T, R, out);
      break;
    case 2:
      embedding_bag_kernel<PAIRS, 2, OUT_BF16><<<grid, block, 0, s>>>(
          table, ids, n_bags, P, D, T, R, out);
      break;
    default:
      embedding_bag_kernel<PAIRS, 4, OUT_BF16><<<grid, block, 0, s>>>(
          table, ids, n_bags, P, D, T, R, out);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Returns a cudaError_t: 0 when the launch was accepted.  table: T*R rows
// of D bf16; ids: n_bags * P int32, row-major; out: n_bags * D, bf16 when
// out_bf16 is nonzero, else float32.  The table must be 4-byte aligned for
// the pair loads when D is even (`pairs` nonzero); out is always aligned
// (a fresh allocation).
int embedding_bag(const void* table, const int32_t* ids, int64_t n_bags,
                  int P, int D, int T, int64_t R, int pairs, int out_bf16,
                  void* out, void* stream) {
  if (n_bags < 1 || P < 0 || D < 1 || T < 1 || R < 1 || R > (1LL << 31) ||
      (n_bags + WARPS - 1) / WARPS > 0x7fffffffLL ||
      (pairs && ((D & 1) || ((uintptr_t)table & 3))))
    return (int)cudaErrorInvalidValue;
  const __nv_bfloat16* tab = static_cast<const __nv_bfloat16*>(table);
  cudaStream_t s = (cudaStream_t)stream;
  const int per_unit = pairs ? 64 : 32;       // columns per unit of the warp
  const int nv = (D + per_unit - 1) / per_unit;
  if (pairs)
    return (int)(out_bf16 ? launch_nv<true, true>(nv, tab, ids, n_bags, P, D,
                                                  T, R, out, s)
                          : launch_nv<true, false>(nv, tab, ids, n_bags, P, D,
                                                   T, R, out, s));
  return (int)(out_bf16 ? launch_nv<false, true>(nv, tab, ids, n_bags, P, D,
                                                 T, R, out, s)
                        : launch_nv<false, false>(nv, tab, ids, n_bags, P, D,
                                                  T, R, out, s));
}

}  // extern "C"
