// Backward of the DLRM's embedding-bag sum pooling, hand-written for Hopper
// (sm_90a).  Built by repro_torch/kernels/build.py with nvcc into a shared
// library with a plain C interface and loaded with ctypes; the wrapper
// repro_torch/kernels/embedding_bag/ops.py::embedding_bag_stacked_backward
// prepares the index (one stable sort), allocates the output and launches
// on PyTorch's current stream.
//
// embedding_bag_backward   replaces no Pallas kernel: the reference trains
//     its DLRM through jnp bags (repro/models/dlrm.py, _embed_bags), whose
//     gradient jax.grad takes as a scatter-add into zeros.  The port's
//     forward runs the embedding_bag kernel, so its backward is a kernel
//     too.  For T stacked tables of R rows, the pooled gradient
//     dpooled (B*T bags, D) and the ids idx (B, T, P):
//         dtables[t * R + r, :] = sum over (b, p) with idx[b, t, p] == r
//                                 of dpooled[b * T + t, :]
//     with repeats counted each time; a row no bag touches is 0.  The sums
//     run in float32 in a fixed order, by row and then by the entry's flat
//     index (b, t, p), and are rounded once to the output's dtype: two
//     launches on the same inputs agree bit for bit, and with the plain
//     version (ref.py::embedding_bag_stacked_backward_ref), which adds in
//     the same order.  Float32 atomics would add in the order the warps
//     arrive.
//
//     Index preparation (the wrapper): the entries' global rows
//     t * R + idx[b, t, p], flattened in (b, t, p) order, sorted stably:
//     sorted_rows (n) and perm (n), the entry each sorted position holds.
//     A row's entries are then one contiguous run, in flat-index order.
//
//     embedding_bag_backward_kernel: one warp per sorted position; the warp
//     at the first position of a run sums the run, the others leave at
//     once (no count of runs, so no device-to-host copy before the
//     launch).  The warp reads 32 positions at a time, one per lane (the
//     run's lanes are a prefix: ballot and popcount), broadcasts each
//     entry's bag with a shuffle, and the lanes cover the row's columns as
//     pairs (or single columns where D is odd or a pointer is not aligned
//     for the pair loads), loading eight bags ahead of their adds.
//
//     embedding_bag_zero_kernel: a zero fill of the output, 16-byte
//     stores over the whole (T * R, D) tensor.  The wrapper takes
//     torch.zeros, which was the faster on the card (PERF.md); this one
//     stays as the yardstick chip_smoke.py times it against.
//
//     Bound: device-memory bytes.  The output is written once, all
//     T * R * D elements (8.19 GB at Table II's sizes, the zero fill, 2.45
//     ms at 3.35 TB/s), against 2.1 MB of dpooled and 3.9 MB of ids read:
//     the fill is the time.  The touched rows (983,040 at B=256) are a
//     second, scattered write of 126 MB; dpooled (2.1 MB) stays in the L2
//     while the warps gather it.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 8;       // sorted positions per block of 256 threads
constexpr int AHEAD = 8;       // bags loaded before their adds
constexpr unsigned FULL = 0xffffffffu;

template <bool IN_BF16>
__device__ __forceinline__ float2 load_pair(const void* base, int64_t o) {
  if (IN_BF16)
    return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
        static_cast<const __nv_bfloat16*>(base) + o));
  return *reinterpret_cast<const float2*>(static_cast<const float*>(base) +
                                          o);
}

template <bool IN_BF16>
__device__ __forceinline__ float load_one(const void* base, int64_t o) {
  if (IN_BF16)
    return __bfloat162float(static_cast<const __nv_bfloat16*>(base)[o]);
  return static_cast<const float*>(base)[o];
}

// PAIRS: each lane owns column pairs (c, c + 1), c = c0 + 2 * (lane + 32 u);
// otherwise single columns c = c0 + lane + 32 u.  NV: units per lane per
// pass over the columns.
template <bool PAIRS, int NV, bool IN_BF16, bool OUT_BF16>
__global__ void __launch_bounds__(WARPS * 32)
embedding_bag_backward_kernel(const void* __restrict__ dpooled,
                              const int32_t* __restrict__ sorted_rows,
                              const int32_t* __restrict__ perm, int64_t n,
                              int P, int D, void* __restrict__ out) {
  constexpr int W = PAIRS ? 2 : 1;            // columns per unit
  constexpr int PASS = 32 * NV * W;           // columns per pass
  const int lane = threadIdx.x & 31;
  const int64_t start = (int64_t)blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (start >= n) return;                     // whole warps leave together
  const int32_t row = sorted_rows[start];
  if (start > 0 && sorted_rows[start - 1] == row) return;  // not a run start

  for (int c0 = 0; c0 < D; c0 += PASS) {
    float acc[NV][W];
#pragma unroll
    for (int u = 0; u < NV; ++u)
#pragma unroll
      for (int w = 0; w < W; ++w) acc[u][w] = 0.0f;

    for (int64_t j0 = start;; j0 += 32) {
      const int64_t j = j0 + lane;
      const bool in = j < n && sorted_rows[j] == row;
      const int cnt = __popc(__ballot_sync(FULL, in));   // a prefix
      const int my_bag = in ? perm[j] / P : 0;
      for (int k = 0; k < cnt; k += AHEAD) {
        float v[AHEAD][NV][W];
#pragma unroll
        for (int b = 0; b < AHEAD; ++b) {
          const int bag = __shfl_sync(FULL, my_bag, (k + b) & 31);
          const int64_t base = (int64_t)bag * D;
#pragma unroll
          for (int u = 0; u < NV; ++u) {
            const int c = c0 + W * (lane + 32 * u);
            if (k + b < cnt && c < D) {
              if (PAIRS) {
                const float2 f = load_pair<IN_BF16>(dpooled, base + c);
                v[b][u][0] = f.x;
                v[b][u][W - 1] = f.y;
              } else {
                v[b][u][0] = load_one<IN_BF16>(dpooled, base + c);
              }
            } else {
#pragma unroll
              for (int w = 0; w < W; ++w) v[b][u][w] = 0.0f;
            }
          }
        }
#pragma unroll
        for (int b = 0; b < AHEAD; ++b) {
          if (k + b < cnt) {                  // warp-uniform
#pragma unroll
            for (int u = 0; u < NV; ++u)
#pragma unroll
              for (int w = 0; w < W; ++w) acc[u][w] += v[b][u][w];
          }
        }
      }
      if (cnt < 32) break;                    // the run ended in this batch
    }

#pragma unroll
    for (int u = 0; u < NV; ++u) {
      const int c = c0 + W * (lane + 32 * u);
      if (c >= D) continue;
      const int64_t o = (int64_t)row * D + c;
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

__global__ void __launch_bounds__(256)
embedding_bag_zero_kernel(uint4* __restrict__ out, int64_t n16,
                          unsigned char* __restrict__ tail, int tail_bytes) {
  const uint4 z = make_uint4(0u, 0u, 0u, 0u);
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n16;
       i += stride)
    out[i] = z;
  if (blockIdx.x == 0 && (int)threadIdx.x < tail_bytes) tail[threadIdx.x] = 0;
}

template <bool PAIRS, bool IN_BF16, bool OUT_BF16>
cudaError_t launch_nv(int nv, const void* dpooled, const int32_t* rows,
                      const int32_t* perm, int64_t n, int P, int D, void* out,
                      cudaStream_t s) {
  const dim3 block(WARPS * 32);
  const dim3 grid((unsigned)((n + WARPS - 1) / WARPS));
  switch (nv) {
    case 1:
      embedding_bag_backward_kernel<PAIRS, 1, IN_BF16, OUT_BF16>
          <<<grid, block, 0, s>>>(dpooled, rows, perm, n, P, D, out);
      break;
    case 2:
      embedding_bag_backward_kernel<PAIRS, 2, IN_BF16, OUT_BF16>
          <<<grid, block, 0, s>>>(dpooled, rows, perm, n, P, D, out);
      break;
    default:
      embedding_bag_backward_kernel<PAIRS, 4, IN_BF16, OUT_BF16>
          <<<grid, block, 0, s>>>(dpooled, rows, perm, n, P, D, out);
  }
  return cudaGetLastError();
}

template <bool PAIRS>
cudaError_t launch_types(int nv, int in_bf16, int out_bf16,
                         const void* dpooled, const int32_t* rows,
                         const int32_t* perm, int64_t n, int P, int D,
                         void* out, cudaStream_t s) {
  if (in_bf16)
    return out_bf16 ? launch_nv<PAIRS, true, true>(nv, dpooled, rows, perm, n,
                                                   P, D, out, s)
                    : launch_nv<PAIRS, true, false>(nv, dpooled, rows, perm,
                                                    n, P, D, out, s);
  return out_bf16 ? launch_nv<PAIRS, false, true>(nv, dpooled, rows, perm, n,
                                                  P, D, out, s)
                  : launch_nv<PAIRS, false, false>(nv, dpooled, rows, perm, n,
                                                   P, D, out, s);
}

}  // namespace

extern "C" {

// Returns a cudaError_t: 0 when the launch was accepted.  dpooled: bags of
// D values (bf16 when in_bf16 is nonzero, else float32), bag e / P for
// entry e; sorted_rows, perm: n int32, the entries' output rows sorted
// stably and the entry at each sorted position; out: rows of D (bf16 when
// out_bf16, else float32), already zero (every row no entry names keeps
// its value).  `pairs` (nonzero) needs D even and dpooled aligned to two
// of its elements; out is a fresh allocation.
int embedding_bag_backward(const void* dpooled, const int32_t* sorted_rows,
                           const int32_t* perm, int64_t n, int P, int D,
                           int pairs, int in_bf16, int out_bf16, void* out,
                           void* stream) {
  const int in_size = in_bf16 ? 2 : 4;
  if (n < 0 || P < 1 || D < 1 ||
      (n + WARPS - 1) / WARPS > 0x7fffffffLL ||
      (pairs && ((D & 1) || ((uintptr_t)dpooled % (2 * in_size)))))
    return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  const int per_unit = pairs ? 64 : 32;       // columns per unit of the warp
  const int nv = (D + per_unit - 1) / per_unit;
  if (pairs)
    return (int)launch_types<true>(nv, in_bf16, out_bf16, dpooled,
                                   sorted_rows, perm, n, P, D, out, s);
  return (int)launch_types<false>(nv, in_bf16, out_bf16, dpooled, sorted_rows,
                                  perm, n, P, D, out, s);
}

// Zero n_bytes from out (16-byte aligned) on the stream.
int embedding_bag_zero(void* out, int64_t n_bytes, void* stream) {
  if (n_bytes < 0 || ((uintptr_t)out & 15)) return (int)cudaErrorInvalidValue;
  if (n_bytes == 0) return 0;
  const int64_t n16 = n_bytes / 16;
  const int tail = (int)(n_bytes - n16 * 16);
  int dev = 0, sms = 132;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  int64_t blocks = (n16 + 255) / 256;
  if (blocks > (int64_t)sms * 8) blocks = (int64_t)sms * 8;
  if (blocks < 1) blocks = 1;
  embedding_bag_zero_kernel<<<(unsigned)blocks, 256, 0, (cudaStream_t)stream>>>(
      static_cast<uint4*>(out), n16,
      static_cast<unsigned char*>(out) + n16 * 16, tail);
  return (int)cudaGetLastError();
}

}  // extern "C"
