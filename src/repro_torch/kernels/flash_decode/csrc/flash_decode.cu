// One-token GQA decode attention over a KV cache, hand-written for Hopper
// (sm_90a).  Built by repro_torch/kernels/build.py with nvcc into a shared
// library with a plain C interface and loaded with ctypes; the wrappers in
// repro_torch/kernels/flash_decode/ops.py check shapes and types, allocate
// the output and the scratch, and launch on PyTorch's current stream.
//
// flash_decode   replaces the Pallas kernel
//     repro/kernels/flash_decode/flash_decode.py::flash_decode (body
//     _kernel): for each batch row b, kv head h and query g of the group,
//         s_t   = (q[b,h,g,:] . k[b,t,h,:]) * (1 / sqrt(D)),   t < length[b]
//         out   = sum_t exp(s_t - m) v[b,t,h,:] / max(sum_t exp(s_t - m), 1e-30)
//     with float32 scores, expf (no fast math), float32 p.v, an online
//     softmax (m, l, acc) over tiles of keys, and one cast to q's dtype
//     (bf16 or float32).  q (B, Hkv, G, D); k, v (B, S, Hkv, D) row-major;
//     any S.  Positions at or past length[b] are never read: in the Pallas
//     kernel their tiles add exactly 0 when length >= 1, so skipping them
//     leaves the result as it is.  length < 1 is not supported (the output
//     is then 0).
//
//     Bound: device-memory bytes, the K and V rows up to length (2 * L * D
//     elements per (b, h)); the G queries of a kv head share each row, so
//     each block reads its rows once, into shared memory, and all G queries
//     use them there.  B * Hkv is small in decode (32 for 8 requests of
//     TinyLlama), far below the card's 132 SMs, so the positions are split
//     into chunks of `chunk` keys, one block per (chunk, kv head, batch
//     row); a second kernel merges the chunks' (m, l, acc) partial sums per
//     query.  With one chunk the first kernel writes the output itself.
//
//     Block: 256 threads.  Per tile of TS keys (64 for D <= 64, 32 for
//     D <= 128, 16 up to 256): all threads load the K and V rows as float
//     (16-byte loads when D and the pointers allow), compute the G x TS
//     scores from shared memory (K rows padded by one float: no bank
//     conflicts), one warp per query updates m and l and turns the scores
//     into p, then each thread updates its (g, d) accumulators (at most 8:
//     G * D <= 2048).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_OUT = 8;                 // (g, d) outputs per thread
constexpr int MAX_G = 16, MAX_D = 256, MAX_GD = MAX_OUT * THREADS;
constexpr float NEG_INF = -1e30f;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// Rows r < n of one kv head, starting at element `off` of src, rows
// `stride` elements apart, into dst (row r at dst + r * ld) as float.
template <typename T, bool VEC>
__device__ __forceinline__ void load_rows(const T* __restrict__ src,
                                          int64_t off, int64_t stride, int n,
                                          int D, float* dst, int ld) {
  if (VEC) {
    constexpr int V = 16 / sizeof(T);       // elements per 16-byte load
    const int per_row = D / V;
    for (int e = threadIdx.x; e < n * per_row; e += THREADS) {
      const int r = e / per_row, c = (e - r * per_row) * V;
      const uint4 raw =
          *reinterpret_cast<const uint4*>(src + off + r * stride + c);
      const T* vals = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int i = 0; i < V; ++i) dst[r * ld + c + i] = to_f(vals[i]);
    }
  } else {
    for (int e = threadIdx.x; e < n * D; e += THREADS) {
      const int r = e / D, c = e - r * D;
      dst[r * ld + c] = to_f(src[off + r * stride + c]);
    }
  }
}

// grid (n_splits, Hkv, B).  n_splits == 1: writes out; otherwise the
// chunk's acc (G * D floats) to part_acc and its m, l (G floats each) to
// part_ml, at slot (b * Hkv + h) * n_splits + split.
template <typename T, bool VEC>
__global__ void __launch_bounds__(THREADS)
flash_decode_split(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, const int32_t* __restrict__ length,
                   int S, int Hkv, int G, int D, int TS, int chunk,
                   int n_splits, float scale, float* __restrict__ part_acc,
                   float* __restrict__ part_ml, T* __restrict__ out) {
  extern __shared__ float smem[];
  const int split = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int GD = G * D;
  float* qs = smem;                         // G * D
  float* ks = qs + GD;                      // TS * (D + 1)
  float* vs = ks + TS * (D + 1);            // TS * D
  float* ps = vs + TS * D;                  // G * TS
  float* m_s = ps + G * TS;                 // G
  float* l_s = m_s + G;                     // G
  float* c_s = l_s + G;                     // G
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  int len = length[b];
  len = len < 0 ? 0 : (len > S ? S : len);
  const int s_begin = split * chunk;
  const int s_end = min(s_begin + chunk, len);
  const int64_t bh = (int64_t)b * Hkv + h;

  for (int e = tid; e < GD; e += THREADS) qs[e] = to_f(q[bh * GD + e]);
  for (int g = tid; g < G; g += THREADS) {
    m_s[g] = NEG_INF;
    l_s[g] = 0.0f;
  }
  float acc[MAX_OUT];
#pragma unroll
  for (int i = 0; i < MAX_OUT; ++i) acc[i] = 0.0f;
  __syncthreads();

  const int64_t stride = (int64_t)Hkv * D;
  for (int t0 = s_begin; t0 < s_end; t0 += TS) {
    const int n = min(TS, s_end - t0);
    const int64_t off = (((int64_t)b * S + t0) * Hkv + h) * D;
    load_rows<T, VEC>(k, off, stride, n, D, ks, D + 1);
    load_rows<T, VEC>(v, off, stride, n, D, vs, D);
    __syncthreads();

    // scores of the tile; positions past the tile's end are masked
    for (int e = tid; e < G * TS; e += THREADS) {
      const int g = e / TS, r = e - g * TS;
      float s = NEG_INF;
      if (r < n) {
        const float* qg = qs + g * D;
        const float* kr = ks + r * (D + 1);
        float dot = 0.0f;
        for (int d = 0; d < D; ++d) dot += qg[d] * kr[d];
        s = dot * scale;
      }
      ps[e] = s;
    }
    __syncthreads();

    // online softmax: one warp per query
    for (int g = warp; g < G; g += WARPS) {
      float* pg = ps + g * TS;
      float mx = NEG_INF;
      for (int r = lane; r < TS; r += 32) mx = fmaxf(mx, pg[r]);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, o));
      const float m_old = m_s[g];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.0f;
      for (int r = lane; r < TS; r += 32) {
        const float p = expf(pg[r] - m_new);
        pg[r] = p;
        sum += p;
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(FULL, sum, o);
      if (lane == 0) {
        const float corr = expf(m_old - m_new);
        m_s[g] = m_new;
        l_s[g] = l_s[g] * corr + sum;
        c_s[g] = corr;
      }
    }
    __syncthreads();

    // acc = acc * corr + p . v
#pragma unroll
    for (int i = 0; i < MAX_OUT; ++i) {
      const int e = tid + i * THREADS;
      if (e < GD) {
        const int g = e / D, d = e - g * D;
        const float* pg = ps + g * TS;
        float pv = 0.0f;
        for (int r = 0; r < n; ++r) pv += pg[r] * vs[r * D + d];
        acc[i] = acc[i] * c_s[g] + pv;
      }
    }
    __syncthreads();
  }

  if (n_splits == 1) {
#pragma unroll
    for (int i = 0; i < MAX_OUT; ++i) {
      const int e = tid + i * THREADS;
      if (e < GD) store(out + bh * GD + e, acc[i] / fmaxf(l_s[e / D], 1e-30f));
    }
    return;
  }
  const int64_t slot = bh * n_splits + split;
#pragma unroll
  for (int i = 0; i < MAX_OUT; ++i) {
    const int e = tid + i * THREADS;
    if (e < GD) part_acc[slot * GD + e] = acc[i];
  }
  for (int g = tid; g < G; g += THREADS) {
    part_ml[slot * 2 * G + g] = m_s[g];
    part_ml[slot * 2 * G + G + g] = l_s[g];
  }
}

// grid (Hkv, B): merges the n_splits chunks of (b, h) into the output.
template <typename T>
__global__ void __launch_bounds__(THREADS)
flash_decode_combine(const float* __restrict__ part_acc,
                     const float* __restrict__ part_ml, int G, int D,
                     int n_splits, T* __restrict__ out) {
  const int64_t bh = (int64_t)blockIdx.y * gridDim.x + blockIdx.x;
  const int GD = G * D;
  const float* ml = part_ml + bh * n_splits * 2 * G;
  for (int e = threadIdx.x; e < GD; e += THREADS) {
    const int g = e / D;
    float m = NEG_INF;
    for (int s = 0; s < n_splits; ++s) m = fmaxf(m, ml[s * 2 * G + g]);
    float l = 0.0f, a = 0.0f;
    for (int s = 0; s < n_splits; ++s) {
      const float w = expf(ml[s * 2 * G + g] - m);
      l += ml[s * 2 * G + G + g] * w;
      a += part_acc[(bh * n_splits + s) * GD + e] * w;
    }
    store(out + bh * GD + e, a / fmaxf(l, 1e-30f));
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const int32_t* length, int B, int S, int Hkv, int G, int D,
                   int chunk, int n_splits, float* part_acc, float* part_ml,
                   void* out, cudaStream_t stream) {
  const int TS = D <= 64 ? 64 : (D <= 128 ? 32 : 16);
  const size_t smem =
      sizeof(float) * ((size_t)G * D + (size_t)TS * (D + 1) + (size_t)TS * D +
                       (size_t)G * TS + 3 * (size_t)G);
  const float scale = (float)(1.0 / sqrt((double)D));
  constexpr int V = 16 / sizeof(T);
  const bool vec = D % V == 0 && ((uintptr_t)k & 15) == 0 &&
                   ((uintptr_t)v & 15) == 0;
  const dim3 grid((unsigned)n_splits, (unsigned)Hkv, (unsigned)B);
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  T* ot = static_cast<T*>(out);
  if (vec)
    flash_decode_split<T, true><<<grid, THREADS, smem, stream>>>(
        qt, kt, vt, length, S, Hkv, G, D, TS, chunk, n_splits, scale,
        part_acc, part_ml, ot);
  else
    flash_decode_split<T, false><<<grid, THREADS, smem, stream>>>(
        qt, kt, vt, length, S, Hkv, G, D, TS, chunk, n_splits, scale,
        part_acc, part_ml, ot);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || n_splits == 1) return err;
  flash_decode_combine<T><<<dim3((unsigned)Hkv, (unsigned)B), THREADS, 0,
                            stream>>>(part_acc, part_ml, G, D, n_splits, ot);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Returns a cudaError_t: 0 when the launches were accepted.  q (B, Hkv, G,
// D), k and v (B, S, Hkv, D), out (B, Hkv, G, D): float32 when is_f32 is
// nonzero, else bf16; length (B,) int32.  With n_splits > 1, part_acc
// holds B * Hkv * n_splits * G * D floats and part_ml B * Hkv * n_splits *
// 2 * G; chunk * n_splits positions are covered.
int flash_decode(const void* q, const void* k, const void* v,
                 const int32_t* length, int B, int S, int Hkv, int G, int D,
                 int is_f32, int chunk, int n_splits, float* part_acc,
                 float* part_ml, void* out, void* stream) {
  if (B < 1 || B > 65535 || S < 1 || Hkv < 1 || Hkv > 65535 || G < 1 ||
      G > MAX_G || D < 1 || D > MAX_D || G * D > MAX_GD || chunk < 1 ||
      n_splits < 1 || (n_splits > 1 && (part_acc == nullptr ||
                                        part_ml == nullptr)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (is_f32)
    return (int)launch<float>(q, k, v, length, B, S, Hkv, G, D, chunk,
                              n_splits, part_acc, part_ml, out, s);
  return (int)launch<__nv_bfloat16>(q, k, v, length, B, S, Hkv, G, D, chunk,
                                    n_splits, part_acc, part_ml, out, s);
}

}  // extern "C"
