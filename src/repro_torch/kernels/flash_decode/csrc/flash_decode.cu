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
//         s_t   = cap * tanh(s_t / cap)       with a logit softcap cap > 0
//         out   = sum_t exp(s_t - m) v[b,t,h,:] / max(sum_t exp(s_t - m), 1e-30)
//     with float32 scores, expf and tanhf (no fast math), float32 p.v, an
//     online softmax (m, l, acc), and one cast to q's dtype (bf16 or
//     float32).  The softcap (Gemma-2's attention logits; the reference
//     applies it in layers.decode_attention and transformer._ring_decode,
//     the Pallas kernel takes none) is a template flag of both bodies, so
//     that the code without it is the code PR 15 measured.
//     q (B, Hkv, G, D); k, v (B, S, Hkv, D) row-major; any S; G <= 16,
//     D <= 256, G * D <= 2048.  Positions at or past length[b] are never
//     read (in the Pallas kernel their tiles add exactly 0 when length >= 1).
//     length < 1 gives an output of 0 (the log-sum-exp route's lse -inf).
//
// Bound: device-memory bytes, the K and V rows below length (2 * L * D
//     elements per (b, h)).  In bf16 the work is about 8 FLOP per byte read,
//     far below the ~295 at which the tensor cores would limit, so the
//     design keeps many bytes in flight, spreads them evenly over the SMs
//     and spends few instructions per byte.  B * Hkv is small in decode (32
//     for 8 requests of TinyLlama), so the positions are split into fixed
//     chunks of `chunk` keys whose (m, l, acc) partials a second kernel
//     merges; with one chunk the first kernel writes the output itself.
//
// bf16 route (the serving path):
//   1. Asynchronous bf16 tiles.  One warp a block; the warp streams its
//      chunk (64 keys) in tiles of 16 keys through a ring in shared memory
//      (4 tiles deep for D <= 64, so the whole 16 KB chunk is in flight; 3
//      above): K and V rows go in as bf16, unconverted, by cp.async.cg
//      16-byte copies issued a ring ahead of compute, rows past the end
//      zero-filled by the copy.  About 8 blocks share an SM (128 KB in
//      flight), and 16 KB blocks spread evenly over the 132 SMs: blocks of
//      4 warps and 256 keys (64 KB) left SMs with 2 or 3 of them and a
//      barrier-bound merge of the warps, and measured slower.  Where D is
//      not a multiple of 8 or q, K, V are not 16-byte aligned, the same
//      ring is filled by scalar loads.  Rows are padded by 16 bytes so that
//      ldmatrix reads are free of bank conflicts; D is zero-padded to a
//      multiple of 16 and the G queries to 16 rows.
//   2. Scores on the tensor cores: mma.sync m16n8k16 bf16 x bf16 -> f32,
//      Q (16 x D, ldmatrix from shared memory) times K^T (ldmatrix).  bf16
//      products are exact in f32, so the scores are the plain version's up
//      to summation order.
//   3. Softmax in registers: the warp keeps its rows' (m, l) and acc
//      fragments in registers, with no block barrier at all (__syncwarp
//      around each ring slot); rows 8-15 are padding when G <= 8 and skip
//      the expf.
//   4. P.V on the tensor cores at f32 accuracy: p leaves the score
//      accumulator as the A fragment (FlashAttention-2's register reuse),
//      V comes through ldmatrix.trans.  p is split into three bf16 terms
//      hi + mid + lo that together hold its 24 significant bits, and three
//      products are issued: a single bf16 rounding of p (2^-8 relative)
//      would not meet the float32 tolerance.
//   5. Fixed chunks.  The result depends on neither max_length (the split
//      count) nor the other rows' lengths: each chunk's partial is computed
//      the same way whichever block takes it; chunks at or past length[b]
//      write nothing; the merge reads only the ceil(length[b] / chunk)
//      valid partials, in a fixed order.  The grid holds about as many
//      blocks as the card keeps resident, each walking its row's chunks
//      x, x + n_blocks, ... and stopping at the first idle one, so a large
//      max_length costs no block per idle chunk.  The merge kernel is a
//      programmatic dependent launch: its blocks are scheduled while the
//      split kernel runs and wait (griddepcontrol.wait) for its partials.
// int8 route (ROADMAP item 9.3, the reference's kv_quant_int8 cache, which
//   layers.decode_attention_quant reads; the Pallas kernel takes none): a
//   template flag I8 of the bf16 body, so that the bf16 instantiations
//   compile to the same code as without the flag (the same SASS counts).
//   K and V arrive as int8 (B, S, Hkv, D) with float32 scales k_s, v_s
//   (B, S, Hkv), one per (key, kv head):
//       s_t = (q . k8_t) * k_s[t] * (1 / sqrt(D)),  softcapped where asked,
//       out = sum_t p_t v_s[t] v8_t / sum_t p_t
//   (the reference folds the scales into the logits and the probability
//   weights the same way).  The int8 rows and the scales go into a staging
//   ring by cp.async (16-byte copies of the rows, 4-byte copies of the
//   scales, which lie Hkv floats apart), half the bytes of a bf16 tile;
//   each tile is widened to bf16 in shared memory before its ldmatrix
//   reads (exact: |x| <= 127 fits bf16's 8-bit significand), so the bf16
//   body's mma.sync products run unchanged; each lane scales its four keys'
//   scores by k_s, and their p by v_s before the three-term split.  Bound:
//   the int8 rows and the scales, 2 * L * (D + 4) bytes per (b, h), about
//   half the bf16 route's.
// log-sum-exp route (a decode cache split along the sequence across ranks,
//   the reference's long_500k and decode_seq_shard layouts, whose softmax
//   GSPMD reduces across the ranks): a template flag LSE of the bf16 and
//   int8 bodies and of the merge, taken where flash_decode is given an lse
//   output.  Each row
//   also writes its log-sum-exp m + log(l) (B, Hkv, G), and out is float32,
//   normalised by the row's own sum, so that the ranks merge exactly
//   without a bf16 rounding per rank.  A row of length 0 (a rank whose
//   block lies past the decode position) gives out 0 and lse -inf.  Only
//   the 16-byte copy variant is instantiated (the caches are whole
//   allocations); the flag-free instantiations are unchanged.
// float32 route: no tensor-core product keeps 1e-5 on float32 inputs, and no
//   path serves float32, so it keeps the CUDA-core body of the first port:
//   256 threads, tiles of keys converted to float in shared memory, the
//   scores and p.v as scalar FMAs, one warp per query for the softmax.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>
#include <type_traits>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int MAX_G = 16, MAX_D = 256, MAX_GD = 2048;
constexpr float NEG_INF = -1e30f;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ void store(float* p, float x) { *p = x; }

// a scaled score through the logit softcap, where CAP
template <bool CAP>
__device__ __forceinline__ float capped(float x, float cap) {
  return CAP ? cap * tanhf(x / cap) : x;
}
__device__ __forceinline__ void store(bf16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// ---------------------------------------------------------------------------
// bf16 route
// ---------------------------------------------------------------------------

constexpr int TK = 16;            // keys per tile (one k-step of p.v)
constexpr int ROW_PAD = 8;        // elements (16 bytes) after each smem row

// tiles in the warp's ring
__host__ __device__ constexpr int ring_depth(int DB) { return DB <= 64 ? 4 : 3; }

// bytes of dynamic shared memory: Q (16 rows) and a ring of `slots` tiles
// of K and V, rows of LD elements
__host__ __device__ constexpr size_t tc_smem(int LD, int slots) {
  return (size_t)LD * 2 * (16 + (size_t)slots * 2 * TK);
}

// bytes of dynamic shared memory of the int8 route: Q (16 rows), one bf16
// tile of K and V (rows of LD elements) that each int8 tile is widened
// into, and a ring of `slots` int8 tiles (rows of DP bytes) with their
// scales (2 * TK floats a slot)
__host__ __device__ constexpr size_t tc_smem_i8(int LD, int DP, int slots) {
  return (size_t)LD * 2 * (16 + 2 * TK) +
         (size_t)slots * 2 * TK * ((size_t)DP + sizeof(float));
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, bypassing L1; `bytes` < 16 zero-fills the rest
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(bytes)
               : "memory");
}
// 4 bytes global -> shared (through L1); `bytes` 0 writes zero
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 x) {
  return *reinterpret_cast<uint32_t*>(&x);
}

// 16 int8 values -> 16 bf16 values (exact) at dst (16-byte aligned)
__device__ __forceinline__ void widen16(int4 x, bf16* dst) {
  const int w[4] = {x.x, x.y, x.z, x.w};
  uint32_t o[8];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int v = w[i];
    o[2 * i] = bits(__floats2bfloat162_rn((float)(int8_t)(v & 0xff),
                                          (float)(int8_t)((v >> 8) & 0xff)));
    o[2 * i + 1] = bits(__floats2bfloat162_rn(
        (float)(int8_t)((v >> 16) & 0xff), (float)(int8_t)((v >> 24) & 0xff)));
  }
  reinterpret_cast<uint4*>(dst)[0] = make_uint4(o[0], o[1], o[2], o[3]);
  reinterpret_cast<uint4*>(dst)[1] = make_uint4(o[4], o[5], o[6], o[7]);
}

// c (16 x 8, f32) += a (16 x 16, bf16, row) . b (16 x 8, bf16, col)
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// (x0, x1) = hi + mid + lo exactly (to f32's 24 bits), each a bf16 pair
// with x0 in the low half
__device__ __forceinline__ void split3(float x0, float x1, uint32_t& hi,
                                       uint32_t& mid, uint32_t& lo) {
  const __nv_bfloat162 a = __floats2bfloat162_rn(x0, x1);
  const float2 af = __bfloat1622float2(a);
  const float r0 = x0 - af.x, r1 = x1 - af.y;
  const __nv_bfloat162 b = __floats2bfloat162_rn(r0, r1);
  const float2 bf = __bfloat1622float2(b);
  const __nv_bfloat162 c = __floats2bfloat162_rn(r0 - bf.x, r1 - bf.y);
  hi = bits(a);
  mid = bits(b);
  lo = bits(c);
}

// grid (n_blocks, Hkv, B), one warp a block: block x takes the chunks
// split = x, x + n_blocks, ... of (b, h) that start below length[b], the
// keys [split * chunk, min((split + 1) * chunk, length)).  DB: D padded to
// 16 is at most DB (64, 128 or 256).  VEC: 16-byte copies (D % 8 == 0, q,
// K and V 16-byte aligned), else scalar loads.  n_splits == 1: writes out;
// otherwise each chunk's acc (G * D floats) to part_acc and its m, l (G
// floats each) to part_ml, at slot (b * Hkv + h) * n_splits + split.
// CAP: the scaled scores go through the softcap `cap`.  I8: K and V are
// int8 with the float32 scales k_scale, v_scale (B, S, Hkv); VEC then
// needs D % 16 == 0.  LSE: out is float32 and lse (B, Hkv, G) gets each
// row's log-sum-exp m + log(l) (-inf where the row reads no key: its out
// is then 0).
template <int DB, bool VEC, bool CAP, bool I8, bool LSE>
__global__ void __launch_bounds__(32)
flash_decode_tc(const bf16* __restrict__ q,
                const typename std::conditional<I8, int8_t, bf16>::type*
                    __restrict__ k,
                const typename std::conditional<I8, int8_t, bf16>::type*
                    __restrict__ v,
                const int32_t* __restrict__ length,
                int S, int Hkv, int G, int D, int chunk, int n_splits,
                float scale, float cap, float* __restrict__ part_acc,
                float* __restrict__ part_ml,
                typename std::conditional<LSE, float, bf16>::type*
                    __restrict__ out,
                float* __restrict__ lse,
                const float* __restrict__ k_scale,
                const float* __restrict__ v_scale) {
  constexpr int NST = ring_depth(DB);   // tiles in flight
  constexpr int NT = DB / 8;            // d n-tiles at most
  constexpr int QPL = DB / 16;          // 8-element pieces of Q per lane
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // the merge grid may be scheduled once every block here has started; it
  // waits for this grid to finish before it reads the partials
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  const int h = blockIdx.y, b = blockIdx.z;
  const int lane = threadIdx.x;
  const int gr = lane >> 2, tg = lane & 3;   // mma fragment row, column pair
  const int DP = (D + 15) & ~15, LD = DP + ROW_PAD, nk = DP / 16;
  const int GD = G * D;
  const int64_t bh = (int64_t)b * Hkv + h;
  const bf16 zero = __ushort_as_bfloat16((unsigned short)0);

  // the row's length and this lane's pieces of Q (16 x DP, zero-padded),
  // all loads issued at once; piece i is row r, columns c .. c + 7
  int len = length[b];
  uint4 qv[QPL];
#pragma unroll
  for (int i = 0; i < QPL; ++i) {
    const int p = lane + 32 * i, r = p / (DP / 8), c = (p - r * (DP / 8)) * 8;
    bf16* e = reinterpret_cast<bf16*>(&qv[i]);
    if (VEC) {
      qv[i] = r < G && c < D
                  ? *reinterpret_cast<const uint4*>(q + bh * GD + r * D + c)
                  : make_uint4(0, 0, 0, 0);
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j)
        e[j] = r < G && c + j < D ? q[bh * GD + r * D + c + j] : zero;
    }
  }
  len = len < 0 ? 0 : (len > S ? S : len);
  // chunks at or past length are idle and write nothing (split 0 runs, so
  // that length 0 gives 0)
  if (blockIdx.x > 0 && blockIdx.x * chunk >= len) return;

  bf16* qs = reinterpret_cast<bf16*>(smem_raw);       // 16 x LD
  bf16* ring = qs + 16 * LD;                           // [slot][K, V][TK x LD]
  // int8 route: `ring` is the one widened tile; the int8 ring and its
  // scales follow it
  int8_t* stage = reinterpret_cast<int8_t*>(ring + 2 * TK * LD);
  float* stage_s = reinterpret_cast<float*>(stage + NST * 2 * TK * DP);
#pragma unroll
  for (int i = 0; i < QPL; ++i) {
    const int p = lane + 32 * i, r = p / (DP / 8), c = (p - r * (DP / 8)) * 8;
    if (r < 16) *reinterpret_cast<uint4*>(qs + r * LD + c) = qv[i];
  }
  // the padding columns of every ring row (the loads never write them)
  if (DP > D)
    for (int e = lane; e < (I8 ? 1 : NST) * 2 * TK * (DP - D); e += 32) {
      const int r = e / (DP - D);
      ring[r * LD + D + (e - r * (DP - D))] = zero;
    }
  __syncwarp();
  const int64_t stride = (int64_t)Hkv * D;
  const int64_t base = ((int64_t)b * S * Hkv + h) * D;   // k[b, 0, h, 0]
  const int64_t sbase = (int64_t)b * S * Hkv + h;        // k_scale[b, 0, h]

  for (int split = blockIdx.x; split < n_splits && (split == 0 ||
                                                    split * chunk < len);
       split += gridDim.x) {
    const int s_begin = split * chunk, s_end = min(s_begin + chunk, len);
    const int n_tiles = s_end > s_begin ? (s_end - s_begin + TK - 1) / TK : 0;
    auto issue = [&](int tile) {
      const int t0 = s_begin + tile * TK;
      if constexpr (I8) {
        // the int8 rows, then lane r < TK the scale k_s of key r and lane
        // TK + r its v_s
        int8_t* k8 = stage + (tile % NST) * 2 * TK * DP;
        int8_t* v8 = k8 + TK * DP;
        if (VEC) {
          const int per_row = D / 16;
          for (int c = lane; c < TK * per_row; c += 32) {
            const int r = c / per_row, col = (c - r * per_row) * 16;
            const bool ok = t0 + r < s_end;
            const int64_t off = base + (ok ? (t0 + r) * stride + col : 0);
            cp_async16(smem_u32(k8 + r * DP + col), k + off, ok ? 16 : 0);
            cp_async16(smem_u32(v8 + r * DP + col), v + off, ok ? 16 : 0);
          }
        } else {
          for (int e = lane; e < TK * D; e += 32) {
            const int r = e / D, col = e - r * D;
            const bool ok = t0 + r < s_end;
            const int64_t off = base + (t0 + r) * stride + col;
            k8[r * DP + col] = ok ? k[off] : (int8_t)0;
            v8[r * DP + col] = ok ? v[off] : (int8_t)0;
          }
        }
        const int r = lane & (TK - 1);
        const bool ok = t0 + r < s_end;
        const float* src = (lane < TK ? k_scale : v_scale) +
                           (ok ? sbase + (int64_t)(t0 + r) * Hkv : 0);
        cp_async4(smem_u32(stage_s + (tile % NST) * 2 * TK + lane), src,
                  ok ? 4 : 0);
      } else {
        bf16* ks = ring + (tile % NST) * 2 * TK * LD;
        bf16* vs = ks + TK * LD;
        if (VEC) {
          const int per_row = D / 8;               // 16-byte pieces per row
          for (int c = lane; c < TK * per_row; c += 32) {
            const int r = c / per_row, col = (c - r * per_row) * 8;
            const bool ok = t0 + r < s_end;
            const int64_t off = base + (ok ? (t0 + r) * stride + col : 0);
            cp_async16(smem_u32(ks + r * LD + col), k + off, ok ? 16 : 0);
            cp_async16(smem_u32(vs + r * LD + col), v + off, ok ? 16 : 0);
          }
        } else {
          for (int e = lane; e < TK * D; e += 32) {
            const int r = e / D, col = e - r * D;
            const bool ok = t0 + r < s_end;
            const int64_t off = base + (t0 + r) * stride + col;
            ks[r * LD + col] = ok ? k[off] : zero;
            vs[r * LD + col] = ok ? v[off] : zero;
          }
        }
      }
    };
    // the ring's tiles go out before anything waits
#pragma unroll
    for (int t = 0; t < NST; ++t) {
      if (t < n_tiles) issue(t);
      cp_async_commit();
    }

    float m_r[2] = {NEG_INF, NEG_INF}, l_r[2] = {0.0f, 0.0f};
    float acc[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[n][j] = 0.0f;

    for (int tile = 0; tile < n_tiles; ++tile) {
      cp_async_wait<NST - 1>();
      __syncwarp();
      const bf16* ks = ring + (I8 ? 0 : (tile % NST) * 2 * TK * LD);
      const bf16* vs = ks + TK * LD;
      const float* sc = stage_s + (tile % NST) * 2 * TK;   // I8: k_s, v_s
      if (I8) {
        // widen the tile's int8 K and V rows to bf16
        const int8_t* k8 = stage + (tile % NST) * 2 * TK * DP;
        bf16* kt = ring;
        if (VEC) {
          const int per_row = D / 16;
          for (int c = lane; c < 2 * TK * per_row; c += 32) {
            const int r = c / per_row, col = (c - r * per_row) * 16;
            widen16(*reinterpret_cast<const int4*>(k8 + r * DP + col),
                    kt + r * LD + col);
          }
        } else {
          for (int e = lane; e < 2 * TK * D; e += 32) {
            const int r = e / D, col = e - r * D;
            kt[r * LD + col] = __float2bfloat16_rn((float)k8[r * DP + col]);
          }
        }
        __syncwarp();
      }

      // scores: s[n] is the 16 x 8 block of keys n * 8 .. n * 8 + 7
      float s[2][4] = {{0.0f, 0.0f, 0.0f, 0.0f}, {0.0f, 0.0f, 0.0f, 0.0f}};
#pragma unroll
      for (int kk = 0; kk < DB / 16; ++kk) {
        if (kk < nk) {
          uint32_t a[4], bk[4];
          ldsm_x4(a, smem_u32(qs + ((lane & 7) + ((lane >> 3) & 1) * 8) * LD +
                              kk * 16 + (lane >> 4) * 8));
          ldsm_x4(bk, smem_u32(ks + ((lane & 7) + (lane >> 4) * 8) * LD +
                               kk * 16 + ((lane >> 3) & 1) * 8));
          mma_bf16(s[0], a, bk[0], bk[1]);
          mma_bf16(s[1], a, bk[2], bk[3]);
        }
      }

      // online softmax of rows gr (j = 0, 1) and gr + 8 (j = 2, 3)
      const int t0 = s_begin + tile * TK;
      float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const bool ok = t0 + n * 8 + tg * 2 + (j & 1) < s_end;
          const float x = I8 ? s[n][j] * sc[n * 8 + tg * 2 + (j & 1)]
                             : s[n][j];
          s[n][j] = ok ? capped<CAP>(x * scale, cap) : NEG_INF;
          mx[j >> 1] = fmaxf(mx[j >> 1], s[n][j]);
        }
      float corr[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(FULL, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(FULL, mx[r], 2));
        const float m_new = fmaxf(m_r[r], mx[r]);
        corr[r] = expf(m_r[r] - m_new);
        m_r[r] = m_new;
      }
      float sum[2] = {0.0f, 0.0f};
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          // rows 8-15 are padding when G <= 8: p = 0 there, no expf
          s[n][j] = j < 2 || G > 8 ? expf(s[n][j] - m_r[j >> 1]) : 0.0f;
          sum[j >> 1] += s[n][j];
        }
#pragma unroll
      for (int r = 0; r < 2; ++r) l_r[r] = l_r[r] * corr[r] + sum[r];
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[n][j] *= corr[j >> 1];

      // the int8 route weighs each key's p by its value scale
      if (I8)
#pragma unroll
        for (int n = 0; n < 2; ++n)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            s[n][j] *= sc[TK + n * 8 + tg * 2 + (j & 1)];

      // acc += p . v, p as three bf16 terms, the smallest first
      uint32_t ph[4], pm[4], pl[4];
      split3(s[0][0], s[0][1], ph[0], pm[0], pl[0]);
      split3(s[0][2], s[0][3], ph[1], pm[1], pl[1]);
      split3(s[1][0], s[1][1], ph[2], pm[2], pl[2]);
      split3(s[1][2], s[1][3], ph[3], pm[3], pl[3]);
#pragma unroll
      for (int dp = 0; dp < DB / 16; ++dp) {
        if (dp < nk) {
          uint32_t bv[4];
          ldsm_x4_trans(bv,
                        smem_u32(vs + ((lane & 7) + ((lane >> 3) & 1) * 8) *
                                          LD + dp * 16 + (lane >> 4) * 8));
          mma_bf16(acc[2 * dp], pl, bv[0], bv[1]);
          mma_bf16(acc[2 * dp], pm, bv[0], bv[1]);
          mma_bf16(acc[2 * dp], ph, bv[0], bv[1]);
          mma_bf16(acc[2 * dp + 1], pl, bv[2], bv[3]);
          mma_bf16(acc[2 * dp + 1], pm, bv[2], bv[3]);
          mma_bf16(acc[2 * dp + 1], ph, bv[2], bv[3]);
        }
      }
      __syncwarp();                     // the slot is read: refill it
      if (tile + NST < n_tiles) issue(tile + NST);
      cp_async_commit();
    }
    cp_async_wait<0>();
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l_r[r] += __shfl_xor_sync(FULL, l_r[r], 1);
      l_r[r] += __shfl_xor_sync(FULL, l_r[r], 2);
    }

    // straight from the fragments: rows gr and gr + 8, columns n * 8 + 2 tg
    const int64_t slot = bh * n_splits + split;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int g = gr + 8 * r;
      if (g >= G) continue;
#pragma unroll
      for (int n = 0; n < NT; ++n) {
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int d = n * 8 + tg * 2 + j;
          if (n < 2 * nk && d < D) {
            if (n_splits == 1)
              store(out + bh * GD + g * D + d,
                    acc[n][2 * r + j] / fmaxf(l_r[r], 1e-30f));
            else
              part_acc[slot * GD + g * D + d] = acc[n][2 * r + j];
          }
        }
      }
      if (n_splits > 1 && tg == 0) {
        part_ml[slot * 2 * G + g] = m_r[r];
        part_ml[slot * 2 * G + G + g] = l_r[r];
      }
      if (LSE && n_splits == 1 && tg == 0)
        lse[bh * G + g] = l_r[r] > 0.0f ? m_r[r] + logf(l_r[r]) : -INFINITY;
    }
  }
}

template <int DB, bool VEC, bool CAP, bool I8, bool LSE>
cudaError_t launch_tc(const bf16* q, const void* k, const void* v,
                      const int32_t* length, int B, int S, int Hkv, int G,
                      int D, int chunk, int n_splits, float scale, float cap,
                      float* part_acc, float* part_ml, void* out, float* lse,
                      const float* k_scale, const float* v_scale,
                      cudaStream_t stream) {
  typedef typename std::conditional<I8, int8_t, bf16>::type KV;
  typedef typename std::conditional<LSE, float, bf16>::type OT;
  constexpr int NST = ring_depth(DB);
  // once per instantiation: allow the bucket's largest block (D = 256
  // needs 57 KB) and prefer shared memory over L1
  static const cudaError_t attr = [] {
    cudaError_t e = cudaFuncSetAttribute(
        flash_decode_tc<DB, VEC, CAP, I8, LSE>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        I8 ? (int)tc_smem_i8(DB + ROW_PAD, DB, NST)
           : (int)tc_smem(DB + ROW_PAD, NST));
    if (e != cudaSuccess) return e;
    return cudaFuncSetAttribute(flash_decode_tc<DB, VEC, CAP, I8, LSE>,
                                cudaFuncAttributePreferredSharedMemoryCarveout,
                                (int)cudaSharedmemCarveoutMaxShared);
  }();
  if (attr != cudaSuccess) return attr;
  // about as many blocks as the card holds at once (n_blocks per row, each
  // walking its row's chunks): the chunks past length cost no block
  static const int resident = [] {
    int dev = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, flash_decode_tc<DB, VEC, CAP, I8, LSE>, 32,
        I8 ? tc_smem_i8(DB + ROW_PAD, DB, NST) : tc_smem(DB + ROW_PAD, NST));
    return sms * (per_sm > 0 ? per_sm : 1);
  }();
  const int64_t rows = (int64_t)B * Hkv;
  const int n_blocks = (int)std::min<int64_t>(
      n_splits, std::max<int64_t>(1, (resident + rows - 1) / rows));
  const int DP = (D + 15) & ~15, LD = DP + ROW_PAD;
  const dim3 grid((unsigned)n_blocks, (unsigned)Hkv, (unsigned)B);
  flash_decode_tc<DB, VEC, CAP, I8, LSE>
      <<<grid, 32, I8 ? tc_smem_i8(LD, DP, NST) : tc_smem(LD, NST), stream>>>(
          q, static_cast<const KV*>(k), static_cast<const KV*>(v), length, S,
          Hkv, G, D, chunk, n_splits, scale, cap, part_acc, part_ml,
          static_cast<OT*>(out), lse, k_scale, v_scale);
  return cudaGetLastError();
}

template <bool VEC, bool CAP, bool I8, bool LSE>
cudaError_t launch_tc_d(const bf16* q, const void* k, const void* v,
                        const int32_t* length, int B, int S, int Hkv, int G,
                        int D, int chunk, int n_splits, float scale,
                        float cap, float* part_acc, float* part_ml, void* out,
                        float* lse, const float* k_scale, const float* v_scale,
                        cudaStream_t stream) {
  const int DP = (D + 15) & ~15;
  if (DP <= 64)
    return launch_tc<64, VEC, CAP, I8, LSE>(
        q, k, v, length, B, S, Hkv, G, D, chunk, n_splits, scale, cap,
        part_acc, part_ml, out, lse, k_scale, v_scale, stream);
  if (DP <= 128)
    return launch_tc<128, VEC, CAP, I8, LSE>(
        q, k, v, length, B, S, Hkv, G, D, chunk, n_splits, scale, cap,
        part_acc, part_ml, out, lse, k_scale, v_scale, stream);
  return launch_tc<256, VEC, CAP, I8, LSE>(
      q, k, v, length, B, S, Hkv, G, D, chunk, n_splits, scale, cap,
      part_acc, part_ml, out, lse, k_scale, v_scale, stream);
}

template <bool VEC, bool I8, bool LSE = false>
cudaError_t launch_tc_cap(const bf16* q, const void* k, const void* v,
                          const int32_t* length, int B, int S, int Hkv, int G,
                          int D, int chunk, int n_splits, float scale,
                          float cap, float* part_acc, float* part_ml,
                          void* out, const float* k_scale,
                          const float* v_scale, cudaStream_t stream,
                          float* lse = nullptr) {
  return cap > 0.0f
             ? launch_tc_d<VEC, true, I8, LSE>(q, k, v, length, B, S, Hkv, G,
                                               D, chunk, n_splits, scale, cap,
                                               part_acc, part_ml, out, lse,
                                               k_scale, v_scale, stream)
             : launch_tc_d<VEC, false, I8, LSE>(q, k, v, length, B, S, Hkv,
                                                G, D, chunk, n_splits, scale,
                                                cap, part_acc, part_ml, out,
                                                lse, k_scale, v_scale,
                                                stream);
}

// ---------------------------------------------------------------------------
// float32 route (CUDA cores)
// ---------------------------------------------------------------------------

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_OUT = MAX_GD / THREADS;   // (g, d) outputs per thread

// Rows r < n of one kv head, starting at element `off` of src, rows
// `stride` elements apart, into dst (row r at dst + r * ld).
template <bool VEC>
__device__ __forceinline__ void load_rows(const float* __restrict__ src,
                                          int64_t off, int64_t stride, int n,
                                          int D, float* dst, int ld) {
  if (VEC) {
    const int per_row = D / 4;
    for (int e = threadIdx.x; e < n * per_row; e += THREADS) {
      const int r = e / per_row, c = (e - r * per_row) * 4;
      const float4 x =
          *reinterpret_cast<const float4*>(src + off + r * stride + c);
      float* o = dst + r * ld + c;
      o[0] = x.x;
      o[1] = x.y;
      o[2] = x.z;
      o[3] = x.w;
    }
  } else {
    for (int e = threadIdx.x; e < n * D; e += THREADS) {
      const int r = e / D, c = e - r * D;
      dst[r * ld + c] = src[off + r * stride + c];
    }
  }
}

// grid (n_splits, Hkv, B).  n_splits == 1: writes out; otherwise the
// chunk's acc (G * D floats) to part_acc and its m, l (G floats each) to
// part_ml, at slot (b * Hkv + h) * n_splits + split.  Per tile of TS keys
// (64 for D <= 64, 32 for D <= 128, 16 up to 256): all threads load the K
// and V rows, compute the G x TS scores from shared memory (K rows padded
// by one float: no bank conflicts), one warp per query updates m and l and
// turns the scores into p, then each thread updates its (g, d) accumulators.
// CAP: the scaled scores go through the softcap `cap`.
template <bool VEC, bool CAP>
__global__ void __launch_bounds__(THREADS)
flash_decode_f32(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v,
                 const int32_t* __restrict__ length, int S, int Hkv, int G,
                 int D, int TS, int chunk, int n_splits, float scale,
                 float cap, float* __restrict__ part_acc,
                 float* __restrict__ part_ml,
                 float* __restrict__ out) {
  extern __shared__ float smem[];
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
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
  // an idle chunk writes nothing (the first runs, so that length 0 gives 0)
  if (split > 0 && s_begin >= len) return;
  const int s_end = min(s_begin + chunk, len);
  const int64_t bh = (int64_t)b * Hkv + h;

  for (int e = tid; e < GD; e += THREADS) qs[e] = q[bh * GD + e];
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
    load_rows<VEC>(k, off, stride, n, D, ks, D + 1);
    load_rows<VEC>(v, off, stride, n, D, vs, D);
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
        s = capped<CAP>(dot * scale, cap);
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
      if (e < GD) out[bh * GD + e] = acc[i] / fmaxf(l_s[e / D], 1e-30f);
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

template <bool CAP>
cudaError_t launch_f32(const float* q, const float* k, const float* v,
                       const int32_t* length, int B, int S, int Hkv, int G,
                       int D, int chunk, int n_splits, float scale, float cap,
                       float* part_acc, float* part_ml, float* out,
                       cudaStream_t stream) {
  const int TS = D <= 64 ? 64 : (D <= 128 ? 32 : 16);
  const size_t smem =
      sizeof(float) * ((size_t)G * D + (size_t)TS * (D + 1) + (size_t)TS * D +
                       (size_t)G * TS + 3 * (size_t)G);
  const bool vec = D % 4 == 0 && ((uintptr_t)k & 15) == 0 &&
                   ((uintptr_t)v & 15) == 0;
  const dim3 grid((unsigned)n_splits, (unsigned)Hkv, (unsigned)B);
  if (vec)
    flash_decode_f32<true, CAP><<<grid, THREADS, smem, stream>>>(
        q, k, v, length, S, Hkv, G, D, TS, chunk, n_splits, scale, cap,
        part_acc, part_ml, out);
  else
    flash_decode_f32<false, CAP><<<grid, THREADS, smem, stream>>>(
        q, k, v, length, S, Hkv, G, D, TS, chunk, n_splits, scale, cap,
        part_acc, part_ml, out);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// merge of the chunks (both routes)
// ---------------------------------------------------------------------------

constexpr int MERGE_LANES = 8;   // lanes per output element
constexpr int MERGE_BATCH = 8;   // partials a lane loads at once

// grid (ceil(G * D * MERGE_LANES / THREADS), Hkv, B): MERGE_LANES adjacent
// lanes per output element e of (b, h).  The element's ceil(length[b] /
// chunk) valid chunk partials, lane j taking chunks j, j + MERGE_LANES, ...
// in order; M = their largest m, then each lane's sums of l exp(m - M) and
// acc exp(m - M), added across the lanes in a fixed tree.  A lane's first
// MERGE_BATCH chunks are loaded at once (all of them up to 64 chunks).
// Launched as a programmatic dependent of the split kernel: it reads the
// length, then waits for the split grid (griddepcontrol.wait) before it
// reads a partial.  LSE: the element's first lane group of each query
// (d == 0) also writes the row's log-sum-exp M + log(L) to lse (-inf
// where the row reads no key).
template <typename T, bool LSE>
__global__ void __launch_bounds__(THREADS)
flash_decode_merge(const float* __restrict__ part_acc,
                   const float* __restrict__ part_ml,
                   const int32_t* __restrict__ length, int S, int G, int D,
                   int chunk, int n_splits, T* __restrict__ out,
                   float* __restrict__ lse) {
  const int b = blockIdx.z;
  const int64_t bh = (int64_t)b * gridDim.y + blockIdx.y;
  const int GD = G * D;
  const int i = blockIdx.x * THREADS + threadIdx.x;
  const int e = i / MERGE_LANES, j = i % MERGE_LANES;
  const bool live = e < GD;   // a lane group shares one element
  const int g = live ? e / D : 0;
  int len = length[b];
  len = len < 0 ? 0 : (len > S ? S : len);
  const int nv = live ? min(n_splits, (len + chunk - 1) / chunk) : 0;
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  const float* ml = part_ml + bh * n_splits * 2 * G + g;   // m at s * 2G
  const float* acc = part_acc + bh * n_splits * GD + e;    // at s * GD
  float mv[MERGE_BATCH], lv[MERGE_BATCH], av[MERGE_BATCH];
  float m = NEG_INF;
#pragma unroll
  for (int t = 0; t < MERGE_BATCH; ++t) {
    const int s = j + MERGE_LANES * t;
    const bool ok = s < nv;
    mv[t] = ok ? ml[s * 2 * G] : NEG_INF;
    lv[t] = ok ? ml[s * 2 * G + G] : 0.0f;
    av[t] = ok ? acc[(int64_t)s * GD] : 0.0f;
    m = fmaxf(m, mv[t]);
  }
  for (int s = j + MERGE_LANES * MERGE_BATCH; s < nv; s += MERGE_LANES)
    m = fmaxf(m, ml[s * 2 * G]);
#pragma unroll
  for (int o = 1; o < MERGE_LANES; o <<= 1)
    m = fmaxf(m, __shfl_xor_sync(FULL, m, o));
  float l = 0.0f, a = 0.0f;
#pragma unroll
  for (int t = 0; t < MERGE_BATCH; ++t) {
    if (j + MERGE_LANES * t < nv) {
      const float w = expf(mv[t] - m);
      l += lv[t] * w;
      a += av[t] * w;
    }
  }
  for (int s = j + MERGE_LANES * MERGE_BATCH; s < nv; s += MERGE_LANES) {
    const float w = expf(ml[s * 2 * G] - m);
    l += ml[s * 2 * G + G] * w;
    a += acc[(int64_t)s * GD] * w;
  }
#pragma unroll
  for (int o = 1; o < MERGE_LANES; o <<= 1) {
    l += __shfl_xor_sync(FULL, l, o);
    a += __shfl_xor_sync(FULL, a, o);
  }
  if (live && j == 0) {
    store(out + bh * GD + e, a / fmaxf(l, 1e-30f));
    if (LSE && e - g * D == 0)
      lse[bh * G + g] = l > 0.0f ? m + logf(l) : -INFINITY;
  }
}

}  // namespace

extern "C" {

// Returns a cudaError_t: 0 when the launches were accepted.  q (B, Hkv, G,
// D), k and v (B, S, Hkv, D), out (B, Hkv, G, D): float32 when is_f32 is
// nonzero, else bf16; length (B,) int32; softcap > 0 caps the scaled
// scores (cap * tanh(s / cap)), 0 means none.  k_scale and v_scale, both
// null or both (B, S, Hkv) float32: with them k and v are int8 (the int8
// route, bf16 q and out only).  With n_splits > 1, part_acc
// holds B * Hkv * n_splits * G * D floats and part_ml B * Hkv * n_splits *
// 2 * G; chunk * n_splits positions are covered.  The bf16 route needs
// chunk % 16 == 0 (whole tiles of keys).
// lse, null for none: the log-sum-exp route, for a cache split along the
// sequence across ranks (bf16 q over a bf16 or int8 cache): out is then
// float32, normalised by the row's own sum, and lse (B, Hkv, G) float32
// gets each row's log-sum-exp, so that the ranks' rows merge exactly: M =
// max lse_r, out = sum_r exp(lse_r - M) out_r / sum_r exp(lse_r - M).  A
// row of length 0 gives out 0 and lse -inf.  It needs 16-byte copies (D %
// 8 == 0, or % 16 with int8; q, k, v 16-byte aligned).
int flash_decode(const void* q, const void* k, const void* v,
                 const int32_t* length, int B, int S, int Hkv, int G, int D,
                 int is_f32, int chunk, int n_splits, float softcap,
                 const float* k_scale, const float* v_scale,
                 float* part_acc, float* part_ml, void* out, float* lse,
                 void* stream) {
  const bool i8 = k_scale != nullptr;
  // 16-byte copies: the bf16 route's rows need D % 8 == 0, the int8
  // route's D % 16 == 0 (and its q rows D % 8 == 0)
  const bool vec = !is_f32 && D % (i8 ? 16 : 8) == 0 &&
                   ((uintptr_t)q & 15) == 0 && ((uintptr_t)k & 15) == 0 &&
                   ((uintptr_t)v & 15) == 0;
  if ((k_scale == nullptr) != (v_scale == nullptr) || (i8 && is_f32) ||
      (lse != nullptr && !vec))
    return (int)cudaErrorInvalidValue;
  if (B < 1 || B > 65535 || S < 1 || Hkv < 1 || Hkv > 65535 || G < 1 ||
      G > MAX_G || D < 1 || D > MAX_D || G * D > MAX_GD || chunk < 1 ||
      n_splits < 1 || (!is_f32 && chunk % TK != 0) ||
      !(softcap >= 0.0f && softcap <= 3.0e38f) ||   // NaN, < 0 or inf
      (n_splits > 1 && (part_acc == nullptr || part_ml == nullptr)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const float scale = (float)(1.0 / sqrt((double)D));
  cudaError_t err;
  if (is_f32) {
    const float *qf = static_cast<const float*>(q),
                *kf = static_cast<const float*>(k),
                *vf = static_cast<const float*>(v);
    err = softcap > 0.0f
              ? launch_f32<true>(qf, kf, vf, length, B, S, Hkv, G, D, chunk,
                                 n_splits, scale, softcap, part_acc, part_ml,
                                 static_cast<float*>(out), s)
              : launch_f32<false>(qf, kf, vf, length, B, S, Hkv, G, D, chunk,
                                  n_splits, scale, softcap, part_acc, part_ml,
                                  static_cast<float*>(out), s);
  } else {
    const bf16* qb = static_cast<const bf16*>(q);
    if (lse != nullptr)
      err = i8 ? launch_tc_cap<true, true, true>(qb, k, v, length, B, S, Hkv,
                                                 G, D, chunk, n_splits, scale,
                                                 softcap, part_acc, part_ml,
                                                 out, k_scale, v_scale, s,
                                                 lse)
               : launch_tc_cap<true, false, true>(qb, k, v, length, B, S, Hkv,
                                                  G, D, chunk, n_splits,
                                                  scale, softcap, part_acc,
                                                  part_ml, out, nullptr,
                                                  nullptr, s, lse);
    else if (i8)
      err = vec ? launch_tc_cap<true, true>(qb, k, v, length, B, S, Hkv, G,
                                            D, chunk, n_splits, scale,
                                            softcap, part_acc, part_ml, out,
                                            k_scale, v_scale, s)
                : launch_tc_cap<false, true>(qb, k, v, length, B, S, Hkv, G,
                                             D, chunk, n_splits, scale,
                                             softcap, part_acc, part_ml, out,
                                             k_scale, v_scale, s);
    else
      err = vec ? launch_tc_cap<true, false>(qb, k, v, length, B, S, Hkv, G,
                                             D, chunk, n_splits, scale,
                                             softcap, part_acc, part_ml, out,
                                             nullptr, nullptr, s)
                : launch_tc_cap<false, false>(qb, k, v, length, B, S, Hkv, G,
                                              D, chunk, n_splits, scale,
                                              softcap, part_acc, part_ml, out,
                                              nullptr, nullptr, s);
  }
  if (err != cudaSuccess || n_splits == 1) return (int)err;
  const unsigned blocks = (unsigned)((G * D * MERGE_LANES + THREADS - 1) /
                                     THREADS);
  cudaLaunchAttribute pdl[1];
  pdl[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  pdl[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks, (unsigned)Hkv, (unsigned)B);
  cfg.blockDim = dim3(THREADS);
  cfg.stream = s;
  cfg.attrs = pdl;
  cfg.numAttrs = 1;
  if (lse != nullptr)
    err = cudaLaunchKernelEx(&cfg, flash_decode_merge<float, true>, part_acc,
                             part_ml, length, S, G, D, chunk, n_splits,
                             static_cast<float*>(out), lse);
  else if (is_f32)
    err = cudaLaunchKernelEx(&cfg, flash_decode_merge<float, false>,
                             part_acc, part_ml, length, S, G, D, chunk,
                             n_splits, static_cast<float*>(out),
                             (float*)nullptr);
  else
    err = cudaLaunchKernelEx(&cfg, flash_decode_merge<bf16, false>, part_acc,
                             part_ml, length, S, G, D, chunk, n_splits,
                             static_cast<bf16*>(out), (float*)nullptr);
  return (int)(err != cudaSuccess ? err : cudaGetLastError());
}

}  // extern "C"
