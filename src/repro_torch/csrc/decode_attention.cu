// Single-query decode attention against a KV cache, for Hopper (sm_90a):
// the cache axis split across blocks, the splits merged in the same launch.
//
// Replaces the TPU kernel src/repro/kernels/decode_attention/kernel.py::
// decode_attention_bhd (body _decode_kernel): one query row per (b, h)
// against caches (B, Hkv, T, hd), masked to positions
// [max(0, length - window), min(length, T)) with `length` read on the
// device, online softmax in f32, output in the input dtype (0 where no
// position is live).
//
// What bounds it: bytes.  A call reads the live part of the K and V cache
// once (2 * B * Hkv * len * hd * sizeof(T)) and does 4 flops per element
// pair of it, far below the ~295 flops/byte at which an H100 stops being
// memory-bound.  At serving shapes B * Hkv is small (40 at SmolLM-360M's
// 8 slots), so one block per (b, kv head) walking the cache leaves most
// of the 132 SMs idle and every tile waits a full memory latency.
//
// Design (flash-decoding in one launch):
// - Grid (units, splits).  A unit is (b, kv head, group of up to RG q
//   heads): the block handles the q heads that share its kv head
//   together, so each K/V row is read once for all of them (RG is 8 in
//   bf16, and 1, 2, 4 or 8 in f32: ops.py::heads_per_block).  The host
//   picks `splits` from the shapes only (ops.py::num_splits: enough
//   blocks that their rings keep about 96 KB of loads in flight an SM, no
//   split under 320 rows of T), never from `length`, so nothing syncs with
//   the host.
// - Each block reads `length`, computes the live range, cuts it into
//   tiles of BT rows (ref.py::split_tile) and takes its 1/splits share of
//   the tiles, so work is balanced at any length.  An empty share gives an
//   empty partial (m = -inf, l = 0).
// - Tiles reach shared memory through a cp.async ring (16-byte copies,
//   neighbouring threads on neighbouring addresses, rows past the range
//   zero-filled), so the next tiles load while one is computed.
// - bf16 (Mma below): tensor cores.  Each warp owns 16 rows of a 64-row
//   tile; S = q K^T and O += P V by mma.sync m16n8k16 with f32
//   accumulators, the online softmax on the S fragments in registers.
// - f32 (Simt below): a row is read by LPR lanes, 16 bytes each; q lives
//   in registers and each row's dot products are reduced by xor shuffles
//   inside its lane group; every lane group is an online-softmax stream.
//   (TF32 would lose the f32 tolerance, so f32 stays off the tensor cores.)
// - The block's streams (warps or lane groups) merge through shared
//   memory.  Then, in the same launch, the block writes its partial (m, l,
//   acc [RG][hd], f32) to a workspace and takes a ticket from an atomic
//   counter per unit after a __threadfence; the last block of the unit
//   merges the splits by log-sum-exp in an order fixed by split index
//   (never ticket order, so results repeat bit for bit), with independent
//   loads so that the merge costs a few memory round trips, writes o and
//   resets the counter to 0.
//   With one split the block writes o directly.
// - A max that is still -inf subtracts 0, so empty streams and splits give
//   weight 0 instead of exp(-inf - -inf) = NaN.
// The workspace and counters come from the caller, which must not share
// them between calls running concurrently on two streams.  The dynamic
// shared memory limit is raised once per instantiation and device, never
// per launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

using bf16 = __nv_bfloat16;

constexpr int THREADS = 128;
constexpr int NWARPS = THREADS / 32;
constexpr int TILE_BYTES = 4096;   // of K per tile of the f32 ring
constexpr float LOG2E = 1.4426950408889634f;

constexpr int pow2ceil(int x) { return x <= 1 ? 1 : 2 * pow2ceil((x + 1) / 2); }
constexpr int pow2floor(int x) { return x < 2 ? 1 : 2 * pow2floor(x / 2); }
constexpr int cmax(int a, int b) { return a > b ? a : b; }

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
// 16 bytes from src, or 16 zero bytes when !valid (src is not read then)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
__device__ __forceinline__ void ldsm_x4(uint32_t* r, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p))
      : "memory");
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t* r, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p))
      : "memory");
}
// d (16 x 8, f32) += a (16 x 16, bf16) * b (16 x 8, bf16)
__device__ __forceinline__ void mma16816(float* d, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x = lo, low bits
  return *reinterpret_cast<uint32_t*>(&v);
}

// 16 bytes at p (16-byte aligned)
__device__ __forceinline__ void load16(const float* p, float* out) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  out[0] = v.x;
  out[1] = v.y;
  out[2] = v.z;
  out[3] = v.w;
}

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ bf16 from_f(float x) {
  return __float2bfloat16(x);
}

// What a block streams: its tiles [t_begin, t_end) of BT rows from
// `start`, the live range ending at `end`.
template <typename T> struct Range {
  const T* kb;
  const T* vb;
  int start, end, t_begin, t_end;
};

// Copy tile t's K and V rows into a stage whose rows are LD elements
// apart; rows past `end` are zero-filled, so no stale value reaches a
// product.
template <typename T, int HD, int BT, int LD>
__device__ __forceinline__ void issue_tile(T* sk, const Range<T>& R, int t) {
  constexpr int NCH = HD * (int)sizeof(T) / 16;
  constexpr int VEC = 16 / sizeof(T);
  T* sv = sk + BT * LD;
  const int r0 = R.start + t * BT, nrow = min(BT, R.end - r0);
  for (int i = threadIdx.x; i < BT * NCH; i += THREADS) {
    const int row = i / NCH, ch = i - row * NCH;
    const bool ok = row < nrow;
    const size_t src = (size_t)(r0 + (ok ? row : 0)) * HD + ch * VEC;
    cp_async16(sk + row * LD + ch * VEC, R.kb + src, ok);
    cp_async16(sv + row * LD + ch * VEC, R.vb + src, ok);
  }
}

// The f32 path: SIMT.  A row is read by LPR lanes, 16 bytes each; q of
// the RG heads lives in registers, pre-scaled by scale * log2(e); each
// row's dot products are reduced by xor shuffles inside its lane group.
// Every group of lanes is an online-softmax stream (max, sum, f32
// accumulator in registers; rescaled once per tile).
template <int HD, int RG> struct Simt {
  using T = float;
  static constexpr int VEC = 16 / sizeof(T);    // elements per 16 bytes
  static constexpr int NCH = HD / VEC;          // 16-byte chunks per row
  static constexpr int LPR = NCH >= 32 ? 32 : pow2ceil(NCH);  // lanes a row
  static constexpr int CPL = (NCH + LPR - 1) / LPR;  // chunks a lane
  static constexpr int RPW = 32 / LPR;          // rows a warp reads at once
  static constexpr int NSTREAM = NWARPS * RPW;  // online-softmax streams
  static constexpr int ROWB = HD * (int)sizeof(T);
  static constexpr int BT = pow2floor(TILE_BYTES / ROWB);  // rows a tile
  static constexpr int NRS = BT / NSTREAM;      // rows a stream, per tile
  static constexpr int NST = 4;                 // stages of the ring
  static constexpr int STAGE = 2 * BT * HD;     // elements: K and V
  static constexpr int SMEM = cmax(NST * STAGE * (int)sizeof(T),
                                   4 * NSTREAM * RG * (HD + 2));
  static_assert(NCH * VEC == HD, "head dim is a multiple of 16 bytes");
  static_assert(NRS >= 1, "a tile gives each stream a row");

  // Streams the block's tiles; leaves each stream's (m, l, acc) in the
  // merge area sm [NSTREAM][RG], sl [NSTREAM][RG], sa [NSTREAM][RG][HD].
  __device__ static void run(unsigned char* smem, const T* qh, int nh,
                             const Range<T>& R, float scale_log2) {
    constexpr int E = CPL * VEC;  // floats a lane holds of a row
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int sub = lane / LPR, j = lane % LPR;
    const int stream = warp * RPW + sub;
    float m[RG], l[RG], acc[RG][E], qr[RG][E];
#pragma unroll
    for (int r = 0; r < RG; ++r) {
      m[r] = -INFINITY;
      l[r] = 0.f;
#pragma unroll
      for (int c = 0; c < CPL; ++c) {
        const int ch = j + c * LPR;
        float* dst = &qr[r][c * VEC];
        if (r < nh && ch < NCH) {
          load16(qh + r * HD + ch * VEC, dst);
#pragma unroll
          for (int e = 0; e < VEC; ++e) dst[e] *= scale_log2;
        } else {
#pragma unroll
          for (int e = 0; e < VEC; ++e) dst[e] = 0.f;
        }
#pragma unroll
        for (int e = 0; e < VEC; ++e) acc[r][c * VEC + e] = 0.f;
      }
    }

    T* const ring = reinterpret_cast<T*>(smem);
    auto issue = [&](int t) {
      if (t < R.t_end)
        issue_tile<T, HD, BT, HD>(ring + ((t - R.t_begin) % NST) * STAGE, R,
                                  t);
      cp_async_commit();  // empty groups keep the wait counts uniform
    };
    if (R.t_begin < R.t_end) {
#pragma unroll
      for (int s = 0; s < NST - 1; ++s) issue(R.t_begin + s);
      for (int t = R.t_begin; t < R.t_end; ++t) {
        cp_async_wait<NST - 2>();
        __syncthreads();  // tile t landed; tile t - 1's stage is free
        issue(t + NST - 1);
        const T* sk = ring + ((t - R.t_begin) % NST) * STAGE;
        const T* sv = sk + BT * HD;
        const int nrow = min(BT, R.end - (R.start + t * BT));

        float s[NRS][RG];
#pragma unroll
        for (int i = 0; i < NRS; ++i) {
          const int row = (i * NWARPS + warp) * RPW + sub;
          float kf[E];
#pragma unroll
          for (int c = 0; c < CPL; ++c) {
            const int ch = j + c * LPR;
            if (ch < NCH) {
              load16(sk + row * HD + ch * VEC, &kf[c * VEC]);
            } else {
#pragma unroll
              for (int e = 0; e < VEC; ++e) kf[c * VEC + e] = 0.f;
            }
          }
#pragma unroll
          for (int r = 0; r < RG; ++r) {
            float d = 0.f;
#pragma unroll
            for (int e = 0; e < E; ++e) d = fmaf(qr[r][e], kf[e], d);
#pragma unroll
            for (int off = LPR / 2; off > 0; off >>= 1)
              d += __shfl_xor_sync(0xffffffffu, d, off);
            s[i][r] = row < nrow ? d : -INFINITY;
          }
        }
#pragma unroll
        for (int r = 0; r < RG; ++r) {
          float mx = m[r];
#pragma unroll
          for (int i = 0; i < NRS; ++i) mx = fmaxf(mx, s[i][r]);
          const float mu = mx == -INFINITY ? 0.f : mx;
          const float corr = exp2f(m[r] - mu);
          m[r] = mx;
          l[r] *= corr;
#pragma unroll
          for (int e = 0; e < E; ++e) acc[r][e] *= corr;
#pragma unroll
          for (int i = 0; i < NRS; ++i) {
            s[i][r] = exp2f(s[i][r] - mu);  // now p; 0 for masked rows
            l[r] += s[i][r];
          }
        }
#pragma unroll
        for (int i = 0; i < NRS; ++i) {
          const int row = (i * NWARPS + warp) * RPW + sub;
#pragma unroll
          for (int c = 0; c < CPL; ++c) {
            const int ch = j + c * LPR;
            if (ch < NCH) {
              float vf[VEC];
              load16(sv + row * HD + ch * VEC, vf);  // zero past `end`
#pragma unroll
              for (int r = 0; r < RG; ++r)
#pragma unroll
                for (int e = 0; e < VEC; ++e)
                  acc[r][c * VEC + e] = fmaf(s[i][r], vf[e],
                                             acc[r][c * VEC + e]);
            }
          }
        }
      }
      cp_async_wait<0>();
    }
    __syncthreads();  // the ring is now the merge area

    float* sm = reinterpret_cast<float*>(smem);
    float* sl = sm + NSTREAM * RG;
    float* sa = sl + NSTREAM * RG;
    if (j == 0) {
#pragma unroll
      for (int r = 0; r < RG; ++r) {
        sm[stream * RG + r] = m[r];
        sl[stream * RG + r] = l[r];
      }
    }
#pragma unroll
    for (int r = 0; r < RG; ++r)
#pragma unroll
      for (int c = 0; c < CPL; ++c) {
        const int ch = j + c * LPR;
        if (ch < NCH) {
          float* dst = sa + (stream * RG + r) * HD + ch * VEC;
#pragma unroll
          for (int e = 0; e < VEC; e += 4)
            *reinterpret_cast<float4*>(dst + e) =
                make_float4(acc[r][c * VEC + e], acc[r][c * VEC + e + 1],
                            acc[r][c * VEC + e + 2], acc[r][c * VEC + e + 3]);
        }
      }
  }
};

// The bf16 path: tensor cores (mma.sync m16n8k16, bf16 in, f32
// accumulate).  A block takes 8 q heads (rows 8..15 of the m16 operand are
// zero); each warp owns 16 rows of every 64-row tile and is one
// online-softmax stream: S = q K^T (two n8 tiles over hd / 16 k-steps, K
// by ldmatrix), masked and scaled in f32, row max over the quad by two
// shuffles, then O += P V with P packed from the S accumulators into the
// A fragment (rounded to bf16, as a tensor-core flash kernel does; the
// sums l are taken from the f32 p) and V by ldmatrix.trans.  Rows are
// padded by 16 bytes in shared memory so ldmatrix's eight row addresses
// fall in distinct banks.
template <int HD> struct Mma {
  static constexpr int BT = 16 * NWARPS;  // rows a tile
  static constexpr int LD = HD + 8;       // shared row, in elements
  static constexpr int NST = HD > 128 ? 2 : 3;
  static constexpr int NSTREAM = NWARPS;
  static constexpr int STAGE = 2 * BT * LD;  // elements: K and V
  static constexpr int SMEM = cmax(NST * STAGE * 2, 4 * NSTREAM * 8 * (HD + 2));
  static_assert(HD % 16 == 0, "head dim is a multiple of 16");

  __device__ static void run(unsigned char* smem, const bf16* qh, int nh,
                             const Range<bf16>& R, float scale_log2) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int g = lane >> 2, c = lane & 3;
    // q as the A operand, rows 0..7 (head g): k pairs 2c and 2c + 8
    uint32_t qa[HD / 16][2];
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      qa[kk][0] = qa[kk][1] = 0u;  // heads past nh: zero rows
      if (g < nh) {
        const uint32_t* qp =
            reinterpret_cast<const uint32_t*>(qh + g * HD + 16 * kk + 2 * c);
        qa[kk][0] = qp[0];
        qa[kk][1] = qp[4];
      }
    }
    float o[HD / 8][4];
#pragma unroll
    for (int u = 0; u < HD / 8; ++u)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[u][e] = 0.f;
    float m = -INFINITY, l = 0.f;  // head g's, l partial over the quad

    bf16* const ring = reinterpret_cast<bf16*>(smem);
    auto issue = [&](int t) {
      if (t < R.t_end)
        issue_tile<bf16, HD, BT, LD>(ring + ((t - R.t_begin) % NST) * STAGE,
                                     R, t);
      cp_async_commit();
    };
    if (R.t_begin < R.t_end) {
#pragma unroll
      for (int s = 0; s < NST - 1; ++s) issue(R.t_begin + s);
      for (int t = R.t_begin; t < R.t_end; ++t) {
        cp_async_wait<NST - 2>();
        __syncthreads();
        issue(t + NST - 1);
        const bf16* sk = ring + ((t - R.t_begin) % NST) * STAGE + 16 * warp * LD;
        const bf16* sv = sk + BT * LD;
        const int nrow = min(BT, R.end - (R.start + t * BT)) - 16 * warp;

        float s[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
        for (int kk = 0; kk < HD / 16; ++kk) {
          uint32_t bk[4];
          ldsm_x4(bk, sk + ((lane & 7) + (lane >> 4) * 8) * LD + 16 * kk +
                          ((lane >> 3) & 1) * 8);
          const uint32_t a[4] = {qa[kk][0], 0u, qa[kk][1], 0u};
          mma16816(s[0], a, bk[0], bk[1]);
          mma16816(s[1], a, bk[2], bk[3]);
        }
        // s[t2][e]: head g, warp row 8 t2 + 2c + e (e < 2)
        float mx = m;
#pragma unroll
        for (int t2 = 0; t2 < 2; ++t2)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float v = 8 * t2 + 2 * c + e < nrow ? s[t2][e] * scale_log2
                                                      : -INFINITY;
            s[t2][e] = v;
            mx = fmaxf(mx, v);
          }
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float mu = mx == -INFINITY ? 0.f : mx;
        const float corr = exp2f(m - mu);
        m = mx;
        l *= corr;
#pragma unroll
        for (int u = 0; u < HD / 8; ++u) {
          o[u][0] *= corr;
          o[u][1] *= corr;
        }
        float p[2][2];
#pragma unroll
        for (int t2 = 0; t2 < 2; ++t2)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            p[t2][e] = exp2f(s[t2][e] - mu);
            l += p[t2][e];
          }
        const uint32_t pa[4] = {pack_bf16(p[0][0], p[0][1]), 0u,
                                pack_bf16(p[1][0], p[1][1]), 0u};
#pragma unroll
        for (int u = 0; u < HD / 16; ++u) {
          uint32_t bv[4];
          ldsm_x4_t(bv, sv + ((lane & 7) + ((lane >> 3) & 1) * 8) * LD +
                            16 * u + (lane >> 4) * 8);
          mma16816(o[2 * u], pa, bv[0], bv[1]);
          mma16816(o[2 * u + 1], pa, bv[2], bv[3]);
        }
      }
      cp_async_wait<0>();
    }
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    __syncthreads();  // the ring is now the merge area

    float* sm = reinterpret_cast<float*>(smem);
    float* sl = sm + NSTREAM * 8;
    float* sa = sl + NSTREAM * 8;
    if (c == 0) {
      sm[warp * 8 + g] = m;
      sl[warp * 8 + g] = l;
    }
#pragma unroll
    for (int u = 0; u < HD / 8; ++u)
      *reinterpret_cast<float2*>(sa + (warp * 8 + g) * HD + 8 * u + 2 * c) =
          make_float2(o[u][0], o[u][1]);
  }
};

template <typename T, int HD, int RG> struct Path;
template <int HD, int RG> struct Path<float, HD, RG> {
  using type = Simt<HD, RG>;
};
template <int HD> struct Path<bf16, HD, 8> { using type = Mma<HD>; };

// The last block of a unit: o = sum_sp exp2(m_sp - M) acc_sp / L over the
// unit's splits.  First each row's max M and sum L, a warp a row and its
// lanes on splits; then 4 elements a thread, the splits in order.  Neither
// pass chains one load on another, so the merge costs a few memory round
// trips, not one per split and element.
template <typename T, int HD, int RG>
__device__ __noinline__ void merge_splits(const float* ws_ml,
                                          const float* ws_acc, T* o,
                                          size_t first, int splits, int nh) {
  __shared__ float s_mu[RG], s_inv[RG];
  const int tid = threadIdx.x, lane = tid & 31;
  for (int r = tid >> 5; r < nh; r += NWARPS) {
    float M = -INFINITY;
    for (int sp = lane; sp < splits; sp += 32)
      M = fmaxf(M, __ldcg(ws_ml + (first + sp) * 2 * RG + r));
#pragma unroll
    for (int off = 16; off; off >>= 1)
      M = fmaxf(M, __shfl_xor_sync(0xffffffffu, M, off));
    const float mu = M == -INFINITY ? 0.f : M;
    float L = 0.f;
    for (int sp = lane; sp < splits; sp += 32) {
      const float ms = __ldcg(ws_ml + (first + sp) * 2 * RG + r);
      const float ls = __ldcg(ws_ml + (first + sp) * 2 * RG + RG + r);
      L = fmaf(exp2f(ms - mu), ls, L);  // an empty split: 0 * 0
    }
#pragma unroll
    for (int off = 16; off; off >>= 1)
      L += __shfl_xor_sync(0xffffffffu, L, off);
    if (lane == 0) {
      s_mu[r] = mu;
      s_inv[r] = L > 0.f ? 1.f / L : 0.f;
    }
  }
  __syncthreads();
  for (int idx = 4 * tid; idx < nh * HD; idx += 4 * THREADS) {
    const int r = idx / HD, d = idx - r * HD;
    const float mu = s_mu[r];
    float4 A = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
    for (int sp = 0; sp < splits; ++sp) {
      const float w = exp2f(__ldcg(ws_ml + (first + sp) * 2 * RG + r) - mu);
      float4 a = __ldcg(reinterpret_cast<const float4*>(
          ws_acc + ((first + sp) * RG + r) * HD + d));
      if (!(w > 0.f)) a = make_float4(0.f, 0.f, 0.f, 0.f);  // empty split
      A.x = fmaf(w, a.x, A.x);
      A.y = fmaf(w, a.y, A.y);
      A.z = fmaf(w, a.z, A.z);
      A.w = fmaf(w, a.w, A.w);
    }
    const float inv = s_inv[r];
    T* const out = o + (size_t)r * HD + d;
    out[0] = from_f<T>(A.x * inv);
    out[1] = from_f<T>(A.y * inv);
    out[2] = from_f<T>(A.z * inv);
    out[3] = from_f<T>(A.w * inv);
  }
}

template <typename T, int HD, int RG>
__global__ void __launch_bounds__(THREADS)
decode_split_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, T* __restrict__ o,
                    const int* __restrict__ length_ptr, float* ws_ml,
                    float* ws_acc, int* counters, int Hkv, int rep,
                    int groups, int T_len, int window, int splits,
                    float scale_log2) {
  using P = typename Path<T, HD, RG>::type;
  constexpr int NSTREAM = P::NSTREAM, BT = P::BT;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int s_ticket;

  const int tid = threadIdx.x;
  const int unit = blockIdx.x, split = blockIdx.y;
  const int grp = unit % groups, bg = unit / groups;  // bg = b * Hkv + g
  const int b = bg / Hkv, g = bg % Hkv;
  const int H = Hkv * rep;
  const int h0 = g * rep + grp * RG, nh = min(RG, rep - grp * RG);

  Range<T> R;
  R.kb = k + (size_t)bg * T_len * HD;
  R.vb = v + (size_t)bg * T_len * HD;
  const int length = *length_ptr;
  R.end = min(length, T_len);
  R.start = window > 0 ? max(0, length - window) : 0;
  const int ntiles = (max(0, R.end - R.start) + BT - 1) / BT;
  const int per = (ntiles + splits - 1) / splits;
  R.t_begin = min(ntiles, split * per);
  R.t_end = min(ntiles, R.t_begin + per);

  P::run(smem, q + ((size_t)b * H + h0) * HD, nh, R, scale_log2);
  __syncthreads();

  // merge the block's streams: weights w_s = exp2(m_s - M), in order
  const float* sm = reinterpret_cast<const float*>(smem);
  const float* sl = sm + NSTREAM * RG;
  const float* sa = sl + NSTREAM * RG;
  const size_t part = (size_t)unit * splits + split;
  for (int idx = tid; idx < nh * HD; idx += THREADS) {
    const int r = idx / HD, d = idx - r * HD;
    float M = -INFINITY;
    for (int st = 0; st < NSTREAM; ++st) M = fmaxf(M, sm[st * RG + r]);
    const float mu = M == -INFINITY ? 0.f : M;
    float L = 0.f, A = 0.f;
    for (int st = 0; st < NSTREAM; ++st) {
      const float w = exp2f(sm[st * RG + r] - mu);
      L = fmaf(w, sl[st * RG + r], L);
      A = fmaf(w, sa[(st * RG + r) * HD + d], A);
    }
    if (splits == 1) {
      o[((size_t)b * H + h0 + r) * HD + d] = from_f<T>(L > 0.f ? A / L : 0.f);
    } else {
      if (d == 0) {
        ws_ml[part * 2 * RG + r] = M;
        ws_ml[part * 2 * RG + RG + r] = L;
      }
      ws_acc[(part * RG + r) * HD + d] = A;
    }
  }
  if (splits == 1) return;

  // the last block of the unit merges the splits (its own function, kept
  // out of line so that it leaves the streaming loop's code as it is)
  __threadfence();
  __syncthreads();
  if (tid == 0) s_ticket = atomicAdd(&counters[unit], 1);
  __syncthreads();
  if (s_ticket != splits - 1) return;
  __threadfence();
  merge_splits<T, HD, RG>(ws_ml, ws_acc, o + ((size_t)b * H + h0) * HD,
                          (size_t)unit * splits, splits, nh);
  if (tid == 0) counters[unit] = 0;  // ready for the next call
}

template <typename T, int HD, int RG>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   const void* length, void* ws_ml, void* ws_acc,
                   void* counters, int B, int Hkv, int rep, int T_len,
                   int window, int splits, float scale, cudaStream_t stream) {
  constexpr int SMEM = Path<T, HD, RG>::type::SMEM;
  static_assert(SMEM + 16 <= 227 * 1024, "shared memory of a block");
  // the dynamic shared memory limit, raised once per device
  static unsigned raised = 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (SMEM > 48 * 1024 && !(dev < 32 && (raised >> dev & 1u))) {
    err = cudaFuncSetAttribute(decode_split_kernel<T, HD, RG>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               SMEM);
    if (err != cudaSuccess) return err;
    if (dev < 32) raised |= 1u << dev;
  }
  const int groups = (rep + RG - 1) / RG;
  const dim3 grid(B * Hkv * groups, splits);
  decode_split_kernel<T, HD, RG><<<grid, THREADS, SMEM, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o),
      static_cast<const int*>(length), static_cast<float*>(ws_ml),
      static_cast<float*>(ws_acc), static_cast<int*>(counters), Hkv, rep,
      groups, T_len, window, splits, scale * LOG2E);
  return cudaGetLastError();
}

template <typename T, int HD>
cudaError_t by_group(int rg, const void* q, const void* k, const void* v,
                     void* o, const void* length, void* ws_ml, void* ws_acc,
                     void* counters, int B, int Hkv, int rep, int T_len,
                     int window, int splits, float scale, cudaStream_t s) {
  if constexpr (std::is_same<T, bf16>::value) {  // the tensor-core path
    if (rg != 8) return cudaErrorInvalidValue;
    return launch<T, HD, 8>(q, k, v, o, length, ws_ml, ws_acc, counters, B,
                            Hkv, rep, T_len, window, splits, scale, s);
  } else {
    switch (rg) {
#define CASE(R)                                                             \
  case R:                                                                   \
    return launch<T, HD, R>(q, k, v, o, length, ws_ml, ws_acc, counters, B, \
                            Hkv, rep, T_len, window, splits, scale, s);
      CASE(1) CASE(2) CASE(4) CASE(8)
#undef CASE
      default:
        return cudaErrorInvalidValue;
    }
  }
}

template <typename T>
cudaError_t by_dim(int hd, int rg, const void* q, const void* k,
                   const void* v, void* o, const void* length, void* ws_ml,
                   void* ws_acc, void* counters, int B, int Hkv, int rep,
                   int T_len, int window, int splits, float scale,
                   cudaStream_t s) {
  switch (hd) {
#define CASE(D)                                                             \
  case D:                                                                   \
    return by_group<T, D>(rg, q, k, v, o, length, ws_ml, ws_acc, counters,  \
                          B, Hkv, rep, T_len, window, splits, scale, s);
    CASE(16) CASE(32) CASE(64) CASE(96) CASE(112) CASE(128) CASE(256)
#undef CASE
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  q/o (B, H, hd), k/v (B, Hkv, T, hd),
// all contiguous and 16-byte aligned; length: one int32 on the device.
// rg: q heads a block takes (8 in bf16; 1, 2, 4 or 8 in f32); units =
// B * Hkv * ceil(rep / rg).  Workspace for splits > 1: ws_ml (units, splits, 2, rg) f32, ws_acc
// (units, splits, rg, hd) f32, counters (units,) int32, zero before the
// first call and left zero by every call.  One launch on `stream`;
// returns cudaError_t.
int decode_attention_launch(const void* q, const void* k, const void* v,
                            void* o, const void* length, void* ws_ml,
                            void* ws_acc, void* counters, int dtype, int B,
                            int H, int Hkv, int T_len, int hd, int window,
                            int rg, int splits, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || Hkv <= 0 || H % Hkv || T_len <= 0 || splits <= 0 ||
      splits > 65535)
    return cudaErrorInvalidValue;
  const int rep = H / Hkv;
  if (dtype == 0)
    return by_dim<float>(hd, rg, q, k, v, o, length, ws_ml, ws_acc, counters,
                         B, Hkv, rep, T_len, window, splits, scale, s);
  if (dtype == 1)
    return by_dim<bf16>(hd, rg, q, k, v, o, length, ws_ml, ws_acc, counters,
                        B, Hkv, rep, T_len, window, splits, scale, s);
  return cudaErrorInvalidValue;
}

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
