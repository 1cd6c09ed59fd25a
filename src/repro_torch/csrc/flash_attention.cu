// Flash attention forward (causal or bidirectional, GQA, optional sliding
// window) on Hopper's CUDA cores (sm_90a), in exact f32 FMAs.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention/kernel.py::
// flash_attention_bhsd (body _flash_kernel): softmax(Q K^T * scale + mask) V
// with q (B, H, Sq, hd), k/v (B, Hkv, Sk, hd); q head h reads kv head
// h / (H / Hkv); positions are aligned at 0 for q and k (key j is visible
// to query i when j < Sk, j <= i under causal, and j > i - window when a
// window is set); rows with no visible key give 0.
//
// What it takes: f32 at head dims 16, 32, 64, 96, 112, 128 and 256 (every
// f32 attention of the port), and bf16 at 16 and 32 (the reference's test
// shapes) and at 64 and 128 (only to time it against
// flash_attention_wgmma.cu, which takes every bf16 head dim a config uses:
// ops.py::variant picks).  Products and the softmax are f32 throughout:
// no tensor core, so no TF32 rounding of the inputs.
//
// What bounds it: operations.  A causal pass does about 2 * B * H * S^2 *
// hd flops against 4 * B * H * S * hd elements moved, far above the
// H100's ridge beyond a few hundred positions, and every flop is an f32
// FFMA on the CUDA cores (67 TFLOP/s peak: 128 FFMA a clock an SM).  What
// keeps a kernel from that peak is what else it issues: each FFMA needs
// operands from shared memory, and an SM serves one 128-byte wavefront a
// clock against four warp-FFMAs.  At short sequences (the decode-vs-forward
// checks, S = 64) a block's own latency is the time instead, and a grid of
// one 64-row tile per (b, h) would leave most of the 132 SMs idle.
//
// Design, an SGEMM's register blocking around an online softmax:
// - Lanes.  A row group of 16 query rows meets every key of a 32-key tile.
//   Lane (ty, tx) = (lane / 8, lane % 8) of a warp holds the 4 x 4 scores
//   of rows 4 ty + i and keys tx + 8 j.  Per 4 head-dim steps it loads 4
//   rows of Q^T and 4 keys of K with 8 LDS.128 for 64 FFMAs; the 8 key
//   lanes of a row read 8 distinct K rows (rows padded by 16 bytes: one
//   wavefront) and the 4 row lanes 64 contiguous bytes of Q^T (one
//   wavefront).  O += P V is blocked the same way: a lane owns rows
//   4 ty + i and columns in chunks of VEC (4, else 2 or 1) at chunk
//   tx + 8 c, and per key reads 4 p's (one LDS.128 of P^T) and its chunks
//   of V (contiguous over the 8 key lanes).  O stays in registers.
// - Warps of a row group.  One warp, or two (HS = 2) that split the head
//   dim: each sums S over its half, the two add each other's partial
//   scores through shared memory (s_own + s_other is the same float in
//   both, so both run the same softmax), and each accumulates its half of
//   O's columns.  That halves a block's latency where the grid is short
//   (S = 64), and at hd 256 it puts 8 warps on an SM instead of 4 (shared
//   memory holds one block: Q^T alone is 64 KB) and halves O's 128
//   registers a lane.
// - The softmax once per score.  A lane reduces its 4 keys of a row, then
//   3 xor-shuffles over the row's 8 key lanes give the tile's row max;
//   each score takes one ex2.approx (the scale times log2(e) is folded
//   into Q^T when Q is staged), by the one lane that holds it.  The
//   running row sum stays a per-lane partial (the lanes of a row share m
//   and alpha) and is reduced once, at the end.  O's rescale by alpha is
//   skipped by the whole warp when no row's max moved.  P goes to shared
//   memory transposed (STS.128 of 4 rows a key, padded: conflict-free)
//   for the row group's P V.
// - Copies.  Q's tile is read once, scaled and widened to f32 into Q^T.
//   K/V tiles go through a ring of STAGES stages by cp.async (16-byte
//   copies; rows at or past Sk zero-filled, so no garbage, NaN included,
//   meets a p = 0), one commit group a tile: tile t + 1 is in flight while
//   tile t is computed.  bf16 tiles stay bf16 in shared memory and are
//   widened once at the register load, never per FMA.
// - Grid.  A block holds RG row groups (BQ = 16 RG query rows of one
//   (b, h)); ops.py::fma_tiling picks BQ = 64, 32 or 16 and HS from the
//   shapes alone so that the grid fills the card at short sequences
//   (S = 64 at 30 (b, h) pairs: 120 blocks of 16 rows and two warps, not
//   30 of 64).  Query tiles are launched heaviest first (the last causal
//   tile sees the most keys).
// - Masking and work.  The block loops only over the key tiles its rows can
//   see (causal and window bound the loop), a row group skips a tile none
//   of its rows sees, and only tiles crossing the diagonal, the window
//   edge or Sk are masked element by element.  The online softmax keeps
//   m, l and O in f32 and masks p explicitly (a masked score is -inf and
//   ex2 gives p = 0 exactly; a row whose max is still -inf subtracts 0),
//   so no result depends on the order in which tiles arrive, and a row
//   that sees no key gives 0.  Sq and Sk need no padding: ragged edges are
//   masked here.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int WR = 16;      // query rows a row group (4 row lanes x 4)
constexpr int BK = 32;      // keys a tile (8 key lanes x KPL)
constexpr int KPL = BK / 8; // keys a lane
constexpr int STAGES = 2;   // K/V tiles in shared memory
constexpr int UD = 8, UK = 8;  // unrolling of the S and P V loops
constexpr int PT_LD = WR + 4;  // P^T row stride (floats): STS.128 without
                               // bank conflicts
constexpr float LOG2E = 1.4426950408889634f;

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

// 4 consecutive elements (16-byte aligned f32, 8-byte aligned bf16) as f32
__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 ld4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  return make_float4(__uint_as_float(u.x << 16),
                     __uint_as_float(u.x & 0xffff0000u),
                     __uint_as_float(u.y << 16),
                     __uint_as_float(u.y & 0xffff0000u));
}
__device__ __forceinline__ void st4(float* p, float4 x) {
  *reinterpret_cast<float4*>(p) = x;
}
__device__ __forceinline__ void st4(__nv_bfloat16* p, float4 x) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(x.x, x.y);
  __nv_bfloat162 hi = __floats2bfloat162_rn(x.z, x.w);
  uint2 u;
  u.x = *reinterpret_cast<uint32_t*>(&lo);
  u.y = *reinterpret_cast<uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(p) = u;
}
// 2^x by the SFU (ex2.approx: 2 ulp; -inf gives +0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}
__device__ __forceinline__ float comp(const float4& x, int e) {
  return e == 0 ? x.x : e == 1 ? x.y : e == 2 ? x.z : x.w;
}
// VEC consecutive elements (4, 2 or 1) as f32, and back
template <int VEC> struct Vec;
template <> struct Vec<4> {
  template <typename T>
  static __device__ __forceinline__ void load(const T* p, float* x) {
    const float4 f = ld4(p);
    x[0] = f.x, x[1] = f.y, x[2] = f.z, x[3] = f.w;
  }
  template <typename T>
  static __device__ __forceinline__ void store(T* p, const float* x) {
    st4(p, make_float4(x[0], x[1], x[2], x[3]));
  }
};
template <> struct Vec<2> {
  static __device__ __forceinline__ void load(const float* p, float* x) {
    const float2 f = *reinterpret_cast<const float2*>(p);
    x[0] = f.x, x[1] = f.y;
  }
  static __device__ __forceinline__ void load(const __nv_bfloat16* p,
                                              float* x) {
    const uint32_t u = *reinterpret_cast<const uint32_t*>(p);
    x[0] = __uint_as_float(u << 16), x[1] = __uint_as_float(u & 0xffff0000u);
  }
  static __device__ __forceinline__ void store(float* p, const float* x) {
    *reinterpret_cast<float2*>(p) = make_float2(x[0], x[1]);
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p,
                                               const float* x) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x[0], x[1]);
  }
};
template <> struct Vec<1> {
  static __device__ __forceinline__ void load(const float* p, float* x) {
    x[0] = *p;
  }
  static __device__ __forceinline__ void load(const __nv_bfloat16* p,
                                              float* x) {
    x[0] = __bfloat162float(*p);
  }
  static __device__ __forceinline__ void store(float* p, const float* x) {
    *p = x[0];
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p,
                                               const float* x) {
    *p = __float2bfloat16(x[0]);
  }
};

// A block: RG row groups of 16 query rows (BQ = 16 RG) of one (b, h), each
// taken by HS warps that split the head dim: S's sum over it, then O's
// columns.
template <typename T, int HD, int RG, int HS> struct Tile {
  static constexpr int BQ = RG * WR;          // query rows a block
  static constexpr int WARPS = RG * HS;
  static constexpr int THREADS = 32 * WARPS;
  static constexpr int QUADS = HD / 4;        // head-dim quads of a row
  static constexpr int SQ = QUADS / HS;       // quads of S's sum a warp
  // O's columns a warp owns (HALF), and of those a lane's: OC chunks of
  // VEC, chunk tx + 8 c (VEC = 4 where the chunks split evenly over 8
  // lanes, else 2 or 1)
  static constexpr int HALF = HD / HS;
  static constexpr int VEC = HALF % 32 == 0 ? 4 : HALF % 16 == 0 ? 2 : 1;
  static constexpr int OC = HALF / VEC / 8;
  static constexpr int K_LD = HD + 16 / (int)sizeof(T);  // padded K row
  static constexpr int KV_ELEMS = BK * (K_LD + HD);      // one stage
  static constexpr int ROW_CHUNKS = HD * (int)sizeof(T) / 16;
  static constexpr size_t Q_BYTES = (size_t)HD * BQ * sizeof(float);
  static constexpr size_t KV_BYTES = (size_t)STAGES * KV_ELEMS * sizeof(T);
  // partial scores a warp hands its partner (HS = 2), and P^T a row group
  static constexpr size_t X_BYTES =
      HS > 1 ? (size_t)WARPS * 32 * 4 * KPL * sizeof(float) : 0;
  static constexpr size_t P_BYTES = (size_t)RG * BK * PT_LD * sizeof(float);
  static constexpr size_t SMEM = Q_BYTES + KV_BYTES + X_BYTES + P_BYTES;
  // blocks an SM holds by shared memory (232,448 bytes, 1 KB reserved a
  // block), capped so that a thread keeps at least 168 registers: ptxas
  // then allocates up to 65536 / (THREADS * MIN_BLOCKS), and spills at
  // none of the instantiations below
  static constexpr int SMEM_BLOCKS = 232448 / (int)(SMEM + 1024);
  static constexpr int REG_BLOCKS = 65536 / (THREADS * 168);
  static constexpr int MIN_BLOCKS =
      SMEM_BLOCKS < 1 || REG_BLOCKS < 1 ? 1
      : SMEM_BLOCKS < REG_BLOCKS        ? SMEM_BLOCKS
                                        : REG_BLOCKS;
  static_assert(HD % 16 == 0 && QUADS % HS == 0, "head dim");
  static_assert(OC * VEC * 8 == HALF, "O's columns split evenly over lanes");
};

// barrier of the HS = 2 warps of row group rg (ids 1.., 0 is __syncthreads)
__device__ __forceinline__ void pair_sync(int rg) {
  asm volatile("bar.sync %0, 64;" ::"r"(1 + rg) : "memory");
}

template <typename T, int HD, int RG, int HS>
__global__ void __launch_bounds__(Tile<T, HD, RG, HS>::THREADS,
                                  Tile<T, HD, RG, HS>::MIN_BLOCKS)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ o, int H, int Hkv,
             int Sq, int Sk, int causal, int window, float qscale) {
  using C = Tile<T, HD, RG, HS>;
  constexpr int BQ = C::BQ, NT = C::THREADS, QUADS = C::QUADS, SQ = C::SQ;
  constexpr int VEC = C::VEC, OC = C::OC, K_LD = C::K_LD;
  extern __shared__ __align__(16) unsigned char smem[];
  float* qt = reinterpret_cast<float*>(smem);                     // [HD][BQ]
  T* kv = reinterpret_cast<T*>(smem + C::Q_BYTES);  // STAGES x (K, V)
  float* xs = reinterpret_cast<float*>(smem + C::Q_BYTES + C::KV_BYTES);
  float* pt = reinterpret_cast<float*>(smem + C::Q_BYTES + C::KV_BYTES +
                                       C::X_BYTES);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int rg = warp / HS, hh = warp % HS;  // row group, head-dim half
  const int ty = lane >> 3, tx = lane & 7;
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int g = h / (H / Hkv);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;  // heaviest first
  const T* qb = q + (size_t)bh * Sq * HD;
  const size_t kvoff = ((size_t)b * Hkv + g) * (size_t)Sk * HD;
  const T* kb = k + kvoff;
  const T* vb = v + kvoff;
  float* pw = pt + rg * BK * PT_LD;  // the row group's P^T [BK][PT_LD]

  // keys visible to some row of the block, then of this row group
  const int k_lo = window > 0 ? max(0, q0 - window + 1) : 0;
  const int k_hi = causal ? min(Sk, q0 + BQ) : Sk;
  const int nt = k_hi > k_lo ? (k_hi - k_lo + BK - 1) / BK : 0;
  const int r0 = q0 + rg * WR;                  // the group's first row
  const int w_lo = window > 0 ? r0 - window + 1 : 0;
  const int w_hi = causal ? min(Sk, r0 + WR) : Sk;
  const bool group_live = r0 < Sq;

  // a tile is BK rows of RC 16-byte chunks each of K and V: NCOPY copies
  // of each a thread (row r, chunk c), unrolled where few
  constexpr int EPC = 16 / (int)sizeof(T), RC = C::ROW_CHUNKS;
  constexpr int NCOPY = (BK * RC + NT - 1) / NT;
  constexpr int UCOPY = NCOPY <= 8 ? NCOPY : 4;
  auto load_tile = [&](int t0, int stage) {
    T* ks = kv + stage * C::KV_ELEMS;
    T* vs = ks + BK * K_LD;
#pragma unroll UCOPY
    for (int n = 0; n < NCOPY; ++n) {
      const int i = tid + n * NT;
      if ((BK * RC) % NT != 0 && i >= BK * RC) break;
      int r, c;
      if constexpr (NT % RC == 0) {
        r = tid / RC + n * (NT / RC), c = tid % RC;
      } else {
        r = i / RC, c = i % RC;
      }
      const bool ok = t0 + r < Sk;
      const size_t src = (size_t)(ok ? t0 + r : 0) * HD + c * EPC;
      cp_async16(ks + r * K_LD + c * EPC, kb + src, ok);
      cp_async16(vs + r * HD + c * EPC, vb + src, ok);
    }
  };
  if (nt > 0) load_tile(k_lo, 0);
  cp_async_commit();

  // Q^T, scaled into log2 space; rows past Sq are 0
  for (int i = tid; i < BQ * QUADS; i += NT) {
    const int r = i % BQ, dq = i / BQ;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (q0 + r < Sq) x = ld4(qb + (size_t)(q0 + r) * HD + 4 * dq);
    qt[(4 * dq + 0) * BQ + r] = x.x * qscale;
    qt[(4 * dq + 1) * BQ + r] = x.y * qscale;
    qt[(4 * dq + 2) * BQ + r] = x.z * qscale;
    qt[(4 * dq + 3) * BQ + r] = x.w * qscale;
  }

  float acc[4][OC][VEC];
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int oc = 0; oc < OC; ++oc)
#pragma unroll
      for (int c = 0; c < VEC; ++c) acc[i][oc][c] = 0.f;
  }
  const float* qw = qt + rg * WR + ty * 4 + hh * SQ * 4 * BQ;
  const int col0 = hh * C::HALF;  // this warp's first column of O

  for (int it = 0; it < nt; ++it) {
    const int t0 = k_lo + it * BK;
    if (it + 1 < nt) load_tile(t0 + BK, (it + 1) % STAGES);
    cp_async_commit();  // empty groups keep the wait count uniform
    cp_async_wait<STAGES - 1>();
    __syncthreads();  // tile it (and, at it = 0, Q^T) visible to all

    if (group_live && t0 < w_hi && t0 + BK > w_lo) {
      const T* ks = kv + (it % STAGES) * C::KV_ELEMS + hh * SQ * 4;
      const T* vs = kv + (it % STAGES) * C::KV_ELEMS + BK * K_LD;

      // S = (Q scale log2 e) K^T: 4 rows x KPL keys a lane, over this
      // warp's SQ quads of the head dim
      float s[4][KPL];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < KPL; ++j) s[i][j] = 0.f;
#pragma unroll UD
      for (int dq = 0; dq < SQ; ++dq) {
        float4 kf[KPL];
#pragma unroll
        for (int j = 0; j < KPL; ++j)
          kf[j] = ld4(ks + (tx + 8 * j) * K_LD + 4 * dq);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float4 qf = *reinterpret_cast<const float4*>(
              qw + (4 * dq + e) * BQ);
#pragma unroll
          for (int j = 0; j < KPL; ++j) {
            const float kj = comp(kf[j], e);
            s[0][j] = fmaf(qf.x, kj, s[0][j]);
            s[1][j] = fmaf(qf.y, kj, s[1][j]);
            s[2][j] = fmaf(qf.z, kj, s[2][j]);
            s[3][j] = fmaf(qf.w, kj, s[3][j]);
          }
        }
      }
      if constexpr (HS > 1) {
        // add the partner's partial sums; s_own + s_other is the same
        // float in both warps, so both run the same softmax
        float4* xw = reinterpret_cast<float4*>(xs) + warp * KPL * 32;
        const float4* xo =
            reinterpret_cast<const float4*>(xs) + (warp ^ 1) * KPL * 32;
#pragma unroll
        for (int j = 0; j < KPL; ++j)
          xw[j * 32 + lane] = make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
        pair_sync(rg);
#pragma unroll
        for (int j = 0; j < KPL; ++j) {
          const float4 x = xo[j * 32 + lane];
          s[0][j] += x.x, s[1][j] += x.y, s[2][j] += x.z, s[3][j] += x.w;
        }
      }

      // mask only tiles that cross Sk, the diagonal or the window edge
      const bool whole = t0 + BK <= Sk &&
                         (!causal || t0 + BK - 1 <= r0) &&
                         (window <= 0 || t0 > r0 + WR - 1 - window);
      if (!whole) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int qi = r0 + ty * 4 + i;
#pragma unroll
          for (int j = 0; j < KPL; ++j) {
            const int kj = t0 + tx + 8 * j;
            const bool ok = kj < Sk && (!causal || kj <= qi) &&
                            (window <= 0 || kj > qi - window);
            if (!ok) s[i][j] = -INFINITY;
          }
        }
      }

      // online softmax: the row max over the row's 8 key lanes
      bool rescale = false;
      float alpha[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float mx = s[i][0];
#pragma unroll
        for (int j = 1; j < KPL; ++j) mx = fmaxf(mx, s[i][j]);
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
        const float m_new = fmaxf(m[i], mx);
        // m_new = -inf: nothing visible to this row yet.  A masked score
        // is -inf and ex2(-inf - base) = 0 exactly, whatever the max.
        const float base = m_new == -INFINITY ? 0.f : m_new;
        alpha[i] = ex2(m[i] - base);  // 0 while m is -inf
        rescale |= alpha[i] != 1.f;
        float psum = 0.f;
#pragma unroll
        for (int j = 0; j < KPL; ++j) {
          s[i][j] = ex2(s[i][j] - base);
          psum += s[i][j];
        }
        l[i] = l[i] * alpha[i] + psum;
        m[i] = m_new;
      }
      // O *= alpha, skipped by the whole warp once no row's max moves
      if (__any_sync(0xffffffffu, rescale)) {
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int oc = 0; oc < OC; ++oc)
#pragma unroll
            for (int c = 0; c < VEC; ++c) acc[i][oc][c] *= alpha[i];
      }

      // P^T to shared memory (one warp of the group writes it): key
      // tx + 8 j, rows 4 ty .. 4 ty + 3
      if (hh == 0) {
#pragma unroll
        for (int j = 0; j < KPL; ++j)
          *reinterpret_cast<float4*>(pw + (tx + 8 * j) * PT_LD + ty * 4) =
              make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
      }
      if constexpr (HS > 1) {
        pair_sync(rg);
      } else {
        __syncwarp();
      }

      // O += P V: rows 4 ty + i, this warp's columns col0 + VEC (tx + 8 oc)
#pragma unroll UK
      for (int kk = 0; kk < BK; ++kk) {
        const float4 pf =
            *reinterpret_cast<const float4*>(pw + kk * PT_LD + ty * 4);
#pragma unroll
        for (int oc = 0; oc < OC; ++oc) {
          float vf[VEC];
          Vec<VEC>::load(vs + kk * HD + col0 + VEC * (tx + 8 * oc), vf);
#pragma unroll
          for (int c = 0; c < VEC; ++c) {
            acc[0][oc][c] = fmaf(pf.x, vf[c], acc[0][oc][c]);
            acc[1][oc][c] = fmaf(pf.y, vf[c], acc[1][oc][c]);
            acc[2][oc][c] = fmaf(pf.z, vf[c], acc[2][oc][c]);
            acc[3][oc][c] = fmaf(pf.w, vf[c], acc[3][oc][c]);
          }
        }
      }
    }
    // stage it % STAGES, the partial scores and P^T consumed before they
    // are written again
    __syncthreads();
  }
  cp_async_wait<0>();

  // the row sums over the row's 8 key lanes, then O / l (0 with no key)
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 4);
  }
  if (!group_live) return;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = r0 + ty * 4 + i;
    if (qi >= Sq) continue;
    const float inv = l[i] > 0.f ? 1.f / l[i] : 0.f;
    T* orow = o + ((size_t)bh * Sq + qi) * HD + col0;
#pragma unroll
    for (int oc = 0; oc < OC; ++oc) {
      float x[VEC];
#pragma unroll
      for (int c = 0; c < VEC; ++c) x[c] = acc[i][oc][c] * inv;
      Vec<VEC>::store(orow + VEC * (tx + 8 * oc), x);
    }
  }
}

template <typename T, int HD, int RG, int HS>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int B, int H, int Hkv, int Sq, int Sk, int causal,
                   int window, float scale, cudaStream_t stream) {
  using C = Tile<T, HD, RG, HS>;
  cudaError_t err = cudaFuncSetAttribute(
      flash_kernel<T, HD, RG, HS>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)C::SMEM);
  if (err != cudaSuccess) return err;
  dim3 grid(B * H, (Sq + C::BQ - 1) / C::BQ);
  flash_kernel<T, HD, RG, HS><<<grid, C::THREADS, C::SMEM, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), H, Hkv, Sq, Sk, causal,
      window, scale * LOG2E);
  return cudaGetLastError();
}

template <typename T, int HD, int HS>
cudaError_t by_rows(int q_tile, const void* q, const void* k, const void* v,
                    void* o, int B, int H, int Hkv, int Sq, int Sk,
                    int causal, int window, float scale, cudaStream_t s) {
  switch (q_tile) {
    case 64:
      return launch<T, HD, 4, HS>(q, k, v, o, B, H, Hkv, Sq, Sk, causal,
                                  window, scale, s);
    case 32:
      return launch<T, HD, 2, HS>(q, k, v, o, B, H, Hkv, Sq, Sk, causal,
                                  window, scale, s);
    case 16:
      return launch<T, HD, 1, HS>(q, k, v, o, B, H, Hkv, Sq, Sk, causal,
                                  window, scale, s);
  }
  return cudaErrorInvalidValue;
}

template <typename T, int HD>
cudaError_t by_tile(int q_tile, int hd_split, const void* q, const void* k,
                    const void* v, void* o, int B, int H, int Hkv, int Sq,
                    int Sk, int causal, int window, float scale,
                    cudaStream_t s) {
  if (hd_split == 1)
    return by_rows<T, HD, 1>(q_tile, q, k, v, o, B, H, Hkv, Sq, Sk, causal,
                             window, scale, s);
  if (hd_split == 2)
    return by_rows<T, HD, 2>(q_tile, q, k, v, o, B, H, Hkv, Sq, Sk, causal,
                             window, scale, s);
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t dispatch(int hd, int q_tile, int hd_split, const void* q,
                     const void* k, const void* v, void* o, int B, int H,
                     int Hkv, int Sq, int Sk, int causal, int window,
                     float scale, cudaStream_t s) {
#define CASE(D)                                                           \
  case D:                                                                 \
    return by_tile<T, D>(q_tile, hd_split, q, k, v, o, B, H, Hkv, Sq, Sk, \
                         causal, window, scale, s);
  switch (hd) { CASE(16) CASE(32) CASE(64) CASE(128) }
  // bf16 at 96, 112 and 256 is flash_attention_wgmma.cu's alone
  if constexpr (std::is_same_v<T, float>) {
    switch (hd) { CASE(96) CASE(112) CASE(256) }
  }
#undef CASE
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  q/o (B, H, Sq, hd), k/v (B, Hkv, Sk,
// hd), all contiguous and 16-byte aligned.  q_tile: query rows a block
// (64, 32 or 16), hd_split: warps a row group (1 or 2)
// (kernels/flash_attention/ops.py::fma_tiling).  Returns cudaError_t.
int flash_attention_launch(const void* q, const void* k, const void* v,
                           void* o, int dtype, int B, int H, int Hkv, int Sq,
                           int Sk, int hd, int causal, int window,
                           int q_tile, int hd_split, float scale,
                           void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch<float>(hd, q_tile, hd_split, q, k, v, o, B, H, Hkv, Sq,
                           Sk, causal, window, scale, s);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(hd, q_tile, hd_split, q, k, v, o, B, H,
                                   Hkv, Sq, Sk, causal, window, scale, s);
  return cudaErrorInvalidValue;
}

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
