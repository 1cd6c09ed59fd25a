// Mamba2 SSD chunked scan (one B/C group) in bf16 on Hopper (sm_90a):
// chunk-parallel, with every product on the tensor cores.
//
// Replaces the TPU kernel src/repro/kernels/ssd_scan/kernel.py::ssd_scan
// (body _ssd_kernel) for bf16 inputs; f32 inputs stay on ssd_scan.cu
// (kernels/ssd_scan/ops.py::variant picks).  Inputs x (b, s, h, p) and
// B/C (b, s, n) in bf16, dt (b, s, h) and A (h,) in f32; output y (b, s,
// h, p) in bf16.  Per chunk of q rows and per head, with cum the running
// sum of dt * A along the chunk:
//   y_i = sum_{j <= i} (C_i . B_j) exp(cum_i - cum_j) dt_j x_j
//         + exp(cum_i) C_i . S_c
//   S_{c+1} = exp(cum_last) S_c + sum_j exp(cum_last - cum_j) dt_j x_j B_j^T
// with the (p, n) state S_c entering chunk c, zero for the first.
//
// What bounds it: bytes.  One read of x, B, C and dt and one write of y is
// 87 MB at Mamba2-2.7B's b 2, s 2048 (0.026 ms at 3.35 TB/s), and the f32
// chunk states between the steps add about 4 x 84 MB; the products are
// 16.2 GFLOP, 0.016 ms at the bf16 tensor-core peak.  So once the chunk
// axis runs in parallel, the state traffic between the steps is the
// bound, and mma.sync m16n8k16 (bf16 in, f32 accumulate) is enough for
// the products.
//
// Design: the split of Mamba2's own chunked implementation, as three
// kernels launched back to back by one wrapper call; only the (p x n)
// state is sequential over chunks, and it is the only thing walked in
// order.
// 1. Chunk states, one block per (b, chunk, block of HB heads): the warp
//    scan of dt * A gives cum (written, f32, for step 3); each head's
//    contribution sum_j w_j x_j^T B_j with w_j = exp(cum_last - cum_j)
//    dt_j is a (p x q).(q x n) product, written in f32 (b, nc, h, p, n).
// 2. State passing, one thread per 4 state elements of a (b, head):
//    S <- exp(cum_last) S + contribution, chunk by chunk, storing the
//    state entering each chunk in bf16.  Elementwise and cheap.
// 3. Chunk scan, one block per (b, chunk, block of HB heads): C B^T (q x q
//    over n) is computed once per block and kept in registers (warp w
//    holds rows 16w..16w+15, only the columns up to its diagonal), shared
//    by the block's heads (one group: C and B do not depend on the head).
//    Per head, L = C B^T * exp(cum_i - cum_j) * dt_j is formed in
//    registers straight into the A fragments of L x (the m16n8 f32
//    accumulator layout is the m16k16 A layout once pairs are packed),
//    with entries above the diagonal set to 0 without calling exp (at A
//    = -16, dt = 0.1 over 128 rows exp(cum_i - cum_j) there is +inf).
//    y = exp(cum_i) (C S_c^T) + L x, rounded to bf16 once at the end.
//    The next head's x, S_c, cum and dt are copied (cp.async) while this
//    head computes.
// Operands are rounded to bf16 at exactly three points, and accumulation
// is f32 everywhere else: (1) w * x before the chunk-state product, (2)
// the entering state S_c before C S_c^T, (3) L before L x.
// (kernels/ssd_scan/ref.py::ssd_scan_chunked with bf16_points=True
// emulates the same three roundings.)
// Shared-memory rows are padded by 16 bytes so the eight row addresses of
// an ldmatrix fall in distinct banks.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int THREADS = 256;  // 8 warps
// heads per block in steps 1 and 3: at Mamba2-2.7B's 80 heads and b * nc
// = 32, 8 head blocks give 256 blocks, two waves on 132 SMs at one block
// per SM (step 3 holds 179 registers a thread); 8 heads gave 2.4 waves
constexpr int HB = 10;
constexpr int QMAX = 128, PMAX = 64;
constexpr int PAD = 8;  // bf16 of padding at the end of each shared row

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src)
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

// cp.async `rows` rows of `cols` bf16 (cols % 8 == 0) from global rows
// `gstride` elements apart into shared rows `sstride` elements apart.
__device__ __forceinline__ void copy_rows(bf16* dst, int sstride,
                                          const bf16* src, size_t gstride,
                                          int rows, int cols) {
  const int cpr = cols / 8;
  for (int i = threadIdx.x; i < rows * cpr; i += THREADS) {
    const int r = i / cpr, c = i - r * cpr;
    cp_async16(dst + r * sstride + c * 8, src + r * gstride + c * 8);
  }
}

// Inclusive cumsum of dt * a over q rows, by one warp: each lane sums a
// run of consecutive rows, then the runs are offset by a warp scan.
__device__ __forceinline__ void chunk_cumsum(const float* sDt, float* sCum,
                                             float a, int q, int lane) {
  const int per = (q + 31) / 32;
  const int j0 = min(lane * per, q), j1 = min(j0 + per, q);
  float run = 0.f;
  for (int j = j0; j < j1; ++j) {
    run += sDt[j] * a;
    sCum[j] = run;
  }
  float incl = run;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float v = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += v;
  }
  for (int j = j0; j < j1; ++j) sCum[j] += incl - run;
}

// ---------------------------------------------------------------------------
// 1. chunk states
// ---------------------------------------------------------------------------

size_t state_smem(int q, int p, int n) {
  return 2 * ((size_t)q * (n + PAD) + (size_t)q * (p + PAD)) +
         4 * 2 * (size_t)q;
}

__global__ void __launch_bounds__(THREADS)
ssd_chunk_state_kernel(const bf16* __restrict__ x,
                       const float* __restrict__ dt,
                       const float* __restrict__ A,
                       const bf16* __restrict__ Bm, float* __restrict__ cum,
                       float* __restrict__ states, int s, int h, int p,
                       int n, int q) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int ldn = n + PAD, ldp = p + PAD;
  bf16* sB = reinterpret_cast<bf16*>(smem);  // [q][ldn]
  bf16* sX = sB + q * ldn;                   // [q][ldp], w_j x_j
  float* sDt = reinterpret_cast<float*>(sX + q * ldp);  // [q]
  float* sCum = sDt + q;                                // [q]

  const int nc = s / q, bb = blockIdx.x / nc, c = blockIdx.x % nc;
  const size_t t0 = (size_t)bb * s + (size_t)c * q;  // first token row
  const int h0 = blockIdx.y * HB, h1 = min(h, h0 + HB);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  // warp tiling of the (p x n) result: 16 rows of p, 64 columns of n
  const int mt = warp & 3, nt0 = (warp >> 2) * 8;

  copy_rows(sB, ldn, Bm + t0 * n, n, q, n);
  for (int hh = h0; hh < h1; ++hh) {
    copy_rows(sX, ldp, x + (t0 * h + hh) * p, (size_t)h * p, q, p);
    cp_async_commit();
    for (int j = tid; j < q; j += THREADS) sDt[j] = dt[(t0 + j) * h + hh];
    __syncthreads();
    if (warp == 0) chunk_cumsum(sDt, sCum, A[hh], q, lane);
    cp_async_wait<0>();
    __syncthreads();
    const float cum_last = sCum[q - 1];
    for (int j = tid; j < q; j += THREADS) cum[(t0 + j) * h + hh] = sCum[j];
    // x_j <- w_j x_j in bf16 (rounding point 1)
    const int hp = p / 2;
    for (int i = tid; i < q * hp; i += THREADS) {
      const int j = i / hp, d = 2 * (i - j * hp);
      const float w = expf(cum_last - sCum[j]) * sDt[j];
      __nv_bfloat162* px = reinterpret_cast<__nv_bfloat162*>(sX + j * ldp + d);
      const float2 xv = __bfloat1622float2(*px);
      *px = __floats2bfloat162_rn(xv.x * w, xv.y * w);
    }
    __syncthreads();

    if (16 * mt < p) {
      float acc[8][4];
#pragma unroll
      for (int u = 0; u < 8; ++u)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[u][e] = 0.f;
      for (int j0 = 0; j0 < q; j0 += 16) {
        // A = (w x)^T (rows p, k = j), stored [j][p]: transposed load
        uint32_t af[4];
        ldsm_x4_t(af, sX + (j0 + (lane & 7) + (lane >> 4) * 8) * ldp +
                          16 * mt + ((lane >> 3) & 1) * 8);
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int nt = nt0 + 2 * u;  // a pair of 8-column tiles of n
          if (8 * nt < n) {
            // B = B chunk (k = j, columns n), stored [j][n]: transposed
            uint32_t bf[4];
            ldsm_x4_t(bf, sB + (j0 + (lane & 7) + ((lane >> 3) & 1) * 8) *
                                   ldn +
                              8 * nt + (lane >> 4) * 8);
            mma16816(acc[2 * u], af, bf[0], bf[1]);
            mma16816(acc[2 * u + 1], af, bf[2], bf[3]);
          }
        }
      }
      float* out = states + (((size_t)bb * nc + c) * h + hh) * p * n;
      const int r = 16 * mt + (lane >> 2);
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int col = 8 * (nt0 + u) + 2 * (lane & 3);
        if (col < n) {
          *reinterpret_cast<float2*>(out + r * n + col) =
              make_float2(acc[u][0], acc[u][1]);
          *reinterpret_cast<float2*>(out + (r + 8) * n + col) =
              make_float2(acc[u][2], acc[u][3]);
        }
      }
    }
    __syncthreads();  // sX, sDt and sCum are the next head's
  }
}

// ---------------------------------------------------------------------------
// 2. state passing
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(THREADS)
ssd_state_pass_kernel(const float* __restrict__ states,
                      const float* __restrict__ cum, bf16* __restrict__ s_in,
                      int s, int h, int pn, int q) {
  const int nc = s / q;
  const int bb = blockIdx.x / h, hh = blockIdx.x % h;
  const int e = (blockIdx.y * THREADS + threadIdx.x) * 4;
  if (e >= pn) return;
  float4 st = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
  for (int c = 0; c < nc; ++c) {
    const size_t off = (((size_t)bb * nc + c) * h + hh) * pn + e;
    const float4 cv = *reinterpret_cast<const float4*>(states + off);
    const float dec =
        expf(cum[((size_t)bb * s + (size_t)c * q + q - 1) * h + hh]);
    // the state entering chunk c, in bf16 (rounding point 2)
    uint2 packed;
    packed.x = pack_bf16(st.x, st.y);
    packed.y = pack_bf16(st.z, st.w);
    *reinterpret_cast<uint2*>(s_in + off) = packed;
    st.x = dec * st.x + cv.x;
    st.y = dec * st.y + cv.y;
    st.z = dec * st.z + cv.z;
    st.w = dec * st.w + cv.w;
  }
}

// ---------------------------------------------------------------------------
// 3. chunk scan
// ---------------------------------------------------------------------------

size_t scan_smem(int q, int p, int n) {
  return 2 * (2 * (size_t)q * (n + PAD) + 2 * (size_t)q * (p + PAD) +
              2 * (size_t)p * (n + PAD)) +
         4 * 4 * (size_t)q;
}

__global__ void __launch_bounds__(THREADS, 1)
ssd_chunk_scan_kernel(const bf16* __restrict__ x,
                      const float* __restrict__ dt,
                      const float* __restrict__ cum,
                      const bf16* __restrict__ Bm,
                      const bf16* __restrict__ Cm,
                      const bf16* __restrict__ s_in, bf16* __restrict__ y,
                      int s, int h, int p, int n, int q) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int ldn = n + PAD, ldp = p + PAD;
  bf16* sC = reinterpret_cast<bf16*>(smem);  // [q][ldn]
  bf16* sB = sC + q * ldn;                   // [q][ldn]
  bf16* sX = sB + q * ldn;                   // [2][q][ldp]
  bf16* sS = sX + 2 * q * ldp;               // [2][p][ldn], S_c as (p x n)
  float* sCum = reinterpret_cast<float*>(sS + 2 * p * ldn);  // [2][q]
  float* sDt = sCum + 2 * q;                                 // [2][q]

  const int nc = s / q, bb = blockIdx.x / nc, c = blockIdx.x % nc;
  const size_t t0 = (size_t)bb * s + (size_t)c * q;
  const int h0 = blockIdx.y * HB, nh = min(h, h0 + HB) - h0;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  auto load_head = [&](int buf, int hh) {
    copy_rows(sX + buf * q * ldp, ldp, x + (t0 * h + hh) * p, (size_t)h * p,
              q, p);
    copy_rows(sS + buf * p * ldn, ldn,
              s_in + (((size_t)bb * nc + c) * h + hh) * p * n, n, p, n);
    for (int j = tid; j < q; j += THREADS) {
      cp_async4(sCum + buf * q + j, cum + (t0 + j) * h + hh);
      cp_async4(sDt + buf * q + j, dt + (t0 + j) * h + hh);
    }
  };
  copy_rows(sC, ldn, Cm + t0 * n, n, q, n);
  copy_rows(sB, ldn, Bm + t0 * n, n, q, n);
  load_head(0, h0);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  // C B^T once for the block: warp w's rows r0..r0+15, key columns up to
  // its diagonal (16-column pairs u <= w)
  const int r0 = 16 * warp;
  const bool rows_ok = r0 < q;
  float cb[QMAX / 8][4];
#pragma unroll
  for (int t = 0; t < QMAX / 8; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) cb[t][e] = 0.f;
  if (rows_ok) {
    for (int k0 = 0; k0 < n; k0 += 16) {
      uint32_t af[4];
      ldsm_x4(af, sC + (r0 + (lane & 15)) * ldn + k0 + (lane >> 4) * 8);
#pragma unroll
      for (int u = 0; u < QMAX / 16; ++u) {
        if (u <= warp) {
          // B operand (k = n, columns j) is B stored [j][n]: direct load
          uint32_t bf[4];
          ldsm_x4(bf, sB + (16 * u + (lane & 7) + (lane >> 4) * 8) * ldn +
                          k0 + ((lane >> 3) & 1) * 8);
          mma16816(cb[2 * u], af, bf[0], bf[1]);
          mma16816(cb[2 * u + 1], af, bf[2], bf[3]);
        }
      }
    }
  }

  const int ra = r0 + (lane >> 2), rb = ra + 8;  // this thread's rows
  const int cq = 2 * (lane & 3);                 // and first column
  for (int k = 0; k < nh; ++k) {
    const int hh = h0 + k, buf = k & 1;
    if (k + 1 < nh) load_head(buf ^ 1, hh + 1);  // overlaps this head
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const bf16* bX = sX + buf * q * ldp;
    const bf16* bS = sS + buf * p * ldn;
    const float* bCum = sCum + buf * q;
    const float* bDt = sDt + buf * q;
    if (rows_ok) {
      float acc[PMAX / 8][4];
#pragma unroll
      for (int t = 0; t < PMAX / 8; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[t][e] = 0.f;
      // inter-chunk: C (q x n) . S_c^T (n x p); S_c stored [p][n]
      for (int k0 = 0; k0 < n; k0 += 16) {
        uint32_t af[4];
        ldsm_x4(af, sC + (r0 + (lane & 15)) * ldn + k0 + (lane >> 4) * 8);
#pragma unroll
        for (int u = 0; u < PMAX / 16; ++u) {
          if (16 * u < p) {
            uint32_t bf[4];
            ldsm_x4(bf, bS + (16 * u + (lane & 7) + (lane >> 4) * 8) * ldn +
                            k0 + ((lane >> 3) & 1) * 8);
            mma16816(acc[2 * u], af, bf[0], bf[1]);
            mma16816(acc[2 * u + 1], af, bf[2], bf[3]);
          }
        }
      }
      const float cum_a = bCum[ra], cum_b = bCum[rb];
      const float ea = expf(cum_a), eb = expf(cum_b);
#pragma unroll
      for (int t = 0; t < PMAX / 8; ++t) {
        acc[t][0] *= ea;
        acc[t][1] *= ea;
        acc[t][2] *= eb;
        acc[t][3] *= eb;
      }
      // intra-chunk: L (q x q, lower triangle) . x (q x p)
#pragma unroll
      for (int kk = 0; kk < QMAX / 16; ++kk) {
        if (kk <= warp) {
          float la[4], lb[4];  // rows ra, rb at columns j0 + {0, 1, 8, 9}
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int j = 16 * kk + cq + (e & 1) + (e >> 1) * 8;
            const float cj = bCum[j], dj = bDt[j];
            const int t = 2 * kk + (e >> 1);
            la[e] = j <= ra ? cb[t][e & 1] * __expf(cum_a - cj) * dj : 0.f;
            lb[e] = j <= rb ? cb[t][2 + (e & 1)] * __expf(cum_b - cj) * dj
                            : 0.f;
          }
          // rounding point 3: L in bf16, as the A fragment of L x
          uint32_t af[4];
          af[0] = pack_bf16(la[0], la[1]);
          af[1] = pack_bf16(lb[0], lb[1]);
          af[2] = pack_bf16(la[2], la[3]);
          af[3] = pack_bf16(lb[2], lb[3]);
#pragma unroll
          for (int u = 0; u < PMAX / 16; ++u) {
            if (16 * u < p) {
              // B operand (k = j, columns p) is x stored [j][p]: transposed
              uint32_t bf[4];
              ldsm_x4_t(bf, bX + (16 * kk + (lane & 7) +
                                  ((lane >> 3) & 1) * 8) * ldp +
                                16 * u + (lane >> 4) * 8);
              mma16816(acc[2 * u], af, bf[0], bf[1]);
              mma16816(acc[2 * u + 1], af, bf[2], bf[3]);
            }
          }
        }
      }
      bf16* ya = y + ((t0 + ra) * h + hh) * p;
      bf16* yb = y + ((t0 + rb) * h + hh) * p;
#pragma unroll
      for (int t = 0; t < PMAX / 8; ++t) {
        const int col = 8 * t + cq;
        if (col < p) {
          *reinterpret_cast<__nv_bfloat162*>(ya + col) =
              __floats2bfloat162_rn(acc[t][0], acc[t][1]);
          *reinterpret_cast<__nv_bfloat162*>(yb + col) =
              __floats2bfloat162_rn(acc[t][2], acc[t][3]);
        }
      }
    }
    __syncthreads();  // buffer buf is the head after next's
  }
}

}  // namespace

extern "C" {

// bf16 x/B/C/y, f32 dt/A.  x/y (b, s, h, p), dt (b, s, h), A (h,), B/C
// (b, s, n), all contiguous; p in {16, 32, 64}, n % 16 == 0 and n <= 128,
// chunk % 16 == 0 and chunk <= 128, s % chunk == 0.  Workspace from the
// caller: cum (b, s, h) f32, states (b, s / chunk, h, p, n) f32, s_in the
// same in bf16.  Three launches on `stream`; returns cudaError_t.
int ssd_scan_tc_launch(const void* x, const void* dt, const void* A,
                       const void* B, const void* C, void* y, void* cum,
                       void* states, void* s_in, int b, int s, int h, int p,
                       int n, int chunk, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int q = chunk;
  if (q <= 0 || q > QMAX || q % 16 || s % q || p <= 0 || p > PMAX ||
      p % 16 || n <= 0 || n > 128 || n % 16 || b <= 0 || h <= 0)
    return cudaErrorInvalidValue;
  const int nc = s / q;
  const dim3 grid(b * nc, (h + HB - 1) / HB);

  const size_t sm1 = state_smem(q, p, n);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_chunk_state_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)sm1);
  if (err != cudaSuccess) return err;
  ssd_chunk_state_kernel<<<grid, THREADS, sm1, st>>>(
      static_cast<const bf16*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(A), static_cast<const bf16*>(B),
      static_cast<float*>(cum), static_cast<float*>(states), s, h, p, n, q);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  const int pn = p * n;
  ssd_state_pass_kernel<<<dim3(b * h, (pn / 4 + THREADS - 1) / THREADS),
                          THREADS, 0, st>>>(
      static_cast<const float*>(states), static_cast<const float*>(cum),
      static_cast<bf16*>(s_in), s, h, pn, q);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  const size_t sm3 = scan_smem(q, p, n);
  err = cudaFuncSetAttribute(ssd_chunk_scan_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)sm3);
  if (err != cudaSuccess) return err;
  ssd_chunk_scan_kernel<<<grid, THREADS, sm3, st>>>(
      static_cast<const bf16*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(cum), static_cast<const bf16*>(B),
      static_cast<const bf16*>(C), static_cast<const bf16*>(s_in),
      static_cast<bf16*>(y), s, h, p, n, q);
  return cudaGetLastError();
}

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
