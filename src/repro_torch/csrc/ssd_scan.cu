// Mamba2 SSD chunked scan (one B/C group) in f32 on Hopper (sm_90a):
// chunk-parallel, every product on f32 FMAs, register-tiled.
//
// Replaces the TPU kernel src/repro/kernels/ssd_scan/kernel.py::ssd_scan
// (body _ssd_kernel) for f32 inputs; bf16 inputs take ssd_scan_tc.cu
// (kernels/ssd_scan/ops.py::variant picks).  Inputs x (b, s, h, p), B/C
// (b, s, n), dt (b, s, h) and A (h,), all f32; output y (b, s, h, p) f32.
// Per chunk of q rows and per head, with cum the running sum of dt * A
// along the chunk:
//   y_i = sum_{j <= i} (C_i . B_j) exp(cum_i - cum_j) dt_j x_j
//         + exp(cum_i) C_i . S_c
//   S_{c+1} = exp(cum_last) S_c + sum_j exp(cum_last - cum_j) dt_j x_j B_j^T
// with the (p, n) state S_c entering chunk c, zero for the first.  No
// TF32 and no rounding: every product and sum is f32.
//
// What bounds it: operations.  At Mamba2-2.7B's b 2, s 2048, h 80, p 64,
// n 128, chunk 128 the chunk products are 13.5 GFLOP counting only the
// lower triangles of C B^T and L x (0.20 ms at the 67 TFLOP/s f32 peak);
// one read of the inputs and one write of y are 176 MB (0.05 ms at 3.35
// TB/s), and the f32 chunk states between the steps about 3 x 84 MB more.
//
// Design: the split of Mamba2's own chunked implementation, as three
// kernels launched back to back by one call; only the state is walked in
// chunk order, and C B^T is computed once per block of heads, not per
// head.
// 1. Chunk states, one block per (b, chunk, block of hb heads): the warp
//    scan of dt * A gives cum (written for steps 2 and 3); each head's
//    contribution sum_j w_j x_j B_j^T, w_j = exp(cum_last - cum_j) dt_j,
//    is written transposed, (b, nc, h, n, p), so step 3 reads S^T rows.
// 2. State passing, one thread per 4 state elements of a (b, head): S <-
//    exp(cum_last) S + contribution, chunk by chunk, in place: the buffer
//    then holds the f32 state entering each chunk.
// 3. Chunk scan, one block per (b, chunk, block of hb heads): C B^T (q x q
//    over n) once per block, kept in registers (an 8 x 8 tile a thread,
//    lower-triangle tiles only) and shared by the block's heads (one
//    group: C and B do not depend on the head).  Per head: acc = C S^T,
//    rows scaled by exp(cum_i); then L = C B^T * exp(cum_i - cum_j) dt_j
//    is written to shared memory from the registers, entries above the
//    diagonal 0 without calling exp (at A = -16, dt = 0.1 over 128 rows
//    exp(cum_i - cum_j) there is +inf); then acc += L x.
// Products are SIMT GEMMs from shared memory: each thread owns an 8 x 4
// (steps 1 and 3) or 8 x 8 (C B^T) output tile and reads its operands as
// float4.  In step 3 a thread's 8 rows are two quads mirrored about the
// middle of the chunk (rows 4a.. and q - 4 - 4a..), so every thread does
// the same share of the triangular L x.  The next head's operands load
// while this head computes: in step 1, x through registers (so that two
// blocks fit on an SM), in step 3 x, cum, dt and S by cp.async.  Step 2
// keeps four chunks' loads in flight ahead of its dependent update.
// `hb` comes from the wrapper
// (ops.py::heads_per_block), which trades C B^T's cost per block against
// filling the 132 SMs.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int SMEM_MAX = 232448;

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
__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ void st4(float* p, float a, float b, float c,
                                    float d) {
  *reinterpret_cast<float4*>(p) = make_float4(a, b, c, d);
}

// cp.async `rows` rows of `cols` floats (cols % 4 == 0) from global rows
// `gstride` floats apart into shared rows `sstride` floats apart.
__device__ __forceinline__ void copy_rows(float* dst, int sstride,
                                          const float* src, size_t gstride,
                                          int rows, int cols) {
  const int cpr = cols / 4;
  for (int i = threadIdx.x; i < rows * cpr; i += THREADS) {
    const int r = i / cpr, c = i - r * cpr;
    cp_async16(dst + r * sstride + c * 4, src + r * gstride + c * 4);
  }
}

// A (rows x cols) f32 block in registers, PF float4s a thread: the
// next head's operand is loaded while this head computes, then stored to
// shared memory (cols % 4 == 0, rows * cols <= 4 * PF * THREADS).
constexpr int PF = 8;  // 128 x 64 floats over 256 threads
__device__ __forceinline__ void fetch_rows(float4* v, const float* src,
                                           size_t gstride, int rows,
                                           int cols) {
  const int cpr = cols / 4;
#pragma unroll
  for (int r = 0; r < PF; ++r) {
    const int i = threadIdx.x + r * THREADS;
    if (i < rows * cpr) {
      const int row = i / cpr, c = i - row * cpr;
      v[r] = ld4(src + row * gstride + c * 4);
    }
  }
}
__device__ __forceinline__ void store_rows(float* dst, int sstride,
                                           const float4* v, int rows,
                                           int cols) {
  const int cpr = cols / 4;
#pragma unroll
  for (int r = 0; r < PF; ++r) {
    const int i = threadIdx.x + r * THREADS;
    if (i < rows * cpr) {
      const int row = i / cpr, c = i - row * cpr;
      *reinterpret_cast<float4*>(dst + row * sstride + c * 4) = v[r];
    }
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
  return 4 * ((size_t)q * n + (size_t)q * p + 3 * (size_t)q);
}

__global__ void __launch_bounds__(THREADS, 2)
ssd_chunk_state_kernel(const float* __restrict__ x,
                       const float* __restrict__ dt,
                       const float* __restrict__ A,
                       const float* __restrict__ Bm, float* __restrict__ cum,
                       float* __restrict__ states, int s, int h, int p,
                       int n, int q, int hb) {
  extern __shared__ __align__(16) float smem[];
  float* sB = smem;             // [q][n]
  float* sX = sB + q * n;       // [q][p], then w_j x_j
  float* sDt = sX + q * p;      // [2][q]
  float* sCum = sDt + 2 * q;    // [q]

  const int nc = s / q, bb = blockIdx.x / nc, c = blockIdx.x % nc;
  const size_t t0 = (size_t)bb * s + (size_t)c * q;  // first token row
  const int h0 = blockIdx.y * hb, h1 = min(h, h0 + hb);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // this thread's tile of the (n x p) result: rows 8kt.., columns 4dq..
  const int p4 = p / 4, items = (n / 8) * p4;
  const int dq = tid % p4, kt = tid / p4;

  auto load_dt = [&](int buf, int hh) {
    for (int j = tid; j < q; j += THREADS)
      cp_async4(sDt + buf * q + j, dt + (t0 + j) * h + hh);
  };
  copy_rows(sB, n, Bm + t0 * n, n, q, n);
  load_dt(0, h0);
  cp_async_commit();
  float4 xv[PF];  // the head's x, loaded while the previous head computes
  fetch_rows(xv, x + (t0 * h + h0) * p, (size_t)h * p, q, p);

  for (int hh = h0; hh < h1; ++hh) {
    const int buf = (hh - h0) & 1;
    __syncthreads();  // the previous head is done with sX and sCum
    store_rows(sX, p, xv, q, p);
    if (hh + 1 < h1) load_dt(buf ^ 1, hh + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const float* bDt = sDt + buf * q;
    if (warp == 0) chunk_cumsum(bDt, sCum, A[hh], q, lane);
    __syncthreads();
    const float cum_last = sCum[q - 1];
    for (int j = tid; j < q; j += THREADS) cum[(t0 + j) * h + hh] = sCum[j];
    for (int i = tid; i < q * p4; i += THREADS) {
      const int j = i / p4;
      const float w = expf(cum_last - sCum[j]) * bDt[j];
      float4 v = ld4(sX + i * 4);
      st4(sX + i * 4, v.x * w, v.y * w, v.z * w, v.w * w);
    }
    if (hh + 1 < h1)  // in flight during the product
      fetch_rows(xv, x + (t0 * h + hh + 1) * p, (size_t)h * p, q, p);
    __syncthreads();

    if (tid < items) {
      float acc[8][4];
#pragma unroll
      for (int r = 0; r < 8; ++r)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[r][e] = 0.f;
      const float* pa = sB + 8 * kt;
      const float* pb = sX + 4 * dq;
#pragma unroll 4
      for (int j = 0; j < q; ++j) {
        const float4 a0 = ld4(pa + j * n), a1 = ld4(pa + j * n + 4);
        const float4 bv = ld4(pb + j * p);
        const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
        const float bw[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
        for (int r = 0; r < 8; ++r)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[r][e] = fmaf(av[r], bw[e], acc[r][e]);
      }
      float* out = states + (((size_t)bb * nc + c) * h + hh) * n * p;
#pragma unroll
      for (int r = 0; r < 8; ++r)
        st4(out + (8 * kt + r) * p + 4 * dq, acc[r][0], acc[r][1], acc[r][2],
            acc[r][3]);
    }
  }
}

// ---------------------------------------------------------------------------
// 2. state passing (in place)
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(THREADS)
ssd_state_pass_kernel(float* __restrict__ states,
                      const float* __restrict__ cum, int s, int h, int pn,
                      int q) {
  const int nc = s / q;
  const int bb = blockIdx.x / h, hh = blockIdx.x % h;
  const int e = (blockIdx.y * THREADS + threadIdx.x) * 4;
  if (e >= pn) return;
  // chunk c's (b, head) state at base + c * stride; its cum_last at
  // cbase + c * cstride.  Loads run D chunks ahead of the dependent
  // update, so a thread has D loads in flight instead of one.
  constexpr int D = 4;
  float* base = states + ((size_t)bb * nc * h + hh) * pn + e;
  const size_t stride = (size_t)h * pn;
  const float* cbase = cum + ((size_t)bb * s + q - 1) * h + hh;
  const size_t cstride = (size_t)q * h;
  float4 cv[D];
  float cl[D];
#pragma unroll
  for (int u = 0; u < D; ++u)
    if (u < nc) {
      cv[u] = ld4(base + u * stride);
      cl[u] = cbase[u * cstride];
    }
  float4 st = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int c0 = 0; c0 < nc; c0 += D) {
#pragma unroll
    for (int u = 0; u < D; ++u) {
      const int c = c0 + u;
      if (c < nc) {
        const float4 v = cv[u];
        const float dec = expf(cl[u]);
        if (c + D < nc) {
          cv[u] = ld4(base + (c + D) * stride);
          cl[u] = cbase[(c + D) * cstride];
        }
        st4(base + c * stride, st.x, st.y, st.z, st.w);  // entering c
        st.x = fmaf(dec, st.x, v.x);
        st.y = fmaf(dec, st.y, v.y);
        st.z = fmaf(dec, st.z, v.z);
        st.w = fmaf(dec, st.w, v.w);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// 3. chunk scan
// ---------------------------------------------------------------------------

size_t scan_smem(int q, int p, int n) {
  const size_t u = n > q ? (size_t)n * q : (size_t)q * q;  // B^T, then L^T
  return 4 * ((size_t)n * q + u + (size_t)n * p + 2 * (size_t)q * p +
              4 * (size_t)q);
}

// rows [0, q) x cols [0, n) of a row-major global matrix into shared
// [n][ldq], transposed; neighbouring threads take neighbouring rows, so
// the scalar stores fall in distinct banks
__device__ __forceinline__ void load_transposed(float* dst, int ldq,
                                                const float* src, int q,
                                                int n) {
  const int n4 = n / 4;
  for (int idx = threadIdx.x; idx < q * n4; idx += THREADS) {
    const int i = idx % q, k = 4 * (idx / q);
    const float4 v = ld4(src + (size_t)i * n + k);
    dst[(k + 0) * ldq + i] = v.x;
    dst[(k + 1) * ldq + i] = v.y;
    dst[(k + 2) * ldq + i] = v.z;
    dst[(k + 3) * ldq + i] = v.w;
  }
}

__global__ void __launch_bounds__(THREADS, 1)
ssd_chunk_scan_kernel(const float* __restrict__ x,
                      const float* __restrict__ dt,
                      const float* __restrict__ cum,
                      const float* __restrict__ Bm,
                      const float* __restrict__ Cm,
                      const float* __restrict__ s_in, float* __restrict__ y,
                      int s, int h, int p, int n, int q, int hb) {
  extern __shared__ __align__(16) float smem[];
  const int ldq = q;
  float* sCT = smem;                         // [n][q] C^T
  float* sU = sCT + n * q;                   // B^T [n][q], then L^T [q][q]
  float* sS = sU + (n > q ? n : q) * q;      // [n][p] S^T
  float* sX = sS + n * p;                    // [2][q][p]
  float* sCum = sX + 2 * q * p;              // [2][q]
  float* sDt = sCum + 2 * q;                 // [2][q]

  const int nc = s / q, bb = blockIdx.x / nc, c = blockIdx.x % nc;
  const size_t t0 = (size_t)bb * s + (size_t)c * q;
  const int h0 = blockIdx.y * hb, h1 = min(h, h0 + hb);
  const int tid = threadIdx.x;

  // the next head's operands load while this head computes (cp.async): x,
  // cum and dt into the other half of their buffers from the start of the
  // head, S^T once this head's C S^T is done with it
  auto load_head = [&](int buf, int hh) {
    copy_rows(sX + buf * q * p, p, x + (t0 * h + hh) * p, (size_t)h * p, q,
              p);
    for (int j = tid; j < q; j += THREADS) {
      cp_async4(sCum + buf * q + j, cum + (t0 + j) * h + hh);
      cp_async4(sDt + buf * q + j, dt + (t0 + j) * h + hh);
    }
  };
  auto load_state = [&](int hh) {
    copy_rows(sS, p, s_in + (((size_t)bb * nc + c) * h + hh) * n * p, p, n,
              p);
  };
  load_head(0, h0);
  load_state(h0);
  cp_async_commit();
  load_transposed(sCT, ldq, Cm + t0 * n, q, n);
  load_transposed(sU, ldq, Bm + t0 * n, q, n);
  __syncthreads();

  // C B^T: thread t owns the 8 x 8 tile (rows 8ti.., columns 8tj..), lower
  // triangle of tiles only
  const int q8 = q / 8;
  const int ti = tid % q8, tj = tid / q8;
  const bool cb_tile = tid < q8 * q8 && tj <= ti;
  float cb[8][8];
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int e = 0; e < 8; ++e) cb[r][e] = 0.f;
  if (cb_tile) {
    for (int k = 0; k < n; ++k) {
      const float4 a0 = ld4(sCT + k * ldq + 8 * ti);
      const float4 a1 = ld4(sCT + k * ldq + 8 * ti + 4);
      const float4 b0 = ld4(sU + k * ldq + 8 * tj);
      const float4 b1 = ld4(sU + k * ldq + 8 * tj + 4);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bw[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int r = 0; r < 8; ++r)
#pragma unroll
        for (int e = 0; e < 8; ++e) cb[r][e] = fmaf(av[r], bw[e], cb[r][e]);
    }
  }

  // this thread's tile of y: rows 4a..4a+3 and q-4-4a..q-1-4a, columns
  // 4dq..4dq+3
  const int p4 = p / 4, items = (q / 8) * p4;
  const int dq = tid % p4, a = tid / p4;
  const int lo = 4 * a, hi = q - 4 - 4 * a;

  for (int hh = h0; hh < h1; ++hh) {
    const int buf = (hh - h0) & 1;
    const float* bX = sX + buf * q * p;
    const float* bCum = sCum + buf * q;
    const float* bDt = sDt + buf * q;
    __syncthreads();  // the previous head is done with sU and buffer buf^1
    if (hh + 1 < h1) load_head(buf ^ 1, hh + 1);
    cp_async_commit();
    cp_async_wait<1>();  // this head's x, cum, dt and S^T have landed
    __syncthreads();

    // inter-chunk: acc = C (q x n) . S^T (n x p), rows scaled by
    // exp(cum_i)
    float acc[8][4];
#pragma unroll
    for (int r = 0; r < 8; ++r)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[r][e] = 0.f;
    if (tid < items) {
#pragma unroll 4
      for (int k = 0; k < n; ++k) {
        const float4 a0 = ld4(sCT + k * ldq + lo);
        const float4 a1 = ld4(sCT + k * ldq + hi);
        const float4 bv = ld4(sS + k * p + 4 * dq);
        const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
        const float bw[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
        for (int r = 0; r < 8; ++r)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            acc[r][e] = fmaf(av[r], bw[e], acc[r][e]);
      }
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        const float g = expf(bCum[r < 4 ? lo + r : hi + r - 4]);
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[r][e] *= g;
      }
    }
    __syncthreads();  // S^T is consumed; sU becomes L^T
    if (hh + 1 < h1) load_state(hh + 1);
    cp_async_commit();

    if (cb_tile) {
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int j = 8 * tj + e;
        const float cj = bCum[j], dj = bDt[j];
        float l[8];
#pragma unroll
        for (int r = 0; r < 8; ++r) {
          const int i = 8 * ti + r;
          l[r] = j <= i ? cb[r][e] * expf(bCum[i] - cj) * dj : 0.f;
        }
        st4(sU + j * ldq + 8 * ti, l[0], l[1], l[2], l[3]);
        st4(sU + j * ldq + 8 * ti + 4, l[4], l[5], l[6], l[7]);
      }
    }
    __syncthreads();

    // intra-chunk: acc += L (q x q, lower triangle) . x (q x p); the low
    // quad needs j <= lo + 3, the high quad j <= hi + 3
    if (tid < items) {
      int j = 0;
#pragma unroll 2
      for (; j < lo + 4; ++j) {
        const float4 a0 = ld4(sU + j * ldq + lo);
        const float4 a1 = ld4(sU + j * ldq + hi);
        const float4 bv = ld4(bX + j * p + 4 * dq);
        const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
        const float bw[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
        for (int r = 0; r < 8; ++r)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            acc[r][e] = fmaf(av[r], bw[e], acc[r][e]);
      }
#pragma unroll 4
      for (; j < hi + 4; ++j) {
        const float4 a1 = ld4(sU + j * ldq + hi);
        const float4 bv = ld4(bX + j * p + 4 * dq);
        const float av[4] = {a1.x, a1.y, a1.z, a1.w};
        const float bw[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            acc[4 + r][e] = fmaf(av[r], bw[e], acc[4 + r][e]);
      }
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        const int i = r < 4 ? lo + r : hi + r - 4;
        st4(y + ((t0 + i) * h + hh) * p + 4 * dq, acc[r][0], acc[r][1],
            acc[r][2], acc[r][3]);
      }
    }
  }
}

// Raise the kernel's dynamic shared memory limit once per device.
template <int ID>
cudaError_t allow_smem(const void* kernel) {
  static unsigned done = 0;  // bit per device
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 32 && (done >> dev & 1u)) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             SMEM_MAX);
  if (err == cudaSuccess && dev < 32) done |= 1u << dev;
  return err;
}

}  // namespace

extern "C" {

// f32 x/dt/A/B/C/y.  x/y (b, s, h, p), dt (b, s, h), A (h,), B/C (b, s,
// n), all contiguous; p in {16, 32, 64}, n % 8 == 0 and n <= 128, chunk %
// 8 == 0 and chunk <= 128, s % chunk == 0; hb heads per block (1..16).
// Workspace from the caller: cum (b, s, h) f32, states (b, s / chunk, h,
// n, p) f32.  Three launches on `stream`; returns cudaError_t.
int ssd_scan_launch(const void* x, const void* dt, const void* A,
                    const void* B, const void* C, void* y, void* cum,
                    void* states, int b, int s, int h, int p, int n,
                    int chunk, int hb, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int q = chunk;
  if (q <= 0 || q > 128 || q % 8 || s % q || p <= 0 || p > 64 || p % 16 ||
      n <= 0 || n > 128 || n % 8 || b <= 0 || h <= 0 || hb < 1 || hb > 16)
    return cudaErrorInvalidValue;
  const int nc = s / q;
  const dim3 grid(b * nc, (h + hb - 1) / hb);
  cudaError_t err;

  if ((err = allow_smem<1>((const void*)ssd_chunk_state_kernel)) !=
      cudaSuccess)
    return err;
  ssd_chunk_state_kernel<<<grid, THREADS, state_smem(q, p, n), st>>>(
      static_cast<const float*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(A), static_cast<const float*>(B),
      static_cast<float*>(cum), static_cast<float*>(states), s, h, p, n, q,
      hb);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  const int pn = p * n;
  ssd_state_pass_kernel<<<dim3(b * h, (pn / 4 + THREADS - 1) / THREADS),
                          THREADS, 0, st>>>(
      static_cast<float*>(states), static_cast<const float*>(cum), s, h, pn,
      q);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  if ((err = allow_smem<3>((const void*)ssd_chunk_scan_kernel)) !=
      cudaSuccess)
    return err;
  ssd_chunk_scan_kernel<<<grid, THREADS, scan_smem(q, p, n), st>>>(
      static_cast<const float*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(cum), static_cast<const float*>(B),
      static_cast<const float*>(C), static_cast<const float*>(states),
      static_cast<float*>(y), s, h, p, n, q, hb);
  return cudaGetLastError();
}

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
