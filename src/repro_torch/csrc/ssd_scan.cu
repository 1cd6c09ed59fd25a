// Mamba2 SSD chunked scan (one B/C group) for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/ssd_scan/kernel.py::ssd_scan
// (body _ssd_kernel).  Inputs x (b, s, h, p) and B/C (b, s, n) in the model
// dtype, dt (b, s, h) and A (h,) in f32; output y (b, s, h, p) like x.  Per
// chunk of q rows and per head, with cum the running sum of dt * A along
// the chunk:
//   y_i   = sum_{j <= i} (C_i . B_j) exp(cum_i - cum_j) dt_j x_j
//           + exp(cum_i) C_i . S
//   S    <- exp(cum_last) S + sum_j exp(cum_last - cum_j) dt_j x_j B_j^T
// with the (p, n) state S in f32, zero before the first chunk.  All
// arithmetic is f32; only y is rounded to the model dtype.
//
// What bounds it: at Mamba2-2.7B's shape in bf16, bytes (one read of x,
// dt, B, C and one write of y, 87 MB at b 2, s 2048: 0.026 ms at 3.35
// TB/s); in f32, operations (about 16 GFLOP of chunk products, 0.24 ms at
// the 67 TFLOP/s f32 peak).  This first version does its products on f32
// FMAs from shared memory, not on tensor cores: it is right and simple
// first, and far from either bound.
//
// Design: the TPU kernel keeps a block of 8 heads' state in VMEM (256 KB
// at p 64, n 128, more than a Hopper block's 227 KB).  Here one block owns
// one (batch row, head) and walks the chunks in order, keeping that head's
// state in shared memory (32 KB); the chunk axis is the sequential loop
// that the TPU grid's last axis was.  Per chunk it stages dt, B (q x n)
// and x (q x p) as f32, takes the cumsum with one warp scan, then goes
// down the chunk in tiles of 32 rows: it stages those rows of C, builds
// their rows of the decay-weighted C B^T, and writes their y, reading the
// old state.  Last it updates the state.  Entries above the diagonal are
// set to 0 without calling exp: there cum_i - cum_j > 0, and at strong
// decay (A = -16, dt = 0.1 over 128 rows) exp gives +inf, which the
// reference removes with a select, not a product.  Shared-memory rows of B
// and S are padded by one float so reads with lanes along a row index hit
// distinct banks.  Each block recomputes C B^T, which is the same for every
// head of its batch row: that, and b * h blocks of 256 threads at one
// block per SM, are what the tensor-core version has to change.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int THREADS = 256;
constexpr int TI = 32;  // chunk rows per tile of C and of the weights M

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f(float x) {
  return __float2bfloat16(x);
}

size_t smem_bytes(int q, int p, int n) {
  const int ti = q < TI ? q : TI;
  return sizeof(float) * ((size_t)q * (n + 1)    // B rows
                          + (size_t)q * p        // x rows
                          + (size_t)p * (n + 1)  // state
                          + (size_t)ti * n       // C rows of the tile
                          + (size_t)ti * q       // M rows of the tile
                          + 3 * (size_t)q);      // cum, dt, state weights
}

// Supports p <= 64 with p % 8 == 0, n <= 128 and q <= 128 with q % 4 == 0
// (the wrapper admits p in {16, 32, 64}, n and q in {16, 32, 64, 128}).
template <typename T>
__global__ void __launch_bounds__(THREADS)
ssd_kernel(const T* __restrict__ x, const float* __restrict__ dt,
           const float* __restrict__ A, const T* __restrict__ Bm,
           const T* __restrict__ Cm, T* __restrict__ y, int s, int h, int p,
           int n, int q) {
  extern __shared__ float smem[];
  const int ti = min(TI, q);
  const int ldb = n + 1;
  float* sB = smem;             // [q][n + 1]
  float* sX = sB + q * ldb;     // [q][p]
  float* sS = sX + q * p;       // [p][n + 1] state carried over chunks
  float* sC = sS + p * ldb;     // [ti][n]
  float* sM = sC + ti * n;      // [ti][q]
  float* sCum = sM + ti * q;    // [q]
  float* sDt = sCum + q;        // [q]
  float* sW = sDt + q;          // [q] exp(cum_last - cum_j) * dt_j

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.x / h, head = blockIdx.x % h;
  const float a = A[head];

  for (int i = tid; i < p * ldb; i += THREADS) sS[i] = 0.f;

  for (int c = 0; c < s / q; ++c) {
    const size_t t0 = (size_t)b * s + (size_t)c * q;  // first token row
    __syncthreads();  // the previous chunk is done with sB, sX, sW, sS
    for (int j = tid; j < q; j += THREADS) sDt[j] = dt[(t0 + j) * h + head];
    for (int i = tid; i < q * n; i += THREADS) {
      const int j = i / n, k = i - j * n;
      sB[j * ldb + k] = to_f(Bm[t0 * n + i]);
    }
    for (int i = tid; i < q * p; i += THREADS) {
      const int j = i / p, d = i - j * p;
      sX[i] = to_f(x[((t0 + j) * h + head) * p + d]);
    }
    __syncthreads();

    // cumsum of dt * a along the chunk: each lane of warp 0 sums a run of
    // consecutive rows, then the runs are offset by a warp scan
    if (warp == 0) {
      const int per = (q + 31) / 32;
      const int j0 = lane * per, j1 = min(j0 + per, q);
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
    __syncthreads();
    const float cum_last = sCum[q - 1];
    for (int j = tid; j < q; j += THREADS)
      sW[j] = expf(cum_last - sCum[j]) * sDt[j];

    for (int i0 = 0; i0 < q; i0 += ti) {
      for (int i = tid; i < ti * n; i += THREADS)
        sC[i] = to_f(Cm[(t0 + i0) * n + i]);
      __syncthreads();

      // M[r][j] = (C_r . B_j) exp(cum_i - cum_j) dt_j for j <= i = i0 + r,
      // else 0.  Warp w takes rows 4w..4w+3, lane l columns l + 32t.
      const int r0 = warp * 4;
      const int jmax = i0 + ti;  // no row of this tile sees j >= jmax
      const int nt = (jmax + 31) / 32;
      if (r0 < ti) {
        float acc[4][4] = {};
        for (int k = 0; k < n; ++k) {
          float cv[4], bv[4];
#pragma unroll
          for (int rr = 0; rr < 4; ++rr) cv[rr] = sC[(r0 + rr) * n + k];
#pragma unroll
          for (int t = 0; t < 4; ++t) {
            const int j = lane + 32 * t;
            bv[t] = (t < nt && j < jmax) ? sB[j * ldb + k] : 0.f;
          }
#pragma unroll
          for (int rr = 0; rr < 4; ++rr)
#pragma unroll
            for (int t = 0; t < 4; ++t) acc[rr][t] += cv[rr] * bv[t];
        }
#pragma unroll
        for (int rr = 0; rr < 4; ++rr) {
          const int i = i0 + r0 + rr;
#pragma unroll
          for (int t = 0; t < 4; ++t) {
            const int j = lane + 32 * t;
            if (t < nt && j < jmax)
              sM[(r0 + rr) * q + j] =
                  j <= i ? acc[rr][t] * expf(sCum[i] - sCum[j]) * sDt[j]
                         : 0.f;
          }
        }
      }
      __syncthreads();

      // y rows of the tile: warp w rows 4w..4w+3, lane l columns l + 32u
      if (r0 < ti) {
        float inter[4][2] = {}, intra[4][2] = {};
        for (int k = 0; k < n; ++k) {
          float cv[4], sv[2];
#pragma unroll
          for (int rr = 0; rr < 4; ++rr) cv[rr] = sC[(r0 + rr) * n + k];
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            const int d = lane + 32 * u;
            sv[u] = d < p ? sS[d * ldb + k] : 0.f;
          }
#pragma unroll
          for (int rr = 0; rr < 4; ++rr)
#pragma unroll
            for (int u = 0; u < 2; ++u) inter[rr][u] += cv[rr] * sv[u];
        }
        const int jend = i0 + r0 + 4;  // M is 0 past each row's diagonal
        for (int j = 0; j < jend; ++j) {
          float mv[4], xv[2];
#pragma unroll
          for (int rr = 0; rr < 4; ++rr) mv[rr] = sM[(r0 + rr) * q + j];
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            const int d = lane + 32 * u;
            xv[u] = d < p ? sX[j * p + d] : 0.f;
          }
#pragma unroll
          for (int rr = 0; rr < 4; ++rr)
#pragma unroll
            for (int u = 0; u < 2; ++u) intra[rr][u] += mv[rr] * xv[u];
        }
#pragma unroll
        for (int rr = 0; rr < 4; ++rr) {
          const int i = i0 + r0 + rr;
          const float e = expf(sCum[i]);
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            const int d = lane + 32 * u;
            if (d < p)
              y[((t0 + i) * h + head) * p + d] =
                  from_f<T>(intra[rr][u] + inter[rr][u] * e);
          }
        }
      }
      __syncthreads();  // the next tile overwrites sC and sM
    }

    // state update: warp w rows d = 8w..8w+7, lane l columns k = l + 32t
    const int d0 = warp * 8;
    if (d0 < p) {
      float acc[8][4] = {};
      for (int j = 0; j < q; ++j) {
        const float wj = sW[j];
        float xv[8], bv[4];
#pragma unroll
        for (int dd = 0; dd < 8; ++dd) xv[dd] = sX[j * p + d0 + dd] * wj;
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          const int k = lane + 32 * t;
          bv[t] = k < n ? sB[j * ldb + k] : 0.f;
        }
#pragma unroll
        for (int dd = 0; dd < 8; ++dd)
#pragma unroll
          for (int t = 0; t < 4; ++t) acc[dd][t] += xv[dd] * bv[t];
      }
      const float dec = expf(cum_last);
#pragma unroll
      for (int dd = 0; dd < 8; ++dd)
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          const int k = lane + 32 * t;
          if (k < n) {
            float* sp = &sS[(d0 + dd) * ldb + k];
            *sp = *sp * dec + acc[dd][t];
          }
        }
    }
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* dt, const void* A,
                   const void* B, const void* C, void* y, int b, int s,
                   int h, int p, int n, int q, cudaStream_t stream) {
  const size_t smem = smem_bytes(q, p, n);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  ssd_kernel<T><<<b * h, THREADS, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(A), static_cast<const T*>(B),
      static_cast<const T*>(C), static_cast<T*>(y), s, h, p, n, q);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (of x, B, C and y).  x/y (b, s, h, p),
// dt (b, s, h) f32, A (h,) f32, B/C (b, s, n), all contiguous; s % chunk
// == 0.  Returns cudaError_t.
int ssd_scan_launch(const void* x, const void* dt, const void* A,
                    const void* B, const void* C, void* y, int dtype, int b,
                    int s, int h, int p, int n, int chunk, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (chunk <= 0 || chunk > 128 || chunk % 4 || s % chunk || p > 64 ||
      p % 8 || n > 128 || n <= 0)
    return cudaErrorInvalidValue;
  if (dtype == 0)
    return launch<float>(x, dt, A, B, C, y, b, s, h, p, n, chunk, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, dt, A, B, C, y, b, s, h, p, n, chunk,
                                 st);
  return cudaErrorInvalidValue;
}

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
