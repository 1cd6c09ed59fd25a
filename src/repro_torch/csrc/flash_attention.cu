// Flash attention forward (causal or bidirectional, GQA, optional sliding
// window) for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/flash_attention/kernel.py::
// flash_attention_bhsd (body _flash_kernel): softmax(Q K^T * scale + mask) V
// with q (B, H, Sq, hd), k/v (B, Hkv, Sk, hd); q head h reads kv head
// h / (H / Hkv); positions are aligned at 0 for q and k (key j is visible
// to query i when j <= i, and j > i - window when a window is set); rows
// with no visible key give 0.
//
// What it takes: f32 at head dims 16, 32, 64, 96, 112, 128 and 256, and
// bf16 at 16 and 32 (the reference's test shapes; no config uses them)
// and at 64 and 128 (only to time it against flash_attention_wgmma.cu,
// which takes every bf16 head dim a config uses: ops.py::variant picks).
//
// What bounds it: operations.  A causal pass does about 2 * B * H * S^2 * hd
// flops against 4 * B * H * S * hd elements moved, so beyond a few hundred
// positions it sits far above the H100's ~295 flops/byte ridge.  It spends
// those flops on f32 FMAs in CUDA cores (67 TFLOP/s peak): f32 has no
// faster route (TF32's tensor cores would round the inputs), and its main
// paths (decode-vs-forward checks at S <= 256) are short.
//
// Design: one block per (BQ-row q tile, b*h).  TPR consecutive threads own
// one query row, each holding every TPR-th element of q and of the output
// accumulator in registers, so per key they read consecutive shared-memory
// words (no bank conflicts) and combine partial dot products with TPR-wide
// shuffles.  The block loops only over the k tiles it can see (causal and
// window bound the loop instead of skipping masked tiles), staging each K/V
// tile in shared memory as f32.  The online softmax keeps m, l and the
// accumulator in f32 and masks p explicitly, so no result depends on the
// order in which tiles arrive (the TPU kernel relies on the diagonal tile
// coming last to wash out p = 1 on fully masked tiles).  Sq and Sk need no
// padding: ragged edges are masked in the kernel.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include <type_traits>

namespace {

constexpr int BQ = 64;

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

template <int HD> struct Tile {
  static constexpr int TPR = HD <= 16 ? 1 : HD <= 32 ? 2 : HD <= 128 ? 4 : 8;
  static constexpr int DPER = HD / TPR;  // elements of a row per thread
  static constexpr int BK = HD > 128 ? 32 : 64;  // keys per smem tile
  static constexpr int KC = 16;                   // keys per softmax step
  static constexpr int THREADS = BQ * TPR;
  static constexpr size_t SMEM = 2 * BK * HD * sizeof(float);
  static_assert(HD % TPR == 0, "head dim must split evenly over a row");
};

template <typename T, int HD>
__global__ void __launch_bounds__(Tile<HD>::THREADS)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ o, int H, int Hkv,
             int Sq, int Sk, int causal, int window, float scale) {
  using C = Tile<HD>;
  constexpr int TPR = C::TPR, DPER = C::DPER, BK = C::BK, KC = C::KC;
  extern __shared__ float smem[];
  float* sk = smem;            // [BK][HD]
  float* sv = smem + BK * HD;  // [BK][HD]

  const int tid = threadIdx.x;
  const int row = tid / TPR, part = tid % TPR;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int g = h / (H / Hkv);
  const int q0 = blockIdx.x * BQ, qi = q0 + row;
  const bool row_ok = qi < Sq;
  const T* qb = q + (size_t)bh * Sq * HD;
  const size_t kvoff = ((size_t)b * Hkv + g) * (size_t)Sk * HD;
  const T* kb = k + kvoff;
  const T* vb = v + kvoff;

  float qr[DPER], acc[DPER];
#pragma unroll
  for (int i = 0; i < DPER; ++i) {
    qr[i] = row_ok ? to_f(qb[(size_t)qi * HD + i * TPR + part]) : 0.f;
    acc[i] = 0.f;
  }
  float m = -INFINITY, l = 0.f;

  // keys visible to some row of this tile
  const int k_lo = window > 0 ? max(0, q0 - window + 1) : 0;
  const int k_hi = causal ? min(Sk, q0 + BQ) : Sk;

  for (int t0 = k_lo; t0 < k_hi; t0 += BK) {
    const int n = min(BK, k_hi - t0);
    __syncthreads();  // previous tile fully consumed
    for (int i = tid; i < BK * HD; i += C::THREADS) {
      const bool in = i < n * HD;
      sk[i] = in ? to_f(kb[(size_t)t0 * HD + i]) : 0.f;
      sv[i] = in ? to_f(vb[(size_t)t0 * HD + i]) : 0.f;
    }
    __syncthreads();

    // KC keys at a time, so the scores stay in registers
#pragma unroll 1
    for (int c = 0; c < BK; c += KC) {
      float s[KC];
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < KC; ++j) {
        const float* kr = sk + (c + j) * HD + part;
        float dot = 0.f;
#pragma unroll
        for (int i = 0; i < DPER; ++i) dot += qr[i] * kr[i * TPR];
#pragma unroll
        for (int off = TPR / 2; off > 0; off >>= 1)
          dot += __shfl_xor_sync(0xffffffffu, dot, off);
        const int kj = t0 + c + j;
        const bool ok = row_ok && c + j < n && (!causal || kj <= qi) &&
                        (window <= 0 || kj > qi - window);
        s[j] = ok ? dot * scale : -INFINITY;
        mx = fmaxf(mx, s[j]);
      }
      const float m_new = fmaxf(m, mx);
      if (m_new == -INFINITY) continue;  // nothing visible to this row yet
      const float alpha = expf(m - m_new);  // 0 while m is -inf
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < KC; ++j) {
        s[j] = s[j] == -INFINITY ? 0.f : expf(s[j] - m_new);
        psum += s[j];
      }
      l = l * alpha + psum;
#pragma unroll
      for (int i = 0; i < DPER; ++i) {
        float a = acc[i] * alpha;
#pragma unroll
        for (int j = 0; j < KC; ++j) a += s[j] * sv[(c + j) * HD + i * TPR + part];
        acc[i] = a;
      }
      m = m_new;
    }
  }

  if (row_ok) {
    T* ob = o + (size_t)bh * Sq * HD + (size_t)qi * HD;
#pragma unroll
    for (int i = 0; i < DPER; ++i)
      ob[i * TPR + part] = from_f<T>(l > 0.f ? acc[i] / l : 0.f);
  }
}

template <typename T, int HD>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int B, int H, int Hkv, int Sq, int Sk, int causal,
                   int window, float scale, cudaStream_t stream) {
  using C = Tile<HD>;
  cudaError_t err = cudaFuncSetAttribute(
      flash_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)C::SMEM);
  if (err != cudaSuccess) return err;
  dim3 grid((Sq + BQ - 1) / BQ, B * H);
  flash_kernel<T, HD><<<grid, C::THREADS, C::SMEM, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), H, Hkv, Sq, Sk, causal,
      window, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int hd, const void* q, const void* k, const void* v,
                     void* o, int B, int H, int Hkv, int Sq, int Sk,
                     int causal, int window, float scale, cudaStream_t s) {
#define CASE(D) \
  case D:       \
    return launch<T, D>(q, k, v, o, B, H, Hkv, Sq, Sk, causal, window, scale, s);
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
// hd), all contiguous.  Returns cudaError_t.
int flash_attention_launch(const void* q, const void* k, const void* v,
                           void* o, int dtype, int B, int H, int Hkv, int Sq,
                           int Sk, int hd, int causal, int window,
                           float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch<float>(hd, q, k, v, o, B, H, Hkv, Sq, Sk, causal, window,
                           scale, s);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(hd, q, k, v, o, B, H, Hkv, Sq, Sk, causal,
                                   window, scale, s);
  return cudaErrorInvalidValue;
}

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
