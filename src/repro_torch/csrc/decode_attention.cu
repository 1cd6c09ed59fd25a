// Single-query decode attention against a KV cache, for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/decode_attention/kernel.py::
// decode_attention_bhd (body _decode_kernel): one query row per (b, h)
// against caches (B, Hkv, T, hd), masked to positions
// [max(0, length - window), min(length, T)) with `length` read on the
// device, online softmax in f32, output in the input dtype.
//
// What bounds it: bytes.  Each step reads the live part of the K and V
// cache once (2 * B * Hkv * len * hd * sizeof(T)) and does 4 flops per
// byte-pair of it, far below the ~295 flops/byte at which an H100 stops
// being memory-bound.
//
// Design: one block per (b, kv head).  The block handles that head's
// `rep = H / Hkv` query heads together, so every K/V row is read from
// device memory once for all of them (the TPU kernel re-reads the cache
// per q head).  It walks only the needed cache range in tiles of BT rows
// staged in shared memory as f32 (rows padded by one float so the
// row-strided score reads hit distinct banks); the running max, sum and
// accumulator live in shared memory.  `length` is an int32 on the device,
// so the serving loop never syncs with the host, and positions past T
// are not read (length > T attends to the whole cache, as the reference
// does).  With B * Hkv blocks this fills few SMs at small batch; a split
// over the cache axis is the known next step.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int THREADS = 256;
constexpr int NWARPS = THREADS / 32;

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
  static constexpr int BT = HD > 128 ? 32 : 64;  // cache rows per tile
};

template <int HD> size_t smem_bytes(int rep) {
  constexpr int BT = Tile<HD>::BT;
  return sizeof(float) *
         (2 * rep * HD + 2 * BT * (HD + 1) + rep * BT + 3 * rep);
}

template <typename T, int HD>
__global__ void __launch_bounds__(THREADS)
decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, T* __restrict__ o,
              const int* __restrict__ length_ptr, int Hkv, int rep, int T_len,
              int window, float scale) {
  constexpr int BT = Tile<HD>::BT;
  constexpr int LD = HD + 1;
  extern __shared__ float smem[];
  float* sq = smem;                 // [rep][HD] query rows
  float* sacc = sq + rep * HD;      // [rep][HD] unnormalised output
  float* sk = sacc + rep * HD;      // [BT][LD]
  float* sv = sk + BT * LD;         // [BT][LD]
  float* ss = sv + BT * LD;         // [rep][BT] scores, then probabilities
  float* sm = ss + rep * BT;        // [rep] running max
  float* sl = sm + rep;             // [rep] running sum
  float* sa = sl + rep;             // [rep] rescale factor of this tile

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.x / Hkv, g = blockIdx.x % Hkv;
  const int H = Hkv * rep;
  const size_t qoff = ((size_t)b * H + (size_t)g * rep) * HD;
  const size_t kvoff = ((size_t)b * Hkv + g) * (size_t)T_len * HD;
  const T* kb = k + kvoff;
  const T* vb = v + kvoff;

  const int length = *length_ptr;
  const int end = min(length, T_len);
  const int start = window > 0 ? max(0, length - window) : 0;

  for (int i = tid; i < rep * HD; i += THREADS) {
    sq[i] = to_f(q[qoff + i]);
    sacc[i] = 0.f;
  }
  for (int r = tid; r < rep; r += THREADS) {
    sm[r] = -INFINITY;
    sl[r] = 0.f;
  }

  for (int t0 = start; t0 < end; t0 += BT) {
    const int n = min(BT, end - t0);
    __syncthreads();  // previous tile fully consumed (and init visible)
    for (int i = tid; i < n * HD; i += THREADS) {
      const int j = i / HD, d = i - j * HD;
      sk[j * LD + d] = to_f(kb[(size_t)t0 * HD + i]);
      sv[j * LD + d] = to_f(vb[(size_t)t0 * HD + i]);
    }
    __syncthreads();
    for (int i = tid; i < rep * BT; i += THREADS) {
      const int r = i / BT, j = i - r * BT;
      if (j < n) {
        float dot = 0.f;
#pragma unroll 16
        for (int d = 0; d < HD; ++d) dot += sq[r * HD + d] * sk[j * LD + d];
        ss[i] = dot * scale;
      }
    }
    __syncthreads();
    for (int r = warp; r < rep; r += NWARPS) {
      float mx = -INFINITY;
      for (int j = lane; j < n; j += 32) mx = fmaxf(mx, ss[r * BT + j]);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_old = sm[r];
      const float m_new = fmaxf(m_old, mx);  // finite: n >= 1 real scores
      float sum = 0.f;
      for (int j = lane; j < n; j += 32) {
        const float p = expf(ss[r * BT + j] - m_new);
        ss[r * BT + j] = p;
        sum += p;
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);  // 0 on the first tile
        sa[r] = alpha;
        sl[r] = sl[r] * alpha + sum;
        sm[r] = m_new;
      }
    }
    __syncthreads();
    for (int i = tid; i < rep * HD; i += THREADS) {
      const int r = i / HD, d = i - r * HD;
      float pv = 0.f;
      for (int j = 0; j < n; ++j) pv += ss[r * BT + j] * sv[j * LD + d];
      sacc[i] = sacc[i] * sa[r] + pv;
    }
  }
  __syncthreads();
  for (int i = tid; i < rep * HD; i += THREADS) {
    const float l = sl[i / HD];
    o[qoff + i] = from_f<T>(l > 0.f ? sacc[i] / l : 0.f);
  }
}

template <typename T, int HD>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   const void* length, int B, int H, int Hkv, int T_len,
                   int window, float scale, cudaStream_t stream) {
  const int rep = H / Hkv;
  const size_t smem = smem_bytes<HD>(rep);
  cudaError_t err = cudaFuncSetAttribute(
      decode_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  decode_kernel<T, HD><<<B * Hkv, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o),
      static_cast<const int*>(length), Hkv, rep, T_len, window, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int hd, const void* q, const void* k, const void* v,
                     void* o, const void* length, int B, int H, int Hkv,
                     int T_len, int window, float scale, cudaStream_t s) {
  switch (hd) {
#define CASE(D) \
  case D:       \
    return launch<T, D>(q, k, v, o, length, B, H, Hkv, T_len, window, scale, s);
    CASE(16) CASE(32) CASE(64) CASE(96) CASE(112) CASE(128) CASE(256)
#undef CASE
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  q/o (B, H, hd), k/v (B, Hkv, T, hd),
// all contiguous; length: one int32 on the device.  Returns cudaError_t.
int decode_attention_launch(const void* q, const void* k, const void* v,
                            void* o, const void* length, int dtype, int B,
                            int H, int Hkv, int T_len, int hd, int window,
                            float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch<float>(hd, q, k, v, o, length, B, H, Hkv, T_len, window,
                           scale, s);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(hd, q, k, v, o, length, B, H, Hkv, T_len,
                                   window, scale, s);
  return cudaErrorInvalidValue;
}

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
