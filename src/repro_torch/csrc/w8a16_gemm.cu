// W8A16 matrix product at decode shapes for Hopper (sm_90a):
// y = x @ (q * s), with the int8 weight read once as stored and never
// materialised in bf16.
//
// Replaces no Pallas kernel: the JAX package dequantizes a weight with XLA
// (src/repro/models/quant.py::wcast) and leaves the product to XLA.  It
// replaces the port's `models/quant.py::wcast` + matmul where a matrix
// meets at most 64 rows (decoding).  There `wcast` read the int8 weight,
// wrote a bf16 copy, read it and the scale, wrote the product, and the
// GEMM read the product again: 7-9 bytes moved a weight where 1 does.
// Forms: x (M, K) bf16 times q (K, N) int8, s (N,) f32; and E matrices at
// once, x (E, M, K), q (E, K, N), s (E, N), giving (E, M, N).
//
// What bounds it: bytes.  A call reads E * K * N int8 weight bytes and does
// 2 * E * M * K * N flops with M <= 64: at most 128 flops a byte, under
// the ~295 at which an H100 stops being memory-bound, and at serving's
// M (5 rows an expert, 32 a projection) far under.  The activations
// (M x K bf16) and the output (M x N bf16) are small beside the weight.
//
// Design:
// - Swapped operands.  The weight is mma's A (its N columns the m16 rows),
//   the activations are B (their M rows the n8 columns), so M pads to MT
//   tiles of 8 rows (MT = 1, 2, 4 or 8), not to 16 or 64, and a warp holds
//   8 * MT f32 accumulators a 16-column tile.
// - The weight is read as stored, (K, N) with N contiguous.  16-byte
//   cp.async copies bring a BK x BN int8 tile (64 k rows x 128 columns,
//   8 KB) and the (8 MT) x BK bf16 activation tile beside it into a ring of
//   STAGES = 5 slots: 32 KB of weight in flight a block, and two to four
//   blocks an SM.  Rows of 16-byte chunks are swizzled by row, so every
//   ldmatrix below is free of bank conflicts.
// - ldmatrix.x4.trans on int8 pairs.  Taking two int8 columns as one b16
//   element, a transposed 8x8 b16 load gives lane (g, t) = (lane / 4,
//   lane % 4) the bytes (k, n), (k, n + 1), (k + 1, n), (k + 1, n + 1) with
//   k = 2t, n = 2g: the A fragment of weight columns n and n + 1 when mma
//   row g is column 2g and row g + 8 is column 2g + 1 of the 16-column
//   tile.  The epilogue writes each accumulator to its column in that
//   order.
// - int8 -> bf16 in registers, exactly (|q| <= 127 has 7 significant
//   bits): q ^ 0x80 as the low byte of the f32 2^23 + u, minus 2^23 + 128,
//   is q as an f32 whose upper half is its bf16; a byte permute packs two.
//   11 integer and f32 instructions convert 4 weights, with no I2F, whose
//   rate (16 an SM a cycle) is near the ~13 weights a cycle an SM's share
//   of the memory brings.
// - mma.sync m16n8k16 in bf16 with f32 accumulators.  The epilogue
//   multiplies each accumulator by its column's f32 scale and rounds once.
// - Stream-K over the flat space of (matrix, 128-column tile, 64-row k
//   tile) iterations: G blocks, as many as fit the SMs at once and at
//   least MIN_ITERS iterations each (ops.py::grid), take equal contiguous
//   runs of it.  So 800 expert tiles and the 8 tiles of a 4 MB projection
//   both fill the 132 SMs, with no tail wave.  A column tile cut across
//   blocks is merged in the same launch: each of its blocks writes its f32
//   partial to the workspace (two slots a block: its first and its last
//   tile, the only ones it can share) and takes a ticket from the tile's
//   counter after a __threadfence; the last sums the partials in block
//   order (never ticket order, so two calls give the same bits), scales,
//   writes y and resets the counter to 0.  No float atomics.
// The workspace and counters come from the caller, which must not share
// them between calls running concurrently on two streams.  The dynamic
// shared memory limit is raised once per instantiation and device.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int THREADS = 128;        // 4 warps, 32 columns each
constexpr int BN = 128;             // weight columns a tile
constexpr int BK = 64;              // k rows a ring slot
constexpr int STAGES = 5;
constexpr int W_BYTES = BK * BN;    // int8 weight tile of a slot
constexpr int ROW_BYTES = 128;      // a swizzled row: 8 chunks of 16 bytes
static_assert(BN == ROW_BYTES && BK * 2 == ROW_BYTES, "tile rows");

template <int MT>
struct Shape {
  static constexpr int X_BYTES = 8 * MT * ROW_BYTES;  // (8 MT) x BK bf16
  static constexpr int SLOT = W_BYTES + X_BYTES;
  static constexpr int SMEM = STAGES * SLOT;
  static constexpr int FRAGS = 2 * MT;                // float4 a thread
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
// 16 bytes from src, or 16 zero bytes when !valid (src is not read then)
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
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
__device__ __forceinline__ void ldsm_x4(uint32_t* r, uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t* r, uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
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

// byte offset of 16-byte chunk `c` of row `r` in a swizzled tile
__device__ __forceinline__ uint32_t swz(int r, int c) {
  return r * ROW_BYTES + ((c ^ (r & 7)) << 4);
}

// the four int8 weights of w (bytes b0..b3) as the bf16 pairs (b0, b2) and
// (b1, b3), low element first
__device__ __forceinline__ void i8x4_to_bf16(uint32_t w, uint32_t& lo,
                                             uint32_t& hi) {
  constexpr uint32_t BASE = 0x4B000000u;     // 2^23 as an f32
  constexpr float MAGIC = 8388736.0f;        // 2^23 + 128
  const uint32_t u = w ^ 0x80808080u;        // q + 128 a byte
  const float f0 = __uint_as_float(__byte_perm(u, BASE, 0x7650)) - MAGIC;
  const float f1 = __uint_as_float(__byte_perm(u, BASE, 0x7651)) - MAGIC;
  const float f2 = __uint_as_float(__byte_perm(u, BASE, 0x7652)) - MAGIC;
  const float f3 = __uint_as_float(__byte_perm(u, BASE, 0x7653)) - MAGIC;
  lo = __byte_perm(__float_as_uint(f0), __float_as_uint(f2), 0x7632);
  hi = __byte_perm(__float_as_uint(f1), __float_as_uint(f3), 0x7632);
}

struct Problem {
  const bf16* x;       // (E, M, K)
  const int8_t* q;     // (E, K, N)
  const float* s;      // (E, N)
  bf16* y;             // (E, M, N)
  float4* ws;          // (G, 2, FRAGS, THREADS)
  int* counters;       // (E * NT,)
  int M, K, N, NT, I;  // NT column tiles a matrix, I k tiles a column tile
  long long W;         // E * NT * I iterations
};

// the first iteration of block b's run
__device__ __forceinline__ long long run_start(long long b, const Problem& p) {
  return b * p.W / gridDim.x;
}
// the block whose run holds iteration i
__device__ __forceinline__ long long owner(long long i, const Problem& p) {
  return ((i + 1) * gridDim.x + p.W - 1) / p.W - 1;
}

// copy iteration (t, kt)'s weight and activation tiles into ring slot
// `base` (a shared address); rows past K or M and columns past N are zero
template <int MT>
__device__ __forceinline__ void load_slot(const Problem& p, long long t,
                                          int kt, uint32_t base, int tid) {
  const int e = static_cast<int>(t / p.NT);
  const int n0 = static_cast<int>(t % p.NT) * BN;
  const int k0 = kt * BK;
  const int8_t* q = p.q + static_cast<size_t>(e) * p.K * p.N;
#pragma unroll
  for (int c = tid; c < BK * 8; c += THREADS) {
    const int r = c >> 3, ch = c & 7;
    const int k = k0 + r, n = n0 + ch * 16;
    const bool ok = k < p.K && n < p.N;
    cp_async16(base + swz(r, ch),
               ok ? q + static_cast<size_t>(k) * p.N + n : p.q, ok);
  }
  const bf16* x = p.x + static_cast<size_t>(e) * p.M * p.K;
  const uint32_t xs = base + W_BYTES;
#pragma unroll
  for (int c = tid; c < MT * 64; c += THREADS) {
    const int r = c >> 3, ch = c & 7;
    const int k = k0 + ch * 8;
    const bool ok = r < p.M && k < p.K;
    cp_async16(xs + swz(r, ch),
               ok ? x + static_cast<size_t>(r) * p.K + k : p.x, ok);
  }
}

// acc[i][j] += the slot's weight columns (warp's 16-column tile i) times
// its activation rows 8j..8j+7, over the slot's 64 k rows
template <int MT>
__device__ __forceinline__ void compute_slot(float (&acc)[2][MT][4],
                                             uint32_t base, int warp,
                                             int lane) {
  const uint32_t xs = base + W_BYTES;
#pragma unroll
  for (int kh = 0; kh < 2; ++kh) {          // two halves of 32 k rows
    uint32_t b[MT][4];
#pragma unroll
    for (int j = 0; j < MT; ++j)
      ldsm_x4(b[j], xs + swz(8 * j + (lane & 7), 4 * kh + (lane >> 3)));
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      uint32_t w[4], a[2][4];
      ldsm_x4_t(w, base + swz(32 * kh + lane, warp * 2 + i));
      i8x4_to_bf16(w[0], a[0][0], a[0][1]);
      i8x4_to_bf16(w[1], a[0][2], a[0][3]);
      i8x4_to_bf16(w[2], a[1][0], a[1][1]);
      i8x4_to_bf16(w[3], a[1][2], a[1][3]);
#pragma unroll
      for (int s = 0; s < 2; ++s)
#pragma unroll
        for (int j = 0; j < MT; ++j)
          mma16816(acc[i][j], a[s], b[j][2 * s], b[j][2 * s + 1]);
    }
  }
}

// y = acc * s for column tile t, rounded once to bf16; lane (g, tq) holds
// columns 2g, 2g + 1 of each 16-column tile and rows 2tq, 2tq + 1 of each
// 8-row tile
template <int MT>
__device__ __forceinline__ void store_tile(const float (&acc)[2][MT][4],
                                           const Problem& p, long long t,
                                           int warp, int lane) {
  const int e = static_cast<int>(t / p.NT);
  const int n0 = static_cast<int>(t % p.NT) * BN;
  const int g = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int n = n0 + 16 * (warp * 2 + i) + 2 * g;
    if (n >= p.N) continue;
    const float2 sc = *reinterpret_cast<const float2*>(
        p.s + static_cast<size_t>(e) * p.N + n);
#pragma unroll
    for (int j = 0; j < MT; ++j) {
      const int m = 8 * j + 2 * tq;
      const float* a = acc[i][j];
      bf16* row = p.y + (static_cast<size_t>(e) * p.M + m) * p.N + n;
      if (m < p.M)
        *reinterpret_cast<__nv_bfloat162*>(row) =
            __floats2bfloat162_rn(a[0] * sc.x, a[2] * sc.y);
      if (m + 1 < p.M)
        *reinterpret_cast<__nv_bfloat162*>(row + p.N) =
            __floats2bfloat162_rn(a[1] * sc.x, a[3] * sc.y);
    }
  }
}

// the end of this block's share of column tile t: the output if the block
// holds all of it, else its partial and, for the tile's last block, the
// merge (into acc, which the caller zeroes after)
template <int MT>
__device__ void finish_tile(float (&acc)[2][MT][4], const Problem& p,
                            long long t, long long first_tile, int tid,
                            int warp, int lane, int* s_ticket) {
  constexpr int FRAGS = Shape<MT>::FRAGS;
  const long long b0 = owner(t * p.I, p);
  const long long b1 = owner((t + 1) * p.I - 1, p);
  if (b0 == b1) {                          // the whole tile is this block's
    store_tile<MT>(acc, p, t, warp, lane);
    return;
  }
  const int slot = t == first_tile ? 0 : 1;
  float4* mine = p.ws + (static_cast<size_t>(blockIdx.x) * 2 + slot) *
                            FRAGS * THREADS + tid;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < MT; ++j)
      mine[(i * MT + j) * THREADS] =
          make_float4(acc[i][j][0], acc[i][j][1], acc[i][j][2], acc[i][j][3]);
  __threadfence();
  __syncthreads();
  if (tid == 0) *s_ticket = atomicAdd(p.counters + t, 1);
  __syncthreads();
  if (*s_ticket != static_cast<int>(b1 - b0)) return;
  __threadfence();
  // the partials in block order: block b holds tile t in its first slot
  // if t is the tile its run starts in, else in its second
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < MT; ++j)
#pragma unroll
      for (int v = 0; v < 4; ++v) acc[i][j][v] = 0.f;
  for (long long b = b0; b <= b1; ++b) {
    const int sl = run_start(b, p) / p.I == t ? 0 : 1;
    const float4* part =
        p.ws + (static_cast<size_t>(b) * 2 + sl) * FRAGS * THREADS + tid;
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < MT; ++j) {
        const float4 v = __ldcg(part + (i * MT + j) * THREADS);
        acc[i][j][0] += v.x;
        acc[i][j][1] += v.y;
        acc[i][j][2] += v.z;
        acc[i][j][3] += v.w;
      }
  }
  store_tile<MT>(acc, p, t, warp, lane);
  if (tid == 0) p.counters[t] = 0;
}

template <int MT>
__global__ void __launch_bounds__(THREADS)
    w8a16_gemm_kernel(const Problem p) {
  extern __shared__ __align__(128) uint8_t smem[];
  __shared__ int s_ticket;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const uint32_t ring = smem_u32(smem);
  const long long i0 = run_start(blockIdx.x, p);
  const long long i1 = run_start(blockIdx.x + 1LL, p);
  const long long first_tile = i0 / p.I;

  // the load cursor runs STAGES - 1 iterations ahead of the compute
  long long lt = first_tile;
  int lkt = static_cast<int>(i0 % p.I);
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (i0 + s < i1) {
      load_slot<MT>(p, lt, lkt, ring + s * Shape<MT>::SLOT, tid);
      if (++lkt == p.I) lkt = 0, ++lt;
    }
    cp_async_commit();
  }

  float acc[2][MT][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < MT; ++j)
#pragma unroll
      for (int v = 0; v < 4; ++v) acc[i][j][v] = 0.f;

  long long t = first_tile;
  int kt = static_cast<int>(i0 % p.I);
  int slot = 0, lslot = STAGES - 1;
  for (long long i = i0; i < i1; ++i) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();                 // slot's copies landed; lslot is free
    if (i + STAGES - 1 < i1) {
      load_slot<MT>(p, lt, lkt, ring + lslot * Shape<MT>::SLOT, tid);
      if (++lkt == p.I) lkt = 0, ++lt;
    }
    cp_async_commit();
    compute_slot<MT>(acc, ring + slot * Shape<MT>::SLOT, warp, lane);
    if (kt == p.I - 1 || i == i1 - 1) {
      finish_tile<MT>(acc, p, t, first_tile, tid, warp, lane, &s_ticket);
#pragma unroll
      for (int a = 0; a < 2; ++a)
#pragma unroll
        for (int j = 0; j < MT; ++j)
#pragma unroll
          for (int v = 0; v < 4; ++v) acc[a][j][v] = 0.f;
    }
    if (++kt == p.I) kt = 0, ++t;
    slot = slot + 1 == STAGES ? 0 : slot + 1;
    lslot = lslot + 1 == STAGES ? 0 : lslot + 1;
  }
  cp_async_wait<0>();
}

// the dynamic shared memory limit of MT's instantiation, raised once per
// device
template <int MT>
cudaError_t prepare() {
  constexpr int SMEM = Shape<MT>::SMEM;
  static_assert(SMEM + 16 <= 227 * 1024, "shared memory of a block");
  static unsigned raised = 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (SMEM > 48 * 1024 && !(dev < 32 && (raised >> dev & 1u))) {
    err = cudaFuncSetAttribute(w8a16_gemm_kernel<MT>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               SMEM);
    if (err != cudaSuccess) return err;
    if (dev < 32) raised |= 1u << dev;
  }
  return cudaSuccess;
}

template <int MT>
cudaError_t blocks_per_sm(int* out) {
  cudaError_t err = prepare<MT>();
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      out, w8a16_gemm_kernel<MT>, THREADS, Shape<MT>::SMEM);
}

template <int MT>
cudaError_t launch(const Problem& p, int blocks, cudaStream_t stream) {
  cudaError_t err = prepare<MT>();
  if (err != cudaSuccess) return err;
  w8a16_gemm_kernel<MT><<<blocks, THREADS, Shape<MT>::SMEM, stream>>>(p);
  return cudaGetLastError();
}

// M rows pad to MT = 1, 2, 4 or 8 tiles of 8 (ops.py::row_tiles): four
// instantiations, as the padded rows cost no weight bytes
#define BY_TILES(M_, CALL)                                  \
  switch ((M_ + 7) / 8) {                                  \
    case 1: return CALL(1);                                \
    case 2: return CALL(2);                                \
    case 3:                                                \
    case 4: return CALL(4);                                \
    case 5:                                                \
    case 6:                                                \
    case 7:                                                \
    case 8: return CALL(8);                                \
    default: return cudaErrorInvalidValue;                 \
  }

}  // namespace

extern "C" {

// Resident blocks an SM for M rows a matrix (1 <= M <= 64): the occupancy
// of the instantiation the launch takes, for the grid (ops.py::grid).
int w8a16_gemm_blocks_per_sm(int M, int* out) {
  if (M < 1 || M > 64 || out == nullptr) return cudaErrorInvalidValue;
#define CALL(T) blocks_per_sm<T>(out)
  BY_TILES(M, CALL)
#undef CALL
}

// x (E, M, K) bf16, q (E, K, N) int8, s (E, N) f32, y (E, M, N) bf16, all
// contiguous, 16-byte aligned; 1 <= M <= 64, K % 8 == 0, N % 16 == 0.
// ws: f32, blocks * 2 * 8 * MT * 128 floats (MT: M's row tiles, padded to
// 1, 2, 4 or 8); counters: int32, one
// a column tile (E * ceil(N / 128)), zero before the first call and left
// zero by every call.  `blocks` (the grid) at most E * ceil(N / 128) *
// ceil(K / 64).  One launch on `stream`; returns cudaError_t.
int w8a16_gemm_launch(const void* x, const void* q, const void* s, void* y,
                      void* ws, void* counters, int E, int M, int K, int N,
                      int blocks, void* stream) {
  if (E < 1 || M < 1 || M > 64 || K < 8 || K % 8 || N < 16 || N % 16 ||
      blocks < 1)
    return cudaErrorInvalidValue;
  Problem p;
  p.x = static_cast<const bf16*>(x);
  p.q = static_cast<const int8_t*>(q);
  p.s = static_cast<const float*>(s);
  p.y = static_cast<bf16*>(y);
  p.ws = static_cast<float4*>(ws);
  p.counters = static_cast<int*>(counters);
  p.M = M;
  p.K = K;
  p.N = N;
  p.NT = (N + BN - 1) / BN;
  p.I = (K + BK - 1) / BK;
  p.W = static_cast<long long>(E) * p.NT * p.I;
  if (blocks > p.W) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define CALL(T) launch<T>(p, blocks, st)
  BY_TILES(M, CALL)
#undef CALL
}

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
