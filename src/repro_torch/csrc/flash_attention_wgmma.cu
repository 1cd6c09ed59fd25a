// Flash attention forward for bf16 at head dims 64, 96, 112, 128 and 256
// on Hopper (sm_90a), with wgmma on the tensor cores.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention/kernel.py::
// flash_attention_bhsd (body _flash_kernel) for bf16 inputs at these head
// dims (SmolLM-360M and MusicGen-large use 64, Phi-3-Vision-4.2B 96,
// Zamba2-7B 112, DeepSeek-Coder-33B, Mistral-Large and Phi-3.5-MoE 128,
// Gemma-7B 256); f32, and bf16 at hd 16 and 32, stay on
// flash_attention.cu (kernels/flash_attention/ops.py::variant picks).
// It computes softmax(Q K^T * scale + mask) V with q (B, H, Sq, hd) and
// k/v (B, Hkv, Sk, hd): q head h reads kv head h / (H / Hkv) (no K/V
// repeat); positions are aligned at 0 for q and k (key j is visible to
// query i when j <= i under causal, j > i - window when a window is set,
// and j < Sk); a row with no visible key gives 0.
//
// What bounds it: operations.  A causal pass does about 2 * B * H * S^2 *
// hd flops against 4 * B * H * S * hd elements moved, so at S = 2048 it
// sits far above the H100's ~295 flops/byte ridge: 16.1 GFLOP at
// SmolLM's B=2, H=15, hd=64, or 0.016 ms at the 989 TFLOP/s bf16 peak.
//
// Head dims.  Shared memory holds hd in 64-column swizzle atoms (ATOMS =
// ceil(hd / 64)).  At hd 96 and 112 the second atom runs past hd: the
// tensor maps name the real hd as their inner dimension, so TMA fills the
// columns past it with zeros (as it does rows past Sq and Sk) and still
// counts the whole box's bytes on the mbarrier.  S = Q K^T walks hd / 16
// k-steps only (6 or 7); O += P V issues its last atom at n64 over those
// zero columns (1/3 more P V work at hd 96, 1/7 at hd 112: one
// instruction shape, and the 128-byte-swizzled MN-major B operand that
// n64 reads whole), and the store writes the columns below hd.  At hd 256
// (four atoms) the O accumulator takes 128 f32 registers a consumer
// thread, and registers bound the key tile: ptxas allocates every role
// within the 168 registers a thread that the launch bound leaves (the
// setmaxnreg split below does not raise that: at BK = 32 ptxas spills
// and serializes the kernel's wgmma, C7512).  BK = 16 (S is m64n16k16:
// 8 registers, P 4) fits with no spill, in 4 stages (129 KB).
//
// Design (the hopper-kernels guide, section 1):
// - Roles.  A block owns 128 query rows of one (b, h) and has three
//   warpgroups: a producer (one thread issues every copy) and two
//   consumers of 64 rows each; setmaxnreg moves registers from the
//   producer (40) to the consumers (232), though ptxas keeps the
//   consumers' code within 168 (see "Head dims").  The consumers take
//   turns at the tensor cores (named barriers, FA3's ping-pong): while
//   one issues its products, the other runs its softmax.  The warpgroup
//   index is read through a shuffle so that ptxas sees the role branches
//   as uniform; a wgmma under a branch it cannot prove uniform makes it
//   serialize every wgmma of the kernel (C7520).
// - Products.  S = Q K^T is wgmma.mma_async m64nBKk16 with Q and K both
//   K-major in shared memory.  P = exp2(S - m) is rounded to bf16 and fed
//   from registers as the A operand of O += P V: the f32 accumulator
//   fragment of S (row lane/4 and +8, columns 2*(lane%4) + {0, 1} of each
//   8-column group) is the A-register fragment once neighbouring pairs
//   are packed as bf16x2.  V is stored (keys x hd) row-major, so it is the
//   B operand in MN-major layout (wgmma's transpose-B bit), one m64n64k16
//   per 64 columns of hd.  Accumulation is f32 throughout; only P and the
//   output are rounded.  Inside a consumer, tile t's S is computed, then
//   tile t-1's P V is issued and the softmax of tile t runs while it is on
//   the tensor cores.
// - Copies.  TMA (cp.async.bulk.tensor) brings Q once and K/V tiles into
//   a ring of STAGES stages in shared memory, 128-byte swizzled (the
//   layout the wgmma descriptors name; hd 128 is two 64-column atoms).
//   Each stage has a "full" mbarrier (the copy's bytes have landed) and
//   an "empty" one (every consumer warp is done with it), so up to STAGES
//   - 2 tiles are in flight while the consumers compute.  The tensor maps
//   are 3-d (hd, rows, b * heads), so rows at or past Sq / Sk fall
//   outside the map and TMA fills them with zeros: no garbage, NaN
//   included, reaches a product with p = 0.  The maps are encoded on the
//   host through cudaGetDriverEntryPoint (no link against libcuda).
// - Masking and work.  The loop covers only the key tiles the block can
//   see (causal and window bound it), a consumer skips a tile that none
//   of its rows sees, and only tiles crossing the diagonal, the window
//   edge or Sk are masked element by element.  Query tiles are launched
//   heaviest first (the last causal tile has the most keys), so causal
//   imbalance leaves no tail.  The row max is kept on raw scores and the
//   scale folded into log2 space: p = exp2(s * scale * log2(e) - m'), one
//   FFMA and one ex2.approx per score.  p is masked explicitly (a masked
//   score is -inf and gives p = 0; a row whose running max is still -inf
//   subtracts 0 instead), so a row with no visible key gives 0, whatever
//   order the tiles come in.
// - Not done yet (the known next steps): a persistent grid, and issuing
//   S_{t+1} before the softmax of tile t.

#include <cuda.h>  // CUtensorMap and its enums: types only, no libcuda link
#include <cudaTypedefs.h>  // PFN_cuTensorMapEncodeTiled
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int BQ = 128;       // query rows per block: two consumers
constexpr int THREADS = 384;  // producer warpgroup + two consumers
constexpr int PRODUCER_REGS = 40, CONSUMER_REGS = 232;
constexpr float LOG2E = 1.4426950408889634f;

template <int HD, int BK, int STAGES>
struct Cfg {
  // 64-column swizzle atoms of hd; the last one may run past hd
  static constexpr int ATOMS = (HD + 63) / 64;
  // whole boxes, zero columns included: what TMA writes and counts
  static constexpr int Q_BYTES = BQ * ATOMS * 128;
  static constexpr int KV_BYTES = BK * ATOMS * 128;  // one K or one V tile
  // + 1024: the swizzle repeats every 1024 bytes, so tiles start there
  static constexpr int SMEM = Q_BYTES + STAGES * 2 * KV_BYTES + 1024;
  // a consumer holds K_t (for S_t) and V_{t-1} (for P_{t-1} V_{t-1}) at
  // once, so STAGES - 2 tiles are in flight
  static_assert(HD % 16 == 0 && BK % 16 == 0 && STAGES >= 3, "tile shape");
  static_assert(SMEM <= 232448, "over the 227 KB a block may use");
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}
// arrive once and expect `bytes` of TMA traffic on this phase
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}
// Wait for the phase of parity `parity` to complete.  A wait that lasts
// beyond ~10 s of clocks is a protocol fault: trap (the launch then fails
// with an error) rather than hang the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  const long long start = clock64();
  for (;;) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (clock64() - start > (1ll << 34)) asm volatile("trap;");
  }
}
// TMA: the box at (c0, c1, c2) of a 3-d tensor map into shared memory,
// completing `bytes` on the mbarrier
__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.tile.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2)
      : "memory");
}
// named barriers 1 and 2 order the two consumers' turns (0 is
// __syncthreads); 256 threads: the 128 of the consumer that waits and the
// 128 of the one that lets it go
__device__ __forceinline__ void turn_wait(int consumer) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(1 + consumer) : "memory");
}
__device__ __forceinline__ void turn_pass(int consumer) {
  asm volatile("bar.arrive %0, 256;\n" ::"r"(1 + consumer) : "memory");
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// wait until at most N committed groups of this warpgroup are pending
// (groups complete in the order they were committed)
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
__device__ __forceinline__ float ex2(float x) {  // 2^x; ex2(-inf) = +0
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}
// pin the accumulator registers at this point: the compiler must not move
// their reads or writes across the asynchronous products
template <int N>
__device__ __forceinline__ void fence_regs(float* d) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t* d) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// wgmma shared-memory descriptor of a 128-byte-swizzled tile: start
// address, leading byte offset, stride byte offset 1024 (eight 128-byte
// rows), layout type 1 (SWIZZLE_128B).  The start must lie in a tile whose
// atoms begin on 1024-byte boundaries.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

// D (64 x 16, f32) (+)= A (64 x 16, K-major in shared memory) * B^T (B:
// 16 x 16, K-major in shared memory).
__device__ __forceinline__ void wgmma_ss_n16(float* d, uint64_t da,
                                              uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, %8, %9, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D (64 x 64, f32) (+)= A (64 x 16, K-major in shared memory) * B^T (B:
// 64 x 16, K-major in shared memory).
__device__ __forceinline__ void wgmma_ss_n64(float* d, uint64_t da,
                                              uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D (64 x 128, f32) (+)= A (64 x 16, K-major in shared memory) * B^T (B:
// 128 x 16, K-major in shared memory).
__device__ __forceinline__ void wgmma_ss_n128(float* d, uint64_t da,
                                              uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D (64 x 64, f32) += A (64 x 16, bf16 in registers) * B (16 x 64,
// MN-major in shared memory: the transpose bit).
__device__ __forceinline__ void wgmma_rs_n64_tb(float* d, const uint32_t* a,
                                                 uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <int BK>
__device__ __forceinline__ void wgmma_ss(float* d, uint64_t da, uint64_t db,
                                         int scale_d) {
  static_assert(BK == 16 || BK == 64 || BK == 128, "key tile");
  if constexpr (BK == 16)
    wgmma_ss_n16(d, da, db, scale_d);
  else if constexpr (BK == 64)
    wgmma_ss_n64(d, da, db, scale_d);
  else
    wgmma_ss_n128(d, da, db, scale_d);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x = lo, low bits
  return *reinterpret_cast<uint32_t*>(&v);
}

template <int HD, int BK, int STAGES>
__global__ void __launch_bounds__(THREADS, 1)
flash_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                   const __grid_constant__ CUtensorMap tm_k,
                   const __grid_constant__ CUtensorMap tm_v,
                   bf16* __restrict__ o, int H, int Hkv, int Sq, int Sk,
                   int causal, int window, float scale_log2) {
  using C = Cfg<HD, BK, STAGES>;
  constexpr int A = C::ATOMS, NS = BK / 2, NP = BK / 16;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bars[1 + 2 * STAGES];  // q, full, empty
  const uint32_t sQ = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sKV = sQ + C::Q_BYTES;  // stage t % STAGES: K, then V
  const uint32_t q_bar = smem_u32(&bars[0]);
  auto full = [&](int st) { return smem_u32(&bars[1 + st]); };
  auto empty = [&](int st) { return smem_u32(&bars[1 + STAGES + st]); };
  auto stage = [&](int t) {
    return sKV + static_cast<uint32_t>(t % STAGES) * 2 * C::KV_BYTES;
  };

  // through a shuffle, so that every branch on it is uniform to ptxas
  const int tid = threadIdx.x;
  const int wg = __shfl_sync(0xffffffffu, tid >> 7, 0);
  const int warp = (tid >> 5) & 3, lane = tid & 31;
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int g = h / (H / Hkv);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;  // heaviest first

  // keys visible to some row of the block
  const int k_lo = window > 0 ? max(0, q0 - window + 1) : 0;
  const int k_hi = causal ? min(Sk, q0 + BQ) : Sk;
  const int ntiles = k_hi > k_lo ? (k_hi - k_lo + BK - 1) / BK : 0;

  if (tid == 0) {
    mbar_init(q_bar, 1);
    for (int st = 0; st < STAGES; ++st) {
      mbar_init(full(st), 1);  // the producer's arrive, plus the bytes
      mbar_init(empty(st), 8);  // one arrive per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {  // ---------------------------------------------- producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    if (tid == 0 && ntiles > 0) {
      mbar_expect_tx(q_bar, C::Q_BYTES);
#pragma unroll
      for (int a = 0; a < A; ++a)
        tma_load_3d(sQ + a * (BQ * 128), &tm_q, q_bar, 64 * a, q0, bh);
      const int kvh = b * Hkv + g;
      for (int t = 0; t < ntiles; ++t) {
        const int st = t % STAGES;
        mbar_wait(empty(st), ((t / STAGES) & 1) ^ 1);  // round 0: free
        mbar_expect_tx(full(st), 2 * C::KV_BYTES);
#pragma unroll
        for (int a = 0; a < A; ++a) {
          tma_load_3d(stage(t) + a * (BK * 128), &tm_k, full(st), 64 * a,
                      k_lo + t * BK, kvh);
          tma_load_3d(stage(t) + C::KV_BYTES + a * (BK * 128), &tm_v,
                      full(st), 64 * a, k_lo + t * BK, kvh);
        }
      }
    }
  } else {  // -------------------------------------------------- consumers
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
    const int cw = wg - 1;
    // this consumer's first row; this thread's rows ra, rb = ra + 8
    const int qw = q0 + cw * 64;
    const int ra = qw + warp * 16 + (lane >> 2), rb = ra + 8;
    const int cq = 2 * (lane & 3);  // first of this thread's column pair

    float acc[A][32];
#pragma unroll
    for (int a = 0; a < A; ++a)
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[a][i] = 0.f;
    float s[NS];
#pragma unroll
    for (int i = 0; i < NS; ++i) s[i] = 0.f;
    uint32_t pf[NP][4];  // P (bf16) of the last tile, for its P V
#pragma unroll
    for (int i = 0; i < NP; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) pf[i][e] = 0u;
    // running row max of the raw scores, and this thread's share of the
    // row sums of p
    float m_a = -INFINITY, m_b = -INFINITY, l_a = 0.f, l_b = 0.f;

    if (ntiles > 0) mbar_wait(q_bar, 0);
    // Per tile t: S_t = Q K_t^T; then issue P_{t-1} V_{t-1} and run the
    // softmax of tile t while it is on the tensor cores; then wait for it,
    // release tile t-1 to the producer, rescale O and pack P_t.  The two
    // consumers take turns at the products (FA3's ping-pong): one issues
    // its S and P V while the other runs its softmax.  Consumer 0 has the
    // first turn; each consumer takes ntiles + 1 turns (the last one for
    // the last P V) and passes each on but its very last.
    if (ntiles > 0 && cw == 1) turn_pass(0);
    bool pv_live = false;  // pf holds a P whose P V is still to be issued
    for (int it = 0; it < ntiles; ++it) {
      const int t0 = k_lo + it * BK;
      mbar_wait(full(it % STAGES), (it / STAGES) & 1);
      turn_wait(cw);
      const uint32_t sK = stage(it);
      const uint32_t sVp = stage(it + STAGES - 1) + C::KV_BYTES;  // V_{t-1}

      // does any row of this consumer see a key of this tile?
      const bool live = (!causal || t0 <= qw + 63) &&
                        (window <= 0 || t0 + BK - 1 > qw - window);
      // Each product is its own wgmma group, opened by its own fence and
      // with its accumulator pinned on both sides of the issue.  S is
      // waited for before P V is issued: ptxas serializes every wgmma of
      // the kernel (C7514) if S's registers are read while a group issued
      // after S is still pending.
      if (live) {  // S = Q K^T over hd in steps of 16 (32 bytes of an atom)
        fence_regs<NS>(s);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < HD / 16; ++kk) {
          const uint32_t qa =
              sQ + (kk >> 2) * (BQ * 128) + cw * (64 * 128) + (kk & 3) * 32;
          const uint32_t ka = sK + (kk >> 2) * (BK * 128) + (kk & 3) * 32;
          wgmma_ss<BK>(s, sw128_desc(qa, 16), sw128_desc(ka, 16), kk > 0);
        }
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs<NS>(s);
      }
      if (pv_live) {  // O += P V: V rows are keys (k), columns hd (n)
#pragma unroll
        for (int a = 0; a < A; ++a) fence_regs<32>(acc[a]);
        fence_regs<NP * 4>(&pf[0][0]);
        wgmma_fence();
#pragma unroll
        for (int a = 0; a < A; ++a)
#pragma unroll
          for (int kk = 0; kk < NP; ++kk)
            wgmma_rs_n64_tb(acc[a], pf[kk],
                            sw128_desc(sVp + a * (BK * 128) + kk * (16 * 128),
                                       BK * 128));
        wgmma_commit();
#pragma unroll
        for (int a = 0; a < A; ++a) fence_regs<32>(acc[a]);
      }
      turn_pass(cw ^ 1);
      float al_a = 1.f, al_b = 1.f;
      if (live) {  // the softmax of tile t, while P_{t-1} V_{t-1} runs

        // mask only tiles that cross the diagonal, the window edge or Sk:
        // a masked score is -inf, and exp2 turns it into p = 0 exactly
        const bool edge = t0 + BK > Sk || (causal && t0 + BK - 1 > qw) ||
                          (window > 0 && t0 <= qw + 63 - window);
        float mx_a = -INFINITY, mx_b = -INFINITY;
#pragma unroll
        for (int i = 0; i < BK / 8; ++i)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            if (edge) {
              const int j = t0 + 8 * i + cq + e;
              const bool jok = j < Sk;
              if (!(jok && (!causal || j <= ra) &&
                    (window <= 0 || j > ra - window)))
                s[4 * i + e] = -INFINITY;
              if (!(jok && (!causal || j <= rb) &&
                    (window <= 0 || j > rb - window)))
                s[4 * i + 2 + e] = -INFINITY;
            }
            mx_a = fmaxf(mx_a, s[4 * i + e]);
            mx_b = fmaxf(mx_b, s[4 * i + 2 + e]);
          }
        // a row's values sit in the four lanes of a quad
        mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, 1));
        mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, 2));
        mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, 1));
        mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, 2));
        const float mn_a = fmaxf(m_a, mx_a), mn_b = fmaxf(m_b, mx_b);
        // the max in log2 units; while a row has seen no key it is -inf,
        // and 0 is subtracted instead, so p stays 0 and nothing is NaN
        const float mu_a = mn_a == -INFINITY ? 0.f : mn_a * scale_log2;
        const float mu_b = mn_b == -INFINITY ? 0.f : mn_b * scale_log2;
        al_a = ex2(m_a * scale_log2 - mu_a);  // 0 while m was -inf
        al_b = ex2(m_b * scale_log2 - mu_b);
        m_a = mn_a;
        m_b = mn_b;
        float ps_a = 0.f, ps_b = 0.f;
#pragma unroll
        for (int i = 0; i < BK / 8; ++i)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float pa = ex2(fmaf(s[4 * i + e], scale_log2, -mu_a));
            const float pb = ex2(fmaf(s[4 * i + 2 + e], scale_log2, -mu_b));
            s[4 * i + e] = pa;
            s[4 * i + 2 + e] = pb;
            ps_a += pa;
            ps_b += pb;
          }
        l_a = l_a * al_a + ps_a;  // this thread's share; summed at the end
        l_b = l_b * al_b + ps_b;
        // P (bf16) as the A operand: score fragments 2kk and 2kk+1 are the
        // 16 keys of k-step kk

      }
      wgmma_wait<0>();  // P_{t-1} V_{t-1} is done: O, pf and tile t-1 free
#pragma unroll
      for (int a = 0; a < A; ++a) fence_regs<32>(acc[a]);
      fence_regs<NP * 4>(&pf[0][0]);
      if (it > 0 && lane == 0) mbar_arrive(empty((it - 1) % STAGES));
      if (live) {
#pragma unroll
        for (int a = 0; a < A; ++a)
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            acc[a][4 * i] *= al_a;
            acc[a][4 * i + 1] *= al_a;
            acc[a][4 * i + 2] *= al_b;
            acc[a][4 * i + 3] *= al_b;
          }
#pragma unroll
        for (int kk = 0; kk < NP; ++kk) {
          pf[kk][0] = pack_bf16(s[8 * kk], s[8 * kk + 1]);
          pf[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
          pf[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
          pf[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
        }
      }
      pv_live = live;
    }
    if (ntiles > 0) turn_wait(cw);
    if (pv_live) {  // the last tile's P V
      const uint32_t sV = stage(ntiles - 1) + C::KV_BYTES;
#pragma unroll
      for (int a = 0; a < A; ++a) fence_regs<32>(acc[a]);
      fence_regs<NP * 4>(&pf[0][0]);
      wgmma_fence();
#pragma unroll
      for (int a = 0; a < A; ++a)
#pragma unroll
        for (int kk = 0; kk < NP; ++kk)
          wgmma_rs_n64_tb(acc[a], pf[kk],
                          sw128_desc(sV + a * (BK * 128) + kk * (16 * 128),
                                     BK * 128));
      wgmma_commit();
    }
    if (ntiles > 0 && cw == 0) turn_pass(1);
    wgmma_wait<0>();
#pragma unroll
    for (int a = 0; a < A; ++a) fence_regs<32>(acc[a]);

    l_a += __shfl_xor_sync(0xffffffffu, l_a, 1);
    l_a += __shfl_xor_sync(0xffffffffu, l_a, 2);
    l_b += __shfl_xor_sync(0xffffffffu, l_b, 1);
    l_b += __shfl_xor_sync(0xffffffffu, l_b, 2);
    const float ia = l_a > 0.f ? 1.f / l_a : 0.f;
    const float ib = l_b > 0.f ? 1.f / l_b : 0.f;
    bf16* ob = o + static_cast<size_t>(bh) * Sq * HD;
#pragma unroll
    for (int a = 0; a < A; ++a)
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        if (64 * a + 8 * i >= HD) continue;  // the zero columns past hd
        const int col = 64 * a + 8 * i + cq;
        if (ra < Sq)
          *reinterpret_cast<__nv_bfloat162*>(
              ob + static_cast<size_t>(ra) * HD + col) =
              __floats2bfloat162_rn(acc[a][4 * i] * ia,
                                    acc[a][4 * i + 1] * ia);
        if (rb < Sq)
          *reinterpret_cast<__nv_bfloat162*>(
              ob + static_cast<size_t>(rb) * HD + col) =
              __floats2bfloat162_rn(acc[a][4 * i + 2] * ib,
                                    acc[a][4 * i + 3] * ib);
      }
  }
}

// cuTensorMapEncodeTiled from the libcuda that the CUDA runtime has loaded
PFN_cuTensorMapEncodeTiled_v12000 tensor_map_encoder() {
  static PFN_cuTensorMapEncodeTiled_v12000 fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                              cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(p);
  }
  return fn;
}

// A 3-d map of (heads, rows, hd) bf16, row-major, read in boxes of 64
// columns (one 128-byte swizzle atom) by `box_rows` rows of one head; a
// box's columns past hd and rows past `rows` arrive as zeros.
bool encode_map(CUtensorMap* map, const void* base, int hd, int rows,
                int heads, int box_rows) {
  PFN_cuTensorMapEncodeTiled_v12000 encode = tensor_map_encoder();
  if (encode == nullptr) return false;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(hd),
                              static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(heads)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(hd) * 2,
                                 static_cast<cuuint64_t>(rows) * hd * 2};
  const cuuint32_t box[3] = {64, static_cast<cuuint32_t>(box_rows), 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                const_cast<void*>(base), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int HD, int BK, int STAGES>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int B, int H, int Hkv, int Sq, int Sk, int causal,
                   int window, float scale, cudaStream_t stream) {
  using C = Cfg<HD, BK, STAGES>;
  CUtensorMap tm_q, tm_k, tm_v;
  if (!encode_map(&tm_q, q, HD, Sq, B * H, BQ) ||
      !encode_map(&tm_k, k, HD, Sk, B * Hkv, BK) ||
      !encode_map(&tm_v, v, HD, Sk, B * Hkv, BK))
    return cudaErrorInvalidValue;
  auto kern = flash_wgmma_kernel<HD, BK, STAGES>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (err != cudaSuccess) return err;
  dim3 grid(B * H, (Sq + BQ - 1) / BQ);
  kern<<<grid, THREADS, C::SMEM, stream>>>(tm_q, tm_k, tm_v,
                                            static_cast<bf16*>(o), H, Hkv,
                                            Sq, Sk, causal, window,
                                            scale * LOG2E);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// bf16 only.  q/o (B, H, Sq, hd), k/v (B, Hkv, Sk, hd), all contiguous;
// hd 64, 96, 112, 128 or 256; B * H < 2^31 and ceil(Sq / 128) <= 65535;
// scale > 0 (the row max is taken on unscaled scores).  Returns
// cudaError_t.
int flash_attention_wgmma_launch(const void* q, const void* k, const void* v,
                                 void* o, int B, int H, int Hkv, int Sq,
                                 int Sk, int hd, int causal, int window,
                                 float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (Sq < 1 || Sk < 1 || Hkv < 1 || H % Hkv ||
      (Sq + BQ - 1) / BQ > 65535 || !(scale > 0.f))
    return cudaErrorInvalidValue;
  switch (hd) {
#define CASE(D, K, N)                                                        \
  case D:                                                                   \
    return launch<D, K, N>(q, k, v, o, B, H, Hkv, Sq, Sk, causal, window,   \
                           scale, s);
    // (hd, key tile, stages): see "Head dims" at the top
    CASE(64, 128, 4) CASE(96, 64, 4) CASE(112, 64, 4) CASE(128, 64, 4)
    CASE(256, 16, 4)
#undef CASE
    default:
      return cudaErrorInvalidValue;
  }
}

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
