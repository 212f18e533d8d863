// Flash attention forward for bf16 on Hopper (sm_90a): wgmma on bf16 tiles
// fed by TMA.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py
// (flash_attention_fwd, line 146 / _fwd_kernel) for bf16 inputs with head
// dim 64 or 128; kernels/flash_attention.py:forward_route sends f32, and
// bf16 at other head dims, to flash_fwd_kernel in flash_attention.cu. For
// every (batch b, q-head h, query row i), with kv head h / G (G = Hq / Hkv)
// and scale = D^-1/2, it computes what that kernel computes:
//   s[i, j] = <q[i], k[j]> * scale, or -1e30 where j >= Sk or, causal,
//             j > i + q_off (q_off = Sk - Sq)
//   online softmax over key tiles in f32: m (running max), l (running sum
//   of exp(s - m), summed from the f32 p before any rounding), acc
//   (running sum of p v), rescaled by exp(m_old - m_new) at each tile
//   o[i]   = acc / max(l, 1e-30) in bf16
//   lse[i] = m + log(max(l, 1e-30)) in f32, [B, Hq, Sq]: what the SIMT
//            backward kernels of flash_attention.cu read
//
// The P V product keeps p in f32 precision. The TPU kernel and
// kernels/ref.py multiply the f32 p by v in f32; rounding p to bf16 before
// the product (the usual flash kernel) misses the element-wise limit the
// port holds bf16 outputs to (2^-7 |o| + 1e-4) by up to 12x on rows that
// see few keys. So p is split into two bf16 fragments, hi = bf16(p) and
// lo = bf16(p - hi), and O += P_hi V + P_lo V runs as two bf16 wgmma
// products into one f32 accumulator: p carries ~16 significant bits.
//
// Block: one CTA of 384 threads per (128 query rows, q head, b); the G q
// heads of one kv head are adjacent in the grid (blockIdx.x = h), so they
// read the same K/V tiles from L2, and q tiles are issued longest causal
// row first (blockIdx.y counts down). Warpgroup 0 is the producer: after
// setmaxnreg.dec to 24 registers, one thread issues TMA loads (the Q tile
// once, then K and V tiles of 128 keys into a ring of two stages) and
// waits on each stage's `empty` mbarrier before refilling it. Warpgroups
// 1 and 2 are consumers of 64 query rows each (setmaxnreg.inc to 240):
// for each key tile they wait on the stage's `full` mbarrier, run
//   S = Q K^T   as wgmma m64nBKk16, both operands in shared memory
//               (D / 16 steps along the head dim), f32 accumulator in
//               registers
//   the online softmax on the accumulator fragments (a row's max and sum
//               reduce over the 4 threads that hold it; the mask is
//               applied only to tiles that cross the diagonal or Sk; tiles
//               wholly above the diagonal are never loaded)
//   O += P_hi V + P_lo V   as wgmma m64nDk16 with P from registers (the
//               S accumulator's layout is the A fragment's) and V from
//               shared memory read transposed (MN-major)
// and then arrive on the stage's `empty` mbarrier. Rows at or past Sq are
// computed on TMA's zero fill and not written; keys past Sk are masked.
//
// Shared memory: each tile is D/64 column blocks of [rows][64] bf16, as
// TMA writes them with the 128-byte swizzle (a 64-wide box per block),
// which is the layout wgmma's 128-byte-swizzled descriptors read. At
// D=128: Q 32 KB + 2 stages x (K 32 KB + V 32 KB) = 160 KB + 1 KB of
// alignment, one CTA per SM. TMA descriptors are 4-D tiled maps over
// [B, S, H, D] with the wrapper's element strides; they are encoded on the
// host by cuTensorMapEncodeTiled, reached through cudaGetDriverEntryPoint
// (no -lcuda), and passed as __grid_constant__ parameters. TMA needs a
// 16-byte-aligned base and byte strides that are multiples of 16: the
// Python wrapper raises otherwise, and the entry point returns
// cudaErrorInvalidValue.
//
// What bounds it on the H100: operations. At the LM prefill shape (B=1,
// S=32,768, Hq=40, Hkv=8, D=128, causal) the function does 1.10e13 FLOP
// (4 * D per visible (query, key) pair): 11.1 ms at the bf16 tensor-core
// peak of 989 TFLOP/s, against 0.24 ms for its ~810 MB of q/k/v/o/lse.
// This design runs 6 * D FLOP a pair (the P_lo V product is the extra
// 2 * D), so its own floor is 16.7 ms, plus the masked halves of the
// diagonal tiles. Each warpgroup waits for its own products before the
// softmax that reads them; the overlap comes from the other warpgroup and
// from the TMA ring, not from pipelining inside a warpgroup. (Issuing the
// next tile's Q K^T beside this tile's P V, as FlashAttention-3 does, was
// tried: ptxas serialised the products (C7513: non-wgmma instructions
// define a wgmma's input registers inside the pipeline stage) and it ran
// slower; a third ring stage did not help.)
#include <cuda.h>          // CUtensorMap and its enums (types only)
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 128;              // query rows per CTA: 2 warpgroups x 64
constexpr int kBK = 128;              // keys per tile
constexpr int kStages = 2;            // K/V ring depth
constexpr int kThreads = 384;         // producer warpgroup + 2 consumers
constexpr int kConsumerThreads = 256;
constexpr int kRowBytes = 128;        // one swizzled row of 64 bf16
constexpr float kNegInf = -1e30f;
constexpr float kLn2 = 0.69314718055994531f;

template <int D>
struct Smem {
  // column block c of a tile: rows x 64 bf16, 128-byte swizzled
  __nv_bfloat16 q[D / 64][kBQ * 64];
  __nv_bfloat16 k[kStages][D / 64][kBK * 64];
  __nv_bfloat16 v[kStages][D / 64][kBK * 64];
  uint64_t q_full;
  uint64_t full[kStages];
  uint64_t empty[kStages];
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   smem_u32(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(bar))
               : "memory");
}

// wait for the phase of `bar` with this parity to complete. A wait that
// outlasts kHangCycles (~10 s) means an arrival was lost: trap, so that the
// launch fails instead of hanging the card
constexpr long long kHangCycles = 1ll << 34;
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  long long start = -1;
  while (true) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(addr), "r"(parity) : "memory");
    if (done) return;
    if (start < 0) start = clock64();
    else if (clock64() - start > kHangCycles) __trap();
  }
}

// box {64, rows, 1, 1} at (d0, s0, h, b) of a [B, S, H, D] map into dst
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int d0, int s0, int h,
                                         int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global"
      ".mbarrier::complete_tx::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];"
      ::"r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)),
        "r"(smem_u32(bar)), "r"(d0), "r"(s0), "r"(h), "r"(b)
      : "memory");
}

// wgmma shared-memory descriptor, 128-byte swizzle. K-major operands (Q,
// K): sbo = 1024 (8 rows of 128 B), lbo unused. MN-major (V): sbo = 1024
// (8 keys), lbo = the byte distance between 64-wide column blocks.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t saddr, uint32_t lbo,
                                               uint32_t sbo) {
  return (uint64_t)((saddr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}

// keep the compiler from moving reads or writes of registers that an
// in-flight wgmma owns across the fence/wait instructions
template <int N>
__device__ __forceinline__ void hold_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void hold_regs(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t bf16x2_bits(__nv_bfloat162 x) {
  return *reinterpret_cast<uint32_t*>(&x);
}

// d[N/2] (+)= A B for one m64nNk16 step. wgmma_ss (N = kBK, for S): A and
// B from shared memory, both K-major. wgmma_rs (N = D, for O): A from
// registers, B MN-major (V).
template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t da,
                                         uint64_t db, int scale_d);
template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2],
                                         const uint32_t (&a)[4], uint64_t db);

template <>
__device__ __forceinline__ void wgmma_rs<64>(float (&d)[32],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_ss<128>(float (&d)[64], uint64_t da,
                                              uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_rs<128>(float (&d)[64],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(1));
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                       const __grid_constant__ CUtensorMap tm_k,
                       const __grid_constant__ CUtensorMap tm_v,
                       __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                       int Sq, int Sk, int Hq, int Hkv, long long osb,
                       long long oss, long long osh, int causal,
                       float scale_log2) {
  constexpr int NB = D / 64;                  // 64-wide column blocks
  constexpr uint32_t kQBlock = kBQ * kRowBytes;
  constexpr uint32_t kKVBlock = kBK * kRowBytes;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  Smem<D>& sm = *reinterpret_cast<Smem<D>*>(smem_raw +
                                            (((raw + 1023) & ~1023u) - raw));

  const int h = blockIdx.x, b = blockIdx.z;
  const int q0 = ((int)gridDim.y - 1 - (int)blockIdx.y) * kBQ;
  const int hk = h / (Hq / Hkv);
  const int q_off = Sk - Sq;
  // keys past the block's last row are masked for every row: stop there
  const int k_end = causal ? min(Sk, q0 + kBQ + q_off) : Sk;
  const int n_kt = (k_end + kBK - 1) / kBK;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    mbar_init(&sm.q_full, 1);
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&sm.full[s], 1);
      mbar_init(&sm.empty[s], kConsumerThreads);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // ------------------------------------------------------- producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 0) {
      mbar_expect_tx(&sm.q_full, kBQ * D * 2);
#pragma unroll
      for (int c = 0; c < NB; ++c)
        tma_load(sm.q[c], &tm_q, &sm.q_full, 64 * c, q0, h, b);
      for (int it = 0; it < n_kt; ++it) {
        const int st = it % kStages;
        mbar_wait(&sm.empty[st], ((it / kStages) & 1) ^ 1);
        mbar_expect_tx(&sm.full[st], 2 * kBK * D * 2);
#pragma unroll
        for (int c = 0; c < NB; ++c) {
          tma_load(sm.k[st][c], &tm_k, &sm.full[st], 64 * c, it * kBK, hk, b);
          tma_load(sm.v[st][c], &tm_v, &sm.full[st], 64 * c, it * kBK, hk, b);
        }
      }
    }
    return;
  }

  // --------------------------------------------------------- consumers
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
  const int cw = wg - 1;                      // 64 rows: q0 + 64 cw ...
  const int t = threadIdx.x - 128 * wg;
  const int warp = t / 32, lane = t % 32, g = lane / 4, tig = lane % 4;
  // accumulator element 4j + e (j < N/8, e < 4) of an m64nN product sits
  // at row 16 warp + g + 8 (e / 2), column 8j + 2 tig + (e % 2)
  const int row0 = q0 + 64 * cw + 16 * warp + g;
  const int pos0 = row0 + q_off;              // key position of row0
  const int wg_first = q0 + 64 * cw + q_off;  // of the warpgroup's first row

  float acc[D / 2];
  float s[kBK / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < kBK / 2; ++i) s[i] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};

  const uint32_t q_base = smem_u32(sm.q[0]) + 64 * cw * kRowBytes;
  mbar_wait(&sm.q_full, 0);

  for (int it = 0; it < n_kt; ++it) {
    const int st = it % kStages;
    const int k0 = it * kBK;
    mbar_wait(&sm.full[st], (it / kStages) & 1);
    const uint32_t k_base = smem_u32(sm.k[st][0]);
    const uint32_t v_base = smem_u32(sm.v[st][0]);

    // S = Q K^T over D in steps of 16 (32 bytes within a swizzled row)
    hold_regs(s);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t off = (kk % 4) * 32;
      wgmma_ss<kBK>(s,
                    sw128_desc(q_base + (kk / 4) * kQBlock + off, 16, 1024),
                    sw128_desc(k_base + (kk / 4) * kKVBlock + off, 16, 1024),
                    kk > 0);
    }
    wgmma_commit();
    wgmma_wait_all();
    hold_regs(s);

    // scale to log2 units, then mask (the TPU kernel's order); only tiles
    // that reach past Sk or across the warpgroup's diagonal need it
#pragma unroll
    for (int i = 0; i < kBK / 2; ++i) s[i] *= scale_log2;
    if (k0 + kBK > Sk || (causal && k0 + kBK - 1 > wg_first)) {
#pragma unroll
      for (int j = 0; j < kBK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = k0 + 8 * j + 2 * tig + (e & 1);
          if (col >= Sk || (causal && col > pos0 + 8 * (e >> 1)))
            s[4 * j + e] = kNegInf;
        }
    }

    // online softmax: the two rows a thread holds, reduced over its quad
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int j = 0; j < kBK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], s[4 * j + e]);
    float corr[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      corr[r] = ex2(m[r] - mx[r]);
      m[r] = mx[r];
    }
#pragma unroll
    for (int j = 0; j < kBK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = ex2(s[4 * j + e] - m[e >> 1]);
        s[4 * j + e] = p;
        sum[e >> 1] += p;
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * corr[r] + sum[r];  // partial
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[4 * j + e] *= corr[e >> 1];

    // p as hi + lo bf16 A fragments: k step kk's four registers are the S
    // accumulator's elements 8 kk .. 8 kk + 7, in pairs
    uint32_t ph[kBK / 16][4], pl[kBK / 16][4];
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float x = s[8 * kk + 2 * r], y = s[8 * kk + 2 * r + 1];
        const __nv_bfloat162 hi = __floats2bfloat162_rn(x, y);
        const float2 hf = __bfloat1622float2(hi);
        ph[kk][r] = bf16x2_bits(hi);
        pl[kk][r] = bf16x2_bits(__floats2bfloat162_rn(x - hf.x, y - hf.y));
      }

    // O += P_hi V + P_lo V over the tile's keys in steps of 16 (2,048 B)
    hold_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      const uint64_t dv = sw128_desc(v_base + kk * 16 * kRowBytes, kKVBlock,
                                     1024);
      wgmma_rs<D>(acc, ph[kk], dv);
      wgmma_rs<D>(acc, pl[kk], dv);
    }
    wgmma_commit();
    wgmma_wait_all();
    hold_regs(acc);
    hold_regs(ph);
    hold_regs(pl);
    mbar_arrive(&sm.empty[st]);
  }

  // epilogue: rows at or past Sq are not written
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    const int row = row0 + 8 * r;
    if (row >= Sq) continue;
    const float lc = fmaxf(l[r], 1e-30f);
    const float inv = 1.f / lc;
    __nv_bfloat16* o_r = o + b * osb + (long long)row * oss + h * osh;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(o_r + 8 * j + 2 * tig) =
          __floats2bfloat162_rn(acc[4 * j + 2 * r] * inv,
                                acc[4 * j + 2 * r + 1] * inv);
    if (tig == 0)
      lse[((long long)b * Hq + h) * Sq + row] = m[r] * kLn2 + logf(lc);
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult res;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                                &res) != cudaSuccess ||
        res != cudaDriverEntryPointSuccess)
      return static_cast<EncodeTiled>(nullptr);
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

// a [B, S, H, D] bf16 tensor with element strides (sb, ss, sh) as the 4-D
// map {D, S, H, B}, read in boxes of {64, rows, 1, 1}, 128-byte swizzled;
// rows past S read as zeros
bool make_map(CUtensorMap* map, const void* ptr, int B, int S, int H, int D,
              long long sb, long long ss, long long sh, int rows) {
  const EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)S, (cuuint64_t)H,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)ss * 2, (cuuint64_t)sh * 2,
                                 (cuuint64_t)sb * 2};
  const cuuint32_t box[4] = {64, (cuuint32_t)rows, 1, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
             dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

bool tma_ok(const void* ptr, long long sb, long long ss, long long sh) {
  return reinterpret_cast<uintptr_t>(ptr) % 16 == 0 && sb > 0 && ss > 0 &&
         sh > 0 && sb % 8 == 0 && ss % 8 == 0 && sh % 8 == 0;
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, void* lse,
           int B, int Sq, int Sk, int Hq, int Hkv, const long long* st,
           int causal, float scale, cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  if (!make_map(&tq, q, B, Sq, Hq, D, st[0], st[1], st[2], kBQ) ||
      !make_map(&tk, k, B, Sk, Hkv, D, st[3], st[4], st[5], kBK) ||
      !make_map(&tv, v, B, Sk, Hkv, D, st[6], st[7], st[8], kBK))
    return (int)cudaErrorInvalidValue;
  const int smem = (int)sizeof(Smem<D>) + 1024;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_wgmma_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(Hq, (Sq + kBQ - 1) / kBQ, B);
  flash_fwd_wgmma_kernel<D><<<grid, kThreads, smem, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), static_cast<float*>(lse), Sq,
      Sk, Hq, Hkv, st[9], st[10], st[11], causal,
      scale * 1.4426950408889634f);
  return (int)cudaGetLastError();
}

}  // namespace

// q/o: [B, Sq, Hq, D] and k/v: [B, Sk, Hkv, D] bf16, each with element
// strides (batch, sequence, head) and a contiguous D axis; D is 64 or 128.
// q, k and v are read by TMA: 16-byte-aligned bases and strides that are
// multiples of 8 elements (a dim of size 1 may be given any such stride).
// lse: [B, Hq, Sq] f32, contiguous. causal != 0 requires Sq <= Sk. Returns
// the cudaError_t of the launch (0 on success).
extern "C" int flash_attention_fwd_wgmma(
    const void* q, const void* k, const void* v, void* o, void* lse, int B,
    int Sq, int Sk, int Hq, int Hkv, int D, long long qsb, long long qss,
    long long qsh, long long ksb, long long kss, long long ksh,
    long long vsb, long long vss, long long vsh, long long osb,
    long long oss, long long osh, int causal, float scale, void* stream) {
  if (B <= 0 || Sq <= 0 || Sk <= 0 || Hkv <= 0 || Hq % Hkv != 0 ||
      B > 65535 || (Sq + kBQ - 1) / kBQ > 65535 || (causal && Sq > Sk) ||
      !tma_ok(q, qsb, qss, qsh) || !tma_ok(k, ksb, kss, ksh) ||
      !tma_ok(v, vsb, vss, vsh))
    return (int)cudaErrorInvalidValue;
  const long long st[12] = {qsb, qss, qsh, ksb, kss, ksh,
                            vsb, vss, vsh, osb, oss, osh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64:
      return launch<64>(q, k, v, o, lse, B, Sq, Sk, Hq, Hkv, st, causal,
                        scale, s);
    case 128:
      return launch<128>(q, k, v, o, lse, B, Sq, Sk, Hq, Hkv, st, causal,
                         scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
