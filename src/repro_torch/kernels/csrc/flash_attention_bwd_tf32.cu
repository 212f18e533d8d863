// Flash attention backward in f32 (causal or not, GQA) for Hopper (sm_90a),
// on the tensor cores in 3xTF32 with wgmma: a dq kernel and a dk/dv kernel.
//
// Replaces the Pallas TPU kernels of src/repro/kernels/flash_attention.py
// flash_attention_bwd (line 281: _bwd_dq_kernel at :198 and its pallas_call
// at :299; _bwd_dkv_kernel at :236 and its pallas_call at :324) for f32
// inputs at head dim 64 or 128 (kernels/flash_attention.py:backward_route;
// the SIMT pair in flash_attention.cu keeps f32 at the other head dims).
// The function is the other routes': from the saved q, k, v, the cotangent
// dO, lse ([B, Hq, Sq] f32, natural log) and delta = rowsum(dO * O) ([B,
// Hq, Sq] f32, computed by the wrapper), with kv head h / G (G = Hq / Hkv),
// scale = D^-1/2 and, causal, q_off = Sk - Sq:
//   p  = exp(s * scale - lse), exactly 0 where masked (key >= Sk, query
//        >= Sq, or causal and key > row + q_off); read as exp2 after
//        multiplying s and lse by log2(e)
//   ds = p * (dO v^T - delta)
//   dq = ds k * scale,  dk = ds^T q * scale,  dv = p^T dO  (dk and dv
//        summed over each kv head's group of G q heads)
// all three written in f32. Each gradient element has one owner and its
// sums run in a fixed order, with no atomics, so two runs agree bit for
// bit.
//
// What bounds it on the H100: operations. At the LM training shape (B=2,
// S=4,096, Hq=40, Hkv=8, D=128, causal) there are 671,252,480 visible
// (query, key) pairs; the function's five products are 8.59e11 FLOP: 12.82
// ms at the 67 TFLOP/s f32 rate of the CUDA cores (the SIMT pair's
// ceiling), 5.21 ms in 3xTF32 (three TF32 products for each f32 one) at
// 495 TFLOP/s. This design runs seven products a pair (S and dP in both
// kernels): 7.29 ms, its own floor, plus the masked halves of the diagonal
// tiles. Its bytes (~0.81 GB read and written once) take 0.24 ms.
//
// Precision. Every product is 3xTF32 (tf32_mma.cuh): each f32 operand
// split into hi = tf32(x) and lo = x - hi, a product hi*lo + lo*hi + hi*hi
// into one f32 accumulator. p and ds are split the same way; none is
// rounded to bf16 and no product runs in tf32 alone (the CPU model in
// tests/test_torch_flash_tf32.py shows one product a step missing the f32
// limit). The long sums are f32 adds: each tile's output product goes into
// a fresh accumulator (scale-d 0 on its first wgmma) that is added to the
// running sum with an FADD, as in the bf16 pair.
//
// Orientation. tf32 wgmma reads both shared-memory operands K-major only
// (no transposed tf32 operand), so each product is written with its
// reduction axis contiguous in shared memory, or with A in registers:
//   dq CTA (64 query rows of one q head; key tiles of 32 stream):
//     S  = Q K^T    A: Q, hi in registers, lo in a plane; B: K planes
//     dP = dO V^T   A: dO likewise; B: V planes
//     dQ^T = K^T dS^T   A: K^T, read into registers from the K planes
//                      (a transposed read costs nothing there); B: dS,
//                      staged by the CTA as [query][key] planes
//   dk/dv CTA (64 keys of one kv head; the query tiles of 32 of each of
//   the G q heads stream, from the tile that holds the block's diagonal):
//     S^T  = K Q^T   A: K, hi in registers, lo in a plane; B: Q planes
//     dP^T = V dO^T  A: V likewise; B: dO planes
//     dV^T = dO^T P  A: dO^T read into registers from the dO planes;
//                    B: P, staged as [key][query] planes
//     dK^T = Q^T dS  A: Q^T from the Q planes; B: dS, staged likewise
// So K, V, Q and dO are each needed in one orientation only, row by row
// ([row][D], D contiguous), and no tensor is transposed in memory. A first
// kernel (split_planes_kernel) splits them once into tf32 hi and lo
// planes, per tile of 32 rows four 128-byte-swizzled planes (x hi, x lo,
// y hi, y lo as [D/32 column blocks][32 rows][128 B]) in a scratch buffer
// the wrapper allocates: K and V for the dq call, Q and dO for the dk/dv
// call. Splitting inside the CTAs instead would split each tile once for
// every CTA that reads it (64 times at S=4,096). Planes of Q^T, dO^T and K^T
// would double the streamed bytes and the shared memory a stage takes:
// 3xTF32 operands are 8 bytes an element, four times bf16's, and a stage of
// all eight planes of 32 query rows would not fit twice in shared memory.
// At the shape above the scratch is 134 MB (K, V) for the dq call and 671
// MB (Q, dO) for the dk/dv call, one buffer of the larger reused by both
// on one stream; the two splits read 0.40 GB and write 0.81 GB: ~0.36 ms at
// 3.35 TB/s.
//
// Both main kernels are 384-thread CTAs, one per SM: warpgroup 0 is the
// producer (setmaxnreg.dec to 24; one thread streams the tiles into a
// two-stage mbarrier ring with 1-D bulk copies), warpgroups 1 and 2 are
// consumers (setmaxnreg.inc to 240) that split the products between them
// without repeating any:
//   dq:    WG 1 makes S and p, WG 2 dP and ds (p handed over in shared
//          memory); then each computes half of dQ^T on the staged dS (the
//          D/2 = 64 dims of its half at D=128, or 32 of the 64 queries at
//          D=64);
//   dk/dv: WG 1 makes S^T and p and accumulates dV^T, WG 2 makes dP^T and
//          ds (reading p from the staged P planes) and accumulates dK^T.
// The dq CTAs take their row tiles longest causal row first, the G q heads
// of a kv head adjacent in the grid so that they read the same key tiles
// from L2; the dk/dv CTAs take their key blocks first key first (the most
// query tiles first). Named barriers order the hand-overs: the staging
// buffers are single, so a CTA's two consumers run one tile in step. A dq
// CTA owns 64 query rows, not the bf16 pair's 128: with 8 bytes an
// element, 128 rows' Q and dO lo planes (128 KB) and two stages of key
// tiles (128 KB) would not fit shared memory.
//
// Registers, per consumer thread at D=128: the fixed operand's hi
// fragments (64), the running sum (32 in dq, 64 in dk/dv), and either the
// scores (16) or a fresh tile accumulator (32) and the transposed A
// fragments (32); dk/dv runs its two D halves one after the other to stay
// within the 240 that setmaxnreg gives; `ptxas -v` reports the spills.
//
// Shared memory at D=128: dq 216 KB (the two lo planes 64 KB, two stages
// of 64 KB, dS 16 KB, p 8 KB), dk/dv 224 KB (lo planes 64 KB, stages 128
// KB, P and dS 32 KB), plus 1 KB of alignment; at D=64 about half.
//
// Measured on an H100 (700 W; PERF.md): 16.3 ms at the shape above, both
// calls (SDPA's f32 backward 38.5 ms and the SIMT pair 65.6 ms in the same
// run), 32% of the 3xTF32 bound; dk/dv 9.6 ms, dq 6.1 ms, the two splits
// 0.44 ms (2.7%); errors within 5.5e-6 of each gradient's largest.
#include "hopper.cuh"
#include "tf32_mma.cuh"

namespace {

using namespace hopper;
using tf32x3::split;

constexpr int kThreads = 384;          // producer warpgroup + 2 consumers
constexpr int kConsumerThreads = 256;
constexpr int kStages = 2;             // ring depth of streamed tiles
constexpr int kTile = 32;              // rows of a streamed tile
constexpr int kRows = 64;              // queries a dq CTA owns, keys a dk/dv
constexpr int kOwnBlock = kRows * kRowBytes;   // a 64-row column block
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

// one streamed tile: x hi, x lo, y hi, y lo, each [D/32 column blocks]
// [kTile rows][128 B], 128-byte swizzled
template <int D>
struct Tile {
  static constexpr int kBlock = kTile * kRowBytes;
  static constexpr int kPlane = kTile * D * 4;
  static constexpr int kBytes = 4 * kPlane;
};

template <int D>
struct SmemDq {
  uint8_t lo[2][D / 32][kOwnBlock];        // Q lo (WG 1), dO lo (WG 2)
  uint8_t stage[kStages][Tile<D>::kBytes]; // K hi, K lo, V hi, V lo
  uint8_t ds[2][kOwnBlock];                // dS hi, lo: [64 queries][32 keys]
  float p[kTile / 2][128];                 // p, element i of thread t
  uint64_t full[kStages];
  uint64_t empty[kStages];
};

template <int D>
struct SmemDkv {
  uint8_t lo[2][D / 32][kOwnBlock];        // K lo (WG 1), V lo (WG 2)
  uint8_t stage[kStages][Tile<D>::kBytes]; // Q hi, Q lo, dO hi, dO lo
  uint8_t p[2][kOwnBlock];                 // P hi, lo: [64 keys][32 queries]
  uint8_t ds[2][kOwnBlock];                // dS hi, lo, likewise
  uint64_t full[kStages];
  uint64_t empty[kStages];
};

__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(threads) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;" ::"r"(id), "r"(threads) : "memory");
}
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

template <typename Smem>
__device__ __forceinline__ Smem& aligned_smem(uint8_t* raw_smem) {
  const uint32_t raw = smem_u32(raw_smem);
  return *reinterpret_cast<Smem*>(raw_smem + (((raw + 1023) & ~1023u) - raw));
}

__device__ __forceinline__ void init_ring(uint64_t* full, uint64_t* empty) {
  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumerThreads);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
}

// the producer: tile `it` of `n` (at src(it)) into stage it % kStages once
// every consumer has released that stage
template <int D, typename Src>
__device__ __forceinline__ void produce(uint8_t (*stage)[Tile<D>::kBytes],
                                        uint64_t* full, uint64_t* empty,
                                        int n, Src src) {
  for (int it = 0; it < n; ++it) {
    const int st = it % kStages;
    mbar_wait(&empty[st], ((it / kStages) & 1) ^ 1);
    mbar_expect_tx(&full[st], Tile<D>::kBytes);
    bulk_load(stage[st], src(it), Tile<D>::kBytes, &full[st]);
  }
}

// rows r0 .. r0 + 63 of the [S, D] view x (row stride xs; rows past S as
// 0) as this warpgroup's A operand: hi into registers (a0..a3: rows g, g +
// 8, g, g + 8 and columns t, t, t + 4, t + 4 of each 8-wide step), lo into
// its swizzled plane of 64 rows (the A of the lo*hi product)
template <int D>
__device__ __forceinline__ void load_fixed(const float* __restrict__ x,
                                           int S, int r0, long long xs,
                                           int warp, int g, int tig,
                                           uint32_t (&ah)[D / 8][4],
                                           uint8_t* lo_plane) {
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = 16 * warp + g + 8 * (e & 1);
      const int col = 8 * j + tig + 4 * (e >> 1);
      const float v = r0 + r < S ? __ldg(x + (long long)(r0 + r) * xs + col)
                                 : 0.f;
      uint32_t lo;
      split<false>(v, ah[j][e], lo);
      *reinterpret_cast<uint32_t*>(lo_plane + (col >> 5) * kOwnBlock +
                                   swz(r, col & 31)) = lo;
    }
}

// s = A B^T over D, m64n32 (the fixed operand's 64 rows against a streamed
// tile's 32): per 8-wide step Ahi Blo + Alo Bhi + Ahi Bhi, with A's hi in
// registers, its lo in the plane at a_lo, B's hi and lo planes at b_hi and
// b_hi + one plane. Committed, not waited for.
template <int D>
__device__ __forceinline__ void scores(float (&s)[kTile / 2],
                                       const uint32_t (&ah)[D / 8][4],
                                       uint32_t a_lo, uint32_t b_hi) {
  const uint32_t b_lo = b_hi + Tile<D>::kPlane;
  hold_regs(s);
  wgmma_fence();
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const uint32_t off = (j / 4) * Tile<D>::kBlock + (j % 4) * 32;
    const uint32_t aoff = (j / 4) * kOwnBlock + (j % 4) * 32;
    tf32_rs<kTile>(s, ah[j], sw128_desc(b_lo + off, 16, 1024), j > 0);
    tf32_ss<kTile>(s, sw128_desc(a_lo + aoff, 16, 1024),
                   sw128_desc(b_hi + off, 16, 1024));
    tf32_rs<kTile>(s, ah[j], sw128_desc(b_hi + off, 16, 1024));
  }
  wgmma_commit();
}

// tile = X^T W, m64nN, into a fresh accumulator: X a streamed tile's
// planes (hi at x_hi, lo one plane on), A = X^T's rows d0 .. d0 + 63
// (dims) over its 32 rows, read into registers; W's hi and lo planes (N
// rows of 32 columns, swizzled) at w_hi and w_lo. Waited for.
template <int D, int N>
__device__ __forceinline__ void transposed_product(
    float (&tile)[N / 2], const uint8_t* x_hi, int d0, uint32_t w_hi,
    uint32_t w_lo, int warp, int g, int tig) {
  uint32_t fh[kTile / 8][4], fl[kTile / 8][4];
#pragma unroll
  for (int kk = 0; kk < kTile / 8; ++kk)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int d = d0 + 16 * warp + g + 8 * (e & 1);
      const int r = 8 * kk + tig + 4 * (e >> 1);
      const uint32_t off = (d >> 5) * Tile<D>::kBlock + swz(r, d & 31);
      fh[kk][e] = *reinterpret_cast<const uint32_t*>(x_hi + off);
      fl[kk][e] =
          *reinterpret_cast<const uint32_t*>(x_hi + Tile<D>::kPlane + off);
    }
  hold_regs(tile);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < kTile / 8; ++kk) {
    const uint64_t dl = sw128_desc(w_lo + kk * 32, 16, 1024);
    const uint64_t dh = sw128_desc(w_hi + kk * 32, 16, 1024);
    tf32_rs<N>(tile, fh[kk], dl, kk > 0);
    tf32_rs<N>(tile, fl[kk], dh);
    tf32_rs<N>(tile, fh[kk], dh);
  }
  wgmma_commit();
  wgmma_wait_all();
  hold_regs(tile);
  hold_regs(fh);
  hold_regs(fl);
}

// the pair (x, y) of accumulator elements 4j + 2r, 4j + 2r + 1 (row 16 warp
// + g + 8r, columns 8j + 2 tig, + 1) as hi and lo into a swizzled staging
// pair of 64 rows of 32 columns (hi at st, lo one block on)
__device__ __forceinline__ void stage_pair(uint8_t* st, int row, int col,
                                           float x, float y) {
  uint2 hi, lo;
  split<false>(x, hi.x, lo.x);
  split<false>(y, hi.y, lo.y);
  const uint32_t off = swz(row, col);
  *reinterpret_cast<uint2*>(st + off) = hi;
  *reinterpret_cast<uint2*>(st + kOwnBlock + off) = lo;
}

// ------------------------------------------------------------ the split
// One CTA per (tile of 32 rows, head, b) of x and y ([B, S, H, D] f32, read
// as float4): the tile's four planes, x hi, x lo, y hi, y lo (rows past S
// as 0)
template <int D>
__global__ void __launch_bounds__(256)
split_planes_kernel(const float* __restrict__ x, const float* __restrict__ y,
                    uint8_t* __restrict__ planes, int S, int H, int n_t,
                    long long xsb, long long xss, long long xsh,
                    long long ysb, long long yss, long long ysh) {
  using T = Tile<D>;
  constexpr int kVec = kTile * D / 4;          // float4s of one tensor
  const int tt = blockIdx.x, hh = blockIdx.y, b = blockIdx.z;
  uint8_t* tile =
      planes + (((long long)b * H + hh) * n_t + tt) * (long long)T::kBytes;
  const int r0 = tt * kTile;
  for (int e = threadIdx.x; e < 2 * kVec; e += 256) {
    const bool is_y = e >= kVec;
    const int i = is_y ? e - kVec : e;
    const int row = i / (D / 4), d = 4 * (i % (D / 4));
    float4 f = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r0 + row < S) {
      const float* src =
          is_y ? y + b * ysb + (long long)(r0 + row) * yss + hh * ysh
               : x + b * xsb + (long long)(r0 + row) * xss + hh * xsh;
      f = __ldg(reinterpret_cast<const float4*>(src + d));
    }
    uint4 hi, lo;
    split<false>(f.x, hi.x, lo.x);
    split<false>(f.y, hi.y, lo.y);
    split<false>(f.z, hi.z, lo.z);
    split<false>(f.w, hi.w, lo.w);
    const uint32_t off = (is_y ? 2 * T::kPlane : 0) + (d >> 5) * T::kBlock +
                         swz(row, d & 31);
    *reinterpret_cast<uint4*>(tile + off) = hi;
    *reinterpret_cast<uint4*>(tile + off + T::kPlane) = lo;
  }
}

// --------------------------------------------------------------- dq
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dq_tf32_kernel(const float* __restrict__ q,
                         const float* __restrict__ dout,
                         const uint8_t* __restrict__ planes,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         float* __restrict__ dq, int Sq, int Sk, int Hq,
                         int Hkv, int n_kt_all, long long qsb, long long qss,
                         long long qsh, long long dsb, long long dss,
                         long long dsh, long long osb, long long oss,
                         long long osh, int causal, float scale,
                         float scale_log2) {
  using T = Tile<D>;
  // this warpgroup's part of dQ^T: at D=128 its 64 dims (d0) of all 64
  // queries, at D=64 all 64 dims of its 32 queries (q_part)
  constexpr int NO = D == 128 ? 64 : 32;
  extern __shared__ uint8_t smem_raw[];
  SmemDq<D>& sm = aligned_smem<SmemDq<D>>(smem_raw);

  const int h = blockIdx.x, b = blockIdx.z;
  const int q0 = ((int)gridDim.y - 1 - (int)blockIdx.y) * kRows;
  const int hk = h / (Hq / Hkv);
  const int q_off = Sk - Sq;
  // keys past the block's last row are masked for every row: stop there
  const int k_end = causal ? min(Sk, q0 + kRows + q_off) : Sk;
  const int n_kt = (k_end + kTile - 1) / kTile;
  const uint8_t* tiles =
      planes + ((long long)b * Hkv + hk) * n_kt_all * (long long)T::kBytes;
  const int wg = threadIdx.x / 128;
  init_ring(sm.full, sm.empty);

  if (wg == 0) {
    // ------------------------------------------------------- producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 0)
      produce<D>(sm.stage, sm.full, sm.empty, n_kt, [&](int it) {
        return tiles + (long long)it * T::kBytes;
      });
    return;
  }

  // --------------------------------------------------------- consumers
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
  const int cw = wg - 1;                // 0: Q, S and p; 1: dO, dP and ds
  const int t = threadIdx.x - 128 * wg;
  const int warp = t / 32, lane = t % 32, g = lane / 4, tig = lane % 4;
  // accumulator element 4j + e of an m64nN product sits at row 16 warp + g
  // + 8 (e / 2), column 8j + 2 tig + (e % 2)
  const int rl0 = 16 * warp + g;        // this thread's rows rl0, rl0 + 8
  const int pos0 = q0 + rl0 + q_off;    // key position of its first row
  const long long stat0 = ((long long)b * Hq + h) * Sq;
  uint32_t ah[D / 8][4];
  if (cw == 0)
    load_fixed<D>(q + b * qsb + h * qsh, Sq, q0, qss, warp, g, tig, ah,
                  sm.lo[0][0]);
  else
    load_fixed<D>(dout + b * dsb + h * dsh, Sq, q0, dss, warp, g, tig, ah,
                  sm.lo[1][0]);
  // lse in log2 units (WG 1) or delta (WG 2) of its two rows; rows past Sq
  // have zero q and dO, so p = 1 and ds = 0 there, never written
  float stat[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + rl0 + 8 * r;
    stat[r] = row >= Sq ? 0.f
              : cw == 0 ? lse[stat0 + row] * kLog2e : delta[stat0 + row];
  }
  fence_async_smem();
  bar_sync(1 + cw, 128);                // its lo plane, before wgmma reads it

  float acc[NO / 2];
#pragma unroll
  for (int i = 0; i < NO / 2; ++i) acc[i] = 0.f;
  const uint32_t a_lo = smem_u32(sm.lo[cw][0]);
  const int d0 = D == 128 ? 64 * cw : 0;
  const int q_part = D == 128 ? 0 : 32 * cw;
  const uint32_t w_hi = smem_u32(sm.ds[0]) + q_part * kRowBytes;
  const uint32_t w_lo = smem_u32(sm.ds[1]) + q_part * kRowBytes;

  for (int it = 0; it < n_kt; ++it) {
    const int st = it % kStages;
    const int k0 = it * kTile;
    mbar_wait(&sm.full[st], (it / kStages) & 1);
    const uint8_t* stage = sm.stage[st];
    // S = Q K^T (WG 1) or dP = dO V^T (WG 2)
    float s[kTile / 2];
    scores<D>(s, ah, a_lo, smem_u32(stage) + (cw == 0 ? 0 : 2 * T::kPlane));
    wgmma_wait_all();
    hold_regs(s);

    if (cw == 0) {
      // mask (p = 0) only tiles that reach past Sk or across the first
      // row's diagonal
      if (k0 + kTile > Sk || (causal && k0 + kTile - 1 > q0 + q_off)) {
#pragma unroll
        for (int j = 0; j < kTile / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int col = k0 + 8 * j + 2 * tig + (e & 1);
            if (col >= Sk || (causal && col > pos0 + 8 * (e >> 1)))
              s[4 * j + e] = kNegInf;
          }
      }
#pragma unroll
      for (int i = 0; i < kTile / 2; ++i)
        sm.p[i][t] = ex2(fmaf(s[i], scale_log2, -stat[(i >> 1) & 1]));
      bar_sync(3, kConsumerThreads);    // p handed over
      bar_sync(3, kConsumerThreads);    // dS staged
    } else {
      bar_sync(3, kConsumerThreads);    // p handed over
      // ds = p (dP - delta), staged as hi and lo planes [query][key]
#pragma unroll
      for (int j = 0; j < kTile / 8; ++j)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int i = 4 * j + 2 * r;
          stage_pair(sm.ds[0], rl0 + 8 * r, 8 * j + 2 * tig,
                     sm.p[i][t] * (s[i] - stat[r]),
                     sm.p[i + 1][t] * (s[i + 1] - stat[r]));
        }
      fence_async_smem();
      bar_sync(3, kConsumerThreads);    // dS staged
    }

    // this warpgroup's part of this tile's dQ^T = K^T dS^T, then added to
    // the running sum
    float tile[NO / 2];
    transposed_product<D, NO>(tile, stage, d0, w_hi, w_lo, warp, g, tig);
    mbar_arrive(&sm.empty[st]);
#pragma unroll
    for (int i = 0; i < NO / 2; ++i) acc[i] += tile[i];
  }

  // epilogue: element 4j + e is dim d0 + rl0 + 8 (e / 2), query q_part +
  // 8j + 2 tig + (e % 2); rows at or past Sq are not written
#pragma unroll
  for (int j = 0; j < NO / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = q0 + q_part + 8 * j + 2 * tig + (e & 1);
      if (row < Sq)
        dq[b * osb + (long long)row * oss + h * osh + d0 + rl0 +
           8 * (e >> 1)] = acc[4 * j + e] * scale;
    }
}

// ------------------------------------------------------------- dk/dv
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dkv_tf32_kernel(const float* __restrict__ k,
                          const float* __restrict__ v,
                          const uint8_t* __restrict__ planes,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta,
                          float* __restrict__ dk, float* __restrict__ dv,
                          int Sq, int Sk, int Hq, int Hkv, int n_qt_all,
                          long long ksb, long long kss, long long ksh,
                          long long vsb, long long vss, long long vsh,
                          long long dksb, long long dkss, long long dksh,
                          long long dvsb, long long dvss, long long dvsh,
                          int causal, float scale, float scale_log2) {
  using T = Tile<D>;
  constexpr int NH = D / 64;            // 64-dim halves of dK^T and dV^T
  extern __shared__ uint8_t smem_raw[];
  SmemDkv<D>& sm = aligned_smem<SmemDkv<D>>(smem_raw);

  const int hk = blockIdx.x, b = blockIdx.z;
  const int k0 = blockIdx.y * kRows;    // first key blocks issued first
  const int G = Hq / Hkv;
  const int q_off = Sk - Sq;
  // rows before the first that sees key k0 (row + q_off >= k0) see none of
  // this block's keys: start at the query tile that holds it
  const int q_first = causal ? max(0, k0 - q_off) / kTile * kTile : 0;
  const int n_qt = (Sq - q_first + kTile - 1) / kTile;   // per q head
  const int n_it = G * n_qt;
  const int wg = threadIdx.x / 128;
  init_ring(sm.full, sm.empty);

  if (wg == 0) {
    // ------------------------------------------------------- producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 0)
      produce<D>(sm.stage, sm.full, sm.empty, n_it, [&](int it) {
        const int h = hk * G + it / n_qt;
        const int tq = q_first / kTile + it % n_qt;
        return planes + (((long long)b * Hq + h) * n_qt_all + tq) *
                            (long long)T::kBytes;
      });
    return;
  }

  // --------------------------------------------------------- consumers
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
  const int cw = wg - 1;     // 0: K, S^T, p and dV^T; 1: V, dP^T, ds, dK^T
  const int t = threadIdx.x - 128 * wg;
  const int warp = t / 32, lane = t % 32, g = lane / 4, tig = lane % 4;
  // accumulator rows are keys, columns the streamed tile's queries
  const int rl0 = 16 * warp + g;
  const int key0 = k0 + rl0;
  uint32_t ah[D / 8][4];
  if (cw == 0)
    load_fixed<D>(k + b * ksb + hk * ksh, Sk, k0, kss, warp, g, tig, ah,
                  sm.lo[0][0]);
  else
    load_fixed<D>(v + b * vsb + hk * vsh, Sk, k0, vss, warp, g, tig, ah,
                  sm.lo[1][0]);
  fence_async_smem();
  bar_sync(1 + cw, 128);

  float acc[NH][32];
#pragma unroll
  for (int hh = 0; hh < NH; ++hh)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[hh][i] = 0.f;
  const uint32_t a_lo = smem_u32(sm.lo[cw][0]);
  uint8_t* mine = cw == 0 ? sm.p[0] : sm.ds[0];   // the pair it stages
  const uint32_t w_hi = smem_u32(mine), w_lo = w_hi + kOwnBlock;

  for (int it = 0; it < n_it; ++it) {
    const int st = it % kStages;
    const int h = hk * G + it / n_qt;
    const int q0 = q_first + (it % n_qt) * kTile;
    mbar_wait(&sm.full[st], (it / kStages) & 1);
    const uint8_t* stage = sm.stage[st];
    // S^T = K Q^T (WG 1) or dP^T = V dO^T (WG 2)
    float s[kTile / 2];
    scores<D>(s, ah, a_lo, smem_u32(stage) + (cw == 0 ? 0 : 2 * T::kPlane));
    // while the products run: the lse (in log2 units) or delta of this
    // thread's 8 query columns (past Sq as 0: masked)
    float stat[kTile / 4];
    {
      const long long at = ((long long)b * Hq + h) * Sq;
#pragma unroll
      for (int j = 0; j < kTile / 8; ++j)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int qq = q0 + 8 * j + 2 * tig + c;
          stat[2 * j + c] = qq >= Sq ? 0.f
                            : cw == 0 ? lse[at + qq] * kLog2e
                                      : delta[at + qq];
        }
    }
    wgmma_wait_all();
    hold_regs(s);

    if (cw == 0) {
      // mask (p = 0): queries past Sq, and causal keys past a row's
      // position
      if (q0 + kTile > Sq || (causal && k0 + kRows - 1 > q0 + q_off)) {
#pragma unroll
        for (int j = 0; j < kTile / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int col = q0 + 8 * j + 2 * tig + (e & 1);
            if (col >= Sq || (causal && key0 + 8 * (e >> 1) > col + q_off))
              s[4 * j + e] = kNegInf;
          }
      }
#pragma unroll
      for (int i = 0; i < kTile / 2; ++i)
        s[i] = ex2(fmaf(s[i], scale_log2, -stat[2 * (i >> 2) + (i & 1)]));
      // WG 2 has read the previous tile's P, and every warp of this one
      // has finished the dV^T products that read it
      if (it > 0) bar_sync(4, kConsumerThreads);
#pragma unroll
      for (int j = 0; j < kTile / 8; ++j)
#pragma unroll
        for (int r = 0; r < 2; ++r)
          stage_pair(mine, rl0 + 8 * r, 8 * j + 2 * tig, s[4 * j + 2 * r],
                     s[4 * j + 2 * r + 1]);
      fence_async_smem();
      bar_arrive(3, kConsumerThreads);  // P staged, for WG 2
      bar_sync(1, 128);                 // and for this warpgroup's wgmma
    } else {
      bar_sync(3, kConsumerThreads);    // P staged
      // p = hi + lo exactly; ds = p (dP - delta), staged as hi and lo
      float p[kTile / 2];
#pragma unroll
      for (int j = 0; j < kTile / 8; ++j)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const uint32_t off = swz(rl0 + 8 * r, 8 * j + 2 * tig);
          const float2 hi = *reinterpret_cast<const float2*>(sm.p[0] + off);
          const float2 lo = *reinterpret_cast<const float2*>(sm.p[1] + off);
          p[4 * j + 2 * r] = hi.x + lo.x;
          p[4 * j + 2 * r + 1] = hi.y + lo.y;
        }
      if (it + 1 < n_it) bar_arrive(4, kConsumerThreads);   // P read
#pragma unroll
      for (int j = 0; j < kTile / 8; ++j)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int i = 4 * j + 2 * r;
          stage_pair(mine, rl0 + 8 * r, 8 * j + 2 * tig,
                     p[i] * (s[i] - stat[2 * j]),
                     p[i + 1] * (s[i + 1] - stat[2 * j + 1]));
        }
      fence_async_smem();
      bar_sync(2, 128);                 // dS staged
    }

    // this tile's dV^T = dO^T P (WG 1) or dK^T = Q^T dS (WG 2), one 64-dim
    // half at a time, each into a fresh accumulator added to the running
    // sum
    const uint8_t* x_hi = stage + (cw == 0 ? 2 * T::kPlane : 0);
#pragma unroll
    for (int hh = 0; hh < NH; ++hh) {
      float tile[32];
      transposed_product<D, 64>(tile, x_hi, 64 * hh, w_hi, w_lo, warp, g,
                                tig);
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[hh][i] += tile[i];
    }
    mbar_arrive(&sm.empty[st]);
  }

  // epilogue: element 4j + e of half hh is dim 64 hh + rl0 + 8 (e / 2),
  // key k0 + 8j + 2 tig + (e % 2); keys at or past Sk are not written
  float* out = cw == 0 ? dv : dk;
  const long long osb = cw == 0 ? dvsb : dksb;
  const long long oss = cw == 0 ? dvss : dkss;
  const long long osh = cw == 0 ? dvsh : dksh;
  const float out_scale = cw == 0 ? 1.f : scale;
#pragma unroll
  for (int hh = 0; hh < NH; ++hh)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + 8 * j + 2 * tig + (e & 1);
        if (key < Sk)
          out[b * osb + (long long)key * oss + hk * osh + 64 * hh + rl0 +
              8 * (e >> 1)] = acc[hh][4 * j + e] * out_scale;
      }
}

template <typename Kernel>
int allow_smem(Kernel kernel, int smem) {
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
}

// x and y as split_planes_kernel's tiles of 32 rows into planes
template <int D>
int split_into(const float* x, const float* y, void* planes, int B, int S,
               int H, const long long* xs, const long long* ys,
               cudaStream_t stream) {
  const int n_t = (S + kTile - 1) / kTile;
  split_planes_kernel<D><<<dim3(n_t, H, B), 256, 0, stream>>>(
      x, y, static_cast<uint8_t*>(planes), S, H, n_t, xs[0], xs[1], xs[2],
      ys[0], ys[1], ys[2]);
  return (int)cudaGetLastError();
}

template <int D>
int launch_dq(const float* q, const float* k, const float* v,
              const float* dout, const float* lse, const float* delta,
              float* dq, void* planes, int B, int Sq, int Sk, int Hq,
              int Hkv, const long long* st, int causal, float scale,
              cudaStream_t stream) {
  int err = split_into<D>(k, v, planes, B, Sk, Hkv, st + 3, st + 6, stream);
  if (err) return err;
  const int smem = (int)sizeof(SmemDq<D>) + 1024;
  err = allow_smem(flash_bwd_dq_tf32_kernel<D>, smem);
  if (err) return err;
  const dim3 grid(Hq, (Sq + kRows - 1) / kRows, B);
  flash_bwd_dq_tf32_kernel<D><<<grid, kThreads, smem, stream>>>(
      q, dout, static_cast<const uint8_t*>(planes), lse, delta, dq, Sq, Sk,
      Hq, Hkv, (Sk + kTile - 1) / kTile, st[0], st[1], st[2], st[9], st[10],
      st[11], st[12], st[13], st[14], causal, scale, scale * kLog2e);
  return (int)cudaGetLastError();
}

template <int D>
int launch_dkv(const float* q, const float* k, const float* v,
               const float* dout, const float* lse, const float* delta,
               float* dk, float* dv, void* planes, int B, int Sq, int Sk,
               int Hq, int Hkv, const long long* st, int causal,
               float scale, cudaStream_t stream) {
  int err = split_into<D>(q, dout, planes, B, Sq, Hq, st, st + 9, stream);
  if (err) return err;
  const int smem = (int)sizeof(SmemDkv<D>) + 1024;
  err = allow_smem(flash_bwd_dkv_tf32_kernel<D>, smem);
  if (err) return err;
  const dim3 grid(Hkv, (Sk + kRows - 1) / kRows, B);
  flash_bwd_dkv_tf32_kernel<D><<<grid, kThreads, smem, stream>>>(
      k, v, static_cast<const uint8_t*>(planes), lse, delta, dk, dv, Sq, Sk,
      Hq, Hkv, (Sq + kTile - 1) / kTile, st[3], st[4], st[5], st[6], st[7],
      st[8], st[12], st[13], st[14], st[15], st[16], st[17], causal, scale,
      scale * kLog2e);
  return (int)cudaGetLastError();
}

// a [B, S, H, D] view read as float4: a 16-byte-aligned base and strides
// that are multiples of 4 elements (a dim of size 1 is never stepped over)
bool vec4_ok(const void* p, const long long* s, int B, int S, int H) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 &&
         (B == 1 || s[0] % 4 == 0) && (S == 1 || s[1] % 4 == 0) &&
         (H == 1 || s[2] % 4 == 0);
}

// what both entry points require: shapes, grid limits, D, a 16-byte-aligned
// scratch of at least the planes its split writes
bool args_ok(int B, int Sq, int Sk, int Hq, int Hkv, int D, int causal,
             const void* planes, long long planes_bytes, long long need) {
  return B > 0 && Sq > 0 && Sk > 0 && Hkv > 0 && Hq % Hkv == 0 &&
         B <= 65535 && Hq <= 65535 && (Sq + kRows - 1) / kRows <= 65535 &&
         (Sk + kRows - 1) / kRows <= 65535 && !(causal && Sq > Sk) &&
         (D == 64 || D == 128) &&
         reinterpret_cast<uintptr_t>(planes) % 16 == 0 &&
         planes_bytes >= need;
}

// the scratch split_into writes: four planes a tile of 32 rows
long long planes_for(int B, int S, int H, int D) {
  return (long long)B * H * ((S + kTile - 1) / kTile) * 4 * kTile * D * 4;
}

}  // namespace

// The backward's two 3xTF32 entry points. q/dO: [B, Sq, Hq, D] and k/v:
// [B, Sk, Hkv, D] f32, dq/dk/dv the same shapes in f32, each with element
// strides (batch, sequence, head) and a contiguous D axis; D is 64 or 128.
// lse and delta = rowsum(dO * O): [B, Hq, Sq] f32, contiguous. planes: a
// 16-byte-aligned scratch of at least B * Hkv * ceil(Sk / 32) * 512 * D
// bytes (dq: the K and V planes) or B * Hq * ceil(Sq / 32) * 512 * D bytes
// (dk/dv: the Q and dO planes); the tensors each entry splits (k and v, or
// q and dO) are read as float4: 16-byte-aligned bases and strides that are
// multiples of 4 elements. flash_attention_bwd_dq_tf32 launches the split
// of k and v and the dq kernel; flash_attention_bwd_dkv_tf32 the split of q
// and dO and the dk/dv kernel (dk and dv summed over each kv head's group
// of q heads). causal != 0 requires Sq <= Sk. Each returns the cudaError_t
// of its launches (0 on success).
extern "C" int flash_attention_bwd_dq_tf32(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dq, void* planes,
    long long planes_bytes, int B, int Sq, int Sk, int Hq, int Hkv, int D,
    long long qsb, long long qss, long long qsh, long long ksb,
    long long kss, long long ksh, long long vsb, long long vss,
    long long vsh, long long dsb, long long dss, long long dsh,
    long long dqsb, long long dqss, long long dqsh, int causal, float scale,
    void* stream) {
  const long long st[15] = {qsb, qss, qsh, ksb, kss, ksh, vsb, vss,
                            vsh, dsb, dss, dsh, dqsb, dqss, dqsh};
  if (!args_ok(B, Sq, Sk, Hq, Hkv, D, causal, planes, planes_bytes,
               planes_for(B, Sk, Hkv, D)))
    return (int)cudaErrorInvalidValue;
  if (!vec4_ok(k, st + 3, B, Sk, Hkv) || !vec4_ok(v, st + 6, B, Sk, Hkv))
    return (int)cudaErrorMisalignedAddress;
  const float *fq = static_cast<const float*>(q),
              *fk = static_cast<const float*>(k),
              *fv = static_cast<const float*>(v),
              *fd = static_cast<const float*>(dout),
              *fl = static_cast<const float*>(lse),
              *fdl = static_cast<const float*>(delta);
  float* out = static_cast<float*>(dq);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return D == 64 ? launch_dq<64>(fq, fk, fv, fd, fl, fdl, out, planes, B, Sq,
                                 Sk, Hq, Hkv, st, causal, scale, s)
                 : launch_dq<128>(fq, fk, fv, fd, fl, fdl, out, planes, B,
                                  Sq, Sk, Hq, Hkv, st, causal, scale, s);
}

extern "C" int flash_attention_bwd_dkv_tf32(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dk, void* dv, void* planes,
    long long planes_bytes, int B, int Sq, int Sk, int Hq, int Hkv, int D,
    long long qsb, long long qss, long long qsh, long long ksb,
    long long kss, long long ksh, long long vsb, long long vss,
    long long vsh, long long dsb, long long dss, long long dsh,
    long long dksb, long long dkss, long long dksh, long long dvsb,
    long long dvss, long long dvsh, int causal, float scale, void* stream) {
  const long long st[18] = {qsb, qss, qsh, ksb,  kss,  ksh,
                            vsb, vss, vsh, dsb,  dss,  dsh,
                            dksb, dkss, dksh, dvsb, dvss, dvsh};
  if (!args_ok(B, Sq, Sk, Hq, Hkv, D, causal, planes, planes_bytes,
               planes_for(B, Sq, Hq, D)))
    return (int)cudaErrorInvalidValue;
  if (!vec4_ok(q, st, B, Sq, Hq) || !vec4_ok(dout, st + 9, B, Sq, Hq))
    return (int)cudaErrorMisalignedAddress;
  const float *fq = static_cast<const float*>(q),
              *fk = static_cast<const float*>(k),
              *fv = static_cast<const float*>(v),
              *fd = static_cast<const float*>(dout),
              *fl = static_cast<const float*>(lse),
              *fdl = static_cast<const float*>(delta);
  float *odk = static_cast<float*>(dk), *odv = static_cast<float*>(dv);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return D == 64 ? launch_dkv<64>(fq, fk, fv, fd, fl, fdl, odk, odv, planes,
                                  B, Sq, Sk, Hq, Hkv, st, causal, scale, s)
                 : launch_dkv<128>(fq, fk, fv, fd, fl, fdl, odk, odv, planes,
                                   B, Sq, Sk, Hq, Hkv, st, causal, scale, s);
}
