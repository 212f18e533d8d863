// Flash attention backward for bf16 on Hopper (sm_90a): wgmma on bf16 tiles
// fed by TMA.
//
// Replaces the Pallas TPU kernels of src/repro/kernels/flash_attention.py
// flash_attention_bwd (line 281: _bwd_dq_kernel at :299 and _bwd_dkv_kernel
// at :324) for bf16 inputs with head dim 64 or 128;
// kernels/flash_attention.py:backward_route sends f32, and bf16 at other
// head dims, to the SIMT pair in flash_attention.cu. From the saved q, k,
// v, the cotangent dO, lse ([B, Hq, Sq] f32, natural log, as the forward
// writes it) and delta = rowsum(dO * O) ([B, Hq, Sq] f32, computed by the
// wrapper), with kv head h / G (G = Hq / Hkv), scale = D^-1/2 and, causal,
// q_off = Sk - Sq:
//   p  = exp(s * scale - lse), exactly 0 where masked (key >= Sk, query
//        >= Sq, or causal and key > row + q_off); read as exp2 after
//        multiplying s and lse by log2(e)
//   ds = p * (dO v^T - delta)
//   dq = ds k * scale
//   dk = ds^T q * scale,  dv = p^T dO     (summed over each kv head's
//                                          group of G q heads)
// all three written in f32, as the TPU kernel's outputs are (its dk and dv
// out_shape is f32, its dq sums in an f32 scratch); the wrapper casts them
// to the inputs' dtype, so a check can hold the f32 values before the cast.
//
// Two kernels, so that each gradient has one owner and no atomics are
// needed: every output element is written once, by one CTA, after sums in
// a fixed order, so the result is the same bit for bit from run to run.
// Both are 384-thread CTAs, one per SM: warpgroup 0 is the producer
// (setmaxnreg.dec to 24; one thread issues TMA loads into a two-stage
// mbarrier ring), warpgroups 1 and 2 are consumers (setmaxnreg.inc to
// 240). wgmma products:
//   * dq: one CTA per (128 query rows, q head, b), each consumer owning 64
//         rows; q tiles are issued longest causal row first, and the G q
//         heads of one kv head are adjacent in the grid, so they read the
//         same K/V tiles from L2. Q and dO are loaded once; K and V tiles
//         of 128 keys stream up to the diagonal. Per key tile:
//           S  = Q K^T, dP = dO V^T      SS, m64n128k16, D/16 steps each
//           p, ds in registers (the accumulators' layout)
//           dQ_tile = dS_hi K + dS_lo K  RS, m64nDk16, K read MN-major
//   * dk/dv: one CTA per (64 keys, kv head, b); key tiles are issued
//         first-key first (the most causal rows first). K and V are loaded
//         once; the Q and dO tiles of 128 rows of each of the G q heads,
//         from the one that holds the diagonal on, stream through the
//         ring, which folds the group sum into the block. Both consumers
//         own the block's 64 keys and compute the transposed products
//         directly, so nothing is transposed in shared memory
//         (FlashAttention-3's arrangement); warpgroup 1 accumulates dV,
//         warpgroup 2 dK:
//           S^T = K Q^T                  SS, m64n128k16 (both)
//           dP^T = V dO^T                SS (the dK consumer)
//           dV_tile = P^T_hi dO + P^T_lo dO    RS, m64nDk16, dO MN-major
//           dK_tile = dS^T_hi Q + dS^T_lo Q    RS, Q MN-major
//         lse and delta of each streamed tile are staged by each consumer
//         itself: a thread loads one value after issuing the S^T (and
//         dP^T) products, so the load overlaps them, into a double-
//         buffered shared array, and the warpgroup meets at a named
//         barrier before reading it.
//
// Precision. The TPU kernel multiplies the f32 p and ds by f32 operands. A
// bf16 p or ds would compute another function: ds has a row sum of
// exactly 0 (sum_j p (dp - delta) = delta - delta), so dq = ds k cancels
// heavily (tests/test_torch_flash.py models a bf16 p and ds, and the
// limits below catch it). So p and ds go in as hi + lo bf16 pairs (two
// wgmmas into one f32 accumulator); q k^T and dO v^T take exact bf16
// inputs. Second, the sums are f32 adds: each tile's products go into a
// fresh accumulator (scale-d 0 on its first wgmma), which is added to the
// running f32 sum with an FADD, so the tensor cores sum one tile's 16
// k-steps at most, and the long sums over tiles (thousands of them for dK
// and dV) are FADDs, as in the SIMT pair. The running sum and the tile's
// both in registers do not fit one warpgroup holding dK and dV (4 x 64 f32
// a thread at D=128), hence the dk/dv consumers' split by gradient, at the
// cost of computing S^T twice. The gradients are written in f32 and held,
// before the wrapper's cast, within 1e-4 of each plain f32 gradient's
// largest magnitude (chip_smoke.py, tests/test_torch_gpu.py).
//
// Masking and ragged edges: TMA zero-fills rows past Sq and Sk, so every
// score is finite; keys past Sk (dq) and queries past Sq (dk/dv) are
// masked to p = 0 before any product, as are the causal positions; rows a
// CTA owns past Sq or Sk are computed on zeros and not written.
//
// What bounds it on the H100: operations. At the LM training shape (B=2,
// S=4,096, Hq=40, Hkv=8, D=128, causal) there are 671,252,480 visible
// (query, key) pairs; the function's five products are 10 * D FLOP a pair,
// 8.59e11 FLOP, 0.869 ms at the bf16 tensor-core peak of 989 TFLOP/s,
// against 0.12 ms for its ~0.40 GB. This design runs eleven products a
// pair (S and dP in dq, S^T twice and dP^T in dk/dv, and each product with
// p or ds twice for hi and lo): 22 * D FLOP a pair, so its own floor is
// 1.91 ms, plus the masked halves of the diagonal tiles.
//
// Registers at D=128, per consumer thread: the running sum (64 f32), and
// either S and dP (64 each, while p and ds are made) or the tile's hi/lo
// fragments (64) and its fresh accumulator (64), within the 240 that
// setmaxnreg gives; `ptxas -v` reports the spills.
#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int kThreads = 384;          // producer warpgroup + 2 consumers
constexpr int kConsumerThreads = 256;
constexpr int kStages = 2;             // ring depth of streamed tiles
constexpr int kRows = 128;             // query rows a dq CTA owns
constexpr int kKeysDq = 128;           // keys a dq CTA streams per tile
constexpr int kKeysDkv = 64;           // keys a dk/dv CTA owns
constexpr int kRowsDkv = 128;          // query rows a dk/dv CTA streams
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

template <int D>
struct SmemDq {
  // column block c of a tile: rows x 64 bf16, 128-byte swizzled
  __nv_bfloat16 q[D / 64][kRows * 64];
  __nv_bfloat16 dout[D / 64][kRows * 64];
  __nv_bfloat16 k[kStages][D / 64][kKeysDq * 64];
  __nv_bfloat16 v[kStages][D / 64][kKeysDq * 64];
  uint64_t qd_full;
  uint64_t full[kStages];
  uint64_t empty[kStages];
};

template <int D>
struct SmemDkv {
  __nv_bfloat16 k[D / 64][kKeysDkv * 64];
  __nv_bfloat16 v[D / 64][kKeysDkv * 64];
  __nv_bfloat16 q[kStages][D / 64][kRowsDkv * 64];
  __nv_bfloat16 dout[kStages][D / 64][kRowsDkv * 64];
  // per consumer warpgroup, double-buffered: lse * log2(e), then delta
  float stats[2][2][2][kRowsDkv];
  uint64_t kv_full;
  uint64_t full[kStages];
  uint64_t empty[kStages];
};

__device__ __forceinline__ void warpgroup_sync(int id) {
  asm volatile("bar.sync %0, 128;" ::"r"(id) : "memory");
}

template <typename Smem>
__device__ __forceinline__ Smem& aligned_smem(uint8_t* raw_smem) {
  const uint32_t raw = smem_u32(raw_smem);
  return *reinterpret_cast<Smem*>(raw_smem + (((raw + 1023) & ~1023u) - raw));
}

__device__ __forceinline__ void init_ring(uint64_t* once, uint64_t* full,
                                          uint64_t* empty) {
  if (threadIdx.x == 0) {
    mbar_init(once, 1);
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumerThreads);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
}

// p (into s) and ds (into dp) for one accumulator element:
// p = exp2(s * scale_log2 - lse2), ds = p (dp - delta)
__device__ __forceinline__ void p_and_ds(float& s, float& dp, float lse2,
                                         float delta, float scale_log2) {
  const float p = ex2(fmaf(s, scale_log2, -lse2));
  s = p;
  dp = p * (dp - delta);
}

// an m64nN accumulator x as the hi + lo bf16 A fragments of its N / 16 k
// steps: step kk's four registers are x's elements 8 kk .. 8 kk + 7, in
// pairs (the accumulator's layout is the A fragment's)
template <int K>
__device__ __forceinline__ void split_frags(const float (&x)[8 * K],
                                            uint32_t (&hi)[K][4],
                                            uint32_t (&lo)[K][4]) {
#pragma unroll
  for (int kk = 0; kk < K; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      split_bf16x2(x[8 * kk + 2 * r], x[8 * kk + 2 * r + 1], hi[kk][r],
                   lo[kk][r]);
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                          const __grid_constant__ CUtensorMap tm_k,
                          const __grid_constant__ CUtensorMap tm_v,
                          const __grid_constant__ CUtensorMap tm_do,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta,
                          float* __restrict__ dq, int Sq, int Sk,
                          int Hq, int Hkv, long long osb, long long oss,
                          long long osh, int causal, float scale,
                          float scale_log2) {
  constexpr int NB = D / 64;                  // 64-wide column blocks
  constexpr int BK = kKeysDq;
  constexpr uint32_t kRowBlock = kRows * kRowBytes;
  constexpr uint32_t kKeyBlock = BK * kRowBytes;
  extern __shared__ uint8_t smem_raw[];
  SmemDq<D>& sm = aligned_smem<SmemDq<D>>(smem_raw);

  const int h = blockIdx.x, b = blockIdx.z;
  const int q0 = ((int)gridDim.y - 1 - (int)blockIdx.y) * kRows;
  const int hk = h / (Hq / Hkv);
  const int q_off = Sk - Sq;
  // keys past the block's last row are masked for every row: stop there
  const int k_end = causal ? min(Sk, q0 + kRows + q_off) : Sk;
  const int n_kt = (k_end + BK - 1) / BK;
  const int wg = threadIdx.x / 128;
  init_ring(&sm.qd_full, sm.full, sm.empty);

  if (wg == 0) {
    // ------------------------------------------------------- producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 0) {
      mbar_expect_tx(&sm.qd_full, 2 * kRows * D * 2);
#pragma unroll
      for (int c = 0; c < NB; ++c) {
        tma_load(sm.q[c], &tm_q, &sm.qd_full, 64 * c, q0, h, b);
        tma_load(sm.dout[c], &tm_do, &sm.qd_full, 64 * c, q0, h, b);
      }
      for (int it = 0; it < n_kt; ++it) {
        const int st = it % kStages;
        mbar_wait(&sm.empty[st], ((it / kStages) & 1) ^ 1);
        mbar_expect_tx(&sm.full[st], 2 * BK * D * 2);
#pragma unroll
        for (int c = 0; c < NB; ++c) {
          tma_load(sm.k[st][c], &tm_k, &sm.full[st], 64 * c, it * BK, hk, b);
          tma_load(sm.v[st][c], &tm_v, &sm.full[st], 64 * c, it * BK, hk, b);
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
  const long long stat0 = ((long long)b * Hq + h) * Sq;
  // rows past Sq: zero q and dO, so p = 1 and ds = 0; never written
  float lse2[2], dlt[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    lse2[r] = row < Sq ? lse[stat0 + row] * kLog2e : 0.f;
    dlt[r] = row < Sq ? delta[stat0 + row] : 0.f;
  }

  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;

  const uint32_t q_base = smem_u32(sm.q[0]) + 64 * cw * kRowBytes;
  const uint32_t do_base = smem_u32(sm.dout[0]) + 64 * cw * kRowBytes;
  mbar_wait(&sm.qd_full, 0);

  for (int it = 0; it < n_kt; ++it) {
    const int st = it % kStages;
    const int k0 = it * BK;
    mbar_wait(&sm.full[st], (it / kStages) & 1);
    if (causal && k0 > wg_first + 63) {       // above this warpgroup's rows
      mbar_arrive(&sm.empty[st]);
      continue;
    }
    const uint32_t k_base = smem_u32(sm.k[st][0]);
    const uint32_t v_base = smem_u32(sm.v[st][0]);

    // S = Q K^T and dP = dO V^T over D in steps of 16 (32 bytes within a
    // swizzled row), into fresh accumulators: scores, products and tile
    // sums live for one tile only
    float s[BK / 2], dp[BK / 2], tile[D / 2];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t off = (kk / 4) * kRowBlock + (kk % 4) * 32;
      const uint32_t koff = (kk / 4) * kKeyBlock + (kk % 4) * 32;
      wgmma_ss<BK>(s, sw128_desc(q_base + off, 16, 1024),
                   sw128_desc(k_base + koff, 16, 1024), kk > 0);
    }
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t off = (kk / 4) * kRowBlock + (kk % 4) * 32;
      const uint32_t koff = (kk / 4) * kKeyBlock + (kk % 4) * 32;
      wgmma_ss<BK>(dp, sw128_desc(do_base + off, 16, 1024),
                   sw128_desc(v_base + koff, 16, 1024), kk > 0);
    }
    wgmma_commit();
    wgmma_wait_all();
    hold_regs(s);
    hold_regs(dp);

    // mask (p = 0) only tiles that reach past Sk or across the
    // warpgroup's diagonal
    if (k0 + BK > Sk || (causal && k0 + BK - 1 > wg_first)) {
#pragma unroll
      for (int j = 0; j < BK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = k0 + 8 * j + 2 * tig + (e & 1);
          if (col >= Sk || (causal && col > pos0 + 8 * (e >> 1)))
            s[4 * j + e] = kNegInf;
        }
    }
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        p_and_ds(s[4 * j + e], dp[4 * j + e], lse2[e >> 1], dlt[e >> 1],
                 scale_log2);

    // ds as hi + lo bf16 A fragments
    uint32_t dh[BK / 16][4], dl[BK / 16][4];
    split_frags(dp, dh, dl);

    // this tile's dQ = dS_hi K + dS_lo K over its keys in steps of 16,
    // into a fresh accumulator, then added to the running one
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint64_t kd = sw128_desc(k_base + kk * 16 * kRowBytes, kKeyBlock,
                                     1024);
      wgmma_rs<D>(tile, dh[kk], kd, kk > 0);
      wgmma_rs<D>(tile, dl[kk], kd);
    }
    wgmma_commit();
    wgmma_wait_all();
    hold_regs(tile);
    hold_regs(dh);
    hold_regs(dl);
    mbar_arrive(&sm.empty[st]);
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] += tile[i];
  }

  // epilogue: rows at or past Sq are not written
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row >= Sq) continue;
    float* d_r = dq + b * osb + (long long)row * oss + h * osh;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<float2*>(d_r + 8 * j + 2 * tig) =
          make_float2(acc[4 * j + 2 * r] * scale,
                      acc[4 * j + 2 * r + 1] * scale);
  }
}

// what a dk/dv consumer needs to walk the block's streamed tiles
struct DkvTiles {
  int b, hk, k0, G, n_qt, q_first, Sq, Sk, Hq, q_off, causal;
  float scale_log2;
};

// one dk/dv consumer warpgroup: DK accumulates dK = sum dS^T Q (and needs
// dP^T and delta), else dV = sum P^T dO; both own the block's 64 keys and
// write their gradient times out_scale
template <int D, bool DK>
__device__ __forceinline__ void dkv_consumer(
    SmemDkv<D>& sm, const DkvTiles& a, const float* __restrict__ lse,
    const float* __restrict__ delta, float* __restrict__ out,
    long long osb, long long oss, long long osh, float out_scale) {
  constexpr int BQ = kRowsDkv;
  constexpr uint32_t kKeyBlock = kKeysDkv * kRowBytes;
  constexpr uint32_t kQBlock = BQ * kRowBytes;
  constexpr int wg = DK ? 2 : 1;
  const int t = threadIdx.x - 128 * wg;
  const int warp = t / 32, lane = t % 32, g = lane / 4, tig = lane % 4;
  // accumulator rows are keys, columns are the streamed tile's queries
  const int key0 = a.k0 + 16 * warp + g;
  const uint32_t k_base = smem_u32(sm.k[0]);
  const uint32_t v_base = smem_u32(sm.v[0]);

  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;

  const int n_it = a.G * a.n_qt;
  for (int it = 0; it < n_it; ++it) {
    const int st = it % kStages;
    const int h = a.hk * a.G + it / a.n_qt;
    const int q0 = a.q_first + (it % a.n_qt) * BQ;
    mbar_wait(&sm.full[st], (it / kStages) & 1);
    const uint32_t q_base = smem_u32(sm.q[st][0]);
    const uint32_t do_base = smem_u32(sm.dout[st][0]);

    // S^T = K Q^T (and dP^T = V dO^T) over D in steps of 16, into fresh
    // accumulators
    float s[BQ / 2], dp[DK ? BQ / 2 : 1], tile[D / 2];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t off = (kk / 4) * kKeyBlock + (kk % 4) * 32;
      const uint32_t qoff = (kk / 4) * kQBlock + (kk % 4) * 32;
      wgmma_ss<BQ>(s, sw128_desc(k_base + off, 16, 1024),
                   sw128_desc(q_base + qoff, 16, 1024), kk > 0);
    }
    if constexpr (DK) {
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t off = (kk / 4) * kKeyBlock + (kk % 4) * 32;
        const uint32_t qoff = (kk / 4) * kQBlock + (kk % 4) * 32;
        wgmma_ss<BQ>(dp, sw128_desc(v_base + off, 16, 1024),
                     sw128_desc(do_base + qoff, 16, 1024), kk > 0);
      }
    }
    wgmma_commit();

    // while the products run: this tile's lse (in log2 units) and, for
    // dK, delta into this warpgroup's buffer (rows past Sq as 0: masked)
    float* stats = sm.stats[wg - 1][it & 1][0];
    {
      const int row = q0 + t;
      const long long at = ((long long)a.b * a.Hq + h) * a.Sq + row;
      stats[t] = row < a.Sq ? lse[at] * kLog2e : 0.f;
      if constexpr (DK) stats[BQ + t] = row < a.Sq ? delta[at] : 0.f;
    }
    wgmma_wait_all();
    hold_regs(s);
    if constexpr (DK) hold_regs(dp);
    warpgroup_sync(wg);

    // mask (p = 0): queries past Sq, and causal keys past a row's position
    if (q0 + BQ > a.Sq || (a.causal && a.k0 + 63 > q0 + a.q_off)) {
#pragma unroll
      for (int j = 0; j < BQ / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = q0 + 8 * j + 2 * tig + (e & 1);
          if (col >= a.Sq ||
              (a.causal && key0 + 8 * (e >> 1) > col + a.q_off))
            s[4 * j + e] = kNegInf;
        }
    }

    // p^T (dV) or ds^T (dK), then as hi + lo bf16 A fragments
    uint32_t fh[BQ / 16][4], fl[BQ / 16][4];
#pragma unroll
    for (int j = 0; j < BQ / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = 8 * j + 2 * tig + (e & 1);
        if constexpr (DK)
          p_and_ds(s[4 * j + e], dp[4 * j + e], stats[c], stats[BQ + c],
                   a.scale_log2);
        else
          s[4 * j + e] = ex2(fmaf(s[4 * j + e], a.scale_log2, -stats[c]));
      }
    if constexpr (DK)
      split_frags(dp, fh, fl);
    else
      split_frags(s, fh, fl);

    // this tile's dV = P^T_hi dO + P^T_lo dO or dK = dS^T_hi Q + dS^T_lo Q
    // over its queries in steps of 16, into a fresh accumulator, then
    // added to the running one
    const uint32_t b_base = DK ? q_base : do_base;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk) {
      const uint64_t bd = sw128_desc(b_base + kk * 16 * kRowBytes, kQBlock,
                                     1024);
      wgmma_rs<D>(tile, fh[kk], bd, kk > 0);
      wgmma_rs<D>(tile, fl[kk], bd);
    }
    wgmma_commit();
    wgmma_wait_all();
    hold_regs(tile);
    hold_regs(fh);
    hold_regs(fl);
    mbar_arrive(&sm.empty[st]);
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] += tile[i];
  }

  // epilogue: keys at or past Sk are not written
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = key0 + 8 * r;
    if (key >= a.Sk) continue;
    float* o_r = out + a.b * osb + (long long)key * oss + a.hk * osh;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<float2*>(o_r + 8 * j + 2 * tig) =
          make_float2(acc[4 * j + 2 * r] * out_scale,
                      acc[4 * j + 2 * r + 1] * out_scale);
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dkv_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                           const __grid_constant__ CUtensorMap tm_k,
                           const __grid_constant__ CUtensorMap tm_v,
                           const __grid_constant__ CUtensorMap tm_do,
                           const float* __restrict__ lse,
                           const float* __restrict__ delta,
                           float* __restrict__ dk,
                           float* __restrict__ dv, int Sq, int Sk,
                           int Hq, int Hkv, long long ksb, long long kss,
                           long long ksh, long long vsb, long long vss,
                           long long vsh, int causal, float scale,
                           float scale_log2) {
  constexpr int NB = D / 64;
  constexpr int BQ = kRowsDkv;
  extern __shared__ uint8_t smem_raw[];
  SmemDkv<D>& sm = aligned_smem<SmemDkv<D>>(smem_raw);

  const int hk = blockIdx.x, b = blockIdx.z;
  const int k0 = blockIdx.y * kKeysDkv;      // first key tiles issued first
  const int G = Hq / Hkv;
  const int q_off = Sk - Sq;
  // rows before the first that sees key k0 (row + q_off >= k0) see none of
  // this block's keys: start at the q tile that holds it, which therefore
  // always holds a visible pair
  const int q_first = causal ? max(0, k0 - q_off) / BQ * BQ : 0;
  const int n_qt = (Sq - q_first + BQ - 1) / BQ;   // per q head
  const int n_it = G * n_qt;
  const int wg = threadIdx.x / 128;
  init_ring(&sm.kv_full, sm.full, sm.empty);

  if (wg == 0) {
    // ------------------------------------------------------- producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 0) {
      mbar_expect_tx(&sm.kv_full, 2 * kKeysDkv * D * 2);
#pragma unroll
      for (int c = 0; c < NB; ++c) {
        tma_load(sm.k[c], &tm_k, &sm.kv_full, 64 * c, k0, hk, b);
        tma_load(sm.v[c], &tm_v, &sm.kv_full, 64 * c, k0, hk, b);
      }
      for (int it = 0; it < n_it; ++it) {
        const int st = it % kStages;
        const int h = hk * G + it / n_qt;
        const int q0 = q_first + (it % n_qt) * BQ;
        mbar_wait(&sm.empty[st], ((it / kStages) & 1) ^ 1);
        mbar_expect_tx(&sm.full[st], 2 * BQ * D * 2);
#pragma unroll
        for (int c = 0; c < NB; ++c) {
          tma_load(sm.q[st][c], &tm_q, &sm.full[st], 64 * c, q0, h, b);
          tma_load(sm.dout[st][c], &tm_do, &sm.full[st], 64 * c, q0, h, b);
        }
      }
    }
    return;
  }

  // --------------------------------------------------------- consumers
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
  // both own the block's 64 keys: warpgroup 1 accumulates dV, 2 dK
  mbar_wait(&sm.kv_full, 0);
  const DkvTiles tiles{b, hk, k0, G, n_qt, q_first, Sq, Sk, Hq, q_off,
                       causal, scale_log2};
  if (wg == 1)
    dkv_consumer<D, false>(sm, tiles, lse, delta, dv, vsb, vss, vsh, 1.f);
  else
    dkv_consumer<D, true>(sm, tiles, lse, delta, dk, ksb, kss, ksh, scale);
}

// the four TMA maps (q, k, v, dO), each in boxes of 64 columns by the rows
// its kernel streams or owns
struct Maps {
  CUtensorMap q, k, v, dout;
};

bool make_maps(Maps* m, const void* q, const void* k, const void* v,
               const void* dout, int B, int Sq, int Sk, int Hq, int Hkv, int D,
               const long long* st, int q_rows, int kv_rows) {
  return make_map(&m->q, q, B, Sq, Hq, D, st[0], st[1], st[2], q_rows) &&
         make_map(&m->k, k, B, Sk, Hkv, D, st[3], st[4], st[5], kv_rows) &&
         make_map(&m->v, v, B, Sk, Hkv, D, st[6], st[7], st[8], kv_rows) &&
         make_map(&m->dout, dout, B, Sq, Hq, D, st[9], st[10], st[11], q_rows);
}

template <typename Kernel>
int allow_smem(Kernel kernel, int smem) {
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
}

template <int D>
int launch_dq(const void* q, const void* k, const void* v, const void* dout,
              const float* lse, const float* delta, void* dq, int B, int Sq,
              int Sk, int Hq, int Hkv, const long long* st, int causal,
              float scale, cudaStream_t stream) {
  Maps m;
  if (!make_maps(&m, q, k, v, dout, B, Sq, Sk, Hq, Hkv, D, st, kRows,
                 kKeysDq))
    return (int)cudaErrorInvalidValue;
  const int smem = (int)sizeof(SmemDq<D>) + 1024;
  const int err = allow_smem(flash_bwd_dq_wgmma_kernel<D>, smem);
  if (err) return err;
  const dim3 grid(Hq, (Sq + kRows - 1) / kRows, B);
  flash_bwd_dq_wgmma_kernel<D><<<grid, kThreads, smem, stream>>>(
      m.q, m.k, m.v, m.dout, lse, delta, static_cast<float*>(dq), Sq,
      Sk, Hq, Hkv, st[12], st[13], st[14], causal, scale, scale * kLog2e);
  return (int)cudaGetLastError();
}

template <int D>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout,
               const float* lse, const float* delta, void* dk, void* dv,
               int B, int Sq, int Sk, int Hq, int Hkv, const long long* st,
               int causal, float scale, cudaStream_t stream) {
  Maps m;
  if (!make_maps(&m, q, k, v, dout, B, Sq, Sk, Hq, Hkv, D, st, kRowsDkv,
                 kKeysDkv))
    return (int)cudaErrorInvalidValue;
  const int smem = (int)sizeof(SmemDkv<D>) + 1024;
  const int err = allow_smem(flash_bwd_dkv_wgmma_kernel<D>, smem);
  if (err) return err;
  const dim3 grid(Hkv, (Sk + kKeysDkv - 1) / kKeysDkv, B);
  flash_bwd_dkv_wgmma_kernel<D><<<grid, kThreads, smem, stream>>>(
      m.q, m.k, m.v, m.dout, lse, delta, static_cast<float*>(dk),
      static_cast<float*>(dv), Sq, Sk, Hq, Hkv, st[12], st[13],
      st[14], st[15], st[16], st[17], causal, scale, scale * kLog2e);
  return (int)cudaGetLastError();
}

// what both entry points require: shapes, grid limits, TMA-readable q, k,
// v and dO (16-byte-aligned bases, strides that are multiples of 8
// elements)
bool args_ok(const void* q, const void* k, const void* v, const void* dout,
             int B, int Sq, int Sk, int Hq, int Hkv, int D,
             const long long* st, int causal) {
  return B > 0 && Sq > 0 && Sk > 0 && Hkv > 0 && Hq % Hkv == 0 &&
         B <= 65535 && Hq <= 65535 && (Sq + kRows - 1) / kRows <= 65535 &&
         (Sk + kKeysDkv - 1) / kKeysDkv <= 65535 && !(causal && Sq > Sk) &&
         (D == 64 || D == 128) && tma_ok(q, st[0], st[1], st[2]) &&
         tma_ok(k, st[3], st[4], st[5]) && tma_ok(v, st[6], st[7], st[8]) &&
         tma_ok(dout, st[9], st[10], st[11]);
}

// an f32 output written as float2 pairs: an 8-byte-aligned base and even
// strides
bool out_ok(const void* out, const long long* st) {
  return reinterpret_cast<uintptr_t>(out) % 8 == 0 && st[0] % 2 == 0 &&
         st[1] % 2 == 0 && st[2] % 2 == 0;
}

}  // namespace

// The backward's two Hopper kernels. q/dO: [B, Sq, Hq, D] and k/v:
// [B, Sk, Hkv, D] bf16, dq/dk/dv the same shapes in f32, each with element
// strides (batch, sequence, head) and a contiguous D axis; D is 64 or 128.
// q, k, v and dO are read by TMA: 16-byte-aligned bases and strides that
// are multiples of 8 elements (a dim of size 1 may be given any such
// stride); dq, dk and dv need 8-byte-aligned bases and even strides. lse and
// delta = rowsum(dO * O): [B, Hq, Sq] f32, contiguous. dq is written by
// flash_attention_bwd_dq_wgmma, dk and dv (summed over each kv head's
// group of q heads) by flash_attention_bwd_dkv_wgmma. causal != 0
// requires Sq <= Sk. Each returns the cudaError_t of its launch (0 on
// success).
extern "C" int flash_attention_bwd_dq_wgmma(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dq, int B, int Sq, int Sk,
    int Hq, int Hkv, int D, long long qsb, long long qss, long long qsh,
    long long ksb, long long kss, long long ksh, long long vsb,
    long long vss, long long vsh, long long dsb, long long dss,
    long long dsh, long long dqsb, long long dqss, long long dqsh,
    int causal, float scale, void* stream) {
  const long long st[15] = {qsb, qss, qsh, ksb, kss, ksh, vsb, vss,
                            vsh, dsb, dss, dsh, dqsb, dqss, dqsh};
  if (!args_ok(q, k, v, dout, B, Sq, Sk, Hq, Hkv, D, st, causal) ||
      !out_ok(dq, st + 12))
    return (int)cudaErrorInvalidValue;
  const float* l = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return D == 64 ? launch_dq<64>(q, k, v, dout, l, dl, dq, B, Sq, Sk, Hq, Hkv,
                                 st, causal, scale, s)
                 : launch_dq<128>(q, k, v, dout, l, dl, dq, B, Sq, Sk, Hq,
                                  Hkv, st, causal, scale, s);
}

extern "C" int flash_attention_bwd_dkv_wgmma(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dk, void* dv, int B, int Sq,
    int Sk, int Hq, int Hkv, int D, long long qsb, long long qss,
    long long qsh, long long ksb, long long kss, long long ksh,
    long long vsb, long long vss, long long vsh, long long dsb,
    long long dss, long long dsh, long long dksb, long long dkss,
    long long dksh, long long dvsb, long long dvss, long long dvsh,
    int causal, float scale, void* stream) {
  const long long st[18] = {qsb, qss, qsh, ksb,  kss,  ksh,
                            vsb, vss, vsh, dsb,  dss,  dsh,
                            dksb, dkss, dksh, dvsb, dvss, dvsh};
  if (!args_ok(q, k, v, dout, B, Sq, Sk, Hq, Hkv, D, st, causal) ||
      !out_ok(dk, st + 12) || !out_ok(dv, st + 15))
    return (int)cudaErrorInvalidValue;
  const float* l = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return D == 64 ? launch_dkv<64>(q, k, v, dout, l, dl, dk, dv, B, Sq, Sk, Hq,
                                  Hkv, st, causal, scale, s)
                 : launch_dkv<128>(q, k, v, dout, l, dl, dk, dv, B, Sq, Sk,
                                   Hq, Hkv, st, causal, scale, s);
}
