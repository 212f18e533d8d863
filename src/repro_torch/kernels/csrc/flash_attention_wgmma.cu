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
#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int kBQ = 128;              // query rows per CTA: 2 warpgroups x 64
constexpr int kBK = 128;              // keys per tile
constexpr int kStages = 2;            // K/V ring depth
constexpr int kThreads = 384;         // producer warpgroup + 2 consumers
constexpr int kConsumerThreads = 256;
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
      for (int r = 0; r < 4; ++r)
        split_bf16x2(s[8 * kk + 2 * r], s[8 * kk + 2 * r + 1], ph[kk][r],
                     pl[kk][r]);

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
