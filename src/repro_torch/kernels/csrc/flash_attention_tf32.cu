// Flash attention forward in f32 (causal or not, GQA) for Hopper (sm_90a),
// on the tensor cores in 3xTF32 with wgmma.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py
// (flash_attention_fwd / _fwd_kernel) for f32 inputs at head dim 64 or 128
// (kernels/flash_attention.py:forward_route; the SIMT kernel in
// flash_attention.cu keeps f32 at the other head dims). The function is
// the SIMT kernel's: for every (batch b, q-head h, query row i), with kv
// head h / G (G = Hq / Hkv) and scale = D^-1/2,
//   s[i, j] = <q[i], k[j]> * scale, or -1e30 where j >= Sk or, causal,
//             j > i + q_off (q_off = Sk - Sq)
//   online softmax over the key tiles in f32 (m, l, acc rescaled by
//   exp(m_old - m_new) at each tile)
//   o[i]   = acc / max(l, 1e-30),  lse[i] = m + log(max(l, 1e-30))
// q/o [B, Sq, Hq, D] and k/v [B, Sk, Hkv, D] are read and written through
// element strides for b, s and h (D contiguous).
//
// What bounds it on the H100: operations. At B=1, S=4,096, 40/8 heads of
// 128, causal, a call does 1.718e11 FLOP (4 D a visible (query, key)
// pair) against ~88 MB of q/k/v/o/lse: 2.56 ms at the 67 TFLOP/s f32 rate
// of the CUDA cores (where the SIMT kernel runs, 8.08 ms), 0.35 ms at the
// 495 TFLOP/s TF32 tensor-core rate for one product a pair, and 1.04 ms
// for the three products 3xTF32 takes: this design's floor.
//
// Design:
// * Products on the tensor cores in 3xTF32 (tf32_mma.cuh): every f32
//   operand split into hi = tf32(x) (cvt.rna) and lo = x - hi (read as
//   tf32, its low 13 bits dropped), a product hi*lo + lo*hi + hi*hi into
//   one f32 accumulator. One product in tf32 alone puts o ~1e-3 off,
//   five times the f32 tolerance (2e-4; the CPU model's control in
//   tests/test_torch_flash_tf32.py); three keep it near 1e-5.
// * The products are wgmma (tf32 operands are K-major only): S = Q K^T as
//   m64n32k8 steps along D, O += P V as m64nDk8 steps along the keys, one
//   warpgroup per 64 query rows, two warpgroups a CTA (128 rows of one q
//   head; the G q heads of a kv head are adjacent in the grid, so they
//   read the same key tiles from L2, and q tiles start longest causal row
//   first). A first design with mma.sync m16n8k8 (8 warps, q's hi and lo
//   in registers, each key tile split by the CTA into shared-memory
//   planes) took 4.3 ms at the shape above: its 255 registers spilled,
//   8 warps an SM left the mma chains' latency bare, and each 8-wide step
//   read its B fragments with its own shared-memory loads.
// * K and V are split once, for all q tiles, by a first kernel
//   (split_kv_kernel) into a scratch buffer the wrapper allocates: per
//   (b, kv head, tile of 32 keys) four 128-byte-swizzled planes, K hi and
//   lo as [key][D] (wgmma's B of Q K^T), V hi and lo transposed as
//   [D][key] (B of P V), keys ordered in each 8-key step as P's register
//   fragment holds them (slot t is key 2t, slot t + 4 key 2t + 1). Keys
//   past Sk are zero. At the shape above the first kernel moves ~100 MB
//   (30 us at 3.35 TB/s, under 2% of the call); splitting in the CTA
//   instead would split each key tile once for every q tile that reads
//   it (32 times at S=4,096).
// * The main kernel streams each tile's 64 KB of planes (D=128) into a
//   ring of 2 stages with 1-D bulk copies (cp.async.bulk) on an mbarrier,
//   issued by one thread once every thread has released the stage.
//   q is read once: hi split into registers (wgmma's A from registers),
//   lo into a swizzled shared-memory plane (A from shared memory for the
//   lo*hi product), which keeps a thread under 200 registers: q's hi and
//   lo both in registers (128 at D=128), O (64), the scores (16) and p's
//   hi and lo (32) would need more than the 255 a thread has.
// * p is taken from the score accumulators as the A fragments of P V
//   (element 4j + e of an m64nN accumulator sits at row 16 warp + g +
//   8 (e / 2), column 8j + 2t + (e % 2)), split into hi and lo registers.
// * The softmax runs in log2 units (ex2) on the accumulators; the mask is
//   applied only to tiles that cross Sk or a warpgroup's diagonal, and a
//   warpgroup skips the products of causal tiles wholly above its rows.
// * Shared memory at D=128: q lo 2 x 32 KB + 2 stages x 64 KB = 192 KB +
//   1 KB of alignment, one CTA an SM; at D=64 half of that.
//
// Measured on an H100 (700 W; PERF.md): 1.79 ms at the shape above, both
// kernels (the SIMT kernel 8.1 ms and SDPA's f32 forward 4.0 ms in the
// same run), 58% of the 3xTF32 floor; errors 7.5e-6 on o, 3.1e-6 on lse.
#include "hopper.cuh"
#include "tf32_mma.cuh"

namespace {

using namespace hopper;
using tf32x3::split;

constexpr int kBQ = 128;              // query rows a CTA: 2 warpgroups x 64
constexpr int kBK = 32;               // keys a tile
constexpr int kStages = 2;
constexpr int kThreads = 256;
constexpr float kNegInf = -1e30f;
constexpr float kLn2 = 0.69314718055994531f;

// One tile's planes: K hi, K lo ([D/32 column blocks][kBK rows][128 B]),
// V hi, V lo ([D rows][128 B]: 32 key slots), each kBK * D * 4 bytes.
template <int D>
struct Tile {
  static constexpr int kPlane = kBK * D * 4;
  static constexpr int kBytes = 4 * kPlane;
  static constexpr int kKBlock = kBK * kRowBytes;   // a K column block
};

template <int D>
struct Smem {
  uint8_t qlo[2][D / 32][64 * kRowBytes];   // per warpgroup, swizzled
  uint8_t stage[kStages][Tile<D>::kBytes];
  uint64_t full[kStages];
  uint64_t empty[kStages];
};

// ------------------------------------------------------------ the split
// One CTA per (key tile, kv head, b): K and V rows [k0, k0 + kBK) into the
// tile's four planes (keys >= Sk as zero).
template <int D>
__global__ void __launch_bounds__(256)
split_kv_kernel(const float* __restrict__ k, const float* __restrict__ v,
                uint8_t* __restrict__ planes, int Sk, int Hkv, int n_kt,
                long long ksb, long long kss, long long ksh, long long vsb,
                long long vss, long long vsh) {
  using T = Tile<D>;
  const int kt = blockIdx.x, hk = blockIdx.y, b = blockIdx.z;
  uint8_t* tile =
      planes + (((long long)b * Hkv + hk) * n_kt + kt) * (long long)T::kBytes;
  const int k0 = kt * kBK;
  for (int e = threadIdx.x; e < 2 * kBK * D; e += 256) {
    const bool is_v = e >= kBK * D;
    const int r = is_v ? e - kBK * D : e;
    const int key = r / D, d = r - key * D;
    float x = 0.f;
    if (k0 + key < Sk)
      x = is_v ? v[b * vsb + (long long)(k0 + key) * vss + hk * vsh + d]
               : k[b * ksb + (long long)(k0 + key) * kss + hk * ksh + d];
    uint32_t hi, lo;
    split<false>(x, hi, lo);
    uint32_t off;
    if (!is_v) {
      off = (d >> 5) * T::kKBlock + swz(key, d & 31);
    } else {                 // slot of `key` in its 8-key step
      const int j = key & 7;
      const int slot = (key & ~7) + ((j & 1) ? 4 + (j >> 1) : (j >> 1));
      off = 2 * T::kPlane + swz(d, slot);
    }
    *reinterpret_cast<uint32_t*>(tile + off) = hi;
    *reinterpret_cast<uint32_t*>(tile + off + T::kPlane) = lo;
  }
}

// ------------------------------------------------------------- the main
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_tf32_kernel(const float* __restrict__ q,
                      const uint8_t* __restrict__ planes,
                      float* __restrict__ o, float* __restrict__ lse,
                      int Sq, int Sk, int Hq, int Hkv, int n_kt_all,
                      long long qsb, long long qss, long long qsh,
                      long long osb, long long oss, long long osh,
                      int causal, float scale_log2) {
  using T = Tile<D>;
  constexpr int NJ = D / 8;           // 8-wide steps along D
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  Smem<D>& sm = *reinterpret_cast<Smem<D>*>(smem_raw +
                                            (((raw + 1023) & ~1023u) - raw));

  const int h = blockIdx.x, b = blockIdx.z;
  const int q0 = ((int)gridDim.y - 1 - (int)blockIdx.y) * kBQ;
  const int hk = h / (Hq / Hkv);
  const int q_off = Sk - Sq;
  const int k_end = causal ? min(Sk, q0 + kBQ + q_off) : Sk;
  const int n_kt = (k_end + kBK - 1) / kBK;
  const uint8_t* tiles =
      planes + ((long long)b * Hkv + hk) * n_kt_all * (long long)T::kBytes;

  const int cw = threadIdx.x / 128;                 // warpgroup
  const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  const int g = lane / 4, tig = lane % 4;
  const int row0 = q0 + 64 * cw + 16 * warp + g;    // rows row0, row0 + 8
  const int pos0 = row0 + q_off;
  const int wg_first = q0 + 64 * cw + q_off;        // its first row's key

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&sm.full[s], 1);
      mbar_init(&sm.empty[s], kThreads);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0 && n_kt > 0) {
    mbar_expect_tx(&sm.full[0], T::kBytes);
    bulk_load(sm.stage[0], tiles, T::kBytes, &sm.full[0]);
  }

  // q: hi into registers (A fragments a0..a3: rows g, g + 8, g, g + 8 and
  // columns t, t, t + 4, t + 4 of each 8-wide step), lo into this
  // warpgroup's swizzled plane
  uint32_t qh[NJ][4];
  {
    const float* qb = q + b * qsb + h * qsh;
    uint8_t* lo_plane = sm.qlo[cw][0];
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = 16 * warp + g + 8 * (e & 1);
        const int col = 8 * j + tig + 4 * (e >> 1);
        const int row = q0 + 64 * cw + r;
        const float x = row < Sq ? __ldg(qb + (long long)row * qss + col)
                                 : 0.f;
        uint32_t lo;
        split<false>(x, qh[j][e], lo);
        *reinterpret_cast<uint32_t*>(lo_plane + (col >> 5) * 64 * kRowBytes +
                                     swz(r, col & 31)) = lo;
      }
  }
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  __syncthreads();

  float acc[D / 2], s[kBK / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < kBK / 2; ++i) s[i] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  const uint32_t qlo_base = smem_u32(sm.qlo[cw][0]);

  for (int it = 0; it < n_kt; ++it) {
    const int st = it % kStages, k0 = it * kBK;
    if (threadIdx.x == 0 && it + 1 < n_kt) {        // the next tile
      const int nx = (it + 1) % kStages;
      mbar_wait(&sm.empty[nx], (((it + 1) / kStages) & 1) ^ 1);
      mbar_expect_tx(&sm.full[nx], T::kBytes);
      bulk_load(sm.stage[nx], tiles + (long long)(it + 1) * T::kBytes,
                T::kBytes, &sm.full[nx]);
    }
    mbar_wait(&sm.full[st], (it / kStages) & 1);
    if (causal && k0 > wg_first + 63) {              // above its rows
      mbar_arrive(&sm.empty[st]);
      continue;
    }
    const uint32_t kh = smem_u32(sm.stage[st]);
    const uint32_t kl = kh + T::kPlane;
    const uint32_t vh = kh + 2 * T::kPlane;
    const uint32_t vl = kh + 3 * T::kPlane;

    // S = Qhi Klo + Qlo Khi + Qhi Khi in 8-wide steps along D (32 bytes
    // within a swizzled 128-byte row)
    hold_regs(s);
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const uint32_t off = (j / 4) * T::kKBlock + (j % 4) * 32;
      const uint32_t qoff = (j / 4) * 64 * kRowBytes + (j % 4) * 32;
      tf32_rs<kBK>(s, qh[j], sw128_desc(kl + off, 16, 1024), j > 0);
      tf32_ss<kBK>(s, sw128_desc(qlo_base + qoff, 16, 1024),
                   sw128_desc(kh + off, 16, 1024));
      tf32_rs<kBK>(s, qh[j], sw128_desc(kh + off, 16, 1024));
    }
    wgmma_commit();
    wgmma_wait_all();
    hold_regs(s);

    // scale to log2 units, then mask (the TPU kernel's order)
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
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int i = 0; i < kBK / 2; ++i)
      mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
    float corr[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      corr[r] = ex2(m[r] - mx[r]);
      m[r] = mx[r];
    }
#pragma unroll
    for (int i = 0; i < kBK / 2; ++i) {
      s[i] = ex2(s[i] - m[(i >> 1) & 1]);
      sum[(i >> 1) & 1] += s[i];
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * corr[r] + sum[r];  // partial
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] *= corr[(i >> 1) & 1];

    // p as hi and lo A fragments: key step kk is accumulator block kk,
    // a0..a3 = elements 0, 2, 1, 3 (slot t is key 2t, slot t + 4 key 2t+1)
    uint32_t ph[kBK / 8][4], pl[kBK / 8][4];
#pragma unroll
    for (int kk = 0; kk < kBK / 8; ++kk)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        split<false>(s[4 * kk + ((e & 1) << 1) + (e >> 1)], ph[kk][e],
                     pl[kk][e]);

    // O += Phi Vlo + Plo Vhi + Phi Vhi in 8-key steps (32 bytes)
    hold_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 8; ++kk) {
      const uint64_t dvl = sw128_desc(vl + kk * 32, 16, 1024);
      const uint64_t dvh = sw128_desc(vh + kk * 32, 16, 1024);
      tf32_rs<D>(acc, ph[kk], dvl);
      tf32_rs<D>(acc, pl[kk], dvh);
      tf32_rs<D>(acc, ph[kk], dvh);
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
    float* o_r = o + b * osb + (long long)row * oss + h * osh;
#pragma unroll
    for (int j = 0; j < NJ; ++j)
      *reinterpret_cast<float2*>(o_r + 8 * j + 2 * tig) =
          make_float2(acc[4 * j + 2 * r] / lc, acc[4 * j + 2 * r + 1] / lc);
    if (tig == 0)
      lse[((long long)b * Hq + h) * Sq + row] = m[r] * kLn2 + logf(lc);
  }
}

struct Args {
  const float *q, *k, *v;
  float *o, *lse;
  uint8_t* planes;
  int B, Sq, Sk, Hq, Hkv;
  long long qsb, qss, qsh, ksb, kss, ksh, vsb, vss, vsh, osb, oss, osh;
  int causal;
  float scale;
};

template <int D>
int launch(const Args& a, cudaStream_t stream) {
  const int n_kt = (a.Sk + kBK - 1) / kBK;
  split_kv_kernel<D><<<dim3(n_kt, a.Hkv, a.B), 256, 0, stream>>>(
      a.k, a.v, a.planes, a.Sk, a.Hkv, n_kt, a.ksb, a.kss, a.ksh, a.vsb,
      a.vss, a.vsh);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int smem = (int)sizeof(Smem<D>) + 1024;
  err = cudaFuncSetAttribute(flash_fwd_tf32_kernel<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(a.Hq, (a.Sq + kBQ - 1) / kBQ, a.B);
  flash_fwd_tf32_kernel<D><<<grid, kThreads, smem, stream>>>(
      a.q, a.planes, a.o, a.lse, a.Sq, a.Sk, a.Hq, a.Hkv, n_kt, a.qsb,
      a.qss, a.qsh, a.osb, a.oss, a.osh, a.causal,
      a.scale * 1.4426950408889634f);
  return (int)cudaGetLastError();
}

}  // namespace

// q, o: [B, Sq, Hq, D] and k, v: [B, Sk, Hkv, D], f32, each with element
// strides (batch, sequence, head) and a contiguous D axis; D is 64 or 128;
// o 8-byte aligned. lse: [B, Hq, Sq] f32, contiguous. planes: scratch of
// B * Hkv * ceil(Sk / 32) * 4 * 32 * D * 4 bytes, 16-byte aligned.
// Launches the split, then the main kernel; returns the cudaError_t of the
// launches (0 on success).
extern "C" int flash_attention_fwd_tf32(
    const void* q, const void* k, const void* v, void* o, void* lse,
    void* planes, long long planes_bytes, int B, int Sq, int Sk, int Hq,
    int Hkv, int D,
    long long qsb, long long qss, long long qsh, long long ksb,
    long long kss, long long ksh, long long vsb, long long vss,
    long long vsh, long long osb, long long oss, long long osh, int causal,
    float scale, void* stream) {
  if (B <= 0 || Sq <= 0 || Sk <= 0 || Hkv <= 0 || Hq % Hkv != 0 ||
      B > 65535 || Hkv > 65535 || (Sq + kBQ - 1) / kBQ > 65535 ||
      (causal && Sq > Sk))
    return (int)cudaErrorInvalidValue;
  if (planes_bytes !=
      (long long)B * Hkv * ((Sk + kBK - 1) / kBK) * 4 * kBK * D * 4)
    return (int)cudaErrorInvalidValue;
  if (reinterpret_cast<uintptr_t>(o) % 8 || osb % 2 || oss % 2 || osh % 2 ||
      reinterpret_cast<uintptr_t>(planes) % 16)
    return (int)cudaErrorMisalignedAddress;
  const Args a{static_cast<const float*>(q), static_cast<const float*>(k),
               static_cast<const float*>(v), static_cast<float*>(o),
               static_cast<float*>(lse), static_cast<uint8_t*>(planes), B,
               Sq, Sk, Hq, Hkv, qsb, qss, qsh, ksb, kss, ksh, vsb, vss, vsh,
               osb, oss, osh, causal, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64: return launch<64>(a, s);
    case 128: return launch<128>(a, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
