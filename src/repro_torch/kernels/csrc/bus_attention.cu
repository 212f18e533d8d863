// BusLM segment + bus attention, forward and backward, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels src/repro/kernels/bus_attention.py
// (bus_attention / _fwd_kernel and bus_attention_bwd / _bwd_kernel). For
// every (news m, segment kk, head h):
//   s[i, t] = <q[i], k[t]> * D^-1/2, or -1e30 where kv_mask[m, kk, t] is 0
//   p       = exp(s - rowmax(s)) / max(rowsum, 1e-30)        (f32)
//   o[i]    = sum_t p[i, t] * v[t]           (written in the input dtype)
// over Sk = S + K keys (the segment's S tokens plus the K bus proxies).
// A row whose keys are all masked averages v uniformly over exactly Sk
// keys, as the TPU kernel does.
//
// The backward recomputes p with the forward's exact arithmetic (no
// residual besides q/k/v is stored) and writes, in one pass per tile,
//   dv = p^T do,  dp = do v^T,  delta = rowsum(p * dp),
//   ds = (mask ? p * (dp - delta) : 0) * scale,  dq = ds k,  dk = ds^T q.
// Each tile owns its dk/dv rows (the bus columns are per-segment copies;
// their gradients reach the [CLS] rows through the caller's concat), so
// there are no atomics and two launches agree bit for bit. dv is nonzero
// on the masked keys of a fully masked segment (p is uniform there), as in
// the TPU kernel.
//
// Layouts (contiguous): q/o/do/dq [M, K, S, H, D]; k/v/dk/dv
// [M, K, Sk, H, D]; mask [M, K, Sk] bytes (torch.bool). Shapes taken:
// D in {16, 32, 64, 128}, S <= 32, Sk <= 40; q/k/v/do 16-byte aligned.
// kernels/bus_attention.py:bus_route sends every other shape to the SIMT
// kernels (bus_attention_simt.cu).
//
// What bounds them on the H100: memory, then instructions. At the serve
// shape (a chunk of M=256 news, K=3, S=32, Sk=35, H=12, D=64, f32) the
// forward must move ~316 MB of q/k/v/o (~94 us at 3.35 TB/s) against ~2.6
// GFLOP; the backward at M=4096 moves 8.9 GB (2.66 ms) against 106 GFLOP.
// The SIMT kernels (bus_attention_simt.cu, now the route for other
// shapes) run at 5-7x that byte bound: one block per tile loads it
// synchronously, then reads both operands of every FMA from shared
// memory. This design:
//
// * Products on the tensor cores, mma.sync m16n8k8 with tf32 operands and
//   f32 accumulators, in 3xTF32: an f32 operand x is split into hi =
//   tf32(x) (cvt.rna) and lo = x - hi, which the tensor core reads as tf32
//   by dropping its low 13 bits, and a product is hi*lo + lo*hi + hi*hi
//   into one accumulator, which keeps f32 accuracy (1xTF32 would put o
//   ~1e-3 off at these widths). bf16 and fp16 inputs are exact in tf32
//   (lo = 0), so only p and ds, computed in f32, are split there. wgmma
//   does not fit: its A tile is 64 rows and a tile has at most 32 queries
//   against keys of its own, so no two tiles share a B operand; m16n8k8
//   fits S in {8, 16, 24, 32} and Sk = S + 3.
// * One warp owns 16 query rows of a tile: S = Q K^T, the softmax (rows
//   reduced across the 4 lanes of a quad) and O = P V, with P taken from
//   the score accumulators as the A operand of the next product (the key
//   index of each 8-key step is permuted so that the accumulator's
//   columns 2t, 2t+1 are the A fragment's columns t, t+4, and V's rows are
//   read in the same order). The backward gives each 16 rows two warps,
//   one a half of the key tiles: S and dP, the softmax with the row max,
//   sum and delta combined across the pair through shared memory, p and
//   ds written as tf32 hi and lo planes (split once, read by every later
//   product); then dQ = dS K a half of D each, and dV^T = dO^T P and
//   dK^T = Q^T dS by 16 columns of D among the tile's warps.
// * The 8-key tiles (2 to 5) are a template argument: a product over a
//   runtime count of tiles put a branch between the accumulators' mma
//   groups, each group's three dependent mmas then ran back to back, and
//   the forward took 1.7x as long.
// * Padding: Sk is padded to a multiple of 8 (35 -> 40) and S to a
//   multiple of 16. A padded key column gets p = 0 exactly (never a score
//   of -1e30, which on an all-masked row would join the uniform average
//   and spread it over 40 keys instead of 35) and ds = 0; padded key and
//   query rows are zero in shared memory and never stored.
// * Loads overlap compute: a persistent grid (SMs x blocks per SM) walks
//   over units of tiles, and a ring of 2-3 stages in shared memory holds
//   the next units' q/k/v (and dO), brought in by 16-byte cp.async.cg (the
//   mask by 4-byte cp.async of its aligned words) while the current unit
//   computes. Outputs go back through shared memory (O over the spent q;
//   dK, dV over the spent k, v; dQ in a tile of its own) and are stored 16
//   bytes a thread. The launcher picks the unit and the ring depth that
//   keep the most warps on an SM: in f32 at S=32 the forward runs 3
//   blocks of 2 warps (one tile a unit, 2 stages), the backward 2 blocks
//   of 4.
// * Shared memory rows are an odd multiple of 16 bytes apart, so every
//   fragment read (rows for Q K^T; columns, two rows a lane, for P V, dS K
//   and the transposed products) falls on 32 distinct banks.
//
// Measured on an H100 (700 W, f32; PERF.md): the forward 0.166 ms at
// M=256 (1.8x the byte bound, SDPA 0.40 ms) and 2.4 ms at M=4096; the
// backward 5.0 ms at M=4096 (1.9x, SDPA's backward 12.5 ms). What holds
// them back is instructions, not bytes: with the copies alone the ring
// moves the forward's q/k/v at 3 TB/s, and with 6-8 warps an SM (the f32
// ring fills shared memory) the splits' integer work (cvt.rna is 4
// instructions on sm_90; rounding hi by truncation instead was 12-15%
// faster) and the mma chains are not all hidden.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

#include <type_traits>

#include "tf32_mma.cuh"

namespace {

using tf32x3::split;

constexpr float kNegInf = -1e30f;
constexpr int kMaxS = 32;           // query rows: two m16 row blocks
constexpr int kMinNT = 2, kMaxNT = 5;   // key tiles of 8: Sk <= 40
constexpr int kMaskBytes = 48;      // the aligned words holding Sk <= 40 mask bytes
constexpr int kMaxSmem = 232448;    // bytes a block can have on an H100
constexpr int kFwdWarps = 4;        // warps a block, at most
constexpr int kBwdWarps = 8;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}
template <> __device__ __forceinline__ __half from_f32<__half>(float x) {
  return __float2half(x);
}

// ----------------------------------------------------------------- layout
struct Shape {
  long long tiles;    // M * K * H
  int S, Sk, H;
  int rb;             // m16 row blocks a tile (1 for S <= 16, else 2)
  int tps;            // tiles a unit (a ring stage); rb * tps warps a block
  int nstage;         // ring stages (2 or 3)
  float scale;
};

// Byte offsets of one block's shared memory: nstage stages of tps tiles
// (q, [do,] k, v, mask words), then, in the backward, tps scratch tiles
// (BwdSmem: p and ds as tf32 hi and lo planes, dq in the input dtype, the
// row statistics the two halves exchange).
struct Geom {
  int pitch;          // bytes between rows of a q/do/k/v tile
  int q_rows;         // 16 * rb
  int kv_rows;        // 8 * nt
  int lp;             // floats between rows of a p/ds tile
  int tile_bytes, stage_bytes, pds_bytes, total_bytes;   // pds: BwdSmem
};

// bytes between shared-memory rows of row_bytes (a multiple of 16): an
// odd multiple of 16, so the fragment reads fall on 32 distinct banks
__host__ __device__ constexpr int row_pitch(int row_bytes) {
  return (row_bytes / 16) % 2 ? row_bytes : row_bytes + 16;
}

// floats between rows of a p/ds tile of nt key tiles (4 mod 8: the
// transposed products' column reads fall on distinct banks)
__host__ __device__ constexpr int pds_pitch(int nt) { return 8 * nt + 4; }

__host__ __device__ inline Geom geometry(int elem, int D, int rb, int nt,
                                         int tps, int nstage, bool bwd) {
  Geom g;
  g.pitch = row_pitch(D * elem);
  g.q_rows = 16 * rb;
  g.kv_rows = 8 * nt;
  g.lp = pds_pitch(nt);
  g.tile_bytes = g.pitch * (g.q_rows * (bwd ? 2 : 1) + 2 * g.kv_rows)
                 + kMaskBytes;
  g.stage_bytes = tps * g.tile_bytes;
  g.pds_bytes = bwd ? 4 * 4 * g.q_rows * g.lp + g.q_rows * g.pitch
                        + 3 * 2 * 4 * g.q_rows
                    : 0;
  g.total_bytes = nstage * g.stage_bytes + tps * g.pds_bytes;
  return g;
}

// One tile's regions inside a stage.
template <typename T>
struct TileSmem {
  T* q; T* dout; T* k; T* v; uint8_t* mask;
  __device__ TileSmem(char* base, const Geom& g, bool bwd) {
    char* p = base;
    q = reinterpret_cast<T*>(p);       p += g.q_rows * g.pitch;
    dout = reinterpret_cast<T*>(p);    if (bwd) p += g.q_rows * g.pitch;
    k = reinterpret_cast<T*>(p);       p += g.kv_rows * g.pitch;
    v = reinterpret_cast<T*>(p);       p += g.kv_rows * g.pitch;
    mask = reinterpret_cast<uint8_t*>(p);
  }
};

// ------------------------------------------------------------- async copy
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(s), "l"(gmem) : "memory");
}
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
               :: "r"(s), "l"(gmem) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// rows x (kCh x 16 bytes) from global (rows g_stride elements apart) into
// shared memory (rows pitch bytes apart)
template <int kCh, typename T>
__device__ __forceinline__ void load_rows(char* s, int pitch, const T* g,
                                          long long g_stride, int rows) {
  for (int e = threadIdx.x; e < rows * kCh; e += blockDim.x) {
    const int r = e / kCh, c = e - r * kCh;
    cp_async16(s + r * pitch + c * 16,
               reinterpret_cast<const char*>(g + r * g_stride) + c * 16);
  }
}

// the reverse, 16 bytes a thread, from lane `first` in steps of `step`
template <int kCh, typename T>
__device__ __forceinline__ void store_rows(T* g, long long g_stride,
                                           const char* s, int pitch, int rows,
                                           int first, int step) {
  for (int e = first; e < rows * kCh; e += step) {
    const int r = e / kCh, c = e - r * kCh;
    *reinterpret_cast<int4*>(reinterpret_cast<char*>(g + r * g_stride)
                             + c * 16) =
        *reinterpret_cast<const int4*>(s + r * pitch + c * 16);
  }
}

struct Ptrs {
  const void* q; const void* k; const void* v; const uint8_t* mask;
  const void* dout;              // backward only
  void* o;                       // forward: o; backward: dq
  void* dk; void* dv;            // backward only
};

// Issue the cp.async copies of unit `unit`'s tiles into `stage`.
template <typename T, int D, bool kBwd>
__device__ __forceinline__ void load_unit(char* stage, long long unit,
                                          const Geom& geo, const Shape& sh,
                                          const Ptrs& p) {
  constexpr int kCh = D * (int)sizeof(T) / 16;
  const long long row = (long long)sh.H * D;
  for (int j = 0; j < sh.tps; ++j) {
    const long long tt = unit * sh.tps + j;
    if (tt >= sh.tiles) break;
    const long long mk = tt / sh.H;
    const int h = (int)(tt - mk * sh.H);
    TileSmem<T> ts(stage + j * geo.tile_bytes, geo, kBwd);
    const long long qo = mk * sh.S * row + h * D;
    const long long ko = mk * sh.Sk * row + h * D;
    load_rows<kCh>(reinterpret_cast<char*>(ts.q), geo.pitch,
                   static_cast<const T*>(p.q) + qo, row, sh.S);
    if (kBwd)
      load_rows<kCh>(reinterpret_cast<char*>(ts.dout), geo.pitch,
                     static_cast<const T*>(p.dout) + qo, row, sh.S);
    load_rows<kCh>(reinterpret_cast<char*>(ts.k), geo.pitch,
                   static_cast<const T*>(p.k) + ko, row, sh.Sk);
    load_rows<kCh>(reinterpret_cast<char*>(ts.v), geo.pitch,
                   static_cast<const T*>(p.v) + ko, row, sh.Sk);
    // the mask bytes through the aligned words that hold them
    const uintptr_t a = reinterpret_cast<uintptr_t>(p.mask + mk * sh.Sk);
    const uintptr_t w0 = a & ~(uintptr_t)3;
    const int nw = (int)((((a + sh.Sk + 3) & ~(uintptr_t)3) - w0) >> 2);
    for (int e = threadIdx.x; e < nw; e += blockDim.x)
      cp_async4(ts.mask + 4 * e, reinterpret_cast<const void*>(w0 + 4 * e));
  }
}

// offset of tile tt's first mask byte inside its copied words
__device__ __forceinline__ int mask_offset(const uint8_t* mask, long long mk,
                                           int Sk) {
  return (int)(reinterpret_cast<uintptr_t>(mask + mk * Sk) & 3);
}

// -------------------------------------------------------- tensor-core math
// (tf32 and split, the 3xTF32 operand split, are in tf32_mma.cuh)

struct FragA { uint32_t hi[4], lo[4]; };    // m16 x k8, row
struct FragB { uint32_t hi[2], lo[2]; };    // k8 x n8, col

__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// c += a b in 3xTF32: hi*lo + lo*hi + hi*hi (an exact side has no lo)
template <bool kAExact, bool kBExact>
__device__ __forceinline__ void mma3(float (&c)[4], const FragA& a,
                                     const FragB& b) {
  if (!kBExact) mma(c, a.hi, b.lo);
  if (!kAExact) mma(c, a.lo, b.hi);
  mma(c, a.hi, b.hi);
}

// Fragment reads; g = lane / 4, t = lane % 4 (PTX's m16n8k8 layouts:
// a0 (g, t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4); b0 (t, g),
// b1 (t + 4, g); c0 (g, 2t), c1 (g, 2t + 1), c2 (g + 8, 2t), c3 (g + 8,
// 2t + 1)). "Paired" reads take the k index of slot t as 2t and of slot
// t + 4 as 2t + 1, as the accumulator's columns are laid out.

// A(m, k) = s[(r0 + m) * ld + k0 + k]
template <bool kExact, typename T>
__device__ __forceinline__ FragA a_rows(const T* s, int ld, int r0, int k0,
                                        int g, int t) {
  FragA f;
  const T* p = s + (r0 + g) * ld + k0 + t;
  split<kExact>(to_f32(p[0]), f.hi[0], f.lo[0]);
  split<kExact>(to_f32(p[8 * ld]), f.hi[1], f.lo[1]);
  split<kExact>(to_f32(p[4]), f.hi[2], f.lo[2]);
  split<kExact>(to_f32(p[8 * ld + 4]), f.hi[3], f.lo[3]);
  return f;
}

// A(m, k) = s[(k0 + k) * ld + m0 + m], k paired
template <bool kExact, typename T>
__device__ __forceinline__ FragA a_cols(const T* s, int ld, int k0, int m0,
                                        int g, int t) {
  FragA f;
  const T* p = s + (k0 + 2 * t) * ld + m0 + g;
  split<kExact>(to_f32(p[0]), f.hi[0], f.lo[0]);
  split<kExact>(to_f32(p[8]), f.hi[1], f.lo[1]);
  split<kExact>(to_f32(p[ld]), f.hi[2], f.lo[2]);
  split<kExact>(to_f32(p[ld + 8]), f.hi[3], f.lo[3]);
  return f;
}

// A from an m16n8 accumulator (k paired): p or ds, split
__device__ __forceinline__ FragA a_acc(const float (&c)[4]) {
  FragA f;
  split<false>(c[0], f.hi[0], f.lo[0]);
  split<false>(c[2], f.hi[1], f.lo[1]);
  split<false>(c[1], f.hi[2], f.lo[2]);
  split<false>(c[3], f.hi[3], f.lo[3]);
  return f;
}

// B(k, n) = s[(n0 + n) * ld + k0 + k]
template <bool kExact, typename T>
__device__ __forceinline__ FragB b_rows(const T* s, int ld, int n0, int k0,
                                        int g, int t) {
  FragB f;
  const T* p = s + (n0 + g) * ld + k0 + t;
  split<kExact>(to_f32(p[0]), f.hi[0], f.lo[0]);
  split<kExact>(to_f32(p[4]), f.hi[1], f.lo[1]);
  return f;
}

// B(k, n) = s[(k0 + k) * ld + n0 + n], k paired
template <bool kExact, typename T>
__device__ __forceinline__ FragB b_cols(const T* s, int ld, int k0, int n0,
                                        int g, int t) {
  FragB f;
  const T* p = s + (k0 + 2 * t) * ld + n0 + g;
  split<kExact>(to_f32(p[0]), f.hi[0], f.lo[0]);
  split<kExact>(to_f32(p[ld]), f.hi[1], f.lo[1]);
  return f;
}

// B(k, n) from hi and lo planes, split when they were written, k paired
__device__ __forceinline__ FragB b_cols_split(const uint32_t* hi,
                                              const uint32_t* lo, int ld,
                                              int k0, int n0, int g, int t) {
  FragB f;
  const int i = (k0 + 2 * t) * ld + n0 + g;
  f.hi[0] = hi[i];
  f.hi[1] = hi[i + ld];
  f.lo[0] = lo[i];
  f.lo[1] = lo[i + ld];
  return f;
}

// Scores of one warp's 16 rows (rows g and g + 8 of the block) into
// probabilities, in place: scaled, masked to -1e30, max-subtracted,
// l = max(sum, 1e-30). Padded key columns (>= Sk) get p = 0 exactly, and
// so do rows past S (`live0`, `live1`).
template <int NT>
__device__ __forceinline__ void softmax_rows(float (&s)[NT][4], int Sk,
                                             const uint8_t* mask,
                                             float scale, int t, bool live0,
                                             bool live1) {
  const float inf = __int_as_float(0x7f800000);
  float mx[2] = {-inf, -inf};
#pragma unroll
  for (int j = 0; j < NT; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int col = j * 8 + 2 * t + (e & 1);
      if (col < Sk) {
        s[j][e] = mask[col] ? s[j][e] * scale : kNegInf;
        mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
      }
    }
  }
  float sum[2] = {0.f, 0.f};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
  }
#pragma unroll
  for (int j = 0; j < NT; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int col = j * 8 + 2 * t + (e & 1);
      s[j][e] = col < Sk ? expf(s[j][e] - mx[e >> 1]) : 0.f;
      sum[e >> 1] += s[j][e];
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 1);
    sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 2);
    sum[r] = 1.f / fmaxf(sum[r], 1e-30f);
  }
  if (!live0) sum[0] = 0.f;
  if (!live1) sum[1] = 0.f;
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] *= sum[e >> 1];
}

template <typename T>
__device__ __forceinline__ void put(T* p, float x) { *p = from_f32<T>(x); }

// ----------------------------------------------------------------- kernels
// Persistent: block b takes units b, b + G, ...; a unit is tps tiles,
// warp w takes row block w % rb of the unit's tile w / rb.
template <typename T, int D, int NT>
__global__ void __launch_bounds__(kFwdWarps * 32, 1)
bus_fwd_kernel(Ptrs p, Shape sh) {
  constexpr bool kE = !std::is_same<T, float>::value;   // inputs exact in tf32
  constexpr int kCh = D * (int)sizeof(T) / 16;
  extern __shared__ __align__(16) char smem[];
  constexpr int ld = row_pitch(D * (int)sizeof(T)) / (int)sizeof(T);
  const Geom geo = geometry(sizeof(T), D, sh.rb, NT, sh.tps, sh.nstage,
                            false);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int slot = warp / sh.rb, rb = warp - slot * sh.rb;
  const long long row = (long long)sh.H * D;

  // padded rows stay zero: the copies only ever write real rows
  for (int i = threadIdx.x; i < geo.total_bytes / 16; i += blockDim.x)
    reinterpret_cast<int4*>(smem)[i] = make_int4(0, 0, 0, 0);
  __syncthreads();

  const long long units = (sh.tiles + sh.tps - 1) / sh.tps;
  const long long first = blockIdx.x, step = gridDim.x;
  const int n = first < units ? (int)((units - 1 - first) / step + 1) : 0;
  for (int s = 0; s < sh.nstage - 1; ++s) {
    if (s < n)
      load_unit<T, D, false>(smem + s * geo.stage_bytes, first + s * step,
                             geo, sh, p);
    cp_async_commit();
  }
  for (int i = 0; i < n; ++i) {
    if (sh.nstage == 3) cp_async_wait<1>(); else cp_async_wait<0>();
    __syncthreads();            // unit i landed; unit i - 1's stage is free
    const int pre = i + sh.nstage - 1;
    if (pre < n)
      load_unit<T, D, false>(smem + (pre % sh.nstage) * geo.stage_bytes,
                             first + pre * step, geo, sh, p);
    cp_async_commit();

    const long long tt = (first + i * step) * sh.tps + slot;
    if (tt >= sh.tiles) continue;
    const long long mk = tt / sh.H;
    const int h = (int)(tt - mk * sh.H);
    TileSmem<T> ts(smem + (i % sh.nstage) * geo.stage_bytes
                   + slot * geo.tile_bytes, geo, false);
    const uint8_t* mask = ts.mask + mask_offset(p.mask, mk, sh.Sk);
    const int r0 = rb * 16;

    float s[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < D / 8; ++ks) {
      const FragA a = a_rows<kE>(ts.q, ld, r0, ks * 8, g, t);
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        mma3<kE, kE>(s[j], a, b_rows<kE>(ts.k, ld, j * 8, ks * 8, g, t));
      }
    }
    softmax_rows(s, sh.Sk, mask, sh.scale, t, r0 + g < sh.S,
                 r0 + g + 8 < sh.S);

    float o[D / 8][4];
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[j][e] = 0.f;
#pragma unroll
    for (int kt = 0; kt < NT; ++kt) {
      const FragA a = a_acc(s[kt]);
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        mma3<false, kE>(o[j], a, b_cols<kE>(ts.v, ld, kt * 8, j * 8, g, t));
    }

    // O over this warp's own q rows, then out 16 bytes a lane
    __syncwarp();
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const int col = j * 8 + 2 * t;
      if (r0 + g < sh.S) {
        put(ts.q + (r0 + g) * ld + col, o[j][0]);
        put(ts.q + (r0 + g) * ld + col + 1, o[j][1]);
      }
      if (r0 + g + 8 < sh.S) {
        put(ts.q + (r0 + g + 8) * ld + col, o[j][2]);
        put(ts.q + (r0 + g + 8) * ld + col + 1, o[j][3]);
      }
    }
    __syncwarp();
    const int rows = min(16, sh.S - r0);
    if (rows > 0)
      store_rows<kCh>(static_cast<T*>(p.o) + (mk * sh.S + r0) * row + h * D,
                      row, reinterpret_cast<const char*>(ts.q + r0 * ld),
                      geo.pitch, rows, lane, 32);
  }
  cp_async_wait<0>();
}

// A tile's backward runs on 2 * rb warps: warp (rb, half) computes S and
// dP for its 16 rows over one half of the key tiles (the row max, sum and
// delta of the softmax combined with the other half's through shared
// memory), then dQ for its rows over one half of D, then a share of the
// 16-column steps of dV^T and dK^T. Shared memory holds two f32 tiles an
// SM at a time, and one warp a row block (4 warps an SM) left the
// products' latency unhidden: 6.45 ms at M=4096, against 5.04 with two.

__device__ __forceinline__ void pair_sync(int id) {
  asm volatile("bar.sync %0, 64;\n" :: "r"(id) : "memory");
}

// Combine a row quantity (rows g and g + 8 of the block, one value a
// quad) with the other half's: red holds [2 halves][q_rows rows].
__device__ __forceinline__ void exchange(float* red, int q_rows, int half,
                                         int row, int t, int bar,
                                         float (&x)[2], bool take_max) {
  if (t == 0) {
    red[half * q_rows + row] = x[0];
    red[half * q_rows + row + 8] = x[1];
  }
  pair_sync(bar);
  const float* o = red + (1 - half) * q_rows + row;
  x[0] = take_max ? fmaxf(x[0], o[0]) : x[0] + o[0];
  x[1] = take_max ? fmaxf(x[1], o[8]) : x[1] + o[8];
}

__device__ __forceinline__ void quad_reduce(float (&x)[2], bool take_max) {
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int m = 1; m <= 2; m <<= 1) {
      const float y = __shfl_xor_sync(0xffffffffu, x[r], m);
      x[r] = take_max ? fmaxf(x[r], y) : x[r] + y;
    }
}

struct BwdSmem {                     // one tile slot's backward scratch
  uint32_t *ps_hi, *ps_lo, *ds_hi, *ds_lo;   // p, ds as tf32 planes
  void* dq;                                  // rows of the tile's pitch
  float* red;                                // 3 x [2 halves][q_rows]
  __device__ BwdSmem(char* base, const Geom& g) {
    const int plane = g.q_rows * g.lp;
    ps_hi = reinterpret_cast<uint32_t*>(base);
    ps_lo = ps_hi + plane;
    ds_hi = ps_lo + plane;
    ds_lo = ds_hi + plane;
    dq = ds_lo + plane;
    red = reinterpret_cast<float*>(reinterpret_cast<char*>(dq)
                                   + g.q_rows * g.pitch);
  }
};

// S and dP of one warp's 16 rows over key tiles [J0, J0 + NJ), the
// softmax with the other half's row statistics, then p and ds written to
// their planes (split once, for every later read). Padded columns and the
// rows past S get p = ds = 0; masked keys ds = 0.
template <typename T, int D, int J0, int NJ>
__device__ __forceinline__ void bwd_scores(const TileSmem<T>& ts,
                                           const BwdSmem& bs, int q_rows,
                                           int lp, const uint8_t* mask,
                                           const Shape& sh, int r0, int half,
                                           int g, int t, int bar) {
  constexpr bool kE = !std::is_same<T, float>::value;
  constexpr int ld = row_pitch(D * (int)sizeof(T)) / (int)sizeof(T);
  float s[NJ][4], dp[NJ][4];
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll 2
  for (int ks = 0; ks < D / 8; ++ks) {
    const FragA aq = a_rows<kE>(ts.q, ld, r0, ks * 8, g, t);
    const FragA ad = a_rows<kE>(ts.dout, ld, r0, ks * 8, g, t);
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      mma3<kE, kE>(s[j], aq, b_rows<kE>(ts.k, ld, (J0 + j) * 8, ks * 8, g, t));
      mma3<kE, kE>(dp[j], ad,
                   b_rows<kE>(ts.v, ld, (J0 + j) * 8, ks * 8, g, t));
    }
  }
  float* red_max = bs.red;
  float* red_sum = red_max + 2 * q_rows;
  float* red_delta = red_sum + 2 * q_rows;
  const float inf = __int_as_float(0x7f800000);
  float x[2] = {-inf, -inf};
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int col = (J0 + j) * 8 + 2 * t + (e & 1);
      if (col < sh.Sk) {
        s[j][e] = mask[col] ? s[j][e] * sh.scale : kNegInf;
        x[e >> 1] = fmaxf(x[e >> 1], s[j][e]);
      }
    }
  quad_reduce(x, true);
  exchange(red_max, q_rows, half, r0 + g, t, bar, x, true);
  const float mx[2] = {x[0], x[1]};
  x[0] = x[1] = 0.f;
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int col = (J0 + j) * 8 + 2 * t + (e & 1);
      s[j][e] = col < sh.Sk ? expf(s[j][e] - mx[e >> 1]) : 0.f;
      x[e >> 1] += s[j][e];
    }
  quad_reduce(x, false);
  exchange(red_sum, q_rows, half, r0 + g, t, bar, x, false);
  const float inv[2] = {r0 + g < sh.S ? 1.f / fmaxf(x[0], 1e-30f) : 0.f,
                        r0 + g + 8 < sh.S ? 1.f / fmaxf(x[1], 1e-30f) : 0.f};
  x[0] = x[1] = 0.f;
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      s[j][e] *= inv[e >> 1];
      x[e >> 1] += s[j][e] * dp[j][e];
    }
  quad_reduce(x, false);
  exchange(red_delta, q_rows, half, r0 + g, t, bar, x, false);
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    uint32_t hi[2][4], lo[2][4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int col = (J0 + j) * 8 + 2 * t + (e & 1);
      const float ds = col < sh.Sk && mask[col]
                           ? s[j][e] * (dp[j][e] - x[e >> 1]) * sh.scale
                           : 0.f;
      split<false>(s[j][e], hi[0][e], lo[0][e]);
      split<false>(ds, hi[1][e], lo[1][e]);
    }
    const int i0 = (r0 + g) * lp + (J0 + j) * 8 + 2 * t, i1 = i0 + 8 * lp;
    *reinterpret_cast<uint2*>(bs.ps_hi + i0) = make_uint2(hi[0][0], hi[0][1]);
    *reinterpret_cast<uint2*>(bs.ps_hi + i1) = make_uint2(hi[0][2], hi[0][3]);
    *reinterpret_cast<uint2*>(bs.ps_lo + i0) = make_uint2(lo[0][0], lo[0][1]);
    *reinterpret_cast<uint2*>(bs.ps_lo + i1) = make_uint2(lo[0][2], lo[0][3]);
    *reinterpret_cast<uint2*>(bs.ds_hi + i0) = make_uint2(hi[1][0], hi[1][1]);
    *reinterpret_cast<uint2*>(bs.ds_hi + i1) = make_uint2(hi[1][2], hi[1][3]);
    *reinterpret_cast<uint2*>(bs.ds_lo + i0) = make_uint2(lo[1][0], lo[1][1]);
    *reinterpret_cast<uint2*>(bs.ds_lo + i1) = make_uint2(lo[1][2], lo[1][3]);
  }
}

// A(m, k) from hi and lo planes of rows of ld, k paired
__device__ __forceinline__ FragA a_rows_split(const uint32_t* hi,
                                              const uint32_t* lo, int ld,
                                              int r0, int k0, int g, int t) {
  FragA f;
  const int i = (r0 + g) * ld + k0 + 2 * t;
  f.hi[0] = hi[i];
  f.hi[1] = hi[i + 8 * ld];
  f.hi[2] = hi[i + 1];
  f.hi[3] = hi[i + 8 * ld + 1];
  f.lo[0] = lo[i];
  f.lo[1] = lo[i + 8 * ld];
  f.lo[2] = lo[i + 1];
  f.lo[3] = lo[i + 8 * ld + 1];
  return f;
}

template <typename T, int D, int NT>
__global__ void __launch_bounds__(kBwdWarps * 32, 1)
bus_bwd_kernel(Ptrs p, Shape sh) {
  constexpr bool kE = !std::is_same<T, float>::value;
  constexpr int kCh = D * (int)sizeof(T) / 16;
  constexpr int ld = row_pitch(D * (int)sizeof(T)) / (int)sizeof(T);
  constexpr int lp = pds_pitch(NT);
  constexpr int kHalf0 = (NT + 1) / 2;        // key tiles of half 0
  extern __shared__ __align__(16) char smem[];
  const Geom geo = geometry(sizeof(T), D, sh.rb, NT, sh.tps, sh.nstage,
                            true);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wpt = 2 * sh.rb;                  // warps a tile
  const int slot = warp / wpt, wi = warp - slot * wpt;
  const int rb = wi % sh.rb, half = wi / sh.rb;
  const int bar = 1 + slot * 2 + rb;          // the pair's named barrier
  const long long row = (long long)sh.H * D;
  char* scratch = smem + sh.nstage * geo.stage_bytes;
  const BwdSmem bs(scratch + slot * geo.pds_bytes, geo);

  for (int i = threadIdx.x; i < geo.total_bytes / 16; i += blockDim.x)
    reinterpret_cast<int4*>(smem)[i] = make_int4(0, 0, 0, 0);
  __syncthreads();

  const long long units = (sh.tiles + sh.tps - 1) / sh.tps;
  const long long first = blockIdx.x, step = gridDim.x;
  const int n = first < units ? (int)((units - 1 - first) / step + 1) : 0;
  for (int s = 0; s < sh.nstage - 1; ++s) {
    if (s < n)
      load_unit<T, D, true>(smem + s * geo.stage_bytes, first + s * step,
                            geo, sh, p);
    cp_async_commit();
  }
  for (int i = 0; i < n; ++i) {
    if (sh.nstage == 3) cp_async_wait<1>(); else cp_async_wait<0>();
    __syncthreads();
    const int pre = i + sh.nstage - 1;
    if (pre < n)
      load_unit<T, D, true>(smem + (pre % sh.nstage) * geo.stage_bytes,
                            first + pre * step, geo, sh, p);
    cp_async_commit();

    const long long unit = first + i * step;
    const long long tt = unit * sh.tps + slot;
    const bool live = tt < sh.tiles;
    char* stage = smem + (i % sh.nstage) * geo.stage_bytes;
    TileSmem<T> ts(stage + slot * geo.tile_bytes, geo, true);
    const int r0 = rb * 16;

    // p and ds of this warp's rows and half of the keys; then dQ = dS K
    // for its rows and half of D, once the pair's planes are complete
    if (live) {
      const long long mk = tt / sh.H;
      const uint8_t* mask = ts.mask + mask_offset(p.mask, mk, sh.Sk);
      if (half == 0)
        bwd_scores<T, D, 0, kHalf0>(ts, bs, geo.q_rows, lp, mask, sh, r0,
                                    half, g, t, bar);
      else
        bwd_scores<T, D, kHalf0, NT - kHalf0>(ts, bs, geo.q_rows, lp, mask,
                                              sh, r0, half, g, t, bar);
      pair_sync(bar);
      float dq[D / 16][4];
#pragma unroll
      for (int j = 0; j < D / 16; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) dq[j][e] = 0.f;
#pragma unroll
      for (int kt = 0; kt < NT; ++kt) {
        const FragA a = a_rows_split(bs.ds_hi, bs.ds_lo, lp, r0, kt * 8, g, t);
#pragma unroll
        for (int j = 0; j < D / 16; ++j)
          mma3<false, kE>(dq[j], a, b_cols<kE>(ts.k, ld, kt * 8,
                                               (half * D / 16 + j) * 8, g, t));
      }
      T* dqs = static_cast<T*>(bs.dq);
#pragma unroll
      for (int j = 0; j < D / 16; ++j) {
        const int col = (half * D / 16 + j) * 8 + 2 * t;
        put(dqs + (r0 + g) * ld + col, dq[j][0]);
        put(dqs + (r0 + g) * ld + col + 1, dq[j][1]);
        put(dqs + (r0 + g + 8) * ld + col, dq[j][2]);
        put(dqs + (r0 + g + 8) * ld + col + 1, dq[j][3]);
      }
    }
    __syncthreads();            // p, ds and dq complete; k, v no longer read

    // dV^T = dO^T P and dK^T = Q^T dS, 16 columns of D a step, over k, v
    if (live) {
      const int kq = (sh.S + 7) / 8;
      for (int mt = wi; mt < D / 16; mt += wpt) {
        float av[NT][4], ak[NT][4];
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) av[j][e] = ak[j][e] = 0.f;
        for (int kk = 0; kk < kq; ++kk) {
          const FragA ad = a_cols<kE>(ts.dout, ld, kk * 8, mt * 16, g, t);
          const FragA aq = a_cols<kE>(ts.q, ld, kk * 8, mt * 16, g, t);
#pragma unroll
          for (int j = 0; j < NT; ++j) {
            mma3<kE, false>(av[j], ad, b_cols_split(bs.ps_hi, bs.ps_lo, lp,
                                                    kk * 8, j * 8, g, t));
            mma3<kE, false>(ak[j], aq, b_cols_split(bs.ds_hi, bs.ds_lo, lp,
                                                    kk * 8, j * 8, g, t));
          }
        }
        const int d0 = mt * 16 + g;
#pragma unroll
        for (int j = 0; j < NT; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int key = j * 8 + 2 * t + (e & 1);
            const int d = d0 + 8 * (e >> 1);
            if (key < sh.Sk) {
              put(ts.v + key * ld + d, av[j][e]);
              put(ts.k + key * ld + d, ak[j][e]);
            }
          }
        }
      }
    }
    __syncthreads();            // dK, dV complete

    // every output out, 16 bytes a thread
    for (int j = 0; j < sh.tps; ++j) {
      const long long tj = unit * sh.tps + j;
      if (tj >= sh.tiles) break;
      const long long mj = tj / sh.H;
      const int hj = (int)(tj - mj * sh.H);
      const TileSmem<T> tsj(stage + j * geo.tile_bytes, geo, true);
      const BwdSmem bsj(scratch + j * geo.pds_bytes, geo);
      const long long ko = mj * sh.Sk * row + hj * D;
      store_rows<kCh>(static_cast<T*>(p.o) + mj * sh.S * row + hj * D, row,
                      static_cast<const char*>(bsj.dq), geo.pitch, sh.S,
                      threadIdx.x, blockDim.x);
      store_rows<kCh>(static_cast<T*>(p.dk) + ko, row,
                      reinterpret_cast<const char*>(tsj.k), geo.pitch, sh.Sk,
                      threadIdx.x, blockDim.x);
      store_rows<kCh>(static_cast<T*>(p.dv) + ko, row,
                      reinterpret_cast<const char*>(tsj.v), geo.pitch, sh.Sk,
                      threadIdx.x, blockDim.x);
    }
  }
  cp_async_wait<0>();
}

// The unit (tiles a stage) and ring depth that keep the most warps on an
// SM (blocks an SM x warps a block, from each candidate's occupancy); a
// tie goes to more blocks (their barriers are apart), then to the wider
// unit and the deeper ring. The best shape differs by dtype, D, key tiles
// and row blocks (it depends on shared memory and on the registers ptxas
// gave each instantiation), so it is found once per instantiation and
// row-block count, on the first launch. err is not cudaSuccess when no
// candidate fits or a query failed.
struct Config { int tps, nstage, bytes, per_sm, threads; cudaError_t err; };

template <typename T, int D, int NT, bool kBwd>
Config search_config(int rb, void (*kernel)(Ptrs, Shape)) {
  const int wpt = kBwd ? 2 * rb : rb;            // warps a tile
  const int most = kBwd ? kBwdWarps : kFwdWarps;
  Config best = {};
  for (int tps = most / wpt; tps >= 1; tps /= 2)
    for (int ns = 3; ns >= 2; --ns) {
      const int bytes =
          geometry(sizeof(T), D, rb, NT, tps, ns, kBwd).total_bytes;
      if (bytes > kMaxSmem) continue;
      cudaError_t err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
      int per_sm = 0;
      if (err == cudaSuccess)
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm, kernel, 32 * wpt * tps, bytes);
      if (err != cudaSuccess) {
        best.err = err;
        return best;
      }
      const bool more = per_sm * tps > best.per_sm * best.tps
                        || (per_sm * tps == best.per_sm * best.tps
                            && per_sm > best.per_sm);
      if (more) best = {tps, ns, bytes, per_sm, 32 * wpt * tps, cudaSuccess};
    }
  if (!best.per_sm) best.err = cudaErrorInvalidConfiguration;
  return best;
}

// One search for each row-block count (1 or 2); a function-local static
// is initialised once, even when launches come from several threads.
template <typename T, int D, int NT, bool kBwd>
const Config& pick_config(int rb, void (*kernel)(Ptrs, Shape)) {
  if (rb == 1) {
    static const Config one = search_config<T, D, NT, kBwd>(1, kernel);
    return one;
  }
  static const Config two = search_config<T, D, NT, kBwd>(2, kernel);
  return two;
}

template <typename T, int D, int NT, bool kBwd>
int launch(const Ptrs& p, int M, int K, int S, int Sk, int H, float scale,
           cudaStream_t stream) {
  Shape sh;
  sh.tiles = (long long)M * K * H;
  sh.S = S; sh.Sk = Sk; sh.H = H;
  sh.rb = S > 16 ? 2 : 1;
  sh.scale = scale;
  if (sh.tiles == 0) return (int)cudaSuccess;
  void (*kernel)(Ptrs, Shape) = kBwd ? bus_bwd_kernel<T, D, NT>
                                      : bus_fwd_kernel<T, D, NT>;
  const Config& c = pick_config<T, D, NT, kBwd>(sh.rb, kernel);
  if (c.err != cudaSuccess) return (int)c.err;
  cudaError_t err;
  if ((err = cudaFuncSetAttribute(
           kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, c.bytes))
      != cudaSuccess)
    return (int)err;
  sh.tps = c.tps;
  sh.nstage = c.nstage;
  int dev = 0, sms = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess)
    return (int)err;
  const long long units = (sh.tiles + sh.tps - 1) / sh.tps;
  const long long grid = units < (long long)sms * c.per_sm
                             ? units : (long long)sms * c.per_sm;
  kernel<<<(unsigned)grid, c.threads, c.bytes, stream>>>(p, sh);
  return (int)cudaGetLastError();
}

// The key tiles are a template argument, so that every product's tiles
// are unrolled without a branch between them; Sk <= 8 takes two.
template <bool kBwd, typename T, int D>
int dispatch_nt(const Ptrs& p, int M, int K, int S, int Sk, int H,
                float scale, cudaStream_t s) {
  if (S < 1 || S > kMaxS || Sk < 1 || Sk > 8 * kMaxNT)
    return (int)cudaErrorInvalidValue;
  switch ((Sk + 7) / 8 < kMinNT ? kMinNT : (Sk + 7) / 8) {
    case 2: return launch<T, D, 2, kBwd>(p, M, K, S, Sk, H, scale, s);
    case 3: return launch<T, D, 3, kBwd>(p, M, K, S, Sk, H, scale, s);
    case 4: return launch<T, D, 4, kBwd>(p, M, K, S, Sk, H, scale, s);
    case 5: return launch<T, D, 5, kBwd>(p, M, K, S, Sk, H, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <bool kBwd, typename T>
int dispatch_d(const Ptrs& p, int M, int K, int S, int Sk, int H, int D,
               float scale, cudaStream_t s) {
  switch (D) {
    case 16: return dispatch_nt<kBwd, T, 16>(p, M, K, S, Sk, H, scale, s);
    case 32: return dispatch_nt<kBwd, T, 32>(p, M, K, S, Sk, H, scale, s);
    case 64: return dispatch_nt<kBwd, T, 64>(p, M, K, S, Sk, H, scale, s);
    case 128: return dispatch_nt<kBwd, T, 128>(p, M, K, S, Sk, H, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <bool kBwd>
int dispatch(const Ptrs& p, int M, int K, int S, int Sk, int H, int D,
             int dtype, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return dispatch_d<kBwd, float>(p, M, K, S, Sk, H, D, scale, s);
    case 1: return dispatch_d<kBwd, __nv_bfloat16>(p, M, K, S, Sk, H, D, scale, s);
    case 2: return dispatch_d<kBwd, __half>(p, M, K, S, Sk, H, D, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, 2 = float16. Returns the cudaError_t
// of the launch (0 on success).
extern "C" int bus_attention_fwd(const void* q, const void* k, const void* v,
                                 const void* mask, void* o, int M, int K,
                                 int S, int Sk, int H, int D, int dtype,
                                 float scale, void* stream) {
  Ptrs p{q, k, v, static_cast<const uint8_t*>(mask), nullptr, o, nullptr,
         nullptr};
  return dispatch<false>(p, M, K, S, Sk, H, D, dtype, scale, stream);
}

// The backward: dq/dk/dv for do, same dtype codes and return value.
extern "C" int bus_attention_bwd(const void* q, const void* k, const void* v,
                                 const void* mask, const void* dout, void* dq,
                                 void* dk, void* dv, int M, int K, int S,
                                 int Sk, int H, int D, int dtype, float scale,
                                 void* stream) {
  Ptrs p{q, k, v, static_cast<const uint8_t*>(mask), dout, dq, dk, dv};
  return dispatch<true>(p, M, K, S, Sk, H, D, dtype, scale, stream);
}
