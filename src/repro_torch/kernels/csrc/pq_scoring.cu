// PQ asymmetric-distance LUT scan for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/pq_scoring.py
// (pq_lut_scores / _kernel, _masked_kernel):
//   out[b, n] = sum_m lut[b, m, codes[min(b, Bc-1), n, m]]
// and, with a validity mask, out[b, n] = -inf where
// valid[min(b, Bv-1), n] == 0. Bc == 1 / Bv == 1 broadcast through the
// index, without a copy. A negative int32 code counts from the end of its
// table row and a code outside [-K, K) scores NaN, as the plain version
// and the JAX reference gather do; the table read itself stays in bounds.
//
// Layouts (contiguous): lut [B, M, K] f32; codes [Bc, N, M] uint8 or int32;
// valid [Bv, N] bytes (torch.bool); out [B, N] f32.
//
// What bounds it on the H100: bytes. It reads Bc*N*M code bytes and
// Bv*N valid bytes and writes B*N*4 score bytes. At the serve path's
// shape (B=16, M=8, K=32, N = nprobe * cap = 16,384 over a 16,384-news
// corpus) that is 3.4 MB, 1.0 us at 3.35 TB/s, so launch latency and one
// memory round trip dominate; at the deployment IVF shape (1,204,224 news,
// nlist 64, nprobe 16, cap 32,768: N = 524,288) it is 109 MB, 32.6 us,
// twice the L2; the flat scan over that corpus (Bc = 1) writes 77 MB of
// scores, 25.9 us.
//
// Two kernels, chosen before launch by kernels/pq_scoring.py:pq_route and
// each counted under its own name; neither falls back to the other.
//
// pq_lut_scores (uint8 codes, M in {8, 16}, K a power of two <= 256,
// codes 16-byte aligned, a query's table <= 48 KB):
// * Work is split into units of (query group, tile of 1,024 candidates);
//   a thread scores 4 consecutive candidates of a unit. For Bc = B a group
//   is one query; for Bc = 1 it is up to 48 KB of query tables (16 at
//   M=8, K=32), and every code tile is scored against all of them, so the
//   shared codes are read once, not B times; a shared scan too small to
//   keep 512 units that way takes fewer queries a group (one, at the serve
//   batch's 16,384 slots) and reads its codes again from L2
//   (kernels/pq_scoring.py:tiled_plan). (One candidate a thread, so
//   that small scans would run four times the threads, was slower at every
//   scan size measured; PERF.md.)
// * A persistent grid (SMs x resident blocks) gives each block a
//   contiguous range of units, so a block keeps its group's tables in
//   shared memory across the tiles it walks and stages them again only
//   when the group changes (once or twice a block).
// * Bytes in flight: each thread loads its 4 candidates' codes with 16-byte
//   loads (32 bytes at M=8) and their valid bytes as one 4-byte word, and
//   fetches the next unit's before it scores this one; at 3 blocks of 256
//   threads an SM (80 registers a thread) that is ~55 KB in flight, above
//   the ~25 KB the memory's latency-bandwidth product asks. A unit's first codes are
//   requested before its tables are staged, so the two round trips
//   overlap. The codes go to registers, not through a shared-memory ring:
//   the table lookups already take most of shared memory's bandwidth (M
//   four-byte reads a candidate and query against M code bytes).
// * Scores are written as float4 (4 candidates) when N % 4 == 0 and valid
//   is 4-byte aligned (the vector width W = 4), else one float at a time
//   (W = 1, codes as 8-byte loads, valid bytes one by one).
// * Lookups: a table row of K floats sits at m*K, so lanes reading row m at
//   their own codes c hit bank c mod 32. For K <= 32 that is conflict-free
//   (equal codes broadcast); for K = 64..256 two lanes whose codes differ
//   by a multiple of 32 conflict, about 2-4 ways at random codes and K =
//   256. The kernel leaves that as it is: every configuration uses K = 32,
//   and replicating the table to spread the banks would multiply the
//   staging (and, for Bc = 1, the shared memory) by the replication.
// * A code >= K (K a power of two) is found by masking its byte's high
//   bits, which also keeps the lookup in bounds; the slot then scores NaN.
//
// Measured on an H100 (700 W; PERF.md), against the general kernel in
// turns: 3.6 us against 4.3 us at the serve path's scan, 41.8 us against
// 67.3 us at the IVF deployment shape (78% of its byte bound), 37.1 us
// against 142.8 us flat (70%).
//
// pq_lut_scores_general (everything else: int32 codes, other M or K, a
// misaligned base, bigger tables): the first port's kernel, a 1-D grid
// over (query, block of 256 candidates); each block stages its query's
// [M, K] table (up to the 227 KB a block can hold) and each thread scores
// one candidate, with 8-byte code loads where M % 8 == 0 and the base is
// 8-byte aligned.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxSmem = 232448;            // bytes a block can have
constexpr int kThreads = 256;               // the general kernel's block
constexpr int kTileThreads = 256;           // the tiled kernel's block
constexpr int kPer = 4;                     // candidates a thread, a unit
constexpr int kTileN = kTileThreads * kPer; // candidates a unit
constexpr int kMinBlocks = 3;               // resident blocks an SM

// ------------------------------------------------------------ tiled scan

// One unit's loads for one thread: its candidates' code words and the
// first query's valid bytes.
template <int M8>
struct Fetch {
  uint32_t w[kPer * 2 * M8];    // candidate c's code words: [c*2*M8, ...)
  uint32_t valid;               // byte c: slot n0 + c valid (nonzero)
};

// Slots n0 .. n0 + 3 of valid row b as the bytes of a word (all valid
// without a mask; slots past N read as invalid and are never stored).
template <int W>
__device__ __forceinline__ uint32_t valid_bytes(const uint8_t* valid,
                                                long long N, long long n0,
                                                int b) {
  if (valid == nullptr) return 0x01010101u;
  const uint8_t* p = valid + (long long)b * N + n0;
  if (W == 4)
    return n0 < N ? __ldg(reinterpret_cast<const uint32_t*>(p)) : 0u;
  uint32_t bytes = 0u;
#pragma unroll
  for (int c = 0; c < kPer; ++c)
    if (n0 + c < N && p[c] != 0) bytes |= 1u << (8 * c);
  return bytes;
}

template <int M8, int W>
__device__ __forceinline__ void fetch(Fetch<M8>& f, const uint8_t* codes,
                                      const uint8_t* valid, long long N,
                                      long long n0, int b_codes, int b_valid) {
  constexpr int M = 8 * M8;
  const uint8_t* row = codes + ((long long)b_codes * N + n0) * M;
  if (W == 4) {                  // 4 whole candidates (N % 4 == 0)
    if (n0 < N) {
#pragma unroll
      for (int i = 0; i < 2 * M8; ++i) {
        const uint4 x = __ldg(reinterpret_cast<const uint4*>(row) + i);
        f.w[4 * i] = x.x; f.w[4 * i + 1] = x.y;
        f.w[4 * i + 2] = x.z; f.w[4 * i + 3] = x.w;
      }
    }
  } else {
#pragma unroll
    for (int c = 0; c < kPer; ++c) {
      if (n0 + c >= N) break;
#pragma unroll
      for (int i = 0; i < M8; ++i) {
        const uint2 x =
            __ldg(reinterpret_cast<const uint2*>(row + (long long)c * M) + i);
        f.w[c * 2 * M8 + 2 * i] = x.x;
        f.w[c * 2 * M8 + 2 * i + 1] = x.y;
      }
    }
  }
  f.valid = valid_bytes<W>(valid, N, n0, b_valid);
}

// Grid: a contiguous range of units a block. A unit is (group, tile):
// queries [group * QG, group * QG + QG) against candidates [tile * kTileN,
// tile * kTileN + kTileN). Shared memory: the group's [QG, M, K] tables.
template <int M8, int W>
__global__ void __launch_bounds__(kTileThreads, kMinBlocks)
pq_tiled_kernel(const float* __restrict__ lut,
                const uint8_t* __restrict__ codes,
                const uint8_t* __restrict__ valid, float* __restrict__ out,
                int B, int K, long long N, int Bc, int Bv, int QG,
                int tiles, int units) {
  constexpr int M = 8 * M8;
  extern __shared__ __align__(16) float tables_s[];
  // units / grid a block, the first units % grid blocks one more
  const int share = units / (int)gridDim.x, extra = units % (int)gridDim.x;
  const int blk = blockIdx.x;
  int u = blk * share + min(blk, extra);
  const int u_end = u + share + (blk < extra ? 1 : 0);
  const uint32_t kmask = (uint32_t)K - 1u;
  const uint32_t high = 0x01010101u * (~kmask & 0xffu);  // bits of codes >= K
  const float nan = __int_as_float(0x7fc00000);
  int group = -1;

  auto unit_at = [&](int uu, int& g, long long& n0) {
    g = uu / tiles;
    n0 = (long long)(uu - g * tiles) * kTileN + kPer * threadIdx.x;
  };
  int g_cur;
  long long n_cur;
  Fetch<M8> cur, nxt;
  if (u < u_end) {
    unit_at(u, g_cur, n_cur);
    fetch<M8, W>(cur, codes, valid, N, n_cur, Bc == 1 ? 0 : g_cur,
                 Bv == 1 ? 0 : g_cur * QG);
  }
  for (; u < u_end; ++u) {
    int g_nxt = g_cur;
    long long n_nxt = n_cur;
    if (u + 1 < u_end) {         // the next unit's loads, in flight now
      unit_at(u + 1, g_nxt, n_nxt);
      fetch<M8, W>(nxt, codes, valid, N, n_nxt, Bc == 1 ? 0 : g_nxt,
                   Bv == 1 ? 0 : g_nxt * QG);
    }
    const int b0 = g_cur * QG, nq = min(QG, B - b0);
    if (g_cur != group) {        // stage the group's tables
      __syncthreads();           // the last group's lookups are done
      const float4* src =
          reinterpret_cast<const float4*>(lut + (long long)b0 * M * K);
      for (int e = threadIdx.x; e < nq * M * K / 4; e += kTileThreads)
        reinterpret_cast<float4*>(tables_s)[e] = __ldg(src + e);
      __syncthreads();
      group = g_cur;
    }
    if (n_cur < N) {
      // candidates with a code >= K score NaN
      uint32_t bad = 0u;
#pragma unroll
      for (int c = 0; c < kPer; ++c) {
        uint32_t any = 0u;
#pragma unroll
        for (int i = 0; i < 2 * M8; ++i) any |= cur.w[c * 2 * M8 + i];
        bad |= ((any & high) != 0u ? 1u : 0u) << c;
      }
      uint32_t vmask = cur.valid;
      for (int qi = 0; qi < nq; ++qi) {
        const int b = b0 + qi;
        if (qi > 0 && Bv != 1)   // this query's own valid row
          vmask = valid_bytes<W>(valid, N, n_cur, b);
        const float* tab = tables_s + qi * M * K;
        float acc[kPer];
#pragma unroll
        for (int c = 0; c < kPer; ++c) {
          acc[c] = 0.f;
#pragma unroll
          for (int m = 0; m < M; ++m) {
            const uint32_t code =
                (cur.w[c * 2 * M8 + m / 4] >> (8 * (m % 4))) & kmask;
            acc[c] += tab[m * K + code];
          }
          if ((bad >> c) & 1u) acc[c] = nan;
          if (((vmask >> (8 * c)) & 0xffu) == 0u) acc[c] = -INFINITY;
        }
        float* o = out + (long long)b * N + n_cur;
        if constexpr (W == 4) {
          *reinterpret_cast<float4*>(o) =
              make_float4(acc[0], acc[1], acc[2], acc[3]);
        } else {
#pragma unroll
          for (int c = 0; c < kPer; ++c)
            if (n_cur + c < N) o[c] = acc[c];
        }
      }
    }
    cur = nxt;
    g_cur = g_nxt;
    n_cur = n_nxt;
  }
}

template <int M8, int W>
int launch_tiled(const float* lut, const uint8_t* codes, const uint8_t* valid,
                 float* out, int B, int K, long long N, int Bc, int Bv,
                 int QG, cudaStream_t stream) {
  constexpr int M = 8 * M8;
  const long long groups = Bc == 1 ? (B + QG - 1) / QG : B;
  const long long tiles = (N + kTileN - 1) / kTileN;
  const long long units = groups * tiles;
  const int smem = 4 * QG * M * K;
  if (smem > kMaxSmem || units > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  if (units == 0) return (int)cudaSuccess;
  auto kernel = pq_tiled_kernel<M8, W>;
  cudaError_t err;
  if (smem > 48 * 1024 &&
      (err = cudaFuncSetAttribute(
           kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem))
          != cudaSuccess)
    return (int)err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, kernel, kTileThreads, smem)) != cudaSuccess)
    return (int)err;
  if (per_sm == 0) return (int)cudaErrorInvalidConfiguration;
  const long long slots = (long long)sms * per_sm;
  const long long grid = units < slots ? units : slots;
  kernel<<<(unsigned)grid, kTileThreads, smem, stream>>>(
      lut, codes, valid, out, B, K, N, Bc, Bv, QG, (int)tiles, (int)units);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------- general scan

// Table entry c of a row of K, numpy-style: c < 0 counts from the end, and
// a code outside [-K, K) reads NaN (from an in-bounds address).
__device__ __forceinline__ float lookup(const float* row, int c, int K) {
  if (c < 0) c += K;
  const float v = row[min(max(c, 0), K - 1)];
  return (c >= 0 && c < K) ? v : __int_as_float(0x7fc00000);
}

template <typename C, bool kVec8>
__global__ void __launch_bounds__(kThreads)
pq_lut_scores_kernel(const float* __restrict__ lut, const C* __restrict__ codes,
                     const uint8_t* __restrict__ valid, float* __restrict__ out,
                     int B, int M, int K, long long N, int Bc, int Bv,
                     long long n_blocks) {
  extern __shared__ float lut_s[];            // [M * K]
  const int b = (int)(blockIdx.x / n_blocks);
  const long long n = (blockIdx.x % n_blocks) * kThreads + threadIdx.x;
  const float* lut_b = lut + (long long)b * M * K;
  for (int e = threadIdx.x; e < M * K; e += kThreads) lut_s[e] = lut_b[e];
  __syncthreads();
  if (n >= N) return;

  const long long bc = Bc == 1 ? 0 : b;
  const C* row = codes + (bc * N + n) * M;
  float acc = 0.f;
  if constexpr (kVec8) {                      // uint8, M % 8 == 0, aligned
    for (int m0 = 0; m0 < M; m0 += 8) {
      const uint2 w = *reinterpret_cast<const uint2*>(row + m0);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const uint32_t word = j < 4 ? w.x : w.y;
        const int c = (word >> (8 * (j & 3))) & 0xff;
        acc += lookup(lut_s + (m0 + j) * K, c, K);
      }
    }
  } else {
    for (int m = 0; m < M; ++m) acc += lookup(lut_s + m * K, (int)row[m], K);
  }
  if (valid != nullptr) {
    const long long bv = Bv == 1 ? 0 : b;
    if (valid[bv * N + n] == 0) acc = -INFINITY;
  }
  out[(long long)b * N + n] = acc;
}

template <typename C, bool kVec8>
int launch(const float* lut, const void* codes, const uint8_t* valid,
           float* out, int B, int M, int K, long long N, int Bc, int Bv,
           cudaStream_t stream) {
  const size_t smem = sizeof(float) * (size_t)M * K;
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        pq_lut_scores_kernel<C, kVec8>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const long long n_blocks = (N + kThreads - 1) / kThreads;
  const long long blocks = n_blocks * B;
  if (blocks == 0) return (int)cudaSuccess;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  pq_lut_scores_kernel<C, kVec8><<<(unsigned)blocks, kThreads, smem, stream>>>(
      lut, static_cast<const C*>(codes), valid, out, B, M, K, N, Bc, Bv,
      n_blocks);
  return (int)cudaGetLastError();
}

}  // namespace

// The tiled scan. uint8 codes; M in {8, 16}; K a power of two <= 256;
// codes 16-byte aligned; QG: queries a group (1 when Bc == B > 1); W: the
// vector width, 4 (N % 4 == 0, valid 4-byte aligned) or 1. valid may be
// null. Returns the cudaError_t of the launch (0 on success).
extern "C" int pq_lut_scores(const void* lut, const void* codes,
                             const void* valid, void* out, int B, int M,
                             int K, long long N, int Bc, int Bv, int QG,
                             int W, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lut);
  const uint8_t* c = static_cast<const uint8_t*>(codes);
  const uint8_t* v = static_cast<const uint8_t*>(valid);
  float* o = static_cast<float*>(out);
  const bool ok =
      K >= 1 && K <= 256 && (K & (K - 1)) == 0 && QG >= 1 && QG <= B &&
      (Bc == 1 || QG == 1) && reinterpret_cast<uintptr_t>(codes) % 16 == 0 &&
      (W == 1 || (W == 4 && N % 4 == 0 &&
                  reinterpret_cast<uintptr_t>(valid) % 4 == 0));
  if (!ok) return (int)cudaErrorInvalidValue;
  if (M == 8 && W == 4)
    return launch_tiled<1, 4>(l, c, v, o, B, K, N, Bc, Bv, QG, s);
  if (M == 8 && W == 1)
    return launch_tiled<1, 1>(l, c, v, o, B, K, N, Bc, Bv, QG, s);
  if (M == 16 && W == 4)
    return launch_tiled<2, 4>(l, c, v, o, B, K, N, Bc, Bv, QG, s);
  if (M == 16 && W == 1)
    return launch_tiled<2, 1>(l, c, v, o, B, K, N, Bc, Bv, QG, s);
  return (int)cudaErrorInvalidValue;
}

// The general scan. code_bytes: 1 = uint8 codes, 4 = int32 codes. valid
// may be null. Returns the cudaError_t of the launch (0 on success).
extern "C" int pq_lut_scores_general(const void* lut, const void* codes,
                                     const void* valid, void* out, int B,
                                     int M, int K, long long N, int Bc,
                                     int Bv, int code_bytes, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lut);
  const uint8_t* v = static_cast<const uint8_t*>(valid);
  float* o = static_cast<float*>(out);
  if (code_bytes == 1) {
    const bool vec8 = M % 8 == 0 && reinterpret_cast<uintptr_t>(codes) % 8 == 0;
    if (vec8) return launch<uint8_t, true>(l, codes, v, o, B, M, K, N, Bc, Bv, s);
    return launch<uint8_t, false>(l, codes, v, o, B, M, K, N, Bc, Bv, s);
  }
  if (code_bytes == 4)
    return launch<int32_t, false>(l, codes, v, o, B, M, K, N, Bc, Bv, s);
  return (int)cudaErrorInvalidValue;
}
