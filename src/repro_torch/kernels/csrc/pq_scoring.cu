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
// What bounds it on the H100: bytes and launch latency. It reads B*N*M
// code bytes and writes B*N*4 score bytes; at the serve shape (B=16,
// M=8, N=nprobe*cap) that is a few MB, microseconds of memory time, so a
// launch costs as much as the work. The design: a 1-D grid over (query,
// block of candidates); each block stages its query's [M, K] table in
// shared memory (1 KB at M=8, K=32; the table must fit the 227 KB a block
// can hold, which the wrapper checks), then every thread
// scores one candidate: one 8-byte load per 8 uint8 codes, M lookups in
// shared memory, one coalesced store. The TPU's one-hot matrix-unit trick
// has no purpose here: shared-memory lookups are cheap on Hopper.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

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
  if (smem > 232448) return (int)cudaErrorInvalidValue;
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

// code_bytes: 1 = uint8 codes, 4 = int32 codes. valid may be null.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int pq_lut_scores(const void* lut, const void* codes,
                             const void* valid, void* out, int B, int M,
                             int K, long long N, int Bc, int Bv,
                             int code_bytes, void* stream) {
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
