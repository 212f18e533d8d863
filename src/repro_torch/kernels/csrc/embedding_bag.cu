// Fused EmbeddingBag (gather plus weighted sum) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/embedding_bag.py
// (embedding_bag / _kernel):
//   out[bag, :] = sum_n w[bag, n] * table[idx[bag, n], :]
// for bag = b * F + f, with w == nullptr meaning all ones. The sum is
// taken in f32 (each product rounded, then added in order n = 0, 1, ...,
// as the plain version's multiply-then-sum does) and rounded once to the
// table's dtype. An index counts from the end when negative; an index
// outside [-V, V) makes its whole bag NaN, even where its weight is 0,
// as the JAX reference's jnp.take does. The table read itself stays in
// bounds. Row offsets are 64-bit: DLRM-RM2's fused table has 2.09e9
// elements, 8.4e9 bytes.
//
// Layouts (contiguous): table [V, d] f32 or bf16; idx [n_bags, nnz] int32;
// w [n_bags, nnz] f32 or null; out [n_bags, d] in the table's dtype.
//
// What bounds it on the H100: device memory. Each bag reads nnz rows of
// d elements at addresses that come from data, and the work is one FMA
// per element: it must move each distinct row it gathers once (a row
// below 32 B still costs one 32 B sector; a row that many bags name, as
// in Criteo's small fields, can come back from L2), the index and weight
// bytes, and the output once. The design: a group of L lanes per bag, L the power of two
// that covers the row in 16-byte (f32) or 8-byte (bf16) vectors (L = 16 at
// d = 64 f32, so a warp gathers two rows per step), capped at 32 lanes,
// which then loop over the row. Each lane keeps a 4-wide f32 accumulator
// in registers and writes its slice of the output once. A row width that
// is not a multiple of 4 (the Wide&Deep wide table has d = 1) takes the
// scalar path: one element per lane, so at d = 1 a warp sums 32 bags. No
// shared memory: the TPU kernel's scalar-prefetched index stream becomes
// each lane's own index load (the lanes of a bag read the same word, one
// transaction), and enough bags are in flight to cover the gather latency.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

template <int VEC>
__device__ __forceinline__ void load(const float* p, float (&v)[VEC]) {
  if constexpr (VEC == 4) {
    const float4 x = *reinterpret_cast<const float4*>(p);
    v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
  } else {
    v[0] = *p;
  }
}

template <int VEC>
__device__ __forceinline__ void load(const __nv_bfloat16* p, float (&v)[VEC]) {
  if constexpr (VEC == 4) {
    const uint2 x = *reinterpret_cast<const uint2*>(p);
    const float2 a = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&x.x));
    const float2 b = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&x.y));
    v[0] = a.x; v[1] = a.y; v[2] = b.x; v[3] = b.y;
  } else {
    v[0] = __bfloat162float(*p);
  }
}

template <int VEC>
__device__ __forceinline__ void store(float* p, const float (&v)[VEC]) {
  if constexpr (VEC == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
    *p = v[0];
  }
}

template <int VEC>
__device__ __forceinline__ void store(__nv_bfloat16* p, const float (&v)[VEC]) {
#pragma unroll
  for (int j = 0; j < VEC; ++j) p[j] = __float2bfloat16_rn(v[j]);
}

template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
embedding_bag_kernel(const T* __restrict__ table, const int* __restrict__ idx,
                     const float* __restrict__ w, T* __restrict__ out,
                     long long V, int d, long long n_bags, int nnz,
                     int lanes_log2) {
  const long long t = (long long)blockIdx.x * kThreads + threadIdx.x;
  const long long bag = t >> lanes_log2;
  const int lane = (int)(t & ((1 << lanes_log2) - 1));
  if (bag >= n_bags) return;
  const int* ib = idx + bag * nnz;
  const float* wb = w != nullptr ? w + bag * nnz : nullptr;
  const int stride = VEC << lanes_log2;
  for (int c = lane * VEC; c < d; c += stride) {
    float acc[VEC];
#pragma unroll
    for (int j = 0; j < VEC; ++j) acc[j] = 0.f;
    bool bad = false;
    for (int n = 0; n < nnz; ++n) {
      long long i = ib[n];
      if (i < 0) i += V;
      if (i < 0 || i >= V) {                  // NaN bag; read nothing
        bad = true;
        continue;
      }
      const float wt = wb != nullptr ? wb[n] : 1.f;
      float v[VEC];
      load<VEC>(table + i * d + c, v);
#pragma unroll
      for (int j = 0; j < VEC; ++j)
        acc[j] = __fadd_rn(acc[j], __fmul_rn(wt, v[j]));
    }
    if (bad) {
#pragma unroll
      for (int j = 0; j < VEC; ++j) acc[j] = __int_as_float(0x7fc00000);
    }
    store<VEC>(out + bag * d + c, acc);
  }
}

template <typename T, int VEC>
int launch(const void* table, const void* idx, const void* w, void* out,
           long long V, int d, long long n_bags, int nnz,
           cudaStream_t stream) {
  // L lanes per bag: the power of two covering d / VEC, at most a warp
  int lanes_log2 = 0;
  while ((1 << lanes_log2) * VEC < d && lanes_log2 < 5) ++lanes_log2;
  const long long threads = n_bags << lanes_log2;
  const long long blocks = (threads + kThreads - 1) / kThreads;
  if (blocks == 0) return (int)cudaSuccess;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  embedding_bag_kernel<T, VEC><<<(unsigned)blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(table), static_cast<const int*>(idx),
      static_cast<const float*>(w), static_cast<T*>(out), V, d, n_bags, nnz,
      lanes_log2);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* table, const void* idx, const void* w, void* out,
             long long V, int d, long long n_bags, int nnz,
             cudaStream_t stream) {
  // 4-wide vectors need rows (and the output) aligned to 4 elements
  const uintptr_t align = 4 * sizeof(T);
  const bool vec4 = d % 4 == 0 &&
                    reinterpret_cast<uintptr_t>(table) % align == 0 &&
                    reinterpret_cast<uintptr_t>(out) % align == 0;
  if (vec4) return launch<T, 4>(table, idx, w, out, V, d, n_bags, nnz, stream);
  return launch<T, 1>(table, idx, w, out, V, d, n_bags, nnz, stream);
}

}  // namespace

// dtype: 0 = float32 table and output, 1 = bfloat16. weights may be null
// (all ones). Returns the cudaError_t of the launch (0 on success).
extern "C" int embedding_bag(const void* table, const void* idx,
                             const void* weights, void* out, long long V,
                             int d, long long n_bags, int nnz, int dtype,
                             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d <= 0 || nnz < 0 || V <= 0) return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return dispatch<float>(table, idx, weights, out, V, d, n_bags, nnz, s);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(table, idx, weights, out, V, d, n_bags,
                                   nnz, s);
  return (int)cudaErrorInvalidValue;
}
