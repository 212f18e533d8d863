// Fused EmbeddingBag (gather plus weighted sum) for Hopper (sm_90a), and
// its gradient with respect to the table.
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
//
// The backward (embedding_bag_bwd) has no Pallas counterpart: the Pallas
// kernel has no VJP, and the JAX package trains through XLA's jnp.take,
// whose transpose is a scatter-add into a dense [V, d] gradient:
//   g[r, :] = sum over slots (bag, n) with idx == r of w[bag, n] * dout[bag, :]
// (a negative index counting from the end; a slot outside [-V, V) adds
// nothing, as jax.vjp of the take gives; rows no slot names stay 0). Sums
// in f32, rounded once to the table's dtype. It repeats bit for bit: no
// float atomics. The caller (the wrapper) gives each slot its row as a key
// (embedding_bag_bwd_keys: the index rules, V for a dropped slot) and
// sorts the keys stably, so each row's slots form one run in slot order.
// The sorted slots are cut into fixed chunks of `chunk` slots (the
// wrapper's BWD_CHUNK, 32). Pass 1 gives each
// chunk a group of lanes that walks its slots in order, summing each run's
// w * dout; a run that lies wholly in the chunk is written to its row, and
// the chunk's first or last run, where it crosses the chunk's edge, goes to
// a scratch of two partial rows a chunk. Pass 2 lets the chunk where such a
// run begins add the partials of the chunks it covers, in chunk order, and
// write the row. So a hot row (Criteo's 4-row fields: about 16,384 slots a
// row at B = 65,536) spreads over 512 chunks in pass 1 instead of one warp,
// and every sum is taken in one fixed order. What bounds it: writing the
// dense gradient (8.4 GB for DLRM-RM2), which the wrapper zeroes before
// the passes write the rows that slots name; the passes read dout once a
// slot and the keys, the sort's permutation and the weights once.
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


__global__ void __launch_bounds__(kThreads)
ebag_bwd_keys_kernel(const int* __restrict__ idx, int* __restrict__ keys,
                     long long n, long long V) {
  const long long t = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (t >= n) return;
  long long i = idx[t];
  if (i < 0) i += V;
  keys[t] = (i < 0 || i >= V) ? (int)V : (int)i;   // V: dropped, sorts last
}

template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
ebag_bwd_chunk_kernel(const int* __restrict__ sk,
                      const long long* __restrict__ perm,
                      const T* __restrict__ dout, const float* __restrict__ w,
                      T* __restrict__ grad, float* __restrict__ part,
                      long long n, long long V, int d, int nnz, int chunk,
                      int lanes_log2) {
  const long long t = (long long)blockIdx.x * kThreads + threadIdx.x;
  const long long c = t >> lanes_log2;
  const int lane = (int)(t & ((1 << lanes_log2) - 1));
  if (c * chunk >= n) return;
  const long long s0 = c * chunk;
  const long long s1 = s0 + chunk < n ? s0 + chunk : n;
  const int prev = s0 > 0 ? sk[s0 - 1] : -1;       // the run before the chunk
  const int next = s1 < n ? sk[s1] : -1;           // the run after it
  float* head = part + 2 * c * d;   // the first run, begun in an earlier chunk
  float* tail = head + d;           // the last run, going on past the chunk
  const int stride = VEC << lanes_log2;
  for (int col = lane * VEC; col < d; col += stride) {
    long long i = s0;
    while (i < s1) {
      const int r = sk[i];
      if (r >= V) break;                 // dropped slots (key V) sort last
      const long long a = i;
      float acc[VEC];
#pragma unroll
      for (int j = 0; j < VEC; ++j) acc[j] = 0.f;
      for (; i < s1 && sk[i] == r; ++i) {
        // n < 2^31 (the wrapper checks): a 32-bit division, not a call
        const unsigned s = (unsigned)perm[i];
        const float wt = w != nullptr ? w[s] : 1.f;
        float v[VEC];
        load<VEC>(dout + (long long)(s / (unsigned)nnz) * d + col, v);
#pragma unroll
        for (int j = 0; j < VEC; ++j)
          acc[j] = __fadd_rn(acc[j], __fmul_rn(wt, v[j]));
      }
      const bool starts = a > s0 || prev != r;
      const bool ends = i < s1 || next != r;
      if (starts && ends)
        store<VEC>(grad + (long long)r * d + col, acc);
      else
        store<VEC>((starts ? tail : head) + col, acc);
    }
  }
}

template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
ebag_bwd_combine_kernel(const int* __restrict__ sk,
                        const float* __restrict__ part, T* __restrict__ grad,
                        long long n, long long V, int d, int chunk,
                        int lanes_log2) {
  const long long t = (long long)blockIdx.x * kThreads + threadIdx.x;
  const long long c = t >> lanes_log2;
  const int lane = (int)(t & ((1 << lanes_log2) - 1));
  const long long s0 = c * chunk;
  if (s0 + chunk >= n) return;              // the last chunk: nothing after
  const long long s1 = s0 + chunk;
  const int r = sk[s1 - 1];
  if (r >= V || sk[s1] != r) return;        // the last run ends here
  if (s0 > 0 && sk[s0] == r && sk[s0 - 1] == r) return;  // begun earlier
  // the run's end: the first sorted slot past r (the key V bounds it)
  long long lo = s1, hi = n;
  while (lo < hi) {
    const long long mid = (lo + hi) >> 1;
    if (sk[mid] <= r) lo = mid + 1; else hi = mid;
  }
  // the chunk of its last slot (n < 2^31: a 32-bit division, not a call)
  const long long last = (unsigned)(lo - 1) / (unsigned)chunk;
  const int stride = VEC << lanes_log2;
  for (int col = lane * VEC; col < d; col += stride) {
    float acc[VEC];
    load<VEC>(part + (2 * c + 1) * d + col, acc);
#pragma unroll 4
    for (long long j = c + 1; j <= last; ++j) {
      float v[VEC];
      load<VEC>(part + 2 * j * d + col, v);
#pragma unroll
      for (int k = 0; k < VEC; ++k) acc[k] = __fadd_rn(acc[k], v[k]);
    }
    store<VEC>(grad + (long long)r * d + col, acc);
  }
}

template <typename T, int VEC>
int launch_bwd(const void* sk, const void* perm, const void* dout,
               const void* w, void* grad, void* part, long long n,
               long long V, int d, int nnz, int chunk, cudaStream_t stream) {
  int lanes_log2 = 0;
  while ((1 << lanes_log2) * VEC < d && lanes_log2 < 5) ++lanes_log2;
  const long long chunks = (n + chunk - 1) / chunk;
  const long long blocks = ((chunks << lanes_log2) + kThreads - 1) / kThreads;
  if (blocks == 0) return (int)cudaSuccess;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const int* keys = static_cast<const int*>(sk);
  float* partial = static_cast<float*>(part);
  ebag_bwd_chunk_kernel<T, VEC><<<(unsigned)blocks, kThreads, 0, stream>>>(
      keys, static_cast<const long long*>(perm), static_cast<const T*>(dout),
      static_cast<const float*>(w), static_cast<T*>(grad), partial, n, V, d,
      nnz, chunk, lanes_log2);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  ebag_bwd_combine_kernel<T, VEC><<<(unsigned)blocks, kThreads, 0, stream>>>(
      keys, partial, static_cast<T*>(grad), n, V, d, chunk, lanes_log2);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_bwd(const void* sk, const void* perm, const void* dout,
                 const void* w, void* grad, void* part, long long n,
                 long long V, int d, int nnz, int chunk,
                 cudaStream_t stream) {
  const uintptr_t align = 4 * sizeof(T);
  const bool vec4 = d % 4 == 0 &&
                    reinterpret_cast<uintptr_t>(dout) % align == 0 &&
                    reinterpret_cast<uintptr_t>(grad) % align == 0 &&
                    reinterpret_cast<uintptr_t>(part) % 16 == 0;
  if (vec4)
    return launch_bwd<T, 4>(sk, perm, dout, w, grad, part, n, V, d, nnz,
                            chunk, stream);
  return launch_bwd<T, 1>(sk, perm, dout, w, grad, part, n, V, d, nnz,
                          chunk, stream);
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

// The backward's keys: keys[s] = the row slot s names (a negative index
// counting from the end), or V where the index lies outside [-V, V).
// V < 2^31. Returns the cudaError_t of the launch.
extern "C" int embedding_bag_bwd_keys(const void* idx, void* keys,
                                      long long n, long long V,
                                      void* stream) {
  if (V <= 0 || V > 0x7fffffffLL || n < 0) return (int)cudaErrorInvalidValue;
  const long long blocks = (n + kThreads - 1) / kThreads;
  if (blocks == 0) return (int)cudaSuccess;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  ebag_bwd_keys_kernel<<<(unsigned)blocks, kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(idx), static_cast<int*>(keys), n, V);
  return (int)cudaGetLastError();
}

// The backward's two passes over the stably sorted keys (n < 2^31
// slots; sorted_keys [n] int32, perm [n] int64: each sorted position's slot b * F * nnz + f * nnz
// + n), dout [n / nnz, d] and grad [V, d] in one dtype (0 = float32, 1 =
// bfloat16), weights [n] f32 or null, chunk the sorted slots a chunk,
// partial: 2 * ceil(n / chunk) * d f32 of scratch. grad must hold zeros:
// the passes write only the rows that slots name. Returns the
// cudaError_t of the launches.
extern "C" int embedding_bag_bwd(const void* sorted_keys, const void* perm,
                                 const void* dout, const void* weights,
                                 void* grad, void* partial, long long n,
                                 long long V, int d, int nnz, int chunk,
                                 int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d <= 0 || nnz <= 0 || chunk <= 0 || n < 0 || n > 0x7fffffffLL ||
      V <= 0 || V > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return dispatch_bwd<float>(sorted_keys, perm, dout, weights, grad,
                               partial, n, V, d, nnz, chunk, s);
  if (dtype == 1)
    return dispatch_bwd<__nv_bfloat16>(sorted_keys, perm, dout, weights,
                                       grad, partial, n, V, d, nnz, chunk,
                                       s);
  return (int)cudaErrorInvalidValue;
}
