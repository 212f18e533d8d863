// BusLM segment + bus attention, forward and backward: the SIMT route, for
// the shapes the tensor-core kernels (bus_attention.cu) do not take.
//
// Same contract as bus_attention.cu, which replaces the Pallas TPU kernels
// src/repro/kernels/bus_attention.py (bus_attention / _fwd_kernel and
// bus_attention_bwd / _bwd_kernel). For every (news m, segment kk, head h):
//   s[i, t] = <q[i], k[t]> * D^-1/2, or -1e30 where kv_mask[m, kk, t] is 0
//   p       = exp(s - rowmax(s)) / max(rowsum, 1e-30)        (f32)
//   o[i]    = sum_t p[i, t] * v[t]           (written in the input dtype)
// over Sk = S + K keys (the segment's S tokens plus the K bus proxies).
// A row whose keys are all masked averages v uniformly over exactly Sk
// keys, as the TPU kernel does: the loops run over exactly Sk columns, so
// no padding column ever enters the softmax.
//
// The backward recomputes p with the forward's exact arithmetic (no
// residual besides q/k/v is stored) and writes, in one pass per tile,
//   dv = p^T do,  dp = do v^T,  delta = rowsum(p * dp),
//   ds = (mask ? p * (dp - delta) : 0) * scale,  dq = ds k,  dk = ds^T q.
// Each tile owns its dk/dv rows, so there are no atomics. dv is nonzero on
// the masked keys of a fully masked segment (p is uniform there).
//
// Layouts (contiguous): q/o/do/dq [M, K, S, H, D]; k/v/dk/dv
// [M, K, Sk, H, D]; mask [M, K, Sk] bytes (torch.bool). Shapes taken: any
// whose tile fits in a block's shared memory (checked at launch), at any
// alignment. kernels/bus_attention.py:bus_route sends a shape here when
// the tensor-core kernels do not take it: a head dim outside {16, 32, 64,
// 128}, more than 32 queries or 40 keys a segment. No SpeedyFeed bucket
// (S in {8, 16, 24, 32}, Sk = S + 3, D = 64) comes here.
//
// The design: one block of 128 threads per (m, kk, h) tile stages its
// operands in shared memory (the k and, in the backward, v rows padded by
// one column so the column-parallel score loops do not conflict on
// banks), keeps the [S, Sk] probabilities there, and reads every input
// byte once and writes every output byte once. It loads a tile, then
// computes; every FMA reads both operands from shared memory, so the rate
// of shared-memory loads bounds it (5-7x the byte bound at the serve shape
// on an H100; PERF.md).
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr float kNegInf = -1e30f;

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

template <typename T>
__global__ void __launch_bounds__(kThreads)
bus_attention_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v,
                         const uint8_t* __restrict__ mask, T* __restrict__ o,
                         int K, int S, int Sk, int H, int D, float scale) {
  extern __shared__ float smem[];
  const int Dk = D + 1;                       // padded k row
  float* q_s = smem;                          // [S][D]
  float* k_s = q_s + S * D;                   // [Sk][D + 1]
  float* v_s = k_s + Sk * Dk;                 // [Sk][D]
  float* p_s = v_s + Sk * D;                  // [S][Sk]
  uint8_t* m_s = reinterpret_cast<uint8_t*>(p_s + S * Sk);   // [Sk]

  const int h = blockIdx.x % H;
  const long long mk = blockIdx.x / H;        // m * K + kk
  const long long HD = (long long)H * D;
  const T* q_g = q + mk * S * HD + (long long)h * D;
  const T* k_g = k + mk * Sk * HD + (long long)h * D;
  const T* v_g = v + mk * Sk * HD + (long long)h * D;
  T* o_g = o + mk * S * HD + (long long)h * D;
  const int tid = threadIdx.x;

  for (int e = tid; e < S * D; e += kThreads) {
    const int i = e / D, d = e - i * D;
    q_s[e] = to_f32(q_g[i * HD + d]);
  }
  for (int e = tid; e < Sk * D; e += kThreads) {
    const int t = e / D, d = e - t * D;
    k_s[t * Dk + d] = to_f32(k_g[t * HD + d]);
    v_s[e] = to_f32(v_g[t * HD + d]);
  }
  for (int t = tid; t < Sk; t += kThreads) m_s[t] = mask[mk * Sk + t];
  __syncthreads();

  // scores, scaled then masked (the TPU kernel's order of operations)
  for (int e = tid; e < S * Sk; e += kThreads) {
    const int i = e / Sk, t = e - i * Sk;
    const float* qr = q_s + i * D;
    const float* kr = k_s + t * Dk;
    float acc = 0.f;
    for (int d = 0; d < D; ++d) acc = fmaf(qr[d], kr[d], acc);
    p_s[e] = m_s[t] ? acc * scale : kNegInf;
  }
  __syncthreads();

  // row softmax: one warp per row, max-subtracted, l = max(sum, 1e-30)
  const int warp = tid >> 5, lane = tid & 31;
  for (int i = warp; i < S; i += kThreads / 32) {
    float* row = p_s + i * Sk;
    float mx = kNegInf;
    for (int t = lane; t < Sk; t += 32) mx = fmaxf(mx, row[t]);
    for (int off = 16; off > 0; off >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    float sum = 0.f;
    for (int t = lane; t < Sk; t += 32) {
      const float e = expf(row[t] - mx);
      row[t] = e;
      sum += e;
    }
    for (int off = 16; off > 0; off >>= 1)
      sum += __shfl_xor_sync(0xffffffffu, sum, off);
    const float inv = 1.f / fmaxf(sum, 1e-30f);
    for (int t = lane; t < Sk; t += 32) row[t] *= inv;
  }
  __syncthreads();

  // o = p @ v, one output element per thread step, stored along D
  for (int e = tid; e < S * D; e += kThreads) {
    const int i = e / D, d = e - i * D;
    const float* pr = p_s + i * Sk;
    float acc = 0.f;
    for (int t = 0; t < Sk; ++t) acc = fmaf(pr[t], v_s[t * D + d], acc);
    o_g[i * HD + d] = from_f32<T>(acc);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
bus_attention_bwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v,
                         const uint8_t* __restrict__ mask,
                         const T* __restrict__ dout, T* __restrict__ dq,
                         T* __restrict__ dk, T* __restrict__ dv,
                         int K, int S, int Sk, int H, int D, float scale) {
  extern __shared__ float smem[];
  const int Dp = D + 1;                       // padded k/v rows
  float* q_s = smem;                          // [S][D]
  float* do_s = q_s + S * D;                  // [S][D]
  float* k_s = do_s + S * D;                  // [Sk][D + 1]
  float* v_s = k_s + Sk * Dp;                 // [Sk][D + 1]
  float* p_s = v_s + Sk * Dp;                 // [S][Sk]
  float* ds_s = p_s + S * Sk;                 // [S][Sk]: dp, then ds
  uint8_t* m_s = reinterpret_cast<uint8_t*>(ds_s + S * Sk);  // [Sk]

  const int h = blockIdx.x % H;
  const long long mk = blockIdx.x / H;        // m * K + kk
  const long long HD = (long long)H * D;
  const long long q_off = mk * S * HD + (long long)h * D;
  const long long k_off = mk * Sk * HD + (long long)h * D;
  const int tid = threadIdx.x;

  for (int e = tid; e < S * D; e += kThreads) {
    const int i = e / D, d = e - i * D;
    q_s[e] = to_f32(q[q_off + i * HD + d]);
    do_s[e] = to_f32(dout[q_off + i * HD + d]);
  }
  for (int e = tid; e < Sk * D; e += kThreads) {
    const int t = e / D, d = e - t * D;
    k_s[t * Dp + d] = to_f32(k[k_off + t * HD + d]);
    v_s[t * Dp + d] = to_f32(v[k_off + t * HD + d]);
  }
  for (int t = tid; t < Sk; t += kThreads) m_s[t] = mask[mk * Sk + t];
  __syncthreads();

  // scores (scaled then masked) and dp = do v^T, the forward's order
  for (int e = tid; e < S * Sk; e += kThreads) {
    const int i = e / Sk, t = e - i * Sk;
    const float* qr = q_s + i * D;
    const float* dr = do_s + i * D;
    const float* kr = k_s + t * Dp;
    const float* vr = v_s + t * Dp;
    float acc = 0.f, dacc = 0.f;
    for (int d = 0; d < D; ++d) {
      acc = fmaf(qr[d], kr[d], acc);
      dacc = fmaf(dr[d], vr[d], dacc);
    }
    p_s[e] = m_s[t] ? acc * scale : kNegInf;
    ds_s[e] = dacc;
  }
  __syncthreads();

  // row softmax as in the forward, then delta = rowsum(p * dp) and ds
  const int warp = tid >> 5, lane = tid & 31;
  for (int i = warp; i < S; i += kThreads / 32) {
    float* row = p_s + i * Sk;
    float* drow = ds_s + i * Sk;
    float mx = kNegInf;
    for (int t = lane; t < Sk; t += 32) mx = fmaxf(mx, row[t]);
    for (int off = 16; off > 0; off >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    float sum = 0.f;
    for (int t = lane; t < Sk; t += 32) {
      const float e = expf(row[t] - mx);
      row[t] = e;
      sum += e;
    }
    for (int off = 16; off > 0; off >>= 1)
      sum += __shfl_xor_sync(0xffffffffu, sum, off);
    const float inv = 1.f / fmaxf(sum, 1e-30f);
    float delta = 0.f;
    for (int t = lane; t < Sk; t += 32) {
      const float p = row[t] * inv;
      row[t] = p;
      delta = fmaf(p, drow[t], delta);
    }
    for (int off = 16; off > 0; off >>= 1)
      delta += __shfl_xor_sync(0xffffffffu, delta, off);
    for (int t = lane; t < Sk; t += 32)
      drow[t] = m_s[t] ? row[t] * (drow[t] - delta) * scale : 0.f;
  }
  __syncthreads();

  // dq = ds k  (S x D)
  for (int e = tid; e < S * D; e += kThreads) {
    const int i = e / D, d = e - i * D;
    const float* sr = ds_s + i * Sk;
    float acc = 0.f;
    for (int t = 0; t < Sk; ++t) acc = fmaf(sr[t], k_s[t * Dp + d], acc);
    dq[q_off + i * HD + d] = from_f32<T>(acc);
  }
  // dk = ds^T q and dv = p^T do  (Sk x D each)
  for (int e = tid; e < Sk * D; e += kThreads) {
    const int t = e / D, d = e - t * D;
    float kacc = 0.f, vacc = 0.f;
    for (int i = 0; i < S; ++i) {
      kacc = fmaf(ds_s[i * Sk + t], q_s[i * D + d], kacc);
      vacc = fmaf(p_s[i * Sk + t], do_s[i * D + d], vacc);
    }
    dk[k_off + t * HD + d] = from_f32<T>(kacc);
    dv[k_off + t * HD + d] = from_f32<T>(vacc);
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* mask,
           void* o, int M, int K, int S, int Sk, int H, int D, float scale,
           cudaStream_t stream) {
  const size_t smem = sizeof(float) * ((size_t)S * D + (size_t)Sk * (D + 1)
                                       + (size_t)Sk * D + (size_t)S * Sk)
                      + (size_t)Sk;
  if (smem > 232448) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        bus_attention_fwd_kernel<T>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const long long blocks = (long long)M * K * H;
  if (blocks == 0) return (int)cudaSuccess;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  bus_attention_fwd_kernel<T><<<(unsigned)blocks, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const uint8_t*>(mask),
      static_cast<T*>(o), K, S, Sk, H, D, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_bwd(const void* q, const void* k, const void* v, const void* mask,
               const void* dout, void* dq, void* dk, void* dv, int M, int K,
               int S, int Sk, int H, int D, float scale,
               cudaStream_t stream) {
  const size_t smem = sizeof(float) * (2 * (size_t)S * D
                                       + 2 * (size_t)Sk * (D + 1)
                                       + 2 * (size_t)S * Sk)
                      + (size_t)Sk;
  if (smem > 232448) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        bus_attention_bwd_kernel<T>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const long long blocks = (long long)M * K * H;
  if (blocks == 0) return (int)cudaSuccess;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  bus_attention_bwd_kernel<T><<<(unsigned)blocks, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const uint8_t*>(mask),
      static_cast<const T*>(dout), static_cast<T*>(dq), static_cast<T*>(dk),
      static_cast<T*>(dv), K, S, Sk, H, D, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, 2 = float16. Returns the cudaError_t
// of the launch (0 on success).
extern "C" int bus_attention_fwd_simt(const void* q, const void* k,
                                      const void* v, const void* mask,
                                      void* o, int M, int K, int S, int Sk,
                                      int H, int D, int dtype, float scale,
                                      void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch<float>(q, k, v, mask, o, M, K, S, Sk, H, D, scale, s);
    case 1: return launch<__nv_bfloat16>(q, k, v, mask, o, M, K, S, Sk, H, D, scale, s);
    case 2: return launch<__half>(q, k, v, mask, o, M, K, S, Sk, H, D, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The backward: dq/dk/dv for do, same dtype codes and return value.
extern "C" int bus_attention_bwd_simt(const void* q, const void* k,
                                      const void* v, const void* mask,
                                      const void* dout, void* dq, void* dk,
                                      void* dv, int M, int K, int S, int Sk,
                                      int H, int D, int dtype, float scale,
                                      void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch_bwd<float>(q, k, v, mask, dout, dq, dk, dv, M, K, S, Sk,
                               H, D, scale, s);
    case 1:
      return launch_bwd<__nv_bfloat16>(q, k, v, mask, dout, dq, dk, dv, M, K,
                                       S, Sk, H, D, scale, s);
    case 2:
      return launch_bwd<__half>(q, k, v, mask, dout, dq, dk, dv, M, K, S, Sk,
                                H, D, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
