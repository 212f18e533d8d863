// Flash attention forward (causal or not, GQA) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py
// (flash_attention_fwd / _fwd_kernel). For every (batch b, q-head h, query
// row i), with kv head h / G (G = Hq / Hkv) and scale = D^-1/2:
//   s[i, j] = <q[i], k[j]> * scale, or -1e30 where causal and
//             j > i + q_off (q_off = Sk - Sq: row i sits at key position
//             i + q_off)
//   online softmax over the key tiles in f32: m (running max), l (running
//   sum of exp(s - m)), acc (running sum of exp(s - m) v), rescaled by
//   exp(m_old - m_new) at each tile
//   o[i]   = acc / max(l, 1e-30)       (written in the input dtype)
//   lse[i] = m + log(max(l, 1e-30))    (f32, [B, Hq, Sq])
// The [Sq, Sk] scores never leave the block.
//
// Layouts: q/o [B, Sq, Hq, D] and k/v [B, Sk, Hkv, D], read and written
// through element strides for b, s and h (the D axis must be contiguous),
// so the wrapper needs no transposes. Inputs are float32 or bfloat16; all
// arithmetic is f32. D is a multiple of 16, at most 128.
//
// Threads and tiles: one block of 256 threads per (q tile of 64 rows, h,
// b). The loop over key tiles of 64 inside the block takes the place of
// the TPU's sequential grid dimension; in a causal call it stops at the
// last tile that meets the diagonal of the block's last row, so tiles
// above the diagonal are neither loaded nor computed. q tiles are issued
// in reverse so the longest causal rows start first. Thread (ty, tx) of a
// 16 x 16 layout owns rows ty + 16r (r < 4) of the tile: scores of columns
// tx + 16c (c < 4) and output columns tx + 16n (n < D/16), all in
// registers; the 16 threads of a row reduce its max and sum with warp
// shuffles. Shared memory holds the q tile, one k or v tile (k, then v in
// the same buffer) and the [64, 64] probabilities, in f32, rows padded by
// one word so the column-parallel reads do not conflict on banks: 82,688
// bytes at D=128, above the 48 KB default, so the launcher raises the
// limit with cudaFuncSetAttribute; two blocks fit on an SM.
//
// What bounds it on the H100: operations. At the LM prefill shape (B=1,
// S=32,768, Hq=40, Hkv=8, D=128, causal, bf16) a call does 1.10e13 FLOP
// (4 * D per visible (query, key) pair): 11.1 ms at the bf16 tensor-core
// peak of 989 TFLOP/s, against 0.24 ms for its ~810 MB of q/k/v/o/lse.
// This kernel runs the products on the CUDA cores in f32 (register tiles
// of 4 x 4 scores and 4 x D/16 outputs per thread: 2 to 2.7 FMAs per
// shared-memory load), so its ceiling is the 67 TFLOP/s f32 rate, 15x short
// of the bound; wgmma on bf16 tiles fed by TMA is the next step.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;          // query rows per block
constexpr int kBK = 64;          // keys per tile
constexpr int kThreads = 256;    // 16 x 16
constexpr int kPS = kBK + 1;     // padded row of the probability tile
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// rows [r0, r0 + rows) of a [*, D] tensor with row stride `rs` (elements)
// into a [rows][D + 1] f32 tile; rows at or past `n` read as 0
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, const T* src, long long rs,
                                          int r0, int rows, int n) {
  constexpr int DP = D + 1;
  for (int e = threadIdx.x; e < rows * D; e += kThreads) {
    const int i = e / D, d = e - i * D;
    const int r = r0 + i;
    dst[i * DP + d] = r < n ? to_f32(src[(long long)r * rs + d]) : 0.f;
  }
}

template <typename T, int NC>   // D = 16 * NC
__global__ void __launch_bounds__(kThreads, 2)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, int Sq, int Sk, int Hq, int Hkv,
                 long long qsb, long long qss, long long qsh,
                 long long ksb, long long kss, long long ksh,
                 long long vsb, long long vss, long long vsh,
                 long long osb, long long oss, long long osh, int causal,
                 float scale) {
  constexpr int D = 16 * NC;
  constexpr int DP = D + 1;
  extern __shared__ float smem[];
  float* q_s = smem;                  // [kBQ][DP]
  float* kv_s = q_s + kBQ * DP;       // [kBK][DP]: k, then v, of one tile
  float* p_s = kv_s + kBK * DP;       // [kBQ][kPS]

  const int n_q = (Sq + kBQ - 1) / kBQ;
  const int q0 = (n_q - 1 - (int)blockIdx.x) * kBQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int q_off = Sk - Sq;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;

  const T* q_g = q + b * qsb + h * qsh;
  const T* k_g = k + b * ksb + hk * ksh;
  const T* v_g = v + b * vsb + hk * vsh;

  load_tile<T, D>(q_s, q_g, qss, q0, kBQ, Sq);

  float m[4], l[4], acc[4][NC];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int n = 0; n < NC; ++n) acc[r][n] = 0.f;
  }

  // keys past the block's last row are masked for every row: stop there
  const int k_end = causal ? min(Sk, q0 + kBQ + q_off) : Sk;
  const int n_kt = (k_end + kBK - 1) / kBK;
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();                  // the last tile's p/v reads are done
    load_tile<T, D>(kv_s, k_g, kss, k0, kBK, Sk);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[r][c] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float a[4], bk[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) a[r] = q_s[(ty + 16 * r) * DP + d];
#pragma unroll
      for (int c = 0; c < 4; ++c) bk[c] = kv_s[(tx + 16 * c) * DP + d];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) s[r][c] = fmaf(a[r], bk[c], s[r][c]);
    }

    // scale, then mask (the TPU kernel's order); online softmax per row
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int qpos = q0 + ty + 16 * r + q_off;
      float mx = kNegInf;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int col = k0 + tx + 16 * c;
        float x = s[r][c] * scale;
        if (col >= Sk || (causal && col > qpos)) x = kNegInf;
        s[r][c] = x;
        mx = fmaxf(mx, x);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[r], mx);
      const float corr = expf(m[r] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float p = expf(s[r][c] - m_new);
        p_s[(ty + 16 * r) * kPS + tx + 16 * c] = p;
        sum += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[r] = l[r] * corr + sum;
      m[r] = m_new;
#pragma unroll
      for (int n = 0; n < NC; ++n) acc[r][n] *= corr;
    }
    __syncthreads();                  // k reads done, p written
    load_tile<T, D>(kv_s, v_g, vss, k0, kBK, Sk);
    __syncthreads();

#pragma unroll 4
    for (int j = 0; j < kBK; ++j) {
      float pr[4], vv[NC];
#pragma unroll
      for (int r = 0; r < 4; ++r) pr[r] = p_s[(ty + 16 * r) * kPS + j];
#pragma unroll
      for (int n = 0; n < NC; ++n) vv[n] = kv_s[j * DP + tx + 16 * n];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int n = 0; n < NC; ++n) acc[r][n] = fmaf(pr[r], vv[n], acc[r][n]);
    }
  }

#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int row = q0 + ty + 16 * r;
    if (row >= Sq) continue;
    const float lc = fmaxf(l[r], 1e-30f);
    T* o_r = o + b * osb + (long long)row * oss + h * osh;
#pragma unroll
    for (int n = 0; n < NC; ++n) o_r[tx + 16 * n] = from_f32<T>(acc[r][n] / lc);
    if (tx == 0) lse[((long long)b * Hq + h) * Sq + row] = m[r] + logf(lc);
  }
}

struct Args {
  const void *q, *k, *v;
  void *o, *lse;
  int B, Sq, Sk, Hq, Hkv;
  long long qsb, qss, qsh, ksb, kss, ksh, vsb, vss, vsh, osb, oss, osh;
  int causal;
  float scale;
};

template <typename T, int NC>
int launch_nc(const Args& a, cudaStream_t stream) {
  const int smem = (int)sizeof(float) * (2 * kBK * (16 * NC + 1) + kBQ * kPS);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, NC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((a.Sq + kBQ - 1) / kBQ, a.Hq, a.B);
  flash_fwd_kernel<T, NC><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<T*>(a.o),
      static_cast<float*>(a.lse), a.Sq, a.Sk, a.Hq, a.Hkv, a.qsb, a.qss,
      a.qsh, a.ksb, a.kss, a.ksh, a.vsb, a.vss, a.vsh, a.osb, a.oss, a.osh,
      a.causal, a.scale);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const Args& a, int D, cudaStream_t stream) {
  switch (D) {
    case 16: return launch_nc<T, 1>(a, stream);
    case 32: return launch_nc<T, 2>(a, stream);
    case 48: return launch_nc<T, 3>(a, stream);
    case 64: return launch_nc<T, 4>(a, stream);
    case 80: return launch_nc<T, 5>(a, stream);
    case 96: return launch_nc<T, 6>(a, stream);
    case 112: return launch_nc<T, 7>(a, stream);
    case 128: return launch_nc<T, 8>(a, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// q/o: [B, Sq, Hq, D], k/v: [B, Sk, Hkv, D], each with element strides
// (batch, sequence, head) and a contiguous D axis; lse: [B, Hq, Sq] f32,
// contiguous. dtype: 0 = float32, 1 = bfloat16. causal != 0 requires
// Sq <= Sk. Returns the cudaError_t of the launch (0 on success).
extern "C" int flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o, void* lse, int B,
    int Sq, int Sk, int Hq, int Hkv, int D, long long qsb, long long qss,
    long long qsh, long long ksb, long long kss, long long ksh,
    long long vsb, long long vss, long long vsh, long long osb,
    long long oss, long long osh, int causal, int dtype, float scale,
    void* stream) {
  if (B <= 0 || Sq <= 0 || Sk <= 0 || Hkv <= 0 || Hq % Hkv != 0 ||
      Hq > 65535 || B > 65535 || (causal && Sq > Sk))
    return (int)cudaErrorInvalidValue;
  const Args a{q, k, v, o, lse, B, Sq, Sk, Hq, Hkv, qsb, qss, qsh, ksb, kss,
               ksh, vsb, vss, vsh, osb, oss, osh, causal, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch<float>(a, D, s);
    case 1: return launch<__nv_bfloat16>(a, D, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
