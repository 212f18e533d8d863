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
// of the bound. So bf16 at head dim 64 or 128 goes to
// flash_attention_wgmma.cu (wgmma on bf16 tiles fed by TMA) instead; this
// kernel takes f32 (a tf32 product would miss the f32 tolerance) and bf16
// at the other head dims (kernels/flash_attention.py:forward_route).
//
// Backward (FlashAttention-2): replaces the Pallas TPU kernels of
// flash_attention_bwd in the same file (_bwd_dq_kernel and
// _bwd_dkv_kernel). From the saved q, k, v, lse and the cotangent dO, with
// delta = rowsum(dO * O) (f32, [B, Hq, Sq], computed by the wrapper):
//   p  = exp(s * scale - lse), 0 where masked   (recomputed, never stored)
//   dp = dO v^T,  ds = p * (dp - delta)
//   dq = ds k * scale,  dk = ds^T q * scale,  dv = p^T dO
// Two kernels, so that each gradient has one owner and no atomics are
// needed (the result is the same from run to run):
//   * dq:  one block per (q tile of 64 rows, q head, b). It loops over the
//          key tiles up to the diagonal (as the forward does), holding the
//          q and dO tiles, one k and one v tile and the [64, 64] ds tile in
//          shared memory, and accumulates dq in f32 registers; written
//          once, in q's dtype.
//   * dkv: one block per (key tile of 64, kv head, b). It loops over the G
//          q heads of its group and, for each, over the q tiles at or
//          below the diagonal, holding its k and v tiles, one q and one dO
//          tile and the [64, 64] p and ds tiles, and accumulates dk and dv
//          in f32 registers; written once, in k's dtype. The TPU kernel
//          wrote per-q-head partials and summed them over the group
//          outside; folding the sum into the block gives the same numbers
//          up to summation order, without a [B, Hq, Sk, D] f32 buffer.
// Thread (ty, tx) of the 16 x 16 layout owns rows ty + 16r of the block's
// own tile and columns tx + 16c of the streamed one, as in the forward;
// all tiles are f32 in shared memory with rows padded by one word. Shared
// memory at D=128: 148,736 bytes (dq) and 165,888 bytes (dkv), one block
// per SM.
//
// What bounds the backward on the H100: operations. At the LM training
// shape (B=2, S=4,096, Hq=40, Hkv=8, D=128, causal, bf16) there are
// 671,252,480 visible (q, key) pairs; the function's work is five
// products, 10 * D FLOP a pair (s recomputed, since no design can store
// p): 8.59e11 FLOP, 0.869 ms at 989 TFLOP/s, against 0.12 ms for its
// ~0.40 GB. These kernels run seven products (q k^T and dO v^T in both)
// on the CUDA cores in f32, so their ceiling is the 67 TFLOP/s f32 rate.
// So bf16 at head dim 64 or 128 goes to flash_attention_bwd_wgmma.cu
// (wgmma on bf16 tiles fed by TMA) instead; this pair takes f32 and bf16
// at the other head dims (kernels/flash_attention.py:backward_route).
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

// ---------------------------------------------------------------- backward

struct BwdArgs {
  const void *q, *k, *v, *dout;
  const float *lse, *delta;
  void *out1, *out2;             // dq; or dk, dv
  int B, Sq, Sk, Hq, Hkv;
  long long st[6][3];            // (b, s, h) strides of q, k, v, dO, out1,
                                 // out2
  int causal;
  float scale;
};

// (b, h)'s slice of a [B, S, H, D] tensor with strides st = (b, s, h)
template <typename T>
__device__ __forceinline__ T* head_ptr(const void* t, const long long* st,
                                       int b, int h) {
  return static_cast<T*>(const_cast<void*>(t)) + b * st[0] + h * st[2];
}

template <typename T, int NC>   // D = 16 * NC
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dq_kernel(BwdArgs a) {
  constexpr int D = 16 * NC;
  constexpr int DP = D + 1;
  extern __shared__ float smem[];
  float* q_s = smem;                  // [kBQ][DP]
  float* do_s = q_s + kBQ * DP;       // [kBQ][DP]
  float* k_s = do_s + kBQ * DP;       // [kBK][DP]
  float* v_s = k_s + kBK * DP;        // [kBK][DP]
  float* ds_s = v_s + kBK * DP;       // [kBQ][kPS]

  const int Sq = a.Sq, Sk = a.Sk;
  const int n_q = (Sq + kBQ - 1) / kBQ;
  const int q0 = (n_q - 1 - (int)blockIdx.x) * kBQ;   // longest rows first
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (a.Hq / a.Hkv);
  const int q_off = Sk - Sq;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;

  const T* q_g = head_ptr<T>(a.q, a.st[0], b, h);
  const T* k_g = head_ptr<T>(a.k, a.st[1], b, hk);
  const T* v_g = head_ptr<T>(a.v, a.st[2], b, hk);
  const T* do_g = head_ptr<T>(a.dout, a.st[3], b, h);
  const float* lse_g = a.lse + ((long long)b * a.Hq + h) * Sq;
  const float* delta_g = a.delta + ((long long)b * a.Hq + h) * Sq;

  load_tile<T, D>(q_s, q_g, a.st[0][1], q0, kBQ, Sq);
  load_tile<T, D>(do_s, do_g, a.st[3][1], q0, kBQ, Sq);
  float lse_r[4], delta_r[4], acc[4][NC];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int row = q0 + ty + 16 * r;
    lse_r[r] = row < Sq ? lse_g[row] : 0.f;
    delta_r[r] = row < Sq ? delta_g[row] : 0.f;
#pragma unroll
    for (int n = 0; n < NC; ++n) acc[r][n] = 0.f;
  }

  const int k_end = a.causal ? min(Sk, q0 + kBQ + q_off) : Sk;
  const int n_kt = (k_end + kBK - 1) / kBK;
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();                  // the last tile's ds, k reads done
    load_tile<T, D>(k_s, k_g, a.st[1][1], k0, kBK, Sk);
    load_tile<T, D>(v_s, v_g, a.st[2][1], k0, kBK, Sk);
    __syncthreads();

    float s[4][4], dp[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[r][c] = dp[r][c] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qa[4], ga[4], kb[4], vb[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        qa[r] = q_s[(ty + 16 * r) * DP + d];
        ga[r] = do_s[(ty + 16 * r) * DP + d];
      }
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        kb[c] = k_s[(tx + 16 * c) * DP + d];
        vb[c] = v_s[(tx + 16 * c) * DP + d];
      }
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          s[r][c] = fmaf(qa[r], kb[c], s[r][c]);
          dp[r][c] = fmaf(ga[r], vb[c], dp[r][c]);
        }
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int row = q0 + ty + 16 * r;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int col = k0 + tx + 16 * c;
        const bool seen = row < Sq && col < Sk &&
                          !(a.causal && col > row + q_off);
        const float p = seen ? expf(s[r][c] * a.scale - lse_r[r]) : 0.f;
        ds_s[(ty + 16 * r) * kPS + tx + 16 * c] =
            p * (dp[r][c] - delta_r[r]);
      }
    }
    __syncthreads();                  // ds written

#pragma unroll 4
    for (int j = 0; j < kBK; ++j) {
      float dsr[4], kk[NC];
#pragma unroll
      for (int r = 0; r < 4; ++r) dsr[r] = ds_s[(ty + 16 * r) * kPS + j];
#pragma unroll
      for (int n = 0; n < NC; ++n) kk[n] = k_s[j * DP + tx + 16 * n];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int n = 0; n < NC; ++n)
          acc[r][n] = fmaf(dsr[r], kk[n], acc[r][n]);
    }
  }

#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int row = q0 + ty + 16 * r;
    if (row >= Sq) continue;
    T* dq_r = head_ptr<T>(a.out1, a.st[4], b, h) + (long long)row * a.st[4][1];
#pragma unroll
    for (int n = 0; n < NC; ++n)
      dq_r[tx + 16 * n] = from_f32<T>(acc[r][n] * a.scale);
  }
}

template <typename T, int NC>   // D = 16 * NC
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dkv_kernel(BwdArgs a) {
  constexpr int D = 16 * NC;
  constexpr int DP = D + 1;
  extern __shared__ float smem[];
  float* k_s = smem;                  // [kBK][DP]
  float* v_s = k_s + kBK * DP;        // [kBK][DP]
  float* q_s = v_s + kBK * DP;        // [kBQ][DP]
  float* do_s = q_s + kBQ * DP;       // [kBQ][DP]
  float* p_s = do_s + kBQ * DP;       // [kBK][kPS]: p^T, key rows
  float* ds_s = p_s + kBK * kPS;      // [kBK][kPS]: ds^T
  float* lse_s = ds_s + kBK * kPS;    // [kBQ]
  float* delta_s = lse_s + kBQ;       // [kBQ]

  const int Sq = a.Sq, Sk = a.Sk;
  const int k0 = blockIdx.x * kBK;    // causal: the first key tiles have the
                                      // most rows, and are issued first
  const int hk = blockIdx.y, b = blockIdx.z;
  const int G = a.Hq / a.Hkv;
  const int q_off = Sk - Sq;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;

  const T* k_g = head_ptr<T>(a.k, a.st[1], b, hk);
  const T* v_g = head_ptr<T>(a.v, a.st[2], b, hk);
  load_tile<T, D>(k_s, k_g, a.st[1][1], k0, kBK, Sk);
  load_tile<T, D>(v_s, v_g, a.st[2][1], k0, kBK, Sk);

  float dk[4][NC], dv[4][NC];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int n = 0; n < NC; ++n) dk[r][n] = dv[r][n] = 0.f;

  // rows below the first that sees key k0 (row + q_off >= k0) see none of
  // this tile: start at the q tile that holds it
  const int q_first = a.causal ? max(0, k0 - q_off) / kBQ * kBQ : 0;
  for (int g = 0; g < G; ++g) {
    const int h = hk * G + g;
    const T* q_g = head_ptr<T>(a.q, a.st[0], b, h);
    const T* do_g = head_ptr<T>(a.dout, a.st[3], b, h);
    const float* lse_g = a.lse + ((long long)b * a.Hq + h) * Sq;
    const float* delta_g = a.delta + ((long long)b * a.Hq + h) * Sq;
    for (int q0 = q_first; q0 < Sq; q0 += kBQ) {
      __syncthreads();                // the last tile's reads are done
      load_tile<T, D>(q_s, q_g, a.st[0][1], q0, kBQ, Sq);
      load_tile<T, D>(do_s, do_g, a.st[3][1], q0, kBQ, Sq);
      for (int i = threadIdx.x; i < kBQ; i += kThreads) {
        const int row = q0 + i;
        lse_s[i] = row < Sq ? lse_g[row] : 0.f;
        delta_s[i] = row < Sq ? delta_g[row] : 0.f;
      }
      __syncthreads();

      // transposed scores: key rows ty + 16r, query columns tx + 16c
      float s[4][4], dp[4][4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) s[r][c] = dp[r][c] = 0.f;
#pragma unroll 4
      for (int d = 0; d < D; ++d) {
        float ka[4], va[4], qb[4], gb[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          ka[r] = k_s[(ty + 16 * r) * DP + d];
          va[r] = v_s[(ty + 16 * r) * DP + d];
        }
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          qb[c] = q_s[(tx + 16 * c) * DP + d];
          gb[c] = do_s[(tx + 16 * c) * DP + d];
        }
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            s[r][c] = fmaf(ka[r], qb[c], s[r][c]);
            dp[r][c] = fmaf(va[r], gb[c], dp[r][c]);
          }
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int key = k0 + ty + 16 * r;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int i = tx + 16 * c, row = q0 + i;
          const bool seen = key < Sk && row < Sq &&
                            !(a.causal && key > row + q_off);
          const float p = seen ? expf(s[r][c] * a.scale - lse_s[i]) : 0.f;
          p_s[(ty + 16 * r) * kPS + i] = p;
          ds_s[(ty + 16 * r) * kPS + i] = p * (dp[r][c] - delta_s[i]);
        }
      }
      __syncthreads();                // p and ds written

#pragma unroll 2
      for (int j = 0; j < kBQ; ++j) {
        float pr[4], dr[4], qq[NC], gg[NC];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          pr[r] = p_s[(ty + 16 * r) * kPS + j];
          dr[r] = ds_s[(ty + 16 * r) * kPS + j];
        }
#pragma unroll
        for (int n = 0; n < NC; ++n) {
          qq[n] = q_s[j * DP + tx + 16 * n];
          gg[n] = do_s[j * DP + tx + 16 * n];
        }
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int n = 0; n < NC; ++n) {
            dv[r][n] = fmaf(pr[r], gg[n], dv[r][n]);
            dk[r][n] = fmaf(dr[r], qq[n], dk[r][n]);
          }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int key = k0 + ty + 16 * r;
    if (key >= Sk) continue;
    T* dk_r = head_ptr<T>(a.out1, a.st[4], b, hk) + (long long)key * a.st[4][1];
    T* dv_r = head_ptr<T>(a.out2, a.st[5], b, hk) + (long long)key * a.st[5][1];
#pragma unroll
    for (int n = 0; n < NC; ++n) {
      dk_r[tx + 16 * n] = from_f32<T>(dk[r][n] * a.scale);
      dv_r[tx + 16 * n] = from_f32<T>(dv[r][n]);
    }
  }
}

template <typename T, int NC>
int launch_bwd_nc(const BwdArgs& a, bool dkv, cudaStream_t stream) {
  constexpr int DP = 16 * NC + 1;
  // q, dO, k and v tiles, [64][DP] each
  const int tiles = (int)sizeof(float) * 2 * (kBQ + kBK) * DP;
  if (dkv) {
    const int smem =
        tiles + (int)sizeof(float) * (2 * kBK * kPS + 2 * kBQ);
    cudaError_t err = cudaFuncSetAttribute(
        flash_bwd_dkv_kernel<T, NC>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid((a.Sk + kBK - 1) / kBK, a.Hkv, a.B);
    flash_bwd_dkv_kernel<T, NC><<<grid, kThreads, smem, stream>>>(a);
  } else {
    const int smem = tiles + (int)sizeof(float) * kBQ * kPS;
    cudaError_t err = cudaFuncSetAttribute(
        flash_bwd_dq_kernel<T, NC>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid((a.Sq + kBQ - 1) / kBQ, a.Hq, a.B);
    flash_bwd_dq_kernel<T, NC><<<grid, kThreads, smem, stream>>>(a);
  }
  return (int)cudaGetLastError();
}

template <typename T>
int launch_bwd(const BwdArgs& a, int D, bool dkv, cudaStream_t stream) {
  switch (D) {
    case 16: return launch_bwd_nc<T, 1>(a, dkv, stream);
    case 32: return launch_bwd_nc<T, 2>(a, dkv, stream);
    case 48: return launch_bwd_nc<T, 3>(a, dkv, stream);
    case 64: return launch_bwd_nc<T, 4>(a, dkv, stream);
    case 80: return launch_bwd_nc<T, 5>(a, dkv, stream);
    case 96: return launch_bwd_nc<T, 6>(a, dkv, stream);
    case 112: return launch_bwd_nc<T, 7>(a, dkv, stream);
    case 128: return launch_bwd_nc<T, 8>(a, dkv, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

int bwd_entry(const BwdArgs& a, int D, int dtype, bool dkv, void* stream) {
  if (a.B <= 0 || a.Sq <= 0 || a.Sk <= 0 || a.Hkv <= 0 ||
      a.Hq % a.Hkv != 0 || a.Hq > 65535 || a.B > 65535 ||
      (a.causal && a.Sq > a.Sk))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch_bwd<float>(a, D, dkv, s);
    case 1: return launch_bwd<__nv_bfloat16>(a, D, dkv, s);
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

// The backward's two kernels. q/dO/dq: [B, Sq, Hq, D] and k/v/dk/dv:
// [B, Sk, Hkv, D], each with element strides (batch, sequence, head) and a
// contiguous D axis, all of one dtype (0 = float32, 1 = bfloat16); lse and
// delta = rowsum(dO * O): [B, Hq, Sq] f32, contiguous. dq is written by
// flash_attention_bwd_dq, dk and dv (summed over each kv head's group of q
// heads) by flash_attention_bwd_dkv. Each returns the cudaError_t of its
// launch (0 on success).
extern "C" int flash_attention_bwd_dq(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dq, int B, int Sq, int Sk,
    int Hq, int Hkv, int D, long long qsb, long long qss, long long qsh,
    long long ksb, long long kss, long long ksh, long long vsb,
    long long vss, long long vsh, long long dsb, long long dss,
    long long dsh, long long dqsb, long long dqss, long long dqsh,
    int causal, int dtype, float scale, void* stream) {
  BwdArgs a{q, k, v, dout, static_cast<const float*>(lse),
            static_cast<const float*>(delta), dq, nullptr, B, Sq, Sk, Hq, Hkv,
            {{qsb, qss, qsh}, {ksb, kss, ksh}, {vsb, vss, vsh},
             {dsb, dss, dsh}, {dqsb, dqss, dqsh}, {0, 0, 0}},
            causal, scale};
  return bwd_entry(a, D, dtype, false, stream);
}

extern "C" int flash_attention_bwd_dkv(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dk, void* dv, int B, int Sq,
    int Sk, int Hq, int Hkv, int D, long long qsb, long long qss,
    long long qsh, long long ksb, long long kss, long long ksh,
    long long vsb, long long vss, long long vsh, long long dsb,
    long long dss, long long dsh, long long dksb, long long dkss,
    long long dksh, long long dvsb, long long dvss, long long dvsh,
    int causal, int dtype, float scale, void* stream) {
  BwdArgs a{q, k, v, dout, static_cast<const float*>(lse),
            static_cast<const float*>(delta), dk, dv, B, Sq, Sk, Hq, Hkv,
            {{qsb, qss, qsh}, {ksb, kss, ksh}, {vsb, vss, vsh},
             {dsb, dss, dsh}, {dksb, dkss, dksh}, {dvsb, dvss, dvsh}},
            causal, scale};
  return bwd_entry(a, D, dtype, true, stream);
}
