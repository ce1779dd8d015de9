// K3: flash attention (causal, sliding-window or full; GQA), hand-written for
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_flash_kernel` behind `flash_attention`
// (src/repro/kernels/flash_attention.py).  Its plain PyTorch version is
// `flash_attention_plain` (src/repro_torch/kernels/flash_attention.py); the
// two agree to the reference's tolerances (2e-5 in float32, 2e-2 in bf16).
//
// What it computes.  For every (batch b, query head h, query row i):
// softmax over the keys j that the mask admits of (q_i . k_j) * scale,
// applied to v, where k and v are read from kv head h / (H / KVH).  The mask
// is the reference's: j <= i when causal, j > i - window when window > 0.
// Masked scores are set to -1e30 and their probabilities to 0, m, l and the
// accumulator are float32 and carried across key tiles (online softmax), and
// the output is acc / max(l, 1e-30), stored in the input type.  Inputs are
// float32, bf16 or fp16 and are widened to float32 as they are loaded.
//
// What bounds it on this card.  Operations: 4 * H * hd flops per admitted
// (i, j) pair against 3 * hd * (H or KVH) elements read per row, so at the
// model widths it serves (hd 64 or 128, S in the thousands) it does
// hundreds of flops per byte, far above the card's ridge point.  The
// products are float32 FMAs on the CUDA cores (no TF32: the float32
// tolerance of 2e-5 forbids it), 67 TFLOP/s at best; the bf16 bound counts
// the tensor cores' 989 TFLOP/s, which this kernel does not use
// (`mma.sync`/`wgmma` are later work).
//
// What the design does about it.  The TPU kernel's sequential KV grid axis
// becomes a loop inside a block that owns (b, h, 64 query rows); m, l and
// the accumulator stay in registers for the whole loop.  Tiles that the mask
// empties (above the diagonal, or before the window) are never loaded.  The
// query tile stays in shared memory; each 64-key tile is loaded once as K,
// used for the scores, then overwritten by V (one buffer, so two blocks fit
// on an SM at hd 128).  256 threads as 16 x 16: a thread computes a 4 x 4
// block of scores from float4 reads (its 4 query rows broadcast within a
// half-warp, its 4 keys on rows 16 apart so a quarter-warp reads distinct
// banks) and then 4 rows x hd/16 output columns, with the row max and sum
// reduced by shuffles among the 16 threads that share a row.  Query tiles
// run longest-first, so the causal triangle's long rows do not trail.
// Rows are read in place from the (B, S, H, hd) layout; S need not be a
// multiple of the tile (the ragged edge is masked).  expf, not __expf, and
// no --use_fast_math.
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "attention_types.cuh"

namespace {

constexpr int kBQ = 64;         // query rows per block
constexpr int kBK = 64;         // keys per tile of the sequential loop
constexpr int kThreads = 256;   // 16 x 16: tx owns key / output columns, ty 4 query rows

using repro_attention::from_float;
using repro_attention::kNegInf;
using repro_attention::to_float;

// Output column c of a thread: chunks of 4 at 64 * c4 + 4 * tx, so that a
// quarter-warp's float4 reads of a V row fall on distinct banks.
__device__ __forceinline__ int out_col(int tx, int c) {
  return 64 * (c / 4) + 4 * tx + c % 4;
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
flash_kernel(const T* __restrict__ q,      // (B, S, H, HD)
             const T* __restrict__ k,      // (B, S, KVH, HD)
             const T* __restrict__ v,      // (B, S, KVH, HD)
             T* __restrict__ out,          // (B, S, H, HD)
             int S, int H, int KVH, int causal, int window, float scale) {
  constexpr int QS = HD + 4;    // padded row stride of the Q and K tiles
  constexpr int PS = kBK + 4;   // padded row stride of the probability tile
  constexpr int CPT = HD / 16;  // output columns per thread
  static_assert(HD % 64 == 0, "head dims 64, 128, 256");

  extern __shared__ float4 smem4[];
  float* q_s = reinterpret_cast<float*>(smem4);   // (kBQ, QS)
  float* kv_s = q_s + kBQ * QS;                   // K as (kBK, QS), then V as (kBK, HD)
  float* p_s = kv_s + kBK * QS;                   // (kBQ, PS)

  const int n_q = (S + kBQ - 1) / kBQ;
  const int q0 = (n_q - 1 - static_cast<int>(blockIdx.x)) * kBQ;   // longest rows first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kh = h / (H / KVH);
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int q_last = min(q0 + kBQ, S) - 1;

  const size_t q_row = static_cast<size_t>(H) * HD;
  const size_t kv_row = static_cast<size_t>(KVH) * HD;
  const T* qb = q + static_cast<size_t>(b) * S * q_row + static_cast<size_t>(h) * HD;
  const T* kb = k + static_cast<size_t>(b) * S * kv_row + static_cast<size_t>(kh) * HD;
  const T* vb = v + static_cast<size_t>(b) * S * kv_row + static_cast<size_t>(kh) * HD;

  for (int i = tid; i < kBQ * HD; i += kThreads) {
    const int r = i / HD, c = i % HD;
    q_s[r * QS + c] = q0 + r < S ? to_float(qb[static_cast<size_t>(q0 + r) * q_row + c]) : 0.f;
  }

  // the key tiles that hold an admitted key for some row of this block
  int kt_lo = 0;
  int kt_hi = (S + kBK - 1) / kBK;
  if (causal) kt_hi = min(kt_hi, q_last / kBK + 1);
  if (window > 0) kt_lo = max(0, (q0 - window + 1) / kBK);

  float m[4], l[4], acc[4][CPT];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < CPT; ++c) acc[i][c] = 0.f;
  }

  for (int kt = kt_lo; kt < kt_hi; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();   // the previous tile's V and P are consumed
    for (int i = tid; i < kBK * HD; i += kThreads) {
      const int r = i / HD, c = i % HD;
      kv_s[r * QS + c] = k0 + r < S ? to_float(kb[static_cast<size_t>(k0 + r) * kv_row + c])
                                    : 0.f;
    }
    __syncthreads();

    // scores: rows ty*4 + i, keys tx + 16*j
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int c = 0; c < HD; c += 4) {
      float4 qa[4], ka[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qa[i] = *reinterpret_cast<const float4*>(q_s + (ty * 4 + i) * QS + c);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        ka[j] = *reinterpret_cast<const float4*>(kv_s + (tx + 16 * j) * QS + c);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(qa[i].x, ka[j].x, s[i][j]);
          s[i][j] = fmaf(qa[i].y, ka[j].y, s[i][j]);
          s[i][j] = fmaf(qa[i].z, ka[j].z, s[i][j]);
          s[i][j] = fmaf(qa[i].w, ka[j].w, s[i][j]);
        }
    }

    // mask and online softmax; the 16 threads of a row are one half-warp
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qp = q0 + ty * 4 + i;
      bool ok[4];
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kp = k0 + tx + 16 * j;
        ok[j] = kp < S && (!causal || kp <= qp) && (window <= 0 || kp > qp - window);
        s[i][j] = ok[j] ? s[i][j] * scale : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = ok[j] ? expf(s[i][j] - m_new) : 0.f;
        p_s[(ty * 4 + i) * PS + tx + 16 * j] = p;
        sum += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[i] = l[i] * alpha + sum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < CPT; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();   // the scores are done with K; P is written

    for (int i = tid; i < kBK * HD; i += kThreads) {
      const int r = i / HD, c = i % HD;
      kv_s[r * HD + c] = k0 + r < S ? to_float(vb[static_cast<size_t>(k0 + r) * kv_row + c])
                                    : 0.f;
    }
    __syncthreads();

    // acc += P V over the tile's keys
#pragma unroll 2
    for (int kk = 0; kk < kBK; kk += 4) {
      float4 pa[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        pa[i] = *reinterpret_cast<const float4*>(p_s + (ty * 4 + i) * PS + kk);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        float vv[CPT];
#pragma unroll
        for (int c4 = 0; c4 < CPT / 4; ++c4) {
          const float4 x = *reinterpret_cast<const float4*>(kv_s + (kk + u) * HD + 64 * c4 + 4 * tx);
          vv[4 * c4] = x.x;
          vv[4 * c4 + 1] = x.y;
          vv[4 * c4 + 2] = x.z;
          vv[4 * c4 + 3] = x.w;
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float p = u == 0 ? pa[i].x : u == 1 ? pa[i].y : u == 2 ? pa[i].z : pa[i].w;
#pragma unroll
          for (int c = 0; c < CPT; ++c) acc[i][c] = fmaf(p, vv[c], acc[i][c]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qp = q0 + ty * 4 + i;
    if (qp >= S) continue;
    const float denom = fmaxf(l[i], 1e-30f);
    T* o = out + (static_cast<size_t>(b) * S + qp) * q_row + static_cast<size_t>(h) * HD;
#pragma unroll
    for (int c = 0; c < CPT; ++c) o[out_col(tx, c)] = from_float<T>(acc[i][c] / denom);
  }
}

template <typename T, int HD>
cudaError_t launch(const void* q, const void* k, const void* v, void* out, int B, int S, int H,
                   int KVH, int causal, int window, float scale, cudaStream_t stream) {
  auto kernel = flash_kernel<T, HD>;
  const size_t smem = (static_cast<size_t>(kBQ + kBK) * (HD + 4) + kBQ * (kBK + 4)) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((S + kBQ - 1) / kBQ, H, B);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), S, H, KVH, causal, window, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_hd(const void* q, const void* k, const void* v, void* out, int B, int S,
                      int H, int KVH, int HD, int causal, int window, float scale,
                      cudaStream_t stream) {
  switch (HD) {
    case 64: return launch<T, 64>(q, k, v, out, B, S, H, KVH, causal, window, scale, stream);
    case 128: return launch<T, 128>(q, k, v, out, B, S, H, KVH, causal, window, scale, stream);
    case 256: return launch<T, 256>(q, k, v, out, B, S, H, KVH, causal, window, scale, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// Plain C interface, bound with ctypes.  dtype: 0 float32, 1 bf16, 2 fp16
// (q, k, v and out all of it); every tensor contiguous.  Launches on
// `stream`, does not synchronise, allocates nothing; returns the
// cudaError_t of the launch (cudaErrorInvalidValue for a head dim or type
// it has no instance for).
extern "C" int repro_flash_attention(const void* q, const void* k, const void* v, void* out,
                                     int B, int S, int H, int KVH, int HD, int dtype,
                                     int causal, int window, float scale, void* stream) {
  if (B < 1 || S < 1 || KVH < 1 || H % KVH != 0 || H > 65535 || B > 65535) {
    return cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch_hd<float>(q, k, v, out, B, S, H, KVH, HD, causal, window, scale, s);
    case 1: return launch_hd<__nv_bfloat16>(q, k, v, out, B, S, H, KVH, HD, causal, window,
                                            scale, s);
    case 2: return launch_hd<__half>(q, k, v, out, B, S, H, KVH, HD, causal, window, scale, s);
    default: return cudaErrorInvalidValue;
  }
}

extern "C" const char* repro_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
