// K4: single-token decode attention over a long KV cache, hand-written for
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_decode_kernel` behind `decode_attention`
// (src/repro/kernels/decode_attention.py).  Its plain PyTorch version is
// `decode_attention_plain` (src/repro_torch/kernels/decode_attention.py);
// the two agree to the reference's tolerances (2e-5 in float32, 2e-2 in
// bf16).
//
// What it computes.  For every sequence b and query head h: softmax over the
// first min(lengths[b], S) cache positions of (q_h . k_j) * scale, applied
// to v, with k and v read from kv head h / (H / KVH).  m, l and the
// accumulator are float32; the output is acc / max(l, 1e-30) in the input
// type, so a sequence with length <= 0 gives zeros, as the TPU kernel does.
//
// What bounds it on this card.  Bytes: every valid cache row is read once
// (2 * KVH * hd elements per position) for 4 * H * hd flops, about rep
// flops per byte in bf16, far below the card's ridge point.
//
// What the design does about it.  On the TPU the grid is (B, KVH, S / BK)
// with S sequential, which on this card would be B * KVH blocks, too few to
// keep 132 SMs' loads in flight (hymba's long decode has B 1 and KVH 5).
// So S is split across blocks: a block owns (b, kv head, one chunk of
// positions), loops over its chunk in 64-position tiles with the query-head
// group for its kv head resident in shared memory, and writes its partial
// (m, l, acc) for each head of the group to scratch.  A second, small launch
// merges the partials of each (b, h) in split order, so the result is
// deterministic without atomics; a sequence whose every chunk is empty
// merges nothing and comes out zero.  Chunks at or past the length return
// before reading anything, and rows past the length inside a chunk are not
// loaded.  In a tile, a thread owns one position and computes its dot
// products for several heads of the group from one float4 read of the key
// row (rows padded so a quarter-warp reads distinct banks); then each warp
// takes whole heads for the max and sum (shuffles); then a thread owns one
// column of V for up to kMaxR heads, reading their probabilities as float4.
// expf, not __expf, and no --use_fast_math.
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "attention_types.cuh"

namespace {

constexpr int kTile = 64;       // cache positions per tile

using repro_attention::from_float;
using repro_attention::kNegInf;
using repro_attention::to_float;

__host__ __device__ constexpr int threads_for(int hd) { return hd > 128 ? hd : 128; }

// Shared-memory layout of one block, in floats: the head group's queries
// (PS x HD), the K tile (kTile x HD+4), the V tile (kTile x HD), the
// probabilities (PS x kTile+4) and the running m, l and rescale factor (PS
// each), where PS = (threads / HD) * kMaxR head slots.
template <int HD, int kMaxR>
struct Layout {
  static constexpr int kThreads = threads_for(HD);
  static constexpr int NG = kThreads / HD;     // head groups of the P V phase
  static constexpr int PS = NG * kMaxR;        // head slots, >= rep
  static constexpr int KS = HD + 4;
  static constexpr int PST = kTile + 4;
  static constexpr int kQ = 0;
  static constexpr int kK = kQ + PS * HD;
  static constexpr int kV = kK + kTile * KS;
  static constexpr int kP = kV + kTile * HD;
  static constexpr int kM = kP + PS * PST;
  static constexpr int kL = kM + PS;
  static constexpr int kA = kL + PS;
  static constexpr int kFloats = kA + PS;
};

template <typename T, int HD, int kMaxR>
__global__ void __launch_bounds__(threads_for(HD))
decode_split_kernel(const T* __restrict__ q,             // (B, H, HD)
                    const T* __restrict__ k,             // (B, S, KVH, HD)
                    const T* __restrict__ v,             // (B, S, KVH, HD)
                    const int32_t* __restrict__ lengths, // (B,)
                    float* __restrict__ m_part,          // (B, KVH, n_split, rep)
                    float* __restrict__ l_part,          // (B, KVH, n_split, rep)
                    float* __restrict__ acc_part,        // (B, KVH, n_split, rep, HD)
                    int S, int H, int KVH, int chunk, int n_split, float scale) {
  using L = Layout<HD, kMaxR>;
  constexpr int kThreads = L::kThreads;
  constexpr int NSUB = kThreads / kTile;           // head subsets of the score phase
  constexpr int SR = (L::PS + NSUB - 1) / NSUB;    // heads per thread in the score phase
  constexpr int NW = kThreads / 32;
  static_assert(HD % 64 == 0, "head dims 64, 128, 256");

  const int split = blockIdx.x;
  const int kh = blockIdx.y;
  const int b = blockIdx.z;
  const int rep = H / KVH;
  const int len = min(max(lengths[b], 0), S);
  const int start = split * chunk;
  if (start >= len) return;          // the whole block: nothing of this chunk is valid
  const int end = min(start + chunk, len);

  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* q_s = smem + L::kQ;
  float* k_s = smem + L::kK;
  float* v_s = smem + L::kV;
  float* p_s = smem + L::kP;
  float* m_s = smem + L::kM;
  float* l_s = smem + L::kL;
  float* a_s = smem + L::kA;

  const int t = threadIdx.x;
  const int lane = t % 32;
  const int warp = t / 32;

  const T* qg = q + (static_cast<size_t>(b) * H + static_cast<size_t>(kh) * rep) * HD;
  for (int i = t; i < L::PS * HD; i += kThreads) {
    q_s[i] = i < rep * HD ? to_float(qg[i]) : 0.f;
  }
  for (int r = t; r < L::PS; r += kThreads) {
    m_s[r] = kNegInf;
    l_s[r] = 0.f;
  }

  const size_t row = static_cast<size_t>(KVH) * HD;
  const T* kb = k + static_cast<size_t>(b) * S * row + static_cast<size_t>(kh) * HD;
  const T* vb = v + static_cast<size_t>(b) * S * row + static_cast<size_t>(kh) * HD;

  const int d = t % HD;              // P V phase: column d of heads hg*kMaxR + j
  const int hg = t / HD;
  float acc[kMaxR];
#pragma unroll
  for (int j = 0; j < kMaxR; ++j) acc[j] = 0.f;

  for (int t0 = start; t0 < end; t0 += kTile) {
    const int n = min(kTile, end - t0);
    __syncthreads();   // the previous tile is consumed; q_s, m_s, l_s are set
    for (int i = t; i < kTile * HD; i += kThreads) {
      const int r = i / HD, c = i % HD;
      float kx = 0.f, vx = 0.f;
      if (r < n) {
        const size_t off = static_cast<size_t>(t0 + r) * row + c;
        kx = to_float(kb[off]);
        vx = to_float(vb[off]);
      }
      k_s[r * L::KS + c] = kx;
      v_s[r * HD + c] = vx;
    }
    __syncthreads();

    // scores: position pos for heads sub + NSUB * j
    {
      const int pos = t % kTile;
      const int sub = t / kTile;
      float dot[SR];
#pragma unroll
      for (int j = 0; j < SR; ++j) dot[j] = 0.f;
      const float* krow = k_s + pos * L::KS;
#pragma unroll 4
      for (int c = 0; c < HD; c += 4) {
        const float4 kx = *reinterpret_cast<const float4*>(krow + c);
#pragma unroll
        for (int j = 0; j < SR; ++j) {
          const int r = sub + NSUB * j;
          if (r < rep) {
            const float4 qx = *reinterpret_cast<const float4*>(q_s + r * HD + c);
            dot[j] = fmaf(qx.x, kx.x, dot[j]);
            dot[j] = fmaf(qx.y, kx.y, dot[j]);
            dot[j] = fmaf(qx.z, kx.z, dot[j]);
            dot[j] = fmaf(qx.w, kx.w, dot[j]);
          }
        }
      }
#pragma unroll
      for (int j = 0; j < SR; ++j) {
        const int r = sub + NSUB * j;
        if (r < rep) p_s[r * L::PST + pos] = pos < n ? dot[j] * scale : kNegInf;
      }
    }
    __syncthreads();

    // online softmax, one warp per head
    for (int r = warp; r < rep; r += NW) {
      float* pr = p_s + r * L::PST;
      const float s0 = pr[lane], s1 = pr[lane + 32];
      float mx = fmaxf(s0, s1);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, mx);
      const float p0 = lane < n ? expf(s0 - m_new) : 0.f;
      const float p1 = lane + 32 < n ? expf(s1 - m_new) : 0.f;
      pr[lane] = p0;
      pr[lane + 32] = p1;
      float sum = p0 + p1;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        l_s[r] = l_s[r] * alpha + sum;
        m_s[r] = m_new;
        a_s[r] = alpha;
      }
    }
    __syncthreads();

    // acc = acc * alpha + P V; positions past n have p = 0 and v = 0
#pragma unroll
    for (int j = 0; j < kMaxR; ++j) {
      const int r = hg * kMaxR + j;
      if (r < rep) acc[j] *= a_s[r];
    }
    const int n4 = (n + 3) & ~3;
    for (int pos = 0; pos < n4; pos += 4) {
      const float v0 = v_s[pos * HD + d];
      const float v1 = v_s[(pos + 1) * HD + d];
      const float v2 = v_s[(pos + 2) * HD + d];
      const float v3 = v_s[(pos + 3) * HD + d];
#pragma unroll
      for (int j = 0; j < kMaxR; ++j) {
        const int r = hg * kMaxR + j;
        if (r < rep) {
          const float4 p = *reinterpret_cast<const float4*>(p_s + r * L::PST + pos);
          acc[j] = fmaf(p.x, v0, acc[j]);
          acc[j] = fmaf(p.y, v1, acc[j]);
          acc[j] = fmaf(p.z, v2, acc[j]);
          acc[j] = fmaf(p.w, v3, acc[j]);
        }
      }
    }
  }

  const size_t part = (static_cast<size_t>(b) * KVH + kh) * n_split + split;
#pragma unroll
  for (int j = 0; j < kMaxR; ++j) {
    const int r = hg * kMaxR + j;
    if (r < rep) acc_part[(part * rep + r) * HD + d] = acc[j];
  }
  for (int r = t; r < rep; r += kThreads) {
    m_part[part * rep + r] = m_s[r];
    l_part[part * rep + r] = l_s[r];
  }
}

// One block per (h, b), one thread per column: merges the partials of the
// chunks that hold a valid position, in chunk order.
template <typename T>
__global__ void decode_combine_kernel(const int32_t* __restrict__ lengths,
                                      const float* __restrict__ m_part,
                                      const float* __restrict__ l_part,
                                      const float* __restrict__ acc_part,
                                      T* __restrict__ out,   // (B, H, HD)
                                      int S, int H, int KVH, int HD, int chunk, int n_split) {
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int d = threadIdx.x;
  const int rep = H / KVH;
  const int kh = h / rep;
  const int r = h % rep;
  const int len = min(max(lengths[b], 0), S);
  const int used = (len + chunk - 1) / chunk;
  const size_t first = (static_cast<size_t>(b) * KVH + kh) * n_split;

  float m = kNegInf;
  for (int s = 0; s < used; ++s) m = fmaxf(m, m_part[(first + s) * rep + r]);
  float l = 0.f, acc = 0.f;
  for (int s = 0; s < used; ++s) {
    const size_t i = (first + s) * rep + r;
    const float w = expf(m_part[i] - m);
    l = fmaf(l_part[i], w, l);
    acc = fmaf(acc_part[i * HD + d], w, acc);
  }
  out[(static_cast<size_t>(b) * H + h) * HD + d] = from_float<T>(acc / fmaxf(l, 1e-30f));
}

template <typename T, int HD, int kMaxR>
cudaError_t launch(const void* q, const void* k, const void* v, const int32_t* lengths,
                   void* out, float* m_part, float* l_part, float* acc_part, int B, int S,
                   int H, int KVH, int chunk, int n_split, float scale, cudaStream_t stream) {
  using L = Layout<HD, kMaxR>;
  auto kernel = decode_split_kernel<T, HD, kMaxR>;
  const size_t smem = static_cast<size_t>(L::kFloats) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  kernel<<<dim3(n_split, KVH, B), L::kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), lengths,
      m_part, l_part, acc_part, S, H, KVH, chunk, n_split, scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  decode_combine_kernel<T><<<dim3(H, B), HD, 0, stream>>>(
      lengths, m_part, l_part, acc_part, static_cast<T*>(out), S, H, KVH, HD, chunk, n_split);
  return cudaGetLastError();
}

template <typename T, int HD>
cudaError_t launch_r(const void* q, const void* k, const void* v, const int32_t* lengths,
                     void* out, float* m_part, float* l_part, float* acc_part, int B, int S,
                     int H, int KVH, int chunk, int n_split, float scale, cudaStream_t stream) {
  constexpr int NG = threads_for(HD) / HD;
  const int per_group = (H / KVH + NG - 1) / NG;
  if (per_group <= 4) {
    return launch<T, HD, 4>(q, k, v, lengths, out, m_part, l_part, acc_part, B, S, H, KVH,
                            chunk, n_split, scale, stream);
  }
  if (per_group <= 8) {
    return launch<T, HD, 8>(q, k, v, lengths, out, m_part, l_part, acc_part, B, S, H, KVH,
                            chunk, n_split, scale, stream);
  }
  if (per_group <= 16) {
    return launch<T, HD, 16>(q, k, v, lengths, out, m_part, l_part, acc_part, B, S, H, KVH,
                             chunk, n_split, scale, stream);
  }
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t launch_hd(const void* q, const void* k, const void* v, const int32_t* lengths,
                      void* out, float* m_part, float* l_part, float* acc_part, int B, int S,
                      int H, int KVH, int HD, int chunk, int n_split, float scale,
                      cudaStream_t stream) {
  switch (HD) {
    case 64: return launch_r<T, 64>(q, k, v, lengths, out, m_part, l_part, acc_part, B, S, H,
                                    KVH, chunk, n_split, scale, stream);
    case 128: return launch_r<T, 128>(q, k, v, lengths, out, m_part, l_part, acc_part, B, S,
                                      H, KVH, chunk, n_split, scale, stream);
    case 256: return launch_r<T, 256>(q, k, v, lengths, out, m_part, l_part, acc_part, B, S,
                                      H, KVH, chunk, n_split, scale, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// Plain C interface, bound with ctypes.  dtype: 0 float32, 1 bf16, 2 fp16
// (q, the caches and out); lengths int32; every tensor contiguous.  The
// caller allocates the float32 scratch m_part, l_part (B, KVH, n_split,
// rep) and acc_part (B, KVH, n_split, rep, HD), with n_split * chunk >= S.
// Two launches on `stream` (the split pass, then the merge), no
// synchronisation, no allocation; returns the first launch error.
extern "C" int repro_decode_attention(const void* q, const void* k, const void* v,
                                      const int32_t* lengths, void* out, float* m_part,
                                      float* l_part, float* acc_part, int B, int S, int H,
                                      int KVH, int HD, int dtype, int chunk, int n_split,
                                      float scale, void* stream) {
  if (B < 1 || S < 1 || KVH < 1 || H % KVH != 0 || chunk < 1 || n_split < 1 ||
      static_cast<long long>(n_split) * chunk < S || B > 65535 || KVH > 65535 || H > 65535) {
    return cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch_hd<float>(q, k, v, lengths, out, m_part, l_part, acc_part, B, S, H,
                                    KVH, HD, chunk, n_split, scale, s);
    case 1: return launch_hd<__nv_bfloat16>(q, k, v, lengths, out, m_part, l_part, acc_part, B,
                                            S, H, KVH, HD, chunk, n_split, scale, s);
    case 2: return launch_hd<__half>(q, k, v, lengths, out, m_part, l_part, acc_part, B, S, H,
                                     KVH, HD, chunk, n_split, scale, s);
    default: return cudaErrorInvalidValue;
  }
}

// Largest query-head group (H / KVH) the kernel has an instance for at
// head dim `hd` (0 for a head dim it does not take).
extern "C" int repro_decode_attention_max_rep(int hd) {
  switch (hd) {
    case 64: return 16 * (threads_for(64) / 64);
    case 128: return 16 * (threads_for(128) / 128);
    case 256: return 16 * (threads_for(256) / 256);
    default: return 0;
  }
}
