// K4: single-token decode attention over a long KV cache, hand-written for
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_decode_kernel` behind `decode_attention`
// (src/repro/kernels/decode_attention.py:78, body :31).  Its plain PyTorch
// version is `decode_attention_plain` (src/repro_torch/kernels/
// decode_attention.py); the two agree to the reference's tolerances (2e-5
// in float32, 2e-2 in bf16 and fp16).
//
// What it computes.  For every sequence b and query head h: softmax over the
// first min(lengths[b], S) cache positions of (q_h . k_j) * scale, applied
// to v, with k and v read from kv head h / (H / KVH).  m, l and the
// accumulator are float32; the output is acc / max(l, 1e-30) in the input
// type, so a sequence with length <= 0 gives zeros, as the TPU kernel does.
//
// What bounds it on this card.  Bytes: every valid cache row is read once
// (2 * KVH * hd elements per position) for 4 * H * hd flops, about rep
// flops per byte in bf16, far below the card's ridge point.  The bound is
// the valid rows' bytes over 3.35 TB/s, and reaching it takes enough bytes
// in flight: about 25 KB per SM for each microsecond of memory latency.
//
// What the design does about it.  On the TPU the grid is (B, KVH, S / BK)
// with S sequential, which on this card would be B * KVH blocks, too few to
// keep 132 SMs' loads in flight (hymba's long decode has B 1 and KVH 5).
// So S is split across blocks: a block owns (b, kv head, one chunk of
// positions), loops over its chunk in tiles, and writes its partial (m, l,
// acc) for each head of the group to scratch.  A second, small launch
// merges the partials of each (b, h) in split order, so the result is
// deterministic without atomics; a sequence whose every chunk is empty
// merges nothing and comes out zero.  Chunks at or past the length return
// before reading anything.  Inside a block, K and V tiles arrive in their
// own type by 16-byte `cp.async.cg` copies into a ring of three stages
// (rows past the length are zero-filled, not read): the block waits only
// for the stage it is about to use, while the next two tiles stay in flight
// behind its math.  The query-head group stays resident in shared memory,
// and each key row and each V row is read once for all heads of the group.
//
// * bf16 and fp16: `decode_split_mma_kernel`.  The products are `mma.sync`
//   m16n8k16 with the group padded to 16 rows (two m-tiles for groups of
//   17 to 32): S = Q K^T from ldmatrix fragments of Q and of each warp's 16
//   positions of a 64-position tile, the softmax on the accumulator
//   fragment (quad shuffles), P rounded to the input type as the A operand
//   of O += P V with V read by ldmatrix.trans.  Each warp keeps its own m,
//   l and accumulator over its positions, so a tile costs one block
//   barrier; the four warps' partials are merged once per chunk.  Tile rows
//   are swizzled (16-byte chunk ^ row % 8) so that ldmatrix reads distinct
//   banks.
// * float32: `decode_split_kernel` on the CUDA cores (TF32 would break the
//   2e-5 tolerance).  Tiles of 8 KB of K; eight threads share a key row,
//   each reading its 16-byte chunks once for every head of the group, and
//   the dot products are summed by shuffles among the eight; a warp per
//   head takes the tile's max and sum; a thread owns a 16-byte column
//   chunk of V for its heads.
//
// expf, not __expf, and no --use_fast_math.
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>
#include <cstring>
#include <type_traits>

#include "attention_types.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kStages = 3;        // ring of K/V tiles in shared memory
constexpr int kStageBytes = 8192; // one K (or V) tile of a stage

using repro_attention::from_float;
using repro_attention::kNegInf;
using repro_attention::to_float;

// 16-byte async copy global -> shared; src_bytes 0 fills the 16 bytes with zeros
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// the four floats at `p` (shared memory)
__device__ __forceinline__ void widen16(const float* p, float* x) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
}
// The shape of one instance: element type T, head dim HD, and at most
// kMaxR query heads per kv head.  Offsets in bytes of shared memory: the
// ring (stage st: K tile, then V tile, rows of HD elements), the group's
// queries as float32 (kMaxR x HD, chunk-interleaved, see `q_index`), the
// tile's scores (kMaxR x TP+4), and the running m, l and rescale factor.
template <typename T, int HD, int kMaxR>
struct Plan {
  static constexpr int EPC = 16 / static_cast<int>(sizeof(T));   // elements per chunk
  static constexpr int C = HD / EPC;                              // 16-byte chunks per row
  static constexpr int RB = HD * static_cast<int>(sizeof(T));     // bytes per row
  static constexpr int TP = kStageBytes / RB < 64 ? kStageBytes / RB : 64;   // positions per tile
  static constexpr int NG = kThreads / C;                   // head groups of the P V phase
  static constexpr int HPT = (kMaxR + NG - 1) / NG;         // heads per thread there
  static constexpr int PST = TP + 4;
  static constexpr int kQ = kStages * 2 * kStageBytes;
  static constexpr int kS = kQ + kMaxR * HD * 4;
  static constexpr int kM = kS + kMaxR * PST * 4;
  static constexpr int kL = kM + kMaxR * 4;
  static constexpr int kA = kL + kMaxR * 4;
  static constexpr int kBytes = kA + kMaxR * 4;
  static_assert(C % 8 == 0 && C <= kThreads, "eight threads share a row");
  static_assert(TP % 4 == 0 && 64 % TP == 0, "tiles split the 64-position chunks");
  static_assert(TP * RB <= kStageBytes, "a tile fits its stage");
};

// float4 index of head r's elements (c * EPC + 4 * part .. + 3) in the
// queries: the eight threads that share a key row read eight consecutive
// float4s for each (head, part)
template <int HD, int C>
__device__ __forceinline__ int q_index(int r, int part, int c) {
  return r * (HD / 4) + part * C + c;
}

template <typename T, int HD, int kMaxR>
__global__ void __launch_bounds__(kThreads)
decode_split_kernel(const T* __restrict__ q,             // (B, H, HD)
                    const T* __restrict__ k,             // (B, S, KVH, HD)
                    const T* __restrict__ v,             // (B, S, KVH, HD)
                    const int32_t* __restrict__ lengths, // (B,)
                    float* __restrict__ m_part,          // (B, KVH, n_split, rep)
                    float* __restrict__ l_part,          // (B, KVH, n_split, rep)
                    float* __restrict__ acc_part,        // (B, KVH, n_split, rep, HD)
                    int S, int H, int KVH, int chunk, int n_split, float scale) {
  using P = Plan<T, HD, kMaxR>;
  constexpr int EPC = P::EPC, C = P::C, RB = P::RB, TP = P::TP;
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
  uint8_t* smem = reinterpret_cast<uint8_t*>(smem4);
  const uint32_t ring = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  float* q_s = reinterpret_cast<float*>(smem + P::kQ);
  const float4* q4 = reinterpret_cast<const float4*>(q_s);
  float* s_s = reinterpret_cast<float*>(smem + P::kS);
  float* m_s = reinterpret_cast<float*>(smem + P::kM);
  float* l_s = reinterpret_cast<float*>(smem + P::kL);
  float* a_s = reinterpret_cast<float*>(smem + P::kA);

  const int t = threadIdx.x;
  const int lane = t % 32;
  const int warp = t / 32;

  const size_t row = static_cast<size_t>(KVH) * HD;
  const T* kb = k + static_cast<size_t>(b) * S * row + static_cast<size_t>(kh) * HD;
  const T* vb = v + static_cast<size_t>(b) * S * row + static_cast<size_t>(kh) * HD;
  const int n_tiles = (end - start + TP - 1) / TP;

  // tile i of the chunk into stage i % kStages, one commit group (empty past the end)
  auto issue = [&](int i) {
    if (i < n_tiles) {
      const int t0 = start + i * TP;
      const uint32_t kd = ring + (i % kStages) * 2 * kStageBytes;
#pragma unroll
      for (int n = 0; n < (TP * C + kThreads - 1) / kThreads; ++n) {
        const int id = t + n * kThreads;
        const int r = id / C, c = id % C;
        if (r < TP) {
          const bool ok = t0 + r < end;
          const size_t off = ok ? static_cast<size_t>(t0 + r) * row + c * EPC : 0;
          cp_async16(kd + r * RB + c * 16, kb + off, ok);
          cp_async16(kd + kStageBytes + r * RB + c * 16, vb + off, ok);
        }
      }
    }
    cp_async_commit();
  };
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) issue(i);

  const T* qg = q + (static_cast<size_t>(b) * H + static_cast<size_t>(kh) * rep) * HD;
  for (int i = t; i < kMaxR * HD; i += kThreads) {
    const int r = i / HD, e = i % HD;
    const int w = e % EPC;
    q_s[q_index<HD, C>(r, w / 4, e / EPC) * 4 + w % 4] = r < rep ? to_float(qg[i]) : 0.f;
  }
  for (int r = t; r < kMaxR; r += kThreads) {
    m_s[r] = kNegInf;
    l_s[r] = 0.f;
  }

  const int g = t % 8;               // score phase: lane g of the eight on rows t / 8 + 16 j
  const int pc = t % C;              // P V phase: column chunk pc of heads hg + NG * j
  const int hg = t / C;
  float acc[P::HPT][EPC];
#pragma unroll
  for (int j = 0; j < P::HPT; ++j)
#pragma unroll
    for (int e = 0; e < EPC; ++e) acc[j][e] = 0.f;

  for (int i = 0; i < n_tiles; ++i) {
    cp_async_wait<kStages - 2>();    // tile i has landed; i + 1 may be in flight
    __syncthreads();                 // ... for every thread; tile i - 1 is consumed
    issue(i + kStages - 1);          // into the stage tile i - 1 left
    const int t0 = start + i * TP;
    const int n = min(TP, end - t0);
    const uint8_t* k_t = smem + (i % kStages) * 2 * kStageBytes;
    const uint8_t* v_t = k_t + kStageBytes;

    // scores: a warp holds four whole rows (TP is a multiple of 4), so the
    // shuffles among a row's eight threads see the whole warp
    for (int p = t / 8; p < TP; p += kThreads / 8) {
      float dot[kMaxR];
#pragma unroll
      for (int r = 0; r < kMaxR; ++r) dot[r] = 0.f;
#pragma unroll
      for (int j = 0; j < C / 8; ++j) {
        const int c = g + 8 * j;
        float kx[EPC];
        widen16(reinterpret_cast<const T*>(k_t + p * RB + c * 16), kx);
#pragma unroll
        for (int r = 0; r < kMaxR; ++r) {
          if (r < rep) {
#pragma unroll
            for (int part = 0; part < EPC / 4; ++part) {
              const float4 qx = q4[q_index<HD, C>(r, part, c)];
              dot[r] = fmaf(qx.x, kx[4 * part], dot[r]);
              dot[r] = fmaf(qx.y, kx[4 * part + 1], dot[r]);
              dot[r] = fmaf(qx.z, kx[4 * part + 2], dot[r]);
              dot[r] = fmaf(qx.w, kx[4 * part + 3], dot[r]);
            }
          }
        }
      }
#pragma unroll
      for (int r = 0; r < kMaxR; ++r) {
        if (r < rep) {
          float x = dot[r];
          x += __shfl_xor_sync(0xffffffffu, x, 4);
          x += __shfl_xor_sync(0xffffffffu, x, 2);
          x += __shfl_xor_sync(0xffffffffu, x, 1);
          if ((r & 7) == g) s_s[r * P::PST + p] = p < n ? x * scale : kNegInf;
        }
      }
    }
    __syncthreads();

    // online softmax, one warp per head
    for (int r = warp; r < rep; r += kThreads / 32) {
      float* pr = s_s + r * P::PST;
      constexpr int U = (TP + 31) / 32;
      float x[U];
      float mx = kNegInf;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int pos = lane + 32 * u;
        x[u] = pos < TP ? pr[pos] : kNegInf;
        mx = fmaxf(mx, x[u]);
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int pos = lane + 32 * u;
        const float p = pos < n ? expf(x[u] - m_new) : 0.f;
        if (pos < TP) pr[pos] = p;
        sum += p;
      }
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

    // acc = acc * alpha + P V; positions past n have p = 0 and zero-filled v
#pragma unroll
    for (int j = 0; j < P::HPT; ++j) {
      const int r = hg + P::NG * j;
      if (r < rep) {
        const float alpha = a_s[r];
#pragma unroll
        for (int e = 0; e < EPC; ++e) acc[j][e] *= alpha;
      }
    }
    const int n4 = (n + 3) & ~3;
    for (int p = 0; p < n4; p += 4) {
      float vx[4][EPC];
#pragma unroll
      for (int u = 0; u < 4; ++u)
        widen16(reinterpret_cast<const T*>(v_t + (p + u) * RB + pc * 16), vx[u]);
#pragma unroll
      for (int j = 0; j < P::HPT; ++j) {
        const int r = hg + P::NG * j;
        if (r < rep) {
          const float4 pp = *reinterpret_cast<const float4*>(s_s + r * P::PST + p);
#pragma unroll
          for (int e = 0; e < EPC; ++e) {
            float a = acc[j][e];
            a = fmaf(pp.x, vx[0][e], a);
            a = fmaf(pp.y, vx[1][e], a);
            a = fmaf(pp.z, vx[2][e], a);
            a = fmaf(pp.w, vx[3][e], a);
            acc[j][e] = a;
          }
        }
      }
    }
  }

  const size_t part = (static_cast<size_t>(b) * KVH + kh) * n_split + split;
#pragma unroll
  for (int j = 0; j < P::HPT; ++j) {
    const int r = hg + P::NG * j;
    if (r < rep) {
      float4* dst = reinterpret_cast<float4*>(acc_part + (part * rep + r) * HD + pc * EPC);
#pragma unroll
      for (int e = 0; e < EPC; e += 4)
        dst[e / 4] = make_float4(acc[j][e], acc[j][e + 1], acc[j][e + 2], acc[j][e + 3]);
    }
  }
  for (int r = t; r < rep; r += kThreads) {
    m_part[part * rep + r] = m_s[r];
    l_part[part * rep + r] = l_s[r];
  }
}

// ---------------------------------------------------------------------------
// bf16 and fp16: decode_split_mma_kernel, the products on mma.sync.

constexpr int kMmaTile = 64;      // cache positions per tile: 16 for each of the 4 warps

// Byte offset of the 16-byte chunk c of row r in a tile of rows of RB bytes,
// the chunk index XOR-ed with r % 8 so that ldmatrix's eight rows of one
// chunk fall on distinct banks
template <int RB>
__device__ __forceinline__ uint32_t swz(int r, int c) {
  return static_cast<uint32_t>(r * RB + ((c ^ (r % 8)) * 16));
}

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t* x) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(x[0]), "=r"(x[1]), "=r"(x[2]), "=r"(x[3])
               : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t addr, uint32_t* x) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(x[0]), "=r"(x[1]), "=r"(x[2]), "=r"(x[3])
               : "r"(addr));
}

// d (16 x 8, float32) += a (16 x 16) b (16 x 8), both of T
template <typename T>
__device__ __forceinline__ void mma16816(float* d, const uint32_t* a, const uint32_t* b) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
        "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  } else {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 {%0, %1, %2, %3}, "
        "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  }
}

// two floats rounded to T, the first in the low half
template <typename T>
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  uint32_t u;
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    const __nv_bfloat162 x = __floats2bfloat162_rn(lo, hi);
    memcpy(&u, &x, 4);
  } else {
    const __half2 x = __floats2half2_rn(lo, hi);
    memcpy(&u, &x, 4);
  }
  return u;
}

// The group's queries are MT m-tiles of 16 rows (heads past rep are zero
// rows).  Each warp owns 16 positions of every tile and keeps its own
// running m, l and accumulator for them (as a split inside the block); the
// four warps' partials are merged once, at the end of the chunk.
template <typename T, int HD, int MT>
__global__ void __launch_bounds__(kThreads)
decode_split_mma_kernel(const T* __restrict__ q,             // (B, H, HD)
                        const T* __restrict__ k,             // (B, S, KVH, HD)
                        const T* __restrict__ v,             // (B, S, KVH, HD)
                        const int32_t* __restrict__ lengths, // (B,)
                        float* __restrict__ m_part,          // (B, KVH, n_split, rep)
                        float* __restrict__ l_part,          // (B, KVH, n_split, rep)
                        float* __restrict__ acc_part,        // (B, KVH, n_split, rep, HD)
                        int S, int H, int KVH, int chunk, int n_split, float scale) {
  static_assert(HD % 64 == 0, "head dims 64, 128, 256");
  constexpr int RB = HD * 2;                 // bytes per row
  constexpr int C = HD / 8;                  // 16-byte chunks per row
  constexpr int kTileBytes = kMmaTile * RB;  // one K or V tile
  constexpr int NT = HD / 8;                 // n-tiles of the output

  const int split = blockIdx.x;
  const int kh = blockIdx.y;
  const int b = blockIdx.z;
  const int rep = H / KVH;
  const int len = min(max(lengths[b], 0), S);
  const int start = split * chunk;
  if (start >= len) return;          // the whole block: nothing of this chunk is valid
  const int end = min(start + chunk, len);

  extern __shared__ float4 smem4[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(smem4);
  const uint32_t ring = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  const uint32_t q_s = ring + kStages * 2 * kTileBytes;

  const int t = threadIdx.x;
  const int lane = t % 32;
  const int warp = t / 32;

  const size_t row = static_cast<size_t>(KVH) * HD;
  const T* kb = k + static_cast<size_t>(b) * S * row + static_cast<size_t>(kh) * HD;
  const T* vb = v + static_cast<size_t>(b) * S * row + static_cast<size_t>(kh) * HD;
  const T* qg = q + (static_cast<size_t>(b) * H + static_cast<size_t>(kh) * rep) * HD;
  const int n_tiles = (end - start + kMmaTile - 1) / kMmaTile;

  // the queries, rows past rep zero-filled; then tile i into stage i % kStages
  for (int id = t; id < 16 * MT * C; id += kThreads) {
    const int r = id / C, c = id % C;
    cp_async16(q_s + swz<RB>(r, c), qg + (r < rep ? r * HD + c * 8 : 0), r < rep);
  }
  auto issue = [&](int i) {
    if (i < n_tiles) {
      const int t0 = start + i * kMmaTile;
      const uint32_t kd = ring + (i % kStages) * 2 * kTileBytes;
#pragma unroll
      for (int n = 0; n < kMmaTile * C / kThreads; ++n) {
        const int id = t + n * kThreads;
        const int r = id / C, c = id % C;
        const bool ok = t0 + r < end;
        const size_t off = ok ? static_cast<size_t>(t0 + r) * row + c * 8 : 0;
        cp_async16(kd + swz<RB>(r, c), kb + off, ok);
        cp_async16(kd + kTileBytes + swz<RB>(r, c), vb + off, ok);
      }
    }
    cp_async_commit();
  };
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) issue(i);   // the queries travel with tile 0

  // this thread's rows of m-tile mt: 16 mt + lane / 4 and 16 mt + lane / 4 + 8
  float m[MT][2], l[MT][2], o[MT][NT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      m[mt][hr] = kNegInf;
      l[mt][hr] = 0.f;
    }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[mt][nt][e] = 0.f;
  }

  const int p0 = warp * 16;          // this warp's positions in every tile
  for (int i = 0; i < n_tiles; ++i) {
    cp_async_wait<kStages - 2>();    // tile i has landed; i + 1 may be in flight
    __syncthreads();                 // ... for every thread; tile i - 1 is consumed
    issue(i + kStages - 1);          // into the stage tile i - 1 left
    const int t0 = start + i * kMmaTile;
    const uint32_t k_t = ring + (i % kStages) * 2 * kTileBytes;
    const uint32_t v_t = k_t + kTileBytes;

#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      // scores of 16 heads x this warp's 16 positions: two n-tiles of 8
      float s[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        uint32_t a[4], bk[4];
        ldsm_x4(q_s + swz<RB>(16 * mt + lane % 16, 2 * kk + lane / 16), a);
        ldsm_x4(k_t + swz<RB>(p0 + lane % 8 + (lane / 16) * 8, 2 * kk + (lane / 8) % 2), bk);
        mma16816<T>(s[0], a, bk);
        mma16816<T>(s[1], a, bk + 2);
      }
      // element e of n-tile nt: row lane / 4 + 8 * (e / 2),
      // position p0 + 8 nt + 2 (lane % 4) + e % 2
      float mx[2] = {kNegInf, kNegInf};
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool ok = t0 + p0 + 8 * nt + 2 * (lane % 4) + e % 2 < end;
          s[nt][e] = ok ? s[nt][e] * scale : kNegInf;
          mx[e / 2] = fmaxf(mx[e / 2], s[nt][e]);
        }
      float m_new[2], shift[2];
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        mx[hr] = fmaxf(mx[hr], __shfl_xor_sync(0xffffffffu, mx[hr], 1));
        mx[hr] = fmaxf(mx[hr], __shfl_xor_sync(0xffffffffu, mx[hr], 2));
        m_new[hr] = fmaxf(m[mt][hr], mx[hr]);
        // while every position so far is masked, shift by 0 so that expf(-1e30)
        // gives the masked probabilities exactly 0
        shift[hr] = m_new[hr] == kNegInf ? 0.f : m_new[hr];
        const float alpha = expf(m[mt][hr] - m_new[hr]);
        m[mt][hr] = m_new[hr];
        l[mt][hr] *= alpha;          // this thread's share; the quad is summed at the end
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          o[mt][nt][2 * hr] *= alpha;
          o[mt][nt][2 * hr + 1] *= alpha;
        }
      }
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[nt][e] = expf(s[nt][e] - shift[e / 2]);
          l[mt][e / 2] += s[nt][e];
        }
      // P in T: the two n-tiles' accumulators are the A operand over 16 positions
      const uint32_t pa[4] = {pack2<T>(s[0][0], s[0][1]), pack2<T>(s[0][2], s[0][3]),
                              pack2<T>(s[1][0], s[1][1]), pack2<T>(s[1][2], s[1][3])};
#pragma unroll
      for (int nt = 0; nt < NT; nt += 2) {
        uint32_t bv[4];
        ldsm_x4_trans(v_t + swz<RB>(p0 + lane % 8 + ((lane / 8) % 2) * 8, nt + lane / 16), bv);
        mma16816<T>(o[mt][nt], pa, bv);
        mma16816<T>(o[mt][nt + 1], pa, bv + 2);
      }
    }
  }

  // merge the four warps' partials through shared memory (the ring is done)
  cp_async_wait<0>();
  __syncthreads();
  float* w_o = reinterpret_cast<float*>(smem);                 // (4, 16 MT, HD)
  float* w_m = w_o + 4 * 16 * MT * HD;                         // (4, 16 MT)
  float* w_l = w_m + 4 * 16 * MT;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      float lw = l[mt][hr];
      lw += __shfl_xor_sync(0xffffffffu, lw, 1);
      lw += __shfl_xor_sync(0xffffffffu, lw, 2);
      const int r = 16 * mt + lane / 4 + 8 * hr;
      if (lane % 4 == 0) {
        w_m[warp * 16 * MT + r] = m[mt][hr];
        w_l[warp * 16 * MT + r] = lw;
      }
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        float* dst = w_o + (warp * 16 * MT + r) * HD + 8 * nt + 2 * (lane % 4);
        dst[0] = o[mt][nt][2 * hr];
        dst[1] = o[mt][nt][2 * hr + 1];
      }
    }
  }
  __syncthreads();
  const size_t part = (static_cast<size_t>(b) * KVH + kh) * n_split + split;
  for (int id = t; id < rep * HD; id += kThreads) {
    const int r = id / HD, d = id % HD;
    float mm = kNegInf;
#pragma unroll
    for (int w = 0; w < 4; ++w) mm = fmaxf(mm, w_m[w * 16 * MT + r]);
    float ll = 0.f, acc = 0.f;
#pragma unroll
    for (int w = 0; w < 4; ++w) {
      const float wt = expf(w_m[w * 16 * MT + r] - mm);
      ll = fmaf(w_l[w * 16 * MT + r], wt, ll);
      acc = fmaf(w_o[(w * 16 * MT + r) * HD + d], wt, acc);
    }
    acc_part[(part * rep + r) * HD + d] = acc;
    if (d == 0) {
      m_part[part * rep + r] = mm;
      l_part[part * rep + r] = ll;
    }
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

// The split pass `kernel` with `smem` bytes of shared memory, then the merge
template <typename T, typename Kernel>
cudaError_t launch(Kernel kernel, size_t smem, const void* q, const void* k, const void* v,
                   const int32_t* lengths, void* out, float* m_part, float* l_part,
                   float* acc_part, int B, int S, int H, int KVH, int HD, int chunk,
                   int n_split, float scale, cudaStream_t stream) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  kernel<<<dim3(n_split, KVH, B), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), lengths,
      m_part, l_part, acc_part, S, H, KVH, chunk, n_split, scale);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  decode_combine_kernel<T><<<dim3(H, B), HD, 0, stream>>>(
      lengths, m_part, l_part, acc_part, static_cast<T*>(out), S, H, KVH, HD, chunk, n_split);
  return cudaGetLastError();
}

// the float32 split pass for groups of up to kMaxR heads
template <typename T, int HD, int kMaxR>
cudaError_t launch_simt(const void* q, const void* k, const void* v, const int32_t* lengths,
                        void* out, float* m_part, float* l_part, float* acc_part, int B, int S,
                        int H, int KVH, int chunk, int n_split, float scale,
                        cudaStream_t stream) {
  return launch<T>(decode_split_kernel<T, HD, kMaxR>, Plan<T, HD, kMaxR>::kBytes, q, k, v,
                   lengths, out, m_part, l_part, acc_part, B, S, H, KVH, HD, chunk, n_split,
                   scale, stream);
}

// the bf16 / fp16 split pass for MT m-tiles of 16 heads
template <typename T, int HD, int MT>
cudaError_t launch_mma(const void* q, const void* k, const void* v, const int32_t* lengths,
                       void* out, float* m_part, float* l_part, float* acc_part, int B, int S,
                       int H, int KVH, int chunk, int n_split, float scale,
                       cudaStream_t stream) {
  return launch<T>(decode_split_mma_kernel<T, HD, MT>,
                   static_cast<size_t>(kStages * 2 * kMmaTile + 16 * MT) * HD * 2, q, k, v,
                   lengths, out, m_part, l_part, acc_part, B, S, H, KVH, HD, chunk, n_split,
                   scale, stream);
}

// Largest query-head group (H / KVH) an instance takes at head dim `hd`.
__host__ __device__ constexpr int max_rep(int hd) { return hd == 64 ? 32 : 16; }

template <typename T, int HD>
cudaError_t launch_r(const void* q, const void* k, const void* v, const int32_t* lengths,
                     void* out, float* m_part, float* l_part, float* acc_part, int B, int S,
                     int H, int KVH, int chunk, int n_split, float scale, cudaStream_t stream) {
  const int rep = H / KVH;
  if constexpr (!std::is_same<T, float>::value) {   // bf16, fp16: one or two m-tiles of 16 heads
    if (rep <= 16) {
      return launch_mma<T, HD, 1>(q, k, v, lengths, out, m_part, l_part, acc_part, B, S, H,
                                  KVH, chunk, n_split, scale, stream);
    }
    if constexpr (max_rep(HD) >= 32) {
      if (rep <= 32) {
        return launch_mma<T, HD, 2>(q, k, v, lengths, out, m_part, l_part, acc_part, B, S, H,
                                    KVH, chunk, n_split, scale, stream);
      }
    }
  } else {                                           // float32: groups of 4, 8, 16 or 32
    if (rep <= 4) {
      return launch_simt<T, HD, 4>(q, k, v, lengths, out, m_part, l_part, acc_part, B, S, H, KVH,
                              chunk, n_split, scale, stream);
    }
    if (rep <= 8) {
      return launch_simt<T, HD, 8>(q, k, v, lengths, out, m_part, l_part, acc_part, B, S, H, KVH,
                              chunk, n_split, scale, stream);
    }
    if (rep <= 16) {
      return launch_simt<T, HD, 16>(q, k, v, lengths, out, m_part, l_part, acc_part, B, S, H, KVH,
                               chunk, n_split, scale, stream);
    }
    if constexpr (max_rep(HD) >= 32) {
      if (rep <= 32) {
        return launch_simt<T, HD, 32>(q, k, v, lengths, out, m_part, l_part, acc_part, B, S, H,
                                 KVH, chunk, n_split, scale, stream);
      }
    }
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
// rep) and acc_part (B, KVH, n_split, rep, HD), with n_split * chunk >= S;
// q, the caches and acc_part 16-byte aligned.
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
  if ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
       reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(acc_part)) % 16 != 0) {
    return cudaErrorInvalidValue;   // the 16-byte copies and stores need aligned rows
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
    case 64: return max_rep(64);
    case 128: return max_rep(128);
    case 256: return max_rep(256);
    default: return 0;
  }
}
