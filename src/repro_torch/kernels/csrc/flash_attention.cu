// K3: flash attention (causal, sliding-window or full; GQA), hand-written for
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_flash_kernel` behind `flash_attention`
// (src/repro/kernels/flash_attention.py:94, body :32).  Its plain PyTorch
// version is `flash_attention_plain` (src/repro_torch/kernels/
// flash_attention.py); the two agree to the reference's tolerances (2e-5 in
// float32, 2e-2 in bf16 and fp16).
//
// What it computes.  For every (batch b, query head h, query row i):
// softmax over the keys j that the mask admits of (q_i . k_j) * scale,
// applied to v, where k and v are read from kv head h / (H / KVH).  The mask
// is the reference's: j <= i when causal, j > i - window when window > 0.
// K and V hold S_kv rows of their own: S_kv == S wherever a mask applies,
// and may differ in a full (non-causal, unwindowed) call, cross-attention's
// S queries over S_kv memory rows.
// Masked scores are set to -1e30 and their probabilities to 0, m, l and the
// accumulator are float32 and carried across key tiles (online softmax), and
// the output is acc / max(l, 1e-30), stored in the input type, so a row
// with no admitted key comes out zero.
//
// What bounds it on this card.  Operations: 4 * H * hd flops per admitted
// (i, j) pair against 3 * hd * (H or KVH) elements read per row, hundreds
// of flops per byte at the model widths it serves (hd 64 to 256, S in the
// thousands), far above the card's ridge point.  In bf16 and fp16 the bound
// is the tensor cores' 989 TFLOP/s; in float32 it is the CUDA cores' 67
// TFLOP/s, since TF32 (495 TFLOP/s, ten mantissa bits) would break the
// float32 tolerance of 2e-5.
//
// What the design does about it.  Two kernels behind one entry point,
// picked by the element type:
//
// * bf16 and fp16: `flash_wgmma_kernel`, in the FlashAttention-2/3 shape.
//   A block owns (b, h, 128 query rows) and is two warpgroups of 64 rows
//   each, so every K/V tile it loads serves 128 queries.  S = Q K^T is a
//   `wgmma` m64nBKk16 with Q and K both in shared memory (K-major, 128-byte
//   swizzle, descriptors built here) and the sum in float32 registers.  The
//   softmax runs on that accumulator fragment: a thread holds two rows, and
//   the row max and sum are quad shuffles.  P is rounded to the input type
//   in registers, where the accumulator layout already is the A operand's,
//   and O += P V is a register-A `wgmma` with V read from shared memory as
//   an MN-major (transposed) B operand.  Q, K and V arrive in their own
//   type by TMA: 4-D tensor maps over the (B, S, heads, hd) layouts read
//   the rows in place, in boxes of 64 columns with the 128-byte swizzle,
//   and fill rows past S with zeros.  K and V go through a ring of three
//   stages with a "full" and an "empty" mbarrier each: thread 0 issues tile
//   j+1 while tile j's products run, once every thread has released the
//   tile it replaces, so the two warpgroups never wait on a block barrier.
//   The third stage holds tile j-1's V for the P V that runs behind tile
//   j's scores: inside a warpgroup the schedule is FlashAttention-3's, issue
//   S_j, issue O += P_{j-1} V_{j-1}, wait for S_j only, and run tile j's
//   softmax while the tensor cores do that P V; then rescale O and round
//   P_j.  Q is loaded once.  Key tiles are 128 wide at hd 64 and 128, 32
//   wide at hd 256, which keeps the accumulators in registers (at most
//   128 + 16 floats a thread) and the ring in shared memory.  Tiles the
//   mask empties for the whole block are never loaded; only the diagonal
//   tile, the window's edge tile and the ragged tail (S not a multiple of
//   the tile) apply the mask; interior tiles run unmasked.  The mask is
//   applied by selects, and every branch around a wgmma depends on the
//   block alone: the compiler serializes wgmma on a path that may diverge.
// * float32: `flash_kernel`, on the CUDA cores.  A block owns (b, h, 64
//   query rows) and loops over 64-key tiles with m, l and the accumulator in
//   registers; 256 threads as 16 x 16, each a 4 x 4 block of scores from
//   float4 reads and 4 rows x hd/16 output columns, row max and sum by
//   half-warp shuffles.  It is K3 as first ported, unchanged.
//
// Both skip the key tiles that the mask empties, run query tiles
// longest-first so the causal triangle's long rows do not trail, read rows
// in place from the (B, S, H, hd) layout, and take any S >= 1.  expf, not
// __expf, and no --use_fast_math.
#include <cuda.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>
#include <cstring>
#include <type_traits>

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
             const T* __restrict__ k,      // (B, S_kv, KVH, HD)
             const T* __restrict__ v,      // (B, S_kv, KVH, HD)
             T* __restrict__ out,          // (B, S, H, HD)
             int S, int S_kv, int H, int KVH, int causal, int window, float scale) {
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
  const T* kb = k + static_cast<size_t>(b) * S_kv * kv_row + static_cast<size_t>(kh) * HD;
  const T* vb = v + static_cast<size_t>(b) * S_kv * kv_row + static_cast<size_t>(kh) * HD;

  for (int i = tid; i < kBQ * HD; i += kThreads) {
    const int r = i / HD, c = i % HD;
    q_s[r * QS + c] = q0 + r < S ? to_float(qb[static_cast<size_t>(q0 + r) * q_row + c]) : 0.f;
  }

  // the key tiles that hold an admitted key for some row of this block
  int kt_lo = 0;
  int kt_hi = (S_kv + kBK - 1) / kBK;
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
      kv_s[r * QS + c] = k0 + r < S_kv ? to_float(kb[static_cast<size_t>(k0 + r) * kv_row + c])
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
        ok[j] = kp < S_kv && (!causal || kp <= qp) && (window <= 0 || kp > qp - window);
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
      kv_s[r * HD + c] = k0 + r < S_kv ? to_float(vb[static_cast<size_t>(k0 + r) * kv_row + c])
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
cudaError_t launch(const void* q, const void* k, const void* v, void* out, int B, int S,
                   int S_kv, int H, int KVH, int causal, int window, float scale,
                   cudaStream_t stream) {
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
      static_cast<T*>(out), S, S_kv, H, KVH, causal, window, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_hd(const void* q, const void* k, const void* v, void* out, int B, int S,
                      int S_kv, int H, int KVH, int HD, int causal, int window, float scale,
                      cudaStream_t stream) {
  switch (HD) {
    case 64: return launch<T, 64>(q, k, v, out, B, S, S_kv, H, KVH, causal, window, scale, stream);
    case 128:
      return launch<T, 128>(q, k, v, out, B, S, S_kv, H, KVH, causal, window, scale, stream);
    case 256:
      return launch<T, 256>(q, k, v, out, B, S, S_kv, H, KVH, causal, window, scale, stream);
    default: return cudaErrorInvalidValue;
  }
}


// ---------------------------------------------------------------------------
// bf16 and fp16: flash_wgmma_kernel on the tensor cores.

constexpr int kTcBQ = 128;        // query rows per block: two warpgroups of 64
constexpr int kTcThreads = 256;
constexpr int kTcStages = 3;      // K/V ring: the tile loading, the tile in S, the tile in P V

// mbarriers in shared memory, and the TMA load that completes on one
__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
// arrive, and expect `bytes` more from TMA loads before the phase completes
__device__ __forceinline__ void mbar_expect(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}
// wait until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}
// one box of a 4-D tensor map into shared memory, completing on `bar`
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, int c0, int c1,
                                         int c2, int c3, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(bar)
      : "memory");
}

// A tile of ROWS rows of 16-bit elements sits in shared memory as HD / 64
// column blocks of ROWS rows of 128 bytes, each written by one TMA box with
// the 128-byte swizzle (the 16-byte chunk c of row r at c ^ (r % 8)): the
// canonical SW128 layout wgmma reads, in 8-row atoms of 1024 bytes.

// wgmma shared-memory matrix descriptor, 128-byte swizzle: start address,
// leading byte offset (K-major: unused; MN-major: the stride between
// 64-element column blocks), stride byte offset 1024 (between 8-row atoms).
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo_bytes) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo_bytes >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keeps the compiler from moving reads or writes of accumulator registers
// across the asynchronous wgmma that owns them
template <int N>
__device__ __forceinline__ void fence_regs(float* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// wgmma.mma_async of one shape and type; the accumulator fragment is d
__device__ __forceinline__ void wgmma_ss_n32_bf16(float* d, uint64_t da, uint64_t db,
                                                   int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15 "
      "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_ss_n128_bf16(float* d, uint64_t da, uint64_t db,
                                                   int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63 "
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_rs_n64_bf16(float* d, const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31 "
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db));
}

__device__ __forceinline__ void wgmma_ss_n32_f16(float* d, uint64_t da, uint64_t db,
                                                   int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.f16.f16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15 "
      "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_ss_n128_f16(float* d, uint64_t da, uint64_t db,
                                                   int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.f16.f16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63 "
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_rs_n64_f16(float* d, const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.f16.f16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31 "
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db));
}

template <typename T>
constexpr bool kIsBf16 = std::is_same<T, __nv_bfloat16>::value;

// S (64 x N) = Q (64 x 16) K^T (16 x N), both operands K-major in shared memory
template <typename T, int N>
__device__ __forceinline__ void mma_qk(float* d, uint64_t da, uint64_t db, int scale_d) {
  static_assert(N == 32 || N == 128, "key tiles of 32 or 128");
  if constexpr (N == 32) {
    if constexpr (kIsBf16<T>) wgmma_ss_n32_bf16(d, da, db, scale_d);
    else wgmma_ss_n32_f16(d, da, db, scale_d);
  } else {
    if constexpr (kIsBf16<T>) wgmma_ss_n128_bf16(d, da, db, scale_d);
    else wgmma_ss_n128_f16(d, da, db, scale_d);
  }
}

// O (64 x 64) += P (64 x 16, registers) V (16 x 64, MN-major in shared memory)
template <typename T>
__device__ __forceinline__ void mma_pv(float* d, const uint32_t* a, uint64_t db) {
  if constexpr (kIsBf16<T>) wgmma_rs_n64_bf16(d, a, db);
  else wgmma_rs_n64_f16(d, a, db);
}

// two floats rounded to the input type, the first in the low half
template <typename T>
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  uint32_t u;
  if constexpr (kIsBf16<T>) {
    const __nv_bfloat162 x = __floats2bfloat162_rn(lo, hi);
    memcpy(&u, &x, 4);
  } else {
    const __half2 x = __floats2half2_rn(lo, hi);
    memcpy(&u, &x, 4);
  }
  return u;
}

template <typename T, int HD, int BK>
__global__ void __launch_bounds__(kTcThreads, 1)
flash_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,   // q (B, S, H, HD)
                   const __grid_constant__ CUtensorMap tm_k,   // k (B, S_kv, KVH, HD)
                   const __grid_constant__ CUtensorMap tm_v,   // v (B, S_kv, KVH, HD)
                   T* __restrict__ out,                        // (B, S, H, HD)
                   int S, int S_kv, int H, int KVH, int causal, int window, float scale) {
  static_assert(HD % 64 == 0 && HD <= 256, "head dims 64, 128, 256");
  constexpr int kQBytes = kTcBQ * HD * 2;
  constexpr int kKVBytes = BK * HD * 2;      // one K or V tile
  constexpr int NS = BK / 2;                 // score accumulator floats a thread
  constexpr int NO = HD / 2;                 // output accumulator floats a thread
  constexpr int NP = BK / 16 * 4;            // P fragment registers a thread

  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw)) + 1023u) &
                        ~1023u;
  const uint32_t q_s = base;                  // (kTcBQ, HD), then stage st: K, V
  auto k_s = [&](int st) { return base + kQBytes + st * 2 * kKVBytes; };
  auto v_s = [&](int st) { return base + kQBytes + st * 2 * kKVBytes + kKVBytes; };
  // after the ring: a "full" barrier per stage (its TMA loads landed), an
  // "empty" one (every thread is done with it), and Q's
  const uint32_t bars = base + kQBytes + 2 * kTcStages * kKVBytes;
  auto full = [&](int st) { return bars + 8 * st; };
  auto empty = [&](int st) { return bars + 8 * (kTcStages + st); };
  const uint32_t q_bar = bars + 16 * kTcStages;

  const int n_q = (S + kTcBQ - 1) / kTcBQ;
  const int q0 = (n_q - 1 - static_cast<int>(blockIdx.x)) * kTcBQ;   // longest rows first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kh = h / (H / KVH);
  const int tid = threadIdx.x;
  const int wg = tid / 128;                   // warpgroup: query rows wq0 .. wq0 + 63
  const int warp = (tid % 128) / 32;
  const int lane = tid % 32;
  const int wq0 = q0 + 64 * wg;
  const int wq_last = min(wq0 + 63, S - 1);   // below wq0 when the rows are all past S
  const int row0 = wq0 + warp * 16 + lane / 4;   // this thread's rows: row0 and row0 + 8
  const int q_last = min(q0 + kTcBQ, S) - 1;
  const size_t q_row = static_cast<size_t>(H) * HD;

  // the key tiles that hold an admitted key for some row of this block
  int kt_lo = 0;
  int kt_hi = (S_kv + BK - 1) / BK;
  if (causal) kt_hi = min(kt_hi, q_last / BK + 1);
  if (window > 0) kt_lo = max(0, (q0 - window + 1) / BK);

  // thread 0 loads: tile it into stage it % kTcStages, once every thread is
  // done with the tile it replaces (rows past S_kv arrive as zeros)
  auto produce = [&](int it) {
    const int st = it % kTcStages, use = it / kTcStages;
    if (use > 0) mbar_wait(empty(st), (use - 1) & 1);
    mbar_expect(full(st), 2 * kKVBytes);
    const int k0 = (kt_lo + it) * BK;
#pragma unroll
    for (int c = 0; c < HD; c += 64) {
      tma_load(k_s(st) + (c / 64) * (BK * 128), &tm_k, c, kh, k0, b, full(st));
      tma_load(v_s(st) + (c / 64) * (BK * 128), &tm_v, c, kh, k0, b, full(st));
    }
  };
  if (tid == 0) {
    for (int st = 0; st < kTcStages; ++st) {
      mbar_init(full(st), 1);
      mbar_init(empty(st), kTcThreads);
    }
    mbar_init(q_bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect(q_bar, kQBytes);
#pragma unroll
    for (int c = 0; c < HD; c += 64)
      tma_load(q_s + (c / 64) * (kTcBQ * 128), &tm_q, c, h, q0, b, q_bar);
    produce(0);
  }

  float o[NO], s[NS];
  uint32_t pa[NP];                            // P of the last tile, rounded to T
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < NO; ++i) o[i] = 0.f;
#pragma unroll
  for (int i = 0; i < NS; ++i) s[i] = 0.f;

  // Every branch around a wgmma below depends on the block alone, never on
  // the thread: a wgmma on a path the compiler must treat as divergent is
  // serialized.  So the first tile is peeled off the loop, and a warpgroup
  // with no admitted key in a tile computes it all the same (masked).

  // start tile it + 1, then wait for tile it
  auto next_tile = [&](int it) {
    if (tid == 0 && kt_lo + it + 1 < kt_hi) produce(it + 1);
    mbar_wait(full(it % kTcStages), (it / kTcStages) & 1);
  };
  // S = Q K^T of the tile in stage st
  auto issue_s = [&](int st) {
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      const int c = kk * 16;
      const uint64_t da =
          sw128_desc(q_s + (c / 64) * (kTcBQ * 128) + wg * 64 * 128 + (c % 64) * 2, 16);
      const uint64_t db = sw128_desc(k_s(st) + (c / 64) * (BK * 128) + (c % 64) * 2, 16);
      mma_qk<T, BK>(s, da, db, kk > 0);
    }
    wgmma_commit();
  };
  // O += P V, V in stage st
  auto issue_pv = [&](int st) {
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
#pragma unroll
      for (int hb = 0; hb < HD / 64; ++hb) {
        const uint64_t db = sw128_desc(v_s(st) + hb * (BK * 128) + kk * 16 * 128, BK * 128);
        mma_pv<T>(o + hb * 32, pa + 4 * kk, db);
      }
    }
    wgmma_commit();
  };
  // the online softmax of tile kt on s: s becomes the probabilities, m and l
  // move on, and alpha is what O must be scaled by
  auto softmax = [&](int kt, float* alpha) {
    const int k0 = kt * BK;
    // every (row, key) pair of the tile admitted: no mask
    const bool full = k0 + BK <= S_kv && (!causal || k0 + BK - 1 <= wq0) &&
                      (window <= 0 || k0 > wq_last - window);
    // accumulator element i: row row0 + 8 * ((i / 2) % 2), key k0 + 8 * (i / 4) +
    // 2 * (lane % 4) + i % 2.  Masked scores become -1e30 by selects.
    if (full) {
#pragma unroll
      for (int i = 0; i < NS; ++i) s[i] *= scale;
    } else {
#pragma unroll
      for (int i = 0; i < NS; ++i) {
        const int kp = k0 + (i / 4) * 8 + 2 * (lane % 4) + (i % 2);
        const int qp = row0 + 8 * ((i / 2) % 2);
        const bool ok = kp < S_kv && (!causal || kp <= qp) && (window <= 0 || kp > qp - window);
        s[i] = ok ? s[i] * scale : kNegInf;
      }
    }
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int i = 0; i < NS; ++i) mx[(i / 2) % 2] = fmaxf(mx[(i / 2) % 2], s[i]);
    // m_new, and the shift the probabilities take: m_new, or 0 while every key
    // of the row so far is masked, so that a masked score's expf(-1e30 - shift)
    // is exactly 0 (its probability zeroed) and an admitted one's is exact
    float m_new[2], shift[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      mx[hr] = fmaxf(mx[hr], __shfl_xor_sync(0xffffffffu, mx[hr], 1));
      mx[hr] = fmaxf(mx[hr], __shfl_xor_sync(0xffffffffu, mx[hr], 2));
      m_new[hr] = fmaxf(m[hr], mx[hr]);
      shift[hr] = m_new[hr] == kNegInf ? 0.f : m_new[hr];
    }
#pragma unroll
    for (int i = 0; i < NS; ++i) {
      const int hr = (i / 2) % 2;
      s[i] = expf(s[i] - shift[hr]);
      sum[hr] += s[i];
    }
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      sum[hr] += __shfl_xor_sync(0xffffffffu, sum[hr], 1);
      sum[hr] += __shfl_xor_sync(0xffffffffu, sum[hr], 2);
      alpha[hr] = expf(m[hr] - m_new[hr]);
      l[hr] = l[hr] * alpha[hr] + sum[hr];
      m[hr] = m_new[hr];
    }
  };
  // O *= alpha, and P in the input type: the accumulator's layout over keys
  // 16 kk .. 16 kk + 15 is the A operand's fragment for that k-step
  auto rescale_and_round = [&](const float* alpha) {
#pragma unroll
    for (int i = 0; i < NO; ++i) o[i] *= alpha[(i / 2) % 2];
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        pa[4 * kk + j] = pack2<T>(s[8 * kk + 2 * j], s[8 * kk + 2 * j + 1]);
    }
  };

  float alpha[2];
  mbar_wait(q_bar, 0);
  next_tile(0);             // the first tile: its scores and softmax
  fence_regs<NS>(s);
  wgmma_fence();
  issue_s(0);
  wgmma_wait<0>();
  fence_regs<NS>(s);
  softmax(kt_lo, alpha);
  rescale_and_round(alpha);
  for (int kt = kt_lo + 1; kt < kt_hi; ++kt) {
    // S of this tile, then the last tile's P V behind it: the tensor cores
    // run that P V while this tile's softmax runs
    const int it = kt - kt_lo;
    next_tile(it);
    fence_regs<NS>(s);
    fence_regs<NO>(o);
    fence_regs<NP>(pa);
    wgmma_fence();
    issue_s(it % kTcStages);
    issue_pv((it - 1) % kTcStages);
    wgmma_wait<1>();        // S is done; the P V may still run
    fence_regs<NS>(s);
    softmax(kt, alpha);
    wgmma_wait<0>();        // the P V is done with o, pa and tile it - 1
    fence_regs<NO>(o);
    fence_regs<NP>(pa);
    mbar_arrive(empty((it - 1) % kTcStages));
    rescale_and_round(alpha);
  }
  fence_regs<NO>(o);        // the last tile's P V
  fence_regs<NP>(pa);
  wgmma_fence();
  issue_pv((kt_hi - 1 - kt_lo) % kTcStages);
  wgmma_wait<0>();
  fence_regs<NO>(o);

  // output element i: row row0 + 8 * ((i / 2) % 2),
  // column 64 * (i / 32) + 8 * ((i % 32) / 4) + 2 * (lane % 4) + i % 2
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int qp = row0 + 8 * hr;
    if (qp >= S) continue;
    const float denom = fmaxf(l[hr], 1e-30f);
    T* orow = out + (static_cast<size_t>(b) * S + qp) * q_row + static_cast<size_t>(h) * HD;
#pragma unroll
    for (int hb = 0; hb < HD / 64; ++hb) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int i = hb * 32 + 4 * j + 2 * hr;
        const int col = hb * 64 + 8 * j + 2 * (lane % 4);
        *reinterpret_cast<uint32_t*>(orow + col) = pack2<T>(o[i] / denom, o[i + 1] / denom);
      }
    }
  }
}

// cuTensorMapEncodeTiled, looked up through the CUDA runtime (no link to libcuda)
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);
EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                             cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p) : nullptr;
  }();
  return fn;
}

// The tensor map of a (B, S, heads, HD) tensor read in boxes of 64 columns
// by `rows` rows of one head, with the 128-byte swizzle; rows past S read
// as zeros
template <typename T, int HD>
bool tensor_map(CUtensorMap* map, const void* ptr, int B, int S, int heads, int rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[4] = {HD, static_cast<cuuint64_t>(heads), static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {HD * 2ull, static_cast<cuuint64_t>(heads) * HD * 2,
                                 static_cast<cuuint64_t>(S) * heads * HD * 2};
  const cuuint32_t box[4] = {64, 1, static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUtensorMapDataType type =
      kIsBf16<T> ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT16;
  return encode(map, type, 4, const_cast<void*>(ptr), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) ==
         CUDA_SUCCESS;
}

template <typename T, int HD>
cudaError_t launch_tc(const void* q, const void* k, const void* v, void* out, int B, int S,
                      int S_kv, int H, int KVH, int causal, int window, float scale,
                      cudaStream_t stream) {
  constexpr int BK = HD > 128 ? 32 : 128;
  auto kernel = flash_wgmma_kernel<T, HD, BK>;
  CUtensorMap tm_q, tm_k, tm_v;
  if (!tensor_map<T, HD>(&tm_q, q, B, S, H, kTcBQ) ||
      !tensor_map<T, HD>(&tm_k, k, B, S_kv, KVH, BK) ||
      !tensor_map<T, HD>(&tm_v, v, B, S_kv, KVH, BK)) {
    return cudaErrorInvalidValue;
  }
  const size_t smem = 1024 + static_cast<size_t>(kTcBQ) * HD * 2 +
                      2 * kTcStages * static_cast<size_t>(BK) * HD * 2 + 16 * kTcStages + 8;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((S + kTcBQ - 1) / kTcBQ, H, B);
  kernel<<<grid, kTcThreads, smem, stream>>>(tm_q, tm_k, tm_v, static_cast<T*>(out), S, S_kv,
                                             H, KVH, causal, window, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_tc_hd(const void* q, const void* k, const void* v, void* out, int B, int S,
                         int S_kv, int H, int KVH, int HD, int causal, int window, float scale,
                         cudaStream_t stream) {
  switch (HD) {
    case 64:
      return launch_tc<T, 64>(q, k, v, out, B, S, S_kv, H, KVH, causal, window, scale, stream);
    case 128:
      return launch_tc<T, 128>(q, k, v, out, B, S, S_kv, H, KVH, causal, window, scale, stream);
    case 256:
      return launch_tc<T, 256>(q, k, v, out, B, S, S_kv, H, KVH, causal, window, scale, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// Plain C interface, bound with ctypes.  dtype: 0 float32, 1 bf16, 2 fp16
// (q, k, v and out all of it); every tensor contiguous; q and out hold S
// rows, k and v S_kv, which must equal S when causal or window > 0.  The
// type picks the kernel: float32 runs flash_kernel on the CUDA cores, bf16
// and fp16 run flash_wgmma_kernel on the tensor cores, whose tensor maps
// need every pointer 16-byte aligned.  Launches on `stream`, does not synchronise,
// allocates nothing; returns the cudaError_t of the launch
// (cudaErrorInvalidValue for a head dim, type or alignment it has no
// instance for, or unequal lengths under a mask; there is no fallback from one kernel to the other).
extern "C" int repro_flash_attention(const void* q, const void* k, const void* v, void* out,
                                     int B, int S, int S_kv, int H, int KVH, int HD,
                                     int dtype, int causal, int window, float scale,
                                     void* stream) {
  if (B < 1 || S < 1 || S_kv < 1 || KVH < 1 || H % KVH != 0 || H > 65535 || B > 65535 ||
      (S_kv != S && (causal || window > 0))) {
    return cudaErrorInvalidValue;
  }
  const uintptr_t any_bits = reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
                             reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(out);
  if (dtype != 0 && any_bits % 16 != 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch_hd<float>(q, k, v, out, B, S, S_kv, H, KVH, HD, causal, window, scale, s);
    case 1:
      return launch_tc_hd<__nv_bfloat16>(q, k, v, out, B, S, S_kv, H, KVH, HD, causal, window,
                                         scale, s);
    case 2:
      return launch_tc_hd<__half>(q, k, v, out, B, S, S_kv, H, KVH, HD, causal, window, scale,
                                  s);
    default: return cudaErrorInvalidValue;
  }
}

extern "C" const char* repro_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
