// K2: the streaming per-level provisioning scan, hand-written for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_stream_scan_kernel` behind
// `provision_scan_stream` (src/repro/kernels/provision_scan.py).  Its plain
// PyTorch version is `_stream_scan` (src/repro_torch/core/torch_provision.py),
// reached through `provision_scan_stream_ref`; the two agree bit for bit.
//
// What it computes.  K1's slot semantics (slot_step.cuh) for every cell g
// and lane j, but in place of the (G, T, N) on-matrix it returns what the
// engine reduces that matrix to:
//   x       (G, T) int32       on lanes per slot (lanes with routes[j] < n_levels);
//   accs    (G, 3 | 7, N) int32 per-lane run / up / down totals, plus the four
//                              decision counters (demand-rise, wait-expired,
//                              peek-fired, toggle-off) on request;
//   carry   (G, N) r, on, wait  the state after the last slot, which a later
//                              call takes to continue the trace bit for bit.
// A fresh call (null carry pointers) starts at the virtual x(0) = a(0) edge:
// at its first slot the previous state is the busy pattern itself, so nothing
// turns on or off there.  The forced final off at T is the caller's to add.
//
// Fresh waits come from a constant row, from a (K, T, N) wait table, or (the
// uniforms route) from the (B, T, N) uniform tables the waits are drawn
// from: the kernel applies A2/A3's inverse CDF itself to the entries a lane
// consumes (slot_step.cuh, `wait_from_uniforms`), so the (W*B, T, N) tables
// of a window sweep are never built.  Both give the same waits in every bit
// only if this kernel's log1pf equals PyTorch's CUDA log1p, which
// chip_smoke.py checks on every entry of its tables.
//
// What bounds it on this card.  Its bytes are O(G * (T + N)): the demand and
// predicted rows, the wait entries a lane consumes when it turns newly idle,
// x and the per-lane totals.  Its work is a dozen compares and selects for
// each (cell, slot, level) update that is not in a steady state, sequential
// in the slot, so it is bound by operations and by the latency of that
// dependent chain; parallelism comes from the G x N lanes only.
//
// What the design does about it.  One thread per (cell, level), 128 levels to
// a block, the grid over (level blocks, cells) with a loop over cells past
// 65535.  The state and every total stay in registers for the whole trace and
// are written once at the end.  The loop (slot_step.cuh) skips the sub-tiles
// in a steady state by their closed forms and loads wait entries ahead of
// their slot.
//
// x(t): each warp counts its on lanes per slot with __ballot_sync + __popc into
// a per-warp row in shared memory; after each tile the block sums its four
// rows and adds every nonzero slot total into x with one atomicAdd.  The sums
// are integers, so the order of the atomics cannot change x; the wrapper
// zeroes x first.  This was chosen over writing (G, N / 128, T) partials for
// the caller to sum, as the TPU kernel does: at a year of 10-minute slots
// those would be 323 MB against 10 MB for x.
//
// Also kept from the reference: with a constant threshold row the wait is the
// row and the carried wait is ignored, with a time-varying source it starts
// from the carry; lanes beyond N or routed to a level >= n_levels count in
// neither x nor the totals.
#include "slot_step.cuh"

namespace {

using namespace repro_scan;

// K2's sink: per-lane totals, and each warp's on-lane count per slot in
// shared memory, summed into x after each tile.
template <bool kRecord>
struct Totals {
  int32_t* w_s;      // (kWarps, tile) on lanes per warp and slot
  int32_t* x_row;    // the cell's (T,) row of x
  int tile;
  bool lane_ok;
  int run, up, down;
  int cnt[4];

  __device__ void slot(int, int k, bool on, bool prev, uint32_t bits) {
    run += on;
    up += on && !prev;
    down += prev && !on;
    if (kRecord) {
      cnt[0] += bits & 1u;
      cnt[1] += (bits >> 1) & 1u;
      cnt[2] += (bits >> 2) & 1u;
      cnt[3] += (bits >> 3) & 1u;
    }
    const unsigned votes = __ballot_sync(0xffffffffu, on && lane_ok);
    if ((threadIdx.x & 31) == 0) w_s[(threadIdx.x / 32) * tile + k] = __popc(votes);
  }
  __device__ void all_busy(int, int k0, int n, bool rise) {
    run += n;
    up += rise;
    if (kRecord) cnt[0] += rise;
    const int on_lanes = __popc(__ballot_sync(0xffffffffu, lane_ok));
    const int i = threadIdx.x & 31;
    if (i < n) w_s[(threadIdx.x / 32) * tile + k0 + i] = on_lanes;
  }
  __device__ void all_idle(int, int k0, int n) {
    const int i = threadIdx.x & 31;
    if (i < n) w_s[(threadIdx.x / 32) * tile + k0 + i] = 0;
  }
  __device__ void tile_end(int t0, int len) {
    __syncthreads();  // every warp's counts of this tile are in
    for (int i = threadIdx.x; i < len; i += kLanes) {
      int s = 0;
      for (int w = 0; w < kWarps; ++w) s += w_s[w * tile + i];
      if (s) atomicAdd(x_row + t0 + i, s);
    }
  }
};

template <int kSource, bool kTabulated, bool kRecord>
__global__ void __launch_bounds__(kLanes)
stream_scan_kernel(ScanIn p,
                   const float* __restrict__ r_in,          // (G, N) or null: fresh
                   const uint8_t* __restrict__ on_in,       // (G, N) or null
                   const float* __restrict__ wait_in,       // (G, N) or null
                   int32_t* __restrict__ x,                 // (G, T), zeroed
                   int32_t* __restrict__ accs,              // (G, 3 | 7, N)
                   float* __restrict__ r_out,               // (G, N)
                   uint8_t* __restrict__ on_out,            // (G, N)
                   float* __restrict__ wait_out,            // (G, N)
                   int n_levels) {
  constexpr int kAccs = kRecord ? 7 : 3;
  extern __shared__ int32_t smem[];
  const int tile = p.tile, N = p.N;
  int32_t* w_s = smem + loop_words(tile, p.horizon, drawn_waits(kSource));
  const Lanes L = block_lanes(p.routes, N);
  const bool lane_ok = L.lane && L.route < n_levels;
  const bool fresh = r_in == nullptr;
  int tally[3] = {0, 0, 0};

  for (int g = blockIdx.y; g < p.G; g += gridDim.y) {
    const size_t gj = static_cast<size_t>(g) * N + L.j;
    SlotState s{0.f, false, 0.f};
    if (L.lane) {
      if (!fresh) {
        s.r = r_in[gj];
        s.on = on_in[gj] != 0;
        s.wait = wait_in[gj];
      }
      if (kSource == kConstantRow) {   // constant row: the carried wait is ignored
        s.wait = p.thresholds[static_cast<size_t>(p.cell_thr[g]) * N + L.j];
      }
    }
    Totals<kRecord> sink{w_s, x + static_cast<size_t>(g) * p.T, tile, lane_ok, 0, 0, 0,
                         {0, 0, 0, 0}};
    scan_cell<kSource, kTabulated>(p, L, g, fresh, s, sink, smem, tally);

    if (L.lane) {
      int32_t* acc = accs + static_cast<size_t>(g) * kAccs * N + L.j;
      acc[0] = lane_ok ? sink.run : 0;
      acc[N] = lane_ok ? sink.up : 0;
      acc[2 * N] = lane_ok ? sink.down : 0;
      if (kRecord) {
        for (int i = 0; i < 4; ++i) acc[(3 + i) * N] = lane_ok ? sink.cnt[i] : 0;
      }
      r_out[gj] = s.r;
      on_out[gj] = s.on;
      wait_out[gj] = s.wait;
    }
  }
  flush_tally(p.paths, tally);
}

// int32 words of shared memory for a tile: the loop's, plus one on-lane
// count per warp and slot
size_t smem_words(int tile, int horizon, bool drawn) {
  return loop_words(tile, horizon, drawn) + static_cast<size_t>(tile) * kWarps;
}

template <int kSource, bool kTabulated, bool kRecord>
cudaError_t launch(const ScanIn& p, const float* r_in, const uint8_t* on_in,
                   const float* wait_in, int32_t* x, int32_t* accs, float* r_out,
                   uint8_t* on_out, float* wait_out, int n_levels, cudaStream_t stream) {
  auto kernel = stream_scan_kernel<kSource, kTabulated, kRecord>;
  const size_t smem = smem_words(p.tile, p.horizon, drawn_waits(kSource)) * sizeof(int32_t);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((p.N + kLanes - 1) / kLanes, p.G < kMaxGridY ? p.G : kMaxGridY);
  kernel<<<grid, kLanes, smem, stream>>>(p, r_in, on_in, wait_in, x, accs, r_out, on_out,
                                         wait_out, n_levels);
  return cudaGetLastError();
}

template <int kSource, bool kTabulated>
cudaError_t launch_recorded(const ScanIn& p, const float* r_in, const uint8_t* on_in,
                            const float* wait_in, int32_t* x, int32_t* accs, float* r_out,
                            uint8_t* on_out, float* wait_out, int n_levels, int record,
                            cudaStream_t stream) {
  return record
      ? launch<kSource, kTabulated, true>(p, r_in, on_in, wait_in, x, accs, r_out, on_out,
                                          wait_out, n_levels, stream)
      : launch<kSource, kTabulated, false>(p, r_in, on_in, wait_in, x, accs, r_out, on_out,
                                           wait_out, n_levels, stream);
}

// A test-only probe, on no path of the engine: the uniforms route's waits on
// their own, one thread per entry, as `wait_from_uniforms` gives them for
// (rows, N) uniforms with one span row.  chip_smoke.py holds every entry of
// its tables to PyTorch's log1p route with it.
template <bool kAtom>
__global__ void uniform_waits_kernel(const float* __restrict__ u,
                                     const float* __restrict__ u0,
                                     const float* __restrict__ span,
                                     const float* __restrict__ p0, float* __restrict__ out,
                                     size_t total, int N) {
  for (size_t i = blockIdx.x * static_cast<size_t>(blockDim.x) + threadIdx.x; i < total;
       i += static_cast<size_t>(gridDim.x) * blockDim.x) {
    const int j = static_cast<int>(i % N);
    out[i] = wait_from_uniforms<kAtom>(u[i], kAtom ? u0[i] : 0.f, span[j], kAtom ? p0[j] : 0.f);
  }
}

}  // namespace

// Plain C interface, bound with ctypes.  Launches on `stream`, does not
// synchronise, allocates nothing; returns the cudaError_t of the launch.
// `tile` must be at least 1 and at most
// repro_provision_scan_stream_max_tile(horizon, source).  `source` is a
// repro_scan::WaitSource: 0 a constant row, 1 a (K, T, N) table, 2 and 3 the
// uniforms route (`thresholds` the (K, N) spans, `u` and, for 3, `u0` and
// `p0` given).  `paths` is as for repro_provision_scan_grid.
extern "C" int repro_provision_scan_stream(
    const int32_t* traces, const int32_t* predicted, const float* thresholds,
    const int32_t* cell_trace, const int32_t* cell_pred, const int32_t* cell_thr,
    const int32_t* cell_hor, const float* level_horizon, const int32_t* routes,
    const float* u, const float* u0, const float* p0, const int32_t* cell_uni,
    const float* r_in, const uint8_t* on_in, const float* wait_in, int32_t* x,
    int32_t* accs, float* r_out, uint8_t* on_out, float* wait_out, int32_t* paths, int G,
    int T, int N, int horizon, int tile, int n_levels, int source, int record,
    void* stream) {
  const ScanIn p{traces, predicted, thresholds, cell_trace, cell_pred, cell_thr, cell_hor,
                 level_horizon, routes, u, u0, p0, cell_uni, paths, G, T, N, horizon, tile};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define REPRO_K2(SOURCE)                                                                    \
  (tabulated(horizon)                                                                       \
       ? launch_recorded<SOURCE, true>(p, r_in, on_in, wait_in, x, accs, r_out, on_out,     \
                                       wait_out, n_levels, record, s)                       \
       : launch_recorded<SOURCE, false>(p, r_in, on_in, wait_in, x, accs, r_out, on_out,    \
                                        wait_out, n_levels, record, s))
  switch (source) {
    case kConstantRow:
      return REPRO_K2(kConstantRow);
    case kTable:
      return REPRO_K2(kTable);
    case kUniforms:
      return REPRO_K2(kUniforms);
    case kUniformsAtom:
      return REPRO_K2(kUniformsAtom);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef REPRO_K2
}

// Largest tile, in slots, that the shared memory of one block holds on this
// card for the given peek horizon and wait source (< 1: none), beside the
// static shared memory.
extern "C" int repro_provision_scan_stream_max_tile(int horizon, int source) {
  int device = 0, bytes = 0;
  if (cudaGetDevice(&device) != cudaSuccess) return -1;
  if (cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, device)
      != cudaSuccess) {
    return -1;
  }
  const long long words = bytes / static_cast<long long>(sizeof(int32_t)) - kStaticWords;
  int tile = static_cast<int>((words - horizon) / (2 + kWarps));
  while (tile > 0 && static_cast<long long>(smem_words(tile, horizon, drawn_waits(source))) > words) {
    --tile;
  }
  return tile;
}

// The test-only probe's entry: the waits of the uniforms route for `total` =
// rows * N entries of `u` (and `u0`), against one (N,) span row (and p0 row
// when `atom`).
extern "C" int repro_uniform_waits(const float* u, const float* u0, const float* span,
                                   const float* p0, float* out, long long total, int N,
                                   int atom, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int blocks = static_cast<int>(
      total / 256 + 1 < 132 * 16 ? total / 256 + 1 : 132 * 16);
  if (atom) {
    uniform_waits_kernel<true><<<blocks, 256, 0, s>>>(u, u0, span, p0, out,
                                                      static_cast<size_t>(total), N);
  } else {
    uniform_waits_kernel<false><<<blocks, 256, 0, s>>>(u, u0, span, p0, out,
                                                       static_cast<size_t>(total), N);
  }
  return cudaGetLastError();
}
