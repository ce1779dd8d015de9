// K2: the streaming per-level provisioning scan, hand-written for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_stream_scan_kernel` behind
// `provision_scan_stream` (src/repro/kernels/provision_scan.py).  Its plain
// PyTorch version is `_stream_scan` (src/repro_torch/core/torch_provision.py),
// reached through `provision_scan_stream_ref`; the two agree bit for bit.
//
// What it computes.  K1's slot semantics (provision_scan.cu) for every cell g
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
// What bounds it on this card.  Its bytes are O(G * (T + N)): the demand and
// predicted rows, the wait entries a lane consumes when it turns newly idle,
// x and the per-lane totals.  Its work is a dozen compares and selects for
// each (cell, slot, level), sequential in the slot, so it is bound by
// operations and by the latency of that dependent chain; parallelism comes
// from the G x N lanes only.
//
// What the design does about it.  One thread per (cell, level), 128 levels to
// a block, the grid over (level blocks, cells) with a loop over cells past
// 65535.  The state and every total stay in registers for the whole trace and
// are written once at the end.  The demand and predicted rows are the same for
// every thread of a block, so they are staged in shared memory in tiles of
// `tile` slots (the predicted tile padded by the peek horizon, 0 past T) and
// read as broadcasts; the tile never changes a result.  The wait table is read
// only where a lane turns newly idle; the peek loop runs only on a lane whose
// wait has expired, the only place its verdict is used.
//
// x(t): each warp counts its on lanes per slot with __ballot_sync + __popc into
// a per-warp row in shared memory; after each tile the block sums its four
// rows and adds every nonzero slot total into x with one atomicAdd.  The sums
// are integers, so the order of the atomics cannot change x; the wrapper
// zeroes x first.  This was chosen over writing (G, N / 128, T) partials for
// the caller to sum, as the TPU kernel does: at a year of 10-minute slots
// those would be 323 MB against 10 MB for x.
//
// Semantics kept from the reference: r, wait and the peek reach are f32
// (`r - 1 >= wait` against fractional waits, `(float)h < reach` so a
// fractional Delta counts); with a constant threshold row the wait is the row
// and the carried wait is ignored, with a time-varying table it starts from
// the carry; lanes beyond N or routed to a level >= n_levels count in neither
// x nor the totals.
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int kLanes = 128;        // levels per block, one per thread
constexpr int kWarps = kLanes / 32;
constexpr int kPadRoute = 1 << 30; // routing id of lanes past N: never busy
constexpr int kMaxGridY = 65535;

// int32 words of shared memory for a tile: demand, predicted (+ horizon),
// and one on-lane count per warp and slot
size_t smem_words(int tile, int horizon) {
  return static_cast<size_t>(tile) * (2 + kWarps) + horizon;
}

template <bool kTimeVarying, bool kRecord>
__global__ void __launch_bounds__(kLanes)
stream_scan_kernel(const int32_t* __restrict__ traces,      // (B, T)
                   const int32_t* __restrict__ predicted,   // (R, T)
                   const float* __restrict__ thresholds,    // (K, 1 | T, N)
                   const int32_t* __restrict__ cell_trace,  // (G,)
                   const int32_t* __restrict__ cell_pred,   // (G,)
                   const int32_t* __restrict__ cell_thr,    // (G,)
                   const int32_t* __restrict__ cell_hor,    // (G,)
                   const float* __restrict__ level_horizon, // (H, N)
                   const int32_t* __restrict__ routes,      // (N,)
                   const float* __restrict__ r_in,          // (G, N) or null: fresh
                   const uint8_t* __restrict__ on_in,       // (G, N) or null
                   const float* __restrict__ wait_in,       // (G, N) or null
                   int32_t* __restrict__ x,                 // (G, T), zeroed
                   int32_t* __restrict__ accs,              // (G, 3 | 7, N)
                   float* __restrict__ r_out,               // (G, N)
                   uint8_t* __restrict__ on_out,            // (G, N)
                   float* __restrict__ wait_out,            // (G, N)
                   int G, int T, int N, int horizon, int tile, int n_levels) {
  constexpr int kAccs = kRecord ? 7 : 3;
  extern __shared__ int32_t smem[];
  int32_t* a_s = smem;                  // demand slots [t0, t0 + tile)
  int32_t* p_s = smem + tile;           // predicted slots [t0 + 1, t0 + 1 + tile + horizon)
  int32_t* w_s = p_s + tile + horizon;  // (kWarps, tile) on lanes per warp and slot

  const int warp = threadIdx.x / 32;
  const int j = blockIdx.x * kLanes + threadIdx.x;
  const bool lane = j < N;
  const int route = lane ? routes[j] : kPadRoute;
  const bool lane_ok = lane && route < n_levels;
  const bool fresh = r_in == nullptr;

  for (int g = blockIdx.y; g < G; g += gridDim.y) {
    const int32_t* a_row = traces + static_cast<size_t>(cell_trace[g]) * T;
    const int32_t* p_row = predicted + static_cast<size_t>(cell_pred[g]) * T;
    const float* thr = thresholds
        + static_cast<size_t>(cell_thr[g]) * (kTimeVarying ? T : 1) * N + j;
    const float reach = lane ? level_horizon[static_cast<size_t>(cell_hor[g]) * N + j] : 0.f;
    const size_t gj = static_cast<size_t>(g) * N + j;

    float r = 0.f;
    bool on = false;
    float wait = 0.f;
    if (lane) {
      if (!fresh) {
        r = r_in[gj];
        on = on_in[gj] != 0;
        wait = wait_in[gj];
      }
      if (!kTimeVarying) wait = thr[0];   // constant row: the carried wait is ignored
    }
    int run = 0, up = 0, down = 0;
    int c_rise = 0, c_wait = 0, c_peek = 0, c_off = 0;

    for (int t0 = 0; t0 < T; t0 += tile) {
      const int len = min(tile, T - t0);
      __syncthreads();  // every thread is done with the previous tile
      for (int i = threadIdx.x; i < len; i += kLanes) {
        a_s[i] = a_row[t0 + i];
      }
      for (int i = threadIdx.x; i < len + horizon; i += kLanes) {
        const int t = t0 + 1 + i;
        p_s[i] = t < T ? p_row[t] : 0;
      }
      __syncthreads();
      for (int k = 0; k < len; ++k) {
        const int t = t0 + k;
        const bool busy = a_s[k] > route;
        const bool prev = (fresh && t == 0) ? busy : on;   // virtual x(0) = a(0)
        if (kRecord) c_rise += busy && !prev;
        on = on || busy;                                  // dispatcher turn-on
        if (busy) r = 0.f;
        const bool idle = on && !busy;
        if (kTimeVarying && lane && idle && r == 0.f) {
          wait = thr[static_cast<size_t>(t) * N];         // newly idle: fresh draw
        }
        if (idle) r += 1.f;
        const bool expired = idle && (r - 1.f >= wait);
        bool seen = false;
        if (expired) {
          for (int h = 0; h < horizon; ++h) {
            if (p_s[k + h] > route && static_cast<float>(h) < reach) {
              seen = true;
              break;
            }
          }
        }
        const bool off = expired && !seen;
        if (off) {
          on = false;
          r = 0.f;
        }
        run += on;
        up += on && !prev;
        down += prev && !on;
        if (kRecord) {
          c_wait += expired;
          c_peek += expired && seen;
          c_off += off;
        }
        const unsigned votes = __ballot_sync(0xffffffffu, on && lane_ok);
        if ((threadIdx.x & 31) == 0) w_s[warp * tile + k] = __popc(votes);
      }
      __syncthreads();  // every warp's counts of this tile are in
      int32_t* x_row = x + static_cast<size_t>(g) * T + t0;
      for (int i = threadIdx.x; i < len; i += kLanes) {
        int s = 0;
        for (int w = 0; w < kWarps; ++w) s += w_s[w * tile + i];
        if (s) atomicAdd(x_row + i, s);
      }
    }

    if (lane) {
      int32_t* acc = accs + static_cast<size_t>(g) * kAccs * N + j;
      acc[0] = lane_ok ? run : 0;
      acc[N] = lane_ok ? up : 0;
      acc[2 * N] = lane_ok ? down : 0;
      if (kRecord) {
        acc[3 * N] = lane_ok ? c_rise : 0;
        acc[4 * N] = lane_ok ? c_wait : 0;
        acc[5 * N] = lane_ok ? c_peek : 0;
        acc[6 * N] = lane_ok ? c_off : 0;
      }
      r_out[gj] = r;
      on_out[gj] = on;
      wait_out[gj] = wait;
    }
  }
}

template <bool kTimeVarying, bool kRecord>
cudaError_t launch(const int32_t* traces, const int32_t* predicted, const float* thresholds,
                   const int32_t* cell_trace, const int32_t* cell_pred,
                   const int32_t* cell_thr, const int32_t* cell_hor,
                   const float* level_horizon, const int32_t* routes, const float* r_in,
                   const uint8_t* on_in, const float* wait_in, int32_t* x, int32_t* accs,
                   float* r_out, uint8_t* on_out, float* wait_out, int G, int T, int N,
                   int horizon, int tile, int n_levels, cudaStream_t stream) {
  auto kernel = stream_scan_kernel<kTimeVarying, kRecord>;
  const size_t smem = smem_words(tile, horizon) * sizeof(int32_t);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((N + kLanes - 1) / kLanes, G < kMaxGridY ? G : kMaxGridY);
  kernel<<<grid, kLanes, smem, stream>>>(traces, predicted, thresholds, cell_trace, cell_pred,
                                         cell_thr, cell_hor, level_horizon, routes, r_in,
                                         on_in, wait_in, x, accs, r_out, on_out, wait_out, G,
                                         T, N, horizon, tile, n_levels);
  return cudaGetLastError();
}

}  // namespace

// Plain C interface, bound with ctypes.  Launches on `stream`, does not
// synchronise, allocates nothing; returns the cudaError_t of the launch.
// `tile` must be at least 1 and at most
// repro_provision_scan_stream_max_tile(horizon).
extern "C" int repro_provision_scan_stream(
    const int32_t* traces, const int32_t* predicted, const float* thresholds,
    const int32_t* cell_trace, const int32_t* cell_pred, const int32_t* cell_thr,
    const int32_t* cell_hor, const float* level_horizon, const int32_t* routes,
    const float* r_in, const uint8_t* on_in, const float* wait_in, int32_t* x,
    int32_t* accs, float* r_out, uint8_t* on_out, float* wait_out, int G, int T, int N,
    int horizon, int tile, int n_levels, int time_varying, int record, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (time_varying) {
    return record
        ? launch<true, true>(traces, predicted, thresholds, cell_trace, cell_pred, cell_thr,
                             cell_hor, level_horizon, routes, r_in, on_in, wait_in, x, accs,
                             r_out, on_out, wait_out, G, T, N, horizon, tile, n_levels, s)
        : launch<true, false>(traces, predicted, thresholds, cell_trace, cell_pred, cell_thr,
                              cell_hor, level_horizon, routes, r_in, on_in, wait_in, x, accs,
                              r_out, on_out, wait_out, G, T, N, horizon, tile, n_levels, s);
  }
  return record
      ? launch<false, true>(traces, predicted, thresholds, cell_trace, cell_pred, cell_thr,
                            cell_hor, level_horizon, routes, r_in, on_in, wait_in, x, accs,
                            r_out, on_out, wait_out, G, T, N, horizon, tile, n_levels, s)
      : launch<false, false>(traces, predicted, thresholds, cell_trace, cell_pred, cell_thr,
                             cell_hor, level_horizon, routes, r_in, on_in, wait_in, x, accs,
                             r_out, on_out, wait_out, G, T, N, horizon, tile, n_levels, s);
}

// Largest tile, in slots, that the shared memory of one block holds on this
// card for the given peek horizon (< 1: none).
extern "C" int repro_provision_scan_stream_max_tile(int horizon) {
  int device = 0, bytes = 0;
  if (cudaGetDevice(&device) != cudaSuccess) return -1;
  if (cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, device)
      != cudaSuccess) {
    return -1;
  }
  return (bytes / static_cast<int>(sizeof(int32_t)) - horizon) / (2 + kWarps);
}
