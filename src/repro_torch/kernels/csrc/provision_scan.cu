// K1: the fused per-level provisioning scan, hand-written for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_grid_scan_kernel` behind
// `provision_scan_grid` (src/repro/kernels/provision_scan.py).  Its plain
// PyTorch version is `_on_matrix_scan` (src/repro_torch/core/torch_provision.py),
// reached through `provision_scan_grid_ref`; the two agree bit for bit.
//
// What it computes.  For every cell g (one noise-std x window x trace
// combination of a provisioning sweep) and every lane j (one server level),
// the ski-rental slot scan of the paper: a level turns on when demand
// exceeds its routed id, and turns off once it has idled past its wait
// threshold unless the prediction window shows demand above it again.  The
// result is a (G, T, N) one-byte on-matrix, plus (G, 4, N) int32 decision
// counters (demand-rise, wait-expired, peek-fired, toggle-off) on request.
//
// What bounds it on this card.  The work per (g, t, j) is a dozen integer
// and float compares, so the kernel is bound by bytes: the one-byte
// on-matrix it writes (G*T*N bytes) and, for the randomized policies, the
// (K, T, N) float32 wait table it reads.  The scan over t is sequential per
// lane; parallelism comes from the G x N lanes only.
//
// What the design does about it.  One thread per (cell, level), 128 levels
// to a block, so neighbouring threads store neighbouring bytes of each
// on-matrix row (one 32-byte sector per warp and slot) and read
// neighbouring words of a wait-table row.  The wait table is read only
// where a lane becomes newly idle, not every slot.  The carry (idle run r,
// on bit, wait) stays in registers for all T slots.  The demand and
// predicted rows of the block's cell are the same for all its threads, so
// they are staged in shared memory in tiles of kTile slots (the predicted
// tile padded by the peek horizon) and read as broadcasts.  The peek loop
// runs only on a lane whose wait has expired, since that is the only place
// its verdict is used.
//
// Semantics kept from the reference: r, wait and the peek reach are f32
// (`r - 1 >= wait` compares against fractional waits, and `(float)h < reach`
// makes a fractional Delta count); with a constant threshold row the
// initial wait is the row itself, with a time-varying table it is 0 until a
// lane first goes idle; the demand-rise counter suppresses t = 0, which
// matches the plain scan's initial state x(0) = a(0); the peek reads 0 past
// the end of the trace; lanes beyond N are masked.
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int kLanes = 128;        // levels per block, one per thread
constexpr int kTile = 256;         // slots staged per shared-memory tile
constexpr int kPadRoute = 1 << 30; // routing id of masked lanes: never busy
constexpr int kMaxGridY = 65535;

template <bool kTimeVarying, bool kRecord>
__global__ void __launch_bounds__(kLanes)
grid_scan_kernel(const int32_t* __restrict__ traces,      // (B, T)
                 const int32_t* __restrict__ predicted,   // (R, T)
                 const float* __restrict__ thresholds,    // (K, 1 | T, N)
                 const int32_t* __restrict__ cell_trace,  // (G,)
                 const int32_t* __restrict__ cell_pred,   // (G,)
                 const int32_t* __restrict__ cell_thr,    // (G,)
                 const int32_t* __restrict__ cell_hor,    // (G,)
                 const float* __restrict__ level_horizon, // (H, N)
                 const int32_t* __restrict__ routes,      // (N,)
                 uint8_t* __restrict__ out,               // (G, T, N)
                 int32_t* __restrict__ counts,            // (G, 4, N) or null
                 int G, int T, int N, int horizon) {
  extern __shared__ int32_t smem[];
  int32_t* a_s = smem;            // demand slots [t0, t0 + kTile)
  int32_t* p_s = smem + kTile;    // predicted slots [t0 + 1, t0 + 1 + kTile + horizon)

  const int j = blockIdx.x * kLanes + threadIdx.x;
  const bool lane = j < N;
  const int route = lane ? routes[j] : kPadRoute;

  for (int g = blockIdx.y; g < G; g += gridDim.y) {
    const int32_t* a_row = traces + static_cast<size_t>(cell_trace[g]) * T;
    const int32_t* p_row = predicted + static_cast<size_t>(cell_pred[g]) * T;
    const float* thr = thresholds
        + static_cast<size_t>(cell_thr[g]) * (kTimeVarying ? T : 1) * N + j;
    const float reach = lane ? level_horizon[static_cast<size_t>(cell_hor[g]) * N + j] : 0.f;
    uint8_t* o = out + static_cast<size_t>(g) * T * N + j;

    float r = 0.f;
    bool on = false;
    float wait = (kTimeVarying || !lane) ? 0.f : thr[0];
    int c_rise = 0, c_wait = 0, c_peek = 0, c_off = 0;

    for (int t0 = 0; t0 < T; t0 += kTile) {
      __syncthreads();  // every thread is done with the previous tile
      for (int i = threadIdx.x; i < kTile; i += kLanes) {
        a_s[i] = t0 + i < T ? a_row[t0 + i] : 0;
      }
      for (int i = threadIdx.x; i < kTile + horizon; i += kLanes) {
        const int t = t0 + 1 + i;
        p_s[i] = t < T ? p_row[t] : 0;
      }
      __syncthreads();
      const int len = min(kTile, T - t0);
      for (int k = 0; k < len; ++k) {
        const int t = t0 + k;
        const bool busy = a_s[k] > route;
        if (kRecord) c_rise += busy && !on && t > 0;
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
        if (lane) o[static_cast<size_t>(t) * N] = on;
        if (kRecord) {
          c_wait += expired;
          c_peek += expired && seen;
          c_off += off;
        }
      }
    }
    if (kRecord && lane) {
      int32_t* c = counts + static_cast<size_t>(g) * 4 * N + j;
      c[0] = c_rise;
      c[N] = c_wait;
      c[2 * N] = c_peek;
      c[3 * N] = c_off;
    }
  }
}

template <bool kTimeVarying, bool kRecord>
cudaError_t launch(const int32_t* traces, const int32_t* predicted, const float* thresholds,
                   const int32_t* cell_trace, const int32_t* cell_pred,
                   const int32_t* cell_thr, const int32_t* cell_hor,
                   const float* level_horizon, const int32_t* routes, uint8_t* out,
                   int32_t* counts, int G, int T, int N, int horizon, cudaStream_t stream) {
  auto kernel = grid_scan_kernel<kTimeVarying, kRecord>;
  const size_t smem = static_cast<size_t>(2 * kTile + horizon) * sizeof(int32_t);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((N + kLanes - 1) / kLanes, G < kMaxGridY ? G : kMaxGridY);
  kernel<<<grid, kLanes, smem, stream>>>(traces, predicted, thresholds, cell_trace,
                                         cell_pred, cell_thr, cell_hor, level_horizon,
                                         routes, out, counts, G, T, N, horizon);
  return cudaGetLastError();
}

}  // namespace

// Plain C interface, bound with ctypes.  Launches on `stream`, does not
// synchronise, allocates nothing; returns the cudaError_t of the launch.
extern "C" int repro_provision_scan_grid(
    const int32_t* traces, const int32_t* predicted, const float* thresholds,
    const int32_t* cell_trace, const int32_t* cell_pred, const int32_t* cell_thr,
    const int32_t* cell_hor, const float* level_horizon, const int32_t* routes,
    uint8_t* out, int32_t* counts, int G, int T, int N, int horizon, int time_varying,
    int record, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (time_varying) {
    return record ? launch<true, true>(traces, predicted, thresholds, cell_trace, cell_pred,
                                       cell_thr, cell_hor, level_horizon, routes, out,
                                       counts, G, T, N, horizon, s)
                  : launch<true, false>(traces, predicted, thresholds, cell_trace, cell_pred,
                                        cell_thr, cell_hor, level_horizon, routes, out,
                                        counts, G, T, N, horizon, s);
  }
  return record ? launch<false, true>(traces, predicted, thresholds, cell_trace, cell_pred,
                                      cell_thr, cell_hor, level_horizon, routes, out,
                                      counts, G, T, N, horizon, s)
                : launch<false, false>(traces, predicted, thresholds, cell_trace, cell_pred,
                                       cell_thr, cell_hor, level_horizon, routes, out,
                                       counts, G, T, N, horizon, s);
}

// Largest peek horizon the shared-memory tiles can hold on this card.
extern "C" int repro_provision_scan_max_horizon() {
  int device = 0, bytes = 0;
  if (cudaGetDevice(&device) != cudaSuccess) return -1;
  if (cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, device)
      != cudaSuccess) {
    return -1;
  }
  return bytes / static_cast<int>(sizeof(int32_t)) - 2 * kTile;
}

extern "C" const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
