// K1: the fused per-level provisioning scan, hand-written for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_grid_scan_kernel` behind
// `provision_scan_grid` (src/repro/kernels/provision_scan.py).  Its plain
// PyTorch version is `_on_matrix_scan` (src/repro_torch/core/torch_provision.py),
// reached through `provision_scan_grid_ref`; the two agree bit for bit.
//
// What it computes.  For every cell g (one noise-std x window x trace
// combination of a provisioning sweep) and every lane j (one server level),
// the ski-rental slot scan of the paper (slot_step.cuh).  The result is a
// (G, T, N) one-byte on-matrix, plus on request (G, 4, N) int32 decision
// counters (demand-rise, wait-expired, peek-fired, toggle-off) and the
// (G, T, N) uint8 per-slot reason bitmask of repro_torch.obs.provenance,
// which `provision(record_decisions=True)` returns as `decisions`.
//
// What bounds it on this card.  The bytes it writes: one (or with the codes
// two) per (g, t, j), G*T*N in all, and for the randomized policies the wait
// entries it reads where a lane turns newly idle.  The scan over t is
// sequential per lane; parallelism comes from the G x N lanes only.
//
// What the design does about it.  One thread per (cell, level), 128 levels
// to a block, so neighbouring threads store neighbouring bytes of each row
// (one 32-byte sector per warp and slot).  The loop is the one K2 runs
// (slot_step.cuh): sub-tiles where every lane is busy, or where nothing is on
// and nothing can turn on, skip the step and only store their ones or zeros;
// wait entries are loaded ahead of their slot.  The carry (r, on, wait) stays
// in registers for all T slots; the counters are written once per cell.
#include "slot_step.cuh"

namespace {

using namespace repro_scan;

constexpr int kTile = 256;         // slots staged per shared-memory tile

// K1's sink: the on byte of every slot, the reason bits under kCodes, and the
// four counters under kRecord.
template <bool kRecord, bool kCodes>
struct StoreOn {
  uint8_t* o;       // this lane's column of the cell's (T, N) on-matrix
  uint8_t* c;       // and of its codes
  int N;
  bool lane;
  int cnt[4];

  __device__ void slot(int t0, int k, bool on, bool, uint32_t bits) {
    const size_t at = static_cast<size_t>(t0 + k) * N;
    if (lane) {
      o[at] = on;
      if (kCodes) c[at] = static_cast<uint8_t>(bits);
    }
    if (kRecord) {
      cnt[0] += bits & 1u;
      cnt[1] += (bits >> 1) & 1u;
      cnt[2] += (bits >> 2) & 1u;
      cnt[3] += (bits >> 3) & 1u;
    }
  }
  __device__ void all_busy(int t0, int k0, int n, bool rise) {
    if (lane) {
      for (int i = 0; i < n; ++i) {
        const size_t at = static_cast<size_t>(t0 + k0 + i) * N;
        o[at] = 1;
        if (kCodes) c[at] = (i == 0 && rise) ? kDemandRise : 0;
      }
    }
    if (kRecord) cnt[0] += rise;
  }
  __device__ void all_idle(int t0, int k0, int n) {
    if (lane) {
      for (int i = 0; i < n; ++i) {
        const size_t at = static_cast<size_t>(t0 + k0 + i) * N;
        o[at] = 0;
        if (kCodes) c[at] = 0;
      }
    }
  }
  __device__ void tile_end(int, int) {}
};

template <int kSource, bool kTabulated, bool kRecord, bool kCodes>
__global__ void __launch_bounds__(kLanes)
grid_scan_kernel(ScanIn p,
                 uint8_t* __restrict__ out,       // (G, T, N)
                 int32_t* __restrict__ counts,    // (G, 4, N) or null
                 uint8_t* __restrict__ codes) {   // (G, T, N) or null
  extern __shared__ int32_t smem[];
  const Lanes L = block_lanes(p.routes, p.N);
  const int N = p.N;
  int tally[3] = {0, 0, 0};

  for (int g = blockIdx.y; g < p.G; g += gridDim.y) {
    const size_t col = static_cast<size_t>(g) * p.T * N + L.j;
    StoreOn<kRecord, kCodes> sink{out + col, kCodes ? codes + col : nullptr, N, L.lane,
                                  {0, 0, 0, 0}};
    SlotState s{0.f, false, 0.f};
    if (kSource == kConstantRow && L.lane) {
      s.wait = p.thresholds[static_cast<size_t>(p.cell_thr[g]) * N + L.j];
    }
    scan_cell<kSource, kTabulated>(p, L, g, /*fresh=*/true, s, sink, smem, tally);
    if (kRecord && L.lane) {
      int32_t* c = counts + static_cast<size_t>(g) * 4 * N + L.j;
      c[0] = sink.cnt[0];
      c[N] = sink.cnt[1];
      c[2 * N] = sink.cnt[2];
      c[3 * N] = sink.cnt[3];
    }
  }
  flush_tally(p.paths, tally);
}

template <int kSource, bool kTabulated, bool kRecord, bool kCodes>
cudaError_t launch(const ScanIn& p, uint8_t* out, int32_t* counts, uint8_t* codes,
                   cudaStream_t stream) {
  auto kernel = grid_scan_kernel<kSource, kTabulated, kRecord, kCodes>;
  const size_t smem = loop_words(kTile, p.horizon, drawn_waits(kSource)) * sizeof(int32_t);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((p.N + kLanes - 1) / kLanes, p.G < kMaxGridY ? p.G : kMaxGridY);
  kernel<<<grid, kLanes, smem, stream>>>(p, out, counts, codes);
  return cudaGetLastError();
}

template <int kSource, bool kTabulated>
cudaError_t launch_recorded(const ScanIn& p, uint8_t* out, int32_t* counts, uint8_t* codes,
                            int record, cudaStream_t stream) {
  if (!record) return launch<kSource, kTabulated, false, false>(p, out, counts, codes, stream);
  return codes ? launch<kSource, kTabulated, true, true>(p, out, counts, codes, stream)
               : launch<kSource, kTabulated, true, false>(p, out, counts, codes, stream);
}

template <int kSource>
cudaError_t launch_source(const ScanIn& p, uint8_t* out, int32_t* counts, uint8_t* codes,
                          int record, cudaStream_t stream) {
  return tabulated(p.horizon)
      ? launch_recorded<kSource, true>(p, out, counts, codes, record, stream)
      : launch_recorded<kSource, false>(p, out, counts, codes, record, stream);
}

}  // namespace

// Plain C interface, bound with ctypes.  Launches on `stream`, does not
// synchronise, allocates nothing; returns the cudaError_t of the launch.
// `codes` (null unless `record`) receives the per-slot reason bits; `paths`
// (null, or 3 int32 zeroed by the caller) receives the number of
// (block, cell, sub-tile) triples that ran the step, were all busy, or idle.
extern "C" int repro_provision_scan_grid(
    const int32_t* traces, const int32_t* predicted, const float* thresholds,
    const int32_t* cell_trace, const int32_t* cell_pred, const int32_t* cell_thr,
    const int32_t* cell_hor, const float* level_horizon, const int32_t* routes,
    uint8_t* out, int32_t* counts, uint8_t* codes, int32_t* paths, int G, int T, int N,
    int horizon, int time_varying, int record, void* stream) {
  const ScanIn p{traces, predicted, thresholds, cell_trace, cell_pred, cell_thr, cell_hor,
                 level_horizon, routes, nullptr, nullptr, nullptr, nullptr, paths,
                 G, T, N, horizon, kTile};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return time_varying ? launch_source<kTable>(p, out, counts, codes, record, s)
                      : launch_source<kConstantRow>(p, out, counts, codes, record, s);
}

// Largest peek horizon the shared-memory tiles can hold on this card: one
// predicted word per slot above kPeekTable (the tabulated horizons below it
// need far less than the card has), beside the static shared memory.
extern "C" int repro_provision_scan_max_horizon() {
  int device = 0, bytes = 0;
  if (cudaGetDevice(&device) != cudaSuccess) return -1;
  if (cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, device)
      != cudaSuccess) {
    return -1;
  }
  return bytes / static_cast<int>(sizeof(int32_t)) - static_cast<int>(loop_words(kTile, 0, false))
      - kStaticWords;
}

extern "C" const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
