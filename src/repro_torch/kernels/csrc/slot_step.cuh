// The slot step and the slot loop that K1 (provision_scan.cu) and K2
// (provision_scan_stream.cu) share.
//
// `slot_step` is the per-(cell, slot, level) ski-rental update of the paper,
// written once: a level turns on when demand exceeds its routed id, and turns
// off once it has idled past its wait threshold unless the prediction window
// shows demand above it again.  It returns the slot's decision bits
// (repro_torch.obs.provenance: DEMAND_RISE 1, WAIT_EXPIRED 2, PEEK_FIRED 4,
// TOGGLE_OFF 8).  `scan_cell` is the loop around it for one cell: it stages
// the demand and predicted rows in shared memory, takes each sub-tile of
// kSub slots by one of three paths, and hands every slot to a sink, the only
// part the kernels do not share (K1 stores bytes, K2 keeps totals and x).
//
// Semantics kept from the reference: r, wait and the peek reach are f32
// (`r - 1 >= wait` compares against fractional waits, and `(float)h < reach`
// makes a fractional Delta count); a fresh trace starts at the virtual
// x(0) = a(0) edge, so nothing rises at its first slot; the peek reads 0 past
// the end of the trace; lanes beyond N are masked (never busy, never on).
//
// What holds a scan back on this card is the dependent chain of one lane
// through T slots, and a device-memory load on that chain wherever a lane
// turns newly idle and draws a fresh wait.  The loop does two things about
// them.
//
// The steady-state skip.  When a tile is staged, each sub-tile's minimum and
// maximum demand are reduced once.  If every real lane of the block routes
// below the sub-tile's minimum demand, every lane is busy on every slot: on
// = 1 and r = 0 after it, wait unchanged, a rise only at its first slot.  If
// every lane routes at or above its maximum and no lane is on, nothing
// changes.  Both are closed forms of the step, so the result is the same in
// every bit; every other sub-tile runs the step.
//
// The wait entry off the chain.  For t >= 1 within a tile, a lane is newly
// idle at t exactly when it is busy at t - 1 and not at t (busy sets r = 0;
// an idle slot leaves r >= 1 or the lane off).  The demand of the tile is in
// shared memory, so those slots are known before the step reaches them: at
// the start of a sub-tile that steps, each lane issues cp.async of all the
// entries it will consume there into its column of a shared-memory ring,
// in the order it consumes them.  Two consecutive slots cannot both be
// newly idle, so kSub / 2 rows hold a sub-tile's entries: A3, which reads u
// and u0 ahead, splits the ring's kSub rows between them.  Only the first
// slot of a tile loads on the chain.
//
// The peek in one read.  At the start of a sub-tile that steps, the block
// tabulates the largest predicted demand in each window of 1 .. horizon
// slots after each of its slots; a lane's peek is then one shared-memory
// read, issued off the chain, where the reference loops over the window.
//
// Both cost shared memory per slot of horizon, so they are kept for
// horizons up to kPeekTable slots.  Above it the loop peeks by walking the
// window, as the reference does, and loads each fresh wait on the chain, so
// that the longest horizon the card takes is what the predicted window
// alone leaves room for.
#pragma once

#include <cuda_runtime.h>

#include <climits>
#include <cstddef>
#include <cstdint>

namespace repro_scan {

constexpr int kLanes = 128;        // levels per block, one per thread
constexpr int kWarps = kLanes / 32;
constexpr int kSub = 32;           // slots per sub-tile of the steady-state skip
constexpr int kPadRoute = 1 << 30; // routing id of masked lanes: never busy
constexpr int kMaxGridY = 65535;
constexpr int kPeekTable = 64;     // longest horizon with the peek table and the ring
constexpr int kStaticWords = 2 * kWarps;   // block_lanes's static shared memory

// decision bits, as repro_torch.obs.provenance
constexpr uint32_t kDemandRise = 1, kWaitExpired = 2, kPeekFired = 4, kToggleOff = 8;

// the three paths of a sub-tile, in the order of the path counters
enum Path : int { kStep = 0, kAllBusy = 1, kAllIdle = 2 };

// where a fresh wait comes from: one constant row, a (T, N) table per cell,
// or the (T, N) uniforms of the cell's trace with the A2/A3 inverse CDF
enum WaitSource : int { kConstantRow = 0, kTable = 1, kUniforms = 2, kUniformsAtom = 3 };

// e - 1 rounded to float32, as PyTorch rounds the Python scalar of
// `u * (math.e - 1.0)` for a float32 tensor
constexpr float kEMinus1 = static_cast<float>(2.718281828459045 - 1.0);

struct SlotState {
  float r;     // idle run length
  bool on;
  float wait;  // wait threshold of the current idle period
};

// One slot of one lane.  `prev` is the lane's state entering the slot (its
// on bit, or at the virtual x(0) = a(0) edge its busy bit); `peek()` says
// whether the prediction window shows demand above the lane; `fresh_wait(w)`
// gives the wait of an idle period that starts at this slot (the current
// wait `w` for a constant row).
template <class Peek, class FreshWait>
__device__ __forceinline__ uint32_t slot_step(SlotState& s, bool busy, bool prev, Peek peek,
                                              FreshWait fresh_wait) {
  const uint32_t rise = (busy && !prev) ? kDemandRise : 0u;
  s.on = s.on || busy;                              // dispatcher turn-on
  if (busy) s.r = 0.f;
  const bool idle = s.on && !busy;
  if (idle && s.r == 0.f) s.wait = fresh_wait(s.wait);   // newly idle: fresh draw
  if (idle) s.r += 1.f;
  const bool expired = idle && (s.r - 1.f >= s.wait);
  const bool seen = expired && peek();              // the peek only matters here
  const bool off = expired && !seen;
  if (off) {
    s.on = false;
    s.r = 0.f;
  }
  return rise | (expired ? kWaitExpired : 0u) | (seen ? kPeekFired : 0u)
      | (off ? kToggleOff : 0u);
}

// A2/A3's inverse CDF in the op order of `_waits_from_uniforms`: span *
// log1p(u * (e - 1)), 0 where the A3 atom draw u0 < p0.  `__fmul_rn` keeps
// each product rounded on its own, as PyTorch's separate kernels round it.
template <bool kAtom>
__device__ __forceinline__ float wait_from_uniforms(float u, float u0, float span, float p0) {
  const float w = __fmul_rn(span, log1pf(__fmul_rn(u, kEMinus1)));
  return (kAtom && u0 < p0) ? 0.f : w;
}

// The inputs both kernels read.  For the uniforms sources `thresholds` holds
// (K, N) span rows, `p0` (K, N) atom rows, and `u`, `u0` the (Bu, T, N)
// uniform tables picked by `cell_uni`.
struct ScanIn {
  const int32_t* traces;       // (B, T)
  const int32_t* predicted;    // (R, T)
  const float* thresholds;     // (K, 1 | T, N), or (K, N) spans
  const int32_t* cell_trace;   // (G,)
  const int32_t* cell_pred;    // (G,)
  const int32_t* cell_thr;     // (G,)
  const int32_t* cell_hor;     // (G,)
  const float* level_horizon;  // (H, N)
  const int32_t* routes;       // (N,)
  const float* u;              // (Bu, T, N) or null
  const float* u0;             // (Bu, T, N) or null
  const float* p0;             // (K, N) or null
  const int32_t* cell_uni;     // (G,) or null
  int32_t* paths;              // 3 counters (Path order) or null
  int G, T, N, horizon, tile;
};

inline __host__ __device__ int subtiles(int tile) { return (tile + kSub - 1) / kSub; }

// whether the loop keeps the peek table and the ring for this horizon
inline __host__ __device__ bool tabulated(int horizon) { return horizon <= kPeekTable; }

// int32 words of shared memory the loop uses for a tile: demand, predicted
// (+ horizon), the sub-tiles' demand minima and maxima, and for a tabulated
// horizon the peek table of a sub-tile and, where waits are drawn (not a
// constant row), the (kSub, kLanes) ring of wait entries
inline __host__ __device__ size_t loop_words(int tile, int horizon, bool drawn) {
  const size_t base = static_cast<size_t>(2 * tile + horizon + 2 * subtiles(tile));
  return tabulated(horizon)
      ? base + static_cast<size_t>(kSub) * (horizon + (drawn ? kLanes : 0))
      : base;
}

// whether a wait source is read ahead through the ring
inline __host__ __device__ bool drawn_waits(int source) { return source != kConstantRow; }

// This thread's lane and the block's route range: the smallest route of all
// lanes, and the largest of the real ones (j < N).
struct Lanes {
  int j;
  bool lane;
  int route;
  int rmin;
  int rmax;
};

__device__ __forceinline__ Lanes block_lanes(const int32_t* routes, int N) {
  __shared__ int red[2][kStaticWords / 2];
  Lanes l;
  l.j = blockIdx.x * kLanes + threadIdx.x;
  l.lane = l.j < N;
  l.route = l.lane ? routes[l.j] : kPadRoute;
  const int lo = __reduce_min_sync(0xffffffffu, l.route);
  const int hi = __reduce_max_sync(0xffffffffu, l.lane ? l.route : INT_MIN);
  if ((threadIdx.x & 31) == 0) {
    red[0][threadIdx.x / 32] = lo;
    red[1][threadIdx.x / 32] = hi;
  }
  __syncthreads();
  l.rmin = red[0][0];
  l.rmax = red[1][0];
  for (int w = 1; w < kWarps; ++w) {
    l.rmin = min(l.rmin, red[0][w]);
    l.rmax = max(l.rmax, red[1][w]);
  }
  return l;
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(addr), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// A lane's wait entry: the table value, or the uniform and the atom uniform.
struct Entry {
  float v;
  float v0;
};

// The slot loop of cell g from state `s`, every slot handed to `sink`:
//   sink.slot(t0, k, on, prev, bits)   a slot the step ran (t = t0 + k);
//   sink.all_busy(t0, k0, n, rise)     n slots from k0, every lane busy;
//   sink.all_idle(t0, k0, n)           n slots from k0, nothing changes;
//   sink.tile_end(t0, len)             after each tile.
// `fresh`: the trace starts here (x(0) = a(0)); else `s` is a carried state.
// `tally` (thread 0's) counts the sub-tiles of each path.  `kTabulated`
// must be tabulated(p.horizon), as the shared memory was sized by it.
template <int kSource, bool kTabulated, class Sink>
__device__ __forceinline__ void scan_cell(const ScanIn& p, const Lanes& L, int g, bool fresh,
                                          SlotState& s, Sink& sink, int32_t* smem,
                                          int (&tally)[3]) {
  constexpr bool kDrawn = kSource != kConstantRow;
  constexpr bool kAtom = kSource == kUniformsAtom;
  const int T = p.T, N = p.N, tile = p.tile, horizon = p.horizon;
  constexpr bool fast = kTabulated;              // the peek table and the ring
  int32_t* a_s = smem;                           // demand slots [t0, t0 + tile)
  int32_t* p_s = a_s + tile;                     // predicted [t0 + 1, t0 + 1 + tile + horizon)
  int32_t* lo_s = p_s + tile + horizon;          // per sub-tile demand minimum
  int32_t* hi_s = lo_s + subtiles(tile);         // and maximum
  int32_t* peek_s = hi_s + subtiles(tile);       // fast: (horizon, kSub) windowed maxima
  constexpr int kRows = kAtom ? kSub / 2 : kSub;  // ring rows per table read ahead
  float* ring = reinterpret_cast<float*>(peek_s + kSub * horizon);   // fast: (kRows, kLanes)
  float* ring0 = ring + kRows * kLanes;         // A3's atom uniforms, likewise

  const int32_t* a_row = p.traces + static_cast<size_t>(p.cell_trace[g]) * T;
  const int32_t* p_row = p.predicted + static_cast<size_t>(p.cell_pred[g]) * T;
  const float reach = L.lane ? p.level_horizon[static_cast<size_t>(p.cell_hor[g]) * N + L.j]
                             : 0.f;
  // the peek examines h = 0 .. horizon - 1 where (float)h < reach: the first
  // `looks` slots after t (none for reach <= 0 or NaN)
  const int looks = reach > 0.f ? static_cast<int>(ceilf(fminf(reach, static_cast<float>(horizon))))
                                : 0;
  const int32_t* my_peek = peek_s + max(looks - 1, 0) * kSub;
  // this lane's column of its wait entries (read only where L.lane)
  const float* src = nullptr;
  const float* src0 = nullptr;
  float span = 0.f, p0 = 0.f;
  if (kSource == kTable) {
    src = p.thresholds + static_cast<size_t>(p.cell_thr[g]) * T * N + L.j;
  } else if (kSource != kConstantRow) {
    const size_t col = static_cast<size_t>(p.cell_uni[g]) * T * N + L.j;
    src = p.u + col;
    if (kAtom) src0 = p.u0 + col;
    if (L.lane) {
      const size_t at = static_cast<size_t>(p.cell_thr[g]) * N + L.j;
      span = p.thresholds[at];
      if (kAtom) p0 = p.p0[at];
    }
  }
  auto load = [&](int t) {
    Entry e;
    e.v = src[static_cast<size_t>(t) * N];
    e.v0 = kAtom ? src0[static_cast<size_t>(t) * N] : 0.f;
    return e;
  };
  auto to_wait = [&](Entry e) {
    return kSource == kTable ? e.v : wait_from_uniforms<kAtom>(e.v, e.v0, span, p0);
  };
  // the reference's peek, for an untabulated horizon: the first `looks` slots
  // after slot t = t0 + k that lie before T (past T it reads 0)
  auto walk = [&](int k, int t) {
    const int reach_in = min(looks, T - 1 - t);
    for (int h = 0; h < reach_in; ++h) {
      if (p_s[k + h] > L.route) return true;
    }
    return false;
  };
  const int lane_id = threadIdx.x & 31;
  const int warp = threadIdx.x / 32;

  for (int t0 = 0; t0 < T; t0 += tile) {
    const int len = min(tile, T - t0);
    __syncthreads();  // every thread is done with the previous tile
    for (int i = threadIdx.x; i < len; i += kLanes) a_s[i] = a_row[t0 + i];
    for (int i = threadIdx.x; i < len + horizon; i += kLanes) {
      const int t = t0 + 1 + i;
      p_s[i] = t < T ? p_row[t] : 0;
    }
    __syncthreads();
    for (int sub = warp; sub * kSub < len; sub += kWarps) {
      const int k = sub * kSub + lane_id;
      const int a = k < len ? a_s[k] : 0;
      const int lo = __reduce_min_sync(0xffffffffu, k < len ? a : INT_MAX);
      const int hi = __reduce_max_sync(0xffffffffu, k < len ? a : INT_MIN);
      if (lane_id == 0) {
        lo_s[sub] = lo;
        hi_s[sub] = hi;
      }
    }
    __syncthreads();

    for (int k0 = 0; k0 < len; k0 += kSub) {
      const int n = min(kSub, len - k0);
      const int sub = k0 / kSub;
      // both tests are block-uniform, so the barrier is reached by all or none
      if (L.rmax < lo_s[sub]) {
        const bool prev = (fresh && t0 + k0 == 0) || s.on;
        sink.all_busy(t0, k0, n, L.lane && !prev);
        if (L.lane) {
          s.on = true;
          s.r = 0.f;
        }
        ++tally[kAllBusy];
        continue;
      }
      if (L.rmin >= hi_s[sub] && !__syncthreads_or(s.on)) {
        sink.all_idle(t0, k0, n);
        ++tally[kAllIdle];
        continue;
      }
      ++tally[kStep];
      if (fast && horizon > 0) {
        // the largest predicted demand in each window of 1 .. horizon slots
        // after each slot of the sub-tile: a lane's peek is one compare
        __syncthreads();  // every thread is done with the previous sub-tile's table
        if (threadIdx.x < n) {
          int m = INT_MIN;
          for (int h = 0; h < horizon; ++h) {
            m = max(m, p_s[k0 + threadIdx.x + h]);
            peek_s[h * kSub + threadIdx.x] = m;
          }
        }
        __syncthreads();
      }
      int used = 0;     // ring rows this lane has consumed in the sub-tile
      if (kDrawn && fast) {
        // every entry this lane consumes in the sub-tile (slots from 1), in flight at once
        if (L.lane) {
          int row = 0;
          for (int k = max(k0, 1); k < k0 + n; ++k) {
            if (a_s[k - 1] > L.route && a_s[k] <= L.route) {
              const int at = row++ * kLanes + threadIdx.x;
              cp_async4(ring + at, src + static_cast<size_t>(t0 + k) * N);
              if (kAtom) cp_async4(ring0 + at, src0 + static_cast<size_t>(t0 + k) * N);
            }
          }
        }
        cp_async_commit();
      }
      for (int k = k0; k < k0 + n; ++k) {
        const int t = t0 + k;
        const bool busy = a_s[k] > L.route;
        const bool seen = fast && looks > 0 && my_peek[k - k0] > L.route;   // off the chain
        const bool prev = (fresh && t == 0) ? busy : s.on;
        const uint32_t bits = slot_step(
            s, busy, prev, [&] { return fast ? seen : walk(k, t); },
            [&](float w) {
              if (!kDrawn) return w;
              if (k == 0 || !fast) return to_wait(load(t));   // on the chain
              cp_async_wait_all();
              const int at = used++ * kLanes + threadIdx.x;
              return to_wait(Entry{ring[at], kAtom ? ring0[at] : 0.f});
            });
        sink.slot(t0, k, s.on, prev, bits);
      }
    }
    sink.tile_end(t0, len);
  }
}

// Adds thread 0's path tallies to the counters, where the caller asked for them.
__device__ __forceinline__ void flush_tally(int32_t* paths, const int (&tally)[3]) {
  if (paths != nullptr && threadIdx.x == 0) {
    for (int i = 0; i < 3; ++i) {
      if (tally[i]) atomicAdd(paths + i, tally[i]);
    }
  }
}

}  // namespace repro_scan
