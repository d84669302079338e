// Segmented serving-window row walk for Hopper (sm_90a).
//
// Replaces the Mosaic kernel spark_scheduler_tpu/ops/pallas_window.py
// `_make_window_kernel` (reached through `window_pack_pallas`), whose gang
// math is ops/pallas_fifo.py `make_gang_solver` — here gang_solve.cuh.
//
// What it computes, for ONE segment of a serving window (one /predicates
// request): the segment's rows in FIFO order, availability carried from row
// to row. Per row: node capacities with and without the driver reserved, the
// driver by the feasibility identity, the executors by the strategy's fill
// (per zone, with the efficiency-scored zone pick, for the single-AZ
// strategies), strict-FIFO blocking, and the admitted row debited. After the
// last real row, the committing row's placement is subtracted from the
// committed base, which the next segment's sorts read.
//
// What bounds it on this card: latency, not bandwidth or arithmetic. Rows
// are sequential and every row is a chain of dependent block reductions (the
// driver, then one per placed node or slot, emax at most): a few hundred KB
// of L2 traffic and some 20 N-wide integer passes per row, each ending in a
// barrier. The segments are sequential too (each one's sorts read the base
// the previous commit left), so a TPU grid step becomes a loop inside ONE
// block of 1024 threads, launched once per live segment on the caller's
// stream with no host synchronisation between segments.
//
// What the design does about it: per-node state (availability, both
// capacities, driver fit, two count buffers) lives in global memory, which
// stays in L2 (8 N int32 words, 512 KB at N = 16,384), not in shared memory:
// the three availability rows alone (192 KB at that N) would crowd out
// everything else. Each reduction is warp shuffles plus one shared-memory
// stage. Keys are unique ranks, so an argmin is a min over ranks and an
// order[] lookup. Tightly-pack places min(remaining, slots left) slots per
// round, so its rounds count distinct nodes, not slots. Spreading a segment
// over several blocks (cluster or grid reduction) and capturing the segment
// loop in a CUDA graph are left for later work.
#include <cuda_runtime.h>

#include "gang_solve.cuh"

namespace {

constexpr int kThreads = 1024;

struct WalkParams {
  const int* dreq;  // [rows][3]
  const int* ereq;  // [rows][3]
  const int* cnt;   // [rows]
  const unsigned char* valid;
  const unsigned char* skip;
  int rows, row_count;
  int* base;  // [n][3] committed base: read at start, commit row subtracted at end
  const unsigned char* elig_e;
  const unsigned char* elig_d;
  const int* drank;
  const int* d_order;
  const int* erank;
  const int* e_order;
  const int* zone;
  const int* sched;  // [n][3]
  int n, emax, num_zones, fill, single_az, az_fallback, include_exec;
  int* meta;     // [rows][4]
  int* execs;    // [rows][emax]
  int* scratch;  // 8 n + 2 emax + 2 num_zones int32 words
};

__global__ void __launch_bounds__(kThreads) window_row_walk_kernel(WalkParams p) {
  __shared__ unsigned long long red[32];
  const int n = p.n;
  const GsWork w = gs_carve(p.scratch, n, p.emax, p.num_zones);
  const GsStrategy s{p.fill, p.single_az, p.az_fallback, p.include_exec, p.num_zones};

  for (int i = threadIdx.x; i < n; i += blockDim.x)
    for (int d = 0; d < 3; ++d) w.avail[d * n + i] = p.base[i * 3 + d];

  GangCtx c;
  c.n = n;
  c.emax = p.emax;
  c.avail = w.avail;
  c.sched = p.sched;
  c.cap_e = w.cap_e;
  c.cap_wd = w.cap_wd;
  c.fit_d = w.fit_d;
  c.elig_e = p.elig_e;
  c.elig_d = p.elig_d;
  c.zone = p.zone;
  c.drank = p.drank;
  c.d_order = p.d_order;
  c.erank = p.erank;
  c.e_order = p.e_order;
  c.red = red;
  gs_zone_facts(c, s, w);  // once per segment

  bool blocked = false;
  for (int r = 0; r < p.rows; ++r) {
    int* meta = p.meta + r * 4;
    int* execs = p.execs + r * p.emax;
    if (r >= p.row_count || !p.valid[r]) {
      gs_empty_row(meta, execs, p.emax);
      continue;
    }
    // The committing row (the segment's last) is also debited from the base.
    gs_fifo_row(c, s, w, p.dreq + r * 3, p.ereq + r * 3, p.cnt[r], p.skip[r] != 0,
                &blocked, r == p.row_count - 1 ? p.base : nullptr, meta, execs);
  }
}

}  // namespace

extern "C" int window_row_walk(
    const int* dreq, const int* ereq, const int* cnt, const unsigned char* valid,
    const unsigned char* skip, int rows, int row_count, int* base,
    const unsigned char* elig_e, const unsigned char* elig_d, const int* drank,
    const int* d_order, const int* erank, const int* e_order, const int* zone,
    const int* sched, int n, int emax, int num_zones, int fill, int single_az,
    int az_fallback, int include_exec, int* meta, int* execs, int* scratch,
    void* stream) {
  WalkParams p{dreq,    ereq,   cnt,   valid,  skip,      rows,        row_count,
               base,    elig_e, elig_d, drank, d_order,   erank,       e_order,
               zone,    sched,  n,     emax,   num_zones, fill,        single_az,
               az_fallback, include_exec, meta, execs, scratch};
  window_row_walk_kernel<<<1, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* window_kernel_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
