// Queue-mode FIFO gang admission for Hopper (sm_90a).
//
// Replaces the Mosaic kernel spark_scheduler_tpu/ops/pallas_fifo.py
// `_make_kernel` (reached through `fifo_pack_pallas`, :576, call :668),
// whose gang math is `make_gang_solver` — here gang_solve.cuh, shared with
// the segmented-window kernel (window_kernel.cu).
//
// What it computes, for each of G independent queues (one instance group
// each; G = 1 for `fifo_pack`): the queue's B apps in FIFO order, with the
// node priority orders fixed once from the starting availability (the
// caller sorts in PyTorch, fitEarlierDrivers semantics) and the
// availability carried from app to app. Per app: node capacities with and
// without the driver reserved, the driver by the feasibility identity, the
// executors by the strategy's fill (per zone, with the efficiency-scored
// zone pick, for the single-AZ strategies), strict-FIFO blocking, and the
// admitted gang debited. The availability after the last app is written
// out in node order.
//
// What bounds it on this card: latency, not bandwidth or arithmetic. Apps
// are sequential and every app is a chain of dependent block reductions (the
// driver, then one per placed node or slot, emax at most), each ending in a
// barrier. The TPU kernel's sequential grid over apps becomes a loop inside
// ONE block of 1024 threads per queue. Queues share nothing, so the G
// queues of a grouped solve are G blocks of one launch and run side by side
// on G SMs.
//
// What the design does about it: one block is the team (gang_solve.cuh
// `BlockTeam`). Per-node state (availability, both capacities, driver fit,
// two count buffers, 8 n int32 words per queue) lives in global memory and
// stays in L2; nodes are keyed by priority rank, so an argmin is a block
// min over a (rank, payload) key and an order[] lookup and no node
// permutation is needed (the TPU kernel's pre-permuted, sublane-folded node
// axis is a layout choice of that chip). The window kernel runs the same
// gang math on a thread-block cluster with the state in shared memory
// (`ClusterTeam`); this kernel moving to it is left for later work.
#include <cuda_runtime.h>

#include "gang_solve.cuh"

namespace {

constexpr int kThreads = kGsThreads;

// Every per-queue array is stacked [G][...] and contiguous.
struct QueueParams {
  int rows, n, emax;
  GsStrategy s;
  const int* dreq;  // [G][rows][3]
  const int* ereq;  // [G][rows][3]
  const int* cnt;   // [G][rows]
  const unsigned char* valid;  // [G][rows]
  const unsigned char* skip;   // [G][rows]
  const int* avail;            // [G][n][3] starting availability
  const unsigned char* elig_e;  // [G][n]
  const unsigned char* elig_d;  // [G][n]
  const int* drank;    // [G][n]
  const int* d_order;  // [G][n]
  const int* erank;    // [G][n]
  const int* e_order;  // [G][n]
  const int* zone;     // [G][n]
  const int* sched;    // [G][n][3]
  int* meta;           // [G][rows][4] (driver_node, admitted, packed, 0)
  int* execs;          // [G][rows][emax]
  int* avail_out;      // [G][n][3] availability after every admitted app
  int* scratch;        // [G][8 n + 2 emax + 2 num_zones]
};

__global__ void __launch_bounds__(kThreads) fifo_queue_kernel(QueueParams p) {
  __shared__ unsigned long long red[32];
  const long long g = blockIdx.x;
  const int n = p.n, rows = p.rows, emax = p.emax;
  const long long words = 8LL * n + 2LL * emax + 2LL * p.s.num_zones;
  int* scratch = p.scratch + g * words;
  const GsWork w = gs_carve(scratch, n, scratch + 8 * n, emax, p.s.num_zones);
  const int* avail0 = p.avail + g * n * 3;
  int* avail_out = p.avail_out + g * n * 3;
  BlockTeam t{n, n, red};

  GS_NODES(t, li, i) {
    for (int d = 0; d < 3; ++d) w.avail[d * n + i] = avail0[i * 3 + d];
  }

  GangCtx c;
  c.n = n;
  c.emax = emax;
  c.avail = w.avail;
  c.sched = p.sched + g * n * 3;
  c.cap_e = w.cap_e;
  c.cap_wd = w.cap_wd;
  c.fit_d = w.fit_d;
  c.elig_e = p.elig_e + g * n;
  c.elig_d = p.elig_d + g * n;
  c.zone = p.zone + g * n;
  c.drank = p.drank + g * n;
  c.d_order = p.d_order + g * n;
  c.erank = p.erank + g * n;
  c.e_order = p.e_order + g * n;
  gs_zone_facts(t, c, p.s, w);  // the orders are fixed for the whole queue

  const int* dreq = p.dreq + g * rows * 3;
  const int* ereq = p.ereq + g * rows * 3;
  const int* cnt = p.cnt + g * rows;
  const unsigned char* valid = p.valid + g * rows;
  const unsigned char* skip = p.skip + g * rows;
  int* meta = p.meta + g * rows * 4;
  int* execs = p.execs + g * rows * emax;
  bool blocked = false;
  for (int b = 0; b < rows; ++b) {
    if (!valid[b]) {  // padding: never packs, debits or blocks
      gs_empty_row(t, meta + b * 4, execs + b * emax, emax);
      continue;
    }
    gs_fifo_row(t, c, p.s, w, dreq + b * 3, ereq + b * 3, cnt[b], skip[b] != 0, &blocked,
                nullptr, meta + b * 4, execs + b * emax);
  }
  GS_NODES(t, li, i) {
    for (int d = 0; d < 3; ++d) avail_out[i * 3 + d] = w.avail[d * n + i];
  }
}

}  // namespace

extern "C" int fifo_queue(
    int groups, int rows, int n, int emax, int num_zones, int fill, int single_az,
    int az_fallback, int include_exec, const int* dreq, const int* ereq, const int* cnt,
    const unsigned char* valid, const unsigned char* skip, const int* avail,
    const unsigned char* elig_e, const unsigned char* elig_d, const int* drank,
    const int* d_order, const int* erank, const int* e_order, const int* zone,
    const int* sched, int* meta, int* execs, int* avail_out, int* scratch, void* stream) {
  QueueParams p{rows,   n,      emax,  GsStrategy{fill, single_az, az_fallback, include_exec, num_zones},
                dreq,   ereq,   cnt,   valid,   skip,    avail,  elig_e,   elig_d,
                drank,  d_order, erank, e_order, zone,   sched,  meta,     execs,
                avail_out, scratch};
  fifo_queue_kernel<<<groups, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* fifo_kernel_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
