// Segmented serving-window row walk for Hopper (sm_90a), one thread-block
// cluster per segment.
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
// What bounds it on this card: latency. Rows are sequential and every row
// is a chain of dependent reductions over the nodes (the driver's sum and
// min, then one per fill round: per placed node for tightly-pack, per slot
// for distribute-evenly, per zone for single-AZ, emax at most; ~9.6 a row
// on the serving path's tightly-pack windows), a few nanoseconds of
// arithmetic each at the bound. The segments are sequential too (each one's
// sorts read the base the previous commit left): one launch per live
// segment on the caller's stream, no host synchronisation between.
//
// What the design does about it: a segment runs on ONE cluster of K = 8
// blocks of 1,024 threads on 8 SMs (cudaLaunchKernelEx with a cluster
// dimension). Block r owns nodes [r * slice, (r + 1) * slice), slice =
// ceil(n / K), so a node pass is slice / 1,024 nodes a thread (2 at the
// serving path's padded n = 16,384, where one block took 16). Its mutable
// per-node state, 8 words a node (availability x3, both capacities, driver
// fit, two count buffers), lives in the block's dynamic shared memory:
// 32 B x slice, 65,536 B at n = 16,384, plus 400 B of static reduction
// buffers and mbarriers (65,936 B a block); it is loaded from the base at
// segment start and the commit row's debit goes back to the base by owner.
// Layout "global" keeps the same state in global memory (per block) for
// clusters whose slice does not fit (ops/window.py `walk_layout`: n above
// 58,008). The bound is now ONE distributed-shared-memory exchange per
// dependent reduction: a __syncthreads, then each block pushes its partial
// into every block's shared memory with `st.async` and waits on its own
// mbarrier (gang_solve.cuh `ClusterTeam`); a cluster barrier runs only at
// launch start and end. The winner's payload rides in the 64-bit key. A
// cluster barrier (arrive.release / wait.acquire) per reduction measured
// 22.5 us a row on an H100 against 17.0 us for the mbarrier exchange
// (PERF.md).
// ptxas, CUDA 12.8, sm_90a (-Xptxas -v, printed by chip_smoke.py phase 1):
// 64 registers a thread (the cap at 1,024 threads); no spills for the
// shared-memory instantiation, 4 B of spill stores and loads for the
// global-state one.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "device_setup.cuh"
#include "gang_solve.cuh"

namespace {

constexpr int kThreads = kGsThreads;

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
  int* scratch;  // per block: [8 slice (global state only)][2 emax + 2 num_zones]
  int slice;     // nodes per block = ceil(n / K)
};

template <bool kSmemState>
__global__ void __launch_bounds__(kThreads) window_row_walk_kernel(WalkParams p) {
  extern __shared__ int smem_state[];  // [8 slice] when kSmemState
  __shared__ unsigned long long red[32];
  __shared__ unsigned long long slots[2 * kGsCluster];
  __shared__ unsigned long long bars[2];
  namespace cg = cooperative_groups;
  const cg::cluster_group cl = cg::this_cluster();
  const int n = p.n, slice = p.slice;
  const int rank = static_cast<int>(cl.block_rank());

  ClusterTeam t;
  t.lo = min(n, rank * slice);
  t.count = min(n, t.lo + slice) - t.lo;
  t.slice = slice;
  t.rank = static_cast<unsigned>(rank);
  t.leader = rank == 0;
  t.red = red;
  t.slots = slots;
  t.bars = bars;
  t.start();

  const int extra_words = 2 * p.emax + 2 * p.num_zones;
  int* block_scratch = p.scratch + static_cast<long long>(rank) *
                                       (extra_words + (kSmemState ? 0 : 8 * slice));
  int* state = kSmemState ? smem_state : block_scratch + extra_words;
  const GsWork w = gs_carve(state, slice, block_scratch, p.emax, p.num_zones);
  const GsStrategy s{p.fill, p.single_az, p.az_fallback, p.include_exec, p.num_zones};

  GS_NODES(t, li, i) {
    for (int d = 0; d < 3; ++d) w.avail[d * slice + li] = p.base[i * 3 + d];
  }

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
  gs_zone_facts(t, c, s, w);  // once per segment

  bool blocked = false;
  for (int r = 0; r < p.rows; ++r) {
    int* meta = p.meta + r * 4;
    int* execs = p.execs + r * p.emax;
    if (r >= p.row_count || !p.valid[r]) {
      gs_empty_row(t, meta, execs, p.emax);
      continue;
    }
    // The committing row (the segment's last) is also debited from the base.
    gs_fifo_row(t, c, s, w, p.dreq + r * 3, p.ereq + r * 3, p.cnt[r], p.skip[r] != 0,
                &blocked, r == p.row_count - 1 ? p.base : nullptr, meta, execs);
  }
  ClusterTeam::cluster_sync();  // no block exits while a push may target it
}

// The launch shape: one cluster of kGsCluster blocks, `dynamic` bytes of
// shared memory each; `attr` must outlive the config.
cudaLaunchConfig_t cluster_config(int dynamic, cudaStream_t stream, cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kGsCluster, 1, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = dynamic;
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = kGsCluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

SmemAllowance<1> g_smem_allowance;

// Sets `device` current and picks the instantiation for `smem_state`, with
// its dynamic shared memory for `slice` nodes a block allowed there.
cudaError_t prepare(int device, int smem_state, int slice, void (**kernel)(WalkParams),
                    int* dynamic) {
  *kernel = smem_state ? &window_row_walk_kernel<true> : &window_row_walk_kernel<false>;
  *dynamic = smem_state ? 8 * slice * static_cast<int>(sizeof(int)) : 0;
  cudaError_t e = cudaSetDevice(device);
  if (e == cudaSuccess && smem_state)
    e = g_smem_allowance.ensure(device, 0, reinterpret_cast<const void*>(*kernel), *dynamic);
  return e;
}

}  // namespace

// One launch on `device`: a cluster of kGsCluster blocks walks one
// segment. smem_state selects where the node state lives (1: shared
// memory, 0: global scratch). Returns the CUDA error of the launch (0 on
// success).
extern "C" int window_row_walk(
    int device, const int* dreq, const int* ereq, const int* cnt, const unsigned char* valid,
    const unsigned char* skip, int rows, int row_count, int* base,
    const unsigned char* elig_e, const unsigned char* elig_d, const int* drank,
    const int* d_order, const int* erank, const int* e_order, const int* zone,
    const int* sched, int n, int emax, int num_zones, int fill, int single_az,
    int az_fallback, int include_exec, int* meta, int* execs, int* scratch, int slice,
    int smem_state, void* stream) {
  WalkParams p{dreq,    ereq,   cnt,   valid,  skip,      rows,        row_count,
               base,    elig_e, elig_d, drank, d_order,   erank,       e_order,
               zone,    sched,  n,     emax,   num_zones, fill,        single_az,
               az_fallback, include_exec, meta, execs, scratch, slice};
  void (*kernel)(WalkParams);
  int dynamic;
  cudaError_t e = prepare(device, smem_state, slice, &kernel, &dynamic);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg =
      cluster_config(dynamic, static_cast<cudaStream_t>(stream), &attr);
  e = cudaLaunchKernelEx(&cfg, kernel, p);
  return static_cast<int>(e != cudaSuccess ? e : cudaGetLastError());
}

// What `device` reports for one instantiation: out[0] registers a thread,
// out[1] local (spill) bytes a thread, out[2] static shared bytes a block,
// out[3] how many such clusters with `slice` nodes a block can be resident
// at once (cudaOccupancyMaxActiveClusters; 0 means the launch cannot run).
// Returns the CUDA error (0 on success).
extern "C" int window_kernel_info(int device, int smem_state, int slice, int* out) {
  void (*kernel)(WalkParams);
  int dynamic;
  cudaError_t e = prepare(device, smem_state, slice, &kernel, &dynamic);
  cudaFuncAttributes a;
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&a, kernel);
  if (e != cudaSuccess) return static_cast<int>(e);
  out[0] = a.numRegs;
  out[1] = static_cast<int>(a.localSizeBytes);
  out[2] = static_cast<int>(a.sharedSizeBytes);
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = cluster_config(dynamic, nullptr, &attr);
  int clusters = 0;
  e = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
  out[3] = clusters;
  return static_cast<int>(e);
}

extern "C" const char* window_kernel_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
