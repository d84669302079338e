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
// are sequential and every app is a chain of dependent steps, each a pass
// over the team's nodes (about one node a thread) and a team reduction:
// the driver's sum and min, then one per fill round (per placed node for
// tightly-pack, per slot for distribute-evenly, emax at most). A step costs
// about the same whatever it touches, so the chain's length sets the time.
// The single-AZ strategies used to run that chain once a zone (~30
// reductions a gang at 6 zones, half the gang's time inside them on an
// H100: PERF.md); their instantiation (kLanes) now solves every zone in
// one chain of lane reductions, one lane a zone (gang_solve.cuh
// `gs_gang_solve_lanes`): ~5 steps a gang whatever the zone count up to
// kGsLanes. The plain strategies keep their own instantiation, compiled
// from the code they had, so its registers, spills and shared memory are
// what they were. The TPU kernel's sequential grid over apps becomes a
// loop inside one team of threads per queue.
//
// What the design does about it: each queue gets a TEAM sized to its node
// count (ops/launch.py `kernel_layout`), and the G queues of a grouped solve
// are G teams of ONE launch (cudaLaunchKernelEx), side by side on the SMs:
//   - "block": one block of 1,024 threads (gang_solve.cuh `BlockTeam`).
//     A reduction is warp shuffles, one __syncthreads, and every warp
//     combining the 32 warp partials with five more shuffles; two partial
//     buffers alternate, so one barrier a reduction is enough. Best while a
//     node pass is a node or a few a thread (n below
//     QUEUE_CLUSTER_MIN_NODES, measured on an H100: PERF.md).
//   - "cluster": one thread-block cluster of K = 8 blocks (`ClusterTeam`,
//     the row walk's team); block r owns nodes [r * slice, (r + 1) * slice),
//     slice = ceil(n / K), and a reduction adds one distributed-shared-memory
//     exchange (st.async onto each block's mbarrier). The queue index is the
//     cluster index, blockIdx.x / K. More queues than resident clusters
//     queue up: a cluster's blocks are scheduled together, so no wait spans
//     clusters.
// The mutable per-node state, 8 words a node (availability x3, both
// capacities, driver fit, two count buffers), lives in each block's
// dynamic shared memory ("smem": 32 B x slice beside the static buffers,
// up to 232,448 B a block) and in global scratch where it does not fit
// ("global"). Every block keeps its own gang slots and zone facts in global
// scratch. Each block loads its slice of the starting availability and
// writes its slice of the availability after the queue. The winner's
// payload rides in the 64-bit reduction key, so no thread reads another's
// node state and the state needs no barrier of its own.
// ptxas (-Xptxas -v) for the eight instantiations (team x node-state
// place x lanes) is printed by chip_smoke.py phase 1.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "device_setup.cuh"
#include "gang_solve.cuh"

namespace {

constexpr int kThreads = kGsThreads;
constexpr int kTeamBlock = 0;
constexpr int kTeamCluster = 1;

// Every per-queue array is stacked [G][...] and contiguous.
struct QueueParams {
  int rows, n, emax;
  int slice;  // nodes a block owns: n (block team) or ceil(n / K) (cluster)
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
  int* meta;           // [G][rows][4] (driver_node, admitted, packed, zone score bits)
  int* execs;          // [G][rows][emax]
  int* avail_out;      // [G][n][3] availability after every admitted app
  // Per block, in launch order ([G][blocks a team]): gs_extra_words (gang
  // slots, zone facts, and the lane slots of the zone-parallel
  // instantiation), then 8 slice words of node state for the global layout.
  int* scratch;
};

// Queue g walked by team t; `state` holds the team's 8 slice words of node
// state, `extra` its gang slots and zone facts.
template <bool kLanes, class Team>
__device__ __forceinline__ void walk_queue(Team& t, const QueueParams& p, long long g,
                                           int* state, int* extra) {
  const int n = p.n, rows = p.rows, emax = p.emax, slice = t.slice;
  const GsWork w = gs_carve(state, slice, extra, emax, p.s.num_zones);
  const int* avail0 = p.avail + g * n * 3;
  GS_NODES(t, li, i) {
    for (int d = 0; d < 3; ++d) w.avail[d * slice + li] = avail0[i * 3 + d];
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
  gs_zone_facts<kLanes>(t, c, p.s, w);  // the orders are fixed for the whole queue

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
    gs_fifo_row<kLanes>(t, c, p.s, w, dreq + b * 3, ereq + b * 3, cnt[b], skip[b] != 0, &blocked,
                nullptr, meta + b * 4, execs + b * emax, true);
  }
  int* avail_out = p.avail_out + g * n * 3;
  GS_NODES(t, li, i) {
    for (int d = 0; d < 3; ++d) avail_out[i * 3 + d] = w.avail[d * slice + li];
  }
}

// kLanes: the zone-parallel instantiation, for the single-AZ strategies
// (gang_solve.cuh gs_gang_solve_lanes), with its lane buffers in static
// shared memory; the plain strategies run the instantiation without them.
template <int kTeam, bool kSmemState, bool kLanes>
__global__ void __launch_bounds__(kThreads) fifo_queue_kernel(QueueParams p) {
  extern __shared__ int smem_state[];  // [8 slice] when kSmemState
  const int extra_words = gs_extra_words(p.emax, p.s.num_zones, kLanes);
  int* block_scratch = p.scratch + static_cast<long long>(blockIdx.x) *
                                       (extra_words + (kSmemState ? 0 : 8 * p.slice));
  int* state = kSmemState ? smem_state : block_scratch + extra_words;
  if constexpr (kTeam == kTeamCluster) {
    __shared__ unsigned long long red[32];
    __shared__ unsigned long long slots[2 * kGsCluster];
    __shared__ unsigned long long bars[2];
    namespace cg = cooperative_groups;
    const int rank = static_cast<int>(cg::this_cluster().block_rank());
    const int n = p.n, slice = p.slice;
    ClusterTeam t;
    t.lo = min(n, rank * slice);
    t.count = min(n, t.lo + slice) - t.lo;  // 0 for a block past the last node
    t.slice = slice;
    t.rank = static_cast<unsigned>(rank);
    t.leader = rank == 0;
    t.red = red;
    t.slots = slots;
    t.bars = bars;
    t.lslots = nullptr;
    if constexpr (kLanes) {
      __shared__ unsigned long long lanes[kGsClusterLaneWords];
      t.ln.attach(lanes);
      t.lslots = lanes + kGsLaneWords;
    }
    t.start();
    walk_queue<kLanes>(t, p, blockIdx.x / kGsCluster, state, block_scratch);
    ClusterTeam::cluster_sync();  // no block exits while a push may target it
  } else {
    __shared__ unsigned long long red[2 * 32];
    BlockTeam t{p.n, p.n, red, 0, {}};
    if constexpr (kLanes) {
      __shared__ unsigned long long lanes[kGsLaneWords];
      t.ln.attach(lanes);
      __syncthreads();  // the accumulators are zero before the first lane fold
    }
    walk_queue<kLanes>(t, p, blockIdx.x, state, block_scratch);
  }
}

using QueueKernel = void (*)(QueueParams);

SmemAllowance<4> g_smem_allowance;  // slot: 2 team + lanes

template <int kTeam>
QueueKernel pick(int smem_state, int lanes) {
  if (lanes)
    return smem_state ? &fifo_queue_kernel<kTeam, true, true>
                      : &fifo_queue_kernel<kTeam, false, true>;
  return smem_state ? &fifo_queue_kernel<kTeam, true, false>
                    : &fifo_queue_kernel<kTeam, false, false>;
}

// Sets `device` current and picks the instantiation for (team, smem_state,
// lanes), with its dynamic shared memory for `slice` nodes a block allowed
// there.
cudaError_t prepare(int device, int team, int smem_state, int lanes, int slice,
                    QueueKernel* kernel, int* dynamic) {
  *kernel = team == kTeamCluster ? pick<kTeamCluster>(smem_state, lanes)
                                 : pick<kTeamBlock>(smem_state, lanes);
  *dynamic = smem_state ? 8 * slice * static_cast<int>(sizeof(int)) : 0;
  cudaError_t e = cudaSetDevice(device);
  if (e == cudaSuccess && smem_state)
    e = g_smem_allowance.ensure(device, 2 * (team == kTeamCluster ? 1 : 0) + (lanes ? 1 : 0),
                                reinterpret_cast<const void*>(*kernel), *dynamic);
  return e;
}

// Blocks a team: 1, or kGsCluster for the cluster team.
int team_blocks(int team) { return team == kTeamCluster ? kGsCluster : 1; }

}  // namespace

// One launch over `groups` queues. team: 0 one block a queue, 1 one
// cluster of kGsCluster blocks a queue; slice: nodes a block owns;
// smem_state: where the node state lives (1 shared memory, 0 global
// scratch). A single-AZ strategy runs the zone-parallel instantiation.
// Returns the CUDA error of the launch (0 on success).
extern "C" int fifo_queue(
    int device, int groups, int rows, int n, int emax, int num_zones, int fill, int single_az,
    int az_fallback, int include_exec, const int* dreq, const int* ereq, const int* cnt,
    const unsigned char* valid, const unsigned char* skip, const int* avail,
    const unsigned char* elig_e, const unsigned char* elig_d, const int* drank,
    const int* d_order, const int* erank, const int* e_order, const int* zone,
    const int* sched, int* meta, int* execs, int* avail_out, int* scratch, int team,
    int slice, int smem_state, void* stream) {
  QueueParams p{rows,   n,      emax,  slice,
                GsStrategy{fill, single_az, az_fallback, include_exec, num_zones},
                dreq,   ereq,   cnt,   valid,   skip,    avail,  elig_e,   elig_d,
                drank,  d_order, erank, e_order, zone,   sched,  meta,     execs,
                avail_out, scratch};
  QueueKernel kernel;
  int dynamic;
  cudaError_t e = prepare(device, team, smem_state, single_az, slice, &kernel, &dynamic);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = team_config(team_blocks(team), groups, kThreads, dynamic,
                                             static_cast<cudaStream_t>(stream), &attr);
  e = cudaLaunchKernelEx(&cfg, kernel, p);
  return static_cast<int>(e != cudaSuccess ? e : cudaGetLastError());
}

// What the card reports for one instantiation (lanes: the zone-parallel
// one) with `slice` nodes a block, in out[0..3] (device_setup.cuh
// `team_info`). Returns the CUDA error (0 on success).
extern "C" int fifo_kernel_info(int device, int team, int smem_state, int lanes, int slice,
                                int* out) {
  QueueKernel kernel;
  int dynamic;
  const cudaError_t e = prepare(device, team, smem_state, lanes, slice, &kernel, &dynamic);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(team_info(device, kernel, team_blocks(team), kThreads, dynamic, out));
}

extern "C" const char* fifo_kernel_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
