// Per-gang solve as CUDA device functions for a TEAM of threads: one block
// (BlockTeam) or one thread-block cluster (ClusterTeam).
//
// Replaces the gang math the JAX package shares between its two Mosaic
// kernels: spark_scheduler_tpu/ops/pallas_fifo.py `make_driver_selector`,
// `make_fill_runner` and `make_gang_solver` (:119-410). Both CUDA kernels,
// the segmented-window row walk (window_kernel.cu, a ClusterTeam) and the
// queue-mode FIFO admission (fifo_kernel.cu, a BlockTeam or a ClusterTeam
// by node count), include this header and walk their rows with the same
// `gs_fifo_row`, so the two cannot drift. The plain PyTorch version of the
// same math is spark_scheduler_tpu_torch/ops/gang.py.
//
// Every function is called by ALL threads of the team with the same
// arguments and returns the same (uniform) values in every thread. The team
// owns the node range [lo, lo + count); the per-node MUTABLE state
// (availability, both capacities, driver fit, two count buffers) holds only
// those nodes, at local index li = node - lo, and is touched only by the
// thread that walks li in every node loop (li % kGsThreads == threadIdx.x),
// so it needs no barrier of its own. The read-only per-node inputs (ranks,
// orders, zones, schedulable, eligibility) stay in global memory, indexed
// by node. Every "first node in priority order among a mask" is a team
// min-reduction over a key led by the node's priority RANK (or a value that
// orders before it): the ranks are permutations of 0..n-1, so the minimum
// is unique and its node is order[rank]. What the winner's owner knows (the
// slots it takes, its node) rides in the key's low bits, so every thread
// learns the placement from the one reduction.
//
// Single-AZ zone scores: the weighted efficiency sum is accumulated in
// double over the float32 per-node products and rounded once to float; at
// most count + 1 products are non-zero, so the team's reduction order does
// not change it; ops/gang.py computes it the same way. The JAX package sums
// in float32 in tile order instead: a cross-zone tie closer than about 1 ulp
// may break differently there (the deviation ops/pallas_fifo.py:49-56
// documents between its own two paths).
//
// What bounds a gang: its chain of dependent steps, each a pass over the
// team's nodes (one node a thread at 5,000 nodes) and a team reduction
// (warp shuffles, a __syncthreads and, for a cluster, one
// distributed-shared-memory round trip: ~0.6 us on an H100 whatever it
// carries, the pass's loads and barriers about as much again), not the
// node visits. A single-AZ gang solved zone by zone ran a driver selection
// (2 reductions), a fill (a round or more, and 2 barriers) and a score
// (1 reduction) for EACH zone: ~30 reductions a gang at 6 zones (PERF.md).
// The zones partition the nodes, so the single-AZ strategies solve every
// zone at once instead (`gs_gang_solve_lanes`): each reduction carries
// kGsLanes LANES, one a zone, each node folding into the lane of its own
// zone (`fold_lanes`), and one count buffer holds every zone's tentative
// executors. A gang then waits on ~5 reductions (driver sum, driver
// minimum, a fill round or more, the scores) whatever the zone count up to
// kGsLanes; more zones run in chunks of kGsLanes. The lane buffers exist
// only in the zone-parallel instantiation (template flag kLanes of the
// kernels): the plain strategies keep their own instantiation, compiled
// from the code it had (gs_gang_solve).
#pragma once

#include <cstdint>
#include <cstring>

#define GS_INF 2147483646  // INT32_INF = 2**31 - 2, the int32 sentinel
#define GS_U64_NONE 0xffffffffffffffffull

enum GsFill { GS_TIGHTLY = 0, GS_DISTRIBUTE = 1, GS_MINFRAG = 2 };

// Both kernels launch 1,024 threads a block (32 warps); the node loops
// stride by it.
constexpr int kGsThreads = 1024;

// Block-wide reduction; every thread gets the result. `red` is a 32-entry
// shared buffer: warp w's partial goes to red[w], then every warp reads the
// 32 partials, one a lane, and combines them with the same five xor
// shuffles, so every thread of the block ends with the same bits (the
// scheme of ClusterTeam::reduce). The caller alternates two such buffers:
// reduction t + 2 writes the buffer of t only after every thread has passed
// the barrier of t + 1, so after its own reads of t, and one barrier a
// reduction is enough.
template <typename T, typename Op>
__device__ __forceinline__ T gs_block_reduce(T v, Op op, T* red) {
  for (int o = 16; o > 0; o >>= 1) v = op(v, __shfl_xor_sync(0xffffffffu, v, o));
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  T r = red[threadIdx.x & 31];  // kGsThreads / 32 == 32 warps, one per lane
  for (int o = 16; o > 0; o >>= 1) r = op(r, __shfl_xor_sync(0xffffffffu, r, o));
  return r;
}

struct GsMin {
  template <typename T>
  __device__ __forceinline__ T operator()(T a, T b) const { return b < a ? b : a; }
};
struct GsMax {
  template <typename T>
  __device__ __forceinline__ T operator()(T a, T b) const { return b > a ? b : a; }
};
struct GsSum {
  template <typename T>
  __device__ __forceinline__ T operator()(T a, T b) const { return a + b; }
};

__device__ __forceinline__ unsigned long long gs_key(unsigned hi, unsigned lo) {
  return (static_cast<unsigned long long>(hi) << 32) | lo;
}

// Zones one lane reduction carries: 8 covers every region of AWS (6 AZs
// at most), GCP and Azure; more zones run in chunks of kGsLanes.
constexpr int kGsLanes = 8;
// Row stride of the [kGsLanes][32] warp partials of the zone scores: 33,
// so the writers of one row hit distinct banks.
constexpr int kGsLaneStride = 33;

// Warp sum (the zone scores' doubles); every lane gets the same bits.
template <typename T, typename Op>
__device__ __forceinline__ T gs_warp_reduce(T v, Op op) {
  for (int o = 16; o > 0; o >>= 1) v = op(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Lane reductions (zone-parallel instantiations). A node pass folds each
// node's value into lane `zone - z0` of the block's current accumulator
// (Team::acc()) with a shared-memory atomic, so a thread keeps no array of
// lanes whatever the number of nodes it walks. Every fold has identity 0,
// so an accumulator is reset by zeroing it: int sums, and minima of 32- or
// 64-bit unsigned keys stored complemented (a maximum of ~key; a fold of 0
// reads back as the key of all ones, "none"). Integer folds are exact in
// any order, so the atomics' order does not show in the bits.
__device__ __forceinline__ void gs_acc_add(unsigned long long* acc, int lane, int v) {
  atomicAdd(reinterpret_cast<int*>(acc + lane), v);
}
__device__ __forceinline__ void gs_acc_min(unsigned long long* acc, int lane, unsigned key) {
  atomicMax(reinterpret_cast<unsigned*>(acc + lane), ~key);
}
__device__ __forceinline__ void gs_acc_min(unsigned long long* acc, int lane,
                                           unsigned long long key) {
  atomicMax(acc + lane, ~key);
}
// A fold's lane l, from the register in which thread (lane index) l holds
// it; called by every thread of the warp.
template <typename T>
__device__ __forceinline__ T gs_lane(T folded, int l) {
  return __shfl_sync(0xffffffffu, folded, l);
}

// A team's lane buffers in shared memory (zone-parallel instantiations):
// three rotating [kGsLanes] accumulators, the [kGsLanes][kGsLaneStride]
// warp partials of the zone scores, two [kGsLanes] int arrays (the chunk's
// zone drivers, the minimal-fragmentation remainders) and the best zone so
// far (4 ints); a cluster team adds two [kGsCluster][kGsLanes] slot rows
// (ClusterTeam::lslots). kGsLaneWords 8-byte words (ops/window.py
// LANE_WORDS).
constexpr int kGsLaneWords = 3 * kGsLanes + kGsLanes * kGsLaneStride + kGsLanes + 2;
struct GsLanes {
  unsigned long long* accs;  // [3][kGsLanes]
  double* part;              // [kGsLanes][kGsLaneStride]
  int* zdrv;                 // [kGsLanes]
  int* zaux;                 // [kGsLanes]
  int* best;                 // [4]: score bits, first driver rank, driver, zone
  int cur;                               // the accumulator nodes fold into
  const unsigned long long* last;        // the last fold's accumulator

  // Carves kGsLaneWords words; every thread, before the team's first
  // barrier. The first two accumulators start at identity.
  __device__ void attach(unsigned long long* smem) {
    accs = smem;
    part = reinterpret_cast<double*>(smem + 3 * kGsLanes);
    zdrv = reinterpret_cast<int*>(smem + 3 * kGsLanes + kGsLanes * kGsLaneStride);
    zaux = zdrv + kGsLanes;
    best = zaux + kGsLanes;
    cur = 0;
    last = accs;
    if (threadIdx.x < 2 * kGsLanes) accs[threadIdx.x] = 0;
  }
  __device__ __forceinline__ unsigned long long* acc() const { return accs + kGsLanes * cur; }
  // After a fold's barrier: zero the accumulator of the fold after next,
  // whose last reads (the pass after the fold before this one) are behind
  // this barrier and whose next writes are behind the next one.
  __device__ __forceinline__ void advance() {
    const int after_next = cur == 0 ? 2 : cur - 1;
    if (threadIdx.x < kGsLanes) accs[kGsLanes * after_next + threadIdx.x] = 0;
    cur = cur == 2 ? 0 : cur + 1;
  }
  // The block's sum of lane l < nl's warp partials, in thread (lane index)
  // l of the calling warp: one warp sum a lane.
  __device__ __forceinline__ double warp_sums(int nl, int mine) const {
    const int lane = threadIdx.x & 31;
    double a = 0.0;
    for (int l = 0; l < nl; ++l) {
      const double y = gs_warp_reduce(part[l * kGsLaneStride + lane], GsSum());
      if (mine == l) a = y;
    }
    return a;
  }
};

// One block owns every node (the queue kernel's team for small clusters).
// Node state is indexed by node (lo = 0, slice = n), in shared or global
// memory.
struct BlockTeam {
  static constexpr int lo = 0;
  static constexpr bool leader = true;  // writes the gang's outputs
  int count;  // nodes owned = n
  int slice;  // stride of the state arrays = n
  unsigned long long* red;  // shared, [2][32] partials, alternating by parity
  int parity;               // the buffer the next reduction uses
  GsLanes ln;               // zone-parallel instantiations only

  template <typename T, typename Op>
  __device__ __forceinline__ T reduce(T v, Op op) {
    static_assert(sizeof(T) <= 8, "a partial fits one 8-byte slot");
    T* buf = reinterpret_cast<T*>(red + 32 * parity);
    parity ^= 1;
    return gs_block_reduce<T>(v, op, buf);
  }
  __device__ __forceinline__ unsigned long long* acc() const { return ln.acc(); }
  // Ends a lane reduction: after one barrier the accumulator holds the
  // block's folds. Returns lane (threadIdx.x % kGsLanes)'s fold.
  template <typename T, typename Op>
  __device__ __forceinline__ T fold_lanes(Op) {
    __syncthreads();
    T r;
    memcpy(&r, ln.acc() + (threadIdx.x & (kGsLanes - 1)), sizeof(T));
    ln.last = ln.acc();
    ln.advance();
    return r;
  }
  // During the pass after fold_lanes: its lane l, l known only at run time.
  template <typename T, typename Op>
  __device__ __forceinline__ T lane_fold(int l, Op) const {
    T r;
    memcpy(&r, ln.last + l, sizeof(T));
    return r;
  }
  // Ends a lane sum of doubles (the zone scores) whose warps left their
  // lane-l sums in ln.part[l * kGsLaneStride + warp]: one barrier, then
  // the same shuffles in every warp. Returns lane (threadIdx.x % 32)'s sum
  // for the first nl lanes.
  __device__ __forceinline__ double fold_lane_sums(int nl) const {
    __syncthreads();
    return ln.warp_sums(nl, threadIdx.x & 31);
  }
  __device__ __forceinline__ bool owns(int node) const {
    return node < count && (node & (kGsThreads - 1)) == static_cast<int>(threadIdx.x);
  }
};

// Blocks in a cluster team: the largest portable cluster. (16, the
// non-portable size, measured no faster for the row walk on an H100:
// PERF.md.)
constexpr int kGsCluster = 8;
// A cluster team's lane buffers: GsLanes' and two [kGsCluster][kGsLanes]
// slot rows (ops/launch.py LANE_SMEM["cluster"]).
constexpr int kGsClusterLaneWords = kGsLaneWords + 2 * kGsCluster * kGsLanes;

// Shared-memory address helpers (PTX): the 32-bit shared::cta address of a
// generic pointer, and the same offset in block `rank` of the cluster.
__device__ __forceinline__ unsigned gs_smem(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ unsigned gs_mapa(unsigned addr, unsigned rank) {
  unsigned r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(r) : "r"(addr), "r"(rank));
  return r;
}

// One cluster of K = kGsCluster blocks owns every node; block r owns
// [r * slice, min(n, (r + 1) * slice)). A reduction is warp shuffles, one
// shared stage per block, then lane q of warp 0 PUSHES the block's partial
// into slot r of block q's shared memory with `st.async`, which completes
// 8 bytes on block q's mbarrier; each block waits on its own mbarrier (K x
// 8 bytes a phase) and every thread reads the K partials from its own
// shared memory in rank order, so every thread of every block gets the
// same bits. Only the partials cross blocks (the node state is
// block-private), so no reduction needs a cluster barrier or a
// cluster-scope fence: the mbarrier wait is a CTA-scope acquire, and a
// cluster barrier per reduction measured slower (PERF.md). Two slot rows
// with an mbarrier each alternate by parity: block q can push reduction
// t + 2 into a row only after it has this block's partial of t + 1, which
// this block pushes only after every one of its threads has read the row's
// values of t.
struct ClusterTeam {
  int lo, count, slice;
  unsigned rank;     // this block's rank in the cluster
  bool leader;       // block rank 0 writes the gang's outputs
  unsigned long long* red;    // shared, 32 warp partials
  unsigned long long* slots;  // shared, [2][kGsCluster] block partials
  unsigned long long* bars;   // shared, [2] mbarriers, one per slot row
  int parity;                 // the slot row the next reduction uses
  unsigned phases;            // bit p: the phase of bars[p] to wait for
  // Zone-parallel instantiations only: the lane buffers and, in shared
  // memory, [2][kGsCluster][kGsLanes] block lane partials. A lane
  // reduction takes the next slot row's parity and mbarrier, as a plain one
  // does, so the two kinds interleave freely.
  GsLanes ln;
  unsigned long long* lslots;
  const unsigned long long* lrow;  // the last lane fold's slot row

  // Once per launch, by every thread, before the first reduction.
  __device__ void start() {
    if (threadIdx.x == 0) {
      for (int p = 0; p < 2; ++p)
        asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(gs_smem(bars + p)), "r"(1u)
                     : "memory");
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    parity = 0;
    phases = 0;
    cluster_sync();  // every block's mbarriers exist before any push
  }

  template <typename T, typename Op>
  __device__ __forceinline__ T reduce(T v, Op op) {
    static_assert(sizeof(T) <= 8, "a partial fits one 8-byte slot");
    const unsigned bar = gs_smem(bars + parity);
    if (threadIdx.x == 0)  // this phase completes when K partials landed
      asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar),
                   "r"(8 * kGsCluster) : "memory");
    for (int o = 16; o > 0; o >>= 1) v = op(v, __shfl_xor_sync(0xffffffffu, v, o));
    T* part = reinterpret_cast<T*>(red);
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    if (lane == 0) part[warp] = v;
    __syncthreads();
    unsigned long long* row = slots + parity * kGsCluster;
    if (warp == 0) {
      T b = part[lane];  // kGsThreads / 32 == 32 warps, one per lane
      for (int o = 16; o > 0; o >>= 1) b = op(b, __shfl_xor_sync(0xffffffffu, b, o));
      if (lane < kGsCluster) {
        unsigned long long bits = 0;
        memcpy(&bits, &b, sizeof(T));
        asm volatile(
            "st.async.shared::cluster.mbarrier::complete_tx::bytes.u64 [%0], %1, [%2];" ::"r"(
                gs_mapa(gs_smem(row + rank), lane)),
            "l"(bits), "r"(gs_mapa(bar, lane))
            : "memory");
      }
    }
    wait(bar, (phases >> parity) & 1u);
    phases ^= 1u << parity;
    T r;
    memcpy(&r, row, sizeof(T));
#pragma unroll
    for (int q = 1; q < kGsCluster; ++q) {
      T x;
      memcpy(&x, row + q, sizeof(T));
      r = op(r, x);
    }
    parity ^= 1;
    return r;
  }
  __device__ __forceinline__ unsigned long long* acc() const { return ln.acc(); }
  // Ends a lane reduction (reduce's scheme with kGsLanes words a block):
  // after one barrier, threads 0-63 push lane l of this block's fold into
  // slot [rank][l] of block q, one 8-byte st.async each, so a phase
  // completes at 8 x K x kGsLanes bytes. Then every warp reads the K x
  // kGsLanes folds two a thread and combines the ranks with two xor
  // shuffles: the same operations on the same values in every thread of
  // every block, so the same bits. Returns lane (threadIdx.x % kGsLanes)'s
  // fold.
  template <typename T, typename Op>
  __device__ __forceinline__ T fold_lanes(Op op) {
    const unsigned bar = gs_smem(bars + parity);
    if (threadIdx.x == 0)  // this phase completes when K x kGsLanes partials landed
      asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar),
                   "r"(8 * kGsCluster * kGsLanes) : "memory");
    __syncthreads();
    unsigned long long* row = lslots + parity * kGsCluster * kGsLanes;
    if (threadIdx.x < kGsCluster * kGsLanes)
      push(row, threadIdx.x % kGsLanes, threadIdx.x / kGsLanes, ln.acc()[threadIdx.x % kGsLanes],
           bar);
    ln.advance();
    return combine<T>(row, bar, op);
  }
  // During the pass after fold_lanes: its lane l, l known only at run time
  // (the ranks combined in rank order; integer folds, so the same value).
  template <typename T, typename Op>
  __device__ __forceinline__ T lane_fold(int l, Op op) const {
    T r;
    memcpy(&r, lrow + l, sizeof(T));
#pragma unroll
    for (int q = 1; q < kGsCluster; ++q) {
      T x;
      memcpy(&x, lrow + q * kGsLanes + l, sizeof(T));
      r = op(r, x);
    }
    return r;
  }
  // Ends a lane sum of doubles (the zone scores) whose warps left their
  // lane-l sums in ln.part[l * kGsLaneStride + warp]: warps 0-1 sum each
  // lane over the block's warps and push it as fold_lanes does. Returns
  // lane (threadIdx.x % kGsLanes)'s sum for the first nl lanes.
  __device__ __forceinline__ double fold_lane_sums(int nl) {
    const unsigned bar = gs_smem(bars + parity);
    if (threadIdx.x == 0)
      asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar),
                   "r"(8 * kGsCluster * kGsLanes) : "memory");
    __syncthreads();
    unsigned long long* row = lslots + parity * kGsCluster * kGsLanes;
    if (threadIdx.x < kGsCluster * kGsLanes) {  // warps 0-1, whole
      const double mine = ln.warp_sums(nl, threadIdx.x % kGsLanes);
      unsigned long long bits;
      memcpy(&bits, &mine, sizeof(bits));
      push(row, threadIdx.x % kGsLanes, threadIdx.x / kGsLanes, bits, bar);
    }
    return combine<double>(row, bar, GsSum());
  }
  __device__ __forceinline__ void push(unsigned long long* row, int l, int q,
                                       unsigned long long bits, unsigned bar) const {
    asm volatile(
        "st.async.shared::cluster.mbarrier::complete_tx::bytes.u64 [%0], %1, [%2];" ::"r"(
            gs_mapa(gs_smem(row + rank * kGsLanes + l), q)),
        "l"(bits), "r"(gs_mapa(bar, q))
        : "memory");
  }
  // Waits for row's K x kGsLanes folds; thread t reads (t / kGsLanes,
  // t % kGsLanes) and (t / kGsLanes + 4, t % kGsLanes) of row[q][l].
  template <typename T, typename Op>
  __device__ __forceinline__ T combine(const unsigned long long* row, unsigned bar, Op op) {
    static_assert(kGsCluster * kGsLanes == 64, "two slots a thread");
    wait(bar, (phases >> parity) & 1u);
    phases ^= 1u << parity;
    parity ^= 1;
    lrow = row;
    const int lane = threadIdx.x & 31;
    T a, x;
    memcpy(&a, row + lane, sizeof(T));
    memcpy(&x, row + 32 + lane, sizeof(T));
    a = op(a, x);
    for (int o = kGsLanes; o < 32; o <<= 1) a = op(a, __shfl_xor_sync(0xffffffffu, a, o));
    return a;
  }
  __device__ __forceinline__ bool owns(int node) const {
    const int li = node - lo;
    return li >= 0 && li < count && (li & (kGsThreads - 1)) == static_cast<int>(threadIdx.x);
  }
  // Spin until the mbarrier's phase of parity `ph` completes. A phase that
  // never completes is a bug: trap, which the next synchronisation reports
  // as an error, rather than hang the card.
  __device__ __forceinline__ static void wait(unsigned bar, unsigned ph) {
    for (unsigned spins = 0;; ++spins) {
      unsigned done;
      asm volatile(
          "{\n\t.reg .pred p;\n\t"
          "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
          "selp.u32 %0, 1, 0, p;\n\t}"
          : "=r"(done)
          : "r"(bar), "r"(ph)
          : "memory");
      if (done) return;
      if (spins == (1u << 24)) __trap();
    }
  }
  // A full cluster barrier (arrive.release / wait.acquire): at launch start
  // and end only.
  __device__ __forceinline__ static void cluster_sync() {
    asm volatile("barrier.cluster.arrive.release;\n\tbarrier.cluster.wait.acquire;" ::: "memory");
  }
};

// Per-row inputs of the gang solve. The state pointers (avail, cap_e,
// cap_wd, fit_d) hold the team's nodes at local index li; the rest are
// global and indexed by node.
struct GangCtx {
  int n, emax, count;
  const int* avail;   // [3][slice] availability at this row (dimension-major)
  const int* sched;   // [n][3] schedulable
  const int* cap_e;   // [slice] executor capacity, no driver reserved
  const int* cap_wd;  // [slice] executor capacity with the driver reserved
  const int* fit_d;   // [slice] driver fits
  const unsigned char* elig_e;
  const unsigned char* elig_d;
  const int* zone;
  const int* drank;
  const int* d_order;
  const int* erank;
  const int* e_order;
  int dreq[3], ereq[3];
};

#define GS_NODES(t, li, i)                                          \
  for (int li = threadIdx.x, i = (t).lo + li; li < (t).count;       \
       li += kGsThreads, i += kGsThreads)

__device__ __forceinline__ bool gs_in_zone(const GangCtx& c, int i, int z) {
  return z < 0 || c.zone[i] == z;
}

// Executor capacity of node i (local index li) inside zone z with driver
// `drv` reserved.
__device__ __forceinline__ int gs_cap_fill(const GangCtx& c, int li, int i, int z, int drv) {
  if (!gs_in_zone(c, i, z)) return 0;
  return i == drv ? c.cap_wd[li] : c.cap_e[li];
}

// Driver selection by the feasibility identity (make_driver_selector):
// reserving the driver on node i only changes node i's executor capacity.
// z < 0 means every node. Returns the driver node, or -1.
template <class Team>
__device__ int gs_select_driver(Team& t, const GangCtx& c, int z) {
  const int count = c.count;
  int part = 0;
  GS_NODES(t, li, i) {
    if (gs_in_zone(c, i, z)) part += min(c.cap_e[li], count);
  }
  const int total = t.reduce(part, GsSum());
  int best = GS_INF;
  GS_NODES(t, li, i) {
    if (!gs_in_zone(c, i, z) || !c.elig_d[i] || !c.fit_d[li]) continue;
    const int total_if = total - min(c.cap_e[li], count) + min(c.cap_wd[li], count);
    if (total_if >= count) best = min(best, c.drank[i]);
  }
  best = t.reduce(best, GsMin());
  return best < GS_INF ? c.d_order[best] : -1;
}

// Executor fill (make_fill_runner). `cnt` [slice] receives executors per
// owned node, `ex` [emax] (leader block only) the node of each slot (-1
// past count). ok = a driver was found.
template <class Team>
__device__ void gs_run_fill(Team& t, const GangCtx& c, int fill, int z, int drv, bool ok,
                            int* cnt, int* ex) {
  const int count = c.count;
  GS_NODES(t, li, i) { cnt[li] = 0; }
  if (t.leader)
    for (int j = threadIdx.x; j < c.emax; j += kGsThreads) ex[j] = -1;
  __syncthreads();
  if (!ok) return;
  if (fill == GS_TIGHTLY) {
    // Every slot goes to the open node of smallest executor rank; that node
    // keeps winning until its capacity is spent, so one round places
    // min(room, slots left) slots. Key (rank * (emax + 1) + take, node):
    // ranks are unique, so the high word orders by rank alone, and it stays
    // below 2^32 because the wrapper guarantees n * emax < 2^31.
    const unsigned span = static_cast<unsigned>(c.emax) + 1u;
    int j = 0;
    while (j < count) {
      const int left = count - j;
      unsigned long long k = GS_U64_NONE;
      GS_NODES(t, li, i) {
        const int room = gs_cap_fill(c, li, i, z, drv) - cnt[li];
        if (room > 0) {
          const unsigned long long key =
              gs_key(static_cast<unsigned>(c.erank[i]) * span + min(room, left), i);
          k = key < k ? key : k;
        }
      }
      k = t.reduce(k, GsMin());
      int node = 0, take = left;  // no open node: the rest read node 0
      if (k != GS_U64_NONE) {
        node = static_cast<int>(k & 0xffffffffu);
        take = static_cast<int>((k >> 32) % span);
        if (t.owns(node)) cnt[node - t.lo] += take;
      }
      if (t.leader)
        for (int s = threadIdx.x; s < take; s += kGsThreads) ex[j + s] = node;
      j += take;
    }
  } else if (fill == GS_DISTRIBUTE) {
    // Key placed * n + rank: lexicographic (placed, rank). The wrapper
    // guarantees n * emax < 2^31, so the key stays below GS_INF.
    for (int j = 0; j < count; ++j) {
      int k = GS_INF;
      GS_NODES(t, li, i) {
        if (!c.elig_e[i] || !gs_in_zone(c, i, z)) continue;
        if (cnt[li] < gs_cap_fill(c, li, i, z, drv)) k = min(k, cnt[li] * c.n + c.erank[i]);
      }
      k = t.reduce(k, GsMin());
      const int node = k < GS_INF ? c.e_order[k % c.n] : 0;
      if (k < GS_INF && t.owns(node)) cnt[node - t.lo] += 1;
      if (t.leader && threadIdx.x == 0) ex[j] = node;
    }
  } else {  // GS_MINFRAG
    // Branch A: the smallest single node holding the whole gang, key
    // (capacity, rank) packed into 64 bits (both fit 32 unsigned bits).
    unsigned long long ka = GS_U64_NONE;
    GS_NODES(t, li, i) {
      const int cap = gs_cap_fill(c, li, i, z, drv);
      if (cap > 0 && cap >= count) {
        const unsigned long long key = gs_key(cap, c.erank[i]);
        ka = key < ka ? key : ka;
      }
    }
    ka = t.reduce(ka, GsMin());
    if (ka != GS_U64_NONE) {
      const int node = c.e_order[static_cast<int>(ka & 0xffffffffu)];
      if (t.leader)
        for (int s = threadIdx.x; s < count; s += kGsThreads) ex[s] = node;
      if (t.owns(node)) cnt[node - t.lo] = count;
      __syncthreads();
      return;
    }
    // Branch B: consume nodes in (clamped capacity desc, rank asc) order
    // while the running total stays <= count; a node is consumed iff its
    // count is non-zero. Key (0x7fffffff - capacity, rank).
    int placed = 0;
    for (int round = 0; round < c.emax; ++round) {
      unsigned long long kb = GS_U64_NONE;
      GS_NODES(t, li, i) {
        const int cap = gs_cap_fill(c, li, i, z, drv);
        if (cap > 0 && cnt[li] == 0) {
          const unsigned long long key = gs_key(0x7fffffff - min(cap, count), c.erank[i]);
          kb = key < kb ? key : kb;
        }
      }
      kb = t.reduce(kb, GsMin());
      if (kb == GS_U64_NONE) break;
      const int c_max = 0x7fffffff - static_cast<int>(kb >> 32);
      if (c_max <= 0 || placed + c_max > count) break;  // later rounds stop too
      const int node = c.e_order[static_cast<int>(kb & 0xffffffffu)];
      if (t.leader)
        for (int s = threadIdx.x; s < c_max; s += kGsThreads) ex[placed + s] = node;
      if (t.owns(node)) cnt[node - t.lo] = c_max;
      placed += c_max;
    }
    const int remainder = count - placed;
    if (remainder > 0) {
      // The remainder on the smallest unconsumed node fitting it.
      unsigned long long kf = GS_U64_NONE;
      GS_NODES(t, li, i) {
        const int cap = gs_cap_fill(c, li, i, z, drv);
        if (cap > 0 && cnt[li] == 0 && cap >= remainder) {
          const unsigned long long key = gs_key(cap, c.erank[i]);
          kf = key < kf ? key : kf;
        }
      }
      kf = t.reduce(kf, GsMin());
      const int node = kf == GS_U64_NONE ? -1 : c.e_order[static_cast<int>(kf & 0xffffffffu)];
      if (t.leader)
        for (int s = threadIdx.x; s < remainder; s += kGsThreads)
          ex[placed + s] = node < 0 ? 0 : node;
      if (node >= 0 && t.owns(node)) cnt[node - t.lo] += remainder;
    }
  }
  __syncthreads();  // the slots are visible to every thread on return
}

// Single-AZ zone score (make_gang_solver :347-375): mean over entries
// (driver + one per executor) of the per-node max dimension efficiency with
// the tentative reservation applied.
template <class Team>
__device__ float gs_zone_efficiency(Team& t, const GangCtx& c, int drv, const int* cnt,
                                    bool include_exec) {
  double part = 0.0;
  GS_NODES(t, li, i) {
    const int is_drv = i == drv ? 1 : 0;
    const int w = cnt[li] + is_drv;
    if (w == 0) continue;
    float eff[3];
    for (int d = 0; d < 3; ++d) {
      int new_res = is_drv * c.dreq[d];
      if (include_exec) new_res += cnt[li] * c.ereq[d];
      const int sched = c.sched[i * 3 + d];
      const int reserved = (sched - c.avail[d * t.slice + li]) + new_res;
      eff[d] = static_cast<float>(reserved) / static_cast<float>(max(sched, 1));
    }
    const float eff_gpu = c.sched[i * 3 + 2] != 0 ? eff[2] : 0.0f;
    const float node_max = fmaxf(eff_gpu, fmaxf(eff[0], eff[1]));
    const float prod = node_max * static_cast<float>(w);
    part += static_cast<double>(prod);
  }
  const double total = t.reduce(part, GsSum());
  return static_cast<float>(total) / static_cast<float>(c.count + 1);
}

// The whole per-gang solve (make_gang_solver), as the plain instantiation
// runs it. On return, *ok says whether the gang packs, *drv is its driver
// (or -1), *score is the chosen zone's score (0 where no zone was chosen),
// and *cnt_out / *ex_out point at the buffers holding the chosen placement
// (one of the two pairs given). zfirst/zhas hold, per zone, the smallest
// driver rank among its driver-eligible nodes and whether it has an
// executor-eligible node. The launchers send the single-AZ strategies to
// the zone-parallel instantiation (gs_gang_solve_lanes), so the plain one
// no longer takes the zone-by-zone branch; it is kept because the plain
// instantiation compiles to the code it had only with it: without it,
// ptxas allocated the plain kernel differently and queue-10k-w100's kernel
// measured 3-8% slower on an H100 (PERF.md).
template <class Team>
__device__ void gs_gang_solve(Team& t, const GangCtx& c, int fill, bool single_az,
                              bool az_fallback, bool include_exec, int num_zones,
                              const int* zfirst, const int* zhas,
                              int* cnt0, int* cnt1, int* ex0, int* ex1,
                              bool* ok, int* drv, float* score, int** cnt_out,
                              int** ex_out) {
  *score = 0.0f;
  if (!single_az) {
    const int d = gs_select_driver(t, c, -1);
    gs_run_fill(t, c, fill, -1, d, d >= 0, cnt0, ex0);
    *ok = d >= 0;
    *drv = d;
    *cnt_out = cnt0;
    *ex_out = ex0;
    return;
  }
  // Per-zone pack + strictly-greater efficiency pick, ties to the zone
  // appearing first in driver priority order (single_az.go:23-97). Every
  // block swaps its own buffers alike.
  int *cur_c = cnt0, *cur_e = ex0, *best_c = cnt1, *best_e = ex1;
  float best_eff = -1.0f;
  int best_first = GS_INF, best_drv = -1;
  bool any_valid = false;
  for (int z = 0; z < num_zones; ++z) {
    const int d = gs_select_driver(t, c, z);
    gs_run_fill(t, c, fill, z, d, d >= 0, cur_c, cur_e);
    const bool valid_z = d >= 0 && zfirst[z] < GS_INF && zhas[z] != 0;
    if (!valid_z) continue;
    any_valid = true;
    const float eff = gs_zone_efficiency(t, c, d, cur_c, include_exec);
    if (eff > best_eff || (eff == best_eff && zfirst[z] < best_first)) {
      best_eff = eff;
      best_first = zfirst[z];
      best_drv = d;
      int* tmp = cur_c; cur_c = best_c; best_c = tmp;
      tmp = cur_e; cur_e = best_e; best_e = tmp;
    }
  }
  // chooseBestResult replaces only on strictly greater than 0.0.
  if (any_valid && best_eff > 0.0f) {
    *ok = true;
    *drv = best_drv;
    *score = best_eff;
    *cnt_out = best_c;
    *ex_out = best_e;
    return;
  }
  *ok = false;
  *drv = -1;
  *cnt_out = cur_c;
  *ex_out = cur_e;
  if (az_fallback) {
    // az-aware: plain pack when no single zone fits
    // (az_aware_pack_tightly.go:27-38).
    const int d = gs_select_driver(t, c, -1);
    gs_run_fill(t, c, fill, -1, d, d >= 0, cur_c, cur_e);
    *ok = d >= 0;
    *drv = d;
  }
}

// The strategy as the kernels receive it (ops/gang.py strategy_params).
struct GsStrategy {
  int fill, single_az, az_fallback, include_exec, num_zones;
};

// A team's workspace: the node state, 8 slice int32 words (global or
// shared memory), and the gang's slots and zone facts, 2 emax + 2 num_zones
// words of global memory (ex0/ex1 are used by the leader block only), then
// for the zone-parallel instantiations min(num_zones, kGsLanes) x emax lane
// slots (leader block only).
struct GsWork {
  int* avail;   // [3][slice] availability, dimension-major
  int* cap_e;   // [slice]
  int* cap_wd;  // [slice]
  int* fit_d;   // [slice]
  int* cnt0;    // [slice]
  int* cnt1;    // [slice]
  int* ex0;     // [emax]
  int* ex1;     // [emax]
  int* zfirst;  // [num_zones]
  int* zhas;    // [num_zones]
  int* exl;     // [min(num_zones, kGsLanes)][emax], zone-parallel only
};

// Global words a block's gang slots and zone facts take (the layout of
// ops/launch.py gang_scratch_words).
__host__ __device__ __forceinline__ int gs_extra_words(int emax, int num_zones, bool lanes) {
  const int nl = num_zones < kGsLanes ? num_zones : kGsLanes;
  return 2 * emax + 2 * num_zones + (lanes ? nl * emax : 0);
}

__device__ __forceinline__ GsWork gs_carve(int* state, int slice, int* extra, int emax,
                                           int num_zones) {
  GsWork w;
  w.avail = state;
  w.cap_e = w.avail + 3 * slice;
  w.cap_wd = w.cap_e + slice;
  w.fit_d = w.cap_wd + slice;
  w.cnt0 = w.fit_d + slice;
  w.cnt1 = w.cnt0 + slice;
  w.ex0 = extra;
  w.ex1 = w.ex0 + emax;
  w.zfirst = w.ex1 + emax;
  w.zhas = w.zfirst + num_zones;
  w.exl = w.zhas + num_zones;
  return w;
}

// Tightly-pack (gs_run_fill's rounds) in every zone of a chunk at once,
// one lane a zone. `capf` is each node's capacity in its own zone with that
// zone's driver reserved, 0 outside the chunk's zones with a driver, so a
// node keys only its own lane. The key is 32 bits, rank * (emax + 1) +
// min(room, count): ranks are unique, so it orders by rank alone, the
// winner's node is e_order[rank], and its take is the key's remainder
// clamped to the lane's slots left. Thread (lane index) l keeps lane l's
// slots placed, `jl`; lanes without a driver (bit l of `act` clear) are
// closed from the start, and rounds run until every lane is full. Zone
// lane l's slots go to exl[l * emax ...].
template <class Team>
__device__ __forceinline__ void gs_lanes_tightly(Team& t, const GangCtx& c, unsigned act,
                                                 int z0, int nl, const int* capf, int* cnt,
                                                 int* exl) {
  const int count = c.count, emax = c.emax, lx = threadIdx.x & 31;
  const unsigned span = static_cast<unsigned>(emax) + 1u;
  int jl = lx < kGsLanes && ((act >> lx) & 1u) ? 0 : count;
  while (__ballot_sync(0xffffffffu, jl < count) != 0) {
    GS_NODES(t, li, i) {
      const int room = capf[li] - cnt[li];
      if (room > 0)
        gs_acc_min(t.acc(), c.zone[i] - z0,
                   static_cast<unsigned>(c.erank[i]) * span + min(room, count));
    }
    const unsigned key = ~t.template fold_lanes<unsigned>(GsMax());
    int node = -1, take = 0;  // no open node: the rest read node 0
    if (jl < count) {
      take = count - jl;
      if (key != 0xffffffffu) {
        node = c.e_order[key / span];
        take = min(static_cast<int>(key % span), take);
      }
    }
    for (int l = 0; l < nl; ++l) {
      const int nd = gs_lane(node, l), tk = gs_lane(take, l), j = gs_lane(jl, l);
      if (tk == 0) continue;
      if (nd >= 0 && t.owns(nd)) cnt[nd - t.lo] += tk;
      if (t.leader)
        for (int s = threadIdx.x; s < tk; s += kGsThreads) exl[l * emax + j + s] = max(nd, 0);
    }
    jl += take;
  }
}

// Minimal-fragmentation (gs_run_fill's branches) in every zone of a chunk
// at once, as gs_lanes_tightly does: branch A in one lane reduction; the
// zones it did not settle consume nodes in branch B rounds, each lane
// stopping where its zone's loop breaks; then one reduction places every
// zone's remainder. Thread (lane index) l keeps lane l's state.
template <class Team>
__device__ __forceinline__ void gs_lanes_minfrag(Team& t, const GangCtx& c, unsigned act,
                                                 int z0, int nl, const int* capf, int* cnt,
                                                 int* exl) {
  const int count = c.count, emax = c.emax, lx = threadIdx.x & 31;
  const bool mine = lx < kGsLanes && ((act >> lx) & 1u);
  GS_NODES(t, li, i) {
    const int cap = capf[li];
    if (cap > 0 && cap >= count) gs_acc_min(t.acc(), c.zone[i] - z0, gs_key(cap, c.erank[i]));
  }
  unsigned long long key = ~t.template fold_lanes<unsigned long long>(GsMax());
  int node = -1;
  bool live = false;  // this thread's lane is in branch B
  if (mine) {
    if (key != GS_U64_NONE)
      node = c.e_order[static_cast<int>(key & 0xffffffffu)];
    else
      live = true;
  }
  for (int l = 0; l < nl; ++l) {
    const int nd = gs_lane(node, l);
    if (nd < 0) continue;
    if (t.leader)
      for (int s = threadIdx.x; s < count; s += kGsThreads) exl[l * emax + s] = nd;
    if (t.owns(nd)) cnt[nd - t.lo] = count;
  }
  const bool branch_b = live;
  int placed = 0;
  for (int round = 0; round < emax && __ballot_sync(0xffffffffu, live) != 0; ++round) {
    GS_NODES(t, li, i) {
      const int cap = capf[li];
      if (cap > 0 && cnt[li] == 0)
        gs_acc_min(t.acc(), c.zone[i] - z0,
                   gs_key(0x7fffffff - min(cap, count), c.erank[i]));
    }
    key = ~t.template fold_lanes<unsigned long long>(GsMax());
    int c_max = 0;
    node = -1;
    if (live) {
      c_max = key == GS_U64_NONE ? 0 : 0x7fffffff - static_cast<int>(key >> 32);
      if (c_max <= 0 || placed + c_max > count) {
        live = false;  // later rounds stop too
        c_max = 0;
      } else {
        node = c.e_order[static_cast<int>(key & 0xffffffffu)];
      }
    }
    for (int l = 0; l < nl; ++l) {
      const int nd = gs_lane(node, l), cm = gs_lane(c_max, l), p = gs_lane(placed, l);
      if (nd < 0) continue;
      if (t.leader)
        for (int s = threadIdx.x; s < cm; s += kGsThreads) exl[l * emax + p + s] = nd;
      if (t.owns(nd)) cnt[nd - t.lo] = cm;
    }
    placed += c_max;
  }
  const int rem = branch_b ? count - placed : 0;
  if (__ballot_sync(0xffffffffu, rem > 0) == 0) return;
  // The remainder on the smallest unconsumed node of the zone fitting it.
  if (threadIdx.x < kGsLanes) t.ln.zaux[threadIdx.x] = rem;
  __syncthreads();
  GS_NODES(t, li, i) {
    const int cap = capf[li];
    if (cap <= 0 || cnt[li] != 0) continue;  // capf > 0: a lane of the chunk
    const int lz = c.zone[i] - z0;
    const int r = t.ln.zaux[lz];
    if (r > 0 && cap >= r) gs_acc_min(t.acc(), lz, gs_key(cap, c.erank[i]));
  }
  key = ~t.template fold_lanes<unsigned long long>(GsMax());
  node = rem > 0 && key != GS_U64_NONE ? c.e_order[static_cast<int>(key & 0xffffffffu)] : -1;
  for (int l = 0; l < nl; ++l) {
    const int r = gs_lane(rem, l), nd = gs_lane(node, l), p = gs_lane(placed, l);
    if (r <= 0) continue;
    if (t.leader)
      for (int s = threadIdx.x; s < r; s += kGsThreads) exl[l * emax + p + s] = max(nd, 0);
    if (nd >= 0 && t.owns(nd)) cnt[nd - t.lo] += r;
  }
}

// Whether zone lane `lz` lies outside the chunk's nl lanes (a node of an
// earlier or later chunk, or of no zone in [0, num_zones)).
__device__ __forceinline__ bool gs_lane_out(int lz, int nl) {
  return static_cast<unsigned>(lz) >= static_cast<unsigned>(nl);
}

// The single-AZ gang solve (make_gang_solver :347-375, single_az.go:23-97)
// with every zone of a chunk of kGsLanes solved at once: per chunk, the
// driver selection (2 lane reductions), the fill into one count buffer
// (w.cnt0: the zones are disjoint, so no zone's counts touch another's and
// nothing is copied between chunks), the zone scores (1 lane reduction),
// then the pick in zone order: strictly greater score, ties to the zone
// appearing first in driver priority order, and a best of 0.0 rejects.
// w.cnt1 holds the nodes' capacities in their zones, then their score
// terms; thread (lane index) l holds lane l's score, and the team's lane
// buffers the chunk's drivers and, between chunks, the best zone so far
// (so no register holds it across a chunk). The chosen zone's slots stay
// in its lane, or go to w.ex0 where a later chunk reuses the lanes. On
// return *zone is the chosen zone (only its nodes' counts are the
// placement), or -1.
template <class Team>
__device__ void gs_gang_solve_lanes(Team& t, const GangCtx& c, const GsStrategy& s,
                                    const GsWork& w, bool* ok, int* drv, float* score,
                                    int* zone, int** cnt_out, int** ex_out) {
  const int count = c.count, emax = c.emax, nz = s.num_zones, lx = threadIdx.x & 31;
  int* const cnt = w.cnt0;
  int* const capf = w.cnt1;
  GS_NODES(t, li, i) { cnt[li] = 0; }
  const int z_last = (nz - 1) / kGsLanes * kGsLanes;  // the last chunk's first zone
  for (int z0 = 0;; z0 += kGsLanes) {
    const int nl = min(kGsLanes, nz - z0);
    // Driver selection (gs_select_driver), one lane a zone.
    GS_NODES(t, li, i) {
      const int lz = c.zone[i] - z0;
      if (!gs_lane_out(lz, nl)) gs_acc_add(t.acc(), lz, min(c.cap_e[li], count));
    }
    t.template fold_lanes<int>(GsSum());
    GS_NODES(t, li, i) {
      const int lz = c.zone[i] - z0;
      if (gs_lane_out(lz, nl) || !c.elig_d[i] || !c.fit_d[li]) continue;
      const int total_if = t.template lane_fold<int>(lz, GsSum()) - min(c.cap_e[li], count) +
                           min(c.cap_wd[li], count);
      if (total_if >= count) gs_acc_min(t.acc(), lz, static_cast<unsigned>(c.drank[i]));
    }
    const unsigned rank = ~t.template fold_lanes<unsigned>(GsMax());
    const int dl = lx < nl && rank != 0xffffffffu ? c.d_order[rank] : -1;
    const unsigned act = __ballot_sync(0xffffffffu, dl >= 0);  // bit l: lane l has a driver
    // Read after the fill's barriers.
    if (threadIdx.x < kGsLanes) t.ln.zdrv[threadIdx.x] = dl;
    GS_NODES(t, li, i) {
      const int lz = c.zone[i] - z0;
      const unsigned r = gs_lane_out(lz, nl) ? 0xffffffffu
                                             : ~t.template lane_fold<unsigned>(lz, GsMax());
      capf[li] = r == 0xffffffffu ? 0 : gs_cap_fill(c, li, i, -1, c.d_order[r]);
    }
    // The lane slots; the fill's first write follows a reduction's barrier.
    if (t.leader)
      for (int j = threadIdx.x; j < nl * emax; j += kGsThreads) w.exl[j] = -1;
    if (s.fill == GS_TIGHTLY)
      gs_lanes_tightly(t, c, act, z0, nl, capf, cnt, w.exl);
    else
      gs_lanes_minfrag(t, c, act, z0, nl, capf, cnt, w.exl);
    __syncthreads();  // the slots and zone drivers are visible to every thread
    // Zone scores: each node's term (its largest dimension efficiency with
    // the tentative reservation applied, times its entries) into capf,
    // then per lane each thread's terms, each warp's, and the block's.
    GS_NODES(t, li, i) {
      const int lz = c.zone[i] - z0;
      float term = 0.0f;
      if (!gs_lane_out(lz, nl)) {
        const int is_drv = i == t.ln.zdrv[lz] ? 1 : 0;
        const int wt = cnt[li] + is_drv;
        if (wt != 0) {
          float eff[3];
          for (int dim = 0; dim < 3; ++dim) {
            int new_res = is_drv * c.dreq[dim];
            if (s.include_exec) new_res += cnt[li] * c.ereq[dim];
            const int sched = c.sched[i * 3 + dim];
            const int reserved = (sched - c.avail[dim * t.slice + li]) + new_res;
            eff[dim] = static_cast<float>(reserved) / static_cast<float>(max(sched, 1));
          }
          const float eff_gpu = c.sched[i * 3 + 2] != 0 ? eff[2] : 0.0f;
          term = fmaxf(eff_gpu, fmaxf(eff[0], eff[1])) * static_cast<float>(wt);
        }
      }
      capf[li] = __float_as_int(term);
    }
    for (int l = 0; l < nl; ++l) {
      double x = 0.0;
      GS_NODES(t, li, i) {
        if (c.zone[i] - z0 == l) x += static_cast<double>(__int_as_float(capf[li]));
      }
      x = gs_warp_reduce(x, GsSum());
      if (lx == 0) t.ln.part[l * kGsLaneStride + (threadIdx.x >> 5)] = x;
    }
    const double sum = t.fold_lane_sums(nl);
    // The pick, zones in order (the loop the zone-by-zone solve had).
    int zf = GS_INF, dz = -1;
    bool valid = false;
    if (lx < nl) {
      dz = t.ln.zdrv[lx];
      zf = w.zfirst[z0 + lx];
      valid = dz >= 0 && zf < GS_INF && w.zhas[z0 + lx] != 0;
    }
    const float eff_l = static_cast<float>(sum) / static_cast<float>(count + 1);
    float best_eff = -1.0f;
    int best_first = GS_INF, best_drv = -1, best_zone = -1;
    if (z0 > 0) {  // the best of the earlier chunks, as thread 0 left it
      best_eff = __int_as_float(t.ln.best[0]);
      best_first = t.ln.best[1];
      best_drv = t.ln.best[2];
      best_zone = t.ln.best[3];
    }
    int best_lane = -1;
    for (int l = 0; l < nl; ++l) {
      const bool v = gs_lane(valid ? 1 : 0, l) != 0;
      const float eff = gs_lane(eff_l, l);
      const int f = gs_lane(zf, l);
      if (v && (eff > best_eff || (eff == best_eff && f < best_first))) {
        best_eff = eff;
        best_first = f;
        best_zone = z0 + l;
        best_lane = l;
      }
    }
    if (best_lane >= 0) best_drv = t.ln.zdrv[best_lane];
    if (z0 < z_last) {  // a later chunk refills the lanes: keep the best's slots
      if (best_lane >= 0 && t.leader)
        for (int j = threadIdx.x; j < emax; j += kGsThreads)
          w.ex0[j] = w.exl[best_lane * emax + j];
      if (threadIdx.x == 0) {
        t.ln.best[0] = __float_as_int(best_eff);
        t.ln.best[1] = best_first;
        t.ln.best[2] = best_drv;
        t.ln.best[3] = best_zone;
      }
      continue;
    }
    *score = 0.0f;
    *zone = -1;
    *cnt_out = cnt;
    // chooseBestResult replaces only on strictly greater than 0.0 (a best
    // of -1 means no zone was valid).
    if (best_eff > 0.0f) {
      *ok = true;
      *drv = best_drv;
      *score = best_eff;
      *zone = best_zone;
      *ex_out = best_lane >= 0 ? w.exl + best_lane * emax : w.ex0;
      return;
    }
    *ok = false;
    *drv = -1;
    *ex_out = w.ex0;
    if (s.az_fallback) {
      // az-aware: plain pack when no single zone fits
      // (az_aware_pack_tightly.go:27-38). az-aware-tightly-pack is the one
      // strategy with a fallback (ops/gang.py PALLAS_SINGLE_AZ), so the
      // fill is tightly-pack.
      const int d = gs_select_driver(t, c, -1);
      gs_run_fill(t, c, GS_TIGHTLY, -1, d, d >= 0, w.cnt1, w.ex1);
      *ok = d >= 0;
      *drv = d;
      *cnt_out = w.cnt1;
      *ex_out = w.ex1;
    }
    return;
  }
}

// Availability-independent zone facts, once per set of orders (single-AZ
// strategies only): per zone, the smallest driver rank among its
// driver-eligible nodes and whether it has an executor-eligible node; in
// the zone-parallel instantiation two lane reductions a chunk of kGsLanes
// zones, in the plain one (which keeps the zone-by-zone solve) two
// reductions a zone. Every block keeps its own copy. Ends with a barrier.
template <bool kLanes, class Team>
__device__ void gs_zone_facts(Team& t, const GangCtx& c, const GsStrategy& s, const GsWork& w) {
  if constexpr (kLanes) {
    for (int z0 = 0; z0 < s.num_zones; z0 += kGsLanes) {
      const int nl = min(kGsLanes, s.num_zones - z0);
      GS_NODES(t, li, i) {
        const int lz = c.zone[i] - z0;
        if (!gs_lane_out(lz, nl) && c.elig_d[i])
          gs_acc_min(t.acc(), lz, static_cast<unsigned>(c.drank[i]));
      }
      const unsigned first = ~t.template fold_lanes<unsigned>(GsMax());
      GS_NODES(t, li, i) {
        const int lz = c.zone[i] - z0;
        if (!gs_lane_out(lz, nl) && c.elig_e[i]) gs_acc_add(t.acc(), lz, 1);
      }
      const int has = t.template fold_lanes<int>(GsSum());
      for (int l = 0; l < nl; ++l) {
        const unsigned f = gs_lane(first, l);
        const int h = gs_lane(has, l);
        if (threadIdx.x == 0) {
          w.zfirst[z0 + l] = f == 0xffffffffu ? GS_INF : static_cast<int>(f);
          w.zhas[z0 + l] = h > 0 ? 1 : 0;
        }
      }
    }
  } else if (s.single_az) {
    for (int z = 0; z < s.num_zones; ++z) {
      int first = GS_INF, has = 0;
      GS_NODES(t, li, i) {
        if (c.zone[i] != z) continue;
        if (c.elig_d[i]) first = min(first, c.drank[i]);
        if (c.elig_e[i]) has = 1;
      }
      first = t.reduce(first, GsMin());
      has = t.reduce(has, GsMax());
      if (threadIdx.x == 0) {
        w.zfirst[z] = first;
        w.zhas[z] = has;
      }
    }
  }
  __syncthreads();
}

// A padding row: nothing packs, nothing is debited, nothing blocks.
template <class Team>
__device__ __forceinline__ void gs_empty_row(const Team& t, int* meta, int* execs, int emax) {
  if (!t.leader) return;
  if (threadIdx.x == 0) {
    meta[0] = -1;
    meta[1] = 0;
    meta[2] = 0;
    meta[3] = 0;
  }
  for (int j = threadIdx.x; j < emax; j += kGsThreads) execs[j] = -1;
}

// One valid FIFO row (pallas_fifo.py:475-553): node capacities from the
// carried availability, the gang solve, `packed = ok && !too_big`,
// `admitted = packed && !blocked`, the admitted gang debited from
// w.avail (and from `commit_base` [n][3] too when it is not null), the
// meta row (driver, admitted, packed, 0) and executor slots written by the
// leader block, and strict-FIFO blocking: a non-skippable failure blocks
// the later rows (resource.go:241-249). With `with_score`, meta[3] holds
// the float32 bits of the chosen zone's score when the row packed (else
// 0); without it, 0. Ends with a barrier.
template <bool kLanes, class Team>
__device__ void gs_fifo_row(Team& t, GangCtx& c, const GsStrategy& s, const GsWork& w,
                            const int* dreq, const int* ereq, int raw, bool skip,
                            bool* blocked, int* commit_base, int* meta, int* execs,
                            bool with_score) {
  const int sl = t.slice;
  const bool too_big = raw > c.emax;
  c.count = min(raw, c.emax);
  for (int d = 0; d < 3; ++d) {
    c.dreq[d] = dreq[d];
    c.ereq[d] = ereq[d];
  }
  // Node capacities (ops/capacity.py): per dim 0 if the reservation
  // exceeds availability, INF if the request is 0, else the floor of a
  // non-negative quotient; min over dims, never negative.
  GS_NODES(t, li, i) {
    int ce = GS_INF, cw = GS_INF, fd = 1;
    for (int d = 0; d < 3; ++d) {
      const int a = w.avail[d * sl + li];
      const int er = c.ereq[d], dr = c.dreq[d];
      const int safe = max(er, 1);
      const int pe = 0 > a ? 0 : (er == 0 ? GS_INF : a / safe);
      const int pw = dr > a ? 0 : (er == 0 ? GS_INF : (a - dr) / safe);
      ce = min(ce, pe);
      cw = min(cw, pw);
      fd &= dr <= a ? 1 : 0;
    }
    const bool e = c.elig_e[i] != 0;
    w.cap_e[li] = e ? max(ce, 0) : 0;
    w.cap_wd[li] = e ? max(cw, 0) : 0;
    w.fit_d[li] = fd;
  }

  bool ok;
  int drv, zone = -1;
  float score;
  int *cnt, *ex;
  if constexpr (kLanes)
    gs_gang_solve_lanes(t, c, s, w, &ok, &drv, &score, &zone, &cnt, &ex);
  else
    gs_gang_solve(t, c, s.fill, s.single_az != 0, s.az_fallback != 0, s.include_exec != 0,
                  s.num_zones, w.zfirst, w.zhas, w.cnt0, w.cnt1, w.ex0, w.ex1, &ok, &drv,
                  &score, &cnt, &ex);
  const bool packed = ok && !too_big;
  const bool admitted = packed && !*blocked;
  if (admitted) {
    GS_NODES(t, li, i) {
      if constexpr (kLanes) {
        if (zone >= 0 && c.zone[i] != zone) continue;  // another zone's tentative counts
      }
      const int k = cnt[li];
      const int is_drv = i == drv ? 1 : 0;
      if (k == 0 && !is_drv) continue;
      for (int d = 0; d < 3; ++d) {
        const int delta = k * c.ereq[d] + is_drv * c.dreq[d];
        w.avail[d * sl + li] -= delta;
        if (commit_base) commit_base[i * 3 + d] -= delta;
      }
    }
  }
  if (t.leader) {
    if (threadIdx.x == 0) {
      meta[0] = admitted ? drv : -1;
      meta[1] = admitted ? 1 : 0;
      meta[2] = packed ? 1 : 0;
      meta[3] = with_score && packed ? __float_as_int(score) : 0;
    }
    for (int j = threadIdx.x; j < c.emax; j += kGsThreads) execs[j] = admitted ? ex[j] : -1;
  }
  *blocked = *blocked || (!packed && !skip);
  __syncthreads();
}
