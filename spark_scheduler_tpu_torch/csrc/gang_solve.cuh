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

  template <typename T, typename Op>
  __device__ __forceinline__ T reduce(T v, Op op) {
    static_assert(sizeof(T) <= 8, "a partial fits one 8-byte slot");
    T* buf = reinterpret_cast<T*>(red + 32 * parity);
    parity ^= 1;
    return gs_block_reduce<T>(v, op, buf);
  }
  __device__ __forceinline__ bool owns(int node) const {
    return node < count && (node & (kGsThreads - 1)) == static_cast<int>(threadIdx.x);
  }
};

// Blocks in a cluster team: the largest portable cluster. (16, the
// non-portable size, measured no faster for the row walk on an H100:
// PERF.md.)
constexpr int kGsCluster = 8;

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

__device__ __forceinline__ unsigned long long gs_key(unsigned hi, unsigned lo) {
  return (static_cast<unsigned long long>(hi) << 32) | lo;
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

// The whole per-gang solve (make_gang_solver). On return, *ok says whether
// the gang packs, *drv is its driver (or -1), and *cnt_out / *ex_out point
// at the buffers holding the chosen placement (one of the two pairs given).
// zfirst/zhas hold, per zone, the smallest driver rank among its
// driver-eligible nodes and whether it has an executor-eligible node.
template <class Team>
__device__ void gs_gang_solve(Team& t, const GangCtx& c, int fill, bool single_az,
                              bool az_fallback, bool include_exec, int num_zones,
                              const int* zfirst, const int* zhas,
                              int* cnt0, int* cnt1, int* ex0, int* ex1,
                              bool* ok, int* drv, int** cnt_out, int** ex_out) {
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
// words of global memory (ex0/ex1 are used by the leader block only).
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
};

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
  return w;
}

// Availability-independent zone facts, once per set of orders (single-AZ
// strategies only): per zone, the smallest driver rank among its
// driver-eligible nodes and whether it has an executor-eligible node. Every
// block keeps its own copy. Ends with a barrier.
template <class Team>
__device__ void gs_zone_facts(Team& t, const GangCtx& c, const GsStrategy& s, const GsWork& w) {
  if (s.single_az) {
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
// the later rows (resource.go:241-249). Ends with a barrier.
template <class Team>
__device__ void gs_fifo_row(Team& t, GangCtx& c, const GsStrategy& s, const GsWork& w,
                            const int* dreq, const int* ereq, int raw, bool skip,
                            bool* blocked, int* commit_base, int* meta, int* execs) {
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
  int drv;
  int *cnt, *ex;
  gs_gang_solve(t, c, s.fill, s.single_az != 0, s.az_fallback != 0, s.include_exec != 0,
                s.num_zones, w.zfirst, w.zhas, w.cnt0, w.cnt1, w.ex0, w.ex1, &ok, &drv,
                &cnt, &ex);
  const bool packed = ok && !too_big;
  const bool admitted = packed && !*blocked;
  if (admitted) {
    GS_NODES(t, li, i) {
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
      meta[3] = 0;
    }
    for (int j = threadIdx.x; j < c.emax; j += kGsThreads) execs[j] = admitted ? ex[j] : -1;
  }
  *blocked = *blocked || (!packed && !skip);
  __syncthreads();
}
