// Per-gang solve as CUDA device functions for one thread block.
//
// Replaces the gang math the JAX package shares between its two Mosaic
// kernels: spark_scheduler_tpu/ops/pallas_fifo.py `make_driver_selector`,
// `make_fill_runner` and `make_gang_solver` (:119-410). Both CUDA kernels,
// the segmented-window row walk (window_kernel.cu) and the queue-mode FIFO
// admission (fifo_kernel.cu), include this header and walk their rows with
// the same `gs_fifo_row`, so the two cannot drift. The plain PyTorch version
// of the same math is spark_scheduler_tpu_torch/ops/gang.py.
//
// Every function is called by ALL threads of the block with the same
// arguments and returns the same (uniform) values in every thread. Per-node
// vectors live in global memory (L2-resident at these sizes); every vector
// operation is a block-strided loop, and every "first node in priority order
// among a mask" is a block min-reduction over the node's priority RANK: the
// ranks are permutations of 0..n-1, so the minimum is unique and its node is
// order[rank] (no second reduction for the position).
//
// Single-AZ zone scores: the weighted efficiency sum is accumulated in
// double over the float32 per-node products and rounded once to float, so
// the block's reduction order does not change it; ops/gang.py computes it
// the same way. The JAX package sums in float32 in tile order instead: a
// cross-zone tie closer than about 1 ulp may break differently there (the
// deviation ops/pallas_fifo.py:49-56 documents between its own two paths).
#pragma once

#include <cstdint>

#define GS_INF 2147483646  // INT32_INF = 2**31 - 2, the int32 sentinel
#define GS_U64_NONE 0xffffffffffffffffull

enum GsFill { GS_TIGHTLY = 0, GS_DISTRIBUTE = 1, GS_MINFRAG = 2 };

// Block-wide reduction; every thread gets the result. `red` is a 32-entry
// shared buffer. The leading barrier keeps a previous reduction's readers
// from seeing this one's partials. blockDim.x must be a multiple of 32.
template <typename T, typename Op>
__device__ __forceinline__ T gs_block_reduce(T v, Op op, T* red) {
  for (int o = 16; o > 0; o >>= 1) v = op(v, __shfl_xor_sync(0xffffffffu, v, o));
  __syncthreads();
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  T r = red[0];
  const int nw = blockDim.x >> 5;
  for (int w = 1; w < nw; ++w) r = op(r, red[w]);
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

// Per-row inputs of the gang solve (all pointers global memory).
struct GangCtx {
  int n, emax, count;
  const int* avail;   // [3][n] availability at this row (dimension-major)
  const int* sched;   // [n][3] schedulable
  const int* cap_e;   // [n] executor capacity, no driver reserved
  const int* cap_wd;  // [n] executor capacity with the driver reserved
  const int* fit_d;   // [n] driver fits
  const unsigned char* elig_e;
  const unsigned char* elig_d;
  const int* zone;
  const int* drank;
  const int* d_order;
  const int* erank;
  const int* e_order;
  int dreq[3], ereq[3];
  unsigned long long* red;  // shared reduction buffer (32 entries)
};

__device__ __forceinline__ bool gs_in_zone(const GangCtx& c, int i, int z) {
  return z < 0 || c.zone[i] == z;
}

// Executor capacity of node i inside zone z with driver `drv` reserved.
__device__ __forceinline__ int gs_cap_fill(const GangCtx& c, int i, int z, int drv) {
  if (!gs_in_zone(c, i, z)) return 0;
  return i == drv ? c.cap_wd[i] : c.cap_e[i];
}

__device__ __forceinline__ int gs_min_red(const GangCtx& c, int v) {
  return gs_block_reduce<int>(v, GsMin(), reinterpret_cast<int*>(c.red));
}
__device__ __forceinline__ unsigned long long gs_min_red64(const GangCtx& c,
                                                           unsigned long long v) {
  return gs_block_reduce<unsigned long long>(v, GsMin(), c.red);
}

// Driver selection by the feasibility identity (make_driver_selector):
// reserving the driver on node i only changes node i's executor capacity.
// z < 0 means every node. Returns the driver node, or -1.
__device__ int gs_select_driver(const GangCtx& c, int z) {
  const int count = c.count;
  int part = 0;
  for (int i = threadIdx.x; i < c.n; i += blockDim.x)
    if (gs_in_zone(c, i, z)) part += min(c.cap_e[i], count);
  const int total = gs_block_reduce<int>(part, GsSum(), reinterpret_cast<int*>(c.red));
  int best = GS_INF;
  for (int i = threadIdx.x; i < c.n; i += blockDim.x) {
    if (!gs_in_zone(c, i, z) || !c.elig_d[i] || !c.fit_d[i]) continue;
    const int total_if = total - min(c.cap_e[i], count) + min(c.cap_wd[i], count);
    if (total_if >= count) best = min(best, c.drank[i]);
  }
  best = gs_min_red(c, best);
  return best < GS_INF ? c.d_order[best] : -1;
}

// Executor fill (make_fill_runner). `cnt` [n] receives executors per node,
// `ex` [emax] the node of each slot (-1 past count). ok = a driver was found.
__device__ void gs_run_fill(const GangCtx& c, int fill, int z, int drv, bool ok,
                            int* cnt, int* ex) {
  const int count = c.count;
  for (int i = threadIdx.x; i < c.n; i += blockDim.x) cnt[i] = 0;
  for (int j = threadIdx.x; j < c.emax; j += blockDim.x) ex[j] = -1;
  __syncthreads();
  if (!ok) return;
  __shared__ int s_node, s_take;
  if (fill == GS_TIGHTLY) {
    // Every slot goes to the open node of smallest executor rank; that node
    // keeps winning until its capacity is spent, so one round places
    // min(remaining, slots left) slots.
    int j = 0;
    while (j < count) {
      int k = GS_INF;
      for (int i = threadIdx.x; i < c.n; i += blockDim.x)
        if (cnt[i] < gs_cap_fill(c, i, z, drv)) k = min(k, c.erank[i]);
      k = gs_min_red(c, k);
      if (threadIdx.x == 0) {
        if (k < GS_INF) {
          const int node = c.e_order[k];
          const int take = min(gs_cap_fill(c, node, z, drv) - cnt[node], count - j);
          cnt[node] += take;
          s_node = node;
          s_take = take;
        } else {  // no open node: the remaining slots read node 0
          s_node = 0;
          s_take = count - j;
        }
      }
      __syncthreads();
      const int node = s_node, take = s_take;
      for (int t = threadIdx.x; t < take; t += blockDim.x) ex[j + t] = node;
      j += take;
    }
  } else if (fill == GS_DISTRIBUTE) {
    // Key placed * n + rank: lexicographic (placed, rank). The wrapper
    // guarantees n * emax < 2^31, so the key stays below GS_INF.
    for (int j = 0; j < count; ++j) {
      int k = GS_INF;
      for (int i = threadIdx.x; i < c.n; i += blockDim.x) {
        if (!c.elig_e[i] || !gs_in_zone(c, i, z)) continue;
        if (cnt[i] < gs_cap_fill(c, i, z, drv)) k = min(k, cnt[i] * c.n + c.erank[i]);
      }
      k = gs_min_red(c, k);
      if (threadIdx.x == 0) {
        if (k < GS_INF) {
          const int node = c.e_order[k % c.n];
          cnt[node] += 1;
          ex[j] = node;
        } else {
          ex[j] = 0;
        }
      }
      __syncthreads();
    }
  } else {  // GS_MINFRAG
    // Branch A: the smallest single node holding the whole gang, key
    // (capacity, rank) packed into 64 bits (both fit 32 unsigned bits).
    unsigned long long ka = GS_U64_NONE;
    for (int i = threadIdx.x; i < c.n; i += blockDim.x) {
      const int cap = gs_cap_fill(c, i, z, drv);
      if (cap > 0 && cap >= count) {
        const unsigned long long key =
            (static_cast<unsigned long long>(cap) << 32) | static_cast<unsigned>(c.erank[i]);
        ka = key < ka ? key : ka;
      }
    }
    ka = gs_min_red64(c, ka);
    if (ka != GS_U64_NONE) {
      const int node = c.e_order[static_cast<int>(ka & 0xffffffffu)];
      for (int t = threadIdx.x; t < count; t += blockDim.x) ex[t] = node;
      if (threadIdx.x == 0) cnt[node] = count;
      __syncthreads();
      return;
    }
    // Branch B: consume nodes in (clamped capacity desc, rank asc) order
    // while the running total stays <= count; a node is consumed iff its
    // count is non-zero. Key (0x7fffffff - capacity, rank).
    int placed = 0;
    for (int round = 0; round < c.emax; ++round) {
      unsigned long long kb = GS_U64_NONE;
      for (int i = threadIdx.x; i < c.n; i += blockDim.x) {
        const int cap = gs_cap_fill(c, i, z, drv);
        if (cap > 0 && cnt[i] == 0) {
          const unsigned long long key =
              (static_cast<unsigned long long>(0x7fffffff - min(cap, count)) << 32) |
              static_cast<unsigned>(c.erank[i]);
          kb = key < kb ? key : kb;
        }
      }
      kb = gs_min_red64(c, kb);
      if (kb == GS_U64_NONE) break;
      const int c_max = 0x7fffffff - static_cast<int>(kb >> 32);
      if (c_max <= 0 || placed + c_max > count) break;  // later rounds stop too
      const int node = c.e_order[static_cast<int>(kb & 0xffffffffu)];
      for (int t = threadIdx.x; t < c_max; t += blockDim.x) ex[placed + t] = node;
      if (threadIdx.x == 0) cnt[node] = c_max;
      __syncthreads();
      placed += c_max;
    }
    const int remainder = count - placed;
    if (remainder > 0) {
      // The remainder on the smallest unconsumed node fitting it.
      unsigned long long kf = GS_U64_NONE;
      for (int i = threadIdx.x; i < c.n; i += blockDim.x) {
        const int cap = gs_cap_fill(c, i, z, drv);
        if (cap > 0 && cnt[i] == 0 && cap >= remainder) {
          const unsigned long long key =
              (static_cast<unsigned long long>(cap) << 32) | static_cast<unsigned>(c.erank[i]);
          kf = key < kf ? key : kf;
        }
      }
      kf = gs_min_red64(c, kf);
      const int node = kf == GS_U64_NONE ? -1 : c.e_order[static_cast<int>(kf & 0xffffffffu)];
      for (int t = threadIdx.x; t < remainder; t += blockDim.x)
        ex[placed + t] = node < 0 ? 0 : node;
      if (threadIdx.x == 0 && node >= 0) cnt[node] += remainder;
    }
  }
  __syncthreads();  // the placement is visible to every thread on return
}

// Single-AZ zone score (make_gang_solver :347-375): mean over entries
// (driver + one per executor) of the per-node max dimension efficiency with
// the tentative reservation applied.
__device__ float gs_zone_efficiency(const GangCtx& c, int drv, const int* cnt,
                                    bool include_exec) {
  double part = 0.0;
  for (int i = threadIdx.x; i < c.n; i += blockDim.x) {
    const int is_drv = i == drv ? 1 : 0;
    const int w = cnt[i] + is_drv;
    if (w == 0) continue;
    float eff[3];
    for (int d = 0; d < 3; ++d) {
      int new_res = is_drv * c.dreq[d];
      if (include_exec) new_res += cnt[i] * c.ereq[d];
      const int sched = c.sched[i * 3 + d];
      const int reserved = (sched - c.avail[d * c.n + i]) + new_res;
      eff[d] = static_cast<float>(reserved) / static_cast<float>(max(sched, 1));
    }
    const float eff_gpu = c.sched[i * 3 + 2] != 0 ? eff[2] : 0.0f;
    const float node_max = fmaxf(eff_gpu, fmaxf(eff[0], eff[1]));
    const float prod = node_max * static_cast<float>(w);
    part += static_cast<double>(prod);
  }
  const double total = gs_block_reduce<double>(part, GsSum(), reinterpret_cast<double*>(c.red));
  return static_cast<float>(total) / static_cast<float>(c.count + 1);
}

// The whole per-gang solve (make_gang_solver). On return, *ok says whether
// the gang packs, *drv is its driver (or -1), and *cnt_out / *ex_out point
// at the buffers holding the chosen placement (one of the two pairs given).
// zfirst/zhas hold, per zone, the smallest driver rank among its
// driver-eligible nodes and whether it has an executor-eligible node.
__device__ void gs_gang_solve(const GangCtx& c, int fill, bool single_az,
                              bool az_fallback, bool include_exec, int num_zones,
                              const int* zfirst, const int* zhas,
                              int* cnt0, int* cnt1, int* ex0, int* ex1,
                              bool* ok, int* drv, int** cnt_out, int** ex_out) {
  if (!single_az) {
    const int d = gs_select_driver(c, -1);
    gs_run_fill(c, fill, -1, d, d >= 0, cnt0, ex0);
    *ok = d >= 0;
    *drv = d;
    *cnt_out = cnt0;
    *ex_out = ex0;
    return;
  }
  // Per-zone pack + strictly-greater efficiency pick, ties to the zone
  // appearing first in driver priority order (single_az.go:23-97).
  int *cur_c = cnt0, *cur_e = ex0, *best_c = cnt1, *best_e = ex1;
  float best_eff = -1.0f;
  int best_first = GS_INF, best_drv = -1;
  bool any_valid = false;
  for (int z = 0; z < num_zones; ++z) {
    const int d = gs_select_driver(c, z);
    gs_run_fill(c, fill, z, d, d >= 0, cur_c, cur_e);
    const bool valid_z = d >= 0 && zfirst[z] < GS_INF && zhas[z] != 0;
    if (!valid_z) continue;
    any_valid = true;
    const float eff = gs_zone_efficiency(c, d, cur_c, include_exec);
    if (eff > best_eff || (eff == best_eff && zfirst[z] < best_first)) {
      best_eff = eff;
      best_first = zfirst[z];
      best_drv = d;
      int* t = cur_c; cur_c = best_c; best_c = t;
      t = cur_e; cur_e = best_e; best_e = t;
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
    const int d = gs_select_driver(c, -1);
    gs_run_fill(c, fill, -1, d, d >= 0, cur_c, cur_e);
    *ok = d >= 0;
    *drv = d;
  }
}

// The strategy as the kernels receive it (ops/gang.py strategy_params).
struct GsStrategy {
  int fill, single_az, az_fallback, include_exec, num_zones;
};

// One block's global-memory workspace: 8 n + 2 emax + 2 num_zones int32
// words, carved from the scratch buffer the wrapper allocates.
struct GsWork {
  int* avail;   // [3][n] availability, dimension-major
  int* cap_e;   // [n]
  int* cap_wd;  // [n]
  int* fit_d;   // [n]
  int* cnt0;    // [n]
  int* cnt1;    // [n]
  int* ex0;     // [emax]
  int* ex1;     // [emax]
  int* zfirst;  // [num_zones]
  int* zhas;    // [num_zones]
};

__device__ __forceinline__ GsWork gs_carve(int* scratch, int n, int emax, int num_zones) {
  GsWork w;
  w.avail = scratch;
  w.cap_e = w.avail + 3 * n;
  w.cap_wd = w.cap_e + n;
  w.fit_d = w.cap_wd + n;
  w.cnt0 = w.fit_d + n;
  w.cnt1 = w.cnt0 + n;
  w.ex0 = w.cnt1 + n;
  w.ex1 = w.ex0 + emax;
  w.zfirst = w.ex1 + emax;
  w.zhas = w.zfirst + num_zones;
  return w;
}

// Availability-independent zone facts, once per set of orders (single-AZ
// strategies only): per zone, the smallest driver rank among its
// driver-eligible nodes and whether it has an executor-eligible node.
// Ends with a barrier.
__device__ void gs_zone_facts(const GangCtx& c, const GsStrategy& s, const GsWork& w) {
  if (s.single_az) {
    for (int z = 0; z < s.num_zones; ++z) {
      int first = GS_INF, has = 0;
      for (int i = threadIdx.x; i < c.n; i += blockDim.x) {
        if (c.zone[i] != z) continue;
        if (c.elig_d[i]) first = min(first, c.drank[i]);
        if (c.elig_e[i]) has = 1;
      }
      first = gs_block_reduce<int>(first, GsMin(), reinterpret_cast<int*>(c.red));
      has = gs_block_reduce<int>(has, GsMax(), reinterpret_cast<int*>(c.red));
      if (threadIdx.x == 0) {
        w.zfirst[z] = first;
        w.zhas[z] = has;
      }
    }
  }
  __syncthreads();
}

// A padding row: nothing packs, nothing is debited, nothing blocks.
__device__ __forceinline__ void gs_empty_row(int* meta, int* execs, int emax) {
  if (threadIdx.x == 0) {
    meta[0] = -1;
    meta[1] = 0;
    meta[2] = 0;
    meta[3] = 0;
  }
  for (int j = threadIdx.x; j < emax; j += blockDim.x) execs[j] = -1;
}

// One valid FIFO row (pallas_fifo.py:475-553): node capacities from the
// carried availability, the gang solve, `packed = ok && !too_big`,
// `admitted = packed && !blocked`, the admitted gang debited from
// w.avail (and from `commit_base` [n][3] too when it is not null), the
// meta row (driver, admitted, packed, 0) and executor slots written, and
// strict-FIFO blocking: a non-skippable failure blocks the later rows
// (resource.go:241-249). Ends with a barrier.
__device__ void gs_fifo_row(GangCtx& c, const GsStrategy& s, const GsWork& w,
                            const int* dreq, const int* ereq, int raw, bool skip,
                            bool* blocked, int* commit_base, int* meta, int* execs) {
  const int n = c.n;
  const bool too_big = raw > c.emax;
  c.count = min(raw, c.emax);
  for (int d = 0; d < 3; ++d) {
    c.dreq[d] = dreq[d];
    c.ereq[d] = ereq[d];
  }
  // Node capacities (ops/capacity.py): per dim 0 if the reservation
  // exceeds availability, INF if the request is 0, else the floor of a
  // non-negative quotient; min over dims, never negative.
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    int ce = GS_INF, cw = GS_INF, fd = 1;
    for (int d = 0; d < 3; ++d) {
      const int a = w.avail[d * n + i];
      const int er = c.ereq[d], dr = c.dreq[d];
      const int safe = max(er, 1);
      const int pe = 0 > a ? 0 : (er == 0 ? GS_INF : a / safe);
      const int pw = dr > a ? 0 : (er == 0 ? GS_INF : (a - dr) / safe);
      ce = min(ce, pe);
      cw = min(cw, pw);
      fd &= dr <= a ? 1 : 0;
    }
    const bool e = c.elig_e[i] != 0;
    w.cap_e[i] = e ? max(ce, 0) : 0;
    w.cap_wd[i] = e ? max(cw, 0) : 0;
    w.fit_d[i] = fd;
  }
  __syncthreads();

  bool ok;
  int drv;
  int *cnt, *ex;
  gs_gang_solve(c, s.fill, s.single_az != 0, s.az_fallback != 0, s.include_exec != 0,
                s.num_zones, w.zfirst, w.zhas, w.cnt0, w.cnt1, w.ex0, w.ex1, &ok, &drv,
                &cnt, &ex);
  const bool packed = ok && !too_big;
  const bool admitted = packed && !*blocked;
  if (admitted) {
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      const int k = cnt[i];
      const int is_drv = i == drv ? 1 : 0;
      if (k == 0 && !is_drv) continue;
      for (int d = 0; d < 3; ++d) {
        const int delta = k * c.ereq[d] + is_drv * c.dreq[d];
        w.avail[d * n + i] -= delta;
        if (commit_base) commit_base[i * 3 + d] -= delta;
      }
    }
  }
  if (threadIdx.x == 0) {
    meta[0] = admitted ? drv : -1;
    meta[1] = admitted ? 1 : 0;
    meta[2] = packed ? 1 : 0;
    meta[3] = 0;
  }
  for (int j = threadIdx.x; j < c.emax; j += blockDim.x) execs[j] = admitted ? ex[j] : -1;
  *blocked = *blocked || (!packed && !skip);
  __syncthreads();
}
