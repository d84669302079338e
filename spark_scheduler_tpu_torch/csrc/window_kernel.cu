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
  int* avail = p.scratch;        // [3][n]
  int* cap_e = avail + 3 * n;    // [n]
  int* cap_wd = cap_e + n;       // [n]
  int* fit_d = cap_wd + n;       // [n]
  int* cnt0 = fit_d + n;         // [n]
  int* cnt1 = cnt0 + n;          // [n]
  int* ex0 = cnt1 + n;           // [emax]
  int* ex1 = ex0 + p.emax;       // [emax]
  int* zfirst = ex1 + p.emax;    // [num_zones]
  int* zhas = zfirst + p.num_zones;

  for (int i = threadIdx.x; i < n; i += blockDim.x)
    for (int d = 0; d < 3; ++d) avail[d * n + i] = p.base[i * 3 + d];

  GangCtx c;
  c.n = n;
  c.emax = p.emax;
  c.avail = avail;
  c.sched = p.sched;
  c.cap_e = cap_e;
  c.cap_wd = cap_wd;
  c.fit_d = fit_d;
  c.elig_e = p.elig_e;
  c.elig_d = p.elig_d;
  c.zone = p.zone;
  c.drank = p.drank;
  c.d_order = p.d_order;
  c.erank = p.erank;
  c.e_order = p.e_order;
  c.red = red;

  if (p.single_az) {
    // Availability-independent zone facts, once per segment.
    for (int z = 0; z < p.num_zones; ++z) {
      int first = GS_INF, has = 0;
      for (int i = threadIdx.x; i < n; i += blockDim.x) {
        if (p.zone[i] != z) continue;
        if (p.elig_d[i]) first = min(first, p.drank[i]);
        if (p.elig_e[i]) has = 1;
      }
      first = gs_block_reduce<int>(first, GsMin(), reinterpret_cast<int*>(red));
      has = gs_block_reduce<int>(has, GsMax(), reinterpret_cast<int*>(red));
      if (threadIdx.x == 0) {
        zfirst[z] = first;
        zhas[z] = has;
      }
    }
  }
  __syncthreads();

  bool blocked = false;
  for (int r = 0; r < p.rows; ++r) {
    int* meta = p.meta + r * 4;
    int* execs = p.execs + r * p.emax;
    if (r >= p.row_count || !p.valid[r]) {
      if (threadIdx.x == 0) {
        meta[0] = -1;
        meta[1] = 0;
        meta[2] = 0;
        meta[3] = 0;
      }
      for (int j = threadIdx.x; j < p.emax; j += blockDim.x) execs[j] = -1;
      continue;
    }
    const int raw = p.cnt[r];
    const bool too_big = raw > p.emax;
    c.count = min(raw, p.emax);
    for (int d = 0; d < 3; ++d) {
      c.dreq[d] = p.dreq[r * 3 + d];
      c.ereq[d] = p.ereq[r * 3 + d];
    }
    // Node capacities (ops/capacity.py): per dim 0 if the reservation
    // exceeds availability, INF if the request is 0, else the floor of a
    // non-negative quotient; min over dims, never negative.
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      int ce = GS_INF, cw = GS_INF, fd = 1;
      for (int d = 0; d < 3; ++d) {
        const int a = avail[d * n + i];
        const int er = c.ereq[d], dr = c.dreq[d];
        const int safe = max(er, 1);
        const int pe = 0 > a ? 0 : (er == 0 ? GS_INF : a / safe);
        const int pw = dr > a ? 0 : (er == 0 ? GS_INF : (a - dr) / safe);
        ce = min(ce, pe);
        cw = min(cw, pw);
        fd &= dr <= a ? 1 : 0;
      }
      const bool e = p.elig_e[i] != 0;
      cap_e[i] = e ? max(ce, 0) : 0;
      cap_wd[i] = e ? max(cw, 0) : 0;
      fit_d[i] = fd;
    }
    __syncthreads();

    bool ok;
    int drv;
    int *cnt, *ex;
    gs_gang_solve(c, p.fill, p.single_az != 0, p.az_fallback != 0,
                  p.include_exec != 0, p.num_zones, zfirst, zhas, cnt0, cnt1,
                  ex0, ex1, &ok, &drv, &cnt, &ex);
    const bool packed = ok && !too_big;
    const bool admitted = packed && !blocked;
    const bool commit = admitted && r == p.row_count - 1;
    if (admitted) {
      for (int i = threadIdx.x; i < n; i += blockDim.x) {
        const int k = cnt[i];
        const int is_drv = i == drv ? 1 : 0;
        if (k == 0 && !is_drv) continue;
        for (int d = 0; d < 3; ++d) {
          const int delta = k * c.ereq[d] + is_drv * c.dreq[d];
          avail[d * n + i] -= delta;
          if (commit) p.base[i * 3 + d] -= delta;
        }
      }
    }
    if (threadIdx.x == 0) {
      meta[0] = admitted ? drv : -1;
      meta[1] = admitted ? 1 : 0;
      meta[2] = packed ? 1 : 0;
      meta[3] = 0;
    }
    for (int j = threadIdx.x; j < p.emax; j += blockDim.x)
      execs[j] = admitted ? ex[j] : -1;
    // Strict FIFO: a non-skippable failure blocks the segment's later rows
    // (resource.go:241-249).
    blocked = blocked || (!packed && !p.skip[r]);
    __syncthreads();
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
