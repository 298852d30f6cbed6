// Column-strip tiled SpMV for Hopper: y = A x over the padded row/column
// spaces of the solver's layout, on the tiles of ops/tiles.py.
//
// Replaces, on the main path, the four Pallas TPU kernels of
// hprlp_tpu/ops/pallas_spmv.py: lane_spmv and thin_spmv (the float
// instantiation, f32 accumulation as theirs) and lane_spmv_df64 and
// thin_spmv_df64 (the double instantiation, native f64 in place of hi/lo
// pairs).  Like _lane_kernel, which stages one 16384-entry x window in VMEM
// per grid step and keeps y in VMEM, a block here stages x one column strip
// at a time in shared memory and keeps its rows of y there.  It succeeds
// the row-parallel CSR kernel of csrc/spmv.cu.
//
// What bounds it: bytes.  Each nonzero reads its value and a 4-byte key
// (8 B per f32 entry, as CSR's value and column index), and y is written
// once; the multiply-add per entry is negligible beside that traffic.
// What the design does about the two costs the CSR kernel's ablations
// found:
// 1. The x gather (44% of the CSR kernel's time at 10.5M nnz): a gather
//    from global memory touches up to 32 lines per warp request.  Here x
//    is read from a shared-memory strip, where 32 random reads cost their
//    worst bank conflict.  The strip arrives by one bulk asynchronous copy
//    (cp.async.bulk, TMA) that completes on an mbarrier, double-buffered
//    so that strip s+1 lands while strip s is consumed.  Staging costs
//    each block the bytes of every strip it covers, so the strips are cut
//    into G groups and block (g, c) covers strip group g of row chunk c:
//    it stages 1/G of x for a chunk of G times as many rows, writes its
//    partial y, and group_sum_kernel adds the G partials in group order.
//    In the multicast stages a cluster of C blocks (the same group, C
//    consecutive chunks) shares each strip: each block copies 1/C of it
//    with .multicast::cluster into all of them.
// 2. The value/key stream at half the HBM rate: the entries of a block
//    and strip are one packed array per warp run, so each lane loads 16
//    bytes of values and of keys per step (coalesced, no idle lanes but
//    the run's last step), with no dependent row-pointer reads.  A warp's
//    runs over its strips are one contiguous stream, and the loads of its
//    next kDepth steps, across strip boundaries and barriers too, are
//    issued before the current step is summed.
// Row sums: each lane sums its VEC entries by row, a segmented warp scan
// on the row key joins rows that span lanes, and each closed row segment
// is added once into y in shared memory; a row has one owning warp per
// strip and strips are separated by a barrier, so there are no atomics
// and the order of every sum is fixed by the layout: two launches on the
// same inputs give bitwise-identical y.
//
// Stages (template CLUSTER, for measurement; ops/spmv.py fixes the main
// one): 0 gathers x from global memory, with the same stream and y in
// shared memory; 1 stages each strip per block; 2, 4 and 8 share it across
// a cluster of that many blocks by multicast.

#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

namespace {

constexpr int kWarps = 16;                    // ops/tiles.py WARPS
constexpr int kThreads = kWarps * 32;
constexpr int kDepth = 4;                     // steps in flight per warp
constexpr int kMaxSmem = 232448;              // ops/tiles.py SMEM_BYTES
constexpr uint32_t kSentinelRow = 0xFFFFu;    // padding entries

template <typename T> struct Vec;
template <> struct Vec<float> {
  static constexpr int n = 4;
  using V = float4;
  using K = uint4;
};
template <> struct Vec<double> {
  static constexpr int n = 2;
  using V = double2;
  using K = uint2;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_u32(bar))
               : "memory");
}

// One arrival that also expects `bytes` of transactions this phase.
__device__ __forceinline__ void mbar_arrive_expect(uint64_t* bar,
                                                   uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(smem_u32(bar)), "r"(bytes)
               : "memory");
}

// Wait until the phase with the given parity has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  }
}

__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// The same bytes into the same offsets of every block in `mask`, each
// block's mbarrier at `bar`'s offset receiving the completion.
__device__ __forceinline__ void bulk_copy_multicast(void* dst, const void* src,
                                                    uint32_t bytes,
                                                    uint64_t* bar,
                                                    uint16_t mask) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      ".multicast::cluster [%0], [%1], %2, [%3], %4;\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar)), "h"(mask)
      : "memory");
}

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

// Every thread of every block of the cluster (a superset of
// __syncthreads for this block's shared memory).
__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n"
      "barrier.cluster.wait.acquire.aligned;\n" ::
          : "memory");
}

template <int CLUSTER>
__device__ __forceinline__ void block_sync() {
  if constexpr (CLUSTER > 1) {
    cluster_sync();
  } else {
    __syncthreads();
  }
}

// Thread 0: arm buffer b's mbarrier and start the copy of strip s into it
// (in a cluster, this block's slice of it, multicast to the cluster).  A
// strip's bytes beyond its last multiple of 16 are copied by the threads.
template <typename T, int CLUSTER>
__device__ __forceinline__ void load_strip(T* buf, uint64_t* bar,
                                           const T* __restrict__ x, int ncols,
                                           int W, int s) {
  const int len = min(W, ncols - s * W);
  const uint32_t bulk = static_cast<uint32_t>(len * sizeof(T)) & ~15u;
  mbar_arrive_expect(bar, bulk);
  const char* src = reinterpret_cast<const char*>(x + static_cast<int64_t>(s) * W);
  char* dst = reinterpret_cast<char*>(buf);
  if constexpr (CLUSTER > 1) {
    const uint32_t slice = (bulk + CLUSTER * 16 - 1) / (CLUSTER * 16) * 16;
    const uint32_t off = cluster_rank() * slice;
    if (off < bulk) {
      bulk_copy_multicast(dst + off, src + off, min(slice, bulk - off), bar,
                          static_cast<uint16_t>((1u << CLUSTER) - 1));
    }
  } else {
    if (bulk) bulk_copy(dst, src, bulk, bar);
  }
}

// One step of a warp run: VEC consecutive entries per lane.
template <typename T>
struct Step {
  T v[Vec<T>::n];
  uint32_t k[Vec<T>::n];
};

// Entries [p + lane * VEC, +VEC) of a run ending at `end` (runs are padded
// to a multiple of VEC, so a lane's entries are all in or all out); lanes
// past the end get zero values on the padding row.
template <typename T>
__device__ __forceinline__ Step<T> load_step(const T* __restrict__ vals,
                                             const uint32_t* __restrict__ keys,
                                             uint32_t p, uint32_t end,
                                             int lane) {
  constexpr int N = Vec<T>::n;
  Step<T> st;
  const uint32_t i = p + lane * N;
  if (i < end) {
    const typename Vec<T>::V v =
        __ldcs(reinterpret_cast<const typename Vec<T>::V*>(vals + i));
    const typename Vec<T>::K k =
        __ldcs(reinterpret_cast<const typename Vec<T>::K*>(keys + i));
    const T* pv = reinterpret_cast<const T*>(&v);
    const uint32_t* pk = reinterpret_cast<const uint32_t*>(&k);
#pragma unroll
    for (int j = 0; j < N; ++j) {
      st.v[j] = pv[j];
      st.k[j] = pk[j];
    }
  } else {
#pragma unroll
    for (int j = 0; j < N; ++j) {
      st.v[j] = T(0);
      st.k[j] = kSentinelRow << 16;
    }
  }
  return st;
}

// Where a warp's next step to load is: its strip s (K when the stream is
// done), its position p and the end of that strip's run.
struct Cursor {
  int s;
  uint32_t p, end;
};

// Move past finished and empty runs (a warp's run of strip s+1 starts
// where that of strip s ends).
__device__ __forceinline__ void settle(Cursor& c, const int* __restrict__ my_runs,
                                       int K) {
  while (c.p >= c.end && c.s < K) {
    ++c.s;
    c.p = c.end;
    if (c.s < K) c.end = static_cast<uint32_t>(__ldg(my_runs + c.s + 1));
  }
}

// A loaded step and the strip it belongs to.
template <typename T>
struct Slot {
  Step<T> st;
  int s;
};

// Load the step at the cursor (all lanes masked past the last strip) and
// advance the cursor: kDepth of these are in flight ahead of the sums.
template <typename T>
__device__ __forceinline__ Slot<T> next_slot(Cursor& c,
                                             const T* __restrict__ vals,
                                             const uint32_t* __restrict__ keys,
                                             const int* __restrict__ my_runs,
                                             int K, int lane) {
  Slot<T> sl;
  sl.s = c.s;
  sl.st = load_step(vals, keys, c.p, c.s < K ? c.end : 0u, lane);
  if (c.s < K) {
    c.p += 32 * Vec<T>::n;
    settle(c, my_runs, K);
  }
  return sl;
}

template <typename T>
__device__ __forceinline__ void add_row(T* ys, uint32_t row, T v) {
  if (row != kSentinelRow) ys[row] += v;
}

// Sum one step into ys.  (carry_row, carry) is the warp's open row from
// the previous step (lane 31's last row), uniform across the warp;
// carry_row is kSentinelRow when there is none.
template <typename T, int CLUSTER>
__device__ __forceinline__ void sum_step(const Step<T>& st, const T* xs,
                                         const T* __restrict__ xg, T* ys,
                                         uint32_t& carry_row, T& carry,
                                         int lane) {
  constexpr int N = Vec<T>::n;
  constexpr unsigned kFull = 0xffffffffu;
  uint32_t r[N];
  T prod[N];
#pragma unroll
  for (int j = 0; j < N; ++j) {
    r[j] = st.k[j] >> 16;
    const uint32_t c = st.k[j] & 0xFFFFu;
    T xv;
    if constexpr (CLUSTER == 0) {
      xv = __ldg(xg + c);
    } else {
      xv = xs[c];
    }
    prod[j] = st.v[j] * xv;
  }
  const uint32_t first = __shfl_sync(kFull, r[0], 0);
  if (carry_row != first) {  // the open row ended with the last step
    if (lane == 0) add_row(ys, carry_row, carry);
    carry_row = kSentinelRow;
    carry = T(0);
  }
  // This lane's last row and its partial sum (a suffix of the entries).
  const uint32_t last = r[N - 1];
  T a = T(0);
#pragma unroll
  for (int j = 0; j < N; ++j) {
    if (r[j] == last) a += prod[j];
  }
  // Segmented inclusive scan over the lanes, keyed by the (sorted) last
  // row; the open row from the last step joins the lanes that continue it.
  T S = a;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const T o = __shfl_up_sync(kFull, S, d);
    const uint32_t kr = __shfl_up_sync(kFull, last, d);
    if (lane >= d && kr == last) S += o;
  }
  if (last == carry_row) S = carry + S;
  // The sum that flows into this lane's first row from the left.
  const T left_s = __shfl_up_sync(kFull, S, 1);
  const uint32_t left_row = __shfl_up_sync(kFull, last, 1);
  T cur = T(0);
  if (lane == 0) {
    if (r[0] == carry_row) cur = carry;
  } else if (left_row == r[0]) {
    cur = left_s;
  }
  // Rows that close inside this lane.
#pragma unroll
  for (int j = 0; j < N - 1; ++j) {
    cur += prod[j];
    if (r[j] != r[j + 1]) {
      add_row(ys, r[j], cur);
      cur = T(0);
    }
  }
  // The last row closes here unless the next lane (or step) continues it.
  const uint32_t next_first = __shfl_down_sync(kFull, r[0], 1);
  if (lane < 31 && next_first != last) add_row(ys, last, S);
  carry_row = __shfl_sync(kFull, last, 31);
  carry = __shfl_sync(kFull, S, 31);
}

template <typename T, int CLUSTER>
__global__ void __launch_bounds__(kThreads, 1)
tiled_spmv_kernel(int nrows, int ncols, int W, int K, int Kg, int C,
                  int max_rows, const T* __restrict__ vals,
                  const uint32_t* __restrict__ keys,
                  const int* __restrict__ runs,
                  const int* __restrict__ row_start,
                  const T* __restrict__ x, T* __restrict__ out) {
  constexpr bool kStaged = CLUSTER > 0;
  // Shared memory: nbuf x strips of W entries, y of the largest chunk
  // (rounded up to 16 bytes), two mbarriers -- the same offsets in every
  // block, as multicast needs.
  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int b = blockIdx.x;
  const int g = b / C;  // strip group: strips g * Kg .. + nstrips
  const int c = b % C;  // row chunk
  const int s0 = g * Kg;
  const int nstrips = max(0, min(Kg, K - s0));
  const int row0 = row_start[c];
  const int nrows_b = row_start[c + 1] - row0;
  const int nbuf = kStaged ? (Kg > 1 ? 2 : 1) : 0;
  T* xs[2] = {reinterpret_cast<T*>(smem),
              reinterpret_cast<T*>(smem) + (nbuf > 1 ? W : 0)};
  T* ys = reinterpret_cast<T*>(smem) + static_cast<int64_t>(nbuf) * W;
  uint64_t* bar = reinterpret_cast<uint64_t*>(
      reinterpret_cast<unsigned char*>(ys) +
      ((static_cast<int64_t>(max_rows) * sizeof(T) + 15) & ~int64_t(15)));

  for (int i = tid; i < nrows_b; i += kThreads) ys[i] = T(0);
  if constexpr (kStaged) {
    if (tid == 0) {
      mbar_init(&bar[0]);
      mbar_init(&bar[1]);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
  }
  block_sync<CLUSTER>();  // barriers initialised in every block, y zeroed
  if constexpr (kStaged) {
    if (tid == 0) {
      for (int l = 0; l < nbuf && l < nstrips; ++l) {
        load_strip<T, CLUSTER>(xs[l], &bar[l], x, ncols, W, s0 + l);
      }
    }
  }

  // This warp's runs, strip by strip, are one contiguous stream.
  const int* my_runs = runs + (static_cast<int64_t>(b) * kWarps + warp) * Kg;
  Cursor next{0, static_cast<uint32_t>(my_runs[0]),
              static_cast<uint32_t>(my_runs[1])};
  settle(next, my_runs, Kg);
  Slot<T> ring[kDepth];
#pragma unroll
  for (int i = 0; i < kDepth; ++i) ring[i] = next_slot(next, vals, keys, my_runs, Kg, lane);

  for (int l = 0; l < nstrips; ++l) {
    const int s = s0 + l;
    const T* xbuf = nullptr;
    if constexpr (kStaged) {
      const int bi = l & 1;
      mbar_wait(&bar[bi], (l >> 1) & 1);
      xbuf = xs[bi];
      const int len = min(W, ncols - s * W);
      const int done = static_cast<int>((len * sizeof(T)) & ~15u) /
                       static_cast<int>(sizeof(T));
      if (done < len) {  // the last strip's tail beyond its last 16 bytes
        for (int i = done + tid; i < len; i += kThreads) {
          xs[bi][i] = x[static_cast<int64_t>(s) * W + i];
        }
        __syncthreads();
      }
    }
    const T* xg = x + static_cast<int64_t>(s) * W;
    uint32_t carry_row = kSentinelRow;
    T carry = T(0);
    while (ring[0].s == l) {
      const Step<T> st = ring[0].st;
#pragma unroll
      for (int i = 0; i + 1 < kDepth; ++i) ring[i] = ring[i + 1];
      ring[kDepth - 1] = next_slot(next, vals, keys, my_runs, Kg, lane);
      sum_step<T, CLUSTER>(st, xbuf, xg, ys, carry_row, carry, lane);
    }
    if (lane == 0) add_row(ys, carry_row, carry);
    // Strip s is consumed in every block (of the cluster) before its
    // buffer is refilled and before another warp owns its rows.
    block_sync<CLUSTER>();
    if constexpr (kStaged) {
      if (tid == 0 && l + 2 < nstrips) {
        load_strip<T, CLUSTER>(xs[l & 1], &bar[l & 1], x, ncols, W, s + 2);
      }
    }
  }
  // y of the chunk, or with several groups this group's partial of it.
  T* dst = out + static_cast<int64_t>(g) * nrows + row0;
  for (int i = tid; i < nrows_b; i += kThreads) dst[i] = ys[i];
}

// y = the G partials summed in group order (the fixed order that keeps y
// bitwise reproducible; no atomics).
template <typename T>
__global__ void __launch_bounds__(256)
group_sum_kernel(int G, int nrows, const T* __restrict__ part,
                 T* __restrict__ y) {
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < nrows; i += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    T sum = part[i];
    for (int g = 1; g < G; ++g) sum += part[static_cast<int64_t>(g) * nrows + i];
    y[i] = sum;
  }
}

template <typename T>
size_t smem_bytes(int cluster, int W, int Kg, int max_rows) {
  const size_t ys = (static_cast<size_t>(max_rows) * sizeof(T) + 15) & ~size_t(15);
  if (cluster == 0) return ys;
  const size_t nbuf = Kg > 1 ? 2 : 1;
  return nbuf * W * sizeof(T) + ys + 16;
}

template <typename T, int CLUSTER>
cudaLaunchConfig_t config(int nblocks, size_t smem, cudaStream_t stream,
                          cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(nblocks);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = CLUSTER > 1 ? CLUSTER : 1;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

struct Args {
  int nrows, ncols, W, K, G, Kg, C, max_rows;
  const void *vals, *keys, *runs, *row_start, *x;
  void *part, *y;
};

template <typename T, int CLUSTER>
int launch_stage(const Args& a, cudaStream_t stream) {
  const size_t smem = smem_bytes<T>(CLUSTER, a.W, a.Kg, a.max_rows);
  const int nblocks = a.G * a.C;
  if (smem > static_cast<size_t>(kMaxSmem) ||
      a.C % (CLUSTER > 1 ? CLUSTER : 1) || (a.G > 1 && !a.part)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = config<T, CLUSTER>(nblocks, smem, stream,
                                                    &attr);
  T* out = static_cast<T*>(a.G > 1 ? a.part : a.y);
  cudaError_t err = cudaLaunchKernelEx(
      &cfg, tiled_spmv_kernel<T, CLUSTER>, a.nrows, a.ncols, a.W, a.K, a.Kg,
      a.C, a.max_rows, static_cast<const T*>(a.vals),
      static_cast<const uint32_t*>(a.keys), static_cast<const int*>(a.runs),
      static_cast<const int*>(a.row_start), static_cast<const T*>(a.x), out);
  if (err == cudaSuccess) err = cudaGetLastError();
  if (err == cudaSuccess && a.G > 1) {
    const int grid = static_cast<int>(
        std::min<int64_t>((a.nrows + 255) / 256, 132 * 8));
    group_sum_kernel<T><<<grid, 256, 0, stream>>>(
        a.G, a.nrows, out, static_cast<T*>(a.y));
    err = cudaGetLastError();
  } else {
    cudaGetLastError();  // clear a launch error that err already holds
  }
  return static_cast<int>(err);
}

template <typename T, int CLUSTER>
int active_clusters(int smem) {
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = config<T, CLUSTER>(
      CLUSTER > 1 ? CLUSTER : 1, smem, nullptr, &attr);
  int n = 0;
  const cudaError_t err =
      cudaOccupancyMaxActiveClusters(&n, tiled_spmv_kernel<T, CLUSTER>, &cfg);
  return err == cudaSuccess ? n : -static_cast<int>(err);
}

template <typename T>
int launch(int cluster, const Args& a, void* stream) {
  if (a.G * a.C <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (cluster) {
    case 0: return launch_stage<T, 0>(a, s);
    case 1: return launch_stage<T, 1>(a, s);
    case 2: return launch_stage<T, 2>(a, s);
    case 4: return launch_stage<T, 4>(a, s);
    case 8: return launch_stage<T, 8>(a, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T>
int max_active(int cluster, int smem) {
  switch (cluster) {
    case 0: return active_clusters<T, 0>(smem);
    case 1: return active_clusters<T, 1>(smem);
    case 2: return active_clusters<T, 2>(smem);
    case 4: return active_clusters<T, 4>(smem);
    case 8: return active_clusters<T, 8>(smem);
    default: return -static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T>
int set_max_smem() {
  const void* fns[] = {
      reinterpret_cast<const void*>(tiled_spmv_kernel<T, 0>),
      reinterpret_cast<const void*>(tiled_spmv_kernel<T, 1>),
      reinterpret_cast<const void*>(tiled_spmv_kernel<T, 2>),
      reinterpret_cast<const void*>(tiled_spmv_kernel<T, 4>),
      reinterpret_cast<const void*>(tiled_spmv_kernel<T, 8>)};
  for (const void* fn : fns) {
    const cudaError_t err = cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

}  // namespace

extern "C" {

// Raise every instantiation's dynamic shared memory limit to 227 KB; call
// once per device before the first launch (never inside a graph capture).
int hprlp_tiled_init(void) {
  const int e = set_max_smem<float>();
  return e ? e : set_max_smem<double>();
}

// y = A x on the tiles; returns the launch's error code (0 on success).
// f64: 0 for float, 1 for double; cluster: the stage (0: x from global
// memory, 1: strips per block, 2/4/8: strips multicast to that many).
// With G > 1 strip groups, `part` holds G * nrows partials of y.
int hprlp_tiled_spmv(int f64, int cluster, int nrows, int ncols, int W,
                     int K, int G, int Kg, int C, int max_rows,
                     const void* vals, const void* keys, const void* runs,
                     const void* row_start, const void* x, void* part,
                     void* y, void* stream) {
  const Args a{nrows, ncols, W, K, G, Kg, C, max_rows, vals, keys, runs,
               row_start, x, part, y};
  return f64 ? launch<double>(cluster, a, stream)
             : launch<float>(cluster, a, stream);
}

// How many clusters of a stage can be resident at once at the given
// dynamic shared memory (0 if none fits); -error on failure.
int hprlp_tiled_max_active_clusters(int f64, int cluster, int smem) {
  return f64 ? max_active<double>(cluster, smem)
             : max_active<float>(cluster, smem);
}

const char* hprlp_tiled_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
