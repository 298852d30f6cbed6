// Column-strip tiled SpMV for Hopper: y = A x over the padded row/column
// spaces of the solver's layout, on the tiles of ops/tiles.py, and the
// single-LP HPR middle iteration's two half-updates fused into its row
// write.
//
// Replaces, on the main path, the four Pallas TPU kernels of
// hprlp_tpu/ops/pallas_spmv.py: lane_spmv and thin_spmv (the float
// instantiation, f32 accumulation as theirs) and lane_spmv_df64 and
// thin_spmv_df64 (the double instantiation, native f64 in place of hi/lo
// pairs).  Like _lane_kernel, which stages one 16384-entry x window in VMEM
// per grid step and keeps y in VMEM, a block here stages x one column strip
// at a time in shared memory and keeps its rows of y there.  It succeeds
// the row-parallel CSR kernel of csrc/spmv.cu.  The fused halves replace
// the plain elementwise ops of solver/chunk.py::_x_half/_y_half after the
// store (XLA fuses them in the JAX package, hprlp_tpu/solver/chunk.py:72,
// :81), as csrc/spmv_csr.cu's do on the "gather" backend.
//
// What bounds it: bytes.  Each nonzero reads its value and a 4-byte key
// (8 B per f32 entry, as CSR's value and column index), and y is written
// once; the multiply-add per entry is negligible beside that traffic.  A
// fused half adds its row operands (x-half: x, last_x, c, l, u read, x_new
// and x_hat written; y-half: y, last_y, AL, AU read, y_new written).
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
//    it stages 1/G of x for a chunk of G times as many rows, and the G
//    blocks of a chunk each hold a partial y of its rows.
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
// The G partials of a chunk (the main stage, tiled_cluster_kernel): the G
// blocks of row chunk c are one thread-block cluster, grid (G, C) with
// cluster (G, 1, 1), so one instantiation serves every G from 2 to 8 (the
// portable cluster size; ops/tiles.py MAX_GROUPS).  At G = 1 a chunk's
// one block holds its rows' whole sums, and the main stage launches the
// block kernel (tiled_spmv_kernel at CLUSTER = 1, as block_x does) over
// the chunks with rows: one launch, the same bits, and 0.7-1.0 us faster
// than a cluster of one (17% of a product at a 0.5M-nnz LP).  Block g is the
// cluster's rank g (%cluster_ctarank) and c the cluster's index; its runs
// are those of the layout's block g * C + c, so the layout, its runs and
// its plain reference are the previous design's.  Each block sums its
// strips into its own shared memory as every stage does, with block-local
// barriers only (groups may hold different strip counts).  Then one
// cluster barrier (arrive.release, wait.acquire), after which rank g takes
// a contiguous 1/G share of the chunk's rows, reads each row's G partials
// from ranks 0 .. G-1 through distributed shared memory, sums them in that
// order (part[0], then += part[r]) and writes y or the row's half-update;
// a second cluster barrier keeps every block's shared memory alive until
// its peers have read it.  The sum is the previous design's in the same
// order on the same partials, so y, x_new, x_hat and y_new are bitwise
// what it gives, with no partials in HBM (2 G nrows values written and
// read), no second launch, and the sum and the half's operand reads spread
// over all G C blocks.  A cluster of G needs G free SMs in one GPC, so
// fewer clusters of G may be resident than SMs / G: build_tiles takes that
// count (ops/spmv.py::cluster_slots) to keep a tiling's chunks in one
// wave.
//
// The previous design (stage block_x, tiled_spmv_kernel at CLUSTER = 1):
// blocks b = g * C + c each stage their strips, write their partial y to
// HBM, and group_sum_kernel<T, E> sums the G partials of each row in group
// order and applies the half.  It is kept as the bitwise yardstick and
// timed beside the main stage; no solve launches it.
//
// Stages (ops/spmv.py TILED_STAGES, the codes below): kGroupStage the
// cluster route above (the main stage); 0 gathers x from global memory,
// with the same stream and y in shared memory; 1 stages each strip per
// block (block_x); 2, 4 and 8 share it across a cluster of that many
// blocks (the same group, consecutive chunks: a different cluster from
// the main stage's) by multicast, each block copying 1/C of it with
// .multicast::cluster into all of them.  Stages 0-8 write partials and
// launch group_sum_kernel at G > 1.
//
// The epilogues (template E, instantiated for the main stage and block_x,
// SEG = kScan only): kStore writes y (or, in the previous design, a
// group's partial of it); kXHalf and kYHalf replace y's write by one HPR
// half-update of each row given its sum, with csrc/hpr_half.cuh's rounding
// rules (each operation rounded once, NaN taken as torch.clamp and
// torch.maximum take it), so a fused half is bitwise the kStore launch
// followed by PyTorch's elementwise ops.  half_epilogue_kernel<T, E> is
// group_sum_kernel's pass at G = 1 on a given y: the column-sharded mesh's
// epilogue, after the all-reduce of the ranks' partial products, launched
// under a name of its own so that a profile tells it from the SpMV.  sigma
// (or lambda * sigma) is a 0-dim device tensor and the Halpern counter is
// read from device memory as inner + t, t baked in at launch, so a
// captured CUDA graph replays it unchanged.
//
// The segsum study (template SEG, float and stage 1 only; launched by
// ops/spmv_variants.py::spmv_segsum, never by a solve; SEG = 0 is the
// solve's scan) replaces prof_kernel_variants.py:39/:121 (pallas_call
// :152), which asks whether a row sum done as a one-hot matrix product can
// replace the kernel's own reduction.  Every variant asks it of this
// layout: the same stream, strips and row ownership, y in shared memory,
// the segmented warp scan replaced by tensor-core products, no atomics.
// A warp step's 128 entries are 8 sub-blocks of 16 (lanes 4q .. 4q + 3);
// an entry's rank is the number of distinct rows before it in its
// sub-block (< 16: its rows are sorted), and one mma.sync m16n8k16 (bf16
// in, f32 accumulate) per sub-block forms C = R P with R[r][k] = [rank_k
// == r] (exact in bf16) and P's columns the bf16 terms of each product.
// Row r's sum is C's row r summed over the terms, added once into y in
// shared memory at the row its rank maps to.  Each lane stages its
// entries' terms as B fragments in shared memory, from which every
// sub-block's mma reads them.
//   1 full        three terms hi, mid, lo (hi + mid + lo is the f32
//                 product exactly); ranks found by a scan over each
//                 sub-block's 4 lanes and staged with the rows they start
//                 (18 KB a block); (C[r][0] + C[r][1]) + C[r][2]
//   2 mm_precomp  two terms hi + lo (~2^-16 relative); R built outside the
//                 kernel (segsum_rtiles: each sub-block's 16 four-bit ranks
//                 in A-fragment order, 8 B, and its rank-to-row table, 32
//                 B, laid out by warp step), read by each lane straight
//                 into its A fragment one step ahead: no rank scan, no
//                 staged ranks or rows (8 KB a block)
//   3 mm_hi1      one term hi, ranks as full's (lossy; timing only)
//   4 mm_fused    one product per step: 16 mma.sync m16n8k8 (TF32 hi + lo
//                 in B's columns 0, 1) into one accumulator, each entry's
//                 rank its row less the step's first row, clamped to 15,
//                 and one flush per step (wrong where a step spans more
//                 than 16 rows; timing only)

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

#include "hpr_half.cuh"

namespace {

constexpr int kWarps = 16;                    // ops/tiles.py WARPS
constexpr int kThreads = kWarps * 32;
constexpr int kDepth = 4;                     // steps in flight per warp
constexpr int kMaxSmem = 232448;              // ops/tiles.py SMEM_BYTES
constexpr int kMaxGroups = 8;                 // ops/tiles.py MAX_GROUPS
constexpr int kGroupStage = -1;               // the main stage's code
constexpr int kRowsAhead = 4;                 // a half's rows in flight
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

// The same barrier without memory ordering: every thread of the cluster
// has arrived, nothing more (prior stores need not be visible).
__device__ __forceinline__ void cluster_sync_relaxed() {
  asm volatile(
      "barrier.cluster.arrive.relaxed.aligned;\n"
      "barrier.cluster.wait.aligned;\n" ::
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

// The segsum study's variants (template SEG; see the note at the top).
enum Seg : int { kScan = 0, kSegFull = 1, kSegPrecomp = 2, kSegHi1 = 3,
                 kSegFused = 4 };

// The bf16 terms a variant splits each product into (B's columns).
template <int SEG>
constexpr int kSegTerms = SEG == kSegFull ? 3 : SEG == kSegPrecomp ? 2 : 1;

// Each warp's segsum staging in shared memory.  full, mm_precomp, mm_hi1:
// each sub-block's mma B fragments (8 sub-blocks x terms x 4 lanes of two
// bf16x2 registers); full and mm_hi1 also its entries' ranks (8 x 4 lanes
// of four 4-bit ranks) and its rank-to-row table (8 x 16 rows).  mm_fused:
// the step's 128 TF32 hi and lo terms and their clamped ranks (bytes).
template <int SEG>
constexpr int kSegWarpBytes =
    SEG == kScan ? 0
    : SEG == kSegFused ? 128 * 4 * 2 + 128
    : 8 * kSegTerms<SEG> * 4 * 8 +
          (SEG == kSegPrecomp ? 0 : 8 * 4 * 4 + 8 * 16 * 2);
template <int SEG>
constexpr int kSegsumBytes = kWarps * kSegWarpBytes<SEG>;

// mm_precomp's R, built outside the kernel (ops/spmv_variants.py::
// segsum_rtiles), by warp step, the steps numbered run by run (step0[run]:
// a run's first step, indexed as runs).  ranks[step][t]: 16 bytes, the
// 16-bit word t of each of the step's 8 sub-blocks (q = 0 .. 7), which
// holds the ranks of the sub-block's entries 4t .. 4t + 3 (the mma's k =
// 2t, 2t + 1, 2t + 8, 2t + 9), four bits each from the lowest; rows[step]
// [g]: 32 bytes, for each sub-block q the rows (in the chunk) of ranks g
// and g + 8, kSentinelRow where no entry has the rank.  So lane 4g + t
// takes its fragment data in one 16-byte load, and lane 4g its rows in
// two.
struct SegTiles {
  const uint4* ranks;
  const uint4* rows;
  const int* step0;
};

// One step's R for mm_precomp, as this lane needs it, and how many of the
// step's sub-blocks hold entries.
struct PreR {
  uint4 rk;
  uint4 row[2];
  int nsub;
};

__device__ __forceinline__ PreR load_pre(const SegTiles& rt, int step,
                                         int nsub, int lane) {
  const int t = lane & 3, g = lane >> 2;
  PreR r;
  r.nsub = nsub;
  r.rk = __ldg(rt.ranks + 4 * step + t);
  r.row[0] = r.row[1] = make_uint4(0, 0, 0, 0);
  if (t == 0) {
    r.row[0] = __ldg(rt.rows + 2 * (8 * step + g));
    r.row[1] = __ldg(rt.rows + 2 * (8 * step + g) + 1);
  }
  return r;
}

// Component i of v.
__device__ __forceinline__ uint32_t lane_of(const uint4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

__device__ __forceinline__ uint32_t bf16_bits(float v) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(v));
}

// TF32 rounding of v (to nearest, ties away from zero), in f32 layout.
__device__ __forceinline__ uint32_t tf32_bits(float v) {
  return (__float_as_uint(v) + 0x1000u) & 0xffffe000u;
}

// C += A B for A 16x16 (row), B 16x8 (col), bf16 in, f32 accumulate.
// Lane 4g + t: a0 = A[g][2t..2t+1], a1 = A[g+8][2t..], a2 = A[g][2t+8..],
// a3 = A[g+8][2t+8..]; b0 = B[2t..2t+1][g], b1 = B[2t+8..2t+9][g]; c =
// C[g][2t], C[g][2t+1], C[g+8][2t], C[g+8][2t+1]; the lower index in the
// low half of a register.
__device__ __forceinline__ void mma_bf16_k16(float (&c)[4], uint32_t a0,
                                             uint32_t a1, uint32_t a2,
                                             uint32_t a3, uint32_t b0,
                                             uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// C += A B for A 16x8 (row), B 8x8 (col), TF32 in, f32 accumulate.  Lane
// 4g + t: a = A[g][t], A[g+8][t], A[g][t+4], A[g+8][t+4]; b = B[t][g],
// B[t+4][g]; c as for mma_bf16_k16.
__device__ __forceinline__ void mma_tf32(float (&c)[4], uint32_t a0,
                                         uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// Sum one step into ys by one-hot bf16 tensor-core products: full,
// mm_precomp or mm_hi1 (see the note at the top).  Lane 4q + t holds
// entries 4t .. 4t + 3 of sub-block q, which are the mma's k = 2t, 2t + 1,
// 2t + 8, 2t + 9: it stages their bf16 terms as the B fragments of columns
// 0 .. NT - 1, and (full, mm_hi1) their ranks and the rows its ranks
// start; mm_precomp takes both from `pre`, the step's R loaded ahead.
// Then every sub-block's product reads its fragments back.
template <int SEG>
__device__ __forceinline__ void onehot_step(const Step<float>& st,
                                            const float* xs, float* ys,
                                            unsigned char* stage,
                                            const PreR& pre, int lane) {
  constexpr unsigned kFull = 0xffffffffu;
  constexpr uint32_t kOne = 0x3f80u;  // 1.0 in bf16
  constexpr int NT = kSegTerms<SEG>;
  const int t = lane & 3, q_own = lane >> 2;
  const uint32_t g = static_cast<uint32_t>(lane >> 2);
  uint2* frags = reinterpret_cast<uint2*>(stage);
  uint32_t* ranks = reinterpret_cast<uint32_t*>(stage + 8 * NT * 4 * 8);
  uint16_t* rows = reinterpret_cast<uint16_t*>(stage + 8 * NT * 4 * 8 +
                                               8 * 4 * 4);
  uint32_t r[4], term[NT][4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    r[j] = st.k[j] >> 16;
    // hi, then (full, mm_precomp) the bf16 of the rest, then (full) the
    // bf16 of what is left: hi + mid + lo is the f32 product exactly.
    const float p = __fmul_rn(st.v[j], xs[st.k[j] & 0xFFFFu]);
    term[0][j] = bf16_bits(p);
    if constexpr (NT >= 2) {
      const float r1 = __fadd_rn(p, -__uint_as_float(term[0][j] << 16));
      term[1][j] = bf16_bits(r1);
      if constexpr (NT == 3) {
        term[2][j] =
            bf16_bits(__fadd_rn(r1, -__uint_as_float(term[1][j] << 16)));
      }
    }
  }
#pragma unroll
  for (int c = 0; c < NT; ++c) {
    frags[(q_own * NT + c) * 4 + t] =
        make_uint2(term[c][0] | (term[c][1] << 16),
                   term[c][2] | (term[c][3] << 16));
  }
  int nranks = 0;
  if constexpr (SEG != kSegPrecomp) {
    // Ranks within the sub-block of lanes 4q .. 4q + 3 (rows are sorted).
    const uint32_t left = __shfl_up_sync(kFull, r[3], 1, 4);
    int cnt[4];
    cnt[0] = t > 0 && r[0] != left;
#pragma unroll
    for (int j = 1; j < 4; ++j) cnt[j] = cnt[j - 1] + (r[j] != r[j - 1]);
    int incl = cnt[3];
#pragma unroll
    for (int d = 1; d < 4; d <<= 1) {
      const int o = __shfl_up_sync(kFull, incl, d, 4);
      if (t >= d) incl += o;
    }
    const int off = incl - cnt[3];
    uint32_t rank4 = 0;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int rk = off + cnt[j];
      rank4 |= static_cast<uint32_t>(rk) << (4 * j);
      const bool start = j == 0 ? (t == 0 || r[0] != left) : r[j] != r[j - 1];
      if (start) rows[q_own * 16 + rk] = static_cast<uint16_t>(r[j]);
    }
    ranks[q_own * 4 + t] = rank4;
    nranks = __shfl_sync(kFull, incl, lane | 3) + 1;
  }
  __syncwarp();
#pragma unroll
  for (int q = 0; q < 8; ++q) {
    if (SEG == kSegPrecomp && q >= pre.nsub) break;  // warp-uniform
    const uint32_t rk =
        SEG == kSegPrecomp
            ? (lane_of(pre.rk, q / 2) >> (16 * (q % 2))) & 0xFFFFu
            : ranks[q * 4 + t];
    uint32_t a[4];
#pragma unroll
    for (int h = 0; h < 2; ++h) {  // h = 0: entries 2t, 2t+1; 1: 2t+8, 2t+9
      const uint32_t k0 = (rk >> (8 * h)) & 15, k1 = (rk >> (8 * h + 4)) & 15;
      a[2 * h] = (k0 == g ? kOne : 0u) | ((k1 == g ? kOne : 0u) << 16);
      a[2 * h + 1] = (k0 == g + 8 ? kOne : 0u) |
                     ((k1 == g + 8 ? kOne : 0u) << 16);
    }
    const uint2 b = g < NT ? frags[(q * NT + g) * 4 + t] : make_uint2(0, 0);
    float c[4] = {0.f, 0.f, 0.f, 0.f};
    // a[0], a[1]: rows g, g + 8 at entries 2t, 2t + 1; a[2], a[3]: the
    // same rows at entries 2t + 8, 2t + 9 (the fragment order above).
    mma_bf16_k16(c, a[0], a[1], a[2], a[3], b.x, b.y);
    // Lane 4g holds columns 0 and 1 of ranks g and g + 8; lane 4g + 1
    // holds column 2 (full's lo).
    float s0 = c[0], s8 = c[2];
    if constexpr (NT == 3) {
      const float lo0 = __shfl_down_sync(kFull, c[0], 1);
      const float lo2 = __shfl_down_sync(kFull, c[2], 1);
      s0 = __fadd_rn(__fadd_rn(c[0], c[1]), lo0);
      s8 = __fadd_rn(__fadd_rn(c[2], c[3]), lo2);
    } else if constexpr (NT == 2) {
      s0 = __fadd_rn(c[0], c[1]);
      s8 = __fadd_rn(c[2], c[3]);
    }
    if constexpr (SEG == kSegPrecomp) {
      // Ranks no entry has map to the padding row, which add_row skips.
      if (t == 0) {
        const uint32_t rows2 = lane_of(pre.row[q / 4], q % 4);
        add_row(ys, rows2 & 0xFFFFu, s0);
        add_row(ys, rows2 >> 16, s8);
      }
    } else {
      const int nq = __shfl_sync(kFull, nranks, 4 * q);
      if (t == 0) {
        if (static_cast<int>(g) < nq) add_row(ys, rows[q * 16 + g], s0);
        if (static_cast<int>(g) + 8 < nq) add_row(ys, rows[q * 16 + g + 8], s8);
      }
    }
    __syncwarp();  // a row in the next sub-block adds after this one
  }
}

// mm_fused: one product for the whole step (128 entries, 16 m16n8k8 TF32
// products into one accumulator), each entry's rank its row less the
// step's first row, clamped to 15, and the products as TF32 hi + lo (B's
// columns 0, 1).  Entry 8j + k of the step (lane 2j + k / 4, entry k % 4)
// is k-block j's k.  One flush per step, into the step's first row plus
// each rank up to its last row: an entry more than 15 rows past the first
// goes to row first + 15 (wrong; timing only), a row this warp owns.
__device__ __forceinline__ void fused_step(const Step<float>& st,
                                           const float* xs, float* ys,
                                           unsigned char* stage, int lane) {
  constexpr unsigned kFull = 0xffffffffu;
  constexpr uint32_t kOne = 0x3f800000u;  // 1.0, exact in TF32
  uint32_t* hi = reinterpret_cast<uint32_t*>(stage);
  uint32_t* lo = hi + 128;
  uint8_t* rank = reinterpret_cast<uint8_t*>(lo + 128);
  const int t = lane & 3;
  const uint32_t g = static_cast<uint32_t>(lane >> 2);
  const uint32_t first = __shfl_sync(kFull, st.k[0] >> 16, 0);
  int last = -1;  // this lane's last real row
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const uint32_t row = st.k[j] >> 16;
    const float p = __fmul_rn(st.v[j], xs[st.k[j] & 0xFFFFu]);
    const uint32_t h = tf32_bits(p);
    hi[4 * lane + j] = h;
    lo[4 * lane + j] = tf32_bits(__fadd_rn(p, -__uint_as_float(h)));
    rank[4 * lane + j] = static_cast<uint8_t>(min(row - first, 15u));
    if (row != kSentinelRow) last = static_cast<int>(row);
  }
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) {
    last = max(last, __shfl_xor_sync(kFull, last, d));
  }
  __syncwarp();
  float c[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int e0 = 8 * j + t, e1 = e0 + 4;
    const uint32_t r0 = rank[e0], r1 = rank[e1];
    const uint32_t b0 = g == 0 ? hi[e0] : g == 1 ? lo[e0] : 0u;
    const uint32_t b1 = g == 0 ? hi[e1] : g == 1 ? lo[e1] : 0u;
    mma_tf32(c, r0 == g ? kOne : 0u, r0 == g + 8 ? kOne : 0u,
             r1 == g ? kOne : 0u, r1 == g + 8 ? kOne : 0u, b0, b1);
  }
  if (t == 0 && last >= 0) {
    const int top = min(last - static_cast<int>(first), 15);
    if (static_cast<int>(g) <= top) {
      add_row(ys, first + g, __fadd_rn(c[0], c[1]));
    }
    if (static_cast<int>(g) + 8 <= top) {
      add_row(ys, first + g + 8, __fadd_rn(c[2], c[3]));
    }
  }
  __syncwarp();  // the staging is the next step's
}

// The row writes (template E; see the note at the top).
enum Epilogue : int { kStore = 0, kXHalf = 1, kYHalf = 2 };

// A fused half's operands, each (nrows,) but scal (0-dim) and inner (0-dim
// int32); null pointers for kStore.  out: x_new (y_new); hat: x_hat
// (x-half only); cur, last: x and last_x (y and last_y); p0, p1, p2: c, l
// and u (AL and AU; no p2); scal: sigma (lambda sigma); the Halpern counter
// is *inner + t.
struct Half {
  void* out;
  void* hat;
  const void *cur, *last, *p0, *p1, *p2, *scal;
  const int* inner;
  int t;
};

// The half's scalar and Halpern factor f1, read once per thread.
template <typename T>
struct HalfScalars {
  T s, f1;
};

template <typename T>
__device__ __forceinline__ HalfScalars<T> half_scalars(const Half& h) {
  return {*static_cast<const T*>(h.scal),
          hprlp::halpern_f1<T>(*h.inner + h.t)};
}

// A row's operands of a half (p2: the x-half's u only).
template <typename T>
struct HalfRow {
  T cur, last, p0, p1, p2;
};

template <typename T, int E>
__device__ __forceinline__ HalfRow<T> load_half_row(const Half& h,
                                                    int64_t row) {
  HalfRow<T> o;
  o.cur = static_cast<const T*>(h.cur)[row];
  o.last = static_cast<const T*>(h.last)[row];
  o.p0 = static_cast<const T*>(h.p0)[row];
  o.p1 = static_cast<const T*>(h.p1)[row];
  o.p2 = E == kXHalf ? static_cast<const T*>(h.p2)[row] : T(0);
  return o;
}

// Row `row`'s half-update given its sum and operands: x_new and x_hat, or
// y_new.
template <typename T, int E>
__device__ __forceinline__ void store_half_row(const Half& h, int64_t row,
                                               T sum, const HalfRow<T>& o,
                                               const HalfScalars<T>& k) {
  if constexpr (E == kXHalf) {
    T xh;
    static_cast<T*>(h.out)[row] = hprlp::x_half_update(
        sum, o.cur, o.last, o.p0, o.p1, o.p2, k.s, k.f1, xh);
    static_cast<T*>(h.hat)[row] = xh;
  } else {
    static_assert(E == kYHalf, "a half is kXHalf or kYHalf");
    static_cast<T*>(h.out)[row] =
        hprlp::y_half_update(sum, o.cur, o.last, o.p0, o.p1, k.s, k.f1);
  }
}

template <typename T, int E>
__device__ __forceinline__ void write_half(const Half& h, int64_t row, T sum,
                                           const HalfScalars<T>& k) {
  store_half_row<T, E>(h, row, sum, load_half_row<T, E>(h, row), k);
}

// A block's chunk of y in shared memory once its strips are summed: ys
// (the same offset in every block of a launch), the chunk's first row and
// its row count.
template <typename T>
struct ChunkSums {
  T* ys;
  int row0, nrows;
};

// Block (g, c)'s sums: strip group g of row chunk c summed into its rows
// of y in shared memory.  b is the layout's block number g * C + c, which
// indexes the runs.  Ends after a block-local barrier: ys is complete in
// this block.
template <typename T, int CLUSTER, int SEG>
__device__ __forceinline__ ChunkSums<T> block_sums(
    unsigned char* smem, int g, int c, int b, int ncols, int W, int K,
    int Kg, int max_rows, const T* __restrict__ vals,
    const uint32_t* __restrict__ keys, const int* __restrict__ runs,
    const int* __restrict__ row_start, const T* __restrict__ x,
    const SegTiles& rt) {
  constexpr bool kStaged = CLUSTER > 0;
  // Shared memory: nbuf x strips of W entries, y of the largest chunk
  // (rounded up to 16 bytes), two mbarriers -- the same offsets in every
  // block, as multicast and the cluster's sum need.
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int s0 = g * Kg;  // strips s0 .. s0 + nstrips - 1
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
  // This warp's segsum staging, after the mbarriers.
  unsigned char* stage = reinterpret_cast<unsigned char*>(bar + 2) +
                         warp * kSegWarpBytes<SEG>;

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
  const int64_t my_run0 = (static_cast<int64_t>(b) * kWarps + warp) * Kg;
  const int* my_runs = runs + my_run0;
  Cursor next{0, static_cast<uint32_t>(my_runs[0]),
              static_cast<uint32_t>(my_runs[1])};
  settle(next, my_runs, Kg);
  Slot<T> ring[kDepth];
#pragma unroll
  for (int i = 0; i < kDepth; ++i) ring[i] = next_slot(next, vals, keys, my_runs, Kg, lane);
  // mm_precomp: this step's R and the next step's, loaded ahead.
  PreR cur{}, next_pre{};
  bool have_next = false;

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
    // mm_precomp: the step's number and the run's entries left from the
    // step on.
    int step = 0, left = 0;
    if constexpr (SEG == kSegPrecomp) {
      step = __ldg(rt.step0 + my_run0 + l);
      left = my_runs[l + 1] - my_runs[l];
    }
    while (ring[0].s == l) {
      const Step<T> st = ring[0].st;
#pragma unroll
      for (int i = 0; i + 1 < kDepth; ++i) ring[i] = ring[i + 1];
      ring[kDepth - 1] = next_slot(next, vals, keys, my_runs, Kg, lane);
      if constexpr (SEG == kScan) {
        sum_step<T, CLUSTER>(st, xbuf, xg, ys, carry_row, carry, lane);
      } else if constexpr (SEG == kSegFused) {
        fused_step(st, xbuf, ys, stage, lane);
      } else {
        if constexpr (SEG == kSegPrecomp) {
          // This step's R (loaded one step ahead where it could be), and
          // the next step's: in this run, else the next strip's.
          cur = have_next ? next_pre
                          : load_pre(rt, step, min(8, (left + 15) / 16), lane);
          have_next = true;
          if (left > 128) {
            next_pre = load_pre(rt, step + 1, min(8, (left - 113) / 16), lane);
          } else if (l + 1 < nstrips && my_runs[l + 2] > my_runs[l + 1]) {
            next_pre = load_pre(rt, __ldg(rt.step0 + my_run0 + l + 1),
                                min(8, (my_runs[l + 2] - my_runs[l + 1] + 15)
                                           / 16), lane);
          } else {
            have_next = false;
          }
        }
        onehot_step<SEG>(st, xbuf, ys, stage, cur, lane);
        ++step;
        left -= 128;
      }
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
  return {ys, row0, nrows_b};
}

// The previous design and the measurement stages: block b = g * C + c
// (1-D grid) writes its chunk's y, or with several groups its partial of
// it, or (G = 1 only) each row's half-update in place of its store.
template <typename T, int CLUSTER, int SEG = kScan, int E = kStore>
__global__ void __launch_bounds__(kThreads, 1)
tiled_spmv_kernel(int nrows, int ncols, int W, int K, int Kg, int C,
                  int max_rows, const T* __restrict__ vals,
                  const uint32_t* __restrict__ keys,
                  const int* __restrict__ runs,
                  const int* __restrict__ row_start,
                  const T* __restrict__ x, T* __restrict__ out,
                  const SegTiles rt, const Half h) {
  static_assert(E == kStore || (CLUSTER == 1 && SEG == kScan),
                "the halves are fused into block_x and the main stage only");
  extern __shared__ __align__(128) unsigned char smem[];
  const int b = blockIdx.x;
  const int g = b / C;  // strip group
  const int c = b % C;  // row chunk
  const ChunkSums<T> k = block_sums<T, CLUSTER, SEG>(
      smem, g, c, b, ncols, W, K, Kg, max_rows, vals, keys, runs, row_start,
      x, rt);
  if constexpr (E == kStore) {
    T* dst = out + static_cast<int64_t>(g) * nrows + k.row0;
    for (int i = threadIdx.x; i < k.nrows; i += kThreads) dst[i] = k.ys[i];
  } else {
    const HalfScalars<T> hs = half_scalars<T>(h);
    for (int i = threadIdx.x; i < k.nrows; i += kThreads) {
      write_half<T, E>(h, k.row0 + i, k.ys[i], hs);
    }
  }
}

// The main stage: grid (G, C), the G blocks of row chunk c one cluster;
// y (or each row's half-update) from the G partials summed through
// distributed shared memory in group order (see the note at the top).
template <typename T, int E>
__global__ void __launch_bounds__(kThreads, 1)
tiled_cluster_kernel(int ncols, int W, int K, int Kg, int C, int max_rows,
                     const T* __restrict__ vals,
                     const uint32_t* __restrict__ keys,
                     const int* __restrict__ runs,
                     const int* __restrict__ row_start,
                     const T* __restrict__ x, T* __restrict__ y,
                     const Half h) {
  extern __shared__ __align__(128) unsigned char smem[];
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  const int G = static_cast<int>(gridDim.x);  // the cluster's size
  const int g = static_cast<int>(cluster_rank());
  const int c = static_cast<int>(blockIdx.y);
  const ChunkSums<T> k = block_sums<T, 1, kScan>(
      smem, g, c, g * C + c, ncols, W, K, Kg, max_rows, vals, keys, runs,
      row_start, x, SegTiles{});
  // Every rank's partial complete and visible to the cluster.
  cluster_sync();
  const T* peer[kMaxGroups];  // this block's own partial read directly
#pragma unroll
  for (int r = 0; r < kMaxGroups; ++r) {
    peer[r] = r < G && r != g ? cluster.map_shared_rank(k.ys, r) : k.ys;
  }
  // Rank g's rows: a share of whole 16-byte vectors (V rows) from row
  // g * share, so that each peer read is one 16-byte load.  Only rank g
  // reads these rows of any block, so it keeps their sums in its own ys.
  constexpr int V = Vec<T>::n;
  using VT = typename Vec<T>::V;
  const int share = ((k.nrows + G - 1) / G + V - 1) / V * V;
  const int i0 = min(k.nrows, g * share);
  const int i1 = min(k.nrows, i0 + share);
  const int nvec = (i1 - i0) / V;
  for (int j = static_cast<int>(threadIdx.x); j < nvec; j += kThreads) {
    const int i = i0 + j * V;
    // All G loads in flight, then each row's sum in group order, as
    // group_rows takes it (part[0], then += part[r]).
    VT part[kMaxGroups];
#pragma unroll
    for (int r = 0; r < kMaxGroups; ++r) {
      if (r < G) part[r] = *reinterpret_cast<const VT*>(peer[r] + i);
    }
    T* sum = reinterpret_cast<T*>(&part[0]);
#pragma unroll
    for (int r = 1; r < kMaxGroups; ++r) {
      if (r < G) {
#pragma unroll
        for (int q = 0; q < V; ++q) {
          sum[q] += reinterpret_cast<const T*>(&part[r])[q];
        }
      }
    }
    *reinterpret_cast<VT*>(k.ys + i) = part[0];
  }
  // The chunk's last rows, short of a whole vector (the last rank's).
  for (int i = i0 + nvec * V + static_cast<int>(threadIdx.x); i < i1;
       i += kThreads) {
    T sum = peer[0][i];
    for (int r = 1; r < G; ++r) sum += peer[r][i];
    k.ys[i] = sum;
  }
  __syncthreads();  // the share's sums in ys
  // y, or each row's half-update, one row a thread: coalesced as the
  // group-sum pass's.  A half's operands of kRowsAhead rows a thread are
  // loaded before any of their updates is stored (the stores may alias
  // the operands for all the compiler knows, so it would not hoist them).
  if constexpr (E == kStore) {
    for (int i = i0 + static_cast<int>(threadIdx.x); i < i1; i += kThreads) {
      y[k.row0 + i] = k.ys[i];
    }
  } else {
    const HalfScalars<T> hs = half_scalars<T>(h);
    for (int i = i0 + static_cast<int>(threadIdx.x); i < i1;
         i += kRowsAhead * kThreads) {
      HalfRow<T> o[kRowsAhead];
#pragma unroll
      for (int u = 0; u < kRowsAhead; ++u) {
        const int r = i + u * kThreads;
        if (r < i1) o[u] = load_half_row<T, E>(h, k.row0 + r);
      }
#pragma unroll
      for (int u = 0; u < kRowsAhead; ++u) {
        const int r = i + u * kThreads;
        if (r < i1) store_half_row<T, E>(h, k.row0 + r, k.ys[r], o[u], hs);
      }
    }
  }
  // No block's shared memory goes while a peer still reads it: a peer
  // arrives after its reads have returned (its stores use them), so the
  // barrier orders nothing else and need not wait for y's stores.
  cluster_sync_relaxed();
}

// y = the G partials summed in group order (the fixed order that keeps y
// bitwise reproducible; no atomics), or each row's half-update given that
// sum.
template <typename T, int E>
__device__ __forceinline__ void group_rows(int G, int nrows,
                                           const T* __restrict__ part,
                                           T* __restrict__ y, const Half& h) {
  HalfScalars<T> k{};
  if constexpr (E != kStore) k = half_scalars<T>(h);
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < nrows; i += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    T sum = part[i];
    for (int g = 1; g < G; ++g) sum += part[static_cast<int64_t>(g) * nrows + i];
    if constexpr (E == kStore) {
      y[i] = sum;
    } else {
      write_half<T, E>(h, i, sum, k);
    }
  }
}

template <typename T, int E>
__global__ void __launch_bounds__(256)
group_sum_kernel(int G, int nrows, const T* __restrict__ part,
                 T* __restrict__ y, const Half h) {
  group_rows<T, E>(G, nrows, part, y, h);
}

// The column-sharded mesh's epilogue: group_rows at G = 1 on the
// all-reduced y (see the note at the top).
template <typename T, int E>
__global__ void __launch_bounds__(256)
half_epilogue_kernel(int nrows, const T* __restrict__ y, const Half h) {
  group_rows<T, E>(1, nrows, y, nullptr, h);
}

// Blocks of 256 threads for a pass over n rows: one per 256 rows, at most
// 8 per SM.
int row_pass_grid(int64_t n) {
  return static_cast<int>(std::min<int64_t>((n + 255) / 256, 132 * 8));
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
  int nrows, ncols, W, K, G, Kg, C, live, max_rows;
  const void *vals, *keys, *runs, *row_start, *x;
  void *part, *y;
  SegTiles rt;  // mm_precomp's R; null pointers for every other launch
  Half h;       // a fused half's operands; null pointers for kStore
};

// Whether h holds every operand epilogue E reads and writes.
template <int E>
bool half_complete(const Half& h) {
  if constexpr (E == kStore) {
    return true;
  } else {
    return h.out && h.cur && h.last && h.p0 && h.p1 && h.scal && h.inner &&
           (E == kYHalf || (h.hat && h.p2));
  }
}

template <typename T, int CLUSTER, int SEG = kScan, int E = kStore>
int launch_stage(const Args& a, cudaStream_t stream) {
  const size_t smem = smem_bytes<T>(CLUSTER, a.W, a.Kg, a.max_rows) +
                      kSegsumBytes<SEG>;
  const int nblocks = a.G * a.C;
  if (smem > static_cast<size_t>(kMaxSmem) ||
      a.C % (CLUSTER > 1 ? CLUSTER : 1) || (a.G > 1 && !a.part) ||
      !half_complete<E>(a.h)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = config<T, CLUSTER>(nblocks, smem, stream,
                                                    &attr);
  T* out = static_cast<T*>(a.G > 1 ? a.part : a.y);
  // With G > 1 the blocks store their partials and the half, if any, runs
  // on their sum.
  const auto kernel = a.G > 1 ? &tiled_spmv_kernel<T, CLUSTER, SEG, kStore>
                              : &tiled_spmv_kernel<T, CLUSTER, SEG, E>;
  cudaError_t err = cudaLaunchKernelEx(
      &cfg, kernel, a.nrows, a.ncols, a.W, a.K, a.Kg, a.C, a.max_rows,
      static_cast<const T*>(a.vals), static_cast<const uint32_t*>(a.keys),
      static_cast<const int*>(a.runs), static_cast<const int*>(a.row_start),
      static_cast<const T*>(a.x), out, a.rt, a.h);
  if (err == cudaSuccess) err = cudaGetLastError();
  if (err == cudaSuccess && a.G > 1) {
    group_sum_kernel<T, E><<<row_pass_grid(a.nrows), 256, 0, stream>>>(
        a.G, a.nrows, out, static_cast<T*>(a.y), a.h);
    err = cudaGetLastError();
  } else {
    cudaGetLastError();  // clear a launch error that err already holds
  }
  return static_cast<int>(err);
}

// The main stage's launch: grid (G, C), one cluster of the G blocks of
// each row chunk.
cudaLaunchConfig_t group_config(int G, int C, size_t smem,
                                cudaStream_t stream,
                                cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(G, C);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = G;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// The main stage: no partials, no second pass; blocks for the first
// `live` chunks only (the rest are empty padding, whose blocks would wait
// for a free SM).  G > 1: a cluster per chunk; G = 1: the block kernel
// (see the note at the top).  Clusters above the portable kMaxGroups are
// refused here; a cluster size the card refuses fails the launch; either
// error is returned.
template <typename T, int E>
int launch_group(const Args& a, cudaStream_t stream) {
  const size_t smem = smem_bytes<T>(1, a.W, a.Kg, a.max_rows);
  if (a.G > kMaxGroups || smem > static_cast<size_t>(kMaxSmem) ||
      a.live < 1 || a.live > a.C ||
      a.live > 65535 || (E == kStore && !a.y) || !half_complete<E>(a.h)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaLaunchAttribute attr;
  cudaError_t err;
  if (a.G == 1) {
    const cudaLaunchConfig_t cfg = config<T, 1>(a.live, smem, stream, &attr);
    err = cudaLaunchKernelEx(
        &cfg, tiled_spmv_kernel<T, 1, kScan, E>, a.nrows, a.ncols, a.W, a.K,
        a.Kg, a.C, a.max_rows, static_cast<const T*>(a.vals),
        static_cast<const uint32_t*>(a.keys),
        static_cast<const int*>(a.runs),
        static_cast<const int*>(a.row_start), static_cast<const T*>(a.x),
        static_cast<T*>(a.y), SegTiles{}, a.h);
  } else {
    const cudaLaunchConfig_t cfg = group_config(a.G, a.live, smem, stream,
                                                &attr);
    err = cudaLaunchKernelEx(
        &cfg, tiled_cluster_kernel<T, E>, a.ncols, a.W, a.K, a.Kg, a.C,
        a.max_rows, static_cast<const T*>(a.vals),
        static_cast<const uint32_t*>(a.keys),
        static_cast<const int*>(a.runs),
        static_cast<const int*>(a.row_start), static_cast<const T*>(a.x),
        static_cast<T*>(a.y), a.h);
  }
  if (err == cudaSuccess) {
    err = cudaGetLastError();
  } else {
    cudaGetLastError();  // clear a launch error that err already holds
  }
  return static_cast<int>(err);
}

// How many clusters of the main stage's G blocks can be resident at once
// at the given dynamic shared memory; -error on failure (a cluster size
// the card refuses).
template <typename T>
int active_group_clusters(int G, int smem) {
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = group_config(G, 1, smem, nullptr, &attr);
  int n = 0;
  const cudaError_t err = cudaOccupancyMaxActiveClusters(
      &n, tiled_cluster_kernel<T, kStore>, &cfg);
  if (err != cudaSuccess) cudaGetLastError();
  return err == cudaSuccess ? n : -static_cast<int>(err);
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
    case kGroupStage: return launch_group<T, kStore>(a, s);
    case 0: return launch_stage<T, 0>(a, s);
    case 1: return launch_stage<T, 1>(a, s);
    case 2: return launch_stage<T, 2>(a, s);
    case 4: return launch_stage<T, 4>(a, s);
    case 8: return launch_stage<T, 8>(a, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// A fused half on the main stage or on block_x (the previous design), the
// two stages instantiated with the halves.
template <typename T>
int launch_half(int epilogue, int cluster, const Args& a, void* stream) {
  if ((cluster != kGroupStage && cluster != 1) ||
      (epilogue != kXHalf && epilogue != kYHalf)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (a.G * a.C <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (cluster == kGroupStage) {
    return epilogue == kXHalf ? launch_group<T, kXHalf>(a, s)
                              : launch_group<T, kYHalf>(a, s);
  }
  return epilogue == kXHalf ? launch_stage<T, 1, kScan, kXHalf>(a, s)
                            : launch_stage<T, 1, kScan, kYHalf>(a, s);
}

template <typename T, int E>
int launch_epilogue(int nrows, const void* y, const Half& h,
                    cudaStream_t stream) {
  if (!y || !half_complete<E>(h)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  half_epilogue_kernel<T, E><<<row_pass_grid(nrows), 256, 0, stream>>>(
      nrows, static_cast<const T*>(y), h);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_epilogue(int epilogue, int nrows, const void* y, const Half& h,
                    void* stream) {
  if (nrows <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (epilogue) {
    case kXHalf: return launch_epilogue<T, kXHalf>(nrows, y, h, s);
    case kYHalf: return launch_epilogue<T, kYHalf>(nrows, y, h, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T>
int max_active(int cluster, int groups, int smem) {
  switch (cluster) {
    case kGroupStage: return active_group_clusters<T>(groups, smem);
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
      reinterpret_cast<const void*>(tiled_spmv_kernel<T, 8>),
      reinterpret_cast<const void*>(tiled_spmv_kernel<T, 1, kScan, kXHalf>),
      reinterpret_cast<const void*>(tiled_spmv_kernel<T, 1, kScan, kYHalf>),
      reinterpret_cast<const void*>(tiled_cluster_kernel<T, kStore>),
      reinterpret_cast<const void*>(tiled_cluster_kernel<T, kXHalf>),
      reinterpret_cast<const void*>(tiled_cluster_kernel<T, kYHalf>),
      reinterpret_cast<const void*>(tiled_spmv_kernel<float, 1, kSegFull>),
      reinterpret_cast<const void*>(tiled_spmv_kernel<float, 1, kSegPrecomp>),
      reinterpret_cast<const void*>(tiled_spmv_kernel<float, 1, kSegHi1>),
      reinterpret_cast<const void*>(tiled_spmv_kernel<float, 1, kSegFused>)};
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
// f64: 0 for float, 1 for double; cluster: the stage (-1: the main stage,
// a cluster of the G strip groups per row chunk; 0: x from global memory,
// 1: strips per block, 2/4/8: strips multicast to that many).  C is the
// tiles' chunk count and `live` how many of them hold rows (the rest are
// trailing padding, which the main stage launches no cluster for).  With
// G > 1 strip groups, stages 0-8 take G * nrows partials of y in `part`;
// the main stage takes none (null).
int hprlp_tiled_spmv(int f64, int cluster, int nrows, int ncols, int W,
                     int K, int G, int Kg, int C, int live, int max_rows,
                     const void* vals, const void* keys, const void* runs,
                     const void* row_start, const void* x, void* part,
                     void* y, void* stream) {
  const Args a{nrows, ncols, W, K, G, Kg, C, live, max_rows, vals, keys,
               runs, row_start, x, part, y, {}, {}};
  return f64 ? launch<double>(cluster, a, stream)
             : launch<float>(cluster, a, stream);
}

// One single-LP middle-iteration half fused into y = A x's row write on
// the tiles: `epilogue` 1 the x-half (out = x_new, hat = x_hat; cur, last,
// p0, p1, p2 = x, last_x, c, l, u), 2 the y-half (out = y_new; cur, last,
// p0, p1 = y, last_y, AL, AU; hat and p2 unread); scal: the 0-dim sigma
// (lambda sigma), inner: the 0-dim int32 Halpern counter at the first
// middle iteration, t this iteration's index.  The tile arguments as for
// hprlp_tiled_spmv at cluster -1 (the main stage) or 1 (block_x, the
// previous design, with G * nrows partials in `part` at G > 1); any other
// stage is refused.  Returns the launch's error code (0 on success).
int hprlp_tiled_half(int f64, int epilogue, int cluster, int nrows, int ncols,
                     int W, int K, int G, int Kg, int C, int live,
                     int max_rows,
                     const void* vals, const void* keys, const void* runs,
                     const void* row_start, const void* x, void* part,
                     void* out, void* hat, const void* cur, const void* last,
                     const void* p0, const void* p1, const void* p2,
                     const void* scal, const void* inner, int t,
                     void* stream) {
  const Half h{out, hat, cur, last, p0, p1, p2, scal,
               static_cast<const int*>(inner), t};
  const Args a{nrows, ncols, W, K, G, Kg, C, live, max_rows, vals, keys,
               runs, row_start, x, part, nullptr, {}, h};
  return f64 ? launch_half<double>(epilogue, cluster, a, stream)
             : launch_half<float>(epilogue, cluster, a, stream);
}

// The column-sharded mesh's epilogue: the half-update of each of nrows rows
// given its sum y[row] (the all-reduced partial products), the operands as
// for hprlp_tiled_half.  Returns the launch's error code (0 on success).
int hprlp_tiled_half_epilogue(int f64, int epilogue, int nrows, const void* y,
                              void* out, void* hat, const void* cur,
                              const void* last, const void* p0,
                              const void* p1, const void* p2,
                              const void* scal, const void* inner, int t,
                              void* stream) {
  const Half h{out, hat, cur, last, p0, p1, p2, scal,
               static_cast<const int*>(inner), t};
  return f64 ? launch_epilogue<double>(epilogue, nrows, y, h, stream)
             : launch_epilogue<float>(epilogue, nrows, y, h, stream);
}

// One variant of the segsum study (float, strips staged per block):
// `variant` 1 full, 2 mm_precomp, 3 mm_hi1, 4 mm_fused; the arguments as
// for hprlp_tiled_spmv, and for mm_precomp R's ranks, rows and step0 (see
// SegTiles; null for the others; ranks and rows 16-byte aligned).  Its shared memory is the stage's plus
// kSegsumBytes<variant>.  Returns cudaErrorInvalidValue for a variant it
// does not have, or mm_precomp without R.
int hprlp_tiled_segsum(int variant, int nrows, int ncols, int W, int K,
                       int G, int Kg, int C, int max_rows, const void* vals,
                       const void* keys, const void* runs,
                       const void* row_start, const void* x,
                       const void* rt_ranks, const void* rt_rows,
                       const void* rt_step0, void* part, void* y,
                       void* stream) {
  const Args a{nrows, ncols, W, K, G, Kg, C, C, max_rows, vals, keys,
               runs, row_start, x, part, y,
               {static_cast<const uint4*>(rt_ranks),
                static_cast<const uint4*>(rt_rows),
                static_cast<const int*>(rt_step0)},
               {}};
  if (variant == kSegPrecomp &&
      (!a.rt.ranks || !a.rt.rows || !a.rt.step0 ||
       (reinterpret_cast<uintptr_t>(rt_ranks) |
        reinterpret_cast<uintptr_t>(rt_rows)) % 16)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (a.G * a.C <= 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (variant) {
    case kSegFull: return launch_stage<float, 1, kSegFull>(a, s);
    case kSegPrecomp: return launch_stage<float, 1, kSegPrecomp>(a, s);
    case kSegHi1: return launch_stage<float, 1, kSegHi1>(a, s);
    case kSegFused: return launch_stage<float, 1, kSegFused>(a, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// How many clusters of a stage can be resident at once at the given
// dynamic shared memory (0 if none fits); -error on failure.  The main
// stage's clusters are of `groups` blocks (the tiles' G); the other
// stages ignore it.
int hprlp_tiled_max_active_clusters(int f64, int cluster, int groups,
                                    int smem) {
  return f64 ? max_active<double>(cluster, groups, smem)
             : max_active<float>(cluster, groups, smem);
}

const char* hprlp_tiled_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
