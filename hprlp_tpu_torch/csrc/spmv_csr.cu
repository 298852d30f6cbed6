// Row-block CSR SpMV for Hopper: y = A x over the padded row/column spaces
// of the solver's layout (the "gather" SpMV backend), and the single-LP HPR
// middle iteration's two half-updates fused into its row write.
//
// Replaces, as the "gather" backend, the four Pallas TPU kernels of
// hprlp_tpu/ops/pallas_spmv.py (lane_spmv, thin_spmv, lane_spmv_df64,
// thin_spmv_df64): the float instantiation accumulates in f32 as the f32
// kernels do, the double one in native f64 in place of hi/lo pairs.  It
// succeeds the row-group kernel of csrc/spmv.cu (the previous design, kept
// to be timed).  The fused halves replace the plain elementwise ops of
// solver/chunk.py::_x_half/_y_half (XLA fuses them in the JAX package,
// hprlp_tpu/solver/chunk.py).
//
// What bounds it: bytes.  Per nonzero its value (4 or 8 B) and its int32
// column index (4 B), read once, and one gathered x entry (4 or 8 B, from
// L2 while x fits its 50 MB); per row two indptr entries (4 B each, shared
// with the next row) and its y entry; per block two plan entries; the
// multiply-add per nonzero is negligible.  The bound (prof/timing.py::
// spmv_bytes) counts nnz * (value + 4) + (nrows + 1) * 4 + (ncols + nrows)
// * value bytes; a fused half adds its row operands (x-half: x, last_x, c,
// l, u read, x_new and x_hat written; y-half: y, last_y, AL, AU read,
// y_new written).  What holds it back on an H100 is the random x gather:
// one L1 line lookup per entry, ~70% of its time at 1.31M nnz in f32
// (kNoGather below; PERF.md section 6).  Only a layout that stages x in
// shared memory removes it: the tiled kernel's strips.
//
// The design, against the row-group kernel's limits:
//  * Row blocks (ops/spmv.py::row_blocks, built once at setup): a block of
//    kBlock threads owns consecutive rows whose entries start within one
//    window of kCap entries (2048 in f32, 1024 in f64: fewer than 2 * kCap
//    entries in all, at most kBlock rows); a row with more than kCap
//    entries has a block of its own.  The plan holds each block's first
//    row and first entry, so a block starts its stream after one read, not
//    two dependent ones.
//  * No idle lanes on short or skewed rows: every thread of a block streams
//    16-byte vectors of 4 values and 4 column indices from the block's
//    entry range (aligned down to the vector, so entries of the neighbour
//    blocks are loaded and dropped), two vectors in flight and their 8 x
//    gathers (x through the read-only path) issued before any product is
//    kept.  The products go to shared memory.
//  * Then one thread per row sums its products in CSR order, one rounded
//    multiply and one rounded add per entry (no fma), and writes the row
//    once.  A long row's block sums it in kBlock strided partials and a
//    fixed tree.  No atomics; the order of every sum is fixed by the plan,
//    so two launches give bitwise-identical y, and ops/spmv.py::
//    csr_spmv_plain computes the same bits in plain PyTorch.
//
// The fused halves (epilogues kXHalf and kYHalf) run the same stream and
// sums and replace the store of y by one HPR half-update per row, as
// solver/chunk.py::_x_half and _y_half compute it with PyTorch's
// elementwise kernels after the kStore launch (csrc/hpr_half.cuh: each
// operation rounded once, NaN taken as torch.clamp and torch.maximum take
// it).  A half runs as csr_spmv_half_kernel, the same body held to the
// store's blocks an SM, and reads its row's streamed operands, sigma and
// the Halpern factor with the row's entry range before the stream, so
// that their loads fly under the gather (row_ops).  sigma
// (or lambda * sigma) is a 0-dim device tensor and the Halpern counter is
// read from device memory as inner + t, t the middle iteration's index,
// baked in at launch, so a captured CUDA graph replays it unchanged; fact1
// = 1 / (inner + t + 2) rounds as solver/chunk.py::_halpern_factors does.
//
// The variant studies (f32, hprlp_csr_study; ops/spmv_variants.py), never a
// solve's.  They ask of this design what the Pallas studies asked of the
// TPU kernel: the ablate family replaces make_kernel/spmv_loop/pallas_call
// of benchmarks/prof_lane_ablate.py:44/:90/:115, the multi_acc family
// those of benchmarks/prof_dual_acc.py:32/:60/:87, the flush family those
// of benchmarks/prof_flush_variants.py:46/:97/:122.  Each variant is its
// own instantiation; the solve's (kStore, kXHalf, kYHalf at NACC = 1) are
// untouched by them.
//   full        kStore, NACC = 1: csr_spmv's own launch (ablate, flush)
//   dma_only    the same 16-byte vector stream, staging and per-row sums,
//               each product replaced by v + float(c), no x read: the
//               streaming floor of this design
//   no_gather   kNoGather: x read at the entry's index (contiguous): what
//               the random gather costs
//   one_gather  the gather kept, but block b reads x[base_b + (c & (W -
//               1))], W = min(16384, pow2_floor(ncols)) (the TPU study's
//               WINDOW), base_b = (b mod (ncols / W)) W: every block's
//               reads fall in one 64 KB window of x -- what a column-
//               windowed layout of this plan would buy
//   no_flush    the stream and gathers kept, no staging and no per-row
//               sum: each thread adds its own products of entries in [e0,
//               e1) into one register and writes it to row r0 + tid (a
//               long row's block: thread 0's strided partial) -- what the
//               staging and the row sums cost
//   n_acc=2, 4  kStore with the per-row sum split over NACC accumulators:
//               entry k of a row goes to acc[(k - rb) % NACC], and the
//               accumulators combine as (acc0 + acc1) + (acc2 + acc3) --
//               what the serial chain of rounded adds costs.  Exact, in a
//               fixed order (ops/spmv.py::plan_row_sums gives its bits).
//               A long row keeps its strided partials and tree.
//   runmerge    kRunMerge: the same stream and gathers, flushed at row ends
//               with no staging and no per-row sum.  The block reads its
//               row ends (indptr[r0 .. r1]) once into shared memory and
//               marks where its rows start in a bitmap with a count per
//               word, so a lane finds its entries' rows with two shared
//               loads.  A warp's 32 vectors of an iteration (a segment of
//               128 entries): each lane sums its 4 entries by row, a
//               segmented warp scan joins them; a row that closes inside
//               the segment is stored once, a row that crosses segments
//               leaves its partials in shared memory and the block adds
//               them left to right, without atomics.  Exact and
//               deterministic; ops/spmv_variants.py::runmerge_plain
//               repeats its order of sums.  A long row's block keeps the
//               strided partials and tree.
//   merge_all   kMergeAll: the same segments with no rows: one sum per
//               segment, added with atomicAdd into row (q0 / 32 + s) mod
//               nrows, q0 the block's first vector and s the segment
//               (long rows' blocks too).  Wrong; the ceiling of any run
//               merge (timing only).

#include <cuda_runtime.h>

#include <cstdint>

#include "hpr_half.cuh"

namespace {

using namespace hprlp;

constexpr int kBlock = 256;  // ops/spmv.py CSR_BLOCK
// Entries per window of a row block (ops/spmv.py::csr_cap): 8 KB of values,
// so a block's products take at most 16 KB of shared memory in either type.
template <typename T>
constexpr int kCap = 8192 / static_cast<int>(sizeof(T));
constexpr int kVec = 4;      // entries per vector load

// kNoGather and the three after it are the ablate study's measurements
// (the note above), never a solve's.  kNoGather stores y with x read at
// the entry's index (masked to x's length) in place of its column, so
// that the reads of x are contiguous; phase 3 of chip_smoke.py times it
// beside csr_spmv too.
enum Epilogue : int { kStore = 0, kXHalf = 1, kYHalf = 2, kNoGather = 3,
                      kDmaOnly = 4, kOneGather = 5, kNoFlush = 6,
                      kRunMerge = 7, kMergeAll = 8 };

// kStore writes out = A X.  kXHalf, over A^T's rows with X = y: cur = x,
// last = last_x, p0 = c, p1 = l, p2 = u, scal = sigma; it writes out = the
// new x and hat = x_hat.  kYHalf, over A's rows with X = x_hat: cur = y,
// last = last_y, p0 = AL, p1 = AU, scal = lambda * sigma; it writes out =
// the new y.  inner: the Halpern counter (int32) at the first middle
// iteration; t: this iteration's index.  xmask: the largest power of two
// within ncols, less one; wmask, nwin: one_gather's window, less one, and
// the number of whole windows in x.
struct Args {
  int nrows, t, xmask;
  int64_t nnz;
  const int* row0;
  const int* ent0;
  const int* indptr;
  const int* indices;
  const void* vals;
  const void* x;
  void* out;
  void* hat;
  const void* cur;
  const void* last;
  const void* p0;
  const void* p1;
  const void* p2;
  const void* scal;
  const int* inner;
  int wmask, nwin;
};

// kVec entries' values and column indices.
template <typename T>
struct Entries {
  T v[kVec];
  int c[kVec];
};

// Vector q (entries kVec * q ..): one 16-byte load of indices and 16 or 32
// bytes of values where the whole vector lies in the arrays, else scalar
// loads of the entries below nnz (the arrays' last, partial vector).
template <typename T>
__device__ __forceinline__ Entries<T> load_vec(const T* __restrict__ vals,
                                               const int* __restrict__ indices,
                                               int64_t q, int64_t nnz) {
  Entries<T> e;
  const int64_t k = q * kVec;
  if (k + kVec <= nnz) {
    const int4 c = __ldg(reinterpret_cast<const int4*>(indices + k));
    e.c[0] = c.x; e.c[1] = c.y; e.c[2] = c.z; e.c[3] = c.w;
    if constexpr (sizeof(T) == 4) {
      const float4 v = __ldg(reinterpret_cast<const float4*>(vals + k));
      e.v[0] = v.x; e.v[1] = v.y; e.v[2] = v.z; e.v[3] = v.w;
    } else {
      const double2 a = __ldg(reinterpret_cast<const double2*>(vals + k));
      const double2 b = __ldg(reinterpret_cast<const double2*>(vals + k + 2));
      e.v[0] = a.x; e.v[1] = a.y; e.v[2] = b.x; e.v[3] = b.y;
    }
  } else {
#pragma unroll
    for (int i = 0; i < kVec; ++i) {
      const bool in = k + i < nnz;
      e.c[i] = in ? indices[k + i] : 0;
      e.v[i] = in ? vals[k + i] : T(0);
    }
  }
  return e;
}

// An entry's term: its rounded product with the x value read for it, or
// (dma_only) its value plus its column.
template <typename T, int E>
__device__ __forceinline__ T term(T v, T xv) {
  if constexpr (E == kDmaOnly) {
    return add_rn(v, xv);
  } else {
    return mul_rn(v, xv);
  }
}

// The products of one vector, stored at its aligned offset in shared
// memory by 16-byte stores (entries outside the block's range are stored
// and never read).
template <typename T, int E>
__device__ __forceinline__ void keep(T* prod, int64_t off, const Entries<T>& e,
                                     const T (&xv)[kVec]) {
  T p[kVec];
#pragma unroll
  for (int i = 0; i < kVec; ++i) p[i] = term<T, E>(e.v[i], xv[i]);
  if constexpr (sizeof(T) == 4) {
    *reinterpret_cast<float4*>(prod + off) = make_float4(p[0], p[1], p[2], p[3]);
  } else {
    *reinterpret_cast<double2*>(prod + off) = make_double2(p[0], p[1]);
    *reinterpret_cast<double2*>(prod + off + 2) = make_double2(p[2], p[3]);
  }
}

// The x value entry k (column c) is multiplied by: x[c], or what the
// variant reads in its place (dma_only reads none: its column).  base:
// one_gather's window of this block.
template <typename T, int E>
__device__ __forceinline__ T x_at(const Args& a, const T* __restrict__ x,
                                  int c, int64_t k, int base) {
  if constexpr (E == kNoGather) {
    return __ldg(x + (k & a.xmask));
  } else if constexpr (E == kDmaOnly) {
    return static_cast<T>(c);
  } else if constexpr (E == kOneGather) {
    return __ldg(x + base + (c & a.wmask));
  } else {
    return __ldg(x + c);
  }
}

template <typename T, int E>
__device__ __forceinline__ void gather(const Args& a, const T* __restrict__ x,
                                       const Entries<T>& e, int64_t q,
                                       int base, T (&xv)[kVec]) {
#pragma unroll
  for (int i = 0; i < kVec; ++i) {
    xv[i] = x_at<T, E>(a, x, e.c[i], q * kVec + i, base);
  }
}

// no_flush: this thread's running sum of the products of vector q's
// entries that lie in [e0, e1).
template <typename T>
__device__ __forceinline__ T own_sum(T acc, const Entries<T>& e,
                                     const T (&xv)[kVec], int64_t q,
                                     int64_t e0, int64_t e1) {
#pragma unroll
  for (int i = 0; i < kVec; ++i) {
    const int64_t k = q * kVec + i;
    if (k >= e0 && k < e1) acc = add_rn(acc, mul_rn(e.v[i], xv[i]));
  }
  return acc;
}

// The sum of one short row's staged products prod[rb - base .. re - base)
// in NACC accumulators, entry k into acc[(k - rb) % NACC], combined as
// (acc0 + acc1) + (acc2 + acc3).  NACC = 1: one add at a time in CSR order.
template <typename T, int NACC>
__device__ __forceinline__ T row_sum(const T* prod, int rb, int re,
                                     int64_t base) {
  if constexpr (NACC == 1) {
    T acc = T(0);
    for (int k = rb; k < re; ++k) acc = add_rn(acc, prod[k - base]);
    return acc;
  } else {
    T acc[NACC];
#pragma unroll
    for (int j = 0; j < NACC; ++j) acc[j] = T(0);
    int k = rb;
    for (; k + NACC <= re; k += NACC) {
#pragma unroll
      for (int j = 0; j < NACC; ++j) {
        acc[j] = add_rn(acc[j], prod[k + j - base]);
      }
    }
#pragma unroll
    for (int j = 0; j < NACC - 1; ++j) {
      if (k + j < re) acc[j] = add_rn(acc[j], prod[k + j - base]);
    }
    if constexpr (NACC == 2) {
      return add_rn(acc[0], acc[1]);
    } else {
      static_assert(NACC == 4, "NACC is 1, 2 or 4");
      return add_rn(add_rn(acc[0], acc[1]), add_rn(acc[2], acc[3]));
    }
  }
}

// A half-update's operands of one row (cur, last, p0, p1 and the x-half's
// p2), sigma and the Halpern factor f1; empty for the other epilogues.
template <typename T>
struct RowOps {
  T x, last, p0, p1, p2, s, f1;
};

template <typename T, int E>
__device__ __forceinline__ RowOps<T> row_ops(const Args& a, int row) {
  RowOps<T> o{};
  if constexpr (E == kXHalf || E == kYHalf) {
    o.x = static_cast<const T*>(a.cur)[row];
    o.last = static_cast<const T*>(a.last)[row];
    o.p0 = static_cast<const T*>(a.p0)[row];
    o.p1 = static_cast<const T*>(a.p1)[row];
    if constexpr (E == kXHalf) o.p2 = static_cast<const T*>(a.p2)[row];
    o.s = *static_cast<const T*>(a.scal);
    o.f1 = halpern_f1<T>(*a.inner + a.t);
  }
  return o;
}

// The row write: y, or one half-update of row `row` given its sum and its
// operands `o` (row_ops).
template <typename T, int E>
__device__ __forceinline__ void write_row(const Args& a, int row, T acc,
                                          const RowOps<T>& o) {
  if constexpr (E != kXHalf && E != kYHalf) {
    static_cast<T*>(a.out)[row] = acc;
  } else if constexpr (E == kXHalf) {
    T xh;
    static_cast<T*>(a.out)[row] = x_half_update(acc, o.x, o.last, o.p0, o.p1,
                                                o.p2, o.s, o.f1, xh);
    static_cast<T*>(a.hat)[row] = xh;
  } else {
    static_cast<T*>(a.out)[row] = y_half_update(acc, o.x, o.last, o.p0, o.p1,
                                                o.s, o.f1);
  }
}

template <typename T, int E>
__device__ __forceinline__ void write_row(const Args& a, int row, T acc) {
  write_row<T, E>(a, row, acc, row_ops<T, E>(a, row));
}

// The flush study's warp segments: a warp's 32 consecutive vectors (128
// entries) of an iteration, numbered from the block's first vector.  A
// block of short rows has at most kMaxSeg<T> of them and its entries from
// the first vector span at most kWords<T> 32-bit words of a bitmap.
constexpr int kSegVecs = 32;
template <typename T>
constexpr int kMaxSeg = (2 * kCap<T> / kVec + 2 + kSegVecs - 1) / kSegVecs;
template <typename T>
constexpr int kWords = (2 * kCap<T> + 2 * kVec + 31) / 32 + 1;

// runmerge's shared memory, in the kernel's prod buffer: the block's row
// ends (ends[i] = indptr[r0 + i]); a bitmap of where its non-empty rows
// start (bit k - 4 q0), the row starts before each word, and the row of
// each start (in order); per warp segment the partial of its first row
// where that row started before it, and of its last row (and which row)
// where that row goes on after it.
template <typename T>
struct Merge {
  int* ends;       // n + 1 <= kBlock + 1
  uint32_t* bits;  // kWords<T>
  int* before;     // kWords<T>
  int* row_of;     // kBlock: the i-th non-empty row
  int* last_row;   // kMaxSeg<T>, -1 where the segment's last row ends in it
  T* first_part;
  T* last_part;
};

// runmerge: one warp segment's rows.  key[j]: entry j's row as its place
// among the block's non-empty rows (-1 before the block's entries, n after
// them; keys rise with the lane), p[j] its product (0 outside the block).
// Each lane sums its last row's entries, a segmented inclusive scan over
// the lanes joins the rows that span lanes (as spmv_tiled.cu's sum_step,
// in as many steps as the longest run of lanes needs), and every row is
// closed once at its last entry in the segment: stored where it lies
// wholly in [lo, hi), else left in m for the block to finish.
template <typename T, int E>
__device__ __forceinline__ void merge_segment(const Args& a, const Merge<T>& m,
                                              int r0, int n, int s,
                                              int64_t lo, int64_t hi,
                                              const int (&key)[kVec],
                                              const T (&p)[kVec], int lane) {
  constexpr unsigned kFull = 0xffffffffu;
  auto close = [&](int o, T v) {
    if (o < 0 || o >= n) return;
    const int i = m.row_of[o];
    if (m.ends[i] < lo) {
      m.first_part[s] = v;
    } else if (m.ends[i + 1] > hi) {
      m.last_part[s] = v;
      m.last_row[s] = i;
    } else {
      write_row<T, E>(a, r0 + i, v);
    }
  };
  const int last = key[kVec - 1];
  T acc = T(0);
#pragma unroll
  for (int j = 0; j < kVec; ++j) {
    if (key[j] == last) acc = add_rn(acc, p[j]);
  }
  // h: the first lane whose last row is this lane's; cont: this lane's
  // first row goes on from the lane to its left.
  const int left_last = __shfl_up_sync(kFull, last, 1);
  const unsigned heads = __ballot_sync(kFull, lane == 0 || left_last != last);
  const unsigned conts = __ballot_sync(kFull, lane > 0 && left_last == key[0]);
  const int h = 31 - __clz(heads & (kFull >> (31 - lane)));
  const int longest = __reduce_max_sync(kFull, lane - h);
  T S = acc;
  for (int d = 1; d <= longest; d <<= 1) {
    const T o = __shfl_up_sync(kFull, S, d);
    if (lane - d >= h) S = add_rn(S, o);
  }
  const T left_s = __shfl_up_sync(kFull, S, 1);
  T cur = (conts >> lane) & 1 ? left_s : T(0);
#pragma unroll
  for (int j = 0; j + 1 < kVec; ++j) {
    cur = add_rn(cur, p[j]);
    if (key[j] != key[j + 1]) {
      close(key[j], cur);
      cur = T(0);
    }
  }
  if (lane == 31 || !((conts >> (lane + 1)) & 1)) close(last, S);
}

// The flush study's stream (kRunMerge, kMergeAll): the kernel's 16-byte
// vectors, two in flight per thread, in warp segments; q0, q1: the
// block's vectors.
template <typename T, int E>
__device__ __forceinline__ void merge_stream(const Args& a, T* prod, int r0,
                                             int r1, int64_t e0, int64_t e1,
                                             int64_t q0, int64_t q1) {
  constexpr unsigned kFull = 0xffffffffu;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n = r1 - r0;
  const T* __restrict__ vals = static_cast<const T*>(a.vals);
  const T* __restrict__ x = static_cast<const T*>(a.x);
  const int nseg = static_cast<int>((q1 - q0 + kSegVecs - 1) / kSegVecs);
  const int nwords = static_cast<int>((q1 - q0) * kVec + 31) / 32;
  const int64_t ebase = q0 * kVec;
  Merge<T> m;
  m.ends = reinterpret_cast<int*>(prod);
  m.bits = reinterpret_cast<uint32_t*>(m.ends + kBlock + 4);
  m.before = reinterpret_cast<int*>(m.bits + kWords<T>);
  m.row_of = m.before + kWords<T>;
  m.last_row = m.row_of + kBlock;
  m.first_part = reinterpret_cast<T*>(m.last_row + kMaxSeg<T>);
  m.last_part = m.first_part + kMaxSeg<T>;
  if constexpr (E == kRunMerge) {
    for (int i = tid; i <= n; i += kBlock) m.ends[i] = a.indptr[r0 + i];
    for (int i = tid; i < nwords; i += kBlock) m.bits[i] = 0;
    for (int i = tid; i < nseg; i += kBlock) m.last_row[i] = -1;
    __syncthreads();
    for (int i = tid; i < n; i += kBlock) {
      const int off = static_cast<int>(m.ends[i] - ebase);
      if (m.ends[i] < m.ends[i + 1]) {
        atomicOr(m.bits + (off >> 5), 1u << (off & 31));
      } else {
        write_row<T, E>(a, r0 + i, T(0));  // an empty row
      }
    }
    __syncthreads();
    if (warp == 0) {  // row starts before each word: 5 words a lane
      int c = 0;
      for (int w = 5 * lane; w < 5 * lane + 5 && w < nwords; ++w) {
        c += __popc(m.bits[w]);
      }
      int incl = c;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int o = __shfl_up_sync(kFull, incl, d);
        if (lane >= d) incl += o;
      }
      int run = incl - c;
      for (int w = 5 * lane; w < 5 * lane + 5 && w < nwords; ++w) {
        m.before[w] = run;
        run += __popc(m.bits[w]);
      }
    }
    __syncthreads();
    for (int i = tid; i < n; i += kBlock) {
      if (m.ends[i] < m.ends[i + 1]) {
        const int off = static_cast<int>(m.ends[i] - ebase);
        m.row_of[m.before[off >> 5] +
                 __popc(m.bits[off >> 5] & ((1u << (off & 31)) - 1))] = i;
      }
    }
    __syncthreads();
  }
  // One warp segment: vector qh of this lane, its entries e and x values.
  auto segment = [&](const Entries<T>& e, const T (&xv)[kVec], int64_t qh) {
    const int s = static_cast<int>((qh - lane - q0) / kSegVecs);
    if constexpr (E == kMergeAll) {
      // One sum per segment, into row (q0 / 32 + s) mod nrows.
      T v = T(0);
#pragma unroll
      for (int j = 0; j < kVec; ++j) {
        const int64_t k = qh * kVec + j;
        if (k >= e0 && k < e1) v = add_rn(v, mul_rn(e.v[j], xv[j]));
      }
#pragma unroll
      for (int d = 16; d > 0; d >>= 1) {
        v = add_rn(v, __shfl_xor_sync(kFull, v, d));
      }
      if (lane == 0) {
        atomicAdd(static_cast<T*>(a.out) + (q0 / kSegVecs + s) % a.nrows, v);
      }
    } else {
      // The row starts at or before each entry, from the bitmap.
      int starts = 0;
      uint32_t mine = 0;
      if (qh < q1) {
        const int off = static_cast<int>(qh * kVec - ebase);
        const uint32_t word = m.bits[off >> 5];
        starts = m.before[off >> 5] + __popc(word & ((1u << (off & 31)) - 1));
        mine = word >> (off & 31);
      }
      int key[kVec];
      T p[kVec];
#pragma unroll
      for (int j = 0; j < kVec; ++j) {
        const int64_t k = qh * kVec + j;
        starts += (mine >> j) & 1;
        p[j] = T(0);
        if (k < e0) {
          key[j] = -1;
        } else if (k >= e1) {
          key[j] = n;
        } else {
          key[j] = starts - 1;
          p[j] = mul_rn(e.v[j], xv[j]);
        }
      }
      const int64_t base = (q0 + static_cast<int64_t>(s) * kSegVecs) * kVec;
      const int64_t lo = base > e0 ? base : e0;
      const int64_t hi = base + kSegVecs * kVec < e1 ? base + kSegVecs * kVec
                                                     : e1;
      merge_segment<T, E>(a, m, r0, n, s, lo, hi, key, p, lane);
    }
  };
  for (int64_t qb = q0 + kSegVecs * warp; qb < q1; qb += 2 * kBlock) {
    const bool two = qb + kBlock < q1;  // warp-uniform
    const int64_t q = qb + lane;
    const Entries<T> ea = load_vec(vals, a.indices, q, a.nnz);
    Entries<T> eb;
    if (two) eb = load_vec(vals, a.indices, q + kBlock, a.nnz);
    T xa[kVec], xb[kVec];
    gather<T, E>(a, x, ea, q, 0, xa);
    if (two) gather<T, E>(a, x, eb, q + kBlock, 0, xb);
    segment(ea, xa, q);
    if (two) segment(eb, xb, q + kBlock);
  }
  if constexpr (E == kRunMerge) {
    // Rows that cross segments: their partials, left to right.
    __syncthreads();
    for (int s = tid; s < nseg; s += kBlock) {
      const int i = m.last_row[s];
      if (i < 0) continue;
      const int64_t re = m.ends[i + 1];
      T v = m.last_part[s];
      for (int s2 = s + 1; s2 < nseg; ++s2) {
        v = add_rn(v, m.first_part[s2]);
        const int64_t hi2 = (q0 + static_cast<int64_t>(s2 + 1) * kSegVecs)
                            * kVec;
        if (re <= hi2) break;
      }
      write_row<T, E>(a, r0 + i, v);
    }
  }
}

// One row block of the plan (blockIdx.x): the stream, the gather, the row
// sums and the epilogue's row write.
template <typename T, int E, int NACC>
__device__ __forceinline__ void spmv_rows(const Args& a) {
  // Products at their offset from the block's first vector: fewer than
  // 2 * kCap entries, plus up to kVec - 1 before the block's first entry.
  __shared__ __align__(16) T prod[2 * kCap<T> + 2 * kVec];
  const int tid = threadIdx.x;
  const int b = blockIdx.x;
  const int r0 = a.row0[b], r1 = a.row0[b + 1];
  const int64_t e0 = a.ent0[b], e1 = a.ent0[b + 1];
  const T* __restrict__ vals = static_cast<const T*>(a.vals);
  const T* __restrict__ x = static_cast<const T*>(a.x);
  const int base_x = E == kOneGather ? (b % a.nwin) * (a.wmask + 1) : 0;

  if (E != kMergeAll && r1 - r0 == 1 && e1 - e0 > kCap<T>) {
    // A long row: kBlock strided partials in entry order, then a tree.
    T acc = T(0);
    for (int64_t k = e0 + tid; k < e1; k += kBlock) {
      acc = add_rn(acc, term<T, E>(vals[k], x_at<T, E>(a, x, a.indices[k], k,
                                                        base_x)));
    }
    if constexpr (E == kNoFlush) {
      if (tid == 0) static_cast<T*>(a.out)[r0] = acc;
      return;
    }
    prod[tid] = acc;
    __syncthreads();
#pragma unroll
    for (int s = kBlock / 2; s > 0; s >>= 1) {
      if (tid < s) prod[tid] = add_rn(prod[tid], prod[tid + s]);
      __syncthreads();
    }
    if (tid == 0) write_row<T, E>(a, r0, prod[0]);
    return;
  }

  const int row = r0 + tid;
  const int64_t q0 = e0 / kVec;
  const int64_t q1 = (e1 + kVec - 1) / kVec;
  if constexpr (E == kRunMerge || E == kMergeAll) {
    merge_stream<T, E>(a, prod, r0, r1, e0, e1, q0, q1);
    return;
  }
  if constexpr (E == kNoFlush) {
    // The same stream and gathers, each thread's products summed where
    // they were loaded.
    T acc = T(0);
    for (int64_t q = q0 + tid; q < q1; q += 2 * kBlock) {
      const bool two = q + kBlock < q1;
      const Entries<T> ea = load_vec(vals, a.indices, q, a.nnz);
      Entries<T> eb;
      if (two) eb = load_vec(vals, a.indices, q + kBlock, a.nnz);
      T xa[kVec], xb[kVec];
      gather<T, E>(a, x, ea, q, base_x, xa);
      if (two) gather<T, E>(a, x, eb, q + kBlock, base_x, xb);
      acc = own_sum(acc, ea, xa, q, e0, e1);
      if (two) acc = own_sum(acc, eb, xb, q + kBlock, e0, e1);
    }
    if (row < r1) static_cast<T*>(a.out)[row] = acc;
    return;
  }

  // This thread's first row's entry range, and a half's operands of it,
  // read before the stream: their loads fly under the gather.
  int rb = 0, re = 0;
  RowOps<T> ops{};
  if (row < r1) {
    rb = a.indptr[row];
    re = a.indptr[row + 1];
    ops = row_ops<T, E>(a, row);
  }
  for (int64_t q = q0 + tid; q < q1; q += 2 * kBlock) {
    const bool two = q + kBlock < q1;
    const Entries<T> ea = load_vec(vals, a.indices, q, a.nnz);
    Entries<T> eb;
    if (two) eb = load_vec(vals, a.indices, q + kBlock, a.nnz);
    T xa[kVec], xb[kVec];
    gather<T, E>(a, x, ea, q, base_x, xa);
    if (two) gather<T, E>(a, x, eb, q + kBlock, base_x, xb);
    keep<T, E>(prod, (q - q0) * kVec, ea, xa);
    if (two) keep<T, E>(prod, (q + kBlock - q0) * kVec, eb, xb);
  }
  __syncthreads();

  const int64_t base = q0 * kVec;
  for (int r = row; r < r1; r += kBlock) {
    if (r != row) {
      rb = a.indptr[r];
      re = a.indptr[r + 1];
      ops = row_ops<T, E>(a, r);
    }
    write_row<T, E>(a, r, row_sum<T, NACC>(prod, rb, re, base), ops);
  }
}

template <typename T, int E, int NACC = 1>
__global__ void __launch_bounds__(kBlock) csr_spmv_kernel(const Args a) {
  spmv_rows<T, E, NACC>(a);
}

// The fused halves hold a row's operands in registers through the stream;
// they are held to the blocks an SM the store keeps (f32 5, at most 48
// registers a thread; f64 4, at most 64).
template <typename T, int E>
__global__ void __launch_bounds__(kBlock, sizeof(T) == 4 ? 5 : 4)
csr_spmv_half_kernel(const Args a) {
  spmv_rows<T, E, 1>(a);
}

template <typename T>
int launch(int epilogue, int nblocks, const Args& a, cudaStream_t s) {
  switch (epilogue) {
    case kStore: csr_spmv_kernel<T, kStore><<<nblocks, kBlock, 0, s>>>(a); break;
    case kXHalf: csr_spmv_half_kernel<T, kXHalf><<<nblocks, kBlock, 0, s>>>(a); break;
    case kYHalf: csr_spmv_half_kernel<T, kYHalf><<<nblocks, kBlock, 0, s>>>(a); break;
    case kNoGather: csr_spmv_kernel<T, kNoGather><<<nblocks, kBlock, 0, s>>>(a); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// The variant studies' instantiations (f32): an ablate or flush epilogue
// at NACC = 1, or kStore at NACC = 1, 2 or 4.
int launch_study(int variant, int n_acc, int nblocks, const Args& a,
                 cudaStream_t s) {
  if (n_acc != 1 && variant != kStore) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  switch (variant * 8 + n_acc) {
    case kStore * 8 + 1: csr_spmv_kernel<float, kStore><<<nblocks, kBlock, 0, s>>>(a); break;
    case kStore * 8 + 2: csr_spmv_kernel<float, kStore, 2><<<nblocks, kBlock, 0, s>>>(a); break;
    case kStore * 8 + 4: csr_spmv_kernel<float, kStore, 4><<<nblocks, kBlock, 0, s>>>(a); break;
    case kNoGather * 8 + 1: csr_spmv_kernel<float, kNoGather><<<nblocks, kBlock, 0, s>>>(a); break;
    case kDmaOnly * 8 + 1: csr_spmv_kernel<float, kDmaOnly><<<nblocks, kBlock, 0, s>>>(a); break;
    case kOneGather * 8 + 1: csr_spmv_kernel<float, kOneGather><<<nblocks, kBlock, 0, s>>>(a); break;
    case kNoFlush * 8 + 1: csr_spmv_kernel<float, kNoFlush><<<nblocks, kBlock, 0, s>>>(a); break;
    case kRunMerge * 8 + 1: csr_spmv_kernel<float, kRunMerge><<<nblocks, kBlock, 0, s>>>(a); break;
    case kMergeAll * 8 + 1: csr_spmv_kernel<float, kMergeAll><<<nblocks, kBlock, 0, s>>>(a); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

constexpr int kWindow = 16384;  // one_gather's x entries per window

// Args of one launch on the plan, the epilogue's operands left null.
Args plan_args(int nrows, int ncols, long long nnz, int t, const void* row0,
               const void* ent0, const void* indptr, const void* indices,
               const void* vals, const void* x, void* out) {
  Args a{};
  a.nrows = nrows;
  a.t = t;
  a.xmask = 0;  // the largest power of two within ncols, less one
  while (ncols > 1 && a.xmask < ncols / 2) a.xmask = 2 * a.xmask + 1;
  const int w = a.xmask + 1 < kWindow ? a.xmask + 1 : kWindow;
  a.wmask = w - 1;
  a.nwin = ncols / w > 1 ? ncols / w : 1;
  a.nnz = nnz;
  a.row0 = static_cast<const int*>(row0);
  a.ent0 = static_cast<const int*>(ent0);
  a.indptr = static_cast<const int*>(indptr);
  a.indices = static_cast<const int*>(indices);
  a.vals = vals;
  a.x = x;
  a.out = out;
  return a;
}

bool bad_plan(int nblocks, long long nnz, const void* vals,
              const void* indices) {
  return nblocks < 0 || nnz < 0 ||
         (reinterpret_cast<uintptr_t>(vals) |
          reinterpret_cast<uintptr_t>(indices)) % 16;
}

}  // namespace

extern "C" {

// y = A x on the row-block plan (epilogue 0; 3: the no-gather
// measurement), or with epilogue 1 or 2 the fused x- or y-half (operands
// as in Args above; pointers an epilogue does not read may be null).
// row0, ent0: (nblocks + 1,) int32, each block's first row and first
// entry; vals and indices 16-byte aligned.  Returns cudaGetLastError()
// after the launch (0 on success).
int hprlp_csr_spmv(int is_f64, int epilogue, int nrows, int ncols,
                   long long nnz, int nblocks, int t, const void* row0,
                   const void* ent0,
                   const void* indptr, const void* indices, const void* vals,
                   const void* x, void* out, void* hat, const void* cur,
                   const void* last, const void* p0, const void* p1,
                   const void* p2, const void* scal, const void* inner,
                   void* stream) {
  if (bad_plan(nblocks, nnz, vals, indices)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (nrows <= 0 || nblocks == 0) return 0;
  Args a = plan_args(nrows, ncols, nnz, t, row0, ent0, indptr, indices, vals,
                     x, out);
  a.hat = hat;
  a.cur = cur;
  a.last = last;
  a.p0 = p0;
  a.p1 = p1;
  a.p2 = p2;
  a.scal = scal;
  a.inner = static_cast<const int*>(inner);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_f64 ? launch<double>(epilogue, nblocks, a, s)
                : launch<float>(epilogue, nblocks, a, s);
}

// One variant of the studies (f32), y = out: `variant` an epilogue of the
// ablate family (0 full, 3 no_gather, 4 dma_only, 5 one_gather, 6
// no_flush) or of the flush family (7 runmerge, 8 merge_all, which adds
// into out: zero it first) with n_acc = 1, or 0 with n_acc = 1, 2 or 4
// (multi_acc);
// the plan's arguments as for hprlp_csr_spmv.  Returns cudaGetLastError()
// after the launch, or cudaErrorInvalidValue for a variant it does not
// have.
int hprlp_csr_study(int variant, int n_acc, int nrows, int ncols,
                    long long nnz, int nblocks, const void* row0,
                    const void* ent0, const void* indptr, const void* indices,
                    const void* vals, const void* x, void* out,
                    void* stream) {
  if (bad_plan(nblocks, nnz, vals, indices)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (nrows <= 0 || nblocks == 0) return 0;
  return launch_study(variant, n_acc, nblocks,
                      plan_args(nrows, ncols, nnz, 0, row0, ent0, indptr,
                                indices, vals, x, out),
                      static_cast<cudaStream_t>(stream));
}

const char* hprlp_csr_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
