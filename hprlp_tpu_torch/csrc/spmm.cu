// CSR SpMM for Hopper: Y = A X, with X (ncols, B) and Y (nrows, B) dense
// and row-major, so that the B values of one row are contiguous; and the
// batched HPR middle iteration's two half-updates fused into its row write.
//
// Replaces no Pallas kernel: the JAX package computes this product outside
// any kernel, as an XLA gather einsum over its ELL buckets
// (hprlp_tpu/ops/sparse.py:594-608, spmm), and XLA fuses the halves around
// it (hprlp_tpu/solver/batched.py:77-91, 162-170), where the reference
// calls cuSPARSE's SpMM and its own active-mask kernels
// (src/batched_solver.cu:122-323, 428-477).  It carries every sparse product
// of the batched solver (solver/batched.py).
//
// What bounds it: bytes.  The function's least bytes (prof/timing.py::
// spmv_bytes, half_bound) read each stored entry's value and int32 column
// index once, X once, and write each row of Y once.  But X's rows are
// gathered, B values for every entry: nnz * B * sizeof(T) bytes (prof/
// timing.py::gather_bytes; 335.5 MB at batched_large, B = 64, f32, against
// X's 33.5 MB), ~20 random rows per output row, which L2 serves while a
// slice's window of X fits its 50 MB.  So the HBM bound (X once) is out of
// reach, and what the card really serves is that L2 gather: ~5.4 TB/s on
// an H100 at batched_large, with one segment a lane in flight or several
// (PERF.md section 6).  Tensor cores do not apply: at ~20 random columns
// per row, 2 * nnz * B operations are far below the card's rate, and a
// wgmma tile would be almost all zeros.  None is used.
//
// The product's design (csr_spmm_kernel; the x-half and the scaling's row
// sums run it too):
//  * A group of G lanes (G a power of two, at most a warp) owns one (row,
//    column slice) of Y, and each lane V adjacent columns of it, so a slice
//    is G * V columns wide; V is the widest load (16, 8 or 4 bytes) that B
//    and the operands' alignment allow.
//  * Slices are the grid's slow axis (blockIdx.y) and rows its fast one
//    (blockIdx.x).  Blocks start in index order, so one slice's ncols x
//    G * V window of X is live at a time, and the wrapper (ops/spmm.py::
//    spmm_plan) caps G so that this window stays within L2_BUDGET: at
//    B = 256, X (134 MB in f32) no longer has to fit L2 at once.
//  * A block owns BLOCK / G consecutive rows of one slice, so its entries
//    are one contiguous range, which its groups read G at a time,
//    coalesced, and broadcast by shuffles.  They are not staged in shared
//    memory: they are 8-12 bytes an entry against 4 * B or 8 * B gathered
//    bytes (3% at B = 64, f32), and already read once and coalesced.
//  * One gather in flight per lane, in registers, and at most 64 registers
//    a thread (4 blocks per SM).  With 2, 4 or 8 such register gathers in
//    flight per lane, or no register cap, this design was slower at every
//    shape measured on an H100 (PERF.md section 6): more in flight cost
//    occupancy.
//  * Every output sums its row's products in CSR order, one fma each, in
//    registers: deterministic, no atomics, no second pass, and bitwise
//    equal to the previous design (csrc/spmm_rowwise.cu), which sums in
//    the same order.  Columns at or past B are masked; an empty row writes
//    zeros.
//
// The fused halves (epilogues kXHalf and kYHalf of csr_spmm_kernel) run the
// same main loop and replace the store of Y by one HPR half-update per
// (row, member), with the member's scalars read from (B,) arrays, as
// solver/batched.py::x_half_plain and y_half_plain compute them with
// PyTorch's elementwise kernels; the update and its rounding rules are
// csrc/hpr_half.cuh's, so a fused iteration is bitwise equal to the plain
// ops run on the same SpMM output.  A frozen member's iterate is written
// back unchanged.  Their streamed operands are read after the gather.
// kXHalf is the x-half's kernel; kYHalf is the y-half's previous design,
// kept as its bitwise yardstick and timed beside the new one.
//
// The y-half's kernel (spmm_y_ring_kernel), with the same groups, slices,
// grid order and L2 windows, does two things about the gather:
//  * Bytes in flight without registers.  Each lane keeps its entries'
//    segments of X (V * sizeof(T) bytes each) in flight as cp.async copies
//    into its own slots of a ring in dynamic shared memory: two batches of
//    Ring<T>::kBatch entries, one commit group a batch, so that while one
//    batch is summed the next is in flight.  A lane copies and reads only
//    its own slots, so its own cp.async.wait_group is all the ordering the
//    loop needs, and no barrier enters it.  Every lane reads the batch's
//    columns and values itself, a batch ahead (one address across its
//    group, no shuffles), and parks each value beside its slot.  A group
//    owns one row, as in the product: a ring across several rows' entries
//    was slower on an H100 at 2 and 4 rows a group (PERF.md section 6),
//    since each further row's operands cost a block shared memory.
//  * The streamed rows under the gather.  Right after the first batch's
//    copies, each lane copies its V columns of its row of y, last_y, AL
//    and AU into shared memory (cp.async with an L2 evict-first policy) as
//    a commit group of their own, so that they arrive while the gather
//    runs and only the epilogue waits for them; the epilogue reads them
//    from there and stores y_new evict-first too, so that X's window keeps
//    L2.  The x-half that follows gathers y_new, but a plain store of it
//    was no faster there and slower end to end (prof/prof_ynew_store.py).
// What it gave on an H100 (PERF.md section 6): the ring's product alone
// gathers at the register loop's L2 rate (the gather is bound by L2's
// throughput, not by the bytes in flight), and the rows fetched under it
// make the y-half 12% faster in f32.  In f64 it is as fast as kYHalf,
// within 1%: a lane's V = 2 columns carry the ring's per-entry work
// (columns, values, copies, shared loads) over half as many fmas, and
// 64 KB a block leave 3 blocks an SM.  Each (row, member) still starts at
// 0 and takes one fma_rn per entry in CSR order, and the update is
// y_half_update with halpern_f1: y_new is bitwise kYHalf's.

#include <cuda_runtime.h>

#include <cstdint>

#include "hpr_half.cuh"

namespace {

using namespace hprlp;

constexpr int kBlock = 256;
constexpr int kMinBlocks = 4;  // blocks per SM: at most 64 registers a thread

template <typename T, int V> struct Vec;
template <> struct Vec<float, 1> { using type = float; };
template <> struct Vec<float, 2> { using type = float2; };
template <> struct Vec<float, 4> { using type = float4; };
template <> struct Vec<double, 1> { using type = double; };
template <> struct Vec<double, 2> { using type = double2; };

template <typename T, int V>
union Pack {
  typename Vec<T, V>::type v;
  T a[V];
};

enum Epilogue : int { kStore = 0, kXHalf = 1, kYHalf = 2 };

// The operands of one launch.  kStore writes out = A X.  kXHalf, over A^T's
// rows with X = y: cur = x, last = last_x, p0 = c, p1 = l, p2 = u, scal =
// sigma; it writes out = the new x and hat = x_hat.  kYHalf, over A's rows
// with X = x_hat: cur = y, last = last_y, p0 = AL, p1 = AU, scal =
// lam_sigma; it writes out = the new y.  inner (int32) and active (bool)
// are per member; t is the middle iteration's index, by which an active
// member's Halpern counter has advanced since `inner` was taken.
struct Args {
  int nrows, B, t;
  const int* indptr;
  const int* indices;
  const void* vals;
  const void* X;
  void* out;
  void* hat;
  const void* cur;
  const void* last;
  const void* p0;
  const void* p1;
  const void* p2;
  const void* scal;
  const int* inner;
  const unsigned char* active;
};

template <typename T, int V>
__device__ __forceinline__ Pack<T, V> load_row(const void* p, int64_t off) {
  Pack<T, V> r;
  r.v = *reinterpret_cast<const typename Vec<T, V>::type*>(
      static_cast<const T*>(p) + off);
  return r;
}

template <typename T, int V>
__device__ __forceinline__ void store_row(void* p, int64_t off,
                                          const Pack<T, V>& r) {
  *reinterpret_cast<typename Vec<T, V>::type*>(static_cast<T*>(p) + off) = r.v;
}

// acc[i] += vals[k] * X[indices[k], col + i] over the row's entries in CSR
// order: the group reads G entries at a time, one per lane, and broadcasts
// each; one gather in flight per lane.
template <typename T, int G, int V>
__device__ __forceinline__ void gather_row(
    int64_t begin, int64_t end, int gl, unsigned mask, bool live, int B,
    int col, const int* __restrict__ indices, const T* __restrict__ vals,
    const T* __restrict__ X, T (&acc)[V]) {
  using VT = typename Vec<T, V>::type;
  // 64-bit entry index: k0 + G must not wrap near nnz = 2^31 - 1.
  for (int64_t k0 = begin; k0 < end; k0 += G) {
    const int64_t k = k0 + gl;
    int c = 0;
    T a = T(0);
    if (k < end) {
      c = __ldg(indices + k);
      a = __ldg(vals + k);
    }
    const int n = static_cast<int>(end - k0 < G ? end - k0 : G);
    for (int j = 0; j < n; ++j) {
      const int cj = __shfl_sync(mask, c, j, G);
      const T aj = __shfl_sync(mask, a, j, G);
      if (live) {
        Pack<T, V> x;
        x.v = __ldg(reinterpret_cast<const VT*>(
            X + static_cast<int64_t>(cj) * B + col));
#pragma unroll
        for (int i = 0; i < V; ++i) acc[i] = fma_rn(aj, x.a[i], acc[i]);
      }
    }
  }
}

template <typename T, int G, int V, int E>
__global__ void __launch_bounds__(kBlock, kMinBlocks)
csr_spmm_kernel(const Args a) {
  const int lane = threadIdx.x & 31;
  const int gl = lane & (G - 1);  // lane within the group
  const unsigned mask = (0xffffffffu >> (32 - G)) << (lane - gl);
  // G divides the block, so all lanes of a group share one row.
  const int row = blockIdx.x * (kBlock / G) + threadIdx.x / G;
  if (row >= a.nrows) return;
  const int col = blockIdx.y * (G * V) + gl * V;
  // B % V == 0, so a lane's V columns are all in range or all out.
  const bool live = col < a.B;

  T acc[V];
#pragma unroll
  for (int i = 0; i < V; ++i) acc[i] = T(0);
  gather_row<T, G, V>(a.indptr[row], a.indptr[row + 1], gl, mask, live, a.B,
                      col, a.indices, static_cast<const T*>(a.vals),
                      static_cast<const T*>(a.X), acc);
  if (!live) return;
  const int64_t off = static_cast<int64_t>(row) * a.B + col;
  Pack<T, V> out;
  if constexpr (E == kStore) {
#pragma unroll
    for (int i = 0; i < V; ++i) out.a[i] = acc[i];
    store_row<T, V>(a.out, off, out);
  } else {
    // A fused half's streamed operands, read after the gather.
    const Pack<T, V> cur = load_row<T, V>(a.cur, off);
    const Pack<T, V> last = load_row<T, V>(a.last, off);
    const Pack<T, V> p0 = load_row<T, V>(a.p0, off);
    const Pack<T, V> p1 = load_row<T, V>(a.p1, off);
    Pack<T, V> p2;
    if constexpr (E == kXHalf) p2 = load_row<T, V>(a.p2, off);
    Pack<T, V> hat;
#pragma unroll
    for (int i = 0; i < V; ++i) {
      const int b = col + i;
      const bool act = a.active[b] != 0;
      const T f1 = halpern_f1<T>(a.inner[b] + (act ? a.t : 0));
      const T s = static_cast<const T*>(a.scal)[b];
      const T x = cur.a[i];
      T next;
      if constexpr (E == kXHalf) {
        next = x_half_update(acc[i], x, last.a[i], p0.a[i], p1.a[i],
                             p2.a[i], s, f1, hat.a[i]);
      } else {
        next = y_half_update(acc[i], x, last.a[i], p0.a[i], p1.a[i], s, f1);
      }
      out.a[i] = act ? next : x;
    }
    store_row<T, V>(a.out, off, out);
    if constexpr (E == kXHalf) store_row<T, V>(a.hat, off, hat);
  }
}

template <typename T, int G, int V>
int launch_gv(int epilogue, int grid_x, int n_slices, const Args& a,
              cudaStream_t stream) {
  const dim3 grid(static_cast<unsigned>(grid_x),
                  static_cast<unsigned>(n_slices));
  switch (epilogue) {
    case kStore:
      csr_spmm_kernel<T, G, V, kStore><<<grid, kBlock, 0, stream>>>(a);
      break;
    case kXHalf:
      csr_spmm_kernel<T, G, V, kXHalf><<<grid, kBlock, 0, stream>>>(a);
      break;
    case kYHalf:
      csr_spmm_kernel<T, G, V, kYHalf><<<grid, kBlock, 0, stream>>>(a);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int V>
int launch_v(int group, int epilogue, int grid_x, int n_slices,
             const Args& a, cudaStream_t stream) {
  switch (group) {
    case 1: return launch_gv<T, 1, V>(epilogue, grid_x, n_slices, a, stream);
    case 2: return launch_gv<T, 2, V>(epilogue, grid_x, n_slices, a, stream);
    case 4: return launch_gv<T, 4, V>(epilogue, grid_x, n_slices, a, stream);
    case 8: return launch_gv<T, 8, V>(epilogue, grid_x, n_slices, a, stream);
    case 16: return launch_gv<T, 16, V>(epilogue, grid_x, n_slices, a, stream);
    case 32: return launch_gv<T, 32, V>(epilogue, grid_x, n_slices, a, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T>
int launch(int group, int vec, int epilogue, int grid_x, int n_slices,
           const Args& a, cudaStream_t stream) {
  switch (vec) {
    case 1: return launch_v<T, 1>(group, epilogue, grid_x, n_slices, a, stream);
    case 2: return launch_v<T, 2>(group, epilogue, grid_x, n_slices, a, stream);
    case 4:
      if constexpr (sizeof(T) == 4) {
        return launch_v<T, 4>(group, epilogue, grid_x, n_slices, a, stream);
      } else {
        return static_cast<int>(cudaErrorInvalidValue);
      }
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// ---------------------------------------------------------------------
// The y-half's kernel: the gather through a cp.async ring.

// Per value type: the entries a commit group (kBatch; a lane's ring holds
// two batches) and the blocks an SM keeps (kMinBlocks, which caps the
// registers a thread: 64 at 4, 85 at 3).
template <typename T> struct Ring;
template <> struct Ring<float> {
  static constexpr int kBatch = 3, kMinBlocks = 4;
};
template <> struct Ring<double> {
  static constexpr int kBatch = 4, kMinBlocks = 3;
};
constexpr int kRingMaxSmem = 232448;  // the H100's dynamic shared memory cap

// The bytes of dynamic shared memory a block of the ring kernel takes (ops/
// spmm.py::ring_smem_bytes mirrors it): each thread's ring of two batches
// of slots of V values and one parked value each, and its row of the 4
// streamed operands.
template <typename T, int V>
constexpr int ring_smem_bytes() {
  return kBlock * (2 * Ring<T>::kBatch * (V + 1) + 4 * V) *
         static_cast<int>(sizeof(T));
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ uint64_t evict_first_policy() {
  uint64_t p;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;"
               : "=l"(p));
  return p;
}

// One cp.async of N bytes (4, 8 or 16: .ca below 16, .cg at 16), with or
// without an L2 cache policy.
template <int N>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
  if constexpr (N == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(
                     smem_addr(dst)), "l"(src) : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;" ::"r"(
                     smem_addr(dst)), "l"(src), "n"(N) : "memory");
  }
}

template <int N>
__device__ __forceinline__ void cp_async_hint(void* dst, const void* src,
                                              uint64_t policy) {
  if constexpr (N == 16) {
    asm volatile(
        "cp.async.cg.shared.global.L2::cache_hint [%0], [%1], 16, %2;" ::"r"(
            smem_addr(dst)), "l"(src), "l"(policy) : "memory");
  } else {
    asm volatile(
        "cp.async.ca.shared.global.L2::cache_hint [%0], [%1], %2, %3;" ::"r"(
            smem_addr(dst)), "l"(src), "n"(N), "l"(policy) : "memory");
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;" ::: "memory");
}

// A store of one lane's V values with an L2 cache policy.
template <typename T, int V>
__device__ __forceinline__ void store_hint(void* p, int64_t off,
                                           const Pack<T, V>& r,
                                           uint64_t policy) {
  constexpr int kWords = V * static_cast<int>(sizeof(T)) / 4;
  union {
    Pack<T, V> p;
    unsigned u[kWords];
  } w;
  w.p = r;
  T* dst = static_cast<T*>(p) + off;
  if constexpr (kWords == 4) {
    asm volatile("st.global.L2::cache_hint.v4.b32 [%0], {%1, %2, %3, %4}, %5;"
                 ::"l"(dst), "r"(w.u[0]), "r"(w.u[1]), "r"(w.u[2]),
                 "r"(w.u[3]), "l"(policy) : "memory");
  } else if constexpr (kWords == 2) {
    asm volatile("st.global.L2::cache_hint.v2.b32 [%0], {%1, %2}, %3;"
                 ::"l"(dst), "r"(w.u[0]), "r"(w.u[1]), "l"(policy)
                 : "memory");
  } else {
    asm volatile("st.global.L2::cache_hint.b32 [%0], %1, %2;" ::"l"(dst),
                 "r"(w.u[0]), "l"(policy) : "memory");
  }
}

// A group of G lanes owns one row of one slice; lane gl its V columns from
// col.  The row's n entries stream through the ring in batches of U, one
// commit group each, into two halves of U slots: while one batch is summed
// from one half, the next is in flight into the other.
template <typename T, int G, int V>
__global__ void __launch_bounds__(kBlock, Ring<T>::kMinBlocks)
spmm_y_ring_kernel(const Args a) {
  using P = Pack<T, V>;
  constexpr int U = Ring<T>::kBatch;
  constexpr int S = 2 * U;
  extern __shared__ __align__(16) unsigned char smem[];
  // [S][kBlock] segments, [S][kBlock] parked values, [4][kBlock] rows: a
  // thread's slots are kBlock apart, so a warp's accesses are contiguous.
  P* ring = reinterpret_cast<P*>(smem);
  T* parked = reinterpret_cast<T*>(ring + S * kBlock);
  P* rows = reinterpret_cast<P*>(parked + S * kBlock);

  const int tid = threadIdx.x;
  const int gl = (tid & 31) & (G - 1);  // lane within the group
  // G divides the block, so all lanes of a group share one row.
  const int row = blockIdx.x * (kBlock / G) + tid / G;
  if (row >= a.nrows) return;
  const int col = blockIdx.y * (G * V) + gl * V;
  // B % V == 0, so a lane's V columns are all in range or all out.
  const bool live = col < a.B;
  const T* __restrict__ X = static_cast<const T*>(a.X) + col;
  const int64_t off = static_cast<int64_t>(row) * a.B + col;

  // The row's entries, by their offset from its first: unsigned, since an
  // offset plus 4 U must not wrap near nnz = 2^31 - 1.  Every lane reads a
  // batch's columns and values itself (one address across its group), a
  // batch ahead of its copies.
  const int kb = a.indptr[row];
  const int* __restrict__ indices = a.indices + kb;
  const T* __restrict__ vals = static_cast<const T*>(a.vals) + kb;
  const unsigned n = static_cast<unsigned>(a.indptr[row + 1] - kb);
  int cn[U];
  T vn[U];
  auto fetch = [&](unsigned k0) {  // batch k0's columns and values
#pragma unroll
    for (int u = 0; u < U; ++u) {
      cn[u] = 0;
      vn[u] = T(0);
      if (k0 + u < n) {
        cn[u] = __ldg(indices + k0 + u);
        vn[u] = __ldg(vals + k0 + u);
      }
    }
  };
  auto copy = [&](unsigned k0, int half) {  // batch k0 into its half
    if (live) {
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (k0 + u < n) {
          const int slot = (half * U + u) * kBlock + tid;
          cp_async<sizeof(P)>(ring + slot,
                              X + static_cast<int64_t>(cn[u]) * a.B);
          parked[slot] = vn[u];
        }
      }
    }
    cp_async_commit();
  };

  T acc[V];
#pragma unroll
  for (int i = 0; i < V; ++i) acc[i] = T(0);
  // Batch k0 in `half`: wait for it, then sum it in CSR order.  The first
  // batch waits for its own group alone (the rows' and the second batch's
  // may still be in flight).
  auto consume = [&](unsigned k0, int half, bool first) {
    if (first) {
      cp_async_wait<2>();
    } else {
      cp_async_wait<1>();  // all but the newest group
    }
    if (!live) return;
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (k0 + u < n) {
        const int slot = (half * U + u) * kBlock + tid;
        const P x = ring[slot];
        const T av = parked[slot];
#pragma unroll
        for (int i = 0; i < V; ++i) acc[i] = fma_rn(av, x.a[i], acc[i]);
      }
    }
  };

  // The first batch's copies, then the streamed rows (their own group, so
  // that only the epilogue waits for them), then the second batch's.
  fetch(0);
  copy(0, 0);
  if (live) {
    const uint64_t policy = evict_first_policy();
    const void* src[4] = {a.cur, a.last, a.p0, a.p1};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      cp_async_hint<sizeof(P)>(rows + j * kBlock + tid,
                               static_cast<const T*>(src[j]) + off, policy);
    }
  }
  cp_async_commit();
  fetch(U);
  copy(U, 1);
  fetch(2 * U);
  for (unsigned k0 = 0; k0 < n; k0 += 2 * U) {
    consume(k0, 0, k0 == 0);
    if (k0 + U >= n) break;
    copy(k0 + 2 * U, 0);
    fetch(k0 + 3 * U);
    consume(k0 + U, 1, false);
    if (k0 + 2 * U >= n) break;
    copy(k0 + 3 * U, 1);
    fetch(k0 + 4 * U);
  }
  cp_async_wait_all();  // the rows, and at most empty groups besides
  if (!live) return;

  // The row's update from acc, its streamed rows and its members' scalars.
  const P* mine = rows + tid;
  const P cur = mine[0], last = mine[kBlock], p0 = mine[2 * kBlock],
          p1 = mine[3 * kBlock];
  P out;
#pragma unroll
  for (int i = 0; i < V; ++i) {
    const int b = col + i;
    const bool act = a.active[b] != 0;
    const T f1 = halpern_f1<T>(a.inner[b] + (act ? a.t : 0));
    const T s = static_cast<const T*>(a.scal)[b];
    const T next =
        y_half_update(acc[i], cur.a[i], last.a[i], p0.a[i], p1.a[i], s, f1);
    out.a[i] = act ? next : cur.a[i];
  }
  store_hint<T, V>(a.out, off, out, evict_first_policy());
}

// The launch arguments after the group and the vector width.
struct RingCall {
  bool init;
  int grid_x, n_slices;
  const Args& a;
  cudaStream_t stream;
};

// One instantiation of the ring kernel: with c.init, its attributes
// (dynamic shared memory up to kRingMaxSmem, the largest shared-memory
// carveout); else one launch.
template <typename T, int G, int V>
int ring_gv(const RingCall& c) {
  if (c.init) {
    const void* fn =
        reinterpret_cast<const void*>(spmm_y_ring_kernel<T, G, V>);
    cudaError_t e = cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize, kRingMaxSmem);
    if (e == cudaSuccess) {
      e = cudaFuncSetAttribute(fn,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
    }
    return static_cast<int>(e);
  }
  constexpr int smem = ring_smem_bytes<T, V>();
  static_assert(smem <= kRingMaxSmem, "the ring exceeds shared memory");
  const dim3 grid(static_cast<unsigned>(c.grid_x),
                  static_cast<unsigned>(c.n_slices));
  spmm_y_ring_kernel<T, G, V><<<grid, kBlock, smem, c.stream>>>(c.a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int V>
int ring_v(int group, const RingCall& c) {
  switch (group) {
    case 1: return ring_gv<T, 1, V>(c);
    case 2: return ring_gv<T, 2, V>(c);
    case 4: return ring_gv<T, 4, V>(c);
    case 8: return ring_gv<T, 8, V>(c);
    case 16: return ring_gv<T, 16, V>(c);
    case 32: return ring_gv<T, 32, V>(c);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T>
int ring(int group, int vec, const RingCall& c) {
  switch (vec) {
    case 1: return ring_v<T, 1>(group, c);
    case 2: return ring_v<T, 2>(group, c);
    case 4:
      if constexpr (sizeof(T) == 4) {
        return ring_v<T, 4>(group, c);
      } else {
        return static_cast<int>(cudaErrorInvalidValue);
      }
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Every instantiation's attributes: V 1, 2 (and 4 in f32) x G 1 .. 32.
template <typename T>
int ring_init_all() {
  for (int vec = 1; vec <= (sizeof(T) == 4 ? 4 : 2); vec *= 2) {
    for (int group = 1; group <= 32; group *= 2) {
      const Args none{};
      const int e = ring<T>(group, vec, RingCall{true, 0, 0, none, nullptr});
      if (e != 0) return e;
    }
  }
  return 0;
}

}  // namespace

extern "C" {

// The solver's SpMM (epilogue 0), and with epilogue 1 or 2 the fused x- or
// y-half (the operands as in Args above; pointers an epilogue does not
// read may be null).  A grid of grid_x x n_slices blocks of 256 threads:
// grid_x * (256 / group) must cover nrows, n_slices * group * vec must
// cover B, B % vec == 0, and every (rows, B) operand aligned to vec *
// sizeof(T).  Returns cudaGetLastError() after the launch (0 on success).
int hprlp_spmm(int is_f64, int epilogue, int nrows, int B, int group,
               int vec, int grid_x, int n_slices, int t, const void* indptr,
               const void* indices, const void* vals, const void* X,
               void* out, void* hat, const void* cur, const void* last,
               const void* p0, const void* p1, const void* p2,
               const void* scal, const void* inner, const void* active,
               void* stream) {
  if (B <= 0 || vec <= 0 || group <= 0 || B % vec != 0 ||
      static_cast<int64_t>(n_slices) * group * vec < B || n_slices > 65535 ||
      static_cast<int64_t>(grid_x) * (kBlock / group) < nrows) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (nrows <= 0) return 0;
  const Args a{nrows, B, t, static_cast<const int*>(indptr),
               static_cast<const int*>(indices), vals, X, out, hat, cur, last,
               p0, p1, p2, scal, static_cast<const int*>(inner),
               static_cast<const unsigned char*>(active)};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_f64 ? launch<double>(group, vec, epilogue, grid_x, n_slices, a, s)
                : launch<float>(group, vec, epilogue, grid_x, n_slices, a, s);
}

// The y-half's kernel (spmm_y_ring_kernel): its attributes, set once for
// every instantiation before any launch (dynamic shared memory up to
// kRingMaxSmem, the largest shared-memory carveout), with the calling
// thread's stream capture mode relaxed for the call, so that a first use
// inside a CUDA-graph capture is allowed.  Returns 0 or the CUDA error.
int hprlp_spmm_ring_init(void) {
  cudaStreamCaptureMode mode = cudaStreamCaptureModeRelaxed;
  cudaError_t e = cudaThreadExchangeStreamCaptureMode(&mode);
  if (e != cudaSuccess) return static_cast<int>(e);
  int err = ring_init_all<float>();
  if (err == 0) err = ring_init_all<double>();
  e = cudaThreadExchangeStreamCaptureMode(&mode);
  return err != 0 ? err : static_cast<int>(e);
}

// One launch of the y-half's kernel: the operands as for hprlp_spmm's
// epilogue 2 (cur = y, last = last_y, p0 = AL, p1 = AU, scal = lam_sigma),
// and its grid as hprlp_spmm's.  Returns cudaGetLastError() after the
// launch (0 on success).
int hprlp_spmm_y_ring(int is_f64, int nrows, int B, int group, int vec,
                      int grid_x, int n_slices, int t, const void* indptr,
                      const void* indices, const void* vals, const void* X,
                      void* out, const void* cur, const void* last,
                      const void* p0, const void* p1, const void* scal,
                      const void* inner, const void* active, void* stream) {
  if (B <= 0 || vec <= 0 || group <= 0 || B % vec != 0 ||
      static_cast<int64_t>(n_slices) * group * vec < B || n_slices > 65535 ||
      static_cast<int64_t>(grid_x) * (kBlock / group) < nrows) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (nrows <= 0) return 0;
  const Args a{nrows, B, t, static_cast<const int*>(indptr),
               static_cast<const int*>(indices), vals, X, out, nullptr, cur,
               last, p0, p1, nullptr, scal, static_cast<const int*>(inner),
               static_cast<const unsigned char*>(active)};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const RingCall c{false, grid_x, n_slices, a, s};
  return is_f64 ? ring<double>(group, vec, c) : ring<float>(group, vec, c);
}

const char* hprlp_spmm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
