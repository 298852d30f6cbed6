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
// What bounds it: bytes.  Each stored entry's value and int32 column index
// are read once and each row of Y is written once, but X's rows are
// gathered, B values for every entry: nnz * B * sizeof(T) bytes, ~20 random
// rows per output row, from L2 while X fits its 50 MB, else from HBM.  So
// the HBM bound (X once) is out of reach, and L2's rate sets the pace of
// the gather.  Tensor cores do not apply: at ~20 random columns per row,
// 2 * nnz * B operations are far below the card's rate, and a wgmma tile
// would be almost all zeros.  None is used.
//
// The design (csr_spmm_kernel):
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
//  * One gather in flight per lane, and at most 64 registers a thread (4
//    blocks per SM): the card's many resident warps keep L2 busy.  On an
//    H100, 2, 4 or 8 gathers in flight per lane, or no register cap, were
//    slower at every shape measured (PERF.md section 6).
//  * Every output sums its row's products in CSR order, one fma each, in
//    registers: deterministic, no atomics, no second pass, and bitwise
//    equal to the previous design (csrc/spmm_rowwise.cu), which sums in
//    the same order.  Columns at or past B are masked; an empty row writes
//    zeros.
//
// The fused halves (epilogues kXHalf and kYHalf) run the same main loop and
// replace the store of Y by one HPR half-update per (row, member), with the
// member's scalars read from (B,) arrays, as solver/batched.py::
// x_half_plain and y_half_plain compute them with PyTorch's elementwise
// kernels; the update and its rounding rules are csrc/hpr_half.cuh's, so
// a fused iteration is bitwise equal to the plain ops run on the same SpMM
// output.  A frozen member's iterate is written
// back unchanged.  Their streamed operands are read after the gather:
// reading them before it was slower on an H100.

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

const char* hprlp_spmm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
