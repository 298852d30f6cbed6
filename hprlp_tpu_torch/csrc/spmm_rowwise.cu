// CSR SpMM for Hopper, the previous design: Y = A X, with X (ncols, B) and
// Y (nrows, B) dense and row-major, so that the B values of one row are
// contiguous.  It is kept in its own library to be timed beside the
// solver's design (csrc/spmm.cu; ops/spmm.py::csr_spmm_rowwise), as
// csrc/spmv.cu is kept beside csrc/spmv_tiled.cu; no solve launches it.
// Both sum every output in CSR order, one fma an entry, so their outputs
// are bitwise equal.
//
// Replaces no Pallas kernel: the JAX package computes this product outside
// any kernel, as an XLA gather einsum over its ELL buckets
// (hprlp_tpu/ops/sparse.py:594-608, spmm), where the reference calls
// cuSPARSE's SpMM (src/batched_solver.cu:428-477).
//
// What bounds it: bytes.  Each stored entry's value and int32 column index
// are read once, each row of Y is written once, and X's rows are gathered,
// B values for every entry: nnz * B * sizeof(T) bytes, from L2 while X
// fits its 50 MB, else from HBM.  Its 2 * nnz * B operations are far below
// the card's rate.
//
// The design: a group of G lanes (G a power of two, at most a warp) owns
// one (row, column slice) of Y, and each lane V adjacent columns of it, so
// a slice is G * V columns wide.  The wrapper (ops/spmm.py) picks V, the
// widest load (16, 8 or 4 bytes) that B and X's alignment allow, and G,
// the least power of two with G * V >= B, at most 32.  The group reads its
// row's (index, value) pairs G at a time, one per lane (coalesced), and
// broadcasts each with a shuffle; for each pair it reads the slice of X's
// row (G * V contiguous values, coalesced) and each lane adds value * x
// into V registers.  So every output is summed in CSR order in registers:
// deterministic, no atomics, no second pass.  Columns at or past B are
// masked; an empty row writes zeros.  Tasks run in row-major order over
// slices, so at large B every slice's X is live at once.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kBlock = 256;

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

template <typename T, int G, int V>
__global__ void __launch_bounds__(kBlock)
csr_spmm_kernel(int nrows, int B, int n_slices,
                const int* __restrict__ indptr,
                const int* __restrict__ indices, const T* __restrict__ vals,
                const T* __restrict__ X, T* __restrict__ Y) {
  using VT = typename Vec<T, V>::type;
  const int lane = threadIdx.x & 31;
  const int gl = lane & (G - 1);  // lane within the group
  const unsigned mask = (0xffffffffu >> (32 - G)) << (lane - gl);
  // G divides the block, so all lanes of a group share one task.
  const int64_t task =
      (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) / G;
  if (task >= static_cast<int64_t>(nrows) * n_slices) return;
  const int row = static_cast<int>(task / n_slices);
  const int col = static_cast<int>(task % n_slices) * (G * V) + gl * V;
  // B % V == 0, so a lane's V columns are all in range or all out.
  const bool live = col < B;

  T acc[V];
#pragma unroll
  for (int i = 0; i < V; ++i) acc[i] = T(0);
  const int64_t end = indptr[row + 1];
  // 64-bit entry index: k0 + G must not wrap near nnz = 2^31 - 1.
  for (int64_t k0 = indptr[row]; k0 < end; k0 += G) {
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
        for (int i = 0; i < V; ++i) acc[i] += aj * x.a[i];
      }
    }
  }
  if (live) {
    Pack<T, V> y;
#pragma unroll
    for (int i = 0; i < V; ++i) y.a[i] = acc[i];
    *reinterpret_cast<VT*>(Y + static_cast<int64_t>(row) * B + col) = y.v;
  }
}

struct Args {
  int nrows, B, n_slices;
  const int* indptr;
  const int* indices;
  const void* vals;
  const void* X;
  void* Y;
  cudaStream_t stream;
};

template <typename T, int G, int V>
int launch_gv(const Args& a) {
  const int64_t threads = static_cast<int64_t>(a.nrows) * a.n_slices * G;
  const int64_t grid = (threads + kBlock - 1) / kBlock;
  if (grid > INT32_MAX) return static_cast<int>(cudaErrorInvalidConfiguration);
  csr_spmm_kernel<T, G, V><<<static_cast<unsigned>(grid), kBlock, 0,
                             a.stream>>>(
      a.nrows, a.B, a.n_slices, a.indptr, a.indices,
      static_cast<const T*>(a.vals), static_cast<const T*>(a.X),
      static_cast<T*>(a.Y));
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int V>
int launch_v(int group, const Args& a) {
  switch (group) {
    case 1: return launch_gv<T, 1, V>(a);
    case 2: return launch_gv<T, 2, V>(a);
    case 4: return launch_gv<T, 4, V>(a);
    case 8: return launch_gv<T, 8, V>(a);
    case 16: return launch_gv<T, 16, V>(a);
    case 32: return launch_gv<T, 32, V>(a);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T>
int launch(int group, int vec, const Args& a) {
  switch (vec) {
    case 1: return launch_v<T, 1>(group, a);
    case 2: return launch_v<T, 2>(group, a);
    case 4:
      if constexpr (sizeof(T) == 4) {
        return launch_v<T, 4>(group, a);
      } else {
        return static_cast<int>(cudaErrorInvalidValue);
      }
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// Y = A X.  group (G) and vec (V) as in the notes above; n_slices * G * V
// must cover B, and B % V == 0 with X and Y aligned to V * sizeof(T).
// Returns cudaGetLastError() after the launch (0 on success).
int hprlp_csr_spmm(int is_f64, int nrows, int B, int group, int vec,
                   int n_slices, const void* indptr, const void* indices,
                   const void* vals, const void* X, void* Y, void* stream) {
  if (B <= 0 || vec <= 0 || B % vec != 0 ||
      static_cast<int64_t>(n_slices) * group * vec < B) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (nrows <= 0) return 0;
  const Args a{nrows, B, n_slices, static_cast<const int*>(indptr),
               static_cast<const int*>(indices), vals, X, Y,
               static_cast<cudaStream_t>(stream)};
  return is_f64 ? launch<double>(group, vec, a) : launch<float>(group, vec, a);
}

const char* hprlp_spmm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
