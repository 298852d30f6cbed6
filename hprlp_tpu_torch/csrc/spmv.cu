// Row-parallel ("vector") CSR SpMV for Hopper: y = A x over the padded
// row/column spaces of the solver's layout.
//
// Replaces the four Pallas TPU kernels of hprlp_tpu/ops/pallas_spmv.py:
//   lane_spmv       (aligned LaneELL tiles, f32)
//   thin_spmv       (packed thin LaneELL tiles, f32)
//   lane_spmv_df64  (aligned tiles on double-f32 pairs)
//   thin_spmv_df64  (thin tiles on double-f32 pairs)
// All four compute the same contract; their aligned/thin split, 128x128
// x-windows and int8 crossbar indices exist only for the TPU's lane
// crossbar.  The float instantiation replaces the two f32 kernels and
// accumulates in f32 as they do; the double instantiation replaces the two
// df64 kernels with native f64 (no hi/lo pairs).
//
// What bounds it: bytes.  Each nonzero reads its value (4 or 8 B), its
// column index (4 B) and a gathered x entry (4 or 8 B, mostly from L2),
// and each row reads two rowptr entries and writes one y entry; the
// multiply-add per nonzero is negligible next to that traffic.
// What the design does about it: a group of TPR threads owns one row and
// strides over its entries, so a group reads one contiguous strip of
// values and indices (coalesced), the row's partial sums are combined with
// warp shuffles, and the group's first lane writes y once -- no atomics
// and no second pass.  TPR is picked by the caller from the mean row
// length.  Row-length bucketing, keeping x in shared memory and fusing
// the solver's elementwise epilogues are left to later work.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kBlock = 256;

template <typename T, int TPR>
__global__ void __launch_bounds__(kBlock)
csr_spmv_kernel(int nrows, const int* __restrict__ indptr,
                const int* __restrict__ indices, const T* __restrict__ vals,
                const T* __restrict__ x, T* __restrict__ y) {
  const int64_t tid = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  const int64_t row = tid / TPR;
  const int lane = static_cast<int>(tid % TPR);
  const bool active = row < nrows;
  T sum = T(0);
  if (active) {
    // 64-bit entry index: k + TPR must not wrap near nnz = 2^31 - 1.
    const int64_t end = indptr[row + 1];
    for (int64_t k = indptr[row] + lane; k < end; k += TPR) {
      sum += vals[k] * __ldg(x + indices[k]);
    }
  }
  // Every lane of the warp reaches the shuffles (inactive rows carry 0),
  // so the full mask is valid; width TPR keeps each row's group apart.
#pragma unroll
  for (int off = TPR / 2; off > 0; off >>= 1) {
    sum += __shfl_down_sync(0xffffffffu, sum, off, TPR);
  }
  if (active && lane == 0) y[row] = sum;
}

template <typename T>
int launch(int nrows, int tpr, const void* indptr, const void* indices,
           const void* vals, const void* x, void* y, void* stream) {
  if (nrows <= 0) return 0;
  const int64_t threads = static_cast<int64_t>(nrows) * tpr;
  const unsigned grid = static_cast<unsigned>((threads + kBlock - 1) / kBlock);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* ip = static_cast<const int*>(indptr);
  const int* ix = static_cast<const int*>(indices);
  const T* v = static_cast<const T*>(vals);
  const T* xv = static_cast<const T*>(x);
  T* yv = static_cast<T*>(y);
  switch (tpr) {
    case 2: csr_spmv_kernel<T, 2><<<grid, kBlock, 0, s>>>(nrows, ip, ix, v, xv, yv); break;
    case 4: csr_spmv_kernel<T, 4><<<grid, kBlock, 0, s>>>(nrows, ip, ix, v, xv, yv); break;
    case 8: csr_spmv_kernel<T, 8><<<grid, kBlock, 0, s>>>(nrows, ip, ix, v, xv, yv); break;
    case 16: csr_spmv_kernel<T, 16><<<grid, kBlock, 0, s>>>(nrows, ip, ix, v, xv, yv); break;
    case 32: csr_spmv_kernel<T, 32><<<grid, kBlock, 0, s>>>(nrows, ip, ix, v, xv, yv); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Each returns cudaGetLastError() after the launch (0 on success).
int hprlp_csr_spmv_f32(int nrows, int tpr, const void* indptr,
                       const void* indices, const void* vals, const void* x,
                       void* y, void* stream) {
  return launch<float>(nrows, tpr, indptr, indices, vals, x, y, stream);
}

int hprlp_csr_spmv_f64(int nrows, int tpr, const void* indptr,
                       const void* indices, const void* vals, const void* x,
                       void* y, void* stream) {
  return launch<double>(nrows, tpr, indptr, indices, vals, x, y, stream);
}

const char* hprlp_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
