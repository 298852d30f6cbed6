// Variant studies of the port's CSR SpMV on Hopper (f32): the run-based
// kernels of two of the four families that replace the Pallas variant
// studies in benchmarks/.  The ablate and multi_acc families
// (prof_lane_ablate.py, prof_dual_acc.py), and the flush family's full,
// ablate the "gather" backend's row-block kernel instead and are
// instantiations of csrc/spmv_csr.cu (its note says what each variant
// isolates); segsum's full runs on the main path's tiles
// (csrc/spmv_tiled.cu, ONEHOT).  What stays here is run-based CSR, with no
// row plan:
//
// K3 flush -- replaces prof_flush_variants.py:46/:97 (pallas_call :122).
//    The TPU study merged the dynamic flushes of equal output windows.
//      full        csr_spmv's launch on the row-block plan (csrc/spmv_csr.cu)
//      runmerge    nnz-balanced (CSR-stream): each warp takes a run of 256
//                  consecutive nonzeros across row boundaries, finds each
//                  entry's row from indptr, sums by row with a segmented
//                  warp scan and stores at row ends.  A row split between
//                  warps is finished with atomicAdd, so its sum depends on
//                  the order of at most 2 + len/256 partials.
//      merge_all   the same runs with no segmentation: one reduction and
//                  one atomicAdd per run, into row (run % nrows).  Wrong; the
//                  ceiling of any run-based flush (timing only).
// K4 segsum -- replaces prof_kernel_variants.py:39/:121 (pallas_call :152).
//    The TPU study summed products by row as a one-hot matrix product on
//    the MXU.  Its exact variant, full, asks this of the main path's
//    layout and lives beside that kernel: csrc/spmv_tiled.cu, template
//    ONEHOT (the tiles' packed stream, x from shared-memory strips, rows
//    owned per strip, the segmented warp scan replaced by one mma.sync
//    m16n8k16 per 16 entries).  The three timing variants below keep the first
//    design on CSR: a warp takes 32 consecutive nonzeros (one per lane),
//    forms p = vals * x[idx], and sums p by row with mma.sync m16n8k8:
//    y_local = R P, R one-hot (16 x 8, R[r][k] = [rank_k == r], rank = row -
//    row of the first entry of the 8-entry sub-block), P (8 x 8) with p in
//    column 0 and zeros in the other seven.
//      mm_precomp  R read from one-hot bf16 tiles built outside the kernel
//                  (segsum_rtiles in ops/spmv_variants.py, 256 B per
//                  sub-block), p as bf16 hi + lo (2^-16 relative)
//      mm_hi1      R in the kernel, one bf16 pass (lossy; timing only)
//      mm_fused    one TF32 hi + lo product per 32-entry tile against the
//                  tile's first row, ranks clamped to 15 (wrong when a tile
//                  spans more than 16 rows; timing only)
//    Each sub-block's row sums go to y with atomicAdd (sub-blocks share
//    rows).  In all but mm_fused an entry 16 or more rows past its
//    sub-block's first row (only where empty rows intervene) is added by
//    itself with atomicAdd.
//
// What bounds them on the card: bytes, as for the CSR SpMV -- a value,
// a column index and a gathered x entry per nonzero, two rowptr entries
// and a y entry per row; the multiply-adds are negligible.  The run-based
// kernels add integer work per entry (row search, scan), atomics, and a
// zeroed y; mm_precomp reads 32 more bytes per nonzero.  Every kernel runs
// on the caller's stream, allocates nothing, and its launch returns
// cudaGetLastError().  The kernels that accumulate with atomicAdd need y
// zeroed by the caller.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int kBlock = 256;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kRun = 256;        // nonzeros per warp in the run-based kernels
constexpr uint32_t kOneF32 = 0x3f800000u;  // 1.0f, exact in TF32
constexpr uint32_t kOneBf16 = 0x3f80u;     // 1.0 in bf16

enum { kMergeAll = 1, kRunMerge = 2 };
enum { kMmPrecomp = 1, kMmHi1 = 2, kMmFused = 3 };

// ---------------------------------------------- run-based kernels (K3, K4)

// The row holding entry k: the largest r in [lo, hi) with indptr[r] <= k,
// given indptr[lo] <= k.
__device__ __forceinline__ int row_search(const int* __restrict__ indptr,
                                          int lo, int hi, int64_t k) {
  while (hi - lo > 1) {
    const int mid = lo + (hi - lo) / 2;
    if (indptr[mid] <= k) {
      lo = mid;
    } else {
      hi = mid;
    }
  }
  return lo;
}

// The row of each lane's entry k, for a slice of 32 consecutive entries
// whose first entry lies in row r_cur.  Each lane loads one of the next 32
// row ends, and counts how many of them are <= its k by a binary search
// over the lanes with shuffles.  Past 32 row ends (only where empty rows
// intervene) it searches indptr.  All 32 lanes must call it.
__device__ __forceinline__ int slice_row(const int* __restrict__ indptr,
                                         int nrows, int r_cur, int64_t k) {
  const int lane = threadIdx.x & 31;
  const int j = r_cur + 1 + lane;
  const int e = j <= nrows ? indptr[j] : INT_MAX;
  int cnt = 0;
#pragma unroll
  for (int step = 16; step > 0; step >>= 1) {
    const int probe = __shfl_sync(kFull, e, cnt + step - 1);
    if (probe <= k) cnt += step;
  }
  const int e_last = __shfl_sync(kFull, e, 31);
  if (cnt == 31 && e_last <= k) return row_search(indptr, r_cur + 32, nrows, k);
  return r_cur + cnt;
}

__device__ __forceinline__ void store_row(float* __restrict__ y, int r,
                                          float v, bool shared) {
  if (shared) {
    atomicAdd(y + r, v);
  } else {
    y[r] = v;
  }
}

__global__ void __launch_bounds__(kBlock)
runmerge_kernel(int nrows, int64_t nnz, const int* __restrict__ indptr,
                const int* __restrict__ indices,
                const float* __restrict__ vals, const float* __restrict__ x,
                float* __restrict__ y) {
  const int64_t warp = (static_cast<int64_t>(blockIdx.x) * blockDim.x +
                        threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  const int64_t k0 = warp * kRun;
  if (k0 >= nnz) return;  // the whole warp
  const int64_t k1 = k0 + kRun < nnz ? k0 + kRun : nnz;
  const int r_first = row_search(indptr, 0, nrows, k0);
  const int r_last = row_search(indptr, r_first, nrows, k1 - 1);
  // Only the run's first and last rows can hold entries of other warps.
  const bool first_shared = indptr[r_first] < k0;
  const bool last_shared = indptr[r_last + 1] > k1;
  int r_cur = r_first;
  int carry_row = -1;
  float carry = 0.f;
  for (int64_t s = k0; s < k1; s += 32) {
    const int64_t k = s + lane;
    const bool valid = k < k1;
    const int row = slice_row(indptr, nrows, r_cur, valid ? k : k1 - 1);
    const int key = valid ? row : INT_MAX;
    float v = valid ? vals[k] * __ldg(x + indices[k]) : 0.f;
    // Inclusive segmented scan by row; rows rise with the lane.
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float v_up = __shfl_up_sync(kFull, v, off);
      const int key_up = __shfl_up_sync(kFull, key, off);
      if (lane >= off && key_up == key) v += v_up;
    }
    const int key_next = __shfl_down_sync(kFull, key, 1);
    const bool seg_end = valid && (lane == 31 || key_next != key);
    if (carry_row >= 0) {
      // The previous slice's last row goes on here (its partial joins the
      // row's segment end) or ended with that slice (stored now).
      if (seg_end && key == carry_row) v += carry;
      if (lane == 0 && key != carry_row) {
        store_row(y, carry_row, carry,
                  (carry_row == r_first && first_shared) ||
                  (carry_row == r_last && last_shared));
      }
    }
    if (seg_end && lane != 31) {
      store_row(y, key, v, (key == r_first && first_shared) ||
                           (key == r_last && last_shared));
    }
    // Lane 31's row may go on into the next slice: carry it.
    carry = __shfl_sync(kFull, v, 31);
    carry_row = __shfl_sync(kFull, key, 31);
    if (carry_row == INT_MAX) carry_row = -1;
    r_cur = __shfl_sync(kFull, row, 31);
  }
  if (carry_row >= 0 && lane == 0) {
    store_row(y, carry_row, carry, (carry_row == r_first && first_shared) ||
                                   (carry_row == r_last && last_shared));
  }
}

__global__ void __launch_bounds__(kBlock)
merge_all_kernel(int nrows, int64_t nnz, const int* __restrict__ indices,
                 const float* __restrict__ vals, const float* __restrict__ x,
                 float* __restrict__ y) {
  const int64_t warp = (static_cast<int64_t>(blockIdx.x) * blockDim.x +
                        threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  const int64_t k0 = warp * kRun;
  if (k0 >= nnz) return;
  const int64_t k1 = k0 + kRun < nnz ? k0 + kRun : nnz;
  float v = 0.f;
  for (int64_t k = k0 + lane; k < k1; k += 32) {
    v += vals[k] * __ldg(x + indices[k]);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  if (lane == 0) atomicAdd(y + warp % nrows, v);
}

// ---------------------------------------------------------------- K4 segsum

// TF32 rounding of v (to nearest, ties away from zero), in f32 layout.
__device__ __forceinline__ uint32_t tf32_bits(float v) {
  return (__float_as_uint(v) + 0x1000u) & 0xffffe000u;
}

__device__ __forceinline__ uint32_t bf16_bits(float v) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(v));
}

__device__ __forceinline__ float bf16_value(uint32_t b) {
  return __uint_as_float(b << 16);
}

// Two bf16 in one register: `first` in the low half (the lower index).
__device__ __forceinline__ uint32_t pack_bf16(uint32_t first,
                                              uint32_t second) {
  return first | (second << 16);
}

// C += A B for A 16x8 (row), B 8x8 (col), TF32 in, f32 accumulate.
// Fragments (lane = 4 g + t): a = A[g][t], A[g+8][t], A[g][t+4], A[g+8][t+4];
// b = B[t][g], B[t+4][g]; c = C[g][2t], C[g][2t+1], C[g+8][2t], C[g+8][2t+1].
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

// C += A B, bf16 in, f32 accumulate.  a0 = (A[g][2t], A[g][2t+1]),
// a1 = (A[g+8][2t], A[g+8][2t+1]); b0 = (B[2t][g], B[2t+1][g]).
__device__ __forceinline__ void mma_bf16(float (&c)[4], uint32_t a0,
                                         uint32_t a1, uint32_t b0) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5}, {%6}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(b0));
}

// The TF32 A fragment of R for the 8 entries at lanes first..first+7, with
// ranks relative to `base` (clamped to 15 when `clamp`).
__device__ __forceinline__ void r_tf32(int row, int first, int base,
                                       bool clamp, int g, int t,
                                       uint32_t (&a)[4]) {
  int r0 = __shfl_sync(kFull, row, first + t) - base;
  int r1 = __shfl_sync(kFull, row, first + t + 4) - base;
  if (clamp) {
    r0 = min(r0, 15);
    r1 = min(r1, 15);
  }
  a[0] = r0 == g ? kOneF32 : 0u;
  a[1] = r0 == g + 8 ? kOneF32 : 0u;
  a[2] = r1 == g ? kOneF32 : 0u;
  a[3] = r1 == g + 8 ? kOneF32 : 0u;
}

// Adds the 16 row sums in column 0 of C (lanes with t == 0 hold rows g and
// g + 8) for ranks 0..top.
__device__ __forceinline__ void flush_c(float* __restrict__ y, const float (&c)[4],
                                        int base, int top, int g, int t) {
  if (t != 0) return;
  if (g <= top) atomicAdd(y + base + g, c[0]);
  if (g + 8 <= top) atomicAdd(y + base + g + 8, c[2]);
}

template <int V>
__global__ void __launch_bounds__(kBlock)
segsum_kernel(int nrows, int64_t nnz, const int* __restrict__ indptr,
              const int* __restrict__ indices, const float* __restrict__ vals,
              const float* __restrict__ x, const uint2* __restrict__ rtiles,
              float* __restrict__ y) {
  const int64_t warp = (static_cast<int64_t>(blockIdx.x) * blockDim.x +
                        threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int64_t k0 = warp * kRun;
  if (k0 >= nnz) return;
  const int64_t k1 = k0 + kRun < nnz ? k0 + kRun : nnz;
  int r_cur = row_search(indptr, 0, nrows, k0);
  for (int64_t s = k0; s < k1; s += 32) {
    const int64_t k = s + lane;
    const bool valid = k < k1;
    const int row = slice_row(indptr, nrows, r_cur, valid ? k : k1 - 1);
    r_cur = __shfl_sync(kFull, row, 31);
    // __fmul_rn: no contraction of the product into the split below.
    const float p = valid ? __fmul_rn(vals[k], __ldg(x + indices[k])) : 0.f;
    // The product as the tensor cores take it: hi (+ lo) bit patterns, and
    // pe = hi + lo, the value this variant adds for the entry.
    uint32_t hi, lo;
    float pe;
    if constexpr (V == kMmFused) {
      hi = tf32_bits(p);
      lo = tf32_bits(p - __uint_as_float(hi));
      pe = __uint_as_float(hi) + __uint_as_float(lo);
    } else {
      hi = bf16_bits(p);
      lo = V == kMmPrecomp ? bf16_bits(p - bf16_value(hi)) : 0u;
      pe = bf16_value(hi) + bf16_value(lo);
    }
    if constexpr (V == kMmFused) {
      // One product for the whole tile against its first row.
      const int base = __shfl_sync(kFull, row, 0);
      float c[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        uint32_t a[4];
        r_tf32(row, 8 * j, base, true, g, t, a);
        const uint32_t h0 = __shfl_sync(kFull, hi, 8 * j + t);
        const uint32_t h1 = __shfl_sync(kFull, hi, 8 * j + t + 4);
        const uint32_t l0 = __shfl_sync(kFull, lo, 8 * j + t);
        const uint32_t l1 = __shfl_sync(kFull, lo, 8 * j + t + 4);
        // Column 0 of P holds the products; the other columns are zero.
        mma_tf32(c, a[0], a[1], a[2], a[3], g == 0 ? h0 : 0u, g == 0 ? h1 : 0u);
        mma_tf32(c, a[0], a[1], a[2], a[3], g == 0 ? l0 : 0u, g == 0 ? l1 : 0u);
      }
      flush_c(y, c, base, min(__shfl_sync(kFull, row, 31) - base, 15), g, t);
      continue;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (s + 8 * j >= k1) break;  // warp-uniform: past the run's end
      const int base = __shfl_sync(kFull, row, 8 * j);
      float c[4] = {0.f, 0.f, 0.f, 0.f};
      {
        uint32_t a0, a1;
        if constexpr (V == kMmPrecomp) {
          const uint2 r = rtiles[((s >> 3) + j) * 32 + lane];
          a0 = r.x;
          a1 = r.y;
        } else {
          const int r0 = __shfl_sync(kFull, row, 8 * j + 2 * t) - base;
          const int r1 = __shfl_sync(kFull, row, 8 * j + 2 * t + 1) - base;
          a0 = pack_bf16(r0 == g ? kOneBf16 : 0u, r1 == g ? kOneBf16 : 0u);
          a1 = pack_bf16(r0 == g + 8 ? kOneBf16 : 0u,
                         r1 == g + 8 ? kOneBf16 : 0u);
        }
        const uint32_t h0 = __shfl_sync(kFull, hi, 8 * j + 2 * t);
        const uint32_t h1 = __shfl_sync(kFull, hi, 8 * j + 2 * t + 1);
        mma_bf16(c, a0, a1, g == 0 ? pack_bf16(h0, h1) : 0u);
        if constexpr (V == kMmPrecomp) {
          const uint32_t l0 = __shfl_sync(kFull, lo, 8 * j + 2 * t);
          const uint32_t l1 = __shfl_sync(kFull, lo, 8 * j + 2 * t + 1);
          mma_bf16(c, a0, a1, g == 0 ? pack_bf16(l0, l1) : 0u);
        }
      }
      flush_c(y, c, base, min(__shfl_sync(kFull, row, 8 * j + 7) - base, 15),
              g, t);
    }
    // An entry 16 or more rows past its sub-block's first row has no place
    // in R: it is added by itself.
    const int own_base = __shfl_sync(kFull, row, lane & ~7);
    if (valid && row - own_base >= 16) atomicAdd(y + row, pe);
  }
}

// ------------------------------------------------------------------ launch

unsigned run_grid(int64_t nnz) {
  const int64_t threads = (nnz + kRun - 1) / kRun * 32;
  return static_cast<unsigned>((threads + kBlock - 1) / kBlock);
}

}  // namespace

extern "C" {

// Each returns cudaGetLastError() after the launch (0 on success), or
// cudaErrorInvalidValue for a variant it does not know.

// merge_all and runmerge (y zeroed by the caller).
int hprlp_spmv_flush(int variant, int nrows, long long nnz,
                     const void* indptr, const void* indices,
                     const void* vals, const void* x, void* y,
                     void* stream) {
  if (nrows <= 0 || nnz <= 0) return 0;
  const int* ip = static_cast<const int*>(indptr);
  const int* ix = static_cast<const int*>(indices);
  const float* v = static_cast<const float*>(vals);
  const float* xv = static_cast<const float*>(x);
  float* yv = static_cast<float*>(y);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (variant) {
    case kMergeAll:
      merge_all_kernel<<<run_grid(nnz), kBlock, 0, s>>>(nrows, nnz, ix, v, xv, yv);
      break;
    case kRunMerge:
      runmerge_kernel<<<run_grid(nnz), kBlock, 0, s>>>(nrows, nnz, ip, ix, v, xv, yv);
      break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// The CSR segsum variants (mm_*) need y zeroed; rtiles is read by
// mm_precomp only.
int hprlp_spmv_segsum(int variant, int nrows, long long nnz,
                      const void* indptr, const void* indices,
                      const void* vals, const void* x, const void* rtiles,
                      void* y, void* stream) {
  if (nrows <= 0 || nnz <= 0) return 0;
  const int* ip = static_cast<const int*>(indptr);
  const int* ix = static_cast<const int*>(indices);
  const float* v = static_cast<const float*>(vals);
  const float* xv = static_cast<const float*>(x);
  const uint2* rt = static_cast<const uint2*>(rtiles);
  float* yv = static_cast<float*>(y);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned grid = run_grid(nnz);
  switch (variant) {
    case kMmPrecomp: segsum_kernel<kMmPrecomp><<<grid, kBlock, 0, s>>>(nrows, nnz, ip, ix, v, xv, rt, yv); break;
    case kMmHi1: segsum_kernel<kMmHi1><<<grid, kBlock, 0, s>>>(nrows, nnz, ip, ix, v, xv, rt, yv); break;
    case kMmFused: segsum_kernel<kMmFused><<<grid, kBlock, 0, s>>>(nrows, nnz, ip, ix, v, xv, rt, yv); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* hprlp_variants_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
