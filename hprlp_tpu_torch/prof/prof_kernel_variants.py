"""Counterpart of benchmarks/prof_kernel_variants.py on an NVIDIA GPU: the
"segsum" kernel family of ops/spmv_variants.py.

The segmented sum of products by row as tensor-core one-hot products
(mma.sync), all on the main path's tiles (csrc/spmv_tiled.cu, template
SEG): one m16n8k16 product per 16 entries of a warp's stream in place of
the tiled kernel's segmented warp scan, with the products as three bf16
terms and ranks found in the kernel (full), as bf16 hi + lo with R built
outside the kernel (mm_precomp: segsum_rtiles), as one bf16 term
(mm_hi1), or one TF32 product per 128-entry warp step with ranks against
its first row clamped to 15 (mm_fused).

    python -m hprlp_tpu_torch.prof.prof_kernel_variants [--size huge]

Prints, for A and A^T, one line per variant: us per SpMV, GB/s by the byte
model, share of the bound, max abs error against the plain version, and
the card's name and power limit.  Needs a CUDA device.
"""

import sys

from . import study

FAMILY = "segsum"
VARIANTS = ("mm_fused", "mm_hi1", "mm_precomp", "full")


def run(mats: dict) -> list:
    """Time every variant on each matrix (name -> CUDA CsrMatrix)."""
    return study.measure(FAMILY, mats, VARIANTS)


def main(argv=None) -> int:
    return study.main(FAMILY, VARIANTS, argv)


if __name__ == "__main__":
    sys.exit(main())
