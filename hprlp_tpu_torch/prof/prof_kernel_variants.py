"""Counterpart of benchmarks/prof_kernel_variants.py on an NVIDIA GPU: the
"segsum" kernel family of ops/spmv_variants.py.

The segmented sum of products by row as tensor-core one-hot products
(mma.sync): per 8-entry sub-block with TF32 hi+lo (full), with host-built
bf16 R tiles and bf16 hi+lo (mm_precomp), in one bf16 pass (mm_hi1), or
one product per 32-entry tile with clamped ranks (mm_fused).

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
