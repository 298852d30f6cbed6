"""Counterpart of benchmarks/prof_kernel_variants.py on an NVIDIA GPU: the
"segsum" kernel family of ops/spmv_variants.py.

The segmented sum of products by row as tensor-core one-hot products
(mma.sync): on the main path's tiles, one m16n8k16 product per 16 entries
of a warp's stream with the products as three bf16 terms, in place of the
tiled kernel's segmented warp scan (full); on CSR, with host-built bf16 R
tiles and bf16 hi+lo (mm_precomp), in one bf16 pass (mm_hi1), or one
product per 32-entry tile with clamped ranks (mm_fused).

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
