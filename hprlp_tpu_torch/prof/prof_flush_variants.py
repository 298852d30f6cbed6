"""Counterpart of benchmarks/prof_flush_variants.py on an NVIDIA GPU: the
"flush" kernel family of ops/spmv_variants.py.

Flush strategies, all on the "gather" backend's CSR kernel and its
row-block plan (csrc/spmv_csr.cu): per-row sums and one store per row
(full: csr_spmv's launch), against the same stream flushed at row ends by
a segmented warp scan over 128-entry warp segments (runmerge, exact), or
merged into one atomicAdd per segment (merge_all, wrong: the ceiling).

    python -m hprlp_tpu_torch.prof.prof_flush_variants [--size huge]

Prints, for A and A^T, one line per variant: us per SpMV, GB/s by the byte
model, share of the bound, its agreement with the plain version, and the
card's name and power limit.  Needs a CUDA device.
"""

import sys

from . import study

FAMILY = "flush"
VARIANTS = ("full", "merge_all", "runmerge")


def run(mats: dict) -> list:
    """Time every variant on each matrix (name -> CUDA CsrMatrix)."""
    return study.measure(FAMILY, mats, VARIANTS)


def main(argv=None) -> int:
    return study.main(FAMILY, VARIANTS, argv)


if __name__ == "__main__":
    sys.exit(main())
