"""Counterpart of benchmarks/prof_dual_acc.py on an NVIDIA GPU: the
"multi_acc" kernel family of ops/spmv_variants.py.

One, two or four accumulators per row in the "gather" backend's CSR
kernel (csrc/spmv_csr.cu on its row-block plan; n_acc=1 is csr_spmv's
launch): does the serial chain of rounded adds by which one thread sums a
row's staged products limit it?  Every variant is exact and bitwise its
plain version.

    python -m hprlp_tpu_torch.prof.prof_dual_acc [--size huge]

Prints, for A and A^T, one line per variant: us per SpMV, GB/s by the byte
model, share of the bound, its agreement with the plain version and A @ x,
and the card's name and power limit.  Needs a CUDA device.
"""

import sys

from . import study

FAMILY = "multi_acc"
VARIANTS = ("n_acc=1", "n_acc=2", "n_acc=4")


def run(mats: dict) -> list:
    """Time every variant on each matrix (name -> CUDA CsrMatrix)."""
    return study.measure(FAMILY, mats, VARIANTS)


def main(argv=None) -> int:
    return study.main(FAMILY, VARIANTS, argv)


if __name__ == "__main__":
    sys.exit(main())
