"""Counterpart of benchmarks/prof_lane_ablate.py on an NVIDIA GPU: the
"ablate" kernel family of ops/spmv_variants.py.

Ablates the "gather" backend's CSR kernel (csrc/spmv_csr.cu on its
row-block plan, the kernel a solve on "gather" runs) to locate its gap to
the byte bound: the streaming floor (dma_only), the random x gather
(no_gather), each row block's reads confined to one 16384-entry x window
(one_gather: what a column-windowed layout would buy), the staging and
per-row sums (no_flush), against the whole kernel (full, csr_spmv's
launch).

    python -m hprlp_tpu_torch.prof.prof_lane_ablate [--size huge]

Prints, for A and A^T, one line per variant: us per SpMV, GB/s by the byte
model, share of the bound (dma_only's without x, which it does not read),
its agreement with the plain version, and the card's name and power
limit.  Needs a CUDA device.
"""

import sys

from . import study

FAMILY = "ablate"
VARIANTS = ("dma_only", "no_gather", "one_gather", "no_flush", "full")


def run(mats: dict) -> list:
    """Time every variant on each matrix (name -> CUDA CsrMatrix)."""
    return study.measure(FAMILY, mats, VARIANTS)


def main(argv=None) -> int:
    return study.main(FAMILY, VARIANTS, argv)


if __name__ == "__main__":
    sys.exit(main())
