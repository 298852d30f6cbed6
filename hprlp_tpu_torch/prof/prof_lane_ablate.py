"""Counterpart of benchmarks/prof_lane_ablate.py on an NVIDIA GPU: the
"ablate" kernel family of ops/spmv_variants.py.

Ablates the row-parallel CSR kernel to locate its gap to the byte bound:
the streaming floor (dma_only), the random x gather (no_gather), a
16384-entry x window (one_gather), the shuffle reduction (no_flush),
against the whole kernel (full).

    python -m hprlp_tpu_torch.prof.prof_lane_ablate [--size huge]

Prints, for A and A^T, one line per variant: us per SpMV, GB/s by the byte
model, share of the bound, max abs error against the plain version, and
the card's name and power limit.  Needs a CUDA device.
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
