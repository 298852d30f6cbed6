"""Command-line LP solver: ``python -m hprlp_tpu_torch.cli -i model.mps``.

Port of hprlp_tpu/cli.py: the same flags, defaults, solution file and exit
codes (0 OPTIMAL, 1 input or parse error, 2 any other status).  --device
takes a CUDA device index (default 0) or ``cpu``; without CUDA the CLI
fails unless ``--device cpu`` is given.  --cusparse-spmv true forces the
CSR SpMV backend ("gather"), as the JAX CLI does.  --precision mixed
solves by f32 stages refined in host f64 (solver/refine.py).  --mesh N
solves on N ranks, one process per card (cards 0..N-1), or N gloo ranks
on the CPU with --device cpu (Parameters.mesh_shape, parallel/).
--malloc-tune tunes the host allocator (_malloc.tune_malloc(thp=True):
mallopt and the host-global transparent-hugepage policy, restored at
exit), as the JAX CLI does; launched ranks tune their own.
"""

from __future__ import annotations

import argparse
import os
import sys


def _bool(s: str) -> bool:
    t = s.strip().lower()
    if t in ("true", "1", "yes", "on"):
        return True
    if t in ("false", "0", "no", "off"):
        return False
    raise argparse.ArgumentTypeError(f"expected true/false, got {s!r}")


def _device(s: str):
    """A CUDA device index, or the string "cpu"."""
    if s.strip().lower() == "cpu":
        return "cpu"
    try:
        return int(s)
    except ValueError:
        raise argparse.ArgumentTypeError(
            f"expected a CUDA device index or 'cpu', got {s!r}") from None


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="hprlp-solve",
        description="Solve an LP from an MPS file with the HPR-LP solver on "
                    "PyTorch and CUDA.")
    p.add_argument("-i", "--input", required=True,
                   help="Path to input .mps or .mps.gz file")
    p.add_argument("--device", type=_device, default=0,
                   help="CUDA device index, or 'cpu' (default: 0)")
    p.add_argument("--max-iter", type=int, default=2**31 - 1,
                   help="Max iterations (default: INT32_MAX)")
    p.add_argument("--tol", type=float, default=1e-4,
                   help="Stopping tolerance (default: 1e-4)")
    p.add_argument("--time-limit", type=float, default=3600.0,
                   help="Time limit in seconds (default: 3600)")
    p.add_argument("--check-iter", type=int, default=150,
                   help="Check interval (default: 150)")
    p.add_argument("--cusparse-spmv", type=_bool, default=False,
                   metavar="true/false",
                   help="Force the plain (non-fused) SpMV backend: the "
                        "CSR kernel in place of the autotuned choice")
    p.add_argument("--autotune-verbose", type=_bool, default=False,
                   metavar="true/false",
                   help="Print SpMV backend autotune results")
    p.add_argument("--cr", type=_bool, default=True, metavar="true/false",
                   help="Curtis-Reid prescaling (default: true)")
    p.add_argument("--ruiz", type=_bool, default=True, metavar="true/false",
                   help="Ruiz scaling (default: true)")
    p.add_argument("--pock", type=_bool, default=True, metavar="true/false",
                   help="Pock-Chambolle scaling (default: true)")
    p.add_argument("--bc", type=_bool, default=True, metavar="true/false",
                   help="Bounds/cost scaling (default: true)")
    p.add_argument("--presolve", type=_bool, default=True,
                   metavar="true/false",
                   help="Presolve (default: true)")
    p.add_argument("--precision",
                   choices=("auto", "f32", "f64", "mixed"),
                   default="auto",
                   help="Solve precision (default: auto; mixed: f32 "
                        "stages refined in host f64, then an f64 tail)")
    p.add_argument("--mesh", type=int, default=None, metavar="N",
                   help="Shard the solve over N ranks, one per card "
                        "(cards 0..N-1; with --device cpu, N CPU ranks)")
    p.add_argument("--mps-format", choices=("free", "fixed"),
                   default="free",
                   help="MPS card format: free (whitespace tokens, default) "
                        "or fixed (column positions; names may contain "
                        "spaces)")
    p.add_argument("--quiet", action="store_true", help="Suppress progress")
    p.add_argument("--malloc-tune", action="store_true",
                   help="Tune the host allocator for giant ingest (brk-heap "
                        "mallopt + transparent hugepages; THP is a "
                        "host-global kernel policy, restored at exit)")
    p.add_argument("--solution-out", metavar="FILE", default=None,
                   help="Write status/objective/x/y/z to FILE in a plain "
                        "text format (consumed by the Julia/MATLAB "
                        "wrappers)")
    return p


def write_solution(path: str, res) -> None:
    """Plain-text solution file: `key value` lines, then one `<name> <len>`
    header per vector followed by its values, one per line."""
    with open(path, "w") as f:
        f.write(f"status {res.status}\n")
        f.write(f"iter {res.iter}\n")
        f.write(f"time {res.time!r}\n")
        f.write(f"primal_obj {res.primal_obj!r}\n")
        f.write(f"dual_obj {res.dual_obj!r}\n")
        f.write(f"gap {res.gap!r}\n")
        f.write(f"residuals {res.residuals!r}\n")
        for name in ("x", "y", "z"):
            v = getattr(res, name)
            if v is None:
                f.write(f"{name} 0\n")
                continue
            f.write(f"{name} {len(v)}\n")
            for val in v:
                f.write(f"{float(val)!r}\n")


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if not os.path.exists(args.input):
        print(f"Input file not found: {args.input}", file=sys.stderr)
        return 1

    if args.malloc_tune:
        from ._malloc import tune_malloc

        tune_malloc(thp=True)
        # Ranks that --mesh launches inherit the environment: they tune
        # their own allocators at import.
        os.environ.setdefault("HPRLP_MALLOC_TUNE", "1")

    import torch

    if args.device != "cpu" and not torch.cuda.is_available():
        print("No CUDA device available; pass --device cpu to solve on the "
              "CPU", file=sys.stderr)
        return 1

    if args.mesh is not None and args.device not in (0, "cpu"):
        print("--mesh N runs rank r on card r: --device takes 0 or cpu with "
              "it", file=sys.stderr)
        return 1
    from .model import Model

    params = params_from_args(args)
    try:
        model = Model.from_mps(args.input, mps_format=args.mps_format)
    except Exception as e:  # parse errors -> exit 1 with message
        print(f"Failed to read {args.input}: {e}", file=sys.stderr)
        return 1
    res = model.solve(params, device="cpu" if args.device == "cpu" else None)
    if args.quiet:
        print(f"status={res.status} iter={res.iter} time={res.time:.3f}s "
              f"obj={res.primal_obj:.12e} kkt={res.residuals:.3e}")
    if args.solution_out:
        write_solution(args.solution_out, res)
    return 0 if res.status == "OPTIMAL" else 2


def params_from_args(args):
    """The Parameters of parsed CLI arguments."""
    from .params import Parameters

    return Parameters(
        max_iter=args.max_iter,
        stop_tol=args.tol,
        time_limit=args.time_limit,
        device_number=0 if args.device == "cpu" else args.device,
        check_iter=args.check_iter,
        spmv_backend="gather" if args.cusparse_spmv else "auto",
        autotune_verbose=args.autotune_verbose,
        use_CR_scaling=args.cr,
        use_Ruiz_scaling=args.ruiz,
        use_Pock_Chambolle_scaling=args.pock,
        use_bc_scaling=args.bc,
        use_presolve=args.presolve,
        precision=args.precision,
        mesh_shape=args.mesh,
        verbose=not args.quiet,
    )


if __name__ == "__main__":
    sys.exit(main())
