"""The port's CPU f64 solve against JAX `solve_problem` at a tight
tolerance, on sparse_large's LP family.

sparse_large is `random_lp(65536, 131072, 20, seed=2)` (1.31M entries).
On the card its f64 solve at stop_tol 1e-8 ends at ITER_LIMIT after
100,050 iterations (max_iter 100,000), on the mesh route and on one card
alike. These cases ask whether the reference does the same on the same
family, so that an ITER_LIMIT there is the method's and not the port's.

Cut to size for tier-1: the same generator (20 entries a row, seed 2,
n = 2 m) at m = 512 (10,144 entries once duplicates are summed), where
both sides reach 1e-8 in 11,700 iterations, each in about 10 s on one
CPU thread; at m = 1,024 neither does within 20,000 (both ITER_LIMIT at
20,100, KKT 6.4e-8), which takes 30 s.  max_iter stays phase 15 (m)'s
100,000.  A control case runs the same LP at 1e-6.

Both sides run in f64 with the same `Parameters`.  They must end with
the same status and the same iteration count, and objectives within
1e-10 relative.  Stops fall on chunk boundaries (every 150 iterations),
and sigma's f32 exp/log chain, f32 on purpose in both packages, could
move a stop by one chunk through its last-bit drift; no case here
needs that slack, so none is allowed.

Run at sparse_large itself (off tier-1; the reference takes minutes to
tens of minutes on the CPU):

    python tests/test_torch_parity_tol.py --m 65536 --side jax

prints the reference's status, iterations, KKT and seconds (`--side
torch` the port's on the CPU, `--side both` the two in turn).  With
`--mixed` it runs `precision="mixed"` (default tolerance 1e-6, pass
`--tol`) stage by stage instead (prof/prof_mixed.py::staged): the
reference's solve_refined once per `--backend` ("gather" and "dense" by
default: two summation orders of the same f32 product), and with
`--side torch` or `both` also the port's on the CPU ("lane", the tiles'
plain version).
"""

import os
import sys

if __name__ == "__main__":
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

import hprlp_tpu_torch as ht  # noqa: E402
from hprlp_tpu.params import Parameters as JaxParameters  # noqa: E402
from hprlp_tpu.problem import LpProblem as JaxLpProblem  # noqa: E402
from hprlp_tpu.solver.loop import solve_problem as jax_solve  # noqa: E402
from hprlp_tpu_torch.prof.problems import random_lp  # noqa: E402

# The same reason as tests/test_torch_solve.py: one intra-op thread.
torch.set_num_threads(1)

CHUNK = 150  # iterations between chunk boundaries (check_iter)
M_TIER1, MAX_ITER_TIER1 = 512, 100_000


def family(m, seed=2):
    """sparse_large's family: m x 2m, 20 entries a row."""
    return random_lp(m, 2 * m, 20, seed=seed)


def params(tol, max_iter, verbose=False):
    kw = dict(stop_tol=tol, precision="f64", use_presolve=False,
              max_iter=max_iter, verbose=verbose)
    return JaxParameters(**kw), ht.Parameters(**kw)


def solve_jax(prob, p):
    return jax_solve(JaxLpProblem.from_arrays(
        prob.A, prob.AL, prob.AU, prob.l, prob.u, prob.c), p)


def solve_torch(prob, p):
    return ht.solve_problem(prob, p, device="cpu")


@pytest.fixture(scope="module")
def lp():
    return family(M_TIER1)


@pytest.mark.parametrize("tol", [1e-8, 1e-6])
def test_f64_solve_matches_the_reference_at_tight_tolerance(lp, tol):
    jp, tp = params(tol, MAX_ITER_TIER1)
    rj = solve_jax(lp, jp)
    rt = solve_torch(lp, tp)
    assert rt.status == rj.status == "OPTIMAL"
    assert rt.iter == rj.iter
    assert rt.iter % CHUNK == 0
    assert rt.primal_obj == pytest.approx(rj.primal_obj, rel=1e-10)
    assert rt.dual_obj == pytest.approx(rj.dual_obj, rel=1e-10)
    assert lp.kkt_error(rt.x, rt.y, rt.z)["kkt"] < tol


def _main(argv=None):
    import argparse
    import json
    import time

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--m", type=int, default=65536)
    ap.add_argument("--tol", type=float, default=1e-8)
    ap.add_argument("--max-iter", type=int, default=100_000)
    ap.add_argument("--side", choices=("jax", "torch", "both"),
                    default="jax")
    ap.add_argument("--verbose", action="store_true")
    ap.add_argument("--mixed", action="store_true")
    ap.add_argument("--backend", nargs="+", default=["gather", "dense"])
    a = ap.parse_args(argv)
    prob = family(a.m)
    if a.mixed:
        return _mixed(a, prob)
    jp, tp = params(a.tol, a.max_iter, verbose=a.verbose)
    sides = ("jax", "torch") if a.side == "both" else (a.side,)
    for side in sides:
        t = time.perf_counter()
        r = solve_jax(prob, jp) if side == "jax" else solve_torch(prob, tp)
        wall = time.perf_counter() - t
        kkt = prob.kkt_error(np.asarray(r.x), np.asarray(r.y),
                             np.asarray(r.z))
        print(json.dumps({
            "side": side, "m": a.m, "n": 2 * a.m, "nnz": int(prob.A.nnz),
            "tol": a.tol, "max_iter": a.max_iter, "status": r.status,
            "iter": int(r.iter), "primal_obj": float(r.primal_obj),
            "dual_obj": float(r.dual_obj), "kkt_host_f64": float(kkt["kkt"]),
            "wall_s": round(wall, 3)}), flush=True)



def _mixed(a, prob):
    import json
    import time

    from hprlp_tpu.solver import loop as jax_loop
    from hprlp_tpu.solver import refine as jax_refine
    from hprlp_tpu_torch.prof.prof_mixed import staged
    from hprlp_tpu_torch.solver import loop, refine

    kw = dict(stop_tol=a.tol, precision="mixed", use_presolve=False,
              max_iter=a.max_iter, verbose=False)
    runs = [("jax", b) for b in a.backend if a.side in ("jax", "both")]
    runs += [("torch", "lane")] if a.side in ("torch", "both") else []
    jprob = JaxLpProblem.from_arrays(prob.A, prob.AL, prob.AU, prob.l,
                                     prob.u, prob.c)
    for side, backend in runs:
        t = time.perf_counter()
        if side == "jax":
            r, stages, tails = staged(
                jax_refine.solve_refined, jax_loop, jprob,
                JaxParameters(spmv_backend=backend, **kw))
        else:
            r, stages, tails = staged(
                refine.solve_refined, loop, prob,
                ht.Parameters(spmv_backend=backend, **kw), device="cpu")
        kkt = prob.kkt_error(np.asarray(r.x), np.asarray(r.y),
                             np.asarray(r.z))["kkt"]
        print(json.dumps({
            "side": side, "backend": backend, "m": a.m, "n": 2 * a.m,
            "tol": a.tol, "status": r.status, "iter": int(r.iter),
            "kkt_host_f64": float(kkt), "stages": stages, "tails": tails,
            "wall_s": round(time.perf_counter() - t, 3)}), flush=True)


if __name__ == "__main__":
    _main()
