"""One LP a call through the front door, `hprlp_tpu_torch.solve` (model.py
`Model.solve`), with Parameters(**traffic["parameters"])."""

from __future__ import annotations

import scipy.sparse as sp

import hprlp_tpu_torch as ht
from hprlp_tpu_torch.solver.loop import solve_problem


def make_pool(generator, config: dict, traffic: dict, gen) -> list:
    pool = []
    for _ in range(traffic["pool"]):
        A = generator.matrix(config, gen)
        pool.append({"A": A, **generator.member(config, gen)})
    return pool


def shape(inst: dict) -> dict:
    m, n = inst["A"].shape
    return {"m": m, "n": n, "nnz": int(inst["A"].nnz), "batch": 1}


def fresh(inst: dict) -> tuple:
    """New copies of the instance's arrays, as a caller hands them over."""
    A = inst["A"]
    A = sp.csr_matrix((A.data.copy(), A.indices.copy(), A.indptr.copy()),
                      shape=A.shape)
    return (A, *(inst[k].copy() for k in ("AL", "AU", "l", "u", "c")))


def call(args: tuple, parameters: dict, device=None):
    return ht.solve(*args, ht.Parameters(**parameters), device=device)


def record(res) -> dict:
    """The call's statuses, iterations and the program's own spans."""
    return {"status": [res.status], "iters": int(res.iter),
            "backend": res.spmv_backend,
            "ingest_s": res.setup_time + res.scaling_time,
            "autotune_s": res.autotune_time, "power_s": res.power_time,
            "capture_s": solve_problem.capture_time, "loop_s": res.time}


def keep(res, k: int, rng, traffic: dict) -> list:
    """The answers to judge once the window has closed: the call's one."""
    return [{"instance": k, "member": 0, "x": res.x, "y": res.y,
             "z": res.z, "reported": float(res.residuals)}]


def member(inst: dict, b: int) -> tuple:
    """(A, AL, AU, l, u, c) of member b, as the benchmark made them."""
    return (inst["A"], *(inst[k] for k in ("AL", "AU", "l", "u", "c")))
