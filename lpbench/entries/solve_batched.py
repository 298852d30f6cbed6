"""B LPs that share A in one call, `hprlp_tpu_torch.solve_batched`, with
Parameters(**traffic["parameters"]); traffic["batch"] members, each drawn
as the configuration's generator draws one LP's vectors."""

from __future__ import annotations

import numpy as np

import hprlp_tpu_torch as ht
from hprlp_tpu_torch.solver.batched import solve_batched

VECTORS = ("C", "AL", "AU", "l", "u")


def make_pool(generator, config: dict, traffic: dict, gen) -> list:
    pool = []
    for _ in range(traffic["pool"]):
        A = generator.matrix(config, gen)
        members = [generator.member(config, gen)
                   for _ in range(traffic["batch"])]
        inst = {"A": A}
        for key, name in zip(VECTORS, ("c", "AL", "AU", "l", "u")):
            first = members[0][name]
            if all(np.array_equal(mb[name], first) for mb in members):
                # Held once; fresh() makes each call's (rows, B) array.
                inst[key] = np.broadcast_to(first[:, None],
                                            (first.size, len(members)))
            else:
                inst[key] = np.stack([mb[name] for mb in members], axis=1)
        pool.append(inst)
    return pool


def shape(inst: dict) -> dict:
    m, n = inst["A"].shape
    return {"m": m, "n": n, "nnz": int(inst["A"].nnz),
            "batch": inst["C"].shape[1]}


def fresh(inst: dict) -> tuple:
    """New copies of the batch's vectors; A is shared by the members and
    read-only to the solver, as a caller's would be."""
    return (inst["A"], *(inst[k].copy() for k in VECTORS))


def call(args: tuple, parameters: dict, device=None):
    return ht.solve_batched(*args, params=ht.Parameters(**parameters),
                            device=device)


def record(res) -> dict:
    return {"status": list(res.status), "iters": int(np.max(res.iter)),
            "backend": (solve_batched.probe or {}).get("backend", "gather"),
            "probe": solve_batched.probe, "ingest_s": res.setup_time,
            "autotune_s": None, "power_s": res.power_time,
            "capture_s": solve_batched.capture_time,
            "loop_s": res.solve_time}


def keep(res, k: int, rng, traffic: dict) -> list:
    """The answers to judge once the window has closed: traffic["check"]
    members of the call, drawn from the run's seed."""
    B = res.x.shape[1]
    picks = np.sort(rng.choice(B, min(traffic["check"], B), replace=False))
    return [{"instance": k, "member": int(b), "x": res.x[:, b].copy(),
             "y": res.y[:, b].copy(), "z": res.z[:, b].copy(),
             "reported": float(res.residuals[b])}
            for b in picks]


def member(inst: dict, b: int) -> tuple:
    return (inst["A"], inst["AL"][:, b], inst["AU"][:, b], inst["l"][:, b],
            inst["u"][:, b], inst["C"][:, b])
