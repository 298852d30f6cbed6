"""Each rank's memory through a mesh's share ingest, on one card
(chip_smoke.py phase 15 (g)).

NCCL runs one rank per card, so a machine with one card cannot run a mesh
of N ranks.  The share ingest alone (solver/loop.py::build_share_ingest)
needs only all-reduces and broadcasts, which gloo runs on CUDA tensors:
`ingest_peak` runs it on `world` gloo ranks (parallel/distributed.py::
launch) that share cuda:0, each with its own caching allocator, and
returns each rank's device peak and resident bytes through the ingest,
its stages' seconds, its share and its host resident set (sampled:
PeakRss), at the ingest's start and at its peak.  A rank on its own
card would hold the same bytes.

`discard_broadcast` runs Model.solve's discard branch on such ranks:
rank 0 presolves beside every rank's share ingest, the ingest is
dropped, and the reduced LP and then the original-space point cross as
pickled bytes (parallel/distributed.py::broadcast_object), each
broadcast measured on every rank.  The reduced solve itself is not run:
it captures the SpMV's all-reduce in a CUDA graph, which needs NCCL.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..parallel import distributed
from ..params import Parameters
from ..results import Results
from .timing import PeakRss


def _rank_ingest(problem, params_kw: dict) -> dict:
    """In a launched gloo rank: the share ingest on cuda:0, measured."""
    from ..solver import loop

    device = torch.device("cuda:0")
    world, rank = distributed.world_size(), distributed.rank()
    params = Parameters(mesh_shape=world, **params_kw)
    torch.cuda.synchronize(device)
    torch.cuda.reset_peak_memory_stats(device)
    base = torch.cuda.memory_allocated(device)
    t0 = time.perf_counter()
    with PeakRss() as rss:
        lp, _, _, seconds = loop.build_share_ingest(problem, params, device,
                                                    rank, world)
        torch.cuda.synchronize(device)
    wall = time.perf_counter() - t0
    out = {"rank": rank, "world": world,
           "peak_bytes": torch.cuda.max_memory_allocated(device) - base,
           "resident_bytes": torch.cuda.memory_allocated(device) - base,
           "rss_start_bytes": rss.start_bytes,
           "rss_peak_bytes": rss.peak_bytes,
           "seconds": seconds, "wall_s": wall,
           **loop.build_share_ingest.record}
    del lp
    return out


def ingest_peak(problem, world: int, params_kw: dict | None = None,
                timeout: float = 900.0) -> list[dict]:
    """Each rank's record of the share ingest of `problem` on `world` gloo
    ranks sharing cuda:0 (params_kw: Parameters fields, e.g. the
    precision), by rank.  Raises as distributed.launch does."""
    return distributed.launch(_rank_ingest, (problem, dict(params_kw or {})),
                              world=world, device_type="cpu",
                              timeout=timeout)


def _device_bytes(device: torch.device, peak: bool = False) -> int:
    """Bytes allocated on `device` now (or at the peak since the last
    reset) by this process's caching allocator; 0 on the CPU."""
    if device.type != "cuda":
        return 0
    torch.cuda.synchronize(device)
    return (torch.cuda.max_memory_allocated(device) if peak
            else torch.cuda.memory_allocated(device))


def _rank_discard(problem, params_kw: dict, device: str,
                  giant_nnz: int | None) -> dict:
    """In a launched gloo rank: Model.solve's route on `device` with
    REINGEST_SHARE below zero (and loop.GIANT_LANE_FIRST_NNZ set to
    `giant_nnz` where given), so that the ingest built beside presolve is
    discarded and the reduced LP broadcast; each broadcast measured (its
    bytes and seconds, the device bytes held at its start and its peak
    above them, the host resident set sampled through it); the reduced
    solve replaced by a zero point (status ITER_LIMIT), which rank 0
    postsolves, validates and broadcasts."""
    from .. import model
    from ..solver import loop

    device = torch.device(device)
    world, rank = distributed.world_size(), distributed.rank()
    params = Parameters(mesh_shape=world, **params_kw)
    real = distributed.broadcast_object
    broadcasts, entered = [], {}

    def measured(obj, dev, src=0):
        held = _device_bytes(device)
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(device)
        with PeakRss() as rss:
            out = real(obj, dev, src)
            peak = _device_bytes(device, peak=True)
        # The real function sets the record of the module's name: this.
        broadcasts.append({
            **measured.record, "held_bytes": held,
            "peak_bytes": max(peak - held, 0),
            "rss_start_bytes": rss.start_bytes,
            "rss_peak_bytes": rss.peak_bytes})
        return out

    def zero_solve(lp, params, x0=None, y0=None, device=None, **kw):
        entered.update(m=lp.m, n=lp.n, nnz=lp.nnz,
                       held_bytes=_device_bytes(torch.device(device)),
                       rss_bytes=PeakRss.rss_bytes())
        res = Results()
        res.status, res.iter = "ITER_LIMIT", 0
        res.x, res.z, res.y = np.zeros(lp.n), np.zeros(lp.n), np.zeros(lp.m)
        return res

    saved = (distributed.broadcast_object, loop.mesh_rank_device,
             loop.GIANT_LANE_FIRST_NNZ, model.solve_problem,
             model.REINGEST_SHARE)
    distributed.broadcast_object = measured
    loop.mesh_rank_device = lambda params, dev: device
    if giant_nnz is not None:
        loop.GIANT_LANE_FIRST_NNZ = giant_nnz
    model.solve_problem = zero_solve
    model.REINGEST_SHARE = -1.0
    t0 = time.perf_counter()
    try:
        res = model.solve_with_presolve(problem, params, device=device)
    finally:
        (distributed.broadcast_object, loop.mesh_rank_device,
         loop.GIANT_LANE_FIRST_NNZ, model.solve_problem,
         model.REINGEST_SHARE) = saved
    return {"rank": rank, "world": world, "wall_s": time.perf_counter() - t0,
            "status": res.status, "presolve_s": res.presolve_time,
            "broadcasts": broadcasts, "reduced_solve": entered,
            **model.solve_with_presolve.record}


def discard_broadcast(problem, world: int, params_kw: dict | None = None,
                      device: str = "cuda:0", giant_nnz: int | None = None,
                      timeout: float = 900.0) -> list[dict]:
    """Each rank's record of Model.solve's discard branch of `problem` on
    `world` gloo ranks sharing `device` (_rank_discard), by rank.  Raises
    as distributed.launch does."""
    return distributed.launch(_rank_discard, (problem, dict(params_kw or {}),
                                              device, giant_nnz),
                              world=world, device_type="cpu",
                              timeout=timeout)
