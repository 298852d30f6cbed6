"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the kernels and the host library from the checkout's sources,
holds each kernel against its plain PyTorch version at its path's shapes,
drives the main path (hprlp_tpu_torch.solve) on three LPs, the SpMV
variant studies, the CLI on an MPS file with presolve, then the batched
solver (hprlp_tpu_torch.solve_batched), the solve loops' CUDA graphs
against their eager steps, the SpMV backend autotune, the solver server
and the C ABI with their workers on the card, precision="mixed", and a
113M-nnz LP through Model.solve, its ingest built beside presolve.  Every solve
on the card replays its chunk boundary from a CUDA graph captured before
its clock starts, and (single LP) runs the SpMV backend the autotune
chose; a solve fails its phase unless it launched that backend's kernel
and its fused halves (on the tiles or "gather"; none on "dense") and no
other SpMV kernel or half (the probes' launches are counted apart), and
never the previous designs:

  1. toolchain   nvidia-smi name/power limit, torch, CUDA, nvcc, Triton
  2. build       the five kernel libraries (nvcc, sm_90a, one process per
                 source, started together) and the host library (g++,
                 native/src), with their build times
  0. repairs     scale_matrix twice on the first LP's A and A^T (f32):
                 bitwise-equal values and norms (its row sums run on the
                 SpMM kernel in CSR order); after phase 4, its solve run a
                 second time: the same iterations and a bitwise-equal
                 objective; then MEMORY_SOLVES more in-process solves of
                 it with no release_device_memory: torch.cuda.
                 memory_reserved() and nvidia-smi's used memory flat
                 within MEMORY_FLAT_MIB after the second (one warm-up
                 stream and one graph pool per device), and, for the
                 record, FAULT_SOLVES solves with a new stream and a
                 private pool per capture
  3. kernel      the tiled SpMV (main path), the CSR kernel ("gather":
                 csrc/spmv_csr.cu on its row-block plan) and the first
                 row-group design (csrc/spmv.cu), f32 and f64, on A and
                 A^T of random_lp(65536, 131072, 20, seed=2) and
                 random_lp(262144, 524288, 40, seed=4): each against its
                 plain version (the CSR kernel bitwise, on its plan), the
                 tiled and CSR ones also for bitwise-identical repeats;
                 timings of all three, of the CSR kernel without its
                 random x gather, of the tiled kernel's stages and of
                 torch.mv on a sparse CSR tensor (cuSPARSE, the library
                 yardstick), the bound and share of it, and the tiles'
                 and plans' build times; the tiles built with the card's
                 resident clusters (cluster_slots) as a solve's are, and
                 the main stage (the strip groups of a row chunk as one
                 cluster) bitwise block_x (the previous design) on them
                 and on one strip group, with G x C and the resident
                 clusters; block_x also timed on its own layout (tiles
                 built with slots=None)
  4. main f32    solve of the first LP at stop_tol=1e-4 (auto -> f32),
                 with the autotune's probe times, its choice and the
                 graph's capture time; the chosen backend's chunk
                 profiled (device us/it, kernels/it, busy share)
  5. main f64    assignment_problem(64) at 1e-8 (auto -> f64), objective
                 against scipy's linear_sum_assignment
  6. real size   solve of the second LP (10.5M nnz) at 1e-4, its peak
                 device memory and its chunk profiled, as in phase 4
                 (on the tiles beside their figures before the fused
                 halves, TILES_BEFORE_FUSION)
  7. variants    the four prof_* studies (hprlp_tpu_torch/prof/) on the
                 bench LP (A, A^T) and on phase 6's LP (A): the ablate,
                 multi_acc and flush families are instantiations of the
                 CSR kernel (csrc/spmv_csr.cu) on the "gather" backend's
                 row-block plan, the segsum family of the tiled kernel
                 (csrc/spmv_tiled.cu, one-hot tensor-core row sums) on
                 the tiles; ablate full, n_acc=1, 2, 4, flush full and
                 runmerge bitwise their plain versions, every other
                 variant within its tolerance of its plain version, the
                 exact ones within it of A @ x; each variant's time by
                 graph replay, launches, share of bound (mm_precomp's
                 counting its R) and cuSPARSE beside it, its plain
                 version's eager time at bench A; segsum beside the tiled
                 kernel on the same tiles
  8. mps + presolve   structured_lp(scale=1.0, seed=7) (950,000 x
                 1,000,000, 10.50M nnz) written as MPS to a temporary
                 directory and solved by hprlp_tpu_torch.cli.main at 1e-4:
                 native reader, native presolve (status OK, the reduced
                 size beside benchmarks/report_presolve_scale.json's),
                 solve on the card (the tiled kernel launched, the CSR
                 kernel never), postsolve, original-space KKT, solution
                 file; that file's x/y/z re-measured in host f64 (KKT <
                 1e-3) and its objective against an in-process solve with
                 presolve off (1e-3 relative); stage times; then
                 `python -m hprlp_tpu_torch.cli -i data/model.mps` in a
                 subprocess
  9. batched     (a) the SpMM kernel (csrc/spmm.cu) against its plain
                 version on the unscaled A and A^T of phase 3's first LP,
                 B in SPMM_BATCHES, f32 and f64: error relative to the row
                 sums of |A| |X|, bitwise repeat, bitwise equal to the
                 previous design (row-wise), times by graph replay of both
                 designs (and, at B >= 64, of the new one with no L2 cap
                 on its slices) beside torch.sparse.mm on a CSR tensor
                 (cuSPARSE) and the byte bound; the new design must beat
                 the previous one on A at B = 64 and 256; (b)
                 batched_large: solve_batched of batched_lp(65536, 131072,
                 64, seed=3) at 1e-4 (f32): every member OPTIMAL with
                 host-f64 KKT < 1e-3, two members against single solves,
                 the SpMM, fused-half and tiled kernels launched and the
                 CSR SpMV never, one chunk profiled; (c) the dense probe
                 on batched_lp(2048, 4096, 256, seed=3): spmv_backend
                 "auto" (both probe times, the winner) against "dense",
                 every member OPTIMAL, objectives within 1e-3; one SpMM of
                 each candidate (and of the previous design) timed by graph
                 replay and eagerly; (d) on
                 batched_large's problem, f32 and f64, with members
                 frozen: one 150-iteration run_batched_chunk through the
                 fused halves and one through the plain halves, bitwise
                 equal; each half's time by graph replay, fused and
                 plain, beside its byte bound; the f64 chunk profiled
 10. graphs      at sparse_large f32 (1e-4) on the tiled and on the gather
                 backend, assignment64 f64 (1e-8) and batched_large f32
                 (1e-4): run_superchunk (or
                 run_batched_superchunk) from the solve's starting point,
                 eagerly and by the replays of a captured graph: the same
                 chunks, bitwise-equal stacked tables and final state; the
                 capture time, the host time per replay, it/s both ways,
                 the busy share over replays (prof_loop), and phase 6's
                 peak memory; (b) at sparse_large on the gather backend,
                 f32 and f64: one 150-iteration run_chunk through the
                 single-LP halves fused into the CSR kernel, one through
                 the plain halves and the fused chunk's graph replay,
                 bitwise equal; then at sparse_large f32 and f64 and
                 assignment_problem(128) f32 each half alone bitwise its
                 plain version, timed fused and plain beside its byte
                 bound; (c) the halves fused into the tiled SpMV
                 at sparse_large and sparse_huge, f32 and f64, on the
                 default tiles and on tiles of another strip-group count
                 (G = 1 against G > 1): each half alone bitwise the
                 kernel's store and the plain ops (else its ulps, and the
                 phase fails), one 150-iteration run_chunk fused, plain
                 and by graph replay, bitwise equal, with 148 launches of
                 each fused half and no group-sum pass; each half and its
                 matrix's product on the main stage (the strip groups of a
                 row chunk as one cluster) bitwise block_x's (the previous
                 design) and timed beside it, with G x C and the resident
                 clusters; each half timed fused, plain and as the
                 kernel's store then the mesh's epilogue, beside its bound
                 (the function's bytes, half_bound) and the tiles' stream;
                 on the default tiles the mesh's epilogue on the kernel's
                 products, bitwise its plain version, timed with its
                 inputs out of L2 beside its plain version and its bound;
                 then kernels/it at sparse_large and (phase 6's profile)
                 sparse_huge f32 on the tiles, each at most
                 KERNELS_PER_IT
 11. autotune    autotune_backends twice on sparse_large f32, sparse_large
                 f64 and random_lp(4096, 8192, 128, seed=5) (1.56% dense):
                 each candidate's probe time, the choice, whether the two
                 choices agree, no probe failed, the chosen chunk
                 profiled; each LP solved with spmv_backend "gather"
                 (and "dense" and "auto" where a dense copy is eligible) to
                 OPTIMAL with host-f64 KKT < 1e-3, launching only its
                 backend; cli.main --cusparse-spmv true on data/model.mps
 12. service     (a) `python -m hprlp_tpu_torch.server` on the default
                 device over pipes: its stderr names the card; ping,
                 mps_dims and solve_mps on data/model.mps, sparse_large as
                 a `solve` request (1e-4, presolve off, spmv_backend
                 "lane"), bitwise the in-process solve (iterations,
                 objective, x), solve_batched of batched_lp(2048, 4096,
                 256, seed=3) ("gather") with the in-process statuses,
                 iterations and objectives, sparse_large four more times
                 (client wall time beside Results.time), the card's used
                 memory after requests 2 and 5 within MEMORY_SLACK_MIB,
                 shutdown, exit 0, and the worker's kernel launches (the
                 tiled SpMV and its fused halves among them); (b)
                 the port's C ABI library and launcher (capi.py), the
                 three examples/c programs built against it and run, each
                 worker on the card, and a ctypes consumer's f32 solve of
                 sparse_large in (a)'s iteration count
 13. mixed       precision="mixed" on assignment_problem(64) and (128) at
                 1e-8 (benchmarks/run.py's configurations): OPTIMAL,
                 host-f64 KKT < 1e-8, the objective within 1e-6 of
                 linear_sum_assignment, each stage's zoom, iterations,
                 KKT, backend and launches and the f64 tail's attempts,
                 beside the direct f64 solve; refine_stage_precision="f64"
                 on assignment64; sparse_large at 1e-6 (OPTIMAL, host-f64
                 KKT < 1e-6); every stage and tail launches the SpMV
                 kernel of the backend it ran and no other
 14. giant       (a) sparse_huge f32 on the giant route (the tiles kept
                 alone: GIANT_LANE_FIRST_NNZ lowered for the call) and the
                 standard route (the CSR arrays kept too), both on the
                 tiles: bitwise-equal iterations, objective and point;
                 each route's setup and scaling seconds, its device memory
                 to the power method, after the ingest and in the solve;
                 (b) banded_lp(1572864, 3145728, 72, 16384, 5) (~113M nnz,
                 benchmarks/run.py's banded giant), generated once,
                 through Model.solve with presolve on: presolve beside the
                 ingest, the reduced nnz and whether the ingest was reused
                 (one ingest where presolve removes at most
                 model.REINGEST_SHARE of nnz, else two), the stage seconds, Model.solve's wall against
                 presolve + ingest (it must be below) and all stages in
                 a row, device memory, host peak RSS; OPTIMAL
                 with host-f64 KKT < 1e-3 on the tiled kernel and its
                 fused halves only, ms/it beside the figure before the
                 fused halves, and one captured chunk of the solve's
                 tiles profiled (device us/it, kernels/it); (c)
                 the tiled SpMV at the giant's A and A^T (the solve's
                 tiles) against its plain version, beside its bound and
                 cuSPARSE (torch.mv on the same matrix, built after the
                 solve); (d) the banded giant through Model.solve in a
                 fresh process with HPRLP_MALLOC_TUNE=1 (the allocator
                 tuned at import, the ingest preheated): tune_malloc's
                 report, presolve and the wall beside (b)'s untuned ones,
                 host peak RSS, the objective bitwise (b)'s
 15. mesh        (a) sparse_huge's A and A^T (f32) cut into 2 and 4
                 column slices (parallel/sharded.py::column_slices), each
                 slice tiled and timed by graph replay beside its bound,
                 the slices' partial y's summed against the tiled kernel
                 on the whole matrix and its plain version; (b) a one-rank
                 NCCL group in this process: sparse_huge f32 (1e-4) and
                 assignment64 f64 (1e-8) with mesh_shape=1 ("auto": the
                 autotune probes sparse_huge on both forms; on the tiles
                 the slice, the all-reduces captured in the CUDA graph),
                 bitwise the one-card solve on the backend it chose
                 (iterations, objective, x), both Results.time, the
                 launches and the collectives per iteration; on the tiles
                 one epilogue launch per middle-iteration half after its
                 all-reduce (as many as the one-card solve's fused tiled
                 halves) and no fused tiled half; (c)
                 batched_large with mesh_shape=1,
                 every member bitwise the single-device batched solve;
                 (d) `python -m hprlp_tpu_torch.cli -i data/model.mps
                 --mesh 1 --quiet` (a launched rank): rc 0, -26.4, the
                 rank's start seconds; (e) with two cards, a 2-rank
                 sparse_huge solve against the single-card one, else a
                 line saying why it did not run; (f) (b)'s solves through
                 the share ingest: 51 scaling exchanges each, its stages
                 beside the one-card ingest's; (g) each rank's device peak
                 and resident bytes through the share ingest (f32) of
                 sparse_huge and the banded giant at N = 2 and 4, the
                 ranks gloo ranks sharing the card (NCCL refuses two ranks
                 on one card); (h) "mixed" at
                 mesh_shape=1 on assignment64 (1e-8) bitwise the one-card
                 "mixed" solve; (i) a server `solve` request of
                 sparse_large with mesh_shape=1 (one launched rank)
                 bitwise the in-process mesh solve; (j) the presolve
                 overlap at mesh_shape=1 on random_lp(524288, 1048576,
                 40, 7) (21.0M nnz; the giant threshold lowered for the
                 part): one presolve, on rank 0, the wall below presolve
                 + ingest, bitwise the one-card overlap, the seconds
                 after presolve; (k) Model.solve's discard branch of the
                 banded giant on 2 gloo ranks sharing the card
                 (prof/share_ingest.py::discard_broadcast:
                 model.REINGEST_SHARE below zero, so the reduced LP
                 crosses; the reduced solve, whose all-reduce needs NCCL,
                 replaced by a zero point): each broadcast's bytes and
                 seconds, the device bytes held at its start and its
                 peak, each rank's host RSS through it; (l)
                 sparse_large's A and A^T (f32, f64) cut by share_cuts'
                 R and C into 2 and 4 row slices: the CSR kernel and its
                 fused halves on each slice timed by graph replay beside
                 their bounds, the slices' outputs concatenated against
                 the kernel on the whole matrix and the plain version
                 (bitwise, or the largest difference in ulps); (m) in
                 the NCCL group, the row shards: sparse_large f32 (1e-4)
                 and f64 (1e-6) with mesh_shape=1 on "gather", dense_lp
                 on "dense", sparse_large on "auto", each bitwise the
                 one-card solve with that backend ("auto": the same
                 choice), the all-gathers per iteration captured in the
                 graph, the launches (no tiled launch outside the
                 probes), Results.time beside the one-card solve's; the
                 share ingest's wall on "gather" (row forms only) beside
                 the tiles' share ingest and the one-card ingest, at
                 sparse_large and sparse_huge
 16. total       the smoke's seconds

Any failure raises (exit code != 0).  The line before the last is the
kernels' JSON record; the last line is {"ok": true, "device": {...}}.
Needs torch, numpy and scipy only; imports neither JAX nor hprlp_tpu.
"""

from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import itertools
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
import types
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from hprlp_tpu_torch.prof.problems import (assignment_problem, make_problem,
                                           random_lp)
from hprlp_tpu_torch.prof.timing import card as card_name
from hprlp_tpu_torch.prof.timing import (PeakRss, eager_ms, spmv_bound,
                                         time_ms)

HERE = os.path.dirname(os.path.abspath(__file__))
T_START = time.perf_counter()


def phase(n, text):
    print(f"[phase {n}] {text}", flush=True)


def check(cond, what):
    if not cond:
        raise AssertionError(what)


def library_call(M, x):
    """torch.mv on a sparse CSR tensor (cuSPARSE), the yardstick of the
    CSR kernels: timed here, never called by the port."""
    S = torch.sparse_csr_tensor(M.indptr, M.indices, M.vals,
                                (M.nrows, M.ncols))
    return lambda: torch.mv(S, x)


def toolchain():
    card = card_name()
    from hprlp_tpu_torch.ops.spmv import _nvcc

    nvcc = subprocess.run([_nvcc(), "--version"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[-1]
    try:
        import triton
        triton_v = triton.__version__
    except ImportError:
        triton_v = "absent"
    print(card, flush=True)
    phase(1, f"card={card!r} torch={torch.__version__} "
             f"cuda={torch.version.cuda} nvcc={nvcc!r} triton={triton_v}")
    return card


def kernel_check(card, problems):
    """Phase 3 on A and A^T of each problem, in f32 and f64.  Returns
    {(size, dtype tag, matrix): record}."""
    from hprlp_tpu_torch.ops.device_problem import build_device_problem
    from hprlp_tpu_torch.ops.spmv import (MAIN_STAGE, TILED_STAGES,
                                          cluster_slots, csr_spmv,
                                          csr_spmv_no_gather,
                                          csr_spmv_plain, csr_spmv_rowgroup,
                                          max_active_clusters, row_blocks,
                                          spmv_reference, tiled_spmv)
    from hprlp_tpu_torch.ops.tiles import build_tiles, tiled_spmv_reference

    rng = np.random.default_rng(0)
    records = {}
    # The card's resident clusters of G blocks, which build_tiles takes on
    # the card.
    slots = cluster_slots("cuda")
    phase(3, f"resident clusters of G strip-group blocks at a block's full "
             f"shared memory (the main stage's): {slots} [{card}]")
    for size, problem in problems.items():
        for dtype, rtol, tag in ((torch.float32, 1e-5, "f32"),
                                 (torch.float64, 1e-12, "f64")):
            lp, _ = build_device_problem(problem, dtype=dtype, device="cuda")
            for mat_name, M in (("A", lp.A), ("AT", lp.AT)):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                T = build_tiles(M)
                torch.cuda.synchronize()
                tiles_s = time.perf_counter() - t0
                t0 = time.perf_counter()
                P = row_blocks(M)
                torch.cuda.synchronize()
                blocks_s = time.perf_counter() - t0
                M = dataclasses.replace(M, blocks=P)
                x = torch.as_tensor(rng.normal(size=M.ncols), device="cuda"
                                    ).to(dtype)
                y = tiled_spmv(T, x)
                y_again = tiled_spmv(T, x)
                y_ref = tiled_spmv_reference(T, x)
                y_csr = csr_spmv(M, x)
                y_csr_again = csr_spmv(M, x)
                y_csr_plain = csr_spmv_plain(M, x)
                y_csr_ref = spmv_reference(M, x)
                y_prev = csr_spmv_rowgroup(M, x)
                torch.cuda.synchronize()
                scale = float(y_ref.abs().max())
                err = float((y - y_ref).abs().max())
                err_csr = float((y_csr - y_csr_ref).abs().max())
                err_prev = float((y_prev - y_csr_ref).abs().max())
                what = f"{size} {tag} {mat_name}"
                check(err <= rtol * scale, f"{what}: tiled max abs err "
                      f"{err} > {rtol} * {scale}")
                check(torch.equal(y, y_again),
                      f"{what}: two tiled launches differ")
                check(err_csr <= rtol * scale, f"{what}: CSR max abs err "
                      f"{err_csr} > {rtol} * {scale}")
                check(torch.equal(y_csr, y_csr_plain), f"{what}: the CSR "
                      f"kernel differs from its plain version on the plan")
                check(torch.equal(y_csr, y_csr_again),
                      f"{what}: two CSR launches differ")
                check(err_prev <= rtol * scale, f"{what}: row-group CSR max "
                      f"abs err {err_prev} > {rtol} * {scale}")
                # The stages: each x path on the main tiles, and the main
                # stage and block_x on tiles of one strip group (row blocks
                # only); the main stage bitwise block_x on both tilings.
                # block_x also on both tilings as laid out before the cut
                # to the card's clusters (slots=None, the previous design's
                # own layout: 128 chunks at G = 1), its yardstick.
                one_group = build_tiles(M, strip_groups=1)
                runs = [(stage, T, stage) for stage in TILED_STAGES]
                runs += [(f"{stage}_one_group", one_group, stage)
                         for stage in (MAIN_STAGE, "block_x")]
                runs += [("block_x_uncut", build_tiles(M, slots=None),
                          "block_x"),
                         ("block_x_one_group_uncut", build_tiles(
                             M, strip_groups=1, slots=None), "block_x")]
                stages, outs = {}, {}
                for name, tiles, stage in runs:
                    outs[name] = y_s = tiled_spmv(tiles, x, stage)
                    torch.cuda.synchronize()
                    e = float((y_s - y_ref).abs().max())
                    check(e <= rtol * scale, f"{what}: stage {name} max "
                          f"abs err {e}")
                    stages[name] = time_ms(
                        lambda t=tiles, st=stage: tiled_spmv(t, x, st))
                for suffix in ("", "_one_group"):
                    u = ulps(outs[MAIN_STAGE + suffix],
                             outs["block_x" + suffix])
                    check(u == 0, f"{what}: {MAIN_STAGE}{suffix} is {u} "
                          f"ulps from block_x{suffix}")
                uncut = (runs[-2][1].n_groups, runs[-2][1].n_chunks,
                         runs[-1][1].n_chunks)
                del outs, runs
                bound_ms, bound_by = spmv_bound(M, dtype)
                rec = {
                    "err": err, "scale": scale, "err_csr": err_csr,
                    "err_rowgroup": err_prev, "nnz": M.nnz,
                    "tiles_s": tiles_s, "blocks_s": blocks_s,
                    "plan_blocks": P.n_blocks, "blocks_bytes": P.nbytes,
                    "strips": T.n_strips, "strip_width": T.strip_width,
                    "groups": T.n_groups, "chunks": T.n_chunks,
                    "live_chunks": T.live_chunks,
                    "blocks": T.n_blocks, "smem": T.smem_bytes,
                    "clusters8": max_active_clusters(T, "cluster8_x"),
                    "resident": max_active_clusters(T),
                    "one_group_chunks": one_group.live_chunks,
                    "uncut_shape": uncut,
                    "ms": stages[MAIN_STAGE],
                    "plain_ms": time_ms(lambda: tiled_spmv_reference(T, x)),
                    "csr_ms": time_ms(lambda: csr_spmv(M, x)),
                    "csr_plain_ms": eager_ms(lambda: csr_spmv_plain(M, x),
                                             reps=3),
                    "rowgroup_ms": time_ms(lambda: csr_spmv_rowgroup(M, x)),
                    "no_gather_ms": time_ms(lambda: csr_spmv_no_gather(M, x)),
                    "reference_ms": time_ms(lambda: spmv_reference(M, x)),
                    "library_ms": time_ms(library_call(M, x)),
                    "eager_ms": eager_ms(lambda: tiled_spmv(T, x)),
                    "bound_ms": bound_ms, "bound_by": bound_by,
                    "stages": stages}
                records[size, tag, mat_name] = rec
                phase(3, f"{what} ({M.nnz} nnz): tiles of {T.n_strips} "
                         f"strips of {T.strip_width} in {T.n_groups} groups x "
                         f"{T.n_chunks} row chunks, {T.smem_bytes} B shared, "
                         f"built in {tiles_s:.3f} s; "
                         f"max_abs_err={err:.3e} (<= {rtol:g}*{scale:.3e}), "
                         f"repeat bitwise-identical; tiled={rec['ms']:.5f} ms "
                         f"({rec['bound_ms'] / rec['ms']:.1%} of bound "
                         f"{bound_ms:.5f} ms, {bound_by}) plain="
                         f"{rec['plain_ms']:.5f} library="
                         f"{rec['library_ms']:.5f} eager_tiled="
                         f"{rec['eager_ms']:.5f} [{card}]")
                phase(3, f"{what} CSR kernel (csrc/spmv_csr.cu) on "
                         f"{P.n_blocks} row blocks ({P.nbytes} B, built in "
                         f"{blocks_s:.4f} s): {rec['csr_ms']:.5f} ms "
                         f"({bound_ms / rec['csr_ms']:.1%} of bound), "
                         f"bitwise its plain version and its repeat, "
                         f"max_abs_err={err_csr:.3e} against spmv_reference; "
                         f"plain {rec['csr_plain_ms']:.5f} ms (eager); "
                         f"without the random x gather (x read at the "
                         f"entry's index) {rec['no_gather_ms']:.5f} ms: the "
                         f"gather {1 - rec['no_gather_ms'] / rec['csr_ms']:.0%}"
                         f" of the time; previous "
                         f"design (row groups, csrc/spmv.cu) "
                         f"{rec['rowgroup_ms']:.5f} ms "
                         f"({bound_ms / rec['rowgroup_ms']:.1%}, err "
                         f"{err_prev:.3e}); library (cuSPARSE) "
                         f"{rec['library_ms']:.5f} ms [{card}]")
                phase(3, f"{what} stages (ms, graph replay): " + ", ".join(
                    f"{k}={v:.5f}" for k, v in stages.items())
                    + f"; {rec['clusters8']} clusters of 8 fit at once; "
                      f"main stage: G x C = {T.n_groups} x {T.n_chunks} "
                      f"({T.live_chunks} chunks with rows launched, "
                      f"{rec['resident']} clusters of {T.n_groups} "
                      f"resident; one group: 1 x "
                      f"{one_group.live_chunks}), bitwise block_x on both "
                      f"tilings; block_x uncut (slots=None): G x C = "
                      f"{uncut[0]} x {uncut[1]}, one group 1 x {uncut[2]} "
                      f"[{card}]")
    return records


def repair_checks(card, problem):
    """Phase 0: scale_matrix twice on the problem's A and A^T (f32) gives
    bitwise-equal values and norms.  Beside it, for the record, whether two
    scatter_reduce_ sums of the same rows (the route it left) agree.
    Returns the row sums one scale_matrix runs on the SpMM kernel."""
    from hprlp_tpu_torch.ops.device_problem import build_device_problem
    from hprlp_tpu_torch.ops.spmm import csr_spmm
    from hprlp_tpu_torch.ops.spmv import row_of_entry
    from hprlp_tpu_torch.solver.scaling import scale_matrix

    lp, _ = build_device_problem(problem, dtype=torch.float32, device="cuda")
    before = csr_spmm.launches
    runs = [scale_matrix(lp.A, lp.AT) for _ in range(2)]
    torch.cuda.synchronize()
    sums = (csr_spmm.launches - before) // 2
    (a1, at1, r1, c1), (a2, at2, r2, c2) = runs
    same = {"A": torch.equal(a1.vals, a2.vals),
            "AT": torch.equal(at1.vals, at2.vals),
            "row_norm": torch.equal(r1, r2), "col_norm": torch.equal(c1, c2)}
    rows, vals = row_of_entry(lp.A), lp.A.vals.abs()
    atomics = [torch.zeros(lp.A.nrows, device="cuda").scatter_reduce_(
        0, rows, vals, reduce="sum") for _ in range(2)]
    phase(0, f"scale_matrix twice on {problem.name} (f32, {lp.A.nnz} nnz): "
             f"bitwise equal {same}; {sums} row sums on the SpMM kernel per "
             f"run; two scatter_reduce_ sums of |A|'s rows bitwise equal: "
             f"{torch.equal(*atomics)} [{card}]")
    check(all(same.values()), f"phase 0: scale_matrix is not bitwise "
          f"repeatable: {same}")
    check(sums > 0, "phase 0: scale_matrix ran no row sum on the card")
    return sums


# The single-LP SpMV wrappers by the name of their launches in a record:
# the tiled kernel and its fused halves, the column-sharded mesh's
# epilogue, the CSR kernel ("gather") and its fused halves, and the
# previous designs, which no solve may launch: the row-group CSR kernel,
# the tiles' group-sum pass (block_x at G > 1) and the fused halves on
# block_x.
SPMV_COUNTERS = {"tiled": "tiled_spmv", "tiled_x_half": "tiled_x_half",
                 "tiled_y_half": "tiled_y_half",
                 "epilogue": "tiled_half_epilogue", "gather": "csr_spmv",
                 "x_half": "spmv_x_half", "y_half": "spmv_y_half",
                 "rowgroup": "csr_spmv_rowgroup",
                 "group_sum": "group_sum_kernel",
                 "x_half_block_x": "tiled_x_half_block_x",
                 "y_half_block_x": "tiled_y_half_block_x"}
# Each backend's fused halves, by their keys in SPMV_COUNTERS.
FUSED_HALVES = {"tiled": ("tiled_x_half", "tiled_y_half"),
                "gather": ("x_half", "y_half")}


def spmv_counters():
    from hprlp_tpu_torch.ops import spmv

    return {k: getattr(spmv, name) for k, name in SPMV_COUNTERS.items()}


def reset_spmv_launches():
    for fn in spmv_counters().values():
        fn.launches = 0


def spmv_launches():
    """{key of SPMV_COUNTERS: launches}."""
    return {k: fn.launches for k, fn in spmv_counters().items()}


def check_backend(n, backend, launches):
    """Fail unless a one-card solve on `backend` launched its SpMV kernel
    and its fused halves and no other's ("dense": none), never the mesh's
    epilogue, never the row-group design, never the tiles' group-sum
    pass and never a fused half on block_x.  launches: spmv_launches() (a record may lack a kernel it never
    counted)."""
    for name in ("tiled", "gather"):
        count = launches.get(name, 0)
        if name == backend:
            check(count > 0, f"phase {n}: the {name} kernel was never "
                  f"launched")
        else:
            check(count == 0, f"phase {n}: a solve on {backend} launched "
                  f"the {name} kernel {count} times")
        for half in FUSED_HALVES[name]:
            count = launches.get(half, 0)
            check((count > 0) == (name == backend), f"phase {n}: a solve on "
                  f"{backend} launched the fused {half} {count} times")
    for name in ("epilogue", "rowgroup", "group_sum", "x_half_block_x",
                 "y_half_block_x"):
        check(launches.get(name, 0) == 0, f"phase {n}: a one-card solve "
              f"launched {SPMV_COUNTERS[name]} {launches.get(name)} times")


def check_probes(n, rec):
    """Fail if an autotune probe failed (the autotune keeps the baseline
    then, and says so on stderr)."""
    check(rec is None or not rec["failed"], f"phase {n}: autotune probes "
          f"failed: {rec and rec['failed']}")


def probe_text(rec):
    """The autotune record as one phrase."""
    if rec is None:
        return "no probe"
    return ("probes " + ", ".join(f"{k}={v * 1e3:.4f} ms"
                                  for k, v in rec["seconds"].items())
            + f" -> {rec['choice']}")


def run_solve(n, problem, params, card, peak=False):
    """One solve on the main path.  Returns (result, host f64 KKT, SpMV
    launches by kernel (spmv_launches), SpMM launches: the scaling's row
    sums, peak device bytes or None)."""
    import hprlp_tpu_torch as hp
    from hprlp_tpu_torch.ops.spmm import csr_spmm
    from hprlp_tpu_torch.solver.autotune import autotune_backends
    from hprlp_tpu_torch.solver.loop import solve_problem

    reset_spmv_launches()
    csr_spmm.launches = 0
    if peak:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    res = hp.solve(problem.A, problem.AL, problem.AU, problem.l, problem.u,
                   problem.c, params, obj_constant=problem.obj_constant)
    peak_bytes = torch.cuda.max_memory_allocated() if peak else None
    launches = spmv_launches()
    row_sums = csr_spmm.launches
    kkt = problem.kkt_error(res.x, res.y, res.z)["kkt"]
    its = res.iter / res.time if res.time > 0 else float("nan")
    probes = probe_text(autotune_backends.record)
    phase(n, f"{problem.name}: status={res.status} iter={res.iter} "
             f"setup={res.setup_time:.3f}s scaling={res.scaling_time:.3f}s "
             f"autotune={res.autotune_time:.3f}s ({probes}) "
             f"power={res.power_time:.3f}s "
             f"graph capture={solve_problem.capture_time:.3f}s "
             f"solve={res.time:.3f}s it/s={its:.1f} "
             f"backend={res.spmv_backend} launches={launches} csr_spmm "
             f"(row sums) {row_sums} primal_obj={res.primal_obj:.10e} "
             f"kkt_f64={kkt:.3e}"
             + ("" if peak_bytes is None else
                f" peak_memory={peak_bytes / 2**30:.3f} GiB") + f" [{card}]")
    check_backend(n, res.spmv_backend, launches)
    check_probes(n, autotune_backends.record)
    check(row_sums > 0, f"phase {n}: the scaling's row sums never ran on "
          f"the SpMM kernel")
    check(res.status == "OPTIMAL", f"phase {n}: status {res.status}")
    return res, kkt, launches, row_sums, peak_bytes


def build_kernels():
    """Build every kernel library at once, one nvcc process per source,
    and the host library (presolve, MPS reader; one g++) beside them.
    Returns {source: (library, seconds, nvcc -Xptxas -v output)}, the host
    library under native.LIB_PATH."""
    from hprlp_tpu_torch import native
    from hprlp_tpu_torch.ops import spmm, spmv

    sources = (spmv.TILED_SOURCE, spmv.SOURCE, spmv.ROWGROUP_SOURCE,
               spmm.SOURCE, spmm.ROWWISE_SOURCE)
    logs = {src: [] for src in sources}

    def one(src):
        t0 = time.perf_counter()
        lib = (native.build() if src == native.LIB_PATH
               else spmv.build(src, logs[src]))
        return lib, time.perf_counter() - t0

    jobs = (*sources, native.LIB_PATH)
    with ThreadPoolExecutor(len(jobs)) as pool:
        built = dict(zip(jobs, pool.map(one, jobs)))
    return {src: (*built[src], "".join(logs.get(src, []))) for src in jobs}


@contextlib.contextmanager
def recorded(record, calls):
    """Wrap each (owner, attribute) of `calls` so that every call appends
    (attribute, seconds, result) to `record`; restore them on exit."""
    saved = [(owner, name, getattr(owner, name)) for owner, name in calls]

    def wrap(name, fn):
        def timed(*args, **kw):
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            record.append((name, time.perf_counter() - t0, out))
            return out
        return timed

    for owner, name, fn in saved:
        setattr(owner, name, wrap(name, fn))
    try:
        yield record
    finally:
        for owner, name, fn in saved:
            setattr(owner, name, fn)


def read_solution(path):
    """The CLI's solution file (cli.write_solution) as (dict of the
    `key value` lines, {"x": array, "y": array, "z": array})."""
    with open(path) as f:
        lines = f.read().splitlines()
    head, vecs, k = {}, {}, 0
    while k < len(lines):
        key, val = lines[k].split(" ", 1)
        k += 1
        if key in ("x", "y", "z"):
            size = int(val)
            vecs[key] = np.array(lines[k:k + size], dtype=np.float64)
            k += size
        else:
            head[key] = val
    return head, vecs


# Phase 8's LP: structured_lp(MPS_SCALE), 10.50M nnz at 1.0.
MPS_SCALE = 1.0
# benchmarks/report_presolve_scale.json at scale 1.0: the reduced problem.
REPORT_REDUCED = (500_000, 549_999, 8_249_671)


def mps_phase(card, scale, cli_extra=()):
    """Phase 8: structured_lp(scale) written as MPS, solved by
    cli.main (native reader, presolve, tiled-kernel solve, postsolve,
    original-space KKT, solution file), checked against a presolve-off
    solve.  Returns (SpMV launches by backend during cli.main, csr_spmm
    launches there (the scaling's row sums), record)."""
    import hprlp_tpu_torch as hp
    from hprlp_tpu_torch import cli, native, presolve
    from hprlp_tpu_torch.io import native_mps
    from hprlp_tpu_torch.ops.spmm import csr_spmm
    from hprlp_tpu_torch.prof.problems import structured_lp, write_mps

    check(native.is_available(), f"phase 8: the host library did not load: "
          f"{native.lib_error}")
    t0 = time.perf_counter()
    problem = structured_lp(scale=scale, seed=7)
    gen_s = time.perf_counter() - t0
    phase(8, f"structured_lp(scale={scale}, seed=7): {problem.m} x "
             f"{problem.n}, {problem.nnz} nnz, generated in {gen_s:.2f} s")
    tmp = tempfile.mkdtemp(prefix="hprlp_smoke_")
    try:
        need = 80 * problem.nnz  # ~52 bytes per written entry, and slack
        free = shutil.disk_usage(tmp).free
        check(free > need, f"phase 8: {free} bytes free in {tmp}, the MPS "
              f"file needs ~{need}")
        mps, sol = os.path.join(tmp, "lp.mps"), os.path.join(tmp, "sol.txt")
        t0 = time.perf_counter()
        write_mps(problem, mps)
        write_s = time.perf_counter() - t0
        size = os.path.getsize(mps)

        record = []
        reset_spmv_launches()
        csr_spmm.launches = 0
        with recorded(record, [(native_mps, "read_mps_native"),
                               (presolve, "presolve_problem"),
                               (presolve.PresolveHandle, "postsolve"),
                               (presolve, "validate_original_kkt"),
                               (hp.Model, "solve")]):
            t0 = time.perf_counter()
            rc = cli.main(["-i", mps, "--tol", "1e-4", "--quiet",
                           "--solution-out", sol, *cli_extra])
            cli_s = time.perf_counter() - t0
        by_backend = spmv_launches()
        launches, csr_launches = by_backend["tiled"], by_backend["gather"]
        row_sums = csr_spmm.launches
        stage = {name: (secs, out) for name, secs, out in record}
        check(set(stage) == {"read_mps_native", "presolve_problem",
                             "postsolve", "validate_original_kkt", "solve"},
              f"phase 8: the CLI took another path: {sorted(stage)}")
        status, reduced, _ = stage["presolve_problem"][1]
        check(status == "OK", f"phase 8: presolve status {status}")
        res = stage["solve"][1]
        phase(8, f"reduced {reduced.m} x {reduced.n}, {reduced.nnz} nnz "
                 f"(benchmarks/report_presolve_scale.json at scale 1.0: "
                 f"{REPORT_REDUCED[0]} x {REPORT_REDUCED[1]}, "
                 f"{REPORT_REDUCED[2]} nnz)")
        head, vecs = read_solution(sol)
        kkt = problem.kkt_error(vecs["x"], vecs["y"], vecs["z"])
        times = {"write": write_s, "native_read": stage["read_mps_native"][0],
                 "presolve": res.presolve_time, "setup": res.setup_time,
                 "scaling": res.scaling_time, "power": res.power_time,
                 "solve": res.time, "postsolve": stage["postsolve"][0],
                 "kkt_validation": stage["validate_original_kkt"][0],
                 "cli_main": cli_s}
        phase(8, f"cli.main rc={rc} status={head['status']} "
                 f"iter={head['iter']} primal_obj={head['primal_obj']} "
                 f"kkt_f64={kkt['kkt']:.3e} backend={res.spmv_backend} "
                 f"launches={launches} csr_launches={csr_launches} "
                 f"autotune={res.autotune_time:.3f}s csr_spmm (row sums) "
                 f"{row_sums}; file {size} bytes; stage "
                 f"times (s): " + ", ".join(f"{k}={v:.3f}"
                                            for k, v in times.items())
              + f" [{card}]")

        t0 = time.perf_counter()
        ref = hp.Model(problem).solve(hp.Parameters(
            stop_tol=1e-4, verbose=False, use_presolve=False),
            device="cpu" if "cpu" in cli_extra else None)
        ref_s = time.perf_counter() - t0
        obj = float(head["primal_obj"])
        rel = abs(obj - ref.primal_obj) / max(1.0, abs(ref.primal_obj))
        phase(8, f"presolve off, in-process: status={ref.status} "
                 f"iter={ref.iter} setup={ref.setup_time:.3f}s "
                 f"scaling={ref.scaling_time:.3f}s power="
                 f"{ref.power_time:.3f}s solve={ref.time:.3f}s "
                 f"(all {ref_s:.3f}s) primal_obj={ref.primal_obj:.10e}; "
                 f"rel diff {rel:.3e} [{card}]")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "hprlp_tpu_torch.cli", "-i",
         os.path.join(HERE, "data", "model.mps"), "--quiet", *cli_extra],
        cwd=HERE, capture_output=True, text=True, timeout=300)
    phase(8, f"python -m hprlp_tpu_torch.cli -i data/model.mps --quiet: "
             f"rc={proc.returncode} in {time.perf_counter() - t0:.1f} s: "
             f"{proc.stdout.strip()}")

    check(rc == 0 and head["status"] == "OPTIMAL",
          f"phase 8: cli.main rc={rc}, status {head['status']}")
    check(kkt["kkt"] < 1e-3, f"phase 8: host f64 KKT {kkt['kkt']}")
    check(ref.status == "OPTIMAL", f"phase 8: presolve-off status "
          f"{ref.status}")
    check(rel < 1e-3, f"phase 8: objective {obj} against {ref.primal_obj} "
          f"with presolve off")
    check_backend(8, res.spmv_backend, by_backend)
    check(row_sums > 0, "phase 8: the scaling's row sums never ran on the "
          "SpMM kernel")
    check(proc.returncode == 0 and "status=OPTIMAL" in proc.stdout,
          f"phase 8: python -m hprlp_tpu_torch.cli failed: {proc.stdout}"
          f"{proc.stderr[-2000:]}")
    return by_backend, row_sums, {
        "m": problem.m, "n": problem.n, "nnz": problem.nnz,
        "spmv_backend": res.spmv_backend,
        "reduced": [reduced.m, reduced.n, reduced.nnz], "iter": res.iter,
        "iter_presolve_off": ref.iter, "kkt_f64": kkt["kkt"],
        "times_s": times}


def ptxas_summary(log):
    """One line per kernel from nvcc -Xptxas -v: registers and spills."""
    kernels, order, name = {}, [], None
    for line in log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties "
                      r"for) '?(\w+)'?", line)
        if m:
            name = m.group(1)
            if name not in kernels:
                kernels[name] = []
                order.append(name)
        elif name and ("spill" in line or "Used" in line):
            kernels[name].append(line.split(":", 1)[-1].strip())
    pretty = dict(zip(order, order))
    if order and shutil.which("c++filt"):
        out = subprocess.run(["c++filt"], input="\n".join(order),
                             capture_output=True, text=True).stdout
        pretty = {k: v.replace("(anonymous namespace)::", "").split("(")[0]
                  .removeprefix("void ")
                  for k, v in zip(order, out.splitlines())}
    return [f"{pretty[k]}: {'; '.join(kernels[k])}" for k in order]


# Each family's headline variant (exact) for the kernels' JSON record, and
# the Pallas study it replaces (make_kernel; spmv_loop; pallas_call).
HEADLINE = {"ablate": "full", "multi_acc": "n_acc=1", "flush": "full",
            "segsum": "full"}
REPLACES = {
    "ablate": ("benchmarks/prof_lane_ablate.py:44", ":90", ":115"),
    "multi_acc": ("benchmarks/prof_dual_acc.py:32", ":60", ":87"),
    "flush": ("benchmarks/prof_flush_variants.py:46", ":97", ":122"),
    "segsum": ("benchmarks/prof_kernel_variants.py:39", ":121", ":152"),
}


def variants_phase(card, built, huge_problem):
    """Phase 7: the variant-study path at the bench LP (A, A^T) and at
    phase 6's LP (A).  Returns the four families' JSON records."""
    from hprlp_tpu_torch.ops import spmv as spmv_mod
    from hprlp_tpu_torch.ops import spmv_variants as sv
    from hprlp_tpu_torch.prof import (prof_dual_acc, prof_flush_variants,
                                      prof_kernel_variants, prof_lane_ablate,
                                      study)

    # The study instantiations of the two libraries built in phase 2: the
    # tiled kernel's segsum (SEG 1-4), the CSR kernel's ablate (3-6) and
    # flush (7, 8) epilogues and multi_acc (NACC 2, 4).
    study_inst = re.compile(r"tiled_spmv_kernel<float, 1, [1-4]>|"
                            r"csr_spmv_kernel<float, [3-8], [124]>")
    for src in (spmv_mod.TILED_SOURCE, spmv_mod.SOURCE):
        lines = ptxas_summary(built[src][2])
        picked = [ln for ln in lines if study_inst.search(ln)] or lines
        for line in picked:
            phase(7, f"ptxas {os.path.basename(src)} {line}")
    sizes = {"bench": study.device_matrices(make_problem()),
             "huge": {"A": study.device_matrices(huge_problem)["A"]}}
    modules = (prof_lane_ablate, prof_dual_acc, prof_flush_variants,
               prof_kernel_variants)

    for wrapper in sv.WRAPPERS.values():
        wrapper.launches = 0
    timings = {(m.FAMILY, size): m.run(mats)
               for m in modules for size, mats in sizes.items()}
    launches = {fam: w.launches for fam, w in sv.WRAPPERS.items()}

    library = {size: {} for size in sizes}
    for size, mats in sizes.items():
        for mat, M in mats.items():
            library[size][mat] = time_ms(library_call(M, study.study_x(M)))
            phase(7, f"{size} {mat}: {M.blocks.n_blocks} row blocks; "
                     f"torch.mv on sparse CSR (cuSPARSE) "
                     f"{library[size][mat] * 1e3:.3f} us [{card}]")
    records, failed = [], []
    for m in modules:
        fam = m.FAMILY
        src = os.path.relpath(spmv_mod.TILED_SOURCE if fam == "segsum"
                              else spmv_mod.SOURCE, HERE)
        checks = []
        for size, mats in sizes.items():
            got = study.check(fam, mats, m.VARIANTS)
            checks += [dict(c, size=size) for c in got]
            for line in study.report(timings[fam, size], got, card, size,
                                     library[size]):
                phase(7, line)
        failed += [f"{fam}/{c['size']}/{c['matrix']}/{c['variant']}"
                   for c in checks if not c["ok"]]
        check(launches[fam] > 0, f"phase 7: {fam} was never launched")
        for (f, size), recs in timings.items():
            for r in recs:
                check(f != fam or r["launches"] > 0,
                      f"phase 7: {fam}/{r['variant']} was never launched")
        head = HEADLINE[fam]
        M = sizes["bench"]["A"]
        x = study.study_x(M)
        t = {(r["matrix"], r["variant"], size): r
             for (f, size), recs in timings.items() if f == fam for r in recs}
        bench_a = t["A", head, "bench"]
        variants = {}
        for name in m.VARIANTS:
            v = sv.variant(fam, name)
            errs = [c for c in checks if c["variant"] == name]
            shape = {f"{size}_{mat}": t[mat, name, size]
                     for size, mats in sizes.items() for mat in mats}
            # The plain version reads counts on the host: timed eagerly.
            plain_ms = eager_ms(lambda: sv.plain(fam, M, x, name), reps=3)
            variants[name] = {
                "source": src, "kind": v.kind, "bitwise": v.bitwise,
                "bitwise_equal": all(c["bitwise"] for c in errs),
                "ms": {k: r["ms"] for k, r in shape.items()},
                "bound_ms": {k: r["bound_ms"] for k, r in shape.items()},
                "launches": sum(r["launches"] for r in shape.values()),
                "plain_ms_bench_A": plain_ms,
                "max_abs_err": max(c["err"] for c in errs),
                "tol_abs": min(c["tol"] * c["scale"] for c in errs)}
            phase(7, f"{fam} {name}: {variants[name]['launches']} launches;"
                     f" plain version (eager) at bench A {plain_ms:.3f} ms "
                     f"[{card}]")
        extra = {"library_ms_shapes": {f"{size}_{mat}": ms
                                       for size, lib_ms in library.items()
                                       for mat, ms in lib_ms.items()}}
        if fam == "segsum":
            # The segsum family runs on the main path's tiles
            # (csrc/spmv_tiled.cu, SEG): beside it, the tiled kernel on
            # the same tiles.
            for size, mats in sizes.items():
                for mat, Mt in mats.items():
                    xt = study.study_x(Mt)
                    t_ms = time_ms(lambda: spmv_mod.tiled_spmv(Mt.tiles, xt))
                    extra[f"tiled_ms_{size}_{mat}"] = t_ms
                    seg = ", ".join(
                        f"{name} {t[mat, name, size]['ms'] * 1e3:.3f}"
                        for name in m.VARIANTS)
                    phase(7, f"segsum {size} {mat} (us): {seg}; the tiled "
                             f"kernel on the same tiles {t_ms * 1e3:.3f} us,"
                             f" cuSPARSE {library[size][mat] * 1e3:.3f} us "
                             f"[{card}]")
        records.append({
            "name": f"spmv_{fam}", "route": "cuda",
            # Every variant's kernel: the tiles' for segsum, the "gather"
            # backend's CSR kernel for the other three.
            "source": src, **extra,
            "replaces": REPLACES[fam][0],
            "also_replaces": "spmv_loop " + REPLACES[fam][1]
                             + ", pallas_call " + REPLACES[fam][2],
            "launches": launches[fam], "headline_variant": head,
            "max_abs_err": variants[head]["max_abs_err"],
            "ms": bench_a["ms"],
            # The plain versions read counts on the host (csr_spmv_plain's
            # row lengths, segsum's sub-blocks), so they are timed eagerly,
            # not by graph replay.
            "plain_ms": variants[head]["plain_ms_bench_A"],
            "bound_ms": bench_a["bound_ms"], "bound_by": bench_a["bound_by"],
            "library_ms": library["bench"]["A"], "variants": variants})
    phase(7, "launches on the study path: " + ", ".join(
        f"{k}={v}" for k, v in launches.items()))
    check(not failed, f"phase 7: outside tolerance: {failed}")
    return records


# Phase 9's batch widths for the SpMM kernel, and its tolerances, relative
# to the row sums of |A| |X| (the kernel's fused multiply-adds round
# otherwise than the plain version's products and sums).
SPMM_BATCHES = (1, 8, 64, 256)
SPMM_TOL = {"f32": 1e-5, "f64": 1e-12}


def spmm_check(card, problem):
    """Phase 9 (a): the SpMM kernel against its plain version and the
    previous design on the unscaled A and A^T of `problem`.  Returns
    {(dtype tag, matrix, B): record}."""
    from hprlp_tpu_torch.ops.device_problem import build_device_problem
    from hprlp_tpu_torch.ops import spmm as spmm_mod
    from hprlp_tpu_torch.ops.spmm import (csr_spmm, csr_spmm_rowwise,
                                          spmm_grid, spmm_plan,
                                          spmm_reference)
    from hprlp_tpu_torch.prof.timing import gather_bytes, spmv_bound

    def uncapped(M, X):
        """The solver's design with no L2 cap on its slices' width."""
        G, V, n_slices = spmm_plan(X.shape[1], X.element_size(),
                                   X.data_ptr())
        plan = (G, V, *spmm_grid(M.nrows, G, n_slices))
        Y = torch.empty((M.nrows, X.shape[1]), dtype=X.dtype, device="cuda")
        return lambda: spmm_mod._launch(spmm_mod.STORE, M, X, Y, plan=plan)

    rng = np.random.default_rng(9)
    records = {}
    for dtype, tag in ((torch.float32, "f32"), (torch.float64, "f64")):
        lp, _ = build_device_problem(problem, dtype=dtype, device="cuda")
        for mat_name, M in (("A", lp.A), ("AT", lp.AT)):
            S = torch.sparse_csr_tensor(M.indptr, M.indices, M.vals,
                                        (M.nrows, M.ncols))
            absM = M.with_vals(M.vals.abs())
            for B in SPMM_BATCHES:
                X = torch.as_tensor(rng.normal(size=(M.ncols, B)),
                                    device="cuda").to(dtype)
                Y = csr_spmm(M, X)
                Y_again = csr_spmm(M, X)
                Y_prev = csr_spmm_rowwise(M, X)
                Y_ref = spmm_reference(M, X)
                scale = spmm_reference(absM, X.abs())
                torch.cuda.synchronize()
                diff = (Y - Y_ref).abs()
                err = float((diff / torch.clamp(
                    scale, min=torch.finfo(dtype).tiny)).max())
                what = f"phase 9: SpMM {tag} {mat_name} B={B}"
                check(err <= SPMM_TOL[tag], f"{what}: error {err} relative "
                      f"to |A||X| > {SPMM_TOL[tag]}")
                check(torch.equal(Y, Y_again), f"{what}: two launches "
                      f"differ")
                check(torch.equal(Y, Y_prev), f"{what}: not bitwise equal "
                      f"to the previous design, which sums in the same "
                      f"order (max diff {float((Y - Y_prev).abs().max())})")
                bound_ms, bound_by = spmv_bound(M, dtype, B)
                align = X.data_ptr()
                rec = {"nnz": M.nnz, "err": err,
                       "max_abs_err": float(diff.max()),
                       "plan": spmm_plan(B, X.element_size(), align,
                                         M.ncols),
                       "prev_plan": spmm_plan(B, X.element_size(), align),
                       "ms": time_ms(lambda: csr_spmm(M, X)),
                       "prev_ms": time_ms(lambda: csr_spmm_rowwise(M, X)),
                       "uncapped_ms": (time_ms(uncapped(M, X))
                                       if B >= 64 else None),
                       "plain_ms": time_ms(lambda: spmm_reference(M, X),
                                           reps=10),
                       "library_ms": time_ms(lambda: torch.sparse.mm(S, X)),
                       "bound_ms": bound_ms, "bound_by": bound_by,
                       "gather_bytes": gather_bytes(M, dtype, B)}
                rec["l2_tbs"] = rec["gather_bytes"] / rec["ms"] * 1e-9
                rec["prev_l2_tbs"] = rec["gather_bytes"] / rec["prev_ms"] \
                    * 1e-9
                records[tag, mat_name, B] = rec
                unc = rec["uncapped_ms"]
                phase(9, f"SpMM {tag} {mat_name} B={B} ({M.nnz} nnz, plan "
                         f"G,V,slices={rec['plan']}, previous "
                         f"{rec['prev_plan']}): err {err:.3e} (<= "
                         f"{SPMM_TOL[tag]:g} of |A||X|), repeat and previous "
                         f"design bitwise-identical; kernel={rec['ms']:.5f} "
                         f"ms ({bound_ms / rec['ms']:.1%} of bound "
                         f"{bound_ms:.5f} ms, {bound_by}) previous="
                         f"{rec['prev_ms']:.5f} uncapped="
                         f"{'-' if unc is None else f'{unc:.5f}'} plain="
                         f"{rec['plain_ms']:.5f} cusparse="
                         f"{rec['library_ms']:.5f}; X gathered from L2 "
                         f"{rec['gather_bytes'] / 1e6:.1f} MB: "
                         f"{rec['l2_tbs']:.2f} TB/s (previous "
                         f"{rec['prev_l2_tbs']:.2f}) [{card}]")
    for tag in ("f32", "f64"):
        for B in (64, 256):
            r = records[tag, "A", B]
            check(r["ms"] < r["prev_ms"], f"phase 9: the SpMM at {tag} A "
                  f"B={B} ({r['ms']} ms) is not faster than the previous "
                  f"design ({r['prev_ms']} ms)")
    return records


# batched_large's iterations with the previous SpMM design and unfused
# halves (PERF.md section 6), against which phase 9 (b) prints its own.
PREVIOUS_BATCHED_ITERS = 1050


def batched_phase(card, row_sums):
    """Phase 9 (b) and (c).  `row_sums`: the SpMM launches of one
    scale_matrix (phase 0).  Returns ({kernel: launches in (b)'s solve}
    for the SpMM, the two fused halves and the tiled SpMV, record)."""
    import hprlp_tpu_torch as hp
    from hprlp_tpu_torch.ops.device_problem import csr_from_coo
    from hprlp_tpu_torch.ops.sparse import spmm, with_backend
    from hprlp_tpu_torch.ops.spmm import (csr_spmm, csr_spmm_rowwise,
                                          spmm_x_half, spmm_y_half,
                                          spmm_y_half_previous)
    from hprlp_tpu_torch.ops.spmv import csr_spmv, tiled_spmv
    from hprlp_tpu_torch.prof import prof_loop
    from hprlp_tpu_torch.prof.problems import batched_lp

    # (b) batched_large.
    t0 = time.perf_counter()
    arrays = batched_lp(65536, 131072, 64, seed=3)
    A, C, AL, AU, l, u = arrays
    B = C.shape[1]
    phase(9, f"batched_large: batched_lp(65536, 131072, 64, seed=3): "
             f"{A.shape[0]} x {A.shape[1]}, {A.nnz} nnz, B={B}, generated "
             f"in {time.perf_counter() - t0:.2f} s")
    counted = {"csr_spmm": csr_spmm, "spmm_x_half": spmm_x_half,
               "spmm_y_half": spmm_y_half, "tiled_spmv": tiled_spmv,
               "csr_spmv": csr_spmv, "csr_spmm_rowwise": csr_spmm_rowwise,
               "spmm_y_half_previous": spmm_y_half_previous}
    for fn in counted.values():
        fn.launches = 0
    res = hp.solve_batched(A, C, AL, AU, l, u, params=hp.Parameters(
        stop_tol=1e-4, verbose=False, time_limit=300))
    launches = {name: fn.launches for name, fn in counted.items()}
    # The same solve with the y-half on its previous design: bitwise the
    # same members (statuses, iterations, objectives).
    from hprlp_tpu_torch.solver import batched as batched_mod
    with swapped(batched_mod, spmm_y_half=spmm_y_half_previous):
        res_prev = hp.solve_batched(A, C, AL, AU, l, u, params=hp.Parameters(
            stop_tol=1e-4, verbose=False, time_limit=300))
    same_prev = (res.status == res_prev.status
                 and np.array_equal(res.iter, res_prev.iter)
                 and np.array_equal(res.primal_obj, res_prev.primal_obj))
    phase(9, f"batched_large with the previous y-half (spmm_y_half_previous"
             f", {spmm_y_half_previous.launches} launches): statuses, "
             f"per-member iterations and objectives bitwise the solve's: "
             f"{same_prev}; solve={res_prev.solve_time:.3f}s against "
             f"{res.solve_time:.3f}s [{card}]")
    check(same_prev, "phase 9: batched_large's members differ with the "
          "previous y-half")
    kkt = np.array([hp.LpProblem.from_arrays(
        A, AL[:, k], AU[:, k], l[:, k], u[:, k], C[:, k]).kkt_error(
        res.x[:, k], res.y[:, k], res.z[:, k])["kkt"] for k in range(B)])
    its = res.iter.max() / res.solve_time
    n_opt = sum(s == "OPTIMAL" for s in res.status)
    phase(9, f"batched_large: {n_opt}/{B} OPTIMAL, iterations max "
             f"{res.iter.max()} mean {res.iter.mean():.1f}; setup="
             f"{res.setup_time:.3f}s power={res.power_time:.3f}s graph "
             f"capture={hp.solve_batched.capture_time:.3f}s solve="
             f"{res.solve_time:.3f}s time={res.time:.3f}s it/s={its:.1f} "
             f"(max iterations over solve time; {PREVIOUS_BATCHED_ITERS} "
             f"with the previous SpMM and unfused halves); host f64 KKT max "
             f"{kkt.max():.3e} mean {kkt.mean():.3e}; launches "
             + ", ".join(f"{k}={v}" for k, v in launches.items())
             + f" [{card}]")
    singles = {}
    for k in (0, B - 1):
        one = hp.solve(A, AL[:, k], AU[:, k], l[:, k], u[:, k], C[:, k],
                       hp.Parameters(stop_tol=1e-4, verbose=False,
                                     use_presolve=False))
        rel = abs(one.primal_obj - res.primal_obj[k]) / max(
            1.0, abs(one.primal_obj))
        singles[k] = {"status": one.status, "iter": one.iter,
                      "primal_obj": one.primal_obj,
                      "batched_obj": float(res.primal_obj[k]),
                      "batched_iter": int(res.iter[k]), "rel": rel}
        phase(9, f"batched_large member {k} alone: status={one.status} "
                 f"iter={one.iter} primal_obj={one.primal_obj:.10e}; "
                 f"batched {res.primal_obj[k]:.10e} at {res.iter[k]} "
                 f"iterations; rel diff {rel:.3e}")
    loop = prof_loop.BatchedLoop(arrays, torch.float32)
    prof = prof_loop.profile(loop, prof_loop.SPMM_KERNELS, chunks=1)
    phase(9, f"batched_large profile of one chunk ({prof['iters']} "
             f"iterations): {prof['its']:.1f} it/s unprofiled; wall "
             f"{prof['wall_us']:.1f} us/it, device {prof['device_us']:.1f} "
             f"us/it, busy share {prof['busy']:.3f}, "
             f"{prof['kernels']:.1f} kernels/it, SpMM and fused halves "
             f"{prof['product_us']:.1f} us/it "
             f"({prof['product_share']:.1%}) [{card}]")
    for us, count, key in prof["top"][:6]:
        phase(9, f"batched_large   {us:8.2f} us/it {count:6d}x {key}")
    del loop

    check(n_opt == B, f"phase 9: {B - n_opt} batched members not OPTIMAL: "
          f"{sorted(set(res.status))}")
    check(kkt.max() < 1e-3, f"phase 9: host f64 KKT {kkt.max()}")
    for k, r in singles.items():
        check(r["status"] == "OPTIMAL", f"phase 9: member {k} alone: "
              f"{r['status']}")
        check(r["rel"] < 1e-3, f"phase 9: member {k}: batched objective "
              f"{r['batched_obj']} against {r['primal_obj']} alone")
    for name in ("csr_spmm", "spmm_x_half", "spmm_y_half", "tiled_spmv"):
        check(launches[name] > 0, f"phase 9: {name} was never launched")
    for name in ("csr_spmv", "csr_spmm_rowwise", "spmm_y_half_previous"):
        check(launches[name] == 0, f"phase 9: the batched solve launched "
              f"{name} {launches[name]} times")

    # (c) the dense probe.
    arrays = batched_lp(2048, 4096, 256, seed=3)
    A, C, AL, AU, l, u = arrays
    runs = {}
    for backend in ("auto", "dense"):
        csr_spmm.launches = spmm_x_half.launches = 0
        r = hp.solve_batched(A, C, AL, AU, l, u, params=hp.Parameters(
            stop_tol=1e-4, verbose=False, time_limit=300,
            spmv_backend=backend))
        probe = hp.solve_batched.probe
        runs[backend] = (r, probe, csr_spmm.launches + spmm_x_half.launches)
        phase(9, f"dense probe case ({A.shape[0]} x {A.shape[1]}, {A.nnz} "
                 f"nnz, B={C.shape[1]}), spmv_backend={backend!r}: "
                 f"{sum(s == 'OPTIMAL' for s in r.status)}/{C.shape[1]} "
                 f"OPTIMAL, iterations max {r.iter.max()}, solve="
                 f"{r.solve_time:.3f}s, csr_spmm launches "
                 f"{csr_spmm.launches} ({row_sums} of them the scaling's "
                 f"row sums), fused x-half {spmm_x_half.launches}; probe "
                 f"{probe} [{card}]")
    (r_auto, probe, auto_l), (r_dense, _, dense_l) = runs["auto"], \
        runs["dense"]
    rel = np.abs(r_auto.primal_obj - r_dense.primal_obj) / np.maximum(
        1.0, np.abs(r_dense.primal_obj))
    phase(9, f"dense probe case: objectives of auto and dense agree to "
             f"{rel.max():.3e} relative")
    # One SpMM of each candidate at this shape: device time (graph replay)
    # and time per call of back-to-back eager calls (host work included),
    # the probe's own measure.
    coo = A.tocoo()
    M = csr_from_coo(coo.row, coo.col, coo.data, A.shape[0], A.shape[1],
                     torch.float32, "cuda")
    D = with_backend(M, "dense")
    X = torch.randn(A.shape[1], C.shape[1], device="cuda")
    # The previous design's wrapper (its plan recomputed on every call) at
    # about the same device time: eager minus graph, side by side, is each
    # wrapper's host cost per call.
    calls = (("kernel", lambda: spmm(M, X)), ("dense", lambda: spmm(D, X)),
             ("previous_kernel", lambda: csr_spmm_rowwise(M, X)))
    spmm_ms = {f"{name}_{how}": timer(fn) for name, fn in calls
               for how, timer in (("graph", time_ms), ("eager", eager_ms))}
    phase(9, "dense probe case, one SpMM (ms): " + ", ".join(
        f"{k}={v:.5f}" for k, v in spmm_ms.items()) + f" [{card}]")
    check(probe is not None and probe["dense_ms"] is not None,
          f"phase 9: the dense probe did not run: {probe}")
    for name, (r, _, _) in runs.items():
        check(all(s == "OPTIMAL" for s in r.status), f"phase 9: {name}: "
              f"{sorted(set(r.status))}")
    check(rel.max() < 1e-3, f"phase 9: auto and dense objectives differ by "
          f"{rel.max()}")
    check(dense_l == row_sums, f"phase 9: the dense run launched the SpMM "
          f"kernels {dense_l} times, {row_sums} of them the scaling's row "
          f"sums")
    return launches, {
        "batched_large": {
            "m": 65536, "n": 131072, "B": 64, "iter_max": int(
                res.iter.max()), "iter_mean": float(res.iter.mean()),
            "iter_previous": PREVIOUS_BATCHED_ITERS,
            "setup_s": res.setup_time, "power_s": res.power_time,
            "solve_s": res.solve_time, "kkt_f64_max": float(kkt.max()),
            "singles": singles, "profile": {
                k: prof[k] for k in ("its", "wall_us", "device_us", "busy",
                                     "kernels", "product_us",
                                     "product_share")}},
        "dense_probe": {"probe": probe, "auto_launches": auto_l,
                        "obj_rel_max": float(rel.max()),
                        "one_spmm_ms": spmm_ms}}


@contextlib.contextmanager
def swapped(owner, **attrs):
    """Set attributes of `owner` for the block's duration."""
    saved = {name: getattr(owner, name) for name in attrs}
    for name, value in attrs.items():
        setattr(owner, name, value)
    try:
        yield
    finally:
        for name, value in saved.items():
            setattr(owner, name, value)


# Members frozen in phase 9 (d)'s chunk.
FROZEN = (3, 17, 40, 63)


def fused_phase(card):
    """Phase 9 (d): on batched_large's problem, f32 and f64, one
    150-iteration run_batched_chunk from a warmed-up state with FROZEN
    members inactive, once through the fused halves and once through the
    plain ones on the card: every state tensor and metric bitwise equal,
    the frozen members' iterates unchanged.  Each half timed by graph
    replay, fused and plain, beside its byte bound; the f64 chunk
    profiled.  Returns {dtype tag: record}."""
    from hprlp_tpu_torch.ops.spmm import (spmm_x_half, spmm_y_half,
                                          spmm_y_half_previous)
    from hprlp_tpu_torch.prof import prof_loop
    from hprlp_tpu_torch.prof.problems import batched_lp
    from hprlp_tpu_torch.prof.timing import gather_bytes, half_bound
    from hprlp_tpu_torch.solver import batched

    arrays = batched_lp(65536, 131072, 64, seed=3)
    records = {}
    for dtype, tag in ((torch.float32, "f32"), (torch.float64, "f64")):
        loop = prof_loop.BatchedLoop(arrays, dtype)
        loop.run(1)
        lp, st = loop.lp, loop.state
        B = st.x.shape[1]
        active = torch.ones(B, dtype=torch.bool, device="cuda")
        active[list(FROZEN)] = False
        flag = torch.zeros(B, dtype=torch.bool, device="cuda")
        args = (lp, loop.row_norm, loop.col_norm, st, loop.sigma, loop.lam,
                flag, active, loop.check)
        spmm_x_half.launches = spmm_y_half.launches = 0
        fused = batched.run_batched_chunk(*args)
        fused_launches = (spmm_x_half.launches, spmm_y_half.launches)
        with swapped(batched, x_half=batched.x_half_plain,
                     y_half=batched.y_half_plain):
            plain = batched.run_batched_chunk(*args)
        torch.cuda.synchronize()
        (st_f, m_f), (st_p, m_p) = fused, plain
        fields = ("x", "y", "last_x", "last_y", "x_bar", "y_bar", "z_bar",
                  "y_obj", "inner")
        differ = [k for k in fields
                  if not torch.equal(getattr(st_f, k), getattr(st_p, k))]
        differ += [k for k in m_f if not torch.equal(m_f[k], m_p[k])]
        frozen = list(FROZEN)
        moved = [k for k in ("x", "y")
                 if not torch.equal(getattr(st_f, k)[:, frozen],
                                    getattr(st, k)[:, frozen])]
        max_diff = max(float((getattr(st_f, k) - getattr(st_p, k)).abs()
                             .max()) for k in ("x", "y"))

        # Each middle half alone, at the warmed-up state.
        sigma = loop.sigma.to(dtype)[None, :]
        lam_sigma = loop.lam.to(dtype) * sigma
        x, y, inner = st.x, st.y, st.inner
        x_hat = batched.x_half(lp, x, y, st.last_x, sigma, inner, 0,
                               active)[1]
        halves = {
            "x": (lambda: batched.x_half(lp, x, y, st.last_x, sigma, inner,
                                         0, active),
                  lambda: batched.x_half_plain(lp, x, y, st.last_x, sigma,
                                               inner, 0, active),
                  half_bound(lp.AT, dtype, B, "x")),
            "y": (lambda: batched.y_half(lp, y, x_hat, st.last_y, lam_sigma,
                                         inner, 0, active),
                  lambda: batched.y_half_plain(lp, y, x_hat, st.last_y,
                                               lam_sigma, inner, 0, active),
                  half_bound(lp.A, dtype, B, "y"))}
        rec = {"fused_launches": fused_launches, "differ": differ,
               "max_abs_err": max_diff, "frozen_moved": moved}
        for half, (fused_fn, plain_fn, (bound_ms, bound_by)) in \
                halves.items():
            rec[half] = {"ms": time_ms(fused_fn),
                         "eager_ms": eager_ms(fused_fn),
                         "plain_ms": time_ms(plain_fn, reps=10),
                         "bound_ms": bound_ms, "bound_by": bound_by,
                         "gather_bytes": gather_bytes(
                             lp.AT if half == "x" else lp.A, dtype, B)}
            r = rec[half]
            phase(9, f"fused {half}-half {tag} B={B}: {r['ms']:.5f} ms "
                     f"({bound_ms / r['ms']:.1%} of bound {bound_ms:.5f} "
                     f"ms, {bound_by}), eager {r['eager_ms']:.5f} ms; plain "
                     f"ops {r['plain_ms']:.5f} ms (graph replay); X "
                     f"gathered from L2 {r['gather_bytes'] / 1e6:.1f} MB: "
                     f"{r['gather_bytes'] / r['ms'] * 1e-9:.2f} TB/s "
                     f"[{card}]")
        # The y-half's kernel (the ring) against its previous design on the
        # same inputs: bitwise, and timed in turns (previous, ring, ring,
        # previous) beside the bound and the L2 rate each implies.
        y_args = (lp.A, x_hat, y, st.last_y, lp.AL, lp.AU,
                  lam_sigma.reshape(-1), inner, active, 0)
        y_ring = spmm_y_half(*y_args)
        y_prev = spmm_y_half_previous(*y_args)
        y_plain = batched.y_half_plain(lp, y, x_hat, st.last_y, lam_sigma,
                                       inner, 0, active)
        torch.cuda.synchronize()
        r = rec["y"]
        r["bitwise_previous"] = torch.equal(y_ring, y_prev)
        # The previous design against the plain ops on the same inputs.
        r["previous_max_abs_err"] = float((y_prev - y_plain).abs().max())
        check(torch.equal(y_prev, y_plain), f"phase 9: the previous y-half "
              f"({tag}) differs from the plain ops by up to "
              f"{r['previous_max_abs_err']}")
        r["previous_ms"] = time_ms(lambda: spmm_y_half_previous(*y_args))
        r["ring_ms"] = time_ms(lambda: spmm_y_half(*y_args))
        r["ring_ms_again"] = time_ms(lambda: spmm_y_half(*y_args))
        r["previous_ms_again"] = time_ms(
            lambda: spmm_y_half_previous(*y_args))
        gb = r["gather_bytes"]
        ratio = (r["ring_ms"] + r["ring_ms_again"]) / (
            r["previous_ms"] + r["previous_ms_again"])
        phase(9, f"y-half {tag} B={B}, same inputs: ring "
                 f"{r['ring_ms']:.5f} / {r['ring_ms_again']:.5f} ms, "
                 f"previous {r['previous_ms']:.5f} / "
                 f"{r['previous_ms_again']:.5f} ms (ring/previous "
                 f"{ratio:.3f}); bound "
                 f"{r['bound_ms']:.5f} ms ({r['bound_by']}; ring "
                 f"{r['bound_ms'] / r['ring_ms']:.1%}); X gathered from L2 "
                 f"{gb / 1e6:.1f} MB: ring {gb / r['ring_ms'] * 1e-9:.2f} "
                 f"TB/s, previous {gb / r['previous_ms'] * 1e-9:.2f} TB/s; "
                 f"bitwise the previous: {r['bitwise_previous']}; previous "
                 f"against the plain ops: max |diff| "
                 f"{r['previous_max_abs_err']} [{card}]")
        check(r["bitwise_previous"], f"phase 9: the y-half ({tag}) differs "
              f"from its previous design by up to "
              f"{float((y_ring - y_prev).abs().max())}")
        del y_ring, y_prev, y_plain
        phase(9, f"fused chunk {tag}: {loop.check} iterations, members "
                 f"{frozen} frozen, fused launches x/y {fused_launches}; "
                 f"fields differing from the plain halves: {differ or 'none'}"
                 f" (max |diff| {max_diff:.3e}); frozen iterates moved: "
                 f"{moved or 'none'} [{card}]")
        if tag == "f64":
            prof = prof_loop.profile(loop, prof_loop.SPMM_KERNELS, chunks=1)
            rec["profile"] = {k: prof[k] for k in (
                "its", "wall_us", "device_us", "busy", "kernels",
                "product_us", "product_share")}
            phase(9, f"batched_large f64 profile of one chunk: "
                     f"{prof['its']:.1f} it/s unprofiled; wall "
                     f"{prof['wall_us']:.1f} us/it, device "
                     f"{prof['device_us']:.1f} us/it, busy share "
                     f"{prof['busy']:.3f}, {prof['kernels']:.1f} kernels/it"
                     f", SpMM and fused halves {prof['product_us']:.1f} "
                     f"us/it ({prof['product_share']:.1%}) [{card}]")
        records[tag] = rec
        middle = loop.check - 2
        del loop, fused, plain
        check(fused_launches == (middle, middle), f"phase 9: the fused "
              f"chunk launched the halves {fused_launches} times, not "
              f"{middle} each")
        check(not differ, f"phase 9: fused and plain chunks differ ({tag}) "
              f"in {differ}")
        check(not moved, f"phase 9: frozen members moved ({tag}): {moved}")
    return records


def same_tables(a, b):
    """The stacked keys whose chunk records differ bitwise."""
    return [k for k in a if not np.array_equal(a[k], b[k])]


def graph_phase(card, prob4, prob5, peak6):
    """Phase 10: the single-LP loop at sparse_large f32 (on the tiled and
    on the gather backend, its middle halves fused into the CSR kernel)
    and assignment64 f64, and the batched loop at batched_large f32, from
    the solve's starting point, eagerly and by graph replay.  Returns
    {cell: record}."""
    from hprlp_tpu_torch.prof import prof_loop
    from hprlp_tpu_torch.prof.problems import batched_lp
    from hprlp_tpu_torch.solver.batched_device_loop import (
        capture_batched_superchunk, run_batched_superchunk)
    from hprlp_tpu_torch.solver.device_loop import (capture_superchunk,
                                                    run_superchunk)
    from hprlp_tpu_torch.params import Parameters

    patience = Parameters().stall_recovery
    records = {}

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    cells = (("sparse_large_f32", prob4, torch.float32, 1e-4, None,
              "tiled"),
             ("sparse_large_f32_gather", prob4, torch.float32, 1e-4, None,
              "gather"),
             ("assignment64_f64", prob5, torch.float64, 1e-8, None, "tiled"),
             ("batched_large_f32", None, torch.float32, 1e-4,
              batched_lp(65536, 131072, 64, seed=3), None))
    for cell, problem, dtype, tol, arrays, backend in cells:
        if arrays is None:
            loop = prof_loop.Loop(problem, dtype, backend=backend)
            args = (loop.lp, loop.scal, loop.state, loop.rd, loop.sigma,
                    loop.lam, loop.metrics)
            tail = (loop.obj_c, tol, loop.check, patience)

            def run(graph, n=128):
                return run_superchunk(*args, 0, tail[0], tol, n, loop.check,
                                      patience, None, graph)

            graph = capture_superchunk(*args, *tail)
            k_at, table_at, state_at = 6, 5, 0
            product = prof_loop.SPMV_KERNELS
        else:
            loop = prof_loop.BatchedLoop(arrays, dtype)
            args = (loop.lp, loop.row_norm, loop.col_norm, loop.state,
                    loop.rd, loop.sigma, loop.lam, loop.active, loop.metrics)

            def run(graph, n=32):
                return run_batched_superchunk(*args, 0, *loop.scales, tol,
                                              n, loop.check, graph)

            graph = capture_batched_superchunk(*args, *loop.scales, tol,
                                               loop.check, 32)
            k_at, table_at, state_at = 7, 6, 0
            product = prof_loop.SPMM_KERNELS
        eager, eager_s = timed(lambda: run(False))
        replayed, graph_s = timed(lambda: run(graph))
        k_e, k_g = eager[k_at], replayed[k_at]
        differ = same_tables(eager[table_at], replayed[table_at])
        st_e, st_g = eager[state_at], replayed[state_at]
        state_differ = [f for f in ("x", "y", "x_bar", "y_bar", "z_bar")
                        if not torch.equal(getattr(st_e, f),
                                           getattr(st_g, f))]
        iters = k_g * loop.check
        prof = prof_loop.profile(loop, product, chunks=2)
        rec = {"chunks_eager": k_e, "chunks_graph": k_g, "iter": iters,
               "capture_s": graph.capture_s,
               "replay_host_us": graph.replay_host_s / graph.replays * 1e6,
               "its_graph": iters / graph_s, "its_eager": k_e * loop.check
               / eager_s, "profile": {k: prof[k] for k in (
                   "its", "wall_us", "device_us", "busy", "kernels",
                   "product_us", "product_share")},
               "busy_unprofiled": prof["device_us"] * prof["its"] / 1e6,
               "tables_differ": differ, "state_differ": state_differ}
        records[cell] = rec
        phase(10, f"{cell}: eager {k_e} chunks in {eager_s:.3f} s "
                  f"({rec['its_eager']:.1f} it/s), graph {k_g} chunks in "
                  f"{graph_s:.3f} s ({rec['its_graph']:.1f} it/s); capture "
                  f"{graph.capture_s:.3f} s, host {rec['replay_host_us']:.1f}"
                  f" us per replay; stacked tables bitwise equal: "
                  f"{not differ}, final state bitwise equal: "
                  f"{not state_differ} [{card}]")
        phase(10, f"{cell} over replays (prof_loop, {prof['iters']} "
                  f"iterations): {prof['its']:.1f} it/s unprofiled, wall "
                  f"{prof['wall_us']:.1f} us/it profiled, device "
                  f"{prof['device_us']:.1f} us/it, busy share "
                  f"{prof['busy']:.3f} profiled and "
                  f"{rec['busy_unprofiled']:.3f} unprofiled (device us/it "
                  f"over unprofiled wall us/it), {prof['kernels']:.1f} "
                  f"kernels/it, sparse products {prof['product_us']:.1f} "
                  f"us/it ({prof['product_share']:.1%})"
                  + ("" if problem is None else
                     before_fusion(problem.name, dtype, backend))
                  + f" [{card}]")
        del loop, graph, eager, replayed
        check(k_e == k_g, f"phase 10: {cell}: {k_e} eager chunks, {k_g} "
              f"replayed")
        check(not differ, f"phase 10: {cell}: stacked tables differ in "
              f"{differ}")
        check(not state_differ, f"phase 10: {cell}: final state differs "
              f"in {state_differ}")
    phase(10, f"sparse_huge f32 solve (phase 6): peak device memory "
              f"{peak6 / 2**30:.3f} GiB (torch.cuda.max_memory_allocated) "
              f"[{card}]")
    records["sparse_huge_peak_bytes"] = peak6
    return records


# Device us/it and kernels/it of the single-LP loop on the tiles before
# their middle halves were fused (PERF.md section 5; chip_smoke.py phases
# 6 and 10 on an NVIDIA H100 80GB HBM3 at 700 W), printed beside this
# run's; and the banded giant's solve in ms/it then (phase 14 (b)).
TILES_BEFORE_FUSION = {("random65536x131072", "f32"): (65.1, 34.5),
                       ("random262144x524288", "f32"): (168.8, 34.5),
                       ("assignment64", "f64"): (48.9, 32.5)}
GIANT_MS_PER_IT_BEFORE = "1.39-1.41"
# The most kernels an iteration of the single-LP loop on the tiles may
# launch since their products and fused halves are one launch at any G.
KERNELS_PER_IT = 5.0


def before_fusion(name, dtype, backend):
    """The phrase giving TILES_BEFORE_FUSION's figures for this cell, or
    "" where there are none."""
    before = TILES_BEFORE_FUSION.get((name, str(dtype)[6:]))
    if backend != "tiled" or before is None:
        return ""
    return (f" (before the tiles' fused halves: {before[0]} device us/it, "
            f"{before[1]} kernels/it)")


def chunk_profile(n, problem, dtype, backend, card):
    """The solve loop's chunk on `backend`, as the solve replays it
    (prof_loop.profile over 2 chunks): device us/it, kernels/it, busy
    share profiled and unprofiled, and the SpMV kernels' share."""
    from hprlp_tpu_torch.prof import prof_loop

    loop = prof_loop.Loop(problem, dtype, backend=backend)
    prof = prof_loop.profile(loop, prof_loop.SPMV_KERNELS, chunks=2)
    del loop
    rec = {k: prof[k] for k in ("its", "wall_us", "device_us", "busy",
                                "kernels", "product_us", "product_share")}
    rec["busy_unprofiled"] = prof["device_us"] * prof["its"] / 1e6
    phase(n, f"{problem.name} {str(dtype)[6:]} chunk on {backend} (graph "
             f"replays, prof_loop): {prof['its']:.1f} it/s unprofiled, "
             f"device {prof['device_us']:.1f} us/it, {prof['kernels']:.1f} "
             f"kernels/it, busy share {prof['busy']:.3f} profiled and "
             f"{rec['busy_unprofiled']:.3f} unprofiled, SpMV "
             f"{prof['product_us']:.1f} us/it ({prof['product_share']:.1%})"
             + before_fusion(problem.name, dtype, backend) + f" [{card}]")
    return rec


def autotune_phase(card, prob4):
    """Phase 11: the autotune twice on three LPs, the chunk it picked
    profiled, forced backends, and the CLI's --cusparse-spmv true.  Returns
    ({dtype tag: {"gather", "x_half", "y_half", "tiled_x_half",
    "tiled_y_half", "group_sum", "x_half_block_x", "y_half_block_x":
    launches of the solves}}, record)."""
    import hprlp_tpu_torch as hp
    from hprlp_tpu_torch import cli
    from hprlp_tpu_torch.prof import prof_loop
    from hprlp_tpu_torch.solver.autotune import autotune_backends

    dense_lp = random_lp(4096, 8192, 128, seed=5)
    cells = (("sparse_large_f32", prob4, torch.float32, "f32"),
             ("sparse_large_f64", prob4, torch.float64, "f64"),
             ("dense_lp_f32", dense_lp, torch.float32, "f32"))
    gather_keys = ("gather", "x_half", "y_half", "tiled_x_half",
                   "tiled_y_half", "group_sum", "x_half_block_x",
                   "y_half_block_x")
    csr_launches = {t: dict.fromkeys(gather_keys, 0) for t in ("f32", "f64")}
    records = {}
    for cell, problem, dtype, tag in cells:
        loop = prof_loop.Loop(problem, dtype, graph=False)
        probe_args = (loop.scal, loop.state, loop.sigma,
                      torch.tensor(4.0, dtype=dtype, device="cuda"),
                      torch.tensor(False, device="cuda"), 20)
        runs = []
        for _ in range(2):
            autotune_backends(loop.lp, probe_args)
            runs.append(autotune_backends.record)
            check_probes(11, runs[-1])
        del loop
        same = runs[0]["choice"] == runs[1]["choice"]
        eligible = "dense" in runs[0]["seconds"]
        phase(11, f"{cell} ({problem.nnz} nnz, dense eligible: {eligible}):"
                  f" run 1 {probe_text(runs[0])}; run 2 "
                  f"{probe_text(runs[1])}; the same choice both runs: "
                  f"{same} [{card}]")
        picked = chunk_profile(11, problem, dtype, runs[0]["choice"], card)
        solves = {}
        for backend in ("gather",) + (("dense", "auto") if eligible
                                      else ()):
            reset_spmv_launches()
            res = hp.solve(problem.A, problem.AL, problem.AU, problem.l,
                           problem.u, problem.c, hp.Parameters(
                               stop_tol=1e-4, verbose=False,
                               precision=tag, spmv_backend=backend,
                               max_iter=100_000))
            launches = spmv_launches()
            kkt = problem.kkt_error(res.x, res.y, res.z)["kkt"]
            solves[backend] = {"status": res.status, "iter": res.iter,
                               "time_s": res.time, "kkt_f64": kkt,
                               "spmv_backend": res.spmv_backend,
                               "launches": launches,
                               "primal_obj": res.primal_obj}
            for k in gather_keys:
                csr_launches[tag][k] += launches[k]
            phase(11, f"{cell} spmv_backend={backend!r}: status="
                      f"{res.status} iter={res.iter} solve={res.time:.3f}s "
                      f"it/s={res.iter / max(res.time, 1e-12):.1f} backend="
                      f"{res.spmv_backend} launches={launches} primal_obj="
                      f"{res.primal_obj:.10e} kkt_f64={kkt:.3e} [{card}]")
            check(res.status == "OPTIMAL", f"phase 11: {cell} {backend}: "
                  f"status {res.status}")
            check(kkt < 1e-3, f"phase 11: {cell} {backend}: host f64 KKT "
                  f"{kkt}")
            check_backend(11, res.spmv_backend, launches)
            check_probes(11, autotune_backends.record)
            if backend != "auto":
                check(res.spmv_backend == backend, f"phase 11: {cell}: "
                      f"forced {backend}, ran {res.spmv_backend}")
        records[cell] = {"probes": runs, "same_choice": same,
                         "dense_eligible": eligible, "solves": solves,
                         "picked_chunk": picked}
    reset_spmv_launches()
    rc = cli.main(["-i", os.path.join(HERE, "data", "model.mps"), "--quiet",
                   "--cusparse-spmv", "true"])
    launches = spmv_launches()
    phase(11, f"cli.main -i data/model.mps --cusparse-spmv true: rc={rc}, "
              f"launches {launches}")
    check(rc == 0, f"phase 11: cli.main --cusparse-spmv true: rc {rc}")
    check_backend(11, "gather", launches)
    for k in gather_keys:
        csr_launches["f32"][k] += launches[k]
    records["cli_cusparse_spmv"] = {"rc": rc, "launches": launches}
    return csr_launches, records


MODEL = os.path.join(HERE, "data", "model.mps")
# Phase 12's sparse_large request, pinned to the tiled kernel (no probe),
# so that the worker's answer is comparable bit for bit with an in-process
# solve; and its batched request, on the SpMM kernel (no dense probe).
SERVER_SOLVE = {"stop_tol": 1e-4, "use_presolve": False,
                "spmv_backend": "lane"}
SERVER_BATCHED = {"stop_tol": 1e-4, "spmv_backend": "gather"}
MEMORY_SLACK_MIB = 64
EXAMPLES = (("example_direct_lp.c", ()), ("example_mps_file.c", (MODEL,)),
            ("example_batched_lp.c", ()))


def worker_lines(text):
    """The worker's own stderr lines: (its device line or None, its kernel
    launches at exit or None)."""
    device = launches = None
    for line in text.splitlines():
        if line.startswith("device ") and device is None:
            device = line
        elif line.startswith("kernel launches "):
            launches = json.loads(line[len("kernel launches "):])
    return device, launches


def used_memory_mib(pid):
    """(MiB that nvidia-smi lists for process `pid`, or None where it
    lists no such process; MiB in use on the whole card)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-compute-apps=pid,used_memory",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True).stdout
    mine = None
    for line in out.splitlines():
        fields = [f.strip() for f in line.split(",")]
        if len(fields) == 2 and fields[0] == str(pid):
            try:
                mine = float(fields[1])
            except ValueError:
                pass
    free, total = torch.cuda.mem_get_info()
    return mine, (total - free) / 2**20


def solve_request(problem, params):
    from hprlp_tpu_torch.server import _enc

    A = problem.A.tocsr()
    return {"op": "solve", "m": problem.m, "n": problem.n,
            "Ap": _enc(A.indptr.astype(np.int64)),
            "Ai": _enc(A.indices.astype(np.int64)),
            "Ax": _enc(A.data.astype(np.float64)),
            "AL": _enc(problem.AL), "AU": _enc(problem.AU),
            "l": _enc(problem.l), "u": _enc(problem.u),
            "c": _enc(problem.c), "obj_constant": problem.obj_constant,
            "params": params}


def batched_request(arrays, params):
    from hprlp_tpu_torch.server import _enc

    A, C, AL, AU, l, u = arrays
    A = A.tocsr()
    col = lambda a: _enc(np.asarray(a, np.float64).ravel(order="F"))
    return {"op": "solve_batched", "m": A.shape[0], "n": A.shape[1],
            "batch": C.shape[1], "Ap": _enc(A.indptr.astype(np.int64)),
            "Ai": _enc(A.indices.astype(np.int64)),
            "Ax": _enc(A.data.astype(np.float64)), "C": col(C),
            "AL": col(AL), "AU": col(AU), "l": col(l), "u": col(u),
            "params": params}


def _dec(text, dtype="<f8"):
    import base64

    return np.frombuffer(base64.b64decode(text), dtype=dtype)


def server_pipes(card, prob4, built_paths):
    """Phase 12 (a): `python -m hprlp_tpu_torch.server` on the default
    device, over pipes.  Returns (record, the worker's launches, the
    sparse_large iteration count)."""
    import hprlp_tpu_torch as hp

    from hprlp_tpu_torch.prof.problems import batched_lp

    warm = {os.path.relpath(p, HERE): os.path.exists(p) for p in built_paths}
    phase(12, f"kernel libraries built before the worker starts (warm "
              f"builds): {warm}")
    check(all(warm.values()), f"phase 12: libraries missing: {warm}")
    # The in-process references first, then this process's cached blocks
    # returned: it holds the same device memory through the worker's run.
    t0 = time.perf_counter()
    ref = hp.Model.from_arrays(prob4.A, prob4.AL, prob4.AU, prob4.l,
                               prob4.u, prob4.c, prob4.obj_constant).solve(
        hp.Parameters(verbose=False, **SERVER_SOLVE))
    bargs = batched_lp(2048, 4096, 256, seed=3)
    bref = hp.solve_batched(*bargs, params=hp.Parameters(verbose=False,
                                                         **SERVER_BATCHED))
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    solve_text = json.dumps(solve_request(prob4, SERVER_SOLVE))
    batched_text = json.dumps(batched_request(bargs, SERVER_BATCHED))
    phase(12, f"in-process references: sparse_large {ref.status} "
              f"iter={ref.iter} backend={ref.spmv_backend}; batched "
              f"{bref.batch_size} members, iterations max "
              f"{int(np.max(bref.iter))}; request sizes {len(solve_text)} "
              f"and {len(batched_text)} bytes "
              f"({time.perf_counter() - t0:.2f} s)")

    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [HERE] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    err = tempfile.TemporaryFile(mode="w+")
    t_start = time.perf_counter()
    proc = subprocess.Popen([sys.executable, "-m", "hprlp_tpu_torch.server"],
                            cwd=HERE, env=env, stdin=subprocess.PIPE,
                            stdout=subprocess.PIPE, stderr=err, text=True)
    walls, times, memory = [], [], {}
    try:
        def ask(text):
            t = time.perf_counter()
            proc.stdin.write(text + "\n")
            proc.stdin.flush()
            line = proc.stdout.readline()
            check(line, "phase 12: the server closed its output")
            return json.loads(line), time.perf_counter() - t

        pong, _ = ask(json.dumps({"op": "ping"}))
        startup = time.perf_counter() - t_start
        check(pong == {"ok": True, "result": "pong"}, f"phase 12: {pong}")
        err.seek(0)
        device = err.readline().strip()
        phase(12, f"worker pid {proc.pid} up in {startup:.2f} s: {device!r}")
        check(device == f"device cuda:0 ({torch.cuda.get_device_name(0)})",
              f"phase 12: the server's device line {device!r}")
        dims, _ = ask(json.dumps({"op": "mps_dims", "path": MODEL}))
        check(dims == {"ok": True, "result": {"m": 2, "n": 2, "nnz": 4}},
              f"phase 12: mps_dims {dims}")
        mps, wall = ask(json.dumps({"op": "solve_mps", "path": MODEL,
                                    "params": {}}))
        check(mps["ok"] and mps["result"]["status"] == "OPTIMAL"
              and abs(mps["result"]["primal_obj"] + 26.4) < 1e-3,
              f"phase 12: solve_mps {mps}")
        phase(12, f"solve_mps data/model.mps: {mps['result']['status']} "
                  f"iter={mps['result']['iter']} obj="
                  f"{mps['result']['primal_obj']!r} client wall {wall:.3f} s")
        memory["after 2"] = used_memory_mib(proc.pid)

        def same_solve(resp, k):
            check(resp["ok"], f"phase 12: solve {k}: {resp}")
            r = resp["result"]
            x = _dec(r["x"])
            same = (r["status"] == "OPTIMAL" and r["iter"] == ref.iter
                    and r["primal_obj"] == ref.primal_obj
                    and x.tobytes() == np.asarray(ref.x, "<f8").tobytes())
            check(same, f"phase 12: solve {k} of sparse_large is not the "
                  f"in-process solve's: {r['status']} iter {r['iter']} "
                  f"(in process {ref.iter}), objective {r['primal_obj']!r} "
                  f"({ref.primal_obj!r})")
            return r

        resp, wall = ask(solve_text)
        first = same_solve(resp, 1)
        walls.append(wall)
        times.append(first["time"])
        memory["after 3"] = used_memory_mib(proc.pid)
        bresp, bwall = ask(batched_text)
        check(bresp["ok"], f"phase 12: solve_batched {bresp}")
        b = bresp["result"]
        obj = _dec(b["primal_obj"])
        check(b["status"] == list(bref.status)
              and np.array_equal(_dec(b["iter"], "<i8"), bref.iter)
              and obj.tobytes() == np.asarray(bref.primal_obj,
                                              "<f8").tobytes(),
              "phase 12: solve_batched differs from the in-process solve")
        phase(12, f"solve_batched batched_lp(2048, 4096, 256, seed=3) "
                  f"{SERVER_BATCHED}: {b['status'].count('OPTIMAL')}/"
                  f"{b['batch']} OPTIMAL, statuses, iterations and "
                  f"objectives equal to in-process; solve {b['time']:.3f} s,"
                  f" client wall {bwall:.3f} s [{card}]")
        memory["after 4"] = used_memory_mib(proc.pid)
        for k in range(2, 6):
            resp, wall = ask(solve_text)
            r = same_solve(resp, k)
            walls.append(wall)
            times.append(r["time"])
            memory[f"after 5.{k - 1}"] = used_memory_mib(proc.pid)
        memory["after 5"] = memory["after 5.4"]
        phase(12, f"sparse_large {SERVER_SOLVE} x5: {first['status']} "
                  f"iter={first['iter']} objective {first['primal_obj']!r}, "
                  f"x bitwise the in-process solve's every time; client "
                  f"wall s {[round(w, 4) for w in walls]} against "
                  f"Results.time s {[round(t, 4) for t in times]} [{card}]")
        bye, _ = ask(json.dumps({"op": "shutdown"}))
        check(bye == {"ok": True}, f"phase 12: shutdown {bye}")
        rc = proc.wait(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    err.seek(0)
    _, launches = worker_lines(err.read())
    err.close()
    (mine2, card2), (mine5, card5) = memory["after 2"], memory["after 5"]
    phase(12, f"worker exit {rc}; its kernel launches {launches}; used "
              f"memory after requests 2 and 5: worker (nvidia-smi) "
              f"{mine2} / {mine5} MiB, whole card {card2:.1f} / "
              f"{card5:.1f} MiB; whole card after each request: "
              + ", ".join(f"{k} {v[1]:.1f}" for k, v in memory.items()))
    check(rc == 0, f"phase 12: the server exited {rc}")
    for name in ("tiled_spmv", "tiled_x_half", "tiled_y_half", "csr_spmm",
                 "spmm_x_half", "spmm_y_half"):
        check(launches and launches[name] > 0,
              f"phase 12: the worker never launched {name}: {launches}")
    check(abs(card5 - card2) <= MEMORY_SLACK_MIB,
          f"phase 12: the card's used memory moved {card5 - card2:.1f} MiB "
          f"between requests 2 and 5")
    if mine2 is not None and mine5 is not None:
        check(abs(mine5 - mine2) <= MEMORY_SLACK_MIB,
              f"phase 12: the worker's memory moved {mine5 - mine2} MiB")
    record = {"startup_s": startup, "client_wall_s": walls,
              "results_time_s": times, "iter": first["iter"],
              "batched_client_wall_s": bwall, "batched_time_s": b["time"],
              "memory_mib": memory, "launches": launches}
    return record, launches, first["iter"]


class CParams(ctypes.Structure):
    """hprlp_parameters (native/include/hprlp_tpu.h)."""
    _fields_ = [("stop_tol", ctypes.c_double),
                ("time_limit", ctypes.c_double),
                ("max_iter", ctypes.c_int64), ("check_iter", ctypes.c_int),
                ("use_CR_scaling", ctypes.c_int),
                ("use_Ruiz_scaling", ctypes.c_int),
                ("use_Pock_Chambolle_scaling", ctypes.c_int),
                ("use_bc_scaling", ctypes.c_int),
                ("use_presolve", ctypes.c_int),
                ("precision", ctypes.c_char * 8)]


class CResults(ctypes.Structure):
    """hprlp_results (native/include/hprlp_tpu.h)."""
    _fields_ = [("status", ctypes.c_char * 16), ("iter", ctypes.c_int64),
                ("time", ctypes.c_double), ("primal_obj", ctypes.c_double),
                ("dual_obj", ctypes.c_double), ("gap", ctypes.c_double),
                ("residuals", ctypes.c_double),
                ("iter4", ctypes.c_int64), ("iter6", ctypes.c_int64),
                ("iter8", ctypes.c_int64), ("time4", ctypes.c_double),
                ("time6", ctypes.c_double), ("time8", ctypes.c_double),
                ("n", ctypes.c_int64), ("m", ctypes.c_int64),
                ("x", ctypes.POINTER(ctypes.c_double)),
                ("y", ctypes.POINTER(ctypes.c_double)),
                ("z", ctypes.POINTER(ctypes.c_double))]


@contextlib.contextmanager
def stderr_to(f):
    """File descriptor 2 pointed at `f` for the block: a worker forked
    inside it writes its stderr there."""
    sys.stderr.flush()
    saved = os.dup(2)
    os.dup2(f.fileno(), 2)
    try:
        yield f
    finally:
        sys.stderr.flush()
        os.dup2(saved, 2)
        os.close(saved)


def ctypes_solve(lib_path, launcher, problem):
    """hprlp_create_model_from_arrays on `problem` and one hprlp_solve in
    f32 at 1e-4 without presolve, then hprlp_shutdown, from this process.
    Returns (status, iterations, objective, client wall seconds, the
    worker's stderr)."""
    dp = ctypes.POINTER(ctypes.c_double)
    L = ctypes.CDLL(lib_path)
    L.hprlp_parameters_default.argtypes = [ctypes.POINTER(CParams)]
    L.hprlp_parameters_default.restype = None
    L.hprlp_create_model_from_arrays.restype = ctypes.c_void_p
    L.hprlp_create_model_from_arrays.argtypes = [
        ctypes.c_int64, ctypes.c_int64, ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int32), dp, dp, dp, dp, dp, dp,
        ctypes.c_double]
    L.hprlp_solve.restype = ctypes.POINTER(CResults)
    L.hprlp_solve.argtypes = [ctypes.c_void_p, ctypes.POINTER(CParams)]
    L.hprlp_free_results.argtypes = [ctypes.POINTER(CResults)]
    L.hprlp_free_results.restype = None
    L.hprlp_free_model.argtypes = [ctypes.c_void_p]
    L.hprlp_free_model.restype = None
    L.hprlp_last_error.restype = ctypes.c_char_p
    L.hprlp_shutdown.restype = None
    A = problem.A.tocsr()
    keep = [np.ascontiguousarray(A.indptr, np.int64),
            np.ascontiguousarray(A.indices, np.int32)] + [
        np.ascontiguousarray(v, np.float64) for v in (
            A.data, problem.AL, problem.AU, problem.l, problem.u, problem.c)]
    ptrs = [keep[0].ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            keep[1].ctypes.data_as(ctypes.POINTER(ctypes.c_int32))] + [
        k.ctypes.data_as(dp) for k in keep[2:]]
    p = CParams()
    L.hprlp_parameters_default(ctypes.byref(p))
    p.stop_tol, p.use_presolve, p.precision = 1e-4, 0, b"f32"
    saved = {k: os.environ.get(k) for k in ("HPRLP_TPU_PYTHON",
                                            "HPRLP_TPU_ROOT")}
    os.environ.update(HPRLP_TPU_PYTHON=launcher, HPRLP_TPU_ROOT=HERE)
    err = tempfile.TemporaryFile(mode="w+")
    try:
        with stderr_to(err):
            model = L.hprlp_create_model_from_arrays(
                problem.m, problem.n, ptrs[0], ptrs[1], *ptrs[2:],
                problem.obj_constant)
            t = time.perf_counter()
            res = L.hprlp_solve(model, ctypes.byref(p))
            wall = time.perf_counter() - t
            error = L.hprlp_last_error()
            out = ((res.contents.status.decode(), res.contents.iter,
                    res.contents.primal_obj) if res else (None, None, None))
            if res:
                L.hprlp_free_results(res)
            L.hprlp_free_model(model)
            L.hprlp_shutdown()
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    err.seek(0)
    text = err.read()
    err.close()
    check(out[0] is not None, f"phase 12: hprlp_solve failed: {error}")
    return (*out, wall, text)


def capi_phase(card, prob4, iters_a):
    """Phase 12 (b): the port's C ABI library and launcher, the C examples
    and a ctypes consumer, each worker on the card.  Returns (record,
    {source: the worker's launches})."""
    from hprlp_tpu_torch import capi

    t0 = time.perf_counter()
    lib = capi.build()
    launcher = capi.write_launcher()
    phase(12, f"built {os.path.relpath(lib, HERE)} (g++) and the launcher "
              f"{os.path.relpath(launcher, HERE)} in "
              f"{time.perf_counter() - t0:.2f} s")
    libdir = os.path.dirname(lib)
    env = dict(os.environ, HPRLP_TPU_PYTHON=launcher, HPRLP_TPU_ROOT=HERE)
    env["LD_LIBRARY_PATH"] = os.pathsep.join(
        [libdir] + ([env["LD_LIBRARY_PATH"]] if env.get("LD_LIBRARY_PATH")
                    else []))
    want = f"device cuda:0 ({torch.cuda.get_device_name(0)})"
    cc = shutil.which("gcc") or shutil.which("cc")
    check(cc, "phase 12: no C compiler")
    record, launches = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        for name, args in EXAMPLES:
            exe = os.path.join(tmp, name[:-2])
            subprocess.run([cc, os.path.join(HERE, "examples", "c", name),
                            "-I" + os.path.join(HERE, "native", "include"),
                            "-L" + libdir, "-lhprlp_tpu", "-o", exe],
                           check=True)
            t = time.perf_counter()
            r = subprocess.run([exe, *args], env=env, capture_output=True,
                               text=True, timeout=600)
            wall = time.perf_counter() - t
            device, counts = worker_lines(r.stderr)
            summary = " | ".join(x for x in r.stdout.splitlines()
                                 if "status" in x or "iter" in x)
            phase(12, f"examples/c/{name}: rc={r.returncode} {summary} "
                      f"wall {wall:.2f} s; worker {device!r}, launches "
                      f"{counts}")
            check(r.returncode == 0 and "OPTIMAL" in r.stdout,
                  f"phase 12: {name}: rc {r.returncode}\n{r.stdout}\n"
                  f"{r.stderr[-2000:]}")
            check(device == want, f"phase 12: {name}: worker device line "
                  f"{device!r}")
            check(counts and counts["tiled_spmv"] + counts["csr_spmm"] > 0,
                  f"phase 12: {name}: the worker launched no kernel")
            record[name] = {"rc": r.returncode, "wall_s": wall,
                            "launches": counts}
            launches[name] = counts
    status, iters, obj, wall, text = ctypes_solve(lib, launcher, prob4)
    device, counts = worker_lines(text)
    phase(12, f"ctypes hprlp_solve of sparse_large (f32, 1e-4, presolve "
              f"off): {status} iter={iters} (server {iters_a}) obj={obj!r} "
              f"client wall {wall:.3f} s; worker {device!r}, launches "
              f"{counts} [{card}]")
    check(status == "OPTIMAL" and iters == iters_a,
          f"phase 12: the ctypes solve: {status} in {iters} iterations, "
          f"the server's {iters_a}")
    check(device == want and counts
          and counts["tiled_spmv"] + counts["csr_spmv"] > 0,
          f"phase 12: the ctypes worker: {device!r} {counts}")
    record["ctypes"] = {"status": status, "iter": iters, "wall_s": wall,
                        "launches": counts}
    launches["ctypes"] = counts
    return record, launches


REFINE_LINE = re.compile(r"\[refine\] stage (\d+): zoom=(\S+) "
                         r"stage_iter=(\d+) kkt=(\S+)")


def refined_solve(card, name, problem, **kw):
    """One Model.solve with precision="mixed", every stage and tail solve
    recorded (precision, iterations, clocks, backend, SpMV launches) and
    the stage lines of HPRLP_REFINE_LOG read.  Returns (result, host-f64
    KKT, wall seconds, the solve_problem calls, the stage lines)."""
    import io

    import hprlp_tpu_torch as hp
    from hprlp_tpu_torch.ops.spmm import csr_spmm
    from hprlp_tpu_torch.solver import loop as loop_mod

    inner = loop_mod.solve_problem
    calls = []

    def recording(prob, params, *args, **kwargs):
        before = (spmv_launches(), csr_spmm.launches)
        t = time.perf_counter()
        res = inner(prob, params, *args, **kwargs)
        calls.append({
            "precision": params.precision, "stop_tol": params.stop_tol,
            "warm": kwargs.get("x0") is not None, "status": res.status,
            "iter": res.iter, "time_s": res.time,
            "wall_s": time.perf_counter() - t,
            # The solve sets capture_time on whatever its module calls
            # solve_problem: this wrapper, while it is installed.
            "capture_s": recording.capture_time,
            "backend": res.spmv_backend,
            "launches": {k: v - before[0][k]
                         for k, v in spmv_launches().items()},
            "csr_spmm": csr_spmm.launches - before[1]})
        return res

    log = io.StringIO()
    saved = os.environ.get("HPRLP_REFINE_LOG")
    os.environ["HPRLP_REFINE_LOG"] = "1"
    loop_mod.solve_problem = recording
    try:
        with contextlib.redirect_stderr(log):
            t = time.perf_counter()
            res = hp.Model(problem).solve(hp.Parameters(
                precision="mixed", verbose=False, max_iter=500_000, **kw))
            wall = time.perf_counter() - t
    finally:
        loop_mod.solve_problem = inner
        if saved is None:
            os.environ.pop("HPRLP_REFINE_LOG")
        else:
            os.environ["HPRLP_REFINE_LOG"] = saved
    stages = [{"stage": int(m[1]), "zoom": float(m[2]), "iter": int(m[3]),
               "kkt": float(m[4])} for m in REFINE_LINE.finditer(
                   log.getvalue())]
    kkt = problem.kkt_error(res.x, res.y, res.z)["kkt"]
    stage_calls = [c for c in calls if c["precision"] != "f64"
                   or kw.get("refine_stage_precision") == "f64"]
    tail = calls[len(stage_calls):]
    for st, c in zip(stages, stage_calls):
        phase(13, f"{name} stage {st['stage']}: {c['precision']} zoom="
                  f"{st['zoom']:.1e} iter={c['iter']} kkt_f64={st['kkt']:.3e}"
                  f" status={c['status']} backend={c['backend']} "
                  f"launches={c['launches']} solve={c['time_s']:.3f}s "
                  f"capture={c['capture_s']:.3f}s wall={c['wall_s']:.3f}s")
    for k, c in enumerate(tail):
        phase(13, f"{name} f64 tail attempt {k + 1} "
                  f"({'warm' if c['warm'] else 'cold'}): iter={c['iter']} "
                  f"status={c['status']} backend={c['backend']} "
                  f"launches={c['launches']} solve={c['time_s']:.3f}s "
                  f"capture={c['capture_s']:.3f}s wall={c['wall_s']:.3f}s")
    phase(13, f"{name} mixed {kw}: status={res.status} iter={res.iter} "
              f"stages={len(stage_calls)} tail attempts={len(tail)} "
              f"Results.time={res.time:.3f}s wall={wall:.3f}s "
              f"primal_obj={res.primal_obj:.12e} kkt_f64={kkt:.3e} [{card}]")
    check(len(stages) == len(stage_calls),
          f"phase 13: {name}: {len(stages)} stage lines for "
          f"{len(stage_calls)} stage solves")
    for c in calls:
        check_backend(13, c["backend"], c["launches"])
    return res, kkt, wall, calls, stages


def mixed_phase(card, prob4):
    """Phase 13: precision="mixed" on assignment64 and assignment128 at
    1e-8 against linear_sum_assignment, each beside the direct f64 solve;
    f64 stages once on assignment64; sparse_large at 1e-6.  Returns
    (record, {"f32": {backend: launches}, "f64": {...}, "csr_spmm": n})."""
    import hprlp_tpu_torch as hp
    from scipy.optimize import linear_sum_assignment

    record = {}
    launches = {"f32": dict.fromkeys(SPMV_COUNTERS, 0),
                "f64": dict.fromkeys(SPMV_COUNTERS, 0), "csr_spmm": 0}

    def tally(calls):
        for c in calls:
            for k, v in c["launches"].items():
                launches[c["precision"]][k] += v
            launches["csr_spmm"] += c["csr_spmm"]

    runs = [("assignment64", 64, {}), ("assignment128", 128, {}),
            ("assignment64", 64, {"refine_stage_precision": "f64"})]
    for name, size, extra in runs:
        problem = assignment_problem(size)
        res, kkt, wall, calls, stages = refined_solve(
            card, name, problem, stop_tol=1e-8, time_limit=300.0, **extra)
        tally(calls)
        side = int(np.sqrt(problem.n))
        cost = problem.c.reshape(side, side)
        r, c = linear_sum_assignment(cost)
        exact = float(cost[r, c].sum())
        rel = abs(res.primal_obj - exact) / abs(exact)
        t = time.perf_counter()
        direct = hp.Model(problem).solve(hp.Parameters(
            stop_tol=1e-8, precision="f64", verbose=False, max_iter=500_000,
            time_limit=300.0))
        dwall = time.perf_counter() - t
        phase(13, f"{name}: linear_sum_assignment={exact:.10e} rel_err="
                  f"{rel:.3e}; direct f64 solve: {direct.status} iter="
                  f"{direct.iter} Results.time={direct.time:.3f}s wall="
                  f"{dwall:.3f}s [{card}]")
        check(res.status == "OPTIMAL", f"phase 13: {name} {extra}: status "
              f"{res.status}")
        check(kkt < 1e-8, f"phase 13: {name} {extra}: host f64 KKT {kkt}")
        check(rel < 1e-6, f"phase 13: {name} {extra}: objective off by "
              f"{rel}")
        key = name + ("_f64_stages" if extra else "")
        record[key] = {"status": res.status, "iter": res.iter,
                       "time_s": res.time, "wall_s": wall, "kkt_f64": kkt,
                       "rel_err": rel, "stages": stages, "calls": calls,
                       "direct_f64": {"iter": direct.iter,
                                      "time_s": direct.time,
                                      "wall_s": dwall}}
    res, kkt, wall, calls, stages = refined_solve(
        card, "sparse_large", prob4, stop_tol=1e-6, time_limit=300.0)
    tally(calls)
    check(res.status == "OPTIMAL", f"phase 13: sparse_large: status "
          f"{res.status}")
    check(kkt < 1e-6, f"phase 13: sparse_large: host f64 KKT {kkt}")
    record["sparse_large_1e-6"] = {
        "status": res.status, "iter": res.iter, "time_s": res.time,
        "wall_s": wall, "kkt_f64": kkt, "stages": stages, "calls": calls}
    phase(13, f"SpMV launches by stage precision: {launches}")
    for tag in ("f32", "f64"):
        check(launches[tag]["tiled"] + launches[tag]["gather"] > 0,
              f"phase 13: no {tag} SpMV launched")
    return record, launches


# Phase 0's in-process solves, and how far the card's memory may move
# after the second of them.
MEMORY_SOLVES = 8
MEMORY_FLAT_MIB = 32
FAULT_SOLVES = 4


def card_used_mib():
    """The card's used memory in MiB, as nvidia-smi reports it."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=memory.used",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, check=True).stdout
    return float(out.split()[0])


def memory_check(card, problem):
    """Phase 0: MEMORY_SOLVES in-process solves of `problem` (f32, 1e-4;
    each with the autotune's probes and its chunk boundary captured in a
    CUDA graph) and no call of server.release_device_memory: from the
    second solve on, torch.cuda.memory_reserved() and nvidia-smi's used
    memory stay within MEMORY_FLAT_MIB (one warm-up stream and one graph
    pool per device, solver/graph.py).  Returns the record."""
    import hprlp_tpu_torch as hp

    params = hp.Parameters(stop_tol=1e-4, verbose=False, max_iter=100_000)
    reserved, used, iters = [], [], []
    for _ in range(MEMORY_SOLVES):
        res = hp.solve(problem.A, problem.AL, problem.AU, problem.l,
                       problem.u, problem.c, params)
        check(res.status == "OPTIMAL", f"phase 0: status {res.status}")
        torch.cuda.synchronize()
        reserved.append(torch.cuda.memory_reserved() / 2**20)
        used.append(card_used_mib())
        iters.append(res.iter)
    spread = {"reserved": max(reserved[1:]) - min(reserved[1:]),
              "used": max(used[1:]) - min(used[1:])}
    phase(0, f"{MEMORY_SOLVES} in-process solves of {problem.name} (f32, "
             f"autotune and graph each, no release_device_memory): "
             f"iterations {iters}; torch.cuda.memory_reserved() MiB "
             f"{[round(v, 1) for v in reserved]}; nvidia-smi used MiB "
             f"{used}; spread after solve 2: reserved "
             f"{spread['reserved']:.1f} MiB, used {spread['used']:.1f} MiB "
             f"(<= {MEMORY_FLAT_MIB}) [{card}]")
    for what, mib in spread.items():
        check(mib <= MEMORY_FLAT_MIB, f"phase 0: {what} memory moved "
              f"{mib:.1f} MiB over solves 2..{MEMORY_SOLVES}")
    # The fault, for the record: the same solves with a new side stream
    # and a private graph pool per capture, as before the repair.
    from hprlp_tpu_torch.solver import graph

    fault = []
    with swapped(graph, warmup_stream=lambda device=None: torch.cuda.Stream(),
                 graph_pool=lambda device=None: None):
        for _ in range(FAULT_SOLVES):
            hp.solve(problem.A, problem.AL, problem.AU, problem.l,
                     problem.u, problem.c, params)
            torch.cuda.synchronize()
            fault.append((torch.cuda.memory_reserved() / 2**20,
                          card_used_mib()))
    phase(0, f"for comparison, {FAULT_SOLVES} more solves with a new side "
             f"stream and a private graph pool per capture (the previous "
             f"capture): reserved MiB {[round(r, 1) for r, _ in fault]}, "
             f"used MiB {[u for _, u in fault]} [{card}]")
    return {"reserved_mib": reserved, "used_mib": used, "iter": iters,
            "spread_mib": spread, "previous_capture_mib": fault}


# Phase 14's giant LP: benchmarks/run.py's banded giant (:488-491), ~113M
# nnz, through Model.solve with presolve on.
GIANT_ARGS = (1572864, 3145728, 72, 16384, 5)
GIB = 2**30


@contextlib.contextmanager
def ingest_memory(mem):
    """Record into `mem`, when the power method starts (the ingest and
    the autotune done): "ingest_peak" (max_memory_allocated since the
    caller's reset) and "resident" (memory_allocated); then reset the
    peak, so that max_memory_allocated after the solve is the solve's."""
    from hprlp_tpu_torch.solver import loop

    power = loop.power_method

    def at_power(lp, *args, **kw):
        torch.cuda.synchronize()
        mem["ingest_peak"] = torch.cuda.max_memory_allocated()
        mem["resident"] = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        return power(lp, *args, **kw)

    with swapped(loop, power_method=at_power):
        yield mem


def host_peak_rss_gib():
    import resource

    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024 / GIB


def giant_phase(card, prob6):
    """Phase 14: (a) sparse_huge f32 on the giant route (the module constant
    lowered for the call) and on the standard route, bitwise equal; (b) the
    banded giant through Model.solve with presolve on, presolve beside the
    ingest; (c) the tiled SpMV at the giant's A and A^T by graph replay
    against its plain version, its bound and cuSPARSE.  Returns (the SpMV
    launches of (a) and (b) by SPMV_COUNTERS' keys, csr_spmm launches there
    (the scaling's row sums), {"giant_A", "giant_AT": shape record},
    record)."""
    import hprlp_tpu_torch as hp
    from hprlp_tpu_torch import presolve
    from hprlp_tpu_torch.model import REINGEST_SHARE
    from hprlp_tpu_torch.ops.spmm import csr_spmm
    from hprlp_tpu_torch.ops.spmv import tiled_spmv
    from hprlp_tpu_torch.ops.tiles import tiled_spmv_reference
    from hprlp_tpu_torch.prof import prof_loop
    from hprlp_tpu_torch.prof.problems import banded_lp
    from hprlp_tpu_torch.solver import loop

    # (a) sparse_huge on both routes, on the tiles ("lane": no probe).
    params = hp.Parameters(stop_tol=1e-4, verbose=False, max_iter=50_000,
                           spmv_backend="lane")
    routes, launches, row_sums = {}, dict.fromkeys(SPMV_COUNTERS, 0), 0
    for route, threshold in (("standard", 10**18), ("giant", 1)):
        mem = {}
        reset_spmv_launches()
        csr_spmm.launches = 0
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        with swapped(loop, GIANT_LANE_FIRST_NNZ=threshold), \
                ingest_memory(mem):
            res = loop.solve_problem(prob6, params)
        l = spmv_launches()
        check_backend(14, "tiled", l)
        check(csr_spmm.launches > 0, f"phase 14: sparse_huge {route}: the "
              f"scaling's row sums never ran on the SpMM kernel")
        for k, v in l.items():
            launches[k] += v
        row_sums += csr_spmm.launches
        routes[route] = res
        rec = {"setup_s": res.setup_time, "scaling_s": res.scaling_time,
               "ingest_peak_gib": (mem["ingest_peak"] - base) / GIB,
               "resident_gib": (mem["resident"] - base) / GIB,
               "solve_peak_gib": (torch.cuda.max_memory_allocated() - base)
               / GIB, "iter": res.iter, "tiled_launches": l["tiled"]}
        routes[route + "_record"] = rec
        phase(14, f"(a) sparse_huge f32 {route} route: status={res.status} "
                  f"iter={res.iter} setup={res.setup_time:.3f}s scaling="
                  f"{res.scaling_time:.3f}s solve={res.time:.3f}s; device "
                  f"memory above the {base / GIB:.3f} GiB before it: peak "
                  f"to the power method {rec['ingest_peak_gib']:.3f} GiB "
                  f"({mem['ingest_peak'] - base:.0f} B, "
                  f"{(mem['ingest_peak'] - base) / prob6.nnz:.1f} B/nnz), "
                  f"allocated after the ingest {rec['resident_gib']:.3f} "
                  f"GiB, peak in the solve {rec['solve_peak_gib']:.3f} GiB "
                  f"[{card}]")
        check(res.status == "OPTIMAL", f"phase 14: sparse_huge {route} "
              f"status {res.status}")
    rs, rg = routes["standard"], routes["giant"]
    same = (rs.iter == rg.iter and rs.primal_obj == rg.primal_obj
            and all(np.array_equal(getattr(rs, k), getattr(rg, k))
                    for k in ("x", "y", "z")))
    phase(14, f"(a) giant route bitwise the standard route: {same} "
              f"(iterations {rg.iter} / {rs.iter}, objectives "
              f"{float(rg.primal_obj)!r} / {float(rs.primal_obj)!r}) "
              f"[{card}]")
    check(same, "phase 14: sparse_huge's giant route differs from its "
          "standard route")

    # (b) the banded giant, generated once.
    rss0 = host_peak_rss_gib()
    t0 = time.perf_counter()
    problem = banded_lp(*GIANT_ARGS)
    gen_s = time.perf_counter() - t0
    phase(14, f"(b) banded_lp{GIANT_ARGS}: m={problem.m} n={problem.n} "
              f"nnz={problem.nnz}, generated in {gen_s:.2f} s on the host")
    calls, mem = [], {}
    reset_spmv_launches()
    csr_spmm.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    with recorded(calls, [(loop, "build_ingest"),
                          (presolve, "presolve_problem")]), \
            ingest_memory(mem), PeakRss() as sampled:
        t0 = time.perf_counter()
        res = hp.Model(problem).solve(hp.Parameters(stop_tol=1e-4,
                                                    verbose=False))
        wall = time.perf_counter() - t0
    solve_peak = torch.cuda.max_memory_allocated() - base
    l = spmv_launches()
    for k, v in l.items():
        launches[k] += v
    giant_sums = csr_spmm.launches
    row_sums += giant_sums
    capture_s = loop.solve_problem.capture_time
    rss = host_peak_rss_gib()
    ingests = [(secs, out) for name, secs, out in calls
               if name == "build_ingest"]
    (pre_status, reduced, _), = [out for name, _, out in calls
                                 if name == "presolve_problem"]
    # Where presolve removes at most REINGEST_SHARE of nnz, Model.solve
    # solves the original on the ingest built beside presolve, so the
    # solve builds none of its own: one ingest.  Else two.
    reuse_due = reduced is not None and (
        problem.nnz - reduced.nnz <= REINGEST_SHARE * problem.nnz)
    reused = len(ingests) == 1
    ingest_s, (_, _, _, stages) = ingests[0]
    lp = ingests[-1][1][0]  # the solve's
    t0 = time.perf_counter()
    kkt = problem.kkt_error(res.x, res.y, res.z)["kkt"]
    kkt_s = time.perf_counter() - t0
    serial = (res.presolve_time + ingest_s + res.power_time + capture_s
              + res.time)
    record = {
        "m": problem.m, "n": problem.n, "nnz": problem.nnz,
        "generate_s": gen_s, "presolve_status": pre_status,
        "reduced_nnz": None if reduced is None else reduced.nnz,
        "ingest_reused": reused, "presolve_s": res.presolve_time,
        "ingest_s": ingest_s, "ingest_stages_s": stages,
        "setup_s": res.setup_time, "scaling_s": res.scaling_time,
        "power_s": res.power_time, "capture_s": capture_s,
        "solve_s": res.time, "iter": res.iter, "model_solve_wall_s": wall,
        "serial_sum_s": serial, "kkt_f64": kkt, "kkt_s": kkt_s,
        "ingest_peak_gib": (mem["ingest_peak"] - base) / GIB,
        "ingest_peak_b_per_nnz": (mem["ingest_peak"] - base) / problem.nnz,
        "resident_gib": (mem["resident"] - base) / GIB,
        "solve_peak_gib": solve_peak / GIB, "host_peak_rss_gib": rss,
        "host_peak_rss_before_gib": rss0,
        "solve_rss_start_gib": sampled.start_bytes / GIB,
        "solve_rss_peak_gib": sampled.peak_bytes / GIB,
        "tiled_launches": l["tiled"],
        "csr_launches": l["gather"], "status": res.status,
        "primal_obj": res.primal_obj,
        "s_per_it": res.time / max(res.iter, 1)}
    phase(14, f"(b) Model.solve: status={res.status} iter={res.iter} "
              f"presolve {pre_status} -> "
              f"{record['reduced_nnz']} nnz, ingest reused: {reused}; "
              f"presolve={res.presolve_time:.3f}s ingest={ingest_s:.3f}s "
              f"(" + ", ".join(f"{k} {v:.3f}" for k, v in stages.items())
              + f") setup={res.setup_time:.3f}s scaling="
              f"{res.scaling_time:.3f}s power={res.power_time:.3f}s "
              f"capture={capture_s:.3f}s solve={res.time:.3f}s "
              f"({record['s_per_it'] * 1e3:.3f} ms/it; before the tiles' "
              f"fused halves {GIANT_MS_PER_IT_BEFORE}); Model.solve wall "
              f"{wall:.3f}s against presolve + ingest "
              f"{res.presolve_time + ingest_s:.3f}s and all stages in a "
              f"row {serial:.3f}s [{card}]")
    phase(14, f"(b) device memory above the {base / GIB:.3f} GiB before "
              f"it: peak to the power method {record['ingest_peak_gib']:.3f}"
              f" GiB ({record['ingest_peak_b_per_nnz']:.1f} B/nnz), "
              f"allocated after the ingest {record['resident_gib']:.3f} "
              f"GiB, peak in the solve {record['solve_peak_gib']:.3f} GiB; "
              f"host peak RSS {rss:.2f} GiB ({rss0:.2f} before (b); "
              f"through Model.solve, sampled: "
              f"{record['solve_rss_start_gib']:.2f} at its start, peak "
              f"{record['solve_rss_peak_gib']:.2f}); "
              f"launches {l}; host f64 KKT {kkt:.3e} ({kkt_s:.1f} s) "
              f"[{card}]")
    check(res.status == "OPTIMAL", f"phase 14: the giant's status "
          f"{res.status}")
    check(kkt < 1e-3, f"phase 14: the giant's host f64 KKT {kkt}")
    check_backend(14, "tiled", l)
    check(giant_sums > 0, "phase 14: the giant's scaling never ran its row "
          "sums on the SpMM kernel")
    check(pre_status == "OK" and len(ingests) == (1 if reuse_due else 2),
          f"phase 14: presolve {pre_status} to {record['reduced_nnz']} "
          f"nnz, {len(ingests)} ingests")
    check(wall < res.presolve_time + ingest_s, f"phase 14: Model.solve "
          f"took {wall} s, no less than presolve + ingest "
          f"({res.presolve_time + ingest_s} s): no overlap")

    # The solve's chunk on the solve's tiles, as it replays it.
    prof = prof_loop.profile(prof_loop.ChunkReplay(lp, ingests[-1][1][2]),
                             prof_loop.SPMV_KERNELS, chunks=2)
    record["chunk_profile"] = {k: prof[k] for k in (
        "its", "wall_us", "device_us", "busy", "kernels", "product_us",
        "product_share")}
    phase(14, f"(b) the giant's chunk (prof_loop over replays of one "
              f"captured chunk on the solve's tiles, groups A "
              f"{lp.A.tiles.n_groups} / A^T {lp.AT.tiles.n_groups}): "
              f"{prof['its']:.1f} it/s unprofiled, device "
              f"{prof['device_us']:.1f} us/it, {prof['kernels']:.1f} "
              f"kernels/it, busy share {prof['busy']:.3f}, SpMV "
              f"{prof['product_us']:.1f} us/it ({prof['product_share']:.1%})"
              f"; before the tiles' fused halves ~34 kernels/it and "
              f"{GIANT_MS_PER_IT_BEFORE} ms/it [{card}]")

    # (c) the tiled SpMV at the giant's shapes, on the solve's tiles.
    rng = np.random.default_rng(0)
    shapes = {}
    for mat_name, M in (("A", lp.A), ("AT", lp.AT)):
        T = M.tiles
        x = torch.as_tensor(rng.normal(size=M.ncols), dtype=M.dtype,
                            device=M.device)
        y = tiled_spmv(T, x)
        y_ref = tiled_spmv_reference(T, x)
        torch.cuda.synchronize()
        scale = float(y_ref.abs().max())
        err = float((y - y_ref).abs().max())
        check(err <= 1e-5 * scale, f"phase 14: giant {mat_name} tiled max "
              f"abs err {err} > 1e-5 * {scale}")
        order, row, col = T.coo
        keep = row < T.nrows
        S = torch.sparse_coo_tensor(
            torch.stack([row[keep], col[keep]]), T.vals[order][keep],
            (T.nrows, T.ncols), check_invariants=False
        ).coalesce().to_sparse_csr()
        del order, row, col, keep
        bound_ms, bound_by = spmv_bound(M, M.dtype)
        rec = {"nnz": M.nnz, "err": err, "scale": scale,
               "ms": time_ms(lambda: tiled_spmv(T, x)),
               "plain_ms": time_ms(lambda: tiled_spmv_reference(T, x),
                                   reps=10),
               "library_ms": time_ms(lambda: torch.mv(S, x)),
               "bound_ms": bound_ms, "bound_by": bound_by,
               "strips": T.n_strips, "groups": T.n_groups,
               "chunks": T.n_chunks, "tile_bytes": T.vals.nbytes
               + T.keys.nbytes + T.runs.nbytes + T.row_start.nbytes}
        shapes["giant_" + mat_name] = rec
        del S
        T.__dict__.pop("coo", None)
        phase(14, f"(c) giant {mat_name} ({M.nnz} nnz, tiles "
                  f"{rec['tile_bytes'] / GIB:.3f} GiB: {T.n_strips} strips "
                  f"in {T.n_groups} groups x {T.n_chunks} chunks): tiled "
                  f"{rec['ms']:.5f} ms ({bound_ms / rec['ms']:.1%} of bound "
                  f"{bound_ms:.5f} ms, {bound_by}), plain "
                  f"{rec['plain_ms']:.5f}, cuSPARSE {rec['library_ms']:.5f}"
                  f"; max_abs_err={err:.3e} (<= 1e-5*{scale:.3e}) [{card}]")
    record["a"] = {k: v for k, v in routes.items() if k.endswith("record")}
    return launches, row_sums, shapes, record, problem


# Phase 14 (d): the banded giant through Model.solve in a fresh process
# with HPRLP_MALLOC_TUNE=1, which tunes the allocator at import
# (hprlp_tpu_torch/_malloc.py); its giant ingest then preheats.
TUNED_GIANT = r"""
import json, sys, time
import hprlp_tpu_torch as hp
from hprlp_tpu_torch import _malloc
from hprlp_tpu_torch.prof.problems import banded_lp
from hprlp_tpu_torch.prof.timing import PeakRss
t0 = time.perf_counter()
with PeakRss() as gen_rss:
    problem = banded_lp(*json.loads(sys.argv[1]))
gen_s = time.perf_counter() - t0
t0 = time.perf_counter()
with PeakRss() as solve_rss:
    res = hp.Model(problem).solve(hp.Parameters(stop_tol=1e-4,
                                                verbose=False))
wall = time.perf_counter() - t0
print(json.dumps({
    "report": _malloc._done, "preheated_bytes": _malloc._preheated,
    "generate_s": gen_s, "presolve_s": res.presolve_time,
    "model_solve_wall_s": wall, "setup_s": res.setup_time,
    "scaling_s": res.scaling_time, "status": res.status, "iter": res.iter,
    "primal_obj": res.primal_obj,
    "generate_rss_peak_gib": gen_rss.peak_bytes / 2**30,
    "solve_rss_start_gib": solve_rss.start_bytes / 2**30,
    "solve_rss_peak_gib": solve_rss.peak_bytes / 2**30}))
"""


def malloc_phase(card, untuned):
    """Phase 14 (d): TUNED_GIANT in a subprocess, beside (b)'s untuned
    record: tune_malloc's report, the bytes preheated, presolve and
    Model.solve's wall, host peak RSS; the same objective bits."""
    env = dict(os.environ, HPRLP_MALLOC_TUNE="1")
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-c", TUNED_GIANT,
                           json.dumps(GIANT_ARGS)], cwd=HERE, env=env,
                          capture_output=True, text=True, timeout=900)
    wall = time.perf_counter() - t0
    check(proc.returncode == 0, f"phase 14 (d): the tuned giant exited "
          f"{proc.returncode}: {proc.stderr[-3000:]}")
    rec = json.loads(proc.stdout.strip().splitlines()[-1])
    rec["process_wall_s"] = wall
    thp = [ln for ln in proc.stderr.splitlines()
           if "transparent_hugepage" in ln]
    rec["thp_line"] = thp[0] if thp else None

    def rise(r):
        return r["solve_rss_peak_gib"] - r["solve_rss_start_gib"]

    phase(14, f"(d) HPRLP_MALLOC_TUNE=1, a fresh process: tune_malloc "
              f"{rec['report']} ({rec['thp_line']}), preheated "
              f"{rec['preheated_bytes'] / GIB:.2f} GiB; generated in "
              f"{rec['generate_s']:.2f} s; presolve {rec['presolve_s']:.3f}"
              f" s (untuned (b): {untuned['presolve_s']:.3f}), Model.solve "
              f"wall {rec['model_solve_wall_s']:.3f} s (untuned "
              f"{untuned['model_solve_wall_s']:.3f}), setup "
              f"{rec['setup_s']:.3f} s (untuned {untuned['setup_s']:.3f}); "
              f"host RSS through Model.solve, sampled: "
              f"{rec['solve_rss_start_gib']:.2f} GiB at its start, peak "
              f"{rec['solve_rss_peak_gib']:.2f} (+{rise(rec):.2f}; untuned "
              f"(b): +{rise(untuned):.2f}, "
              f"{untuned['solve_rss_start_gib']:.2f} to "
              f"{untuned['solve_rss_peak_gib']:.2f}), generation's peak "
              f"{rec['generate_rss_peak_gib']:.2f}; status={rec['status']} "
              f"iter={rec['iter']}, the objective bitwise (b)'s: "
              f"{rec['primal_obj'] == untuned['primal_obj']} [{card}]")
    check(rec["status"] == "OPTIMAL" and rec["report"].get("mallopt"),
          f"phase 14 (d): {rec}")
    check(rec["primal_obj"] == untuned["primal_obj"], f"phase 14 (d): the "
          f"tuned objective {rec['primal_obj']!r} is not (b)'s "
          f"{untuned['primal_obj']!r}")
    return rec


CHUNK_FIELDS = ("x", "y", "last_x", "last_y", "x_bar", "y_bar", "z_bar",
                "y_obj", "inner")


def chunk_differ(a, b):
    """The state fields and metrics in which two run_chunk results differ
    (not bitwise equal)."""
    (st_a, m_a), (st_b, m_b) = a, b
    return ([f for f in CHUNK_FIELDS
             if not torch.equal(getattr(st_a, f), getattr(st_b, f))]
            + [k for k in m_a if not torch.equal(m_a[k], m_b[k])])


def fused_spmv_phase(card, problem):
    """Phase 10 (b): the single-LP middle iteration fused into the CSR
    kernel, at `problem` (sparse_large) on the gather backend, f32 and
    f64: one 150-iteration run_chunk through the fused halves, one through
    the plain halves (the kernel's store, then the plain ops) and the fused
    chunk's CUDA-graph replay, every state tensor and metric bitwise
    equal.  Then at sparse_large f32 and f64 and assignment_problem(128)
    f32 (whose "mixed" solves take "gather" in phase 13) each half alone
    bitwise its plain version (0 differing entries) and timed by graph
    replay, fused and plain, beside its byte bound.  Returns {cell:
    record}: "f32" and "f64" sparse_large's, "assignment128_f32"."""
    from hprlp_tpu_torch.ops.spmv import spmv_x_half, spmv_y_half
    from hprlp_tpu_torch.prof import prof_loop
    from hprlp_tpu_torch.prof.timing import half_bound
    from hprlp_tpu_torch.solver import chunk
    from hprlp_tpu_torch.solver.graph import CapturedStep

    differ = chunk_differ
    records = {}
    for cell, prob, dtype, tag in (
            ("f32", problem, torch.float32, "f32"),
            ("f64", problem, torch.float64, "f64"),
            ("assignment128_f32", assignment_problem(128), torch.float32,
             "f32")):
        loop = prof_loop.Loop(prob, dtype, graph=False, backend="gather")
        loop.run(1)
        lp, st, sigma = loop.lp, loop.state, loop.sigma
        rec = {}
        if cell in ("f32", "f64"):
            args = (lp, loop.scal, st, sigma, loop.lam,
                    torch.tensor(False, device="cuda"), loop.check)
            spmv_x_half.launches = spmv_y_half.launches = 0
            fused = chunk.run_chunk(*args)
            fused_launches = (spmv_x_half.launches, spmv_y_half.launches)
            with swapped(chunk, x_half=chunk.x_half_plain,
                         y_half=chunk.y_half_plain):
                plain = chunk.run_chunk(*args)
            step = CapturedStep(lambda: chunk.run_chunk(*args), counts={})
            step.replay()
            torch.cuda.synchronize()
            vs_plain, vs_graph = differ(fused, plain), differ(fused, step.out)
            max_diff = max(float((getattr(fused[0], k)
                                  - getattr(plain[0], k)).abs().max())
                           for k in ("x", "y"))
            rec = {"fused_launches": fused_launches,
                   "differ_plain": vs_plain, "differ_graph": vs_graph,
                   "max_abs_err": max_diff}
            phase(10, f"fused chunk {tag} (sparse_large, gather): "
                      f"{loop.check} iterations, fused launches x/y "
                      f"{fused_launches}; fields differing from the plain "
                      f"halves: {vs_plain or 'none'}; from the graph's "
                      f"replay: {vs_graph or 'none'} [{card}]")
            middle = loop.check - 2
            del fused, plain, step
            check(fused_launches == (middle, middle), f"phase 10: the fused "
                  f"chunk launched the halves {fused_launches} times, not "
                  f"{middle} each")
            check(not vs_plain, f"phase 10: fused and plain chunks differ "
                  f"({tag}) in {vs_plain}")
            check(not vs_graph, f"phase 10: the fused chunk's replay differs "
                  f"from its eager run ({tag}) in {vs_graph}")

        lam_sigma = loop.lam * sigma

        def h():  # the first middle iteration's counter, factors unmade
            return chunk.Halpern(st.inner, 0, dtype)

        x_hat = chunk.x_half_plain(lp, st.x, st.y, st.last_x, sigma, h())[1]
        halves = {
            "x": (lambda: chunk.x_half(lp, st.x, st.y, st.last_x, sigma,
                                       h()),
                  lambda: chunk.x_half_plain(lp, st.x, st.y, st.last_x,
                                             sigma, h()),
                  half_bound(lp.AT, dtype, 1, "x")),
            "y": (lambda: (chunk.y_half(lp, st.y, x_hat, st.last_y,
                                        lam_sigma, h()),),
                  lambda: (chunk.y_half_plain(lp, st.y, x_hat, st.last_y,
                                              lam_sigma, h()),),
                  half_bound(lp.A, dtype, 1, "y"))}
        errs = []
        for half, (fused_fn, plain_fn, (bound_ms, bound_by)) in \
                halves.items():
            new, ref = fused_fn(), plain_fn()
            torch.cuda.synchronize()
            differ_n = sum(int((a != b).sum()) for a, b in zip(new, ref))
            errs.append(max(float((a - b).abs().max())
                            for a, b in zip(new, ref)))
            del new, ref
            rec[half] = {"ms": time_ms(fused_fn),
                         "eager_ms": eager_ms(fused_fn),
                         "plain_ms": time_ms(plain_fn, reps=10),
                         "bound_ms": bound_ms, "bound_by": bound_by,
                         "differ": differ_n}
            r = rec[half]
            phase(10, f"fused single-LP {half}-half {cell} (gather): "
                      f"{r['ms']:.5f} ms ({bound_ms / r['ms']:.1%} of bound "
                      f"{bound_ms:.5f} ms, {bound_by}), eager "
                      f"{r['eager_ms']:.5f} ms; its SpMV and plain ops "
                      f"{r['plain_ms']:.5f} ms (graph replay); entries "
                      f"differing from the plain half {differ_n} [{card}]")
            check(differ_n == 0, f"phase 10: the fused {half}-half differs "
                  f"from its plain version ({cell}) in {differ_n} entries")
        rec["max_abs_err"] = max([rec.get("max_abs_err", 0.0)] + errs)
        records[cell] = rec
        del loop
    return records


def tiled_halves_phase(card, problems):
    """Phase 10 (c): the single-LP middle iteration's halves fused into the
    tiled SpMV, at each of `problems` ({name: LP}), f32 and f64, on the
    default tiles and on tiles with another strip-group count (G = 1 where
    the default has groups, else 4): each half alone bitwise the kernel's
    store followed by the plain ops (else the largest difference in ulps,
    and the phase fails); one 150-iteration run_chunk through the fused
    halves, through the plain halves and by its graph's replay, every state
    tensor and metric bitwise equal, with 148 fused launches of each half
    and none of the CSR kernel's or of the group-sum pass; each half and
    its matrix's product on the main stage (one cluster of the G
    strip-group blocks per row chunk) bitwise and timed beside block_x
    (the previous design: partials through HBM, then group_sum_kernel),
    with G x C and the resident clusters; each half timed by graph
    replay, fused, plain, and as the kernel's store then the mesh's
    epilogue, beside its bound (half_bound over its matrix: the
    function's bytes) and the tiles' stream on both stages; block_x also
    on its own layout (the same tiling built with slots=None), bitwise
    that layout's store then the mesh's epilogue.  Tiles are built with
    the card's resident clusters (cluster_slots), as a solve builds them.
    On the default tiles the mesh's epilogue too, on the
    kernel's products: bitwise its plain version, timed with its inputs out
    of L2 (rotated copies) beside its plain version, timed so, and its
    bound, and in L2.  Returns {cell: record}."""
    import dataclasses

    from hprlp_tpu_torch.ops.spmv import (MAIN_STAGE, group_sum_kernel,
                                          max_active_clusters, spmv_x_half,
                                          spmv_y_half, tiled_half_epilogue,
                                          tiled_spmv, tiled_x_half,
                                          tiled_x_half_block_x,
                                          tiled_y_half,
                                          tiled_y_half_block_x)
    from hprlp_tpu_torch.ops.tiles import build_tiles
    from hprlp_tpu_torch.prof import prof_loop
    from hprlp_tpu_torch.prof.timing import (HBM_BYTES_PER_S, epilogue_bound,
                                             half_bound, l2_rotations,
                                             tiled_half_bytes)
    from hprlp_tpu_torch.solver import chunk
    from hprlp_tpu_torch.solver.graph import CapturedStep

    def counts():  # fused tiled x, y; CSR halves; group sums; block_x x, y
        return (tiled_x_half.launches, tiled_y_half.launches,
                spmv_x_half.launches + spmv_y_half.launches,
                group_sum_kernel.launches, tiled_x_half_block_x.launches,
                tiled_y_half_block_x.launches)

    records = {}
    t0 = time.perf_counter()
    for size, problem in problems.items():
        for dtype, tag in ((torch.float32, "f32"), (torch.float64, "f64")):
            loop = prof_loop.Loop(problem, dtype, graph=False,
                                  backend="tiled")
            loop.run(1)
            st, sigma = loop.state, loop.sigma
            lam_sigma = loop.lam * sigma
            other = {name: M.with_tiles(build_tiles(
                M, strip_groups=1 if M.tiles.n_groups > 1 else 4))
                for name, M in (("A", loop.lp.A), ("AT", loop.lp.AT))}
            tilings = {"default": loop.lp,
                       "other_G": dataclasses.replace(loop.lp, **other)}
            for tiling, lp in tilings.items():
                cell = f"{size}_{tag}_{tiling}"
                at_start = counts()
                groups = (lp.A.tiles.n_groups, lp.AT.tiles.n_groups)
                rows_x = (st.x, st.last_x, lp.c, lp.l, lp.u)
                rows_y = (st.y, st.last_y, lp.AL, lp.AU)

                def h():  # the first middle iteration's counter
                    return chunk.Halpern(st.inner, 0, dtype)

                def fused_x():
                    return chunk.x_half(lp, st.x, st.y, st.last_x, sigma,
                                        h())

                def plain_x():
                    return chunk.x_half_plain(lp, st.x, st.y, st.last_x,
                                              sigma, h())

                before = counts()
                xf, xp = fused_x(), plain_x()
                y_f = chunk.y_half(lp, st.y, xf[1], st.last_y, lam_sigma,
                                   h())
                y_p = chunk.y_half_plain(lp, st.y, xp[1], st.last_y,
                                         lam_sigma, h())
                torch.cuda.synchronize()
                alone = tuple(a - b for a, b in zip(counts(), before))
                pairs = {"x_new": (xf[0], xp[0]), "x_hat": (xf[1], xp[1]),
                         "y_new": (y_f, y_p)}
                half_ulps = {k: ulps(a, b) for k, (a, b) in pairs.items()}
                max_err = max(float((a - b).abs().max())
                              for a, b in pairs.values())

                args = (lp, loop.scal, st, sigma, loop.lam,
                        torch.tensor(False, device="cuda"), loop.check)
                before = counts()
                fused = chunk.run_chunk(*args)
                launches = tuple(a - b for a, b in zip(counts(), before))
                with swapped(chunk, x_half=chunk.x_half_plain,
                             y_half=chunk.y_half_plain):
                    plain = chunk.run_chunk(*args)
                step = CapturedStep(lambda: chunk.run_chunk(*args),
                                    counts={})
                step.replay()
                torch.cuda.synchronize()
                vs_plain = chunk_differ(fused, plain)
                vs_graph = chunk_differ(fused, step.out)
                del fused, plain, step

                x_hat = xf[1]
                rec = {"groups": {"A": groups[0], "AT": groups[1]},
                       "ulps": half_ulps, "max_abs_err": max_err,
                       "alone_launches": alone, "chunk_launches": launches,
                       "differ_plain": vs_plain, "differ_graph": vs_graph}
                timed = (
                    ("x", fused_x, plain_x, lp.AT, st.y, rows_x, sigma),
                    ("y", lambda: chunk.y_half(lp, st.y, x_hat, st.last_y,
                                               lam_sigma, h()),
                     lambda: chunk.y_half_plain(lp, st.y, x_hat, st.last_y,
                                                lam_sigma, h()),
                     lp.A, x_hat, rows_y, lam_sigma))
                halves = {"x": tiled_x_half,
                          "y": lambda *a, **k: (tiled_y_half(*a, **k),)}
                for half, fused_fn, plain_fn, M, v, rows, scal in timed:
                    T = M.tiles

                    def on(stage, T=T, v=v, rows=rows, scal=scal,
                           half=half):  # the half alone on a stage
                        return halves[half](T, v, *rows, scal, st.inner, 0,
                                            stage=stage)

                    # block_x's yardstick on its own layout: these tiles as
                    # laid out before the cut to the card's clusters
                    # (slots=None).  Another layout sums in another order,
                    # so the half there is held bitwise to that layout's
                    # store then the mesh's epilogue.
                    T_uncut = build_tiles(
                        M, strip_groups=None if tiling == "default"
                        else T.n_groups, slots=None)

                    def uncut(T_uncut=T_uncut, v=v, rows=rows, scal=scal,
                              half=half):
                        return halves[half](T_uncut, v, *rows, scal,
                                            st.inner, 0, stage="block_x")

                    split = tiled_half_epilogue(
                        half, tiled_spmv(T_uncut, v, "block_x"), rows, scal,
                        st.inner, 0)
                    uncut_ulps = max(ulps(a, b) for a, b in zip(
                        uncut(), split if half == "x" else (split,)))
                    check(uncut_ulps == 0, f"phase 10 (c): {cell}: the "
                          f"{half}-half on block_x's own layout is "
                          f"{uncut_ulps} ulps from its store then the "
                          f"epilogue")

                    # The main stage against the previous design on the
                    # same tiles: the half and the product, bitwise.
                    stage_ulps = {
                        "half": max(ulps(a, b) for a, b in zip(
                            on(MAIN_STAGE), on("block_x"))),
                        "product": ulps(tiled_spmv(T, v),
                                        tiled_spmv(T, v, "block_x"))}
                    # The bound is the function's bytes over M (half_bytes);
                    # the tiles' stream (padding, runs, on block_x the
                    # partials) is shown beside it.  split: the kernel's
                    # store, then the mesh's epilogue on its y, the other
                    # way to run the half.
                    bound_ms, bound_by = half_bound(M, dtype, 1, half)
                    rec[half] = r = {
                        "ms": time_ms(fused_fn),
                        "block_x_ms": time_ms(lambda: on("block_x")),
                        "product_ms": time_ms(lambda: tiled_spmv(T, v)),
                        "product_block_x_ms": time_ms(
                            lambda: tiled_spmv(T, v, "block_x")),
                        "block_x_uncut_ms": time_ms(uncut),
                        "product_block_x_uncut_ms": time_ms(
                            lambda: tiled_spmv(T_uncut, v, "block_x")),
                        "uncut_shape": (T_uncut.n_groups, T_uncut.n_chunks),
                        "uncut_ulps": uncut_ulps,
                        "plain_ms": time_ms(plain_fn, reps=10),
                        "split_ms": time_ms(
                            lambda: tiled_half_epilogue(
                                half, tiled_spmv(T, v), rows, scal,
                                st.inner, 0)),
                        "bound_ms": bound_ms, "bound_by": bound_by,
                        "stream_ms": tiled_half_bytes(T, dtype, half)
                        / HBM_BYTES_PER_S * 1e3,
                        "stream_block_x_ms": tiled_half_bytes(
                            T, dtype, half, "block_x")
                        / HBM_BYTES_PER_S * 1e3,
                        "groups": T.n_groups, "chunks": T.n_chunks,
                        "live_chunks": T.live_chunks,
                        "resident": max_active_clusters(T),
                        "ulps_vs_block_x": stage_ulps}
                    phase(10, f"(c) {cell} fused {half}-half on the tiles "
                              f"(G x C {T.n_groups} x {T.n_chunks}, "
                              f"{T.live_chunks} launched, {r['resident']} "
                              f"clusters of {T.n_groups} resident): "
                              f"{r['ms']:.5f} ms, block_x "
                              f"{r['block_x_ms']:.5f} ms ("
                              f"{bound_ms / r['ms']:.1%} and "
                              f"{bound_ms / r['block_x_ms']:.1%} of "
                              f"half_bound {bound_ms:.5f} ms, {bound_by}; "
                              f"the tiles' stream at the HBM rate "
                              f"{r['stream_ms']:.5f} ms, block_x's "
                              f"{r['stream_block_x_ms']:.5f}); the product "
                              f"{r['product_ms']:.5f} ms, block_x "
                              f"{r['product_block_x_ms']:.5f} ms; block_x "
                              f"on its own layout (G x C {T_uncut.n_groups} "
                              f"x {T_uncut.n_chunks}, slots=None): half "
                              f"{r['block_x_uncut_ms']:.5f} ms, product "
                              f"{r['product_block_x_uncut_ms']:.5f} ms, "
                              f"{uncut_ulps} ulps from its store then the "
                              f"epilogue; ulps from "
                              f"block_x {stage_ulps}; the store then the "
                              f"epilogue {r['split_ms']:.5f} ms; its SpMV "
                              f"and plain ops {r['plain_ms']:.5f} ms (graph "
                              f"replay) [{card}]")
                    check(not any(stage_ulps.values()), f"phase 10 (c): "
                          f"{cell}: the {half}-half's main stage differs "
                          f"from block_x by {stage_ulps} ulps")
                if tiling == "default":
                    # The plain updates on given rows: (x, last_x, c, l, u)
                    # or (y, last_y, AL, AU).
                    epi = {
                        "x": (tiled_spmv(lp.AT.tiles, st.y), rows_x, sigma,
                              lambda s, r: chunk.x_update(
                                  types.SimpleNamespace(c=r[2], l=r[3],
                                                        u=r[4]),
                                  r[0], s, r[1], sigma, *h().factors)[:2]),
                        "y": (tiled_spmv(lp.A.tiles, x_hat), rows_y,
                              lam_sigma,
                              lambda s, r: chunk.y_update(
                                  types.SimpleNamespace(AL=r[2], AU=r[3]),
                                  r[0], s, r[1], lam_sigma,
                                  *h().factors)[:1])}
                    for half, (s_, rows, scal, plain_fn) in epi.items():
                        got = tiled_half_epilogue(half, s_, rows, scal,
                                                  st.inner, 0)
                        got = got if half == "x" else (got,)
                        want = plain_fn(s_, rows)
                        torch.cuda.synchronize()
                        e_ulps = max(ulps(a, b) for a, b in zip(got, want))
                        bound_ms, bound_by = epilogue_bound(s_.numel(), dtype,
                                                            half)
                        # Timed with its inputs out of L2, as a mesh solve
                        # meets them after a tiled SpMV: each call takes the
                        # next of enough copies to fill the L2 four times.
                        k = l2_rotations((1 + len(rows)) * s_.numel()
                                         * s_.element_size())
                        copies = [tuple(a.clone() for a in (s_, *rows))
                                  for _ in range(k)]
                        turn = itertools.cycle(copies)

                        def cold_fused():
                            s1, *r1 = next(turn)
                            return tiled_half_epilogue(half, s1, r1, scal,
                                                       st.inner, 0)

                        def cold_plain():
                            s1, *r1 = next(turn)
                            return plain_fn(s1, r1)

                        rec[f"epilogue_{half}"] = r = {
                            "ulps": e_ulps, "max_abs_err": max(
                                float((a - b).abs().max())
                                for a, b in zip(got, want)),
                            "ms": time_ms(cold_fused, reps=max(50, k)),
                            "plain_ms": time_ms(cold_plain, reps=max(10, k)),
                            "l2_resident_ms": time_ms(
                                lambda: tiled_half_epilogue(
                                    half, s_, rows, scal, st.inner, 0)),
                            "rotated_copies": k,
                            "bound_ms": bound_ms, "bound_by": bound_by}
                        del copies, turn
                        phase(10, f"(c) {cell} the mesh's {half}-half "
                                  f"epilogue alone ({s_.numel()} rows): "
                                  f"{e_ulps} ulps from its plain version; "
                                  f"{r['ms']:.5f} ms with its inputs out of "
                                  f"L2 ({k} copies; {bound_ms / r['ms']:.1%}"
                                  f" of bound {bound_ms:.5f} ms, {bound_by})"
                                  f", plain {r['plain_ms']:.5f} ms; in L2 "
                                  f"{r['l2_resident_ms']:.5f} ms [{card}]")
                        check(e_ulps == 0, f"phase 10 (c): {cell}: the "
                              f"{half}-half epilogue is {e_ulps} ulps from "
                              f"its plain version")
                # The fused halves' calls on block_x in this cell: the
                # timings' and bitwise checks' alone (the chunks take none).
                rec["block_x_calls"] = tuple(
                    a - b for a, b in zip(counts(), at_start))[4:]
                records[cell] = rec
                phase(10, f"(c) {cell}: tiles of A / A^T in {groups[0]} / "
                          f"{groups[1]} strip groups; each half alone: ulps "
                          f"from the store and plain ops {half_ulps}, "
                          f"launches (tiled x, tiled y, CSR, group sums, "
                          f"block_x x, block_x y) {alone}; chunk "
                          f"of {loop.check}: launches {launches}, fields "
                          f"differing from the plain halves: "
                          f"{vs_plain or 'none'}, from the graph's replay: "
                          f"{vs_graph or 'none'} [{card}]")
                middle = loop.check - 2
                check(all(u == 0 for u in half_ulps.values()),
                      f"phase 10 (c): {cell}: a fused half differs from "
                      f"its store and plain ops by {half_ulps} ulps")
                check(alone == (1, 1, 0, 0, 0, 0)
                      and launches == (middle, middle, 0, 0, 0, 0),
                      f"phase 10 (c): {cell}: launches {alone} alone, "
                      f"{launches} in the chunk")
                check(not vs_plain, f"phase 10 (c): {cell}: fused and "
                      f"plain chunks differ in {vs_plain}")
                check(not vs_graph, f"phase 10 (c): {cell}: the fused "
                      f"chunk's replay differs from its eager run in "
                      f"{vs_graph}")
            g = [records[f"{size}_{tag}_{t}"]["groups"] for t in tilings]
            check(all(g[0][k] != g[1][k] for k in ("A", "AT"))
                  and any(v == 1 for d in g for v in d.values())
                  and any(v > 1 for d in g for v in d.values()),
                  f"phase 10 (c): {size} {tag}: strip groups {g}: no pair "
                  f"of G = 1 and G > 1")
            del loop, tilings, other
    phase(10, f"(c) took {time.perf_counter() - t0:.1f} s [{card}]")
    return records


MESH_SLICES = (2, 4)
MESH_TOL = 1e-5  # the sum of the slices' partial y's, f32, relative
GROUP_UP = re.compile(r"\[mesh rank (\d+)/(\d+)\] .* group up in (\S+) s")


def mesh_counts(fn):
    """(fn(), each counted wrapper's launches during it, the sharded
    SpMV's all-reduces included: solver/graph.py::launch_counts)."""
    from hprlp_tpu_torch.solver.graph import launch_counts

    before = launch_counts()
    out = fn()
    after = launch_counts()
    return out, {k: after[k] - before[k] for k in after}


def same_point(a, b):
    """Iterations, objective and x bitwise equal."""
    return (a.iter == b.iter and a.primal_obj == b.primal_obj
            and np.array_equal(a.x, b.x))


def mesh_slices(card, problem):
    """Phase 15 (a): sparse_huge's A and A^T (f32) cut by column_slices at
    each N of MESH_SLICES, each slice tiled on the card and timed by graph
    replay beside its bound; the slices' partial y's summed against the
    tiled kernel on the whole matrix and its plain version."""
    from hprlp_tpu_torch.ops.device_problem import build_device_problem
    from hprlp_tpu_torch.ops.spmv import tiled_spmv
    from hprlp_tpu_torch.ops.tiles import build_tiles, tiled_spmv_reference
    from hprlp_tpu_torch.parallel.sharded import (column_slices,
                                                  slice_columns)

    rng = np.random.default_rng(15)
    lp, _ = build_device_problem(problem, dtype=torch.float32,
                                 device="cuda")
    rec = {}
    for name, M in (("A", lp.A), ("AT", lp.AT)):
        x = torch.as_tensor(rng.normal(size=M.ncols), device="cuda"
                            ).to(torch.float32)
        T = build_tiles(M).without_perm()
        whole = tiled_spmv(T, x)
        plain = tiled_spmv_reference(T, x)
        whole_ms = time_ms(lambda: tiled_spmv(T, x))
        scale = float(plain.abs().max())
        col = torch.bincount(M.indices.long(), minlength=M.ncols)
        for N in MESH_SLICES:
            total = torch.zeros_like(whole)
            slices = []
            for c0, c1 in column_slices(col.cpu().numpy(), N):
                S = slice_columns(M, c0, c1)
                TS = build_tiles(S).without_perm()
                xs = x[c0:c1]
                total += tiled_spmv(TS, xs)
                bound, by = spmv_bound(S, torch.float32)
                slices.append({"c0": c0, "c1": c1, "nnz": S.nnz,
                               "ms": time_ms(lambda: tiled_spmv(TS, xs)),
                               "bound_ms": bound, "bound_by": by})
                del S, TS
            torch.cuda.synchronize()
            err = float((total - whole).abs().max())
            err_plain = float((total - plain).abs().max())
            check(max(err, err_plain) <= MESH_TOL * scale,
                  f"phase 15 (a): {name} at N={N}: the slices' partial y's "
                  f"are {err} from the whole kernel's and {err_plain} from "
                  f"the plain version's, more than {MESH_TOL} * {scale}")
            top = max(slices, key=lambda r: r["ms"])
            rec[f"{name}_N{N}"] = {"slices": slices, "max_abs_err": err,
                                   "max_abs_err_plain": err_plain,
                                   "whole_ms": whole_ms,
                                   "largest_slice_ms": top["ms"]}
            phase(15, f"(a) sparse_huge {name} f32 ({M.nnz} nnz) in {N} "
                      f"column slices: " + "; ".join(
                          f"[{r['c0']}, {r['c1']}) {r['nnz']} nnz "
                          f"{r['ms']:.5f} ms (bound {r['bound_ms']:.5f} ms, "
                          f"{r['bound_by']})" for r in slices)
                  + f"; sum of the partial y's against the whole kernel "
                    f"max_abs_err={err:.3e}, against the plain version "
                    f"{err_plain:.3e} (<= {MESH_TOL:g}*{scale:.3e}); the "
                    f"largest slice {top['ms']:.5f} ms beside the whole "
                    f"matrix's {whole_ms:.5f} ms [{card}]")
    return rec


def ulps(a, b) -> int:
    """The largest distance between a and b (one float dtype) in units in
    the last place: 0 where they are bitwise equal."""
    itype = torch.int32 if a.dtype == torch.float32 else torch.int64
    return int((a.view(itype).long() - b.view(itype).long()).abs().max())


def row_slice(M, r0, r1):
    """Rows [r0, r1) of CSR matrix M (on the card, no tiles) as a matrix of
    their own, its arrays copied (16-byte aligned, as a rank's upload
    is), with its row-block plan."""
    from hprlp_tpu_torch.ops.spmv import row_blocks

    e0, e1 = int(M.indptr[r0]), int(M.indptr[r1])
    S = dataclasses.replace(
        M, indptr=(M.indptr[r0:r1 + 1] - e0).contiguous(),
        indices=M.indices[e0:e1].clone(), vals=M.vals[e0:e1].clone(),
        nrows=r1 - r0, blocks=None, tiles=None, dense=None)
    return dataclasses.replace(S, blocks=row_blocks(S))


def row_slices(card, problem):
    """Phase 15 (l): `problem`'s (sparse_large's) A and A^T, f32 and f64,
    cut into N row slices (MESH_SLICES) at share_cuts' R (A's rows) and C
    (A^T's rows), each a CSR matrix of its own with its row-block plan,
    as a rank of a row-sharded mesh holds it: the CSR kernel and its
    fused half (the y-half over A's rows, the x-half over A^T's) on each
    slice timed by graph replay beside their bounds; the slices' outputs
    concatenated against the kernel on the whole matrix and against the
    plain versions (csr_spmv_plain; the half's plain ops), bitwise or the
    largest difference in ulps.  Returns the record."""
    from hprlp_tpu_torch.ops.device_problem import (build_device_problem,
                                                    canonical_csr)
    from hprlp_tpu_torch.ops.spmv import (csr_spmv, csr_spmv_plain,
                                          spmv_x_half, spmv_y_half)
    from hprlp_tpu_torch.parallel.sharded import share_cuts
    from hprlp_tpu_torch.prof.timing import half_bound
    from hprlp_tpu_torch.solver import chunk

    A_host = canonical_csr(problem)
    rec = {}
    for dtype, tag in ((torch.float32, "f32"), (torch.float64, "f64")):
        lp, _ = build_device_problem(problem, dtype=dtype, device="cuda")
        gen = torch.Generator(device="cuda").manual_seed(15)

        def rand(k):
            return torch.randn(k, generator=gen, device="cuda", dtype=dtype)

        inner = torch.tensor(4, dtype=torch.int32, device="cuda")
        scal = torch.tensor(0.9, dtype=dtype, device="cuda")
        for name, M, half in (("A", lp.A, "y"), ("AT", lp.AT, "x")):
            M = row_slice(M, 0, M.nrows)
            v = rand(M.ncols)
            r = [rand(M.nrows) for _ in range(5)]
            r[3], r[4] = -r[3].abs(), r[4].abs()  # the bounds

            def half_on(S, a, b):
                k = slice(a, b)
                if half == "x":  # x, last_x, c, l, u
                    return spmv_x_half(S, v, r[0][k], r[1][k], r[2][k],
                                       r[3][k], r[4][k], scal, inner, 2)
                return (spmv_y_half(S, v, r[0][k], r[1][k], r[3][k],
                                    r[4][k], scal, inner, 2),)

            h = chunk.Halpern(inner, 2, dtype)
            if half == "x":
                plain_half = chunk.x_half_plain(dataclasses.replace(
                    lp, AT=M, c=r[2], l=r[3], u=r[4]), r[0], v, r[1], scal,
                    h)
            else:
                plain_half = (chunk.y_half_plain(dataclasses.replace(
                    lp, A=M, AL=r[3], AU=r[4]), r[0], v, r[1], scal, h),)
            whole, plain = csr_spmv(M, v), csr_spmv_plain(M, v)
            whole_half = half_on(M, 0, M.nrows)
            whole_ms = time_ms(lambda: csr_spmv(M, v))
            whole_half_ms = time_ms(lambda: half_on(M, 0, M.nrows))
            for N in MESH_SLICES:
                row_cuts, col_cuts, _ = share_cuts(A_host, lp.m, lp.n, 0, N)
                cuts = row_cuts if name == "A" else col_cuts
                parts, halves, slices = [], [], []
                for a, b in zip(cuts, cuts[1:]):
                    S = row_slice(M, a, b)
                    parts.append(csr_spmv(S, v))
                    halves.append(half_on(S, a, b))
                    bound, by = spmv_bound(S, dtype)
                    hbound, hby = half_bound(S, dtype, 1, half)
                    slices.append({
                        "r0": a, "r1": b, "nnz": S.nnz,
                        "ms": time_ms(lambda: csr_spmv(S, v)),
                        "bound_ms": bound, "bound_by": by,
                        "half_ms": time_ms(lambda: half_on(S, a, b)),
                        "half_bound_ms": hbound, "half_bound_by": hby})
                    del S
                got = torch.cat(parts)
                got_half = [torch.cat([hv[i] for hv in halves])
                            for i in range(len(whole_half))]
                r_ = {"slices": slices, "whole_ms": whole_ms,
                      "whole_half_ms": whole_half_ms,
                      "ulps_whole": ulps(got, whole),
                      "ulps_plain": ulps(got, plain),
                      "half_ulps_whole": max(ulps(g, w) for g, w in zip(
                          got_half, whole_half)),
                      "half_ulps_plain": max(ulps(g, w) for g, w in zip(
                          got_half, plain_half)),
                      "max_abs_err": float((got - plain).abs().max())}
                rec[f"{name}_{tag}_N{N}"] = r_
                scale = float(plain.abs().max())
                phase(15, f"(l) sparse_large {name} {tag} ({M.nnz} nnz) in "
                          f"{N} row slices: " + "; ".join(
                              f"[{q['r0']}, {q['r1']}) {q['nnz']} nnz csr_spmv "
                              f"{q['ms']:.5f} ms (bound {q['bound_ms']:.5f}, "
                              f"{q['bound_by']}), {half}-half "
                              f"{q['half_ms']:.5f} ms (bound "
                              f"{q['half_bound_ms']:.5f})" for q in slices)
                      + f"; the whole matrix {whole_ms:.5f} ms, its "
                        f"{half}-half {whole_half_ms:.5f} ms; concatenated "
                        f"against the whole kernel "
                        f"{r_['ulps_whole']} ulps, the plain version "
                        f"{r_['ulps_plain']} ulps; the {half}-half against "
                        f"the whole's {r_['half_ulps_whole']} ulps, its "
                        f"plain ops {r_['half_ulps_plain']} ulps [{card}]")
                check(r_["max_abs_err"] <= MESH_TOL * scale,
                      f"phase 15 (l): {name} {tag} N={N}: the slices are "
                      f"{r_['max_abs_err']} from the plain version")
            del M, whole, plain, whole_half, plain_half
        del lp
    return rec


# Phase 15 (m)'s solves: (cell, problem key, precision, spmv_backend,
# stop_tol); dense_lp is phase 11's LP.  sparse_large in f64 at 1e-6:
# at 1e-8 both the mesh and the one card stop at 100,000 iterations
# (ITER_LIMIT, bitwise alike, 4.3-5.7 s each).
ROW_MESH_CELLS = (("sparse_large", "prob4", "f32", "gather", 1e-4),
                  ("sparse_large", "prob4", "f64", "gather", 1e-6),
                  ("dense_lp", "dense_lp", "f32", "dense", 1e-4),
                  ("sparse_large", "prob4", "f32", "auto", 1e-4))


def row_mesh(card, prob4, prob6, add):
    """Phase 15 (m), in the one-rank NCCL group: each of ROW_MESH_CELLS
    with mesh_shape=1 (the row shards from the share's row forms, an
    all-gather per SpMV and per fused half, captured in the CUDA graph)
    and without a mesh: bitwise (iterations, objective, x) on the same
    backend, for "auto" the same choice; each mesh solve's launches
    (added to phase 15's by precision through `add`), its all-gathers per
    iteration and no tiled launch outside the probes.  Then the share
    ingest's wall for "gather" (the row forms alone) beside the tiles'
    share ingest and the one-card ingest, at sparse_large and
    sparse_huge.  Returns the record."""
    import hprlp_tpu_torch as hp
    from hprlp_tpu_torch.solver import loop
    from hprlp_tpu_torch.solver.autotune import autotune_backends

    t0 = time.perf_counter()
    problems = {"prob4": prob4,
                "dense_lp": random_lp(4096, 8192, 128, seed=5)}
    rec = {}
    for cell, key, tag, backend, tol in ROW_MESH_CELLS:
        problem = problems[key]
        kw = dict(stop_tol=tol, verbose=False, use_presolve=False,
                  precision=tag, spmv_backend=backend, max_iter=100_000)
        calls = []
        with recorded(calls, [(loop, "build_ingest")]):
            mesh, counts = mesh_counts(lambda: hp.solve_problem(
                problem, hp.Parameters(mesh_shape=1, **kw)))
            forms = loop.build_share_ingest.record["forms"]
            mesh_tune = autotune_backends.record
            one = hp.solve_problem(problem, hp.Parameters(**kw))
            one_tune = autotune_backends.record
        add(tag, counts)
        same = same_point(mesh, one) and mesh.spmv_backend == one.spmv_backend
        per_it = counts["all_gather_rows"] / max(mesh.iter, 1)
        mesh_s, one_s = [out[3] for _, _, out in calls]
        name = f"{cell}_{tag}_{backend}"
        rec[name] = {"status": mesh.status, "iter": mesh.iter,
                     "spmv_backend": mesh.spmv_backend, "forms": forms,
                     "time_mesh": mesh.time, "time_one": one.time,
                     "launches": counts, "all_gathers_per_iter": per_it,
                     "bitwise": same, "autotune_mesh": mesh_tune,
                     "autotune_one": one_tune, "ingest_mesh_s": mesh_s,
                     "ingest_one_s": one_s}
        phase(15, f"(m) {cell} {tag} spmv_backend={backend!r} mesh_shape=1 "
                  f"(row shards, all-gathers in the CUDA graph): status="
                  f"{mesh.status} iter={mesh.iter} backend "
                  f"{mesh.spmv_backend} (one card {one.spmv_backend}; "
                  f"autotune: mesh {probe_text(mesh_tune)}, one card "
                  f"{probe_text(one_tune)}), forms kept {forms}; "
                  f"Results.time {mesh.time:.4f}s (one card {one.time:.4f}s, "
                  f"iter {one.iter}); all-gathers {counts['all_gather_rows']}"
                  f" ({per_it:.3f} per iteration); launches csr_spmv "
                  f"{counts['csr_spmv']}, spmv_x_half "
                  f"{counts['spmv_x_half']}, spmv_y_half "
                  f"{counts['spmv_y_half']}, tiled_spmv "
                  f"{counts['tiled_spmv']}, all_reduce_sum "
                  f"{counts['all_reduce_sum']}; ingest wall (s) mesh "
                  f"{mesh_s['wall']:.3f} one card {one_s['wall']:.3f}; "
                  f"bitwise the one-card solve (iterations, objective, x, "
                  f"backend): {same} [{card}]")
        check(same and mesh.status == "OPTIMAL", f"phase 15 (m): {name}: "
              f"{rec[name]}")
        check(mesh.spmv_backend != "tiled" or backend == "auto",
              f"phase 15 (m): {name} ran the tiles")
        if mesh.spmv_backend != "tiled":
            check(counts["tiled_spmv"] == 0 and counts["all_reduce_sum"] == 0
                  and counts["all_gather_rows"] > 0
                  and (mesh.spmv_backend == "dense"
                       or min(counts["csr_spmv"], counts["spmv_x_half"],
                              counts["spmv_y_half"]) > 0),
                  f"phase 15 (m): {name} launched {counts}")
        check(backend != "auto" or (
            mesh_tune and one_tune
            and mesh_tune["choice"] == one_tune["choice"]),
              f"phase 15 (m): {name}: the mesh chose "
              f"{mesh_tune and mesh_tune['choice']}, one card "
              f"{one_tune and one_tune['choice']}")
        del mesh, one
    walls = {}
    for cell, problem in (("sparse_large", prob4), ("sparse_huge", prob6)):
        base = dict(stop_tol=1e-4, verbose=False, use_presolve=False,
                    precision="f32")
        for route, extra in (("share_gather", dict(mesh_shape=1,
                                                   spmv_backend="gather")),
                             ("share_lane", dict(mesh_shape=1,
                                                 spmv_backend="lane")),
                             ("one_card_gather", dict(spmv_backend="gather")),
                             ("one_card_lane", dict(spmv_backend="lane"))):
            lp, _, _, seconds = loop.build_ingest(
                problem, hp.Parameters(**base, **extra))
            del lp
            torch.cuda.synchronize()
            walls[f"{cell}_{route}"] = seconds
        w = {k[len(cell) + 1:]: v for k, v in walls.items()
             if k.startswith(cell)}
        phase(15, f"(m) {cell} f32 ingest wall (s) and stages: " + "; ".join(
            f"{route} {v['wall']:.3f} (" + ", ".join(
                f"{k} {x:.3f}" for k, x in v.items() if k != "wall") + ")"
            for route, v in w.items()) + f" [{card}]")
    rec["ingest"] = walls
    phase(15, f"(m) took {time.perf_counter() - t0:.1f} s [{card}]")
    return rec


def mesh_phase(card, prob6, prob5, prob4, giant):
    """Phase 15: the mesh route on one card.  (a) mesh_slices; (b) a
    one-rank NCCL group in this process: sparse_huge f32 (1e-4) and
    assignment64 f64 (1e-8) with mesh_shape=1, captured, bitwise the
    one-card solve on the backend the autotune chose, (f) each through
    the share ingest, its exchanges counted; (c) batched_large with mesh_shape=1 bitwise the
    single-device batched solve; (h) "mixed" at mesh_shape=1 on
    assignment64 (1e-8) bitwise the one-card "mixed" solve; (j) the
    presolve overlap at mesh_shape=1 on a 21.0M-nnz random LP
    (overlap_mesh): one presolve, bitwise the one-card overlap, the wall
    below presolve + ingest; (i) a server `solve` request with mesh_shape=1
    (sparse_large) bitwise the in-process mesh solve; (d) `python -m
    hprlp_tpu_torch.cli --mesh 1` on data/model.mps (its own group, in a
    launched rank); (e) with two cards or more, a 2-rank sparse_huge solve
    against the single-card one, else why not; (g) each rank's device
    peak through the share ingest for N = 2 and 4 (share_ingest_phase);
    (k) the discard branch's broadcasts at the banded giant
    (discard_phase); (l) row slices of sparse_large (row_slices); (m)
    the row shards in the group (row_mesh).
    Returns ({"f32", "f64": tiled launches, and each other counted
    wrapper's} of the mesh-route solves, record)."""
    import torch.distributed as dist

    import hprlp_tpu_torch as hp
    from hprlp_tpu_torch.parallel import distributed
    from hprlp_tpu_torch.prof.problems import batched_lp
    from hprlp_tpu_torch.solver import loop
    from hprlp_tpu_torch.solver.autotune import autotune_backends

    t_start = time.perf_counter()
    rec = {"slices": mesh_slices(card, prob6)}
    t_l = time.perf_counter()
    rec["row_slices"] = row_slices(card, prob4)
    phase(15, f"(l) took {time.perf_counter() - t_l:.1f} s [{card}]")
    launches = {"f32": {}, "f64": {}}

    def add(tag, counts):
        for k, v in counts.items():
            launches[tag][k] = launches[tag].get(k, 0) + v

    params = {"sparse_huge": (prob6, "f32", dict(
        stop_tol=1e-4, verbose=False, use_presolve=False,
        max_iter=50_000)),
        "assignment64": (prob5, "f64", dict(
            stop_tol=1e-8, verbose=False, use_presolve=False,
            max_iter=100_000))}
    singles = {}
    arrays = batched_lp(65536, 131072, 64, seed=3)
    distributed.initialize(world_size=1, rank=0, device_type="cuda",
                           store=distributed.host_store())
    try:
        for name, (problem, tag, kw) in params.items():
            calls = []
            with recorded(calls, [(loop, "build_ingest")]):
                mesh, counts = mesh_counts(lambda: hp.solve_problem(
                    problem, hp.Parameters(mesh_shape=1, **kw)))
                share = dict(loop.build_share_ingest.record)
                tune = autotune_backends.record
                ran = mesh.spmv_backend
                lane, lane_counts = mesh_counts(lambda: hp.solve_problem(
                    problem, hp.Parameters(
                        spmv_backend="lane" if ran == "tiled" else ran,
                        **kw)))
            add(tag, counts)
            singles[name] = lane
            same = same_point(mesh, lane)
            tiles = ran == "tiled"
            coll = "all_reduce_sum" if tiles else "all_gather_rows"
            per_it = counts[coll] / max(mesh.iter, 1)
            # One epilogue per middle-iteration half after its all-reduce
            # on the mesh, where one card launches the fused halves.
            lane_halves = (lane_counts["tiled_x_half"]
                           + lane_counts["tiled_y_half"])
            mesh_s, lane_s = [out[3] for _, _, out in calls]
            rec[name] = {"iter": mesh.iter, "status": mesh.status,
                         "spmv_backend": ran, "autotune": tune,
                         "time_mesh": mesh.time, "time_lane": lane.time,
                         "setup_mesh": mesh.setup_time,
                         "setup_lane": lane.setup_time,
                         "launches": counts, "lane_launches": lane_counts,
                         "collectives_per_iter": per_it,
                         "bitwise": same, "share": share,
                         "ingest_mesh_s": mesh_s, "ingest_lane_s": lane_s}
            phase(15, f"(b) {name} {tag} mesh_shape=1 (one NCCL rank, "
                      f"collectives in the CUDA graph): status="
                      f"{mesh.status} iter={mesh.iter} backend {ran} "
                      f"(forms kept {share['forms']}; autotune "
                      f"{probe_text(tune)}) "
                      f"Results.time={mesh.time:.4f}s (one card on {ran}: "
                      f"{lane.time:.4f}s, iter={lane.iter}) "
                      f"setup={mesh.setup_time:.3f}s (one card "
                      f"{lane.setup_time:.3f}s) tiled_spmv launches "
                      f"{counts['tiled_spmv']}, csr_spmv "
                      f"{counts['csr_spmv']}, {coll} {counts[coll]} "
                      f"({per_it:.3f} per iteration), tiled_half_epilogue "
                      f"{counts['tiled_half_epilogue']} (one card's fused "
                      f"tiled halves {lane_halves}); bitwise the one-card "
                      f"solve (iterations, objective, x): {same} [{card}]")
            phase(15, f"(f) {name} {tag}: the share ingest (rows "
                      f"{share['rows']}, columns {share['cols']}, "
                      f"{share['entries']} entries = 2 x {problem.nnz} nnz) "
                      f"ran {share['exchanges']} scaling exchanges; its "
                      f"stages (s) " + ", ".join(
                          f"{k} {v:.3f}" for k, v in mesh_s.items())
                  + "; the one-card ingest's " + ", ".join(
                      f"{k} {v:.3f}" for k, v in lane_s.items())
                  + f" [{card}]")
            check(same, f"phase 15 (b): {name} with mesh_shape=1 is not "
                  f"bitwise the one-card solve on {ran}")
            check(mesh.status == "OPTIMAL", f"phase 15 (b): {name} "
                  f"{mesh.status} {ran}")
            check((counts["tiled_spmv"] > 0) == tiles and counts[coll] > 0
                  and (counts["csr_spmv"] == 0) == tiles,
                  f"phase 15 (b): {name} on {ran} launched {counts}")
            check(not tiles or (
                counts["tiled_x_half"] == counts["tiled_y_half"] == 0
                and counts["tiled_half_epilogue"] == lane_halves > 0),
                f"phase 15 (b): {name} on the tiles launched "
                f"{counts['tiled_half_epilogue']} epilogues and the fused "
                f"halves {counts['tiled_x_half']} / "
                f"{counts['tiled_y_half']} times, one card "
                f"{lane_halves} fused halves")
            check(share["exchanges"] == 51 and share["entries"]
                  == 2 * problem.nnz, f"phase 15 (f): {name}: {share}")
        A, C, AL, AU, l, u = arrays
        bkw = dict(stop_tol=1e-4, verbose=False, time_limit=300)
        bmesh, counts = mesh_counts(lambda: hp.solve_batched(
            A, C, AL, AU, l, u, params=hp.Parameters(mesh_shape=1, **bkw)))
        add("f32", counts)
        bone = hp.solve_batched(A, C, AL, AU, l, u,
                                params=hp.Parameters(**bkw))
        bsame = (bmesh.status == bone.status
                 and np.array_equal(bmesh.iter, bone.iter)
                 and np.array_equal(bmesh.primal_obj, bone.primal_obj)
                 and np.array_equal(bmesh.x, bone.x))
        rec["batched_large"] = {"time_mesh": bmesh.time,
                                "time_single": bone.time,
                                "launches": counts, "bitwise": bsame}
        phase(15, f"(c) batched_large B={C.shape[1]} mesh_shape=1: "
                  f"{sum(st == 'OPTIMAL' for st in bmesh.status)}/"
                  f"{C.shape[1]} OPTIMAL, every member bitwise the "
                  f"single-device batched solve (status, iterations, "
                  f"objective, x): {bsame}; time {bmesh.time:.3f}s (single "
                  f"{bone.time:.3f}s); launches csr_spmm "
                  f"{counts['csr_spmm']}, spmm halves "
                  f"{counts['spmm_x_half']}/{counts['spmm_y_half']} "
                  f"[{card}]")
        check(bsame, "phase 15 (c): batched_large with mesh_shape=1 is not "
              "bitwise the single-device batched solve")
        rec["rows"] = row_mesh(card, prob4, prob6, add)
        rec["mixed"] = mixed_mesh(card, prob5, mesh_counts)
        rec["overlap"], counts = overlap_mesh(card)
        add("f32", counts)
        server_ref = hp.solve_problem(prob4, hp.Parameters(
            mesh_shape=1, **SERVER_MESH_PARAMS))
    finally:
        dist.destroy_process_group()

    rec["server"] = server_mesh(card, prob4, server_ref)

    t0 = time.perf_counter()
    cli = subprocess.run([sys.executable, "-m", "hprlp_tpu_torch.cli", "-i",
                          MODEL, "--mesh", "1", "--quiet"], cwd=HERE,
                         capture_output=True, text=True, timeout=300)
    wall = time.perf_counter() - t0
    line = [ln for ln in cli.stdout.splitlines()
            if ln.startswith("status=")]
    obj = float(line[0].split("obj=")[1].split()[0]) if line else None
    ups = [float(m.group(3)) for m in GROUP_UP.finditer(cli.stderr)]
    rec["cli"] = {"rc": cli.returncode, "obj": obj, "wall_s": wall,
                  "rank_start_s": ups}
    phase(15, f"(d) python -m hprlp_tpu_torch.cli -i data/model.mps --mesh 1 "
              f"--quiet: rc={cli.returncode} {line[0] if line else ''}; the "
              f"rank's group up {ups} s after its start (outside "
              f"Results.time), wall {wall:.2f}s [{card}]")
    check(cli.returncode == 0 and obj is not None
          and abs(obj + 26.4) <= 1e-3 * 26.4 and len(ups) == 1,
          f"phase 15 (d): rc {cli.returncode}, objective {obj}, stderr "
          f"{cli.stderr[-2000:]}")

    n_cards = torch.cuda.device_count()
    if n_cards >= 2:
        two = hp.solve_problem(prob6, hp.Parameters(
            mesh_shape=2, **params["sparse_huge"][2]))
        one = singles["sparse_huge"]
        rel = abs(two.primal_obj - one.primal_obj) / abs(one.primal_obj)
        rec["two_cards"] = {"status": two.status, "iter": two.iter,
                            "time": two.time, "rel_obj": rel,
                            "rank_start_s":
                                distributed.launch.record["start_s"]}
        phase(15, f"(e) sparse_huge on 2 cards (2 NCCL ranks): status="
                  f"{two.status} iter={two.iter} time={two.time:.4f}s "
                  f"objective rel diff {rel:.3e} against one card "
                  f"({one.status}, iter {one.iter}, {one.time:.4f}s) "
                  f"[{card}]")
        check(two.status == one.status and rel <= 1e-4,
              f"phase 15 (e): 2 cards {two.status} rel {rel}")
    else:
        rec["two_cards"] = None
        phase(15, f"(e) 2-card solve not run: this machine has {n_cards} "
                  f"card(s), and NCCL runs one rank per card [{card}]")
    rec["share_ingest"] = share_ingest_phase(card, {"sparse_huge": prob6,
                                                    "banded_giant": giant})
    rec["discard"] = discard_phase(card, giant)
    phase(15, f"took {time.perf_counter() - t_start:.1f} s [{card}]")
    return launches, rec


def mixed_mesh(card, prob5, counted):
    """Phase 15 (h), in the group: precision="mixed" on assignment64 at
    1e-8 with mesh_shape=1 (every f32 stage and the f64 tail a one-rank
    mesh solve on its own share ingest) and without a mesh: bitwise
    (iterations, objective, x)."""
    import hprlp_tpu_torch as hp

    kw = dict(stop_tol=1e-8, verbose=False, use_presolve=False,
              precision="mixed", time_limit=300.0)
    mesh, counts = counted(lambda: hp.solve_problem(
        prob5, hp.Parameters(mesh_shape=1, **kw)))
    one = hp.solve_problem(prob5, hp.Parameters(**kw))
    same = same_point(mesh, one)
    kkt = prob5.kkt_error(mesh.x, mesh.y, mesh.z)["kkt"]
    rec = {"status": mesh.status, "iter": mesh.iter, "time_mesh": mesh.time,
           "time_one": one.time, "kkt_f64": kkt, "bitwise": same,
           "launches": counts}
    phase(15, f"(h) assignment64 precision=\"mixed\" mesh_shape=1: "
              f"status={mesh.status} iter={mesh.iter} Results.time="
              f"{mesh.time:.4f}s (one card: {one.status}, iter {one.iter}, "
              f"{one.time:.4f}s), host f64 KKT {kkt:.3e}; tiled_spmv "
              f"launches {counts['tiled_spmv']}, all-reduces "
              f"{counts['all_reduce_sum']}; bitwise the one-card \"mixed\" "
              f"solve (iterations, objective, x): {same} [{card}]")
    check(same and mesh.status == "OPTIMAL" and kkt < 1e-8,
          f"phase 15 (h): {rec}")
    return rec


# Phase 15 (j)'s LP: random_lp at twice sparse_huge's size (21.0M nnz), so
# that the ingest beside presolve outweighs the fixed costs that follow it.
OVERLAP_ARGS = (524288, 1048576, 40, 7)


def overlap_mesh(card):
    """Phase 15 (j), in the group: Model.solve of random_lp(*OVERLAP_ARGS)
    with mesh_shape=1 and loop.GIANT_LANE_FIRST_NNZ swapped to 1, so rank
    0's presolve runs beside the share ingest: one presolve, its wall
    below presolve + ingest, bitwise the one-card Model.solve's overlap
    (the same threshold, run first); each run's seconds after presolve
    (power method, capture, solve, broadcasts).  Returns (record,
    launches of the mesh run)."""
    import hprlp_tpu_torch as hp
    from hprlp_tpu_torch import model, presolve
    from hprlp_tpu_torch.solver import loop

    problem = random_lp(*OVERLAP_ARGS)
    kw = dict(stop_tol=1e-4, verbose=False, max_iter=50_000)
    runs = {}
    with swapped(loop, GIANT_LANE_FIRST_NNZ=1):
        for name, extra in (("one", {}), ("mesh", {"mesh_shape": 1})):
            calls = []
            with recorded(calls, [(loop, "build_ingest"),
                                  (presolve, "presolve_problem")]):
                t0 = time.perf_counter()
                res, counts = mesh_counts(lambda: hp.Model(problem).solve(
                    hp.Parameters(**kw, **extra)))
                wall = time.perf_counter() - t0
            ingests = [c for c in calls if c[0] == "build_ingest"]
            runs[name] = {"res": res, "wall": wall, "counts": counts,
                          "presolves": sum(c[0] == "presolve_problem"
                                           for c in calls),
                          "ingests": len(ingests),
                          "ingest_s": ingests[0][1],
                          "capture_s": loop.solve_problem.capture_time,
                          "record": dict(model.solve_with_presolve.record)}
    mesh, one = runs["mesh"], runs["one"]
    m, o = mesh["res"], one["res"]
    same = same_point(m, o)
    rec = {k: {"status": r["res"].status, "iter": r["res"].iter,
               "presolve_s": r["res"].presolve_time, "ingest_s":
               r["ingest_s"], "ingests": r["ingests"],
               "presolves": r["presolves"], "wall_s": r["wall"],
               "power_s": r["res"].power_time, "capture_s": r["capture_s"],
               "solve_s": r["res"].time, "record": r["record"]}
           for k, r in runs.items()}
    rec["bitwise"] = same
    rec["nnz"] = problem.nnz

    def after(k):
        r = rec[k]
        return (f"power {r['power_s']:.3f}s, capture {r['capture_s']:.3f}s,"
                f" solve {r['solve_s']:.3f}s")

    phase(15, f"(j) random_lp{OVERLAP_ARGS} ({problem.nnz} nnz) "
              f"Model.solve mesh_shape=1, giant threshold lowered: "
              f"status={m.status} iter={m.iter}; presolve "
              f"{m.presolve_time:.3f}s ({mesh['presolves']} call, on rank "
              f"0) beside the share ingest {mesh['ingest_s']:.3f}s, "
              f"{mesh['ingests']} ingest(s); wall {mesh['wall']:.3f}s "
              f"against presolve + ingest "
              f"{m.presolve_time + mesh['ingest_s']:.3f}s; after presolve "
              f"{after('mesh')}, broadcasts "
              f"{mesh['record']['broadcast_bytes']} B in "
              f"{mesh['record']['broadcast_s']:.4f}s; one card: wall "
              f"{one['wall']:.3f}s, presolve {o.presolve_time:.3f}s, "
              f"ingest {one['ingest_s']:.3f}s, {after('one')}; bitwise the "
              f"one-card overlap (iterations, objective, x): {same} "
              f"[{card}]")
    check(same and m.status == "OPTIMAL" and mesh["presolves"] == 1
          and mesh["ingests"] == one["ingests"], f"phase 15 (j): {rec}")
    check(mesh["wall"] < m.presolve_time + mesh["ingest_s"],
          f"phase 15 (j): Model.solve took {mesh['wall']} s, no less than "
          f"presolve + ingest: no overlap")
    return rec, mesh["counts"]


# Phase 15 (i)'s request: sparse_large with mesh_shape=1.
SERVER_MESH_PARAMS = {"stop_tol": 1e-4, "verbose": False,
                      "use_presolve": False, "max_iter": 100_000}


def server_mesh(card, prob4, ref):
    """Phase 15 (i): `python -m hprlp_tpu_torch.server` on the default
    device answers a `solve` request of sparse_large with mesh_shape=1 by
    launching one rank; the answer bitwise `ref`, the in-process mesh
    solve (iterations, objective, x); the server's stderr line with the
    rank's start seconds."""
    req = solve_request(prob4, {"mesh_shape": 1, **SERVER_MESH_PARAMS})
    with tempfile.TemporaryFile() as err:
        t0 = time.perf_counter()
        proc = subprocess.Popen([sys.executable, "-m",
                                 "hprlp_tpu_torch.server"], cwd=HERE,
                                stdin=subprocess.PIPE,
                                stdout=subprocess.PIPE, stderr=err,
                                text=True)
        try:
            proc.stdin.write(json.dumps(req) + "\n")
            proc.stdin.flush()
            resp = json.loads(proc.stdout.readline())
            wall = time.perf_counter() - t0
            proc.stdin.write(json.dumps({"op": "shutdown"}) + "\n")
            proc.stdin.flush()
            proc.stdout.readline()
            rc = proc.wait(timeout=120)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        err.seek(0)
        stderr = err.read().decode(errors="replace")
    check(resp.get("ok"), f"phase 15 (i): {resp}; stderr {stderr[-2000:]}")
    got = resp["result"]
    x = _dec(got["x"])
    same = (got["iter"] == ref.iter and got["primal_obj"] == ref.primal_obj
            and np.array_equal(x, ref.x))
    line = [ln for ln in stderr.splitlines() if ln.startswith("mesh of ")]
    rec = {"status": got["status"], "iter": got["iter"], "rc": rc,
           "wall_s": wall, "bitwise": same, "line": line[0] if line
           else None}
    phase(15, f"(i) server `solve` request, sparse_large mesh_shape=1: "
              f"status={got['status']} iter={got['iter']} time="
              f"{got['time']:.4f}s; client wall {wall:.2f}s (server start, "
              f"one launched rank, ingest, solve); {rec['line']}; bitwise "
              f"the in-process mesh solve (iterations, objective, x): "
              f"{same}; server exit {rc} [{card}]")
    check(same and rc == 0 and line, f"phase 15 (i): {rec}")
    return rec


def share_ingest_phase(card, problems):
    """Phase 15 (g): each rank's device peak and resident bytes through
    the share ingest (f32) of each of `problems` at N = 2 and 4, as gloo
    ranks sharing cuda:0 (prof/share_ingest.py::ingest_peak: NCCL refuses
    two ranks on one card), beside the one-card ingest's peak (phase
    14).  A failed launch fails the phase."""
    from hprlp_tpu_torch.prof.share_ingest import ingest_peak

    rec = {}
    for name, problem in problems.items():
        for N in MESH_SLICES:
            t0 = time.perf_counter()
            ranks = ingest_peak(problem, N, {"precision": "f32"})
            wall = time.perf_counter() - t0
            rec[f"{name}_N{N}"] = {"ranks": ranks, "wall_s": wall}
            phase(15, f"(g) {name} ({problem.nnz} nnz) share ingest on {N} "
                      f"gloo ranks sharing the card, f32: " + "; ".join(
                          f"rank {r['rank']} ({r['entries']} entries): peak "
                          f"{r['peak_bytes'] / GIB:.3f} GiB "
                          f"({r['peak_bytes'] / problem.nnz:.1f} B per nnz "
                          f"of the LP), resident "
                          f"{r['resident_bytes'] / GIB:.3f} GiB, "
                          f"{r['exchanges']} exchanges, stages (s) "
                          + ", ".join(f"{k} {v:.2f}"
                                      for k, v in r["seconds"].items())
                          + f", host RSS (sampled) "
                            f"{r['rss_start_bytes'] / GIB:.2f} GiB at its "
                            f"start, peak {r['rss_peak_bytes'] / GIB:.2f}"
                          for r in ranks)
                  + f"; launch wall {wall:.1f}s [{card}]")
            check(all(r["exchanges"] == 51 for r in ranks),
                  f"phase 15 (g): {name} N={N} exchanges")
    return rec


# Phase 15 (k)'s ranks and the broadcasts' names, in the order they cross.
DISCARD_RANKS = 2
DISCARD_BROADCASTS = ("decision", "reduced LP", "postsolved point")


def discard_phase(card, giant):
    """Phase 15 (k): Model.solve's discard branch of the banded giant on
    DISCARD_RANKS gloo ranks sharing cuda:0 (prof/share_ingest.py::
    discard_broadcast): rank 0 presolves beside every rank's share
    ingest, the ingest is dropped, then the reduced LP crosses (the
    giant's presolve removes no nnz, so model.REINGEST_SHARE is set below
    zero for the part), then the postsolved point of a zero reduced
    solution.  Each broadcast's bytes and seconds, the device bytes held
    at its start and its peak above them, each rank's host RSS through
    it (sampled)."""
    from hprlp_tpu_torch.prof.share_ingest import discard_broadcast

    t0 = time.perf_counter()
    ranks = discard_broadcast(giant, DISCARD_RANKS,
                              {"precision": "f32", "stop_tol": 1e-4,
                               "verbose": False})
    wall = time.perf_counter() - t0
    rec = {"ranks": ranks, "wall_s": wall}
    for r in ranks:
        phase(15, f"(k) banded_giant discard branch, rank {r['rank']} of "
                  f"{r['world']} (gloo, sharing the card; presolved: "
                  f"{r['presolved']}, presolve {r['presolve_s']:.3f}s): "
                  + "; ".join(
                      f"{what} {b['bytes']} B in {b['seconds']:.3f}s, "
                      f"device {b['held_bytes'] / GIB:.3f} GiB held at its "
                      f"start, peak {b['peak_bytes'] / GIB:.3f} GiB above "
                      f"it, host RSS (sampled) "
                      f"{b['rss_start_bytes'] / GIB:.2f} -> "
                      f"{b['rss_peak_bytes'] / GIB:.2f} GiB"
                      for what, b in zip(DISCARD_BROADCASTS,
                                         r["broadcasts"]))
                  + f"; entering the reduced solve "
                    f"({r['reduced_solve']['nnz']} nnz): device "
                    f"{r['reduced_solve']['held_bytes'] / GIB:.3f} GiB "
                    f"held, host RSS "
                    f"{r['reduced_solve']['rss_bytes'] / GIB:.2f} GiB; "
                    f"{r['wall_s']:.1f}s in Model.solve [{card}]")
    phase(15, f"(k) launch wall {wall:.1f}s [{card}]")
    sizes = [[b["bytes"] for b in r["broadcasts"]] for r in ranks]
    check([r["presolved"] for r in ranks] == [True] + [False] * (
        DISCARD_RANKS - 1) and all(s == sizes[0] for s in sizes)
          and len(sizes[0]) == len(DISCARD_BROADCASTS)
          and 0 < ranks[0]["reduced_solve"]["nnz"] <= giant.nnz
          and sizes[0][1] >= 12 * ranks[0]["reduced_solve"]["nnz"]
          and all(r["reduced_solve"] | {"held_bytes": 0, "rss_bytes": 0}
                  == ranks[0]["reduced_solve"] | {"held_bytes": 0,
                                                  "rss_bytes": 0}
                  for r in ranks),
          f"phase 15 (k): {[dict(r, broadcasts=None) for r in ranks]}, "
          f"broadcast bytes {sizes}")
    return rec


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    import hprlp_tpu_torch
    from hprlp_tpu_torch import Parameters, native
    from hprlp_tpu_torch.ops import spmm as spmm_mod
    from hprlp_tpu_torch.ops import spmv as spmv_mod

    pkg_dir = os.path.dirname(os.path.abspath(hprlp_tpu_torch.__file__))
    check(os.path.dirname(pkg_dir) == HERE,
          f"hprlp_tpu_torch imported from {pkg_dir}, not this checkout")
    check("jax" not in sys.modules and "hprlp_tpu" not in sys.modules,
          "the port imported JAX")

    card = toolchain()

    built = build_kernels()
    for src in (spmv_mod.TILED_SOURCE, spmv_mod.SOURCE,
                spmv_mod.ROWGROUP_SOURCE):
        lib, secs, log = built[src]
        phase(2, f"built {os.path.relpath(lib, HERE)} in {secs:.2f} s")
    for src in (spmv_mod.TILED_SOURCE, spmv_mod.SOURCE):
        for line in ptxas_summary(built[src][2]):
            phase(2, f"ptxas {line}")
    lib, secs, _ = built[native.LIB_PATH]
    phase(2, f"built {os.path.relpath(lib, HERE)} (host: presolve, MPS "
             f"reader; g++) in {secs:.2f} s")

    prob4 = random_lp(65536, 131072, 20, seed=2)
    prob6 = random_lp(262144, 524288, 40, seed=4)
    row_sums = repair_checks(card, prob4)
    rec = kernel_check(card, {"bench": prob4, "huge": prob6})
    for mat in ("A", "AT"):
        r = rec["huge", "f32", mat]
        check(r["ms"] < r["csr_ms"], f"phase 3: the tiled kernel "
              f"({r['ms']} ms) is not faster than the CSR kernel "
              f"({r['csr_ms']} ms) at sparse_huge {mat} f32")

    params4 = Parameters(stop_tol=1e-4, verbose=False, max_iter=100_000)
    res4, kkt4, l4, s4, _ = run_solve(4, prob4, params4, card)
    check(kkt4 < 1e-3, f"phase 4: host f64 KKT {kkt4}")
    again, _, _, _, _ = run_solve(4, prob4, params4, card)
    phase(0, f"phase 4's f32 solve run twice: iterations {res4.iter} and "
             f"{again.iter}, objectives {res4.primal_obj!r} and "
             f"{again.primal_obj!r}, backends {res4.spmv_backend} and "
             f"{again.spmv_backend} [{card}]")
    check(again.iter == res4.iter and again.primal_obj == res4.primal_obj
          and again.spmv_backend == res4.spmv_backend,
          "phase 0: phase 4's f32 solve is not bitwise repeatable")
    memory_rec = memory_check(card, prob4)
    chunk4 = chunk_profile(4, prob4, torch.float32, res4.spmv_backend, card)

    prob5 = assignment_problem(64)
    res5, _, l5, s5, _ = run_solve(5, prob5, Parameters(
        stop_tol=1e-8, verbose=False, max_iter=100_000), card)
    from scipy.optimize import linear_sum_assignment

    cost = prob5.c.reshape(64, 64)
    r, c = linear_sum_assignment(cost)
    exact = float(cost[r, c].sum())
    rel = abs(res5.primal_obj - exact) / abs(exact)
    phase(5, f"linear_sum_assignment={exact:.10e} rel_err={rel:.3e}")
    check(rel < 1e-6, f"phase 5: objective off by {rel}")

    res6, kkt6, l6, s6, peak6 = run_solve(
        6, prob6, Parameters(stop_tol=1e-4, verbose=False, max_iter=50_000),
        card, peak=True)
    check(kkt6 < 1e-3, f"phase 6: host f64 KKT {kkt6}")
    chunk6 = chunk_profile(6, prob6, torch.float32, res6.spmv_backend, card)

    variant_records = variants_phase(card, built, prob6)

    l8, s8, mps_record = mps_phase(card, MPS_SCALE)

    for src in (spmm_mod.SOURCE, spmm_mod.ROWWISE_SOURCE):
        lib, secs, _ = built[src]
        phase(9, f"built {os.path.relpath(lib, HERE)} in {secs:.2f} s")
    for line in ptxas_summary(built[spmm_mod.SOURCE][2]):
        phase(9, f"ptxas {line}")
    spmm_rec = spmm_check(card, prob4)
    l9, batched_record = batched_phase(card, row_sums)
    l9_tiled = l9["tiled_spmv"]
    fused_rec = fused_phase(card)
    graph_rec = graph_phase(card, prob4, prob5, peak6)
    # One launch a tiled product and a fused half at any G: the single-LP
    # iteration's kernels on the tiles (sparse_huge: phase 6's chunk).
    per_it = {"sparse_large_f32": graph_rec["sparse_large_f32"]["profile"][
        "kernels"]}
    if res6.spmv_backend == "tiled":
        per_it["sparse_huge_f32"] = chunk6["kernels"]
    graph_rec["kernels_per_it"] = per_it
    phase(10, f"kernels/it on the tiles (one launch a product and a fused "
              f"half at any G; 6.9 with a group-sum pass at G > 1): "
              f"{per_it} [{card}]")
    check(all(v <= KERNELS_PER_IT for v in per_it.values()),
          f"phase 10: kernels/it {per_it} above {KERNELS_PER_IT}")
    single_fused = fused_spmv_phase(card, prob4)
    tiled_rec = tiled_halves_phase(card, {"sparse_large": prob4,
                                          "sparse_huge": prob6})
    csr11, autotune_rec = autotune_phase(card, prob4)
    t_service = time.perf_counter()
    server_rec, l12a, iters12 = server_pipes(
        card, prob4, [built[spmv_mod.TILED_SOURCE][0],
                      built[spmm_mod.SOURCE][0], native.LIB_PATH])
    capi_rec, l12b = capi_phase(card, prob4, iters12)
    mixed_rec, l13 = mixed_phase(card, prob4)
    phase(13, f"phases 12 and 13 took {time.perf_counter() - t_service:.1f}"
              f" s [{card}]")
    t_giant = time.perf_counter()
    l14, s14, giant_shapes, giant_rec, giant = giant_phase(card, prob6)
    giant_rec["tuned"] = malloc_phase(card, giant_rec)
    phase(14, f"took {time.perf_counter() - t_giant:.1f} s [{card}]")
    l15, mesh_rec = mesh_phase(card, prob6, prob5, prob4, giant)
    del giant
    # Phase 12's workers by the precision they solved in: the server and
    # the ctypes consumer f32 (1e-4), the C examples f64 (f64 or 1e-6).
    w32 = [l12a, l12b["ctypes"]]
    w64 = [l12b[name] for name, _ in EXAMPLES]

    def worker_sum(workers, kernel):
        return sum(w[kernel] for w in workers)

    p12 = {k: worker_sum(w32 + w64, k) for k in (
        "csr_spmv", "csr_spmm", "spmm_x_half", "spmm_y_half",
        "spmm_y_half_previous")}
    # Each phase's SpMV launches, by the backend each solve ran.
    by_phase = {"4": l4, "5": l5, "6": l6, "8": l8}

    def shapes(tag, keys):
        return {f"{size}_{mat}": {k: rec[size, tag, mat][k] for k in keys}
                for size in ("bench", "huge") for mat in ("A", "AT")}

    kernels = []
    for tag, launches, replaces, also in (
            ("f32", l4["tiled"] + l6["tiled"] + l8["tiled"] + l9_tiled
             + worker_sum(w32, "tiled_spmv") + l13["f32"]["tiled"]
             + l14["tiled"] + l15["f32"]["tiled_spmv"],
             "hprlp_tpu/ops/pallas_spmv.py:67",
             "thin_spmv hprlp_tpu/ops/pallas_spmv.py:272"),
            ("f64", l5["tiled"] + worker_sum(w64, "tiled_spmv")
             + l13["f64"]["tiled"] + l15["f64"]["tiled_spmv"],
             "hprlp_tpu/ops/pallas_spmv.py:178",
             "thin_spmv_df64 hprlp_tpu/ops/pallas_spmv.py:394")):
        a = rec["bench", tag, "A"]
        kernels.append({
            "name": f"spmv_tiled_{tag}", "route": "cuda",
            "source": os.path.relpath(spmv_mod.TILED_SOURCE, HERE),
            "replaces": replaces, "also_replaces": also,
            "stage": spmv_mod.MAIN_STAGE, "launches": launches,
            "max_abs_err": max(r["err"] for (_, t, _), r in rec.items()
                               if t == tag),
            "ms": a["ms"], "plain_ms": a["plain_ms"],
            "bound_ms": a["bound_ms"], "bound_by": a["bound_by"],
            "library_ms": a["library_ms"],
            "shapes": shapes(tag, ("nnz", "ms", "plain_ms", "bound_ms",
                                   "library_ms", "csr_ms", "tiles_s",
                                   "stages"))})
    # The previous design of the tiles (stage block_x: each strip group's
    # partial y through HBM, then group_sum_kernel), timed beside the main
    # stage in phases 3 and 10 (c); its group-sum pass's and fused halves'
    # launches by the solves of each phase, which must all be 0.
    def previous_by_phase(tag, key, counted):
        """A previous design's launches by the solves of each phase: key
        in SPMV_COUNTERS, counted its name in solver/graph.py::COUNTED."""
        out = {k: v.get(key, 0) for k, v in by_phase.items()
               if (k == "5") == (tag == "f64")}
        out["11"] = csr11[tag][key]
        out["13"] = l13[tag].get(key, 0)
        if tag == "f32":
            out["14"] = l14.get(key, 0)
        out["15"] = l15[tag].get(counted, 0)
        return out

    for tag, replaces in (("f32", "hprlp_tpu/ops/pallas_spmv.py:67"),
                          ("f64", "hprlp_tpu/ops/pallas_spmv.py:178")):
        a = rec["bench", tag, "A"]
        per_phase = previous_by_phase(tag, "group_sum", "group_sum_kernel")
        check(not any(per_phase.values()), f"a solve launched the group-sum "
              f"pass ({tag}): {per_phase}")
        kernels.append({
            "name": f"spmv_tiled_block_x_{tag}", "route": "cuda",
            "source": os.path.relpath(spmv_mod.TILED_SOURCE, HERE),
            "replaces": replaces, "stage": "block_x",
            "previous_design": "the tiles' route before the strip groups "
                               "became one cluster: each strip group's "
                               "partial y through HBM, then group_sum_kernel "
                               "(a second launch at G > 1); the main stage's "
                               "bitwise yardstick, timed in phases 3 and 10 "
                               "(c), launched by no solve",
            "launches": sum(per_phase.values()),
            "launches_by_phase": per_phase,
            "max_abs_err": max(r["err"] for (_, t, _), r in rec.items()
                               if t == tag),
            "ms": a["stages"]["block_x"], "plain_ms": a["plain_ms"],
            "bound_ms": a["bound_ms"], "bound_by": a["bound_by"],
            "library_ms": a["library_ms"],
            "uncut_ms": a["stages"]["block_x_uncut"],
            "shapes": {k: {"ms": v["stages"]["block_x"],
                           "uncut_ms": v["stages"]["block_x_uncut"]}
                       for k, v in shapes(tag, ("stages",)).items()}})
    # The CSR kernel's launches by phase and dtype: phases 4-6 and 8 where
    # the autotune chose it, 11's solves and CLI run, 12's workers, 13's
    # stages, 15's mesh solves on the row shards; its fused halves'
    # likewise.
    def gather_by_phase(tag, key, worker_key):
        out = {k: v[key] for k, v in by_phase.items()
               if (k == "5") == (tag == "f64")}
        out["11"] = csr11[tag][key]
        out["12"] = worker_sum(w32 if tag == "f32" else w64, worker_key)
        out["13"] = l13[tag][key]
        out["15"] = l15[tag].get(worker_key, 0)
        return out

    for tag, replaces, also in (
            ("f32", "hprlp_tpu/ops/pallas_spmv.py:67",
             "thin_spmv hprlp_tpu/ops/pallas_spmv.py:272"),
            ("f64", "hprlp_tpu/ops/pallas_spmv.py:178",
             "thin_spmv_df64 hprlp_tpu/ops/pallas_spmv.py:394")):
        a = rec["bench", tag, "A"]
        per_phase = gather_by_phase(tag, "gather", "csr_spmv")
        kernels.append({
            "name": f"csr_spmv_{tag}", "route": "cuda",
            "source": os.path.relpath(spmv_mod.SOURCE, HERE),
            "replaces": replaces, "also_replaces": also,
            "note": "the \"gather\" backend on its row-block plan: the "
                    "autotune's candidate and the --cusparse-spmv true "
                    "backend; plain_ms: csr_spmv_plain (the kernel's bits "
                    "in plain PyTorch, eager)",
            "launches": sum(per_phase.values()),
            "launches_by_phase": per_phase,
            "max_abs_err": max(r["err_csr"] for (_, t, _), r in rec.items()
                               if t == tag),
            "ms": a["csr_ms"], "plain_ms": a["csr_plain_ms"],
            "bound_ms": a["bound_ms"], "bound_by": a["bound_by"],
            "library_ms": a["library_ms"],
            "shapes": shapes(tag, ("csr_ms", "csr_plain_ms", "reference_ms",
                                   "rowgroup_ms", "no_gather_ms",
                                   "bound_ms", "library_ms",
                                   "plan_blocks", "blocks_bytes",
                                   "blocks_s"))})
    for tag in ("f32", "f64"):
        a = rec["bench", tag, "A"]
        kernels.append({
            "name": f"csr_spmv_rowgroup_{tag}", "route": "cuda",
            "source": os.path.relpath(spmv_mod.ROWGROUP_SOURCE, HERE),
            "replaces": "hprlp_tpu/ops/pallas_spmv.py:"
                        + ("67" if tag == "f32" else "178"),
            "previous_design": "the first CSR kernel (a group of threads per "
                               "row), succeeded by csr_spmv; timed in phase "
                               "3 only, launched by no solve",
            "launches": sum(l.get("rowgroup", 0) for l in (l4, l5, l6, l8)),
            "max_abs_err": max(r["err_rowgroup"]
                               for (_, t, _), r in rec.items() if t == tag),
            "ms": a["rowgroup_ms"], "plain_ms": a["reference_ms"],
            "bound_ms": a["bound_ms"], "bound_by": a["bound_by"],
            "library_ms": a["library_ms"],
            "shapes": shapes(tag, ("rowgroup_ms", "bound_ms",
                                   "library_ms"))})
    for half, matrix, line in (("x", "A^T", "x_update :89"),
                               ("y", "A", "y_update :99")):
        r32, r64 = single_fused["f32"][half], single_fused["f64"][half]
        per_phase = {t: gather_by_phase(t, f"{half}_half",
                                        f"spmv_{half}_half")
                     for t in ("f32", "f64")}
        kernels.append({
            "name": f"spmv_{half}_half", "route": "cuda",
            "source": os.path.relpath(spmv_mod.SOURCE, HERE),
            "replaces": "hprlp_tpu/solver/chunk.py:" + (
                "72" if half == "x" else "81"),
            "note": f"the single-LP middle iteration's {half}-half fused "
                    f"into the CSR kernel over {matrix}'s rows "
                    f"(csr_spmv_half_kernel, each row's operands read "
                    f"before the stream; plain: "
                    f"hprlp_tpu_torch/solver/chunk.py {line}); no Pallas "
                    f"kernel in the JAX package (XLA fuses it); "
                    f"sparse_large f32, plain_ms the kernel's store and "
                    f"the plain ops by graph replay; launches where a "
                    f"solve ran on \"gather\"",
            "launches": sum(sum(v.values()) for v in per_phase.values()),
            "launches_by_phase": per_phase,
            "max_abs_err": max(r["max_abs_err"]
                               for r in single_fused.values()),
            "ms": r32["ms"], "plain_ms": r32["plain_ms"],
            "bound_ms": r32["bound_ms"], "bound_by": r32["bound_by"],
            "library_ms": None, "f64": r64,
            "assignment128_f32": single_fused["assignment128_f32"][half]})
    kernels[-1]["chunks"] = {t: {k: v for k, v in r.items()
                                 if k not in ("x", "y")}
                             for t, r in single_fused.items()
                             if t in ("f32", "f64")}

    def tiled_by_phase(tag, key, i):
        """A tiled half's launches by phase: the solves' (gather_by_phase),
        phase 10 (c)'s chunks and phase 14's solves."""
        out = gather_by_phase(tag, key, key)
        out["10"] = sum(r["chunk_launches"][i] for c, r in tiled_rec.items()
                        if f"_{tag}_" in c)
        if tag == "f32":
            out["14"] = l14[key]
        return out

    head = tiled_rec["sparse_large_f32_default"]
    for i, (half, matrix, line) in enumerate((("x", "A^T", "x_update :89"),
                                              ("y", "A", "y_update :99"))):
        key = f"tiled_{half}_half"
        prev_phase = {t: previous_by_phase(t, f"{half}_half_block_x",
                                           f"{key}_block_x")
                      for t in ("f32", "f64")}
        check(not any(n for v in prev_phase.values() for n in v.values()),
              f"a solve launched the {half}-half on block_x: {prev_phase}")
        per_phase = {t: tiled_by_phase(t, key, i) for t in ("f32", "f64")}
        kernels.append({
            "name": key, "route": "cuda",
            "source": os.path.relpath(spmv_mod.TILED_SOURCE, HERE),
            "replaces": "hprlp_tpu/solver/chunk.py:" + (
                "72" if half == "x" else "81"),
            "note": f"the single-LP middle iteration's {half}-half fused "
                    f"into the tiled SpMV over {matrix}'s rows (plain: "
                    f"hprlp_tpu_torch/solver/chunk.py {line}); no Pallas "
                    f"kernel in the JAX package (XLA fuses it); headline "
                    f"sparse_large f32 on the default tiles, plain_ms the "
                    f"kernel's store and the plain ops by graph replay; "
                    f"cells: phase 10 (c)",
            "launches": sum(sum(v.values()) for v in per_phase.values()),
            "launches_by_phase": per_phase,
            "max_abs_err": max(r["max_abs_err"] for r in tiled_rec.values()),
            "ms": head[half]["ms"], "plain_ms": head[half]["plain_ms"],
            "bound_ms": head[half]["bound_ms"],
            "bound_by": head[half]["bound_by"], "library_ms": None,
            "stage": spmv_mod.MAIN_STAGE,
            "cells": {c: dict(r[half], groups=r["groups"])
                      for c, r in tiled_rec.items()}})
        kernels.append({
            "name": f"{key}_block_x", "route": "cuda",
            "source": os.path.relpath(spmv_mod.TILED_SOURCE, HERE),
            "replaces": kernels[-1]["replaces"], "stage": "block_x",
            "previous_design": f"the {half}-half on the tiles before the "
                               f"strip groups became one cluster: in the "
                               f"kernel at G = 1, in group_sum_kernel after "
                               f"the partials at G > 1; timed in phase 10 "
                               f"(c), launched by no solve",
            "launches": sum(sum(v.values()) for v in prev_phase.values()),
            "launches_by_phase": prev_phase,
            "measurement_calls": {
                "note": "phase 10 (c)'s calls on block_x by the wrapper's "
                        "count (eager calls, and the timing graphs' "
                        "warm-ups and captures; replays uncounted), "
                        "outside any solve",
                "cells": {c: r["block_x_calls"][i]
                          for c, r in tiled_rec.items()}},
            "max_abs_err": kernels[-1]["max_abs_err"],
            "ms": head[half]["block_x_ms"],
            "plain_ms": head[half]["plain_ms"],
            "bound_ms": head[half]["bound_ms"],
            "bound_by": head[half]["bound_by"], "library_ms": None,
            "uncut_ms": head[half]["block_x_uncut_ms"],
            "cells": {c: {k: r[half][k] for k in (
                "block_x_ms", "block_x_uncut_ms", "uncut_shape")}
                      for c, r in tiled_rec.items()}})
    kernels[-2]["chunks"] = {c: {k: v for k, v in r.items()
                                 if k not in ("x", "y", "epilogue_x",
                                              "epilogue_y")}
                             for c, r in tiled_rec.items()}  # tiled_y_half
    epi = {c: {h: r[f"epilogue_{h}"] for h in ("x", "y")}
           for c, r in tiled_rec.items() if "epilogue_x" in r}
    epi_head = epi["sparse_huge_f32_default"]["x"]
    epi_by_phase = {t: {"15": l15[t].get("tiled_half_epilogue", 0)}
                    for t in ("f32", "f64")}
    kernels.append({
        "name": "tiled_half_epilogue", "route": "cuda",
        "source": os.path.relpath(spmv_mod.TILED_SOURCE, HERE),
        "replaces": "hprlp_tpu/solver/chunk.py:72",
        "also_replaces": "hprlp_tpu/solver/chunk.py:81",
        "note": "a column-sharded mesh's middle-iteration half after the "
                "all-reduce of the partial products: half_epilogue_kernel "
                "(group_sum_kernel's pass at G = 1 with the half's update); "
                "headline the x-half at sparse_huge f32's n rows with its "
                "inputs out of L2 (rotated copies), plain_ms solver/"
                "chunk.py::x_update timed so; launches: phase 15's mesh "
                "solves on the tiles",
        "launches": sum(v["15"] for v in epi_by_phase.values()),
        "launches_by_phase": epi_by_phase,
        "max_abs_err": max(r[h]["max_abs_err"] for r in epi.values()
                           for h in r),
        "ms": epi_head["ms"], "plain_ms": epi_head["plain_ms"],
        "bound_ms": epi_head["bound_ms"], "bound_by": epi_head["bound_by"],
        "library_ms": None, "cells": epi})
    kernels[0]["launches_by_phase"] = {
        "4": l4["tiled"], "6": l6["tiled"], "8": l8["tiled"], "9": l9_tiled,
        "12": worker_sum(w32, "tiled_spmv"), "13": l13["f32"]["tiled"],
        "14": l14["tiled"], "15": l15["f32"]["tiled_spmv"]}
    kernels[0]["shapes"].update(giant_shapes)
    kernels[0]["giant"] = giant_rec
    kernels[0]["mesh"] = mesh_rec
    kernels[1]["launches_by_phase"] = {
        "5": l5["tiled"], "12": worker_sum(w64, "tiled_spmv"),
        "13": l13["f64"]["tiled"], "15": l15["f64"]["tiled_spmv"]}
    kernels[0]["mps_presolve"] = mps_record
    kernels[0]["graphs"] = graph_rec
    kernels[0]["server"] = server_rec
    kernels[0]["capi"] = capi_rec
    kernels[0]["mixed"] = mixed_rec
    csr32 = next(k for k in kernels if k["name"] == "csr_spmv_f32")
    csr32["autotune"] = autotune_rec
    csr32["memory"] = memory_rec
    csr32["chunks_picked"] = {"4": chunk4, "6": chunk6}
    kernels += variant_records
    head = spmm_rec["f32", "A", 64]
    spmm_common = {
        "route": "cuda", "source": os.path.relpath(spmm_mod.SOURCE, HERE),
        "replaces": "hprlp_tpu/ops/sparse.py:594",
        "max_abs_err": max(r["max_abs_err"] for r in spmm_rec.values()),
        "max_err_rel_abs_ax": max(r["err"] for r in spmm_rec.values()),
        "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"],
        "bound_by": head["bound_by"], "library_ms": head["library_ms"]}
    spmm_by_phase = {"4": s4, "5": s5, "6": s6, "8": s8, "9": l9["csr_spmm"],
                     "12": p12["csr_spmm"], "13": l13["csr_spmm"],
                     "14": s14, "15": sum(l15[t]["csr_spmm"]
                                          for t in ("f32", "f64"))}
    kernels.append({
        "name": "csr_spmm", **spmm_common,
        "note": "no Pallas kernel in the JAX package: spmm is an XLA "
                "gather einsum; headline shape f32 A B=64; phases 4-8 "
                "launch it for the scaling's row sums (B=1)",
        "launches": sum(spmm_by_phase.values()),
        "launches_by_phase": spmm_by_phase,
        "ms": head["ms"],
        "shapes": {f"{tag}_{mat}_B{b}": {k: r[k] for k in (
            "nnz", "ms", "prev_ms", "uncapped_ms", "plain_ms", "library_ms",
            "bound_ms", "err", "plan", "prev_plan", "gather_bytes", "l2_tbs",
            "prev_l2_tbs")}
            for (tag, mat, b), r in spmm_rec.items()},
        "batched": batched_record})
    kernels.append({
        "name": "csr_spmm_rowwise", **spmm_common,
        "source": os.path.relpath(spmm_mod.ROWWISE_SOURCE, HERE),
        "previous_design": "succeeded in the solver by csr_spmm; timed in "
                           "phase 9 (a) only",
        "launches": l9["csr_spmm_rowwise"], "ms": head["prev_ms"]})
    for half, matrix in (("x", "A^T"), ("y", "A")):
        r32, r64 = fused_rec["f32"][half], fused_rec["f64"][half]
        kernels.append({
            "name": f"spmm_{half}_half", "route": "cuda",
            "source": os.path.relpath(spmm_mod.SOURCE, HERE),
            "replaces": "hprlp_tpu/solver/batched.py:" + (
                "77" if half == "x" else "85"),
            "note": f"the middle iteration's {half}-half fused into the "
                    f"SpMM over {matrix}'s rows; no Pallas kernel in the "
                    f"JAX package (XLA fuses it); batched_large B=64 f32, "
                    f"plain_ms the plain ops by graph replay",
            "launches": l9[f"spmm_{half}_half"] + p12[f"spmm_{half}_half"]
            + l15["f32"][f"spmm_{half}_half"],
            "launches_by_phase": {"9": l9[f"spmm_{half}_half"],
                                  "12": p12[f"spmm_{half}_half"],
                                  "15": l15["f32"][f"spmm_{half}_half"]},
            "max_abs_err": max(fused_rec[t]["max_abs_err"]
                               for t in fused_rec),
            "ms": r32["ms"], "plain_ms": r32["plain_ms"],
            "bound_ms": r32["bound_ms"], "bound_by": r32["bound_by"],
            "library_ms": None, "f64": r64})
    kernels[-1]["chunks"] = {t: {k: v for k, v in r.items()
                                 if k not in ("x", "y")}
                             for t, r in fused_rec.items()}
    y32, y64 = fused_rec["f32"]["y"], fused_rec["f64"]["y"]
    kernels[-1]["previous_ms"] = y32["previous_ms"]
    prev_by_phase = {"9": l9["spmm_y_half_previous"],
                     "12": p12["spmm_y_half_previous"],
                     "15": l15["f32"]["spmm_y_half_previous"]}
    check(not any(prev_by_phase.values()), f"the solves of phases 9, 12 "
          f"and 15 launched the previous y-half: {prev_by_phase}")
    kernels.append({
        "name": "spmm_y_half_previous", "route": "cuda",
        "source": os.path.relpath(spmm_mod.SOURCE, HERE),
        "replaces": "hprlp_tpu/solver/batched.py:85",
        "previous_design": "the y-half on the product kernel's epilogue "
                           "(register gathers, operands read after them), "
                           "succeeded by the ring kernel; timed in phase "
                           "9 (d) only, bitwise equal",
        "launches": sum(prev_by_phase.values()),
        "launches_by_phase": prev_by_phase,
        "max_abs_err": max(fused_rec[t]["y"]["previous_max_abs_err"]
                           for t in fused_rec),
        "ms": y32["previous_ms"],
        "plain_ms": y32["plain_ms"], "bound_ms": y32["bound_ms"],
        "bound_by": y32["bound_by"], "library_ms": None,
        "f64": {"ms": y64["previous_ms"], "bound_ms": y64["bound_ms"]}})
    phase(16, f"the smoke took {time.perf_counter() - T_START:.1f} s "
              f"[{card}]")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
