"""The share ingest of a mesh (parallel/sharded.py, solver/loop.py::
build_share_ingest, solver/scaling.py with a ScalingShare) over 2 and 3
gloo ranks on the CPU: each rank builds, uploads and scales only its
share, and its scaled vectors, factors and tiles are bitwise those of the
one-card ingest followed by shard_problem, in f64 and f32; so are its
mesh solves.

One launch per world size (parallel/distributed.py::launch, the ranks
running test_torch_parallel_ranks.py::run_cases) runs every case.  This
module imports neither JAX nor the JAX package.
"""

import numpy as np
import pytest
import torch

from hprlp_tpu_torch.ops.device_problem import padded_size
from hprlp_tpu_torch.parallel import distributed
from hprlp_tpu_torch.parallel.sharded import column_slices

import test_torch_parallel_ranks as ranks
from test_torch_parallel_ranks import quiet, random_problem, same_results

torch.set_num_threads(1)

WORLDS = (2, 3)
# An LP whose 3-rank cut leaves no rank empty, and a small one whose last
# slices are padding only at 3 ranks (m, n below 3 blocks of 32).
LPS = {"lp": lambda: random_problem(11, m=150, n=230, density=0.06),
       "small": lambda: random_problem(12, m=40, n=70, density=0.2)}
SOLVES = {"f64": {"stop_tol": 1e-6, "precision": "f64"},
          "f32": {"stop_tol": 1e-4, "precision": "f32"}}


def _cases(world):
    out = [(f"share_{lp}_{prec}", "share", (make(), prec), {})
           for lp, make in LPS.items() for prec in ("f64", "f32")]
    out += [(f"solve_{prec}", "share_solve",
             (LPS["lp"](), quiet(mesh_shape=world, **kw)), {})
            for prec, kw in SOLVES.items()]
    return out


@pytest.fixture(scope="module", params=WORLDS, ids=lambda w: f"world{w}")
def runs(request):
    """(world, every rank's {case: result})."""
    world = request.param
    return world, distributed.launch(ranks.run_cases, (_cases(world),),
                                     world=world, device_type="cpu",
                                     timeout=300)


@pytest.mark.parametrize("lp", sorted(LPS))
@pytest.mark.parametrize("prec", ["f64", "f32"])
def test_share_is_the_one_card_ingest_then_sliced_bitwise(runs, lp, prec):
    """Every rank: the scaling's factors and scalars, the scaled vectors,
    each matrix's column slice and tiles (vals, keys, runs, row_start)
    bitwise those of the one-card ingest then shard_problem; the row
    forms released; 51 exchanges (CR 2 x 20, Ruiz 10, PC 1)."""
    world, per_rank = runs
    for r, out in enumerate(per_rank):
        got = out[f"share_{lp}_{prec}"]
        bad = [k for k, ok in got["same"].items() if not ok]
        assert not bad, (r, bad)
        assert got["record"]["exchanges"] == 51


@pytest.mark.parametrize("lp", sorted(LPS))
def test_the_cuts_are_the_column_slices(runs, lp):
    """R and C of rank r are column_slices of A's row counts (A^T's column
    counts) and of A's column counts, the slices the one-card route cuts;
    the ranks' R and C each cover the padded rows and columns."""
    world, per_rank = runs
    problem = LPS[lp]()
    A = problem.A.tocsr()
    m_pad, n_pad = padded_size(problem.m), padded_size(problem.n)
    row_nnz = np.zeros(m_pad, np.int64)
    row_nnz[:problem.m] = np.diff(A.indptr)
    col_nnz = np.bincount(A.indices, minlength=n_pad)
    want_r, want_c = column_slices(row_nnz, world), column_slices(col_nnz,
                                                                  world)
    for r, out in enumerate(per_rank):
        rec = out[f"share_{lp}_f64"]["record"]
        assert tuple(rec["rows"]) == want_r[r]
        assert tuple(rec["cols"]) == want_c[r]


@pytest.mark.parametrize("lp", sorted(LPS))
def test_no_rank_uploads_more_than_its_share(runs, lp):
    """Each array a rank uploads from the host holds no more than the
    larger of its share's two sets of entries, A[R, :] and A[:, C], or a
    replicated vector (m_pad + 1, n_pad + 1); all of them together at
    most each share entry in two forms, values and indices, the four
    indptrs and the five vectors.  Each rank's share is below the whole
    matrix's nnz."""
    world, per_rank = runs
    total_entries = 0
    for out in per_rank:
        got = out[f"share_{lp}_f64"]
        m_pad, n_pad, nnz = got["sizes"]
        e_rows, e_cols = got["forms"]
        assert got["record"]["entries"] == e_rows + e_cols
        total_entries += e_rows + e_cols
        assert max(e_rows, e_cols) < nnz
        ups = got["uploads"]
        assert max(ups) <= max(e_rows, e_cols, m_pad + 1, n_pad + 1)
        assert sum(ups) <= (4 * (e_rows + e_cols) + 2 * (m_pad + n_pad + 2)
                            + 2 * m_pad + 3 * n_pad)
    # Each entry of A is in exactly one rank's A[R, :] and one's A[:, C].
    assert total_entries == 2 * nnz


@pytest.mark.parametrize("prec", sorted(SOLVES))
def test_mesh_solve_is_the_one_card_ingest_then_sliced(runs, prec):
    """The mesh solve through the share ingest: every field of every
    rank's Results bitwise the same mesh solve on the one-card ingest
    then shard_problem, times aside; every rank's the same, times
    included."""
    world, per_rank = runs
    for out in per_rank:
        got, want = out[f"solve_{prec}"]
        assert got.status == "OPTIMAL"
        for name in ranks.loop.TIME_FIELDS:
            setattr(want, name, getattr(got, name))
        same_results(got, want)
    for out in per_rank[1:]:
        same_results(out[f"solve_{prec}"][0], per_rank[0][f"solve_{prec}"][0])


def test_discard_branch_broadcasts_once_the_ingest_is_gone():
    """prof/share_ingest.py::discard_broadcast (chip_smoke.py phase 15
    (k)) on 2 gloo CPU ranks: Model.solve's discard branch under a mesh,
    the giant threshold lowered to 1 so that rank 0 presolves beside the
    share ingest.  Rank 0 alone presolves; three broadcasts, the same
    bytes on both ranks: the decision, the reduced LP (at least its
    nnz's f64 values and int32 indices) and the postsolved point; every
    rank enters the reduced solve with rank 0's reduced LP."""
    from hprlp_tpu_torch.prof.share_ingest import discard_broadcast

    per_rank = discard_broadcast(LPS["lp"](), 2, {"stop_tol": 1e-4,
                                                  "verbose": False},
                                 device="cpu", giant_nnz=1, timeout=300)
    assert [r["presolved"] for r in per_rank] == [True, False]
    sizes = [[b["bytes"] for b in r["broadcasts"]] for r in per_rank]
    assert len(sizes[0]) == 3 and sizes[0] == sizes[1]
    entered = [r["reduced_solve"] for r in per_rank]
    assert entered[0]["nnz"] > 0
    assert entered[0]["m"] == entered[1]["m"]
    assert entered[0]["n"] == entered[1]["n"]
    assert entered[0]["nnz"] == entered[1]["nnz"]
    assert sizes[0][1] >= 12 * entered[0]["nnz"]
    assert all(r["broadcast_bytes"] == sum(sizes[0]) for r in per_rank)
    assert per_rank[0]["status"] == per_rank[1]["status"]
