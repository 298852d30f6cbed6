"""Column-strip tiles of a CSR matrix: the layout of the main-path SpMV
kernel (csrc/spmv_tiled.cu) and its plain version.

Counterpart of hprlp_tpu/ops/lane_ell.py, which groups a matrix's entries
by 128-row window and x window for the TPU's crossbar.  Here the entries
are grouped for Hopper thread blocks that stage x in shared memory one
column strip at a time and keep their rows of y there:

* column strips of W columns (W a multiple of 32, at most 65536); by
  default the largest W for which two strips (the kernel double-buffers
  them) and a chunk's y fit the 227 KB of shared memory a block may use,
  or one strip covering all columns where that fits alone;
* G strip groups of Kg consecutive strips, and row chunks of at most
  65535 rows that carry about equal nnz, padded with empty chunks to a
  multiple of CLUSTER (the largest cluster of the multicast stages);
  block b = g * n_chunks + c takes strip group g of row chunk c, so it
  stages 1/G of x.  With G > 1 each block holds a partial y of its chunk
  in shared memory, and the kernel's main stage launches the G blocks of
  a chunk as one thread-block cluster that sums the G partials in group
  order through distributed shared memory: the partials never go through
  HBM (the previous design, stage block_x, wrote them there for a second
  pass).  By default G balances the x a block stages (ncols / G) against
  the partials each row's sum reads (G per row, 2 * rows per chunk in the
  model below), within what shared memory allows.  On the card
  build_tiles takes `slots`, the clusters of each size that can be
  resident at once (ops/spmv.py::cluster_slots): a tiling of G groups then aims at
  slots[G] chunks, so that its clusters fill the card in one wave (a
  chunk longer than block_rows still splits), and without it at
  TARGET_BLOCKS / G; with slots a default G whose last group would hold
  fewer than half the others' strips also takes one group fewer (the
  strip-group sweep, prof/prof_tiled.py); `live_chunks` counts the chunks
  before the padding, the only ones the main stage launches clusters
  for;
* within a (block, strip) each row belongs to one of WARPS warp runs, cut
  at row boundaries so that the runs carry about equal nnz; entries are
  stored by (block, warp, strip, row, column), so that one warp's runs
  over its strips are one contiguous stream;
* per entry the value and one uint32 key, row_in_chunk << 16 |
  col_in_strip (stored as int32), so 8 B per f32 entry as in CSR;
* each run starts at a multiple of VEC entries (one 16-byte load per
  lane), padded with zero values whose row is SENTINEL_ROW;
* `runs[(b * WARPS + w) * Kg + l]` is where the run of warp w in the
  l-th strip of block b's group starts, and `runs[-1]` the padded length;
* `perm` maps CSR entry order to tile order, so `retile` takes rescaled
  values without a rebuild; tiles built from final values may drop it
  (`without_perm`), as the solve's ingest does.

`build_tiles` runs on A's device with torch ops (stable sorts and
cumsums, no loop over rows).  On a card it asks the card for its resident
clusters (once per device); on the CPU it asks nothing, and tests can
give it a table in `slots`.  `strip_width`, `block_rows`, `strip_groups`
and `slots` exist so that tests and measurements can force a layout.
"""

from __future__ import annotations

import dataclasses
import functools

import torch

WARPS = 16                 # warps per block (csrc/spmv_tiled.cu kWarps)
CLUSTER = 8                # largest cluster of the multicast stages
SMEM_BYTES = 232448        # shared memory one block may use on an H100
BARRIER_BYTES = 16         # two mbarriers
MAX_BLOCK_ROWS = 65535     # row_in_chunk < 0xFFFF, the padding row
MAX_STRIP_WIDTH = 65536    # col_in_strip < 2**16
SENTINEL_ROW = 0xFFFF
TARGET_BLOCKS = 128        # one block per SM (of 132), one wave
NNZ_PER_BLOCK = 4096       # fewer blocks below TARGET_BLOCKS * this nnz
MAX_GROUPS = 8
INT32_MAX = 2**31 - 1


def vec_width(dtype: torch.dtype) -> int:
    """Entries per 16-byte lane load: 4 in f32, 2 in f64."""
    return 16 // torch.empty((), dtype=dtype).element_size()


def _round_up(a, b):
    return -(-a // b) * b


def smem_bytes(strip_width: int, block_strips: int, max_block_rows: int,
               itemsize: int) -> int:
    """Dynamic shared memory of one block: the x strip buffers (two when
    a block has more than one strip), y of its rows, two mbarriers."""
    ys = _round_up(max_block_rows * itemsize, 16)
    nbuf = 2 if block_strips > 1 else 1
    return nbuf * strip_width * itemsize + ys + BARRIER_BYTES


@dataclasses.dataclass(frozen=True)
class TiledMatrix:
    vals: torch.Tensor       # (L,) float32/float64, tile order, zero padded
    keys: torch.Tensor       # (L,) int32: row_in_chunk << 16 | col_in_strip
    runs: torch.Tensor       # (n_blocks * WARPS * group_strips + 1,) int32
    row_start: torch.Tensor  # (n_chunks + 1,) int32, first row of a chunk
    perm: torch.Tensor | None  # (nnz,) int64: CSR entry -> tile position
    nrows: int
    ncols: int
    nnz: int                 # stored entries, without the padding
    strip_width: int
    n_strips: int            # K
    n_groups: int            # G
    group_strips: int        # Kg: strips per group (the last may have fewer)
    n_chunks: int
    max_block_rows: int      # rows of the largest chunk
    live_chunks: int         # the chunks before the padding (with rows)

    @property
    def n_blocks(self) -> int:
        return self.n_groups * self.n_chunks

    @property
    def dtype(self) -> torch.dtype:
        return self.vals.dtype

    @property
    def smem_bytes(self) -> int:
        return smem_bytes(self.strip_width, self.group_strips,
                          self.max_block_rows, self.vals.element_size())

    @functools.cached_property
    def coo(self) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """(order, row, col), int64: the tile positions by (chunk, strip,
        warp), which takes each row's entries in increasing column order,
        and the row and column of each position in that order.  Padding
        entries get row `nrows` (one past the last) and the first column of
        their strip."""
        dev = self.keys.device
        Kg, C = self.group_strips, self.n_chunks
        counts = (self.runs[1:] - self.runs[:-1]).to(torch.int64)
        run = torch.repeat_interleave(
            torch.arange(counts.numel(), device=dev), counts,
            output_size=self.vals.shape[0])
        block, warp = run // (Kg * WARPS), run // Kg % WARPS
        chunk = block % C
        strip = block // C * Kg + run % Kg
        order = torch.sort((chunk * self.n_strips + strip) * WARPS + warp,
                           stable=True).indices
        key = self.keys.to(torch.int64)[order] & 0xFFFFFFFF
        chunk, strip = chunk[order], strip[order]
        rib = key >> 16
        row = torch.where(rib == SENTINEL_ROW, self.nrows,
                          self.row_start.to(torch.int64)[chunk] + rib)
        col = strip * self.strip_width + (key & 0xFFFF)
        return order, row, col

    def without_perm(self) -> "TiledMatrix":
        """The same tiles without `perm` (8 B per entry), which only
        `retile` reads."""
        return dataclasses.replace(self, perm=None)

    def retile(self, vals: torch.Tensor) -> "TiledMatrix":
        """The same layout with new values, given in CSR entry order."""
        if self.perm is None:
            raise ValueError("these tiles dropped their CSR order "
                             "(without_perm): retile needs it")
        if vals.shape != (self.nnz,) or vals.dtype != self.dtype:
            raise ValueError(f"retile needs ({self.nnz},) {self.dtype} "
                             f"values, got {tuple(vals.shape)} {vals.dtype}")
        out = torch.zeros_like(self.vals).index_put_((self.perm,), vals)
        new = dataclasses.replace(self, vals=out)
        if "coo" in self.__dict__:  # the structure is shared
            new.__dict__["coo"] = self.__dict__["coo"]
        return new


def _row_chunks(indptr: torch.Tensor, nrows: int, nnz: int, n_target: int,
                row_cap: int) -> tuple[torch.Tensor, int]:
    """(first row of each chunk, int64, ending with nrows; the chunks
    before the padding): n_target cuts at about equal nnz, chunks longer
    than row_cap split evenly, empty chunks appended up to a multiple of
    CLUSTER."""
    dev = indptr.device
    targets = torch.arange(1, n_target, device=dev) * nnz // n_target
    cuts = torch.searchsorted(indptr, targets)
    edges = torch.unique(torch.cat([
        torch.zeros(1, dtype=torch.int64, device=dev), cuts,
        torch.full((1,), nrows, dtype=torch.int64, device=dev)]))
    if edges.numel() < 2:  # nrows == 0
        edges = torch.zeros(2, dtype=torch.int64, device=dev)
    length = edges[1:] - edges[:-1]
    parts = torch.clamp(-(-length // row_cap), min=1)
    first = torch.cumsum(parts, 0) - parts
    j = torch.arange(int(parts.sum()), device=dev) \
        - torch.repeat_interleave(first, parts)
    starts = (torch.repeat_interleave(edges[:-1], parts)
              + j * torch.repeat_interleave(length, parts)
              // torch.repeat_interleave(parts, parts))
    n_chunks = _round_up(starts.numel(), CLUSTER)
    tail = torch.full((n_chunks - starts.numel() + 1,), nrows,
                      dtype=torch.int64, device=dev)
    return torch.cat([starts, tail]), starts.numel()


def _strip_width(ncols: int, max_rows: int, itemsize: int,
                 strip_width: int | None) -> int:
    if strip_width is not None:
        W = int(strip_width)
        if W % 32 or not 32 <= W <= MAX_STRIP_WIDTH:
            raise ValueError(f"strip_width must be a multiple of 32 in "
                             f"[32, {MAX_STRIP_WIDTH}], got {W} (the "
                             f"column in a strip is a 16-bit key)")
        return W
    budget = SMEM_BYTES - BARRIER_BYTES - _round_up(max_rows * itemsize, 16)
    whole = _round_up(max(ncols, 1), 32)
    if whole <= MAX_STRIP_WIDTH and whole * itemsize <= budget:
        return whole
    return min(MAX_STRIP_WIDTH, budget // (2 * itemsize) // 32 * 32)


def _default_groups(nrows: int, ncols: int, blocks: int, row_cap: int) -> int:
    """The power of two nearest below sqrt(blocks * ncols / (2 * nrows)),
    which minimises the x a block stages (ncols / G) plus the partials of
    its rows it writes and reads (2 * nrows * G / blocks: since the
    cluster route, a shared-memory write and a distributed shared-memory
    read), with chunks of at most row_cap rows and at least one chunk per
    group."""
    best = (blocks * ncols / (2 * max(nrows, 1))) ** 0.5
    cap = min(MAX_GROUPS, blocks, blocks * row_cap // max(nrows, 1))
    g = 1
    while 2 * g <= min(best, cap):
        g *= 2
    return g


def _chunk_target(nnz: int, G: int, slots: dict | None) -> int:
    """Row chunks to aim for at G groups: one block per NNZ_PER_BLOCK
    entries, and at most one wave: TARGET_BLOCKS blocks (one per SM), or
    with the card's `slots` the slots[G] clusters of G resident at once."""
    blocks = max(1, -(-nnz // NNZ_PER_BLOCK))
    if slots and G in slots:
        return max(1, min(blocks // G, slots[G]))
    return max(1, min(TARGET_BLOCKS, blocks) // G)


def build_tiles(A, strip_width: int | None = None,
                block_rows: int | None = None,
                strip_groups: int | None = None,
                slots: dict | None | str = "device") -> TiledMatrix:
    """Lay CSR matrix A (CsrMatrix: int32 indptr/indices, sorted columns
    within a row) out as column-strip tiles on A's device.  `slots`: {G:
    clusters of G blocks resident at once on the card that will run the
    tiles}; "device" (the default) takes them from A's device (ops/
    spmv.py::cluster_slots, None on the CPU); None lays the tiles out
    without a residency cap, as on the CPU.  Raises if a row or column
    index would not fit its 16 bits, or a block's strips and y would not
    fit shared memory."""
    dev = A.indptr.device
    if isinstance(slots, str):
        if slots != "device":
            raise ValueError(f"slots must be a dict, None or 'device', got "
                             f"{slots!r}")
        from .spmv import cluster_slots  # ops/spmv.py imports this module
        slots = cluster_slots(dev)
    nrows, ncols, nnz = A.nrows, A.ncols, A.nnz
    itemsize = A.vals.element_size()
    vec = vec_width(A.vals.dtype)
    # By default y takes at most half of shared memory.
    row_cap = (min(MAX_BLOCK_ROWS, SMEM_BYTES // 2 // itemsize)
               if block_rows is None else int(block_rows))
    if not 1 <= row_cap <= MAX_BLOCK_ROWS:
        raise ValueError(f"block_rows must be in [1, {MAX_BLOCK_ROWS}], got "
                         f"{row_cap} (the row in a chunk is a 16-bit key "
                         f"and 0xFFFF marks padding)")
    if strip_groups is not None and int(strip_groups) < 1:
        raise ValueError(f"strip_groups must be >= 1, got {strip_groups}")
    blocks = min(TARGET_BLOCKS, max(1, -(-nnz // NNZ_PER_BLOCK)))
    G = (_default_groups(nrows, ncols, blocks, row_cap)
         if strip_groups is None else int(strip_groups))
    indptr = A.indptr.to(torch.int64)
    aim, recut = G, False  # the group count the chunks are cut for
    while True:
        chunk_start, live = _row_chunks(indptr, nrows, nnz,
                                        _chunk_target(nnz, aim, slots),
                                        row_cap)
        max_rows = int((chunk_start[1:] - chunk_start[:-1]).max())
        W = _strip_width(ncols, max_rows, itemsize, strip_width)
        K = -(-ncols // W)
        if G > max(K, 1):
            G = aim = max(K, 1)  # no more groups than strips
            continue
        Kg = -(-K // G) if K else 1
        G = -(-K // Kg) if K else 1  # no empty group
        if slots is None or recut:
            break
        # On the card (slots): a default G whose last group holds fewer
        # than half the others' strips takes one group fewer, since that
        # group's block idles while its cluster's others stream; and the
        # chunks are cut once more for the G that runs where it is not the
        # G they were cut for, so that its clusters fill the wave (clusters
        # of fewer blocks are no fewer: still one wave).
        if strip_groups is None and G > 1 and 2 * (K - (G - 1) * Kg) < Kg:
            G -= 1
        if G == aim:
            break
        aim, recut = G, True
    C = chunk_start.numel() - 1
    need = smem_bytes(W, Kg, max_rows, itemsize)
    if need > SMEM_BYTES:
        raise ValueError(f"strips of {W} columns and {max_rows} rows of y "
                         f"need {need} B of shared memory, more than "
                         f"{SMEM_BYTES}")

    # Each int64 per-entry temporary is 8 B/nnz: each is dropped as soon
    # as it is dead, since this is the ingest's peak of device memory.
    row = torch.repeat_interleave(
        torch.arange(nrows, device=dev), indptr[1:] - indptr[:-1],
        output_size=nnz)
    chunk = torch.searchsorted(chunk_start, row, right=True) - 1
    key = (row - chunk_start[chunk]) << 16  # row in chunk
    del row
    col = A.indices.to(torch.int64)
    strip = col // W
    key |= col - strip * W
    del col
    group = (strip // Kg * C + chunk) * Kg + strip % Kg  # (block, strip)
    del strip, chunk
    order = torch.sort(group, stable=True).indices  # rows stay sorted
    g = group[order]
    del group
    # Within a (block, strip) pair the row in chunk orders as the row.
    r = key[order] >> 16
    n_groups = G * C * Kg
    g_count = torch.bincount(g, minlength=n_groups)
    g_first = torch.cumsum(g_count, 0) - g_count
    idx = torch.arange(nnz, device=dev)
    warp = (idx - g_first[g]) * WARPS // torch.clamp(g_count[g], min=1)
    # A row's entries go to the warp of its first entry in the pair.
    head = torch.ones(nnz, dtype=torch.bool, device=dev)
    head[1:] = (g[1:] != g[:-1]) | (r[1:] != r[:-1])
    del r
    warp = warp[head][torch.cumsum(head, 0) - 1]
    del head
    run = (g // Kg * WARPS + warp) * Kg + g % Kg
    del g, warp
    r_count = torch.bincount(run, minlength=n_groups * WARPS)
    runs = torch.zeros(n_groups * WARPS + 1, dtype=torch.int64, device=dev)
    runs[1:] = torch.cumsum(-(-r_count // vec) * vec, 0)
    length = int(runs[-1])
    if length > INT32_MAX:
        raise ValueError(f"{length} tile entries exceed int32 offsets")
    # A run's entries are contiguous in pair order: offset from its first.
    r_head = torch.ones(nnz, dtype=torch.bool, device=dev)
    r_head[1:] = run[1:] != run[:-1]
    r_first = torch.cummax(torch.where(r_head, idx, 0), 0).values
    del r_head
    perm = torch.empty(nnz, dtype=torch.int64, device=dev)
    perm[order] = runs[run] + idx - r_first
    del order, run, idx, r_first

    keys = torch.full((length,), SENTINEL_ROW << 16, dtype=torch.int64,
                      device=dev)
    keys[perm] = key
    del key
    keys = torch.where(keys >= 2**31, keys - 2**32, keys).to(torch.int32)
    vals = torch.zeros(length, dtype=A.vals.dtype, device=dev)
    vals[perm] = A.vals
    return TiledMatrix(vals=vals, keys=keys, runs=runs.to(torch.int32),
                       row_start=chunk_start.to(torch.int32), perm=perm,
                       nrows=nrows, ncols=ncols, nnz=nnz, strip_width=W,
                       n_strips=K, n_groups=G, group_strips=Kg, n_chunks=C,
                       max_block_rows=max_rows, live_chunks=live)


def tiled_spmv_reference(T: TiledMatrix, x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch y = A @ x on the tiles (any device): index_add_ of
    vals * x[col] by (chunk, strip, warp), so each row sums in increasing
    column order, as spmv_reference does in CSR order."""
    order, row, col = T.coo
    y = torch.zeros(T.nrows + 1, dtype=x.dtype, device=x.device)
    return y.index_add_(0, row, T.vals[order] * x[col])[:T.nrows]
