"""Graph partitioning and the stacked per-subgraph ELL views DIGEST trains on.

The paper partitions with METIS; offline we implement a deterministic
multilevel-flavored greedy (LDG/Fennel-style streaming over a BFS order),
which like METIS optimizes edge cut under balance constraints, plus random
partitioning as the ablation baseline.

Boundary-aware accounting at production scale: the ``halo_weight`` term of
:func:`greedy_partition` charges each candidate part the *marginal new halo
rows* an assignment creates, which needs an exact "is u already a halo row
of part p" membership test during the stream.  That membership is kept in
**per-node replica arrays** — for every node, the distinct parts it is
currently replicated into, stored in one flat O(E) buffer laid out by the
CSR degree slots (a node can only ever be a halo row of a part one of its
neighbors was assigned to, so ``|replicas(u)| <= deg(u)`` and the total is
bounded by 2E).  Each assignment touches only the <= deg(v) adjacent
entries; no (num_parts, num_nodes) matrix is ever materialized, so a
1M-node x 256-part build runs in O(E) extra memory and near-linear time.

Locality-aware local row ordering: ``build_partitions(order="rcm")``
reorders each part's local rows with reverse Cuthill-McKee over the
induced subgraph (and re-lays each per-subgraph halo slab's owner runs by
first-referencing row) so consecutive 128-row output blocks reference
clustered halo-slab ranges.  That drives the static
:class:`ChunkWorklist` occupancy down into the regime where the
chunk-skipping streamed kernel (``halo_spmm_skip_pallas``) is selected
and streams a fraction of the dense bytes.  The ordering is a pure
permutation of local rows (per-row ELL edge order, the owner-sharded
store layout and the PullPlan routing are untouched), guarded per part:
a part keeps its identity order if RCM would not reduce its visited
(row_block x chunk) count at the build geometry, so occupancy never
increases.

``build_partitions`` produces a :class:`StackedPartitions`: every subgraph
padded to identical (S, H, deg) sizes so the whole structure stacks into
(M, ...) arrays — directly shardable over the mesh "data" axis with one
subgraph per device slice, and vmap-able on CPU.
"""
from __future__ import annotations

import dataclasses
import warnings

import numpy as np

from repro_torch.graph.graph import (EllMatrix, Graph, coo_to_ell,
                                     gcn_norm_weights)


# ---------------------------------------------------------------------------
# Partitioners
# ---------------------------------------------------------------------------

def random_partition(g: Graph, num_parts: int, seed: int = 0,
                     halo_weight: float = 0.0) -> np.ndarray:
    # halo_weight accepted so every PARTITIONERS entry has the same
    # signature under build_partitions — but random assignment has no
    # streaming score to weight, so a sweep comparing partitioners at
    # halo_weight > 0 would silently misreport this leg as boundary-aware.
    if halo_weight:
        warnings.warn(
            f"random_partition ignores halo_weight={halo_weight!r}: the "
            f"boundary-aware marginal-halo score only exists in the "
            f"greedy streaming partitioner (method='greedy'/'metis')",
            stacklevel=2)
    rng = np.random.default_rng(seed)
    assign = np.arange(g.num_nodes) % num_parts
    rng.shuffle(assign)
    return assign.astype(np.int32)


def _ragged_take(buf: np.ndarray, starts: np.ndarray, lens: np.ndarray
                 ) -> tuple[np.ndarray, np.ndarray]:
    """Gather ``concatenate([buf[s:s+l] for s, l in zip(starts, lens)])``
    plus the index of the (start, len) pair each element came from —
    vectorized (no per-slice Python loop)."""
    total = int(lens.sum())
    src = np.repeat(np.arange(len(starts)), lens)
    base = np.repeat(np.cumsum(lens) - lens, lens)
    pos = np.repeat(starts, lens) + (np.arange(total) - base)
    return buf[pos], src


def greedy_partition(g: Graph, num_parts: int, seed: int = 0,
                     slack: float = 1.05,
                     halo_weight: float = 0.0) -> np.ndarray:
    """LDG-style streaming partition over a BFS order (METIS stand-in).

    ``halo_weight`` adds a boundary-aware term to the streaming score: the
    classic LDG objective minimizes *edge cut*, but the compact store's
    residency and §3.3's wire cost both scale with ``Σ_m |halo(G_m)|``
    (vertex replication), which equal-cut partitions can differ a lot on.
    With a positive weight each candidate part is charged the *marginal
    new halo rows* its assignment would create — v replicated into every
    other adjacent part, plus every out-of-part neighbor that is not yet
    a halo row of the candidate (tracked exactly during the stream) —
    and parts at capacity are masked out so the penalty cannot trade
    balance for halo (the additive term would otherwise defeat the
    multiplicative balance factor).  ``halo_weight=0`` reproduces the
    original assignments bit-for-bit; 0.1–0.25 trims Σ|halo| a few
    percent on the test graphs at unchanged balance (edge cut drifts up
    slightly — the point is that cut is the wrong cost proxy).

    Cost note: halo membership is tracked in per-node **replica arrays**
    (one flat int32 buffer laid out by the CSR degree slots — a node is
    only ever replicated into parts its neighbors were assigned to, so
    ``|replicas(u)| <= deg(u)`` and the whole structure is O(E)).  Each
    step touches the <= deg(v) adjacent entries plus the candidates'
    replica arrays (``O(sum_{u in N(v)} |replicas(u)|)``); no
    (num_parts, num_nodes) matrix exists anywhere, so the 1M-node x
    256-part dry-run regime builds in O(E) extra memory.  The accounting
    is exactly the dense formulation's: ``is_halo[p, u]`` holds iff u is
    assigned and some assigned neighbor of u lives in part ``p !=
    assign[u]`` — the invariant the replica arrays maintain
    incrementally (asserted against a dense reference in
    tests/test_order_invariance.py).
    """
    n = g.num_nodes
    rng = np.random.default_rng(seed)
    capacity = slack * n / num_parts
    assign = np.full(n, -1, np.int32)
    sizes = np.zeros(num_parts, np.int64)
    indptr, indices = g.indptr, g.indices

    # BFS order from random seeds → locality in the stream.  LIFO
    # traversal appending unseen neighbors in CSR order — semantically
    # the per-edge Python loop of the original implementation, run as
    # one vectorized step per visited node (bit-identical order).
    order = np.empty(n, np.int64)
    seen = np.zeros(n, bool)
    stack = np.empty(n, np.int64)
    pos = 0
    for root in rng.permutation(n):
        if seen[root]:
            continue
        stack[0] = root
        top = 1
        seen[root] = True
        while top:
            top -= 1
            v = stack[top]
            order[pos] = v
            pos += 1
            ns = indices[indptr[v]:indptr[v + 1]]
            new = ns[~seen[ns]]
            if len(new):
                seen[new] = True
                stack[top:top + len(new)] = new
                top += len(new)
    assert pos == n

    if halo_weight:
        # Per-node replica arrays: node u's current replica set (the
        # distinct parts u is a halo row of) lives unsorted at
        # rep_buf[indptr[u] : indptr[u] + rep_len[u]] — capacity deg(u)
        # suffices because every entry is the part of some assigned
        # neighbor.  O(E) total, vs the dense (num_parts, n) bool.
        rep_buf = np.zeros(len(indices), np.int32)
        rep_len = np.zeros(n, np.int64)

    for v in order:
        nbrs = indices[indptr[v]:indptr[v + 1]]
        counts = np.zeros(num_parts, np.float64)
        assigned = assign[nbrs]
        valid = assigned >= 0
        anbrs = nbrs[valid]
        if valid.any():
            np.add.at(counts, assigned[valid], 1.0)
        score = counts * (1.0 - sizes / capacity)
        if halo_weight:
            present = counts > 0
            # Marginal Σ_m |halo| of assigning v to p: v becomes a halo
            # row of every other adjacent part, and each assigned
            # neighbor outside p becomes a halo row of p unless it
            # already is one.  The dense form's per-part neighbor term
            # (fresh & out_of_p).sum(axis=1) equals
            #   |anbrs| − counts[p] − #{u : p ∈ replicas(u)}
            # (replica sets never contain the node's own part), so only
            # the candidates' replica arrays are gathered — no column
            # scan of an (M, n) matrix.
            pen = np.full(num_parts, float(present.sum()))
            pen -= present
            if len(anbrs):
                pen += len(anbrs) - counts
                reps, _ = _ragged_take(rep_buf, indptr[anbrs],
                                       rep_len[anbrs])
                if len(reps):
                    pen -= np.bincount(reps, minlength=num_parts)
            score = score - halo_weight * pen
            score[sizes >= capacity] = -np.inf
        # Tie-break toward the emptiest part for balance.
        score += 1e-9 * (capacity - sizes)
        best = int(np.argmax(score))
        assign[v] = best
        sizes[best] += 1
        if halo_weight and len(anbrs):
            au = assign[anbrs]
            other = au != best
            if other.any():
                # v is now a halo row of every other adjacent part …
                mine = np.unique(au[other]).astype(np.int32)
                s = indptr[v]
                rep_buf[s:s + len(mine)] = mine
                rep_len[v] = len(mine)
                # … and each out-of-part assigned neighbor becomes a
                # halo row of `best` unless it already is one.
                targets = anbrs[other]
                reps, src = _ragged_take(rep_buf, indptr[targets],
                                         rep_len[targets])
                has = np.zeros(len(targets), bool)
                if len(reps):
                    has[src[reps == best]] = True
                fresh_t = targets[~has]
                rep_buf[indptr[fresh_t] + rep_len[fresh_t]] = best
                rep_len[fresh_t] += 1
    return assign


# Chunk geometry the RCM ordering guard scores candidates at when the
# caller does not thread its own (mirrors kernels.spmm.STREAM_CHUNK_ROWS;
# prepare_graph_data passes the actual build knob through).
ORDER_GUARD_CHUNK_ROWS = 512
# Output rows per kernel row block (mirrors kernels.spmm.BLOCK_ROWS).
ORDER_BLOCK_ROWS = 128

LOCAL_ORDERS = ("none", "rcm")


def reverse_cuthill_mckee(indptr: np.ndarray, indices: np.ndarray
                          ) -> np.ndarray:
    """Deterministic RCM ordering of a CSR graph; returns a permutation
    ``perm`` such that ``perm[i]`` is the old index of new row i.

    Classic Cuthill–McKee — BFS from the minimum-degree node of each
    component (ties by lowest id), neighbors enqueued in ascending
    (degree, id) order — reversed.  Consecutive rows of the reordered
    matrix then share neighborhoods (small bandwidth), which is what
    clusters the (row_block x chunk) occupancy of the streamed halo
    kernels."""
    n = len(indptr) - 1
    deg = np.diff(indptr)
    visited = np.zeros(n, bool)
    order = np.empty(n, np.int64)
    seeds = np.lexsort((np.arange(n), deg))   # min degree first, ties by id
    si = 0
    pos = 0
    while pos < n:
        while visited[seeds[si]]:
            si += 1
        root = seeds[si]
        visited[root] = True
        order[pos] = root
        head, pos = pos, pos + 1
        while head < pos:
            v = order[head]
            head += 1
            ns = indices[indptr[v]:indptr[v + 1]]
            new = ns[~visited[ns]]
            if len(new):
                new = new[np.lexsort((new, deg[new]))]
                visited[new] = True
                order[pos:pos + len(new)] = new
                pos += len(new)
    return order[::-1].copy()


def _induced_csr(loc: np.ndarray, g2l: np.ndarray, indptr: np.ndarray,
                 indices: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """CSR of the subgraph induced on ``loc`` (ascending global ids), in
    local indices; ``g2l`` maps global id → local index (−1 outside)."""
    lens = indptr[loc + 1] - indptr[loc]
    flat, src = _ragged_take(indices, indptr[loc], lens)
    lcols = g2l[flat]
    keep = lcols >= 0
    rows_l = src[keep]
    cols_l = lcols[keep]
    new_indptr = np.zeros(len(loc) + 1, np.int64)
    new_indptr[1:] = np.cumsum(np.bincount(rows_l, minlength=len(loc)))
    return new_indptr, cols_l.astype(np.int64)


def _visited_pairs(loc_rows: np.ndarray, halo_pos: np.ndarray,
                   n_blocks: int, n_chunks: int, chunk_rows: int) -> int:
    """# of distinct (row_block, slab_chunk) pairs the out-edges of one
    part occupy — exactly ``ChunkWorklist.visited_chunks`` for that part
    at the same geometry (real references only; padding/sentinel rows
    reference nothing)."""
    if len(loc_rows) == 0:
        return 0
    blocks = np.minimum(loc_rows // ORDER_BLOCK_ROWS, n_blocks - 1)
    key = blocks.astype(np.int64) * n_chunks + halo_pos // chunk_rows
    return len(np.unique(key))


def edge_cut(g: Graph, assign: np.ndarray) -> int:
    rows = np.repeat(np.arange(g.num_nodes), g.degrees().astype(np.int64))
    cols = g.indices
    return int(np.sum(assign[rows] != assign[cols]) // 2)


PARTITIONERS = {"greedy": greedy_partition, "random": random_partition,
                "metis": greedy_partition}


def parts_per_device(num_parts: int, num_devices: int,
                     what: str = "collective halo exchange") -> int:
    """k = num_parts / num_devices — owner shards (and subgraphs) on each
    exchange-axis device under the collective halo paths.

    ``num_devices`` counts every mesh axis the exchange shards M over:
    the "data" axis alone on a single-pod mesh, pods · data on the
    multi-pod ("pod", "data") mesh (see
    ``halo_exchange.exchange_axes``).  The collective pull/push block
    the owner-sharded slot space (and the PullPlan) into k contiguous
    shards per device, so any M that is a *multiple* of the device
    count works (M > pod size = parts-per-device > 1).  A non-multiple
    M would silently corrupt the owner-local slot math (a device could
    not tell where its shards start), so it is rejected loudly instead
    — this is the single authoritative check;
    ``halo_exchange.shards_per_device`` and
    ``StackedPartitions.shards_per_device`` both delegate here.
    """
    if num_devices <= 0 or num_parts % num_devices != 0:
        raise ValueError(
            f"{what}: num_parts={num_parts} must be a whole multiple of "
            f"the mesh exchange axes ({num_devices} devices — the "
            f"\"data\" axis, times \"pod\" on a multi-pod mesh) — each "
            f"device owns k = num_parts/{num_devices} contiguous "
            f"shards, but {num_parts} % {max(num_devices, 1)} = "
            f"{num_parts % num_devices if num_devices > 0 else num_parts}"
            f".  Use a part count divisible by the device count, or the "
            f"dense-gather fallback (pull_slab / push / "
            f"pull_mode='gather'), which is correct on any device count.")
    return num_parts // num_devices


def partition_report(g: Graph, sp: "StackedPartitions",
                     chunk_rows: int = ORDER_GUARD_CHUNK_ROWS,
                     row_bytes: int = 256) -> dict:
    """Partition quality by what the compact store actually pays for.

    Edge cut is the classic METIS objective, but §3.3's wire cost scales
    with Σ_m |halo(G_m)| (rows pulled per sync) and the store residency
    with |boundary| (union of halos) — two partitions with equal cut can
    differ a lot on both.  Reported side by side so fig9 scores the real
    cost drivers.

    The worklist columns score the *locality* of the layout, not just its
    size: ``wl_occupancy`` is the stacked :class:`ChunkWorklist` fraction
    of (row_block × chunk) pairs the streamed halo kernels must visit at
    ``chunk_rows`` geometry (below ``SKIP_OCCUPANCY_MAX`` the skip kernel
    is auto-selected), and ``stream_bytes_skip`` / ``stream_bytes_dense``
    estimate the per-layer slab traffic of the skip vs dense stream
    (visited resp. all chunks × ``chunk_rows`` slab rows × ``row_bytes``
    per row — default 256 B = the 64-wide fp32 hidden slab).
    """
    sizes = sp.local_valid.sum(axis=1).astype(np.float64)
    wl = sp.chunk_worklist(chunk_rows, block_rows=ORDER_BLOCK_ROWS)
    chunk_bytes = chunk_rows * row_bytes
    return {
        "edge_cut": edge_cut(g, sp.assign),
        "halo_rows": sp.pull_rows(),              # Σ_m |halo(G_m)|
        "boundary": sp.num_boundary,              # |∪_m halo(G_m)|
        "boundary_frac": sp.boundary_fraction(),
        "balance": float(sizes.max() / max(sizes.mean(), 1.0)),
        "order": sp.order,
        "wl_occupancy": wl.occupancy,
        "wl_visited": wl.visited_chunks,
        "wl_total": wl.total_pairs,
        "stream_bytes_skip": wl.visited_chunks * chunk_bytes,
        "stream_bytes_dense": wl.total_pairs * chunk_bytes,
    }


# ---------------------------------------------------------------------------
# Streamed-kernel occupancy worklist
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class ChunkWorklist:
    """Static (row-block × slab-chunk) occupancy of a streamed halo SpMM.

    The chunk-skipping kernel (``repro.kernels.spmm.halo_spmm_skip_pallas``)
    re-indexes the innermost grid dimension of the streamed pull+aggregate
    through this CSR-style worklist: row block i visits exactly the chunks
    ``ids[..., i, :cnt[..., i]]`` (ascending), instead of all
    ``n_chunks`` — owner-sharded halo references are strongly clustered
    by owner, so most (row_block, chunk) pairs reference nothing and DMA-
    ing them is pure waste.  ``ids`` is padded to the static
    ``max_chunks`` width with a *repeat of the last visited chunk* (0 for
    empty blocks), so padded grid steps re-address the block already in
    VMEM (no new DMA) and are masked out of the FMA by ``t >= cnt``.

    Computed once at partition time from the halo tables (numpy, host
    side); geometry must match the kernel call: ``block_rows`` rows per
    row block after the caller pads rows up to a ``block_rows`` multiple,
    ``chunk_rows``-row slab chunks over the (H+1)-row slab.
    """

    chunk_rows: int          # slab rows per streamed chunk
    block_rows: int          # output rows per row block (kernel BLOCK_ROWS)
    n_chunks: int            # ceil(slab_rows / chunk_rows)
    max_chunks: int          # static padded worklist width (grid dim)
    ids: np.ndarray          # (..., n_row_blocks, max_chunks) int32
    cnt: np.ndarray          # (..., n_row_blocks) int32 — valid prefix len

    @property
    def visited_chunks(self) -> int:
        """Σ chunk visits — what the skip kernel actually streams."""
        return int(self.cnt.sum())

    @property
    def total_pairs(self) -> int:
        """row_blocks × n_chunks (× M) — what the dense stream pays."""
        return int(np.prod(self.cnt.shape) * self.n_chunks)

    @property
    def occupancy(self) -> float:
        """visited / total — the static kernel-selection signal."""
        return self.visited_chunks / max(self.total_pairs, 1)


def build_chunk_worklist(nbr: np.ndarray, n_slab_rows: int,
                         chunk_rows: int, block_rows: int = 128
                         ) -> ChunkWorklist:
    """Occupancy worklist of an ELL adjacency against a slab.

    Args:
      nbr: (rows, deg) or (M, rows, deg) slab-row indices; the sentinel
        row ``n_slab_rows - 1`` (the zero row every padding entry points
        at) is excluded — chunks referenced only through it contribute
        exactly zero and are skipped.
      n_slab_rows: gather-table rows *before* chunk padding (H+1).
      chunk_rows / block_rows: streamed-kernel tile geometry; rows are
        assumed padded up to a ``block_rows`` multiple by the caller
        (``repro.kernels.spmm.ops`` pads to 128 = BLOCK_ROWS), extra rows
        referencing nothing.
    """
    nbr = np.asarray(nbr)
    stacked = nbr.ndim == 3
    batch = nbr.shape[0] if stacked else 1
    rows = nbr.shape[-2]
    n_blocks = max(-(-rows // block_rows), 1)
    n_chunks = max(-(-n_slab_rows // chunk_rows), 1)
    sentinel = n_slab_rows - 1

    flat = nbr.reshape(batch, rows, -1)
    block_of = np.minimum(np.arange(rows) // block_rows, n_blocks - 1)
    occ = np.zeros((batch, n_blocks, n_chunks), bool)
    for m in range(batch):
        valid = flat[m] < sentinel
        b = np.broadcast_to(block_of[:, None], flat[m].shape)[valid]
        occ[m, b, flat[m][valid] // chunk_rows] = True

    cnt = occ.sum(axis=2).astype(np.int32)
    max_chunks = max(int(cnt.max()), 1)
    ids = np.zeros((batch, n_blocks, max_chunks), np.int32)
    for m in range(batch):
        for i in range(n_blocks):
            ch = np.where(occ[m, i])[0]
            ids[m, i, :len(ch)] = ch
            # Pad with the last visited chunk: the pipeline re-addresses
            # the resident block instead of DMA-ing a fresh one.
            ids[m, i, len(ch):] = ch[-1] if len(ch) else 0
    if not stacked:
        ids, cnt = ids[0], cnt[0]
    return ChunkWorklist(chunk_rows=chunk_rows, block_rows=block_rows,
                         n_chunks=n_chunks, max_chunks=max_chunks,
                         ids=ids, cnt=cnt)


# ---------------------------------------------------------------------------
# Stacked per-subgraph views
# ---------------------------------------------------------------------------

def build_pull_plan(halo_slots: np.ndarray, halo_valid: np.ndarray,
                    halo_size: int, shard_rows: int) -> "PullPlan":
    """Ragged per-(owner, requester) collective-pull routing over ANY
    owner-sharded slot layout (see :class:`PullPlan`).

    The only layout facts the plan depends on are that slots are grouped
    in M contiguous shards of ``shard_rows`` rows (owner = slot //
    shard_rows) with the owner's zero sentinel at the shard's last row —
    so the same builder routes both the training store (boundary rows
    only, ``StackedPartitions.pull_plan``) and the all-node serving
    store (``repro.core.serving.build_serve_plan``), which lay slots out
    differently but share the shard/sentinel convention.

    halo_slots: (M, H) slot of each halo entry (any value where invalid);
    halo_valid: (M, H) bool; padding pairs route owner-sentinel rows into
    the slab's sentinel position ``halo_size``.
    """
    M = halo_slots.shape[0]
    sr = shard_rows
    owner_of = halo_slots // sr                       # (M, H)
    counts = np.zeros((M, M), np.int64)
    for m in range(M):
        np.add.at(counts[m], owner_of[m][halo_valid[m]], 1)
    K = max(int(counts.max()), 1)
    send_off = np.full((M, M, K), sr - 1, np.int32)
    recv_pos = np.full((M, M, K), halo_size, np.int32)
    for m in range(M):                                # requester
        for j in range(M):                            # owner
            sel = np.where(halo_valid[m] & (owner_of[m] == j))[0]
            send_off[j, m, :len(sel)] = halo_slots[m, sel] - j * sr
            recv_pos[m, j, :len(sel)] = sel
    return PullPlan(max_rows=K, send_offsets=send_off,
                    recv_positions=recv_pos)


@dataclasses.dataclass
class PullPlan:
    """Ragged per-(owner, requester) routing of the collective halo pull.

    For every requester m and owner j, the plan lists which rows of owner
    j's store *shard* feed subgraph m's halo slab, padded to a common
    width ``max_rows`` so the exchange is one dense ``all_to_all``:

      send_offsets[j, m, k]   owner-local row offset (< shard_rows) of the
                              k-th row owner j ships to requester m;
                              padding points at owner j's zero sentinel.
      recv_positions[m, j, k] halo-slab position (< H+1) where requester m
                              lands that row; padding points at slab row H
                              (the slab's zero sentinel).

    Both tables are **device-blockable**: offsets are owner-local and
    positions requester-local, so sharding the leading axis over a mesh
    data axis of D devices hands each device the k = M/D contiguous
    (owner-block, requester-block) slices it needs — this is what lets
    ``collective_pull``/``shard_push`` run with parts-per-device > 1
    (M exceeding the pod size) without rebuilding the plan.
    """

    max_rows: int                 # K — padded per-pair row count
    send_offsets: np.ndarray      # (M_owner, M_req, K) int32
    recv_positions: np.ndarray    # (M_req, M_owner, K) int32


@dataclasses.dataclass
class StackedPartitions:
    """All M subgraphs padded to identical sizes and stacked on axis 0.

    Sentinel id == num_nodes (a zero row is appended to every global table).

    Boundary / compact-store views: the **boundary set** is the union of
    all subgraph halos — the only rows the stale store ever serves.  Slots
    are **owner-sharded**: every boundary node is owned by the part it is
    local to, and the slot space is laid out as M contiguous shards of
    ``shard_rows`` rows each (``slot = owner · shard_rows + rank``), the
    last row of every shard a per-owner zero sentinel.  Device m of a
    "data"-sharded mesh therefore holds exactly the rows it pushes, and a
    pull is a collective gather of each subgraph's halo slots from the
    owner shards (see ``repro.core.halo_exchange``).  ``store_map`` sends
    non-boundary ids (and the global sentinel id N) to the *global*
    sentinel slot ``M·shard_rows − 1``.
    """

    num_nodes: int
    num_parts: int
    num_boundary: int        # |boundary| — true boundary nodes, no padding
    shard_rows: int          # rows per owner shard (incl. its sentinel row)
    assign: np.ndarray       # (N,) int32 node → owning part
    local_ids: np.ndarray    # (M, S) int32, global node id or sentinel
    local_valid: np.ndarray  # (M, S) bool
    halo_ids: np.ndarray     # (M, H) int32, global node id or sentinel
    halo_valid: np.ndarray   # (M, H) bool
    in_nbr: np.ndarray       # (M, S, Din) int32 → local slot index or S
    in_wts: np.ndarray       # (M, S, Din) float32
    out_nbr: np.ndarray      # (M, S, Dout) int32 → halo slot index or H
    out_wts: np.ndarray      # (M, S, Dout) float32
    labels: np.ndarray       # (M, S) int32
    train_mask: np.ndarray   # (M, S) bool (False at padding)
    val_mask: np.ndarray     # (M, S) bool
    test_mask: np.ndarray    # (M, S) bool
    # Owner-sharded compact-store indexing, emitted for HaloExchange.
    store_map: np.ndarray    # (N+1,) int32 global id → slot (sentinel: R-1)
    store_ids: np.ndarray    # (R,) int32 slot → global id, N at pad rows
    store_owner: np.ndarray  # (R,) int32 slot → owner part
    sentinel_slots: np.ndarray  # (M,) int32 per-part sentinel slot
    halo_slots: np.ndarray   # (M, H) int32 store slot of each halo entry
    local_slots: np.ndarray  # (M, S) int32 store slot of each local row
                             #   (part m's sentinel where not boundary)
    local_boundary: np.ndarray  # (M, S) bool valid AND boundary (served)
    out_nbr_store: np.ndarray   # (M, S, Dout) int32 → store slot or R-1
    out_nbr_global: np.ndarray  # (M, S, Dout) int32 → global id or N
    order: str = "none"      # local-row layout knob build_partitions used

    @property
    def part_size(self) -> int:
        return self.local_ids.shape[1]

    @property
    def halo_size(self) -> int:
        return self.halo_ids.shape[1]

    @property
    def store_rows(self) -> int:
        """Total slab rows R = num_parts · shard_rows (incl. sentinels)."""
        return len(self.store_ids)

    def halo_ratio(self) -> np.ndarray:
        """Paper Fig. 9 metric: |out-of-subgraph| / |in-subgraph| per part."""
        return (self.halo_valid.sum(axis=1)
                / np.maximum(self.local_valid.sum(axis=1), 1))

    def boundary_fraction(self) -> float:
        """|boundary| / N — the compact-vs-dense store row ratio."""
        return self.num_boundary / max(self.num_nodes, 1)

    def push_rows(self) -> int:
        """Σ_m |boundary ∩ V_m| — rows shipped per PUSH sync (§3.3)."""
        return int(self.local_boundary.sum())

    def pull_rows(self) -> int:
        """Σ_m |halo(G_m)| — rows shipped per PULL sync (§3.3)."""
        return int(self.halo_valid.sum())

    def shards_per_device(self, num_devices: int) -> int:
        """k = M / num_devices under the collective paths; raises the
        spelled-out ValueError of :func:`parts_per_device` when M is not
        a multiple (the collective slot math would silently be wrong;
        the dense-gather fallback is the correct choice there)."""
        return parts_per_device(self.num_parts, num_devices)

    def chunk_worklist(self, chunk_rows: int, block_rows: int = 128
                       ) -> ChunkWorklist:
        """Per-subgraph (row_block × chunk) occupancy of the out-ELL
        against the (H+1)-row pulled halo slab (see
        :class:`ChunkWorklist`): ids (M, n_blocks, max_chunks),
        cnt (M, n_blocks)."""
        return build_chunk_worklist(self.out_nbr, self.halo_size + 1,
                                    chunk_rows, block_rows)

    def pull_plan(self) -> PullPlan:
        """Ragged collective-pull routing (see :class:`PullPlan`)."""
        return build_pull_plan(self.halo_slots, self.halo_valid,
                               self.halo_size, self.shard_rows)


def build_partitions(g: Graph, num_parts: int, method: str = "greedy",
                     seed: int = 0, pad_multiple: int = 8,
                     halo_weight: float = 0.0, order: str = "none",
                     order_chunk_rows: int = None) -> StackedPartitions:
    """Partition ``g`` into the stacked per-subgraph views.

    ``order`` selects the local-row layout of every part: ``"none"``
    keeps ascending global ids; ``"rcm"`` reorders each part's rows by
    reverse Cuthill–McKee over its induced subgraph (and re-lays the
    halo slab's owner runs by first-referencing row) so consecutive
    ``ORDER_BLOCK_ROWS``-row blocks reference clustered slab chunks —
    a pure local-row permutation that drives :class:`ChunkWorklist`
    occupancy down (see the module docstring).  Each part keeps its
    identity order unless RCM strictly helps at the ``order_chunk_rows``
    guard geometry (default ``ORDER_GUARD_CHUNK_ROWS``; pass the same
    ``chunk_rows`` the epoch streams with), so occupancy never
    increases.
    """
    if order not in LOCAL_ORDERS:
        raise ValueError(f"order={order!r} not in {LOCAL_ORDERS}")
    assign = PARTITIONERS[method](g, num_parts, seed=seed,
                                  halo_weight=halo_weight)
    n = g.num_nodes
    rows, cols, wts = gcn_norm_weights(g)

    def _pad_to(x: int) -> int:
        return max(((x + pad_multiple - 1) // pad_multiple) * pad_multiple,
                   pad_multiple)

    parts_local = [np.where(assign == m)[0].astype(np.int32)
                   for m in range(num_parts)]
    # Halo = out-of-subgraph endpoints of P rows owned by the part,
    # ordered by (owner, ...): each subgraph's halo slab is then laid out
    # as contiguous owner runs — the slab-side mirror of the owner-
    # sharded store.  Local rows referencing few owners touch few slab
    # ranges, which is what makes the streamed kernel's (row_block ×
    # chunk) worklist sparse (gathers do no arithmetic, and the per-row
    # ELL edge order is untouched, so results are bitwise identical for
    # any slab-run layout).  Within each owner run the rows sort by id
    # (order="none") or by first-referencing local row (order="rcm" —
    # keeping a block's references contiguous in the slab).
    e_part = assign[rows]
    parts_out = []               # per-part out-edge COO (global ids)
    parts_halo = []
    for m in range(num_parts):
        sel = e_part == m
        out = assign[cols[sel]] != m
        parts_out.append((rows[sel][out], cols[sel][out]))
        parts_halo.append(np.unique(cols[sel][out]).astype(np.int32))

    S = _pad_to(max(len(p) for p in parts_local))
    H = _pad_to(max((len(h) for h in parts_halo), default=1))

    chunk_rows = (ORDER_GUARD_CHUNK_ROWS if order_chunk_rows is None
                  else order_chunk_rows)
    n_blocks = max(-(-S // ORDER_BLOCK_ROWS), 1)
    n_chunks = max(-(-(H + 1) // chunk_rows), 1)
    for m in range(num_parts):
        loc, halo = parts_local[m], parts_halo[m]
        r_out, c_out = parts_out[m]
        owners = assign[halo]
        # Candidate A — identity: ascending local ids, owner runs by id.
        halo_a = halo[np.lexsort((halo, owners))]
        if order != "rcm" or len(loc) == 0:
            parts_halo[m] = halo_a
            continue
        g2l = np.full(n, -1, np.int64)
        g2l[loc] = np.arange(len(loc))
        # Candidate B — RCM local rows + first-ref slab runs.
        ip_l, ix_l = _induced_csr(loc.astype(np.int64), g2l, g.indptr,
                                  g.indices)
        perm = reverse_cuthill_mckee(ip_l, ix_l)
        loc_b = loc[perm]
        pos_b = np.full(n, -1, np.int64)
        pos_b[loc_b] = np.arange(len(loc))
        rows_b = pos_b[r_out]
        hidx = np.searchsorted(halo, c_out)
        first_ref = np.full(len(halo), S, np.int64)
        if len(c_out):
            np.minimum.at(first_ref, hidx, rows_b)
        halo_b = halo[np.lexsort((halo, first_ref, owners))]
        # Keep whichever candidate the streamed kernels visit fewer
        # (row_block × chunk) pairs under — RCM only ever on a win, so
        # the stacked worklist occupancy is non-increasing vs "none".
        pos_ha = np.full(n, -1, np.int64)
        pos_ha[halo_a] = np.arange(len(halo))
        pos_hb = np.full(n, -1, np.int64)
        pos_hb[halo_b] = np.arange(len(halo))
        v_a = _visited_pairs(g2l[r_out], pos_ha[c_out], n_blocks,
                             n_chunks, chunk_rows)
        v_b = _visited_pairs(rows_b, pos_hb[c_out], n_blocks, n_chunks,
                             chunk_rows)
        if v_b <= v_a:
            parts_local[m] = loc_b
            parts_halo[m] = halo_b
        else:
            parts_halo[m] = halo_a

    local_ids = np.full((num_parts, S), n, np.int32)
    local_valid = np.zeros((num_parts, S), bool)
    halo_ids = np.full((num_parts, H), n, np.int32)
    halo_valid = np.zeros((num_parts, H), bool)
    in_ells, out_ells = [], []
    max_din, max_dout = 1, 1

    for m in range(num_parts):
        loc, halo = parts_local[m], parts_halo[m]
        local_ids[m, :len(loc)] = loc
        local_valid[m, :len(loc)] = True
        halo_ids[m, :len(halo)] = halo
        halo_valid[m, :len(halo)] = True

        g2l = np.full(n + 1, S, np.int64)   # global → local slot
        g2l[loc] = np.arange(len(loc))
        g2h = np.full(n + 1, H, np.int64)   # global → halo slot
        g2h[halo] = np.arange(len(halo))

        sel = assign[rows] == m
        r_m, c_m, w_m = rows[sel], cols[sel], wts[sel]
        local_rows = g2l[r_m].astype(np.int32)
        is_in = assign[c_m] == m

        ell_in = coo_to_ell(local_rows[is_in],
                            g2l[c_m[is_in]].astype(np.int32),
                            w_m[is_in], S, S)
        ell_out = coo_to_ell(local_rows[~is_in],
                             g2h[c_m[~is_in]].astype(np.int32),
                             w_m[~is_in], S, H)
        in_ells.append(ell_in)
        out_ells.append(ell_out)
        max_din = max(max_din, ell_in.max_degree)
        max_dout = max(max_dout, ell_out.max_degree)

    max_din, max_dout = _pad_to(max_din), _pad_to(max_dout)

    def _stack(ells: list[EllMatrix], deg: int, n_cols: int):
        nbr = np.full((num_parts, S, deg), n_cols, np.int32)
        w = np.zeros((num_parts, S, deg), np.float32)
        for m, e in enumerate(ells):
            nbr[m, :, :e.max_degree] = e.nbr
            w[m, :, :e.max_degree] = e.wts
        return nbr, w

    in_nbr, in_wts = _stack(in_ells, max_din, S)
    out_nbr, out_wts = _stack(out_ells, max_dout, H)

    labels = np.zeros((num_parts, S), np.int32)
    tr = np.zeros((num_parts, S), bool)
    va = np.zeros((num_parts, S), bool)
    te = np.zeros((num_parts, S), bool)
    for m, loc in enumerate(parts_local):
        labels[m, :len(loc)] = g.labels[loc]
        tr[m, :len(loc)] = g.train_mask[loc]
        va[m, :len(loc)] = g.val_mask[loc]
        te[m, :len(loc)] = g.test_mask[loc]

    # Boundary set = union of all halos, laid out **owner-sharded**: part
    # m's locally-owned boundary nodes occupy the contiguous slot range
    # [m·shard_rows, m·shard_rows + |owned_m|), the last row of each shard
    # is that owner's zero sentinel, and the global sentinel (non-boundary
    # ids and id n) is the last row of the last shard.  Sharding the slab
    # slot-wise over the mesh "data" axis then gives every device exactly
    # the rows it pushes; pulls gather from the owner shards.
    boundary = (np.unique(np.concatenate(parts_halo))
                if any(len(h) for h in parts_halo)
                else np.empty(0, np.int32)).astype(np.int32)
    B = len(boundary)
    owned = [np.sort(boundary[assign[boundary] == m])
             for m in range(num_parts)]
    shard_rows = _pad_to(max((len(o) for o in owned), default=0) + 1)
    R = num_parts * shard_rows
    store_map = np.full(n + 1, R - 1, np.int32)
    store_ids = np.full(R, n, np.int32)
    store_owner = np.repeat(np.arange(num_parts, dtype=np.int32),
                            shard_rows)
    for m, o in enumerate(owned):
        slots = m * shard_rows + np.arange(len(o), dtype=np.int32)
        store_map[o] = slots
        store_ids[slots] = o
    sentinel_slots = ((np.arange(num_parts, dtype=np.int32) + 1)
                      * shard_rows - 1)
    halo_slots = store_map[halo_ids]
    raw_slots = store_map[local_ids]
    local_boundary = local_valid & (raw_slots != R - 1)
    # Non-boundary / padding local rows push into the *owner's* sentinel
    # row so scatters never leave the device-local shard.
    local_slots = np.where(local_boundary, raw_slots,
                           sentinel_slots[:, None]).astype(np.int32)

    # Per-part remaps of the out-ELL: halo-slot → store-slot / global id,
    # so the out-of-subgraph product can gather straight from the shared
    # compact slab (or from x_global for layer 0) with no per-part table.
    out_nbr_store = np.empty_like(out_nbr)
    out_nbr_global = np.empty_like(out_nbr)
    for m in range(num_parts):
        ext_s = np.concatenate([halo_slots[m], [R - 1]]).astype(np.int32)
        ext_g = np.concatenate([halo_ids[m], [n]]).astype(np.int32)
        out_nbr_store[m] = ext_s[out_nbr[m]]
        out_nbr_global[m] = ext_g[out_nbr[m]]

    return StackedPartitions(
        num_nodes=n, num_parts=num_parts, num_boundary=B,
        shard_rows=shard_rows, assign=assign,
        local_ids=local_ids, local_valid=local_valid,
        halo_ids=halo_ids, halo_valid=halo_valid,
        in_nbr=in_nbr, in_wts=in_wts, out_nbr=out_nbr, out_wts=out_wts,
        labels=labels, train_mask=tr, val_mask=va, test_mask=te,
        store_map=store_map, store_ids=store_ids, store_owner=store_owner,
        sentinel_slots=sentinel_slots,
        halo_slots=halo_slots, local_slots=local_slots,
        local_boundary=local_boundary,
        out_nbr_store=out_nbr_store, out_nbr_global=out_nbr_global,
        order=order)
