"""Online embedding serving over the owner-sharded DIGEST store.

The serving store is a single-layer, all-node owner-sharded slab,

    slot(v) = assign[v] · (S + 1) + local_row(v),

with S the padded part size, one zero sentinel row per shard at local row
S, and the global sentinel the last row (``serve_map[N] = R - 1``).  A
refresh pushes h^(L-1) (:func:`repro_torch.core.digest.top_layer_reps`)
through the same ``halo_exchange.push`` as training and bumps the int32
``version`` scalar, the cache-invalidation signal.

:func:`serve_query` answers a batch of global node ids: it gathers the
(L-1)-layer rows of each query node and its in-neighbours from the store
(the gcn/sage reduction rides :func:`repro_torch.kernels.spmm.halo_spmm`
and its kernel-selection ladder; GAT's attention gathers rows through
``halo_gather``) and runs only the top layer.  The aggregation mirrors the
full-graph forward's ELL math term for term, so on the CPU served gcn/sage
logits equal ``full_graph_forward`` bitwise on an fp32 store.

A set-associative (``cache_ways``-way, LRU) hot-row cache in front of the
store holds finished logits rows tagged by (serve slot, store version);
a refresh invalidates every entry by bumping the version.  Lookup and
miss-fill are vectorised, and the fill is deterministic: among one set's
misses the highest batch index wins (a scatter-max), and losers write a
padded dummy set row that is sliced off.

The multi-device engine (``serve_query_sharded``) belongs to a later slice.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.core import halo_exchange
from repro_torch.core.halo_exchange import PRECISIONS, HaloPrecision
from repro_torch.device import resolve_device, synchronize
from repro_torch.graph.partition import PullPlan, build_pull_plan
from repro_torch.kernels.spmm import halo_gather, halo_spmm
from repro_torch.nn import dense


# ---------------------------------------------------------------------------
# Static serving knobs
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """Serving knobs: batch and cache geometry, storage precision and the
    halo_spmm selection-ladder overrides of the query-time reduction."""

    batch_size: int = 256
    # Hot-row cache capacity in rows; 0 disables the cache (queries
    # always recompute).  Must be a multiple of cache_ways.
    cache_rows: int = 0
    cache_ways: int = 4
    # Serving-store storage precision (same vocabulary as HaloPrecision).
    storage: str = "fp32"
    # Aggregation backend + halo_spmm selection-ladder overrides (see
    # repro_torch.kernels.spmm.ops).
    backend: str = "auto"
    resident_max_bytes: Optional[int] = None
    chunk_rows: Optional[int] = None
    skip_occupancy_max: Optional[float] = None

    def __post_init__(self):
        if self.storage not in PRECISIONS:
            raise ValueError(f"storage {self.storage!r} not in {PRECISIONS}")
        if self.batch_size < 1:
            raise ValueError(f"batch_size {self.batch_size} < 1")
        if self.cache_ways < 1:
            raise ValueError(f"cache_ways {self.cache_ways} < 1")
        if self.cache_rows < 0 or self.cache_rows % self.cache_ways:
            raise ValueError(
                f"cache_rows {self.cache_rows} must be a non-negative "
                f"multiple of cache_ways {self.cache_ways}")

    @property
    def cache_sets(self) -> int:
        return self.cache_rows // self.cache_ways

    @property
    def precision(self) -> HaloPrecision:
        return HaloPrecision(self.storage)


# ---------------------------------------------------------------------------
# Host-side plan: slot layout, routing, query ELL
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class ServePlan:
    """Host-side serving layout/routing (numpy; build once per graph).

    ``query_data(device)`` / ``refresh_data(device)`` bundle the tensors
    :func:`serve_query` and the refresh take.
    """

    num_nodes: int
    num_parts: int
    part_rows: int            # S — padded local rows per part
    serve_rows: int           # S + 1 (per-shard sentinel row included)
    store_rows: int           # R = M · (S + 1)
    halo_size: int            # H — per-part out-of-part slots
    serve_map: np.ndarray     # (N+1,) global id → serve slot (sentinel R-1)
    local_ids: np.ndarray     # (M, S) global id of each local row
    local_valid: np.ndarray   # (M, S) bool
    local_slots: np.ndarray   # (M, S) serve slot of each local row
    sentinel_slots: np.ndarray  # (M,) per-shard sentinel slots
    halo_slots: np.ndarray    # (M, H) serve slot of each halo entry
    pull: PullPlan            # serving-layout collective-pull routing
    nbr: np.ndarray           # (N+1, Din) in-neighbour global ids, sentinel N
    wts: np.ndarray           # (N+1, Din) in-edge weights

    def query_data(self, device="cuda") -> dict:
        """Tensors of :func:`serve_query` (the ``qdata`` dict)."""
        dev = resolve_device(device)
        return {k: torch.from_numpy(getattr(self, k)).to(dev)
                for k in ("serve_map", "nbr", "wts")}

    def refresh_data(self, device="cuda") -> dict:
        """Tensors of the refresh step (the ``rdata`` dict)."""
        dev = resolve_device(device)
        return {k: torch.from_numpy(getattr(self, k)).to(dev)
                for k in ("local_ids", "local_valid", "local_slots",
                          "sentinel_slots")}


def build_serve_plan(data: dict) -> ServePlan:
    """Derive the serving layout from a ``prepare_graph_data`` dict (needs
    its host-side ``_sp`` entry and the full M=1 view)."""
    sp = data.get("_sp")
    if sp is None:
        raise ValueError("build_serve_plan needs prepare_graph_data's "
                         "host-side '_sp' metadata (don't strip it "
                         "before building the plan)")
    local_ids = np.asarray(sp.local_ids)
    local_valid = np.asarray(sp.local_valid)
    M, S = local_ids.shape
    srows = S + 1
    R = M * srows
    n = int(sp.num_nodes)

    serve_map = np.full(n + 1, R - 1, np.int32)
    for m in range(M):
        v = local_valid[m]
        serve_map[local_ids[m][v]] = m * srows + np.where(v)[0]
    local_slots = (np.arange(M, dtype=np.int32)[:, None] * srows
                   + np.arange(S, dtype=np.int32)[None, :])
    sentinel_slots = (np.arange(M, dtype=np.int32) + 1) * srows - 1

    halo_ids = np.asarray(sp.halo_ids)
    halo_valid = np.asarray(sp.halo_valid)
    halo_slots = np.where(halo_valid,
                          serve_map[np.minimum(halo_ids, n)],
                          R - 1).astype(np.int32)
    pull = build_pull_plan(halo_slots, halo_valid, sp.halo_size, srows)

    # Full-view in-ELL re-keyed to (n+1) global-id rows: row v lists v's
    # in-neighbours (full view local index == global id by construction),
    # row n is the all-sentinel padding row queries clamp into.
    full_nbr = data["full_struct"]["in_nbr"][0].cpu().numpy()
    full_wts = data["full_struct"]["in_wts"][0].cpu().numpy()
    full_ids = data["full_ids"][0].cpu().numpy()
    if not np.array_equal(full_ids[:n], np.arange(n)):
        raise ValueError("full view rows are not in ascending global-id "
                         "order; the serving query ELL cannot be "
                         "re-keyed by node id")
    din = full_nbr.shape[1]
    nbr = np.full((n + 1, din), n, np.int32)
    wts = np.zeros((n + 1, din), np.float32)
    nbr[:n] = np.where(full_nbr[:n] >= n, n, full_nbr[:n])
    wts[:n] = full_wts[:n]

    return ServePlan(num_nodes=n, num_parts=M, part_rows=S,
                     serve_rows=srows, store_rows=R,
                     halo_size=int(sp.halo_size), serve_map=serve_map,
                     local_ids=local_ids, local_valid=local_valid,
                     local_slots=local_slots.astype(np.int32),
                     sentinel_slots=sentinel_slots,
                     halo_slots=halo_slots, pull=pull, nbr=nbr, wts=wts)


# ---------------------------------------------------------------------------
# Serving store: init + in-place refresh
# ---------------------------------------------------------------------------

def init_serve_store(plan: ServePlan, hidden: int,
                     precision: HaloPrecision = HaloPrecision(),
                     device="cuda") -> dict:
    """All-node single-layer serving slab + the version scalar:
    {"data": (1, R, hidden)[, "scale"], "version": int32 ()}."""
    store = halo_exchange.init_store(1, plan.store_rows - 1, hidden,
                                     precision, device)
    store["version"] = torch.zeros((), dtype=torch.int32,
                                   device=store["data"].device)
    return store


def store_bare(store: dict) -> dict:
    """The HaloExchange view of a serving store (version leaf stripped)."""
    return {k: store[k] for k in ("data", "scale") if k in store}


def make_refresh_fn(mesh=None, donate: bool = True):
    """Serving-store refresh ``refresh(store, reps_top, rdata) -> store``.

    ``reps_top`` is the (N_pad, hidden) top-layer input table
    (:func:`repro_torch.core.digest.top_layer_reps`) and ``rdata`` is
    ``ServePlan.refresh_data()``.  Every refresh bumps ``version``.

    ``donate=True`` — the counterpart of XLA buffer donation — writes the
    new rows, scales and version into the store's own tensors in place,
    so a deployment holds one store-sized allocation across refreshes;
    the returned dict holds the same tensors and the argument must not
    be read as the old store afterwards.  ``donate=False`` writes into
    copies and leaves the argument untouched, which is what
    :func:`refresh_or_degrade` needs to keep serving the old store when a
    refresh fails.

    ``mesh`` selects the multi-device refresh, which belongs to a later
    slice of the port.
    """
    if mesh is not None:
        raise NotImplementedError("the mesh refresh (shard_push) is ported "
                                  "with the multi-device slice")

    def refresh(store, reps_top, rdata):
        ids = torch.clamp_max(rdata["local_ids"].long(),
                              reps_top.shape[0] - 1)
        reps = reps_top[ids][:, None]                   # (M, 1, S, hidden)
        new = halo_exchange.push(store_bare(store), rdata["local_slots"],
                                 rdata["local_valid"], reps,
                                 rdata["sentinel_slots"], inplace=donate)
        if donate:
            new["version"] = store["version"].add_(1)
        else:
            new["version"] = store["version"] + 1
        return new

    return refresh


def refresh_or_degrade(refresh_fn, store, reps_top, rdata,
                       stats: dict = None) -> tuple[dict, dict]:
    """Deploy a refresh; on ANY failure keep serving the old store.

    A refresh that raises must not take serving down: the previous store
    keeps answering, and since its version was never bumped every cache
    entry stays valid.  The failure is counted in
    ``stats["degraded_refreshes"]``.  Pair with
    ``make_refresh_fn(donate=False)``: an in-place refresh that fails
    part-way may have overwritten the old store.

    Returns ``(store, stats)`` — the new store on success, the old one on
    failure; ``stats`` gains ``refreshes``/``degraded_refreshes`` counts.
    """
    stats = dict(stats) if stats else {"refreshes": 0,
                                       "degraded_refreshes": 0}
    try:
        new = refresh_fn(store, reps_top, rdata)
        synchronize(new)
    except Exception:
        stats["degraded_refreshes"] += 1
        return store, stats
    stats["refreshes"] += 1
    return new, stats


# ---------------------------------------------------------------------------
# Hot-row cache
# ---------------------------------------------------------------------------

def init_cache(scfg: ServeConfig, width: int, device="cuda") -> dict:
    """Empty hot-row cache for rows of ``width`` (= num_classes).

    tags/vers are -1 (never match), ``last`` is the LRU clock (per-way
    last access step), ``step`` the batch counter, hits/misses the
    counters.  ``cache_rows == 0`` keeps only the counters.
    """
    dev = resolve_device(device)

    def full(shape, value, dtype=torch.int32):
        return torch.full(shape, value, dtype=dtype, device=dev)

    counters = {"hits": full((), 0), "misses": full((), 0)}
    if scfg.cache_rows == 0:
        return counters
    sets, ways = scfg.cache_sets, scfg.cache_ways
    return {"tags": full((sets, ways), -1), "vers": full((sets, ways), -1),
            "last": full((sets, ways), 0),
            "rows": full((sets, ways, width), 0.0, torch.float32),
            "step": full((), 0), **counters}


def hit_rate(cache: dict) -> float:
    """hits / (hits + misses) over every valid query served so far."""
    h, m = int(cache["hits"]), int(cache["misses"])
    return h / max(h + m, 1)


def _cache_lookup(cache, slots, version):
    """Vectorised set-associative probe: returns (hit, rows, line, way)."""
    sets = cache["tags"].shape[0]
    line = slots.long() % sets                              # (B,)
    hit_w = ((cache["tags"][line] == slots[:, None])
             & (cache["vers"][line] == version))            # (B, ways)
    hit = hit_w.any(dim=1)
    way = torch.argmax(hit_w.to(torch.int8), dim=1)         # first on ties
    return hit, cache["rows"][line, way], line, way


def _cache_commit(cache, slots, version, fresh_rows, hit, line, way, valid):
    """Touch LRU on hits, fill at most one victim way per set from the
    missed rows, and advance the counters — deterministic scatters."""
    sets, ways = cache["tags"].shape
    b = slots.shape[0]
    dev = slots.device
    arange = torch.arange(b, dtype=torch.int32, device=dev)
    step2 = cache["step"] + 1
    touched = cache["last"].clone()
    touched.view(-1).scatter_reduce_(
        0, line * ways + way,
        torch.where(hit & valid, step2, torch.zeros_like(step2)),
        reduce="amax")
    # Victim way per probe: any dead way first (empty tag or stale
    # version — both unreadable), else least-recently-used; the first
    # such way on ties.
    dead = (cache["vers"][line] != version) | (cache["tags"][line] < 0)
    evict_way = torch.argmin(
        torch.where(dead, torch.full_like(touched[line], -1),
                    touched[line]), dim=1)
    want = (~hit) & valid
    cand = torch.where(want, arange, torch.full_like(arange, -1))
    winner = torch.full((sets,), -1, dtype=torch.int32, device=dev)
    winner.scatter_reduce_(0, line, cand, reduce="amax")
    do = want & (winner[line] == arange)
    wline = torch.where(do, line, torch.full_like(line, sets))  # dummy row

    def fill(a, value):
        padded = torch.cat([a, a.new_zeros((1,) + tuple(a.shape[1:]))])
        padded[wline, evict_way] = value
        return padded[:sets]

    return {
        "tags": fill(cache["tags"], slots),
        "vers": fill(cache["vers"], version.to(torch.int32)),
        "last": fill(touched, step2),
        "rows": fill(cache["rows"], fresh_rows),
        "step": step2,
        "hits": cache["hits"] + (hit & valid).sum(dtype=torch.int32),
        "misses": cache["misses"] + want.sum(dtype=torch.int32),
    }


# ---------------------------------------------------------------------------
# The top-layer math over a query batch
# ---------------------------------------------------------------------------

def _side_spmm(scfg: ServeConfig, side: dict, wts) -> torch.Tensor:
    """One aggregation side through the halo_spmm selection ladder."""
    return halo_spmm(side["nbr"], wts, side["data"], side.get("scale"),
                     backend=scfg.backend,
                     resident_max_bytes=scfg.resident_max_bytes,
                     chunk_rows=scfg.chunk_rows,
                     skip_occupancy_max=scfg.skip_occupancy_max)


def _batch_top_layer(cfg, scfg: ServeConfig, p, h_self, sides):
    """Top GNN layer restricted to a query batch.

    ``sides`` are aggregation sides, each {"nbr": (B, D) row ids into its
    "data" slab, "wts": (B, D), "valid": (B, D), "data"[, "scale"]}; the
    query engine passes ONE side (the full-view ELL against the whole
    store).  Mirrors the layer math of ``repro_torch.models.gnn`` term for
    term.
    """
    if cfg.model == "gcn":
        agg = _side_spmm(scfg, sides[0], sides[0]["wts"])
        for s in sides[1:]:
            agg = agg + _side_spmm(scfg, s, s["wts"])
        return dense(agg, p["w"], p["b"])
    if cfg.model == "sage":
        denom = torch.sum(sides[0]["wts"], dim=1, keepdim=True)
        for s in sides[1:]:
            denom = denom + torch.sum(s["wts"], dim=1, keepdim=True)
        denom = torch.clamp_min(denom, 1e-12)
        agg = _side_spmm(scfg, sides[0], sides[0]["wts"] / denom)
        for s in sides[1:]:
            agg = agg + _side_spmm(scfg, s, s["wts"] / denom)
        return (dense(h_self, p["w_self"]) + dense(agg, p["w_nbr"])
                + p["b"])
    if cfg.model != "gat":
        raise ValueError(cfg.model)

    z_self = torch.einsum("bd,dhk->bhk", h_self, p["w"])
    s_dst = torch.einsum("bhk,hk->bh", z_self, p["a_dst"])
    scored = []
    for s in sides:
        rows = halo_gather(s["nbr"], s["data"], s.get("scale"))
        z = torch.einsum("bkd,dhj->bkhj", rows, p["w"])     # (B, D, h, j)
        e = torch.nn.functional.leaky_relu(
            s_dst[:, None, :] + torch.einsum("bkhj,hj->bkh", z, p["a_src"]),
            0.2)
        v = s["valid"][..., None]
        scored.append((z, torch.where(v, e, -1e30), v))
    m = scored[0][1].amax(dim=1)
    for _, e, _ in scored[1:]:
        m = torch.maximum(m, e.amax(dim=1))                 # (B, heads)
    probs = [torch.exp(e - m[:, None, :]) * v for _, e, v in scored]
    denom = torch.sum(probs[0], dim=1)
    for pe in probs[1:]:
        denom = denom + torch.sum(pe, dim=1)
    denom = denom + 1e-16
    out = 0.0
    for (z, _, _), pe in zip(scored, probs):
        out = out + torch.einsum("bkh,bkhj->bhj", pe / denom[:, None, :], z)
    return out.reshape(out.shape[0], -1) + p["b"]


# ---------------------------------------------------------------------------
# Query engine
# ---------------------------------------------------------------------------

def serve_query(cfg, scfg: ServeConfig, params, store, cache, qdata,
                q) -> tuple[torch.Tensor, dict]:
    """Batched prediction query against the serving store.

    q: (batch_size,) int32 global node ids on the store's device; pad
    short batches with ``num_nodes`` (padding rows are excluded from the
    cache counters and return the sentinel-row logits).  Returns
    (logits (B, classes), new_cache).
    """
    n = qdata["serve_map"].shape[0] - 1
    if tuple(q.shape) != (scfg.batch_size,):
        raise ValueError(
            f"query batch shape {tuple(q.shape)} != "
            f"(batch_size={scfg.batch_size},) — pad with the sentinel id "
            "num_nodes")
    valid = q < n
    qc = torch.clamp_max(q, n).long()
    slots = qdata["serve_map"][qc]

    data, scale = halo_exchange.layer_table(store_bare(store), 0)
    nbr_ids = qdata["nbr"][qc]                              # (B, Din)
    side = {"nbr": qdata["serve_map"][nbr_ids.long()],
            "wts": qdata["wts"][qc],
            "valid": nbr_ids < n, "data": data}
    if scale is not None:
        side["scale"] = scale
    h_self = halo_gather(slots, data, scale)
    p = params[f"layer_{cfg.num_layers - 1}"]
    fresh = _batch_top_layer(cfg, scfg, p, h_self, [side])

    if scfg.cache_rows == 0:
        counters = dict(cache)
        counters["misses"] = (cache["misses"]
                              + valid.sum(dtype=torch.int32))
        return fresh, counters
    hit, rows, line, way = _cache_lookup(cache, slots, store["version"])
    hit = hit & valid
    logits = torch.where(hit[:, None], rows, fresh)
    new_cache = _cache_commit(cache, slots, store["version"], fresh, hit,
                              line, way, valid)
    return logits, new_cache


# ---------------------------------------------------------------------------
# Workload synthesis (host-side)
# ---------------------------------------------------------------------------

def zipf_queries(num_nodes: int, batch_size: int, num_batches: int,
                 skew: float = 1.1, *, seed: int = 0,
                 hot_ids: Optional[np.ndarray] = None) -> np.ndarray:
    """(num_batches, batch_size) int32 Zipf(``skew``) query stream.

    Rank r is drawn with probability ∝ r^-skew; ``hot_ids`` optionally
    maps popularity rank → node id (e.g. nodes by descending degree, so
    hubs are hottest).  Identity by default.
    """
    rng = np.random.default_rng(seed)
    ranks = np.arange(1, num_nodes + 1, dtype=np.float64)
    prob = ranks ** -float(skew)
    prob /= prob.sum()
    draws = rng.choice(num_nodes, size=(num_batches, batch_size), p=prob)
    if hot_ids is not None:
        draws = np.asarray(hot_ids, np.int64)[draws]
    return draws.astype(np.int32)
