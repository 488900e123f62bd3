"""General owned/ghost index maps for ARBITRARY shard neighbor graphs.

Generalization of the slab path's plane-contiguous exchange to the
unstructured (spoke-mesh) decomposition, where a shard's ghosts may be
owned by any other shard (reference: ``dolfinx::common::IndexMap`` over
a graph-partitioned mesh, src/mesh.cpp:153-186, and the
``common::Scatterer`` pack -> MPI -> unpack exchange,
src/cgpoisson_problem.cpp:185-230).

Design: the exchange is decomposed at SETUP into a static
schedule of ``jax.lax.ppermute`` rounds.  Each round is a partial
permutation of the shard axis (every shard sends at most one buffer and
receives at most one), obtained by greedy edge-coloring of the shard
neighbor digraph; R rounds cover every edge (R = max degree for the
SFC-partitioned spoke mesh, typically 2-4).  Buffers are padded to the
schedule-wide maximum and masked — every shard runs the identical
program (shard_map requires static shapes).

The forward scatter (owner -> ghost copies, the only exchange the
owner-computes-rows solvers need) sends owned values along each edge;
the reverse scatter (ghost partial sums -> owner accumulate) runs the
same schedule backwards.
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np


@dataclasses.dataclass
class GeneralIndexMaps:
    """Static exchange metadata for one dof layout across S shards.

    Local vector layout per shard: ``[max_owned | max_ghost]`` slots,
    zero-padded; identical shapes on every shard.
    """

    nshards: int
    max_owned: int
    max_ghost: int
    nlocal: int
    local_gids: np.ndarray      # [S, nlocal] global dof per slot (pad 0)
    owned_counts: np.ndarray    # [S]
    ghost_counts: np.ndarray    # [S]
    owned_mask: np.ndarray      # [S, nlocal] bool
    # exchange schedule: R ppermute rounds
    rounds: Tuple                # tuple of perm lists [(src, dst), ...]
    buf: int                     # padded buffer length per round
    send_idx: np.ndarray         # [S, R, buf] local slots packed when
    #                              shard is a SENDER in round r (owned)
    send_mask: np.ndarray        # [S, R, buf] bool
    recv_idx: np.ndarray         # [S, R, buf] local ghost slots written
    #                              when shard is a RECEIVER in round r
    recv_mask: np.ndarray        # [S, R, buf] bool

    # -- host-side helpers -------------------------------------------------
    def local_of_global(self, shard: int, gids: np.ndarray) -> np.ndarray:
        lg = self.local_gids[shard]
        n_own = int(self.owned_counts[shard])
        n_gh = int(self.ghost_counts[shard])
        own = lg[:n_own]
        gh = lg[self.max_owned: self.max_owned + n_gh]
        out = np.empty(gids.shape, dtype=np.int64)
        pos = np.searchsorted(own, gids)
        pos_c = np.clip(pos, 0, max(n_own - 1, 0))
        is_own = (own[pos_c] == gids) if n_own else np.zeros(gids.shape, bool)
        out[is_own] = pos_c[is_own]
        rest = ~is_own
        if rest.any():
            pos_g = np.searchsorted(gh, gids[rest])
            pos_g_c = np.clip(pos_g, 0, max(n_gh - 1, 0))
            if n_gh == 0 or not bool((gh[pos_g_c] == gids[rest]).all()):
                raise ValueError("gid not present on shard")
            out[rest] = self.max_owned + pos_g_c
        return out

    def distribute(self, x_global: np.ndarray) -> np.ndarray:
        out = np.zeros((self.nshards, self.nlocal), dtype=x_global.dtype)
        for s in range(self.nshards):
            no, ng = int(self.owned_counts[s]), int(self.ghost_counts[s])
            out[s, :no] = x_global[self.local_gids[s, :no]]
            sl = slice(self.max_owned, self.max_owned + ng)
            out[s, sl] = x_global[self.local_gids[s, sl]]
        return out

    def collect(self, x_local: np.ndarray, ndofs: int) -> np.ndarray:
        out = np.zeros(ndofs, dtype=x_local.dtype)
        for s in range(self.nshards):
            no = int(self.owned_counts[s])
            out[self.local_gids[s, :no]] = x_local[s, :no]
        return out

    # -- traced exchange (inside shard_map; per-shard rows already sliced) --
    def fwd(self, y: jnp.ndarray, send_idx, send_mask, recv_idx, recv_mask,
            axis: str = "shard") -> jnp.ndarray:
        """Refresh ghost slots from owners (scatter_fwd)."""
        for r, perm in enumerate(self.rounds):
            vals = jnp.where(send_mask[r], y[send_idx[r]], 0.0)
            recv = jax.lax.ppermute(vals, axis, perm)
            upd = jnp.where(recv_mask[r], recv, y[recv_idx[r]])
            y = y.at[recv_idx[r]].set(upd)
        return y

    def rev_add(self, y: jnp.ndarray, send_idx, send_mask, recv_idx,
                recv_mask, axis: str = "shard") -> jnp.ndarray:
        """Accumulate ghost partial sums into owners (scatter_rev(plus)).

        Ghost slots are left holding their STALE partial sums — callers
        must refresh them with ``fwd`` (or mask them) before reading the
        full local vector; reducing over all slots, or chaining a second
        rev_add without a fwd in between, would double-count."""
        for r, perm in enumerate(self.rounds):
            rperm = [(b, a) for (a, b) in perm]
            vals = jnp.where(recv_mask[r], y[recv_idx[r]], 0.0)
            recv = jax.lax.ppermute(vals, axis, rperm)
            y = y.at[send_idx[r]].add(jnp.where(send_mask[r], recv, 0.0))
        return y


def build_general_maps(local_gid_sets: Sequence[np.ndarray],
                       owner_of: np.ndarray) -> GeneralIndexMaps:
    """Build exchange maps from each shard's referenced global dofs and a
    global ownership array.

    local_gid_sets[s]: sorted unique global dofs shard s touches.
    owner_of[g]: owning shard of global dof g (every dof must be
    referenced by its owner).
    """
    S = len(local_gid_sets)
    owned: List[np.ndarray] = []
    ghosts: List[np.ndarray] = []
    for s in range(S):
        gids = np.asarray(local_gid_sets[s])
        own_mask = owner_of[gids] == s
        owned.append(gids[own_mask])
        ghosts.append(gids[~own_mask])

    max_owned = max((o.shape[0] for o in owned), default=1)
    max_ghost = max((g.shape[0] for g in ghosts), default=0)
    max_ghost = max(max_ghost, 1)
    nlocal = max_owned + max_ghost

    local_gids = np.zeros((S, nlocal), dtype=np.int64)
    owned_counts = np.array([o.shape[0] for o in owned])
    ghost_counts = np.array([g.shape[0] for g in ghosts])
    owned_mask = np.zeros((S, nlocal), dtype=bool)
    for s in range(S):
        local_gids[s, :owned_counts[s]] = owned[s]
        local_gids[s, max_owned: max_owned + ghost_counts[s]] = ghosts[s]
        owned_mask[s, :owned_counts[s]] = True

    # edges: (owner u -> ghost-holder v) with the sorted gid list per edge
    edge_gids = {}
    for v in range(S):
        if ghosts[v].size == 0:
            continue
        owners = owner_of[ghosts[v]]
        for u in np.unique(owners):
            sel = ghosts[v][owners == u]
            edge_gids[(int(u), v)] = sel  # sorted (ghosts[v] sorted)

    # greedy edge-coloring into partial-permutation rounds
    rounds: List[List[Tuple[int, int]]] = []
    round_edges: List[List[Tuple[int, int]]] = []
    for e in sorted(edge_gids):
        placed = False
        for r, perm in enumerate(rounds):
            if all(e[0] != a and e[1] != b for (a, b) in perm):
                perm.append(e)
                round_edges[r].append(e)
                placed = True
                break
        if not placed:
            rounds.append([e])
            round_edges.append([e])

    R = max(len(rounds), 1)
    buf = max((edge_gids[e].shape[0] for e in edge_gids), default=1)
    send_idx = np.zeros((S, R, buf), dtype=np.int64)
    send_mask = np.zeros((S, R, buf), dtype=bool)
    recv_idx = np.zeros((S, R, buf), dtype=np.int64)
    recv_mask = np.zeros((S, R, buf), dtype=bool)

    def slots_of(shard, gids):
        # owned slots (sender side)
        pos = np.searchsorted(owned[shard], gids)
        assert bool((owned[shard][pos] == gids).all())
        return pos

    def ghost_slots_of(shard, gids):
        pos = np.searchsorted(ghosts[shard], gids)
        assert bool((ghosts[shard][pos] == gids).all())
        return max_owned + pos

    for r, edges in enumerate(round_edges):
        for (u, v) in edges:
            g = edge_gids[(u, v)]
            n = g.shape[0]
            send_idx[u, r, :n] = slots_of(u, g)
            send_mask[u, r, :n] = True
            recv_idx[v, r, :n] = ghost_slots_of(v, g)
            recv_mask[v, r, :n] = True

    return GeneralIndexMaps(
        nshards=S, max_owned=max_owned, max_ghost=max_ghost, nlocal=nlocal,
        local_gids=local_gids, owned_counts=owned_counts,
        ghost_counts=ghost_counts, owned_mask=owned_mask,
        rounds=tuple(tuple(p) for p in rounds), buf=buf,
        send_idx=send_idx, send_mask=send_mask,
        recv_idx=recv_idx, recv_mask=recv_mask)


def partition_cells_sfc(centroids: np.ndarray, nshards: int) -> np.ndarray:
    """Cell -> shard by contiguous split of the Morton (Z-order) curve
    over cell centroids — the deterministic, communication-free stand-in
    for the reference's graph partitioner (ParMETIS/PT-SCOTCH,
    src/mesh.cpp:153-162): good locality, perfectly balanced counts."""
    c = np.asarray(centroids, dtype=np.float64)
    lo = c.min(axis=0)
    span = np.maximum(c.max(axis=0) - lo, 1e-300)
    q = np.minimum(((c - lo) / span) * 1024.0, 1023.0).astype(np.uint64)

    key = np.zeros(c.shape[0], dtype=np.uint64)
    for b in range(10):  # 10 bits per axis, explicit interleave
        for ax in range(3):
            bit = (q[:, ax] >> np.uint64(b)) & np.uint64(1)
            key |= bit << np.uint64(3 * b + ax)
    order = np.argsort(key, kind="stable")
    C = c.shape[0]
    bounds = np.linspace(0, C, nshards + 1).astype(np.int64)
    shard = np.empty(C, dtype=np.int64)
    for s in range(nshards):
        shard[order[bounds[s]: bounds[s + 1]]] = s
    return shard
