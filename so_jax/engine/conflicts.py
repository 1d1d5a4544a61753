"""Mass-ordered subsume/slurp/retain conflict protocol.

Reference: kdSO processes groups in ascending input-GTP-mass order
(kd2.c:864-895, sort kd2.c:843-861) and, after each successful R_Delta
solve, walks that group's interior particles in ascending distance
(kdTagParticles, kd2.c:663-720):

  - unowned particle                        -> tag to A (kd2.c:716-718)
  - owned by B, |posA-posB| <= RvirA        -> SUBSUME B: every particle
      currently tagged B gets nSubsumed++ and iGrp=0 (kdZeroGroup,
      kd2.c:617-643); B is marked Rvir=-10*A.index, Mvir=-Mvir; the walk's
      B-particles end up tagged to A; iGroupsRemoved++ (kd2.c:683-693)
  - else |posA-posB| <= RvirB               -> SLURP A: every particle
      tagged to A so far gets nSubsumed++ and iGrp=0; A is marked
      Rvir=-10*B.index, Mvir=-Mvir; the walk breaks at the start of the
      next iteration; iGroupsSlurped++ (kd2.c:694-705, break kd2.c:670-671)
  - else                                    -> RETAIN: B keeps the particle,
      nIgnored++ (kd2.c:706-715)

The usage text claims slurped particles are re-tagged to B (so.c:167-175);
the code only zeroes them — we implement the code's behavior.

Distances here are *raw* float32 differences with no periodic wrap, exactly
as kdTagParticles computes them (kd2.c:677-680).

The walk is order-dependent only through (a) which owners get subsumed
before a slurp cuts the walk short and (b) which particles are A-tagged at
the slurp moment, so each halo's pass reduces to a handful of vectorized
numpy ops over its interior list — the per-particle loop is gone but the
sequential mass-order semantics are preserved bit-for-bit.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


@dataclass
class ConflictState:
    """Post-protocol per-particle and per-group ownership state."""
    igrp: np.ndarray          # (N,) i32 final group id per particle (0 = none)
    n_subsumed: np.ndarray    # (N,) i32 — .sosub counters (kd2.c:639)
    n_ignored: np.ndarray     # (N,) i32 — .soign counters (kd2.c:714)
    mvir: np.ndarray          # (G,) f32 catalog Mvir after sub/slurp negation
    rvir: np.ndarray          # (G,) f32 catalog Rvir after -10*winner marking
    slurped_own: np.ndarray   # (G,) bool — slurped during own tagging
    groups_removed: int = 0   # iGroupsRemoved (kd2.c:692)
    groups_slurped: int = 0   # iGroupsSlurped (kd2.c:702)


def resolve_conflicts(index: np.ndarray, pos: np.ndarray,
                      mvir: np.ndarray, rvir: np.ndarray, code: np.ndarray,
                      order: np.ndarray, members: list,
                      n_particles: int, use_native: bool | None = None) -> ConflictState:
    """Run the protocol over all groups in the given processing order.

    ``order`` is the ascending-GTP-mass permutation (numerics.indexx);
    ``members[h]`` is halo h's sorted interior original-index list (only
    consulted when code[h] == 0 — error groups never tag, kd2.c:772-796,
    836-839).

    ``use_native``: run the C implementation (so_jax/native/so_native.c) —
    default tries native and falls back to this vectorized-numpy path.
    Both implement identical semantics (tests/test_native.py).
    """
    if use_native is not False:
        from ..native import conflict_pass_native
        out = conflict_pass_native(np.asarray(index, np.int32),
                                   np.asarray(pos, np.float32),
                                   np.asarray(mvir, np.float32),
                                   np.asarray(rvir, np.float32),
                                   np.asarray(code, np.int32),
                                   np.asarray(order, np.int64),
                                   members, n_particles)
        if out is not None:
            return ConflictState(**out)
        if use_native:
            raise RuntimeError("native conflict pass requested but unavailable")
    G = index.shape[0]
    igrp = np.zeros(n_particles, np.int32)
    n_sub = np.zeros(n_particles, np.int32)
    n_ign = np.zeros(n_particles, np.int32)
    mvir = np.asarray(mvir, np.float32).copy()
    rvir = np.asarray(rvir, np.float32).copy()
    pos = np.asarray(pos, np.float32)
    slurped_own = np.zeros(G, bool)
    removed = 0
    slurped = 0

    id2row = {int(i): r for r, i in enumerate(index)}

    for a in order:
        if code[a] != 0:
            continue
        ms = members[a]
        if ms is None or ms.size == 0:
            continue
        own = igrp[ms]
        a_id = np.int32(index[a])
        rvir_a = np.float32(rvir[a])

        nz = own != 0
        if not nz.any():
            igrp[ms] = a_id
            continue

        occ_pos = np.nonzero(nz)[0]
        occ_rows = np.fromiter((id2row[int(o)] for o in own[occ_pos]),
                               dtype=np.int64, count=occ_pos.size)
        d = (pos[a][None, :] - pos[occ_rows]).astype(np.float32)
        d2 = (d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1] + d[:, 2] * d[:, 2]).astype(np.float32)
        rva2 = np.float32(rvir_a * rvir_a)
        rvb = rvir[occ_rows].astype(np.float32)
        is_sub = d2 <= rva2
        is_slurp = (~is_sub) & (d2 <= (rvb * rvb).astype(np.float32))

        if is_slurp.any():
            k_s = occ_pos[np.argmax(is_slurp)]   # first slurp occurrence
            in_prefix = occ_pos < k_s
            slurper_row = occ_rows[np.argmax(is_slurp)]
        else:
            k_s = None
            in_prefix = np.ones(occ_pos.size, bool)
        prefix_end = k_s if k_s is not None else ms.size

        sub_rows = np.unique(occ_rows[is_sub & in_prefix])
        for b in sub_rows:
            assert mvir[b] >= 0.0, "kdZeroGroup: zeroed group mass already negative"
            b_id = np.int32(index[b])
            bp = np.nonzero(igrp == b_id)[0]
            n_sub[bp] += 1
            igrp[bp] = 0
            rvir[b] = np.float32(-10.0 * float(a_id))
            mvir[b] = -mvir[b]
            removed += 1

        # retained-in-adversity counters for ignore-class prefix occurrences
        ign_occ = (~is_sub) & (~is_slurp) & in_prefix
        n_ign[ms[occ_pos[ign_occ]]] += 1

        # tag to A: prefix particles that are unowned *now* (covers both the
        # originally-unowned and the just-zeroed subsumed-owner particles)
        pref = ms[:prefix_end]
        take = igrp[pref] == 0
        tagged = pref[take]
        igrp[tagged] = a_id

        if k_s is not None:
            assert mvir[a] >= 0.0
            n_sub[tagged] += 1
            igrp[tagged] = 0
            rvir[a] = np.float32(-10.0 * float(index[slurper_row]))
            mvir[a] = -mvir[a]
            slurped_own[a] = True
            slurped += 1

    return ConflictState(igrp=igrp, n_subsumed=n_sub, n_ignored=n_ign,
                         mvir=mvir, rvir=rvir, slurped_own=slurped_own,
                         groups_removed=removed, groups_slurped=slurped)


# ---------------------------------------------------------------------------
# Component decomposition — the provably-parallel form of the serial walk
# ---------------------------------------------------------------------------
#
# Every read and write of the walk above touches only (a) catalog columns
# of groups whose member lists SHARE a particle row with the current
# group's list (ownership can only arise from earlier tagging of a shared
# row; zeroing/slurping touches only rows the zeroed group tagged, which
# are inside its own list), and (b) per-particle state of rows inside the
# current component's member lists. Hence the serial mass-order walk
# decomposes EXACTLY over connected components of the "groups sharing a
# member row" graph: running each component's groups in the global order
# restricted to that component is bit-identical to the reference's single
# serial pass (kd2.c:864-895). This is what lets the multi-controller
# driver shard the 1e6-group walk across hosts and keep per-particle
# output arrays only for its own particle segment.


def conflict_components(code: np.ndarray, members: list) -> np.ndarray:
    """Connected-component label per group (−1 for groups that never walk:
    error codes or empty member lists). Union-find over shared member rows
    via one sort of the concatenated (row, group) pairs."""
    G = len(members)
    active = [g for g in range(G)
              if code[g] == 0 and members[g] is not None and members[g].size]
    parent = np.arange(G, dtype=np.int64)

    def find(x):
        root = x
        while parent[root] != root:
            root = parent[root]
        while parent[x] != root:
            parent[x], x = root, parent[x]
        return root

    if active:
        rows = np.concatenate([np.asarray(members[g], np.int64)
                               for g in active])
        gids = np.repeat(np.asarray(active, np.int64),
                         [members[g].size for g in active])
        o = np.argsort(rows, kind="stable")
        rows_s, gids_s = rows[o], gids[o]
        same = rows_s[1:] == rows_s[:-1]
        for a, b in zip(gids_s[:-1][same], gids_s[1:][same]):
            ra, rb = find(a), find(b)
            if ra != rb:
                parent[rb] = ra

    comp = np.full(G, -1, np.int64)
    for g in active:
        comp[g] = find(g)
    return comp


@dataclass
class SparseConflictRows:
    """Per-particle conflict outputs as (row, value) triplets — only rows
    inside the walked components appear; everything else is implicitly
    (igrp=0, n_sub=0, n_ign=0). Rows are unique across the structure
    (components have disjoint member-row sets by construction), so a
    scatter into zeroed dense arrays reproduces the serial pass exactly."""
    rows: np.ndarray          # (T,) i64 particle rows
    igrp: np.ndarray          # (T,) i32
    n_subsumed: np.ndarray    # (T,) i32
    n_ignored: np.ndarray     # (T,) i32
    own: np.ndarray           # (G,) bool — groups inside walked components
    mvir: np.ndarray          # (G,) f32, mutated only at own groups
    rvir: np.ndarray          # (G,) f32, mutated only at own groups
    slurped_own: np.ndarray   # (G,) bool (False outside own)
    groups_removed: int
    groups_slurped: int


def conflict_walk_sparse(index, pos, mvir, rvir, code, order, members,
                         comp: np.ndarray | None = None, comp_sel=None,
                         use_native: bool | None = None
                         ) -> SparseConflictRows:
    """The component-decomposed conflict walk with SPARSE per-particle
    output — the multi-controller form: each host walks only its share of
    components (``comp_sel``) and holds O(tagged rows of its components)
    state instead of O(n_particles) dense arrays.

    ``comp_sel(component_ids) -> mask`` restricts the walk to a subset of
    components (the distributed driver passes each host its round-robin
    share); per-group columns are then meaningful only at ``own`` groups
    and callers merge across hosts (own masks are disjoint). Singleton
    components (groups sharing no member row with any other group) cannot
    conflict: they are emitted as one unconditional tag, skipping the
    walk entirely.
    """
    G = index.shape[0]
    if comp is None:
        comp = conflict_components(code, members)
    mvir_out = np.asarray(mvir, np.float32).copy()
    rvir_out = np.asarray(rvir, np.float32).copy()
    own = np.zeros(G, bool)
    slurped_own = np.zeros(G, bool)
    removed = slurped = 0
    rows_l, ig_l, ns_l, ni_l = [], [], [], []

    roots, counts = np.unique(comp[comp >= 0], return_counts=True)
    if comp_sel is not None:
        keep = comp_sel(roots)
        roots, counts = roots[keep], counts[keep]
    keep_root = set(roots.tolist())

    # singleton components: tag all members unconditionally (own == 0
    # everywhere by construction)
    single_roots = set(roots[counts == 1].tolist())
    rank = np.empty(G, np.int64)
    rank[np.asarray(order)] = np.arange(G)
    multi_groups = []
    for g in range(G):
        c = comp[g]
        if c < 0 or c not in keep_root:
            continue
        own[g] = True
        if c in single_roots:
            m = np.asarray(members[g], np.int64)
            rows_l.append(m)
            ig_l.append(np.full(m.size, np.int32(index[g]), np.int32))
            z = np.zeros(m.size, np.int32)
            ns_l.append(z)
            ni_l.append(z)
        else:
            multi_groups.append(g)

    # multi-group components: the exact serial walk per component, over
    # compacted particle rows (the native C pass runs per component)
    multi_groups.sort(key=lambda g: rank[g])
    by_comp: dict = {}
    for g in multi_groups:
        by_comp.setdefault(comp[g], []).append(g)
    for c, gs in by_comp.items():
        gs = np.asarray(gs, np.int64)      # already in global mass order
        rows_c = np.unique(np.concatenate([members[g] for g in gs]))
        mem_c = [np.searchsorted(rows_c, members[g]) for g in gs]
        st = resolve_conflicts(
            index[gs], pos[gs], mvir[gs], rvir[gs], code[gs],
            np.arange(gs.size), mem_c, rows_c.size,
            use_native=use_native)
        rows_l.append(rows_c)
        ig_l.append(st.igrp)
        ns_l.append(st.n_subsumed)
        ni_l.append(st.n_ignored)
        mvir_out[gs] = st.mvir
        rvir_out[gs] = st.rvir
        slurped_own[gs] = st.slurped_own
        removed += st.groups_removed
        slurped += st.groups_slurped

    cat = lambda ls, dt: (np.concatenate(ls) if ls
                          else np.zeros(0, dt)).astype(dt, copy=False)
    return SparseConflictRows(
        rows=cat(rows_l, np.int64), igrp=cat(ig_l, np.int32),
        n_subsumed=cat(ns_l, np.int32), n_ignored=cat(ni_l, np.int32),
        own=own, mvir=mvir_out, rvir=rvir_out, slurped_own=slurped_own,
        groups_removed=removed, groups_slurped=slurped)


def resolve_conflicts_components(index, pos, mvir, rvir, code, order,
                                 members, n_particles,
                                 comp: np.ndarray | None = None,
                                 comp_sel=None,
                                 use_native: bool | None = None
                                 ) -> ConflictState:
    """resolve_conflicts via the component decomposition — bit-identical
    output (tests/test_native.py fuzz + the distributed CLI byte test).
    The dense form of conflict_walk_sparse: scatter the sparse triplets
    into zeroed n_particles arrays."""
    sp = conflict_walk_sparse(index, pos, mvir, rvir, code, order, members,
                              comp=comp, comp_sel=comp_sel,
                              use_native=use_native)
    igrp = np.zeros(n_particles, np.int32)
    n_sub = np.zeros(n_particles, np.int32)
    n_ign = np.zeros(n_particles, np.int32)
    igrp[sp.rows] = sp.igrp
    n_sub[sp.rows] = sp.n_subsumed
    n_ign[sp.rows] = sp.n_ignored
    return ConflictState(igrp=igrp, n_subsumed=n_sub, n_ignored=n_ign,
                         mvir=sp.mvir, rvir=sp.rvir,
                         slurped_own=sp.slurped_own,
                         groups_removed=sp.groups_removed,
                         groups_slurped=sp.groups_slurped)
