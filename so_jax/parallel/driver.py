"""Multi-controller end-to-end pipeline — run_so across jax.distributed
processes.

The reference is one process with the whole snapshot in RAM (so.c:192-575,
kd2.c:318-421); the BASELINE 1024^3 multi-host configuration cannot be.
This driver is that assembly: every process runs
the SAME program (SPMD-host style) —

  1. per-host snapshot segment read (io.tipsy.read_tipsy_segment over
     distributed.grid_segment) — no host ever touches the rest of the file;
  2. build_sharded_grid_segment: per-host Morton grids, assembled into one
     global ShardedGrid whose 'part' axis crosses processes;
  3. the UNCHANGED engine escalation drivers (solve_rvir /
     members_and_derived / compute_derived) with injected stages that wrap
     the shard_map kernels in make_global / fetch_sharded — since every
     host sees identical solver state, all hosts issue identical dispatch
     sequences and the cross-process collectives line up;
  4. host-side phases: the conflict protocol is SHARDED by connected
     component of the shared-member-row graph (dist_conflict_fn — the
     exact decomposition of the serial walk, engine.conflicts); each host
     walks its round-robin component share, ships sparse (row, tag)
     triplets, and keeps per-particle conflict state only for its own
     segment (SegmentConflictState). vcm/stats reductions merge
     per-segment partials (process_allgather); catalog-level files are
     written by process 0 while .sogrp/.sosub/.soign are written
     cooperatively, each host writing its own byte range
     (write_array_file_segments + io.writers.int_array_text_length).

Ownership story at 1024^3 (1e9 particles): particle DATA is strictly per-host (segment reads + 'part'
sharding); per-PARTICLE conflict outputs are O(N/P) per host steady
(12 B/particle over the segment). Member index lists are SEGMENTED too
(seg_member_filter: each host keeps only rows inside its particle
segment, with their walk-order ranks — ~24 B/segment-row), so the
returned SORun.members holds SegRows views, not full lists; singleton
conflict components tag locally with no network traffic and only
multi-group component rows transit the exchanges (O(total
multi-component rows) transient). No host holds any O(N) array beyond
its own segment.

Association notes: vcm and the stats mass sums merge per-host f64
partials in host order instead of one global f64 pass — differences are
at the 1e-16 level, far below the float32 catalog columns and the %g
stats formatting (tests assert byte-identical output against the
single-process CLI).
"""

from __future__ import annotations

import os
import time as _time
from dataclasses import dataclass
from typing import NamedTuple

import numpy as np

from .distributed import (allgather_varlen, build_sharded_grid_segment,
                          fetch_sharded, grid_segment, make_global,
                          make_multihost_mesh)
from .mesh import grid_proxy


@dataclass
class SegmentConflictState:
    """ConflictState whose per-particle arrays cover ONLY this host's
    particle segment [seg_start, seg_start+seg_count) of the global file
    order — the O(N/P)-per-host form the 1e9-particle ownership story
    needs. Per-group columns and counters are global (replicated)."""
    igrp: np.ndarray          # (seg_count,) i32
    n_subsumed: np.ndarray    # (seg_count,) i32
    n_ignored: np.ndarray     # (seg_count,) i32
    seg_start: int
    seg_count: int
    n_global: int
    mvir: np.ndarray          # (G,) f32 post-conflict catalog columns
    rvir: np.ndarray          # (G,) f32
    slurped_own: np.ndarray   # (G,) bool
    groups_removed: int
    groups_slurped: int


class SegRows(NamedTuple):
    """One halo's member rows restricted to one host's particle segment.

    ``rows`` are global original indices inside [seg_start, seg_start +
    seg_count); ``ranks`` each row's slot in the halo's FULL
    distance-sorted interior list (kdTagParticles walk order,
    kd2.c:663-720 — segments preserve relative order but reassembly
    needs the absolute slot); ``n`` the full list length, identical on
    every host (the fused stage's global counts)."""
    ranks: np.ndarray   # (k,) i64
    rows: np.ndarray    # (k,) i64
    n: int


def seg_member_filter(start: int, count: int):
    """members_and_derived member_filter: keep only this host's segment
    rows of each halo's member list (with their walk-order ranks), so no
    host retains O(total member rows) state — the full per-halo array
    stays a per-chunk transient inside the fused escalation driver."""
    def filt(piece: np.ndarray) -> SegRows:
        piece = np.asarray(piece, np.int64)
        sel = (piece >= start) & (piece < start + count)
        return SegRows(ranks=np.nonzero(sel)[0].astype(np.int64),
                       rows=piece[sel], n=int(piece.size))

    return filt


def _union_find(G: int, edge_blocks) -> np.ndarray:
    """Deterministic union-find over group ids; edge_blocks is an
    iterable of flat i64 (a,b) pair arrays, processed in order (every
    host sees identical blocks in identical order, so roots agree)."""
    parent = np.arange(G, dtype=np.int64)

    def find(x):
        root = x
        while parent[root] != root:
            root = parent[root]
        while parent[x] != root:
            parent[x], x = root, parent[x]
        return root

    for blk in edge_blocks:
        pairs = np.asarray(blk, np.int64).reshape(-1, 2)
        for a, b in pairs:
            ra, rb = find(a), find(b)
            if ra != rb:
                parent[rb] = ra
    return np.fromiter((find(g) for g in range(G)), np.int64, count=G)


class _JaxTransport:
    """The real jax.distributed collective surface dist_conflict_fn uses;
    tests substitute a threaded in-process fake (same duck type)."""

    def __init__(self):
        import jax

        self.nproc = jax.process_count()
        self.pid = jax.process_index()

    def allgather_varlen(self, a):
        return allgather_varlen(a)

    def process_allgather(self, tree):
        from jax.experimental import multihost_utils

        return multihost_utils.process_allgather(tree)


def dist_conflict_fn(start: int, count: int, transport=None):
    """_post_solve conflict_fn: the component-sharded conflict walk over
    SEGMENTED member lists (``members[h]`` is a SegRows — this host's
    slice of the walk list; see seg_member_filter).

    Phases, all O(segment) or O(component share) per host:

    1. components — a shared member row lives in exactly one segment, so
       each host discovers the edges of the "groups sharing a row" graph
       inside its own segment ((row, group) sort, adjacent-equal pairs);
       the deduplicated edge lists allgather (tiny: one pair per locally
       shared row) and every host runs the same union-find, agreeing on
       the component labels.
    2. singleton components cannot conflict (engine/conflicts.py): every
       host tags its own segment rows locally — their rows never cross
       the network at all (the dominant fraction in practice).
    3. multi-group components are assigned round-robin by root id; hosts
       exchange (group, rank, row) triples of multi-component rows and
       each owner reassembles the full distance-ordered lists for ITS
       components only, runs the exact serial walk per component
       (engine.conflicts.conflict_walk_sparse, bit-identical
       decomposition — tests/test_native.py), and ships the sparse
       (row, igrp, n_sub, n_ign) results back; hosts keep rows inside
       their own segment. Per-group columns merge by the disjoint
       ownership masks.

    Host memory: O(seg_count) steady; transients are O(total
    multi-component rows) during the two exchanges — the all-pairs
    member replication of the pre-segmented design is gone.

    ``transport`` overrides the jax.distributed collectives (process
    count/id, varlen allgather, process_allgather) — the test harness
    injects a threaded in-process fake to fuzz multi-host segment
    configurations without spawning processes."""
    from ..engine.conflicts import conflict_walk_sparse

    if transport is None:
        transport = _JaxTransport()

    def conflict_fn(index, pos, mvir, rvir, code, order, members,
                    n_particles):
        nproc, pid = transport.nproc, transport.pid
        G = index.shape[0]
        counts = np.array([m.n if m is not None else 0 for m in members],
                          np.int64)
        active = (np.asarray(code) == 0) & (counts > 0)
        act = np.nonzero(active)[0]

        # -- 1. components from per-segment shared rows ------------------
        if act.size:
            rows_cat = np.concatenate([members[g].rows for g in act])
            gid_cat = np.repeat(act, [members[g].rows.size for g in act])
        else:
            rows_cat = np.zeros(0, np.int64)
            gid_cat = np.zeros(0, np.int64)
        o = np.argsort(rows_cat, kind="stable")
        rows_s, gid_s = rows_cat[o], gid_cat[o]
        same = rows_s[1:] == rows_s[:-1]
        edges = np.unique(
            np.stack([gid_s[:-1][same], gid_s[1:][same]], axis=1), axis=0)
        comp_full = _union_find(G, transport.allgather_varlen(edges.ravel()))
        comp = np.where(active, comp_full, -1)

        roots, root_sizes = np.unique(comp[act], return_counts=True)
        multi_roots = roots[root_sizes >= 2]
        mine = multi_roots[multi_roots % nproc == pid]

        igrp = np.zeros(count, np.int32)
        nsub = np.zeros(count, np.int32)
        nign = np.zeros(count, np.int32)

        # -- 2. singleton components: tag locally, no exchange -----------
        single = set(roots[root_sizes == 1].tolist())
        for g in act:
            if comp[g] in single:
                igrp[members[g].rows - start] = np.int32(index[g])

        # -- 3. multi-group components: triple exchange + owner walks ----
        in_multi = np.isin(comp, multi_roots) & active
        mg = np.nonzero(in_multi)[0]
        if mg.size:
            tri = np.empty((sum(members[g].rows.size for g in mg), 3),
                           np.int64)
            off = 0
            for g in mg:
                k = members[g].rows.size
                tri[off:off + k, 0] = g
                tri[off:off + k, 1] = members[g].ranks
                tri[off:off + k, 2] = members[g].rows
                off += k
        else:
            tri = np.zeros((0, 3), np.int64)
        tri_all = transport.allgather_varlen(tri.ravel())

        owned = mg[np.isin(comp[mg], mine)] if mg.size else mg
        base = np.full(G, -1, np.int64)
        base[owned] = np.cumsum(counts[owned]) - counts[owned]
        flat = np.full(int(counts[owned].sum()), -1, np.int64)
        for blk in tri_all:
            t = np.asarray(blk, np.int64).reshape(-1, 3)
            sel = np.isin(comp[t[:, 0]], mine)
            t = t[sel]
            flat[base[t[:, 0]] + t[:, 1]] = t[:, 2]
        assert (flat >= 0).all(), "segment member reassembly left holes"
        members_full: list = [None] * G
        for g in owned:
            members_full[g] = flat[base[g]:base[g] + counts[g]]

        sp = conflict_walk_sparse(index, pos, mvir, rvir, code, order,
                                  members_full, comp=comp,
                                  comp_sel=lambda r: np.isin(r, mine))

        rows_all = transport.allgather_varlen(sp.rows)
        vals_all = transport.allgather_varlen(np.stack(
            [sp.igrp, sp.n_subsumed, sp.n_ignored], axis=1).ravel())
        for rows_p, vals_p in zip(rows_all, vals_all):
            v = vals_p.reshape(-1, 3)
            sel = (rows_p >= start) & (rows_p < start + count)
            loc = rows_p[sel] - start
            igrp[loc] = v[sel, 0]
            nsub[loc] = v[sel, 1]
            nign[loc] = v[sel, 2]

        own_a, mvir_a, rvir_a, sl_a, cnt_a = transport.process_allgather(
            (sp.own.astype(np.uint8), sp.mvir, sp.rvir,
             sp.slurped_own.astype(np.uint8),
             np.array([sp.groups_removed, sp.groups_slurped], np.int32)))
        mvir_m = np.asarray(mvir, np.float32).copy()
        rvir_m = np.asarray(rvir, np.float32).copy()
        slurped = np.zeros(index.shape[0], bool)
        removed = slurped_n = 0
        for p in range(nproc):
            o = own_a[p].astype(bool)
            mvir_m[o] = mvir_a[p][o]
            rvir_m[o] = rvir_a[p][o]
            slurped[o] = sl_a[p][o].astype(bool)
            removed += int(cnt_a[p][0])
            slurped_n += int(cnt_a[p][1])
        return SegmentConflictState(
            igrp=igrp, n_subsumed=nsub, n_ignored=nign, seg_start=start,
            seg_count=count, n_global=n_particles, mvir=mvir_m, rvir=rvir_m,
            slurped_own=slurped, groups_removed=removed,
            groups_slurped=slurped_n)

    return conflict_fn


def write_array_file_segments(path: str, seg_values: np.ndarray,
                              n_global: int) -> None:
    """Cooperative tipsy-array write: every process calls this with its
    own segment (global file order); process 0 creates the file with the
    count header and sizes it, then each host writes its lines at its
    exact byte offset (io.writers.int_array_text_length). Requires a
    shared filesystem — the same requirement process-0-writes-everything
    had, without the O(N) gather."""
    import jax
    from jax.experimental import multihost_utils

    from ..io.writers import int_array_text_length, write_int_array_segment

    pid = jax.process_index()
    lens = [int(a[0]) for a in
            allgather_varlen(np.array([int_array_text_length(seg_values)],
                                      np.int64))]
    header = ("%d\n" % n_global).encode()
    if pid == 0:
        with open(path, "wb") as fp:
            fp.write(header)
            fp.truncate(len(header) + sum(lens))
    multihost_utils.sync_global_devices("so_jax_seg_create:" + path)
    write_int_array_segment(path, seg_values, len(header) + sum(lens[:pid]))
    multihost_utils.sync_global_devices("so_jax_seg_done:" + path)


def _pad_rows(a, n_halo: int, fill=0.0):
    B = a.shape[0]
    pad = (-B) % n_halo
    if not pad:
        return np.asarray(a)
    out = np.full((B + pad,) + a.shape[1:], fill, dtype=np.asarray(a).dtype)
    out[:B] = a
    return out


def dist_stage_fn(mesh, sgrid):
    """solve_rvir stage_fn: solve_stage_sharded with global-array inputs
    and a host fetch of the packed block."""
    from jax.sharding import PartitionSpec as P

    from ..engine.solver import pack_stage_out
    from .mesh import solve_stage_sharded

    n_halo = mesh.shape["halo"]

    def stage(level, K, S, n_members, centers, radii, thr):
        B = centers.shape[0]
        c = _pad_rows(np.asarray(centers, np.float32), n_halo)
        r = _pad_rows(np.asarray(radii, np.float32), n_halo, 1e-30)
        out = solve_stage_sharded(
            mesh, sgrid, level, K, S, n_members,
            make_global(mesh, P("halo"), c),
            make_global(mesh, P("halo"), r),
            make_global(mesh, P(), np.asarray(thr, np.float32)))
        packed = pack_stage_out(out)
        return fetch_sharded(packed)[:B]

    return stage


def dist_fused_stage_fn(mesh, sgrid):
    """solve_rvir fused_stage_fn: solve_stage_fused_sharded with global
    inputs; tier-1/tier-2 blocks fetched and concatenated host-side."""
    from jax.sharding import PartitionSpec as P

    from .mesh import solve_stage_fused_sharded

    n_halo = mesh.shape["halo"]

    def stage(level, K, S, level2, K2, S2, B2, n_members, dk,
              centers, radii, kleft, thr):
        B = centers.shape[0]
        c = _pad_rows(np.asarray(centers, np.float32), n_halo)
        r = _pad_rows(np.asarray(radii, np.float32), n_halo, 1e-30)
        kl = _pad_rows(np.asarray(kleft, np.int32), n_halo, 0)
        p1, p2 = solve_stage_fused_sharded(
            mesh, sgrid, level, K, S, level2, K2, S2, B2, n_members, dk,
            make_global(mesh, P("halo"), c),
            make_global(mesh, P("halo"), r),
            make_global(mesh, P("halo"), kl),
            make_global(mesh, P(), np.asarray(thr, np.float32)))
        return np.concatenate([fetch_sharded(p1)[:B], fetch_sharded(p2)])

    return stage


def dist_classify_fn(mesh, sgrid):
    """solve_rvir classify_stage_fn (--survey across processes):
    classify_stage_sharded with global inputs and a host fetch."""
    from jax.sharding import PartitionSpec as P

    from .mesh import classify_stage_sharded

    n_halo = mesh.shape["halo"]

    def stage(level, K, S, n_members, c_pad, r_pad, thr_vec):
        B = c_pad.shape[0]
        c = _pad_rows(np.asarray(c_pad, np.float32), n_halo)
        r = _pad_rows(np.asarray(r_pad, np.float32), n_halo, 1e-30)
        thr = np.atleast_1d(np.asarray(thr_vec, np.float32))
        out = classify_stage_sharded(
            mesh, sgrid, level, K, S, n_members,
            make_global(mesh, P("halo"), c),
            make_global(mesh, P("halo"), r),
            make_global(mesh, P(), thr), T=thr.shape[0])
        return fetch_sharded(out)[:B]

    return stage


def dist_fused_members_fn(mesh, sgrid):
    """members_and_derived stage_fn: fused_members_stage_sharded with
    global inputs; member prefix-pack on the host (same contract as
    parallel.mesh.sharded_fused_members_fn)."""
    from jax.sharding import PartitionSpec as P

    from .mesh import fused_members_stage_sharded

    n_halo = mesh.shape["halo"]

    def stage(level, K, S, cap, n_members, species, centers, rvir, j, mvir,
              grav):
        B = centers.shape[0]
        out = fused_members_stage_sharded(
            mesh, sgrid, level, K, S, n_members, tuple(species),
            make_global(mesh, P("halo"),
                        _pad_rows(np.asarray(centers, np.float32), n_halo)),
            make_global(mesh, P("halo"),
                        _pad_rows(np.asarray(rvir, np.float32), n_halo,
                                  1e-30)),
            make_global(mesh, P("halo"),
                        _pad_rows(np.asarray(j, np.int32), n_halo, 0)),
            make_global(mesh, P("halo"),
                        _pad_rows(np.asarray(mvir, np.float32), n_halo,
                                  1.0)),
            make_global(mesh, P(), np.asarray(grav, np.float32)))
        orig = fetch_sharded(out["orig"])[:B]
        valid = orig >= 0
        counts = valid.sum(axis=1).astype(np.int32)
        return orig[valid], counts, fetch_sharded(out["dblock"])[:B]

    return stage


def dist_derived_fn(mesh, sgrid):
    """compute_derived stage_fn (checkpoint-resume path parity)."""
    from jax.sharding import PartitionSpec as P

    from .mesh import derived_stage_sharded

    n_halo = mesh.shape["halo"]

    def stage(level, K, S, n_members, species, centers, rvir, mvir, grav):
        import jax.numpy as jnp

        B = centers.shape[0]
        out = derived_stage_sharded(
            mesh, sgrid, level, K, S, n_members, tuple(species),
            make_global(mesh, P("halo"),
                        _pad_rows(np.asarray(centers, np.float32), n_halo)),
            make_global(mesh, P("halo"),
                        _pad_rows(np.asarray(rvir, np.float32), n_halo,
                                  1e-30)),
            make_global(mesh, P("halo"),
                        _pad_rows(np.asarray(mvir, np.float32), n_halo,
                                  0.0)),
            make_global(mesh, P(), np.asarray(grav, np.float32)))
        parts = [fetch_sharded(out["overflow"]).astype(np.float32)[:, None],
                 fetch_sharded(out["vcirc"]), fetch_sharded(out["rmass"]),
                 fetch_sharded(out["rmax"])[:, None],
                 fetch_sharded(out["vmax"])[:, None]]
        parts += [fetch_sharded(out["profiles"][sp]) for sp in species]
        return np.concatenate(parts, axis=1)[:B]

    return stage


def dist_vcm_fn(mv_seg: np.ndarray, start: int):
    """Per-segment _VcmParticles partials, merged across processes in host
    order (engine.members.member_mv_sums is the shared reduction core)."""
    from ..engine.members import member_mv_sums
    from .distributed import allgather_f64

    mv_seg = np.asarray(mv_seg, np.float32)
    count = mv_seg.shape[0]

    def vcm_fn(rows, counts, mvir_rows):
        counts = np.asarray(counts, np.int64)
        seg_id = np.repeat(np.arange(counts.size), counts)
        sel = (rows >= start) & (rows < start + count)
        my_counts = np.bincount(seg_id[sel], minlength=counts.size)
        partial = member_mv_sums(mv_seg, rows[sel] - start, my_counts)
        sums = allgather_f64(partial).sum(axis=0)
        nz = counts > 0
        out = np.zeros((counts.size, 3), np.float32)
        out[nz] = (sums[nz]
                   / np.asarray(mvir_rows, np.float64)[nz, None]) \
            .astype(np.float32)
        return out

    return vcm_fn


def dist_stats_fn(mass_seg: np.ndarray, start: int):
    """kdOutStats reductions from per-segment partials (the conflict state
    itself is identical on every host)."""
    from ..stats import RunStats
    from .distributed import allgather_f64

    m64 = np.asarray(mass_seg, np.float64)
    count = m64.shape[0]

    def stats_fn(conflicts):
        if getattr(conflicts, "seg_start", None) is not None:
            # segmented conflict state: arrays already cover exactly this
            # host's segment
            assert (conflicts.seg_start, conflicts.seg_count) \
                == (start, count)
            nsub, nign, ig = (conflicts.n_subsumed, conflicts.n_ignored,
                              conflicts.igrp)
        else:
            sl = slice(start, start + count)
            nsub = conflicts.n_subsumed[sl]
            nign = conflicts.n_ignored[sl]
            ig = conflicts.igrp[sl]
        from ..native import stats_pass_native
        nat = stats_pass_native(mass_seg, ig, nsub, nign)
        if nat is not None:
            f, i = nat
            part = np.array([i[0], i[1], f[0], f[1], i[2], i[3], f[2],
                             f[3], f[4]], np.float64)
        else:
            part = np.array([
                nsub.sum(), (nsub > 0).sum(),
                (m64 * nsub).sum(), m64[nsub > 0].sum(),
                nign.sum(), (nign > 0).sum(),
                (m64 * nign).sum(), m64[nign > 0].sum(),
                m64[ig > 0].sum()], np.float64)
        tot = allgather_f64(part).sum(axis=0)
        return RunStats(
            cum_particles_subsumed=int(tot[0]),
            particles_subsumed=int(tot[1]),
            cum_mass_subsumed=float(tot[2]), mass_subsumed=float(tot[3]),
            cum_particles_ignored=int(tot[4]),
            particles_ignored=int(tot[5]),
            cum_mass_ignored=float(tot[6]), mass_ignored=float(tot[7]),
            groups_removed=conflicts.groups_removed,
            groups_slurped=conflicts.groups_slurped,
            particle_mass_sum=float(tot[8]),
            halo_mass_sum=float(np.maximum(
                conflicts.mvir.astype(np.float64), 0.0).sum()))

    return stats_fn


def recenter_most_bound_distributed(mesh, sgrid, centers, rgtp,
                                    k0_cap: int = 4096, s_max: int = 11):
    """-pot recentring across processes: recenter_stage_sharded with
    global inputs (mirrors parallel.mesh.recenter_most_bound_sharded)."""
    from jax.sharding import PartitionSpec as P

    from ..engine.solver import _k_limit, _pad_to_bucket, _pick_level_span
    from .mesh import recenter_stage_sharded

    proxy = grid_proxy(sgrid, with_slab=False)
    n_halo = mesh.shape["halo"]
    G = centers.shape[0]
    centers = np.asarray(centers, np.float32)
    radii_all = np.asarray(rgtp, np.float32)
    out = centers.copy()
    todo = np.arange(G)
    capacity = k0_cap
    while todo.size:
        K = int(min(capacity, _k_limit(proxy, s_max)))
        radii = radii_all[todo]
        level, S = _pick_level_span(
            proxy, float(radii.max()) if radii.size else 0.0, s_max)
        B = _pad_to_bucket(todo.size)
        B += (-B) % n_halo
        c_pad = np.zeros((B, 3), np.float32)
        r_pad = np.zeros(B, np.float32)
        c_pad[:todo.size] = centers[todo]
        r_pad[:todo.size] = radii_all[todo]
        res = recenter_stage_sharded(
            mesh, sgrid, level, K, S,
            make_global(mesh, P("halo"), c_pad),
            make_global(mesh, P("halo"), r_pad))
        nc = fetch_sharded(res["centers"])[:todo.size]
        ovf = fetch_sharded(res["overflow"])[:todo.size]
        out[todo[~ovf]] = nc[~ovf]
        todo = todo[ovf]
        capacity *= 4
        if capacity > max(8 * _k_limit(proxy, s_max), k0_cap) and todo.size:
            raise RuntimeError("distributed recentring escalation runaway")
    return out


def _dist_setup(snapshot_path: str, catalog, params, standard: bool,
                parts_per_host: int, mark_mask, timer):
    """Shared multi-controller preamble: multihost mesh, per-host segment
    read, global uniform-mass verdict, segment grid build, -pot
    recentring. Returns (mesh, pset, sgrid, centers, rgtp, start, count,
    n_global)."""
    from ..io.tipsy import read_header, read_tipsy_segment

    mesh = make_multihost_mesh(parts_per_host)
    with open(snapshot_path, "rb") as fp:
        hdr = read_header(fp, standard)
    n_global = hdr.nbodies
    start, count = grid_segment(n_global, mesh)
    with timer.phase("segment read"):
        pset = read_tipsy_segment(snapshot_path, start, count, standard)
    if mark_mask is not None:
        pset.mark = np.asarray(mark_mask, bool)[start:start + count]
    ptype_seg = pset.ptype(start + np.arange(count, dtype=np.int64))

    # global uniform-mass verdict: every host's segment must be uniform
    # AND carry the same f32 value (process_allgather keeps the static
    # aux identical on all processes — a mismatch would desync the
    # shard_map pytrees)
    um = None
    if os.environ.get("SO_JAX_UNIFORM", "1") != "0":
        # every process must join the collective (an empty segment is
        # vacuously uniform and contributes no value)
        from ..ops.grid import detect_uniform_mass
        seg_um = detect_uniform_mass(pset.mass) if count else None
        loc = np.array(
            [float(count == 0 or seg_um is not None),
             seg_um if seg_um is not None else 0.0,
             float(count > 0)], np.float64)
        from jax.experimental import multihost_utils
        allm = np.atleast_2d(multihost_utils.process_allgather(loc))
        vals = allm[allm[:, 2] > 0, 1]
        if bool(allm[:, 0].all()) and vals.size \
                and bool((vals == vals[0]).all()):
            um = float(np.float32(vals[0]))

    with timer.phase("sharded grid build (segment)"):
        sgrid = build_sharded_grid_segment(
            mesh, start, n_global, pset.pos, pset.mass, vel=pset.vel,
            phi=pset.phi, ptype=ptype_seg, mark=pset.mark,
            period=params.period, center=params.center, m=params.grid_m,
            uniform_mass=um)

    centers = np.asarray(catalog.pos, np.float32).copy()
    rgtp = np.asarray(catalog.rgtp, np.float32)
    if params.b_pot:
        with timer.phase("recenter (-pot, distributed)"):
            centers = recenter_most_bound_distributed(mesh, sgrid,
                                                      centers, rgtp)
            catalog.pos = centers
    return mesh, pset, sgrid, centers, rgtp, start, count, n_global


def run_so_distributed(snapshot_path: str, catalog, params,
                       standard: bool = False, parts_per_host: int = 1,
                       mark_mask=None):
    """The multi-controller run_so. Call identically on every process
    AFTER jax.distributed is initialized (distributed.init_distributed);
    returns the full SORun on every host (catalog-sized outputs are
    host-replicated; only process 0 should write files)."""
    import jax

    from ..engine import solver
    from ..engine.pipeline import _post_solve
    from ..profiling import PhaseTimer, profile_trace

    timer = PhaseTimer()
    with profile_trace(params.profile_dir):
        mesh, pset, sgrid, centers, rgtp, start, count, n_global = \
            _dist_setup(snapshot_path, catalog, params, standard,
                        parts_per_host, mark_mask, timer)

        t0 = _time.perf_counter()
        # --checkpoint under --distributed: each host snapshots its OWN
        # post-members segment state (replicated solve arrays + SegRows
        # member pieces, checkpoint.save_solve_segment) after the device
        # phase; a rerun resumes every host straight into the host-side
        # conflict/derived/writer phases. The digest mixes the per-host
        # segment layout in, so resuming with a different snapshot,
        # catalog, params, OR process layout fails loudly.
        ck = params.checkpoint
        ck_members = None
        ck_path = digest = None
        if ck is not None:
            from ..checkpoint import input_digest

            digest = input_digest(pset, centers, rgtp, params.threshold,
                                  params.n_members, params.period,
                                  params.center)
            digest = (f"{digest}:seg{start}+{count}/{n_global}"
                      f"@p{jax.process_index()}/{jax.process_count()}")
            ck_path = f"{ck}.rank{jax.process_index()}" \
                      f"-of-{jax.process_count()}.npz"
            # all-or-nothing across hosts: a partial shard set means a
            # died save — resuming some hosts while others re-solve
            # would deadlock the collectives
            from jax.experimental import multihost_utils
            ex = np.array([float(os.path.exists(ck_path))], np.float64)
            exs = np.atleast_2d(multihost_utils.process_allgather(ex))[:, 0]
            if exs.any() and not exs.all():
                raise RuntimeError(
                    f"partial distributed checkpoint: shards exist on "
                    f"{int(exs.sum())}/{exs.size} hosts — delete "
                    f"{ck}.rank*.npz and rerun")
            resume = bool(exs.all())
        else:
            resume = False

        if resume:
            from ..checkpoint import load_solve_segment

            with timer.phase("checkpoint resume (segment)"):
                solve, ck_members, ck_centers = load_solve_segment(
                    ck_path, digest)
                centers = np.asarray(ck_centers, np.float32)
                catalog.pos = centers
        else:
            with timer.phase("R_Delta solve (distributed)"):
                solve = solver.solve_rvir(
                    grid_proxy(sgrid), centers, rgtp, params.threshold,
                    n_members=params.n_members,
                    stage_fn=dist_stage_fn(mesh, sgrid),
                    fused_stage_fn=dist_fused_stage_fn(mesh, sgrid),
                    classify_stage_fn=dist_classify_fn(mesh, sgrid),
                    survey=params.survey)

        run = _post_solve(
            grid_proxy(sgrid), pset, catalog, centers, solve, params,
            timer, members=ck_members,
            fused_fn=dist_fused_members_fn(mesh, sgrid),
            derived_fn=dist_derived_fn(mesh, sgrid),
            vcm_fn=dist_vcm_fn(pset.vel * pset.mass[:, None], start),
            n_particles=n_global,
            stats_fn=dist_stats_fn(pset.mass, start),
            conflict_fn=dist_conflict_fn(start, count),
            member_filter=seg_member_filter(start, count))

        if ck is not None and ck_members is None:
            from ..checkpoint import save_solve_segment

            with timer.phase("checkpoint save (segment)"):
                save_solve_segment(ck_path, run.solve, run.members,
                                   centers, digest=digest)

    run.solve_seconds = _time.perf_counter() - t0
    if params.verbose and jax.process_index() == 0:
        timer.report()
    return run


def dist_multi_stage_fn(mesh, sgrid, thresholds):
    """solve_rvir_multi stage_fn: multi_stage_sharded with global-array
    inputs and a host fetch of the (T+1, B, 5) packed block (same
    contract as parallel.mesh.solve_rvir_multi_sharded's stage)."""
    from jax.sharding import PartitionSpec as P

    from .mesh import multi_stage_sharded

    n_halo = mesh.shape["halo"]
    thr = np.asarray(thresholds, np.float32)

    def stage(level, K, S, nm, T, centers, radii):
        B = centers.shape[0]
        c = _pad_rows(np.asarray(centers, np.float32), n_halo)
        r = _pad_rows(np.asarray(radii, np.float32), n_halo, 1e-30)
        out = multi_stage_sharded(
            mesh, sgrid, level, K, S, nm, T,
            make_global(mesh, P("halo"), c),
            make_global(mesh, P("halo"), r),
            make_global(mesh, P(), thr))
        return fetch_sharded(out)[:, :B]

    return stage


def run_so_multi_distributed(snapshot_path: str, catalog, params,
                             thresholds, standard: bool = False,
                             parts_per_host: int = 1, mark_mask=None):
    """Multi-controller multi-threshold pipeline (--distributed --deltas):
    one segment grid + the shared-gather multi solve across processes,
    then the full per-threshold post-processing with the distributed
    stages — each returned SORun equals an independent run_so_distributed
    at that threshold (mirrors engine.pipeline.run_so_multi /
    parallel.mesh.run_so_multi_sharded; reference: one-pass main with all
    flags, so.c:192-575)."""
    import jax

    from ..engine.multi import solve_rvir_multi
    from ..engine.pipeline import SORun, _post_solve
    from ..engine.solver import SolveResult
    from ..profiling import PhaseTimer, profile_trace

    timer = PhaseTimer()
    runs: list = []
    with profile_trace(params.profile_dir):
        mesh, pset, sgrid, centers, rgtp, start, count, n_global = \
            _dist_setup(snapshot_path, catalog, params, standard,
                        parts_per_host, mark_mask, timer)

        t0 = _time.perf_counter()
        with timer.phase("R_Delta solve (multi, distributed)"):
            multi = solve_rvir_multi(
                grid_proxy(sgrid), centers, rgtp, thresholds,
                n_members=params.n_members,
                stage_fn=dist_multi_stage_fn(mesh, sgrid, thresholds),
                classify_stage_fn=dist_classify_fn(mesh, sgrid),
                survey=params.survey)
        for t in range(len(thresholds)):
            solve_t = SolveResult(
                code=multi.code[t].copy(), mvir=multi.mvir[t].copy(),
                rvir=multi.rvir[t].copy(), j=multi.j[t].copy(),
                d2cut=multi.d2cut[t].copy(),
                vcm=np.zeros((catalog.n, 3), np.float32))
            run = _post_solve(
                grid_proxy(sgrid), pset, catalog, centers, solve_t, params,
                timer, fused_fn=dist_fused_members_fn(mesh, sgrid),
                derived_fn=dist_derived_fn(mesh, sgrid),
                vcm_fn=dist_vcm_fn(pset.vel * pset.mass[:, None], start),
                n_particles=n_global,
                stats_fn=dist_stats_fn(pset.mass, start),
                conflict_fn=dist_conflict_fn(start, count),
                member_filter=seg_member_filter(start, count))
            run.solve_seconds = _time.perf_counter() - t0
            runs.append(run)
    if params.verbose and jax.process_index() == 0:
        timer.report()
    return runs
