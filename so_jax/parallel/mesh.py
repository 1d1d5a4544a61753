"""Multi-chip SPMD: halo x particle sharding over a jax.sharding.Mesh.

The reference is a single-process serial program (SURVEY.md section 2.2);
its two implicit decomposition axes become first-class mesh axes here:

  - 'halo': candidate centers are data-parallel — each device solves its
    slice of the catalog (no communication until results are fetched).
  - 'part': the particle population is sharded — each device owns a
    Morton-sorted cell grid over its shard, gathers ball candidates
    locally, and the per-shard hit lists are all-gathered over 'part' and
    merge-sorted so the density scan sees exactly the same globally
    distance-sorted sequence as the single-device path.

Exactness: the scan consumes (d2, mass) pairs in ascending d2; an
all_gather of per-shard hits followed by one sort is a merge of disjoint
subsets, so results are bit-comparable to single-device up to float32 sort
ties. The -1 count is a psum; overflow is an any-reduce.

Everything runs under one jit with shard_map — XLA inserts the collectives
(all_gather over 'part') and partitions the rest.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..ops.gather import ragged_ball_gather
from ..ops.grid import CellGrid, _build_device, choose_m
from ..engine.solver import scan_sorted


def make_mesh(n_halo: int, n_part: int, devices=None) -> Mesh:
    devices = np.asarray(devices if devices is not None else jax.devices())
    assert devices.size == n_halo * n_part, (devices.size, n_halo, n_part)
    return Mesh(devices.reshape(n_halo, n_part), ("halo", "part"))


@jax.tree_util.register_pytree_node_class
@dataclass
class ShardedGrid:
    """Per-shard Morton grids, stacked on a leading 'part'-sharded axis.

    Shard s owns rows [s] of every array: its own Morton-sorted particle
    block (padded with sentinel-coded zero-mass particles to equal size)
    plus its own multi-level CSR starts.
    """
    m: int
    lo: jnp.ndarray           # (3,)
    period: jnp.ndarray       # (3,)
    pos: jnp.ndarray          # (nsh, Nl, 3)
    mass: jnp.ndarray         # (nsh, Nl)
    vel: jnp.ndarray          # (nsh, Nl, 3)
    phi: jnp.ndarray          # (nsh, Nl)
    ptype: jnp.ndarray        # (nsh, Nl)
    mark: jnp.ndarray         # (nsh, Nl)
    orig_idx: jnp.ndarray     # (nsh, Nl) — local row -> global original index
    starts: tuple             # per level: (nsh, size_g)
    soa8t: jnp.ndarray | None = None  # (nsh, 8, Nl+chunk) slab payload
    chunk: int = 256          # static: slab DMA chunk (see CellGrid.chunk)
    uniform_mass: float | None = None  # static: the single f32 mass when
    #                           every REAL particle's mass is bit-identical
    #                           (detected on the pre-padding host array —
    #                           shard padding rows are excluded from every
    #                           gather by their sentinel Morton codes).
    #                           Sharded stages then skip the mass channel:
    #                           the all_gather merge halves and the sort
    #                           drops one operand (see CellGrid.uniform_mass).

    @property
    def nshards(self) -> int:
        return self.orig_idx.shape[0]

    @property
    def n_local(self) -> int:
        return self.orig_idx.shape[1]

    def tree_flatten(self):
        return ((self.lo, self.period, self.pos, self.mass, self.vel,
                 self.phi, self.ptype, self.mark, self.orig_idx, self.starts,
                 self.soa8t), (self.m, self.chunk, self.uniform_mass))

    @classmethod
    def tree_unflatten(cls, aux, children):
        m, chunk, uniform_mass = aux
        return cls(m, *children, chunk=chunk, uniform_mass=uniform_mass)

    def local_cellgrid(self) -> CellGrid:
        """Inside shard_map: view this shard's block (leading dim 1) as a
        plain CellGrid. Deduplicated (None) per-particle arrays pass
        through — CellGrid's *_a() accessors serve them from the payload."""
        sq = lambda a: None if a is None else a[0]
        return CellGrid(self.m, self.lo, self.period, sq(self.pos),
                        sq(self.mass), sq(self.vel), sq(self.phi),
                        sq(self.ptype), sq(self.mark), sq(self.orig_idx),
                        tuple(sq(s) for s in self.starts),
                        sq(self.soa8t), chunk=self.chunk,
                        uniform_mass=self.uniform_mass)


def _specs_grid(sgrid: ShardedGrid) -> ShardedGrid:
    """shard_map in_specs pytree matching a ShardedGrid: particle arrays
    and per-level starts sharded along 'part', box constants replicated.
    Static aux (m, chunk) must equal the operand's for structure match;
    deduplicated (None) arrays mirror as None so the pytrees align."""
    sp = lambda a: None if a is None else P("part")
    return ShardedGrid(
        sgrid.m, P(), P(), sp(sgrid.pos), sp(sgrid.mass), sp(sgrid.vel),
        sp(sgrid.phi), sp(sgrid.ptype), sp(sgrid.mark), P("part"),
        tuple(P("part") for _ in sgrid.starts),
        sp(sgrid.soa8t), chunk=sgrid.chunk,
        uniform_mass=sgrid.uniform_mass)


def grid_proxy(sgrid: ShardedGrid, with_slab: bool = True):
    """Host-side stand-in for a CellGrid: just enough surface (m, n,
    period, soa8t, ncell) for the engine escalation drivers' level/K/S
    logic. ``with_slab=False`` hides the slab payload where the sharded
    stage gathers via XLA inside shard_map."""
    class _GridProxy:
        m = sgrid.m
        n = int(sgrid.nshards * sgrid.n_local)
        n_occ = int(sgrid.n_local)   # per-shard occupancy (each shard's
        #                              cells hold only its own particles —
        #                              solver._pick_level's chunk floor)
        period = sgrid.period
        soa8t = sgrid.soa8t if with_slab else None
        chunk = sgrid.chunk
        uniform_mass = sgrid.uniform_mass

        def ncell(self, level):
            return 1 << (sgrid.m - level)

    return _GridProxy()


def build_sharded_grid(pos, mass, vel=None, phi=None, ptype=None, mark=None,
                       period=(1.0, 1.0, 1.0), center=(0.0, 0.0, 0.0),
                       m: int | None = None, mesh: Mesh | None = None,
                       slab: bool | None = None) -> ShardedGrid:
    """Split particles into equal shards and build one grid per shard.

    The build is vmapped over shards; with a mesh, arrays are placed with
    PartitionSpec('part') on the shard axis so each device holds only its
    own grid.
    """
    pos = np.asarray(pos, np.float32)
    n = pos.shape[0]
    has_phi = phi is not None
    mass = np.asarray(mass, np.float32)
    # uniform-mass detection on the REAL rows (padding rows are zero-mass
    # but excluded from every gather by their sentinel Morton codes)
    from ..ops.grid import detect_uniform_mass
    um = detect_uniform_mass(mass)
    vel = np.zeros((n, 3), np.float32) if vel is None else np.asarray(vel, np.float32)
    phi = np.zeros(n, np.float32) if phi is None else np.asarray(phi, np.float32)
    ptype = np.zeros(n, np.int32) if ptype is None else np.asarray(ptype, np.int32)
    mark = np.zeros(n, bool) if mark is None else np.asarray(mark, bool)
    period_a = np.asarray(period, np.float32)
    center_a = np.asarray(center, np.float32)
    lo = center_a - period_a * 0.5

    nsh = mesh.shape["part"] if mesh is not None else 1
    if m is None:
        m = min(choose_m(max(n // nsh, 1)), 9)
    nl = -(-n // nsh)

    def pad_split(a, fill=0):
        out = np.full((nsh * nl,) + a.shape[1:], fill, dtype=a.dtype)
        out[:n] = a
        return out.reshape((nsh, nl) + a.shape[1:])

    valid = pad_split(np.ones(n, bool), False)
    gidx = pad_split(np.arange(n, dtype=np.int32), 0)

    build = jax.jit(jax.vmap(
        lambda p, ms, v, ph, pt, mk, va: _build_device(
            m, jnp.asarray(lo), jnp.asarray(period_a), p, ms, v, ph, pt, mk, va),
    ), static_argnums=())

    out = build(pad_split(pos), pad_split(mass), pad_split(vel),
                pad_split(phi), pad_split(ptype), pad_split(mark), valid)
    pos_s, mass_s, vel_s, phi_s, ptype_s, mark_s, perm_s, starts_s = out
    # perm is shard-local; translate to global original indices
    orig = jnp.take_along_axis(jnp.asarray(gidx), perm_s, axis=1)

    from ..ops.grid import choose_chunk, slab_default

    if slab is None:
        slab = slab_default()
    chunk = choose_chunk(max(n // nsh, 1), m)
    soa = None
    if slab:
        from ..ops.slab import pack_soa8t
        soa = jax.jit(jax.vmap(partial(pack_soa8t, chunk=chunk)))(
            pos_s, mass_s, vel_s, ptype_s, mark_s)
        if os.environ.get("SO_JAX_DEDUP", "1") != "0":
            # payload is a bit-exact encoding — drop the duplicates (the
            # memory budget; CellGrid *_a() accessors serve the rare
            # ragged paths from payload slices). phi is kept only if
            # provided.
            pos_s = mass_s = vel_s = ptype_s = mark_s = None
            if not has_phi:
                phi_s = None

    sg = ShardedGrid(m, jnp.asarray(lo), jnp.asarray(period_a), pos_s, mass_s,
                     vel_s, phi_s, ptype_s, mark_s, orig, tuple(starts_s),
                     soa, chunk=chunk, uniform_mass=um)
    if mesh is not None:
        def place(a):
            return None if a is None else \
                jax.device_put(a, NamedSharding(mesh, P("part")))
        sg = ShardedGrid(m, jax.device_put(sg.lo, NamedSharding(mesh, P())),
                         jax.device_put(sg.period, NamedSharding(mesh, P())),
                         place(sg.pos), place(sg.mass), place(sg.vel),
                         place(sg.phi), place(sg.ptype), place(sg.mark),
                         place(sg.orig_idx), tuple(place(s) for s in sg.starts),
                         place(soa), chunk=chunk, uniform_mass=um)
    return sg



def _local_hits(grid: CellGrid, level: int, K: int, S: int, centers, radii,
                channels: tuple, r2_mask=None):
    """Per-shard slotted hits (unsorted): d2 + requested channel arrays,
    n_in, overflow. Uses the slab gather when the payload is present
    (channels from {"mass", "meta", "mvx", "mvy", "mvz", "ilo", "ihi"};
    meta packs species|mark<<4, ilo/ihi the f32-exact split local row).
    ``r2_mask`` optionally tightens the acceptance radius below radii^2
    (the member pass gathers at a covering radius but accepts d2cut)."""
    r2 = radii * radii if r2_mask is None else r2_mask
    if grid.soa8t is not None:
        from ..ops.gather import cell_ranges
        from ..ops.slab import slab_slots

        st, cnt, q, total = cell_ranges(grid, level, centers, radii, r2, S,
                                        align=grid.chunk)
        out = slab_slots(grid.soa8t, st, cnt, q, centers, grid.period, r2,
                         K, chans=tuple(channels), CHUNK=grid.chunk)
        d2 = out[:, 0]
        n_in = jnp.isfinite(d2).sum(axis=1).astype(jnp.int32)
        return (d2, *[out[:, 1 + i] for i in range(len(channels))],
                n_in, total > K)
    g = ragged_ball_gather(grid, level, centers, radii, r2, K, S, sort=False)
    ok = jnp.isfinite(g.d2)
    mv = None
    outs = [g.d2]
    for ch in channels:
        if ch == "mass":
            outs.append(jnp.where(ok, grid.mass_a()[g.idx], 0.0))
        elif ch == "meta":
            meta = (grid.ptype_a()[g.idx]
                    | (grid.mark_a()[g.idx].astype(jnp.int32) << 4)
                    ).astype(jnp.float32)
            outs.append(jnp.where(ok, meta, 0.0))
        elif ch in ("mvx", "mvy", "mvz"):
            if mv is None:
                mv = grid.mass_a()[g.idx, None] * grid.vel_a()[g.idx]
            outs.append(jnp.where(ok, mv[..., "xyz".index(ch[2])], 0.0))
        elif ch == "ilo":
            outs.append(jnp.where(ok, (g.idx & 0xFFF).astype(jnp.float32), 0.0))
        elif ch == "ihi":
            outs.append(jnp.where(ok, (g.idx >> 12).astype(jnp.float32), 0.0))
        else:
            raise ValueError(ch)
    return (*outs, g.n_in, g.overflow)


@partial(jax.jit, static_argnames=("mesh", "level", "K", "S", "n_members"))
def solve_stage_sharded(mesh: Mesh, sgrid: ShardedGrid, level: int, K: int,
                        S: int, n_members: int, centers, radii, thr):
    """The batched R_Delta stage, SPMD over (halo, part).

    Each device gathers its particle shard's candidates for its halo slice,
    all_gathers the per-shard (d2, mass, m*v) hit lists over 'part',
    merge-sorts, and runs the shared density scan. Outputs are
    halo-sharded and part-replicated.
    """
    um = sgrid.uniform_mass

    def body(sg: ShardedGrid, centers, radii, thr):
        grid = sg.local_cellgrid()
        if um is not None:
            # uniform mass: no mass channel — the all_gather merge halves
            # and the merge sort drops to one operand (cum is the shared
            # serial-f32 ladder inside scan_sorted)
            d2_l, n_in_l, ovf_l = _local_hits(grid, level, K, S, centers,
                                              radii, ())
        else:
            d2_l, mass_l, n_in_l, ovf_l = _local_hits(grid, level, K, S,
                                                      centers, radii,
                                                      ("mass",))

        # merge over the particle axis: all_gather + one sort
        d2_all = jax.lax.all_gather(d2_l, "part", axis=1, tiled=True)
        n_in = jax.lax.psum(n_in_l, "part")
        overflow = jax.lax.psum(ovf_l.astype(jnp.int32), "part") > 0

        if um is not None:
            d2_s = jax.lax.sort((d2_all,), num_keys=1, is_stable=False)[0]
            m_s = None
        else:
            m_all = jax.lax.all_gather(mass_l, "part", axis=1, tiled=True)
            d2_s, m_s = jax.lax.sort((d2_all, m_all), num_keys=1,
                                     is_stable=False)
        out = scan_sorted(d2_s, m_s, None, n_in, thr, n_members,
                          uniform_m=um)
        out.update(n_in=n_in, overflow=overflow)
        return out

    specs_grid = _specs_grid(sgrid)
    return jax.shard_map(
        body, mesh=mesh,
        in_specs=(specs_grid, P("halo"), P("halo"), P()),
        out_specs={k: P("halo") for k in
                   ("found", "jstar", "mvir", "rvir", "d2cut", "vcm",
                    "n_in", "overflow")},
        check_vma=False,  # outputs are 'part'-replicated via all_gather/psum
    )(sgrid, centers, radii, thr)


@partial(jax.jit, static_argnames=("mesh", "level", "K", "S", "n_members",
                                   "T"))
def classify_stage_sharded(mesh: Mesh, sgrid: ShardedGrid, level: int,
                           K: int, S: int, n_members: int, centers, radii,
                           thresholds, T: int = 1):
    """Sharded sort-free -1/-2 classify (--survey under a mesh).

    Each particle shard gathers its local hits and reduces them to the
    ascending kk-nearest prefix (engine.solver._classify_prefix); the
    kk-wide prefixes all_gather over 'part' (kk ~ 16 floats per halo —
    far cheaper than the K-wide solve merge) and a second top-k yields
    the exact global prefix, since every one of the kk globally-nearest
    hits is inside its own shard's kk-nearest. The verdict core is shared
    with the single-device path and is order-invariant (tie-deferral),
    so sharded verdicts are identical."""
    from ..engine.solver import (_classify_counts, _classify_prefix,
                                 _classify_verdict)

    kk = min(K, max(16, n_members + 2))

    um = sgrid.uniform_mass

    def body(sg: ShardedGrid, centers, radii, thrs):
        grid = sg.local_cellgrid()
        if um is not None:
            # uniform mass: the counting verdict (solver._classify_counts)
            # — counts are additive over particle shards, so four (B,)
            # psums replace the kk-prefix all_gather + double top_k
            d2_l, n_in_l, ovf_l = _local_hits(grid, level, K, S, centers,
                                              radii, ())
            n_in = jax.lax.psum(n_in_l, "part")
            overflow = jax.lax.psum(ovf_l.astype(jnp.int32), "part") > 0
            return _classify_counts(
                d2_l, n_in, overflow, thrs, T, n_members, um,
                psum=lambda c: jax.lax.psum(c, "part"))
        d2_l, mass_l, n_in_l, ovf_l = _local_hits(grid, level, K, S,
                                                  centers, radii, ("mass",))
        d2k_l, mk_l = _classify_prefix(d2_l, mass_l, kk)
        d2_all = jax.lax.all_gather(d2k_l, "part", axis=1, tiled=True)
        mk_all = jax.lax.all_gather(mk_l, "part", axis=1, tiled=True)
        n_in = jax.lax.psum(n_in_l, "part")
        overflow = jax.lax.psum(ovf_l.astype(jnp.int32), "part") > 0
        d2k, mk = _classify_prefix(d2_all, mk_all, kk)
        return _classify_verdict(d2k, mk, n_in, overflow, thrs, T,
                                 n_members)

    return jax.shard_map(
        body, mesh=mesh,
        in_specs=(_specs_grid(sgrid), P("halo"), P("halo"), P()),
        out_specs=P("halo"),
        check_vma=False,  # 'part'-replicated via all_gather/psum
    )(sgrid, centers, radii, thresholds)


def sharded_classify_fn(mesh: Mesh, sgrid: ShardedGrid):
    """Adapter matching solve_rvir's classify_stage_fn contract."""
    n_halo = mesh.shape["halo"]

    def stage(level, K, S, n_members, c_pad, r_pad, thr_vec):
        B = c_pad.shape[0]
        pad = (-B) % n_halo
        c = jnp.asarray(np.concatenate(
            [c_pad, np.zeros((pad, 3), np.float32)]) if pad else c_pad)
        r = jnp.asarray(np.concatenate(
            [r_pad, np.full(pad, 1e-30, np.float32)]) if pad else r_pad)
        thr = np.atleast_1d(np.asarray(thr_vec, np.float32))
        out = classify_stage_sharded(mesh, sgrid, level, K, S, n_members,
                                     c, r, jnp.asarray(thr),
                                     T=thr.shape[0])
        return np.asarray(out)[:B]

    return stage


@partial(jax.jit, static_argnames=("mesh", "level", "K", "S", "level2",
                                   "K2", "S2", "B2", "n_members", "dk"))
def solve_stage_fused_sharded(mesh: Mesh, sgrid: ShardedGrid, level: int,
                              K: int, S: int, level2: int, K2: int, S2: int,
                              B2: int, n_members: int, dk: int,
                              centers, radii, kleft, thr):
    """Two escalation rounds in ONE dispatch under shard_map: the sharded
    analog of engine.solver._solve_stage_fused. Tier-1 per-shard hits merge
    over 'part' (all_gather + sort) exactly like solve_stage_sharded; the
    tier-2 population/radii come from the shared fused_tier2_select (the
    inputs are part-replicated, so every shard of a halo row compacts the
    same ids) and the tier-2 gather+merge runs in the same program.
    Returns (p1, p2): p1 is the (B, 7) tier-1 block in global halo order;
    p2 is (n_halo * B2, 7) — each halo shard contributes its own compacted
    tier-2 rows with ids translated to GLOBAL halo rows, so the host
    driver's two-block decision logic applies unchanged."""
    from ..engine.solver import fused_tier2_select, pack_stage_out

    um = sgrid.uniform_mass

    def merged_scan(sg, level_, K_, S_, centers_, radii_, thr_):
        grid = sg.local_cellgrid()
        if um is not None:
            d2_l, n_in_l, ovf_l = _local_hits(grid, level_, K_, S_,
                                              centers_, radii_, ())
        else:
            d2_l, mass_l, n_in_l, ovf_l = _local_hits(
                grid, level_, K_, S_, centers_, radii_, ("mass",))
        d2_all = jax.lax.all_gather(d2_l, "part", axis=1, tiled=True)
        n_in = jax.lax.psum(n_in_l, "part")
        overflow = jax.lax.psum(ovf_l.astype(jnp.int32), "part") > 0
        if um is not None:
            d2_s = jax.lax.sort((d2_all,), num_keys=1, is_stable=False)[0]
            m_s = None
        else:
            m_all = jax.lax.all_gather(mass_l, "part", axis=1, tiled=True)
            d2_s, m_s = jax.lax.sort((d2_all, m_all), num_keys=1,
                                     is_stable=False)
        out = scan_sorted(d2_s, m_s, None, n_in, thr_, n_members,
                          uniform_m=um)
        out.update(n_in=n_in, overflow=overflow)
        return out

    def body(sg: ShardedGrid, centers, radii, kleft, thr):
        B = centers.shape[0]          # per-shard halo rows
        out1 = merged_scan(sg, level, K, S, centers, radii, thr)
        p1 = pack_stage_out(out1)
        p1x = jnp.concatenate([p1, jnp.zeros((B, 2), jnp.int32)], axis=1)

        idc, valid2, steps, c2, r2 = fused_tier2_select(
            out1["found"], out1["overflow"], out1["n_in"], kleft, centers,
            radii, B2, dk, n_members)
        out2 = merged_scan(sg, level2, K2, S2, c2, r2, thr)
        gid = jax.lax.axis_index("halo").astype(jnp.int32) * B + idc
        p2 = jnp.concatenate(
            [pack_stage_out(out2),
             jnp.where(valid2, gid, -1)[:, None], steps[:, None]], axis=1)
        return p1x, p2

    specs_grid = _specs_grid(sgrid)
    return jax.shard_map(
        body, mesh=mesh,
        in_specs=(specs_grid, P("halo"), P("halo"), P("halo"), P()),
        out_specs=(P("halo"), P("halo")),
        check_vma=False,
    )(sgrid, centers, radii, kleft, thr)


@partial(jax.jit, static_argnames=("mesh", "level", "K", "S", "n_members",
                                   "species"))
def derived_stage_sharded(mesh: Mesh, sgrid: ShardedGrid, level: int, K: int,
                          S: int, n_members: int, species: tuple,
                          centers, rvir, mvir, grav):
    """Sharded kdVcirc/kdMassProfile: per-shard gathers at 2*Rvir are
    all_gathered over 'part' and merge-sorted; the species profile
    partial sums are thereby exactly merged across particle shards (the
    'psum-merged profiles' of the multi-host configuration)."""
    from ..engine.derived import derived_from_sorted

    um = sgrid.uniform_mass

    def body(sg: ShardedGrid, centers, rvir, mvir, grav):
        grid = sg.local_cellgrid()
        fball = jnp.float32(2.0) * rvir
        if um is not None:
            # mass dropped (ladder cum in derived_from_sorted); meta kept
            # only while species profiles are requested
            chans = ("meta",) if species else ()
        else:
            chans = ("mass", "meta") if species else ("mass",)
        outs = _local_hits(grid, level, K, S, centers, fball, chans)
        d2_l, ch_l, n_in_l, ovf_l = outs[0], outs[1:-2], outs[-2], outs[-1]

        d2_all = jax.lax.all_gather(d2_l, "part", axis=1, tiled=True)
        ch_all = [jax.lax.all_gather(c, "part", axis=1, tiled=True)
                  for c in ch_l]
        n_in = jax.lax.psum(n_in_l, "part")
        overflow = jax.lax.psum(ovf_l.astype(jnp.int32), "part") > 0

        srt = jax.lax.sort((d2_all, *ch_all), num_keys=1, is_stable=False)
        d2_s, rest = srt[0], list(srt[1:])
        m_s = None if um is not None else rest.pop(0)
        if species:
            meta = rest.pop(0).astype(jnp.int32)
            ptype_s, mark_s = meta & 0xF, (meta >> 4) > 0
        else:
            ptype_s = jnp.zeros_like(d2_s, jnp.int32)
            mark_s = jnp.zeros_like(d2_s, bool)
        out = derived_from_sorted(d2_s, m_s, ptype_s, mark_s,
                                  n_in, rvir, mvir, fball, n_members,
                                  species, grav, uniform_m=um)
        out.update(overflow=overflow)
        return out

    specs_grid = _specs_grid(sgrid)
    out_keys = ["vcirc", "rmass", "rmax", "vmax", "n_in", "overflow"]
    out_specs = {k: P("halo") for k in out_keys}
    out_specs["profiles"] = {sp: P("halo") for sp in species}
    return jax.shard_map(
        body, mesh=mesh,
        in_specs=(specs_grid, P("halo"), P("halo"), P("halo"), P()),
        out_specs=out_specs,
        check_vma=False,
    )(sgrid, centers, rvir, mvir, grav)


@partial(jax.jit, static_argnames=("mesh", "level", "K", "S"))
def members_stage_sharded(mesh: Mesh, sgrid: ShardedGrid, level: int, K: int,
                          S: int, centers, cover_r, d2cut, j):
    """Sharded interior-member extraction (kdTagParticles, kd2.c:823):
    per-shard gathers are translated to *global* original particle
    indices, all_gathered over 'part', merge-sorted by distance, and cut
    at the interior count j. Returns the same (orig, n_in, overflow) as
    engine.members._members_stage, with the slot axis nshards*K wide.
    vcm is NOT computed here — the caller derives it host-side from the
    member lists (engine.members.vcm_from_members), the one documented
    _VcmParticles accumulation order (kd2.c:595-609); the m*v channels
    this stage once gathered (a second f32 slot-sum order) also doubled
    the all_gather merge bytes."""
    from ..ops.slab import decode_idx

    def body(sg: ShardedGrid, centers, cover_r, d2cut, j):
        grid = sg.local_cellgrid()
        d2_l, ilo, ihi, n_in_l, ovf_l = _local_hits(
            grid, level, K, S, centers, cover_r,
            ("ilo", "ihi"), r2_mask=d2cut)
        rowl = decode_idx(ilo, ihi)
        orig_l = jnp.where(jnp.isfinite(d2_l),
                           grid.orig_idx[jnp.clip(rowl, 0, grid.n - 1)], -1)

        ag = lambda a: jax.lax.all_gather(a, "part", axis=1, tiled=True)
        n_in = jax.lax.psum(n_in_l, "part")
        overflow = jax.lax.psum(ovf_l.astype(jnp.int32), "part") > 0

        d2_s, orig_s = jax.lax.sort((ag(d2_l), ag(orig_l)),
                                    num_keys=1, is_stable=False)
        Km = d2_s.shape[1]
        interior = jnp.arange(Km, dtype=jnp.int32)[None, :] < j[:, None]
        orig = jnp.where(interior & jnp.isfinite(d2_s), orig_s, -1)
        return dict(orig=orig, n_in=n_in, overflow=overflow)

    specs_grid = _specs_grid(sgrid)
    out = jax.shard_map(
        body, mesh=mesh,
        in_specs=(specs_grid, P("halo"), P("halo"), P("halo"), P("halo")),
        out_specs={k: P("halo") for k in ("orig", "n_in", "overflow")},
        check_vma=False,
    )(sgrid, centers, cover_r, d2cut, j)
    return out["orig"], out["n_in"], out["overflow"]


@partial(jax.jit, static_argnames=("mesh", "level", "K", "S", "n_members",
                                   "species"))
def fused_members_stage_sharded(mesh: Mesh, sgrid: ShardedGrid, level: int,
                                K: int, S: int, n_members: int,
                                species: tuple, centers, rvir, j, mvir,
                                grav):
    """Sharded fused members+derived (the shard_map analog of
    engine.fused._fused_stage): ONE per-shard gather at 2*Rvir per halo,
    merged over 'part' (all_gather + sort), feeding BOTH
    derived_from_sorted and the interior member rows — the --mesh pipeline
    previously re-gathered every 2*Rvir ball twice.
    Returns halo-sharded (orig, dblock): orig is the (B, nshards*K)
    interior-masked global original-index matrix, dblock the packed
    derived block of sharded_derived_fn's contract."""
    from ..engine.derived import derived_from_sorted
    from ..ops.slab import decode_idx

    um = sgrid.uniform_mass

    def body(sg: ShardedGrid, centers, rvir, j, mvir, grav):
        grid = sg.local_cellgrid()
        fball = jnp.float32(2.0) * rvir
        chans = (() if um is not None else ("mass",)) \
            + (("meta",) if species else ()) + ("ilo", "ihi")
        outs = _local_hits(grid, level, K, S, centers, fball, chans)
        d2_l, rest, (n_in_l, ovf_l) = outs[0], outs[1:-2], outs[-2:]
        rowl = decode_idx(rest[-2], rest[-1])
        orig_l = jnp.where(jnp.isfinite(d2_l),
                           grid.orig_idx[jnp.clip(rowl, 0, grid.n - 1)], -1)

        ag = lambda a: jax.lax.all_gather(a, "part", axis=1, tiled=True)
        n_in = jax.lax.psum(n_in_l, "part")
        overflow = jax.lax.psum(ovf_l.astype(jnp.int32), "part") > 0
        ops = (ag(d2_l),) \
            + (() if um is not None else (ag(rest[0]),)) \
            + ((ag(rest[-3]),) if species else ()) + (ag(orig_l),)
        sorted_ops = jax.lax.sort(ops, num_keys=1, is_stable=False)
        d2_s = sorted_ops[0]
        mass_s = None if um is not None else sorted_ops[1]
        if species:
            meta = sorted_ops[-2].astype(jnp.int32)
            ptype_s, mark_s = meta & 0xF, (meta >> 4) > 0
        else:
            ptype_s = jnp.zeros_like(d2_s, jnp.int32)
            mark_s = jnp.zeros_like(d2_s, bool)
        orig_s = sorted_ops[-1]

        der = derived_from_sorted(d2_s, mass_s, ptype_s, mark_s, n_in,
                                  rvir, mvir, fball, n_members, species,
                                  grav, uniform_m=um)
        Km = d2_s.shape[1]
        interior = (jnp.arange(Km, dtype=jnp.int32)[None, :] < j[:, None]) \
            & jnp.isfinite(d2_s)
        orig = jnp.where(interior, orig_s, -1)
        dblock = jnp.concatenate(
            [overflow.astype(jnp.float32)[:, None], der["vcirc"],
             der["rmass"], der["rmax"][:, None], der["vmax"][:, None]]
            + [der["profiles"][sp] for sp in species], axis=1)
        return dict(orig=orig, dblock=dblock)

    specs_grid = _specs_grid(sgrid)
    return jax.shard_map(
        body, mesh=mesh,
        in_specs=(specs_grid, P("halo"), P("halo"), P("halo"), P("halo"),
                  P()),
        out_specs={k: P("halo") for k in ("orig", "dblock")},
        check_vma=False,
    )(sgrid, centers, rvir, j, mvir, grav)


def sharded_fused_members_fn(mesh: Mesh, sgrid: ShardedGrid):
    """Adapter matching engine.fused.members_and_derived's stage_fn
    contract ((packed, counts, dblock)); packing to the dense member
    vector happens host-side (locally-attached meshes fetch (B, K)
    cheaply — see sharded_members_fn)."""
    n_halo = mesh.shape["halo"]

    def stage(level, K, S, cap, n_members, species, centers, rvir, j, mvir,
              grav):
        B = centers.shape[0]
        pad = (-B) % n_halo
        if pad:
            zf = lambda a, fill: jnp.concatenate(
                [a, jnp.full((pad,) + a.shape[1:], fill, a.dtype)])
            centers = zf(centers, 0.0)
            rvir = zf(rvir, 1e-30)
            j = zf(j, 0)
            mvir = zf(mvir, 1.0)
        out = fused_members_stage_sharded(
            mesh, sgrid, level, K, S, n_members, tuple(species),
            centers, rvir, j, mvir, grav)
        orig = np.asarray(out["orig"])[:B]
        valid = orig >= 0
        counts = valid.sum(axis=1).astype(np.int32)
        packed = orig[valid]          # row-major: (halo, distance) order
        return packed, counts, np.asarray(out["dblock"])[:B]

    return stage


def sharded_members_fn(mesh: Mesh, sgrid: ShardedGrid):
    """Adapter with the same signature as engine.members._members_stage
    (minus the grid argument), for reuse of the host-side escalation
    driver via extract_members(stage_fn=...). Packing to the dense member
    vector happens host-side here, where the single-device path packs on
    the device (engine.members._pack_prefix)."""
    n_halo = mesh.shape["halo"]

    def stage(level, K, S, cap, centers, cover_r, d2cut, j, mvir):
        B = centers.shape[0]
        pad = (-B) % n_halo
        if pad:
            zf = lambda a, fill: jnp.concatenate(
                [a, jnp.full((pad,) + a.shape[1:], fill, a.dtype)])
            centers = zf(centers, 0.0)
            cover_r = zf(cover_r, 1e-30)
            d2cut = zf(d2cut, 0.0)
            j = zf(j, 0)
        orig, n_in, ovf = members_stage_sharded(
            mesh, sgrid, level, K, S, centers, cover_r, d2cut, j)
        orig = np.asarray(orig)[:B]
        valid = orig >= 0
        counts = valid.sum(axis=1).astype(np.int32)
        packed = orig[valid]          # row-major: (halo, distance) order
        return packed, counts, n_in[:B], ovf[:B]

    return stage


def host_mv_from_sharded(sgrid: ShardedGrid):
    """Lazy ``(vel, mass)`` pair in ORIGINAL file order, reconstructed
    from the shards (one fetch). Shard padding rows all carry orig_idx 0,
    so the scatter runs in REVERSE flat order: padding lives at the tail
    of the last shard block (sentinel Morton codes sort high), hence the
    real row for index 0 — in shard 0 — is written after every pad row."""
    oi = np.asarray(sgrid.orig_idx).reshape(-1)
    if sgrid.vel is not None:
        vel = np.asarray(sgrid.vel, np.float32).reshape(-1, 3)
        mass = np.asarray(sgrid.mass, np.float32).reshape(-1)
    else:
        nl = sgrid.n_local
        soa = np.asarray(sgrid.soa8t, np.float32)      # (nsh, 8, Nl+chunk)
        vel = soa[:, 4:7, :nl].transpose(0, 2, 1).reshape(-1, 3)
        mass = soa[:, 3, :nl].reshape(-1)
    n = int(oi.max()) + 1 if oi.size else 0
    vel_o = np.zeros((n, 3), np.float32)
    mass_o = np.zeros(n, np.float32)
    vel_o[oi[::-1]] = vel[::-1]
    mass_o[oi[::-1]] = mass[::-1]
    return vel_o, mass_o


def extract_members_sharded(mesh: Mesh, sgrid: ShardedGrid, centers, d2cut,
                            j, mvir, host_mv=None, **kw):
    """Multi-device extract_members: same escalation driver, sharded stage.
    ``host_mv`` (original-order m*v, or the lazy (vel, mass) pair) feeds
    the shared host-side vcm (engine.members.vcm_from_members); when None
    it is reconstructed from the shards with one fetch."""
    from ..engine.members import extract_members

    if host_mv is None:
        host_mv = host_mv_from_sharded(sgrid)
    return extract_members(grid_proxy(sgrid), centers, d2cut, j, mvir,
                           stage_fn=sharded_members_fn(mesh, sgrid),
                           host_mv=host_mv, **kw)


def sharded_stage_fn(mesh: Mesh, sgrid: ShardedGrid):
    """Adapter with the same signature as engine.solver._solve_stage, for
    reuse of the host-side escalation driver."""
    n_halo = mesh.shape["halo"]

    def stage(level, K, S, n_members, centers, radii, thr):
        from ..engine.solver import pack_stage_out

        B = centers.shape[0]
        pad = (-B) % n_halo
        if pad:
            centers = jnp.concatenate(
                [centers, jnp.zeros((pad, 3), jnp.float32)])
            radii = jnp.concatenate([radii, jnp.full(pad, 1e-30, jnp.float32)])
        out = solve_stage_sharded(mesh, sgrid, level, K, S, n_members,
                                  centers, radii, thr)
        if pad:
            out = {k: v[:B] for k, v in out.items()}
        return pack_stage_out(out)  # (B, 7) i32, see unpack_stage_out

    return stage


@partial(jax.jit, static_argnames=("mesh", "level", "K", "S", "n_members",
                                   "T"))
def multi_stage_sharded(mesh: Mesh, sgrid: ShardedGrid, level: int, K: int,
                        S: int, n_members: int, T: int, centers, radii,
                        thresholds):
    """Sharded multi-threshold stage: ONE part-merged gather+sort per halo,
    T density scans (engine.multi._multi_stage under shard_map). Output is
    the same (T+1, B, 5) packed block, halo-sharded on axis 1."""
    from ..engine.solver import scan_sorted as _scan

    um = sgrid.uniform_mass

    def body(sg: ShardedGrid, centers, radii, thresholds):
        grid = sg.local_cellgrid()
        if um is not None:
            d2_l, n_in_l, ovf_l = _local_hits(grid, level, K, S, centers,
                                              radii, ())
        else:
            d2_l, mass_l, n_in_l, ovf_l = _local_hits(grid, level, K, S,
                                                      centers, radii,
                                                      ("mass",))
        d2_all = jax.lax.all_gather(d2_l, "part", axis=1, tiled=True)
        n_in = jax.lax.psum(n_in_l, "part")
        ovf = jax.lax.psum(ovf_l.astype(jnp.int32), "part") > 0
        if um is not None:
            d2_s = jax.lax.sort((d2_all,), num_keys=1, is_stable=False)[0]
            m_s = None
        else:
            m_all = jax.lax.all_gather(mass_l, "part", axis=1, tiled=True)
            d2_s, m_s = jax.lax.sort((d2_all, m_all), num_keys=1,
                                     is_stable=False)
        outs = [_scan(d2_s, m_s, None, n_in, thresholds[t], n_members,
                      uniform_m=um)
                for t in range(T)]
        bc = lambda x: jax.lax.bitcast_convert_type(x, jnp.int32)
        per_t = jnp.stack([jnp.stack(
            [o["found"].astype(jnp.int32), o["jstar"],
             bc(o["mvir"]), bc(o["rvir"]), bc(o["d2cut"])], axis=1)
            for o in outs])
        tail = jnp.stack([n_in.astype(jnp.int32), ovf.astype(jnp.int32),
                          jnp.zeros_like(n_in), jnp.zeros_like(n_in),
                          jnp.zeros_like(n_in)], axis=1)[None]
        return jnp.concatenate([per_t, tail], axis=0)

    specs_grid = _specs_grid(sgrid)
    return jax.shard_map(
        body, mesh=mesh,
        in_specs=(specs_grid, P("halo"), P("halo"), P()),
        out_specs=P(None, "halo"),
        check_vma=False,
    )(sgrid, centers, radii, thresholds)


def solve_rvir_multi_sharded(mesh: Mesh, sgrid: ShardedGrid, centers, rgtp,
                             thresholds, n_members: int = 8, **kw):
    """Multi-device multi-threshold solve: same escalation driver."""
    from ..engine.multi import solve_rvir_multi

    n_halo = mesh.shape["halo"]
    thr_dev = jnp.asarray(np.asarray(thresholds, np.float32))

    def stage(level, K, S, nm, T, centers, radii):
        B = centers.shape[0]
        pad = (-B) % n_halo
        if pad:
            centers = jnp.concatenate(
                [centers, jnp.zeros((pad, 3), jnp.float32)])
            radii = jnp.concatenate([radii, jnp.full(pad, 1e-30,
                                                     jnp.float32)])
        out = multi_stage_sharded(mesh, sgrid, level, K, S, nm, T,
                                  centers, radii, thr_dev)
        return out[:, :B]

    kw.setdefault("classify_stage_fn", sharded_classify_fn(mesh, sgrid))
    return solve_rvir_multi(grid_proxy(sgrid), centers, rgtp, thresholds,
                            n_members=n_members, stage_fn=stage, **kw)


@partial(jax.jit, static_argnames=("mesh", "level", "K", "S"))
def recenter_stage_sharded(mesh: Mesh, sgrid: ShardedGrid, level: int,
                           K: int, S: int, centers, radii):
    """Sharded -pot recentring (kdRvir's bPot block, kd2.c:749-761): each
    particle shard gathers its own candidates, the (phi, d2, position)
    triples are all_gathered over 'part', and the min-phi argmin runs on
    the merged list. Ties break in (shard, slot) order — backend-specific
    order, as documented in engine/recenter.py."""
    def body(sg: ShardedGrid, centers, radii):
        grid = sg.local_cellgrid()
        g = ragged_ball_gather(grid, level, centers, radii, radii * radii,
                               K, S, sort=False)
        ok = jnp.isfinite(g.d2)
        phi_l = jnp.where(ok, grid.phi_a()[g.idx], jnp.inf)
        pos_l = grid.pos_a()[g.idx]
        n_in_l = ok.sum(axis=1).astype(jnp.int32)

        ag = lambda a, ax: jax.lax.all_gather(a, "part", axis=ax, tiled=True)
        phi = ag(phi_l, 1)
        pos = ag(pos_l, 1)
        n_in = jax.lax.psum(n_in_l, "part")
        overflow = jax.lax.psum(g.overflow.astype(jnp.int32), "part") > 0
        rows = jnp.arange(centers.shape[0])
        amin = jnp.argmin(phi, axis=1)
        best = pos[rows, amin]
        new_centers = jnp.where((n_in > 0)[:, None], best, centers)
        return dict(centers=new_centers, n_in=n_in, overflow=overflow)

    specs_grid = _specs_grid(sgrid)
    return jax.shard_map(
        body, mesh=mesh,
        in_specs=(specs_grid, P("halo"), P("halo")),
        out_specs={k: P("halo") for k in ("centers", "n_in", "overflow")},
        check_vma=False,
    )(sgrid, centers, radii)


def recenter_most_bound_sharded(mesh: Mesh, sgrid: ShardedGrid, centers,
                                rgtp, k0_cap: int = 4096, s_max: int = 11):
    """Multi-device recenter_most_bound: same escalation shape."""
    from ..engine.solver import _k_limit, _pad_to_bucket, _pick_level_span

    # XLA per-shard gathers inside shard_map: no slab payload in the
    # level/K logic
    proxy = grid_proxy(sgrid, with_slab=False)
    n_halo = mesh.shape["halo"]
    G = centers.shape[0]
    centers = np.asarray(centers, np.float32)
    radii_all = np.asarray(rgtp, np.float32)
    out = centers.copy()
    todo = np.arange(G)
    capacity = k0_cap
    while todo.size:
        # per-shard capacity: the merged list holds nshards * K slots
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
        res = recenter_stage_sharded(mesh, sgrid, level, K, S,
                                     jnp.asarray(c_pad), jnp.asarray(r_pad))
        nc = np.asarray(res["centers"])[:todo.size]
        ovf = np.asarray(res["overflow"])[:todo.size]
        out[todo[~ovf]] = nc[~ovf]
        todo = todo[ovf]
        capacity *= 4
        if capacity > max(8 * _k_limit(proxy, s_max), k0_cap) and todo.size:
            raise RuntimeError("sharded recentring escalation runaway")
    return out


def sharded_derived_fn(mesh: Mesh, sgrid: ShardedGrid):
    """Adapter matching engine.derived.compute_derived's stage_fn contract
    (packed (B, 13 + 16*nspecies) block, column 0 = overflow)."""
    n_halo = mesh.shape["halo"]

    def stage(level, K, S, n_members, species, centers, rvir, mvir, grav):
        B = centers.shape[0]
        pad = (-B) % n_halo
        if pad:
            zf = lambda a, fill: jnp.concatenate(
                [a, jnp.full((pad,) + a.shape[1:], fill, a.dtype)])
            centers = zf(centers, 0.0)
            rvir = zf(rvir, 1e-30)
            mvir = zf(mvir, 0.0)
        out = derived_stage_sharded(mesh, sgrid, level, K, S, n_members,
                                    tuple(species), centers, rvir, mvir,
                                    grav)
        block = jnp.concatenate(
            [out["overflow"].astype(jnp.float32)[:, None], out["vcirc"],
             out["rmass"], out["rmax"][:, None], out["vmax"][:, None]]
            + [out["profiles"][sp] for sp in species], axis=1)
        return block[:B]

    return stage


def run_so_sharded(particles, catalog, params, mesh: Mesh):
    """Multi-device end-to-end pipeline: the run_so stage order with every
    device phase sharded over (halo x part) — solve, the fused
    members+derived pass (ONE 2*Rvir gather per halo, like the
    single-device pipeline), and recentring run under shard_map; the
    mass-ordered conflict pass stays host-side by design. Single-process
    multi-chip meshes (one-host pods / the virtual-CPU test mesh); the
    CLI's --mesh flag routes here. The post-solve sequence is the shared
    engine.pipeline._post_solve with injected shard_map stages."""
    import time as _time

    from ..engine.pipeline import _post_solve
    from ..profiling import PhaseTimer, profile_trace

    timer = PhaseTimer()
    with profile_trace(params.profile_dir):
        with timer.phase("sharded grid build"):
            sgrid = build_sharded_grid(
                particles.pos, particles.mass, vel=particles.vel,
                phi=particles.phi, ptype=particles.ptype_all(),
                mark=(particles.mark if particles.mark is not None
                      else None),
                period=params.period, center=params.center,
                m=params.grid_m, mesh=mesh)

        centers = np.asarray(catalog.pos, np.float32).copy()
        rgtp = np.asarray(catalog.rgtp, np.float32)
        if params.b_pot:
            with timer.phase("recenter (-pot, sharded)"):
                centers = recenter_most_bound_sharded(mesh, sgrid, centers,
                                                      rgtp)
                catalog.pos = centers

        t0 = _time.perf_counter()
        with timer.phase("R_Delta solve (sharded)"):
            solve = solve_rvir_sharded(mesh, sgrid, centers, rgtp,
                                       params.threshold,
                                       n_members=params.n_members,
                                       survey=params.survey)

        run = _post_solve(grid_proxy(sgrid), particles, catalog, centers,
                          solve, params, timer,
                          fused_fn=sharded_fused_members_fn(mesh, sgrid),
                          derived_fn=sharded_derived_fn(mesh, sgrid))

    run.solve_seconds = _time.perf_counter() - t0
    if params.verbose:
        timer.report()
    return run


def run_so_multi_sharded(particles, catalog, params, thresholds,
                         mesh: Mesh):
    """Sharded multi-threshold pipeline (--mesh --deltas): one sharded
    grid + the shared-gather multi solve (solve_rvir_multi_sharded), then
    the full per-threshold post-processing with the sharded fused
    members+derived stages — each returned SORun equals an independent
    run_so at that threshold (mirrors engine.pipeline.run_so_multi)."""
    import time as _time

    from ..engine.pipeline import SORun, _post_solve
    from ..engine.solver import SolveResult
    from ..profiling import PhaseTimer, profile_trace

    timer = PhaseTimer()
    runs: list[SORun] = []
    with profile_trace(params.profile_dir):
        with timer.phase("sharded grid build"):
            sgrid = build_sharded_grid(
                particles.pos, particles.mass, vel=particles.vel,
                phi=particles.phi, ptype=particles.ptype_all(),
                mark=(particles.mark if particles.mark is not None
                      else None),
                period=params.period, center=params.center,
                m=params.grid_m, mesh=mesh)
        centers = np.asarray(catalog.pos, np.float32).copy()
        rgtp = np.asarray(catalog.rgtp, np.float32)
        if params.b_pot:
            with timer.phase("recenter (-pot, sharded)"):
                centers = recenter_most_bound_sharded(mesh, sgrid, centers,
                                                      rgtp)
                catalog.pos = centers

        t0 = _time.perf_counter()
        with timer.phase("R_Delta solve (multi, sharded)"):
            multi = solve_rvir_multi_sharded(mesh, sgrid, centers, rgtp,
                                             thresholds,
                                             n_members=params.n_members,
                                             survey=params.survey)
        for t in range(len(thresholds)):
            solve_t = SolveResult(
                code=multi.code[t].copy(), mvir=multi.mvir[t].copy(),
                rvir=multi.rvir[t].copy(), j=multi.j[t].copy(),
                d2cut=multi.d2cut[t].copy(),
                vcm=np.zeros((catalog.n, 3), np.float32))
            run = _post_solve(grid_proxy(sgrid), particles, catalog,
                              centers, solve_t, params, timer,
                              fused_fn=sharded_fused_members_fn(mesh,
                                                                sgrid),
                              derived_fn=sharded_derived_fn(mesh, sgrid))
            run.solve_seconds = _time.perf_counter() - t0
            runs.append(run)
    if params.verbose:
        timer.report()
    return runs


def sharded_fused_stage_fn(mesh: Mesh, sgrid: ShardedGrid):
    """Adapter matching engine.solver's fused_stage_fn contract: tier-1
    rows [0:B] + tier-2 rows [B:] with global halo ids — the driver's
    decision logic runs unchanged on multi-device meshes."""
    n_halo = mesh.shape["halo"]

    def stage(level, K, S, level2, K2, S2, B2, n_members, dk,
              centers, radii, kleft, thr):
        B = centers.shape[0]
        pad = (-B) % n_halo
        if pad:
            centers = jnp.concatenate(
                [centers, jnp.zeros((pad, 3), jnp.float32)])
            radii = jnp.concatenate([radii, jnp.full(pad, 1e-30, jnp.float32)])
            kleft = jnp.concatenate([kleft, jnp.zeros(pad, jnp.int32)])
        p1, p2 = solve_stage_fused_sharded(
            mesh, sgrid, level, K, S, level2, K2, S2, B2, n_members, dk,
            centers, radii, kleft, thr)
        # ids in p2 reference the padded batch; rows pointing at pad halos
        # are dropped by the driver's `ids < part.size` check
        return jnp.concatenate([p1[:B], p2], axis=0)

    return stage


def solve_rvir_sharded(mesh: Mesh, sgrid: ShardedGrid, centers, rgtp, thr,
                       n_members: int = 8, **kw):
    """Multi-device solve_rvir: same escalation driver, sharded stage."""
    from ..engine import solver

    kw.setdefault("fused_stage_fn", sharded_fused_stage_fn(mesh, sgrid))
    kw.setdefault("classify_stage_fn", sharded_classify_fn(mesh, sgrid))
    return solver.solve_rvir(grid_proxy(sgrid), centers, rgtp, thr,
                             n_members=n_members,
                             stage_fn=sharded_stage_fn(mesh, sgrid), **kw)
