"""Fused member-extraction + derived-quantity pass.

The reference re-gathers every solved group twice: kdTagParticles walks the
j interior particles (call site kd2.c:823) and kdVcirc re-gathers at 2*Rvir
(kd2.c:511-514). Both passes read the same ball (the interior is a prefix
of the 2*Rvir gather, sorted by distance), so one fused stage gathers at
2*Rvir with (mass, meta, idx) channels and derives BOTH products from the
single sorted stack:

  - derived quantities via engine.derived.derived_from_sorted (bit-equal:
    same sorted inputs as the separate stage),
  - interior member lists as the first j sorted rows (identical set to the
    d2cut-masked member gather; tie order at the d2cut boundary is
    arbitrary in both, as in the reference's unstable qsort),

halving the gather+sort work and the dispatches and fetches of the
post-solve phases. vcm is computed host-side from the member rows
(_VcmParticles, kd2.c:595-609), as in the host_mv member path.

Eligibility: kdVcirc runs only for groups not slurped during their own
tagging (kd2.c:884), which is known only after the host conflict pass.
Since derived quantities read only particle data, the fused stage computes
them for every solved group and the pipeline zeroes the slurped rows after
the conflict pass — observably identical output.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..ops.gather import ragged_ball_gather, slab_gather
from ..ops.grid import CellGrid
from .derived import NMASSPROFILE, NVCIRC, DerivedResult, derived_from_sorted
from .members import _pack_prefix


@partial(jax.jit, static_argnames=("level", "K", "S", "cap", "n_members",
                                   "species"))
def _fused_stage(grid: CellGrid, level: int, K: int, S: int, cap: int,
                 n_members: int, species: tuple, centers, rvir, j, mvir,
                 grav):
    fball = jnp.float32(2.0) * rvir
    fball2 = fball * fball
    B = centers.shape[0]
    slot = jnp.arange(K, dtype=jnp.int32)[None, :]
    um = grid.uniform_mass
    if grid.soa8t is not None:
        # meta feeds only the species profiles and mass only the general
        # (non-uniform) cumulative sums — dropping either takes one operand
        # out of the K-wide sort
        chans = (() if um is not None else ("mass",)) \
            + (("meta",) if species else ()) + ("idx",)
        sg = slab_gather(grid, level, centers, fball, fball2, K, S,
                         channels=chans)
        d2_s = sg.d2
        mass_s = None if um is not None else sg.channels[0]
        if species:
            meta = sg.channels[-2].astype(jnp.int32)
            ptype_s, mark_s = meta & 0xF, (meta >> 4) > 0
        else:
            ptype_s = jnp.zeros_like(d2_s, jnp.int32)
            mark_s = jnp.zeros_like(d2_s, bool)
        srow = sg.channels[-1]
        n_in, overflow = sg.n_in, sg.overflow
    else:
        g = ragged_ball_gather(grid, level, centers, fball, fball2, K, S,
                               sort=True)
        valid = slot < g.n_in[:, None]
        d2_s = g.d2
        mass_s = None if um is not None \
            else jnp.where(valid, grid.mass_a()[g.idx], 0.0)
        ptype_s = grid.ptype_a()[g.idx]
        mark_s = grid.mark_a()[g.idx] & valid
        srow = jnp.where(valid, g.idx, -1)
        n_in, overflow = g.n_in, g.overflow

    der = derived_from_sorted(d2_s, mass_s, ptype_s, mark_s, n_in, rvir,
                              mvir, fball, n_members, species, grav,
                              uniform_m=um)

    # interior members: first j sorted rows (kdTagParticles walk order) —
    # a contiguous PREFIX of each sorted row, so the dense member vector
    # is a computed gather (_pack_prefix), not a flat B*K sort. Original
    # indices are translated only on the packed vector, not through a
    # (B, K) orig_idx[srow] random row-gather.
    interior = (slot < j[:, None]) & jnp.isfinite(d2_s) & (srow >= 0)
    counts = jnp.minimum(j.astype(jnp.int32), n_in)
    packed_rows, counts = _pack_prefix(jnp.where(interior, srow, -1),
                                       counts, cap)
    packed = jnp.where(packed_rows >= 0,
                       grid.orig_idx[jnp.clip(packed_rows, 0, grid.n - 1)],
                       -1)

    dblock = jnp.concatenate(
        [overflow.astype(jnp.float32)[:, None], der["vcirc"], der["rmass"],
         der["rmax"][:, None], der["vmax"][:, None]]
        + [der["profiles"][sp] for sp in species], axis=1)
    # ONE flat i32 output buffer [counts | packed | dblock bits]: the
    # three outputs ship as a single device-to-host transfer and the host
    # splits them (the bitcast is free on both ends)
    return jnp.concatenate(
        [counts, packed,
         jax.lax.bitcast_convert_type(dblock, jnp.int32).reshape(-1)])


def members_and_derived(grid: CellGrid, centers: np.ndarray,
                        rvir: np.ndarray, d2cut: np.ndarray, j: np.ndarray,
                        mvir: np.ndarray, host_mv,
                        n_members: int = 8, species: tuple = (),
                        grav: float = 1.0, s_max: int = 11,
                        slot_budget: int = 1 << 25, stage_fn=None,
                        vcm_fn=None, member_filter=None):
    """One fused pass over the solved halos: (members, vcm, DerivedResult).

    Same escalation shape as engine.members.extract_members /
    engine.derived.compute_derived; capacity sized for the 2*Rvir ball.

    ``stage_fn(level, K, S, cap, n_members, species, centers, rvir, j,
    mvir, grav) -> (packed, counts, dblock)`` overrides the single-device
    fused stage — the multi-device path
    (parallel.mesh.sharded_fused_members_fn) injects its shard_map stage
    here and reuses this escalation driver unchanged. (The default
    _fused_stage returns the same three outputs concatenated into one
    flat i32 buffer — one transfer instead of three; the driver
    accepts both forms.)

    ``vcm_fn(rows, counts, mvir_rows) -> (n, 3) f32`` overrides the
    host-side vcm computation for hosts that hold only a particle segment
    (parallel.driver computes per-segment member_mv_sums partials and
    merges them across processes); default: members.vcm_from_members over
    ``host_mv``.

    ``member_filter(piece) -> object`` transforms each halo's full
    distance-sorted member-row array before storage — the multi-controller
    driver keeps only rows inside its particle segment
    (parallel.driver.seg_member_filter), so no host retains the O(total
    member rows) lists; the full array stays a per-chunk transient.
    """
    from .solver import (_chunk_for, _k_limit, _level_groups, _pad_b,
                         _pick_level_span, _stage_grid, k_slab_max)

    # slab ceiling (solver.k_slab_max) for THIS stage's output width:
    # d2 + idx(2) [+ mass unless uniform] [+ meta when species] — see
    # _fused_stage's channel tuple
    k_slab = k_slab_max(3 + (0 if getattr(grid, "uniform_mass", None)
                             is not None else 1) + (1 if species else 0))

    G = centers.shape[0]
    vcm = np.zeros((G, 3), np.float32)
    out_members: list[np.ndarray | None] = [None] * G
    derived = DerivedResult(
        vcirc=np.zeros((G, NVCIRC), np.float32),
        rmass=np.zeros((G, 2), np.float32),
        rmax=np.zeros(G, np.float32),
        vmax=np.zeros(G, np.float32),
        profiles={sp: np.zeros((G, NMASSPROFILE), np.float32)
                  for sp in species})
    if G == 0:
        return out_members, vcm, derived
    if getattr(grid, "soa8t", None) is not None:
        s_max = min(s_max, 7)
    centers = np.asarray(centers, np.float32)
    rvir = np.asarray(rvir, np.float32)
    j = np.asarray(j, np.int64)
    mvir = np.asarray(mvir, np.float32)
    grav32 = jnp.float32(grav)

    import os
    import sys
    from time import perf_counter as _pc
    dbg = os.environ.get("SO_JAX_DEBUG")

    if getattr(grid, "soa8t", None) is not None and stage_fn is None:
        # EXACT per-halo slot footprints from one enumeration-only
        # dispatch (solver._foot_stage: cell_ranges totals at the batch
        # legacy level — no particle data touched). The previous model
        # (12*j interior margin + an S^3 * 2*chunk alignment-slack
        # BOUND) was dominated by the slack constant (8192 at S>=3), so
        # every halo of the 2M bench landed in the K=16384 sort tier;
        # measured footprints put most in K<=8192, and the sort is
        # superlinear in K. The probe level
        # matches the legacy _level_groups choice; halos the bucketing
        # moves to a finer level can overflow and pay one cached-retry
        # dispatch, exactly like an underestimate did before.
        from .solver import _foot_stage
        g0, S0 = _pick_level_span(grid, 2.0 * float(np.max(rvir)), s_max)
        Bp = _pad_b(G, 4096)
        c_pad = np.zeros((Bp, 3), np.float32)
        r_pad = np.full(Bp, 1e-30, np.float32)
        c_pad[:G] = centers
        r_pad[:G] = 2.0 * rvir
        t0 = _pc() if dbg else 0.0
        foot = np.asarray(_foot_stage(grid, g0, S0, jnp.asarray(c_pad),
                                      jnp.asarray(r_pad)))[:G]
        if dbg:
            print(f"so_jax[fused]: foot-probe level={g0} S={S0} n={G} "
                  f"dt={(_pc() - t0) * 1e3:.1f}ms", file=sys.stderr,
                  flush=True)
        est = np.maximum(foot.astype(np.int64), 256)
        merge_tiers = True
    else:
        merge_tiers = False
        # capacity from the interior count alone: ~8x volume Rvir ->
        # 2*Rvir plus margin (+ alignment slack on sharded slab paths,
        # whose per-shard footprints the single-device probe can't see).
        # The solve's kcap hint is deliberately NOT a floor here (the
        # 2*Rvir ball needs a different capacity than the solve ball,
        # and flooring at the tier-2 K2 pushed ~200 mid-size halos per
        # 16k batch into 4x-too-big XLA-fallback tiers); a rare
        # underestimate costs one cached-retry dispatch via the
        # overflow loop. Power-of-2 tiers: the pow-4 ladder skipped
        # K=32768, the largest slab-path tier.
        if getattr(grid, "soa8t", None) is not None:
            _, S_est = _pick_level_span(grid, 2.0 * float(np.max(rvir)),
                                        s_max)
            pad0 = int(min(8192, 2 * getattr(grid, "chunk", 256)
                           * S_est ** 3))
        else:
            pad0 = 256
        est = j * 12 + pad0
    need_cap = 2 ** np.ceil(np.log2(np.maximum(est, 256))).astype(np.int64)
    if merge_tiers:
        # the pass is dispatch-count bound, not slot bound: each dispatch
        # pays a packed fetch and a host scatter regardless of K, while
        # extra slots are cheap. Promote a tier into the next one up while
        # the extra B*dK slots stay under MERGE_SLOTS (inherited from an
        # earlier build; not yet measured on the H100), capped at the
        # slab ceiling so no halo is pushed onto the ragged fallback.
        MERGE_SLOTS = 32 * 1024 * 1024
        caps = np.unique(need_cap)
        for c, nxt in zip(caps[:-1], caps[1:]):
            if nxt > k_slab:
                break
            b = need_cap == c
            if int(b.sum()) * int(nxt - c) < MERGE_SLOTS:
                need_cap[b] = nxt
    todo = np.arange(G)
    guard = 0
    # per-particle m*v — dense or the lazy (vel, mass) pair (None when
    # vcm_fn supplies segment-partial sums)
    mvh = host_mv if host_mv is None or isinstance(host_mv, tuple) \
        else np.asarray(host_mv, np.float32)
    while todo.size:
        guard += 1
        if guard > 64:
            raise RuntimeError("fused member/derived escalation runaway")
        next_todo = []
        # dispatch every capacity tier before syncing any of them: the
        # device serializes the programs, and each fetch overlaps the
        # next tier's execution
        pending = []
        for capacity in np.unique(need_cap[todo]):
            sel0 = todo[need_cap[todo] == capacity]
            K = int(min(capacity, max(512, _k_limit(grid, s_max))))
            # at most 8192 halos per dispatch, so chunk t+1 executes on
            # the device while chunk t's packed rows come back
            chunk = min(_chunk_for(K, slot_budget, k_slab), 8192)
            for level, S, bidx in _level_groups(grid, 2.0 * rvir[sel0],
                                                s_max, K):
              sel = sel0[bidx]
              for lo in range(0, sel.size, chunk):
                part = sel[lo:lo + chunk]
                B = _pad_b(part.size, K, k_slab)
                c_pad = np.zeros((B, 3), np.float32)
                r_pad = np.full(B, 1e-30, np.float32)
                j_pad = np.zeros(B, np.int32)
                m_pad = np.ones(B, np.float32)
                c_pad[:part.size] = centers[part]
                r_pad[:part.size] = rvir[part]
                j_pad[:part.size] = j[part]
                m_pad[:part.size] = mvir[part]
                cap = 1 << int(np.ceil(np.log2(
                    max(int(j[part].sum()) + 8 * part.size, 1024))))
                cap = int(min(cap, B * K))
                t0 = _pc() if dbg else 0.0
                if stage_fn is not None:
                    out_dev = stage_fn(level, K, S, cap, n_members, species,
                                       jnp.asarray(c_pad),
                                       jnp.asarray(r_pad),
                                       jnp.asarray(j_pad),
                                       jnp.asarray(m_pad), grav32)
                else:
                    out_dev = _fused_stage(
                        _stage_grid(grid, K, k_slab),
                        level, K, S, cap, n_members, species,
                        jnp.asarray(c_pad), jnp.asarray(r_pad),
                        jnp.asarray(j_pad), jnp.asarray(m_pad), grav32)
                pending.append((part, B, K, S, level, cap, t0, out_dev))

        # start the device->host transfers for every pending stage now:
        # the runtime queues each copy behind its producing program, so
        # later stages' results stream back while the host scatters
        # earlier ones (copy_to_host_async is best-effort — the sync
        # np.asarray below is the correctness path)
        for *_m, out_dev in pending:
            for leaf in (out_dev if isinstance(out_dev, tuple)
                         else (out_dev,)):
                try:
                    leaf.copy_to_host_async()
                except (AttributeError, NotImplementedError):
                    break

        # SO_JAX_DEBUG=2: split each stage's wall time into device-complete,
        # bulk fetch, and host scatter
        dbg2 = bool(dbg) and dbg.isdigit() and int(dbg) >= 2
        D = 13 + 16 * len(species)
        for part, B, K, S, level, cap, t0, out_dev in pending:
            flat = not isinstance(out_dev, tuple)
            if dbg2:
                t1 = _pc()
                jax.block_until_ready(out_dev)
                t_dev = _pc() - t1
                t1 = _pc()
            if flat:
                # single-transfer [counts | packed | dblock bits] buffer
                buf = np.asarray(out_dev)
                counts = buf[:B]
                packed = buf[B:B + cap]
                dblock = buf[B + cap:].view(np.float32).reshape(B, D)
            else:
                packed, counts, dblock = out_dev
                counts = np.asarray(counts)
            if int(counts.sum()) > cap:
                need_cap[part] = np.minimum(need_cap[part] * 4,
                                            2 * _k_limit(grid, s_max))
                next_todo.extend(part)
                continue
            packed = np.asarray(packed)
            dblock = np.asarray(dblock)[:part.size]
            if dbg2:
                t_fetch = _pc() - t1
                t_scat0 = _pc()
            if dbg:
                print(f"so_jax[fused]: stage K={K} S={S} "
                      f"level={level} n={part.size} cap={cap} "
                      f"dt={(_pc() - t0) * 1e3:.1f}ms"
                      + (f" dev={t_dev * 1e3:.1f}ms fetch={t_fetch * 1e3:.1f}ms"
                         if dbg2 else ""),
                      file=sys.stderr, flush=True)
            # vectorized scatter to catalog order (a per-halo Python
            # loop here cost ~1 s of host time at B=4096)
            counts_p = counts[:part.size]
            ovf = dblock[:, 0] > 0
            okm = ~ovf
            idx = part[okm]
            derived.vcirc[idx] = dblock[okm, 1:9]
            derived.rmass[idx] = dblock[okm, 9:11]
            derived.rmax[idx] = dblock[okm, 11]
            derived.vmax[idx] = dblock[okm, 12]
            for si, sp in enumerate(species):
                derived.profiles[sp][idx] = \
                    dblock[okm, 13 + 16 * si:29 + 16 * si]

            seg = np.cumsum(counts_p)
            rows64 = packed[:seg[-1]].astype(np.int64)
            pieces = np.split(rows64, seg[:-1])   # views, no copies
            for i, h in enumerate(part):
                if ovf[i]:
                    need_cap[h] = min(need_cap[h] * 4,
                                      2 * _k_limit(grid, s_max))
                    next_todo.append(h)
                else:
                    out_members[h] = pieces[i] if member_filter is None \
                        else member_filter(pieces[i])

            # group mean velocity from the member rows (_VcmParticles) —
            # shared batch-invariant accumulation (members.vcm_from_members)
            if vcm_fn is not None:
                vcm[idx] = vcm_fn(rows64, counts_p, mvir[part])[okm]
            else:
                from .members import vcm_from_members
                vcm[idx] = vcm_from_members(mvh, rows64, counts_p,
                                            mvir[part])[okm]
            if dbg2:
                print(f"so_jax[fused]: scatter+vcm n={part.size} "
                      f"dt={(_pc() - t_scat0) * 1e3:.1f}ms",
                      file=sys.stderr, flush=True)
        todo = np.asarray(next_todo, np.int64)
    return out_members, vcm, derived
