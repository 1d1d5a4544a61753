"""Derived halo quantities — batched kdVcirc + kdMassProfile.

Reference: kdVcirc (kd2.c:498-586) re-gathers each group at 2*Rvir, sorts by
distance, and derives:
  - 8 circular-velocity bins at (0.25..2.0)*Rvir: Vc = sqrt(G M(<r)/r) with
    cumulative mass strictly inside each bin radius; the last bin uses the
    full gathered mass at exactly 2*Rvir (kd2.c:508-532)
  - quarter/half-mass radii: distance of the first sorted particle where
    cumulative mass reaches {0.25, 0.5}*Mvir (kd2.c:537-546)
  - Vmax/Rmax: max of sqrt(G M(<r)/r) scanning from the nMembers-th particle
    (kd2.c:549-569), keeping the earliest maximum
  - 16 cumulative per-species mass-profile bins at (2/16..2.0)*Rvir
    (kdMassProfile, kd2.c:458-496), species by iOrder range or mark mask

These read only particle positions/masses/types — never group tags — so the
whole catalog batches into fixed-shape device passes after the conflict
pass decides eligibility (kdSO runs kdVcirc only when rvir > 0 and the
group wasn't slurped during its own tagging, kd2.c:884).
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..io.tipsy import MARK
from ..ops.gather import ragged_ball_gather, slab_gather
from ..ops.grid import CellGrid
from ..ops.seqsum import seq_cumsum

NVCIRC = 8          # kd2.h:10
NMASSPROFILE = 16   # kd2.h:12


@dataclass
class DerivedResult:
    vcirc: np.ndarray     # (G, NVCIRC) f32
    rmass: np.ndarray     # (G, 2) f32 — quarter/half mass radii
    rmax: np.ndarray      # (G,) f32
    vmax: np.ndarray      # (G,) f32
    profiles: dict        # species -> (G, NMASSPROFILE) f32 for requested species


def derived_from_sorted(d2_s, mass_s, ptype_s, mark_s, n_in, rvir, mvir,
                        fball, n_members: int, species: tuple, grav,
                        uniform_m: float | None = None):
    """All kdVcirc/kdMassProfile quantities from distance-sorted hits —
    shared by the single-device stage and the shard_map merge path.

    ``uniform_m``: when every particle mass is the same f32 value,
    ``mass_s`` may be None — cumulative masses are the shared serial-f32
    ladder (solver._mass_ladder), so callers drop the mass gather channel
    and the distance sort loses one operand. Species profiles then sample
    the ladder at exact integer selection counts (adding 0.0 never changes
    a serial f32 accumulator, so sum(m over selected prefix) ==
    ladder[count-1] bit-for-bit)."""
    B, K = d2_s.shape
    slot = jnp.arange(K, dtype=jnp.int32)[None, :]
    valid = slot < n_in[:, None]
    rows = jnp.arange(B)
    lad = None
    if uniform_m is not None:
        from .solver import _uniform_cum
        cum, lad = _uniform_cum(uniform_m, K, n_in, valid)
        if lad is None:          # giant tier: constant mass row, seq-scanned
            mass_s = jnp.where(valid, jnp.float32(uniform_m), 0.0)
    else:
        # C-order float32 accumulation (kd2.c:521, 543) — see ops/seqsum.py
        cum = seq_cumsum(mass_s, axis=1)
    use_ladder = lad is not None

    def cum_at(counts, c):
        return jnp.where(counts > 0, c[rows, jnp.maximum(counts - 1, 0)], 0.0)

    total_mass = cum_at(n_in, cum)

    # Vc bins (kd2.c:508-532): strict d2 < r^2 cumulative mass
    vcs = []
    for i in range(NVCIRC - 1):
        f = jnp.float32((i + 1) * (2.0 / NVCIRC))
        r = f * rvir
        cnt = (valid & (d2_s < (r * r)[:, None])).sum(axis=1)
        m = cum_at(cnt, cum)
        vcs.append(jnp.sqrt(grav * m / r))
    vcs.append(jnp.sqrt(grav * total_mass / fball))
    vcirc = jnp.stack(vcs, axis=1)

    # quarter/half mass radii (kd2.c:537-546); the reference has no bounds
    # guard — we clamp to the last gathered particle
    rmass = []
    for f in (0.25, 0.5):
        m = jnp.float32(f) * mvir
        ge = cum >= m[:, None]
        has = ge.any(axis=1)
        jq = jnp.where(has, jnp.argmax(ge, axis=1), jnp.maximum(n_in - 1, 0))
        rmass.append(jnp.sqrt(d2_s[rows, jq]))
    rmass = jnp.stack(rmass, axis=1)

    # Vmax/Rmax (kd2.c:549-569): scan from the nMembers-th particle,
    # earliest maximum wins (strict > update)
    r_s = jnp.sqrt(d2_s)
    vc_all = jnp.sqrt(grav * cum / r_s)
    vc_all = jnp.where((slot >= n_members - 1) & valid, vc_all, -jnp.inf)
    jm = jnp.argmax(vc_all, axis=1)
    vmax = vc_all[rows, jm]
    rmax = r_s[rows, jm]
    none = ~jnp.isfinite(vmax)
    vmax = jnp.where(none, 0.0, vmax)
    rmax = jnp.where(none, 0.0, rmax)

    # species mass profiles (kdMassProfile, kd2.c:458-496)
    profs = {}
    bin_cnts = []                          # shared across species
    for i in range(NMASSPROFILE - 1):
        f = jnp.float32((i + 1) * (2.0 / NMASSPROFILE))
        r = f * rvir
        bin_cnts.append((valid & (d2_s < (r * r)[:, None])).sum(axis=1))
    bin_cnts.append(n_in)                  # last bin: everything <= 2 Rvir
    for sp in species:
        sel = mark_s if sp == MARK else (ptype_s == sp)
        if use_ladder:
            # ladder at the exact int count of selected hits in the prefix
            selcnt = jnp.cumsum((sel & valid).astype(jnp.int32), axis=1)

            def sp_at(cnt, selcnt=selcnt):
                sc = jnp.where(cnt > 0,
                               selcnt[rows, jnp.maximum(cnt - 1, 0)], 0)
                return jnp.where(sc > 0, lad[jnp.maximum(sc - 1, 0)], 0.0)

            bins = [sp_at(cnt) for cnt in bin_cnts]
        else:
            cumsp = seq_cumsum(jnp.where(sel, mass_s, 0.0), axis=1)
            bins = [cum_at(cnt, cumsp) for cnt in bin_cnts]
        profs[sp] = jnp.stack(bins, axis=1)

    return dict(vcirc=vcirc, rmass=rmass, rmax=rmax, vmax=vmax,
                profiles=profs, n_in=n_in)


@partial(jax.jit, static_argnames=("level", "K", "S", "n_members", "species"))
def _derived_stage(grid: CellGrid, level: int, K: int, S: int, n_members: int,
                   species: tuple, centers, rvir, mvir, grav):
    fball = jnp.float32(2.0) * rvir
    fball2 = fball * fball
    um = grid.uniform_mass
    if grid.soa8t is not None:
        chans = (() if um is not None else ("mass",)) \
            + (("meta",) if species else ())
        sg = slab_gather(grid, level, centers, fball, fball2, K, S,
                         channels=chans)
        d2_s = sg.d2
        mass_s = None if um is not None else sg.channels[0]
        if species:
            meta = sg.channels[-1].astype(jnp.int32)
            ptype_s = meta & 0xF
            mark_s = (meta >> 4) > 0
        else:
            ptype_s = jnp.zeros_like(d2_s, jnp.int32)
            mark_s = jnp.zeros_like(d2_s, bool)
        n_in, overflow = sg.n_in, sg.overflow
    else:
        g = ragged_ball_gather(grid, level, centers, fball, fball2, K, S,
                               sort=True)
        slot0 = jnp.arange(K, dtype=jnp.int32)[None, :]
        valid = slot0 < g.n_in[:, None]
        d2_s = g.d2
        mass_s = None if um is not None \
            else jnp.where(valid, grid.mass_a()[g.idx], 0.0)
        ptype_s = grid.ptype_a()[g.idx]
        mark_s = grid.mark_a()[g.idx] & valid
        n_in, overflow = g.n_in, g.overflow
    out = derived_from_sorted(d2_s, mass_s, ptype_s, mark_s, n_in, rvir,
                              mvir, fball, n_members, species, grav,
                              uniform_m=um)
    # one fetch-friendly (B, 13 + 16*nspecies) f32 block, one transfer:
    # [overflow, vcirc(8), rmass(2), rmax, vmax, profiles(16)...]
    return jnp.concatenate(
        [overflow.astype(jnp.float32)[:, None], out["vcirc"], out["rmass"],
         out["rmax"][:, None], out["vmax"][:, None]]
        + [out["profiles"][sp] for sp in species], axis=1)


def compute_derived(grid: CellGrid, centers: np.ndarray, rvir: np.ndarray,
                    mvir: np.ndarray, j_interior: np.ndarray,
                    eligible: np.ndarray, n_members: int = 8,
                    species: tuple = (), grav: float = 1.0,
                    s_max: int = 11, slot_budget: int = 1 << 25,
                    stage_fn=None) -> DerivedResult:
    """Batched derived quantities for all eligible halos; zeros otherwise.

    ``stage_fn(level, K, S, n_members, species, centers, rvir, mvir,
    grav)`` overrides the single-device stage with the same packed-block
    contract as _derived_stage — the multi-device path
    (parallel.mesh.sharded_derived_fn) injects its shard_map stage here.
    """
    from .solver import (_chunk_for, _k_limit, _level_groups, _pad_b,
                         _pad_to_bucket, _pick_level_span, _stage_grid,
                         k_slab_max)

    # channel-aware slab ceiling for this stage's output rows:
    # d2 [+ mass unless uniform] [+ meta when species]
    k_slab = k_slab_max(1 + (0 if getattr(grid, "uniform_mass", None)
                             is not None else 1) + (1 if species else 0))

    G = centers.shape[0]
    out = DerivedResult(
        vcirc=np.zeros((G, NVCIRC), np.float32),
        rmass=np.zeros((G, 2), np.float32),
        rmax=np.zeros(G, np.float32),
        vmax=np.zeros(G, np.float32),
        profiles={sp: np.zeros((G, NMASSPROFILE), np.float32) for sp in species},
    )
    todo = np.nonzero(eligible)[0]
    if todo.size == 0:
        return out
    if getattr(grid, "soa8t", None) is not None:
        s_max = min(s_max, 7)
    centers = np.asarray(centers, np.float32)
    rvir = np.asarray(rvir, np.float32)
    mvir = np.asarray(mvir, np.float32)
    grav32 = jnp.float32(grav)

    # capacity estimate: interior count scales ~8x from Rvir to 2 Rvir;
    # slab footprints add CHUNK-aligned padding per merged run
    pad0 = 8192 if getattr(grid, "soa8t", None) is not None else 256
    # power-of-4 tiers (see members.py): fewer compile variants
    need_cap = 4 ** np.ceil(np.log2(np.maximum(
        j_interior.astype(np.int64) * 12 + pad0, 256)) / 2).astype(np.int64)
    guard = 0
    while todo.size:
        guard += 1
        if guard > 64:
            raise RuntimeError("derived-quantity escalation runaway")
        next_todo = []
        for capacity in np.unique(need_cap[todo]):
            sel0 = todo[need_cap[todo] == capacity]
            K = int(min(capacity, _k_limit(grid, s_max)))
            chunk = _chunk_for(K, slot_budget, k_slab)
            for level, S, bidx in _level_groups(
                    grid, (2.0 * rvir[sel0]).astype(np.float32), s_max, K):
              sel = sel0[bidx]
              for lo in range(0, sel.size, chunk):
                part = sel[lo:lo + chunk]
                B = _pad_b(part.size, K, k_slab)
                c_pad = np.zeros((B, 3), np.float32)
                r_pad = np.full(B, 1e-30, np.float32)
                m_pad = np.zeros(B, np.float32)
                c_pad[:part.size] = centers[part]
                r_pad[:part.size] = rvir[part]
                m_pad[:part.size] = mvir[part]
                import os, sys
                from time import perf_counter as _pc
                t0 = _pc() if os.environ.get("SO_JAX_DEBUG") else 0.0
                if stage_fn is not None:
                    o = stage_fn(level, K, S, n_members, species,
                                 jnp.asarray(c_pad), jnp.asarray(r_pad),
                                 jnp.asarray(m_pad), grav32)
                else:
                    o = _derived_stage(_stage_grid(grid, K, k_slab),
                                       level, K, S, n_members, species,
                                       jnp.asarray(c_pad), jnp.asarray(r_pad),
                                       jnp.asarray(m_pad), grav32)
                o = np.asarray(o)[:part.size]
                if os.environ.get("SO_JAX_DEBUG"):
                    print(f"so_jax[derived]: stage B={B} K={K} S={S} "
                          f"level={level} n={part.size} "
                          f"dt={(_pc() - t0) * 1e3:.1f}ms",
                          file=sys.stderr, flush=True)
                ovf = o[:, 0] > 0
                ok = ~ovf
                idx = part[ok]
                out.vcirc[idx] = o[ok, 1:9]
                out.rmass[idx] = o[ok, 9:11]
                out.rmax[idx] = o[ok, 11]
                out.vmax[idx] = o[ok, 12]
                for si, sp in enumerate(species):
                    out.profiles[sp][idx] = o[ok, 13 + 16 * si:29 + 16 * si]
                bad = part[~ok]
                need_cap[bad] = np.minimum(need_cap[bad] * 4,
                                            2 * _k_limit(grid, s_max))
                next_todo.extend(bad.tolist())
        todo = np.asarray(next_todo, np.int64)
    return out
