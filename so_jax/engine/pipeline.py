"""End-to-end SO pipeline — the batched equivalent of main() (so.c:192-575).

Stage order preserves the reference's observable semantics:
  1. build the spatial index over all particles           (kdBuildTree)
  2. optional -pot recentring, batched over all halos     (kd2.c:749-761)
  3. batched R_Delta solve for all halos                  (kdRvir)
  4. interior-member extraction                           (gather at d2cut)
  5. mass-ordered conflict pass on host                   (kdSO + kdTagParticles)
  6. batched derived quantities for eligible halos        (kdVcirc)
  7. stats                                                (kdOutStats)

Steps 2-4 and 6 are order-free in the reference (they read only particle
data), which is what makes the batched formulation exact; only step 5 is
sequential, and it runs vectorized per halo on the host.
"""

from __future__ import annotations

import os
import time as _time
from dataclasses import dataclass

import numpy as np

from ..io.catalogs import GroupCatalog
from ..io.tipsy import ParticleSet
from ..numerics import indexx
from ..ops.grid import CellGrid, build_grid
from ..stats import RunStats, compute_stats
from .conflicts import ConflictState, resolve_conflicts
from .derived import DerivedResult, compute_derived
from .recenter import recenter_most_bound
from .solver import SolveResult, solve_rvir


@dataclass
class SOParams:
    """Engine parameters (CLI defaults mirror so.c:213-263)."""
    threshold: float = 178.0           # density in box units (already * Omega)
    n_members: int = 8
    period: tuple = (1.0, 1.0, 1.0)
    center: tuple = (0.0, 0.0, 0.0)
    b_pot: bool = False
    species: tuple = ()                # subset of (DARK, GAS, STAR, MARK)
    grav: float = 1.0
    grid_m: int | None = None
    verbose: bool = False
    profile_dir: str | None = None     # jax.profiler trace output
    checkpoint: str | None = None      # solve-state save/resume (.npz)
    survey: bool | None = None         # sort-free -1/-2 pre-pass: True
    #                                    forces (--survey), False disables,
    #                                    None auto-gates by sampling


@dataclass
class SORun:
    """Everything the writers and stats need."""
    catalog: GroupCatalog              # with final (possibly recentred) centers
    solve: SolveResult                 # pre-conflict Mvir/Rvir/j/vcm
    conflicts: ConflictState           # final igrp / counters / mutated Mvir,Rvir
    derived: DerivedResult
    stats: RunStats
    order: np.ndarray                  # processing order (ascending GTP mass)
    solve_seconds: float = 0.0
    members: list | None = None        # per-halo sorted interior lists

    # catalog-facing columns (post-conflict)
    @property
    def mvir(self):
        return self.conflicts.mvir

    @property
    def rvir(self):
        return self.conflicts.rvir


def run_so(particles: ParticleSet, catalog: GroupCatalog, params: SOParams,
           grid: CellGrid | None = None) -> SORun:
    from ..profiling import PhaseTimer, profile_trace

    timer = PhaseTimer()
    with profile_trace(params.profile_dir):
        if grid is None:
            with timer.phase("grid build"):
                grid = build_grid(
                    particles.pos, particles.mass, vel=particles.vel,
                    phi=particles.phi, ptype=particles.ptype_all(),
                    mark=(particles.mark if particles.mark is not None else None),
                    period=params.period, center=params.center, m=params.grid_m)
                # drain the async build before the phase ends so the solve
                # phase is not charged for it in the timing report
                import jax
                jax.block_until_ready(grid.soa8t if grid.soa8t is not None
                                      else grid.pos)

        centers = np.asarray(catalog.pos, np.float32).copy()
        rgtp = np.asarray(catalog.rgtp, np.float32)

        if params.b_pot:
            with timer.phase("recenter (-pot)"):
                centers = recenter_most_bound(grid, centers, rgtp)
                catalog.pos = centers

        t0 = _time.perf_counter()
        ck_members = None
        ck = params.checkpoint
        digest = None
        if ck is not None:
            from ..checkpoint import input_digest

            # guards resume against a different snapshot/catalog/params
            digest = input_digest(particles, centers, rgtp, params.threshold,
                                  params.n_members, params.period,
                                  params.center)
        if ck is not None and os.path.exists(ck):
            from ..checkpoint import load_solve

            with timer.phase("checkpoint resume"):
                solve, ck_members, ck_centers = load_solve(ck, digest)
                centers = np.asarray(ck_centers, np.float32)
                catalog.pos = centers
        else:
            with timer.phase("R_Delta solve"):
                solve = solve_rvir(grid, centers, rgtp, params.threshold,
                                   n_members=params.n_members,
                                   survey=params.survey)

        run = _post_solve(grid, particles, catalog, centers, solve, params,
                          timer, members=ck_members)
        run.solve_seconds = _time.perf_counter() - t0

        if ck is not None and ck_members is None:
            from ..checkpoint import save_solve

            with timer.phase("checkpoint save"):
                save_solve(ck, run.solve, run.members, centers,
                           digest=digest)

    if params.verbose:
        timer.report(items={"R_Delta solve": catalog.n,
                            "member extraction": catalog.n})
    return run


def run_so_multi(particles: ParticleSet, catalog: GroupCatalog,
                 params: SOParams, thresholds) -> list[SORun]:
    """Multi-threshold pipeline: one grid + one shared-gather solve pass
    (engine.multi), then the full per-threshold post-processing — each
    returned SORun equals an independent run_so at that threshold."""
    from ..profiling import PhaseTimer, profile_trace
    from .multi import solve_rvir_multi
    from .solver import SolveResult

    timer = PhaseTimer()
    runs: list[SORun] = []
    with profile_trace(params.profile_dir):
        with timer.phase("grid build"):
            grid = build_grid(
                particles.pos, particles.mass, vel=particles.vel,
                phi=particles.phi, ptype=particles.ptype_all(),
                mark=(particles.mark if particles.mark is not None else None),
                period=params.period, center=params.center, m=params.grid_m)
        centers = np.asarray(catalog.pos, np.float32).copy()
        rgtp = np.asarray(catalog.rgtp, np.float32)
        if params.b_pot:
            with timer.phase("recenter (-pot)"):
                centers = recenter_most_bound(grid, centers, rgtp)
                catalog.pos = centers

        t0 = _time.perf_counter()
        with timer.phase("R_Delta solve (multi)"):
            multi = solve_rvir_multi(grid, centers, rgtp, thresholds,
                                     n_members=params.n_members,
                                     survey=params.survey)
        for t in range(len(thresholds)):
            solve_t = SolveResult(
                code=multi.code[t].copy(), mvir=multi.mvir[t].copy(),
                rvir=multi.rvir[t].copy(), j=multi.j[t].copy(),
                d2cut=multi.d2cut[t].copy(),
                vcm=np.zeros((catalog.n, 3), np.float32))
            run = _post_solve(grid, particles, catalog, centers, solve_t,
                              params, timer)
            run.solve_seconds = _time.perf_counter() - t0
            runs.append(run)
    if params.verbose:
        timer.report()
    return runs


def _scatter_derived(src, ok_rows, eligible, n, species):
    """Fused-stage rows (over the solved subset) -> catalog-order
    DerivedResult with ineligible rows zeroed."""
    from .derived import NMASSPROFILE, NVCIRC

    out = DerivedResult(
        vcirc=np.zeros((n, NVCIRC), np.float32),
        rmass=np.zeros((n, 2), np.float32),
        rmax=np.zeros(n, np.float32),
        vmax=np.zeros(n, np.float32),
        profiles={sp: np.zeros((n, NMASSPROFILE), np.float32)
                  for sp in species})
    keep = eligible[ok_rows]
    dst = ok_rows[keep]
    out.vcirc[dst] = src.vcirc[keep]
    out.rmass[dst] = src.rmass[keep]
    out.rmax[dst] = src.rmax[keep]
    out.vmax[dst] = src.vmax[keep]
    for sp in species:
        out.profiles[sp][dst] = src.profiles[sp][keep]
    return out


def _post_solve(grid, particles, catalog, centers, solve, params,
                timer, members=None, fused_fn=None, derived_fn=None,
                vcm_fn=None, n_particles=None, stats_fn=None,
                conflict_fn=None, member_filter=None) -> SORun:
    """``fused_fn``/``derived_fn`` inject multi-device shard_map stages
    (parallel.mesh.sharded_fused_members_fn / sharded_derived_fn) into the
    otherwise identical post-solve sequence; ``grid`` may then be a
    grid_proxy. ``vcm_fn``/``n_particles`` support multi-controller hosts
    that hold only a particle segment (parallel.driver): vcm comes from
    merged per-segment partials and the conflict pass sizes its arrays
    from the GLOBAL particle count. ``conflict_fn`` replaces the serial
    conflict pass (parallel.driver.dist_conflict_fn: the component-sharded
    walk returning a per-segment SegmentConflictState)."""
    ok = solve.code == 0
    derived_all = None
    if members is None:
        # fused pass: member lists AND derived quantities from ONE gather
        # at 2*Rvir (the interior is a sorted prefix of the kdVcirc ball;
        # kd2.c:511-514 vs 823) — halves the post-solve gather/sort work
        # and the device round-trips
        from .fused import members_and_derived

        with timer.phase("members + derived (fused)"):
            members_ok, vcm_ok, derived_all = members_and_derived(
                grid, centers[ok], solve.rvir[ok], solve.d2cut[ok],
                solve.j[ok], solve.mvir[ok],
                host_mv=(None if vcm_fn is not None
                         else (particles.vel, particles.mass)),
                n_members=params.n_members, species=tuple(params.species),
                grav=params.grav, stage_fn=fused_fn, vcm_fn=vcm_fn,
                member_filter=member_filter)
            members = [None] * catalog.n
            for slot, h in enumerate(np.nonzero(ok)[0]):
                members[h] = members_ok[slot]
            solve.vcm[ok] = vcm_ok  # _VcmParticles (kd2.c:595-609)

    with timer.phase("conflict protocol"):
        # ascending input-mass order (kdSortMass, kd2.c:843-861)
        order = indexx(np.asarray(catalog.gtp_mass, np.float32))
        resolve = resolve_conflicts if conflict_fn is None else conflict_fn
        conflicts = resolve(catalog.index, centers, solve.mvir,
                            solve.rvir, solve.code, order, members,
                            n_particles if n_particles is not None
                            else particles.n)

    eligible = ok & ~conflicts.slurped_own  # kdSO eligibility (kd2.c:884)
    with timer.phase("derived quantities"):
        if derived_all is not None:
            # scatter the fused per-ok-halo rows to catalog order, zeroing
            # ineligible (slurped-own) rows — kdVcirc skip, kd2.c:884
            derived = _scatter_derived(derived_all, np.nonzero(ok)[0],
                                       eligible, catalog.n,
                                       tuple(params.species))
        else:
            # checkpoint-resume path: members came from the snapshot, only
            # the derived pass runs on device
            derived = compute_derived(grid, centers, solve.rvir, solve.mvir,
                                      solve.j, eligible,
                                      n_members=params.n_members,
                                      species=tuple(params.species),
                                      grav=params.grav,
                                      stage_fn=derived_fn)

    with timer.phase("stats"):
        if stats_fn is not None:
            stats = stats_fn(conflicts)
        else:
            stats = compute_stats(np.asarray(particles.mass),
                                  conflicts.igrp,
                                  conflicts.n_subsumed, conflicts.n_ignored,
                                  conflicts.mvir, conflicts.groups_removed,
                                  conflicts.groups_slurped)

    run = SORun(catalog=catalog, solve=solve, conflicts=conflicts,
                derived=derived, stats=stats, order=order)
    run.members = members
    return run
