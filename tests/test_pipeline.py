"""Python-API pipeline tests (run_so) + conflict-protocol unit tests."""

import os
import sys

import numpy as np
import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

from fixtures import make_clumpy_box  # noqa: E402

from so_jax.engine import SOParams, run_so  # noqa: E402
from so_jax.engine.conflicts import resolve_conflicts  # noqa: E402
from so_jax.io.tipsy import DARK, ParticleSet, TipsyHeader  # noqa: E402


def _particle_set(data):
    n = data["pos"].shape[0]
    hdr = TipsyHeader(time=1.0, nbodies=n, ndim=3, nsph=0, ndark=n, nstar=0)
    return ParticleSet(hdr, data["pos"], data["vel"], data["mass"],
                       data["phi"], np.zeros(n, np.float32))


def _catalog(centers, rgtp, masses):
    from so_jax.io.catalogs import GroupCatalog
    centers = np.asarray(centers, np.float32)
    return GroupCatalog(index=np.arange(1, len(rgtp) + 1, dtype=np.int32),
                        pos=centers.copy(),
                        rgtp=np.asarray(rgtp, np.float32),
                        gtp_mass=np.asarray(masses, np.float32),
                        n_in_gtp=len(rgtp), gtp_time=1.0)


def test_run_so_end_to_end():
    rng = np.random.default_rng(23)
    clumps = [dict(center=(0.1, 0.1, 0.1), n=2500, rmax=0.06, mass_total=0.2)]
    data = make_clumpy_box(rng, n_background=6000, clumps=clumps)
    ps = _particle_set(data)
    cat = _catalog([(0.1, 0.1, 0.1)], [0.04], [0.2])
    run = run_so(ps, cat, SOParams(threshold=178.0, species=(DARK,)))
    assert run.solve.code[0] == 0
    assert run.mvir[0] > 0 and run.rvir[0] > 0
    # mass conservation of the stats bookkeeping
    assert run.stats.halo_mass_sum == pytest.approx(float(run.mvir[0]), rel=1e-6)
    assert (run.conflicts.igrp == 1).sum() == run.solve.j[0]
    # dark profile last bin holds everything within 2 Rvir
    prof = run.derived.profiles[DARK][0]
    assert (np.diff(prof) >= 0).all()
    assert prof[-1] >= float(run.mvir[0]) * 0.9


def test_vcm_identical_across_member_paths():
    """The fused members+derived pass and the plain extract_members host
    path share one vcm accumulation order (members.vcm_from_members) and
    must produce identical bits (PARITY #8)."""
    from so_jax.engine.fused import members_and_derived
    from so_jax.engine.members import extract_members
    from so_jax.engine.solver import solve_rvir
    from so_jax.ops import build_grid

    rng = np.random.default_rng(31)
    clumps = [dict(center=(0.1, 0.1, 0.1), n=1800, rmax=0.06, mass_total=0.2),
              dict(center=(-0.3, 0.25, -0.2), n=900, rmax=0.04,
                   mass_total=0.07)]
    data = make_clumpy_box(rng, n_background=4000, clumps=clumps)
    grid = build_grid(data["pos"], data["mass"], vel=data["vel"],
                      phi=data["phi"])
    centers = np.array([(0.1, 0.1, 0.1), (-0.3, 0.25, -0.2)], np.float32)
    rgtp = np.array([0.04, 0.03], np.float32)
    solve = solve_rvir(grid, centers, rgtp, 178.0)
    ok = solve.code == 0
    assert ok.all()
    host_mv = data["vel"] * data["mass"][:, None]
    m_f, vcm_f, _ = members_and_derived(
        grid, centers, solve.rvir, solve.d2cut, solve.j, solve.mvir,
        host_mv=host_mv)
    m_p, vcm_p = extract_members(grid, centers, solve.d2cut, solve.j,
                                 solve.mvir, host_mv=host_mv)
    for a, b in zip(m_f, m_p):
        np.testing.assert_array_equal(np.sort(a), np.sort(b))
    np.testing.assert_array_equal(vcm_f, vcm_p)
    # the lazy (vel, mass) form (what run_so passes) is bit-identical to
    # the dense pre-materialized m*v — the f32 multiply commutes with the
    # member-row gather
    _, vcm_lazy, _ = members_and_derived(
        grid, centers, solve.rvir, solve.d2cut, solve.j, solve.mvir,
        host_mv=(data["vel"], data["mass"]))
    np.testing.assert_array_equal(vcm_lazy, vcm_f)
    _, vcm_lazy_p = extract_members(grid, centers, solve.d2cut, solve.j,
                                    solve.mvir,
                                    host_mv=(data["vel"], data["mass"]))
    np.testing.assert_array_equal(vcm_lazy_p, vcm_p)


def _conflict_inputs(igrp_members, positions, rvirs, codes, masses):
    index = np.arange(1, len(positions) + 1, dtype=np.int32)
    return index, np.asarray(positions, np.float32), \
        np.asarray(masses, np.float32), np.asarray(rvirs, np.float32), \
        np.asarray(codes, np.int32)


def test_conflicts_subsume():
    # B (small) processed first owns particles 0..4; A at same center with
    # bigger Rvir subsumes B
    index, pos, mvir, rvir, code = _conflict_inputs(
        None, [(0, 0, 0), (0.01, 0, 0)], [0.1, 0.02], [0, 0], [0.5, 0.1])
    members = [np.arange(10), np.arange(5)]
    order = np.array([1, 0])  # B (row 1) first
    st = resolve_conflicts(index, pos, mvir, rvir, code, order, members, 20)
    assert st.groups_removed == 1 and st.groups_slurped == 0
    assert st.rvir[1] == np.float32(-10.0)           # -10 * A.index(=1)
    assert st.mvir[1] == np.float32(-0.1)            # B's Mvir negated
    assert (st.igrp[:10] == 1).all()
    assert (st.n_subsumed[:5] == 1).all()
    assert (st.n_subsumed[5:] == 0).all()


def test_conflicts_slurp():
    # B (row 1, small gtp mass) processed first with a HUGE Rvir; A (row 0)
    # is centered outside its own small Rvir reach of B but inside B's ->
    # A gets slurped at its first B-owned particle
    index, pos, mvir, rvir, code = _conflict_inputs(
        None, [(0.3, 0, 0), (0.0, 0, 0)], [0.05, 0.4], [0.05, 0.5], [0, 0],)
    mvir = np.asarray([0.05, 0.4], np.float32)
    rvir = np.asarray([0.05, 0.5], np.float32)
    members = [np.arange(8), np.arange(30)]        # overlapping interiors
    order = np.array([1, 0])
    st = resolve_conflicts(index, pos, mvir, rvir, code, order, members, 40)
    assert st.groups_slurped == 1 and st.groups_removed == 0
    assert st.slurped_own[0]
    assert st.rvir[0] == np.float32(-20.0)          # -10 * B.index(=2)
    assert st.mvir[0] == np.float32(-0.05)
    # A's walk broke at its first particle; B keeps everything
    assert (st.igrp[:30] == 2).all()


def test_conflicts_retain():
    # disjoint centers, neither inside the other -> ignore/retain
    index, pos, mvir, rvir, code = _conflict_inputs(
        None, [(0.3, 0, 0), (0.0, 0, 0)], [0.2, 0.1], [0.01, 0.01], [0, 0])
    mvir = np.asarray([0.2, 0.1], np.float32)
    rvir = np.asarray([0.01, 0.01], np.float32)
    members = [np.array([0, 1, 2, 5]), np.array([5, 6, 7])]
    order = np.array([1, 0])
    st = resolve_conflicts(index, pos, mvir, rvir, code, order, members, 10)
    assert st.groups_removed == 0 and st.groups_slurped == 0
    assert st.igrp[5] == 2            # B keeps particle 5
    assert st.n_ignored[5] == 1       # A counted it but didn't claim it
    assert (st.igrp[[0, 1, 2]] == 1).all()


def test_conflicts_error_groups_never_tag():
    index, pos, mvir, rvir, code = _conflict_inputs(
        None, [(0, 0, 0)], [-1.0], [-1.0], [-1])
    st = resolve_conflicts(index, pos, np.asarray([-1.0], np.float32),
                           np.asarray([-1.0], np.float32),
                           np.asarray([-1], np.int32), np.array([0]),
                           [None], 5)
    assert (st.igrp == 0).all()


def test_catalog_order_invariance():
    """Permuting the input catalog must not change any per-halo result —
    processing is by ascending GTP mass (kdSortMass, kd2.c:843-861), so
    file order only controls output row order. Property test from
    SURVEY.md section 4 item 3."""
    rng = np.random.default_rng(31)
    clumps = [
        dict(center=(0.1, 0.0, 0.0), n=1500, rmax=0.06, mass_total=0.2),
        dict(center=(0.14, 0.02, 0.0), n=700, rmax=0.04, mass_total=0.06),
        dict(center=(-0.3, 0.25, 0.1), n=900, rmax=0.05, mass_total=0.1),
    ]
    data = make_clumpy_box(rng, n_background=4000, clumps=clumps)
    ps = _particle_set(data)
    centers = np.array([c["center"] for c in clumps]
                       + [[0.4, -0.4, 0.3]], np.float32)
    rgtp = np.array([0.05, 0.035, 0.045, 0.03], np.float32)
    masses = np.array([0.2, 0.06, 0.1, 0.01], np.float32)  # distinct

    base = run_so(ps, _catalog(centers, rgtp, masses),
                  SOParams(threshold=178.0, species=(DARK,)))
    perm = np.array([2, 0, 3, 1])
    shuf = run_so(ps, _catalog(centers[perm], rgtp[perm], masses[perm]),
                  SOParams(threshold=178.0, species=(DARK,)))

    # halo renumbering: original 1-based index -> shuffled 1-based index
    remap = np.zeros(len(perm) + 1, np.int64)
    remap[perm + 1] = np.arange(1, len(perm) + 1)

    np.testing.assert_array_equal(shuf.solve.code, base.solve.code[perm])
    np.testing.assert_array_equal(shuf.mvir, base.mvir[perm])
    # the -10*index subsume/slurp marker encodes the SUBSUMER's catalog
    # index (kdZeroGroup, kd2.c:633-634) — remap it before comparing
    rv = base.rvir[perm].copy()
    marked = rv <= -10.0
    rv[marked] = -10.0 * remap[(-rv[marked] / 10.0).astype(np.int64)]
    np.testing.assert_array_equal(shuf.rvir, rv)
    np.testing.assert_array_equal(shuf.derived.vcirc, base.derived.vcirc[perm])
    # per-particle ownership maps through the halo renumbering
    np.testing.assert_array_equal(shuf.conflicts.igrp,
                                  remap[base.conflicts.igrp])
