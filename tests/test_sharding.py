"""Multi-device tests on the 8-virtual-CPU mesh (SURVEY.md section 4 item 4):
the (halo x part)-sharded solve must reproduce single-device results."""

import os
import sys

import jax
import numpy as np
import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

from fixtures import make_clumpy_box  # noqa: E402

from so_jax.engine.solver import solve_rvir  # noqa: E402
from so_jax.ops import build_grid  # noqa: E402
from so_jax.parallel import (build_sharded_grid, make_mesh,  # noqa: E402
                             solve_rvir_sharded)


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(17)
    clumps = [
        dict(center=(0.1, 0.0, -0.1), n=1400, rmax=0.06, mass_total=0.2),
        dict(center=(-0.25, 0.3, 0.2), n=800, rmax=0.04, mass_total=0.08),
        dict(center=(0.45, 0.45, 0.45), n=700, rmax=0.05, mass_total=0.06),
    ]
    d = make_clumpy_box(rng, n_background=3500, clumps=clumps)
    base = np.array([[0.1, 0.0, -0.1], [-0.25, 0.3, 0.2], [0.45, 0.45, 0.45]],
                    np.float32)
    # extra centers near the clumps: every halo resolves within 1-2 ladder
    # tiers (a -3 halo would climb to the brute-force capacity tier, which
    # the CPU interpreter executes minutes-slow; -1/-2/-3 codes are covered
    # by test_solver/test_golden)
    extra = np.concatenate([base, base[:2]])         + rng.normal(size=(5, 3)).astype(np.float32) * 0.01
    centers = np.concatenate([base, extra])
    rgtp = rng.uniform(0.03, 0.06, centers.shape[0]).astype(np.float32)
    return d, centers, rgtp


def test_eight_devices_available():
    assert len(jax.devices()) == 8


# (2,4): 2D mesh (default); (1,8) pure particle sharding is marked slow
# (same merge path, heavier compile). (8,1)/(4,2) also pass.
@pytest.mark.parametrize("mesh_shape", [
    pytest.param((1, 8), marks=pytest.mark.slow), (2, 4)])
def test_sharded_solve_matches_single(data, mesh_shape):
    d, centers, rgtp = data
    thr = 178.0
    grid = build_grid(d["pos"], d["mass"], vel=d["vel"], m=3)
    want = solve_rvir(grid, centers, rgtp, thr)

    mesh = make_mesh(*mesh_shape)
    sgrid = build_sharded_grid(d["pos"], d["mass"], vel=d["vel"], m=3,
                               mesh=mesh)
    got = solve_rvir_sharded(mesh, sgrid, centers, rgtp, thr)

    np.testing.assert_array_equal(got.code, want.code)
    np.testing.assert_allclose(got.mvir, want.mvir, rtol=2e-6)
    np.testing.assert_allclose(got.rvir, want.rvir, rtol=2e-6)
    np.testing.assert_array_equal(got.j, want.j)
    np.testing.assert_allclose(got.d2cut, want.d2cut, rtol=2e-6)


def test_sharded_grid_partition_covers_all_particles(data):
    d, _, _ = data
    mesh = make_mesh(2, 4)
    sgrid = build_sharded_grid(d["pos"], d["mass"], m=3, mesh=mesh)
    n = d["pos"].shape[0]
    # every original particle appears exactly once across shards (sentinel
    # padding carries zero mass)
    orig = np.asarray(sgrid.orig_idx).ravel()
    mass = np.asarray(sgrid.mass).ravel()
    real = mass > 0
    assert np.unique(orig[real]).size == real.sum()
    np.testing.assert_allclose(np.asarray(sgrid.mass).sum(),
                               d["mass"].sum(), rtol=1e-5)


def test_sharded_derived_matches_single(data):
    """Sharded kdVcirc/profiles (all_gather merge) == single-device."""
    import jax.numpy as jnp

    from so_jax.engine.derived import _derived_stage
    from so_jax.io.tipsy import DARK
    from so_jax.parallel import build_sharded_grid, make_mesh
    from so_jax.parallel.mesh import derived_stage_sharded

    d, centers, rgtp = data
    thr = 178.0
    grid = build_grid(d["pos"], d["mass"], vel=d["vel"], m=3)
    solved = solve_rvir(grid, centers, rgtp, thr)
    ok = solved.code == 0
    assert ok.sum() >= 2
    B = 8  # pad to the halo-axis multiple
    c_pad = np.zeros((B, 3), np.float32)
    r_pad = np.full(B, 1e-30, np.float32)
    m_pad = np.zeros(B, np.float32)
    nsel = int(ok.sum())
    c_pad[:nsel] = centers[ok]
    r_pad[:nsel] = solved.rvir[ok]
    m_pad[:nsel] = solved.mvir[ok]

    wp = np.asarray(_derived_stage(grid, 1, 8192, 7, 8, (DARK,),
                                   jnp.asarray(c_pad), jnp.asarray(r_pad),
                                   jnp.asarray(m_pad), jnp.float32(1.0)))
    # packed block: [overflow, vcirc(8), rmass(2), rmax, vmax, profiles(16)]
    want = dict(overflow=wp[:, 0] > 0, vcirc=wp[:, 1:9], rmass=wp[:, 9:11],
                vmax=wp[:, 12], profiles={DARK: wp[:, 13:29]})
    assert not want["overflow"][:nsel].any()

    mesh = make_mesh(2, 4)
    sgrid = build_sharded_grid(d["pos"], d["mass"], vel=d["vel"], m=3,
                               mesh=mesh)
    got = derived_stage_sharded(mesh, sgrid, 1, 2048, 7, 8, (DARK,),
                                jnp.asarray(c_pad), jnp.asarray(r_pad),
                                jnp.asarray(m_pad), jnp.float32(1.0))
    assert not np.asarray(got["overflow"][:nsel]).any()
    np.testing.assert_allclose(np.asarray(got["vcirc"][:nsel]),
                               np.asarray(want["vcirc"][:nsel]), rtol=1e-5)
    np.testing.assert_allclose(np.asarray(got["rmass"][:nsel]),
                               np.asarray(want["rmass"][:nsel]), rtol=1e-5)
    np.testing.assert_allclose(np.asarray(got["vmax"][:nsel]),
                               np.asarray(want["vmax"][:nsel]), rtol=1e-5)
    np.testing.assert_allclose(np.asarray(got["profiles"][DARK][:nsel]),
                               np.asarray(want["profiles"][DARK][:nsel]),
                               rtol=1e-5)


def test_sharded_members_match_single(data):
    """Sharded member extraction (global-index translation + all_gather
    merge) == single-device: identical member sets, and ONE vcm
    accumulation order everywhere — plain, fused, and sharded are
    BIT-identical (vcm_from_members sequential-f64),
    both with an explicit host_mv and with each path's own derivation."""
    from so_jax.engine.fused import members_and_derived
    from so_jax.engine.members import extract_members
    from so_jax.parallel.mesh import (extract_members_sharded,
                                      host_mv_from_sharded)

    d, centers, rgtp = data
    thr = 178.0
    grid = build_grid(d["pos"], d["mass"], vel=d["vel"], m=3)
    solved = solve_rvir(grid, centers, rgtp, thr)
    ok = solved.code == 0
    assert ok.sum() >= 2
    mv = (d["vel"], d["mass"])
    want, want_vcm = extract_members(grid, centers[ok], solved.d2cut[ok],
                                     solved.j[ok], solved.mvir[ok],
                                     host_mv=mv)

    mesh = make_mesh(2, 4)
    sgrid = build_sharded_grid(d["pos"], d["mass"], vel=d["vel"], m=3,
                               mesh=mesh)
    got, got_vcm = extract_members_sharded(mesh, sgrid, centers[ok],
                                           solved.d2cut[ok], solved.j[ok],
                                           solved.mvir[ok], host_mv=mv)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        # tie order at equal d2 is arbitrary; the member SET is exact
        np.testing.assert_array_equal(np.sort(a), np.sort(b))
    np.testing.assert_array_equal(got_vcm, want_vcm)

    # third way: the fused members+derived single-gather pass
    _, vcm_f, _ = members_and_derived(
        grid, centers[ok], solved.rvir[ok], solved.d2cut[ok],
        solved.j[ok], solved.mvir[ok], host_mv=mv)
    np.testing.assert_array_equal(vcm_f, want_vcm)

    # each path's own host_mv derivation reproduces the explicit pair
    # bit-for-bit (grid accessors / shard reconstruction are lossless)
    dv, dm = host_mv_from_sharded(sgrid)
    np.testing.assert_array_equal(dv, np.asarray(d["vel"], np.float32))
    np.testing.assert_array_equal(dm, np.asarray(d["mass"], np.float32))
    _, vcm_auto = extract_members(grid, centers[ok], solved.d2cut[ok],
                                  solved.j[ok], solved.mvir[ok])
    np.testing.assert_array_equal(vcm_auto, want_vcm)
    _, vcm_auto_s = extract_members_sharded(mesh, sgrid, centers[ok],
                                            solved.d2cut[ok], solved.j[ok],
                                            solved.mvir[ok])
    np.testing.assert_array_equal(vcm_auto_s, want_vcm)


def test_host_segments_partition():
    """host_segment slices are contiguous, balanced, and covering."""
    from so_jax.parallel.distributed import host_segment, init_distributed

    for n, hosts in [(17, 4), (16, 4), (3, 8), (0, 2), (1024, 1)]:
        segs = [host_segment(n, hosts, h) for h in range(hosts)]
        pos = 0
        for start, count in segs:
            assert start == pos
            pos += count
        assert pos == n
        sizes = [c for _, c in segs]
        assert max(sizes) - min(sizes) <= 1
    # defaults read jax.process_index/count (single-process here)
    assert host_segment(10) == (0, 10)
    assert init_distributed() is False  # no coordinator configured


def test_sharded_solve_pallas_payload():
    """The slab gather under shard_map must agree with the ragged
    local-gather sharded path."""
    rng = np.random.default_rng(41)
    clump = dict(center=(0.05, 0.0, 0.0), n=700, rmax=0.05, mass_total=0.3)
    d = make_clumpy_box(rng, n_background=500, clumps=[clump])
    centers = np.array([[0.05, 0.0, 0.0], [0.06, 0.01, 0.0]], np.float32)
    rgtp = np.array([0.05, 0.04], np.float32)
    thr = 178.0
    mesh = make_mesh(1, 2, devices=__import__("jax").devices()[:2])
    sg_x = build_sharded_grid(d["pos"], d["mass"], vel=d["vel"], m=2,
                              mesh=mesh, slab=False)
    sg_p = build_sharded_grid(d["pos"], d["mass"], vel=d["vel"], m=2,
                              mesh=mesh, slab=True)
    assert sg_p.soa8t is not None
    a = solve_rvir_sharded(mesh, sg_x, centers, rgtp, thr)
    b = solve_rvir_sharded(mesh, sg_p, centers, rgtp, thr)
    np.testing.assert_array_equal(a.code, b.code)
    np.testing.assert_array_equal(a.j, b.j)
    np.testing.assert_allclose(a.mvir, b.mvir, rtol=1e-6)
    np.testing.assert_allclose(a.rvir, b.rvir, rtol=1e-6)


def test_sharded_fused_tier_matches_single(data):
    """The fused two-round program (tier 1 + compacted tier 2 in one
    dispatch) under shard_map == the single-device escalation path."""
    d, centers, rgtp = data
    thr = 178.0
    grid = build_grid(d["pos"], d["mass"], vel=d["vel"], m=3)
    want = solve_rvir(grid, centers, rgtp, thr)

    mesh = make_mesh(2, 4)
    sgrid = build_sharded_grid(d["pos"], d["mass"], vel=d["vel"], m=3,
                               mesh=mesh)
    # small fused_b2/k0_cap keep the CPU tier-2 arrays sane; fused=True
    # forces the fused round below its G >= 2048 default gate
    got = solve_rvir_sharded(mesh, sgrid, centers, rgtp, thr, fused=True,
                             fused_b2=8, k0_cap=1024)
    np.testing.assert_array_equal(got.code, want.code)
    np.testing.assert_allclose(got.mvir, want.mvir, rtol=2e-6)
    np.testing.assert_allclose(got.rvir, want.rvir, rtol=2e-6)
    np.testing.assert_array_equal(got.j, want.j)


def test_sharded_escalation_overflow_and_m3(data):
    """Capacity-overflow escalation and the -3 give-up tier under a
    multi-device mesh (the tiers the base fixtures deliberately avoid)."""
    d, centers, rgtp = data
    grid = build_grid(d["pos"], d["mass"], vel=d["vel"], m=3)
    mesh = make_mesh(2, 4)
    sgrid = build_sharded_grid(d["pos"], d["mass"], vel=d["vel"], m=3,
                               mesh=mesh)

    # tiny k0_cap: every halo overflows tier 1 and climbs the x4 capacity
    # ladder (smGrowList analog) before resolving
    thr = 178.0
    want = solve_rvir(grid, centers, rgtp, thr)
    got = solve_rvir_sharded(mesh, sgrid, centers, rgtp, thr, k0_cap=128)
    np.testing.assert_array_equal(got.code, want.code)
    np.testing.assert_allclose(got.mvir, want.mvir, rtol=2e-6)
    np.testing.assert_array_equal(got.j, want.j)

    # threshold below the box's asymptotic enclosed density: the density
    # never drops under it, so the ladder exhausts at the give-up bound and
    # the gather climbs to the whole-box brute-force capacity -> -3
    # (kd2.c:836-839), sharded == single-device
    c3 = centers[:2]
    r3 = rgtp[:2]
    want3 = solve_rvir(grid, c3, r3, 1e-4)
    got3 = solve_rvir_sharded(mesh, sgrid, c3, r3, 1e-4)
    assert (want3.code == -3).any()
    np.testing.assert_array_equal(got3.code, want3.code)
    np.testing.assert_array_equal(got3.mvir, want3.mvir)


def test_sharded_multi_threshold_matches_single(data):
    """Multi-threshold solve on a (2,4) mesh == single-device engine.multi
    for every threshold."""
    from so_jax.engine.multi import solve_rvir_multi
    from so_jax.parallel.mesh import solve_rvir_multi_sharded

    d, centers, rgtp = data
    thresholds = [178.0, 500.0, 80.0]
    grid = build_grid(d["pos"], d["mass"], vel=d["vel"], m=3)
    want = solve_rvir_multi(grid, centers, rgtp, thresholds)

    mesh = make_mesh(2, 4)
    sgrid = build_sharded_grid(d["pos"], d["mass"], vel=d["vel"], m=3,
                               mesh=mesh)
    got = solve_rvir_multi_sharded(mesh, sgrid, centers, rgtp, thresholds)
    np.testing.assert_array_equal(got.code, want.code)
    np.testing.assert_allclose(got.mvir, want.mvir, rtol=2e-6)
    np.testing.assert_allclose(got.rvir, want.rvir, rtol=2e-6)
    np.testing.assert_array_equal(got.j, want.j)
    np.testing.assert_allclose(got.d2cut, want.d2cut, rtol=2e-6)


def test_sharded_survey_matches_single():
    """solve_rvir_sharded(survey=True) — the classify pre-pass via
    classify_stage_sharded (per-shard kk-prefix merge over 'part') — must
    equal both the single-device survey solve and the plain solve on a
    catalog mixing -1, -2, and successful halos."""
    from so_jax.parallel.mesh import solve_rvir_multi_sharded

    rng = np.random.default_rng(55)
    d = make_clumpy_box(rng, n_background=6000, clumps=[
        dict(center=(0.2, 0.2, 0.2), n=2000, rmax=0.06, mass_total=0.25)])
    centers = np.array([
        (0.2, 0.2, 0.2),        # success
        (-0.4, -0.4, -0.4),     # tiny ball in the void -> -1
        (-0.35, 0.4, -0.4),     # big sparse ball -> -2
        (0.21, 0.19, 0.2),      # success
        (0.4, -0.4, 0.4),       # another void -2 candidate
    ], np.float32)
    rgtp = np.array([0.05, 0.004, 0.2, 0.04, 0.15], np.float32)
    grid = build_grid(d["pos"], d["mass"], m=3)
    want = solve_rvir(grid, centers, rgtp, 178.0, survey=False)
    assert set(np.unique(want.code)) >= {0, -1, -2}

    mesh = make_mesh(2, 4)
    sgrid = build_sharded_grid(d["pos"], d["mass"], m=3, mesh=mesh)
    got = solve_rvir_sharded(mesh, sgrid, centers, rgtp, 178.0,
                             survey=True)
    np.testing.assert_array_equal(got.code, want.code)
    np.testing.assert_allclose(got.mvir, want.mvir, rtol=2e-6)
    np.testing.assert_allclose(got.rvir, want.rvir, rtol=2e-6)
    np.testing.assert_array_equal(got.j, want.j)

    # multi-threshold: the sharded classifier shares one gather across
    # thresholds (T-wide -2 bitmask), same contract as engine.multi
    from so_jax.engine.multi import solve_rvir_multi
    thresholds = [178.0, 1e-4]
    want_m = solve_rvir_multi(grid, centers, rgtp, thresholds,
                              survey=False)
    got_m = solve_rvir_multi_sharded(mesh, sgrid, centers, rgtp,
                                     thresholds, survey=True)
    np.testing.assert_array_equal(got_m.code, want_m.code)
    np.testing.assert_allclose(got_m.mvir, want_m.mvir, rtol=2e-6)
    np.testing.assert_allclose(got_m.rvir, want_m.rvir, rtol=2e-6)


def test_cli_mesh_flag_matches_default(tmp_path):
    """The --mesh HxP CLI runs the sharded end-to-end pipeline and must
    reproduce the single-device CLI outputs exactly. Deliberately tiny
    and species-free: every extra capacity tier is another multi-10s
    shard_map compile on the CPU backend."""
    import sys as _sys

    HERE2 = os.path.dirname(os.path.abspath(__file__))
    _sys.path.insert(0, HERE2)
    from fixtures import write_gtp, write_snapshot

    from so_jax.cli import main

    rng = np.random.default_rng(29)
    clumps = [dict(center=(0.1, 0.0, -0.1), n=900, rmax=0.05,
                   mass_total=0.18),
              dict(center=(-0.25, 0.3, 0.2), n=700, rmax=0.04,
                   mass_total=0.09)]
    d = make_clumpy_box(rng, n_background=1500, clumps=clumps)
    workdir = str(tmp_path)
    write_snapshot(f"{workdir}/snap.bin", d)
    write_gtp(f"{workdir}/cat.gtp", [c["center"] for c in clumps],
              [0.045, 0.04], [0.18, 0.09])
    base = ["-i", f"{workdir}/cat.gtp", "--tipsy", f"{workdir}/snap.bin",
            "-grp", "-gtp", "-subsumed", "-ignored"]
    assert main(base + ["-o", f"{workdir}/single"]) == 0
    assert main(base + ["-o", f"{workdir}/meshed", "--mesh", "2x4"]) == 0
    for ext in ("sovcirc", "sogrp", "sosub", "soign"):
        a = f"{workdir}/single.{ext}"
        b = f"{workdir}/meshed.{ext}"
        la = [l for l in open(a, "rb").read().splitlines()
              if not (l.startswith(b"# Run on") or b"written to" in l)]
        lb = [l for l in open(b, "rb").read().splitlines()
              if not (l.startswith(b"# Run on") or b"written to" in l)]
        assert la == lb, ext
    # .sogtp carries vel = vcm: both pipelines now route through the fused
    # members+derived pass and the shared vcm_from_members accumulation
    # (PARITY #8), so the catalogs are byte-identical
    assert open(f"{workdir}/single.sogtp", "rb").read() == \
        open(f"{workdir}/meshed.sogtp", "rb").read()


def test_cli_mesh_deltas_matches_default(tmp_path):
    """--mesh combined with --deltas: the sharded multi-threshold pipeline
    must reproduce the single-device --deltas outputs exactly."""
    import sys as _sys

    HERE2 = os.path.dirname(os.path.abspath(__file__))
    _sys.path.insert(0, HERE2)
    from fixtures import write_gtp, write_snapshot

    from so_jax.cli import main

    rng = np.random.default_rng(41)
    clumps = [dict(center=(0.1, 0.0, -0.1), n=900, rmax=0.05,
                   mass_total=0.18),
              dict(center=(-0.25, 0.3, 0.2), n=700, rmax=0.04,
                   mass_total=0.09)]
    d = make_clumpy_box(rng, n_background=1500, clumps=clumps)
    workdir = str(tmp_path)
    write_snapshot(f"{workdir}/snap.bin", d)
    write_gtp(f"{workdir}/cat.gtp", [c["center"] for c in clumps],
              [0.045, 0.04], [0.18, 0.09])
    base = ["-i", f"{workdir}/cat.gtp", "--tipsy", f"{workdir}/snap.bin",
            "-grp", "-gtp", "--deltas", "150,500"]
    assert main(base + ["-o", f"{workdir}/single"]) == 0
    assert main(base + ["-o", f"{workdir}/meshed", "--mesh", "2x4"]) == 0
    for dstr in ("150", "500"):
        for ext in ("sovcirc", "sogrp"):
            a = f"{workdir}/single.d{dstr}.{ext}"
            b = f"{workdir}/meshed.d{dstr}.{ext}"
            la = [l for l in open(a, "rb").read().splitlines()
                  if not (l.startswith(b"# Run on") or b"written to" in l)]
            lb = [l for l in open(b, "rb").read().splitlines()
                  if not (l.startswith(b"# Run on") or b"written to" in l)]
            assert la == lb, (dstr, ext)
        assert open(f"{workdir}/single.d{dstr}.sogtp", "rb").read() == \
            open(f"{workdir}/meshed.d{dstr}.sogtp", "rb").read()


def test_sharded_recenter_matches_single(data):
    """Sharded -pot recentring (all_gather merge + argmin) == the
    single-device stage whenever phi values are distinct."""
    from so_jax.engine.recenter import recenter_most_bound
    from so_jax.parallel.mesh import recenter_most_bound_sharded

    d, centers, rgtp = data
    rng = np.random.default_rng(3)
    phi = rng.uniform(-3.0, -0.1, d["pos"].shape[0]).astype(np.float32)
    grid = build_grid(d["pos"], d["mass"], phi=phi, m=3)
    want = recenter_most_bound(grid, centers, rgtp)

    mesh = make_mesh(2, 4)
    sgrid = build_sharded_grid(d["pos"], d["mass"], phi=phi, m=3, mesh=mesh)
    got = recenter_most_bound_sharded(mesh, sgrid, centers, rgtp)
    np.testing.assert_array_equal(got, want)


def test_uniform_mass_sharded_matches_single(data):
    """Uniform-mass sharded stages (mass channel dropped, halved
    all_gather merge, 1-op sort, ladder cum) must bit-match the
    single-device solve — plain solve, --survey classify, and
    multi-threshold."""
    from so_jax.engine.multi import solve_rvir_multi
    from so_jax.parallel.mesh import solve_rvir_multi_sharded

    d, centers, rgtp = data
    n = d["pos"].shape[0]
    mass = np.full(n, np.float32(1.0 / n))
    grid = build_grid(d["pos"], mass)
    assert grid.uniform_mass is not None
    want = solve_rvir(grid, centers, rgtp, 178.0)

    mesh = make_mesh(2, 4)
    sgrid = build_sharded_grid(d["pos"], mass, m=3, mesh=mesh)
    assert sgrid.uniform_mass == grid.uniform_mass
    for survey in (False, True):
        got = solve_rvir_sharded(mesh, sgrid, centers, rgtp, 178.0,
                                 survey=survey)
        np.testing.assert_array_equal(got.code, want.code)
        np.testing.assert_array_equal(got.mvir, want.mvir)
        np.testing.assert_array_equal(got.rvir, want.rvir)
        np.testing.assert_array_equal(got.j, want.j)

    thresholds = [178.0, 500.0]
    want_m = solve_rvir_multi(grid, centers, rgtp, thresholds)
    got_m = solve_rvir_multi_sharded(mesh, sgrid, centers, rgtp, thresholds)
    np.testing.assert_array_equal(got_m.code, want_m.code)
    np.testing.assert_array_equal(got_m.mvir, want_m.mvir)
    np.testing.assert_array_equal(got_m.rvir, want_m.rvir)


def test_uniform_mass_sharded_fused_members_matches(data):
    """The sharded fused members+derived stage under uniform mass (mass
    operand dropped from the merge sort, ladder cum + int-count species
    profiles) must match the single-device fused pass bit-for-bit."""
    import dataclasses

    from so_jax.engine.fused import members_and_derived
    from so_jax.io.tipsy import DARK
    from so_jax.parallel.mesh import sharded_fused_members_fn

    d, centers, rgtp = data
    n = d["pos"].shape[0]
    mass = np.full(n, np.float32(1.0 / n))
    vel = np.random.default_rng(5).normal(size=(n, 3)).astype(np.float32)
    grid = build_grid(d["pos"], mass, vel=vel)
    sr = solve_rvir(grid, centers, rgtp, 178.0)
    ok = sr.code == 0

    mesh = make_mesh(2, 4)
    sgrid = build_sharded_grid(d["pos"], mass, vel=vel, m=3, mesh=mesh)
    assert sgrid.uniform_mass is not None
    species = (DARK,)
    want = members_and_derived(grid, centers[ok], sr.rvir[ok], sr.d2cut[ok],
                               sr.j[ok], sr.mvir[ok], host_mv=(vel, mass),
                               species=species)
    got = members_and_derived(grid, centers[ok], sr.rvir[ok], sr.d2cut[ok],
                              sr.j[ok], sr.mvir[ok], host_mv=(vel, mass),
                              species=species,
                              stage_fn=sharded_fused_members_fn(mesh, sgrid))
    for a, b in zip(got[0], want[0]):
        np.testing.assert_array_equal(np.sort(a), np.sort(b))
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[2].vcirc, want[2].vcirc)
    np.testing.assert_array_equal(got[2].rmass, want[2].rmass)
    np.testing.assert_array_equal(got[2].profiles[DARK],
                                  want[2].profiles[DARK])
