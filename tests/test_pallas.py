"""Slab gather (ops/slab.py) on the CPU: the slotted payload gather must
agree with the ragged row-gather path bit for bit — same candidate sets,
distances and channels — at every chunk width and channel set."""

import numpy as np
import pytest

from so_jax.ops import build_grid
from so_jax.ops.gather import ragged_ball_gather, slab_gather


@pytest.fixture(scope="module")
def small_grid():
    rng = np.random.default_rng(3)
    N = 600
    pos = rng.uniform(-0.5, 0.5, (N, 3)).astype(np.float32)
    mass = rng.uniform(0.5, 1.5, N).astype(np.float32)
    vel = rng.normal(size=(N, 3)).astype(np.float32)
    ptype = rng.choice([1, 2, 4], N).astype(np.int32)
    mark = rng.uniform(size=N) < 0.3
    grid = build_grid(pos, mass, vel=vel, ptype=ptype, mark=mark, m=2,
                      slab=True)
    return grid, rng


def test_slab_matches_xla(small_grid):
    import jax.numpy as jnp

    grid, rng = small_grid
    # K must hold the CHUNK-aligned per-cell footprints (cell_ranges align)
    B, K, S = 4, 8192, 5
    centers = jnp.asarray(rng.uniform(-0.5, 0.5, (B, 3)).astype(np.float32))
    radii = jnp.asarray(rng.uniform(0.05, 0.3, B).astype(np.float32))
    r2 = radii * radii
    ref = ragged_ball_gather(grid, 1, centers, radii, r2, 2048, S, sort=True)
    got = slab_gather(grid, 1, centers, radii, r2, K, S,
                      channels=("mass", "mv", "meta", "idx"))
    assert not np.asarray(got.overflow).any()
    np.testing.assert_array_equal(np.asarray(got.n_in), np.asarray(ref.n_in))
    # the pallas build deduplicates: the raw arrays live only in the
    # payload, served bit-exactly by the accessors
    assert grid.mass is None and grid.vel is None
    mass_np = np.asarray(grid.mass_a())
    mv_np = np.asarray(grid.vel_a()) * mass_np[:, None]
    meta_np = (np.asarray(grid.ptype_a())
               | (np.asarray(grid.mark_a()).astype(np.int32) << 4))
    for b in range(B):
        n = int(ref.n_in[b])
        # both paths round each square on its own (slab.dist2): equal bits
        np.testing.assert_array_equal(np.asarray(got.d2[b, :n]),
                                      np.asarray(ref.d2[b, :n]))
        gi = np.asarray(got.channels[3][b, :n])
        ri = np.asarray(ref.idx[b, :n])
        np.testing.assert_array_equal(np.sort(gi), np.sort(ri))
        np.testing.assert_array_equal(np.asarray(got.channels[0][b, :n]),
                                      mass_np[gi])
        np.testing.assert_allclose(np.asarray(got.channels[1][b, :n]),
                                   mv_np[gi], rtol=1e-6)
        np.testing.assert_array_equal(
            np.asarray(got.channels[2][b, :n]).astype(np.int32), meta_np[gi])


def test_slab_overflow_flag(small_grid):
    import jax.numpy as jnp

    grid, _ = small_grid
    centers = jnp.zeros((1, 3), jnp.float32)
    big = jnp.asarray([0.45], jnp.float32)
    got = slab_gather(grid, 1, centers, big, big * big, 256, 5,
                      channels=("mass",))
    assert bool(got.overflow[0])


def test_slab_recenter_matches_xla():
    """-pot recentring via the slab kernel (phi in the mass row, unsorted
    argmin) == the XLA ragged-gather recenter stage."""
    import jax.numpy as jnp

    from so_jax.engine.recenter import recenter_most_bound

    rng = np.random.default_rng(11)
    N = 900
    pos = rng.uniform(-0.5, 0.5, (N, 3)).astype(np.float32)
    pos[:300] = pos[:300] * 0.08 + np.array([0.1, 0.1, 0.1], np.float32)
    mass = rng.uniform(0.5, 1.5, N).astype(np.float32)
    phi = rng.uniform(-3.0, -0.1, N).astype(np.float32)  # distinct: no ties
    g_slab = build_grid(pos, mass, phi=phi, m=2, slab=True)
    g_xla = build_grid(pos, mass, phi=phi, m=2, slab=False)
    centers = np.array([[0.1, 0.1, 0.1], [0.12, 0.09, 0.1],
                        [-0.4, -0.4, -0.4],    # likely-empty ball
                        [0.3, -0.2, 0.0]], np.float32)
    rgtp = np.array([0.05, 0.04, 0.01, 0.2], np.float32)
    a = recenter_most_bound(g_xla, centers, rgtp)
    b = recenter_most_bound(g_slab, centers, rgtp)
    np.testing.assert_array_equal(a, b)


def test_dedup_payload_roundtrip_bit_exact():
    """The payload is a lossless encoding: every accessor on a
    deduplicated grid returns bit-identical arrays to a duplicate-layout
    build of the same inputs, and the giant-K fallback grid
    (solver._stage_grid) materializes the same bits."""
    from so_jax.engine.solver import K_SLAB_MAX, _FB_ALL, _stage_grid

    rng = np.random.default_rng(21)
    N = 500
    pos = rng.uniform(-0.5, 0.5, (N, 3)).astype(np.float32)
    mass = rng.uniform(0.5, 1.5, N).astype(np.float32)
    vel = rng.normal(size=(N, 3)).astype(np.float32)
    ptype = rng.choice([1, 2, 4], N).astype(np.int32)
    mark = rng.uniform(size=N) < 0.3
    kw = dict(vel=vel, ptype=ptype, mark=mark, m=2)
    g_d = build_grid(pos, mass, slab=True, **kw)
    g_x = build_grid(pos, mass, slab=False, **kw)
    assert g_d.pos is None and g_d.soa8t is not None
    assert g_d.phi is None           # no potentials provided -> dropped
    assert g_d.n == g_x.n == N
    np.testing.assert_array_equal(np.asarray(g_d.pos_a()), np.asarray(g_x.pos))
    np.testing.assert_array_equal(np.asarray(g_d.mass_a()), np.asarray(g_x.mass))
    np.testing.assert_array_equal(np.asarray(g_d.vel_a()), np.asarray(g_x.vel))
    np.testing.assert_array_equal(np.asarray(g_d.ptype_a()), np.asarray(g_x.ptype))
    np.testing.assert_array_equal(np.asarray(g_d.mark_a()), np.asarray(g_x.mark))
    np.testing.assert_array_equal(np.asarray(g_d.phi_a()), np.asarray(g_x.phi))

    fb = _stage_grid(g_d, K_SLAB_MAX + 1)
    assert fb.soa8t is None
    np.testing.assert_array_equal(np.asarray(fb.pos), np.asarray(g_x.pos))
    np.testing.assert_array_equal(np.asarray(fb.mass), np.asarray(g_x.mass))
    np.testing.assert_array_equal(np.asarray(fb.ptype),
                                  np.asarray(g_x.ptype))
    np.testing.assert_array_equal(np.asarray(fb.mark), np.asarray(g_x.mark))
    # vcm is host-side: NO fallback stage reads vel, so the fallback grid
    # deliberately never materializes it (512^3 OOM lesson, 2026-08-20)
    assert fb.vel is None
    # each field materializes ONCE into the per-field cache; later
    # giant-K dispatches of any stage reuse the same device arrays
    cache = g_d._fb_fields
    assert set(cache) == set(_FB_ALL)
    fb2 = _stage_grid(g_d, K_SLAB_MAX + 1)
    assert fb2.pos is cache["pos"] and fb.pos is cache["pos"]
    assert fb2.mass is cache["mass"]
    # a narrower field request (the uniform-mass solve reads pos alone)
    # still reuses the shared cache entries
    fb3 = _stage_grid(g_d, K_SLAB_MAX + 1, fields=("pos",))
    assert fb3.pos is cache["pos"]

    # phi provided -> carried through dedup for the -pot paths
    g_phi = build_grid(pos, mass, phi=mass * 2, slab=True, **kw)
    assert g_phi.phi is not None


def test_dedup_env_escape_hatch(monkeypatch):
    monkeypatch.setenv("SO_JAX_DEDUP", "0")
    rng = np.random.default_rng(22)
    pos = rng.uniform(-0.5, 0.5, (200, 3)).astype(np.float32)
    mass = rng.uniform(0.5, 1.5, 200).astype(np.float32)
    g = build_grid(pos, mass, m=2, slab=True)
    assert g.soa8t is not None and g.pos is not None and g.mass is not None


def test_uniform_mass_slab_paths_match_general(tmp_path):
    """The chans=() slab configs (uniform-mass solve/classify/fused) must
    produce bit-identical results to the general (d2, mass) slab path."""
    import dataclasses

    from so_jax.engine.fused import members_and_derived
    from so_jax.engine.solver import solve_rvir
    from so_jax.io.tipsy import DARK, GAS

    rng = np.random.default_rng(31)
    n_c, n_b = 1800, 2600
    pos = np.concatenate([
        (rng.normal(size=(n_c, 3)) * 0.03).astype(np.float32),
        rng.uniform(-0.5, 0.5, (n_b, 3)).astype(np.float32)])
    n = pos.shape[0]
    mass = np.full(n, np.float32(1.0 / n))
    vel = (rng.normal(size=(n, 3)) * 0.01).astype(np.float32)
    ptype = np.where(np.arange(n) % 3 == 0, GAS, DARK).astype(np.int32)
    g_u = build_grid(pos, mass, vel=vel, ptype=ptype, m=2, slab=True)
    assert g_u.uniform_mass is not None and g_u.soa8t is not None
    g_g = dataclasses.replace(g_u, uniform_mass=None)

    centers = np.array([[0.0, 0.0, 0.0], [0.01, 0.0, 0.01],
                        [0.3, 0.3, 0.3]], np.float32)
    rgtp = np.array([0.05, 0.04, 0.02], np.float32)
    for survey in (False, True):
        want = solve_rvir(g_g, centers, rgtp, 178.0, survey=survey)
        got = solve_rvir(g_u, centers, rgtp, 178.0, survey=survey)
        np.testing.assert_array_equal(got.code, want.code)
        np.testing.assert_array_equal(got.mvir, want.mvir)
        np.testing.assert_array_equal(got.rvir, want.rvir)
        np.testing.assert_array_equal(got.j, want.j)

    sr = solve_rvir(g_g, centers, rgtp, 178.0)
    ok = sr.code == 0
    res = {}
    for name, g in (("u", g_u), ("g", g_g)):
        res[name] = members_and_derived(
            g, centers[ok], sr.rvir[ok], sr.d2cut[ok], sr.j[ok],
            sr.mvir[ok], host_mv=(vel, mass), species=(GAS, DARK))
    for a, b in zip(res["u"][0], res["g"][0]):
        np.testing.assert_array_equal(np.sort(a), np.sort(b))
    np.testing.assert_array_equal(res["u"][1], res["g"][1])
    for sp in (GAS, DARK):
        np.testing.assert_array_equal(res["u"][2].profiles[sp],
                                      res["g"][2].profiles[sp])
    np.testing.assert_array_equal(res["u"][2].rmass, res["g"][2].rmass)


_CHANS = {"d2": (), "mass": ("mass",),
          "all": ("mass", "mvx", "mvy", "mvz", "meta", "ilo", "ihi")}


def _slab_case(chunk):
    """A clumpy grid with the given payload chunk, and a batch of balls
    with their merged runs at level 1."""
    import dataclasses

    import jax.numpy as jnp

    from so_jax.ops.gather import cell_ranges
    from so_jax.ops.slab import pack_soa8t

    rng = np.random.default_rng(40 + chunk)
    N = 2400
    pos = rng.uniform(-0.5, 0.5, (N, 3)).astype(np.float32)
    pos[:800] = pos[:800] * 0.1 + np.float32(0.2)
    mass = rng.uniform(0.5, 1.5, N).astype(np.float32)
    vel = rng.normal(size=(N, 3)).astype(np.float32)
    ptype = rng.choice([1, 2, 4], N).astype(np.int32)
    mark = rng.uniform(size=N) < 0.3
    g = build_grid(pos, mass, vel=vel, ptype=ptype, mark=mark, m=3,
                   slab=False)
    g = dataclasses.replace(g, chunk=chunk, soa8t=pack_soa8t(
        g.pos, g.mass, g.vel, g.ptype, g.mark, chunk=chunk))
    B, S = 6, 5
    centers = rng.uniform(-0.5, 0.5, (B, 3)).astype(np.float32)
    centers[0] = 0.2                       # inside the clump
    centers[1] = (0.49, -0.49, 0.0)        # across the periodic boundary
    radii = rng.uniform(0.05, 0.25, B).astype(np.float32)
    centers, radii = jnp.asarray(centers), jnp.asarray(radii)
    r2 = radii * radii
    runs = cell_ranges(g, 1, centers, radii, r2, S, align=chunk)
    return g, centers, radii, r2, runs


@pytest.mark.parametrize("chans", sorted(_CHANS))
@pytest.mark.parametrize("chunk", [128, 256])
def test_slab_slots_match_ragged(chunk, chans):
    """slab_slots against the independent ragged row-gather: per halo the
    same in-ball count, the same source rows, bit-equal d2, and channels
    equal to the particle arrays at those rows (m*v one f32 product);
    empty and out-of-ball slots carry d2=+inf and zero channels."""
    from so_jax.ops.slab import decode_idx, slab_slots

    g, centers, radii, r2, (st, cnt, q, total) = _slab_case(chunk)
    K, S = 4096, 5
    assert int(np.asarray(total).max()) <= K
    ch = _CHANS[chans]
    out = np.asarray(slab_slots(g.soa8t, st, cnt, q, centers, g.period, r2,
                                K, chans=ch, CHUNK=chunk))
    assert out.shape == (centers.shape[0], 1 + len(ch), K)
    ref = ragged_ball_gather(g, 1, centers, radii, r2, K, S, sort=True)
    d2 = out[:, 0]
    hit = np.isfinite(d2)
    np.testing.assert_array_equal(hit.sum(axis=1), np.asarray(ref.n_in))
    assert (out[:, 1:][~np.broadcast_to(hit[:, None], out[:, 1:].shape)]
            == 0).all()
    full = ("mass", "mvx", "mvy", "mvz", "meta", "ilo", "ihi")
    want_ch = np.asarray(slab_slots(g.soa8t, st, cnt, q, centers, g.period,
                                    r2, K, chans=full, CHUNK=chunk))
    rows_all = np.asarray(decode_idx(want_ch[:, 6], want_ch[:, 7]))
    mass = np.asarray(g.mass)
    mv = np.asarray(g.vel) * mass[:, None]
    meta = np.asarray(g.ptype) | (np.asarray(g.mark).astype(np.int32) << 4)
    for b in range(centers.shape[0]):
        n = int(ref.n_in[b])
        rows = rows_all[b][hit[b]]
        np.testing.assert_array_equal(np.sort(rows),
                                      np.sort(np.asarray(ref.idx[b, :n])))
        np.testing.assert_array_equal(np.sort(d2[b][hit[b]]),
                                      np.asarray(ref.d2[b, :n]))
        got = {name: out[b, 1 + i][hit[b]] for i, name in enumerate(ch)}
        for name, v in got.items():
            if name == "mass":
                np.testing.assert_array_equal(v, mass[rows])
            elif name in ("mvx", "mvy", "mvz"):
                np.testing.assert_array_equal(v, mv[rows, "xyz".index(name[2])])
            elif name == "meta":
                np.testing.assert_array_equal(v.astype(np.int32), meta[rows])


def test_dist2_rounds_each_square():
    """dist2 equals the separately rounded numpy sum on every element: no
    fused multiply-add contraction, whatever the backend does with a
    plain x*x + y*y + z*z."""
    import jax
    import jax.numpy as jnp

    from so_jax.ops.slab import dist2

    rng = np.random.default_rng(5)
    x = rng.uniform(-0.3, 0.3, (3, 1 << 16)).astype(np.float32)
    want = (x[0] * x[0] + x[1] * x[1]) + x[2] * x[2]
    zero = jnp.asarray(np.zeros(1, np.int32))
    got = jax.jit(lambda a, z: dist2(a[0], a[1], a[2], z[0]))(x, zero)
    np.testing.assert_array_equal(np.asarray(got), want)
