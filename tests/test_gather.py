"""Property tests: cell-grid gather == brute-force O(N^2) gather.

The reference's kd-tree gather is exact — INTERSECT never drops an in-ball
particle (SURVEY.md section 4 item 3) — so the grid gather must be too, at
every level, for anisotropic periods, off-center boxes, and balls wrapping
the periodic boundary.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from so_jax.ops import build_grid, ragged_ball_gather


def brute_force(pos, center, r2, period):
    # reference float32 association: shifted center first, then subtract
    # the particle (kd2.h INTERSECT + smooth2.c:89-92)
    d0 = (center[None, :] - pos).astype(np.float32)
    n = np.round(d0 / period[None, :]).astype(np.float32)
    sx = (center[None, :] - period[None, :] * n).astype(np.float32)
    d = (sx - pos).astype(np.float32)
    d2 = d[:, 0] ** 2 + d[:, 1] ** 2 + d[:, 2] ** 2
    return np.sort(d2[d2 <= r2])


@pytest.mark.parametrize("period,center", [
    ((1.0, 1.0, 1.0), (0.0, 0.0, 0.0)),
    ((2.0, 1.0, 0.5), (0.3, -0.2, 0.1)),
])
def test_gather_matches_brute_force(period, center):
    rng = np.random.default_rng(0)
    N = 4000
    period = np.asarray(period, np.float32)
    center = np.asarray(center, np.float32)
    lo = center - period / 2
    pos = (lo + rng.uniform(0, 1, (N, 3)) * period).astype(np.float32)
    mass = rng.uniform(0.5, 1.5, N).astype(np.float32)
    grid = build_grid(pos, mass, period=period, center=center, m=3)

    B = 6
    centers = (lo + rng.uniform(0, 1, (B, 3)) * period).astype(np.float32)
    radii = rng.uniform(0.02, 0.2, B).astype(np.float32)
    for level in range(grid.m + 1):
        S = 11
        res = ragged_ball_gather(grid, level, jnp.asarray(centers),
                                 jnp.asarray(radii),
                                 jnp.asarray(radii ** 2), K=4096, S=S)
        for b in range(B):
            if bool(res.overflow[b]):
                continue
            want = brute_force(pos, centers[b], radii[b] ** 2, period)
            got = np.asarray(res.d2[b])[: int(res.n_in[b])]
            assert got.size == want.size, (level, b)
            np.testing.assert_allclose(np.sort(got), want, rtol=1e-6, atol=0)


def test_gather_overflow_flag():
    rng = np.random.default_rng(1)
    pos = rng.uniform(-0.5, 0.5, (2000, 3)).astype(np.float32)
    grid = build_grid(pos, np.ones(2000, np.float32), m=2)
    centers = jnp.zeros((1, 3), jnp.float32)
    big = jnp.asarray([0.4], jnp.float32)
    res = ragged_ball_gather(grid, 2, centers, big, big * big, K=64, S=11)
    assert bool(res.overflow[0])
    res = ragged_ball_gather(grid, 2, centers, big, big * big, K=2048, S=11)
    assert not bool(res.overflow[0])


def test_gather_wrapping_ball():
    """Ball centered at the box corner must pick up wrapped neighbors."""
    pos = np.array([[0.49, 0.0, 0.0], [-0.49, 0.0, 0.0],
                    [0.0, 0.49, 0.0], [0.25, 0.0, 0.0]], np.float32)
    grid = build_grid(pos, np.ones(4, np.float32), m=2)
    centers = jnp.asarray([[0.5, 0.0, 0.0]], jnp.float32)
    r = jnp.asarray([0.05], jnp.float32)
    res = ragged_ball_gather(grid, 0, centers, r, r * r, K=256, S=5)
    assert int(res.n_in[0]) == 2  # both corner particles via min-image


def test_gather_inclusive_boundary():
    # the reference's test is fDist2 <= fBall2 (smooth2.c:95): inclusive
    pos = np.array([[0.1, 0.0, 0.0]], np.float32)
    grid = build_grid(pos, np.ones(1, np.float32), m=1)
    centers = jnp.zeros((1, 3), jnp.float32)
    d2 = jnp.asarray([np.float32(0.1) ** 2], jnp.float32)
    res = ragged_ball_gather(grid, 0, centers, jnp.asarray([0.1], jnp.float32),
                             d2, K=256, S=5)
    assert int(res.n_in[0]) == 1


def test_staged_build_bit_identical(monkeypatch):
    """The staged large-N build (perm from positions alone + per-field
    permutes; engaged above grid.STAGED_BUILD_MIN to bound the build's
    memory peak) must reproduce the one-shot build bit-for-bit —
    including absent fields materialized as sorted zeros and the soa8t
    slab payload."""
    from so_jax.ops import grid as grid_mod

    rng = np.random.default_rng(3)
    n = 5000
    pos = rng.uniform(-0.5, 0.5, (n, 3)).astype(np.float32)
    mass = rng.uniform(0.5, 2.0, n).astype(np.float32)
    vel = rng.normal(size=(n, 3)).astype(np.float32)
    phi = rng.uniform(-2, -0.1, n).astype(np.float32)

    ptype = rng.integers(0, 3, n).astype(np.int32)
    mark = rng.integers(0, 2, n).astype(bool)
    for kw in (dict(vel=vel, phi=phi),            # provided
               dict(),                            # defaulted (constant rows)
               dict(vel=vel, ptype=ptype, mark=mark)):  # meta row
        for slab in (False, True):
            one = build_grid(pos, mass, slab=slab, **kw)
            monkeypatch.setattr(grid_mod, "STAGED_BUILD_MIN", 1)
            staged = build_grid(pos, mass, slab=slab, **kw)
            monkeypatch.setattr(grid_mod, "STAGED_BUILD_MIN", 1 << 25)
            for f in ("pos", "mass", "vel", "phi", "ptype", "mark",
                      "orig_idx", "soa8t"):
                a, b = getattr(one, f), getattr(staged, f)
                assert (a is None) == (b is None), f
                if a is not None:
                    np.testing.assert_array_equal(
                        np.asarray(a), np.asarray(b), err_msg=f)
            assert len(one.starts) == len(staged.starts)
            for sa, sb in zip(one.starts, staged.starts):
                np.testing.assert_array_equal(np.asarray(sa), np.asarray(sb))
            assert one.chunk == staged.chunk
            assert one.uniform_mass == staged.uniform_mass
