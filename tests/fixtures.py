"""Synthetic tipsy snapshot / GTP fixture generation for golden tests.

Builds boxes of uniform background plus rho ~ r^-2 clumps (isothermal
spheres have analytically known SO radii: M(<r) = A r, so
rho_enc = 3A/(4 pi r^2) crosses a threshold at R = sqrt(3A/(4 pi thr)) —
the survey's verification used exactly this construction).
"""

from __future__ import annotations

import numpy as np

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from so_jax.io.tipsy import (DARK_DTYPE, GAS_DTYPE, STAR_DTYPE, TipsyHeader,
                             write_tipsy)


def make_clumpy_box(rng, n_background=8000, clumps=(), box=1.0, time=1.0,
                    species="dark", mass=None, vel_scale=0.05):
    """Positions/velocities/masses for a unit box with r^-2 clumps.

    clumps: list of dicts {center (3,), n, rmax, mass_total}.
    Returns dict of float32 arrays (pos, vel, mass, phi).
    """
    pos = [rng.uniform(-box / 2, box / 2, (n_background, 3))]
    npart = n_background
    for c in clumps:
        r = c["rmax"] * rng.uniform(0.0005, 1.0, c["n"])  # rho ~ r^-2
        u = rng.normal(size=(c["n"], 3))
        u /= np.linalg.norm(u, axis=1, keepdims=True)
        p = np.asarray(c["center"])[None, :] + r[:, None] * u
        p = (p + box / 2) % box - box / 2
        pos.append(p)
        npart += c["n"]
    pos = np.concatenate(pos).astype(np.float32)
    vel = (rng.normal(size=(npart, 3)) * vel_scale).astype(np.float32)
    if mass is None:
        mtot_clumps = sum(c.get("mass_total", 0.0) for c in clumps)
        m_bg = max(1e-8, (1.0 - mtot_clumps)) / n_background
        masses = [np.full(n_background, m_bg, np.float32)]
        for c in clumps:
            masses.append(np.full(c["n"], c["mass_total"] / c["n"], np.float32))
        mass = np.concatenate(masses).astype(np.float32)
    phi = rng.uniform(-2.0, -0.1, npart).astype(np.float32)
    return dict(pos=pos, vel=vel, mass=mass, phi=phi)


def make_zoom_box(rng, n_hi, n_lo, n_halos, zoom_half=0.15, verbose=False):
    """Zoom-in multi-species box (BASELINE.md scale-ladder config): a
    high-resolution sub-volume (gas+dark+star, light particles, clustered
    r^-2 halos) embedded in a low-resolution background of heavy dark
    particles — particle masses span ~2 orders of magnitude. Stresses the
    iOrder species windows (reference kd2.c:135-141), per-species
    cumulative profiles (kd2.c:458-496), and density scans dominated by
    occasional heavyweight background hits rather than uniform-mass counts.

    Unit periodic box, total mass 1: hi-res particles (half clumped in
    r^-2 halos, half uniform) inside the zoom cube |x_i| < zoom_half, and
    heavy lo-res dark particles filling the rest of the volume.

    Returns (data dict for write_snapshot, split, centers, rgtp). The
    hi-res block is shuffled then split gas/dark/star 20/70/10; the dark
    block is hi-res dark followed by all lo-res particles (tipsy species
    order gas, dark, star is preserved by construction).
    """
    n_clumped = n_hi // 2
    n_zbg = n_hi - n_clumped
    sizes = rng.pareto(1.5, n_halos) + 1.0
    sizes = np.maximum((sizes / sizes.sum() * n_clumped).astype(np.int64), 24)
    margin = 0.02
    centers = rng.uniform(-(zoom_half - margin), zoom_half - margin,
                          (n_halos, 3)).astype(np.float32)

    # mass budget: clumps 0.05 (the zoom overdensity), hi-res uniform
    # matches mean density inside the zoom cube, lo-res takes the rest
    m_clump_tot = 0.05
    v_zoom = (2.0 * zoom_half) ** 3
    m_zbg_tot = v_zoom
    m_p_hi = m_clump_tot / float(sizes.sum())
    # r^-2 clumps: M(<r) = m_c r / rmax, so the Delta=178 crossing sits at
    # R/rmax = sqrt(3 m_p_hi / (4 pi 178 coef^3)) independent of clump
    # size; pick coef so R/rmax ~ 0.4 (crossing well inside the clump,
    # >~100 members for a mean-size halo, near-nMembers for the smallest)
    coef = (3.0 * m_p_hi / (4.0 * np.pi * 178.0 * 0.16)) ** (1.0 / 3.0)
    rmax = (coef * sizes.astype(np.float64) ** (1.0 / 3.0)).astype(np.float32)

    chunks = [rng.uniform(-zoom_half, zoom_half, (n_zbg, 3)).astype(np.float32)]
    for c, n, rm in zip(centers, sizes, rmax):
        r = rm * rng.uniform(0.001, 1.0, n)
        u = rng.normal(size=(n, 3))
        u /= np.linalg.norm(u, axis=1, keepdims=True)
        chunks.append(c[None, :] + (r[:, None] * u).astype(np.float32))
    pos_hi = np.concatenate(chunks)
    mass_hi = np.concatenate([
        np.full(n_zbg, m_zbg_tot / n_zbg, np.float32),
        np.full(int(sizes.sum()), m_p_hi, np.float32)])
    # shuffle so the gas/dark/star windows are spatially mixed
    perm = rng.permutation(pos_hi.shape[0])
    pos_hi, mass_hi = pos_hi[perm], mass_hi[perm]
    n_hi_tot = pos_hi.shape[0]

    # lo-res: uniform outside the zoom cube (rejection sample)
    pos_lo = np.empty((0, 3), np.float32)
    while pos_lo.shape[0] < n_lo:
        cand = rng.uniform(-0.5, 0.5, (int(n_lo * 1.2) + 64, 3)
                           ).astype(np.float32)
        outside = np.abs(cand).max(axis=1) >= zoom_half
        pos_lo = np.concatenate([pos_lo, cand[outside]])[:n_lo]
    m_lo = (1.0 - m_clump_tot - m_zbg_tot) / n_lo
    mass_lo = np.full(n_lo, m_lo, np.float32)

    ngas = int(0.2 * n_hi_tot)
    nstar = int(0.1 * n_hi_tot)
    ndark_hi = n_hi_tot - ngas - nstar
    # species order: gas | dark(hi) + dark(lo) | star
    pos = np.concatenate([pos_hi[:ngas], pos_hi[ngas:ngas + ndark_hi],
                          pos_lo, pos_hi[ngas + ndark_hi:]])
    mass = np.concatenate([mass_hi[:ngas], mass_hi[ngas:ngas + ndark_hi],
                           mass_lo, mass_hi[ngas + ndark_hi:]])
    n_tot = pos.shape[0]
    data = dict(
        pos=pos.astype(np.float32),
        vel=(rng.normal(size=(n_tot, 3)) * 0.05).astype(np.float32),
        mass=mass.astype(np.float32),
        phi=rng.uniform(-2.0, -0.1, n_tot).astype(np.float32))
    split = (ngas, ndark_hi + n_lo, nstar)
    if verbose:
        print(f"zoom box: {n_tot} particles (gas {ngas}, dark {ndark_hi}"
              f"+{n_lo} lo-res, star {nstar}), mass ratio lo/hi = "
              f"{m_lo / m_p_hi:.1f}, {n_halos} halos, rmax "
              f"[{rmax.min():.4g}, {rmax.max():.4g}]", flush=True)
    return data, split, centers, rmax


def write_snapshot(path, data, time=1.0, standard=False, split=None):
    """Write particles as a tipsy snapshot. split=(ngas, ndark, nstar) or
    all-dark by default."""
    n = data["pos"].shape[0]
    ngas, ndark, nstar = split if split is not None else (0, n, 0)
    assert ngas + ndark + nstar == n

    def fill(dt, sl, extra):
        rec = np.zeros(sl.stop - sl.start, dtype=dt)
        rec["mass"] = data["mass"][sl]
        rec["pos"] = data["pos"][sl]
        rec["vel"] = data["vel"][sl]
        rec["phi"] = data["phi"][sl]
        for k, v in extra.items():
            rec[k] = v
        return rec

    gas = fill(GAS_DTYPE[False], slice(0, ngas),
               {"temp": 1e4, "rho": 1.0, "hsmooth": 0.01, "metals": 0.01}) if ngas else None
    dark = fill(DARK_DTYPE[False], slice(ngas, ngas + ndark), {"eps": 0.01}) if ndark else None
    star = fill(STAR_DTYPE[False], slice(ngas + ndark, n),
                {"metals": 0.02, "tform": 0.5, "eps": 0.01}) if nstar else None
    hdr = TipsyHeader(time=time, nbodies=n, ndim=3, nsph=ngas, ndark=ndark,
                      nstar=nstar)
    write_tipsy(path, hdr, gas, dark, star, standard)
    return hdr


def write_gtp(path, centers, rgtp, masses, time=1.0, standard=False):
    """Write a star-only GTP catalog of candidate centers."""
    centers = np.asarray(centers, np.float32)
    n = centers.shape[0]
    rec = np.zeros(n, dtype=STAR_DTYPE[False])
    rec["mass"] = np.asarray(masses, np.float32)
    rec["pos"] = centers
    rec["eps"] = np.asarray(rgtp, np.float32)
    rec["tform"] = np.arange(1, n + 1, dtype=np.float32)
    hdr = TipsyHeader(time=time, nbodies=n, ndim=3, nsph=0, ndark=0, nstar=n)
    write_tipsy(path, hdr, None, None, rec, standard)
