"""Live-reference fuzz: random boxes -> reference binary vs so_jax.

Complements the fixed-seed golden suite by hunting knife-edge mismatches on
fresh random configurations each seed. Skipped when the reference sources
are unavailable. Shapes are held constant across seeds so jit caches are
reused within the test session.
"""

import os
import shutil
import subprocess
import sys
import tempfile

import numpy as np
import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

from fixtures import (make_clumpy_box, make_zoom_box, write_gtp,  # noqa: E402
                      write_snapshot)
from make_goldens import REFERENCE_SRC, build_reference  # noqa: E402
from util_compare import (compare_exact_file, compare_file,  # noqa: E402
                          compare_sogtp)

pytestmark = pytest.mark.skipif(
    not os.path.isdir(REFERENCE_SRC), reason="reference sources unavailable")


@pytest.fixture(scope="module")
def so_bin(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("refbuild"))
    return build_reference(d)


def _run_both(so_bin, work, ref_args, our_args=None, standard=False):
    """Run the live reference and so_jax on work/{snap.bin,cat.gtp} and
    compare every produced output file."""
    with open(f"{work}/snap.bin", "rb") as snap:
        r = subprocess.run([so_bin, "-i", f"{work}/cat.gtp", "-o",
                            f"{work}/ref"] + ref_args,
                           stdin=snap, capture_output=True, text=True,
                           cwd=work)
    assert r.returncode == 0, r.stderr[-1500:]

    from so_jax.cli import main
    assert main(["-i", f"{work}/cat.gtp", "-o", f"{work}/got",
                 "--tipsy", f"{work}/snap.bin"]
                + (ref_args if our_args is None else our_args)) == 0

    errs = []
    for ext in ("sovcirc", "sodark", "sogas", "sostar"):
        if os.path.exists(f"{work}/ref.{ext}"):
            errs += compare_file(f"{work}/ref.{ext}", f"{work}/got.{ext}")
    for ext in ("sogrp", "sosub", "soign"):
        if os.path.exists(f"{work}/ref.{ext}"):
            errs += compare_exact_file(f"{work}/ref.{ext}", f"{work}/got.{ext}")
    if os.path.exists(f"{work}/ref.sogtp"):
        errs += compare_sogtp(f"{work}/ref.sogtp", f"{work}/got.sogtp",
                              standard)
    return errs


def _random_box(rng, n_clumps=4, box=1.0, n_background=6000,
                void_center=True):
    """``void_center=False`` keeps every candidate on a clump — needed for
    -pot fuzz, where an *empty* Rgtp ball makes the reference read stale
    neighbor-list memory and recenter onto the previous group's particles
    (documented divergence, docs/PARITY.md #5)."""
    clumps = []
    for _ in range(n_clumps):
        clumps.append(dict(
            center=tuple(rng.uniform(-0.45 * box, 0.45 * box, 3)),
            n=int(rng.integers(400, 1500)),
            rmax=float(rng.uniform(0.02, 0.07) * box),
            mass_total=float(rng.uniform(0.03, 0.15))))
    data = make_clumpy_box(rng, n_background=n_background, clumps=clumps,
                           box=box)
    extra = (tuple(rng.uniform(-0.45 * box, 0.45 * box, 3)) if void_center
             else tuple(np.asarray(clumps[0]["center"])
                        + rng.normal(size=3) * 0.004 * box))
    centers = [c["center"] for c in clumps] + [extra]
    rgtp = rng.uniform(0.01, 0.05, n_clumps + 1) * box
    masses = rng.uniform(0.01, 0.2, n_clumps + 1)
    return data, centers, rgtp, masses


@pytest.mark.parametrize("seed", [
    101, pytest.param(202, marks=pytest.mark.slow),
    pytest.param(303, marks=pytest.mark.slow)])
def test_fuzz_random_boxes(so_bin, seed, tmp_path):
    rng = np.random.default_rng(seed)
    data, centers, rgtp, masses = _random_box(rng)
    work = str(tmp_path)
    write_snapshot(f"{work}/snap.bin", data, time=1.0)
    write_gtp(f"{work}/cat.gtp", centers, rgtp, masses, time=1.0)
    errs = _run_both(so_bin, work,
                     ["-grp", "-gtp", "-subsumed", "-ignored", "-all"])
    assert not errs, "\n".join(errs[:8])


# knife-edge-prone paths the base fuzz never varies: -std (XDR read, kd2.c:330-371), -pot (recenter, kd2.c:749-761),
# -p/-c (periodic min-image, kd2.h:154-253), species splits
# (kdParticleType ranges, kd2.c:135-141 + per-species profiles).
FUZZ_MODES = {
    "std": dict(seed=404, standard=True,
                args=["-std", "-grp", "-gtp", "-subsumed", "-ignored"]),
    "pot": dict(seed=505, void_center=False,
                args=["-pot", "-grp", "-subsumed", "-ignored", "-all"]),
    "period": dict(seed=606, box=2.0,
                   args=["-p", "2.0", "-c", "1.0", "-grp", "-subsumed",
                         "-ignored"]),
    "species": dict(seed=707, split=True,
                    args=["-all", "-grp", "-subsumed", "-ignored"]),
    # --survey is a so_jax extension: same reference run, classifier on
    # our side — random boxes with void centers exercise the -1/-2
    # short-circuit against the live reference
    "survey": dict(seed=909, args=["-grp", "-gtp", "-subsumed", "-ignored"],
                   our_extra=["--survey"]),
    # all-equal f32 masses: the uniform-mass ladder fast path against the
    # live reference — quarter/half-mass crossings land exactly on
    # particle boundaries whenever a member count divides by 4, so the
    # Mvir add-then-subtract ulp (kd2.c:810-818) is load-bearing here
    "uniform": dict(seed=808, uniform=True,
                    args=["-all", "-grp", "-gtp", "-subsumed", "-ignored"]),
}


@pytest.mark.parametrize("mode", sorted(FUZZ_MODES))
@pytest.mark.parametrize("seed_off", [
    0, pytest.param(1, marks=pytest.mark.slow),
    pytest.param(2, marks=pytest.mark.slow)])
def test_fuzz_modes(so_bin, mode, seed_off, tmp_path):
    cfg = FUZZ_MODES[mode]
    rng = np.random.default_rng(cfg["seed"] + seed_off)
    box = cfg.get("box", 1.0)
    data, centers, rgtp, masses = _random_box(
        rng, box=box, void_center=cfg.get("void_center", True))
    if box != 1.0:
        # reference boxes are centered via -c; shift positions to [0, box)
        data["pos"] = ((data["pos"] + box / 2) % box).astype(np.float32)
        centers = [tuple((np.asarray(c) + box / 2) % box) for c in centers]
    work = str(tmp_path)
    n = data["pos"].shape[0]
    if cfg.get("uniform"):
        data["mass"] = np.full(n, np.float32(1.0 / n))
    split = None
    if cfg.get("split"):
        # interleave species: shuffle, then iOrder ranges split gas/dark/star
        perm = rng.permutation(n)
        for k in data:
            data[k] = data[k][perm]
        split = (n // 4, n - n // 4 - n // 6, n // 6)
    write_snapshot(f"{work}/snap.bin", data, time=1.0,
                   standard=cfg.get("standard", False), split=split)
    write_gtp(f"{work}/cat.gtp", centers, rgtp, masses, time=1.0,
              standard=cfg.get("standard", False))
    errs = _run_both(so_bin, work, cfg["args"],
                     our_args=cfg["args"] + cfg.get("our_extra", []),
                     standard=cfg.get("standard", False))
    assert not errs, "\n".join(errs[:8])


@pytest.mark.parametrize("seed", [
    1101, pytest.param(1202, marks=pytest.mark.slow),
    pytest.param(1303, marks=pytest.mark.slow)])
def test_fuzz_zoom_multispecies(so_bin, seed, tmp_path):
    """Zoom-in multi-species regime (BASELINE.md scale ladder): hi-res
    gas/dark/star clumps embedded in a heavy lo-res background — particle
    masses span ~2 orders of magnitude across the iOrder species windows,
    so density scans are dominated by rare heavyweight hits. At-scale
    counterpart: scripts/compare_reference_zoom.py."""
    rng = np.random.default_rng(seed)
    data, split, centers, rmax = make_zoom_box(rng, 30000, 6000, 48)
    work = str(tmp_path)
    write_snapshot(f"{work}/snap.bin", data, time=1.0, split=split)
    write_gtp(f"{work}/cat.gtp", centers, rmax,
              rng.uniform(0.001, 1.0, centers.shape[0]), time=1.0)
    errs = _run_both(so_bin, work,
                     ["-all", "-grp", "-gtp", "-subsumed", "-ignored"])
    assert not errs, "\n".join(errs[:8])


def test_fuzz_pot_phi_ties(so_bin, tmp_path):
    """-pot with deliberately duplicated phi values: quantify the PARITY #4
    divergence (the reference breaks min-phi ties in kd-traversal order,
    so_jax in cell order). Every catalog mismatch must be explained by an
    actual phi tie among that group's in-ball minimum — anything else is a
    real recentring bug. Clumps are kept far apart so a tie-divergent
    center cannot cascade into another group via the conflict pass."""
    rng = np.random.default_rng(808)
    clumps = [dict(center=(0.3, 0.3, 0.3), n=1200, rmax=0.05,
                   mass_total=0.15),
              dict(center=(-0.3, -0.3, -0.3), n=1000, rmax=0.04,
                   mass_total=0.10),
              dict(center=(0.3, -0.3, 0.3), n=900, rmax=0.04,
                   mass_total=0.08)]
    data = make_clumpy_box(rng, n_background=4000, clumps=clumps)
    # quantize phi to 8 distinct values -> min-phi ties are near-certain
    data["phi"] = -(np.floor(-data["phi"] * 4.0) / 4.0).astype(np.float32)
    work = str(tmp_path)
    write_snapshot(f"{work}/snap.bin", data, time=1.0)
    centers = np.array([c["center"] for c in clumps], np.float32)
    rgtp = np.array([0.04, 0.035, 0.03], np.float32)
    write_gtp(f"{work}/cat.gtp", centers, rgtp, [0.15, 0.10, 0.08], time=1.0)

    with open(f"{work}/snap.bin", "rb") as snap:
        r = subprocess.run([so_bin, "-i", f"{work}/cat.gtp", "-o",
                            f"{work}/ref", "-pot"],
                           stdin=snap, capture_output=True, text=True,
                           cwd=work)
    assert r.returncode == 0, r.stderr[-1500:]
    from so_jax.cli import main
    assert main(["-i", f"{work}/cat.gtp", "-o", f"{work}/got",
                 "--tipsy", f"{work}/snap.bin", "-pot"]) == 0
    errs = compare_file(f"{work}/ref.sovcirc", f"{work}/got.sovcirc")
    if not errs:
        return  # catalogs matched even with ties — strongest outcome
    # every mismatching row must belong to a group whose Rgtp ball has a
    # tied minimum phi (brute force over the raw inputs)
    tied = set()
    for g in range(centers.shape[0]):
        d = data["pos"] - centers[g]
        d -= np.round(d)  # unit box min-image
        inball = (d * d).sum(axis=1) <= rgtp[g] * rgtp[g]
        phis = data["phi"][inball]
        if phis.size and (phis == phis.min()).sum() > 1:
            tied.add(g + 1)
    assert tied, "catalog mismatch without any phi tie:\n" + "\n".join(errs[:8])
    for e in errs:
        for line in e.splitlines():
            line = line.strip()
            if not line.startswith("golden:"):
                continue
            tok = line.split()[1]
            if not tok.isdigit():
                continue   # stats-comment aggregates may differ once tied
            grp = int(tok)
            assert grp in tied, \
                f"mismatch on group {grp} which has no phi tie:\n{e}"
