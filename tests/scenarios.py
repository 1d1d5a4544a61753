"""Golden-test scenarios: deterministic fixture generation + CLI flag sets.

Each scenario regenerates its snapshot/catalog inputs from a fixed seed
(numpy Generator bit streams are stable by spec), so only the *reference
outputs* need committing (tests/goldens/<name>/). The same definitions are
used by make_goldens.py (runs the compiled reference, SURVEY.md section 4
item 1) and test_golden.py (runs so_jax and compares).
"""

from __future__ import annotations

import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from fixtures import (make_clumpy_box, make_zoom_box, write_snapshot,  # noqa: E402
                      write_gtp)


def _basic(outdir, standard=False):
    rng = np.random.default_rng(42)
    clumps = [
        dict(center=(0.1, 0.1, 0.1), n=3000, rmax=0.08, mass_total=0.2),
        dict(center=(-0.2, 0.25, -0.3), n=1500, rmax=0.05, mass_total=0.08),
        dict(center=(0.12, 0.12, 0.12), n=800, rmax=0.03, mass_total=0.04),
        dict(center=(0.4, -0.4, 0.0), n=600, rmax=0.04, mass_total=0.03),
    ]
    data = make_clumpy_box(rng, n_background=10000, clumps=clumps)
    write_snapshot(f"{outdir}/snap.bin", data, time=1.0, standard=standard)
    centers = [c["center"] for c in clumps] + [(-0.45, -0.45, -0.45)]
    write_gtp(f"{outdir}/cat.gtp", centers, [0.05, 0.04, 0.025, 0.03, 0.02],
              [0.2, 0.08, 0.04, 0.03, 0.001], time=1.0, standard=standard)


def _species(outdir):
    rng = np.random.default_rng(7)
    clumps = [
        dict(center=(-0.1, 0.0, 0.2), n=2400, rmax=0.06, mass_total=0.15),
        dict(center=(0.3, 0.3, -0.2), n=1200, rmax=0.05, mass_total=0.07),
    ]
    data = make_clumpy_box(rng, n_background=9000, clumps=clumps)
    n = data["pos"].shape[0]
    # interleave species by shuffling particle order, then split gas/dark/star
    perm = rng.permutation(n)
    for k in data:
        data[k] = data[k][perm]
    ngas, nstar = n // 5, n // 7
    write_snapshot(f"{outdir}/snap.bin", data, time=0.5,
                   split=(ngas, n - ngas - nstar, nstar))
    write_gtp(f"{outdir}/cat.gtp", [c["center"] for c in clumps],
              [0.04, 0.035], [0.15, 0.07], time=0.5)
    # mark file: every 3rd particle (1-based indices; kd2.c:158-164)
    idx = np.arange(1, n + 1, 3)
    with open(f"{outdir}/mark.txt", "w") as f:
        f.write(f"{n} {ngas} {nstar}\n")
        f.write("\n".join(str(i) for i in idx) + "\n")


def _flags(outdir):
    rng = np.random.default_rng(13)
    clumps = [
        dict(center=(0.0, 0.0, 0.0), n=2500, rmax=0.07, mass_total=0.2),
        dict(center=(0.3, -0.25, 0.1), n=1500, rmax=0.05, mass_total=0.1),
        dict(center=(-0.3, 0.3, -0.3), n=1000, rmax=0.04, mass_total=0.05),
        dict(center=(0.15, 0.4, 0.4), n=800, rmax=0.04, mass_total=0.04),
    ]
    data = make_clumpy_box(rng, n_background=8000, clumps=clumps)
    write_snapshot(f"{outdir}/snap.bin", data, time=0.8)
    write_gtp(f"{outdir}/cat.gtp", [c["center"] for c in clumps],
              [0.05, 0.04, 0.03, 0.03], [0.2, 0.1, 0.05, 0.04], time=0.8)
    # out-of-order -list subset exercises the .sogtp pointer walk
    with open(f"{outdir}/list.txt", "w") as f:
        f.write("3\n1\n4\n")
    # SKID-style .stat lines for every group: 2 ints + 16 floats + x y z
    centers = [(0.002, 0.001, -0.003), (0.301, -0.252, 0.102),
               (-0.298, 0.301, -0.301), (0.149, 0.401, 0.402)]
    with open(f"{outdir}/stat.txt", "w") as f:
        for g, c in enumerate(centers, 1):
            f.write(f"{g} 10 " + " ".join("0.5" for _ in range(16))
                    + f" {c[0]} {c[1]} {c[2]}\n")


def _errors(outdir, standard=False):
    rng = np.random.default_rng(99)
    clumps = [dict(center=(0.2, 0.2, 0.2), n=2000, rmax=0.06, mass_total=0.25)]
    data = make_clumpy_box(rng, n_background=6000, clumps=clumps)
    write_snapshot(f"{outdir}/snap.bin", data, time=1.0, standard=standard)
    # group 1: normal; group 2: void center, tiny rgtp (-1);
    # group 3: void center, big rgtp so >= nMembers sparse particles (-2);
    # group 4: tiny rgtp inside the clump: dense forever at huge -delta (-3 run)
    write_gtp(f"{outdir}/cat.gtp",
              [(0.2, 0.2, 0.2), (-0.4, -0.4, -0.4), (-0.35, 0.4, -0.4),
               (0.2, 0.2, 0.2)],
              [0.05, 0.004, 0.2, 0.01],
              [0.25, 0.001, 0.002, 0.003], time=1.0, standard=standard)


def _slurp(outdir):
    rng = np.random.default_rng(5)
    # A: extended massive clump with deliberately tiny GTP mass (processed
    # first) -> huge Rvir; B: modest clump centered inside A's Rvir but with
    # dist(A,B) > Rvir_B -> B slurped by A at its first owned particle.
    clumps = [
        dict(center=(0.0, 0.0, 0.0), n=5000, rmax=0.12, mass_total=0.45),
        dict(center=(0.055, 0.0, 0.0), n=700, rmax=0.012, mass_total=0.02),
    ]
    data = make_clumpy_box(rng, n_background=6000, clumps=clumps)
    write_snapshot(f"{outdir}/snap.bin", data, time=1.0)
    write_gtp(f"{outdir}/cat.gtp", [(0.0, 0.0, 0.0), (0.055, 0.0, 0.0)],
              [0.08, 0.01], [0.01, 0.02], time=1.0)


def _ties(outdir):
    rng = np.random.default_rng(21)
    clumps = [
        dict(center=(0.05, 0.05, 0.05), n=1800, rmax=0.05, mass_total=0.12),
        dict(center=(0.08, 0.05, 0.05), n=900, rmax=0.03, mass_total=0.05),
        dict(center=(-0.3, -0.3, 0.3), n=900, rmax=0.03, mass_total=0.05),
        dict(center=(0.02, 0.08, 0.05), n=900, rmax=0.03, mass_total=0.05),
    ]
    data = make_clumpy_box(rng, n_background=7000, clumps=clumps)
    write_snapshot(f"{outdir}/snap.bin", data, time=1.0)
    # three equal GTP masses -> processing order decided by NR indexx ties
    write_gtp(f"{outdir}/cat.gtp", [c["center"] for c in clumps],
              [0.04, 0.025, 0.025, 0.025], [0.12, 0.05, 0.05, 0.05], time=1.0)


def _period(outdir):
    rng = np.random.default_rng(31)
    # clump straddling the periodic boundary; off-center box via -c
    clumps = [
        dict(center=(1.98, 1.0, 1.0), n=2500, rmax=0.1, mass_total=0.3),
        dict(center=(1.0, 1.0, 1.0), n=1200, rmax=0.08, mass_total=0.1),
    ]
    data = make_clumpy_box(rng, n_background=8000, clumps=clumps, box=2.0)
    data["pos"] = ((data["pos"] + 1.0) % 2.0).astype(np.float32)  # [0,2) box
    write_snapshot(f"{outdir}/snap.bin", data, time=1.0)
    write_gtp(f"{outdir}/cat.gtp", [(1.98, 1.0, 1.0), (1.0, 1.0, 1.0)],
              [0.07, 0.06], [0.3, 0.1], time=1.0)


def _period_axes(outdir):
    rng = np.random.default_rng(37)
    # distinct per-axis centers (-cx/-cy/-cz, so.c per-axis parsing); one
    # clump wraps the x boundary of the shifted box
    cx, cy, cz = 1.0, 0.5, -0.25
    c = np.array([cx, cy, cz], np.float32)
    # clump centers in the FINAL (per-axis-shifted) frame; generate in the
    # zero-centered frame and shift+wrap the whole box afterwards
    final_centers = [(cx + 0.98, cy, cz),
                     (cx - 0.4, cy + 0.3, cz - 0.2)]
    clumps = [
        dict(center=tuple(np.asarray(fc) - c), n=n, rmax=rm, mass_total=mt)
        for fc, n, rm, mt in zip(final_centers, (2200, 1100), (0.09, 0.06),
                                 (0.25, 0.1))
    ]
    data = make_clumpy_box(rng, n_background=7000, clumps=clumps, box=2.0)
    data["pos"] = (((data["pos"] + c) - (c - 1.0)) % 2.0
                   + (c - 1.0)).astype(np.float32)
    write_snapshot(f"{outdir}/snap.bin", data, time=1.0)
    write_gtp(f"{outdir}/cat.gtp", final_centers,
              [0.07, 0.05], [0.25, 0.1], time=1.0)


def _uniform(outdir):
    # every particle carries the same f32 mass (the plain N-body regime):
    # exercises the uniform-mass ladder fast path against the reference,
    # where quarter/half-mass crossings land EXACTLY on particle
    # boundaries (member counts divisible by 4) and the Mvir
    # add-then-subtract ulp (kd2.c:810-818) decides the slot
    rng = np.random.default_rng(271)
    clumps = [
        dict(center=(0.1, 0.1, 0.1), n=2800, rmax=0.07, mass_total=0.2),
        dict(center=(-0.2, 0.25, -0.3), n=1400, rmax=0.05, mass_total=0.1),
        dict(center=(0.35, -0.35, 0.3), n=800, rmax=0.04, mass_total=0.05),
    ]
    data = make_clumpy_box(rng, n_background=9000, clumps=clumps)
    n = data["pos"].shape[0]
    data["mass"] = np.full(n, np.float32(1.0 / n))
    write_snapshot(f"{outdir}/snap.bin", data, time=1.0)
    write_gtp(f"{outdir}/cat.gtp",
              [c["center"] for c in clumps] + [(-0.45, -0.45, -0.45)],
              [0.05, 0.04, 0.03, 0.02], [0.2, 0.1, 0.05, 0.001], time=1.0)


def _zoom(outdir):
    # zoom-in multi-species regime (BASELINE.md scale ladder): hi-res
    # gas/dark/star clumps in a heavy lo-res dark background — particle
    # masses span ~2 orders of magnitude across the iOrder species
    # windows, so serial-f32 mass accumulations mix unequal addends
    # (this regime caught the Mvir add-then-subtract ulp, kd2.c:810-818)
    rng = np.random.default_rng(1789)
    data, split, centers, rmax = make_zoom_box(rng, 20000, 4000, 32)
    write_snapshot(f"{outdir}/snap.bin", data, time=1.0, split=split)
    write_gtp(f"{outdir}/cat.gtp", centers, rmax,
              rng.uniform(0.001, 1.0, centers.shape[0]), time=1.0)


SCENARIOS = {
    # name: (generator, reference CLI args after -i/-o, needs_std_io)
    "basic": (_basic, ["-grp", "-gtp", "-subsumed", "-ignored", "-all"], False),
    "std": (lambda d: _basic(d, standard=True), ["-std", "-grp", "-gtp"], True),
    "species": (_species, ["-all", "-mark", "{dir}/mark.txt", "-grp", "-z", "0.5",
                           "-O", "0.3", "-L"], False),
    "flags_list": (_flags, ["-delta", "500", "-M", "0.045", "-list",
                            "{dir}/list.txt", "-m", "16", "-u", "2.2e16", "50",
                            "-grp", "-gtp"], False),
    "flags_stat": (_flags, ["-stat", "{dir}/stat.txt", "-grp", "-gtp"], False),
    "flags_pot": (_flags, ["-pot", "-grp"], False),
    "errors": (_errors, ["-grp", "-gtp"], False),
    "errors_m3": (_errors, ["-delta", "1e-4", "-grp"], False),
    # error codes under XDR: the reference's -std read paths (kd2.c:330-335,
    # 368-371) interacting with unconverted error rows (kd2.c:996-1000)
    "errors_std": (lambda d: _errors(d, standard=True),
                   ["-std", "-grp", "-gtp"], True),
    "errors_m3_std": (lambda d: _errors(d, standard=True),
                      ["-std", "-delta", "1e-4", "-grp"], True),
    # -u unit conversion + user -delta under -std (kd2.c:981-991 with XDR IO)
    "units_std": (lambda d: _basic(d, standard=True),
                  ["-std", "-delta", "500", "-u", "2.2e16", "50",
                   "-grp", "-gtp"], True),
    "slurp": (_slurp, ["-grp", "-gtp", "-subsumed", "-ignored"], False),
    "zoom": (_zoom, ["-all", "-grp", "-gtp", "-subsumed", "-ignored"], False),
    "uniform": (_uniform, ["-all", "-grp", "-gtp", "-subsumed", "-ignored"],
                False),
    "ties": (_ties, ["-grp", "-subsumed", "-ignored"], False),
    "period": (_period, ["-p", "2.0", "-c", "1.0", "-grp"], False),
    # per-axis centers (-cx/-cy/-cz, so.c:338-360) with a boundary clump,
    # plus a small -m (nMembers=4, below the classifier window)
    "period_axes": (_period_axes,
                    ["-p", "2.0", "-cx", "1.0", "-cy", "0.5", "-cz", "-0.25",
                     "-m", "4", "-grp", "-gtp"], False),
}

OUTPUT_FILES = ["sovcirc", "sogrp", "sogtp", "sosub", "soign",
                "sodark", "sogas", "sostar", "somark"]


def generate_inputs(name: str, outdir: str) -> list[str]:
    gen, args, _std = SCENARIOS[name]
    os.makedirs(outdir, exist_ok=True)
    gen(outdir)
    return [a.format(dir=outdir) for a in args]
