"""Zoom-in multi-species at-scale parity + speed comparison.

Covers the BASELINE.md scale-ladder config "zoom-in multi-species": a
high-resolution sub-volume (gas+dark+star, light particles, clustered
r^-2 halos) embedded in a low-resolution background of heavy dark
particles — the standard zoom-in construction, with particle masses
spanning ~2 orders of magnitude. This stresses exactly what the
dark-only bench box does not: the iOrder species windows
(reference kd2.c:135-141), per-species cumulative mass profiles
(kd2.c:458-496) through the fused members+derived pass, and density
scans whose cumulative mass is dominated by occasional heavyweight
background hits rather than uniform-mass counts.

Runs the compiled reference and the so_jax CLI with
``-all -grp -gtp -subsumed -ignored`` on identical inputs and compares
every output file (.sovcirc/.sodark/.sogas/.sostar float-tolerant,
.sogrp/.sosub/.soign exact, .sogtp field-aware).

Usage: python scripts/compare_reference_zoom.py [n_hi] [n_lo] [n_halos]
Defaults are the at-scale config (6.3M hi-res + 1M lo-res, 4096 centers);
pass small values for a CPU smoke run.
"""

from __future__ import annotations

import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tests"))

from make_goldens import build_reference  # noqa: E402
from util_compare import (compare_exact_file, compare_file,  # noqa: E402
                          compare_sogtp)

from fixtures import make_zoom_box, write_gtp, write_snapshot  # noqa: E402


FLAGS = ["-all", "-grp", "-gtp", "-subsumed", "-ignored"]
OUTS = ["sovcirc", "sodark", "sogas", "sostar", "sogrp", "sogtp",
        "sosub", "soign"]
EXACT = {"sogrp", "sosub", "soign"}


def main(n_hi=6 << 20, n_lo=1 << 20, n_halos=4096):
    from so_jax.runtime import enable_compile_cache

    enable_compile_cache()
    rng = np.random.default_rng(2026)
    t0 = time.perf_counter()
    data, split, centers, rmax = make_zoom_box(rng, n_hi, n_lo, n_halos,
                                               verbose=True)
    work = tempfile.mkdtemp(prefix="so_zoom_")
    write_snapshot(f"{work}/snap.bin", data, time=1.0, split=split)
    gtp_mass = rng.uniform(0.001, 1.0, n_halos).astype(np.float32)
    write_gtp(f"{work}/cat.gtp", centers, rmax, gtp_mass, time=1.0)
    print(f"inputs written in {time.perf_counter() - t0:.1f}s -> {work}",
          flush=True)

    with tempfile.TemporaryDirectory() as build:
        so_bin = build_reference(build)
        t0 = time.perf_counter()
        with open(f"{work}/snap.bin", "rb") as snap:
            r = subprocess.run([so_bin, "-i", f"{work}/cat.gtp", "-o",
                                f"{work}/ref"] + FLAGS, stdin=snap,
                               capture_output=True, text=True, cwd=work)
        ref_wall = time.perf_counter() - t0
    assert r.returncode == 0, r.stderr[-2000:]
    m = re.search(r"SO CPU Time:\s+([0-9.]+)", r.stderr)
    ref_solver = float(m.group(1)) if m else float("nan")
    print(f"reference: wall {ref_wall:.1f}s, kdSO {ref_solver:.3f}s",
          flush=True)

    from so_jax.cli import main as so_main
    t0 = time.perf_counter()
    so_main(["-i", f"{work}/cat.gtp", "-o", f"{work}/got", "--tipsy",
             f"{work}/snap.bin", "--verbose"] + FLAGS)
    our_wall = time.perf_counter() - t0
    print(f"so_jax: wall {our_wall:.1f}s", flush=True)

    errs = []
    for ext in OUTS:
        gpath, opath = f"{work}/ref.{ext}", f"{work}/got.{ext}"
        if ext == "sogtp":
            e = compare_sogtp(gpath, opath, False)
        elif ext in EXACT:
            e = compare_exact_file(gpath, opath)
        else:
            e = compare_file(gpath, opath)
        print(f"  {ext}: {'OK' if not e else f'{len(e)} mismatches'}",
              flush=True)
        errs += e
    for e in errs[:8]:
        print(e, flush=True)
    print(f"ZOOM COMPARE {'PASS' if not errs else 'FAIL'} "
          f"(ref kdSO {ref_solver:.2f}s, ref wall {ref_wall:.1f}s, "
          f"so_jax wall {our_wall:.1f}s)")
    return 0 if not errs else 1


if __name__ == "__main__":
    a = [int(x) for x in sys.argv[1:4]]
    sys.exit(main(*a))
