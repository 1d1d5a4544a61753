"""512^3-class parity spot-check: so_jax (GPU) vs the reference (CPU).

Runs BOTH implementations on the exact snapshot experiments/scale512.py
measures (bench.make_box, seed 12345, 1.34e8 particles) with a
subsampled catalog (the reference needs hours for the full 65,536
centers at this N; a subsampled catalog is fine), and
diffs every output file — the same whole-pipeline comparison as
scripts/compare_reference_scale.py (reference: so.c:192-575 main pass)
at the BASELINE.md 512^3 ladder rung.

Usage: python scripts/compare_reference_512.py [n_particles] [n_centers]
Defaults: 512^3 particles, 192 centers. Run detached — the reference
side builds a kd-tree over all 1.34e8 particles on one CPU core and
writes a ~1 GB ASCII .sogrp.
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
from util_compare import compare_exact_file, compare_file  # noqa: E402

from bench import make_box  # noqa: E402
from so_jax.io.tipsy import DARK_DTYPE, TipsyHeader, write_tipsy  # noqa: E402
from tests.fixtures import write_gtp  # noqa: E402


def main(n_particles=512 ** 3, n_centers=192):
    from so_jax.runtime import enable_compile_cache

    enable_compile_cache()
    n_halos = 65536  # the scale512 catalog this subsamples
    t0 = time.perf_counter()
    rng = np.random.default_rng(12345)  # scale512's seed
    pos, mass, vel, centers, rgtp = make_box(rng, n_particles, n_halos)
    print(f"box: generated in {time.perf_counter() - t0:.0f}s", flush=True)

    sub = np.random.default_rng(99).choice(centers.shape[0], n_centers,
                                           replace=False)
    sub.sort()
    centers, rgtp = centers[sub], rgtp[sub]
    gtp_mass = np.random.default_rng(98).uniform(
        0.001, 1.0, n_centers).astype(np.float32)

    work = tempfile.mkdtemp(prefix="so_512cmp_")
    n = pos.shape[0]
    t0 = time.perf_counter()
    dark = np.zeros(n, DARK_DTYPE[False])
    dark["mass"] = mass
    dark["pos"] = pos
    dark["vel"] = vel
    write_tipsy(f"{work}/snap.bin", TipsyHeader(1.0, n, 3, 0, n, 0),
                None, dark, None, False)
    del dark
    write_gtp(f"{work}/cat.gtp", centers, rgtp, gtp_mass, time=1.0)
    print(f"inputs: {n} particles ({os.path.getsize(f'{work}/snap.bin') / 2**30:.2f} GiB), "
          f"{n_centers} centers -> {work} "
          f"({time.perf_counter() - t0:.0f}s)", flush=True)

    with tempfile.TemporaryDirectory() as build:
        so_bin = build_reference(build)
        t0 = time.perf_counter()
        with open(f"{work}/snap.bin", "rb") as snap:
            r = subprocess.run([so_bin, "-i", f"{work}/cat.gtp", "-o",
                                f"{work}/ref", "-grp", "-gtp"],
                               stdin=snap, capture_output=True, text=True,
                               cwd=work)
        ref_wall = time.perf_counter() - t0
    assert r.returncode == 0, r.stderr[-2000:]
    m = re.search(r"SO CPU Time:\s+([0-9.]+)", r.stderr)
    ref_solver = float(m.group(1)) if m else float("nan")
    print(f"reference: wall {ref_wall:.1f}s, kdSO {ref_solver:.3f}s",
          flush=True)

    from so_jax.cli import main as so_main
    t0 = time.perf_counter()
    so_main(["-i", f"{work}/cat.gtp", "-o", f"{work}/got", "--tipsy",
             f"{work}/snap.bin", "-grp", "-gtp", "--verbose"])
    our_wall = time.perf_counter() - t0
    print(f"so_jax: wall {our_wall:.1f}s", flush=True)

    errs = compare_file(f"{work}/ref.sovcirc", f"{work}/got.sovcirc")
    grp_errs = compare_exact_file(f"{work}/ref.sogrp", f"{work}/got.sogrp")
    print(f"sovcirc mismatched lines: {len(errs)}; sogrp exact: "
          f"{'yes' if not grp_errs else 'NO'}", flush=True)
    for e in errs[:8]:
        print(e, flush=True)
    ok = len(errs) == 0 and not grp_errs
    print(f"512 COMPARE {'PASS' if ok else 'PARTIAL'} "
          f"(ref wall {ref_wall:.0f}s / kdSO {ref_solver:.0f}s vs so_jax "
          f"wall {our_wall:.0f}s on the same {n / 1e6:.0f}M-particle box)")


if __name__ == "__main__":
    a = [int(x) for x in sys.argv[1:3]]
    main(*a)
