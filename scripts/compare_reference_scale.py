"""At-scale parity + speed comparison: so_jax (GPU) vs the reference (CPU).

Generates a 128^3-class clustered snapshot with a few thousand centers,
runs the compiled reference binary and the so_jax CLI on identical inputs,
compares every output, and reports both solver wall times.

Usage: python scripts/compare_reference_scale.py [n_particles] [n_halos]
(requires the reference sources; builds them into a temp dir)
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

sys.path.insert(0, ROOT)
from bench import make_box  # noqa: E402
from so_jax.io.tipsy import DARK_DTYPE, TipsyHeader, write_tipsy  # noqa: E402
from tests.fixtures import write_gtp  # noqa: E402


def main(n_particles=2 ** 21, n_halos=4096):
    from so_jax.runtime import enable_compile_cache

    enable_compile_cache()
    rng = np.random.default_rng(777)
    pos, mass, vel, centers, rgtp = make_box(rng, n_particles, n_halos)
    work = tempfile.mkdtemp(prefix="so_scale_")
    n = pos.shape[0]
    dark = np.zeros(n, DARK_DTYPE[False])
    dark["mass"] = mass
    dark["pos"] = pos
    dark["vel"] = vel
    dark["phi"] = rng.uniform(-2, -0.1, n).astype(np.float32)
    write_tipsy(f"{work}/snap.bin", TipsyHeader(1.0, n, 3, 0, n, 0),
                None, dark, None, False)
    masses = rng.uniform(0.001, 1.0, n_halos).astype(np.float32)
    write_gtp(f"{work}/cat.gtp", centers, rgtp, masses, time=1.0)
    print(f"inputs: {n} particles, {n_halos} centers -> {work}", flush=True)

    with tempfile.TemporaryDirectory() as build:
        so_bin = build_reference(build)
        t0 = time.perf_counter()
        with open(f"{work}/snap.bin", "rb") as snap:
            r = subprocess.run([so_bin, "-i", f"{work}/cat.gtp", "-o",
                                f"{work}/ref", "-grp", "-gtp"],
                               stdin=snap, capture_output=True, text=True, cwd=work)
        ref_wall = time.perf_counter() - t0
    assert r.returncode == 0, r.stderr[-2000:]
    m = re.search(r"SO CPU Time:\s+([0-9.]+)", r.stderr)
    ref_solver = float(m.group(1)) if m else float("nan")
    print(f"reference: wall {ref_wall:.1f}s, kdSO {ref_solver:.3f}s", flush=True)

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
    print(f"SCALE COMPARE {'PASS' if len(errs) == 0 and not grp_errs else 'PARTIAL'} "
          f"(ref kdSO {ref_solver:.2f}s vs so_jax solve phases above)")


if __name__ == "__main__":
    a = [int(x) for x in sys.argv[1:3]]
    main(*a)
