"""Giant-tier parity comparison: so_jax (GPU) vs the reference (CPU).

The ≥1e5-candidate capacity tiers — the code that OOM'd twice in round 4
(K≥2^18 slab giants, the K>k_slab XLA fallback, and the round-5
whole-box terminal tier for uniform-mass grids) — were only exercised by
ad-hoc scale runs before this script. It builds a
box with one ~1.6e6-particle r^-2 mega-clump (so a handful of halos
escalate straight through every giant tier) on a uniform background,
runs the compiled reference and the so_jax CLI on identical inputs in
TWO mass variants, and diffs every output file:

  general  non-uniform masses: the giant slab tiers (K up to 2^19) and
           the K>k_slab XLA-fallback escalation (smooth2.c:49-55 regrow
           to huge n; kd2.c:765-832 at give-up-bound radii)
  uniform  equal masses: the K=2^20 one-row slab ceiling and the
           whole-box terminal stage (solver._whole_box_stage)

The script ASSERTS the giant paths actually fired (a dispatch spy on
solver._dbg_stage), so a future heuristic change silently rerouting the
giants cannot turn this into a vacuous pass.

Usage: python scripts/compare_reference_giant.py [n_bg] [n_clump] [n_small]
Defaults: 3.4e6 background, 1.6e6 clump, 60 small centers (GPU run).
CPU smoke: python scripts/compare_reference_giant.py 200000 120000 12
(the giant tiers then trigger at proportionally smaller K — the spy
asserts against the actual k_slab ceilings either way).
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

from so_jax.io.tipsy import DARK_DTYPE, TipsyHeader, write_tipsy  # noqa: E402
from tests.fixtures import write_gtp  # noqa: E402


def make_giant_box(rng, n_bg, n_clump):
    """One r^-2 mega-clump holding half the box mass + uniform bg."""
    c = np.array([0.1, -0.05, 0.2], np.float32)
    rmax = 0.08
    r = rmax * rng.uniform(0.0005, 1.0, n_clump)
    u = rng.normal(size=(n_clump, 3))
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    clump = ((c[None, :] + (r[:, None] * u).astype(np.float32) + 0.5)
             % 1.0 - 0.5).astype(np.float32)
    bg = rng.uniform(-0.5, 0.5, (n_bg, 3)).astype(np.float32)
    pos = np.concatenate([bg, clump])
    return pos, c, rmax


def run_variant(tag, pos, mass, centers, rgtp, cat_mass, work, so_bin,
                giant_kind):
    n = pos.shape[0]
    dark = np.zeros(n, DARK_DTYPE[False])
    dark["mass"] = mass
    dark["pos"] = pos
    write_tipsy(f"{work}/snap_{tag}.bin", TipsyHeader(1.0, n, 3, 0, n, 0),
                None, dark, None, False)
    del dark
    write_gtp(f"{work}/cat_{tag}.gtp", centers, rgtp, cat_mass, time=1.0)

    t0 = time.perf_counter()
    with open(f"{work}/snap_{tag}.bin", "rb") as snap:
        r = subprocess.run([so_bin, "-i", f"{work}/cat_{tag}.gtp", "-o",
                            f"{work}/ref_{tag}", "-grp", "-gtp"],
                           stdin=snap, capture_output=True, text=True,
                           cwd=work)
    ref_wall = time.perf_counter() - t0
    assert r.returncode == 0, r.stderr[-2000:]
    m = re.search(r"SO CPU Time:\s+([0-9.]+)", r.stderr)
    ref_solver = float(m.group(1)) if m else float("nan")
    print(f"[{tag}] reference: wall {ref_wall:.1f}s, kdSO {ref_solver:.3f}s",
          flush=True)

    # spy on the solve dispatches so the giant paths PROVABLY fired
    from so_jax.engine import solver

    seen = []
    orig_dbg = solver._dbg_stage

    def spy(name, t0, **kv):
        seen.append((name, int(kv.get("K", 0))))
        return orig_dbg(name, t0, **kv)

    from so_jax.cli import main as so_main

    solver._dbg_stage = spy
    try:
        t0 = time.perf_counter()
        so_main(["-i", f"{work}/cat_{tag}.gtp", "-o", f"{work}/got_{tag}",
                 "--tipsy", f"{work}/snap_{tag}.bin", "-grp", "-gtp",
                 "--verbose"])
        our_wall = time.perf_counter() - t0
    finally:
        solver._dbg_stage = orig_dbg
    print(f"[{tag}] so_jax: wall {our_wall:.1f}s", flush=True)

    if giant_kind == "wbox":
        n_wbox = sum(1 for nm, _ in seen if nm == "wbox")
        assert n_wbox > 0, \
            f"[{tag}] no whole-box dispatch fired: {sorted(set(seen))}"
        print(f"[{tag}] whole-box terminal dispatches: {n_wbox}",
              flush=True)
    else:
        ks = solver.k_slab_max(2)
        giant = [(nm, K) for nm, K in seen
                 if nm == "stage" and K > ks]
        assert giant, (f"[{tag}] no K>{ks} XLA-fallback dispatch fired: "
                       f"{sorted(set(seen))}")
        print(f"[{tag}] giant fallback dispatches: {len(giant)} "
              f"(max K={max(K for _, K in giant)})", flush=True)

    errs = compare_file(f"{work}/ref_{tag}.sovcirc",
                        f"{work}/got_{tag}.sovcirc")
    grp_errs = compare_exact_file(f"{work}/ref_{tag}.sogrp",
                                  f"{work}/got_{tag}.sogrp")
    print(f"[{tag}] sovcirc mismatched lines: {len(errs)}; sogrp exact: "
          f"{'yes' if not grp_errs else 'NO'}", flush=True)
    for e in errs[:8]:
        print(e, flush=True)
    return len(errs) == 0 and not grp_errs


def main(n_bg=3_400_000, n_clump=1_600_000, n_small=60):
    from so_jax.runtime import enable_compile_cache

    enable_compile_cache()
    rng = np.random.default_rng(515151)
    pos, c, rmax = make_giant_box(rng, n_bg, n_clump)
    n = pos.shape[0]
    print(f"# giant box: n={n} clump={n_clump} (candidates at the "
          f"crossing radius ~ the full clump)", flush=True)

    # 4 giant centers on/near the mega-clump (they subsume each other ->
    # conflict coverage at giant j) + small background centers
    giant_c = np.stack([c, c + np.float32(0.004),
                        c - np.float32(0.003),
                        c + np.array([0.006, -0.002, 0.001], np.float32)])
    small_c = rng.uniform(-0.45, 0.45, (n_small, 3)).astype(np.float32)
    centers = np.concatenate([giant_c, small_c]).astype(np.float32)
    rgtp = np.concatenate([np.full(4, 0.02, np.float32),
                           rng.uniform(0.01, 0.05, n_small)
                           .astype(np.float32)])
    cat_mass = rng.uniform(0.001, 1.0, centers.shape[0]).astype(np.float32)

    work = tempfile.mkdtemp(prefix="so_giant_")
    results = {}
    with tempfile.TemporaryDirectory() as build:
        so_bin = build_reference(build)
        mass_u = np.full(n, np.float32(1.0 / n), np.float32)
        # clump carries half the mass in both variants (same crossing
        # radius scale); general = jittered per-particle masses
        mass_g = (rng.uniform(0.5, 1.5, n).astype(np.float32)
                  / np.float32(n))
        results["general"] = run_variant("general", pos, mass_g, centers,
                                         rgtp, cat_mass, work, so_bin,
                                         giant_kind="fallback")
        results["uniform"] = run_variant("uniform", pos, mass_u, centers,
                                         rgtp, cat_mass, work, so_bin,
                                         giant_kind="wbox")

    ok = all(results.values())
    print(f"GIANT COMPARE {'PASS' if ok else 'PARTIAL'} "
          f"(general={results['general']} uniform={results['uniform']})")
    if not ok:
        sys.exit(1)


if __name__ == "__main__":
    a = [int(x) for x in sys.argv[1:4]]
    main(*a)
