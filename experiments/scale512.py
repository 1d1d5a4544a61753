"""512^3-class single-card scale run (BASELINE.md scale-ladder config).

Generates a 512^3-scale clustered box (default 1.34e8 particles), builds
the deduplicated grid on one card, solves 65,536 centers at Delta=178,
then the multi-threshold profile config (BASELINE.md ladder: "512^3
multi-threshold profiles"; deltas 178/200/500), and reports:

  - device memory in use after the build (the steady-state budget) and
    the allocator peak (the build peak)
  - grid build wall, cold and warm
  - solve wall, solves/sec, dispatch count
  - candidate distance evals/sec (solver.EVAL_SLOTS delta per rep) —
    the BASELINE.md secondary metric "particle-distance evals/sec on a
    512^3 snapshot" (each B*K slot buffer row gets one d2 against its
    halo center; reference counterpart: the per-candidate dx2 loop in
    smooth2.c:88-106)

Run: python experiments/scale512.py
Smaller dry runs: python experiments/scale512.py <n_particles> <n_halos>
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import jax
import jax.numpy as jnp

from so_jax.runtime import enable_compile_cache  # noqa: E402

enable_compile_cache()

from bench import make_box
from so_jax.engine import solver
from so_jax.engine.multi import solve_rvir_multi
from so_jax.engine.solver import solve_rvir
from so_jax.ops import build_grid


def sync(a):
    jax.block_until_ready(a)


def mem_gb():
    """(in_use_GiB, peak_GiB) as strings, 'n/a' where the backend has no
    memory_stats()."""
    try:
        st = jax.devices()[0].memory_stats()
    except Exception:
        st = None
    if not st:
        return "n/a", "n/a"
    return (f"{st.get('bytes_in_use', 0) / 2**30:.2f}",
            f"{st.get('peak_bytes_in_use', 0) / 2**30:.2f}")


def main():
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 512 ** 3
    n_halos = int(sys.argv[2]) if len(sys.argv) > 2 else 65536
    print(f"# scale512: n={n} halos={n_halos} "
          f"device={jax.devices()[0].device_kind}", flush=True)

    t0 = time.perf_counter()
    rng = np.random.default_rng(12345)
    pos, mass, vel, centers, rgtp = make_box(rng, n, n_halos)
    print(f"gen: {time.perf_counter() - t0:.1f}s "
          f"({pos.shape[0]} particles, {pos.nbytes / 2**30:.2f} GiB pos)",
          flush=True)

    grid = None
    for tag in ("cold", "warm"):
        # drop the previous grid BEFORE rebuilding: at 512^3 the payload
        # is ~4.5 GiB, and the cold grid kept alive through the warm build
        # fragments device memory
        grid = None
        t0 = time.perf_counter()
        grid = build_grid(pos, mass, vel=vel)
        sync(grid.soa8t if grid.soa8t is not None else grid.mass)
        sync(grid.orig_idx)
        dt = time.perf_counter() - t0
        used, peak = mem_gb()
        print(f"grid build ({tag}): {dt:.1f}s  HBM in use "
              f"{used} GiB, peak {peak} GiB", flush=True)

    thr = 178.0
    t0 = time.perf_counter()
    res = solve_rvir(grid, centers, rgtp, thr)
    print(f"solve warmup (compiles): {time.perf_counter() - t0:.1f}s",
          flush=True)

    reps, disp, evals = [], [], []
    for _ in range(3):
        d0, e0 = solver.DISPATCHES, solver.EVAL_SLOTS
        t0 = time.perf_counter()
        res = solve_rvir(grid, centers, rgtp, thr)
        reps.append(time.perf_counter() - t0)
        disp.append(solver.DISPATCHES - d0)
        evals.append(solver.EVAL_SLOTS - e0)
    best = int(np.argmin(reps))
    ok = int((res.code == 0).sum())
    codes = np.bincount(-res.code[res.code <= 0], minlength=4).tolist()
    print(f"solve: best {reps[best]:.3f}s of {[f'{r:.3f}' for r in reps]} = "
          f"{n_halos / reps[best]:.0f} solves/s  dispatches={disp[best]} "
          f"ok={ok} codes={codes}", flush=True)
    print(f"distance evals: {evals[best] / 1e9:.2f}e9 slots/rep = "
          f"{evals[best] / reps[best] / 1e9:.2f}e9 evals/s", flush=True)
    used, peak = mem_gb()
    print(f"post-solve HBM: in use {used} GiB, peak {peak} GiB", flush=True)

    # multi-threshold profiles (the ladder's 512^3 config)
    thresholds = [178.0, 200.0, 500.0]
    t0 = time.perf_counter()
    multi = solve_rvir_multi(grid, centers, rgtp, thresholds)
    print(f"multi-threshold warmup: {time.perf_counter() - t0:.1f}s",
          flush=True)
    t0 = time.perf_counter()
    multi = solve_rvir_multi(grid, centers, rgtp, thresholds)
    dt = time.perf_counter() - t0
    nres = int((multi.code == 0).sum())
    print(f"multi-threshold x{len(thresholds)}: {dt:.3f}s = "
          f"{n_halos * len(thresholds) / dt:.0f} (threshold,halo)/s  "
          f"resolved={nres}", flush=True)
    used, peak = mem_gb()
    print(f"final HBM: in use {used} GiB, peak {peak} GiB", flush=True)


if __name__ == "__main__":
    main()
