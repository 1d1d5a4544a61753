"""Benchmark: halo R_Delta solves/sec on one device.

Synthetic cosmological boxes (uniform background + clustered r^-2 halos),
solved with the production batched engine, across three regimes:

  standard  2^21 particles / 16,384 halos   (solve + e2e pipeline)
  dense     2^23 particles / 65,536 halos   (solve + e2e pipeline)
  survey    2^25 particles / 1,000,000 halos (auto-survey solve)

Prints ONE JSON line: the headline metric/value/unit (standard-box solve
rate) and a "rows" list with every regime's numbers. Every row names the
device it ran on (platform, device_kind, device count) and, on an NVIDIA
card, its name and power limit from nvidia-smi. Times end in
jax.block_until_ready or a host fetch of the result.

SO_BENCH_MODE: "all" (default) | "standard" | "dense" | "survey" | "e2e"
("e2e" = standard box only, headline the end-to-end pipeline rate).
"""

import gc
import json
import os
import subprocess
import sys
import time

import numpy as np


def make_box(rng, n_particles, n_halos):
    """Clustered box: half the mass in r^-2 halos, half uniform."""
    n_clumped = n_particles // 2
    n_bg = n_particles - n_clumped
    # halo sizes: power-law-ish distribution over the requested halo count
    sizes = rng.pareto(1.5, n_halos) + 1.0
    sizes = np.maximum((sizes / sizes.sum() * n_clumped).astype(np.int64), 24)
    centers = rng.uniform(-0.5, 0.5, (n_halos, 3)).astype(np.float32)
    # rmax such that the clump is a genuine overdensity (edge density well
    # above the Delta=178 threshold for a particle mass of 1/N)
    rmax = (0.0012 * sizes.astype(np.float64) ** (1 / 3)).astype(np.float32)

    chunks = [rng.uniform(-0.5, 0.5, (n_bg, 3)).astype(np.float32)]
    for c, n, rm in zip(centers, sizes, rmax):
        r = rm * rng.uniform(0.001, 1.0, n)
        u = rng.normal(size=(n, 3))
        u /= np.linalg.norm(u, axis=1, keepdims=True)
        p = c[None, :] + (r[:, None] * u).astype(np.float32)
        chunks.append(((p + 0.5) % 1.0 - 0.5).astype(np.float32))
    pos = np.concatenate(chunks)
    n_tot = pos.shape[0]
    mass = np.full(n_tot, 1.0 / n_tot, np.float32)
    vel = np.zeros((n_tot, 3), np.float32)
    rgtp = np.maximum(rmax, 0.001).astype(np.float32)
    return pos, mass, vel, centers, rgtp


def device_fields():
    """The device every row names: JAX's platform, device_kind and count,
    and nvidia-smi's card name and power limit where there is a card."""
    import jax

    d = jax.devices()[0]
    out = {"platform": d.platform, "device_kind": d.device_kind,
           "device_count": len(jax.devices())}
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"],
                           capture_output=True, text=True, timeout=60)
        if r.returncode == 0 and r.stdout.strip():
            name, limit = r.stdout.strip().splitlines()[0].split(",", 1)
            out.update(card=name.strip(), power_limit=limit.strip())
    except (OSError, subprocess.TimeoutExpired):
        pass
    return out


def bench_box(tag, n_particles, n_halos, survey, do_e2e, seed=12345):
    """One regime: build the box + grid, time the solve (best of reps),
    optionally the full pipeline. Returns the row dict for the JSON
    artifact."""
    import jax

    from so_jax.engine import solver as _solver
    from so_jax.engine.solver import solve_rvir
    from so_jax.ops import build_grid

    t0 = time.perf_counter()
    rng = np.random.default_rng(seed)
    pos, mass, vel, centers, rgtp = make_box(rng, n_particles, n_halos)
    gen_s = time.perf_counter() - t0
    rng = np.random.default_rng(seed + 1)   # catalog-mass draws (e2e)

    def timed_build():
        t0 = time.perf_counter()
        g = build_grid(pos, mass, vel=vel)
        jax.block_until_ready(g)
        return g, time.perf_counter() - t0

    # the cold build includes any uncached compiles; the warm rebuild is
    # the steady-state cost
    grid, build_cold_s = timed_build()
    grid, build_s = timed_build()

    thr = 178.0
    # warmup: compiles every tier this workload touches
    t0 = time.perf_counter()
    res = solve_rvir(grid, centers, rgtp, thr, survey=survey)
    warm_s = time.perf_counter() - t0

    # best of reps; the giant survey box gets 2 reps to keep the run
    # bounded. solve_rvir returns host arrays, so each rep ends synced.
    n_reps = 5 if n_halos <= (1 << 17) else 2
    reps = []
    disp = []
    for _ in range(n_reps):
        d0 = _solver.DISPATCHES
        t0 = time.perf_counter()
        res = solve_rvir(grid, centers, rgtp, thr, survey=survey)
        reps.append(time.perf_counter() - t0)
        disp.append(_solver.DISPATCHES - d0)
    solve_s = min(reps)

    ok = int((res.code == 0).sum())
    rate = n_halos / solve_s
    print(f"# [{tag}] particles={pos.shape[0]} halos={n_halos} ok={ok} "
          f"codes={np.bincount(-res.code[res.code<=0], minlength=4).tolist()} "
          f"gen={gen_s:.1f}s grid={build_s:.1f}s (cold {build_cold_s:.1f}s) "
          f"warm={warm_s:.1f}s "
          f"solve={solve_s:.3f}s (reps: "
          f"{', '.join(f'{r:.3f}' for r in reps)}) "
          f"dispatches={disp[-1]} device={jax.devices()[0].device_kind}",
          file=sys.stderr)

    row = {
        "tag": tag,
        **device_fields(),
        "particles": int(pos.shape[0]),
        "halos": int(n_halos),
        "grid_s": round(build_s, 4),
        "solve_s": round(solve_s, 4),
        "solves_per_sec": round(rate, 1),
        "dispatches": int(disp[-1]),
    }

    # full pipeline (solve -> members+derived -> conflicts -> stats): the
    # end-to-end rate the reference's single wall-clock number compares to
    if do_e2e:
        from so_jax.engine import SOParams, run_so
        from so_jax.io.catalogs import GroupCatalog
        from so_jax.io.tipsy import ParticleSet, TipsyHeader

        n_tot = pos.shape[0]
        hdr = TipsyHeader(time=1.0, nbodies=n_tot, ndim=3, nsph=0,
                          ndark=n_tot, nstar=0)
        ps = ParticleSet(hdr, pos, vel, mass, np.zeros(n_tot, np.float32),
                         np.zeros(n_tot, np.float32))
        gtp_mass = rng.uniform(0.001, 1.0, n_halos).astype(np.float32)
        params = SOParams(threshold=thr, survey=survey,
                          verbose=bool(os.environ.get("SO_BENCH_VERBOSE")))

        def one_run():
            cat = GroupCatalog(
                index=np.arange(1, n_halos + 1, dtype=np.int32),
                pos=centers.copy(), rgtp=rgtp, gtp_mass=gtp_mass,
                n_in_gtp=n_halos, gtp_time=1.0)
            return run_so(ps, cat, params, grid=grid)

        one_run()                       # warmup (compiles post-solve stages)
        e2e_reps = []
        for _ in range(2):
            t0 = time.perf_counter()
            one_run()
            e2e_reps.append(time.perf_counter() - t0)
        e2e_s = min(e2e_reps)
        row["e2e_s"] = round(e2e_s, 4)
        row["e2e_halos_per_sec"] = round(n_halos / e2e_s, 1)
        print(f"# [{tag}] e2e: full pipeline {e2e_s:.3f}s = "
              f"{n_halos / e2e_s:.0f} halos/s "
              f"(solve+members+derived+conflicts+stats)", file=sys.stderr)

    # free this regime's device buffers before the next
    del grid, res
    gc.collect()
    return row


def main():
    from so_jax.runtime import enable_compile_cache

    enable_compile_cache()

    mode = os.environ.get("SO_BENCH_MODE", "all")
    # explicit size overrides pin the run to ONE custom standard-shaped box
    custom = ("SO_BENCH_PARTICLES" in os.environ
              or "SO_BENCH_HALOS" in os.environ)
    n_particles = int(os.environ.get("SO_BENCH_PARTICLES", 2 ** 21))
    n_halos = int(os.environ.get("SO_BENCH_HALOS", 16384))
    survey_std = True if os.environ.get("SO_BENCH_SURVEY") == "1" else None

    rows = []
    if mode in ("all", "standard", "e2e") or custom:
        rows.append(bench_box("standard", n_particles, n_halos, survey_std,
                              do_e2e=os.environ.get("SO_BENCH_E2E",
                                                    "1") != "0"))
    if mode in ("all", "dense") and not custom:
        rows.append(bench_box("dense", 2 ** 23, 65536, survey_std,
                              do_e2e=os.environ.get("SO_BENCH_E2E",
                                                    "1") != "0"))
    if mode in ("all", "survey") and not custom:
        # 2^25-particle request clamps to ~46.1M with the >=24/halo floor;
        # survey=None exercises the auto-gate (the production default)
        rows.append(bench_box("survey", 2 ** 25, 1_000_000, survey_std,
                              do_e2e=False))

    head = rows[0]
    out = {
        "metric": "halo_rvir_solves_per_sec",
        "value": head["solves_per_sec"],
        "unit": "solves/sec",
        "rows": rows,
    }
    if mode == "e2e" and "e2e_halos_per_sec" in head:
        out.update(metric="e2e_pipeline_halos_per_sec",
                   value=head["e2e_halos_per_sec"],
                   unit="halos/sec")
    print(json.dumps(out))


if __name__ == "__main__":
    main()
