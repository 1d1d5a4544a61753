"""Probe: exact slab-footprint totals vs grid level, per halo-radius class.

Evidence base for the per-halo level bucketing cost model
(engine/solver._bucket_levels): on a dense box the occupancy floor forces
one coarse level for the whole batch, inflating every small halo's
CHUNK-aligned footprint into the biggest sort tier.
This script measures, on CPU, the exact cell_ranges totals (the quantity
the capacity tier K must cover) at every level for a spread of ball radii,
so the host-side estimator can be checked against ground truth.

Run: JAX_PLATFORMS=cpu python experiments/level_cost_probe.py [n_particles]
"""

import os
import sys

os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=1")
import jax

jax.config.update("jax_platforms", "cpu")

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import jax.numpy as jnp

from bench import make_box
from so_jax.ops.gather import cell_ranges
from so_jax.ops.grid import build_grid


def main():
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 2 ** 21
    n_halos = int(sys.argv[2]) if len(sys.argv) > 2 else 4096
    rng = np.random.default_rng(12345)
    pos, mass, vel, centers, rgtp = make_box(rng, n, n_halos)
    grid = build_grid(pos, mass, slab=False)
    grid_n = pos.shape[0]
    print(f"n={grid_n} m={grid.m} chunk={grid.chunk} "
          f"occ_by_level={[round(grid_n / (grid.ncell(g) ** 3), 1) for g in range(grid.m + 1)]}")

    radii = (rgtp * np.float32(1.2)).astype(np.float32)
    sel = np.argsort(radii)
    # radius classes: small / median / large
    cls = {
        "p10": sel[int(0.10 * n_halos)],
        "p50": sel[int(0.50 * n_halos)],
        "p90": sel[int(0.90 * n_halos)],
        "max": sel[-1],
    }
    sample = {k: (centers[v], radii[v]) for k, v in cls.items()}

    period = np.asarray(grid.period, np.float32)
    for name, (c, r) in sample.items():
        rows = []
        for g in range(grid.m + 1):
            cs = float(period.min()) / grid.ncell(g)
            span = min(int(2 * r / cs) + 2, grid.ncell(g))
            if span > 11:
                continue
            S = max(span, 1)
            cb = jnp.asarray(c[None, :])
            rb = jnp.asarray(np.array([r], np.float32))
            st, cnt, q, total = cell_ranges(grid, g, cb, rb, rb * rb, S,
                                            align=grid.chunk)
            nruns = int((np.asarray(cnt) > 0).sum())
            cand = int(np.asarray(cnt).sum())
            tot = int(np.asarray(total)[0])
            occ = grid_n / grid.ncell(g) ** 3
            # the estimator under test (mirrors solver._est_foot)
            est = occ * span ** 3 + nruns * grid.chunk
            rows.append((g, S, round(occ), cand, nruns, tot, int(est)))
        print(f"halo {name}: r={float(r):.5f}")
        print("  lvl  S   occ   cand  runs  exact_foot  est")
        for row in rows:
            print(f"  {row[0]:3d} {row[1]:3d} {row[2]:5d} {row[3]:6d} "
                  f"{row[4]:5d} {row[5]:10d} {row[6]:6d}")


if __name__ == "__main__":
    main()
