"""Grid-build phase breakdown on the real device.

Separates the grid build into upload, Morton build (_build_device), CSR
starts, and the slab payload pack, so the build cost can be attributed.

Run: python experiments/grid_build_probe.py [n_particles]
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
from so_jax.ops.grid import _build_device, choose_chunk, choose_m
from so_jax.ops.slab import pack_soa8t


def sync(a):
    jax.block_until_ready(a)


def main():
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 2 ** 21
    rng = np.random.default_rng(12345)
    pos, mass, vel, centers, rgtp = make_box(rng, n, 4096)
    n = pos.shape[0]
    m = choose_m(n)
    chunk = choose_chunk(n, m)
    lo = jnp.asarray(np.full(3, -0.5, np.float32))
    period = jnp.asarray(np.ones(3, np.float32))
    phi = np.zeros(n, np.float32)
    ptype = np.zeros(n, np.int32)
    mark = np.zeros(n, bool)

    for rep in range(2):
        t0 = time.perf_counter()
        dp = [jax.device_put(a) for a in (pos, mass, vel, phi, ptype, mark)]
        for a in dp:
            sync(a)
        t_up = time.perf_counter() - t0

        t0 = time.perf_counter()
        out = _build_device(m, lo, period, *dp)
        sync(out[0]); sync(out[1]); sync(out[6])
        for s in out[7]:
            sync(s)
        t_build = time.perf_counter() - t0

        t0 = time.perf_counter()
        soa = jax.jit(pack_soa8t, static_argnames=("chunk",))(
            out[0], out[1], out[2], out[4], out[5], chunk=chunk)
        sync(soa)
        t_pack = time.perf_counter() - t0
        print(f"rep{rep}: n={n} m={m} chunk={chunk} upload={t_up:.2f}s "
              f"build={t_build:.2f}s pack={t_pack:.2f}s "
              f"total={t_up + t_build + t_pack:.2f}s", flush=True)


if __name__ == "__main__":
    main()
