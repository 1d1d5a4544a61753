"""Microbench: lax.sort cost vs operand count and K on the solve shapes.

Decides the histogram-bisection question with numbers: if the sort is key-bandwidth-bound (1-op ~= 2-op) then operand
reduction is dead; if it scales ~linearly in K then a conservative
bracket that halves the sorted width saves ~half the sort time.

Run: python experiments/sort_microbench.py   (on the card)
"""

import time

import numpy as np


def main():
    import jax

    jax.config.update("jax_enable_x64", True)   # real i64 keys for the
    #                                             packed-key variant
    import jax.numpy as jnp

    from so_jax.runtime import enable_compile_cache

    enable_compile_cache()

    rng = np.random.default_rng(0)
    B = 16384

    def timed(fn, *args, reps=5):
        jax.block_until_ready(fn(*args))        # compile
        ts = []
        for _ in range(reps):
            t0 = time.perf_counter()
            jax.block_until_ready(fn(*args))
            ts.append(time.perf_counter() - t0)
        return min(ts)

    for K in (2048, 4096, 8192):
        ops = [jnp.asarray(rng.random((B, K), np.float32)) for _ in range(4)]

        for n_ops in (1, 2, 4):
            f = jax.jit(lambda *a: jax.lax.sort(a, num_keys=1,
                                                is_stable=False))
            dt = timed(f, *ops[:n_ops])
            print(f"K={K} ops={n_ops}: {dt * 1e3:7.2f} ms")
        # the i64 packed-key variant: one operand, key<<32 | payload bits
        pk = (ops[0].view(jnp.int32).astype(jnp.int64) << 32) | \
            ops[1].view(jnp.int32).astype(jnp.int64).astype(jnp.uint32).astype(jnp.int64)
        f64 = jax.jit(lambda a: jax.lax.sort((a,), num_keys=1,
                                             is_stable=False))
        dt = timed(f64, pk)
        print(f"K={K} i64-packed: {dt * 1e3:7.2f} ms")


if __name__ == "__main__":
    main()
