"""Part 2 of the fused-stage decomposition: where does the member
packing time go, and what does decode-before-sort save?

Pieces (same bench grid/tier as experiments/fused_breakdown.py):
  g+mask        gather + interior mask (returns masked srow)
  g+pack        + _pack_prefix (packed grid rows, counts)
  g+pack+tr     + orig_idx translate (the production member output)
  g2op          gather variant: decode ilo/ihi -> i32 BEFORE the sort
                (2-operand sort instead of 3)
  g2op+p+tr     the 2-op variant with pack + translate
"""

import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp

from so_jax.runtime import enable_compile_cache  # noqa: E402

enable_compile_cache()

from functools import partial

from bench import make_box
from so_jax.engine.members import _pack_prefix
from so_jax.engine.solver import (_foot_stage, _pad_b, _pick_level_span,
                                  _stage_grid, k_slab_max, solve_rvir)
from so_jax.ops import build_grid
from so_jax.ops.gather import cell_ranges, slab_gather
from so_jax.ops.slab import decode_idx, slab_slots


def sync(o):
    jax.block_until_ready(o)


def timeit(name, f, *a):
    o = f(*a)
    sync(o)
    ts = []
    for _ in range(3):
        t0 = time.perf_counter()
        o = f(*a)
        sync(o)
        ts.append(time.perf_counter() - t0)
    print(f"{name:12s} {min(ts) * 1e3:8.1f} ms  (reps: "
          + ", ".join(f"{t * 1e3:.1f}" for t in ts) + ")", flush=True)
    return o


def main():
    rng = np.random.default_rng(12345)
    pos, mass, vel, centers, rgtp = make_box(rng, 2 ** 21, 16384)
    grid = build_grid(pos, mass, vel=vel)
    res = solve_rvir(grid, centers, rgtp, 178.0)
    ok = res.code == 0
    c = np.asarray(centers[ok], np.float32)
    rv = np.asarray(res.rvir[ok], np.float32)
    jj = np.asarray(res.j[ok], np.int64)

    g0, S0 = _pick_level_span(grid, 2.0 * float(np.max(rv)), 7)
    G = c.shape[0]
    Bp = _pad_b(G, 4096)
    c_pad0 = np.zeros((Bp, 3), np.float32)
    r_pad0 = np.full(Bp, 1e-30, np.float32)
    c_pad0[:G] = c
    r_pad0[:G] = 2.0 * rv
    foot = np.asarray(_foot_stage(grid, g0, S0, jnp.asarray(c_pad0),
                                  jnp.asarray(r_pad0)))[:G]
    est = np.maximum(foot.astype(np.int64), 256)
    need = 2 ** np.ceil(np.log2(est)).astype(np.int64)
    sel = np.nonzero(need <= 4096)[0]

    K, S, level = 4096, S0, g0
    B = _pad_b(sel.size, K, k_slab_max(3))
    c_pad = np.zeros((B, 3), np.float32)
    j_pad = np.zeros(B, np.int32)
    c_pad[:sel.size] = c[sel]
    j_pad[:sel.size] = jj[sel]
    fb = np.full(B, 1e-30, np.float32)
    fb[:sel.size] = 2.0 * rv[sel]
    cap = 1 << int(np.ceil(np.log2(max(int(jj[sel].sum()) + 8 * sel.size,
                                       1024))))
    cap = int(min(cap, B * K))
    print(f"B={B} K={K} S={S} level={level} cap={cap}")

    sg = _stage_grid(grid, K, k_slab_max(3))
    cj = jnp.asarray(c_pad)
    jjx = jnp.asarray(j_pad)
    fbj = jnp.asarray(fb)
    fb2j = jnp.asarray(fb * fb)

    slot = jnp.arange(K, dtype=jnp.int32)[None, :]

    @partial(jax.jit, static_argnames=("level", "K", "S"))
    def f_gmask(g, level, K, S, cc, rr, r2, j):
        sgr = slab_gather(g, level, cc, rr, r2, K, S, channels=("idx",))
        srow = sgr.channels[-1]
        interior = (slot < j[:, None]) & jnp.isfinite(sgr.d2) & (srow >= 0)
        return jnp.where(interior, srow, -1), \
            jnp.minimum(j.astype(jnp.int32), sgr.n_in)

    @partial(jax.jit, static_argnames=("level", "K", "S", "cap"))
    def f_gpack(g, level, K, S, cap, cc, rr, r2, j):
        sgr = slab_gather(g, level, cc, rr, r2, K, S, channels=("idx",))
        srow = sgr.channels[-1]
        interior = (slot < j[:, None]) & jnp.isfinite(sgr.d2) & (srow >= 0)
        counts = jnp.minimum(j.astype(jnp.int32), sgr.n_in)
        return _pack_prefix(jnp.where(interior, srow, -1), counts, cap)

    @partial(jax.jit, static_argnames=("level", "K", "S", "cap"))
    def f_gpacktr(g, level, K, S, cap, cc, rr, r2, j):
        sgr = slab_gather(g, level, cc, rr, r2, K, S, channels=("idx",))
        srow = sgr.channels[-1]
        interior = (slot < j[:, None]) & jnp.isfinite(sgr.d2) & (srow >= 0)
        counts = jnp.minimum(j.astype(jnp.int32), sgr.n_in)
        packed_rows, counts = _pack_prefix(jnp.where(interior, srow, -1),
                                           counts, cap)
        packed = jnp.where(packed_rows >= 0,
                           g.orig_idx[jnp.clip(packed_rows, 0, g.n - 1)],
                           -1)
        return packed, counts

    def g2op_gather(g, level, K, S, cc, rr, r2):
        """slab gather with the idx pair decoded BEFORE the sort."""
        st, cnt, q, total = cell_ranges(g, level, cc, rr, r2, S,
                                        align=g.chunk)
        out = slab_slots(g.soa8t, st, cnt, q, cc, g.period, r2, K,
                                 chans=("ilo", "ihi"), CHUNK=g.chunk)
        d2 = out[:, 0, :]
        idx = decode_idx(out[:, 1, :], out[:, 2, :])
        d2_s, idx_s = jax.lax.sort((d2, idx), num_keys=1, is_stable=False)
        n_in = jnp.isfinite(d2).sum(axis=1).astype(jnp.int32)
        return d2_s, idx_s, n_in, total > K

    @partial(jax.jit, static_argnames=("level", "K", "S"))
    def f_g2op(g, level, K, S, cc, rr, r2):
        return g2op_gather(g, level, K, S, cc, rr, r2)

    @partial(jax.jit, static_argnames=("level", "K", "S", "cap"))
    def f_g2op_ptr(g, level, K, S, cap, cc, rr, r2, j):
        d2_s, srow, n_in, ovf = g2op_gather(g, level, K, S, cc, rr, r2)
        interior = (slot < j[:, None]) & jnp.isfinite(d2_s) & (srow >= 0)
        counts = jnp.minimum(j.astype(jnp.int32), n_in)
        packed_rows, counts = _pack_prefix(jnp.where(interior, srow, -1),
                                           counts, cap)
        packed = jnp.where(packed_rows >= 0,
                           g.orig_idx[jnp.clip(packed_rows, 0, g.n - 1)],
                           -1)
        return packed, counts

    timeit("g+mask", f_gmask, sg, level, K, S, cj, fbj, fb2j, jjx)
    timeit("g+pack", f_gpack, sg, level, K, S, cap, cj, fbj, fb2j, jjx)
    timeit("g+pack+tr", f_gpacktr, sg, level, K, S, cap, cj, fbj, fb2j, jjx)
    timeit("g2op", f_g2op, sg, level, K, S, cj, fbj, fb2j)
    timeit("g2op+p+tr", f_g2op_ptr, sg, level, K, S, cap, cj, fbj, fb2j, jjx)


if __name__ == "__main__":
    main()
