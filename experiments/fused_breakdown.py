"""Decompose the fused members+derived stage's device time at the bench
shape (B=16384, K=4096, uniform-mass 2M box) — which piece of
engine.fused._fused_stage costs what.

Pieces timed (each its own jit, warm best-of-3, block_until_ready):
  cellranges   cell_ranges alone (merged-run enumeration)
  kernel       cell_ranges + slab_slots (no sort)
  gather       slab_gather = kernel + 3-op sort (d2, ilo, ihi) + decode
  g+derived    gather + derived_from_sorted
  full         _fused_stage (adds _pack_prefix + orig_idx translate)
  solve-ref    the production solve dispatch for scale (same B, K)

Run: python experiments/fused_breakdown.py
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

from bench import make_box
from functools import partial

from so_jax.engine.fused import _fused_stage
from so_jax.engine.derived import derived_from_sorted
from so_jax.engine.solver import solve_rvir, _foot_stage, _pick_level_span, \
    _pad_b, k_slab_max, _stage_grid
from so_jax.ops import build_grid
from so_jax.ops.gather import cell_ranges, slab_gather


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
    mv = np.asarray(res.mvir[ok], np.float32)

    # replicate the fused tier-1 selection: probe footprints at 2*rvir
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
    print(f"tier-1 halos: {sel.size} / {G}")

    K, S, level = 4096, S0, g0
    B = _pad_b(sel.size, K, k_slab_max(3))
    c_pad = np.zeros((B, 3), np.float32)
    r_pad = np.full(B, 1e-30, np.float32)
    j_pad = np.zeros(B, np.int32)
    m_pad = np.ones(B, np.float32)
    c_pad[:sel.size] = c[sel]
    r_pad[:sel.size] = rv[sel]
    j_pad[:sel.size] = jj[sel]
    m_pad[:sel.size] = mv[sel]
    cap = 1 << int(np.ceil(np.log2(max(int(jj[sel].sum()) + 8 * sel.size,
                                       1024))))
    cap = int(min(cap, B * K))
    print(f"B={B} K={K} S={S} level={level} cap={cap}")

    sg = _stage_grid(grid, K, k_slab_max(3))
    cj, rj = jnp.asarray(c_pad), jnp.asarray(r_pad)
    jjx, mjx = jnp.asarray(j_pad), jnp.asarray(m_pad)
    fb = 2.0 * r_pad
    fbj = jnp.asarray(fb)
    fb2j = jnp.asarray(fb * fb)

    @partial(jax.jit, static_argnames=("level", "S"))
    def f_cellranges(g, level, S, cc, rr, r2):
        return cell_ranges(g, level, cc, rr, r2, S, align=g.chunk)

    @partial(jax.jit, static_argnames=("level", "K", "S"))
    def f_kernel(g, level, K, S, cc, rr, r2):
        from so_jax.ops.slab import slab_slots
        st, cnt, q, total = cell_ranges(g, level, cc, rr, r2, S,
                                        align=g.chunk)
        return slab_slots(g.soa8t, st, cnt, q, cc, g.period, r2, K,
                                  chans=("ilo", "ihi"), CHUNK=g.chunk)

    @partial(jax.jit, static_argnames=("level", "K", "S"))
    def f_gather(g, level, K, S, cc, rr, r2):
        return slab_gather(g, level, cc, rr, r2, K, S, channels=("idx",))

    @partial(jax.jit, static_argnames=("level", "K", "S", "n_members"))
    def f_gder(g, level, K, S, n_members, cc, rvir, mvir, rr, r2):
        sgr = slab_gather(g, level, cc, rr, r2, K, S, channels=("idx",))
        ptype_s = jnp.zeros_like(sgr.d2, jnp.int32)
        mark_s = jnp.zeros_like(sgr.d2, bool)
        return derived_from_sorted(sgr.d2, None, ptype_s, mark_s, sgr.n_in,
                                   rvir, mvir, rr, n_members, (),
                                   jnp.float32(1.0),
                                   uniform_m=g.uniform_mass)["vcirc"]

    timeit("cellranges", f_cellranges, sg, level, S, cj, fbj, fb2j)
    timeit("kernel", f_kernel, sg, level, K, S, cj, fbj, fb2j)
    timeit("gather", f_gather, sg, level, K, S, cj, fbj, fb2j)
    timeit("g+derived", f_gder, sg, level, K, S, 8, cj, rj, mjx, fbj, fb2j)
    timeit("full", lambda *a: _fused_stage(*a), sg, level, K, S, cap, 8, (),
           cj, rj, jjx, mjx, jnp.float32(1.0))

    def f_solve():
        return solve_rvir(grid, centers, rgtp, 178.0)
    t0 = time.perf_counter()
    f_solve()
    print(f"solve-ref    {(time.perf_counter() - t0) * 1e3:8.1f} ms "
          f"(full production solve incl. host)")


if __name__ == "__main__":
    main()
