"""Interior-member extraction + group mean velocity.

The reference tags the j strictly-interior particles of each solved group
in ascending-distance order (kdTagParticles call site, kd2.c:823) and
computes the mass-weighted mean velocity over the same j particles
(_VcmParticles, kd2.c:595-609). The batched solver returns only (j, d2cut);
this pass re-gathers each solved halo's interior as *sorted original
particle indices* (consumed by the host-side conflict protocol) and the
vcm. Distances reuse the same gather kernels, so they are bit-identical to
the solve.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..ops.gather import ragged_ball_gather, slab_gather
from ..ops.grid import CellGrid


def vcm_from_members(mvh: np.ndarray, rows: np.ndarray, counts: np.ndarray,
                     mvir: np.ndarray) -> np.ndarray:
    """Group mean velocity from concatenated member rows (_VcmParticles,
    kd2.c:595-609): per-halo sequential float64 accumulation over the
    sorted member list, divided by Mvir.

    This is THE accumulation order for every so_jax host vcm path (fused
    and plain member extraction share it — docs/PARITY.md #8): reduceat
    sums each halo's segment independently, so the result depends only on
    that halo's own member list, not on how halos were batched into
    dispatch chunks (a global-prefix-difference scheme is not
    batch-invariant under float rounding).

    ``rows``: concatenated member original-indices (halo-major, ascending
    distance within each halo); ``counts``: per-halo lengths; ``mvh``:
    per-particle m*v, dense (N, 3) or the lazy ``(vel, mass)`` pair
    (member_mv_sums forms the f32 products on member rows only).
    """
    sums = member_mv_sums(mvh, rows, counts)
    return (sums / np.maximum(np.asarray(mvir, np.float64)[:, None], 1e-300)
            ).astype(np.float32) * (np.asarray(counts, np.int64) > 0)[:, None]


def member_mv_sums(mvh, rows: np.ndarray, counts: np.ndarray) -> np.ndarray:
    """(G, 3) f64 per-halo sequential sums of mvh over concatenated member
    rows — the reduction core of vcm_from_members, exposed separately so a
    multi-controller host can compute the partial over its own particle
    segment (parallel.driver sums the per-host partials in host order).

    ``mvh``: dense per-particle (N, 3) m*v, or the lazy ``(vel, mass)``
    pair — then the f32 product is formed on the gathered member rows only
    (bit-identical to pre-materializing m*v for all N: the elementwise IEEE
    multiply commutes with the gather), saving an O(N) pass + allocation
    per pipeline run on the host."""
    counts = np.asarray(counts, np.int64)
    G = counts.shape[0]
    sums = np.zeros((G, 3), np.float64)
    nz = counts > 0
    if nz.any():
        if isinstance(mvh, tuple):
            vel, mass = mvh
            mv_rows = (np.asarray(vel, np.float32)[rows]
                       * np.asarray(mass, np.float32)[rows, None])
        else:
            mv_rows = np.asarray(mvh, np.float32)[rows]
        seg_starts = (np.cumsum(counts) - counts)[nz]
        sums[nz] = np.add.reduceat(mv_rows.astype(np.float64), seg_starts,
                                   axis=0)
    return sums


def _pack_prefix(rows_sorted, counts, cap: int):
    """Compact the valid member rows of the (B, K) slot matrix into one
    dense vector, preserving (halo, ascending-distance) order. Fetching
    all B*K slots would move e.g. 268 MB for a 4096x16384 stage; the
    compacted fetch is ~sum(j) entries. ``cap`` is a static power-of-two
    >= total valid.

    Each row's valid entries are its contiguous PREFIX (slots
    [0, counts[b]) of the distance-sorted row), so the dense vector is a
    computed gather, not a flat B*K compaction sort.

    The flat source index is a per-halo affine ramp (src = b*K + p −
    start_b for p in [start_b, cum_b)), built by scattering the ramp-
    offset diffs at each halo's start and prefix-summing — the same
    piecewise-constant trick as ragged_ball_gather's jump vector, in
    place of a searchsorted(cum, p) row lookup."""
    B, K = rows_sorted.shape
    counts = counts.astype(jnp.int32)
    cum = jnp.cumsum(counts)
    start = cum - counts
    # val_b = b*K - start_b; empty halos share their successor's start and
    # the scatter-ADD of diffs lands both, so cumsum yields the LAST
    # halo's value at a shared start — exactly searchsorted side="right"
    val = jnp.arange(B, dtype=jnp.int32) * K - start
    dif = jnp.concatenate([val[:1], val[1:] - val[:-1]])
    p = jnp.arange(cap, dtype=jnp.int32)
    acc = jnp.zeros(cap, jnp.int32).at[start].add(dif, mode="drop")
    src = jnp.cumsum(acc) + p
    valid = p < cum[-1]
    vals = rows_sorted.reshape(-1)[jnp.clip(src, 0, B * K - 1)]
    return jnp.where(valid, vals, -1), counts


@partial(jax.jit, static_argnames=("level", "K", "S", "cap"))
def _members_stage(grid: CellGrid, level: int, K: int, S: int, cap: int,
                   centers, cover_r, d2cut, j, mvir):
    """Interior-member row extraction only — vcm is ALWAYS computed on the
    host from the member lists (vcm_from_members, the one documented
    _VcmParticles accumulation order), so the gather needs just d2 + the
    split source index: a 3-operand sort and a 3-row slab gather (an
    on-device f32 slot-sum vcm would be a second, undocumented
    accumulation order)."""
    slot = jnp.arange(K, dtype=jnp.int32)[None, :]
    interior = slot < j[:, None]
    if grid.soa8t is not None:
        g = slab_gather(grid, level, centers, cover_r, d2cut, K, S,
                        channels=("idx",))
        idx_s = g.channels[-1]
        srow = jnp.where(interior, idx_s, -1)
    else:
        g = ragged_ball_gather(grid, level, centers, cover_r, d2cut, K, S,
                               sort=True)
        valid = jnp.isfinite(g.d2)
        srow = jnp.where(valid & interior, g.idx, -1)
    # pack first, translate after: orig_idx[(B, K) rows] is a huge random
    # row-gather; orig_idx[(cap,) rows] is negligible. The valid member slots are the contiguous prefix of
    # each distance-sorted row (interior = slot < j and hits sort finite-
    # first), so the prefix pack applies — no flat sort.
    counts = jnp.minimum(j.astype(jnp.int32), g.n_in)
    packed_rows, counts = _pack_prefix(jnp.where(interior, srow, -1),
                                       counts, cap)
    packed = jnp.where(packed_rows >= 0,
                       grid.orig_idx[jnp.clip(packed_rows, 0, grid.n - 1)],
                       -1)
    return packed, counts, g.n_in, g.overflow


def extract_members(grid: CellGrid, centers: np.ndarray, d2cut: np.ndarray,
                    j: np.ndarray, mvir: np.ndarray, s_max: int = 11,
                    slot_budget: int = 1 << 25, stage_fn=None,
                    cap_hint=None, host_mv=None):
    """Per solved halo: sorted interior original-index list (length j) and
    the group mean velocity.

    ``cap_hint`` (SolveResult.kcap) sizes each halo's gather from the
    capacity that resolved it — the member re-gather happens at a radius
    <= the resolving stage's, so its footprint can only be smaller and the
    first tier is guaranteed to land. Without a hint, capacity is sized
    from the interior count j. Ties at the d2cut boundary may gather a few
    extra hits, which are truncated to j exactly as the reference's walk
    stops at j (kd2.c:663-670).

    ``stage_fn(level, K, S, cap, centers, cover_r, d2cut, j, mvir)``
    overrides the single-device stage — the multi-device path
    (parallel.mesh.extract_members_sharded) injects its shard_map stage
    here and reuses this escalation driver unchanged.

    vcm ALWAYS comes from vcm_from_members over the extracted lists (one
    accumulation order everywhere). ``host_mv`` is the per-particle m*v in
    ORIGINAL file order, dense (N, 3) or the lazy ``(vel, mass)`` pair;
    when None it is derived from the grid's own arrays (one device fetch
    — callers should pass the host copy they already hold, as the
    pipeline does).
    """
    from .solver import (_chunk_for, _k_limit, _level_groups, _pad_b,
                         _pad_to_bucket, _pick_level_span, _stage_grid,
                         k_slab_max)

    if host_mv is None:
        if stage_fn is not None:
            raise ValueError(
                "extract_members with an injected stage_fn needs host_mv "
                "(the grid argument is a proxy without particle arrays)")
        # sorted-order device arrays -> original file order via orig_idx
        oi = np.asarray(grid.orig_idx)
        vel_o = np.empty((grid.n, 3), np.float32)
        vel_o[oi] = np.asarray(grid.vel_a(), np.float32)
        mass_o = np.empty(grid.n, np.float32)
        mass_o[oi] = np.asarray(grid.mass_a(), np.float32)
        host_mv = (vel_o, mass_o)
    # slab ceiling (solver.k_slab_max) for this stage's output width: d2 +
    # the split source index (vcm needs no device channels)
    k_slab = k_slab_max(3)
    if stage_fn is None:
        stage_fn = lambda level, K, S, *a: _members_stage(
            _stage_grid(grid, K, k_slab), level, K, S, *a)

    if getattr(grid, "soa8t", None) is not None:
        s_max = min(s_max, 7)
    G = centers.shape[0]
    centers = np.asarray(centers, np.float32)
    d2cut = np.asarray(d2cut, np.float32)
    j = np.asarray(j, np.int64)
    mvir = np.asarray(mvir, np.float32)
    out: list[np.ndarray | None] = [None] * G
    vcm = np.zeros((G, 3), np.float32)
    if G == 0:
        return [], vcm

    cover = np.sqrt(d2cut.astype(np.float64)).astype(np.float32)
    cover = np.nextafter(cover, np.float32(np.inf)) * np.float32(1.0 + 1e-6)

    if cap_hint is not None:
        need_cap = np.maximum(np.asarray(cap_hint, np.int64), 512)
    else:
        # slab footprints are CHUNK-aligned per merged run — budget extra
        # slots up front so the first capacity tier usually lands (each
        # escalation tier is another compile)
        pad0 = 8192 if getattr(grid, "soa8t", None) is not None else 512
        # power-of-4 tiers: every (K, level, S) combination is its own
        # compile; fewer tiers beats tight capacities
        need_cap = np.maximum(
            4 ** np.ceil(np.log2(np.maximum(j * 2 + pad0, 512))
                         / 2).astype(np.int64), 512)
    todo = np.arange(G)
    guard = 0
    while todo.size:
        guard += 1
        if guard > 64:
            raise RuntimeError("member extraction runaway")
        next_todo = []
        for capacity in np.unique(need_cap[todo]):
            sel0 = todo[need_cap[todo] == capacity]
            K = int(min(capacity, max(512, _k_limit(grid, s_max))))
            chunk = _chunk_for(K, slot_budget, k_slab)
            for level, S, bidx in _level_groups(grid, cover[sel0], s_max, K):
              sel = sel0[bidx]
              for lo in range(0, sel.size, chunk):
                part = sel[lo:lo + chunk]
                B = _pad_b(part.size, K, k_slab)
                c_pad = np.zeros((B, 3), np.float32)
                r_pad = np.zeros(B, np.float32)
                d_pad = np.zeros(B, np.float32)
                j_pad = np.zeros(B, np.int32)
                m_pad = np.ones(B, np.float32)
                c_pad[:part.size] = centers[part]
                r_pad[:part.size] = cover[part]
                d_pad[:part.size] = d2cut[part]
                j_pad[:part.size] = j[part]
                m_pad[:part.size] = mvir[part]
                # static fetch capacity: the packed member vector holds at
                # most sum(j) + tie slack entries (power-of-two buckets
                # bound the compile-variant count)
                cap = 1 << int(np.ceil(np.log2(
                    max(int(j[part].sum()) + 8 * part.size, 1024))))
                cap = int(min(cap, B * K))
                import os, sys
                from time import perf_counter as _pc
                dbg = os.environ.get("SO_JAX_DEBUG")
                t0 = _pc() if dbg else 0.0
                packed, counts, n_in, ovf = stage_fn(
                    level, K, S, cap, jnp.asarray(c_pad),
                    jnp.asarray(r_pad), jnp.asarray(d_pad),
                    jnp.asarray(j_pad), jnp.asarray(m_pad))
                counts = np.asarray(counts)
                total = int(counts.sum())
                if total > cap:
                    # tie inflation beyond the slack: re-run this chunk
                    # with doubled capacities (rare; ties are float32-exact
                    # distance collisions at the d2cut boundary)
                    need_cap[part] = np.minimum(need_cap[part] * 4,
                                                2 * _k_limit(grid, s_max))
                    next_todo.extend(part)
                    continue
                packed = np.asarray(packed)
                ovf = np.asarray(ovf)[:part.size]
                if dbg:
                    print(f"so_jax[members]: stage B={B} K={K} S={S} "
                          f"level={level} n={part.size} cap={cap} "
                          f"dt={(_pc() - t0) * 1e3:.1f}ms",
                          file=sys.stderr, flush=True)
                seg = np.cumsum(counts)
                for i, h in enumerate(part):
                    if ovf[i]:
                        need_cap[h] = min(need_cap[h] * 4,
                                          2 * _k_limit(grid, s_max))
                        next_todo.append(h)
                    else:
                        lo_i = seg[i - 1] if i else 0
                        out[h] = packed[lo_i:lo_i + min(counts[i], j[h])] \
                            .astype(np.int64)
        todo = np.asarray(next_todo, np.int64)
    # group mean velocity from the member lists (_VcmParticles,
    # kd2.c:595-609) — THE shared accumulation order, see vcm_from_members;
    # dense (n_particles, 3) m*v or the lazy (vel, mass) pair
    mvh = host_mv if isinstance(host_mv, tuple) \
        else np.asarray(host_mv, np.float32)
    counts = np.array([0 if lst is None else lst.size for lst in out],
                      np.int64)
    rows = (np.concatenate([lst for lst in out if lst is not None
                            and lst.size])
            if counts.sum() else np.zeros(0, np.int64))
    vcm = vcm_from_members(mvh, rows, counts, mvir)
    return out, vcm
