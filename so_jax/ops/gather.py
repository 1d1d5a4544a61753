"""Batched ragged ball gather — the accelerator-native smBallGather.

The reference gathers one ball at a time by walking the kd-tree with the
periodic INTERSECT prune and scanning leaf buckets (smooth2.c:58-114,
kd2.h:154-253). Here a whole batch of balls is gathered in one fixed-shape
XLA program:

  1. enumerate the S^3 cube of level-g cells covering each ball (periodic
     wrap on cell indices; offsets beyond the needed span are masked),
  2. prune cells whose min distance to the center exceeds the ball radius
     (the INTERSECT role),
  3. turn the ragged per-cell CSR ranges into a dense K-slot index vector
     per ball with a scatter+cumsum trick (no per-cell padding),
  4. gather positions, compute min-image distances, mask to the ball, and
     (optionally) sort each ball's hits by distance.

Capacity K and cube side S are static; the host escalates K when a ball
overflows, mirroring the reference's nnList regrow (smooth2.c:49-55).

Two gather paths share the cell enumeration:
  - ragged_ball_gather: per-slot row gather from the grid's particle
    arrays, returns sorted (d2, row-index) pairs.
  - slab_gather: the cell-slab gather over the grid's payload
    (ops/slab.py), returns sorted channel stacks (d2, mass, m*v, meta,
    idx).
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from .grid import CellGrid, morton_encode
from .slab import decode_idx, dist2, min_image, slab_slots


class GatherResult(NamedTuple):
    d2: jnp.ndarray        # (B, K) f32 — sorted ascending if sort=True; +inf pad
    idx: jnp.ndarray       # (B, K) i32 — rows into the grid's sorted particle SoA
    n_in: jnp.ndarray      # (B,)  i32 — hits with d2 <= r2_mask
    overflow: jnp.ndarray  # (B,)  bool — candidate count exceeded K


def cell_ranges(grid: CellGrid, level: int, centers, radii, r2_mask, S: int,
                align: int = 1):
    """Enumerate each ball's candidate cells at the given level.

    Returns (st, cnt, q, total): per (halo, cell) the CSR slab start, count
    (0 for pruned / out-of-span cells), exclusive output offset, and the
    per-halo candidate total. The INTERSECT-style per-cell min-distance
    prune uses r2_mask so no acceptable particle is ever dropped.

    ``align`` rounds each cell's slot footprint up (the slab gather reads
    CHUNK-aligned pieces); unfilled slots read as empty.
    """
    ncg = grid.ncell(level)
    cs = grid.cell_size(level)                       # (3,)
    starts = grid.starts[level]
    B = centers.shape[0]

    uc = centers - grid.lo
    uc = uc - jnp.floor(uc / grid.period) * grid.period   # wrapped center (B,3)

    r = radii[:, None]                                # (B,1)
    i_lo = jnp.floor((uc - r) / cs).astype(jnp.int32)  # (B,3)
    i_hi = jnp.floor((uc + r) / cs).astype(jnp.int32)
    span = jnp.minimum(i_hi - i_lo + 1, ncg)           # (B,3)

    offs = jnp.arange(S, dtype=jnp.int32)
    coords = i_lo[:, :, None] + offs[None, None, :]    # (B,3,S) unwrapped
    axis_ok = offs[None, None, :] < span[:, :, None]   # (B,3,S)

    # per-axis min distance from the (wrapped) center to the cell slab,
    # computed in unwrapped ball coordinates (the cube is contiguous there)
    lo_edge = coords.astype(jnp.float32) * cs[None, :, None]
    hi_edge = lo_edge + cs[None, :, None]
    d_ax = jnp.maximum(jnp.maximum(lo_edge - uc[:, :, None],
                                   uc[:, :, None] - hi_edge), 0.0)  # (B,3,S)

    cw = jnp.mod(coords, ncg)                          # wrapped cell coords

    # cube assembly: flat cell index c = ((ox*S)+oy)*S+oz
    code = morton_encode(
        cw[:, 0, :, None, None],
        cw[:, 1, None, :, None],
        cw[:, 2, None, None, :],
    ).reshape(B, S * S * S)
    d2min = dist2(d_ax[:, 0, :, None, None], d_ax[:, 1, None, :, None],
                  d_ax[:, 2, None, None, :], starts[0]).reshape(B, S * S * S)
    cell_ok = (axis_ok[:, 0, :, None, None]
               & axis_ok[:, 1, None, :, None]
               & axis_ok[:, 2, None, None, :]).reshape(B, S * S * S)
    cell_ok = cell_ok & (d2min <= r2_mask[:, None])

    st = starts[code]
    cnt = jnp.where(cell_ok, starts[code + 1] - st, 0)  # (B,C)

    if align > 1:
        # Merge adjacent slabs: Morton-neighboring cells of the cube are
        # contiguous in the sorted particle array, so sorting candidates by
        # slab start and fusing ranges with st[i+1] == st[i]+cnt[i] turns
        # the cube into a handful of long runs — fewer pieces and far less
        # chunk-alignment waste for the slab gather.
        big = jnp.int32(1 << 30)
        key = jnp.where(cnt > 0, st, big)
        key_s, st_s, cnt_s = jax.lax.sort((key, st, cnt), num_keys=1)
        cnt_s = jnp.where(key_s < big, cnt_s, 0)
        prev_end = jnp.concatenate(
            [jnp.full((B, 1), -1, st_s.dtype), (st_s + cnt_s)[:, :-1]], axis=1)
        # compaction by a second tiny sort instead of scatter-adds: run
        # j's count is the difference of exclusive prefix-counts at
        # consecutive run starts
        C = st.shape[1]
        is_new = (st_s != prev_end) & (key_s < big)
        csum = jnp.cumsum(cnt_s, axis=1)
        pref = csum - cnt_s
        total_cnt = csum[:, -1:]
        nrun = is_new.sum(axis=1, keepdims=True)
        slotc = jnp.arange(C, dtype=jnp.int32)[None, :]
        key2 = jnp.where(is_new, slotc, jnp.int32(C))
        _, st_m, pref_m = jax.lax.sort((key2, st_s, pref), num_keys=1)
        pref_next = jnp.concatenate([pref_m[:, 1:], total_cnt], axis=1)
        pref_next = jnp.where(slotc + 1 < nrun, pref_next, total_cnt)
        cnt = jnp.where(slotc < nrun, pref_next - pref_m, 0)
        st = st_m
        # footprint covers the align-down..align-up window of each run (the
        # gather reads aligned chunks and masks rows outside [st, st+cnt))
        foot = jnp.where(cnt > 0,
                         ((st % align) + cnt + (align - 1)) // align * align,
                         0)
    else:
        foot = cnt
    q = jnp.cumsum(foot, axis=1) - foot                 # exclusive prefix
    total = q[:, -1] + foot[:, -1]
    return st, cnt, q, total


@partial(jax.jit, static_argnames=("level", "K", "S", "sort"))
def ragged_ball_gather(grid: CellGrid, level: int, centers, radii, r2_mask,
                       K: int, S: int, sort: bool = True) -> GatherResult:
    """Gather all particles with min-image d2 <= r2_mask around each center.

    ``radii`` sets the cell-cube coverage (must satisfy radii^2 >= r2_mask);
    ``r2_mask`` is the inclusive distance-squared acceptance threshold,
    matching the reference's ``fDist2 <= fBall2`` test (smooth2.c:95).
    """
    n = grid.n
    B = centers.shape[0]
    st, cnt, q, total = cell_ranges(grid, level, centers, radii, r2_mask, S)
    overflow = total > K

    # ragged->dense: piecewise-constant "jump" per cell, materialized by a
    # scatter of jump-diffs at each cell's output offset + a cumsum.
    jumps = st - q
    dif = jnp.concatenate([jumps[:, :1], jumps[:, 1:] - jumps[:, :-1]], axis=1)
    rows = jnp.arange(B, dtype=jnp.int32)[:, None]
    acc = jnp.zeros((B, K), jnp.int32).at[rows, q].add(dif, mode="drop")
    gidx = jnp.cumsum(acc, axis=1) + jnp.arange(K, dtype=jnp.int32)[None, :]
    slot_ok = jnp.arange(K, dtype=jnp.int32)[None, :] < jnp.minimum(total, K)[:, None]
    gidx = jnp.clip(gidx, 0, n - 1)

    p = grid.pos_a()[gidx]                              # (B,K,3)
    d = min_image(centers[:, None, :], p, grid.period[None, None, :])
    # starts[level][0] is 0 (every level's first cell begins at row 0)
    d2 = dist2(d[..., 0], d[..., 1], d[..., 2], grid.starts[level][0])
    valid = slot_ok & (d2 <= r2_mask[:, None])
    n_in = valid.sum(axis=1).astype(jnp.int32)

    key = jnp.where(valid, d2, jnp.inf)
    if sort:
        key, gidx = jax.lax.sort((key, gidx), num_keys=1, is_stable=False)
    return GatherResult(d2=key, idx=gidx, n_in=n_in, overflow=overflow)


class SlabGatherResult(NamedTuple):
    d2: jnp.ndarray          # (B, K) sorted ascending; +inf beyond n_in
    channels: tuple          # requested channel stacks, sorted alongside d2
    n_in: jnp.ndarray        # (B,) i32
    overflow: jnp.ndarray    # (B,) bool


@partial(jax.jit, static_argnames=("level", "K", "S", "channels"))
def slab_gather(grid: CellGrid, level: int, centers, radii, r2_mask,
                K: int, S: int, channels: tuple = ("mass",)) -> SlabGatherResult:
    """Slab-path gather: sorted (d2, channel...) stacks per halo.

    channels is a static tuple drawn from {"mass", "mv", "meta", "idx"};
    "mv" expands to three m*v components, "idx" to the exact source row.
    """
    kernel_chans = []
    for ch in channels:
        if ch == "mass":
            kernel_chans.append("mass")
        elif ch == "mv":
            kernel_chans.extend(["mvx", "mvy", "mvz"])
        elif ch == "meta":
            kernel_chans.append("meta")
        elif ch == "idx":
            kernel_chans.extend(["ilo", "ihi"])
        else:
            raise ValueError(ch)

    st, cnt, q, total = cell_ranges(grid, level, centers, radii, r2_mask, S,
                                    align=grid.chunk)
    overflow = total > K
    out = slab_slots(grid.soa8t, st, cnt, q, centers, grid.period, r2_mask,
                     K, chans=tuple(kernel_chans), CHUNK=grid.chunk)
    d2 = out[:, 0, :]
    n_in = jnp.isfinite(d2).sum(axis=1).astype(jnp.int32)

    # decode the split source-row pair BEFORE the sort: one fused
    # elementwise pass turns (ilo, ihi) into a single i32 operand, so the
    # sort carries one less channel
    ops = [d2]
    pre = []                      # channel slots in ops order
    i = 1
    for ch in channels:
        if ch == "mass" or ch == "meta":
            ops.append(out[:, i, :])
            i += 1
            pre.append(ch)
        elif ch == "mv":
            ops.extend([out[:, i, :], out[:, i + 1, :], out[:, i + 2, :]])
            i += 3
            pre.append(ch)
        elif ch == "idx":
            ops.append(decode_idx(out[:, i, :], out[:, i + 1, :]))
            i += 2
            pre.append(ch)
    # unstable (stable adds an iota tiebreak operand); the reference's own
    # distance sort (NR sort2, kd2.c) is unstable too, so equal-d2 tie
    # order is arbitrary in both implementations
    sorted_ops = jax.lax.sort(tuple(ops), num_keys=1, is_stable=False)
    d2_s = sorted_ops[0]
    rest = list(sorted_ops[1:])

    chans = []
    for ch in pre:
        if ch == "mv":
            chans.append(jnp.stack([rest.pop(0), rest.pop(0), rest.pop(0)],
                                   axis=-1))
        else:
            chans.append(rest.pop(0))
    return SlabGatherResult(d2=d2_s, channels=tuple(chans), n_in=n_in,
                            overflow=overflow)
