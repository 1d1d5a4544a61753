"""Cell-slab gather: the payload, its run descriptors and the slotted gather.

A ball's candidates are *contiguous slabs* of the Morton-sorted particle
array (one per intersecting cell, pre-merged into maximal runs by
gather.cell_ranges). The slab path reads them through three pieces:

  payload (pack_soa8t): a transposed (8, N + chunk) float32 array,
    rows [x, y, z, mass, vx, vy, vz, meta], meta = species | mark<<4.
    Velocities are stored RAW, so every grid field (pos, mass, vel,
    ptype, mark) is bit-exactly recoverable from the payload rows, which
    lets CellGrid drop its per-particle duplicates (the memory budget).
    The trailing chunk columns are padding: positions 1e30, other rows 0.

  descriptors (chunk_descriptors): each halo's merged runs cut into
    CHUNK-aligned pieces laid out densely — output slot s of chunk
    t = s // CHUNK reads payload column a0[t] + s, and only rows inside
    the run's [lo, hi) range count.

  gather (slab_slots): (B, 1+len(chans), K) slotted channels. Row 0 is
    the min-image d2 (+inf on empty and out-of-ball slots), rows 1..
    follow ``chans`` (zero on those slots). Channel names: mass, mvx,
    mvy, mvz (m*v as one f32 product of the mass and raw-velocity rows),
    meta, and ilo/ihi (the source row split as ilo + 4096*ihi, exact in
    f32). Plain jnp left to XLA, reading only the payload rows the
    channel set needs. A Pallas (Triton) kernel of the same contract was
    measured against it on the H100 and did not beat it end to end
    (PERF.md, PR 1 findings).
"""

from __future__ import annotations

import os
from functools import partial

import jax
import jax.numpy as jnp

# Default slab chunk (rows); also the tail pad of the payload. The chunk
# sets the occupancy floor of the level selection (solver._pick_level
# min_occ = 3/4 * chunk) and the alignment slack of every run footprint;
# build_grid picks 128 or 256 per grid from the occupancy ladder
# (grid.choose_chunk). Inherited from an earlier build, where it was a
# DMA transfer size; not yet re-derived on the H100. SO_JAX_CHUNK forces
# a global value for experiments.
CHUNK = int(os.environ.get("SO_JAX_CHUNK", "256"))
assert CHUNK % 128 == 0 and CHUNK > 0, CHUNK
CHUNK_FORCED = "SO_JAX_CHUNK" in os.environ

# payload row of each gathered channel (the mv* rows are velocities,
# multiplied by the mass row on the way out)
_ROW = {"mass": 3, "mvx": 4, "mvy": 5, "mvz": 6, "meta": 7}


def pack_soa8t(pos, mass, vel, ptype, mark, chunk: int = CHUNK):
    """Build the padded, transposed (8, N + chunk) payload array.

    Rows 4-6 hold RAW velocities (the gather multiplies by the mass row
    when emitting m*v channels), so the payload is a lossless, bit-exact
    encoding of (pos, mass, vel, ptype, mark) — see CellGrid's accessors.
    """
    meta = (ptype.astype(jnp.int32)
            | (mark.astype(jnp.int32) << 4)).astype(jnp.float32)
    soa = jnp.stack([pos[:, 0], pos[:, 1], pos[:, 2],
                     mass.astype(jnp.float32),
                     vel[:, 0], vel[:, 1], vel[:, 2], meta], axis=0)
    pad = jnp.zeros((8, chunk), jnp.float32).at[0:3, :].set(1e30)
    return jnp.concatenate([soa.astype(jnp.float32), pad], axis=1)


def payload_zero(soa8t):
    """An i32 zero read from the payload's last pad column (its meta row
    is 0.0 by construction) — a runtime value the compiler cannot fold,
    for dist2."""
    return jax.lax.bitcast_convert_type(soa8t[7, -1], jnp.int32)


def dist2(dx, dy, dz, zero):
    """dx*dx + dy*dy + dz*dz, left-associated, with every square rounded
    to f32 on its own as the reference computes it (smooth2.c:89-95).

    XLA's CPU backend contracts a plain x*x + y*y + z*z into fused
    multiply-adds, which round once: on uniform random inputs about a
    fifth of the d2 values move by an ulp, while the GPU backend matched
    the separately rounded sum bit for bit. An ulp flips knife-edge
    particles across R_Delta, so the CPU reference run and the card
    would disagree. OR-ing a runtime i32 ``zero`` into each square's bits
    is an identity no compiler can see through, so no contraction
    happens on any backend. ``zero`` must be 0 at run time and not a
    constant (XLA folds a constant away): payload_zero, or a CSR starts
    array's first entry."""
    def sq(d):
        bits = jax.lax.bitcast_convert_type(d * d, jnp.int32) | zero
        return jax.lax.bitcast_convert_type(bits, jnp.float32)
    return (sq(dx) + sq(dy)) + sq(dz)


def min_image(c, p, period):
    """Min-image displacement with the reference's exact float32
    association: the shifted center sx = c ± period is computed FIRST and
    the particle subtracted from it (INTERSECT kd2.h:154-253 then
    smooth2.c:89-92) — (c − period) − p and (c − p) − period can differ by
    an ulp, which flips knife-edge particles across ball/bin boundaries.
    The shift choice uses the round-to-nearest image, identical to the
    box-based choice for every particle closer than period/2."""
    d0 = c - p
    n = jnp.round(d0 / period)
    return (c - period * n) - p


def chunk_descriptors(st, cnt, q, K: int, CHUNK: int = CHUNK):
    """Cut merged slab runs into dense CHUNK descriptors.

    Returns per (halo, chunk t < NC): a0 (src_t = a0 + t*CHUNK, aligned),
    lo/hi (valid source-row range), and n_chunks per halo. Output slots of
    chunk t are exactly [t*CHUNK, (t+1)*CHUNK), so no destination offsets
    are needed.
    """
    B, C = st.shape
    NC = (K + CHUNK) // CHUNK
    rows = jnp.arange(B, dtype=jnp.int32)[:, None]

    astart = (st // CHUNK) * CHUNK
    foot = jnp.where(cnt > 0,
                     ((st % CHUNK) + cnt + (CHUNK - 1)) // CHUNK * CHUNK, 0)
    nch = foot // CHUNK
    qc = q // CHUNK                       # first chunk slot of each run
    n_total = jnp.minimum(nch.sum(axis=1), NC).astype(jnp.int32)

    def seg_const(vals):
        """Piecewise-constant per-run value expanded to chunk slots."""
        diffs = jnp.concatenate([vals[:, :1], vals[:, 1:] - vals[:, :-1]],
                                axis=1)
        arr = jnp.zeros((B, NC), vals.dtype).at[rows, qc].add(diffs,
                                                              mode="drop")
        return jnp.cumsum(arr, axis=1)

    a0 = seg_const(astart - qc * CHUNK)   # src_t = a0 + t*CHUNK
    lo = seg_const(st)
    hi = seg_const(st + cnt)
    # chunks at or beyond n_total keep garbage descriptors; the gather
    # masks them to the pad
    return a0, lo, hi, n_total


@partial(jax.jit, static_argnames=("K", "chans", "CHUNK"))
def slab_slots(soa8t, starts, cnts, qs, centers, period, r2, K: int,
               chans: tuple = ("mass", "mvx", "mvy", "mvz", "meta", "ilo",
                               "ihi"), CHUNK: int = CHUNK):
    """(B,C) merged slab runs -> (B, 1+len(chans), K) slotted channels:
    row 0 is d2 (+inf on empty/out-of-ball slots), rows 1.. follow chans
    (0 there). ``CHUNK`` must match the payload's pack_soa8t chunk."""
    a0, lo, hi, n_total = chunk_descriptors(starts, cnts, qs, K, CHUNK)
    B, NC = a0.shape

    def per_slot(v):
        """(B, NC) chunk value -> (B, K) slot value (broadcast, no gather)."""
        return jnp.broadcast_to(v[:, :, None], (B, NC, CHUNK)) \
            .reshape(B, NC * CHUNK)[:, :K]

    slot = jnp.arange(K, dtype=jnp.int32)[None, :]
    row = per_slot(a0) + slot                         # source payload column
    live = per_slot(jnp.arange(NC, dtype=jnp.int32)[None, :]
                    < n_total[:, None])
    in_cell = live & (row >= per_slot(lo)) & (row < per_slot(hi))
    col = jnp.clip(row, 0, soa8t.shape[1] - 1)

    def take(r):
        return soa8t[r][col]

    c = centers.astype(jnp.float32)
    p = period.astype(jnp.float32)
    dx = min_image(c[:, 0:1], take(0), p[0])
    dy = min_image(c[:, 1:2], take(1), p[1])
    dz = min_image(c[:, 2:3], take(2), p[2])
    d2 = dist2(dx, dy, dz, payload_zero(soa8t))
    in_ball = in_cell & (d2 <= r2.astype(jnp.float32)[:, None])

    parts = [jnp.where(in_ball, d2, jnp.inf)]
    mass = take(3) if any(ch != "meta" and ch in _ROW for ch in chans) \
        else None
    for ch in chans:
        if ch == "ilo":
            v = (row & 0xFFF).astype(jnp.float32)
        elif ch == "ihi":
            v = (row >> 12).astype(jnp.float32)
        elif ch == "mass":
            v = mass
        elif ch in ("mvx", "mvy", "mvz"):
            v = mass * take(_ROW[ch])
        elif ch == "meta":
            v = take(7)
        else:
            raise ValueError(ch)
        parts.append(jnp.where(in_ball, v, 0.0))
    return jnp.stack(parts, axis=1)


def decode_idx(ilo, ihi):
    return (ilo.astype(jnp.int32) + (ihi.astype(jnp.int32) << 12))

