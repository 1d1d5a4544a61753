"""-pot most-bound recentring — reference: kdRvir's bPot block (kd2.c:749-761).

Before the ball ladder runs, each group's center is permanently replaced by
the position of the minimum-fPhi particle within radius Rgtp of the input
center. This is independent per halo (it reads only particle data), so it
runs as one batched pass over all halos before the solver.

Two gather paths (chosen by the grid's slab payload, like the solver):
  - ragged gather (CPU / fallback).
  - slab gather: phi rides the existing 8-row payload format in the
    "mass" row of a recenter-specific payload (built once per call), so
    the gather itself is unchanged; output stays UNSORTED — argmin phi
    over the slotted candidates needs no distance sort at all.

Tie-breaking note: the reference keeps the first minimum in kd-tree
traversal order (strict '<', kd2.c:754-759); we keep the first minimum in
backend-specific candidate order (cell enumeration order on the XLA path,
merged-run chunk order on the slab path). Identical whenever phi values
are distinct; tests/test_fuzz_reference.py::test_fuzz_pot_phi_ties bounds
the divergence to actual min-phi ties.

Degenerate case: an empty Rgtp ball makes the reference read stale list
memory (smx->nnList[0] from the previous gather); we keep the original
center instead.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..ops.gather import ragged_ball_gather
from ..ops.grid import CellGrid


@partial(jax.jit, static_argnames=("level", "K", "S"))
def _recenter_stage(grid: CellGrid, level: int, K: int, S: int, centers, radii):
    g = ragged_ball_gather(grid, level, centers, radii, radii * radii, K, S,
                           sort=False)
    slot_valid = jnp.isfinite(g.d2)
    phi = jnp.where(slot_valid, grid.phi_a()[g.idx], jnp.inf)
    amin = jnp.argmin(phi, axis=1)
    rows = jnp.arange(centers.shape[0])
    best = grid.pos_a()[g.idx[rows, amin]]
    new_centers = jnp.where((g.n_in > 0)[:, None], best, centers)
    return new_centers, g.n_in, g.overflow


@partial(jax.jit, static_argnames=("level", "K", "S"))
def _recenter_stage_slab(grid: CellGrid, phi_soa, level: int, K: int, S: int,
                         centers, radii):
    """Slab-path recenter: unsorted slotted (d2, phi, idx) channels, then
    an elementwise argmin — no K*logK sort."""
    from ..ops.gather import cell_ranges
    from ..ops.slab import decode_idx, slab_slots

    r2 = radii * radii
    st, cnt, q, total = cell_ranges(grid, level, centers, radii, r2, S,
                                    align=grid.chunk)
    out = slab_slots(phi_soa, st, cnt, q, centers, grid.period, r2, K,
                     chans=("mass", "ilo", "ihi"), CHUNK=grid.chunk)
    d2 = out[:, 0]
    ok = jnp.isfinite(d2)
    phi = jnp.where(ok, out[:, 1], jnp.inf)
    n_in = ok.sum(axis=1).astype(jnp.int32)
    rows = jnp.arange(centers.shape[0])
    amin = jnp.argmin(phi, axis=1)
    row = decode_idx(out[:, 2][rows, amin], out[:, 3][rows, amin])
    best = grid.pos_a()[jnp.clip(row, 0, grid.n - 1)]
    new_centers = jnp.where((n_in > 0)[:, None], best, centers)
    return new_centers, n_in, total > K


def _phi_payload(grid: CellGrid):
    """Recenter-specific payload: the layout of pack_soa8t with phi in
    the mass row (the gather's "mass" channel then carries phi). On a
    deduplicated grid this is one .at[].set on the existing payload — the
    gather never reads the velocity/meta rows for the recenter channel
    set."""
    if grid.soa8t is not None:
        return grid.soa8t.at[3, :grid.n].set(grid.phi_a())
    from ..ops.slab import pack_soa8t

    n = grid.n
    return jax.jit(pack_soa8t, static_argnames=("chunk",))(
        grid.pos, grid.phi_a(), jnp.zeros((n, 3), jnp.float32), grid.ptype,
        grid.mark, chunk=grid.chunk)


def recenter_most_bound(grid: CellGrid, centers: np.ndarray, rgtp: np.ndarray,
                        k0_cap: int = 4096, s_max: int = 11,
                        slot_budget: int = 1 << 25) -> np.ndarray:
    """Batched recentring for all halos; escalates capacity on overflow."""
    from .solver import _chunk_for, _k_limit, _pick_level_span, _pad_to_bucket

    G = centers.shape[0]
    centers = np.asarray(centers, np.float32)
    radii_all = np.asarray(rgtp, np.float32)
    out = centers.copy()
    has_slab = getattr(grid, "soa8t", None) is not None
    phi_soa = _phi_payload(grid) if has_slab else None
    if has_slab:
        s_max = min(s_max, 7)
    todo = np.arange(G)
    capacity = k0_cap
    while todo.size:
        K = int(min(capacity, _k_limit(grid, s_max)))
        use_slab = phi_soa is not None and K <= (1 << 16)
        radii = radii_all[todo]
        level, S = _pick_level_span(grid, float(radii.max()) if radii.size else 0.0, s_max)
        chunk = _chunk_for(K, slot_budget)
        still = []
        for lo in range(0, todo.size, chunk):
            part = todo[lo:lo + chunk]
            B = _pad_to_bucket(part.size)
            c_pad = np.zeros((B, 3), np.float32)
            r_pad = np.zeros(B, np.float32)
            c_pad[:part.size] = centers[part]
            r_pad[:part.size] = radii_all[part]
            if use_slab:
                nc, n_in, ovf = _recenter_stage_slab(
                    grid, phi_soa, level, K, S, jnp.asarray(c_pad),
                    jnp.asarray(r_pad))
            else:
                nc, n_in, ovf = _recenter_stage(grid, level, K, S,
                                                jnp.asarray(c_pad),
                                                jnp.asarray(r_pad))
            nc = np.asarray(nc)[:part.size]
            ovf = np.asarray(ovf)[:part.size]
            out[part[~ovf]] = nc[~ovf]
            still.append(part[ovf])
        todo = np.concatenate(still) if still else np.zeros(0, np.int64)
        capacity *= 4
        if capacity > max(8 * _k_limit(grid, s_max), k0_cap):
            if todo.size:
                raise RuntimeError("recentring escalation runaway")
    return out
