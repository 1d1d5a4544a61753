"""Morton-sorted multi-level cell grid — the batched replacement for the kd-tree.

The reference builds a balanced, heap-indexed kd-tree over particles and
walks it per ball gather (kdBuildTree kd2.c:1096-1185, smBallGather
smooth2.c:58-114). Pointer-chasing traversal is hostile to XLA, so instead:

  - Particles are sorted once by Morton code on a 2^m-per-axis grid over the
    periodic box. A coarse cell at level g (cells of 2^g x 2^g x 2^g fine
    cells) is then a *contiguous range* of the sorted particle array, so one
    CSR "starts" array per level gives O(1) cell -> particle-range lookup at
    every resolution.
  - A ball gather becomes: enumerate the cube of level-g cells covering the
    ball (periodic wrap on cell indices, per-cell min-distance pruning that
    plays the role of the INTERSECT macro kd2.h:154-253), turn the ragged
    per-cell ranges into a dense index vector with a scatter+cumsum trick,
    and compute min-image distances for the whole halo batch at once.

Everything is fixed-shape and batched: the host only chooses capacity tiers.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np


def _part1by2(x):
    """Spread the low 10 bits of x over 30 bits (Morton interleave helper)."""
    x = x.astype(jnp.uint32) & 0x3FF
    x = (x | (x << 16)) & 0x030000FF
    x = (x | (x << 8)) & 0x0300F00F
    x = (x | (x << 4)) & 0x030C30C3
    x = (x | (x << 2)) & 0x09249249
    return x


def morton_encode(ix, iy, iz):
    """3D Morton code from per-axis cell coords (< 1024 each)."""
    return (_part1by2(ix) | (_part1by2(iy) << 1) | (_part1by2(iz) << 2)).astype(jnp.int32)


@jax.tree_util.register_pytree_node_class
@dataclass
class CellGrid:
    """Device-resident spatial index + particle SoA, Morton-sorted.

    ``starts[g]`` has 8^(m-g)+1 entries; particles of level-g cell c occupy
    sorted rows [starts[g][c], starts[g][c+1]). Positions are kept in their
    *original* coordinates (distances use min-image arithmetic directly,
    matching the reference's shifted-center scheme, kd2.h:154-253); wrapped
    coordinates are used only to assign cells.

    Memory budget: when the slab payload ``soa8t`` is built, the
    per-particle arrays pos/mass/vel/ptype/mark are dropped (None) — the
    payload is a bit-exact encoding of all five (pack_soa8t stores raw
    velocities), so the ragged-gather fallback paths reconstruct them on
    demand via the *_a() accessors (fused slices under jit; no persistent
    duplicate buffers).
    Persistent cost is then ~36 B/particle (payload 32 + orig_idx 4 +
    CSR starts ~0.2) + 4 B when phi is carried, vs ~73 B with duplicates.
    SO_JAX_DEDUP=0 keeps the legacy duplicate layout.
    """
    m: int                      # static: finest level has 2^m cells per axis
    lo: jnp.ndarray             # (3,) f32 box lower corner (center - period/2)
    period: jnp.ndarray         # (3,) f32
    pos: jnp.ndarray | None     # (N,3) f32 Morton-sorted original positions
    mass: jnp.ndarray | None    # (N,)  f32
    vel: jnp.ndarray | None     # (N,3) f32
    phi: jnp.ndarray | None     # (N,)  f32 (None when the caller provided
    #                             no potentials — phi_a() serves zeros)
    ptype: jnp.ndarray | None   # (N,)  i32 species code (DARK/GAS/STAR)
    mark: jnp.ndarray | None    # (N,)  bool
    orig_idx: jnp.ndarray       # (N,)  i32 sorted-row -> original file order
    starts: tuple               # per level g=0..m: (8^(m-g)+1,) i32
    soa8t: jnp.ndarray | None = None  # (8, N+chunk) payload of the slab
    #                                   gather (ops/slab.py; None on CPU)
    chunk: int = 256            # static: slab chunk of the payload;
    #                             also sets the occupancy floor of the
    #                             level selection (solver._pick_level)
    uniform_mass: float | None = None  # static: the single mass value when
    #                             every particle's f32 mass is bit-identical
    #                             (plain N-body boxes). Solve stages then
    #                             skip the mass channel entirely: the sorted
    #                             cumulative mass is the same serial-f32
    #                             ladder for every halo (adding zeros never
    #                             changes a serial accumulator), so the
    #                             distance sort drops to one operand.

    @property
    def n(self) -> int:
        return self.orig_idx.shape[0]

    # --- accessors serving either the stored array or a payload slice ---
    # (bit-exact: pack_soa8t copies pos/mass/vel f32 verbatim and packs
    # ptype|mark<<4 into the meta row — small ints are exact in f32)

    def pos_a(self) -> jnp.ndarray:
        if self.pos is not None:
            return self.pos
        return self.soa8t[0:3, :self.n].T

    def mass_a(self) -> jnp.ndarray:
        if self.mass is not None:
            return self.mass
        return self.soa8t[3, :self.n]

    def vel_a(self) -> jnp.ndarray:
        if self.vel is not None:
            return self.vel
        return self.soa8t[4:7, :self.n].T

    def ptype_a(self) -> jnp.ndarray:
        if self.ptype is not None:
            return self.ptype
        return self.soa8t[7, :self.n].astype(jnp.int32) & 0xF

    def mark_a(self) -> jnp.ndarray:
        if self.mark is not None:
            return self.mark
        return (self.soa8t[7, :self.n].astype(jnp.int32) >> 4) > 0

    def phi_a(self) -> jnp.ndarray:
        if self.phi is not None:
            return self.phi
        return jnp.zeros(self.n, jnp.float32)

    def ncell(self, level: int) -> int:
        return 1 << (self.m - level)

    def cell_size(self, level: int) -> jnp.ndarray:
        return self.period / self.ncell(level)

    def tree_flatten(self):
        children = (self.lo, self.period, self.pos, self.mass, self.vel,
                    self.phi, self.ptype, self.mark, self.orig_idx,
                    self.starts, self.soa8t)
        return children, (self.m, self.chunk, self.uniform_mass)

    @classmethod
    def tree_unflatten(cls, aux, children):
        m, chunk, uniform_mass = aux
        return cls(m, *children, chunk=chunk, uniform_mass=uniform_mass)


def detect_uniform_mass(mass) -> float | None:
    """The single f32 mass value when every entry is bit-identical, else
    None. One memcmp-speed host pass; never fetches a device buffer
    (jax.Array inputs return None) and honors SO_JAX_UNIFORM=0. The ONE
    detection contract shared by build_grid, build_sharded_grid and the
    distributed driver's per-segment check."""
    if isinstance(mass, jax.Array):
        return None
    if os.environ.get("SO_JAX_UNIFORM", "1") == "0":
        return None
    m_np = np.asarray(mass, np.float32)
    if m_np.size and bool((m_np == m_np.flat[0]).all()):
        return float(m_np.flat[0])
    return None


def choose_m(n_particles: int, target_occupancy: int = 24, m_max: int = 9) -> int:
    """Pick the finest level so mean cell occupancy ~= target."""
    if n_particles <= 1:
        return 0
    cells = max(1.0, n_particles / target_occupancy)
    m = int(round(np.log2(cells ** (1.0 / 3.0))))
    return int(np.clip(m, 0, m_max))


def choose_chunk(n_particles: int, m: int) -> int:
    """Per-grid slab chunk from the occupancy ladder.

    The chunk sets (a) the occupancy floor of the level selection
    (solver._pick_level needs mean occupancy >= 3/4 * chunk so chunks
    arrive mostly full) and (b) the per-run alignment slack of every
    gather footprint. 128 is chosen when either
      - its floor (96) admits a strictly finer level than 256's (192):
        smaller cells shrink every candidate footprint severalfold, or
      - the selected level's occupancy is < 1.5 chunks (384 rows): each
        cell is barely one 256-chunk, so the per-run alignment waste at
        256 inflates capacity tiers.
    Otherwise 256. The ladder was inherited from an earlier build's DMA
    kernel and is not yet re-derived on the H100. SO_JAX_CHUNK forces a
    global value.
    """
    from .slab import CHUNK, CHUNK_FORCED

    if CHUNK_FORCED:
        return CHUNK
    occ = [n_particles / (1 << (3 * (m - g))) for g in range(m + 1)]
    g96 = next((g for g, o in enumerate(occ) if o >= 96), m)
    g192 = next((g for g, o in enumerate(occ) if o >= 192), m)
    if g96 < g192 or occ[g192] < 384:
        return 128
    return 256


# Sentinel Morton code for padding particles: >= the cell count at every
# level (1<<30 >> 3g >= 8^(m-g) whenever m <= 9), so every cell range at
# every level excludes sentinels by construction.
# (a numpy scalar, not jnp: creating a device array at import time would
# initialize the XLA backend before jax.distributed.initialize can run)
SENTINEL_CODE = np.int32(1 << 30)


def _build_device_impl(m, lo, period, pos, mass, vel, phi, ptype, mark,
                       valid=None):
    nc = 1 << m
    u = pos - lo
    u = u - jnp.floor(u / period) * period  # wrap to [0, period)
    ic = jnp.clip((u / period * nc).astype(jnp.int32), 0, nc - 1)
    code = morton_encode(ic[:, 0], ic[:, 1], ic[:, 2])
    if valid is not None:
        code = jnp.where(valid, code, SENTINEL_CODE)
        mass = jnp.where(valid, mass, 0.0)
    perm = jnp.argsort(code, stable=True)
    code_s = code[perm]
    starts = []
    for g in range(m + 1):
        ncg3 = 1 << (3 * (m - g))
        cg = (code_s >> (3 * g)).astype(jnp.int32)
        starts.append(jnp.searchsorted(cg, jnp.arange(ncg3 + 1, dtype=jnp.int32),
                                       side="left").astype(jnp.int32))
    return (pos[perm], mass[perm], vel[perm], phi[perm], ptype[perm],
            mark[perm], perm.astype(jnp.int32), tuple(starts))


_build_device = partial(jax.jit, static_argnames=("m",))(_build_device_impl)
# the donating variant lets XLA alias/free the unsorted input buffers while
# producing the sorted outputs — build-time device-memory peak drops by
# roughly the input footprint (~34 B/particle). Used by build_grid only
# when it owns the device buffers (inputs arrived as host arrays), so no
# caller-held jax.Array is invalidated.
_build_device_donated = partial(jax.jit, static_argnames=("m",),
                                donate_argnums=(3, 4, 5, 6, 7, 8))(
                                    _build_device_impl)


@partial(jax.jit, static_argnames=("m",))
def _codes_perm(m, lo, period, pos):
    """Phase A of the staged build: Morton perm + level starts from the
    positions alone — the identical ops _build_device_impl runs (same
    encode, same stable argsort, same searchsorted), so the staged build
    is bit-identical to the one-shot build by construction."""
    nc = 1 << m
    u = pos - lo
    u = u - jnp.floor(u / period) * period
    ic = jnp.clip((u / period * nc).astype(jnp.int32), 0, nc - 1)
    code = morton_encode(ic[:, 0], ic[:, 1], ic[:, 2])
    perm = jnp.argsort(code, stable=True)
    code_s = code[perm]
    starts = []
    for g in range(m + 1):
        ncg3 = 1 << (3 * (m - g))
        cg = (code_s >> (3 * g)).astype(jnp.int32)
        starts.append(jnp.searchsorted(cg, jnp.arange(ncg3 + 1, dtype=jnp.int32),
                                       side="left").astype(jnp.int32))
    return perm.astype(jnp.int32), tuple(starts)


_take_rows = jax.jit(lambda a, perm: a[perm])


@partial(jax.jit, static_argnames=("chunk",))
def _staged_rows3(a, perm, padval, chunk):
    """One (3, n+chunk) payload row-block: permute an (n,3) field, transpose,
    pad `chunk` trailing columns with padval — bit-identical to the matching
    rows of pack_soa8t (permute-then-slice == slice-then-permute)."""
    s = a[perm].T.astype(jnp.float32)
    return jnp.concatenate([s, jnp.full((3, chunk), padval, jnp.float32)],
                           axis=1)


@partial(jax.jit, static_argnames=("chunk",))
def _staged_row1(a, perm, chunk):
    """One (1, n+chunk) payload row, zero-padded."""
    s = a[perm].astype(jnp.float32)[None, :]
    return jnp.concatenate([s, jnp.zeros((1, chunk), jnp.float32)], axis=1)


# the one-shot build peaks at inputs + outputs + sort scratch. Above this
# row count build_grid stages the build instead: perm from the positions
# alone, then (in the usual slab+dedup configuration) the slab payload
# assembled row-block by row-block straight from the UNSORTED fields — the
# sorted per-field duplicates that pack_soa8t would otherwise hold live
# are never materialized, and each unsorted input is freed as soon as its
# rows are built. Absent fields become constant rows with no upload at
# all. Peak is then roughly max(field uploads) + payload + one row-block.
STAGED_BUILD_MIN = int(os.environ.get("SO_JAX_STAGED_BUILD", 1 << 25))


def slab_default() -> bool:
    """Whether grids carry the slab payload by default: on an accelerator
    yes, on the CPU no (the ragged gather is the CPU path).
    SO_JAX_SLAB=0/1 forces either."""
    env = os.environ.get("SO_JAX_SLAB", "auto")
    if env in ("0", "1"):
        return env == "1"
    return jax.default_backend() != "cpu"


def build_grid(pos, mass, vel=None, phi=None, ptype=None, mark=None,
               period=(1.0, 1.0, 1.0), center=(0.0, 0.0, 0.0),
               m: int | None = None, slab: bool | None = None) -> CellGrid:
    """Build the grid from (host or device) particle arrays.

    ``period``/``center`` follow the reference's -p / -c / -cx/-cy/-cz flags
    (defaults period=1^3, center=0^3; so.c:241-244).
    ``slab``: also build the slab-gather payload (default: slab_default()).
    """
    # donation is safe only for buffers created here (host inputs) — a
    # caller-held jax.Array would be invalidated by donating it
    owned = all(a is None or not isinstance(a, jax.Array)
                for a in (pos, mass, vel, phi, ptype, mark))
    pos = jnp.asarray(pos, jnp.float32)
    n = pos.shape[0]
    has_phi = phi is not None
    um = detect_uniform_mass(mass)
    period = jnp.asarray(period, jnp.float32)
    center = jnp.asarray(center, jnp.float32)
    lo = center - period * 0.5
    if m is None:
        m = choose_m(n)
    if slab is None:
        slab = slab_default()
    dedup = os.environ.get("SO_JAX_DEDUP", "1") != "0"
    chunk = choose_chunk(n, m)
    if owned and n >= STAGED_BUILD_MIN and slab and dedup:
        # staged build, payload-direct (bit-identical, see _codes_perm and
        # the STAGED_BUILD_MIN note): perm from the positions alone, then
        # the (8, n+chunk) slab payload assembled one row-block at a time
        # from the UNSORTED inputs, freeing each as it is consumed. The
        # sorted per-field duplicates are never materialized — dedup would
        # drop them immediately anyway.
        perm, starts = _codes_perm(m, lo, period, pos)
        parts = [_staged_rows3(pos, perm, jnp.float32(1e30), chunk)]
        del pos
        parts.append(_staged_row1(jnp.asarray(mass, jnp.float32), perm,
                                  chunk))
        del mass
        if vel is None:
            parts.append(jnp.zeros((3, n + chunk), jnp.float32))
        else:
            parts.append(_staged_rows3(jnp.asarray(vel, jnp.float32), perm,
                                       jnp.float32(0.0), chunk))
        del vel
        if ptype is None and mark is None:
            parts.append(jnp.zeros((1, n + chunk), jnp.float32))
        else:
            pt = (jnp.zeros(n, jnp.int32) if ptype is None
                  else jnp.asarray(ptype, jnp.int32))
            mk = (jnp.zeros(n, jnp.int32) if mark is None
                  else jnp.asarray(mark, bool).astype(jnp.int32))
            parts.append(_staged_row1(pt | (mk << 4), perm, chunk))
            del pt, mk
        del ptype, mark
        phi_s = (_take_rows(jnp.asarray(phi, jnp.float32), perm)
                 if has_phi else None)
        del phi
        soa8t = jnp.concatenate(parts, axis=0)
        del parts
        return CellGrid(m, lo, period, None, None, None, phi_s, None, None,
                        perm, starts, soa8t=soa8t, chunk=chunk,
                        uniform_mass=um)
    if owned and n >= STAGED_BUILD_MIN:
        # staged build, field-wise (the slab-less / SO_JAX_DEDUP=0
        # configurations): one permute per provided field, freeing each
        # unsorted input before touching the next; absent fields are
        # materialized directly as sorted zeros (permuting a constant
        # array is the identity).
        perm, starts = _codes_perm(m, lo, period, pos)
        pos_s = _take_rows(pos, perm)
        del pos
        mass_s = _take_rows(jnp.asarray(mass, jnp.float32), perm)
        del mass

        def _field(a, shape, dtype):
            if a is None:
                return jnp.zeros(shape, dtype)
            return _take_rows(jnp.asarray(a, dtype), perm)

        vel_s = _field(vel, (n, 3), jnp.float32)
        del vel
        phi_s = _field(phi, (n,), jnp.float32)
        del phi
        ptype_s = _field(ptype, (n,), jnp.int32)
        del ptype
        mark_s = _field(mark, (n,), bool)
        del mark
        out = (pos_s, mass_s, vel_s, phi_s, ptype_s, mark_s, perm, starts)
        del pos_s, mass_s, vel_s, phi_s, ptype_s, mark_s
    else:
        mass = jnp.asarray(mass, jnp.float32)
        vel = jnp.zeros((n, 3), jnp.float32) if vel is None else jnp.asarray(vel, jnp.float32)
        phi = jnp.zeros(n, jnp.float32) if phi is None else jnp.asarray(phi, jnp.float32)
        ptype = jnp.zeros(n, jnp.int32) if ptype is None else jnp.asarray(ptype, jnp.int32)
        mark = jnp.zeros(n, bool) if mark is None else jnp.asarray(mark, bool)
        build = (_build_device_donated
                 if owned and jax.default_backend() != "cpu" else _build_device)
        out = build(m, lo, period, pos, mass, vel, phi, ptype, mark)
        # free the unsorted device inputs before packing the payload — at
        # 512^3-class sizes the build-time memory peak is what limits a
        # single card
        del pos, mass, vel, phi, ptype, mark
    grid = CellGrid(m, lo, period, *out, chunk=chunk, uniform_mass=um)
    del out
    if slab:
        from .slab import pack_soa8t
        # NOT donated: XLA input->output aliasing needs matching
        # shape/layout, and none of the five sorted fields can alias the
        # single (8, n+chunk) payload — a donate_argnums here is a no-op
        # that only emits "Some donated buffers were not usable". The
        # sorted duplicates are freed right below by the dedup drop
        # instead; giant builds avoid them entirely via the staged
        # row-block path (STAGED_BUILD_MIN).
        pack = jax.jit(pack_soa8t, static_argnames=("chunk",))
        grid.soa8t = pack(grid.pos, grid.mass, grid.vel, grid.ptype,
                          grid.mark, chunk=grid.chunk)
        if dedup:
            # the payload encodes pos/mass/vel/ptype/mark bit-exactly —
            # drop the duplicates (XLA frees the buffers); rare fallback
            # paths reconstruct via the *_a() accessors
            grid.pos = grid.mass = grid.vel = None
            grid.ptype = grid.mark = None
            if not has_phi:
                grid.phi = None
    return grid
