"""Multi-host wiring: jax.distributed init + per-host snapshot segments.

The reference is a single process (SURVEY.md section 2.2); scaling out a
1024^3 snapshot means each host must read only its own slice of the file
and own only its shard of the particle population. The pieces:

  1. init_distributed() — jax.distributed.initialize from env/args; after
     this, jax.devices() spans all hosts and a Mesh built from it makes
     shard_map collectives cross processes automatically: they are XLA
     collectives, which NCCL carries on the GPU.
  2. host_segment(n, ...) — the [start, count) slice of the global
     particle file this host should read (io.tipsy.read_tipsy_segment
     seeks straight to it — no host ever touches the rest of the file).
  3. The (halo x part) stages in parallel.mesh are already SPMD over a
     Mesh; with a multi-host mesh they run unchanged.

This module is exercised in single-process form by the test suite; the
multi-process path follows jax.distributed's documented contract and is
validated on the 8-virtual-device host-platform mesh (tests/conftest.py).
"""

from __future__ import annotations

import os

import numpy as np


def init_distributed(coordinator_address: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None) -> bool:
    """Initialize jax.distributed for a multi-host run.

    Arguments default to the standard JAX environment variables
    (JAX_COORDINATOR_ADDRESS / JAX_NUM_PROCESSES / JAX_PROCESS_ID) or the
    cluster auto-detectors jax.distributed supports natively. Returns True
    if distributed mode was initialized, False for single-process runs
    (no coordinator configured) — callers can treat both uniformly.
    """
    import jax

    coordinator_address = (coordinator_address
                           or os.environ.get("JAX_COORDINATOR_ADDRESS"))
    if num_processes is None and "JAX_NUM_PROCESSES" in os.environ:
        num_processes = int(os.environ["JAX_NUM_PROCESSES"])
    if process_id is None and "JAX_PROCESS_ID" in os.environ:
        process_id = int(os.environ["JAX_PROCESS_ID"])
    if coordinator_address is None and num_processes is None:
        return False          # single-process: nothing to initialize
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes, process_id=process_id)
    return True


def host_segment(n: int, num_hosts: int | None = None,
                 host_id: int | None = None) -> tuple[int, int]:
    """The [start, count) slice of an n-particle snapshot owned by this
    host: contiguous, balanced (sizes differ by at most 1), covering.
    Defaults to jax.process_index()/process_count()."""
    import jax

    if num_hosts is None:
        num_hosts = jax.process_count()
    if host_id is None:
        host_id = jax.process_index()
    if not 0 <= host_id < num_hosts:
        raise ValueError(f"host_id {host_id} outside [0, {num_hosts})")
    base, rem = divmod(n, num_hosts)
    start = host_id * base + min(host_id, rem)
    count = base + (1 if host_id < rem else 0)
    return start, count


# ---------------------------------------------------------------------------
# Multi-process meshes and global-array plumbing
#
# The single-process path (parallel.mesh) builds global arrays by plain
# device_put; in a real multi-controller run every jax.Array spanning the
# mesh must be assembled from per-process shards. The helpers below are the
# only pieces that differ between the two worlds — the SPMD stages
# (solve/derived/members_stage_sharded) run unchanged on the global arrays.
# ---------------------------------------------------------------------------


def make_multihost_mesh(parts_per_host: int = 1):
    """(halo x part) Mesh with the 'part' axis laid out ACROSS hosts.

    Particle arrays are sharded along 'part', so placing that axis across
    hosts means each host materializes only its own particle segment (the
    per-host tipsy read); halo-sharded outputs stay fully addressable on
    every host because each host owns one device in every halo row.

    With P processes of L local devices each: mesh shape is
    (L // parts_per_host, P * parts_per_host) and column j lives entirely
    on host j // parts_per_host.
    """
    import jax
    from jax.sharding import Mesh

    devs = np.array(jax.devices())
    P_ = jax.process_count()
    L = devs.size // P_
    if L % parts_per_host:
        raise ValueError(f"{L} local devices not divisible by "
                         f"parts_per_host={parts_per_host}")
    n_halo = L // parts_per_host
    # devs is process-major; host h, column c, row i -> local device c*n_halo+i
    by_proc = devs.reshape(P_, parts_per_host, n_halo)
    mesh_devs = np.transpose(by_proc, (2, 0, 1)).reshape(
        n_halo, P_ * parts_per_host)
    return Mesh(mesh_devs, ("halo", "part"))


def grid_segment(n: int, mesh, process_id: int | None = None) -> tuple[int, int]:
    """[start, count) of the global particle file this host must read so
    that its 'part' columns of ``mesh`` cover exactly its own rows under
    the ShardedGrid split convention (shard s = rows [s*nl, (s+1)*nl) with
    nl = ceil(n / nshards), tail-padded)."""
    import jax

    if process_id is None:
        process_id = jax.process_index()
    nsh = mesh.shape["part"]
    pph = nsh // jax.process_count()
    nl = -(-n // nsh) if n else 0
    start = min(process_id * pph * nl, n)
    stop = min((process_id + 1) * pph * nl, n)
    return start, stop - start


def make_global(mesh, spec, value):
    """Global jax.Array from a host-replicated numpy value.

    Every process passes the same full ``value``; each places only its
    addressable shards. Works for replicated (P()) and sharded specs alike.
    """
    import jax
    from jax.sharding import NamedSharding

    value = np.asarray(value)
    sharding = NamedSharding(mesh, spec)
    idx_map = sharding.addressable_devices_indices_map(value.shape)
    arrays = [jax.device_put(value[idx], d) for d, idx in idx_map.items()]
    return jax.make_array_from_single_device_arrays(value.shape, sharding,
                                                    arrays)


def make_global_from_local(mesh, spec, local_block, global_shape, lo_row: int):
    """Global jax.Array sharded on axis 0 where this process holds only
    rows [lo_row, lo_row + local_block.shape[0]) of the global array."""
    import jax
    from jax.sharding import NamedSharding

    sharding = NamedSharding(mesh, spec)
    idx_map = sharding.addressable_devices_indices_map(tuple(global_shape))
    arrays = []
    for d, idx in idx_map.items():
        sl = idx[0]
        blk = local_block[sl.start - lo_row:sl.stop - lo_row]
        if blk.shape[0] != sl.stop - sl.start:
            raise ValueError(
                f"device {d} wants global rows [{sl.start},{sl.stop}) but "
                f"this host holds [{lo_row},{lo_row + local_block.shape[0]})")
        arrays.append(jax.device_put(blk, d))
    return jax.make_array_from_single_device_arrays(tuple(global_shape),
                                                    sharding, arrays)


def allgather_f64(a) -> np.ndarray:
    """process_allgather that PRESERVES float64 bits.

    jax.experimental.multihost_utils.process_allgather routes values
    through jax arrays, which silently truncate float64 to float32 when
    jax_enable_x64 is off (the default) — fatal for the f64 partial sums
    the distributed stats/vcm reductions exchange. Viewing the buffer as
    uint32 makes the transport bit-exact. Returns (P,) + a.shape float64.
    """
    from jax.experimental import multihost_utils

    a = np.ascontiguousarray(a, np.float64)
    raw = a.view(np.uint32)                      # (..., 2x last dim)
    out = np.ascontiguousarray(multihost_utils.process_allgather(raw))
    return out.view(np.float64).reshape((-1,) + a.shape)


def allgather_varlen(a: np.ndarray) -> list:
    """Bit-exact process_allgather of per-host 1-D arrays of DIFFERING
    lengths; returns one array per process, dtype preserved.

    Transport is uint32 views (process_allgather routes through jax
    arrays, which would truncate i64/f64 when x64 is off); lengths are
    gathered first so every host pads to the same global max. Used by the
    segmented conflict exchange (each host ships the sparse rows of its
    walked components)."""
    from jax.experimental import multihost_utils

    a = np.ascontiguousarray(a)
    dt = a.dtype
    raw = a.view(np.uint32)
    counts = np.asarray(multihost_utils.process_allgather(
        np.array([raw.shape[0]], np.int32))).reshape(-1)
    m = max(int(counts.max()), 1) if counts.size else 1
    pad = np.zeros(m, np.uint32)
    pad[:raw.shape[0]] = raw
    out = np.asarray(multihost_utils.process_allgather(pad)).reshape(-1, m)
    return [out[p, :int(counts[p])].view(dt) for p in range(out.shape[0])]


def fetch_sharded(arr) -> np.ndarray:
    """Host numpy from a (possibly multi-process) jax.Array whose shards
    are all addressable locally — true for P('halo')-sharded outputs of the
    across-host-'part' meshes built by make_multihost_mesh."""
    out = np.empty(arr.shape, arr.dtype)
    seen = np.zeros(arr.shape, bool)
    for s in arr.addressable_shards:
        out[s.index] = np.asarray(s.data)
        seen[s.index] = True
    if not seen.all():
        raise ValueError("output not fully addressable from this host "
                         "(is the mesh's 'part' axis across hosts?)")
    return out


def build_sharded_grid_segment(mesh, start: int, n_global: int, pos, mass,
                               vel=None, phi=None, ptype=None, mark=None,
                               period=(1.0, 1.0, 1.0), center=(0.0, 0.0, 0.0),
                               m: int | None = None,
                               slab: bool | None = None,
                               uniform_mass: float | None = None):
    """Multi-controller ShardedGrid: each host grids only its own particle
    segment (read via io.tipsy.read_tipsy_segment over grid_segment) and
    the global arrays are assembled shard-by-shard — no host ever holds
    the full snapshot. Split convention matches parallel.mesh.
    build_sharded_grid exactly, so single-process results are identical.

    ``uniform_mass`` is caller-asserted (a host sees only its segment, so
    it cannot detect GLOBAL mass uniformity itself): pass the single f32
    mass value only when every host agrees every particle carries it —
    run_so_distributed derives it with a process_allgather of per-segment
    (uniform, value) pairs. Same static aux on every process, or shard_map
    pytrees mismatch.
    """
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from ..ops.grid import _build_device, choose_m
    from .mesh import ShardedGrid

    pid = jax.process_index()
    nsh = mesh.shape["part"]
    pph = nsh // jax.process_count()
    nl = -(-n_global // nsh)
    want = grid_segment(n_global, mesh)
    pos = np.asarray(pos, np.float32)
    count = pos.shape[0]
    if (start, count) != want:
        raise ValueError(f"host {pid} segment ({start}, {count}) != "
                         f"expected {want} for this mesh")

    has_phi = phi is not None
    mass = np.asarray(mass, np.float32)
    vel = np.zeros((count, 3), np.float32) if vel is None else np.asarray(vel, np.float32)
    phi = np.zeros(count, np.float32) if phi is None else np.asarray(phi, np.float32)
    ptype = np.zeros(count, np.int32) if ptype is None else np.asarray(ptype, np.int32)
    mark = np.zeros(count, bool) if mark is None else np.asarray(mark, bool)
    period_a = np.asarray(period, np.float32)
    lo = np.asarray(center, np.float32) - period_a * 0.5
    if m is None:
        m = min(choose_m(max(n_global // nsh, 1)), 9)

    def pad_split(a, fill=0):
        out = np.full((pph * nl,) + a.shape[1:], fill, dtype=a.dtype)
        out[:count] = a
        return out.reshape((pph, nl) + a.shape[1:])

    valid = pad_split(np.ones(count, bool), False)
    gidx = pad_split(start + np.arange(count, dtype=np.int32), 0)

    build = jax.jit(jax.vmap(
        lambda p, ms, v, ph, pt, mk, va: _build_device(
            m, jnp.asarray(lo), jnp.asarray(period_a), p, ms, v, ph, pt, mk,
            va)))
    out = build(pad_split(pos), pad_split(mass), pad_split(vel),
                pad_split(phi), pad_split(ptype), pad_split(mark), valid)
    pos_s, mass_s, vel_s, phi_s, ptype_s, mark_s, perm_s, starts_s = out
    orig = jnp.take_along_axis(jnp.asarray(gidx), perm_s, axis=1)

    from functools import partial as _partial

    from ..ops.grid import choose_chunk, slab_default

    if slab is None:
        # same default as the single-process build_sharded_grid
        slab = slab_default()
    chunk = choose_chunk(max(n_global // nsh, 1), m)
    soa_s = None
    if slab:
        from ..ops.slab import pack_soa8t
        soa_s = jax.jit(jax.vmap(_partial(pack_soa8t, chunk=chunk)))(
            pos_s, mass_s, vel_s, ptype_s, mark_s)
        if os.environ.get("SO_JAX_DEDUP", "1") != "0":
            # same dedup as build_sharded_grid: the payload encodes
            # pos/mass/vel/ptype/mark bit-exactly
            pos_s = mass_s = vel_s = ptype_s = mark_s = None
            if not has_phi:
                phi_s = None

    lo_row = pid * pph
    gp = lambda a: None if a is None else make_global_from_local(
        mesh, P("part"), np.asarray(a), (nsh,) + a.shape[1:], lo_row)
    return ShardedGrid(
        m, make_global(mesh, P(), lo), make_global(mesh, P(), period_a),
        gp(pos_s), gp(mass_s), gp(vel_s), gp(phi_s), gp(ptype_s), gp(mark_s),
        gp(orig), tuple(gp(s) for s in starts_s),
        gp(soa_s), chunk=chunk, uniform_mass=uniform_mass)
