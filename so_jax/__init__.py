"""so_jax — spherical-overdensity halo characterization engine in JAX.

A from-scratch JAX/XLA rebuild of the capabilities of the serial C
program ``so`` (N-BodyShop, "SO Release 1.7", reference: so.c:208): given a
tipsy particle snapshot and a catalog of candidate halo centers, find for
each center the smallest radius R at which the mean enclosed density falls
below a threshold, the enclosed mass M_Delta, circular-velocity profile,
half/quarter-mass radii, Vmax/Rmax, per-species radial mass profiles, and
per-particle group membership with the deterministic mass-ordered
subsume/slurp/retain conflict protocol (reference: so.c:24-43, kd2.c:663-720).

Architecture (accelerator-first, not a port):
  - Morton-sorted multi-level cell grid in device memory replaces the kd-tree
    (reference: kd2.c:1013-1185).
  - Batched ragged cell gathers + vectorized distance/sort/scan replace the
    per-halo ball-gather loop (reference: smooth2.c:58-114, kd2.c:723-840).
  - Thousands of centers are solved concurrently per card; multi-card scaling
    via jax.sharding/shard_map over a device mesh with psum/all_gather
    collectives.
  - The inherently sequential mass-ordered conflict protocol runs as a
    vectorized host pass over device-produced membership lists.
"""

from .version import __version__

__all__ = ["__version__"]
