"""One process of a real multi-controller jax.distributed CPU run.

Launched (twice) by tests/test_distributed.py:

    python distributed_worker.py <coordinator_port> <process_id> \
        <num_processes> <local_devices> <workdir>

Each process forces the virtual-CPU platform, joins the localhost
coordinator via so_jax.parallel.distributed.init_distributed, reads ONLY
its own segment of the snapshot (read_tipsy_segment), builds its shards of
the global grid, runs the sharded solve + member stages over the global
2-host mesh (all_gather/psum cross process boundaries), checkpoints its
halo slice (save_solve_sharded) and reloads the merged checkpoint
(load_solve_sharded). Process 0 writes the fetched results for the parent
to compare against the single-process solver.
"""

import os
import sys

port, pid, nproc, ldev, workdir = sys.argv[1:6]
pid, nproc, ldev = int(pid), int(nproc), int(ldev)

os.environ["XLA_FLAGS"] = f"--xla_force_host_platform_device_count={ldev}"
os.environ["JAX_PLATFORMS"] = "cpu"
os.environ.setdefault("TF_CPP_MIN_LOG_LEVEL", "3")
os.environ["SO_JAX_SLAB"] = "0"

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from so_jax.engine.solver import SolveResult  # noqa: E402
from so_jax.checkpoint import (load_solve_sharded,  # noqa: E402
                               save_solve_sharded)
from so_jax.io.tipsy import read_header, read_tipsy_segment  # noqa: E402
from so_jax.parallel.distributed import (build_sharded_grid_segment,  # noqa: E402
                                         fetch_sharded, grid_segment,
                                         init_distributed, make_global,
                                         make_multihost_mesh)
from so_jax.parallel.mesh import (members_stage_sharded,  # noqa: E402
                                  solve_stage_sharded)

assert init_distributed(f"localhost:{port}", nproc, pid) is True
assert jax.process_count() == nproc, jax.process_count()
assert jax.device_count() == nproc * ldev, jax.device_count()

snap = os.path.join(workdir, "snap.bin")
with open(snap, "rb") as fp:
    hdr = read_header(fp, standard=False)
n = hdr.nbodies

mesh = make_multihost_mesh()   # 'part' across the 2 hosts, 'halo' within
start, count = grid_segment(n, mesh)
pset = read_tipsy_segment(snap, start, count)
assert pset.n == count

sgrid = build_sharded_grid_segment(
    mesh, start, n, pset.pos, pset.mass, vel=pset.vel, phi=pset.phi, m=3)

prob = np.load(os.path.join(workdir, "problem.npz"))
centers, radii, thr = prob["centers"], prob["radii"], float(prob["thr"])

centers_g = make_global(mesh, P("halo"), centers)
radii_g = make_global(mesh, P("halo"), radii)
thr_g = make_global(mesh, P(), np.float32(thr))

out = solve_stage_sharded(mesh, sgrid, 1, 2048, 7, 8,
                          centers_g, radii_g, thr_g)
res = {k: fetch_sharded(v) for k, v in out.items()}

# member lists for the found halos (padded to the full batch: the halo
# axis is mesh-sharded) — cover radius just past d2cut, like
# engine.members.extract_members
found = res["found"]
d2cut = np.where(found, res["d2cut"], 0.0).astype(np.float32)
cover = np.nextafter(np.sqrt(d2cut.astype(np.float64)).astype(np.float32),
                     np.float32(np.inf)) * np.float32(1.0 + 1e-6)
jarr = np.where(found, res["jstar"], 0).astype(np.int32)
mvir = np.where(found, res["mvir"], 1.0).astype(np.float32)

orig, n_in_m, ovf_m = members_stage_sharded(
    mesh, sgrid, 1, 2048, 7,
    make_global(mesh, P("halo"), np.where(found, centers.T, 0.0).T
                .astype(np.float32)),
    make_global(mesh, P("halo"), np.where(found, cover, 1e-30)
                .astype(np.float32)),
    make_global(mesh, P("halo"), d2cut),
    make_global(mesh, P("halo"), jarr))
assert not fetch_sharded(ovf_m).any()
orig_np = fetch_sharded(orig)
members = []
for g in range(centers.shape[0]):
    rows = orig_np[g]
    members.append(rows[rows >= 0][:jarr[g]].astype(np.int64)
                   if found[g] else None)

# vcm from the member lists via per-segment partials merged across the
# two processes — the ONE _VcmParticles accumulation order
# (parallel.driver.dist_vcm_fn over engine.members.member_mv_sums)
from so_jax.parallel.driver import dist_vcm_fn  # noqa: E402

mcounts_all = np.array([0 if m is None else m.size for m in members],
                       np.int64)
rows_all = (np.concatenate([m for m in members if m is not None and m.size])
            if mcounts_all.sum() else np.zeros(0, np.int64))
vcm_np = dist_vcm_fn(pset.vel * pset.mass[:, None], start)(
    rows_all, mcounts_all, mvir)

# sharded checkpoint round-trip across the two processes
solve = SolveResult(
    code=np.where(found, 0, -3).astype(np.int32),
    mvir=res["mvir"].astype(np.float32), rvir=res["rvir"].astype(np.float32),
    j=jarr, d2cut=res["d2cut"].astype(np.float32),
    vcm=vcm_np.astype(np.float32))
ckpt = os.path.join(workdir, "ckpt")
save_solve_sharded(ckpt, solve, members, centers)

from jax.experimental import multihost_utils  # noqa: E402

multihost_utils.sync_global_devices("so_jax_ckpt_written")

solve2, members2, centers2 = load_solve_sharded(ckpt, nproc)
np.testing.assert_array_equal(solve2.code, solve.code)
np.testing.assert_array_equal(solve2.mvir, solve.mvir)
np.testing.assert_array_equal(solve2.j, solve.j)
np.testing.assert_array_equal(centers2, centers)
for a, b in zip(members2, members):
    if b is None:
        assert a is None or a.size == 0
    else:
        np.testing.assert_array_equal(a, b)

if pid == 0:
    np.savez(os.path.join(workdir, "results.npz"),
             found=found, jstar=res["jstar"], mvir=res["mvir"],
             rvir=res["rvir"], d2cut=res["d2cut"], vcm=vcm_np,
             members=np.concatenate([m for m in members if m is not None]
                                    or [np.zeros(0, np.int64)]),
             mcounts=np.array([0 if m is None else m.size for m in members]))

multihost_utils.sync_global_devices("so_jax_done")
print(f"DISTRIBUTED_WORKER_OK pid={pid}", flush=True)
