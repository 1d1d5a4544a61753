"""Real multi-process jax.distributed exercise (SURVEY.md section 5,
"distributed communication backend").

Two local processes join a localhost coordinator, each with 4 virtual CPU
devices, forming a global 8-device (4 halo x 2 part) mesh whose 'part'
axis crosses the process boundary — the all_gather/psum merges in
solve/members_stage_sharded ride real cross-process collectives. Each
process reads only its own half of the snapshot file. Results must equal
the single-process solver on the same problem.
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

from fixtures import make_clumpy_box, write_snapshot  # noqa: E402


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def problem(tmp_path_factory):
    workdir = tmp_path_factory.mktemp("dist")
    rng = np.random.default_rng(23)
    clumps = [
        dict(center=(0.1, 0.0, -0.1), n=1200, rmax=0.06, mass_total=0.2),
        dict(center=(-0.25, 0.3, 0.2), n=700, rmax=0.04, mass_total=0.08),
    ]
    d = make_clumpy_box(rng, n_background=2500, clumps=clumps)
    write_snapshot(str(workdir / "snap.bin"), d)
    base = np.array([[0.1, 0.0, -0.1], [-0.25, 0.3, 0.2]], np.float32)
    centers = np.concatenate(
        [base, base + rng.normal(size=(2, 3)).astype(np.float32) * 0.01,
         np.array([[0.45, -0.4, 0.3]], np.float32),      # background: no halo
         base[:1] + 0.005, base[1:] - 0.005, base[:1]])
    radii = rng.uniform(0.04, 0.06, centers.shape[0]).astype(np.float32)
    assert centers.shape[0] % 4 == 0                     # halo-axis multiple
    np.savez(workdir / "problem.npz", centers=centers, radii=radii,
             thr=np.float32(178.0))
    return workdir, d, centers, radii


@pytest.mark.distributed
def test_two_process_distributed_solve(problem):
    workdir, d, centers, radii = problem
    port = _free_port()
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("XLA_", "JAX_"))}
    env["TF_CPP_MIN_LOG_LEVEL"] = "3"
    procs = [
        subprocess.Popen(
            [sys.executable, os.path.join(HERE, "distributed_worker.py"),
             str(port), str(pid), "2", "4", str(workdir)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)
        for pid in range(2)
    ]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=600)
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"worker {pid} failed:\n{out[-4000:]}"
        assert f"DISTRIBUTED_WORKER_OK pid={pid}" in out

    # equality with the single-process solver (same stage parameters)
    import jax.numpy as jnp

    from so_jax.engine.members import extract_members
    from so_jax.engine.solver import _solve_stage, unpack_stage_out
    from so_jax.ops import build_grid

    grid = build_grid(d["pos"], d["mass"], vel=d["vel"], phi=d["phi"], m=3,
                      slab=False)
    packed = _solve_stage(grid, 1, 2048, 7, 8, jnp.asarray(centers),
                          jnp.asarray(radii), jnp.float32(178.0))
    ints, flts = unpack_stage_out(np.asarray(packed))
    got = np.load(workdir / "results.npz")

    assert not ints[:, 3].any()                  # no overflow
    np.testing.assert_array_equal(got["found"], ints[:, 2].astype(bool))
    np.testing.assert_array_equal(got["jstar"], ints[:, 1])
    np.testing.assert_allclose(got["mvir"], flts[:, 0], rtol=2e-6)
    np.testing.assert_allclose(got["rvir"], flts[:, 1], rtol=2e-6)
    np.testing.assert_allclose(got["d2cut"], flts[:, 2], rtol=2e-6)

    found = ints[:, 2].astype(bool)
    want_members, want_vcm = extract_members(
        grid, centers[found], flts[found, 2], ints[found, 1],
        flts[found, 0])
    mcounts = got["mcounts"]
    seg = np.cumsum(mcounts)
    gi = 0
    for g in range(centers.shape[0]):
        if not found[g]:
            assert mcounts[g] == 0
            continue
        lo = seg[g - 1] if g else 0
        mine = got["members"][lo:seg[g]]
        # tie order at equal d2 is arbitrary; the member SET is exact
        np.testing.assert_array_equal(np.sort(mine),
                                      np.sort(want_members[gi]))
        np.testing.assert_allclose(got["vcm"][g], want_vcm[gi], rtol=2e-5,
                                   atol=1e-7)
        gi += 1


@pytest.mark.distributed
@pytest.mark.parametrize("variant", [
    "plain",
    # uniform-mass variant: the driver's process_allgather verdict must
    # come back True on BOTH processes and the sharded uniform stages
    # (mass channel dropped, ladder cum) must stay byte-identical to the
    # single-process CLI, which takes its own uniform path
    pytest.param("uniform", marks=pytest.mark.slow),
    # zoom multi-species variant: per-host segment reads crossing the
    # gas/dark/star iOrder boundaries, cross-process species profiles
    # (-all), and ~2-orders-of-magnitude mass spread in the merges
    pytest.param("zoom", marks=pytest.mark.slow),
    # multi-threshold variant (--distributed --deltas):
    # the shared-gather multi solve across processes
    # (run_so_multi_distributed) + full per-threshold post-processing
    pytest.param("deltas", marks=pytest.mark.slow)])
def test_distributed_cli_matches_single_process(tmp_path, variant):
    """run_so_distributed end-to-end: a REAL 2-process
    `so_jax --distributed` CLI run — per-host segment reads, cross-process
    sharded solve + fused members/derived, replicated conflict pass,
    partial-merged vcm/stats — must write outputs byte-identical to the
    single-process CLI (modulo the run-timestamp header line)."""
    from fixtures import make_zoom_box, write_gtp

    from so_jax.cli import main

    workdir = str(tmp_path)
    rng = np.random.default_rng(61)
    if variant == "zoom":
        d, split, zcenters, zrmax = make_zoom_box(rng, 2400, 600, 6)
        write_snapshot(f"{workdir}/snap.bin", d, split=split)
        write_gtp(f"{workdir}/cat.gtp", zcenters, zrmax,
                  rng.uniform(0.01, 1.0, zcenters.shape[0]))
    else:
        clumps = [
            dict(center=(0.1, 0.0, -0.1), n=1100, rmax=0.06,
                 mass_total=0.2),
            dict(center=(-0.25, 0.3, 0.2), n=700, rmax=0.04,
                 mass_total=0.08),
            dict(center=(0.12, 0.02, -0.08), n=400, rmax=0.03,
                 mass_total=0.03),   # overlaps clump 0 -> conflicts
        ]
        d = make_clumpy_box(rng, n_background=2500, clumps=clumps)
        if variant == "uniform":
            d["mass"] = np.full(d["pos"].shape[0],
                                np.float32(1.0 / d["pos"].shape[0]))
        write_snapshot(f"{workdir}/snap.bin", d)
        write_gtp(f"{workdir}/cat.gtp",
                  [c["center"] for c in clumps] + [(0.45, -0.4, 0.3)],
                  [0.05, 0.04, 0.03, 0.02], [0.2, 0.08, 0.03, 0.01])
    # --survey forces the classify pre-pass in BOTH runs: single-process
    # via engine.solver._classify_stage, distributed via
    # parallel.driver.dist_classify_fn (the cross-process kk-prefix
    # merge) — the byte-identity check below covers their equivalence
    extra = (["-all"] if variant == "zoom" else ["-dark"]) \
        + ["-grp", "-gtp", "-subsumed", "-ignored", "--survey"]
    if variant == "deltas":
        extra += ["--deltas", "178,200,500"]

    assert main(["-i", f"{workdir}/cat.gtp", "--tipsy",
                 f"{workdir}/snap.bin", "-o", f"{workdir}/single"]
                + extra) == 0

    port = _free_port()
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("XLA_", "JAX_"))}
    env["TF_CPP_MIN_LOG_LEVEL"] = "3"
    procs = [
        subprocess.Popen(
            [sys.executable,
             os.path.join(HERE, "distributed_cli_worker.py"),
             str(port), str(pid), "2", "4", workdir] + extra,
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)
        for pid in range(2)
    ]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=600)
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"worker {pid} failed:\n{out[-4000:]}"
        assert f"DISTRIBUTED_CLI_OK pid={pid}" in out

    exts = ("sovcirc", "sogrp", "sosub", "soign", "sodark") \
        + (("sogas", "sostar") if variant == "zoom" else ())
    # under --deltas every output file is written once per threshold
    bases = ([("single.d178", "dist.d178"), ("single.d200", "dist.d200"),
              ("single.d500", "dist.d500")] if variant == "deltas"
             else [("single", "dist")])
    for sb, db in bases:
        for ext in exts:
            a = [l for l in open(f"{workdir}/{sb}.{ext}", "rb").read()
                 .splitlines() if not (l.startswith(b"# Run on")
                                       or b"written to" in l)]
            b = [l for l in open(f"{workdir}/{db}.{ext}", "rb").read()
                 .splitlines() if not (l.startswith(b"# Run on")
                                       or b"written to" in l)]
            assert a == b, (sb, ext)
        assert open(f"{workdir}/{sb}.sogtp", "rb").read() == \
            open(f"{workdir}/{db}.sogtp", "rb").read()


def test_segment_grid_matches_inprocess_sharded():
    """Single-process sanity: build_sharded_grid_segment(start=0, full
    snapshot) over an in-process mesh == build_sharded_grid exactly."""
    import jax

    from so_jax.parallel import build_sharded_grid, make_mesh
    from so_jax.parallel.distributed import (build_sharded_grid_segment,
                                             grid_segment, make_multihost_mesh)

    rng = np.random.default_rng(5)
    d = make_clumpy_box(rng, n_background=1000,
                        clumps=[dict(center=(0.1, 0.0, 0.0), n=500,
                                     rmax=0.05, mass_total=0.2)])
    mesh = make_multihost_mesh(parts_per_host=2)   # (4, 2) single-process
    n = d["pos"].shape[0]
    start, count = grid_segment(n, mesh)
    assert (start, count) == (0, n)
    sg = build_sharded_grid_segment(mesh, 0, n, d["pos"], d["mass"],
                                    vel=d["vel"], m=3)
    ref_mesh = make_mesh(4, 2)
    sg_ref = build_sharded_grid(d["pos"], d["mass"], vel=d["vel"], m=3,
                                mesh=ref_mesh, slab=False)
    np.testing.assert_array_equal(np.asarray(sg.pos), np.asarray(sg_ref.pos))
    np.testing.assert_array_equal(np.asarray(sg.mass),
                                  np.asarray(sg_ref.mass))
    np.testing.assert_array_equal(np.asarray(sg.orig_idx),
                                  np.asarray(sg_ref.orig_idx))
    for a, b in zip(sg.starts, sg_ref.starts):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_segment_grid_pallas_payload_matches():
    """build_sharded_grid_segment with the slab payload == the
    in-process builder's payload (chunk threading included)."""
    from so_jax.parallel import build_sharded_grid
    from so_jax.parallel.distributed import (build_sharded_grid_segment,
                                             make_multihost_mesh)

    rng = np.random.default_rng(8)
    d = make_clumpy_box(rng, n_background=800,
                        clumps=[dict(center=(0.1, 0.0, 0.0), n=400,
                                     rmax=0.05, mass_total=0.2)])
    mesh = make_multihost_mesh(parts_per_host=2)
    n = d["pos"].shape[0]
    sg = build_sharded_grid_segment(mesh, 0, n, d["pos"], d["mass"],
                                    m=2, slab=True)
    from so_jax.parallel import make_mesh
    ref = build_sharded_grid(d["pos"], d["mass"], m=2,
                             mesh=make_mesh(4, 2), slab=True)
    assert sg.soa8t is not None and ref.soa8t is not None
    assert sg.chunk == ref.chunk
    np.testing.assert_array_equal(np.asarray(sg.soa8t),
                                  np.asarray(ref.soa8t))


# ---------------------------------------------------------------------------
# Segmented conflict phase pieces (single-process forms; the 2-process CLI
# byte test above exercises the real cross-process exchange)
# ---------------------------------------------------------------------------


def test_dist_conflict_fn_matches_serial_single_process():
    """parallel.driver.dist_conflict_fn with P=1 reproduces the serial
    resolve_conflicts bit-for-bit. Member lists are fed in the driver's
    SEGMENTED form (seg_member_filter over each full list — with one
    host the segment is the whole box; restricted multi-segment splits
    are fuzzed by the threaded-hub test below), exercising the
    per-segment edge discovery, local singleton tagging, and the
    rank-scatter reassembly of multi-component lists."""
    from test_native import _random_case

    from so_jax.engine.conflicts import resolve_conflicts
    from so_jax.parallel.driver import dist_conflict_fn, seg_member_filter

    rng = np.random.default_rng(31)
    args = _random_case(rng, n_groups=50)
    index, pos, mvir, rvir, code, order, members, n = args
    want = resolve_conflicts(*args)

    filt = seg_member_filter(0, n)
    members_seg = [None if m is None else filt(m) for m in members]
    got = dist_conflict_fn(0, n)(
        index, pos, mvir, rvir, code, order, members_seg, n)
    assert (got.seg_start, got.seg_count, got.n_global) == (0, n, n)
    np.testing.assert_array_equal(got.igrp, want.igrp)
    np.testing.assert_array_equal(got.n_subsumed, want.n_subsumed)
    np.testing.assert_array_equal(got.n_ignored, want.n_ignored)
    np.testing.assert_array_equal(got.mvir, want.mvir)
    np.testing.assert_array_equal(got.rvir, want.rvir)
    np.testing.assert_array_equal(got.slurped_own, want.slurped_own)
    assert (got.groups_removed, got.groups_slurped) \
        == (want.groups_removed, want.groups_slurped)


class _Hub:
    """Barrier-synchronised value exchange for N virtual hosts running in
    threads — stands in for the jax.distributed collectives so the
    segmented conflict walk can be fuzzed across multi-host segment
    configurations without spawning processes."""

    def __init__(self, nproc):
        import threading

        self.nproc = nproc
        self.slots = [None] * nproc
        self.b1 = threading.Barrier(nproc)
        self.b2 = threading.Barrier(nproc)

    def exchange(self, pid, value):
        self.slots[pid] = value
        self.b1.wait(timeout=120)
        out = list(self.slots)
        self.b2.wait(timeout=120)
        return out

    def abort(self):
        self.b1.abort()
        self.b2.abort()


class _ThreadTransport:
    """dist_conflict_fn transport duck type over a _Hub."""

    def __init__(self, hub, pid):
        self.hub = hub
        self.nproc = hub.nproc
        self.pid = pid

    def allgather_varlen(self, a):
        return self.hub.exchange(self.pid, np.ascontiguousarray(a))

    def process_allgather(self, tree):
        vals = self.hub.exchange(self.pid, tuple(np.asarray(x)
                                                 for x in tree))
        return tuple(np.stack([v[i] for v in vals])
                     for i in range(len(tree)))


def test_dist_conflict_fn_multihost_threaded_fuzz():
    """The SEGMENTED conflict walk (per-segment edge discovery, local
    singleton tagging, rank-scatter reassembly, sparse result exchange)
    over 2- and 3-host segment splits must reproduce the serial
    resolve_conflicts bit-for-bit on random conflict graphs. Virtual
    hosts run in threads over a barrier hub standing in for the
    jax.distributed collectives."""
    import threading

    from test_native import _random_case

    from so_jax.engine.conflicts import resolve_conflicts
    from so_jax.parallel.driver import dist_conflict_fn, seg_member_filter

    for seed in (5, 12, 77):
        rng = np.random.default_rng(seed)
        args = _random_case(rng, n_groups=60)
        index, pos, mvir, rvir, code, order, members, n = args
        want = resolve_conflicts(*args)

        for nproc in (2, 3):
            bounds = np.linspace(0, n, nproc + 1).astype(np.int64)
            hub = _Hub(nproc)
            results = [None] * nproc
            errors = [None] * nproc

            def run(pid):
                try:
                    start = int(bounds[pid])
                    count = int(bounds[pid + 1]) - start
                    filt = seg_member_filter(start, count)
                    ms = [None if m is None else filt(m) for m in members]
                    tr = _ThreadTransport(hub, pid)
                    results[pid] = dist_conflict_fn(
                        start, count, transport=tr)(
                        index, pos, mvir, rvir, code, order, ms, n)
                except BaseException as e:   # noqa: BLE001
                    errors[pid] = e
                    hub.abort()

            threads = [threading.Thread(target=run, args=(p,))
                       for p in range(nproc)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=180)
            for e in errors:
                assert e is None, f"virtual host failed: {e!r}"

            np.testing.assert_array_equal(
                np.concatenate([r.igrp for r in results]), want.igrp)
            np.testing.assert_array_equal(
                np.concatenate([r.n_subsumed for r in results]),
                want.n_subsumed)
            np.testing.assert_array_equal(
                np.concatenate([r.n_ignored for r in results]),
                want.n_ignored)
            for r in results:     # per-group columns are host-replicated
                np.testing.assert_array_equal(r.mvir, want.mvir)
                np.testing.assert_array_equal(r.rvir, want.rvir)
                np.testing.assert_array_equal(r.slurped_own,
                                              want.slurped_own)
                assert (r.groups_removed, r.groups_slurped) \
                    == (want.groups_removed, want.groups_slurped)


def test_int_array_text_length_exact_and_segment_write(tmp_path):
    """int_array_text_length matches the formatted byte count exactly
    (including negatives and powers of ten), and a cooperative segment
    write reproduces write_array_file byte-for-byte."""
    from so_jax.io.writers import (int_array_text_length, write_array_file,
                                   write_int_array_segment)
    from so_jax.parallel.driver import write_array_file_segments

    edge = np.array([0, 1, -1, 9, 10, 99, 100, 999, 1000, 10**6 - 1, 10**6,
                     -10**6, 2**31 - 1, -2**31 + 1], np.int64)
    rng = np.random.default_rng(7)
    v = np.concatenate([edge, rng.integers(-50, 10**7, 20000)])
    body = b"".join(b"%d\n" % x for x in v.tolist())
    assert int_array_text_length(v) == len(body)

    v32 = v.astype(np.int32)
    a, b = str(tmp_path / "a"), str(tmp_path / "b")
    write_array_file(a, v32)
    write_array_file_segments(b, v32, v32.shape[0])
    assert open(a, "rb").read() == open(b, "rb").read()

    # manual two-segment write against the one-shot file
    c = str(tmp_path / "c")
    cut = 1234
    header = b"%d\n" % v32.shape[0]
    with open(c, "wb") as fp:
        fp.write(header)
        fp.truncate(len(header) + int_array_text_length(v32))
    write_int_array_segment(c, v32[:cut], len(header))
    write_int_array_segment(c, v32[cut:],
                            len(header) + int_array_text_length(v32[:cut]))
    assert open(c, "rb").read() == open(a, "rb").read()


def test_allgather_varlen_single_process():
    from so_jax.parallel.distributed import allgather_varlen

    for arr in (np.arange(7, dtype=np.int64) * (1 << 40),
                np.zeros(0, np.int64),
                np.array([-3, 2**31 - 1], np.int32),
                np.array([1.5, -0.25], np.float64)):
        out = allgather_varlen(arr)
        assert len(out) == 1 and out[0].dtype == arr.dtype
        np.testing.assert_array_equal(out[0], arr)


@pytest.mark.distributed
def test_distributed_checkpoint_resume(tmp_path):
    """--checkpoint under --distributed: run 1 saves
    one segment shard per host after the device phase
    (checkpoint.save_solve_segment — replicated solve arrays + this
    host's SegRows member pieces); run 2, in FRESH processes, resumes
    every host straight into the host-side conflict/derived/writer
    phases. Both runs' outputs must be byte-identical to each other and
    to the single-process CLI."""
    import glob
    import shutil

    from fixtures import write_gtp

    from so_jax.cli import main

    workdir = str(tmp_path)
    rng = np.random.default_rng(67)
    clumps = [
        dict(center=(0.1, 0.0, -0.1), n=1100, rmax=0.06, mass_total=0.2),
        dict(center=(-0.25, 0.3, 0.2), n=700, rmax=0.04, mass_total=0.08),
        dict(center=(0.12, 0.02, -0.08), n=400, rmax=0.03,
             mass_total=0.03),        # overlaps clump 0 -> conflicts
    ]
    d = make_clumpy_box(rng, n_background=2500, clumps=clumps)
    write_snapshot(f"{workdir}/snap.bin", d)
    write_gtp(f"{workdir}/cat.gtp",
              [c["center"] for c in clumps] + [(0.45, -0.4, 0.3)],
              [0.05, 0.04, 0.03, 0.02], [0.2, 0.08, 0.03, 0.01])
    extra = ["-dark", "-grp", "-gtp", "-subsumed", "-ignored"]
    assert main(["-i", f"{workdir}/cat.gtp", "--tipsy",
                 f"{workdir}/snap.bin", "-o", f"{workdir}/single"]
                + extra) == 0

    ck = f"{workdir}/ck.npz"

    def run_pair():
        port = _free_port()
        env = {k: v for k, v in os.environ.items()
               if not k.startswith(("XLA_", "JAX_"))}
        env["TF_CPP_MIN_LOG_LEVEL"] = "3"
        procs = [
            subprocess.Popen(
                [sys.executable,
                 os.path.join(HERE, "distributed_cli_worker.py"),
                 str(port), str(pid), "2", "4", workdir] + extra
                + ["--checkpoint", ck, "--verbose"],
                env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)
            for pid in range(2)
        ]
        outs = []
        try:
            for p in procs:
                out, _ = p.communicate(timeout=600)
                outs.append(out)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
        for pid, (p, out) in enumerate(zip(procs, outs)):
            assert p.returncode == 0, f"worker {pid} failed:\n{out[-4000:]}"
            assert f"DISTRIBUTED_CLI_OK pid={pid}" in out
        return outs

    outs_a = run_pair()
    shards = sorted(glob.glob(f"{ck}.rank*-of-2.npz"))
    assert len(shards) == 2, shards
    assert any("checkpoint save (segment)" in o for o in outs_a)
    exts = ("sovcirc", "sogrp", "sosub", "soign", "sodark", "sogtp")
    for ext in exts:
        shutil.copy(f"{workdir}/dist.{ext}", f"{workdir}/distA.{ext}")

    outs_b = run_pair()
    # the rerun must actually RESUME (no solve phase), on both hosts'
    # participation — the verbose timer report prints on process 0
    assert any("checkpoint resume (segment)" in o for o in outs_b)
    assert not any("R_Delta solve (distributed)" in o for o in outs_b)

    strip = lambda p: [l for l in open(p, "rb").read().splitlines()
                       if not (l.startswith(b"# Run on")
                               or b"written to" in l)]
    for ext in exts[:-1]:
        single = strip(f"{workdir}/single.{ext}")
        assert strip(f"{workdir}/distA.{ext}") == single, ext
        assert strip(f"{workdir}/dist.{ext}") == single, ext
    assert open(f"{workdir}/distA.sogtp", "rb").read() == \
        open(f"{workdir}/single.sogtp", "rb").read()
    assert open(f"{workdir}/dist.sogtp", "rb").read() == \
        open(f"{workdir}/single.sogtp", "rb").read()
