"""Command-line driver with full reference flag parity (so.c:192-575).

All 29 reference flags are accepted with identical semantics and defaults:
-i -o -z -O -L -s -rho -delta -m -p -c -cx -cy -cz -std -M -u -list -grp
-gtp -pot -subsumed -ignored -stat -mark -dark -gas -star -all
(-rho is the reference's tombstone: it errors and points at -delta,
so.c:310-315; -s is parsed but absent from the reference usage text,
so.c:304-308 — here it is documented.)

Additional so_jax flags are double-dashed and optional: --tipsy reads the
snapshot from a file instead of stdin; --verbose adds engine timings.
"""

from __future__ import annotations

import sys
import time as _time

import numpy as np

from .cosmology import rhovir_over_rhobar
from .engine.pipeline import SOParams, run_so
from .io.catalogs import read_gtp_list, read_mark, read_stat
from .io.tipsy import DARK, GAS, STAR, MARK, read_tipsy
from .io.writers import (SPECIES_EXT, write_array_file, write_profile_file,
                         write_sogtp, write_sovcirc_header, write_sovcirc_rows)
from .stats import format_stats
from .units import unit_conversions
from .version import BANNER

USAGE = """USAGE:
so_jax -i <SKID .gtp file> [-o <outfilebase>] [([-dark] [-gas] [-star]) || [-all])]
      [-mark <markfile>]  [-std]  [-grp] [-gtp] [-subsumed] [-ignored]
      [-list <File containing group indexes>]
      [-pot || -stat <SKID .stat file containing most-bound-particle positions>]
      [-delta <fThreshold>] [-M <fMinGTPMass>] [-m <mMinSOMembers>]
      [-O <fOmega0>]  [-L]  [-z <fRedshift>]  [-s <nSmooth>]
      [-p <xyzPeriod>]  [-c <xyzCenter>]
      [-cx <xCenter>]  [-cy <yCenter>]  [-cz <zCenter>]
      [-u <fMassUnit> <fMpcUnit>]
      [--tipsy <snapshot>] [--verbose] [--profile <trace-dir>]
      [--deltas d1,d2,...] [--checkpoint <state.npz>] [--mesh HxP]
      [--survey] [--distributed]

Spherical-overdensity halo characterization (JAX engine). For every
group center in the input .gtp catalog, finds the smallest radius R inside
which the mean density drops below the threshold, plus enclosed mass,
quarter/half-mass radii, Vmax and its radius, and Vc at (1/4..2)R; main
catalog goes to <outfilebase>.sovcirc (default so.sovcirc). The particle
snapshot is read from stdin (or --tipsy <file>).

  -dark/-gas/-star/-all  per-species 16-bin radial mass profiles to
                         .sodark/.sogas/.sostar
  -mark <file>           profile of marked particles to .somark
  -std                   read/write big-endian ("standard") tipsy binaries
  -grp/-gtp              write .sogrp membership / .sogtp catalog; ids match
                         the input .gtp group numbers
  -pot                   recenter on the minimum-Phi particle within the
                         input group radius
  -stat <file>           recenter on SKID .stat most-bound positions
                         (mutually exclusive with -pot)
  -delta <d>             overdensity threshold (default: virial density from
                         cosmology); converted to density via *Omega0
  -L                     set Lambda0 = 1 - Omega0
  -z <z>                 redshift (default 1/h.time - 1 from the snapshot)
  -p/-c/-cx/-cy/-cz      periodic box size and center (default 1, 0);
                         periodic boundaries are always assumed
  -M <m>                 minimum input group mass to consider
  -m <n>                 minimum members for a valid group (default 8)
  -u <Msol> <Mpc>        output units: Msol, kpc, km/s
  -subsumed/-ignored     write .sosub/.soign per-particle conflict counters

Groupwise error codes in the Mvir/Rvir columns:
  -1  fewer than nMembers particles within 1.2x the input group radius
  -2  density already below threshold at nMembers particles
  -3  density never below threshold before the give-up radius
 -Mvir with Rvir = -10*id: subsumed (Vc columns kept) or slurped (zeros) by
      group <id>; conflicts are resolved processing groups in increasing
      input mass, larger groups absorbing smaller ones whose centers fall
      inside their radius (subsume), being absorbed when inside a bigger
      earlier-processed one (slurp), or leaving ownership untouched while
      still counting the mass (retain).
"""


def usage(out=sys.stderr) -> "NoReturn":
    out.write(USAGE)
    raise SystemExit(1)


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    print(BANNER, file=sys.stderr)

    # defaults — so.c:213-263
    n_bucket = 16               # fixed in the reference; grid analog is auto
    b_standard = False
    b_threshold = False
    f_threshold = 0.0
    f_min_mass = 0.0
    n_members = 8
    f_redshift = -9.9999
    b_redshift = False
    f_mass_unit = -9.9
    f_mpc_unit = -9.9
    f_omega = 1.0
    f_lambda = 0.0
    b_lambda = False
    b_periodic = 1
    f_period = [1.0, 1.0, 1.0]
    f_center = [0.0, 0.0, 0.0]
    grav, h0 = 1.0, 2.8944      # fixed and unused — so.c:245-247
    n_smooth = 1028
    b_dark = b_gas = b_star = b_mark = False
    b_grp = b_gtp = b_pot = b_subsumed = b_ignored = False
    gtp_file = list_file = out_base = mark_file = stat_file = None
    tipsy_file = None
    verbose = False
    profile_dir = None
    checkpoint = None
    deltas = None
    mesh_shape = None
    b_survey = False
    b_distributed = False

    def need(i):
        if i >= len(argv):
            usage()
        return argv[i]

    def ffloat(s):
        # the reference parses every numeric flag into a C float (so.c:200);
        # round through float32 so downstream double math sees the same value
        return float(np.float32(float(s)))

    i = 0
    while i < len(argv):
        a = argv[i]
        if a == "-i":
            i += 1; gtp_file = need(i); i += 1
        elif a == "-o":
            i += 1; out_base = need(i); i += 1
        elif a == "-z":
            i += 1; b_redshift = True; f_redshift = ffloat(need(i)); i += 1
        elif a == "-O":
            i += 1; f_omega = ffloat(need(i)); i += 1
        elif a == "-L":
            i += 1; b_lambda = True
        elif a == "-s":
            i += 1; n_smooth = int(need(i)); i += 1
        elif a == "-rho":
            sys.stderr.write("-rho option is no longer availible.  Use -delta instead.\n")
            usage()
        elif a == "-delta":
            i += 1; f_threshold = ffloat(need(i)); b_threshold = True; i += 1
        elif a == "-m":
            i += 1; n_members = int(need(i)); i += 1
        elif a == "-p":
            i += 1; v = ffloat(need(i)); f_period = [v, v, v]; b_periodic = 1; i += 1
        elif a == "-c":
            i += 1; v = ffloat(need(i)); f_center = [v, v, v]; i += 1
        elif a == "-cx":
            i += 1; f_center[0] = ffloat(need(i)); i += 1
        elif a == "-cy":
            i += 1; f_center[1] = ffloat(need(i)); i += 1
        elif a == "-cz":
            i += 1; f_center[2] = ffloat(need(i)); i += 1
        elif a == "-std":
            b_standard = True; i += 1
        elif a == "-M":
            i += 1; f_min_mass = ffloat(need(i)); i += 1
        elif a == "-u":
            i += 1; f_mass_unit = ffloat(need(i)); i += 1
            f_mpc_unit = ffloat(need(i)); i += 1
        elif a == "-list":
            i += 1; list_file = need(i); i += 1
        elif a == "-grp":
            b_grp = True; i += 1
        elif a == "-gtp":
            b_gtp = True; i += 1
        elif a == "-pot":
            b_pot = True; i += 1
            if stat_file is not None:
                usage()
        elif a == "-subsumed":
            b_subsumed = True; i += 1
        elif a == "-ignored":
            b_ignored = True; i += 1
        elif a == "-stat":
            i += 1; stat_file = need(i); i += 1
            if b_pot:
                usage()
        elif a == "-mark":
            i += 1; mark_file = need(i); b_mark = True; i += 1
        elif a == "-dark":
            b_dark = True; i += 1
        elif a == "-gas":
            b_gas = True; i += 1
        elif a == "-star":
            b_star = True; i += 1
        elif a == "-all":
            b_dark = b_gas = b_star = True; i += 1
        elif a == "--tipsy":
            i += 1; tipsy_file = need(i); i += 1
        elif a == "--verbose":
            verbose = True; i += 1
        elif a == "--profile":
            i += 1; profile_dir = need(i); i += 1
        elif a == "--checkpoint":
            # save/resume the device solve state (.npz); a rerun with the
            # same file skips straight to the host-side phases
            i += 1; checkpoint = need(i); i += 1
        elif a == "--deltas":
            # multi-threshold extension: comma-separated overdensities, one
            # full output set per threshold (<base>.d<delta>.*), all solved
            # against shared gathers (engine/multi.py)
            i += 1; deltas = [ffloat(x) for x in need(i).split(",")]; i += 1
        elif a == "--survey":
            # sort-free -1/-2 pre-pass: a large win for candidate-rich
            # catalogs where most centers fail the membership/threshold
            # checks (engine/solver._classify_stage)
            b_survey = True; i += 1
        elif a == "--distributed":
            # multi-controller extension: run the same command on every
            # process of a jax.distributed job (JAX_COORDINATOR_ADDRESS /
            # JAX_NUM_PROCESSES / JAX_PROCESS_ID env vars, or a cluster
            # auto-detector); each host reads only its snapshot segment
            # and process 0 writes the outputs (parallel/driver.py)
            b_distributed = True; i += 1
        elif a == "--mesh":
            # multi-chip extension: HxP (halo x part) device mesh — solve,
            # member extraction, and derived quantities run sharded over
            # the attached devices (parallel/mesh.py run_so_sharded)
            i += 1
            try:
                mesh_shape = tuple(int(x) for x in need(i).split("x"))
            except ValueError:
                mesh_shape = ()
            if len(mesh_shape) != 2 or min(mesh_shape) < 1:
                sys.stderr.write("--mesh expects HxP, e.g. --mesh 2x4\n")
                raise SystemExit(1)
            i += 1
        else:
            usage()

    if gtp_file is None:
        usage()
    if out_base is None:
        out_base = "so"
    if b_lambda:
        f_lambda = 1.0 - f_omega

    def checked(fn, *a, name=None):
        """File-error contract of kdCheckFile (kd2.c:24-30): message + exit 1."""
        try:
            return fn(*a)
        except (FileNotFoundError, IsADirectoryError, PermissionError):
            sys.stderr.write(f"ERROR opening file {name or a[0]}\n")
            raise SystemExit(1)

    is_p0 = True
    if b_distributed:
        # multi-controller: never read the whole snapshot on any host —
        # the header gives the counts, run_so_distributed reads segments
        if tipsy_file is None:
            sys.stderr.write("--distributed requires --tipsy <file> "
                             "(snapshot segments are seek-read per host)\n")
            raise SystemExit(1)
        from .io.tipsy import read_header
        from .parallel.distributed import init_distributed

        if not init_distributed():
            sys.stderr.write(
                "--distributed: no coordinator configured (set "
                "JAX_COORDINATOR_ADDRESS / JAX_NUM_PROCESSES / "
                "JAX_PROCESS_ID or run under a supported cluster)\n")
            raise SystemExit(1)
        import jax

        is_p0 = jax.process_index() == 0
        with open(tipsy_file, "rb") as fp:
            h = checked(read_header, fp, b_standard, name=tipsy_file)
        particles = None
        n_particles = h.nbodies
    else:
        # snapshot from stdin (so.c:457) or --tipsy
        src = tipsy_file if tipsy_file is not None else sys.stdin.buffer
        particles = checked(read_tipsy, src, b_standard,
                            name=tipsy_file or "stdin")
        h = particles.header
        n_particles = particles.n
    from .runtime import enable_compile_cache

    enable_compile_cache()
    # the reference stores the header time in a float (kd->fTime, kd2.h:119);
    # the redshift default and the .sogtp header inherit that rounding
    f_time = float(np.float32(h.time))
    if is_p0:
        sys.stderr.write(f"nDark:{h.ndark} nGas:{h.nsph} nStar:{h.nstar}\n")
        sys.stderr.write(f"Read {n_particles} particles from TIPSY file.\n")

    mask = None
    if b_mark:
        assert mark_file is not None
        mask, nmark = checked(read_mark, mark_file, n_particles)
        if particles is not None:
            particles.mark = mask
        if is_p0:
            sys.stderr.write(f"{nmark} mark particles read from {mark_file}\n")

    if not b_redshift:
        f_redshift = float(np.float32(1.0 / f_time - 1.0))   # so.c:470-472

    if not b_threshold:
        f_threshold = rhovir_over_rhobar(f_omega, b_lambda, f_redshift) * f_omega
    else:
        f_threshold *= f_omega            # so.c:479-481

    run_time = _time.time()
    catalog = checked(read_gtp_list, gtp_file, list_file, f_min_mass,
                      b_standard)
    if is_p0:
        sys.stderr.write(f"Read {catalog.n} groups to process.\n")

    if stat_file is not None:
        nrep = checked(read_stat, catalog, stat_file, name=stat_file)
        if is_p0:
            sys.stderr.write(f"Replaced {nrep} group centers.\n")
        if nrep != catalog.n:
            sys.stderr.write("ERROR in reading .stat file!\n")
            raise SystemExit(1)

    species = tuple(sp for sp, on in
                    ((DARK, b_dark), (GAS, b_gas), (STAR, b_star), (MARK, b_mark))
                    if on)
    units = unit_conversions(f_mass_unit, f_mpc_unit, f_redshift)

    def write_particle_array(path, run, field):
        """Per-particle tipsy-array output. A SegmentConflictState (the
        --distributed segmented conflict pass) holds only this host's
        particle segment: every process then writes its own byte range
        cooperatively — O(N/P) memory, called on ALL processes."""
        vals = getattr(run.conflicts, field)
        if getattr(run.conflicts, "seg_start", None) is not None:
            from .parallel.driver import write_array_file_segments

            write_array_file_segments(path, vals, run.conflicts.n_global)
        elif is_p0:
            write_array_file(path, vals)

    def write_outputs(base, run, threshold, threshold_user):
        """Catalog-level files are written by process 0; per-particle
        files go through write_particle_array (cooperative segment writes
        under --distributed, hence called on every process)."""
        if is_p0:
            with open(f"{base}.sovcirc", "w") as fp_out:
                write_sovcirc_header(fp_out, run_time, gtp_file, list_file,
                                     stat_file, np.float32(threshold),
                                     threshold_user, f_redshift, f_omega,
                                     f_lambda, b_periodic, f_period, f_center,
                                     f_min_mass, n_members, b_pot,
                                     f_mass_unit, f_mpc_unit)
                # stats to stderr and the catalog file (kdOutStats)
                sys.stderr.write(format_stats(run.stats, for_file=False))
                fp_out.write(format_stats(run.stats, for_file=True))
                for sp in (DARK, GAS, STAR, MARK):
                    if sp in species:
                        write_profile_file(f"{base}.{SPECIES_EXT[sp]}",
                                           fp_out, run_time, sp,
                                           catalog.index,
                                           run.derived.profiles[sp], units)
                write_sovcirc_rows(fp_out, catalog.index, run.mvir, run.rvir,
                                   run.derived.rmass, run.derived.rmax,
                                   run.derived.vmax, run.derived.vcirc,
                                   units)
        if b_grp:
            write_particle_array(f"{base}.sogrp", run, "igrp")
        if b_gtp and is_p0:
            write_sogtp(f"{base}.sogtp", f_time, catalog.n_in_gtp,
                        catalog.index, run.mvir, run.rvir, catalog.pos,
                        run.solve.vcm, b_standard)
        if b_subsumed:
            write_particle_array(f"{base}.sosub", run, "n_subsumed")
        if b_ignored:
            write_particle_array(f"{base}.soign", run, "n_ignored")

    if checkpoint is not None and mesh_shape is not None:
        # run_so_sharded has no resume wiring yet; failing loudly beats a
        # run the user believes is checkpointed but is not
        sys.stderr.write("--mesh with --checkpoint is not supported yet\n")
        raise SystemExit(1)
    if checkpoint is not None and deltas is not None:
        # run_so_multi never reads params.checkpoint; same fail-loudly
        # principle as the --mesh guard above
        sys.stderr.write("--deltas with --checkpoint is not supported yet\n")
        raise SystemExit(1)
    if b_distributed and mesh_shape is not None:
        # --mesh is redundant under --distributed (the multi-controller
        # driver builds its own multihost mesh from the process layout).
        # --distributed --deltas IS supported (run_so_multi_distributed),
        # and --distributed --checkpoint saves/resumes per-host segment
        # shards (parallel.driver: checkpoint.save_solve_segment).
        sys.stderr.write("--distributed cannot be combined with --mesh\n")
        raise SystemExit(1)
    # --survey forces the classifier pre-pass; without the flag the engine
    # AUTO-gates it by sampling (engine/solver.py SURVEY_*), so dense
    # survey catalogs get the win with no flag. Works under --mesh /
    # --distributed too (the part-merged kk-prefix classify,
    # parallel.mesh.classify_stage_sharded).
    params = SOParams(threshold=float(np.float32(f_threshold)),
                      n_members=n_members,
                      period=tuple(f_period), center=tuple(f_center),
                      b_pot=b_pot, species=species, grav=grav, verbose=verbose,
                      profile_dir=profile_dir, checkpoint=checkpoint,
                      survey=(True if b_survey else None))

    mesh = None
    if mesh_shape is not None:
        import jax

        from .parallel import make_mesh

        n_dev = mesh_shape[0] * mesh_shape[1]
        if len(jax.devices()) < n_dev:
            sys.stderr.write(f"--mesh {mesh_shape[0]}x{mesh_shape[1]} needs "
                             f"{n_dev} devices, found {len(jax.devices())}\n")
            raise SystemExit(1)
        mesh = make_mesh(*mesh_shape, devices=jax.devices()[:n_dev])

    if b_distributed and deltas is not None:
        from jax.experimental import multihost_utils

        from .parallel.driver import run_so_multi_distributed

        thresholds = [float(np.float32(d * np.float32(f_omega)))
                      for d in deltas]
        runs = run_so_multi_distributed(tipsy_file, catalog, params,
                                        thresholds, standard=b_standard,
                                        mark_mask=mask)
        for d, thr, run in zip(deltas, thresholds, runs):
            dstr = ("%g" % d).replace("+", "")
            # ALL processes enter each write (cooperative segments)
            write_outputs(f"{out_base}.d{dstr}", run, thr, True)
        multihost_utils.sync_global_devices("so_jax_distributed_done")
        solve_seconds = runs[-1].solve_seconds if runs else 0.0
    elif b_distributed:
        from jax.experimental import multihost_utils

        from .parallel.driver import run_so_distributed

        run = run_so_distributed(tipsy_file, catalog, params,
                                 standard=b_standard, mark_mask=mask)
        # ALL processes enter: per-particle files are written as
        # cooperative per-host segments; catalog files by process 0
        write_outputs(out_base, run, f_threshold, b_threshold)
        # writers finish everywhere before any process may exit
        multihost_utils.sync_global_devices("so_jax_distributed_done")
        solve_seconds = run.solve_seconds
    elif deltas is not None:
        thresholds = [float(np.float32(d * np.float32(f_omega)))
                      for d in deltas]
        if mesh is not None:
            from .parallel.mesh import run_so_multi_sharded

            runs = run_so_multi_sharded(particles, catalog, params,
                                        thresholds, mesh)
        else:
            from .engine.pipeline import run_so_multi

            runs = run_so_multi(particles, catalog, params, thresholds)
        for d, thr, run in zip(deltas, thresholds, runs):
            dstr = ("%g" % d).replace("+", "")
            write_outputs(f"{out_base}.d{dstr}", run, thr, True)
        solve_seconds = runs[-1].solve_seconds if runs else 0.0
    elif mesh is not None:
        from .parallel.mesh import run_so_sharded

        run = run_so_sharded(particles, catalog, params, mesh)
        write_outputs(out_base, run, f_threshold, b_threshold)
        solve_seconds = run.solve_seconds
    else:
        run = run_so(particles, catalog, params)
        write_outputs(out_base, run, f_threshold, b_threshold)
        solve_seconds = run.solve_seconds

    if is_p0:
        sec = int(solve_seconds)
        usec = int((solve_seconds - sec) * 1e6)
        sys.stderr.write("SO CPU Time:")
        sys.stderr.write("   %d.%06d\n\n" % (sec, usec))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
