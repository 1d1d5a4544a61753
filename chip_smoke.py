#!/usr/bin/env python3
"""Smoke test of the SO pipeline on an NVIDIA GPU.

    python chip_smoke.py           one card: device, kernel, goldens, full
    python chip_smoke.py --four    four cards: the mesh and distributed paths

Phases on one card, each checked against a plain reference:

  device   jax.devices() and the card's name and power limit (nvidia-smi);
           refuses any backend but "gpu" (there is no CPU fallback).
  kernel   the slab gather (ops/slab.py) at B=16,384, K=4,096 on the full
           box, for the channel sets (), (mass,) and all seven, against
           the independent ragged row gather: equal in-ball counts, equal
           sorted source-row sets, bit-equal sorted d2. Prints the time per
           call and the compiled memory analysis.
  goldens  every scenario under tests/goldens through so_jax.cli.main:
           .sogrp/.sosub/.soign byte-identical to the committed reference
           outputs, catalogs within the goldens' tolerance.
  full     a seeded 2^21-particle box with 16,384 centres (bench.make_box)
           through the CLI with -grp -gtp -all, against the same command in
           a child on the CPU (JAX_PLATFORMS=cpu, ragged gather), which
           never opens the card; then --deltas 178,500 against the two
           single-threshold runs and --survey against the run without it.

--four runs only the multi-card paths and what they are compared with:
the full box on one card, --mesh 2x2 over four cards in one process, and
--distributed as four processes with one card each (CUDA_VISIBLE_DEVICES
per child); the parent stays off JAX until they are done. Membership files
must be byte-identical to the one-card run, catalogs within tolerance.

Any failed check exits non-zero. The last line of standard output is
{"ok": true, "device": {"platform": ..., "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import socket
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
TESTS = os.path.join(ROOT, "tests")

N_PARTICLES = 1 << 21
N_HALOS = 16384
SEED = 12345
FULL_FLAGS = ["-grp", "-gtp", "-all"]
EXACT = ("sogrp", "sosub", "soign")
OUTPUTS = ("sovcirc", "sogrp", "sogtp", "sosub", "soign", "sodark",
           "sogas", "sostar", "somark")


class SmokeFailure(RuntimeError):
    """A phase's check failed."""


def log(msg: str) -> None:
    print(msg, flush=True)


def card_info() -> str:
    """nvidia-smi's name and power limit of every card, one line each."""
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"],
                       capture_output=True, text=True, timeout=60)
    if r.returncode != 0:
        raise SmokeFailure(f"nvidia-smi failed: {r.stderr.strip()}")
    return r.stdout.strip()


def phase_device():
    """Print the devices; refuse anything but the GPU backend."""
    import jax

    backend = jax.default_backend()
    log(f"[device] jax {jax.__version__} backend={backend} "
        f"devices={jax.devices()}")
    if backend != "gpu":
        raise SmokeFailure(f"backend is {backend!r}, not 'gpu'")
    log(f"[device] card: {card_info()}")
    return jax.devices()


# ---------------------------------------------------------------------------
# inputs and comparisons
# ---------------------------------------------------------------------------

def write_box(workdir: str, n_particles: int = N_PARTICLES,
              n_halos: int = N_HALOS, seed: int = SEED):
    """Write bench.make_box's seeded box as workdir/snap.bin (tipsy, all
    dark) and workdir/cat.gtp. Returns (CLI input arguments, the box's
    (pos, mass, vel, centers, rgtp) arrays)."""
    import numpy as np

    sys.path.insert(0, ROOT)
    sys.path.insert(0, TESTS)
    from bench import make_box
    from fixtures import write_gtp, write_snapshot

    rng = np.random.default_rng(seed)
    pos, mass, vel, centers, rgtp = make_box(rng, n_particles, n_halos)
    n = pos.shape[0]
    zeros = np.zeros(n, np.float32)
    write_snapshot(f"{workdir}/snap.bin",
                   dict(pos=pos, mass=mass, vel=vel, phi=zeros))
    gtp_mass = rng.uniform(0.001, 1.0, n_halos).astype(np.float32)
    write_gtp(f"{workdir}/cat.gtp", centers, rgtp, gtp_mass)
    return (["-i", f"{workdir}/cat.gtp", "--tipsy", f"{workdir}/snap.bin"],
            (pos, mass, vel, centers, rgtp))


def compare_outputs(ref_base: str, got_base: str,
                    standard: bool = False) -> list[str]:
    """Every reference output file against got_base.<ext>: membership
    files byte for byte, catalogs within the goldens' tolerance
    (tests/util_compare.py). The reference files are ref_base.<ext>, or
    ref_base/<ext> when ref_base is a directory (tests/goldens/<name>)."""
    sys.path.insert(0, TESTS)
    from util_compare import compare_exact_file, compare_file, compare_sogtp

    errs = []
    seen = 0
    for ext in OUTPUTS:
        ref = (os.path.join(ref_base, ext) if os.path.isdir(ref_base)
               else f"{ref_base}.{ext}")
        got = f"{got_base}.{ext}"
        if not os.path.exists(ref):
            continue
        seen += 1
        if not os.path.exists(got):
            errs.append(f"missing {got}")
        elif ext == "sogtp":
            errs += compare_sogtp(ref, got, standard)
        elif ext in EXACT:
            errs += compare_exact_file(ref, got)
        else:
            errs += compare_file(ref, got)
    if not seen:
        errs.append(f"no outputs at {ref_base}.*")
    return errs


def run_cli(argv: list[str]) -> float:
    """so_jax.cli.main in this process; returns its wall seconds."""
    from so_jax.cli import main

    t0 = time.perf_counter()
    rc = main(argv)
    dt = time.perf_counter() - t0
    if rc != 0:
        raise SmokeFailure(f"CLI rc={rc}: {' '.join(argv)}")
    return dt


def cli_child(argv: list[str], env_extra: dict, log_path: str):
    """Start `python -m so_jax argv` as a child with env_extra; stdout and
    stderr go to log_path, which the child's `log_path` attribute names."""
    env = dict(os.environ)
    env.update(env_extra)
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    with open(log_path, "w") as fp:
        proc = subprocess.Popen([sys.executable, "-m", "so_jax"] + argv,
                                stdout=fp, stderr=subprocess.STDOUT,
                                env=env, cwd=ROOT)
    proc.log_path = log_path
    return proc


def wait_child(proc, what: str, timeout: float) -> None:
    try:
        rc = proc.wait(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
        rc = "timeout"
    with open(proc.log_path) as fp:
        tail = fp.read()[-3000:]
    if rc != 0:
        raise SmokeFailure(f"{what} failed (rc={rc}):\n{tail}")
    log(f"[{what}] done")


def expect(errs: list[str], what: str) -> None:
    if errs:
        raise SmokeFailure(f"{what}: {len(errs)} mismatches\n  "
                           + "\n  ".join(errs[:10]))
    log(f"[{what}] PASS")


# ---------------------------------------------------------------------------
# one-card phases
# ---------------------------------------------------------------------------

def phase_kernel(box) -> None:
    """The slab gather on the card against the ragged row gather."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from so_jax.engine.solver import _pick_level_span, ladder_radius
    from so_jax.ops import build_grid
    from so_jax.ops.gather import cell_ranges, ragged_ball_gather, slab_gather
    from so_jax.ops.slab import slab_slots

    pos, mass, vel, centers_np, rgtp = box
    grid = build_grid(pos, mass, vel=vel)
    if grid.soa8t is None:
        raise SmokeFailure("grid built without the slab payload")
    B, K = centers_np.shape[0], 4096
    centers = jnp.asarray(centers_np)
    radii_np = ladder_radius(rgtp, np.ones(B, np.int32))
    level, S = _pick_level_span(grid, float(radii_np.max()), 7)
    radii = jnp.asarray(radii_np)
    r2 = radii * radii
    log(f"[kernel] B={B} K={K} level={level} S={S} chunk={grid.chunk}")

    ref = ragged_ball_gather(grid, level, centers, radii, r2, K, S)
    got = slab_gather(grid, level, centers, radii, r2, K, S,
                      channels=("idx",))
    ok = ~(np.asarray(ref.overflow) | np.asarray(got.overflow))
    if ok.sum() < B // 2:
        raise SmokeFailure(f"only {int(ok.sum())} of {B} halos fit K={K}")
    n_ref = np.asarray(ref.n_in)[ok]
    n_got = np.asarray(got.n_in)[ok]
    if not np.array_equal(n_ref, n_got):
        raise SmokeFailure(f"n_in differs for {(n_ref != n_got).sum()} "
                           "halos")
    d2_ref = np.asarray(ref.d2)[ok]
    d2_got = np.asarray(got.d2)[ok]
    if not np.array_equal(d2_ref.view(np.int32), d2_got.view(np.int32)):
        raise SmokeFailure(f"sorted d2 differs in "
                           f"{(d2_ref != d2_got).sum()} slots")
    slot = np.arange(K)[None, :]
    live = slot < n_ref[:, None]
    big = np.iinfo(np.int32).max
    idx_ref = np.sort(np.where(live, np.asarray(ref.idx)[ok], big), axis=1)
    idx_got = np.sort(np.where(live, np.asarray(got.channels[0])[ok], big),
                      axis=1)
    if not np.array_equal(idx_ref, idx_got):
        raise SmokeFailure("sorted source-row sets differ")
    log(f"[kernel] {int(ok.sum())} halos without overflow, "
        f"{int(n_ref.sum())} hits: n_in, sorted index sets and d2 bits "
        "equal to the ragged gather")

    st, cnt, q, _ = cell_ranges(grid, level, centers, radii, r2, S,
                                align=grid.chunk)
    for chans in ((), ("mass",),
                  ("mass", "mvx", "mvy", "mvz", "meta", "ilo", "ihi")):
        args = (grid.soa8t, st, cnt, q, centers, grid.period, r2)
        comp = slab_slots.lower(*args, K=K, chans=chans,
                                CHUNK=grid.chunk).compile()
        jax.block_until_ready(slab_slots(*args, K=K, chans=chans,
                                         CHUNK=grid.chunk))
        ts = []
        for _ in range(10):
            t0 = time.perf_counter()
            jax.block_until_ready(slab_slots(*args, K=K, chans=chans,
                                             CHUNK=grid.chunk))
            ts.append(time.perf_counter() - t0)
        mem = comp.memory_analysis()
        log(f"[kernel] slab_slots chans={len(chans)}: "
            f"median {np.median(ts) * 1e3:.3f} ms/call "
            f"(min {min(ts) * 1e3:.3f}); memory_analysis: "
            f"temp={getattr(mem, 'temp_size_in_bytes', '?')} "
            f"out={getattr(mem, 'output_size_in_bytes', '?')} "
            f"arg={getattr(mem, 'argument_size_in_bytes', '?')}")
    log("[kernel] PASS")


def phase_goldens() -> None:
    """Every committed golden scenario through the CLI on the card."""
    sys.path.insert(0, TESTS)
    from scenarios import SCENARIOS, generate_inputs

    names = sorted(n for n in SCENARIOS
                   if os.path.isdir(os.path.join(TESTS, "goldens", n)))
    failed = []
    for name in names:
        work = tempfile.mkdtemp(prefix=f"golden_{name}_")
        args = generate_inputs(name, work)
        dt = run_cli(["-i", f"{work}/cat.gtp", "-o", f"{work}/got",
                      "--tipsy", f"{work}/snap.bin"] + args)
        errs = compare_outputs(os.path.join(TESTS, "goldens", name),
                               f"{work}/got", SCENARIOS[name][2])
        log(f"[goldens] {name}: {'PASS' if not errs else 'FAIL'} "
            f"({dt:.1f} s){'' if not errs else '  ' + errs[0]}")
        if errs:
            failed.append(name)
        shutil.rmtree(work, ignore_errors=True)
    if failed:
        raise SmokeFailure(f"goldens failed: {failed}")
    log(f"[goldens] PASS ({len(names)} scenarios)")


def phase_full(workdir: str, inputs: list[str], cpu_ref) -> None:
    """The full box on the card against the CPU child, then --deltas and
    --survey against single-threshold runs."""
    import jax

    base = inputs + FULL_FLAGS
    out = f"{workdir}/out"
    os.makedirs(out, exist_ok=True)
    dt = run_cli(base + ["-delta", "178", "-o", f"{out}/gpu178", "--verbose"])
    peak = (jax.devices()[0].memory_stats() or {}).get("peak_bytes_in_use")
    log(f"[full] card run -delta 178: {dt:.2f} s wall, "
        f"peak_bytes_in_use={peak}")
    dt = run_cli(base + ["-delta", "500", "-o", f"{out}/gpu500"])
    log(f"[full] card run -delta 500: {dt:.2f} s wall")
    dt = run_cli(base + ["--deltas", "178,500", "-o", f"{out}/multi"])
    log(f"[full] card run --deltas 178,500: {dt:.2f} s wall")
    for d in ("178", "500"):
        expect(compare_outputs(f"{out}/gpu{d}", f"{out}/multi.d{d}"),
               f"full --deltas d{d} vs -delta {d}")
    dt = run_cli(base + ["-delta", "178", "--survey", "-o",
                         f"{out}/survey"])
    log(f"[full] card run --survey: {dt:.2f} s wall")
    expect(compare_outputs(f"{out}/gpu178", f"{out}/survey"),
           "full --survey vs plain")
    proc, ref_base = cpu_ref
    wait_child(proc, "full cpu reference", timeout=900)
    expect(compare_outputs(ref_base, f"{out}/gpu178"),
           "full card vs cpu reference")


def start_cpu_reference(workdir: str, inputs: list[str]):
    """The full-box command in a CPU child (ragged gather): it never opens
    the card. Returns (process, output base)."""
    ref_base = f"{workdir}/out/cpu178"
    os.makedirs(f"{workdir}/out", exist_ok=True)
    proc = cli_child(inputs + FULL_FLAGS + ["-delta", "178", "-o", ref_base],
                     {"JAX_PLATFORMS": "cpu", "SO_JAX_SLAB": "0"},
                     f"{workdir}/cpu_ref.log")
    return proc, ref_base


# ---------------------------------------------------------------------------
# four cards
# ---------------------------------------------------------------------------

def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def run_four(workdir: str, inputs: list[str]) -> None:
    """One card, --mesh 2x2 and 4-process --distributed, each in its own
    child; the parent stays off JAX until they are done."""
    out = f"{workdir}/out"
    os.makedirs(out, exist_ok=True)
    args = inputs + FULL_FLAGS + ["-delta", "178"]
    t0 = time.perf_counter()
    one = cli_child(args + ["-o", f"{out}/one"],
                    {"CUDA_VISIBLE_DEVICES": "0"}, f"{workdir}/one.log")
    wait_child(one, "four: one card", timeout=900)
    log(f"[four] one card: {time.perf_counter() - t0:.2f} s")

    t0 = time.perf_counter()
    mesh = cli_child(args + ["--mesh", "2x2", "-o", f"{out}/mesh"], {},
                     f"{workdir}/mesh.log")
    wait_child(mesh, "four: mesh 2x2", timeout=900)
    log(f"[four] mesh 2x2: {time.perf_counter() - t0:.2f} s")
    expect(compare_outputs(f"{out}/one", f"{out}/mesh"),
           "four: mesh 2x2 vs one card")

    t0 = time.perf_counter()
    port = _free_port()
    procs = [cli_child(args + ["--distributed", "-o", f"{out}/dist"],
                       {"CUDA_VISIBLE_DEVICES": str(i),
                        "JAX_COORDINATOR_ADDRESS": f"localhost:{port}",
                        "JAX_NUM_PROCESSES": "4",
                        "JAX_PROCESS_ID": str(i)},
                       f"{workdir}/dist{i}.log") for i in range(4)]
    try:
        for i, p in enumerate(procs):
            wait_child(p, f"four: distributed process {i}", timeout=900)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    log(f"[four] distributed x4: {time.perf_counter() - t0:.2f} s")
    expect(compare_outputs(f"{out}/one", f"{out}/dist"),
           "four: distributed x4 vs one card")


# ---------------------------------------------------------------------------

def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-card mesh/distributed paths")
    opts = ap.parse_args(argv)

    sys.path.insert(0, ROOT)
    workdir = tempfile.mkdtemp(prefix="chip_smoke_")
    t_start = time.perf_counter()
    try:
        if opts.four:
            log(f"[device] card: {card_info()}")
            inputs, _ = write_box(workdir)
            run_four(workdir, inputs)
            devices = phase_device()
        else:
            devices = phase_device()
            from so_jax.runtime import enable_compile_cache

            log(f"[device] compile cache: {enable_compile_cache()}")
            t0 = time.perf_counter()
            inputs, box = write_box(workdir)
            log(f"[full] box of {box[0].shape[0]} particles and "
                f"{box[3].shape[0]} centres written in "
                f"{time.perf_counter() - t0:.1f} s")
            cpu_ref = start_cpu_reference(workdir, inputs)
            try:
                phase_kernel(box)
                del box
                phase_goldens()
                phase_full(workdir, inputs, cpu_ref)
            finally:
                if cpu_ref[0].poll() is None:
                    cpu_ref[0].kill()
                    cpu_ref[0].wait()
    except SmokeFailure as e:
        log(f"FAIL: {e}")
        return 1
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    log(f"[done] all phases passed in {time.perf_counter() - t_start:.1f} s")
    d = devices[0]
    print(json.dumps({"ok": True, "device": {
        "platform": d.platform, "kind": d.device_kind,
        "count": len(devices)}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
