"""Automated on-device parity gate.

Runs, each in a FRESH subprocess (platform/jit state is sticky):

  1. chip_smoke.py — golden scenarios end-to-end on the card (slab path +
     fused escalation + conflict protocol) and the 2^21-particle box
     against a CPU run of the same command;
  2. scripts/compare_reference_scale.py — at-scale (2M/4096 default)
     output parity + wall-time comparison against the freshly compiled
     reference binary;
  3. scripts/compare_reference_zoom.py — at-scale zoom-in multi-species
     parity (hi-res gas/dark/star clumps in a heavy lo-res background,
     the BASELINE.md ladder config the dark-only boxes don't cover);
  4. scripts/compare_reference_giant.py — giant-tier parity (a
     ~1.6e6-candidate mega-clump through the K>=2^18 slab tiers, the
     K>k_slab ragged fallback and the uniform-mass whole-box terminal
     stage, with dispatch-spy asserts that those paths fired).

and prints a dated pass/fail + timing report naming the device and the
git revision. Exit code 0 only if every stage passed. Stages 2-4 build
the compiled reference from /root/reference (tests/reference_oracle.py).

Usage: python scripts/parity_gate.py [--quick]
  --quick  skips the reference comparisons (chip_smoke.py only)
"""

from __future__ import annotations

import datetime
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def run(cmd, timeout):
    t0 = time.perf_counter()
    try:
        p = subprocess.run(cmd, capture_output=True, text=True,
                           timeout=timeout, cwd=ROOT)
        out = (p.stdout + p.stderr)
        ok = p.returncode == 0
    except subprocess.TimeoutExpired as e:
        out = ((e.stdout or b"").decode(errors="replace")
               + (e.stderr or b"").decode(errors="replace")
               + f"\nTIMEOUT after {timeout}s")
        ok = False
    return ok, time.perf_counter() - t0, out


def main(argv):
    quick = "--quick" in argv
    stages = [("chip_smoke",
               [sys.executable, os.path.join(ROOT, "chip_smoke.py")],
               1800)]
    if not quick:
        stages.append(
            ("reference_scale",
             [sys.executable, os.path.join(HERE,
                                           "compare_reference_scale.py")],
             3600))
        stages.append(
            ("reference_zoom",
             [sys.executable, os.path.join(HERE,
                                           "compare_reference_zoom.py")],
             3600))
        stages.append(
            # giant-tier certification: ~1.6e6-candidate halos through
            # the K>=2^18 slab tiers, the K>k_slab ragged fallback (general masses) and the whole-box terminal stage
            # (uniform masses), with dispatch-spy asserts that those paths
            # actually fired
            ("reference_giant",
             [sys.executable, os.path.join(HERE,
                                           "compare_reference_giant.py")],
             3600))

    results = []
    for name, cmd, timeout in stages:
        ok, dt, out = run(cmd, timeout)
        tail = "\n".join(out.strip().splitlines()[-12:])
        results.append((name, ok, dt, tail))
        print(f"[{name}] {'PASS' if ok else 'FAIL'} in {dt:.0f}s",
              flush=True)

    stamp = datetime.datetime.now().strftime("%Y-%m-%d %H:%M")
    all_ok = all(ok for _, ok, _, _ in results)
    git = subprocess.run(["git", "rev-parse", "--short", "HEAD"],
                         capture_output=True, text=True, cwd=ROOT)
    rev = git.stdout.strip() or "?"
    # device identity from a child that has finished with the card: the
    # stages above ran in fresh processes, so this one holds no card
    dev = subprocess.run(
        [sys.executable, "-c",
         "import jax; d = jax.devices()[0]; print(d.platform, d.device_kind)"],
        capture_output=True, text=True, cwd=ROOT).stdout.strip()
    print(f"\n## {stamp} — {'PASS' if all_ok else 'FAIL'} "
          f"(device: {dev or '?'}, rev {rev})")
    for name, ok, dt, tail in results:
        print(f"### {name}: {'PASS' if ok else 'FAIL'} ({dt:.0f}s)")
        print("```\n" + tail + "\n```", flush=True)
    return 0 if all_ok else 1


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))
