"""Native (C) vs pure-numpy conflict pass equivalence + native writers."""

import os
import sys

import numpy as np
import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

from so_jax.engine.conflicts import resolve_conflicts  # noqa: E402
from so_jax.native import get_lib, write_int_array_native  # noqa: E402


pytestmark = pytest.mark.skipif(get_lib() is None,
                                reason="no C compiler available")


def _random_case(rng, n_groups=40, n_particles=4000):
    """Random overlapping groups exercising subsume/slurp/retain paths."""
    index = np.arange(1, n_groups + 1, dtype=np.int32)
    pos = rng.uniform(-0.5, 0.5, (n_groups, 3)).astype(np.float32)
    # cluster some centers to force conflicts
    pos[n_groups // 2:] = pos[: n_groups - n_groups // 2] \
        + rng.normal(size=(n_groups - n_groups // 2, 3)).astype(np.float32) * 0.02
    code = np.where(rng.uniform(size=n_groups) < 0.15, -1, 0).astype(np.int32)
    mvir = rng.uniform(0.01, 0.5, n_groups).astype(np.float32)
    rvir = rng.uniform(0.01, 0.12, n_groups).astype(np.float32)
    mvir[code != 0] = -1.0
    rvir[code != 0] = -1.0
    order = rng.permutation(n_groups).astype(np.int64)
    members = []
    for g in range(n_groups):
        if code[g] != 0:
            members.append(None)
            continue
        k = int(rng.integers(1, 120))
        members.append(rng.choice(n_particles, size=k, replace=False)
                       .astype(np.int64))
    return index, pos, mvir, rvir, code, order, members, n_particles


@pytest.mark.parametrize("seed", [0, 1, 2, 3, 4])
def test_native_matches_python(seed):
    rng = np.random.default_rng(seed)
    args = _random_case(rng)
    a = resolve_conflicts(*args, use_native=True)
    b = resolve_conflicts(*args, use_native=False)
    np.testing.assert_array_equal(a.igrp, b.igrp)
    np.testing.assert_array_equal(a.n_subsumed, b.n_subsumed)
    np.testing.assert_array_equal(a.n_ignored, b.n_ignored)
    np.testing.assert_array_equal(a.mvir, b.mvir)
    np.testing.assert_array_equal(a.rvir, b.rvir)
    np.testing.assert_array_equal(a.slurped_own, b.slurped_own)
    assert a.groups_removed == b.groups_removed
    assert a.groups_slurped == b.groups_slurped


def test_native_int_array_writer(tmp_path):
    vals = np.array([0, 3, -1, 2 ** 31 - 1, -2 ** 31], np.int32)
    p = str(tmp_path / "arr.txt")
    assert write_int_array_native(p, vals)
    assert open(p).read() == "5\n0\n3\n-1\n2147483647\n-2147483648\n"


def test_python_fallback_writer_streams_and_matches(tmp_path):
    """The no-compiler fallback writes chunked (never the whole text at
    once) and byte-matches the native writer across chunk boundaries."""
    from so_jax.io.writers import write_array_file

    rng = np.random.default_rng(9)
    vals = rng.integers(-(2 ** 31), 2 ** 31, (1 << 20) + 7).astype(np.int32)
    pn = str(tmp_path / "native.txt")
    pf = str(tmp_path / "fallback.txt")
    assert write_int_array_native(pn, vals)
    import so_jax.native as native
    orig = native.write_int_array_native
    native.write_int_array_native = lambda *a: False   # force the fallback
    try:
        write_array_file(pf, vals)
    finally:
        native.write_int_array_native = orig
    assert open(pn, "rb").read() == open(pf, "rb").read()


def test_streaming_sogrp_write_at_scale(tmp_path):
    """A synthetic 1e8-value .sogrp-style write
    (the per-particle group-id column of a ~464^3 run) completes at
    measured MB/s through the bounded (1 MB) native text buffer."""
    import time

    n = 100_000_000
    vals = np.arange(n, dtype=np.int32) % 1_000_003
    p = str(tmp_path / "big.sogrp")
    t0 = time.perf_counter()
    assert write_int_array_native(p, vals)
    dt = time.perf_counter() - t0
    size = os.path.getsize(p)
    assert size > 6 * n                      # ~6.9 bytes/line at this range
    rate = size / dt / 1e6
    print(f"\nstreamed {size / 1e6:.0f} MB in {dt:.2f}s = {rate:.0f} MB/s")
    assert rate > 30.0                       # native writer measures ~360
    # spot-check head and tail without reading the whole file back
    with open(p, "rb") as fp:
        head = fp.read(32).split(b"\n")
        assert head[0] == b"100000000" and head[1] == b"0" and head[2] == b"1"
        fp.seek(-32, os.SEEK_END)
        tail = fp.read().strip().split(b"\n")
        assert tail[-1] == str((n - 1) % 1_000_003).encode()


def _assert_state_equal(a, b):
    np.testing.assert_array_equal(a.igrp, b.igrp)
    np.testing.assert_array_equal(a.n_subsumed, b.n_subsumed)
    np.testing.assert_array_equal(a.n_ignored, b.n_ignored)
    np.testing.assert_array_equal(a.mvir, b.mvir)
    np.testing.assert_array_equal(a.rvir, b.rvir)
    np.testing.assert_array_equal(a.slurped_own, b.slurped_own)
    assert a.groups_removed == b.groups_removed
    assert a.groups_slurped == b.groups_slurped


@pytest.mark.parametrize("seed", [0, 1, 2, 3, 4, 5, 6])
def test_component_pass_matches_serial(seed):
    """The component-decomposed walk (engine.conflicts.
    resolve_conflicts_components) is bit-identical to the single serial
    pass on overlapping-group fuzz cases — the exactness claim the
    multi-controller sharded conflict pass rests on."""
    from so_jax.engine.conflicts import resolve_conflicts_components

    rng = np.random.default_rng(100 + seed)
    args = _random_case(rng)
    a = resolve_conflicts(*args)
    b = resolve_conflicts_components(*args)
    _assert_state_equal(a, b)


@pytest.mark.parametrize("nhosts", [2, 3])
def test_component_pass_host_split_merges_exactly(nhosts):
    """comp_sel round-robin split across virtual hosts + merge ==
    unrestricted pass (what parallel.driver's sharded conflict phase
    does across processes)."""
    from so_jax.engine.conflicts import (conflict_components,
                                         resolve_conflicts_components)

    rng = np.random.default_rng(77)
    args = _random_case(rng, n_groups=60)
    index, pos, mvir, rvir, code, order, members, n_particles = args
    want = resolve_conflicts_components(*args)

    comp = conflict_components(code, members)
    igrp = np.zeros(n_particles, np.int32)
    n_sub = np.zeros(n_particles, np.int32)
    n_ign = np.zeros(n_particles, np.int32)
    mvir_m = np.asarray(mvir, np.float32).copy()
    rvir_m = np.asarray(rvir, np.float32).copy()
    slurped = np.zeros(index.size, bool)
    removed = ns = 0
    for h in range(nhosts):
        st = resolve_conflicts_components(
            *args, comp=comp, comp_sel=lambda roots: roots % nhosts == h)
        # per-particle outputs are disjoint across hosts (component rows)
        touched = (st.igrp != 0) | (st.n_subsumed > 0) | (st.n_ignored > 0)
        igrp[touched] = st.igrp[touched]
        n_sub[touched] += st.n_subsumed[touched]
        n_ign[touched] += st.n_ignored[touched]
        own = comp >= 0
        own &= (comp % nhosts) == h
        mvir_m[own] = st.mvir[own]
        rvir_m[own] = st.rvir[own]
        slurped[own] = st.slurped_own[own]
        removed += st.groups_removed
        ns += st.groups_slurped
    np.testing.assert_array_equal(igrp, want.igrp)
    np.testing.assert_array_equal(n_sub, want.n_subsumed)
    np.testing.assert_array_equal(n_ign, want.n_ignored)
    np.testing.assert_array_equal(mvir_m, want.mvir)
    np.testing.assert_array_equal(rvir_m, want.rvir)
    np.testing.assert_array_equal(slurped, want.slurped_own)
    assert removed == want.groups_removed and ns == want.groups_slurped


def test_native_stats_pass_matches_numpy():
    """so_stats_pass (one C sweep) vs the numpy compute_stats fallback:
    identical integer counters and f64 sums within summation-order
    rounding (the %g output formatting absorbs far more)."""
    import so_jax.native as nat
    from so_jax.stats import compute_stats

    rng = np.random.default_rng(9)
    n = 200_001
    mass = rng.uniform(0.5, 1.5, n).astype(np.float32) / n
    igrp = rng.integers(-1, 50, n).astype(np.int32)
    nsub = ((rng.uniform(size=n) < 0.05)
            * rng.integers(1, 4, n)).astype(np.int32)
    nign = (rng.uniform(size=n) < 0.1).astype(np.int32)
    mvir = rng.uniform(-1, 1, 500).astype(np.float32)

    a = compute_stats(mass, igrp, nsub, nign, mvir, 2, 1)
    assert nat.get_lib() is not None
    saved, nat._lib, nat._tried = nat._lib, None, True
    try:
        b = compute_stats(mass, igrp, nsub, nign, mvir, 2, 1)
    finally:
        nat._lib = saved
    import dataclasses
    for fld in dataclasses.fields(a):
        va, vb = getattr(a, fld.name), getattr(b, fld.name)
        if isinstance(va, int):
            assert va == vb, fld.name
        else:
            np.testing.assert_allclose(va, vb, rtol=1e-12, err_msg=fld.name)

    # all-zero conflict arrays: exact zeros either way
    z = np.zeros(n, np.int32)
    az = compute_stats(mass, igrp, z, z, mvir, 0, 0)
    assert az.cum_mass_subsumed == 0.0 and az.mass_ignored == 0.0
