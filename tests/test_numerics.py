"""indexx permutation tests (reference: nr.c:91-151, used by kdSortMass)."""

import numpy as np

from so_jax.numerics import _indexx_nr, indexx


def test_indexx_distinct_is_argsort():
    rng = np.random.default_rng(0)
    for n in (1, 2, 7, 8, 50, 1000):
        arr = rng.permutation(n).astype(np.float32)
        got = indexx(arr)
        np.testing.assert_array_equal(arr[got], np.sort(arr))
        np.testing.assert_array_equal(got, np.argsort(arr, kind="stable"))


def test_indexx_ties_sorted_and_permutation():
    rng = np.random.default_rng(1)
    for n in (5, 16, 100, 513):
        arr = rng.integers(0, 4, n).astype(np.float32)
        got = indexx(arr)
        assert sorted(got) == list(range(n))
        assert (np.diff(arr[got]) >= 0).all()


def test_indexx_tie_order_is_nr_not_stable():
    """The NR quicksort's tie order differs from a stable sort for large
    inputs; the slow path must be exercised and deterministic."""
    rng = np.random.default_rng(2)
    arr = rng.integers(0, 3, 200).astype(np.float32)
    a = indexx(arr)
    b = indexx(arr)
    np.testing.assert_array_equal(a, b)   # deterministic
    # consistency of the 1-based core against itself on a shifted copy
    arr1 = np.concatenate([[np.float32(0)], arr])
    core = _indexx_nr(arr1)[1:] - 1
    np.testing.assert_array_equal(a, core)


def test_indexx_empty_and_single():
    assert indexx(np.zeros(0, np.float32)).size == 0
    np.testing.assert_array_equal(indexx(np.array([3.0], np.float32)), [0])


def test_indexx_native_matches_python_port():
    """so_indexx (native C) is bit-faithful to _indexx_nr (the Python NR
    port): same permutation including the quicksort's tie order, fuzzed
    over heavy/no/all-tie key sets."""
    from so_jax.native import indexx_native

    rng = np.random.default_rng(99)
    for n in (1, 2, 7, 8, 50, 333, 5000):
        for mode in ("ties", "distinct", "const"):
            if mode == "ties":
                arr = rng.integers(0, max(n // 3, 1), n).astype(np.float32)
            elif mode == "distinct":
                arr = rng.permutation(n).astype(np.float64)
            else:
                arr = np.zeros(n, np.float32)
            arr1 = np.concatenate([[np.float64(0)],
                                   arr.astype(np.float64)])
            got = indexx_native(arr1)
            if got is None:
                import pytest
                pytest.skip("native library unavailable")
            want = _indexx_nr(arr1)
            np.testing.assert_array_equal(got[1:], want[1:])
