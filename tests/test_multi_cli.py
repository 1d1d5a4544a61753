"""--deltas multi-threshold CLI: each output set equals a -delta run."""

import os
import sys

import numpy as np
import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

from scenarios import generate_inputs  # noqa: E402
from util_compare import compare_exact_file, compare_file, compare_sogtp  # noqa: E402


def test_deltas_checkpoint_rejected(tmp_path):
    """run_so_multi never reads params.checkpoint — the combination must
    fail loudly, not run silently uncheckpointed."""
    from so_jax.cli import main

    workdir = str(tmp_path)
    generate_inputs("basic", workdir)
    with pytest.raises(SystemExit) as ei:
        main(["-i", f"{workdir}/cat.gtp", "--tipsy", f"{workdir}/snap.bin",
              "-o", f"{workdir}/out", "--deltas", "120,400",
              "--checkpoint", f"{workdir}/state.npz"])
    assert ei.value.code == 1
    assert not os.path.exists(f"{workdir}/state.npz")


def test_deltas_matches_single_runs(tmp_path):
    from so_jax.cli import main

    workdir = str(tmp_path)
    generate_inputs("basic", workdir)
    base_args = ["-i", f"{workdir}/cat.gtp", "--tipsy", f"{workdir}/snap.bin",
                 "-grp", "-gtp"]
    assert main(base_args + ["-o", f"{workdir}/multi",
                             "--deltas", "120,400"]) == 0
    for d in ("120", "400"):
        assert main(base_args + ["-o", f"{workdir}/single{d}",
                                 "-delta", d]) == 0
        errs = compare_file(f"{workdir}/single{d}.sovcirc",
                            f"{workdir}/multi.d{d}.sovcirc")
        errs += compare_exact_file(f"{workdir}/single{d}.sogrp",
                                   f"{workdir}/multi.d{d}.sogrp")
        # .sogtp carries vel=vcm columns: run_so_multi zeroes
        # SolveResult.vcm and relies on the member pass recomputing it —
        # this pins that the --deltas catalogs get real velocities
        errs += compare_sogtp(f"{workdir}/single{d}.sogtp",
                              f"{workdir}/multi.d{d}.sogtp", False)
        assert not errs, "\n".join(errs[:5])
