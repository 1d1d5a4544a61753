"""Golden-output tests: so_jax vs committed reference outputs.

Each scenario regenerates its inputs from a fixed seed, runs the so_jax CLI
end-to-end, and compares every output file against the outputs produced by
the compiled reference (tests/goldens/, regenerated by make_goldens.py).
Catalog files compare to float tolerance; membership/conflict arrays
compare exactly (the conflict protocol is deterministic).

Known intentional divergence: with -mark, the reference's kdWriteProfile
smashes its filename buffer (strcpy of "marked" into char[5], kd2.c:905,
925-928) and writes the mark profile to a file literally named "d"; so_jax
writes the intended <base>.somark. The species scenario therefore skips
the mark-profile file comparison.
"""

import os
import shutil
import sys

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

from scenarios import SCENARIOS, OUTPUT_FILES, generate_inputs  # noqa: E402
from util_compare import (compare_exact_file, compare_file,  # noqa: E402
                          compare_sogtp)

GOLDEN_DIR = os.path.join(HERE, "goldens")

EXACT_FILES = {"sogrp", "sosub", "soign"}


def _run_cli(workdir, args):
    from so_jax.cli import main
    argv = ["-i", f"{workdir}/cat.gtp", "-o", f"{workdir}/got",
            "--tipsy", f"{workdir}/snap.bin"] + args
    assert main(argv) == 0


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_golden(name, tmp_path):
    golden = os.path.join(GOLDEN_DIR, name)
    if not os.path.isdir(golden):
        pytest.skip(f"no goldens for {name} (run tests/make_goldens.py)")
    workdir = str(tmp_path)
    args = generate_inputs(name, workdir)
    standard = SCENARIOS[name][2]
    _run_cli(workdir, args)

    errs = []
    for ext in OUTPUT_FILES:
        gpath = os.path.join(golden, ext)
        opath = f"{workdir}/got.{ext}"
        if not os.path.exists(gpath):
            continue
        assert os.path.exists(opath), f"missing output {opath}"
        if ext == "sogtp":
            errs += compare_sogtp(gpath, opath, standard)
        elif ext in EXACT_FILES:
            errs += compare_exact_file(gpath, opath)
        else:
            errs += compare_file(gpath, opath)
    assert not errs, "\n".join(errs[:10])
