"""chip_smoke.py's helpers at a tiny size on the CPU, and its card-only
check (marked gpu: skips without a CUDA card)."""

import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

import chip_smoke as cs

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_write_box_roundtrip(tmp_path):
    """The box writer's tipsy + .gtp files read back as the seeded box."""
    from so_jax.io.catalogs import read_gtp_list
    from so_jax.io.tipsy import read_tipsy

    args, (pos, mass, vel, centers, rgtp) = cs.write_box(str(tmp_path),
                                                         4096, 16)
    assert args == ["-i", f"{tmp_path}/cat.gtp",
                    "--tipsy", f"{tmp_path}/snap.bin"]
    with open(f"{tmp_path}/snap.bin", "rb") as fp:
        ps = read_tipsy(fp, False)
    assert ps.n == pos.shape[0] > 0
    np.testing.assert_array_equal(ps.pos, pos)
    np.testing.assert_array_equal(ps.mass, mass)
    cat = read_gtp_list(f"{tmp_path}/cat.gtp")
    np.testing.assert_array_equal(cat.pos, centers)
    np.testing.assert_array_equal(cat.rgtp, rgtp)
    # the same seed writes the same box
    (tmp_path / "b").mkdir()
    _, again = cs.write_box(str(tmp_path / "b"), 4096, 16)
    np.testing.assert_array_equal(again[0], pos)


def _outputs(base, grp=(1, 0, 2)):
    with open(f"{base}.sogrp", "w") as fp:
        fp.write(f"{len(grp)}\n" + "".join(f"{g}\n" for g in grp))
    with open(f"{base}.sovcirc", "w") as fp:
        fp.write("# Run on some host\n1 0.5 0.1 0.01 0.02 0.03 1.0 2.0\n")


def test_compare_outputs(tmp_path):
    """Membership files compare byte for byte, catalogs within the
    goldens' tolerance; missing outputs and golden-directory layouts are
    handled."""
    ref, got = str(tmp_path / "ref"), str(tmp_path / "got")
    _outputs(ref)
    _outputs(got)
    assert cs.compare_outputs(ref, got) == []
    # a catalog value one part in 1e7 off is within tolerance
    with open(f"{got}.sovcirc", "w") as fp:
        fp.write("# Run on another host\n"
                 "1 0.50000005 0.1 0.01 0.02 0.03 1.0 2.0\n")
    assert cs.compare_outputs(ref, got) == []
    # one membership changed: caught
    _outputs(got, grp=(1, 2, 2))
    assert cs.compare_outputs(ref, got)
    os.remove(f"{got}.sogrp")
    assert any("missing" in e for e in cs.compare_outputs(ref, got))
    # tests/goldens/<name>/<ext> layout
    gold = tmp_path / "golden"
    gold.mkdir()
    shutil.copy(f"{ref}.sogrp", gold / "sogrp")
    _outputs(got)
    assert cs.compare_outputs(str(gold), got) == []
    assert cs.compare_outputs(str(tmp_path / "nothing"), got)


def test_device_phase_refuses_cpu():
    """No GPU backend, no result: the device phase raises, and the script
    exits non-zero without printing the result line."""
    with pytest.raises(cs.SmokeFailure, match="not 'gpu'"):
        cs.phase_device()
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, os.path.join(ROOT, "chip_smoke.py")],
                       capture_output=True, text=True, env=env, timeout=300)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


@pytest.mark.gpu
def test_slab_gather_on_card(gpu_device):
    """On the card: the slab gather against the ragged row gather on a
    small clumpy box (in-ball counts, sorted d2 bits, source-row sets)."""
    code = r'''
import numpy as np, jax, jax.numpy as jnp
from so_jax.ops import build_grid
from so_jax.ops.gather import ragged_ball_gather, slab_gather
rng = np.random.default_rng(8)
pos = rng.uniform(-0.5, 0.5, (60000, 3)).astype(np.float32)
pos[:20000] = pos[:20000] * 0.05 + np.float32(0.1)
grid = build_grid(pos, np.full(60000, 1 / 60000, np.float32), m=4)
assert grid.soa8t is not None and jax.default_backend() == "gpu"
c = jnp.asarray(rng.uniform(-0.5, 0.5, (256, 3)).astype(np.float32))
r = jnp.asarray(rng.uniform(0.02, 0.08, 256).astype(np.float32))
ref = ragged_ball_gather(grid, 1, c, r, r * r, 8192, 7)
got = slab_gather(grid, 1, c, r, r * r, 8192, 7, channels=("idx",))
ok = ~(np.asarray(ref.overflow) | np.asarray(got.overflow))
assert ok.sum() >= 128, ok.sum()
assert np.array_equal(np.asarray(ref.n_in)[ok], np.asarray(got.n_in)[ok])
assert np.array_equal(np.asarray(ref.d2)[ok].view(np.int32),
                      np.asarray(got.d2)[ok].view(np.int32))
for b in np.nonzero(ok)[0]:
    n = int(ref.n_in[b])
    assert np.array_equal(np.sort(np.asarray(ref.idx[b, :n])),
                          np.sort(np.asarray(got.channels[0][b, :n])))
print("OK", jax.devices()[0].device_kind)
'''
    env = {k: v for k, v in os.environ.items() if k != "JAX_PLATFORMS"}
    env["PYTHONPATH"] = ROOT
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, env=env, timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    assert r.stdout.strip().endswith(gpu_device)
