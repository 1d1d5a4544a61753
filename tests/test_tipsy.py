"""Tipsy codec tests: header layout, XDR endianness, round-trips, readers."""

import io
import struct

import numpy as np
import pytest

from so_jax.io.catalogs import read_gtp_list, read_mark, read_stat
from so_jax.io.tipsy import (DARK, GAS, STAR, DARK_DTYPE, GAS_DTYPE,
                             STAR_DTYPE, TipsyHeader, header_dtype,
                             read_tipsy, write_tipsy)


def test_header_is_32_bytes_padded():
    # struct dump: double + 5 ints + 4 tail-pad bytes (tipsydefs.h:41-48)
    assert header_dtype(False).itemsize == 32
    assert header_dtype(True).itemsize == 32


def test_record_sizes():
    # 12/9/11 floats (tipsydefs.h:6-39; xdr_vector counts kd2.c:369, 385, 401)
    assert GAS_DTYPE[False].itemsize == 12 * 4
    assert DARK_DTYPE[False].itemsize == 9 * 4
    assert STAR_DTYPE[False].itemsize == 11 * 4


def test_xdr_is_big_endian():
    buf = io.BytesIO()
    hdr = TipsyHeader(time=0.25, nbodies=1, ndim=3, nsph=0, ndark=1, nstar=0)
    dark = np.zeros(1, DARK_DTYPE[False])
    dark["mass"] = 2.0
    dark["pos"] = [0.1, -0.2, 0.3]
    write_tipsy(buf, hdr, None, dark, None, standard=True)
    raw = buf.getvalue()
    # XDR header: big-endian double then ints (xdrHeader, kd2.c:32-44)
    assert struct.unpack(">d", raw[:8])[0] == 0.25
    assert struct.unpack(">6i", raw[8:32]) == (1, 3, 0, 1, 0, 0)
    assert struct.unpack(">f", raw[32:36])[0] == pytest.approx(2.0)


def test_roundtrip_multispecies():
    rng = np.random.default_rng(3)
    n = (4, 6, 5)
    gas = np.zeros(n[0], GAS_DTYPE[False])
    dark = np.zeros(n[1], DARK_DTYPE[False])
    star = np.zeros(n[2], STAR_DTYPE[False])
    for rec in (gas, dark, star):
        for f in rec.dtype.names:
            rec[f] = rng.normal(size=rec[f].shape).astype(np.float32)
    hdr = TipsyHeader(time=0.5, nbodies=sum(n), ndim=3, nsph=n[0],
                      ndark=n[1], nstar=n[2])
    for std in (False, True):
        buf = io.BytesIO()
        write_tipsy(buf, hdr, gas, dark, star, std)
        buf.seek(0)
        ps = read_tipsy(buf, std)
        assert ps.n == sum(n)
        assert ps.header.time == 0.5
        # file order: gas, dark, star (kd2.c:360-416)
        np.testing.assert_array_equal(ps.mass[:4], gas["mass"])
        np.testing.assert_array_equal(ps.mass[4:10], dark["mass"])
        np.testing.assert_array_equal(ps.pos[10:], star["pos"])
        # temp only for gas (kd2.c:377, 393, 409)
        np.testing.assert_array_equal(ps.temp[:4], gas["temp"])
        assert (ps.temp[4:] == 0).all()
        # species from iOrder ranges (kdParticleType, kd2.c:135-141)
        t = ps.ptype_all()
        assert (t[:4] == GAS).all() and (t[4:10] == DARK).all() \
            and (t[10:] == STAR).all()


def test_segment_reader_matches_whole_file(tmp_path):
    """read_tipsy_segment(start, count) == read_tipsy slices for every
    species-boundary-straddling window, both endiannesses."""
    from so_jax.io.tipsy import read_tipsy_segment

    rng = np.random.default_rng(9)
    n = (4, 6, 5)
    gas = np.zeros(n[0], GAS_DTYPE[False])
    dark = np.zeros(n[1], DARK_DTYPE[False])
    star = np.zeros(n[2], STAR_DTYPE[False])
    for rec in (gas, dark, star):
        for f in rec.dtype.names:
            rec[f] = rng.normal(size=rec[f].shape).astype(np.float32)
    hdr = TipsyHeader(time=1.0, nbodies=sum(n), ndim=3, nsph=n[0],
                      ndark=n[1], nstar=n[2])
    for std in (False, True):
        path = str(tmp_path / f"snap{int(std)}.bin")
        with open(path, "wb") as f:
            write_tipsy(f, hdr, gas, dark, star, std)
        whole = read_tipsy(path, std)
        for start, count in [(0, 15), (0, 4), (2, 6), (3, 9), (9, 6),
                             (14, 1), (5, 0)]:
            seg = read_tipsy_segment(path, start, count, std)
            sl = slice(start, start + count)
            np.testing.assert_array_equal(seg.pos, whole.pos[sl])
            np.testing.assert_array_equal(seg.vel, whole.vel[sl])
            np.testing.assert_array_equal(seg.mass, whole.mass[sl])
            np.testing.assert_array_equal(seg.phi, whole.phi[sl])
            np.testing.assert_array_equal(seg.temp, whole.temp[sl])
            # species via global indices
            np.testing.assert_array_equal(
                seg.ptype(np.arange(start, start + count)),
                whole.ptype_all()[sl])
        with pytest.raises(ValueError):
            read_tipsy_segment(path, 10, 6, std)


def test_native_std_same_logical_content():
    rng = np.random.default_rng(4)
    dark = np.zeros(16, DARK_DTYPE[False])
    dark["mass"] = rng.uniform(0.5, 1.0, 16).astype(np.float32)
    dark["pos"] = rng.uniform(-0.5, 0.5, (16, 3)).astype(np.float32)
    hdr = TipsyHeader(time=1.0, nbodies=16, ndim=3, nsph=0, ndark=16, nstar=0)
    bufs = {}
    for std in (False, True):
        b = io.BytesIO()
        write_tipsy(b, hdr, None, dark, None, std)
        b.seek(0)
        bufs[std] = read_tipsy(b, std)
    np.testing.assert_array_equal(bufs[False].pos, bufs[True].pos)
    np.testing.assert_array_equal(bufs[False].mass, bufs[True].mass)


def _write_gtp_file(path, masses, rgtp=None, std=False):
    n = len(masses)
    star = np.zeros(n, STAR_DTYPE[False])
    star["mass"] = masses
    star["pos"] = np.arange(3 * n, dtype=np.float32).reshape(n, 3) / 100
    star["eps"] = rgtp if rgtp is not None else 0.01
    hdr = TipsyHeader(time=1.0, nbodies=n, ndim=3, nsph=0, ndark=0, nstar=n)
    write_tipsy(path, hdr, None, None, star, std)


def test_gtp_reader_rejects_nonstar(tmp_path):
    p = str(tmp_path / "bad.gtp")
    dark = np.zeros(3, DARK_DTYPE[False])
    hdr = TipsyHeader(time=1.0, nbodies=3, ndim=3, nsph=0, ndark=3, nstar=0)
    write_tipsy(p, hdr, None, dark, None, False)
    with pytest.raises(ValueError, match="MISMATCH"):
        read_gtp_list(p)


def test_gtp_min_mass_and_index(tmp_path):
    p = str(tmp_path / "cat.gtp")
    _write_gtp_file(p, [0.5, 0.1, 0.9, 0.05])
    cat = read_gtp_list(p, f_min_mass=0.2)
    # filtered groups keep their 1-based GTP index (kd2.c:266-274)
    np.testing.assert_array_equal(cat.index, [1, 3])
    assert cat.n_in_gtp == 4
    np.testing.assert_allclose(cat.gtp_mass, [0.5, 0.9])


def test_gtp_list_order_and_filter(tmp_path):
    p = str(tmp_path / "cat.gtp")
    lst = str(tmp_path / "list.txt")
    _write_gtp_file(p, [0.5, 0.1, 0.9, 0.3])
    with open(lst, "w") as f:
        f.write("4\n1\n2\n")
    cat = read_gtp_list(p, lst, f_min_mass=0.2)
    # list order preserved; -M filter applies (kd2.c:244-261)
    np.testing.assert_array_equal(cat.index, [4, 1])


def test_stat_sequential_matching(tmp_path):
    p = str(tmp_path / "cat.gtp")
    _write_gtp_file(p, [0.5, 0.4, 0.3])
    cat = read_gtp_list(p)
    stat = str(tmp_path / "s.stat")
    lines = []
    for g, xyz in ((1, (1, 2, 3)), (5, (9, 9, 9)), (2, (4, 5, 6)), (3, (7, 8, 9))):
        lines.append(f"{g} 0 " + " ".join("0" for _ in range(16))
                     + f" {xyz[0]} {xyz[1]} {xyz[2]}")
    with open(stat, "w") as f:
        f.write("\n".join(lines) + "\n")
    k = read_stat(cat, stat)
    assert k == 3
    np.testing.assert_allclose(cat.pos, [[1, 2, 3], [4, 5, 6], [7, 8, 9]])


def test_mark_reader(tmp_path):
    p = str(tmp_path / "m.mark")
    with open(p, "w") as f:
        f.write("10 0 0\n3\n1\n7\n3\n")
    mask, count = read_mark(p, 10)
    assert count == 4          # every line counted (kd2.c:160-165)
    np.testing.assert_array_equal(np.nonzero(mask)[0], [0, 2, 6])
