"""Batched R_Delta solver — the batched kdRvir (reference: kd2.c:723-840).

Semantics being reproduced exactly (see also SURVEY.md section 7):

The reference grows a gather ball from Rgtp by x1.2 per pass (first gather at
1.2*Rgtp, kd2.c:745-769), sorts hits by distance, and scans cumulative mass
until the enclosed density drops below threshold for two consecutive
particles (kd2.c:804-831). Because the scan state carries across ball
regrows and each consecutive pair is evaluated exactly once, the whole
procedure is equivalent to a single scan over the globally distance-sorted
particle list limited to the *last* ball radius of the ladder:

    cum(i)  = sum of sorted masses m_0..m_i
    rho(i)  = cum(i) / ((4/3) pi d2(i)^(3/2))          (rhoEnclosed, kd2.c:588)
    cond(i) = rho(i) < thr  and  rho(i+1) < thr
    j* = first i >= nMembers-2 with cond(i) and i+1 inside the ball ladder

    j* == nMembers-2            -> error -2   (kd2.c:785-796)
    j*  > nMembers-2            -> Mvir = cum(j*-1), Rvir = (Mvir/((4/3)pi thr))^(1/3),
                                   interior = sorted particles 0..j*-1 (kd2.c:814-823)
    no j* within the ladder cap -> error -3   (kd2.c:836-839)
    first ball (radius 1.2*Rgtp) holds < nMembers particles -> error -1 (kd2.c:772-778)
    Rgtp already >= 0.25*|period| (loop never entered)      -> error -3

The ladder cap is the first radius Rgtp*1.2^k >= 0.25*sqrt(px^2+py^2+pz^2),
iterated in float32 exactly like the reference's repeated float multiply.

Realization: per capacity tier, one fixed-shape jitted program gathers
candidates for the whole halo batch via the cell grid, sorts by distance,
computes the cumulative-mass density scan vectorized, and emits result /
escalate-to-next-tier flags. The host driver only routes halos between
tiers (mirroring the reference's own regrow loop, but batched).
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache, partial

import os
import sys
from time import perf_counter as _pc

import jax
import jax.numpy as jnp
import numpy as np

from ..ops.gather import ragged_ball_gather, slab_gather
from ..ops.seqsum import seq_cumsum
from ..ops.grid import CellGrid

FOUR_THIRDS_PI = np.float32(4.0 / 3.0 * np.pi)  # rhoEnclosed's 1.33333333*M_PI (kd2.c:592)


def rvir_reference_bits(mvir, thr) -> np.ndarray:
    """fRvir with the reference's exact arithmetic (kd2.c:816-819):

        r3 = mass / ((4./3.)*M_PI*fRhoVir);   /* double RHS, float r3 */
        r  = pow(r3, 0.3333333333);           /* libm double, float r */

    i.e. ONE f32 rounding of a double quotient, then libm pow with the
    truncated exponent 0.3333333333 (not 1/3), rounded once to f32. The
    device scan's f32 cbrt differs from this in the last ulp for some
    Mvir, and that ulp is observable: every downstream boundary is cut
    with strict f32 compares against r-derived values — the Vc bins
    d2 < (f*Rvir)^2 (kd2.c:518-524), the 2*Rvir profile gather, and the
    conflict-protocol distance tests — so a heavier-than-average particle
    sitting within an ulp of a bin edge flips a visible 0.x% of profile
    mass (caught by the at-scale zoom parity gate: one lo-res particle at
    the 0.75*Rvir bin of one group). The host therefore recomputes Rvir
    from the exact f32 Mvir bits; the device value is only a
    within-dispatch estimate."""
    import math

    denom = (4.0 / 3.0) * math.pi * float(np.float32(thr))
    r3 = np.asarray(np.asarray(mvir, np.float64) / denom, np.float32)
    return np.power(r3.astype(np.float64),
                    0.3333333333).astype(np.float32)


# ---------------------------------------------------------------------------
# Ball ladder (host): float32-faithful emulation of the regrow loop
# ---------------------------------------------------------------------------

def rvir_ladder(rgtp: np.ndarray, period) -> tuple[np.ndarray, np.ndarray]:
    """Per-halo (kmax, cap): number of x1.2 growths until the give-up bound.

    Mirrors the loop head ``while (fBall < 0.25*fRootPeriod) fBall *= 1.2``
    (kd2.c:765-767) in float32. kmax == 0 means the loop never runs
    (immediate -3). The first gather radius is ladder step k=1.
    """
    period = np.asarray(period, np.float32)
    root = np.float32(np.sqrt(np.float64(period[0] * period[0]
                                         + period[1] * period[1]
                                         + period[2] * period[2])))
    cap = 0.25 * np.float64(root)
    fball = np.asarray(rgtp, np.float32).copy()
    kmax = np.zeros(fball.shape, np.int32)
    live = np.float64(fball) < cap
    while live.any():
        fball[live] = (fball[live] * np.float32(1.2)).astype(np.float32)
        kmax[live] += 1
        live = np.float64(fball) < cap
    return kmax, np.float32(cap)


def ladder_radius(rgtp: np.ndarray, k: np.ndarray) -> np.ndarray:
    """Rgtp * 1.2^k by repeated float32 multiplication (per-halo k)."""
    r = np.asarray(rgtp, np.float32).copy()
    k = np.asarray(k)
    if k.size == 0:
        return r
    for step in range(int(k.max()) if k.size else 0):
        sel = k > step
        r[sel] = (r[sel] * np.float32(1.2)).astype(np.float32)
    return r


# ---------------------------------------------------------------------------
# Stage kernel (device)
# ---------------------------------------------------------------------------

# ladder constants above this K would bloat the jitted program (the giant
# XLA-fallback tier reaches K ~ the particle count); larger uniform stages
# synthesize the constant mass row in-program and seq-scan it instead —
# still no gather channel, identical bits (same serial f32 order).
# 2^20 matches the largest slab-path tier (k_slab_max(1)): a 4 MB
# embedded constant beats the 2^20-step sequential scan those giant
# dispatches would otherwise pay. The whole-box tier (K ~ the particle
# count) passes its ladder as a runtime argument instead (scan_sorted's
# ``lad``) — a 0.5 GB constant would bloat the executable.
_LADDER_KMAX = 1 << 20


@lru_cache(maxsize=32)
def _mass_ladder(m: float, K: int) -> np.ndarray:
    """Serial-f32 cumulative sums of K copies of m. np.cumsum is
    ufunc.accumulate, whose semantics are the sequential r[i] = r[i-1]+a[i]
    — the same left-associated f32 order as the C accumulator and
    ops/seqsum.py (asserted in tests/test_solver.py)."""
    return np.cumsum(np.full(K, np.float32(m), np.float32))


def _uniform_cum(uniform_m: float, K: int, n_in, live, lad=None):
    """Serial-f32 cumulative mass over bit-identical-mass sorted rows:
    cum(i) = ladder[min(i, n_in-1)] materialized as a broadcast+select
    (no (B,K) gather) — ``live`` is the (B,K) slot<n_in mask. Above
    _LADDER_KMAX (giant tiers) the constant mass row is synthesized
    in-program and seq-scanned instead of embedding a huge ladder
    constant — identical bits (same serial order). ``lad`` supplies the
    (K,) ladder as a runtime array instead (the whole-box tier, where K
    is the particle count). Returns (cum, lad): ``lad`` is None on the
    seq-scan fallback. Shared by scan_sorted and derived_from_sorted so
    the Mvir-side and profile-side cumulative masses can never
    desynchronize."""
    if lad is None and K <= _LADDER_KMAX:
        lad = jnp.asarray(_mass_ladder(uniform_m, K))
    if lad is not None:
        last = jnp.where(n_in > 0, lad[jnp.maximum(n_in - 1, 0)], 0.0)
        return jnp.where(live, lad[None, :], last[:, None]), lad
    mass_s = jnp.where(live, jnp.float32(uniform_m), 0.0)
    return seq_cumsum(mass_s, axis=1), None


def scan_sorted(d2_s, mass_s, vel_s, n_in, thr, n_members: int,
                uniform_m: float | None = None, lad=None):
    """The density scan over distance-sorted hits (shared by the single- and
    multi-device paths). ``mass_s`` must be zero on invalid slots.
    ``vel_s`` may be None (vcm is then computed later, in the member pass).

    ``uniform_m``: when every particle mass is the same f32 value,
    ``mass_s`` may be None — the sorted cumulative mass is then the same
    serial ladder for every halo (padding zeros never change a serial f32
    accumulator), so callers skip the mass gather channel and the distance
    sort drops to one operand."""
    B, K = d2_s.shape
    slot = jnp.arange(K, dtype=jnp.int32)[None, :]
    if uniform_m is not None:
        cum, _ = _uniform_cum(uniform_m, K, n_in, slot < n_in[:, None],
                              lad=lad)
    else:
        # C-order float32 accumulation (kd2.c:807) — see ops/seqsum.py
        cum = seq_cumsum(mass_s, axis=1)

    # rho(i) = cum(i) / ((4/3) pi d2^(3/2)) — rhoEnclosed (kd2.c:588-593)
    r3 = d2_s * jnp.sqrt(d2_s)
    rho = cum / (FOUR_THIRDS_PI * r3)

    rho_next = jnp.concatenate([rho[:, 1:], jnp.full((B, 1), jnp.inf)], axis=1)
    pair_ok = ((rho < thr) & (rho_next < thr)
               & (slot + 1 < n_in[:, None])
               & (slot >= n_members - 2))
    found = pair_ok.any(axis=1)
    jstar = jnp.argmax(pair_ok, axis=1).astype(jnp.int32)

    jm1 = jnp.maximum(jstar - 1, 0)
    rows = jnp.arange(B)
    # Mvir is NOT the plain prefix sum: the reference adds the j* particle
    # and subtracts it again (kd2.c:810-818 `mass -= nnList[j]`), so
    # fMvir = fl(fl(cum[j*-1] + m_j*) - m_j*) — one ulp above cum[j*-1]
    # whenever the add rounds up. That ulp is observable: the quarter/half
    # mass radii (kd2.c:537-546) compare 0.25·fMvir against the same serial
    # sums, and a crossing that lands exactly on a particle boundary (equal
    # masses, count divisible by 4) picks the slot by that last ulp.
    if uniform_m is not None:
        # zero-hit rows must subtract 0 like the general path (whose
        # mass_s[0] is the zero pad), not the constant m — the packed
        # stage block stays bit-identical across paths even for rows the
        # host never reads
        m_at_jstar = jnp.where(n_in > 0, jnp.float32(uniform_m), 0.0)
    else:
        m_at_jstar = mass_s[rows, jstar]
    mvir = cum[rows, jstar] - m_at_jstar
    d2cut = d2_s[rows, jm1]
    # Rvir derived from Mvir, not a particle distance (kd2.c:816-819)
    rvir = jnp.cbrt(mvir / (FOUR_THIRDS_PI * thr))

    # group mean velocity over the j interior particles (_VcmParticles,
    # kd2.c:595-609) — mass-weighted over sorted prefix [0, jstar)
    if vel_s is not None and mass_s is None:
        raise ValueError("vcm needs per-slot masses; pass mass_s")
    if vel_s is not None:
        interior = slot < jstar[:, None]
        w = jnp.where(interior, mass_s, 0.0)
        vcm = (w[:, :, None] * vel_s).sum(axis=1) / mvir[:, None]
    else:
        vcm = jnp.zeros((B, 3), jnp.float32)

    return dict(found=found, jstar=jstar, mvir=mvir, rvir=rvir, d2cut=d2cut,
                vcm=vcm)


def pack_stage_out(out):
    """One fetch-friendly i32 (B,5) array:
    [n_in | found<<30 | overflow<<31, jstar, mvir_bits, rvir_bits,
    d2cut_bits] (floats bit-cast) — one small device-to-host copy per
    stage instead of eight."""
    w0 = (out["n_in"].astype(jnp.int32)
          | (out["found"].astype(jnp.int32) << 30)
          | (out["overflow"].astype(jnp.int32) << 31))
    return jnp.stack(
        [w0,
         out["jstar"].astype(jnp.int32),
         jax.lax.bitcast_convert_type(out["mvir"], jnp.int32),
         jax.lax.bitcast_convert_type(out["rvir"], jnp.int32),
         jax.lax.bitcast_convert_type(out["d2cut"], jnp.int32)], axis=1)


def unpack_stage_out(packed: np.ndarray):
    """Host-side inverse of pack_stage_out: ((B,4) ints [n_in, jstar,
    found, overflow], (B,3) floats [mvir, rvir, d2cut])."""
    w0 = packed[:, 0]
    ints = np.stack([w0 & 0x3FFFFFFF, packed[:, 1],
                     (w0 >> 30) & 1, (w0 >> 31) & 1], axis=1)
    flts = np.ascontiguousarray(packed[:, 2:5]).view(np.float32)
    return ints, flts


def fused_tier2_select(out1_found, overflow, n_in, kleft, centers, radii,
                       B2: int, dk: int, n_members: int):
    """Tier-2 population + radii for the fused two-round stage (shared by
    the single-device and shard_map paths): halos tier 1 could not settle,
    compacted to B2 rows. Returns (idc, valid2, steps, c2, r2)."""
    B = centers.shape[0]
    need2 = overflow | ((~out1_found) & (kleft > 0) & (n_in >= n_members))
    big = jnp.int32(1 << 30)
    key = jnp.where(need2, jnp.arange(B, dtype=jnp.int32), big)
    ids = jax.lax.sort(key)[:B2]              # compacted halo rows
    valid2 = ids < big
    idc = jnp.where(valid2, ids, 0)

    # radius: unchanged for overflow (capacity regrow, smooth2.c:49-55);
    # next dk ladder rungs otherwise (kd2.c:765-767), in exact float32
    ovf_sel = overflow[idc] & valid2
    steps = jnp.where(valid2 & ~ovf_sel,
                      jnp.minimum(kleft[idc], dk), 0).astype(jnp.int32)
    r2 = radii[idc]
    for i in range(dk):                       # static repeated f32 multiply
        r2 = jnp.where(i < steps, r2 * jnp.float32(1.2), r2)
    r2 = jnp.where(valid2, r2, jnp.float32(1e-30))
    return idc, valid2, steps, centers[idc], r2


@partial(jax.jit, static_argnames=("level", "K", "S", "level2", "K2", "S2",
                                   "B2", "n_members", "dk"))
def _solve_stage_fused(grid: CellGrid, level: int, K: int, S: int,
                       level2: int, K2: int, S2: int, B2: int,
                       n_members: int, dk: int, centers, radii, kleft, thr):
    """Two escalation rounds in ONE dispatch: the usual tier-1 stage plus a
    compacted tier-2 pass (bigger capacity K2 and/or the next dk ladder
    radii) for the halos tier 1 could not settle — the handful of largest
    halos no longer cost a second host round-trip.

    Returns an (B + B2, 7) i32 array: rows [:B] are the tier-1
    pack_stage_out quintuples (2 pad columns), rows [B:] are the tier-2
    quintuples plus [halo row id (-1 = unused slot), ladder steps taken].
    The host applies its unchanged per-round decision logic to each block
    in sequence, so the escalation semantics are identical to two
    dispatched rounds (kd2.c:745-839 staging)."""
    B = centers.shape[0]
    um = grid.uniform_mass
    chans = () if um is not None else ("mass",)
    g = slab_gather(grid, level, centers, radii, radii * radii, K, S,
                    channels=chans)
    out1 = scan_sorted(g.d2, None if um is not None else g.channels[0],
                       None, g.n_in, thr, n_members, uniform_m=um)
    out1.update(n_in=g.n_in, overflow=g.overflow)
    p1 = pack_stage_out(out1)

    # tier-2 population: capacity overflow, or no crossing found with
    # ladder rungs left (and not an obvious -1: n_in < nMembers without
    # overflow resolves immediately on the host)
    idc, valid2, steps, c2, r2 = fused_tier2_select(
        out1["found"], g.overflow, g.n_in, kleft, centers, radii, B2, dk,
        n_members)

    g2 = slab_gather(grid, level2, c2, r2, r2 * r2, K2, S2,
                     channels=chans)
    out2 = scan_sorted(g2.d2, None if um is not None else g2.channels[0],
                       None, g2.n_in, thr, n_members, uniform_m=um)
    out2.update(n_in=g2.n_in, overflow=g2.overflow)
    p2 = jnp.concatenate(
        [pack_stage_out(out2),
         jnp.where(valid2, idc, -1)[:, None], steps[:, None]], axis=1)
    p1x = jnp.concatenate([p1, jnp.zeros((B, 2), jnp.int32)], axis=1)
    return jnp.concatenate([p1x, p2], axis=0)


@partial(jax.jit, static_argnames=("level", "K", "S", "n_members", "T"))
def _classify_stage(grid: CellGrid, level: int, K: int, S: int,
                    n_members: int, centers, radii, thresholds, T: int = 1):
    """Sort-free -1/-2 classification from the nearest hits.

    The -1 verdict needs only the in-ball count (kd2.c:772-778) and the
    -2 verdict only the first nMembers sorted hits (the two-consecutive
    rule firing at the earliest eligible slot, kd2.c:785-796) — a
    lax.top_k of the unsorted distances plus a 16-wide exact prefix
    replaces the full K-wide sort. Candidate-rich survey catalogs where
    most halos fail these checks (83% on the 34M/1e6 box) skip the
    expensive sorted solve for them entirely; survivors re-run the
    normal rounds with identical semantics (the scan is round-stateless).

    ``thresholds`` is a (T,) vector — the -1 verdict is
    threshold-independent and the -2 rule is evaluated per threshold
    against the same prefix, so the multi-threshold engine shares one
    classify gather. Returns packed i32 (B, 2):
    [n_in | overflow<<31, m2 bitmask (bit t = -2 at thresholds[t])].
    """
    kk = min(K, max(16, n_members + 2))   # top_k k must not exceed K;
    #                                       a clamped window simply defers
    #                                       -2 to the full solve
    um = grid.uniform_mass
    if grid.soa8t is not None:
        from ..ops.gather import cell_ranges
        from ..ops.slab import slab_slots

        r2 = radii * radii
        st, cnt, q, total = cell_ranges(grid, level, centers, radii, r2, S,
                                        align=grid.chunk)
        out = slab_slots(grid.soa8t, st, cnt, q, centers, grid.period, r2,
                         K, chans=() if um is not None else ("mass",),
                         CHUNK=grid.chunk)
        d2 = out[:, 0]
        mass = None if um is not None else out[:, 1]
        overflow = total > K
    else:
        g = ragged_ball_gather(grid, level, centers, radii, radii * radii,
                               K, S, sort=False)
        ok = jnp.isfinite(g.d2)
        d2 = jnp.where(ok, g.d2, jnp.inf)
        mass = None if um is not None \
            else jnp.where(ok, grid.mass_a()[g.idx], 0.0)
        overflow = g.overflow
    n_in = jnp.isfinite(d2).sum(axis=1).astype(jnp.int32)
    if um is not None:
        # uniform masses: the -2 verdict needs no nearest-hit prefix at
        # all — it reduces to exact order-statistic COUNTS (see
        # _classify_counts), dropping the lax.top_k that dominated the
        # survey classify's device time on the 1e6-halo box
        return _classify_counts(d2, n_in, overflow, thresholds, T,
                                n_members, um)
    d2k, mk = _classify_prefix(d2, mass, kk)
    return _classify_verdict(d2k, mk, n_in, overflow, thresholds, T,
                             n_members)


def _classify_counts(d2, n_in, overflow, thresholds, T: int,
                     n_members: int, um: float, psum=None):
    """Counting form of the -1/-2 verdict for UNIFORM masses.

    With every mass the same f32 value, the sorted cumulative mass at
    slot i is the fixed ladder value cum(i) (serial-f32, order-free), so

        rho(i) < thr  <=>  d2_(i) > Q_i,   Q_i = (cum(i)/((4/3)pi thr))^(2/3)
                      <=>  count(d2 <= Q_i) <= i

    — an order statistic over the candidate multiset, EXACT under any
    tie order (counts are permutation-invariant, unlike a top_k prefix,
    so this path needs no tie deferral). The -2 verdict
    (pair_ok at the first eligible slot b1 = n_members-2, kd2.c:785-796)
    becomes two counts per threshold:

        count(d2 <= Q_b1) <= b1  AND  count(d2 <= Q_b1+1) <= b1+1
        AND n_in >= n_members  (slot b1+1 inside the ball)

    Knife edges: the full solve compares f32-rounded rho against thr, so
    a d2 within a few ulp of Q_i can flip there. Each count is therefore
    taken at Q_i*(1 +/- BAND); a halo is classified -2 only when the
    verdict holds at the INCLUSIVE edge (certainly -2 even if every
    band-interior candidate flips). Ambiguous halos simply stay
    survivors and get the full solve's bit-exact verdict — identical
    final output, a vanishing fraction of extra work.

    ``psum``: cross-shard reduction for the sharded path — counts are
    additive over particle shards (``n_in``/``overflow`` must arrive
    already reduced), so the mesh variant psums four (B,) count vectors
    instead of all_gathering kk-wide prefixes."""
    BAND = 3e-5   # ~250 f32 ulps: covers the <=5-op rounding chain of
    #               scan_sorted's rho plus this Q's own f32 evaluation
    b1 = n_members - 2
    # serial-f32 ladder prefix — the exact cum values scan_sorted sees
    lad = np.cumsum(np.full(n_members, np.float32(um), np.float32))
    m2_mask = jnp.zeros_like(n_in)
    thresholds = jnp.atleast_1d(thresholds)

    def cnt(q):
        c = (d2 <= q).sum(axis=1).astype(jnp.int32)
        return psum(c) if psum is not None else c

    for t in range(T):
        thr_t = thresholds[t]
        q1 = (lad[b1] / (FOUR_THIRDS_PI * thr_t)) ** (2.0 / 3.0)
        q2 = (lad[b1 + 1] / (FOUR_THIRDS_PI * thr_t)) ** (2.0 / 3.0)
        c1 = cnt(q1 * (1.0 + BAND))
        c2 = cnt(q2 * (1.0 + BAND))
        # certainty guard at the exclusive edge: if shrinking Q by the
        # band changes either count, a candidate sits in the ambiguous
        # ring — defer to the full solve
        c1l = cnt(q1 * (1.0 - BAND))
        c2l = cnt(q2 * (1.0 - BAND))
        is_m2 = ((c1 <= b1) & (c2 <= b1 + 1) & (c1 == c1l) & (c2 == c2l)
                 & (n_in >= n_members))
        m2_mask = m2_mask | (is_m2.astype(jnp.int32) << t)
    w0 = n_in | (overflow.astype(jnp.int32) << 31)
    return jnp.stack([w0, m2_mask], axis=1)


def _classify_prefix(d2, mass, kk: int):
    """Ascending kk-nearest (d2, mass) prefix of unsorted hit lists (pad
    slots carry d2=+inf/mass=0). Composable across particle shards: the
    global kk-prefix of per-shard kk-prefixes equals the kk-prefix of the
    union, which is what classify_stage_sharded all_gathers."""
    negd2, idx = jax.lax.top_k(-d2, kk)
    return -negd2, jnp.take_along_axis(mass, idx, axis=1)


def _classify_verdict(d2k, mk, n_in, overflow, thresholds, T: int,
                      n_members: int):
    """The order-invariant -1/-2 verdict core over an ascending
    kk-prefix; see _classify_stage for the contract and the tie-deferral
    argument (any ordering of equal keys gives the same packed result)."""
    kk = d2k.shape[1]
    cum = seq_cumsum(mk, axis=1)
    rho = cum / (FOUR_THIRDS_PI * (d2k * jnp.sqrt(d2k)))
    slot = jnp.arange(kk, dtype=jnp.int32)[None, :]
    rho_next = jnp.concatenate(
        [rho[:, 1:], jnp.full((rho.shape[0], 1), jnp.inf)], axis=1)
    # tie-order robustness: the full solve's unstable sort may order
    # equal-d2 hits differently than top_k; cum at the decision slots is
    # order-invariant EXCEPT for ties straddling slots (m-2, m-1) or
    # (m-1, m) — defer those knife-edges to the full solve, whose verdict
    # is the contract
    b1 = n_members - 2
    if b1 + 2 <= kk - 1:
        no_tie = (d2k[:, b1] != d2k[:, b1 + 1]) \
            & (d2k[:, b1 + 1] != d2k[:, b1 + 2])
    else:
        no_tie = None                   # window too short to decide -2
    m2_mask = jnp.zeros_like(n_in)
    thresholds = jnp.atleast_1d(thresholds)
    for t in range(T):
        thr_t = thresholds[t]
        pair_ok = ((rho < thr_t) & (rho_next < thr_t)
                   & (slot + 1 < n_in[:, None])
                   & (slot >= n_members - 2))
        found_w = pair_ok.any(axis=1)
        jstar_w = jnp.argmax(pair_ok, axis=1).astype(jnp.int32)
        is_m2 = found_w & (jstar_w == n_members - 2)
        is_m2 = is_m2 & no_tie if no_tie is not None \
            else jnp.zeros_like(is_m2)
        m2_mask = m2_mask | (is_m2.astype(jnp.int32) << t)
    w0 = n_in | (overflow.astype(jnp.int32) << 31)
    return jnp.stack([w0, m2_mask], axis=1)


@partial(jax.jit, static_argnames=("level", "K", "S", "n_members"))
def _solve_stage(grid: CellGrid, level: int, K: int, S: int, n_members: int,
                 centers, radii, thr):
    """One capacity tier: gather+sort+scan for a batch of halos.

    Returns packed (ints, floats) per halo — see pack_stage_out. n_in
    feeds the -1 check; vcm comes later from the member pass.
    """
    um = grid.uniform_mass
    if grid.soa8t is not None:
        # slab path: (d2, mass) come pre-extracted from the payload;
        # uniform-mass grids skip the mass channel — the cum ladder is
        # shared and the distance sort drops to one operand
        chans = () if um is not None else ("mass",)
        g = slab_gather(grid, level, centers, radii, radii * radii, K, S,
                        channels=chans)
        mass_s = None if um is not None else g.channels[0]
        out = scan_sorted(g.d2, mass_s, None, g.n_in, thr, n_members,
                          uniform_m=um)
    else:
        g = ragged_ball_gather(grid, level, centers, radii, radii * radii,
                               K, S, sort=True)
        if um is not None:
            mass_s = None
        else:
            slot = jnp.arange(K, dtype=jnp.int32)[None, :]
            valid = slot < g.n_in[:, None]
            mass_s = jnp.where(valid, grid.mass_a()[g.idx], 0.0)
        out = scan_sorted(g.d2, mass_s, None, g.n_in, thr, n_members,
                          uniform_m=um)
    out.update(n_in=g.n_in, overflow=g.overflow)
    return pack_stage_out(out)


def _whole_box_d2(grid: CellGrid, centers):
    """(B, N) min-image d2 of every particle against every center, with
    the reference's exact f32 association (shifted center first — see
    ops/slab.min_image) and the same rounded dist2 as both gather
    paths. Reads the payload rows directly (no transposed copy) when
    present."""
    from ..ops.slab import dist2, min_image

    n = grid.n
    if getattr(grid, "soa8t", None) is not None:
        x, y, z = (grid.soa8t[0, :n], grid.soa8t[1, :n], grid.soa8t[2, :n])
    else:
        p = grid.pos
        x, y, z = p[:, 0], p[:, 1], p[:, 2]
    px, py, pz = grid.period[0], grid.period[1], grid.period[2]
    cx, cy, cz = centers[:, 0:1], centers[:, 1:2], centers[:, 2:3]
    dx = min_image(cx, x[None, :], px)
    dy = min_image(cy, y[None, :], py)
    dz = min_image(cz, z[None, :], pz)
    # starts[0][0] is 0: the finest level's first cell begins at row 0
    return dist2(dx, dy, dz, grid.starts[0][0])


@partial(jax.jit, static_argnames=("n_members",))
def _whole_box_stage(grid: CellGrid, lad, n_members: int, centers, radii,
                     thr):
    """Terminal capacity tier for uniform-mass grids: d2 against EVERY
    particle (no cell machinery, no index materialization), one-operand
    sort, runtime-ladder cumulative mass. Capacity is the particle count,
    so overflow is impossible — the analog of the reference's nnList
    having grown to the whole tree (smooth2.c:49-55 regrow run to N).
    Bit-identical to the gather stages by construction: same d2
    association, same unstable sort key set, same serial-f32 ladder.
    ``lad`` is the (N,) host-side _mass_ladder as a device array."""
    d2 = _whole_box_d2(grid, centers)
    r2 = (radii * radii)[:, None]
    key = jnp.where(d2 <= r2, d2, jnp.inf)
    n_in = jnp.isfinite(key).sum(axis=1).astype(jnp.int32)
    d2_s = jax.lax.sort(key, is_stable=False)
    out = scan_sorted(d2_s, None, None, n_in, thr, n_members,
                      uniform_m=grid.uniform_mass, lad=lad)
    out.update(n_in=n_in, overflow=jnp.zeros_like(n_in, dtype=bool))
    return pack_stage_out(out)


@partial(jax.jit, static_argnames=("n_members", "T"))
def _whole_box_multi_stage(grid: CellGrid, lad, n_members: int, T: int,
                           centers, radii, thresholds):
    """Multi-threshold variant of _whole_box_stage: one sorted stream, T
    scans; emits the same (T+1, B, 5) block as engine.multi._multi_stage."""
    d2 = _whole_box_d2(grid, centers)
    r2 = (radii * radii)[:, None]
    key = jnp.where(d2 <= r2, d2, jnp.inf)
    n_in = jnp.isfinite(key).sum(axis=1).astype(jnp.int32)
    d2_s = jax.lax.sort(key, is_stable=False)
    outs = [scan_sorted(d2_s, None, None, n_in, thresholds[t], n_members,
                        uniform_m=grid.uniform_mass, lad=lad)
            for t in range(T)]
    bc = lambda x: jax.lax.bitcast_convert_type(x, jnp.int32)
    per_t = jnp.stack([jnp.stack(
        [o["found"].astype(jnp.int32), o["jstar"],
         bc(o["mvir"]), bc(o["rvir"]), bc(o["d2cut"])], axis=1)
        for o in outs])
    zero = jnp.zeros_like(n_in)
    tail = jnp.stack([n_in.astype(jnp.int32), zero, zero, zero, zero],
                     axis=1)[None]
    return jnp.concatenate([per_t, tail], axis=0)


def _wbox_ladder_dev(grid):
    """Device copy of the whole-box serial-f32 mass ladder, cached on the
    grid object (one host cumsum + one upload per grid; ~4 B/particle).
    Built with a direct np.cumsum, NOT _mass_ladder: its lru_cache would
    pin a ~0.5 GB host array at 512^3 on top of this per-grid cache (the
    cumsum semantics are identical — ufunc.accumulate's sequential
    left-associated f32 order)."""
    lad = getattr(grid, "_wbox_lad", None)
    if lad is None:
        lad = jnp.asarray(np.cumsum(
            np.full(grid.n, np.float32(grid.uniform_mass), np.float32)))
        try:
            grid._wbox_lad = lad
        except AttributeError:
            pass
    return lad


def _wbox_chunk(n_particles: int) -> int:
    """Halos per whole-box dispatch: each costs a (B, N) sort, so keep
    B*N within ~2^27 slots (a 0.5 GB key buffer)."""
    np2 = 1 << int(np.ceil(np.log2(max(n_particles, 2))))
    return max(1, min(64, (1 << 27) // np2))


# ---------------------------------------------------------------------------
# Host driver
# ---------------------------------------------------------------------------

@dataclass
class SolveResult:
    """Per-halo R_Delta solve output (pre-conflict-resolution)."""
    code: np.ndarray    # (G,) i32: 0 ok; -1/-2/-3 reference error codes
    mvir: np.ndarray    # (G,) f32: cum mass strictly inside Rvir (or error code)
    rvir: np.ndarray    # (G,) f32: derived radius (or error code)
    j: np.ndarray       # (G,) i32: interior particle count
    d2cut: np.ndarray   # (G,) f32: d2 of the (j-1)-th sorted particle
    vcm: np.ndarray     # (G,3) f32: mass-weighted mean velocity of interior
    kcap: np.ndarray | None = None  # (G,) i64: gather capacity of the
    #                     resolving stage — a sufficient capacity for any
    #                     re-gather at radius <= that stage's radius
    #                     (footprints are monotone in radius), used to size
    #                     the member/derived passes without escalation


# the capacity ceiling of the slab path when a caller names no stage
# width (k_slab_max gives the per-stage ceilings); tiers above a stage's
# ceiling gather through the ragged path with small batches
K_SLAB_MAX = 1 << 15

# slab-path capacity ceiling per output row count (d2 plus the requested
# channels): the (B, nch, K) slot buffers of a dispatch grow with both,
# so narrow stages (uniform-mass solves gather d2 only) reach larger K
_K_SLAB = {1: 1 << 20, 2: 1 << 19, 3: 1 << 18, 4: 1 << 18}


def k_slab_max(nch: int) -> int:
    """Slab-path capacity ceiling for an nch-row stage output (nch counts
    d2 plus the requested channels): nch=1 -> 2^20, 2 -> 2^19,
    3-4 -> 2^18, 5-8 -> 2^17. The table sets tier routing (which
    capacity tiers leave the slab path); it was inherited from an earlier
    build and is not yet re-derived on the H100."""
    if not 1 <= nch <= 8:
        raise ValueError(f"slab stage width {nch} outside 1..8")
    return _K_SLAB.get(nch, 1 << 17)


def _solve_kslab(grid) -> int:
    """Ceiling for the solve/classify stages: they gather d2 only on
    uniform-mass grids (the ladder replaces the mass channel), d2+mass
    otherwise."""
    um = getattr(grid, "uniform_mass", None)
    return k_slab_max(1 if um is not None else 2)

# --survey auto-gate (survey=None): catalogs below SURVEY_MIN_G halos skip
# the pre-pass entirely (its dispatch would cost more than it saves); above
# it, a SURVEY_SAMPLE-halo classify runs first and the full pre-pass only
# proceeds when >= SURVEY_FRAC of the sample resolves as -1/-2
SURVEY_MIN_G = 1 << 15
SURVEY_SAMPLE = 1024
SURVEY_FRAC = 0.25

# minimum round population for per-halo level bucketing (_bucket_levels):
# small tail rounds are dispatch-round-trip-bound, where splitting into
# level groups costs more than the smaller sort tiers save
BUCKET_MIN = 2048

# span sub-bucket quantization ladder: each distinct S is a distinct
# compile, so per-halo spans round UP to these
SPAN_LADDER = (2, 3, 5, 7, 9, 11)
# marginal device cost per (halo x candidate cell) of a slab dispatch
# (the cell enumeration and the descriptor walk scale with S^3), and the
# least device time a span sub-bucket must save to pay for its extra
# dispatch. Both were inherited from an earlier build and are not yet
# measured on the H100; they decide only how halos are bucketed, never
# a result.
_SPAN_CELL_S = 4e-8
_SPAN_MIN_SAVE_S = 0.05


def _span_subgroups(grid, g: int, S_g: int, radii: np.ndarray,
                    b: np.ndarray, s_max: int):
    """Split one level group into per-halo-span sub-buckets.

    A level group's S was the max covering span over its members, so in a
    mixed-radius catalog the many small halos paid the few big halos'
    S^3 cell walk (survey box: 1e6 halos at S=7 when the median needs
    S=3 — 279 vs 62 ms per 16k-halo classify dispatch). Each sub-bucket
    dispatches at the smallest ladder span covering every member, so hit
    sets are unchanged (the span only prunes cells the ball cannot
    intersect); sub-buckets that would not save _SPAN_MIN_SAVE_S of
    estimated device time merge upward into the next span. Returns
    [(g, S, positions)] partitioning ``b``. SO_JAX_SPAN_SPLIT=0 disables
    (single group at S_g) for A/B runs."""
    if os.environ.get("SO_JAX_SPAN_SPLIT", "1") == "0" or b.size == 0:
        return [(g, S_g, b)]
    cap = min(s_max, grid.ncell(g))
    cs = float(np.asarray(grid.period, np.float32).min()) / grid.ncell(g)
    # per-halo covering need — the same truncation as _span_at
    need = (2.0 * np.asarray(radii[b], np.float64) / cs).astype(np.int64) + 2
    need = np.maximum(np.minimum(need, cap), 1)
    qs = np.full(b.size, S_g, np.int64)
    for s in reversed([s for s in SPAN_LADDER if s < S_g]):
        qs[need <= s] = s
    uq = np.unique(qs)
    if uq.size == 1:
        return [(g, S_g, b)]
    groups = [(int(s), np.nonzero(qs == s)[0]) for s in uq]
    out = []
    pend = None
    for i, (s, pos) in enumerate(groups):
        if pend is not None:
            pos = np.concatenate([pend, pos])
            pend = None
        if i + 1 < len(groups):
            nxt = groups[i + 1][0]
            save = pos.size * (nxt ** 3 - s ** 3) * _SPAN_CELL_S
            if save < _SPAN_MIN_SAVE_S:
                pend = pos
                continue
        # ascending original order inside each bucket: a fully-merged
        # group is then dispatch-identical to the unsplit baseline (and
        # tier-2 eligibility windows see halos in catalog order)
        out.append((g, s, b[np.sort(pos)]))
    return out


def _level_groups(grid, radii: np.ndarray, s_max: int, K: int,
                  lam: float | None = None):
    """[(level, S, member-positions)] for one dispatch round: per-halo
    trap-avoiding levels (_bucket_levels) when the round is big enough to
    amortize extra dispatches, else the single legacy level; each level
    group further splits into per-halo-span sub-buckets when that saves
    device time (_span_subgroups). ``lam`` is
    the measured local-density correction (_calibrate_lambda); the
    default None reads the grid's cached calibration from the solve pass
    (solve_rvir sets grid._lam_cache), so the members/derived/fused
    passes bucket with the same measured density instead of λ=1."""
    if lam is None:
        lam = getattr(grid, "_lam_cache", None) or 1.0
    if radii.size >= BUCKET_MIN:
        lv = _bucket_levels(grid, radii, s_max, K, lam)
        out = []
        for g in np.unique(lv):
            b = np.nonzero(lv == g)[0]
            S_g = _span_at(grid, int(g), float(radii[b].max()), s_max)
            out.extend(_span_subgroups(grid, int(g), S_g, radii, b, s_max))
        return out
    level, S = _pick_level_span(grid, float(radii.max()) if radii.size
                                else 1e-30, s_max)
    return [(level, S, np.arange(radii.size))]


_FB_ALL = ("pos", "mass", "ptype", "mark")


def _stage_grid(grid, K: int, k_slab: int | None = None,
                fields: tuple = _FB_ALL):
    """Strip the slab payload for giant-K tiers (above the stage's
    slab ceiling, k_slab_max).

    ``k_slab`` is the calling stage's channel-aware ceiling (k_slab_max);
    None keeps the conservative K_SLAB_MAX. On a deduplicated grid
    (build_grid dropped the per-particle arrays in favor of the payload)
    the ragged fallback's arrays are materialized from the payload slices —
    but ONLY the ``fields`` the calling stage reads (the solve touches
    pos [+mass], members pos only; NO fallback stage reads vel — vcm is
    host-side). Each field is materialized once and cached on the grid
    object, so repeated giant-tier dispatches of any stage share one
    copy: at 512^3 an all-fields cache holds 4.4 GiB; pos+mass is
    2.1 GiB and the uniform-mass solve needs pos alone (1.6 GiB)."""
    if K > (K_SLAB_MAX if k_slab is None else k_slab) \
            and getattr(grid, 'soa8t', None) is not None:
        import dataclasses
        if getattr(grid, "pos", None) is not None:
            return dataclasses.replace(grid, soa8t=None)
        cache = getattr(grid, "_fb_fields", None)
        if cache is None:
            cache = {}
            grid._fb_fields = cache
        for f in fields:
            if f not in cache:
                cache[f] = getattr(grid, f + "_a")()
        return dataclasses.replace(
            grid, soa8t=None, **{f: cache.get(f) for f in _FB_ALL})
    return grid


def _k_limit(grid, s_max: int) -> int:
    """Capacity ceiling that is guaranteed gather-complete.

    The plain candidate total is bounded by the particle count, but the
    slab path's CHUNK-aligned run footprints can exceed it (up to one
    chunk of padding per candidate cell) — an overflow at a
    pow2ceil(npart) cap would otherwise escalate forever."""
    npart = grid.n
    extra = 0
    if getattr(grid, "soa8t", None) is not None:
        extra = (s_max ** 3) * getattr(grid, "chunk", 256)
    return max(256, 1 << int(np.ceil(np.log2(max(npart + extra, 2)))))


def _pick_level(grid: CellGrid, rmax: float, s_max: int) -> int:
    """Finest level whose S_MAX-cube covers radius rmax.

    On the slab path each nonempty cell costs a CHUNK-aligned slot
    footprint, so the level is also pushed coarse enough that mean cell
    occupancy is a healthy fraction of the chunk.
    """
    min_occ = 0
    if getattr(grid, "soa8t", None) is not None:
        min_occ = (3 * getattr(grid, "chunk", 256)) // 4
    # occupancy is a per-grid property: on sharded grids each shard's own
    # cells hold n_occ = n/nshards particles (grid_proxy sets n_occ), while
    # the capacity ceiling _k_limit still uses the global count
    n_occ = getattr(grid, "n_occ", grid.n)
    period = np.asarray(grid.period, np.float32)
    for g in range(grid.m + 1):
        cs = float(period.min()) / grid.ncell(g)
        occ = n_occ / (grid.ncell(g) ** 3)
        if 2 * int(np.ceil(rmax / cs)) + 2 <= s_max and occ >= min_occ:
            return g
    return grid.m


def _pick_level_span(grid: CellGrid, rmax: float, s_max: int) -> tuple[int, int]:
    """(level, S): the level as above plus the smallest cube side actually
    covering rmax there — the cell-enumeration cost scales with S^3, so a
    tight S beats always using s_max."""
    g = _pick_level(grid, rmax, s_max)
    cs = float(np.asarray(grid.period, np.float32).min()) / grid.ncell(g)
    span = min(int(2 * rmax / cs) + 2, s_max, grid.ncell(g))
    return g, max(span, 1)


def _span_at(grid, g: int, rmax: float, s_max: int) -> int:
    """Covering cube side for radius rmax at level g (clipped to s_max /
    the level's cell count)."""
    cs = float(np.asarray(grid.period, np.float32).min()) / grid.ncell(g)
    return max(min(int(2 * rmax / cs) + 2, s_max, grid.ncell(g)), 1)


# expected cell-enumeration cost per candidate cell, in slot-equivalents
# (inherited from an earlier build; not yet measured on the H100)
_CELL_COST_SLOTS = 36.0


@partial(jax.jit, static_argnames=("level", "S"))
def _foot_stage(grid: CellGrid, level: int, S: int, centers, radii):
    """Exact per-halo slab-slot footprints (cell_ranges totals) — a tiny
    enumeration-only dispatch used to CALIBRATE the level cost model: the
    mean-occupancy estimate underpredicts footprints near clumps (halos
    sit in overdensities; measured ~6x on the dense 8.4M box), which made
    the trap detection miss exactly where it matters."""
    from ..ops.gather import cell_ranges

    _, _, _, total = cell_ranges(grid, level, centers, radii,
                                 radii * radii, S,
                                 align=getattr(grid, "chunk", 1)
                                 if getattr(grid, "soa8t", None) is not None
                                 else 1)
    return total


def _est_span(grid, radii: np.ndarray, g: int, s_max: int):
    """(ok, dens, slack, span) of the footprint model at level g:
    candidate rows from mean occupancy (dens — the local-density-scalable
    part) and CHUNK-alignment run slack (slack — geometry-bound)."""
    n_occ = getattr(grid, "n_occ", grid.n)
    chunk = getattr(grid, "chunk", 256) \
        if getattr(grid, "soa8t", None) is not None else 0
    period = float(np.asarray(grid.period, np.float32).min())
    ncg = grid.ncell(g)
    cs = period / ncg
    need = (2.0 * radii / cs).astype(np.int64) + 2
    ok = (need <= s_max) | (ncg <= s_max)      # ncg <= s_max: whole box
    ecells = (1.0 + 2.0 * radii / cs) ** 3
    dens = (n_occ / ncg ** 3) * ecells
    slack = (1.0 + ecells / 3.0) * chunk
    span = np.minimum(need, min(s_max, ncg))
    return ok, dens, slack, span


def _calibrate_lambda(grid, centers: np.ndarray, radii: np.ndarray,
                      s_max: int) -> float:
    """Density-correction factor for the footprint model: exact footprints
    (one tiny _foot_stage dispatch over a strided halo sample) over the
    mean-occupancy estimate, 75th percentile, clipped to [1, 64]."""
    n = radii.size
    step = max(1, n // 1024)
    idx = np.arange(0, n, step)[:1024]
    rs = np.asarray(radii, np.float64)[idx]
    g = _pick_level(grid, float(rs.max()), s_max)
    ok, dens, slack, _ = _est_span(grid, rs, g, s_max)
    if not ok.any():
        return 1.0
    S = _span_at(grid, g, float(rs[ok].max()), s_max)
    c_pad = np.asarray(centers, np.float32)[idx[ok]]
    r_pad = np.asarray(radii, np.float32)[idx[ok]]
    t0 = _pc()
    total = np.asarray(_foot_stage(grid, g, S, jnp.asarray(c_pad),
                                   jnp.asarray(r_pad)))
    _dbg_stage("foot-probe", t0, level=g, S=S, n=int(ok.sum()))
    lam = (total.astype(np.float64) - slack[ok]) / np.maximum(dens[ok], 1.0)
    return float(np.clip(np.percentile(lam, 75.0), 1.0, 64.0))


def _bucket_levels(grid, radii: np.ndarray, s_max: int,
                   K: int, lam: float = 1.0) -> np.ndarray:
    """Per-halo grid level: the legacy occupancy-floor level unless that
    level's expected slot footprint overflows the capacity tier K — the
    dense-box trap, where one coarse level forced every small halo's
    footprint past K and the whole batch escalated into the superlinear
    K=16384 sort tier. Trapped halos move to the cheapest FINER level whose
    estimated footprint fits 3/4*K, costed as
        est_foot (mean occupancy x intersected cells + CHUNK-aligned run
        slack; calibrated in experiments/level_cost_probe.py)
        + _CELL_COST_SLOTS * span^3 (cell-enumeration work).
    Untrapped halos keep the measured-and-tuned legacy level, so sparse
    boxes are bit-and-perf-identical to the single-level dispatch.
    Exactness is level-independent: every level yields the same hit set
    (the acceptance test is d2 <= r2, not cell membership).
    """
    radii = np.maximum(np.asarray(radii, np.float64), 1e-30)
    n = radii.size
    n_occ = getattr(grid, "n_occ", grid.n)
    chunk = getattr(grid, "chunk", 256) \
        if getattr(grid, "soa8t", None) is not None else 0
    min_occ = (3 * chunk) // 4
    L = grid.m + 1

    ok = np.zeros((L, n), bool)
    est = np.full((L, n), np.inf)
    score = np.full((L, n), np.inf)
    occ_ok = np.zeros(L, bool)
    for g in range(L):
        ok_g, dens, slack, span = _est_span(grid, radii, g, s_max)
        # lam: measured local-density correction (_calibrate_lambda) —
        # halos live in overdensities, so the mean-occupancy term is
        # scaled while the alignment-slack term is geometry-bound
        e = lam * dens + slack
        ok[g] = ok_g
        occ_ok[g] = (n_occ / grid.ncell(g) ** 3) >= min_occ
        est[g, ok_g] = e[ok_g]
        score[g] = est[g] + _CELL_COST_SLOTS * span.astype(np.float64) ** 3

    # legacy level: finest g with span fit and the occupancy floor
    legal = ok & occ_ok[:, None]
    legal[L - 1] = True                      # whole-box fallback
    legacy = np.argmax(legal, axis=0).astype(np.int32)
    rows = np.arange(n)
    trapped = est[legacy, rows] > K
    if not trapped.any():
        return legacy

    fits = ok & (est <= 0.75 * K)            # margin absorbs est error
    cand = np.where(fits, score, np.inf)
    best = np.argmin(cand, axis=0).astype(np.int32)
    has_fit = np.isfinite(cand[best, rows])
    move = trapped & has_fit
    # a non-legacy bucket costs one extra dispatch round-trip; unless a
    # meaningful population escapes the trap, the legacy escalation
    # (fused tier 2) handles the few big halos more cheaply
    if move.sum() < BUCKET_MIN // 2:
        return legacy
    out = legacy.copy()
    out[move] = best[move]
    return out


def _pad_to_bucket(n: int, buckets=(256, 1024, 4096)) -> int:
    for b in buckets:
        if n <= b:
            return b
    return ((n + 4095) // 4096) * 4096


def _chunk_for(K: int, slot_budget: int, k_slab: int | None = None) -> int:
    """Halos per dispatch. XLA-fallback tiers (K above the stage's slab
    ceiling) hold many live (B, K) temporaries, so their B*K budget is
    much smaller."""
    if K > (K_SLAB_MAX if k_slab is None else k_slab):
        return max(1, min(64, min(slot_budget, 1 << 23) // K))
    return max(1, min(16384, min(slot_budget, 1 << 26) // K))


# above this K the batch pad switches to finer buckets: a 32->256
# bucket pad at K=2^19 is 87% wasted sort work and an n=128 chunk padded
# to 256 doubles it (each padded row costs a K-wide sort lane). The
# bucket floor of 32 (not pow2ceil) bounds the compile count: each
# distinct B at a giant K is one more compile.
_PAD_FINE_K = 1 << 17


def _pad_b(n: int, K: int, k_slab: int | None = None) -> int:
    """Batch pad bucket; giant-K tiers keep B tiny so B*K slot buffers
    stay within device memory (no minimum pad: an 8-halo pad of a
    B=1/K=2^23 dispatch multiplies its (B,K) temporaries x8)."""
    if K > (K_SLAB_MAX if k_slab is None else k_slab):
        return max(1, 1 << int(np.ceil(np.log2(max(n, 1)))))
    if K >= _PAD_FINE_K:
        # 512 tops the ladder: _chunk_for caps chunks at 512 for K=2^17
        # (the smallest K here), so no chunk outgrows the buckets
        return _pad_to_bucket(n, buckets=(32, 64, 128, 256, 512))
    return _pad_to_bucket(n)


def _dispatch_chunks(sel: np.ndarray, K: int, slot_budget: int,
                     k_slab: int | None = None):
    """Chunk a live halo set so each dispatch's B*K slot buffers stay
    within the budget — the ONE chunking rule for the survey, fused, and
    classic rounds of solve_rvir (they previously triplicated it, with
    the survey/fused copies ignoring slot_budget). Defers to _chunk_for
    so giant-K ragged-fallback tiers get their much smaller budget (they
    hold many live (B, K) temporaries)."""
    chunk = _chunk_for(K, slot_budget, k_slab)
    for lo in range(0, sel.size, chunk):
        yield lo, sel[lo:lo + chunk]


def _pad_chunk(part_size: int, K: int, centers, radii,
               k_slab: int | None = None):
    """(B, padded centers, padded radii) for one dispatch chunk."""
    B = _pad_b(part_size, K, k_slab)
    c_pad = np.zeros((B, 3), np.float32)
    r_pad = np.zeros(B, np.float32)
    c_pad[:part_size] = centers
    r_pad[:part_size] = radii
    return B, c_pad, r_pad


# device dispatches issued by solve_rvir (all rounds); bench.py reports
# the delta per rep
DISPATCHES = 0

# candidate distance evaluations issued (sum of B*K slot buffers per
# dispatch, + B2*K2 for fused tier-2 blocks): every slot gets one d2
# against its halo center, so this is the BASELINE.md secondary metric
# "particle-distance evals/sec" numerator (experiments/scale512.py)
EVAL_SLOTS = 0


def _pipelined() -> bool:
    """Depth-2 dispatch pipelining (dispatch chunk i+1 before blocking on
    chunk i's transfer). SO_JAX_PIPELINE=0 forces depth-1; outputs are
    bit-identical either way. Read per call so a run can A/B it."""
    return os.environ.get("SO_JAX_PIPELINE", "1") != "0"


def _dbg_stage(name: str, t0: float, **kv):
    global DISPATCHES, EVAL_SLOTS
    DISPATCHES += 1
    if "B" in kv and "K" in kv:
        EVAL_SLOTS += kv["B"] * kv["K"] + kv.get("B2", 0) * kv.get("K2", 0)
    if os.environ.get("SO_JAX_DEBUG"):
        fields = " ".join(f"{k}={v}" for k, v in kv.items())
        print(f"so_jax[solve]: {name} {fields} "
              f"dt={(_pc() - t0) * 1e3:.1f}ms", file=sys.stderr, flush=True)


def solve_rvir(grid: CellGrid, centers: np.ndarray, rgtp: np.ndarray,
               thr: float, n_members: int = 8,
               k0_cap: int = 4096, s_max: int = 11,
               slot_budget: int = 1 << 26,
               progress=None, stage_fn=None, fused=None,
               fused_b2: int = 256, fused_stage_fn=None,
               survey: bool | None = None,
               classify_stage_fn=None) -> SolveResult:
    """Solve R_Delta for every halo (batched, staged capacity escalation).

    ``stage_fn(level, K, S, n_members, centers, radii, thr)`` overrides the
    single-device stage kernel — the multi-device path
    (parallel.mesh.solve_rvir_sharded) injects its shard_map stage here and
    reuses this escalation driver unchanged.

    ``fused`` runs the first round through _solve_stage_fused (tier 1 +
    compacted tier 2 in one dispatch); default: on for the slab path with
    large batches, where the second round-trip dominates the tail cost.
    ``fused_stage_fn(level, K, S, level2, K2, S2, B2, n_members, dk,
    centers, radii, kleft, thr)`` overrides the fused kernel the same way
    stage_fn overrides the plain one (parallel.mesh injects its shard_map
    fused stage) — the host decision logic is identical either way.

    ``survey``: run a sort-free -1/-2 classifier over the first ladder
    rung before the full rounds (see _classify_stage) — a large win for
    candidate-rich catalogs where most halos fail those checks, a small
    extra dispatch otherwise. True forces it (CLI --survey), False
    disables it, and the default None AUTO-gates: catalogs of
    SURVEY_MIN_G+ halos classify a small sample first and continue only
    if enough of it resolves. Needs direct grid access OR an injected
    ``classify_stage_fn(level, K, S, n_members, c_pad, r_pad, thr_vec)``
    (parallel.mesh.sharded_classify_fn / parallel.driver.dist_classify_fn
    — the part-merged kk-prefix classify), so --survey works under
    --mesh and --distributed too.
    """
    default_stage = stage_fn is None
    # channel-aware slab ceiling for the solve/classify gathers (1 row
    # uniform-mass, 2 rows general) — giant tiers below it stay on the
    # slab path instead of the XLA fallback
    ks = _solve_kslab(grid)
    # the XLA fallback reads pos (+mass on non-uniform grids) only
    fb_fields = ("pos",) if grid.uniform_mass is not None \
        else ("pos", "mass")
    # uniform-mass grids route tiers above the slab ceiling to the
    # whole-box terminal stage instead of the XLA gather fallback: no
    # per-particle fallback copy, no capacity escalation, one dispatch
    # per super-giant halo (the ladder-prefix equivalence lets it jump
    # straight to the final rung — see the module docstring)
    wbox = default_stage and grid.uniform_mass is not None
    if stage_fn is None:
        stage_fn = lambda level, K, *a: _solve_stage(
            _stage_grid(grid, K, ks, fb_fields), level, K, *a)
    G = centers.shape[0]
    period = np.asarray(grid.period, np.float32)
    centers = np.asarray(centers, np.float32)
    rgtp = np.asarray(rgtp, np.float32)
    thr32 = jnp.float32(thr)

    # the slab path enumerates all S^3 cell slots per halo, so it prefers
    # a smaller cube at a coarser (occupancy-matched) level; a bounded S
    # also bounds the compile count. s_max=7 was inherited from an earlier
    # build and is not yet re-derived on the H100.
    has_slab = getattr(grid, "soa8t", None) is not None
    if has_slab:
        s_max = min(s_max, 7)
    if fused is None:
        # fused round 1 needs direct grid access (no injected stage) and a
        # batch big enough that the saved round-trip matters
        fused = ((has_slab and default_stage) or fused_stage_fn is not None) \
            and G >= 2048
    can_fuse = fused_stage_fn is not None or (has_slab and default_stage)

    code = np.zeros(G, np.int32)
    mvir = np.zeros(G, np.float32)
    rvir = np.zeros(G, np.float32)
    jout = np.zeros(G, np.int32)
    d2cut = np.zeros(G, np.float32)
    vcm = np.zeros((G, 3), np.float32)
    kcap = np.full(G, k0_cap, np.int64)
    resolved = np.zeros(G, bool)

    kmax, _cap = rvir_ladder(rgtp, period)

    # loop never entered -> immediate -3 (kd2.c:766, 836-839)
    zero_iter = kmax == 0
    code[zero_iter] = -3
    mvir[zero_iter] = -3.0
    rvir[zero_iter] = -3.0
    resolved |= zero_iter

    # per-halo tier state
    cur_k = np.ones(G, np.int32)          # ladder exponent (first gather: k=1)
    cur_cap = np.full(G, k0_cap, np.int64)
    minus1_open = np.ones(G, bool)        # -1 check still undecided
    DK = 8                                # ladder exponents per escalation
    #                                       (few big jumps: every extra tail
    #                                       round costs a full dispatch)
    k_cap_max = max(2 * _k_limit(grid, s_max), k0_cap)

    # local-density calibration for the level cost model: one tiny
    # enumeration-only dispatch over a halo sample (needs direct grid
    # access and a batch big enough for bucketing to be in play). Cached
    # per grid object — the density field is a property of the snapshot,
    # and the probe dispatch should not be paid on every solve over the
    # same grid
    lam = getattr(grid, "_lam_cache", None)
    if lam is None and default_stage and has_slab and G >= BUCKET_MIN \
            and not resolved.all():
        live0 = np.nonzero(~resolved)[0]
        if live0.size >= BUCKET_MIN:
            lam = _calibrate_lambda(
                grid, centers[live0],
                ladder_radius(rgtp[live0],
                              np.minimum(cur_k[live0], kmax[live0])),
                s_max)
            try:
                grid._lam_cache = lam
            except AttributeError:
                pass
    lam = 1.0 if lam is None else lam

    def apply_round(part, ints, flts, k_now, cap_now, dk=DK):
        """One round of the reference's regrow decisions (kd2.c:745-839)
        for a batch of halos, given their stage outputs. Mutates the
        enclosing per-halo state arrays; identical whether the stage ran
        as its own dispatch or as a pass of the fused program. ``dk`` is
        the ladder step for the grow-ball escalation (any step sequence
        yields identical results — the scan's first crossing is
        rung-path-independent; see the module docstring)."""
        if part.size == 0:
            return
        n_in = ints[:, 0]
        jstar = ints[:, 1]
        found = ints[:, 2].astype(bool)
        ovf = ints[:, 3].astype(bool)
        o_mvir, o_rvir, o_d2c = flts[:, 0], flts[:, 1], flts[:, 2]

        cur_k[part] = np.minimum(k_now, kmax[part])
        at_cap_k = cur_k[part] >= kmax[part]

        # -1: first ladder radius holds < nMembers (kd2.c:772-778).
        # Decidable negative when n_in >= nMembers (any capacity);
        # decidable positive only without overflow.
        m1 = minus1_open[part]
        is_m1 = m1 & ~ovf & (n_in < n_members)
        minus1_open[part[n_in >= n_members]] = False

        # resolutions (only trustworthy without overflow)
        ok = ~ovf
        is_m2 = ok & found & (jstar == n_members - 2) & ~is_m1
        is_succ = ok & found & (jstar > n_members - 2) & ~is_m1
        is_m3 = ok & ~found & at_cap_k & ~is_m1 & ~minus1_open[part]

        idx = part[is_m1]
        code[idx] = -1; mvir[idx] = -1.0; rvir[idx] = -1.0; resolved[idx] = True
        idx = part[is_m2]
        code[idx] = -2; mvir[idx] = -2.0; rvir[idx] = -2.0; resolved[idx] = True
        idx = part[is_m3]
        code[idx] = -3; mvir[idx] = -3.0; rvir[idx] = -3.0; resolved[idx] = True
        kcap[part] = np.maximum(kcap[part], int(cap_now))
        idx = part[is_succ]
        code[idx] = 0
        mvir[idx] = o_mvir[is_succ]
        # host-exact Rvir from the f32 Mvir bits (the device value is a
        # cbrt estimate whose last ulp can differ from kd2.c:816-819)
        rvir[idx] = rvir_reference_bits(o_mvir[is_succ], thr)
        jout[idx] = jstar[is_succ]
        d2cut[idx] = o_d2c[is_succ]
        resolved[idx] = True

        def _never_skip_ks(old, new):
            """A capacity escalation must TRY the slab ceiling before
            exceeding it: x4 growth from 2^19 is 2^21, skipping the
            ks=2^20 tier — halos whose footprint fits 2^20 then fell
            through to the whole-box tier (at 512^3: 294 wbox dispatches
            instead of ~32)."""
            return np.where((old < ks) & (new > ks), ks, new)

        # escalation for the rest
        rest = ~(is_m1 | is_m2 | is_succ | is_m3)
        # overflow (or -1 undecided under overflow): more capacity,
        # same radius — mirrors smGrowList (smooth2.c:49-55)
        grow_cap = rest & ovf
        cur_cap[part[grow_cap]] = _never_skip_ks(
            cur_cap[part[grow_cap]], np.minimum(
                np.asarray(cap_now, np.int64)[grow_cap] * 4
                if np.ndim(cap_now) else int(cap_now) * 4, k_cap_max))
        # no overflow, nothing found, ladder not exhausted: grow ball.
        # Halos already AT the slab ceiling step finely (dk=2): a dk=8
        # jump grows their gather volume ~80x, off the slab path into
        # the whole-box sort, when their crossing is typically 1-2 rungs
        # out — 443 halos/pass fell that way in the 512^3 multi run.
        # Fine steps keep them in
        # K=2^20 slab dispatches; the truly giant remainder still
        # overflows to the terminal whole-box tier.
        grow_ball = rest & ~ovf & ~at_cap_k
        gi = part[grow_ball]
        dkv = np.where(cur_cap[gi] >= ks, min(dk, 2), dk)
        cur_k[gi] = np.minimum(cur_k[gi] + dkv, kmax[gi])
        # pre-size capacity for the larger ball from observed density
        vol_ratio = np.ceil(
            np.float64(1.2) ** (3 * dkv)).astype(np.int64)
        est = (n_in[grow_ball].astype(np.int64) + 64) * vol_ratio
        cur_cap[gi] = _never_skip_ks(
            cur_cap[gi],
            np.maximum(cur_cap[gi],
                       np.minimum(2 ** np.ceil(np.log2(
                           np.maximum(est, 1))).astype(np.int64),
                           k_cap_max)))
        if progress is not None:
            progress(resolved.sum(), G)

    if survey is not False and not resolved.all() \
            and (default_stage or classify_stage_fn is not None):
        # sort-free -1/-2 pre-pass over the first ladder rung: resolves
        # the candidate-poor bulk of survey catalogs without a K-wide
        # sort; survivors rescan rung 1 in the normal rounds (cheap
        # relative to the skipped sorts — the scan is round-stateless).
        # survey=None is the AUTO gate: on sizeable catalogs, classify a
        # small sample first and run the full pre-pass only when a
        # meaningful fraction of it resolves — dense survey boxes get the
        # 2.6x win with no flag, well-posed catalogs pay one small extra
        # dispatch (and catalogs below SURVEY_MIN_G none at all).
        live = np.nonzero(~resolved)[0]
        auto = survey is None
        if not auto or live.size >= SURVEY_MIN_G:
            K = int(min(k0_cap, _k_limit(grid, s_max)))
            k_eff = np.minimum(cur_k[live], kmax[live])
            radii_all = ladder_radius(rgtp[live], k_eff)
            thr_vec = jnp.asarray([thr], jnp.float32)

            def classify_dispatch(part, radii, level, S):
                B, c_pad, r_pad = _pad_chunk(part.size, K, centers[part],
                                             radii, ks)
                t0 = _pc()
                if classify_stage_fn is not None:
                    out = classify_stage_fn(
                        level, K, S, n_members, c_pad, r_pad, thr_vec)
                else:
                    out = _classify_stage(
                        _stage_grid(grid, K, ks, fb_fields), level, K, S,
                        n_members, jnp.asarray(c_pad), jnp.asarray(r_pad),
                        thr_vec, T=1)
                return (part, B, level, S, t0, out)

            def classify_apply(part, B, level, S, t0, out):
                arr = np.asarray(out)
                _dbg_stage("classify", t0, B=B, K=K, S=S, level=level,
                           n=part.size)
                w0 = arr[:part.size, 0]
                n_in = w0 & 0x7FFFFFFF
                ovf = (w0 >> 31) & 1
                m2f = arr[:part.size, 1] & 1
                ok_v = ovf == 0
                is_m1 = ok_v & (n_in < n_members) & minus1_open[part]
                minus1_open[part[n_in >= n_members]] = False
                is_m2 = ok_v & (m2f > 0) & ~is_m1
                idx = part[is_m1]
                code[idx] = -1; mvir[idx] = -1.0; rvir[idx] = -1.0
                resolved[idx] = True
                idx = part[is_m2]
                code[idx] = -2; mvir[idx] = -2.0; rvir[idx] = -2.0
                resolved[idx] = True
                return int(is_m1.sum() + is_m2.sum())

            def run_classify(idx_arr, rads):
                # pipeline depth 2: dispatch chunk i+1 before blocking on
                # chunk i's transfer — chunks are disjoint halo sets and
                # dispatch reads nothing that apply mutates, so the host's
                # apply overlaps the next chunk's device work
                total = 0
                if idx_arr.size == 0:
                    return total
                pending = None
                for level, S, b in _level_groups(grid, rads, s_max, K, lam):
                    sel_g, rad_g = idx_arr[b], rads[b]
                    for lo, part in _dispatch_chunks(sel_g, K, slot_budget,
                                                     ks):
                        nxt = classify_dispatch(
                            part, rad_g[lo:lo + part.size], level, S)
                        if not _pipelined():
                            total += classify_apply(*nxt)
                            continue
                        if pending is not None:
                            total += classify_apply(*pending)
                        pending = nxt
                if pending is not None:
                    total += classify_apply(*pending)
                return total

            start = 0
            if auto:
                ns = min(SURVEY_SAMPLE, live.size)
                n_res = run_classify(live[:ns], radii_all[:ns])
                start = ns if n_res >= SURVEY_FRAC * ns else live.size
            run_classify(live[start:], radii_all[start:])

    if fused and can_fuse and not resolved.all():
        # round 1 + compacted round 2 in one dispatch, bucketed by the
        # per-halo footprint-minimizing level (_bucket_levels): small
        # halos of dense boxes stay in small footprints/sort tiers while
        # big halos dispatch at coarser levels
        live = np.nonzero(~resolved)[0]
        K = int(min(k0_cap, _k_limit(grid, s_max)))
        K2 = int(min(ks, _k_limit(grid, s_max), 8 * K))
        B2 = fused_b2   # tier-2 rows per dispatch; halos beyond this
        #                 spill into the classic escalation rounds
        # ladder step for the spill halos' growth (tier-2 itself steps DK
        # on device). A finer step for big spill populations was measured
        # AND REJECTED on the 512^3 box: dk=2's tight x3 volume presize
        # makes intermediate rungs overflow repeatedly, laddering caps x4
        # past the slab ceiling — the whole-box tier exploded from 32 to
        # 379 dispatches.
        # The dk=8 jump OVER-gathers (x80 volume) but lands most halos at
        # their crossing in one round with a presize that covers it.
        dk_f = DK
        k_eff_l = np.minimum(cur_k[live], kmax[live])
        radii_l = ladder_radius(rgtp[live], k_eff_l)
        fpend = None

        def fused_apply(part, B, k_eff_sl, t0, level, S, level2, S2,
                        packed):
            arr = np.asarray(packed)
            _dbg_stage("fused", t0, B=B, K=K, S=S, level=level, K2=K2,
                       S2=S2, level2=level2, B2=B2, n=part.size)
            ints1, flts1 = unpack_stage_out(arr[:part.size, :5])
            p2 = arr[B:]
            ids = p2[:, 5]
            steps = p2[:, 6]
            ok2 = (ids >= 0) & (ids < part.size)
            ids_l = ids[ok2]
            # -1 openness closes on the tier-1 counts for everyone
            # BEFORE tier-2 rows are judged (the classic round order)
            minus1_open[part[ints1[:, 0] >= n_members]] = False
            mask1 = np.ones(part.size, bool)
            mask1[ids_l] = False
            apply_round(part[mask1], ints1[mask1], flts1[mask1],
                        k_eff_sl[mask1], K, dk_f)
            ints2, flts2 = unpack_stage_out(p2[ok2][:, :5])
            apply_round(part[ids_l], ints2, flts2,
                        k_eff_sl[ids_l] + steps[ok2], K2, dk_f)

        for level, S, b in _level_groups(grid, radii_l, s_max, K, lam):
            sel = live[b]
            k_eff = k_eff_l[b]
            radii = radii_l[b]
            rmax = float(radii.max())
            r2max = float(ladder_radius(
                rgtp[sel], np.minimum(k_eff + DK, kmax[sel])).max())
            # prefer the tier-1 level for tier 2: overflow halos regather
            # at their tier-1 radius, and a coarser level would inflate
            # their chunk-aligned footprints past K2; only go coarser when
            # the grown ladder radius cannot fit in an s_max cube here
            cs1 = float(np.asarray(grid.period, np.float32).min()) \
                / grid.ncell(level)
            span2 = int(2 * r2max / cs1) + 2
            kl_zero = False
            if span2 <= s_max:
                level2, S2 = level, max(span2, S)
            else:
                # the DK-grown ladder radii cannot fit an s_max cube at
                # the tier-1 level. A coarser shared level2 once inflated
                # the OVERFLOW population's chunk-aligned footprints past
                # K2 (dense 8.4M box: 161 giant halos overflowed into a
                # 1.1 s K=131072 XLA tail although they fit K2 at the
                # tier-1 level) — so keep tier 2 at the tier-1 level for
                # the overflow re-gathers (same radii: S suffices) and
                # route the ladder-growers to the classic rounds
                # (kleft=0 removes them from tier-2 eligibility)
                level2, S2 = level, S
                kl_zero = True
            for lo, part in _dispatch_chunks(sel, K, slot_budget, ks):
                B, c_pad, r_pad = _pad_chunk(part.size, K, centers[part],
                                             radii[lo:lo + part.size], ks)
                kl_pad = np.zeros(B, np.int32)
                if not kl_zero:
                    kl_pad[:part.size] = kmax[part] \
                        - k_eff[lo:lo + part.size]
                t0 = _pc()
                if fused_stage_fn is not None:
                    packed = fused_stage_fn(
                        level, K, S, level2, K2, S2, B2, n_members, DK,
                        jnp.asarray(c_pad), jnp.asarray(r_pad),
                        jnp.asarray(kl_pad), thr32)
                else:
                    packed = _solve_stage_fused(
                        grid, level, K, S, level2, K2, S2, B2, n_members,
                        DK, jnp.asarray(c_pad), jnp.asarray(r_pad),
                        jnp.asarray(kl_pad), thr32)
                # pipeline depth 2: queue this chunk's program, then block
                # on the PREVIOUS chunk's transfer + host apply — chunks
                # are disjoint halo sets and apply_round mutates only its
                # own halos' state, so the next device program runs while
                # the host processes the last one
                nxt = (part, B, k_eff[lo:lo + part.size], t0,
                       level, S, level2, S2, packed)
                if not _pipelined():
                    fused_apply(*nxt)
                    continue
                if fpend is not None:
                    fused_apply(*fpend)
                fpend = nxt
        if fpend is not None:
            fused_apply(*fpend)

    guard = 0
    while not resolved.all():
        guard += 1
        if guard > 200:
            raise RuntimeError("solver failed to converge (escalation runaway)")
        live = np.nonzero(~resolved)[0]
        # unify the capacity tier across the round: fully when the tail
        # fits one dispatch at the unified capacity (tiny tails share one
        # program), otherwise only within a x16 band of the max — halos
        # further below keep their own presized caps. Both halves are
        # measured: dropping unification entirely sent ~150 halos/pass
        # through whole-box sorts (their crossing resolves EARLY at an
        # inflated-cap big-K dispatch under unification, before their
        # ladder radii balloon past the slab ceiling), while unbanded
        # unification dragged 14.7k presized small halos into K=2^20
        # sort lanes (461 dispatches of the 512^3 multi run).
        # With the whole-box terminal tier in play, unify only WITHIN the
        # gather tiers: lifting sub-ceiling halos into a giant tier would
        # drag them through full-box sorts they don't need (and the giant
        # halos are terminal in one wbox dispatch anyway)
        if guard > 1 and live.size:
            kl = _k_limit(grid, s_max)
            sub = live[np.minimum(cur_cap[live], kl) <= ks] if wbox \
                else live
            if sub.size:
                capu = cur_cap[sub].max()
                if sub.size <= _chunk_for(int(min(capu, kl)), slot_budget,
                                          ks):
                    cur_cap[sub] = capu
                else:
                    band = sub[cur_cap[sub] * 16 > capu]
                    cur_cap[band] = capu
        # ladder step for this round's grow-ball escalations. dk=2 for
        # large tails was measured AND REJECTED (see dk_f above): the
        # overshoot of dk=8 is what keeps overflow rounds rare and halos
        # off the whole-box tier.
        dk_round = DK
        caps = np.unique(cur_cap[live])
        # pipeline depth 2 across the round's dispatches (disjoint halo
        # sets; apply_round only touches its own halos) — flushed before
        # the while condition re-reads `resolved`
        spend = None

        def stage_apply(part, B, K, k_eff_sl, t0, level, S, rmax, packed,
                        dk):
            ints, flts = unpack_stage_out(np.asarray(packed)[:part.size])
            _dbg_stage("stage", t0, B=B, K=K, S=S, level=level,
                       n=part.size, rmax=rmax)
            apply_round(part, ints, flts, k_eff_sl, K, dk)

        for capacity in caps:
            sel0 = live[cur_cap[live] == capacity]
            K = int(min(capacity, _k_limit(grid, s_max)))
            if wbox and K > ks and sel0.size:
                # terminal whole-box tier for uniform-mass giants: d2
                # against EVERY particle, so capacity is the particle
                # count and overflow is impossible. The ladder-prefix
                # equivalence (module docstring) lets a halo whose -1
                # verdict is closed jump straight to its FINAL rung —
                # one dispatch settles it as success/-2/-3, with no
                # per-particle fallback copy and no escalation (a giant
                # B=8/K=2^21 ragged-fallback dispatch ran out of memory
                # at 512^3). A still-open -1 halo (only
                # possible while every prior round overflowed, so still
                # at rung 1) dispatches at its current rung to decide
                # -1 exactly first.
                lad = _wbox_ladder_dev(grid)
                Bw = _wbox_chunk(grid.n)
                k_dst = np.where(minus1_open[sel0],
                                 np.minimum(cur_k[sel0], kmax[sel0]),
                                 kmax[sel0]).astype(np.int32)
                radii_w = ladder_radius(rgtp[sel0], k_dst)
                for lo in range(0, sel0.size, Bw):
                    part = sel0[lo:lo + Bw]
                    nb = part.size
                    c_pad = np.zeros((Bw, 3), np.float32)
                    r_pad = np.zeros(Bw, np.float32)
                    c_pad[:nb] = centers[part]
                    r_pad[:nb] = radii_w[lo:lo + nb]
                    t0 = _pc()
                    packed = _whole_box_stage(
                        grid, lad, n_members, jnp.asarray(c_pad),
                        jnp.asarray(r_pad), thr32)
                    ints, flts = unpack_stage_out(np.asarray(packed)[:nb])
                    _dbg_stage("wbox", t0, B=Bw, K=grid.n, n=nb)
                    apply_round(part, ints, flts, k_dst[lo:lo + nb],
                                grid.n, dk_round)
                continue
            k_eff0 = np.minimum(cur_k[sel0], kmax[sel0])
            radii0 = ladder_radius(rgtp[sel0], k_eff0)
            for level, S, b in _level_groups(grid, radii0, s_max, K, lam):
                sel, k_eff, radii = sel0[b], k_eff0[b], radii0[b]
                for lo, part in _dispatch_chunks(sel, K, slot_budget, ks):
                    B, c_pad, r_pad = _pad_chunk(
                        part.size, K, centers[part],
                        radii[lo:lo + part.size], ks)
                    t0 = _pc()
                    packed = stage_fn(level, K, S, n_members,
                                      jnp.asarray(c_pad),
                                      jnp.asarray(r_pad), thr32)
                    nxt = (part, B, K, k_eff[lo:lo + part.size], t0,
                           level, S, f"{float(r_pad.max()):.4g}", packed,
                           dk_round)
                    if not _pipelined():
                        stage_apply(*nxt)
                        continue
                    if spend is not None:
                        stage_apply(*spend)
                    spend = nxt
        if spend is not None:
            stage_apply(*spend)
    return SolveResult(code=code, mvir=mvir, rvir=rvir, j=jout, d2cut=d2cut,
                       vcm=vcm, kcap=kcap)
