"""Multi-threshold solver: R_200c / R_200m / R_vir catalogs in one pass.

The reference solves one overdensity threshold per run; multi-threshold
catalogs (BASELINE.json's 512^3 config) would re-run the whole program.
On the device the gather+sort dominates and the density scan is nearly
free, so this extension evaluates T thresholds against the *same* sorted
candidate stream per halo: per threshold the scan is exactly the
single-threshold rule (error codes included), so each output catalog
matches an independent reference run at that threshold.

The give-up ladder and the -1 check are threshold-independent (they depend
only on geometry/counts: kd2.c:765-778), so the escalation driver tracks
one ball per halo and a (T,)-vector of resolutions.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..ops.gather import ragged_ball_gather, slab_gather
from ..ops.grid import CellGrid
from . import solver as _solver
from .solver import (_chunk_for, _classify_stage, _k_limit, _pad_b,
                     _pad_chunk, _pad_to_bucket, _pick_level_span,
                     _stage_grid, ladder_radius, rvir_ladder,
                     rvir_reference_bits, scan_sorted)


@dataclass
class MultiSolveResult:
    """Per-(threshold, halo) results; axis 0 indexes thresholds."""
    code: np.ndarray    # (T, G) i32
    mvir: np.ndarray    # (T, G) f32
    rvir: np.ndarray    # (T, G) f32
    j: np.ndarray       # (T, G) i32
    d2cut: np.ndarray   # (T, G) f32


@partial(jax.jit, static_argnames=("level", "K", "S", "n_members", "T"))
def _multi_stage(grid: CellGrid, level: int, K: int, S: int, n_members: int,
                 T: int, centers, radii, thresholds):
    um = grid.uniform_mass
    if grid.soa8t is not None:
        g = slab_gather(grid, level, centers, radii, radii * radii, K, S,
                        channels=() if um is not None else ("mass",))
        mass_s = None if um is not None else g.channels[0]
        d2_s, n_in, ovf = g.d2, g.n_in, g.overflow
    else:
        g = ragged_ball_gather(grid, level, centers, radii, radii * radii,
                               K, S, sort=True)
        if um is not None:
            mass_s = None
        else:
            slot = jnp.arange(K, dtype=jnp.int32)[None, :]
            mass_s = jnp.where(slot < g.n_in[:, None],
                               grid.mass_a()[g.idx], 0.0)
        d2_s, n_in, ovf = g.d2, g.n_in, g.overflow

    outs = [scan_sorted(d2_s, mass_s, None, n_in, thresholds[t], n_members,
                        uniform_m=um)
            for t in range(T)]
    bc = lambda x: jax.lax.bitcast_convert_type(x, jnp.int32)
    # one fetch-friendly (T+1, B, 5) i32 block: rows [:T] are per-threshold
    # [found, jstar, mvir_bits, rvir_bits, d2cut_bits]; row T carries the
    # threshold-independent [n_in, overflow, 0, 0, 0]
    per_t = jnp.stack([jnp.stack(
        [o["found"].astype(jnp.int32), o["jstar"],
         bc(o["mvir"]), bc(o["rvir"]), bc(o["d2cut"])], axis=1)
        for o in outs])
    tail = jnp.stack([n_in.astype(jnp.int32), ovf.astype(jnp.int32),
                      jnp.zeros_like(n_in), jnp.zeros_like(n_in),
                      jnp.zeros_like(n_in)], axis=1)[None]
    return jnp.concatenate([per_t, tail], axis=0)


def solve_rvir_multi(grid: CellGrid, centers, rgtp, thresholds,
                     n_members: int = 8, k0_cap: int = 4096, s_max: int = 11,
                     slot_budget: int = 1 << 25,
                     stage_fn=None, survey: bool | None = None,
                     classify_stage_fn=None) -> MultiSolveResult:
    """Batched R_Delta for every (halo, threshold) pair, shared gathers.

    ``stage_fn(level, K, S, n_members, T, centers, radii)`` overrides the
    single-device stage — parallel.mesh.solve_rvir_multi_sharded injects
    its shard_map stage and reuses this escalation driver unchanged.

    ``survey`` mirrors solve_rvir's: the -2 rule is classified per
    threshold against one shared topk prefix (_classify_stage's T-vector
    form); a halo skips the full sorted rounds only when every threshold
    resolved."""
    thresholds = np.asarray(thresholds, np.float32)
    T = thresholds.shape[0]
    G = centers.shape[0]
    centers = np.asarray(centers, np.float32)
    rgtp = np.asarray(rgtp, np.float32)
    period = np.asarray(grid.period, np.float32)
    thr_dev = jnp.asarray(thresholds)
    injected = stage_fn is not None    # the classifier needs direct grid
    #                                    access: single-device path only
    # channel-aware slab ceiling: the multi stage gathers like the solve
    # (d2 only on uniform-mass grids, d2+mass otherwise)
    ks = _solver._solve_kslab(grid)
    # the XLA fallback reads pos (+mass on non-uniform grids) only
    fb_fields = ("pos",) if grid.uniform_mass is not None \
        else ("pos", "mass")
    if stage_fn is None:
        stage_fn = lambda level, K, S, nm, T_, c, r: _multi_stage(
            _stage_grid(grid, K, ks, fb_fields), level, K, S, nm, T_, c, r,
            thr_dev)
    if getattr(grid, "soa8t", None) is not None:
        s_max = min(s_max, 7)

    code = np.zeros((T, G), np.int32)
    mvir = np.zeros((T, G), np.float32)
    rvir = np.zeros((T, G), np.float32)
    jout = np.zeros((T, G), np.int32)
    d2cut = np.zeros((T, G), np.float32)
    resolved = np.zeros((T, G), bool)

    kmax, _cap = rvir_ladder(rgtp, period)
    zero_iter = kmax == 0
    for arr, v in ((code, -3), (mvir, -3.0), (rvir, -3.0)):
        arr[:, zero_iter] = v
    resolved[:, zero_iter] = True

    cur_k = np.ones(G, np.int32)
    cur_cap = np.full(G, k0_cap, np.int64)
    minus1_open = np.ones(G, bool)
    DK = 8

    if survey is not False and not resolved.all() \
            and (not injected or classify_stage_fn is not None):
        live = np.nonzero(~resolved.all(axis=0))[0]
        auto = survey is None
        if not auto or live.size >= _solver.SURVEY_MIN_G:
            K = int(min(k0_cap, _k_limit(grid, s_max)))
            k_eff = np.minimum(cur_k[live], kmax[live])
            radii_all = ladder_radius(rgtp[live], k_eff)
            level, S = _pick_level_span(grid, float(radii_all.max()), s_max)

            def classify(part, radii):
                B, c_pad, r_pad = _pad_chunk(part.size, K, centers[part],
                                             radii)
                if classify_stage_fn is not None:
                    arr = np.asarray(classify_stage_fn(
                        level, K, S, n_members, c_pad, r_pad,
                        np.asarray(thr_dev)))
                else:
                    arr = np.asarray(_classify_stage(
                        _stage_grid(grid, K, ks, fb_fields), level, K, S,
                        n_members,
                        jnp.asarray(c_pad), jnp.asarray(r_pad), thr_dev,
                        T=T))
                w0 = arr[:part.size, 0]
                n_in = w0 & 0x7FFFFFFF
                ovf = (w0 >> 31) & 1
                m2m = arr[:part.size, 1]
                ok_v = ovf == 0
                is_m1 = ok_v & (n_in < n_members) & minus1_open[part]
                minus1_open[part[n_in >= n_members]] = False
                idx = part[is_m1]
                code[:, idx] = -1; mvir[:, idx] = -1.0; rvir[:, idx] = -1.0
                resolved[:, idx] = True
                for t in range(T):
                    is_m2 = ok_v & (((m2m >> t) & 1) > 0) & ~is_m1
                    idx = part[is_m2]
                    code[t, idx] = -2
                    mvir[t, idx] = -2.0
                    rvir[t, idx] = -2.0
                    resolved[t, idx] = True
                # only fully-resolved halos skip the sorted rounds
                return int(resolved[:, part].all(axis=0).sum())

            start = 0
            if auto:
                ns = min(_solver.SURVEY_SAMPLE, live.size)
                n_res = classify(live[:ns], radii_all[:ns])
                start = ns if n_res >= _solver.SURVEY_FRAC * ns \
                    else live.size
            chunk = max(1, min(16384, int(min(slot_budget, 1 << 26) // K)))
            for lo in range(0, live.size - start, chunk):
                part = live[start + lo:start + lo + chunk]
                classify(part, radii_all[start + lo:start + lo + part.size])

    # uniform-mass grids route capacity tiers above the slab ceiling to
    # the whole-box terminal stage instead of the ragged gather fallback
    # (see solver.solve_rvir — same tier, multi-threshold scan block)
    wbox = not injected and grid.uniform_mass is not None

    # capacity presize from a one-dispatch footprint probe: the multi
    # engine has no fused tier, so an overflowing halo would otherwise
    # ladder its capacity x4 per ROUND, each round a full re-gather of
    # every live halo. The
    # probe's CHUNK-aligned totals size each halo's first dispatch right;
    # a residual underestimate (per-halo bucketing may pick a different
    # level) costs one classic x4 round exactly as before. Capacity
    # never changes results (the sorted prefix is padding-invariant), so
    # the multi==single equality contract is untouched.
    if not injected and getattr(grid, "soa8t", None) is not None \
            and G >= 1024 and not resolved.all():
        live0 = np.nonzero(~resolved.all(axis=0))[0]
        radii0 = ladder_radius(rgtp[live0],
                               np.minimum(cur_k[live0], kmax[live0]))
        g0, S0 = _pick_level_span(grid, float(radii0.max()), s_max)
        Bp = _pad_b(live0.size, 4096)
        c_pad = np.zeros((Bp, 3), np.float32)
        r_pad = np.full(Bp, 1e-30, np.float32)
        c_pad[:live0.size] = centers[live0]
        r_pad[:live0.size] = radii0
        foot = np.asarray(_solver._foot_stage(
            grid, g0, S0, jnp.asarray(c_pad),
            jnp.asarray(r_pad)))[:live0.size]
        cap_max = max(2 * _k_limit(grid, s_max), k0_cap)
        cur_cap[live0] = np.maximum(cur_cap[live0], np.minimum(
            2 ** np.ceil(np.log2(np.maximum(foot, 1))).astype(np.int64),
            cap_max))

    def _apply_block(part, arr, dk=DK):
        """One round of verdicts + escalation from a (T+1, B, 5) stage
        block — shared by the gather and whole-box dispatch paths (the
        whole-box rows always carry overflow=0). ``dk`` is the round's
        grow-ball ladder step (any step sequence yields identical
        results — the scan's first crossing is rung-path-independent)."""
        n_in = arr[T, :part.size, 0]
        ovf = arr[T, :part.size, 1].astype(bool)
        found = arr[:T, :part.size, 0].astype(bool)  # (T, b)
        jstar = arr[:T, :part.size, 1]
        flts = np.ascontiguousarray(
            arr[:T, :part.size, 2:5]).view(np.float32)

        at_cap_k = cur_k[part] >= kmax[part]
        m1 = minus1_open[part]
        is_m1 = m1 & ~ovf & (n_in < n_members)      # (b,)
        minus1_open[part[n_in >= n_members]] = False

        ok = ~ovf[None, :]
        is_m2 = ok & found & (jstar == n_members - 2) & ~is_m1[None, :]
        is_succ = ok & found & (jstar > n_members - 2) & ~is_m1[None, :]
        is_m3 = (ok & ~found & at_cap_k[None, :] & ~is_m1[None, :]
                 & ~minus1_open[part][None, :])

        for t in range(T):
            idx = part[is_m1]
            code[t, idx] = -1; mvir[t, idx] = -1.0; rvir[t, idx] = -1.0
            resolved[t, idx] = True
            idx = part[is_m2[t]]
            code[t, idx] = -2; mvir[t, idx] = -2.0; rvir[t, idx] = -2.0
            resolved[t, idx] = True
            idx = part[is_m3[t]]
            code[t, idx] = -3; mvir[t, idx] = -3.0; rvir[t, idx] = -3.0
            resolved[t, idx] = True
            su = is_succ[t]
            idx = part[su]
            code[t, idx] = 0
            mvir[t, idx] = flts[t, su, 0]
            # host-exact Rvir from the f32 Mvir bits (see
            # solver.rvir_reference_bits — the device cbrt's last
            # ulp is observable in every downstream boundary)
            rvir[t, idx] = rvir_reference_bits(flts[t, su, 0],
                                               thresholds[t])
            d2cut[t, idx] = flts[t, su, 2]
            jout[t, idx] = jstar[t, su]
            resolved[t, idx] = True

        def _never_skip_ks(old, new):
            """Try the slab ceiling before exceeding it (x4 growth from
            2^19 skips ks=2^20 straight into the whole-box tier — see
            solver.apply_round's twin)."""
            return np.where((old < ks) & (new > ks), ks, new)

        halo_done = resolved[:, part].all(axis=0)
        rest = ~halo_done
        grow_cap = rest & ovf
        cur_cap[part[grow_cap]] = _never_skip_ks(
            cur_cap[part[grow_cap]], np.minimum(
                cur_cap[part[grow_cap]] * 4,
                max(2 * _k_limit(grid, s_max), k0_cap)))
        # at-ceiling halos step finely to stay on the slab path — see
        # solver.apply_round's twin (443 halos/pass once fell into
        # whole-box sorts from a dk=8 jump)
        grow_ball = rest & ~ovf & ~at_cap_k
        gi = part[grow_ball]
        dkv = np.where(cur_cap[gi] >= ks, min(dk, 2), dk)
        cur_k[gi] = np.minimum(cur_k[gi] + dkv, kmax[gi])
        vol_ratio = np.ceil(
            np.float64(1.2) ** (3 * dkv)).astype(np.int64)
        est = (n_in[grow_ball].astype(np.int64) + 64) * vol_ratio
        cur_cap[gi] = _never_skip_ks(cur_cap[gi], np.maximum(
            cur_cap[gi], np.minimum(
                2 ** np.ceil(np.log2(np.maximum(est, 1))).astype(np.int64),
                max(2 * _k_limit(grid, s_max), k0_cap))))

    guard = 0
    while not resolved.all():
        guard += 1
        if guard > 200:
            raise RuntimeError("multi-threshold solver escalation runaway")
        live = np.nonzero(~resolved.all(axis=0))[0]
        # banded capacity unification (see solve_rvir's twin and its
        # measured rationale): full unify for one-dispatch tails, x16
        # band otherwise — the unbanded unify dragged 14.7k
        # footprint-presized halos into K=2^20 sort lanes (461 dispatches
        # of the 512^3 multi run), while no unify at all pushes
        # slow-resolving giants into whole-box sorts
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
        # fine ladder steps for large tails were measured AND REJECTED
        # (see solve_rvir's dk_f note: repeated overflows laddered caps
        # past the slab ceiling into the whole-box tier)
        dk_round = DK

        # pipeline depth 2 across the round's dispatches (disjoint halo
        # sets; _apply_block only touches its own halos' state) — flushed
        # before the while condition re-reads `resolved`, exactly like
        # solve_rvir's rounds
        mpend = None

        def m_apply(part, B, K, S, level, t0, out, dk):
            arr = np.asarray(out)
            _solver._dbg_stage("multi-stage", t0, B=B, K=K, S=S,
                               level=level, n=part.size)
            _apply_block(part, arr, dk)

        for capacity in np.unique(cur_cap[live]):
            sel0 = live[cur_cap[live] == capacity]
            K = int(min(capacity, _k_limit(grid, s_max)))
            if wbox and K > ks and sel0.size:
                # terminal whole-box tier (see solver.solve_rvir): jump
                # halos whose -1 verdict is closed straight to their
                # final rung; a still-open -1 halo dispatches at its
                # current rung to decide -1 exactly first
                lad = _solver._wbox_ladder_dev(grid)
                Bw = _solver._wbox_chunk(grid.n)
                k_dst = np.where(minus1_open[sel0],
                                 np.minimum(cur_k[sel0], kmax[sel0]),
                                 kmax[sel0]).astype(np.int32)
                cur_k[sel0] = k_dst
                radii_w = ladder_radius(rgtp[sel0], k_dst)
                for lo in range(0, sel0.size, Bw):
                    part = sel0[lo:lo + Bw]
                    c_pad = np.zeros((Bw, 3), np.float32)
                    r_pad = np.zeros(Bw, np.float32)
                    c_pad[:part.size] = centers[part]
                    r_pad[:part.size] = radii_w[lo:lo + part.size]
                    t0 = _solver._pc()
                    arr = np.asarray(_solver._whole_box_multi_stage(
                        grid, lad, n_members, T, jnp.asarray(c_pad),
                        jnp.asarray(r_pad), thr_dev))
                    _solver._dbg_stage("multi-wbox", t0, B=Bw, K=grid.n,
                                       n=part.size)
                    _apply_block(part, arr, dk_round)
                continue
            k_eff0 = np.minimum(cur_k[sel0], kmax[sel0])
            radii0 = ladder_radius(rgtp[sel0], k_eff0)
            chunk = _chunk_for(K, slot_budget, ks)
            for level, S, bidx in _solver._level_groups(grid, radii0,
                                                        s_max, K):
              sel, k_eff_b, radii = sel0[bidx], k_eff0[bidx], radii0[bidx]
              for lo in range(0, sel.size, chunk):
                part = sel[lo:lo + chunk]
                B = _pad_b(part.size, K, ks)
                c_pad = np.zeros((B, 3), np.float32)
                r_pad = np.zeros(B, np.float32)
                c_pad[:part.size] = centers[part]
                r_pad[:part.size] = radii[lo:lo + chunk]
                t0 = _solver._pc()
                out = stage_fn(level, K, S, n_members, T,
                               jnp.asarray(c_pad), jnp.asarray(r_pad))
                nxt = (part, B, K, S, level, t0, out, dk_round)
                if not _solver._pipelined():
                    m_apply(*nxt)
                    continue
                if mpend is not None:
                    m_apply(*mpend)
                mpend = nxt
        if mpend is not None:
            m_apply(*mpend)
    return MultiSolveResult(code=code, mvir=mvir, rvir=rvir, j=jout,
                            d2cut=d2cut)
