"""Smoke test of the navigation engine on one NVIDIA GPU.

Drives the main path once through the public entry points at bench widths
and checks every result against the repo's references:

1. SLAM fleet: ``slam.run_fleet`` on the combined-mission config (128
   missions, 64 landmark slots, MBES), a 15 s mission; four missions
   against the f64 NumPy oracle (identical association decisions, pose
   within the golden tests' 5 cm).
2. MCL: ``pf.run(scheme="systematic")`` at 2^20 particles on a 15 s mission
   with GPS fixes; one resample's ancestors against a float64 NumPy
   systematic resample, and the mean track against ground truth.
3. Combined: ``fleet.run_combined`` (2^20-particle MCL + the SLAM mission).
4. Every other bench section once at its bench shapes (SLAM L=256 full and
   marginal, FLS, localization 64/512, 15-state single and dual, dead
   reckoning, raycast fleet): finite outputs, and lane 0 of each fleet
   against the per-mission ``run`` of the same mission on the card.

``--four-cards`` runs only the multi-card checks on four GPUs: the SLAM
fleet sharded over a 4-way ``mission`` mesh against the same fleet on one
card (every leaf bitwise equal), and the 2^20 MCL sharded over a 4-way
``particle`` mesh against one card (the bank bitwise equal, moments within
the reassociation of their sums).

The last line of standard output is ``{"ok": true, "device": {...}}`` and
is printed only when every phase passed on a GPU; otherwise the script
exits non-zero. Run from the repo root:

    python chip_smoke.py               # one GPU
    python chip_smoke.py --four-cards  # four GPUs of one host
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
import time
import warnings

import numpy as np

POSE_TOL_M = 5e-2      # tests/test_slam_golden.py pose-track bound
PF_TRACK_TOL_M = 1.5   # tests/test_particle_filter.py mean-track bound
LANE0_TOL = 1e-3       # fleet lane 0 vs per-mission run (same program math)


class PhaseFailure(AssertionError):
    pass


def check(cond, msg):
    if not cond:
        raise PhaseFailure(msg)


def log(msg):
    print(msg, flush=True)


def _block(x):
    import jax

    return jax.block_until_ready(x)


def compile_and_time(name, fn, *args, memory=False):
    """jit + compile ``fn`` for ``args``, run it cold then warm; returns
    (outputs, compile_s, warm_s). Prints the compiled memory analysis of
    the main steps."""
    import jax

    t0 = time.perf_counter()
    compiled = jax.jit(fn).lower(*args).compile()
    t_compile = time.perf_counter() - t0
    if memory:
        ma = compiled.memory_analysis()
        if ma is not None:
            log(f"  [{name}] memory_analysis: "
                f"args={ma.argument_size_in_bytes} out={ma.output_size_in_bytes} "
                f"temp={ma.temp_size_in_bytes} code={ma.generated_code_size_in_bytes} bytes")
    out = _block(compiled(*args))
    t0 = time.perf_counter()
    out = _block(compiled(*args))
    t_warm = time.perf_counter() - t0
    return out, t_compile, t_warm


def report(name, worst, limit, t_compile, t_warm, extra=""):
    log(f"  [{name}] worst error {worst:.3e} (limit {limit:.1e}); "
        f"compile {t_compile:.1f} s, warm call {t_warm * 1e3:.1f} ms {extra}")


# ---------------------------------------------------------------------------
# phase 1: SLAM fleet vs the f64 oracle
# ---------------------------------------------------------------------------

def slam_oracle():
    """tests/oracles/ekf_slam_oracle.py, loaded by path: an installed
    package named ``tests`` may shadow the repo's directory."""
    import importlib.util
    import os

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "tests", "oracles", "ekf_slam_oracle.py")
    spec = importlib.util.spec_from_file_location("ekf_slam_oracle", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def phase_slam_fleet(B=128, duration=15.0, n_oracle=4):
    from smarc_navigation_tpu.io import workloads
    from smarc_navigation_tpu.models import ekf_slam as slam

    oracle = slam_oracle()

    cfg = workloads.combined_slam_cfg()
    params = slam.make_params(cfg)
    tl = workloads.slam_fleet_timelines(cfg, duration, B)
    (final, out), tc, tw = compile_and_time(
        "slam-fleet", lambda t: slam.run_fleet(t, params, cfg), tl, memory=True)
    mu = np.asarray(out["mu"])
    check(mu.shape == (tl.ticks.shape[1], B, 6), f"mu shape {mu.shape}")
    check(np.isfinite(mu).all() and np.isfinite(np.asarray(final.Sigma)).all(),
          "non-finite SLAM state")
    matched = np.asarray(out["matched_mbes"])
    worst, decisions = 0.0, 0
    for b in range(n_oracle):
        mus_o, matched_o, o = oracle.run_oracle(
            cfg, oracle.timeline_arrays(tl, b), "full")
        check(int(final.n_active[b]) == o.n_active,
              f"mission {b}: {int(final.n_active[b])} landmarks vs oracle {o.n_active}")
        bad = int((matched[:, b] != matched_o).sum())
        check(bad == 0, f"mission {b}: {bad} association decisions differ from the oracle")
        decisions += int((matched_o >= 0).sum())
        worst = max(worst, float(np.linalg.norm(mu[:, b, 0:3] - mus_o[:, 0:3], axis=-1).max()))
    check(worst < POSE_TOL_M, f"pose error {worst} m")
    check(decisions > 0, "oracle missions made no associations")
    report("slam-fleet", worst, POSE_TOL_M, tc, tw,
           f"({n_oracle} missions x {mu.shape[0]} ticks vs f64 oracle: "
           f"{decisions} association decisions identical)")
    return {"slam_fleet_pose_err_m": worst, "slam_fleet_warm_s": tw}


# ---------------------------------------------------------------------------
# phase 2: MCL at 2^20 particles
# ---------------------------------------------------------------------------

def pf_case(duration, n):
    """The MCL mission of tests/test_particle_filter.py (surface vehicle,
    GPS fixes throughout) at ``n`` particles."""
    from smarc_navigation_tpu.configs import PFConfig
    from smarc_navigation_tpu.io import sim
    from smarc_navigation_tpu.models import particle_filter as pf

    m = sim.simulate(sim.MissionSpec(duration_s=duration, gps_std=0.3,
                                     dvl_std=0.02, gps_surface_z=-100.0))
    cfg = dataclasses.replace(PFConfig(), particle_count=n, measurement_std=1.0,
                              motion_cov=(1e-4, 1e-4, 0.0, 0.0, 0.0, 1e-6))
    return m, cfg, pf.pf_timeline(m), pf.make_params(cfg)


def resample_ancestor_check(n, seed=0):
    """One systematic resample on the device vs float64 NumPy on the same
    weights and uniform draw. Returns (mismatches, tie_tol, worst_tie):
    every mismatched slot must sit within ``tie_tol`` of an ancestor
    boundary — the f32 CDF's own rounding error plus the f32 rounding of
    N·cdf − u (2^-23 in CDF units): a tie at f32 resolution."""
    import jax
    import jax.numpy as jnp

    from smarc_navigation_tpu.configs import PFConfig
    from smarc_navigation_tpu.models import particle_filter as pf
    from smarc_navigation_tpu.ops import resampling

    params = pf.make_params(PFConfig(particle_count=n))
    st = pf.init_state(n, params, key=jax.random.PRNGKey(seed))
    key = jax.random.PRNGKey(seed + 1)

    @jax.jit
    def dev(parts, k):
        w = pf._gps_weights(parts, jnp.asarray([0.4, -0.3], jnp.float32), params)
        u = jax.random.uniform(k, (), w.dtype)
        return w, u, resampling.blocked_cdf(w), resampling.systematic_resample(k, w)

    w, u, cdf32, anc = (np.asarray(x) for x in dev(st.particles, key))
    cdf64 = np.cumsum(w.astype(np.float64))
    cdf64 /= cdf64[-1]
    pos = (np.arange(n) + float(u)) / n
    ref = np.minimum(np.searchsorted(cdf64, pos, side="right"), n - 1)
    tie_tol = float(np.abs(cdf32.astype(np.float64) - cdf64).max()) + 2.0 ** -23
    bad = np.nonzero(anc != ref)[0]
    worst_tie = 0.0
    for j in bad:
        lo, hi = sorted((int(anc[j]), int(ref[j])))
        # the boundaries between the two candidate ancestors must all sit
        # within the f32 CDF error of the slot's position
        worst_tie = max(worst_tie, float(np.abs(cdf64[lo:hi] - pos[j]).max()))
    check(np.all(np.diff(anc) >= 0), "device ancestors not monotone")
    check(worst_tie <= tie_tol,
          f"ancestor mismatch beyond f32 CDF ties: {worst_tie} > {tie_tol}")
    return len(bad), tie_tol, worst_tie


def phase_mcl(n=1 << 20, duration=15.0):
    import jax.numpy as jnp

    from smarc_navigation_tpu.models import particle_filter as pf

    m, cfg, tl, params = pf_case(duration, n)
    (final, out), tc, tw = compile_and_time(
        "mcl", lambda t: pf.run(t, params, cfg, n_particles=n, scheme="systematic"),
        tl, memory=True)
    mean = np.asarray(out["mean"])
    check(np.isfinite(mean).all() and np.isfinite(np.asarray(final.particles)).all(),
          "non-finite PF output")
    n_upd = int(jnp.sum(out["updated"]))
    check(n_upd >= 3, f"only {n_upd} GPS updates")
    gt = m.gt_at(np.asarray(tl.ticks, np.float64))
    err = np.linalg.norm(mean[:, :2] - gt[:, :2], axis=-1)
    track = float(err[len(err) // 2:].mean())
    check(track < PF_TRACK_TOL_M, f"PF mean track error {track} m")
    report("mcl", track, PF_TRACK_TOL_M, tc, tw,
           f"({n} particles, {mean.shape[0]} ticks, {n_upd} GPS updates; "
           f"second-half mean xy error vs ground truth)")

    mism, tie_tol, worst_tie = resample_ancestor_check(n)
    log(f"  [resample-ancestors] {mism} of {n} slots differ from the float64 "
        f"NumPy systematic resample; all are f32 CDF ties (worst boundary "
        f"distance {worst_tie:.3e}, limit {tie_tol:.3e})")
    return {"mcl_track_err_m": track, "mcl_warm_s": tw,
            "resample_mismatch": mism}


# ---------------------------------------------------------------------------
# phase 3: combined PF + SLAM mission
# ---------------------------------------------------------------------------

def phase_combined(n=1 << 20, duration=15.0):
    import jax.numpy as jnp

    from smarc_navigation_tpu.configs import PFConfig
    from smarc_navigation_tpu.io import workloads
    from smarc_navigation_tpu.models import ekf_slam as slam
    from smarc_navigation_tpu.models import particle_filter as pf
    from smarc_navigation_tpu.parallel.fleet import run_combined

    pf_cfg = PFConfig(particle_count=n)
    pf_params = pf.make_params(pf_cfg)
    cfg = workloads.combined_slam_cfg()
    params = slam.make_params(cfg)
    tl_slam, tl_pf = workloads.combined_workload(cfg, duration)

    def both(ts, tp):
        total = run_combined(ts, tp, params, cfg, pf_params, pf_cfg, n)
        _, out_pf = pf.run(tp, pf_params, pf_cfg, n_particles=n, scheme="systematic")
        fin_s, _ = slam.run_fleet(ts, params, cfg)
        parts = (jnp.sum(out_pf["mean"]) + jnp.sum(fin_s.mu[:, 0:6])
                 + jnp.sum(fin_s.n_active))
        return total, parts, fin_s.n_active

    (total, parts, n_act), tc, tw = compile_and_time(
        "combined", both, tl_slam, tl_pf, memory=True)
    total, parts = float(total), float(parts)
    check(np.isfinite(total), "non-finite combined output")
    check(int(n_act[0]) > 0, "combined SLAM mission mapped no landmarks")
    rel = abs(total - parts) / max(abs(parts), 1.0)
    check(rel < 1e-5, f"run_combined {total} vs its parts {parts}")
    report("combined", rel, 1e-5, tc, tw,
           f"(run_combined vs pf.run + slam.run_fleet on the same mission; "
           f"{int(n_act[0])} landmarks)")
    return {"combined_warm_s": tw}


# ---------------------------------------------------------------------------
# phase 4: every other bench section
# ---------------------------------------------------------------------------

def _lane0_check(name, fleet_out, single_out, exact_keys=()):
    """Fleet lane 0 (time-major fleet outputs) vs the per-mission run."""
    worst = 0.0
    for k, v in single_out.items():
        f = np.asarray(fleet_out[k])[:, 0]
        s = np.asarray(v)
        check(np.isfinite(np.asarray(fleet_out[k], np.float64)).all(),
              f"{name}: non-finite {k}")
        if k in exact_keys:
            check((f == s).all(), f"{name}: {k} differs from the per-mission run")
        else:
            worst = max(worst, float(np.abs(f.astype(np.float64) - s).max()))
    check(worst < LANE0_TOL, f"{name}: lane 0 differs from the per-mission run by {worst}")
    return worst


def section_slam(name, cfg, tl, update_mode="full", sensors=("mbes",)):
    import jax

    from smarc_navigation_tpu.models import ekf_slam as slam

    params = slam.make_params(cfg)
    (final, out), tc, tw = compile_and_time(
        name, lambda t: slam.run_fleet(t, params, cfg, update_mode=update_mode), tl)
    tl0 = jax.tree_util.tree_map(lambda x: x[0], tl)
    _, out0 = jax.jit(lambda t: slam.run(t, params, cfg, update_mode=update_mode))(tl0)
    keys = ["mu", "n_active"] + ["matched_" + s for s in sensors]
    worst = _lane0_check(name, out, {k: out0[k] for k in keys},
                         exact_keys=["n_active"] + ["matched_" + s for s in sensors])
    check(int(np.asarray(final.n_active).max()) > 0, f"{name}: no landmarks mapped")
    report(name, worst, LANE0_TOL, tc, tw, f"(B={tl.ticks.shape[0]}, lane 0 vs run)")


def phase_sections(duration=15.0, b_slam256=32, b_fls=128, b_loc=64, b_loc_wide=512,
                   b_ekf15=64, b_dr=256, b_rc=1024, t_rc=76):
    import jax
    import jax.numpy as jnp

    from smarc_navigation_tpu.configs import EKFLocConfig
    from smarc_navigation_tpu.io import sim, workloads
    from smarc_navigation_tpu.models import dead_reckoning as dr
    from smarc_navigation_tpu.models import ekf_15state as e15
    from smarc_navigation_tpu.models import ekf_localization as loc
    from smarc_navigation_tpu.models import ekf_slam as slam
    from smarc_navigation_tpu.parallel import fleet

    # SLAM L=256 full + marginal (B=32)
    cfg256 = workloads.slam256_cfg()
    tl256 = workloads.slam_fleet_timelines(cfg256, duration, b_slam256)
    section_slam("slam-L256-full", cfg256, tl256, "full")
    section_slam("slam-L256-marginal", cfg256, tl256, "marginal")

    # FLS fleet (B=128, L=64)
    cfgf = workloads.fls_slam_cfg()
    section_slam("fls-fleet", cfgf, workloads.fls_fleet_timelines(cfgf, duration, b_fls),
                 sensors=("fls",))

    # localization fleets (64 and 512 lanes)
    cfg_loc = EKFLocConfig()
    m_loc = sim.simulate(sim.MissionSpec(duration_s=duration, num_landmarks=16,
                                         dvl_std=0.05, mbes_std=0.05, seed=7))
    tl_loc = loc.loc_timeline(m_loc, cfg_loc)
    params_loc = loc.make_params(m_loc.landmarks, cfg_loc)
    _, out0 = jax.jit(lambda t: loc.run(t, params_loc, cfg_loc))(tl_loc)
    for name, B in (("loc-64", b_loc), ("loc-512", b_loc_wide)):
        bt = fleet.batch_timelines([tl_loc] * B)
        (_, out), tc, tw = compile_and_time(
            name, lambda t: loc.run_fleet(t, params_loc, cfg_loc), bt)
        worst = _lane0_check(name, out, {"mu": out0["mu"], "matches": out0["matches"]},
                             exact_keys=["matches"])
        report(name, worst, LANE0_TOL, tc, tw, f"(B={B}, lane 0 vs run)")

    # 15-state EKF single and dual (B=64, 50 Hz)
    cfg15 = e15.Ekf15Config(frequency=50.0)
    cfg15g = e15.global_config(frequency=50.0)
    m15 = sim.simulate(sim.MissionSpec(duration_s=duration, seed=5))
    tl15 = e15.ekf15_timeline(m15, cfg15, include_gps=True)
    bt15 = fleet.batch_timelines([tl15] * b_ekf15)
    (_, out), tc, tw = compile_and_time(
        "ekf15", lambda t: e15.run_fleet(t, cfg15), bt15)
    _, out0 = jax.jit(lambda t: e15.run(t, cfg15))(tl15)
    worst = _lane0_check("ekf15", out, {"x": out0["x"]})
    report("ekf15", worst, LANE0_TOL, tc, tw, f"(B={b_ekf15}, lane 0 vs run)")
    (dual, tc, tw) = compile_and_time(
        "ekf15-dual", lambda t: e15.run_dual_fleet(t, t, cfg15, cfg15g), bt15)
    (_, ol0), (_, og0), _ = jax.jit(lambda t: e15.run_dual(t, t, cfg15, cfg15g))(tl15)
    (_, ol), (_, og), mo = dual
    worst = max(_lane0_check("ekf15-dual local", ol, {"x": ol0["x"]}),
                _lane0_check("ekf15-dual global", og, {"x": og0["x"]}))
    check(np.isfinite(np.asarray(mo.trans)).all(), "ekf15-dual: non-finite map->odom")
    report("ekf15-dual", worst, LANE0_TOL, tc, tw, f"(B={b_ekf15}, lane 0 vs run_dual)")

    # closed-form SAM dead reckoning (B=256)
    m_dr = sim.simulate(sim.MissionSpec(duration_s=duration, seed=9))
    tl_dr = dr.sam_timeline(m_dr)
    bt_dr = fleet.batch_timelines([tl_dr] * b_dr)
    track, tc, tw = compile_and_time("sam-dr", dr.run_sam_dr_vectorized, bt_dr)
    track0 = np.asarray(jax.jit(dr.run_sam_dr_vectorized)(tl_dr))
    track = np.asarray(track)
    check(np.isfinite(track).all(), "sam-dr: non-finite track")
    worst = float(np.abs(track[0] - track0).max())
    check(worst < LANE0_TOL, f"sam-dr: lane 0 differs by {worst}")
    report("sam-dr", worst, LANE0_TOL, tc, tw, f"(B={b_dr}, lane 0 vs single)")

    # closed-loop raycast fleet (BASELINE config: 1024 missions)
    cfg_rc, spec, lms, lmm = workloads.raycast_fleet_setup(b_rc)
    params_rc = slam.make_params(cfg_rc)
    base_m = sim.simulate(sim.MissionSpec(duration_s=30.0, seed=1))
    gt_one = base_m.gt_at(np.arange(t_rc) / cfg_rc.system_freq).astype(np.float32)
    gt = jnp.asarray(np.tile(gt_one, (b_rc, 1, 1)))
    (fin, (mu, na)), tc, tw = compile_and_time(
        "raycast", lambda g, l, m_: fleet.run_raycast_fleet(g, l, m_, cfg_rc, params_rc, spec),
        gt, lms, lmm)
    _, (mu0, na0) = jax.jit(lambda g, l, m_: fleet.run_raycast_fleet(
        g, l, m_, cfg_rc, params_rc, spec))(gt[:1], lms[:1], lmm[:1])
    mu, na = np.asarray(mu), np.asarray(na)
    check(np.isfinite(mu).all(), "raycast: non-finite poses")
    check((na[0] == np.asarray(na0)[0]).all(), "raycast: lane 0 landmark counts differ")
    check(int(na[:, -1].max()) > 0, "raycast: no landmarks mapped")
    worst = float(np.abs(mu[0] - np.asarray(mu0)[0]).max())
    check(worst < LANE0_TOL, f"raycast: lane 0 differs by {worst}")
    report("raycast", worst, LANE0_TOL, tc, tw, f"(B={b_rc}, lane 0 vs B=1)")
    return {}


# ---------------------------------------------------------------------------
# --four-cards: mission- and particle-sharded paths vs one card
# ---------------------------------------------------------------------------

def _four_devices(n_dev):
    import jax

    devs = jax.devices()[:n_dev]
    check(len(devs) == n_dev, f"needs {n_dev} devices, found {len(devs)}")
    return devs


def _leaf_diffs(named_a, named_b):
    """[(name, mismatching elements, max |a - b|)] of leaves that differ."""
    out = []
    for (name, a), (_, b) in zip(named_a, named_b):
        a, b = np.asarray(a), np.asarray(b)
        bad = int((a != b).sum())
        if bad:
            out.append((name, bad, float(np.abs(a.astype(np.float64)
                                                - b.astype(np.float64)).max())))
    return out


SHARD_MOMENT_RTOL = 1e-5  # particle-sharded vs one-card MCL moments: the
SHARD_MOMENT_ATOL = 1e-6  # reassociated 2^20-term f32 sums (psum order)


def phase_slam_sharded(B=128, duration=15.0, n_dev=4):
    """SLAM fleet over an ``n_dev``-way ``mission`` mesh
    (``run_fleet(device_mesh=)``: the one-device program on each card's
    block of missions) vs the same fleet on one card of the same process:
    every output and final-state leaf bitwise equal."""
    import jax

    from smarc_navigation_tpu.io import workloads
    from smarc_navigation_tpu.models import ekf_slam as slam
    from smarc_navigation_tpu.parallel import mesh as mesh_lib

    devs = _four_devices(n_dev)
    cfg = workloads.combined_slam_cfg()
    params = slam.make_params(cfg)
    tl = workloads.slam_fleet_timelines(cfg, duration, B)
    mmesh = mesh_lib.make_mesh(mission=n_dev, particle=1, devices=devs)

    def sharded():
        return _block(slam.run_fleet(tl, params, cfg, device_mesh=mmesh))

    sharded()
    t0 = time.perf_counter()
    fin_s, out_s = sharded()
    tw = time.perf_counter() - t0
    check(len(fin_s.mu.sharding.device_set) == n_dev, "SLAM fleet not spread over the mesh")
    (fin_u, out_u), _, tw1 = compile_and_time(
        "slam-fleet-1card", lambda t: slam.run_fleet(t, params, cfg),
        jax.device_put(tl, devs[0]))

    def named(fin, out):
        return ([("final." + k, v) for k, v in zip(slam.SlamState._fields, fin)]
                + sorted(out.items()))

    diffs = _leaf_diffs(named(fin_s, out_s), named(fin_u, out_u))
    check(not diffs, f"mission-sharded fleet is not bitwise the one-card fleet: {diffs}")
    log(f"  [slam-fleet-4way] B={B}: every output and final-state leaf bitwise "
        f"equal to one card; warm call {tw * 1e3:.1f} ms on {n_dev} cards vs "
        f"{tw1 * 1e3:.1f} ms on one")
    return {"slam_shard_mismatch": 0}


def phase_mcl_sharded(duration=15.0, n=1 << 20, n_dev=4):
    """2^20 MCL over an ``n_dev``-way ``particle`` mesh vs one card: the
    final bank bitwise equal, moments within the reassociation of their
    2^20-term sums (``SHARD_MOMENT_RTOL``/``ATOL``)."""
    import jax

    from smarc_navigation_tpu.models import particle_filter as pf
    from smarc_navigation_tpu.parallel import mesh as mesh_lib

    devs = _four_devices(n_dev)
    m, cfg, tl, params = pf_case(duration, n)
    key = jax.random.PRNGKey(11)
    pmesh = mesh_lib.make_mesh(mission=1, particle=n_dev, devices=devs)
    (f_sh, o_sh), _, tw = compile_and_time(
        "mcl-4way", lambda t: pf.run(t, params, cfg, n_particles=n, key=key,
                                     scheme="systematic", pmesh=pmesh), tl)
    check(len(f_sh.particles.sharding.device_set) == n_dev, "PF bank not spread over the mesh")
    (f_1, o_1), _, tw1 = compile_and_time(
        "mcl-1card", lambda t: pf.run(t, params, cfg, n_particles=n, key=key,
                                      scheme="systematic"), jax.device_put(tl, devs[0]))
    bank_bad = int((np.asarray(f_sh.particles) != np.asarray(f_1.particles)).sum())
    worst = 0.0
    for k in ("mean", "cov"):
        a, b = np.asarray(o_sh[k], np.float64), np.asarray(o_1[k], np.float64)
        worst = max(worst, float((np.abs(a - b) / (SHARD_MOMENT_ATOL
                                                   + SHARD_MOMENT_RTOL * np.abs(b))).max()))
    log(f"  [mcl-4way] {n} particles: {bank_bad} of {6 * n} bank elements differ "
        f"from one card; moments at {worst:.3f} of their tolerance; warm call "
        f"{tw * 1e3:.1f} ms on {n_dev} cards vs {tw1 * 1e3:.1f} ms on one")
    check(bank_bad == 0, f"particle-sharded bank is not bitwise the one-card bank: "
                         f"{bank_bad} elements differ")
    check(worst <= 1.0, f"sharded moments beyond reassociation: {worst:.3f} x tolerance")
    return {"mcl_bank_mismatch": bank_bad}


# ---------------------------------------------------------------------------

def gpu_name_and_power():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the 4-GPU mission- and particle-sharded checks")
    args = ap.parse_args(argv)

    import jax

    devs = jax.devices()
    dev = devs[0]
    need = 4 if args.four_cards else 1
    if dev.platform != "gpu" or len(devs) < need:
        print(f"FAIL: needs {need} GPU(s); JAX found {len(devs)} "
              f"{dev.platform} device(s)", file=sys.stderr)
        return 2

    import smarc_navigation_tpu  # noqa: F401  (forces f32 matmul precision)
    from smarc_navigation_tpu import compile_cache

    # the bench workloads cap detections at max_obs per tick by design
    warnings.filterwarnings("ignore", message="event channel saturated")

    log(f"device: platform={dev.platform} kind={dev.device_kind} count={len(devs)}")
    log(f"nvidia-smi: {gpu_name_and_power()}")
    log(f"jax {jax.__version__}; jax_default_matmul_precision="
        f"{jax.config.jax_default_matmul_precision}; compile cache {compile_cache.enable()}")

    phases = ([("slam-4way", phase_slam_sharded), ("mcl-4way", phase_mcl_sharded)]
              if args.four_cards else
              [("slam-fleet", phase_slam_fleet), ("mcl", phase_mcl),
               ("combined", phase_combined), ("sections", phase_sections)])
    failed = []
    for name, fn in phases:
        log(f"phase {name}:")
        t0 = time.perf_counter()
        try:
            fn()
            log(f"phase {name}: PASS in {time.perf_counter() - t0:.1f} s")
        except Exception as e:  # noqa: BLE001 — report every phase, then fail
            failed.append(name)
            log(f"phase {name}: FAIL in {time.perf_counter() - t0:.1f} s: {e!r}")
    if failed:
        print(f"FAIL: phases {failed}", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(devs)}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
