"""Benchmark: EKF-SLAM fleet steps/sec + 2^20-particle MCL on one GPU.

Prints a JSON result line: {"metric", "value", "unit", "vs_baseline",
"secondary", "device"}. The line is RE-EMITTED after every completed
section (the last line printed is always the most complete result), so a
run cut by an external timeout still leaves a parseable record of
everything measured up to that point.

Baseline anchor: the reference's EKF-SLAM runs at a fixed 10 Hz wall-clock
tick on CPU (``auv_ekf_slam/launch/ekf_slam.launch:23``) — one mission, one
process. vs_baseline is therefore (aggregate filter steps/sec) / 10: how
many reference-node-seconds of work one card does per second.

Timing protocol: every workload is measured as the SLOPE between a short
and a long run of the same jitted program (same shapes except the time
axis), each ended by fetching a scalar (which waits for the device), best
of ``reps``. Per-call fixed costs (dispatch, the scalar fetch) cancel, and
compilation happens in the untimed warm-up call.

Sections run in priority order (headline first) under a wall-clock budget
(env BENCH_BUDGET_S, default 1500 s); a section is skipped if the remaining
budget is below its floor. A section that fails or is skipped for want
of budget is reported, the partial JSON is re-emitted, and the run exits
non-zero: a missing metric never passes for a clean run. With no GPU the
run fails before measuring anything.

``--trace DIR`` additionally records a ``jax.profiler`` trace of one warm
call of the SLAM headline and of the MCL section under DIR and prints the
device-side summary (top ops, idle share, per-leg time) of each.
"""

import argparse
import json
import os
import subprocess
import sys
import time
import warnings

import numpy as np

T0 = time.monotonic()
BUDGET_S = float(os.environ.get("BENCH_BUDGET_S", "1500"))
# dev/debug: run only the named sections (comma-separated), e.g.
# BENCH_ONLY=pf-weakscale python bench.py
ONLY = {s for s in os.environ.get("BENCH_ONLY", "").split(",") if s}

RESULT = {
    "metric": "ekf_slam_filter_steps_per_sec_fleet128",
    "value": 0.0,
    "unit": "steps/s",
    "vs_baseline": 0.0,
    "secondary": {},
}
FAILED = []
SKIPPED = []


def emit():
    print(json.dumps(RESULT), flush=True)


def remaining():
    return BUDGET_S - (time.monotonic() - T0)


def section(name, fn, floor_s=40.0):
    """Run one bench section under the budget; re-emit the JSON line."""
    if ONLY and name not in ONLY:
        return
    if remaining() < floor_s:
        SKIPPED.append(name)
        print(f"# SKIP {name}: {remaining():.0f}s left < {floor_s:.0f}s floor",
              file=sys.stderr)
        return
    t_start = time.monotonic()
    try:
        fn()
        print(f"# [{name}] done in {time.monotonic()-t_start:.1f}s "
              f"({remaining():.0f}s budget left)", file=sys.stderr)
    except Exception as e:  # noqa: BLE001 — record, keep the other sections
        FAILED.append(name)
        print(f"# [{name}] FAILED after {time.monotonic()-t_start:.1f}s: "
              f"{e!r}", file=sys.stderr)
    emit()


def _force(x):
    return float(np.asarray(x))


def timed(fn, *args, reps=3):
    """Best-of-reps wall time of fn(*args) forced via a scalar fetch."""
    _force(fn(*args))  # compile + warm
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        _force(fn(*args))
        best = min(best, time.perf_counter() - t0)
    return best


def slope(fn, args_small, args_big, units_small, units_big, reps=3):
    """Marginal seconds per work unit between two run lengths."""
    t_small = timed(fn, *args_small, reps=reps)
    t_big = timed(fn, *args_big, reps=reps)
    return max(t_big - t_small, 1e-9) / (units_big - units_small)


LEGS = ("slam_predict", "slam_da_cost", "slam_assign", "slam_update",
        "pf_predict", "pf_weights", "pf_resample", "pf_moments")


def hlo_scopes(hlo_text):
    """Instruction name -> ``op_name`` metadata (the ``jax.named_scope``
    path) of a compiled module's HLO text. GPU kernels are named after
    their instruction with '.' replaced by '_', so both spellings map."""
    import re

    pat = re.compile(r'^\s*(?:ROOT\s+)?%?([\w.\-]+)\s*=.*?op_name="([^"]*)"')
    scopes = {}
    for line in hlo_text.splitlines():
        m = pat.match(line)
        if m:
            scopes[m.group(1)] = m.group(2)
            scopes[m.group(1).replace(".", "_")] = m.group(2)
    return scopes


def trace_summary(trace_dir, hlo_text="", top=15):
    """Reduce the newest ``jax.profiler`` trace under ``trace_dir`` to device
    metrics: busy time (union of kernel intervals), idle share over the
    span from the first to the last device event, device-to-host copies,
    the ``top`` kernels by total time, and the kernel time under each
    named-scope leg (``LEGS``), read from the compiled module's metadata
    (``hlo_text``) through the kernel's HLO instruction."""
    import glob
    from collections import defaultdict

    from jax.profiler import ProfileData

    files = sorted(glob.glob(os.path.join(
        trace_dir, "plugins", "profile", "*", "*.xplane.pb")))
    if not files:
        raise FileNotFoundError(f"no xplane.pb under {trace_dir}")
    scopes = hlo_scopes(hlo_text)
    pd = ProfileData.from_file(files[-1])
    summary = {}
    for plane in pd.planes:
        if not plane.name.startswith("/device:"):
            continue
        spans, by_name, legs = [], defaultdict(float), defaultdict(float)
        d2h = 0
        for line in plane.lines:
            if not line.name.startswith("Stream"):
                continue
            for e in line.events:
                spans.append((e.start_ns, e.start_ns + e.duration_ns))
                by_name[e.name] += e.duration_ns
                d2h += e.name == "MemcpyD2H"
                stats = {str(k): str(v) for k, v in e.stats}
                # kernels replayed from a command buffer (CUDA graph) carry
                # hlo_op="command_buffer"; their own name is the fusion's
                path = next((scopes[n] for n in (stats.get("hlo_op", ""), e.name)
                             if n in scopes), "")
                leg = next((t for t in LEGS if t in path), "other" if path else "unattributed")
                legs[leg] += e.duration_ns
        if not spans:
            continue
        spans.sort()
        busy, cur_s, cur_e = 0, spans[0][0], spans[0][1]
        for s0, e0 in spans[1:]:
            if s0 > cur_e:
                busy += cur_e - cur_s
                cur_s, cur_e = s0, e0
            else:
                cur_e = max(cur_e, e0)
        busy += cur_e - cur_s
        window = max(e for _, e in spans) - spans[0][0]
        summary[plane.name] = {
            "kernels": len(spans),
            "memcpy_d2h": d2h,
            "busy_ms": busy / 1e6,
            "window_ms": window / 1e6,
            "idle_share": 1.0 - busy / window if window else None,
            "top_kernels_ms": [(k[:100], v / 1e6) for k, v in sorted(
                by_name.items(), key=lambda kv: -kv[1])[:top]],
            "legs_ms": {k: v / 1e6 for k, v in sorted(legs.items())},
        }
    return summary


def traced_call(trace_dir, name, fn, *args):
    """One warm call of the jitted ``fn`` under the profiler; prints and
    returns its summary."""
    import jax

    _force(fn(*args))  # warm
    hlo = fn.lower(*args).compile().as_text()
    path = os.path.join(trace_dir, name)
    with jax.profiler.trace(path):
        _force(fn(*args))
    summ = trace_summary(path, hlo)
    print(f"# trace {name}: " + json.dumps(summ), file=sys.stderr)
    return summ


def device_info():
    """Platform, kind, count and the card's name/power limit; exits when
    JAX finds no GPU (nothing here is meaningful on another device)."""
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        print(f"FAIL: bench.py measures the GPU; JAX found {len(devs)} "
              f"{devs[0].platform} device(s)", file=sys.stderr)
        sys.exit(2)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()
    info = {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs), "nvidia_smi": smi.splitlines()[0] if smi else ""}
    print(f"# device: {json.dumps(info)}", flush=True)
    return info


def main(argv=None):
    ap = argparse.ArgumentParser(description="GPU benchmark (see module doc)")
    ap.add_argument("--trace", metavar="DIR", default=None,
                    help="also trace one warm call of the SLAM headline and "
                         "the MCL section under DIR")
    args = ap.parse_args(argv)

    import jax
    import jax.numpy as jnp

    RESULT["device"] = device_info()

    import smarc_navigation_tpu  # noqa: F401  (sets matmul precision)
    from smarc_navigation_tpu import compile_cache
    from smarc_navigation_tpu.configs import PFConfig
    from smarc_navigation_tpu.io import sim, workloads
    from smarc_navigation_tpu.models import ekf_slam as slam
    from smarc_navigation_tpu.models import particle_filter as pf
    from smarc_navigation_tpu.parallel import fleet

    compile_cache.enable()
    # the bench workloads cap detections at max_obs per tick by design
    warnings.filterwarnings("ignore", message="event channel saturated")
    print(f"# budget: {BUDGET_S:.0f}s", file=sys.stderr)

    _tl_cache = {}

    def slam_timelines(cfg, duration, B):
        # content depends only on (system_freq, max_obs, duration, B) — the
        # SLAM configs benched here share freq/max_obs, so cache on those
        # and build the same missions once for the L=64, L=256 and
        # fleet-combined sections
        ck = (cfg.system_freq, cfg.max_obs, duration, B)
        if ck not in _tl_cache:
            _tl_cache[ck] = workloads.slam_fleet_timelines(cfg, duration, B)
        return _tl_cache[ck]

    def slam_fleet_fn(cfg, params, update_mode="full"):
        def run(t):
            final, _ = slam.run_fleet(t, params, cfg, update_mode=update_mode)
            return jnp.sum(final.mu[:, 0:6]) + jnp.sum(final.n_active)
        return jax.jit(run)

    # ---- 1. EKF-SLAM fleet (headline: L=64 working shapes) --------------------
    def sec_slam_headline():
        cfg = workloads.combined_slam_cfg()
        B = 128
        run1 = slam_fleet_fn(cfg, slam.make_params(cfg))
        b_small = slam_timelines(cfg, 15.0, B)
        b_big = slam_timelines(cfg, 60.0, B)
        T_s, T_b = int(b_small.ticks.shape[1]), int(b_big.ticks.shape[1])
        per_tick = slope(run1, (b_small,), (b_big,), T_s, T_b)
        steps = B / per_tick
        RESULT["value"] = round(steps, 1)
        RESULT["vs_baseline"] = round(steps / 10.0, 1)
        RESULT["secondary"]["slam_realtime_factor_aggregate"] = round(
            steps / cfg.system_freq, 1)
        print(
            f"# ekf-slam fleet (L=64): {B} x ({T_s}->{T_b}) ticks, "
            f"{per_tick*1e6:.0f} us/fleet-tick -> {steps:,.0f} steps/s",
            file=sys.stderr,
        )
        if args.trace:
            traced_call(args.trace, "slam-fleet-headline", run1, b_small)

    section("slam-fleet-headline", sec_slam_headline, floor_s=30.0)

    def pf_tl(duration, updates=True, seed=3):
        m = sim.simulate(sim.MissionSpec(
            duration_s=duration, seed=seed,
            gps_surface_z=(-100.0 if updates else 100.0)))
        return pf.pf_timeline(m, freq_hz=10.0)

    def pf_fn(n_particles):
        pf_cfg = PFConfig(particle_count=n_particles)
        pf_params = pf.make_params(pf_cfg)

        @jax.jit
        def run(t, key=None):
            _, out = pf.run(t, pf_params, pf_cfg, n_particles=n_particles,
                            key=key, scheme="systematic")
            return jnp.sum(out["mean"])
        return run

    # ---- 2. 2^20-particle MCL (systematic resampling) ------------------------
    def sec_pf():
        n_particles = 1 << 20
        # the distributed resample (explicit collectives) on a particle=1
        # mesh must be bitwise the single-device sampler
        from smarc_navigation_tpu.ops import resampling
        from smarc_navigation_tpu.parallel import mesh as mesh_lib
        from smarc_navigation_tpu.parallel import resample_dist

        pm1 = mesh_lib.make_mesh(mission=1, particle=1)
        nd = 1 << 17
        kd = jax.random.PRNGKey(123)
        pd = jax.random.normal(jax.random.PRNGKey(1), (6, nd), jnp.float32)
        wd = resampling.normalize_weights_det(
            jax.random.uniform(jax.random.PRNGKey(2), (nd,), jnp.float32))
        ref = jnp.take(pd, resampling.systematic_resample(kd, wd), axis=1)
        got = resample_dist.systematic_resample_gather_dist(pd, wd, kd, pm1)
        assert (np.asarray(got) == np.asarray(ref)).all(), (
            "distributed resample drifted from the single-device sampler")
        print("# dist-resample: bitwise OK (particle=1 mesh)", file=sys.stderr)

        run_pf = pf_fn(n_particles)
        tl_s, tl_b = pf_tl(15.0), pf_tl(60.0)
        Tp_s, Tp_b = int(tl_s.ticks.shape[0]), int(tl_b.ticks.shape[0])
        per_tick = slope(run_pf, (tl_s,), (tl_b,), Tp_s, Tp_b)
        RESULT["secondary"]["pf_particle_updates_per_sec_1M"] = round(
            n_particles / per_tick, 1)
        RESULT["secondary"]["pf_realtime_factor_1M_particles"] = round(
            0.1 / per_tick, 1)  # ticks are 10 Hz
        print(
            f"# pf: {n_particles:,} particles, {per_tick*1e6:.0f} us/tick -> "
            f"{n_particles/per_tick:,.3g} upd/s ({0.1/per_tick:,.0f}x real-time)",
            file=sys.stderr,
        )
        if args.trace:
            traced_call(args.trace, "pf-1M", run_pf, tl_s)

    section("pf-1M", sec_pf, floor_s=40.0)

    # ---- 3. combined north star: 2^20-particle MCL + EKF-SLAM, one mission ---
    def sec_combined():
        from smarc_navigation_tpu.parallel.fleet import run_combined

        n_particles = 1 << 20
        pf_cfg = PFConfig(particle_count=n_particles)
        pf_params = pf.make_params(pf_cfg)
        cfg = workloads.combined_slam_cfg()
        slam_params = slam.make_params(cfg)
        run_c = jax.jit(lambda ts, tp: run_combined(
            ts, tp, slam_params, cfg, pf_params, pf_cfg, n_particles))
        a_s = workloads.combined_workload(cfg, 15.0)
        a_b = workloads.combined_workload(cfg, 60.0)
        Tc_s = int(a_s[1].ticks.shape[0])
        Tc_b = int(a_b[1].ticks.shape[0])
        per_tick = slope(run_c, a_s, a_b, Tc_s, Tc_b)
        rt = 0.1 / per_tick
        RESULT["secondary"]["combined_1M_pf_slam_realtime_factor"] = round(rt, 1)
        print(
            f"# combined 2^20-PF + SLAM: {per_tick*1e6:.0f} us/tick -> "
            f"{rt:,.0f}x real-time", file=sys.stderr,
        )

    section("combined-northstar", sec_combined, floor_s=40.0)

    # ---- 3b. PF weak-scaling sweep -------------------------------------------
    # Each N/k point is the per-device bank of a k-device particle shard of
    # the 2^20 mission (collectives excluded); the predict-only mission
    # (no GPS fixes) splits the tick into predict and update legs.
    def sec_weakscale():
        tls = {(d, u): pf_tl(d, u) for d in (15.0, 240.0)
               for u in (True, False)}
        T_s = int(tls[(15.0, True)].ticks.shape[0])
        T_b = int(tls[(240.0, True)].ticks.shape[0])
        for n in (1 << 17, 1 << 18, 1 << 19, 1 << 20):
            run_n = pf_fn(n)
            full = slope(run_n, (tls[(15.0, True)],), (tls[(240.0, True)],),
                         T_s, T_b, reps=5)
            pred = slope(run_n, (tls[(15.0, False)],),
                         (tls[(240.0, False)],), T_s, T_b, reps=5)
            RESULT["secondary"][f"pf_tick_us_full_n{n}"] = round(full * 1e6, 1)
            RESULT["secondary"][f"pf_tick_us_predict_n{n}"] = round(
                pred * 1e6, 1)
            print(f"# pf weak-scale N=2^{n.bit_length()-1}: full "
                  f"{full*1e6:.1f} us/tick, predict-leg {pred*1e6:.1f} "
                  f"us/tick, update-leg {(full-pred)*1e6:.1f} us/tick",
                  file=sys.stderr)

    section("pf-weakscale", sec_weakscale, floor_s=70.0)

    # ---- 3c. fleet-scale combined: 32 missions x 2^18 particles each ----------
    # SLAM through the B=32 fleet, each mission's MCL through pf.run in turn
    # (distinct missions, distinct keys). Aggregate = B missions' 10 Hz
    # seconds per wall second.
    def sec_fleet_combined():
        B, n_part = 32, 1 << 18
        cfg = workloads.combined_slam_cfg()
        run_slam_b = slam_fleet_fn(cfg, slam.make_params(cfg))
        run_pf = pf_fn(n_part)

        def mk(duration):
            pfs = [pf_tl(duration, seed=100 + i) for i in range(8)]
            return slam_timelines(cfg, duration, B), (pfs * (B // 8))[:B]

        def run_fc(tl_slam, tl_pfs):
            acc = run_slam_b(tl_slam)
            for i, t in enumerate(tl_pfs):
                acc = acc + run_pf(t, jax.random.PRNGKey(1000 + i))
            return acc

        a_s, a_b = mk(15.0), mk(60.0)
        T_s = int(a_s[0].ticks.shape[1])
        T_b = int(a_b[0].ticks.shape[1])
        per_tick = slope(run_fc, a_s, a_b, T_s, T_b)
        agg = B * 0.1 / per_tick
        RESULT["secondary"]["fleet_combined_32x256k_aggregate_realtime"] = \
            round(agg, 1)
        print(f"# fleet combined (B={B} x 2^18-PF + SLAM): "
              f"{per_tick*1e6:.0f} us/fleet-tick -> {agg:,.0f}x aggregate "
              f"({0.1/per_tick:,.1f}x per mission)", file=sys.stderr)

    section("fleet-combined", sec_fleet_combined, floor_s=60.0)

    def chained(body, reps):
        """``reps`` data-dependent replays in one program: single replays of
        the cheap sections are too short to time against per-call costs."""
        @jax.jit
        def fn(t):
            def step(acc, _):
                t2 = jax.tree_util.tree_map(
                    lambda x: x + acc.astype(x.dtype) * 1e-30
                    if jnp.issubdtype(x.dtype, jnp.floating) else x, t)
                return acc + body(t2), None
            acc, _ = jax.lax.scan(
                step, jnp.asarray(0.0, jnp.float32), None, length=reps)
            return acc
        return fn

    # ---- 4. closed-form SAM dead-reckoning fleet ------------------------------
    def sec_dr():
        from smarc_navigation_tpu.models import dead_reckoning as dr_mod

        REPS_DR = 32
        fndr = chained(lambda t: jnp.sum(dr_mod.run_sam_dr_vectorized(t)), REPS_DR)
        rdr, Tdr = {}, {}
        for dur, key in ((15.0, "s"), (120.0, "b")):
            mdr = sim.simulate(sim.MissionSpec(duration_s=dur, seed=9))
            btdr = fleet.batch_timelines([dr_mod.sam_timeline(mdr)] * 256)
            Tdr[key] = int(btdr.ticks.shape[1])
            rdr[key] = timed(fndr, btdr)
        perdr = max(rdr["b"] - rdr["s"], 1e-9) / (Tdr["b"] - Tdr["s"]) / REPS_DR
        RESULT["secondary"]["sam_dr_ticks_per_sec_fleet256"] = round(256 / perdr, 1)
        print(
            f"# sam-dr fleet (closed form): 256 missions, {perdr*1e6:.3f} "
            f"us/fleet-tick -> {256/perdr:,.3g} ticks/s", file=sys.stderr,
        )

    section("sam-dr-fleet", sec_dr, floor_s=30.0)

    # ---- 5. EKF-SLAM fleet at reference-advertised shapes ---------------------
    def sec_slam256():
        # padded 256-landmark state, reference launch tunings
        cfg256 = workloads.slam256_cfg()
        B256 = 32
        params256 = slam.make_params(cfg256)
        b_s = slam_timelines(cfg256, 15.0, B256)
        b_b = slam_timelines(cfg256, 60.0, B256)
        T_s, T_b = int(b_s.ticks.shape[1]), int(b_b.ticks.shape[1])
        for mode, key in (("full", "ekf_slam_steps_per_sec_fleet32_L256_reftuned"),
                          ("marginal", "ekf_slam_steps_per_sec_fleet32_L256_marginal")):
            # "marginal" is the reference's own 9x9 writeback
            # (ekf_slam_core.cpp:351-371); "full" the whole-state gain
            per_tick = slope(slam_fleet_fn(cfg256, params256, mode),
                             (b_s,), (b_b,), T_s, T_b)
            steps = B256 / per_tick
            RESULT["secondary"][key] = round(steps, 1)
            print(f"# ekf-slam fleet (L=256, {mode} update): {B256} missions, "
                  f"{per_tick*1e6:.0f} us/fleet-tick -> {steps:,.0f} steps/s",
                  file=sys.stderr)

    section("slam-L256-reftuned", sec_slam256, floor_s=60.0)

    # ---- 5b. FLS fleet --------------------------------------------------------
    def sec_fls():
        cfg = workloads.fls_slam_cfg()
        B = 128
        runf = slam_fleet_fn(cfg, slam.make_params(cfg))
        b_s = workloads.fls_fleet_timelines(cfg, 15.0, B)
        b_b = workloads.fls_fleet_timelines(cfg, 60.0, B)
        T_s, T_b = int(b_s.ticks.shape[1]), int(b_b.ticks.shape[1])
        per_tick = slope(runf, (b_s,), (b_b,), T_s, T_b)
        steps = B / per_tick
        RESULT["secondary"]["ekf_slam_fls_steps_per_sec_fleet128"] = round(steps, 1)
        print(
            f"# ekf-slam FLS fleet (L=64): {B} x ({T_s}->{T_b}) ticks, "
            f"{per_tick*1e6:.0f} us/fleet-tick -> {steps:,.0f} steps/s",
            file=sys.stderr,
        )

    section("fls-fleet", sec_fls, floor_s=40.0)

    # ---- 6. EKF localization fleet (reference launch tunings) ----------------
    def sec_loc():
        from smarc_navigation_tpu.configs import EKFLocConfig
        from smarc_navigation_tpu.models import ekf_localization as loc

        cfg_loc = EKFLocConfig()  # ekf_localization.launch:8-13 defaults

        def loc_mission(duration):
            m_loc = sim.simulate(
                sim.MissionSpec(duration_s=duration, num_landmarks=16,
                                dvl_std=0.05, mbes_std=0.05, seed=7))
            return loc.loc_timeline(m_loc, cfg_loc), m_loc

        tl_small, _ = loc_mission(15.0)
        tl_big, m_big = loc_mission(60.0)
        params_loc = loc.make_params(m_big.landmarks, cfg_loc)
        run_loc = jax.jit(
            lambda t: jnp.sum(loc.run_fleet(t, params_loc, cfg_loc)[1]["mu"]))
        for B, key in ((64, "ekf_localization_steps_per_sec_fleet64"),
                       (512, "ekf_localization_steps_per_sec_fleet512")):
            bl_s = fleet.batch_timelines([tl_small] * B)
            bl_b = fleet.batch_timelines([tl_big] * B)
            Tl_s, Tl_b = int(bl_s.ticks.shape[1]), int(bl_b.ticks.shape[1])
            per_tick = slope(run_loc, (bl_s,), (bl_b,), Tl_s, Tl_b)
            steps = B / per_tick
            RESULT["secondary"][key] = round(steps, 1)
            print(
                f"# ekf-localization fleet-{B} (ref-tuned): "
                f"{per_tick*1e6:.1f} us/fleet-tick -> {steps:,.0f} steps/s "
                f"({steps / cfg_loc.system_freq:,.0f}x the 50 Hz node)",
                file=sys.stderr,
            )

    section("loc-fleet", sec_loc, floor_s=40.0)

    # ---- 7. closed-loop Monte-Carlo raycast fleet (BASELINE config: 1024) ----
    def sec_raycast():
        B_rc = 1024
        cfg, spec, lms, lmm = workloads.raycast_fleet_setup(B_rc)
        params_rc = slam.make_params(cfg)
        base_m = sim.simulate(sim.MissionSpec(duration_s=30.0, seed=1))
        run_rc = jax.jit(
            lambda g, l, m_: jnp.sum(
                fleet.run_raycast_fleet(g, l, m_, cfg, params_rc, spec)[1][0]))

        def rc_args(T_rc):
            gt_one = base_m.gt_at(np.arange(T_rc) / cfg.system_freq)
            return (jnp.asarray(np.tile(gt_one.astype(np.float32), (B_rc, 1, 1))),
                    lms, lmm)

        Tr_s, Tr_b = 76, 301
        per_tick = slope(run_rc, rc_args(Tr_s), rc_args(Tr_b), Tr_s, Tr_b)
        steps = B_rc / per_tick
        RESULT["secondary"]["raycast_fleet_closed_loop_steps_per_sec_1024"] = round(
            steps, 1)
        print(
            f"# raycast fleet: {B_rc} missions (render+perceive+slam), "
            f"{per_tick*1e6:.0f} us/fleet-tick -> {steps:,.0f} steps/s",
            file=sys.stderr,
        )

    section("raycast-fleet", sec_raycast, floor_s=40.0)

    # ---- 8. 15-state dual EKF fleet -------------------------------------------
    def sec_ekf15():
        from smarc_navigation_tpu.models import ekf_15state as e15

        REPS15 = 8
        cfg15 = e15.Ekf15Config(frequency=50.0)
        cfg15g = e15.global_config(frequency=50.0)
        fn15 = chained(lambda t: jnp.sum(e15.run_fleet(t, cfg15)[1]["x"]), REPS15)
        fnd = chained(
            lambda t: jnp.sum(e15.run_dual_fleet(t, t, cfg15, cfg15g)[2].trans),
            REPS15)
        r15, rd, T15 = {}, {}, {}
        for dur, key in ((15.0, "s"), (120.0, "b")):
            m15 = sim.simulate(sim.MissionSpec(duration_s=dur, seed=5))
            tl15 = e15.ekf15_timeline(m15, cfg15, include_gps=True)
            bt15 = fleet.batch_timelines([tl15] * 64)
            T15[key] = int(bt15.ticks.shape[1])
            r15[key] = timed(fn15, bt15)
            rd[key] = timed(fnd, bt15)
        dT = (T15["b"] - T15["s"]) * REPS15
        per15 = max(r15["b"] - r15["s"], 1e-9) / dT
        perd = max(rd["b"] - rd["s"], 1e-9) / dT
        RESULT["secondary"]["ekf15_steps_per_sec_fleet64"] = round(64 / per15, 1)
        RESULT["secondary"]["ekf15_dual_pairs_per_sec_fleet64"] = round(
            64 / perd, 1)
        print(f"# ekf15 fleet: 64 missions, {per15*1e6:.2f} us/fleet-tick -> "
              f"{64/per15:,.0f} steps/s", file=sys.stderr)
        print(f"# ekf15 DUAL fleet: 64 missions, {perd*1e6:.2f} us/fleet-tick "
              f"-> {64/perd:,.0f} dual-steps/s", file=sys.stderr)

    section("ekf15-fleet", sec_ekf15, floor_s=40.0)

    emit()
    if FAILED or SKIPPED:
        print(f"# FAILED sections: {FAILED}; SKIPPED for want of budget: {SKIPPED}",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
