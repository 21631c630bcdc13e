"""Where do sharded runs part from one device? A diagnostic for the
``chip_smoke.py --four-cards`` bitwise checks.

Runs, on the first ``--devices`` devices of one host:

* the SLAM fleet (``combined_slam_cfg``) as one SPMD program over a
  ``mission`` mesh (the fleet inside a ``shard_map``) vs the same fleet on
  one device: the first tick at which an output differs, then each leg of
  that tick (predict, DA cost table, assignment, update, the whole step)
  run alone, sharded vs one device, from the same state; and
  ``run_fleet(device_mesh=)``, the one-device program on each device's
  block, vs one device;
* the MCL over a ``particle`` mesh vs one device: the bank before and
  after the first GPS update, then predict, weights, resample and the
  whole step alone from the same bank;
* ``--pf-variants``: the MCL comparison under candidate formulations of
  predict and update patched into the module (``PF_VARIANTS``).

``--variants`` repeats the comparisons under XLA compiler options applied
to both sides. Optimized HLO of the full programs goes to ``--out``. Run
from the repo root, on four GPUs:

    python scripts/probe_shard_bitwise.py --out probe_out
    python scripts/probe_shard_bitwise.py --pf-variants pf-as-is,pin-predict-all

On the CPU (every comparison is expected to be bitwise there):

    JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=4 \\
        python scripts/probe_shard_bitwise.py --small --out probe_out
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import warnings

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax import shard_map  # noqa: E402
from jax.sharding import NamedSharding, PartitionSpec as P  # noqa: E402

import smarc_navigation_tpu  # noqa: E402,F401  (matmul precision)
from smarc_navigation_tpu.configs import PFConfig  # noqa: E402
from smarc_navigation_tpu.io import sim, workloads  # noqa: E402
from smarc_navigation_tpu.models import ekf_slam as slam  # noqa: E402
from smarc_navigation_tpu.models import particle_filter as pf  # noqa: E402
from smarc_navigation_tpu.ops import assignment  # noqa: E402
from smarc_navigation_tpu.parallel import mesh as mesh_lib  # noqa: E402

warnings.filterwarnings("ignore", message="event channel saturated")


def leaves(tree):
    return [np.asarray(x) for x in jax.tree_util.tree_leaves(tree)]


def diff(a, b):
    """[(leaf, mismatches, max |a-b|)] of leaves that differ."""
    out = []
    for i, (x, y) in enumerate(zip(leaves(a), leaves(b))):
        bad = int((x != y).sum())
        if bad:
            out.append((i, bad, float(np.abs(x.astype(np.float64) - y).max())))
    return out or "bitwise"


def compiled(fn, args, opts, dump=None):
    c = jax.jit(fn).lower(*args).compile(compiler_options=opts or None)
    if dump:
        with open(dump, "w") as f:
            f.write(c.as_text())
    return c


def take(tree, sl):
    return jax.tree_util.tree_map(lambda x: x[sl], tree)


# ---------------------------------------------------------------------------


def slam_probe(devs, B, duration, opts, out_dir, tag, force_tick=None,
               legs_too=True):
    n_dev = len(devs)
    cfg = workloads.combined_slam_cfg()
    params = slam.make_params(cfg)
    tl = workloads.slam_fleet_timelines(cfg, duration, B)
    mesh = mesh_lib.make_mesh(mission=n_dev, particle=1, devices=devs)
    d0 = devs[0]

    def one(t):
        return slam.run_fleet(t, params, cfg)

    def sharded(t):
        # one SPMD program over the mesh: the fleet inside a shard_map
        def local(tb):
            fin, out = slam.run_fleet(tb, params, cfg)
            return fin, jax.tree_util.tree_map(lambda x: jnp.moveaxis(x, 0, 1), out)

        spec = P(mesh_lib.MISSION_AXIS)
        fin, out = shard_map(local, mesh=mesh, in_specs=spec, out_specs=spec,
                             check_vma=False)(t)
        return fin, jax.tree_util.tree_map(lambda x: jnp.moveaxis(x, 0, 1), out)

    tl0 = jax.device_put(tl, d0)
    dump = out_dir and os.path.join(out_dir, f"slam_{tag}")
    r1 = compiled(one, (tl0,), opts, dump and dump + "_1dev.hlo")(tl0)
    if dump:
        tl_small = jax.device_put(take(tl, slice(0, B // n_dev)), d0)
        compiled(one, (tl_small,), opts, dump + f"_1dev_B{B // n_dev}.hlo")
    r4 = compiled(sharded, (tl,), opts, dump and dump + f"_{n_dev}dev.hlo")(tl)
    d = diff(r1, r4)
    first = None
    mu1, mu4 = np.asarray(r1[1]["mu"]), np.asarray(r4[1]["mu"])
    bad_t = np.nonzero((mu1 != mu4).any(axis=(1, 2)))[0]
    if len(bad_t):
        first = int(bad_t[0])
    print(f"[slam {tag}] one SPMD program (shard_map) B={B} T={mu1.shape[0]} vs one "
          f"device: {d}; first differing tick of mu: {first}", flush=True)
    # run_fleet(device_mesh=): the one-device program on each device's block
    r_pd = slam.run_fleet(tl, params, cfg, device_mesh=mesh)
    print(f"[slam {tag}] run_fleet(device_mesh=) (one-device program per device, "
          f"B={B // n_dev} each) vs one device B={B}: {diff(r1, r_pd)}", flush=True)
    first = first if first is not None else force_tick
    if first is None or not legs_too:
        return
    # state before the first differing tick, from the one-device run
    pre = take(tl, (slice(None), slice(0, first)))
    st, _ = jax.jit(one)(jax.device_put(pre, d0))
    tick = take(tl, (slice(None), first))
    spec = P(mesh_lib.MISSION_AXIS)

    def legs(fn, *args):
        f4 = shard_map(fn, mesh=mesh, in_specs=spec, out_specs=spec, check_vma=False)
        a0 = jax.device_put(args, d0)
        a4 = jax.device_put(args, NamedSharding(mesh, spec))
        return diff(compiled(fn, a0, opts)(*a0), compiled(f4, a4, opts)(*a4))

    def pose(tk):
        return tk.channels["odom"].value[..., 0:6]

    v = jax.vmap
    print(f"  predict: {legs(v(lambda s, tk: slam.predict(s, pose(tk), params)), st, tick)}")
    pred = jax.jit(v(lambda s, tk: slam.predict(s, pose(tk), params)))(st, tick)
    ev = tick.events["mbes"]

    def stage(s, z, m):
        return slam.da_stage(s, z, m, params, cfg, slam.MBES)

    print(f"  da_stage: {legs(v(stage), pred, ev.value, ev.mask)}")
    cost, staged = jax.jit(v(stage))(pred, ev.value, ev.mask)
    print(f"  hungarian: {legs(v(assignment.hungarian), cost)}")
    c2r = jax.jit(v(assignment.hungarian))(cost)

    def commit(s, c, stg, z, m):
        return slam.da_commit(s, c, stg, z, m, params, cfg, slam.MBES)

    print(f"  da_commit: {legs(v(commit), pred, c2r, staged, ev.value, ev.mask)}")
    print(f"  step: {legs(v(lambda s, tk: slam.step(cfg, params, s, tk)), st, tick)}",
          flush=True)


def pf_probe(devs, n, duration, opts, out_dir, tag, force_tick=None,
               legs_too=True):
    n_dev = len(devs)
    m = sim.simulate(sim.MissionSpec(duration_s=duration, gps_std=0.3, dvl_std=0.02,
                                     gps_surface_z=-100.0))
    cfg = dataclasses.replace(PFConfig(), particle_count=n, measurement_std=1.0,
                              motion_cov=(1e-4, 1e-4, 0.0, 0.0, 0.0, 1e-6))
    params = pf.make_params(cfg)
    tl = pf.pf_timeline(m)
    key = jax.random.PRNGKey(11)
    pmesh = mesh_lib.make_mesh(mission=1, particle=n_dev, devices=devs)
    d0 = devs[0]

    def one(t):
        return pf.run(t, params, cfg, n_particles=n, key=key, scheme="systematic")

    def sharded(t):
        return pf.run(t, params, cfg, n_particles=n, key=key, scheme="systematic",
                      pmesh=pmesh)

    tl0 = jax.device_put(tl, d0)
    dump = out_dir and os.path.join(out_dir, f"pf_{tag}")
    f1, o1 = compiled(one, (tl0,), opts, dump and dump + "_1dev.hlo")(tl0)
    f4, o4 = compiled(sharded, (tl,), opts, dump and dump + f"_{n_dev}dev.hlo")(tl)
    upd = np.nonzero(np.asarray(o1["updated"]))[0]
    dm = np.abs(np.asarray(o1["mean"]) - np.asarray(o4["mean"])).max(axis=1)
    jump = np.nonzero(dm > 1e-5)[0]
    first = int(jump[0]) if len(jump) else None
    bank_bad = int((np.asarray(f1.particles) != np.asarray(f4.particles)).sum())
    print(f"[pf {tag}] full run n={n}: bank {bank_bad} of {6 * n} differ; updates at "
          f"ticks {upd.tolist()}; mean diff per tick (max) {dm.max():.3e}; first tick "
          f"above 1e-5: {first}", flush=True)
    if not legs_too or (bank_bad == 0 and force_tick is None):
        return
    # the bank itself just before and just after the first update
    same = []
    for k in (int(upd[0]), int(upd[0]) + 1):
        pre = take(tl, slice(0, k))
        b1 = jax.jit(one)(jax.device_put(pre, d0))[0].particles
        b4 = jax.jit(sharded)(pre)[0].particles
        same.append(diff(b1, b4) == "bitwise")
        print(f"  bank after {k} ticks: {diff(b1, b4)}", flush=True)
    first = force_tick if force_tick is not None else (int(upd[0]) if same[0] else 0)
    print(f"  legs at tick {first}:", flush=True)
    # bank before the first diverging tick, from the one-device run
    pre = take(tl, slice(0, first))
    st, _ = jax.jit(one)(jax.device_put(pre, d0))
    tick = take(tl, first)
    bank_sh = NamedSharding(pmesh, P(None, mesh_lib.PARTICLE_AXIS))
    rep = NamedSharding(pmesh, P())
    st4 = jax.device_put(st, rep)._replace(particles=jax.device_put(st.particles, bank_sh))

    def legs(fn1, fn4, s1, s4, *rest):
        a1 = jax.device_put((s1,) + rest, d0)
        a4 = (s4,) + jax.device_put(rest, rep)
        return diff(compiled(fn1, a1, opts)(*a1), compiled(fn4, a4, opts)(*a4))

    dt = jnp.asarray(tick.ticks - st.t_prev)
    gps = tick.channels["gps"].value[0:2]
    odom = tick.channels["odom"].value

    def pred(s, o, d):
        return pf.predict(s, o, d, params)

    def weights(s, g):
        return pf._gps_weights(s.particles, g, params)

    def upd(mesh):
        return lambda s, g: pf.update_resample(s, g, params, "systematic", pmesh=mesh)

    def step(mesh):
        return lambda s, tk: pf.step(cfg, params, s, tk, "systematic", pmesh=mesh)[0]

    print(f"  predict: {legs(pred, pred, st, st4, odom, dt)}")
    print(f"  weights: {legs(weights, weights, st, st4, gps)}")
    print(f"  update_resample: {legs(upd(None), upd(pmesh), st, st4, gps)}")
    print(f"  step: {legs(step(None), step(pmesh), st, st4, tick)}", flush=True)


def _predict_pinned_noise(state, odom, dt, params):
    """``pf.predict`` with the scaled noise materialized before the motion
    model adds it (no multiply-add across a fusion boundary)."""
    key, sub = jax.random.split(state.key)
    n = state.particles.shape[1]
    sd = jnp.sqrt(params.motion_cov)
    n3 = jax.random.normal(sub, (3, n), state.particles.dtype)
    noise = jnp.zeros((6, n), state.particles.dtype)
    noise = noise.at[0].set(n3[0] * sd[0]).at[1].set(n3[1] * sd[1]).at[5].set(n3[2] * sd[5])
    noise = jax.lax.optimization_barrier(noise)
    return pf.PFState(pf.motion_model_batch(state.particles, odom, dt, noise), key,
                      state.t_prev)


def _predict_pinned_all(state, odom, dt, params):
    """As above, and the odometry scalars pinned too."""
    odom, dt = jax.lax.optimization_barrier((odom, dt))
    return _predict_pinned_noise(state, odom, dt, params)


_UPDATE = pf.update_resample


def _update_pinned(state, gps, params, scheme="residual", pmesh=None):
    """``pf.update_resample`` with the jitter materialized before the add."""
    key, k_res, k_noise = jax.random.split(state.key, 3)
    w = pf._gps_weights(state.particles, gps, params)
    if pmesh is not None:
        from smarc_navigation_tpu.parallel import resample_dist
        parts = resample_dist.systematic_resample_gather_dist(
            state.particles, w, k_res, pmesh)
    else:
        from smarc_navigation_tpu.ops import resampling
        parts = state.particles[:, resampling.systematic_resample(k_res, w)]
    noise = jax.random.normal(k_noise, parts.shape, parts.dtype) * jnp.sqrt(
        params.res_noise_cov)[:, None]
    parts, noise = jax.lax.optimization_barrier((parts, noise))
    return pf.PFState(parts + noise, key, state.t_prev)


PF_VARIANTS = {
    "pf-as-is": (pf.predict, _UPDATE),
    "pin-predict-noise": (_predict_pinned_noise, _UPDATE),
    "pin-predict-all": (_predict_pinned_all, _UPDATE),
    "pin-all+update": (_predict_pinned_all, _update_pinned),
}


def pf_variants(devs, n, duration, names):
    """The particle-sharded MCL vs one device under candidate formulations
    of predict and update (patched into the module): bank mismatches after
    the whole run and after the predict-only ticks before the first fix."""
    orig = (pf.predict, pf.update_resample)
    m = sim.simulate(sim.MissionSpec(duration_s=duration, gps_std=0.3, dvl_std=0.02,
                                     gps_surface_z=-100.0))
    cfg = dataclasses.replace(PFConfig(), particle_count=n, measurement_std=1.0,
                              motion_cov=(1e-4, 1e-4, 0.0, 0.0, 0.0, 1e-6))
    params = pf.make_params(cfg)
    tl = pf.pf_timeline(m)
    key = jax.random.PRNGKey(11)
    pmesh = mesh_lib.make_mesh(mission=1, particle=len(devs), devices=devs)
    try:
        for name in names:
            pf.predict, pf.update_resample = PF_VARIANTS[name]
            res = []
            for T in (10, tl.ticks.shape[0]):
                t = take(tl, slice(0, T))
                b1 = jax.jit(lambda x: pf.run(x, params, cfg, n_particles=n, key=key,
                                              scheme="systematic")[0].particles)(
                    jax.device_put(t, devs[0]))
                b4 = jax.jit(lambda x: pf.run(x, params, cfg, n_particles=n, key=key,
                                              scheme="systematic", pmesh=pmesh)[0].particles)(t)
                res.append(f"T={T}: {int((np.asarray(b1) != np.asarray(b4)).sum())}")
            print(f"[pf-variant {name}] bank elements differing: {', '.join(res)}",
                  flush=True)
    finally:
        pf.predict, pf.update_resample = orig


VARIANTS = {
    "default": {},
    "no_triton_gemm": {"xla_gpu_enable_triton_gemm": False},
}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--devices", type=int, default=4)
    ap.add_argument("--small", action="store_true", help="tiny sizes (CPU rehearsal)")
    ap.add_argument("--out", default="", help="directory for optimized HLO dumps")
    ap.add_argument("--variants", default="default")
    ap.add_argument("--pf-variants", default="",
                    help=f"comma list of {list(PF_VARIANTS)}: run only these")
    ap.add_argument("--quick", action="store_true",
                    help="full-run comparisons only: no leg probes, no dumps")
    args = ap.parse_args()
    devs = jax.devices()[:args.devices]
    assert len(devs) == args.devices, jax.devices()
    if args.out:
        os.makedirs(args.out, exist_ok=True)
    print(f"devices: {[d.device_kind for d in devs]}; precision "
          f"{jax.config.jax_default_matmul_precision}", flush=True)
    B, dur, n = (8, 1.5, 1 << 14) if args.small else (8, 3.0, 1 << 20)
    force = 11 if args.small else None   # exercise the leg probes on the CPU
    if args.pf_variants:
        pf_variants(devs, n, dur, args.pf_variants.split(","))
        return
    for name in args.variants.split(","):
        opts = VARIANTS[name]
        out = "" if args.quick else args.out
        legs_too = name == "default" and not args.quick
        for label, fn in (("slam", lambda: slam_probe(devs, B, dur, opts, out, name, force,
                                                      legs_too)),
                          ("pf", lambda: pf_probe(devs, n, dur, opts, out, name, force,
                                                  legs_too))):
            try:
                fn()
            except Exception as e:  # noqa: BLE001 — report and go on
                print(f"[{label} {name}] error: {e!r}", flush=True)


if __name__ == "__main__":
    main()
