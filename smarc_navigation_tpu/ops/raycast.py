"""Simulated MBES ray-casting, on device.

The Monte-Carlo fleet configuration (BASELINE.json: "1024 batched missions
with simulated MBES ray-cast") needs sonar synthesis *inside* the jitted
mission step so fleets never touch the host. This renders a multibeam ping
against a flat seafloor plus spherical rock landmarks:

* beams fan across-track in the vehicle's y/z plane,
* per beam: ray/plane and ray/sphere intersections, nearest hit wins,
* intensity = background + reflectivity bump on rock hits.

Feeding the rendered ping through ``ops.sonar.extract_peaks`` closes the
loop sim → perception → SLAM entirely on device; vmap over missions and shard
over the mesh for fleets.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import jax.numpy as jnp

from ..utils.geometry import rotmat_from_rpy


class MBESSpec(NamedTuple):
    num_beams: int = 64
    swath_rad: float = 2.0          # total fan opening
    max_range: float = 60.0
    floor_z: float = -15.0
    rock_radius: float = 1.0
    base_intensity: float = 1.0
    rock_intensity: float = 10.0


def beam_dirs_base(spec: MBESSpec, dtype=jnp.float32) -> jnp.ndarray:
    """(B, 3) unit beam directions in the base frame (across-track fan)."""
    th = jnp.linspace(-spec.swath_rad / 2, spec.swath_rad / 2, spec.num_beams,
                      dtype=dtype)
    return jnp.stack([jnp.zeros_like(th), jnp.sin(th), -jnp.cos(th)], axis=-1)


def render_ping(
    pose6: jnp.ndarray,        # (6,) vehicle pose in map frame
    landmarks: jnp.ndarray,    # (L, 3)
    lm_mask: jnp.ndarray,      # (L,)
    spec: MBESSpec = MBESSpec(),
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """-> (ranges (B,), intensities (B,)) for one ping."""
    dtype = pose6.dtype
    d_base = beam_dirs_base(spec, dtype)                       # (B,3)
    R = rotmat_from_rpy(pose6[3:6])
    d = d_base @ R.T                                           # (B,3) map frame
    p = pose6[0:3]

    # seafloor plane z = floor_z
    dz = d[:, 2]
    t_floor = (spec.floor_z - p[2]) / jnp.where(jnp.abs(dz) < 1e-6, -1e-6, dz)
    t_floor = jnp.where((t_floor > 0) & (t_floor < spec.max_range), t_floor,
                        spec.max_range)

    # spheres at landmarks
    oc = landmarks[None, :, :] - p[None, None, :]              # (1,L,3) - broadcast
    oc = jnp.broadcast_to(landmarks[None, :, :] - p[None, None, :],
                          (d.shape[0], landmarks.shape[0], 3))
    t_ca = jnp.einsum("blk,bk->bl", oc, d)                     # (B,L)
    d2 = jnp.sum(oc * oc, axis=-1) - t_ca**2
    r2 = spec.rock_radius**2
    hit = (d2 < r2) & (t_ca > 0) & lm_mask[None, :]
    t_hit = t_ca - jnp.sqrt(jnp.maximum(r2 - d2, 0.0))
    t_hit = jnp.where(hit & (t_hit > 0), t_hit, spec.max_range)
    t_rock = jnp.min(t_hit, axis=1)                            # (B,)

    rock_first = t_rock < t_floor
    ranges = jnp.where(rock_first, t_rock, t_floor)
    intensities = jnp.where(rock_first, spec.rock_intensity, spec.base_intensity)
    return ranges, intensities


def ping_detections(
    pose6: jnp.ndarray,
    landmarks: jnp.ndarray,
    lm_mask: jnp.ndarray,
    spec: MBESSpec = MBESSpec(),
    max_detections: int = 8,
):
    """Render + extract: one call from vehicle pose to base-frame landmark
    detections (what the perception layer hands the SLAM filter)."""
    from . import sonar

    ranges, intens = render_ping(pose6, landmarks, lm_mask, spec)
    th0 = -spec.swath_rad / 2
    dth = spec.swath_rad / (spec.num_beams - 1)
    det = sonar.extract_peaks(
        intens, ranges, angle_min=th0, angle_increment=dth,
        range_max=spec.max_range, max_detections=max_detections,
    )
    # beams fan in the y/z plane: polar (r, alpha) -> base-frame (0, y, z)
    y = det.points[:, 0] * 0.0  # extract_peaks returns (r cos a, r sin a, 0)
    pts = jnp.stack(
        [
            jnp.zeros_like(det.points[:, 0]),
            det.points[:, 1],          # r·sin(alpha): across-track
            -det.points[:, 0],         # r·cos(alpha): downward
        ],
        axis=-1,
    )
    pts = jnp.where(det.mask[:, None], pts, 0.0)
    return pts, det.mask
