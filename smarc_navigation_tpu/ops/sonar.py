"""Sonar perception kernels: landmark extraction from raw sonar data.

JAX rebuild of the reference's perception layer (SURVEY.md §2.4):

* ``extract_peaks`` — the sidescan/MBES LaserScan peak extractor
  (``sonar_manipulator.hpp:44-97``, duplicated at
  ``toy_mbes_manipulator.cpp:21-81``): 5-tap mean smoothing, adaptive
  threshold (mean intensity, disabled when the signal is flat), clustering
  of consecutive over-threshold beams, middle-of-cluster beam → polar →
  cartesian point in the sensor frame. The data-dependent cluster list
  becomes a fixed-K detection bank with a validity mask, built from
  run-length segment ops (cumsum boundaries + scatter) — no host loops.

* ``detect_blobs`` — the FLS rock detector (``fls_rock_detector.cpp:69-150``:
  OpenCV GaussianBlur + SimpleBlobDetector, area gate 600-5000 px). Rebuilt
  as box blur + threshold + connected components via iterative min-label
  propagation + area-gated centroids (the blob-detector's circularity walk
  is deliberately simplified away; centroid/area semantics match). Pixel →
  FLS-frame coordinates reproduce ``:119-137``: (rows - y - 1, x - cols/2).

* ``fuse_submap`` — the MBES submap builder (``mbes_mapper/src/
  mbes_receptor.cpp:64-107``): transform a window of pings into the middle
  ping's frame and merge.

All functions are jittable and batch over leading dims with vmap.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp


class Detections(NamedTuple):
    points: jnp.ndarray  # (K, 3) sensor-frame cartesian points
    mask: jnp.ndarray    # (K,)


def smooth_intensities(intensities: jnp.ndarray) -> jnp.ndarray:
    """5-tap mean filter; the 2 edge beams on each side pass through raw
    (``sonar_manipulator.hpp:44-59``). (The reference accumulates the mean
    into an int by accident, truncating fractions; we keep float precision.)
    """
    x = intensities
    n = x.shape[-1]
    kernel = jnp.full((5,), 0.2, x.dtype)
    inner = jnp.convolve(x, kernel, mode="valid")  # (n-4,)
    return jnp.concatenate([x[:2], inner, x[-2:]]) if n >= 5 else x


def adaptive_threshold(smoothed: jnp.ndarray, range_max) -> jnp.ndarray:
    """Mean-intensity threshold; if the mean is within ±10% of the max the
    scan is flat (no target) and the threshold is pushed out of reach
    (``sonar_manipulator.hpp:61-66``)."""
    mean = jnp.mean(smoothed)
    mx = jnp.max(smoothed)
    flat = (mean >= 0.9 * mx) & (mean <= 1.1 * mx)
    return jnp.where(flat, range_max * 10.0, mean)


def extract_peaks(
    intensities: jnp.ndarray,  # (B,) beam intensities
    ranges: jnp.ndarray,       # (B,) beam ranges
    angle_min,
    angle_increment,
    range_max,
    max_detections: int = 8,
) -> Detections:
    """One scan -> up to K sensor-frame landmark points.

    Scatter-free formulation (round-4): the run-length segmentation is
    expressed with two associative scans (a reversed ``cummin`` finds each
    run's exclusive end, a ``cumsum`` numbers the valid runs) and the
    K-slot compaction with masked lane reduces — no ``scatter``/``gather``
    anywhere. This matters for fleets: vmapped over 1024 missions inside a
    scan body, scatters don't vectorize across the batch, while this form
    fuses into the surrounding elementwise work. Semantics are pinned by
    tests/test_sonar.py's oracle loop.
    """
    B = intensities.shape[-1]
    dtype = intensities.dtype
    smoothed = smooth_intensities(intensities)
    thresh = adaptive_threshold(smoothed, jnp.asarray(range_max, dtype))

    # over-threshold beams; beam 0 can never fire (the reference stores the
    # beam *index* with 0 as the empty sentinel, sonar_manipulator.hpp:67-73)
    idx = jnp.arange(B)
    hot = (smoothed >= 1.05 * thresh) & (idx > 0)

    # run-length segmentation of consecutive hot beams: a run's exclusive
    # end is the first non-hot index at-or-after it (reversed cummin)
    prev_hot = jnp.concatenate([jnp.zeros(1, bool), hot[:-1]])
    run_start = hot & ~prev_hot
    nonhot_at = jnp.where(hot, B, idx).astype(jnp.int32)
    run_end = jax.lax.cummin(nonhot_at[::-1])[::-1]
    run_len = jnp.where(run_start, run_end - idx, 0).astype(jnp.int32)

    # middle-of-cluster selection (size//2 for even, (size+1)//2 for odd —
    # the reference's off-center pick, sonar_manipulator.hpp:82-86)
    offset = jnp.where(run_len % 2 == 0, run_len // 2, (run_len + 1) // 2)
    mid = jnp.clip(idx + offset, 0, B - 1)
    valid_run = run_start & (run_len > 1)

    # compact valid runs into K slots: the k-th valid run's quantities are
    # masked sums over the beam axis (each one-hot row selects one beam)
    slot = jnp.cumsum(valid_run) - 1
    K = max_detections
    onehot = (slot[None, :] == jnp.arange(K)[:, None]) & valid_run[None, :]
    det_beam = jnp.sum(jnp.where(onehot, mid[None, :], 0), axis=1)
    det_mask = jnp.any(onehot, axis=1)

    alpha = angle_min + angle_increment * det_beam.astype(dtype)
    # range sampled at the MID beam (not the run start the slot one-hot
    # points at) — a second one-hot keyed on det_beam replaces the gather
    mid_oh = (idx[None, :] == det_beam[:, None]) & det_mask[:, None]
    r = jnp.sum(jnp.where(mid_oh, ranges[None, :], 0), axis=1)
    pts = jnp.stack([r * jnp.cos(alpha), r * jnp.sin(alpha), jnp.zeros_like(r)], -1)
    pts = jnp.where(det_mask[:, None], pts, 0.0)
    return Detections(points=pts, mask=det_mask)


def scans_to_base(
    det_left: Detections,
    det_right: Detections,
    rot_base_left: jnp.ndarray,
    trans_base_left: jnp.ndarray,
    rot_base_right: jnp.ndarray,
    trans_base_right: jnp.ndarray,
) -> Detections:
    """ApproximateTime-synced left/right sonar pair -> base-frame PoseArray
    (``mbes_receptor.cpp:68-109``)."""
    l_pts = det_left.points @ rot_base_left.T + trans_base_left
    r_pts = det_right.points @ rot_base_right.T + trans_base_right
    pts = jnp.concatenate([jnp.where(det_left.mask[:, None], l_pts, 0.0),
                           jnp.where(det_right.mask[:, None], r_pts, 0.0)])
    return Detections(points=pts, mask=jnp.concatenate([det_left.mask, det_right.mask]))


# ---------------------------------------------------------------------------
# FLS blob detection
# ---------------------------------------------------------------------------

def box_blur(img: jnp.ndarray, k: int = 5) -> jnp.ndarray:
    """Separable k×k box blur (stand-in for the reference's GaussianBlur)."""
    kern = jnp.full((k,), 1.0 / k, img.dtype)
    img = jax.vmap(lambda row: jnp.convolve(row, kern, mode="same"))(img)
    img = jax.vmap(lambda col: jnp.convolve(col, kern, mode="same"), in_axes=1,
                   out_axes=1)(img)
    return img


def connected_components(mask: jnp.ndarray, iters: int = 64) -> jnp.ndarray:
    """Min-label propagation over the 4-neighborhood; labels are flat pixel
    indices, background = -1. ``iters`` bounds the largest blob diameter."""
    H, W = mask.shape
    lab0 = jnp.where(mask, jnp.arange(H * W).reshape(H, W), H * W)

    def body(_, lab):
        pad = jnp.pad(lab, 1, constant_values=H * W)
        neigh = jnp.minimum(
            jnp.minimum(pad[:-2, 1:-1], pad[2:, 1:-1]),
            jnp.minimum(pad[1:-1, :-2], pad[1:-1, 2:]),
        )
        return jnp.where(mask, jnp.minimum(lab, neigh), H * W)

    lab = jax.lax.fori_loop(0, iters, body, lab0)
    return jnp.where(mask, lab, -1)


def detect_blobs(
    img: jnp.ndarray,          # (H, W) intensity image
    threshold: float = 0.5,    # relative to max after blur
    min_area: int = 600,       # SimpleBlobDetector params (fls_rock_detector.cpp:93-102,174-176)
    max_area: int = 5000,
    max_blobs: int = 8,
    cc_iters: int = 96,
    min_circularity: float = 0.1,  # fls_rock_detector.cpp:96-97,176
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """-> (centroids_px (K,2) as (x,y), areas (K,), mask (K,)).

    The circularity gate mirrors SimpleBlobDetector's 4πA/P² filter
    (``fls_rock_detector.cpp:95-97``, minCircularity 0.1); the perimeter
    here is the 4-neighborhood boundary-edge count per component — a
    slight overestimate of the contour length for diagonal edges, which
    only makes the gate marginally stricter than OpenCV's.
    """
    H, W = img.shape
    blurred = box_blur(img, 5)
    mask = blurred >= threshold * jnp.max(blurred)
    lab = connected_components(mask, cc_iters)

    flat = lab.reshape(-1)
    ys = (jnp.arange(H * W) // W).astype(img.dtype)
    xs = (jnp.arange(H * W) % W).astype(img.dtype)
    on = flat >= 0
    safe = jnp.where(on, flat, 0)

    # boundary-edge count per pixel: 4-neighbors that are off/out-of-bounds
    pad = jnp.pad(mask, 1, constant_values=False)
    nbr_off = (
        (~pad[:-2, 1:-1]).astype(jnp.int32) + (~pad[2:, 1:-1]).astype(jnp.int32)
        + (~pad[1:-1, :-2]).astype(jnp.int32) + (~pad[1:-1, 2:]).astype(jnp.int32)
    ).reshape(-1)

    area = jnp.zeros(H * W, jnp.int32).at[safe].add(jnp.where(on, 1, 0))
    perim = jnp.zeros(H * W, jnp.int32).at[safe].add(jnp.where(on, nbr_off, 0))
    sx = jnp.zeros(H * W, img.dtype).at[safe].add(jnp.where(on, xs, 0.0))
    sy = jnp.zeros(H * W, img.dtype).at[safe].add(jnp.where(on, ys, 0.0))

    circ = (4.0 * jnp.pi) * area / jnp.maximum(perim * perim, 1).astype(img.dtype)
    is_root = (flat == jnp.arange(H * W)) & on
    good = (
        is_root & (area >= min_area) & (area <= max_area)
        & (circ >= min_circularity)
    )

    slot = jnp.cumsum(good) - 1
    K = max_blobs
    tgt = jnp.where(good, slot, K)
    out_area = jnp.zeros(K, jnp.int32).at[tgt].set(area, mode="drop")
    out_x = jnp.zeros(K, img.dtype).at[tgt].set(sx / jnp.maximum(area, 1), mode="drop")
    out_y = jnp.zeros(K, img.dtype).at[tgt].set(sy / jnp.maximum(area, 1), mode="drop")
    out_mask = jnp.zeros(K, bool).at[tgt].set(True, mode="drop")
    return jnp.stack([out_x, out_y], -1), out_area, out_mask


def blobs_to_fls_frame(centroids_px: jnp.ndarray, rows: int, cols: int) -> jnp.ndarray:
    """Keypoint pixels -> FLS-frame pixel coordinates (z=0):
    x' = rows - y - 1, y' = x - cols/2 (``fls_rock_detector.cpp:119-137``)."""
    x, y = centroids_px[..., 0], centroids_px[..., 1]
    return jnp.stack([rows - y - 1.0, x - cols / 2.0, jnp.zeros_like(x)], -1)


# ---------------------------------------------------------------------------
# MBES submap fusion
# ---------------------------------------------------------------------------

def fuse_submap(
    ping_points: jnp.ndarray,  # (P, B, 3) beam points in sensor frame
    ping_mask: jnp.ndarray,    # (P, B)
    rot_map_ping: jnp.ndarray, # (P, 3, 3) map<-sensor rotation per ping
    trans_map_ping: jnp.ndarray,  # (P, 3)
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Fuse a window of pings into the *middle* ping's frame
    (``mbes_mapper/src/mbes_receptor.cpp:64-107``).

    Returns (points (P·B, 3) in mid-ping frame, mask (P·B,)).
    """
    P = ping_points.shape[0]
    mid = P // 2
    pts_map = jnp.einsum("pij,pbj->pbi", rot_map_ping, ping_points) + trans_map_ping[:, None, :]
    r_mid_t = rot_map_ping[mid].T
    pts_mid = jnp.einsum("ij,pbj->pbi", r_mid_t, pts_map - trans_map_ping[mid])
    return pts_mid.reshape(-1, 3), ping_mask.reshape(-1)


def save_pcd(
    path: str,
    points,                # (N, 3) submap points (masked rows dropped)
    mask=None,             # (N,) optional validity mask
    viewpoint_trans=None,  # (3,) submap frame origin in map (sensor_origin_)
    viewpoint_quat=None,   # (4,) xyzw (sensor_orientation_)
) -> int:
    """Persist a fused submap as an ASCII PCD v0.7 file — the reference's
    ``pcl::io::savePCDFileASCII`` dump per submap
    (``mbes_mapper/src/mbes_receptor.cpp:92-106``), including the
    VIEWPOINT header carrying the submap frame's map pose. Host-side.

    Returns the number of points written.
    """
    import os

    import numpy as np

    pts = np.asarray(points, np.float64).reshape(-1, 3)
    if mask is not None:
        pts = pts[np.asarray(mask).reshape(-1)]
    vp_t = [0.0, 0.0, 0.0] if viewpoint_trans is None else list(
        np.asarray(viewpoint_trans, np.float64)
    )
    # PCD VIEWPOINT order is (tx ty tz qw qx qy qz)
    q = [1.0, 0.0, 0.0, 0.0] if viewpoint_quat is None else [
        float(np.asarray(viewpoint_quat)[3]),
        float(np.asarray(viewpoint_quat)[0]),
        float(np.asarray(viewpoint_quat)[1]),
        float(np.asarray(viewpoint_quat)[2]),
    ]
    parent = os.path.dirname(os.path.abspath(path))
    os.makedirs(parent, exist_ok=True)
    n = len(pts)
    header = (
        "# .PCD v0.7 - Point Cloud Data file format\n"
        "VERSION 0.7\nFIELDS x y z\nSIZE 4 4 4\nTYPE F F F\nCOUNT 1 1 1\n"
        f"WIDTH {n}\nHEIGHT 1\n"
        "VIEWPOINT " + " ".join(f"{v:.9g}" for v in (vp_t + q)) + "\n"
        f"POINTS {n}\nDATA ascii\n"
    )
    with open(path, "w") as f:
        f.write(header)
        for x, y, z in pts:
            f.write(f"{x:.9g} {y:.9g} {z:.9g}\n")
    return n
