"""SO(3) / quaternion / rigid-transform primitives.

This module replaces the reference's use of ``tf::Quaternion`` /
``tf::Matrix3x3`` / ``tf::Transform`` (pervasive, e.g.
``auv_ekf_localization/src/ekf_localization.cpp:360-422``) with pure,
jit/vmap-friendly jnp functions.

Conventions (identical to ROS tf):
  * quaternions are (x, y, z, w)
  * Euler angles are fixed-axis XYZ roll/pitch/yaw (= intrinsic ZYX), i.e.
    ``R = Rz(yaw) @ Ry(pitch) @ Rx(roll)`` — matching
    ``tf::createQuaternionFromRPY`` / ``tf::Matrix3x3::getRPY``.
  * ``wrap_angle`` maps to [-pi, pi). The reference's ``angleLimit``
    (``correspondence_obj.cpp:99-101``) uses C ``fmod`` which fails to wrap
    inputs below -pi; we use floored modulo, which is correct for all inputs
    and agrees with the reference on its operating range (-3pi, pi).

All functions are shape-polymorphic over leading batch dims where noted.
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp

_TWO_PI = 2.0 * jnp.pi


def wrap_angle(a: jnp.ndarray) -> jnp.ndarray:
    """Wrap angle(s) to [-pi, pi). Elementwise."""
    return jnp.mod(a + jnp.pi, _TWO_PI) - jnp.pi


def wrap_rpy(mu: jnp.ndarray) -> jnp.ndarray:
    """Wrap components 3:6 of a 6-DOF pose vector (..., 6)."""
    return mu.at[..., 3:6].set(wrap_angle(mu[..., 3:6]))


# ---------------------------------------------------------------------------
# Rotation matrices
# ---------------------------------------------------------------------------

def rotmat_from_rpy(rpy: jnp.ndarray) -> jnp.ndarray:
    """(..., 3) rpy -> (..., 3, 3) rotation, R = Rz(yaw) Ry(pitch) Rx(roll).

    Same as the reference's ``fullRotation`` (``dr_node.py:260-273``,
    ``auv_particle.py:86-97``).
    """
    r, p, y = rpy[..., 0], rpy[..., 1], rpy[..., 2]
    cr, sr = jnp.cos(r), jnp.sin(r)
    cp, sp = jnp.cos(p), jnp.sin(p)
    cy, sy = jnp.cos(y), jnp.sin(y)
    row0 = jnp.stack([cy * cp, cy * sp * sr - sy * cr, cy * sp * cr + sy * sr], axis=-1)
    row1 = jnp.stack([sy * cp, sy * sp * sr + cy * cr, sy * sp * cr - cy * sr], axis=-1)
    row2 = jnp.stack([-sp, cp * sr, cp * cr], axis=-1)
    return jnp.stack([row0, row1, row2], axis=-2)


def rpy_from_rotmat(R: jnp.ndarray) -> jnp.ndarray:
    """(..., 3, 3) rotation -> (..., 3) roll/pitch/yaw (tf getRPY solution 1).

    Gimbal-safe via clamping of sin(pitch).
    """
    sp = jnp.clip(-R[..., 2, 0], -1.0, 1.0)
    pitch = jnp.arcsin(sp)
    roll = jnp.arctan2(R[..., 2, 1], R[..., 2, 2])
    yaw = jnp.arctan2(R[..., 1, 0], R[..., 0, 0])
    return jnp.stack([roll, pitch, yaw], axis=-1)


# ---------------------------------------------------------------------------
# Quaternions (x, y, z, w)
# ---------------------------------------------------------------------------

def quat_from_rpy(rpy: jnp.ndarray) -> jnp.ndarray:
    """(..., 3) rpy -> (..., 4) xyzw quaternion (tf createQuaternionFromRPY)."""
    hr, hp, hy = rpy[..., 0] * 0.5, rpy[..., 1] * 0.5, rpy[..., 2] * 0.5
    cr, sr = jnp.cos(hr), jnp.sin(hr)
    cp, sp = jnp.cos(hp), jnp.sin(hp)
    cy, sy = jnp.cos(hy), jnp.sin(hy)
    x = sr * cp * cy - cr * sp * sy
    y = cr * sp * cy + sr * cp * sy
    z = cr * cp * sy - sr * sp * cy
    w = cr * cp * cy + sr * sp * sy
    return jnp.stack([x, y, z, w], axis=-1)


def quat_from_rpy_np(rpy):
    """Numpy twin of ``quat_from_rpy`` for host-side preprocessing (timeline
    builders stay on host — see the ops/timeline.py module note)."""
    import numpy as _np

    rpy = _np.asarray(rpy)
    hr, hp, hy = rpy[..., 0] * 0.5, rpy[..., 1] * 0.5, rpy[..., 2] * 0.5
    cr, sr = _np.cos(hr), _np.sin(hr)
    cp, sp = _np.cos(hp), _np.sin(hp)
    cy, sy = _np.cos(hy), _np.sin(hy)
    return _np.stack([
        sr * cp * cy - cr * sp * sy,
        cr * sp * cy + sr * cp * sy,
        cr * cp * sy - sr * sp * cy,
        cr * cp * cy + sr * sp * sy,
    ], axis=-1)


def quat_normalize(q: jnp.ndarray, eps: float = 1e-12) -> jnp.ndarray:
    return q / jnp.sqrt(jnp.sum(q * q, axis=-1, keepdims=True) + eps)


def quat_multiply(q1: jnp.ndarray, q2: jnp.ndarray) -> jnp.ndarray:
    """Hamilton product q1 ⊗ q2 in xyzw (tf quaternion_multiply order)."""
    x1, y1, z1, w1 = q1[..., 0], q1[..., 1], q1[..., 2], q1[..., 3]
    x2, y2, z2, w2 = q2[..., 0], q2[..., 1], q2[..., 2], q2[..., 3]
    return jnp.stack(
        [
            w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
            w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
            w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
            w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
        ],
        axis=-1,
    )


def quat_conjugate(q: jnp.ndarray) -> jnp.ndarray:
    return q * jnp.asarray([-1.0, -1.0, -1.0, 1.0], dtype=q.dtype)


def rotmat_from_quat(q: jnp.ndarray) -> jnp.ndarray:
    """(..., 4) xyzw -> (..., 3, 3). Normalizes internally."""
    q = quat_normalize(q)
    x, y, z, w = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    row0 = jnp.stack([1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy)], axis=-1)
    row1 = jnp.stack([2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx)], axis=-1)
    row2 = jnp.stack([2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy)], axis=-1)
    return jnp.stack([row0, row1, row2], axis=-2)


def quat_from_rotmat(R: jnp.ndarray) -> jnp.ndarray:
    """(3, 3) -> xyzw quaternion (Shepperd's branch-free-ish method).

    Uses the max-trace-component selection expressed with jnp.where so it
    stays jittable; numerically stable for all rotations.
    """
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22

    # Four candidate formulations; pick per-element the best-conditioned one.
    def cand_w():
        s = jnp.sqrt(jnp.maximum(tr + 1.0, 1e-12)) * 2.0
        return jnp.stack([(m21 - m12) / s, (m02 - m20) / s, (m10 - m01) / s, 0.25 * s], -1)

    def cand_x():
        s = jnp.sqrt(jnp.maximum(1.0 + m00 - m11 - m22, 1e-12)) * 2.0
        return jnp.stack([0.25 * s, (m01 + m10) / s, (m02 + m20) / s, (m21 - m12) / s], -1)

    def cand_y():
        s = jnp.sqrt(jnp.maximum(1.0 + m11 - m00 - m22, 1e-12)) * 2.0
        return jnp.stack([(m01 + m10) / s, 0.25 * s, (m12 + m21) / s, (m02 - m20) / s], -1)

    def cand_z():
        s = jnp.sqrt(jnp.maximum(1.0 + m22 - m00 - m11, 1e-12)) * 2.0
        return jnp.stack([(m02 + m20) / s, (m12 + m21) / s, 0.25 * s, (m10 - m01) / s], -1)

    qw, qx, qy, qz = cand_w(), cand_x(), cand_y(), cand_z()
    use_w = tr > 0.0
    use_x = (~use_w) & (m00 >= m11) & (m00 >= m22)
    use_y = (~use_w) & (~use_x) & (m11 >= m22)
    q = jnp.where(use_w[..., None], qw,
                  jnp.where(use_x[..., None], qx,
                            jnp.where(use_y[..., None], qy, qz)))
    return quat_normalize(q)


def rpy_from_quat(q: jnp.ndarray) -> jnp.ndarray:
    """xyzw quaternion -> roll/pitch/yaw (tf euler_from_quaternion)."""
    return rpy_from_rotmat(rotmat_from_quat(q))


def quat_rotate(q: jnp.ndarray, v: jnp.ndarray) -> jnp.ndarray:
    """Rotate vector(s) v (..., 3) by quaternion(s) q (..., 4)."""
    return jnp.einsum("...ij,...j->...i", rotmat_from_quat(q), v)


# ---------------------------------------------------------------------------
# Rigid transforms (replaces tf::Transform and the tf tree)
# ---------------------------------------------------------------------------

class Transform(NamedTuple):
    """Rigid transform: x_parent = rot @ x_child + trans.

    Stored as (rotation matrix, translation) for cheap composition inside
    filters. Leading batch dims are allowed on both fields.
    """

    rot: jnp.ndarray    # (..., 3, 3)
    trans: jnp.ndarray  # (..., 3)

    def apply(self, v: jnp.ndarray) -> jnp.ndarray:
        return jnp.einsum("...ij,...j->...i", self.rot, v) + self.trans

    def rotate(self, v: jnp.ndarray) -> jnp.ndarray:
        """Apply only the rotation (tf's getBasis() * v)."""
        return jnp.einsum("...ij,...j->...i", self.rot, v)

    def compose(self, other: "Transform") -> "Transform":
        """self ∘ other: (self.compose(other)).apply(x) == self.apply(other.apply(x))."""
        return Transform(
            rot=jnp.einsum("...ij,...jk->...ik", self.rot, other.rot),
            trans=self.apply(other.trans),
        )

    def inverse(self) -> "Transform":
        rot_t = jnp.swapaxes(self.rot, -1, -2)
        return Transform(rot=rot_t, trans=-jnp.einsum("...ij,...j->...i", rot_t, self.trans))

    @staticmethod
    def identity(dtype=jnp.float32) -> "Transform":
        return Transform(rot=jnp.eye(3, dtype=dtype), trans=jnp.zeros(3, dtype=dtype))

    @staticmethod
    def from_rpy_trans(rpy: jnp.ndarray, trans: jnp.ndarray) -> "Transform":
        return Transform(rot=rotmat_from_rpy(rpy), trans=jnp.asarray(trans))

    @staticmethod
    def from_quat_trans(q: jnp.ndarray, trans: jnp.ndarray) -> "Transform":
        return Transform(rot=rotmat_from_quat(q), trans=jnp.asarray(trans))

    @staticmethod
    def from_pose(mu: jnp.ndarray) -> "Transform":
        """6-DOF pose vector (x,y,z,roll,pitch,yaw) -> map<-base transform.

        Equivalent to the reference's
        ``tf::Transform(createQuaternionFromRPY(mu(3..5)), Vector3(mu(0..2)))``
        (``ekf_slam_core.cpp:214-216``).
        """
        return Transform(rot=rotmat_from_rpy(mu[..., 3:6]), trans=mu[..., 0:3])


# ---------------------------------------------------------------------------
# Static frame graph (replaces the tf tree lookups done at node init)
# ---------------------------------------------------------------------------

class FrameGraph:
    """Static rigid-frame registry.

    The reference blocks on tf lookups at init (base<-dvl/fls/sss extrinsics,
    world<-odom, utm<-map: ``ekf_localization.cpp:138-161``,
    ``ekf_slam.cpp:110-128``) and treats them as constant afterwards. Here
    frames are registered once on the host; ``get(a, b)`` returns the constant
    Transform taking b-frame vectors into a-frame, composed along the tree.
    """

    def __init__(self):
        self._edges = {}  # (parent, child) -> Transform
        self._parent = {}  # child -> parent

    def add(self, parent: str, child: str, tf: Transform) -> None:
        if child in self._parent and self._parent[child] != parent:
            raise ValueError(f"frame {child!r} already has parent {self._parent[child]!r}")
        self._edges[(parent, child)] = tf
        self._parent[child] = parent

    def _path_to_root(self, frame: str):
        path = [frame]
        while path[-1] in self._parent:
            path.append(self._parent[path[-1]])
        return path

    def get(self, target: str, source: str) -> Transform:
        """Transform taking source-frame vectors into target frame."""
        up_t = self._path_to_root(target)
        up_s = self._path_to_root(source)
        common = None
        up_t_set = set(up_t)
        for f in up_s:
            if f in up_t_set:
                common = f
                break
        if common is None:
            raise KeyError(f"no path between frames {target!r} and {source!r}")

        def chain_to(frame, stop):
            tf = Transform.identity()
            f = frame
            while f != stop:
                p = self._parent[f]
                tf = self._edges[(p, f)].compose(tf)
                f = p
            return tf

        t_common_source = chain_to(source, common)
        t_common_target = chain_to(target, common)
        return t_common_target.inverse().compose(t_common_source)
