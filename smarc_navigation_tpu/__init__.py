"""smarc_navigation_tpu — JAX/XLA AUV navigation / estimation framework.

A ground-up JAX/XLA re-design of the capabilities of
``smarc-project/smarc_navigation`` (ROS1 sensor-fusion stack for the SMARC
underwater vehicles): dead-reckoning from IMU+DVL+pressure, 6-DOF EKF
localization against a known landmark map, online EKF-SLAM with MBES/FLS
sonar landmark detection, and a GPS-weighted Monte-Carlo particle filter.

Instead of a ROS node graph exchanging messages at 10-100 Hz, the whole
mission is compiled into one XLA program: a time-sorted, padded *sensor
timeline* is folded through jitted filter step functions with
``jax.lax.scan``; particle banks are ``vmap``-ed; fleets of missions are
sharded over a device mesh with ``shard_map``.

Layout (layer map mirrors SURVEY.md §1):
  utils/     geometry (SO(3)/quaternions/frames), geodesy (UTM/NED), linalg
  ops/       timeline, Bézier interpolation, 1-D KF, resampling, assignment,
             sonar perception kernels
  models/    dead_reckoning, ekf_localization, ekf_slam, particle_filter,
             sam motion model
  parallel/  device mesh + fleet scaling (mission × particle axes)
  io/        synthetic mission simulator, replay driver, metrics
"""

__version__ = "0.1.0"

# Filter covariance algebra is numerically delicate: at default precision
# an f32 matmul on an NVIDIA GPU may run on the tensor cores in TF32 (a
# 10-bit mantissa, about 3 significant digits), which is catastrophic for
# Σ updates (~1e-3 relative error per step, compounding over 10^5-step
# missions). Force full f32 matmul precision package-wide; the matrices
# involved are tiny (6..774 wide), and the big fleet paths (particle banks)
# are elementwise-dominated.
import jax as _jax

_jax.config.update("jax_default_matmul_precision", "highest")
