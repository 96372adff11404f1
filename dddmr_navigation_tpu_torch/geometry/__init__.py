from dddmr_navigation_tpu_torch.geometry.se3 import (
    quat_multiply,
    quat_conjugate,
    quat_rotate,
    quat_from_axis_angle,
    quat_from_rpy,
    quat_from_yaw,
    yaw_from_quat,
    normalize_angle,
    slope_aware_quat,
    quat_rotate_fma,
)
