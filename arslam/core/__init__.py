from arslam.core.lie import (  # noqa: F401
    axis_angle_rotate,
    axis_angle_to_quaternion,
    compose_axis_angle,
    invert_axis_angle,
    normalize_angle,
    quaternion_product,
    quaternion_to_axis_angle,
)
from arslam.core.projection import (  # noqa: F401
    ARUCO_DIRECTIONS,
    block_residual,
    project_corners,
    reprojection_residuals,
)
from arslam.core.seeding import (  # noqa: F401
    calc_init_values,
    init_ar_pose,
    init_capture_pose,
)
