from arslam.viz.export import camera_info, marker_array, transforms  # noqa: F401
from arslam.viz.annotate import annotate_capture  # noqa: F401
