from arslam.graph.store import (  # noqa: F401
    Block,
    Capture,
    Aruco,
    CameraState,
    MapStore,
)
from arslam.graph.arrays import BlockArrays, export_arrays, bucket_size  # noqa: F401
from arslam.graph.yamlio import load_yaml, save_yaml, dumps_yaml  # noqa: F401
