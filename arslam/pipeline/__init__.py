from arslam.pipeline.ingest import ImageIngest, load_image  # noqa: F401
from arslam.pipeline.merge import MergeDetections  # noqa: F401
from arslam.pipeline.engine import ArSlamEngine  # noqa: F401
