"""arslam — an accelerator-resident AR-tag SLAM engine.

A from-scratch JAX/XLA re-design of the capabilities of the reference
``dbking77/ar_slam`` ROS 2 package (structure-from-motion over a bipartite
capture–tag constraint graph with shared camera intrinsics):

- ``arslam.core``    — geometry, camera model, reprojection residuals (pure jnp)
- ``arslam.graph``   — host-side constraint-graph store + map.yaml checkpoint IO
- ``arslam.solve``   — Levenberg–Marquardt with Schur elimination of tag blocks
- ``arslam.detect``  — batched Aruco detection (NumPy oracle + batched XLA detector)
- ``arslam.parallel``— multi-chip/multi-host distributed bundle adjustment
- ``arslam.pipeline``— async ingest → detect → merge → incremental-solve pipeline
- ``arslam.viz``     — headless debug annotation + pose/intrinsics artifact export
"""

__version__ = "0.1.0"

from arslam.config import ArSlamConfig  # noqa: F401
