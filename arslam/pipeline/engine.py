"""The mapping engine: detection ingestion + incremental solve + artifacts.

≙ the ArSlam node (ar_slam.cpp): consume merged detections, run incremental
BA, export transforms/camera-info/markers, save the map on shutdown
(ar_slam.cpp:103-111).  Plus the batch flows of the CLIs (ar_slam_cli.cpp,
ar_loc.cpp) and the event-log recorder (≙ BagRecorder, bag_recorder.cpp —
jsonl instead of a rosbag).
"""

from __future__ import annotations

import json
import logging
import os
import time

import numpy as np

from arslam.config import ArSlamConfig
from arslam.graph import MapStore, load_yaml, save_yaml
from arslam.pipeline.ingest import ImageIngest

logger = logging.getLogger(__name__)


def _encode_png_b64(image) -> str:
    """Grayscale (H, W) uint8 -> base64 PNG string (hermetic log record)."""
    import base64
    import io

    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(image, mode="L").save(buf, format="PNG")
    return base64.b64encode(buf.getvalue()).decode("ascii")


def decode_png_b64(data: str):
    """Inverse of _encode_png_b64 (used by ``arslam replay``)."""
    import base64
    import io

    import numpy as np
    from PIL import Image

    return np.asarray(Image.open(io.BytesIO(base64.b64decode(data)))
                      .convert("L"))


class EventLog:
    """Append-only jsonl event recorder (≙ BagRecorder's /tmp/ar_slam.bag):
    captures and merged detections, replayable into a new engine."""

    def __init__(self, path: str):
        self.path = path
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self._f = open(path, "a")

    def record(self, kind: str, **payload):
        rec = {"t": time.time(), "kind": kind, **payload}
        self._f.write(json.dumps(rec) + "\n")
        self._f.flush()

    def close(self):
        self._f.close()

    @staticmethod
    def replay(path: str):
        with open(path) as f:
            for line in f:
                if line.strip():
                    yield json.loads(line)


class ArSlamEngine:
    """Incremental mapping engine with a device-batched detection front end."""

    def __init__(self, config: ArSlamConfig | None = None,
                 use_device_detector: bool = True, detect_mesh=None):
        from arslam.utils.metrics import Metrics

        self.config = config or ArSlamConfig()
        self.store = MapStore(initial_focal=self.config.camera.initial_focal)
        self.ingest = ImageIngest()
        self.use_device_detector = use_device_detector
        # optional 1-D jax Mesh: data-parallel detection over the image
        # axis (parallel/detect.detect_batch_sharded — detection is
        # embarrassingly data-parallel, zero collectives)
        self.detect_mesh = detect_mesh
        self.metrics = Metrics()
        self.event_log = None
        if self.config.pipeline.event_log_path:
            self.event_log = EventLog(self.config.pipeline.event_log_path)

    # ---- restore ---------------------------------------------------------

    def load_map(self, path: str):
        load_yaml(self.store, path)
        logger.info("loaded map %s: %s", path, self.store.stats())

    # ---- detection front end --------------------------------------------

    def detect_images(self, paths: list[str]) -> list[tuple[str, list, tuple, str]]:
        """Ingest + detect a batch of images (sequential mode).

        Returns [(uid, [(tag_id, centered_corners(4,2)), ...], (w, h), path)].
        """
        with self.metrics.timer("ingest"):
            caps = self.ingest.ingest_many(paths)
        return [
            (uid, [d for dets in by_dict.values() for d in dets], size, path)
            for uid, by_dict, size, path in self.detect_decoded(caps)
        ]

    def detect_decoded(self, caps) -> list[tuple[str, dict, tuple, str]]:
        """Detect over already-ingested captures, keeping each dictionary's
        detections separate (the pipelined mode feeds them to the merge
        stage as distinct detector streams, ≙ the two ArucoDetector
        components running on the same image, ar_slam_launch.py:75-95).

        Returns [(uid, {"aruco_<dict>": [(tag_id, corners), ...]}, (w, h),
        path)].
        """
        if not caps:
            return []
        images = np.stack([c.image for c in caps])
        h, w = images.shape[1:]
        dict_names = tuple(self.config.detect.dictionaries)
        # optional working resolution: detect on a downscaled copy, report
        # corners in full-resolution centered coordinates (graph/solver
        # always see the true sensor geometry)
        max_side = self.config.detect.max_side
        scale = 1.0
        if max_side and max(h, w) > max_side:
            scale = max_side / max(h, w)
            from PIL import Image as _Image

            small = [
                np.asarray(_Image.fromarray(img).resize(
                    (int(round(w * scale)), int(round(h * scale))),
                    _Image.BILINEAR))
                for img in images
            ]
            det_images = np.stack(small)
            logger.info("detection at %dx%d (scale %.3f) for %dx%d input",
                        det_images.shape[2], det_images.shape[1], scale, w, h)
        else:
            det_images = images
        with self.metrics.timer("detect"):
            per_image = self._run_detector(det_images, dict_names)
        if scale != 1.0:
            per_image = [
                {dt: [(tid, corners / scale) for tid, corners in dets]
                 for dt, dets in by_dict.items()}
                for by_dict in per_image
            ]
        self.metrics.count("images_detected", len(caps))
        self.metrics.count(
            "detections",
            sum(len(d) for bd in per_image for d in bd.values())
        )
        out = []
        for i, cap in enumerate(caps):
            by_dict = per_image[i]
            flat = [d for dets in by_dict.values() for d in dets]
            if len(flat) <= 2:
                logger.warning("not enough AR tags detected in %s (%d)",
                               cap.path, len(flat))
            out.append((cap.uid, by_dict, (w, h), cap.path))
            if self.event_log:
                # ≙ BagRecorder's captures stream (bag_recorder.cpp:73-83):
                # the raw-capture record (path; pixels too when
                # event_log_embed_images — hermetic, replayable without
                # the originals) + detections
                extra = {}
                if self.config.pipeline.event_log_embed_images:
                    extra["image_png"] = _encode_png_b64(cap.image)
                self.event_log.record(
                    "capture", uid=cap.uid, path=cap.path, width=w, height=h,
                    **extra,
                )
                self.event_log.record(
                    "detections", uid=cap.uid, path=cap.path,
                    width=w, height=h,
                    detections=[
                        {"id": tid, "corners": c.reshape(-1).tolist()}
                        for tid, c in flat
                    ],
                )
        return out

    def _run_detector(self, images, dict_names):
        """Returns one dict per image: {"aruco_<dict>": [(tag_id,
        centered_corners), ...]} (keys only for dictionaries that fired
        the detector — all of ``dict_names``)."""
        h, w = images.shape[1:]
        center = np.array([w / 2.0, h / 2.0])
        per_image = [{f"aruco_{n}": [] for n in dict_names}
                     for _ in range(len(images))]
        if self.use_device_detector:
            import jax.numpy as jnp

            from arslam.detect.device_detect import (
                detect_batch, params_from_config)

            params = params_from_config(self.config.detect)
            # pad the batch to a power-of-two bucket: each distinct batch
            # size is a separate compile, and a serve loop sees arbitrary
            # sizes
            n = len(images)
            n_pad = 1
            while n_pad < n:
                n_pad *= 2
            if n_pad > n:
                pad = np.zeros((n_pad - n, *images.shape[1:]),
                               dtype=images.dtype)
                images = np.concatenate([images, pad])
            if self.detect_mesh is not None:
                from arslam.parallel.detect import detect_batch_sharded

                out = detect_batch_sharded(
                    jnp.asarray(images), mesh=self.detect_mesh,
                    params=params, dict_names=dict_names)
            else:
                out = detect_batch(jnp.asarray(images), params=params,
                                   dict_names=dict_names)
            for name in dict_names:
                ids = np.asarray(out[name]["ids"])
                corners = np.asarray(out[name]["corners"])
                valid = np.asarray(out[name]["valid"])
                for i in range(len(per_image)):
                    for k in np.nonzero(valid[i])[0]:
                        per_image[i][f"aruco_{name}"].append(
                            (f"aruco_{name}_{int(ids[i][k])}",
                             corners[i][k] - center)
                        )
        else:
            from arslam.detect.reference import detect_markers

            for i, img in enumerate(images):
                for d in detect_markers(img, dict_names=dict_names):
                    # d.id = "aruco_<dict>_<n>" -> detector stream key
                    det_type = d.id.rsplit("_", 1)[0]
                    per_image[i].setdefault(det_type, []).append(
                        (d.id, d.corners - center))
        return per_image

    # ---- mapping flows ---------------------------------------------------

    def add_images(self, paths: list[str]) -> list[int]:
        """Detect + add captures to the graph (unsolved pool)."""
        added = []
        for uid, dets, size, path in self.detect_images(paths):
            idx = self.store.add_detections(uid, dets, size, path)
            if idx is not None:
                added.append(idx)
        return added

    def solve(self) -> dict:
        """Batch BFS solve (≙ ar_slam_cli)."""
        from arslam.solve import solve_batch
        from arslam.utils.metrics import profile_trace

        with self.metrics.timer("solve"), \
                profile_trace(self.config.pipeline.profile_trace_dir):
            out = solve_batch(self.store, self.config)
        self.metrics.count("captures_solved", out.get("waves", 0))
        self._maybe_snapshot()
        return out

    def solve_incremental(self) -> dict:
        """Incremental solve (≙ ArSlam::detection_callback path)."""
        from arslam.solve import solve_incremental
        from arslam.utils.metrics import profile_trace

        with self.metrics.timer("solve_incremental"), \
                profile_trace(self.config.pipeline.profile_trace_dir):
            out = solve_incremental(self.store, self.config)
        self.metrics.count("captures_solved", out.get("waves", 0))
        self._maybe_snapshot()
        return out

    def _maybe_snapshot(self):
        """Periodic durable checkpoint during long solves (orbax-style
        cadence; the map.yaml IS the checkpoint format, SURVEY.md §5.4)."""
        p = self.config.pipeline
        if not p.output_map_fn or p.snapshot_every_s <= 0:
            return
        now = time.time()
        last = getattr(self, "_last_snapshot", 0.0)
        if now - last >= p.snapshot_every_s:
            self._last_snapshot = now
            self.save_map(p.output_map_fn)

    def localize(self, paths: list[str]) -> dict:
        """Localize new images against the frozen current map (≙ ar_loc)."""
        from arslam.solve import localize_many

        first = self.store.next_capture_index
        self.add_images(paths)
        return localize_many(self.store, first, self.config)

    # ---- artifacts -------------------------------------------------------

    def save_map(self, path: str):
        save_yaml(self.store, path)
        logger.info("saved map to %s", path)

    def print_cameras(self):
        p = self.store.camera.params
        print(f"\tf={p[0]}\tl1={p[1]}\tl1={p[2]}")

    def export_artifacts(self) -> dict:
        from arslam.viz.export import (
            camera_info, marker_array, transforms,
        )

        return {
            "transforms": transforms(self.store),
            "camera_info": camera_info(self.store),
            "markers": marker_array(self.store, self.config.aruco_size),
        }

    def close(self):
        if self.event_log:
            self.event_log.close()
