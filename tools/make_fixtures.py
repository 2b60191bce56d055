"""Generate test fixtures: Aruco detections for the demo images using
OpenCV's detector as an independent oracle (test-only — the engine's own
detector lives in arslam.detect).

Writes tests/fixtures/demo_detections.yaml with centered-coordinate corners
for both dictionaries, replicating the reference's detector settings
(minCornerDistanceRate=0.1, ar_slam_util.cpp:249-252; per-dictionary ids
aruco_<dict>_<n>, aruco_detector.cpp:122-131).
"""

import os
import sys

import cv2
import cv2.aruco as aruco
import numpy as np
import yaml

IMAGES = ["img1.jpg", "img2.jpg", "img3.jpg", "img4.jpg"]
SRC = "/root/reference/ar_slam/resources/images"
DICTS = {
    "4X4_50": aruco.DICT_4X4_50,
    "5X5_100": aruco.DICT_5X5_100,
}


def detect(img, dict_name, min_corner_rate=0.1):
    d = aruco.getPredefinedDictionary(DICTS[dict_name])
    params = aruco.DetectorParameters()
    params.minCornerDistanceRate = min_corner_rate
    det = aruco.ArucoDetector(d, params)
    rects, ids, _ = det.detectMarkers(img)
    out = []
    if ids is None:
        return out
    h, w = img.shape[:2]
    for rect, tag_id in zip(rects, ids.reshape(-1)):
        corners = rect.reshape(4, 2).astype(float)
        centered = corners - np.array([w / 2.0, h / 2.0])
        out.append(
            {
                "id": f"aruco_{dict_name}_{int(tag_id)}",
                "corners": [round(float(v), 6) for v in centered.reshape(-1)],
            }
        )
    return out


def main():
    out = {"captures": []}
    for i, name in enumerate(IMAGES):
        img = cv2.imread(os.path.join(SRC, name))
        h, w = img.shape[:2]
        entry = {
            "uid": f"cap_{i}",
            "img_fn": os.path.join(SRC, name),
            "width": int(w),
            "height": int(h),
            "detections": {},
        }
        for dict_name in DICTS:
            entry["detections"][dict_name] = detect(img, dict_name)
        out["captures"].append(entry)
        print(
            name,
            {k: [d["id"] for d in v] for k, v in entry["detections"].items()},
        )
    dst = os.path.join(os.path.dirname(__file__), "..", "tests", "fixtures")
    os.makedirs(dst, exist_ok=True)
    with open(os.path.join(dst, "demo_detections.yaml"), "w") as f:
        yaml.safe_dump(out, f, sort_keys=False)
    print("wrote", os.path.join(dst, "demo_detections.yaml"))


if __name__ == "__main__":
    sys.exit(main())
