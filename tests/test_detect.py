"""Detection tests: rendered synthetic tags under homographies with exact
id/corner assertions (SURVEY.md §4), plus demo-image parity against the
OpenCV-oracle fixture."""

import os

import numpy as np
import pytest
import yaml
from PIL import Image

from arslam.detect import detect_markers
from arslam.detect.dictionaries import get_dictionary
from arslam.detect.gen import generate_pages, place_marker, render_marker
from arslam.detect.reference import (
    adaptive_threshold,
    convex_hull,
    decimate_to_quad,
    otsu_threshold,
)

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")


@pytest.mark.parametrize("dict_name,marker_id", [("4X4_50", 7), ("4X4_50", 23),
                                                 ("5X5_100", 42)])
def test_detect_rendered_frontal(dict_name, marker_id):
    marker = render_marker(dict_name, marker_id, 120)
    canvas = np.full((400, 400), 200, dtype=np.uint8)
    quad = np.array([[140, 140], [260, 140], [260, 260], [140, 260]], float)
    place_marker(canvas, marker, quad)
    dets = detect_markers(canvas, dict_names=(dict_name,), refine=False)
    assert len(dets) == 1
    d = dets[0]
    assert d.id == f"aruco_{dict_name}_{marker_id}"
    # corners within 1.5 px of placement, in the same order
    err = np.abs(d.corners - quad).max()
    assert err < 1.5, (d.corners, quad)


@pytest.mark.parametrize("rot90", [1, 2, 3])
def test_detect_rendered_rotated_corner_order(rot90):
    """Rotating the marker image must rotate the reported corner start so
    corner 0 is always the canonical marker top-left."""
    dict_name, marker_id = "4X4_50", 11
    marker = render_marker(dict_name, marker_id, 120)
    marker = np.rot90(marker, rot90).copy()
    canvas = np.full((400, 400), 200, dtype=np.uint8)
    quad = np.array([[140, 140], [260, 140], [260, 260], [140, 260]], float)
    place_marker(canvas, marker, quad)
    dets = detect_markers(canvas, dict_names=(dict_name,), refine=False)
    assert len(dets) == 1
    d = dets[0]
    assert d.id == f"aruco_{dict_name}_{marker_id}"
    # np.rot90 rotates array content CCW in (row, col) space, which appears
    # CLOCKWISE on screen (y down): canonical TL lands at placement corner
    # (4 - k) % 4 (verified against cv::aruco on the demo photos)
    expected_start = quad[(4 - rot90) % 4]
    np.testing.assert_allclose(d.corners[0], expected_start, atol=1.5)


def test_detect_perspective_warp():
    dict_name, marker_id = "4X4_50", 5
    marker = render_marker(dict_name, marker_id, 168)  # 28 px/cell, no pad
    canvas = np.full((480, 640), 180, dtype=np.uint8)
    quad = np.array([[180, 120], [420, 150], [400, 360], [200, 330]], float)
    place_marker(canvas, marker, quad)
    dets = detect_markers(canvas, dict_names=(dict_name,), refine=False)
    assert len(dets) == 1
    assert dets[0].id == f"aruco_{dict_name}_{marker_id}"
    assert np.abs(dets[0].corners - quad).max() < 2.0


def test_detect_multiple_markers_and_dicts():
    canvas = np.full((480, 640), 210, dtype=np.uint8)
    placements = [
        ("4X4_50", 3, np.array([[50, 50], [150, 50], [150, 150], [50, 150]], float)),
        ("4X4_50", 30, np.array([[400, 80], [520, 90], [515, 205], [395, 195]], float)),
        ("5X5_100", 77, np.array([[100, 300], [220, 300], [220, 420], [100, 420]], float)),
    ]
    for dn, mid, quad in placements:
        px = 144 if dn == "4X4_50" else 140  # divisible by cell count
        place_marker(canvas, render_marker(dn, mid, px), quad)
    dets = detect_markers(canvas, dict_names=("4X4_50", "5X5_100"), refine=False)
    got = {d.id for d in dets}
    assert got == {"aruco_4X4_50_3", "aruco_4X4_50_30", "aruco_5X5_100_77"}


def test_no_false_positives_on_noise():
    rng = np.random.default_rng(0)
    canvas = (rng.uniform(0, 255, size=(480, 640))).astype(np.uint8)
    dets = detect_markers(canvas, dict_names=("4X4_50", "5X5_100"))
    assert dets == []


def test_demo_images_match_cv2_oracle():
    """Exact id-set parity with cv::aruco on the real demo photos, corners
    within 2 px."""
    with open(os.path.join(FIXTURES, "demo_detections.yaml")) as f:
        data = yaml.safe_load(f)
    for cap in data["captures"]:
        img = np.asarray(Image.open(cap["img_fn"]).convert("L"))
        dets = detect_markers(img, dict_names=("4X4_50", "5X5_100"))
        ours = {d.id for d in dets}
        oracle = {d["id"] for d in cap["detections"]["4X4_50"]}
        oracle |= {d["id"] for d in cap["detections"]["5X5_100"]}
        assert ours == oracle, (cap["uid"], ours, oracle)
        om = {d["id"]: np.array(d["corners"]).reshape(4, 2)
              for d in cap["detections"]["4X4_50"]}
        size = (cap["width"], cap["height"])
        for d in dets:
            err = np.abs(d.corners_centered(size) - om[d.id]).max()
            assert err < 2.0, (cap["uid"], d.id, err)


def test_generate_pages(tmp_path):
    paths = generate_pages(str(tmp_path), "4X4_50")
    assert len(paths) == 9  # 50 markers / 6 per page
    img = np.asarray(Image.open(paths[0]).convert("L"))
    assert img.shape == (1100, 850)
    dets = detect_markers(img, dict_names=("4X4_50",), refine=False)
    got = sorted(d.marker_id for d in dets)
    assert got == [0, 1, 2, 3, 4, 5]


def test_otsu_threshold_bimodal():
    v = np.concatenate([np.full(50, 20.0), np.full(50, 220.0)])
    t = otsu_threshold(v)
    assert 20 < t < 220


def test_quad_decimation_square():
    pts = np.array([[x, y] for x in range(20) for y in range(20)], float)
    hull = convex_hull(pts)
    quad = decimate_to_quad(hull)
    assert quad is not None
    got = {tuple(p) for p in quad}
    assert got == {(0.0, 0.0), (0.0, 19.0), (19.0, 0.0), (19.0, 19.0)}


def test_adaptive_threshold_marks_dark():
    img = np.full((64, 64), 200.0)
    img[20:40, 20:40] = 30.0
    b = adaptive_threshold(img, win=23, c=7.0)
    assert b[30, 30]
    assert not b[5, 5]


def test_detect_6x6_250_frontal_and_warp():
    """6X6_250 — the third dictionary the reference's aruco_dict accepts
    (aruco_detector.cpp:59-78)."""
    marker = render_marker("6X6_250", 123, 160)  # 20 px/cell
    canvas = np.full((480, 640), 200, dtype=np.uint8)
    quad = np.array([[180, 120], [420, 150], [400, 360], [200, 330]], float)
    place_marker(canvas, marker, quad)
    dets = detect_markers(canvas, dict_names=("6X6_250",), refine=False)
    assert len(dets) == 1
    assert dets[0].id == "aruco_6X6_250_123"
    assert np.abs(dets[0].corners - quad).max() < 2.0


def test_detect_6x6_matches_cv2():
    """Rendered 6x6 markers decode to the same ids as cv::aruco."""
    cv2 = pytest.importorskip("cv2")
    canvas = np.full((480, 640), 210, dtype=np.uint8)
    placements = [
        (17, np.array([[60, 60], [220, 60], [220, 220], [60, 220]], float)),
        (249, np.array([[360, 240], [540, 260], [530, 430], [350, 420]],
                       float)),
    ]
    for mid, quad in placements:
        place_marker(canvas, render_marker("6X6_250", mid, 160), quad)
    dets = detect_markers(canvas, dict_names=("6X6_250",))
    got = sorted(d.id for d in dets)
    d = cv2.aruco.getPredefinedDictionary(cv2.aruco.DICT_6X6_250)
    det = cv2.aruco.ArucoDetector(d, cv2.aruco.DetectorParameters())
    corners, ids, _ = det.detectMarkers(canvas)
    cv_ids = sorted(f"aruco_6X6_250_{int(i)}" for i in np.ravel(ids))
    assert got == cv_ids == ["aruco_6X6_250_17", "aruco_6X6_250_249"]
