"""Localization tests (≙ ar_loc flow, ar_slam_util.cpp:888-979): build the
demo map from img1-3, localize img4 against it with frozen map/camera."""

import os

import numpy as np
import pytest
import yaml

from arslam.config import ArSlamConfig
from arslam.graph import MapStore
from arslam.solve import localize_many, solve_batch
from arslam.utils.synthetic import make_synthetic_map

from test_lm import load_demo_store

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")


def add_fixture_capture(store, uid, dicts=("4X4_50",)):
    with open(os.path.join(FIXTURES, "demo_detections.yaml")) as f:
        data = yaml.safe_load(f)
    for cap in data["captures"]:
        if cap["uid"] != uid:
            continue
        dets = []
        for d in dicts:
            for det in cap["detections"][d]:
                dets.append((det["id"], np.array(det["corners"]).reshape(4, 2)))
        return store.add_detections(
            cap["uid"], dets, (cap["width"], cap["height"]), cap["img_fn"]
        )
    raise KeyError(uid)


def test_localize_img4_against_demo_map():
    store = load_demo_store()  # img1-3
    solve_batch(store, ArSlamConfig())
    first_loc = store.next_capture_index
    cam_before = store.camera.params.copy()
    tags_before = [t.pose.copy() for t in store.arucos]

    add_fixture_capture(store, "cap_3")  # img4: 3 visible tags
    result = localize_many(store, first_loc)

    assert result["localized"] == 1
    assert result["status"]["cap_3"] == "localized"
    # pose-only: map must be untouched
    np.testing.assert_array_equal(store.camera.params, cam_before)
    for tag, before in zip(store.arucos, tags_before):
        np.testing.assert_array_equal(tag.pose, before)
    # img4 shares real tags; RMSE should be small (sub-2px at the optimum)
    assert result["rmse"] < 2.0, result
    # and the pose is behind the tags (negative-z camera position above map)
    pose = store.captures[first_loc].inv_pose
    assert np.linalg.norm(pose[0:3]) > 0.1


def test_localize_disconnected_capture_skipped():
    store = load_demo_store()
    solve_batch(store, ArSlamConfig())
    first_loc = store.next_capture_index
    # a capture observing only unknown tags
    store.add_detections(
        "stranger",
        [("aruco_4X4_50_49", np.array([[-10, -10], [10, -10], [10, 10], [-10, 10]], float))],
        store.camera.size,
    )
    result = localize_many(store, first_loc)
    assert result["localized"] == 0
    assert result["status"]["stranger"] == "disconnected"


def test_localize_many_synthetic_batch():
    """Many queries in one vmapped device call recover ground-truth poses."""
    store, truth = make_synthetic_map(n_tags=12, n_caps=10, seed=8)
    # rebuild as: map = captures 0-5 solved, queries = the rest localized
    map_store = MapStore(initial_focal=3000.0)
    map_store.camera.size = store.camera.size
    query_caps = []
    for cap in store.captures:
        dets = [
            (store.arucos[store.blocks[bh].tag_idx].id, store.blocks[bh].corners)
            for bh in cap.blocks
        ]
        if int(cap.uid.split("_")[1]) < 6:
            map_store.add_detections(cap.uid, dets, store.camera.size)
        else:
            query_caps.append((cap.uid, dets))
    solve_batch(map_store, ArSlamConfig())
    first_loc = map_store.next_capture_index
    for uid, dets in query_caps:
        map_store.add_detections(uid, dets, map_store.camera.size)
    result = localize_many(map_store, first_loc)
    assert result["localized"] == len(query_caps)
    assert result["rmse"] < 0.5, result


def test_localize_reports_per_query_iterations():
    store = load_demo_store()
    solve_batch(store, ArSlamConfig())
    first_loc = store.next_capture_index
    add_fixture_capture(store, "cap_3")
    result = localize_many(store, first_loc)
    iters = result["iterations"]
    assert set(iters) == {"cap_3"}
    # converged well before the 50-iteration budget (the convergence
    # battery — param tolerance + stall-lambda — must actually fire)
    assert 1 <= iters["cap_3"] < 50, iters


def test_localize_unknown_tags_parity_switch():
    """--parity restores the reference's localizeOne semantics: blocks for
    map-UNKNOWN tags are added with their constant (zero) store poses
    (ar_slam_util.cpp:950-972), degrading the solve; the default excludes
    them (documented divergence)."""
    import dataclasses

    def build():
        store = load_demo_store()
        solve_batch(store, ArSlamConfig())
        first = store.next_capture_index
        cap_idx = add_fixture_capture(store, "cap_3")
        # add an observation of a tag the map has never seen: under parity
        # it joins the residual set at pose zero
        tag = store.get_or_add_aruco("aruco_4X4_50_49")
        store.add_block(
            np.array([[-60, -60], [-20, -60], [-20, -20], [-60, -20]],
                     float),
            cap_idx, tag.index,
        )
        return store, first

    s1, f1 = build()
    r_default = localize_many(s1, f1)
    s2, f2 = build()
    cfg_parity = ArSlamConfig()
    cfg_parity = dataclasses.replace(
        cfg_parity, solver=dataclasses.replace(
            cfg_parity.solver, localize_unknown_tags=True))
    r_parity = localize_many(s2, f2, cfg_parity)

    assert r_default["localized"] == r_parity["localized"] == 1
    # default ignores the junk observation entirely -> clean residual
    assert r_default["rmse"] < 2.0, r_default
    # parity includes the zero-pose tag's 8 residuals -> far larger cost
    assert r_parity["cost"] > 10.0 * max(r_default["cost"], 1e-9), (
        r_default, r_parity)
    # and the recovered poses differ (the junk block pulls the solve)
    assert not np.allclose(s1.captures[f1].inv_pose,
                           s2.captures[f2].inv_pose)


def test_localize_kernel_matches_f64_anchor():
    """The f32 vmapped pose-only kernel lands on the INDEPENDENT f64 scipy
    optimum (tools/cpu_anchor.py --mode localize): anchors localization
    accuracy against a non-self-referential solver, the stand-in for the
    reference's f64 Ceres pose-only solve (ar_slam_util.cpp:888-979).
    Measured round 5: the demo img4 query's ~1.6-1.9 px rmse is the
    query's genuine noise floor (3 map-known blocks, one occluded tag) —
    the f64 anchor reproduces it to 6 decimal places from both the
    kernel's answer and a perturbed seed."""
    import importlib.util
    import sys

    tools = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "tools")
    spec = importlib.util.spec_from_file_location(
        "cpu_anchor", os.path.join(tools, "cpu_anchor.py"))
    cpu_anchor = importlib.util.module_from_spec(spec)
    sys.modules["cpu_anchor"] = cpu_anchor
    spec.loader.exec_module(cpu_anchor)

    store = load_demo_store()  # img1-3
    solve_batch(store, ArSlamConfig(), dtype=np.float32)
    first = store.next_capture_index
    add_fixture_capture(store, "cap_3")
    result = localize_many(store, first, ArSlamConfig(), dtype=np.float32)
    kernel_rmse = float(result["rmse"])
    kernel_pose = np.asarray(store.captures[first].inv_pose, np.float64)

    # identical query, f64 scipy, frozen tags + camera
    tag_poses = np.stack([t.pose for t in store.arucos])
    q_blocks = [store.blocks[bh] for bh in store.captures[first].blocks
                if any(store.blocks[b2].cap_idx < first
                       for b2 in store.arucos[store.blocks[bh].tag_idx]
                       .blocks)]
    ti = np.array([b.tag_idx for b in q_blocks])
    crn = np.stack([b.corners for b in q_blocks])
    pose_f64, _, rmse_f64 = cpu_anchor.solve_pose_only_scipy(
        store.camera.params, tag_poses, ti, crn, kernel_pose)
    # re-solve from a perturbed seed: same optimum => genuine basin
    pose_p, _, rmse_p = cpu_anchor.solve_pose_only_scipy(
        store.camera.params, tag_poses, ti, crn,
        kernel_pose + np.array([0.05, -0.05, 0.1, 0.02, -0.02, 0.03]))

    assert abs(kernel_rmse - rmse_f64) < 0.02, (kernel_rmse, rmse_f64)
    assert np.abs(kernel_pose - pose_f64).max() < 1e-3
    assert np.abs(pose_f64 - pose_p).max() < 1e-6, "anchor found a saddle"
    assert abs(rmse_f64 - rmse_p) < 1e-6
