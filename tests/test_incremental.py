"""Incremental map extension (BASELINE config #3): sequential detection
batches growing one connected graph, solver state persisting between calls,
and disconnected captures parked until a connecting tag arrives."""

import pytest
import numpy as np

from arslam.config import ArSlamConfig
from arslam.graph import MapStore
from arslam.solve import solve_incremental
from arslam.utils.synthetic import make_synthetic_map


def detections_of(store, cap):
    return [
        (store.arucos[store.blocks[bh].tag_idx].id, store.blocks[bh].corners)
        for bh in cap.blocks
    ]


@pytest.mark.slow
def test_incremental_growth_matches_connectivity():
    src, _ = make_synthetic_map(n_tags=12, n_caps=8, seed=10)
    dst = MapStore()
    dst.camera.size = src.camera.size
    cfg = ArSlamConfig()

    # batch 1: captures 0-2
    for cap in src.captures[:3]:
        dst.add_detections(cap.uid, detections_of(src, cap), src.camera.size)
    s1 = solve_incremental(dst, cfg)
    assert s1["waves"] == 3
    assert s1["unsolved"] == 0
    assert s1["rmse"] < 1.0

    # batch 2: three more captures, incremental extension
    for cap in src.captures[3:6]:
        dst.add_detections(cap.uid, detections_of(src, cap), src.camera.size)
    s2 = solve_incremental(dst, cfg)
    assert s2["waves"] == 3
    assert s2["unsolved"] == 0
    assert s2["rmse"] < 1.0


@pytest.mark.slow
def test_incremental_parks_disconnected_captures():
    src, _ = make_synthetic_map(n_tags=12, n_caps=6, seed=11)
    dst = MapStore()
    dst.camera.size = src.camera.size
    cfg = ArSlamConfig()

    # first solve the first capture's component
    dst.add_detections(src.captures[0].uid, detections_of(src, src.captures[0]),
                       src.camera.size)
    solve_incremental(dst, cfg)

    # a capture observing only unknown tags stays unsolved
    stranger_dets = [("aruco_4X4_50_49",
                      np.array([[-40, -40], [40, -40], [40, 40], [-40, 40]],
                               float))]
    dst.add_detections("stranger", stranger_dets, src.camera.size)
    s = solve_incremental(dst, cfg)
    assert s["unsolved"] == 1
    assert "stranger" in {dst.captures[i].uid for i in dst.unsolved_captures}

    # once a connecting capture arrives that shares the stranger's tag AND a
    # map tag, both solve
    bridge_dets = detections_of(src, src.captures[1]) + stranger_dets
    dst.add_detections("bridge", bridge_dets, src.camera.size)
    s = solve_incremental(dst, cfg)
    assert s["unsolved"] == 0


@pytest.mark.slow
def test_optimize_every_batches_waves():
    """solver.optimize_every=3: seed-only waves run zero LM iterations in
    the same compiled program; the final map quality matches the per-wave
    (reference-parity) schedule."""
    import dataclasses

    from arslam.solve.batch import solve

    def run(every):
        store, _ = make_synthetic_map(n_tags=12, n_caps=6, seed=11,
                                      noise_px=0.3)
        cfg = ArSlamConfig()
        cfg = dataclasses.replace(
            cfg, solver=dataclasses.replace(
                cfg.solver, dtype="float64", optimize_every=every))
        out = solve(store, cfg)
        return out

    out1 = run(1)
    out3 = run(3)
    assert out1["waves"] == out3["waves"] == 6
    # both schedules land in the same optimum basin
    assert out3["rmse"] < max(2.5 * out1["rmse"], 0.5)


@pytest.mark.slow
def test_engine_map_6x6_scene(tmp_path):
    """Full engine flow on a rendered 6X6_250 scene: detect -> map ->
    map.yaml with 6x6 tag ids (the third reference aruco_dict option,
    end to end)."""
    import dataclasses

    from PIL import Image

    from arslam.config import ArSlamConfig
    from arslam.detect.gen import render_marker
    from arslam.graph import MapStore, load_yaml
    from arslam.pipeline.engine import ArSlamEngine
    from arslam.detect.gen import place_marker

    rng = np.random.default_rng(5)
    # 3 views of 4 tags in a row; camera shifts between views
    tag_quads = {
        tid: np.array([[60 + i * 150, 180], [170 + i * 150, 180],
                       [170 + i * 150, 290], [60 + i * 150, 290]], float)
        for i, tid in enumerate((3, 57, 120, 201))
    }
    paths = []
    for v in range(3):
        canvas = np.full((480, 700), 205, dtype=np.uint8)
        shift = np.array([v * 18.0, v * 7.0])
        for tid, quad in tag_quads.items():
            q = quad - shift + rng.uniform(-1, 1, size=(4, 2))
            if q.min() < 2 or q[:, 0].max() > 698 or q[:, 1].max() > 478:
                continue
            place_marker(canvas, render_marker("6X6_250", tid, 160), q)
        p = tmp_path / f"view{v}.png"
        Image.fromarray(canvas).save(p)
        paths.append(str(p))

    cfg = ArSlamConfig()
    cfg = dataclasses.replace(
        cfg, detect=dataclasses.replace(cfg.detect,
                                        dictionaries=("6X6_250",)))
    engine = ArSlamEngine(config=cfg, use_device_detector=False)
    engine.add_images(paths)
    summary = engine.solve()
    out = tmp_path / "map6.yaml"
    engine.save_map(str(out))
    store = MapStore()
    load_yaml(store, str(out))
    ids = {t.id for t in store.arucos}
    assert {"aruco_6X6_250_3", "aruco_6X6_250_57",
            "aruco_6X6_250_120", "aruco_6X6_250_201"} <= ids
    assert summary["rmse"] < 2.0, summary


@pytest.mark.slow
def test_batched_construction_full_path_converges():
    """Full store -> BFS waves -> map.yaml path at a scale with several
    multi-capture flushes (the large-map regime in miniature): batched
    strides + geometric schedule + register-then-refine warmup + final
    polish must land at the noise floor, recover the focal, and the saved
    map must round-trip.  This is the committed guard for the 10k-tag
    mapping row (tools/map_bench.py; round-4: rmse 8.3 -> 0.295 px)."""
    import dataclasses
    import io

    from arslam.config import ArSlamConfig, SolverConfig
    from arslam.graph import MapStore, load_yaml, save_yaml
    from arslam.solve.batch import solve
    from arslam.utils.synthetic import make_synthetic_map

    store, truth = make_synthetic_map(n_tags=200, n_caps=80, seed=2,
                                      noise_px=0.3)
    cfg = ArSlamConfig(solver=SolverConfig(
        max_iterations=30, optimize_every=16, optimize_growth=1.25,
        final_polish_iterations=60, linear_solver="cg", dtype="float64"))
    out = solve(store, cfg)
    assert out["rmse"] <= 0.5, out
    # focal recovered from the construction (truth 3000; the homography
    # estimate on this near-frontal synthetic is unusable and falls back
    # to the reference init)
    assert abs(float(store.camera.params[0]) - truth["camera"][0]) < 150.0

    buf = io.StringIO()
    save_yaml(store, buf)
    restored = MapStore()
    load_yaml(restored, io.StringIO(buf.getvalue()))
    assert len(restored.blocks) == len(store.blocks)
    assert len(restored.captures) == len(store.captures)
