"""Pipeline + CLI tests: ingest semantics, merge join behavior, and the
end-to-end CLI flows (map / localize / replay / annotate / gen) on the demo
images — the equivalent of the reference's demo_launch e2e."""

import json
import os

import numpy as np
import pytest
import yaml

from arslam.cli import main as cli_main
from arslam.graph import MapStore, load_yaml
from arslam.pipeline.ingest import ImageIngest, filename_no_ext
from arslam.pipeline.merge import MergeDetections

IMAGES = [f"/root/reference/ar_slam/resources/images/img{i}.jpg"
          for i in (1, 2, 3, 4)]


# ---- ingest ---------------------------------------------------------------

def test_filename_no_ext():
    assert filename_no_ext("file.jpg") == "file"
    assert filename_no_ext("/path/to/file.jpg") == "file"
    assert filename_no_ext("../../file.jpg") == "file"
    assert filename_no_ext("noext") == "noext"
    assert filename_no_ext(".hidden") == ".hidden"


def test_ingest_uid_dedup(tmp_path):
    import PIL.Image

    a = tmp_path / "x.jpg"
    PIL.Image.fromarray(np.zeros((8, 8), np.uint8)).save(a)
    ing = ImageIngest()
    assert ing.ingest(str(a)).uid == "x"
    assert ing.ingest(str(a)).uid == "x:1"
    assert ing.ingest(str(a)).uid == "x:2"


def test_ingest_rotation_fix(tmp_path):
    import PIL.Image

    wide = tmp_path / "wide.png"
    tall = tmp_path / "tall.png"
    PIL.Image.fromarray(np.zeros((60, 80), np.uint8)).save(wide)
    PIL.Image.fromarray(np.zeros((80, 60), np.uint8)).save(tall)
    ing = ImageIngest()
    c1 = ing.ingest(str(wide))
    assert c1.image.shape == (60, 80)
    c2 = ing.ingest(str(tall))  # transposed -> auto-rotated
    assert c2.image.shape == (60, 80)
    bad = tmp_path / "bad.png"
    PIL.Image.fromarray(np.zeros((10, 10), np.uint8)).save(bad)
    with pytest.raises(ValueError, match="same size"):
        ing.ingest(str(bad))


# ---- merge ----------------------------------------------------------------

def test_merge_publishes_when_complete():
    got = []
    m = MergeDetections(on_merged=lambda uid, merged: got.append(merged))
    m.add_capture("c1", object(), (100, 80))
    m.add_detections("c1", "aruco_4X4_50", [("a", None)])
    assert got == []
    m.add_detections("c1", "aruco_5X5_100", [("b", None)])
    assert len(got) == 1
    assert got[0]["detections"] == [("a", None), ("b", None)]


def test_merge_queue_depth_drops_oldest():
    got = []
    m = MergeDetections(on_merged=lambda uid, merged: got.append(uid),
                        queue_depth=3)
    for i in range(5):
        m.add_capture(f"c{i}", object(), (10, 10))
    # c0, c1 dropped; completing them later is a no-op warning
    m.add_detections("c0", "aruco_4X4_50", [])
    m.add_detections("c0", "aruco_5X5_100", [])
    assert got == []  # c0 was evicted then recreated incomplete... publish
    # completing a live one works
    m.add_detections("c4", "aruco_4X4_50", [])
    m.add_detections("c4", "aruco_5X5_100", [])
    assert "c4" not in m.pending


def test_merge_late_detections_dropped():
    got = []
    m = MergeDetections(expected_detector_types=("d1",), include_image=False,
                        on_merged=lambda uid, merged: got.append(uid))
    m.add_detections("c1", "d1", [])
    assert got == ["c1"]
    m.add_detections("c1", "d1", [("late", None)])  # published already
    assert got == ["c1"]


def test_merge_empty_expected_passthrough():
    got = []
    m = MergeDetections(expected_detector_types=(), include_image=True,
                        on_merged=lambda uid, merged: got.append(uid))
    m.add_capture("c1", object(), (10, 10))
    assert got == ["c1"]


# ---- CLI end-to-end -------------------------------------------------------

@pytest.fixture(scope="module")
def demo_map(tmp_path_factory):
    out = tmp_path_factory.mktemp("cli") / "map.yaml"
    rc = cli_main(["map", *IMAGES[:3], "-o", str(out)])
    assert rc == 0
    return str(out)


def test_cli_map_builds_demo_map(demo_map):
    store = MapStore()
    load_yaml(store, demo_map)
    s = store.stats()
    assert s["captures"] == 3
    assert s["arucos"] == 6
    assert s["blocks"] == 15
    # a solved map: focal self-calibrated away from the 3000 default
    assert 500 < store.camera.params[0] < 1200


def test_cli_localize_img4(demo_map, tmp_path):
    out = tmp_path / "localize.yaml"
    rc = cli_main(["localize", demo_map, IMAGES[3], "-o", str(out)])
    assert rc == 0
    store = MapStore()
    load_yaml(store, str(out))
    assert len(store.captures) == 4  # 3 map + 1 localized
    # localized capture has a non-zero pose
    assert np.linalg.norm(store.captures[3].inv_pose) > 0.1


def test_cli_map_resolve_roundtrip(demo_map, tmp_path):
    """Mode 2 of ar_slam_cli: re-solve a saved map without images."""
    out = tmp_path / "resolved.yaml"
    rc = cli_main(["map", demo_map, "-o", str(out)])
    assert rc == 0
    store = MapStore()
    load_yaml(store, str(out))
    assert len(store.captures) == 3


def test_cli_gen(tmp_path):
    rc = cli_main(["gen", "--out-dir", str(tmp_path)])
    assert rc == 0
    assert len(list(tmp_path.glob("*.png"))) == 9


def test_cli_detect_json(capsys):
    rc = cli_main(["detect", IMAGES[0]])
    assert rc == 0
    line = capsys.readouterr().out.strip().splitlines()[-1]
    rec = json.loads(line)
    assert rec["uid"] == "img1"
    ids = sorted(d["id"] for d in rec["detections"])
    assert ids == [f"aruco_4X4_50_{i}" for i in (18, 20, 21, 22, 23)]


@pytest.mark.slow
def test_cli_map_parity_mode(tmp_path):
    """--parity restores reference behavior: fixed focal init 3000 +
    frontal-only seeding.  From that start the demo is a GAMBLE the
    reference itself takes (README "Focal self-calibration"): descent
    either escapes to the true-focal optimum (~760, sub-px rmse) or lands
    in the documented ~12 px plateau, depending on sub-pixel detection
    noise — cv2's fixture corners escape, tiny corner perturbations flip
    it.  Parity mode must produce a structurally valid map in one of
    those two basins, never garbage; the calibrated default (other tests)
    must always converge."""
    out = tmp_path / "map_parity.yaml"
    rc = cli_main(["map", *IMAGES[:3], "--parity", "-o", str(out)])
    assert rc == 0
    store = MapStore()
    load_yaml(store, str(out))
    assert len(store.captures) == 3
    assert len(store.arucos) == 6
    focal = float(store.camera.params[0])
    converged = 500 < focal < 1200
    plateau = 1200 <= focal < 4000
    assert converged or plateau, focal
    # whichever basin, every pose must be finite and the map reloadable
    for cap in store.captures:
        assert np.isfinite(cap.inv_pose).all()
    for tag in store.arucos:
        assert np.isfinite(tag.pose).all()
    # per-basin quality bounds: an IN-BASIN regression (e.g. 12 px -> 30 px
    # inside the plateau, or 0.5 -> 3 px in the converged basin) must fail
    # the guard, not just "either basin with finite poses"
    from arslam.utils.audit import compare_projections

    rows = compare_projections(store)
    # audit rmse_px is per-corner distance; /sqrt(2) converts to the
    # per-component convention of rmse_from_cost / the README's 12 px row
    rmse = float(np.sqrt(np.mean([r["rmse_px"] ** 2 for r in rows]) / 2.0))
    if converged:
        assert rmse <= 1.0, f"converged basin degraded: rmse {rmse}"
    else:
        # documented ~12 px plateau; focal stays pinned near the fixed
        # 3000 init (descent cannot move it in this basin)
        assert rmse <= 15.0, f"plateau basin degraded: rmse {rmse}"
        assert abs(focal - 3000.0) < 600.0, (
            f"plateau focal not stationary: {focal}"
        )


@pytest.mark.slow
def test_parity_f64_escapes_plateau_on_cv2_fixtures():
    """The measured f64 behavior (README "Focal self-calibration"): from
    the reference's fixed focal-3000 start, the f64 CPU solve of the cv2
    fixture detections ESCAPES the plateau to the true-focal optimum
    (~760 px, sub-px rmse).  An f32 device run is the one that can land in
    the 12 px plateau; this pins the f64 side of that documented split.
    Reference behavior: ar_slam_util.cpp:744-866 with fixed focal 3000
    (ar_slam_util.hpp:69)."""
    import dataclasses

    import yaml as _yaml

    from arslam.config import ArSlamConfig
    from arslam.solve.batch import solve as solve_store

    fixtures = os.path.join(os.path.dirname(__file__), "fixtures")
    with open(os.path.join(fixtures, "demo_detections.yaml")) as f:
        data = _yaml.safe_load(f)
    store = MapStore()
    for cap in data["captures"][:3]:
        dets = [(d["id"], np.array(d["corners"]).reshape(4, 2))
                for d in cap["detections"]["4X4_50"]]
        store.add_detections(cap["uid"], dets,
                             (cap["width"], cap["height"]), cap["img_fn"])
    cfg = ArSlamConfig()
    cfg = dataclasses.replace(
        cfg,
        solver=dataclasses.replace(cfg.solver, seed_mode="frontal",
                                   seed_anchors="single"),
        camera=dataclasses.replace(cfg.camera, focal_init_mode="fixed"),
    )
    info = solve_store(store, config=cfg, dtype=np.float64)
    focal = float(store.camera.params[0])
    rmse = float(info["rmse"])
    assert 500 < focal < 1200, f"f64 parity did not escape: focal {focal}"
    assert rmse < 1.0, f"f64 parity rmse {rmse}"


def test_cli_audit(demo_map, capsys):
    """≙ compareProjections (ar_slam_util.cpp:576-589): every block of a
    solved demo map audits at sub-pixel reprojection error."""
    import json as _json

    rc = cli_main(["audit", demo_map, "--json"])
    assert rc == 0
    rows = [_json.loads(line)
            for line in capsys.readouterr().out.strip().splitlines()]
    assert len(rows) == 15
    assert all(r["rmse_px"] < 2.0 for r in rows)
    # sorted worst-first, and projected/observed corners are close
    rmses = [r["rmse_px"] for r in rows]
    assert rmses == sorted(rmses, reverse=True)
    for r in rows:
        obs = np.asarray(r["observed"])
        proj = np.asarray(r["projected"])
        assert np.abs(obs - proj).max() < 5.0


def test_cli_annotate(demo_map, tmp_path):
    rc = cli_main(["annotate", demo_map, "--out-dir", str(tmp_path),
                   "--all-tags"])
    assert rc == 0
    outs = list(tmp_path.glob("*_annotated.png"))
    assert len(outs) == 3


def test_detect_max_side_working_resolution(tmp_path):
    """detect.max_side: a 2x-upscaled photo is detected at the original
    working resolution, with corners reported in FULL-resolution centered
    coordinates (2x the original fixture corners)."""
    import dataclasses

    from PIL import Image

    from arslam.config import ArSlamConfig
    from arslam.pipeline.engine import ArSlamEngine

    im = Image.open(IMAGES[0]).convert("RGB")
    big = im.resize((im.width * 2, im.height * 2), Image.BILINEAR)
    big_path = tmp_path / "img1_2x.jpg"
    big.save(big_path, quality=95)

    cfg = ArSlamConfig()
    cfg = dataclasses.replace(
        cfg, detect=dataclasses.replace(
            cfg.detect, max_side=max(im.width, im.height)))
    engine = ArSlamEngine(config=cfg, use_device_detector=False)
    [(uid, dets, (w, h), _)] = engine.detect_images([str(big_path)])
    assert (w, h) == (im.width * 2, im.height * 2)

    ref_engine = ArSlamEngine(use_device_detector=False)
    [(_, ref_dets, _, _)] = ref_engine.detect_images([IMAGES[0]])
    assert sorted(t for t, _ in dets) == sorted(t for t, _ in ref_dets)
    ref = {t: c for t, c in ref_dets}
    for t, c in dets:
        np.testing.assert_allclose(c, 2.0 * ref[t], atol=3.0)


def test_load_images_service(tmp_path):
    """≙ LoadImages.srv contract (img_fns[] -> success+message) over the
    unix-socket control plane, including the empty-request error the client
    enforces (load_images_client.py:30-40)."""
    from arslam.pipeline.service import LoadImagesServer, send_load_images

    sock = str(tmp_path / "arslam.sock")
    server = LoadImagesServer(sock)
    try:
        resp = send_load_images(sock, ["a.jpg", "b.jpg"])
        assert resp["success"] and "2" in resp["message"]
        resp = send_load_images(sock, ["c.jpg"])
        assert resp["success"]
        assert server.pop_batch() == ["a.jpg", "b.jpg", "c.jpg"]
        assert server.pop_batch() == []
        resp = send_load_images(sock, [])
        assert not resp["success"]
        # partial drain respects max_items
        send_load_images(sock, ["d.jpg", "e.jpg", "f.jpg"])
        assert server.pop_batch(max_items=2) == ["d.jpg", "e.jpg"]
        assert server.pop_batch() == ["f.jpg"]
    finally:
        server.close()
    assert not os.path.exists(sock)


@pytest.mark.slow
def test_event_log_replay(tmp_path):
    """Record detections while mapping, then rebuild the same map from the
    log (≙ the bag-record/replay workflow)."""
    import dataclasses

    from arslam.config import ArSlamConfig, PipelineConfig
    from arslam.pipeline.engine import ArSlamEngine

    log = tmp_path / "events.jsonl"
    cfg = ArSlamConfig(pipeline=PipelineConfig(event_log_path=str(log)))
    eng = ArSlamEngine(config=cfg)
    eng.add_images(IMAGES[:3])
    s1 = eng.solve()
    eng.close()

    out = tmp_path / "replayed.yaml"
    rc = cli_main(["replay", str(log), "-o", str(out)])
    assert rc == 0
    store = MapStore()
    load_yaml(store, str(out))
    assert len(store.captures) == 3
    assert len(store.blocks) == 15


def test_export_artifacts(demo_map):
    from arslam.pipeline.engine import ArSlamEngine

    eng = ArSlamEngine()
    eng.load_map(demo_map)
    art = eng.export_artifacts()
    assert len(art["transforms"]) == 6 + 3
    ci = art["camera_info"]
    assert ci["distortion_model"] == "plumb_bob"
    assert ci["k"][0] == ci["k"][4] > 0
    assert ci["width"] == 1020
    assert len(art["markers"]) == 1 + 6


def test_make_map_service(tmp_path):
    """MakeMap request type: {"make_map": true, img_fns} parks the client
    until the owner responds with the map YAML (≙ MakeMap.srv — declared by
    the reference interfaces, ar_slam_interfaces/CMakeLists.txt:21, but
    never served there)."""
    import threading
    import time

    from arslam.pipeline.service import (
        LoadImagesServer,
        send_load_images,
        send_make_map,
    )

    sock = str(tmp_path / "arslam.sock")
    server = LoadImagesServer(sock)
    result = {}

    def owner_loop():
        deadline = time.time() + 10
        while time.time() < deadline:
            for respond, fns in server.pop_make_map():
                respond({"success": True, "message": f"{len(fns)} images",
                         "yaml": "blocks: []\n"})
                return
            time.sleep(0.02)

    try:
        t = threading.Thread(target=owner_loop)
        t.start()
        resp = send_make_map(sock, ["x.jpg", "y.jpg"], timeout=10.0)
        t.join()
        assert resp["success"] and resp["yaml"].startswith("blocks:")
        # make_map with no filenames fails immediately, like LoadImages
        resp = send_make_map(sock, [], timeout=5.0)
        assert not resp["success"]
        # plain load_images still works alongside
        resp = send_load_images(sock, ["a.jpg"])
        assert resp["success"] and server.pop_batch() == ["a.jpg"]
        result["ok"] = True
    finally:
        server.close()
    assert result.get("ok")


def test_make_map_response_builds_yaml(tmp_path):
    """The serve-side MakeMap fulfilment: images in, solved map YAML out."""
    import argparse

    from arslam.cli import _make_map_response
    from arslam.graph import MapStore, load_yaml

    imgs = [f"/root/reference/ar_slam/resources/images/img{i}.jpg"
            for i in (1, 2, 3)]
    if not os.path.exists(imgs[0]):
        pytest.skip("demo images unavailable")
    args = argparse.Namespace(cpu_detector=True)
    resp = _make_map_response(args, imgs)
    assert resp["success"], resp
    fn = tmp_path / "mm.yaml"
    fn.write_text(resp["yaml"])
    store = MapStore()
    load_yaml(store, str(fn))
    assert len(store.captures) == 3 and len(store.arucos) >= 5
    # failure path: unreadable input reports, does not raise
    resp = _make_map_response(args, [str(tmp_path / "nope.jpg")])
    assert not resp["success"] and "make_map failed" in resp["message"]


def test_cli_config_file(tmp_path, capsys):
    """--config loads the full ArSlamConfig tree; CLI flags override it."""
    import argparse

    import yaml as _yaml

    from arslam.cli import _config
    from arslam.config import ArSlamConfig

    fn = tmp_path / "cfg.yaml"
    fn.write_text(_yaml.safe_dump({
        "aruco_size": 0.1,
        "solver": {"max_iterations": 7, "loss": "huber"},
        "detect": {"dictionaries": ["6X6_250"]},
    }))
    args = argparse.Namespace(config=str(fn))
    cfg = _config(args)
    assert cfg.aruco_size == 0.1
    assert cfg.solver.max_iterations == 7 and cfg.solver.loss == "huber"
    assert cfg.detect.dictionaries == ("6X6_250",)
    # untouched fields keep defaults
    assert cfg.solver.linear_solver == "dense"
    # flag overrides the file
    args = argparse.Namespace(config=str(fn), iterative_schur=True)
    assert _config(args).solver.linear_solver == "cg"
    # round trip through to_dict
    assert ArSlamConfig.from_dict(cfg.to_dict()) == cfg


def test_config_file_unknown_key_raises(tmp_path):
    import pytest as _pytest

    from arslam.config import ArSlamConfig

    with _pytest.raises(ValueError, match="max_iteration"):
        ArSlamConfig.from_dict({"solver": {"max_iteration": 5}})


# ---- pipelined streaming mode (≙ the MT component container) --------------

@pytest.mark.slow
def test_stream_pipeline_e2e_matches_sequential():
    """The overlapped ingest→detect→merge→solve pipeline produces the same
    map as the strict sequential loop, actually drives the MergeDetections
    join for every capture, overlaps stages in wall-time, and is at least
    as fast on a 12-image stream (≙ ar_slam_launch.py:124-142's MT
    container vs single-threaded execution)."""
    import time

    from arslam.config import ArSlamConfig, PipelineConfig
    from arslam.pipeline.engine import ArSlamEngine
    from arslam.pipeline.stream import StreamPipeline
    import dataclasses

    cfg = dataclasses.replace(ArSlamConfig(),
                              pipeline=PipelineConfig(batch_size=4))
    paths = IMAGES[:3] * 4  # 12 images, tags in every one
    bs = 4

    # warm the jit caches (detector + solver) so timing compares steady
    # state, not compilation
    warm = ArSlamEngine(config=cfg)
    warm.add_images(IMAGES[:3])
    warm.solve_incremental()

    eng_s = ArSlamEngine(config=cfg)
    t0 = time.time()
    for i in range(0, len(paths), bs):
        eng_s.add_images(paths[i:i + bs])
        eng_s.solve_incremental()
    seq_wall = time.time() - t0

    eng_p = ArSlamEngine(config=cfg)
    pipe = StreamPipeline(eng_p)
    t0 = time.time()
    pipe.submit(paths)
    out = pipe.drain()
    pipe_wall = time.time() - t0
    pipe.close()

    assert out is not None and out.get("unsolved", 0) == 0
    # identical maps (same captures in the same order, same optimum)
    assert eng_p.store.stats() == eng_s.store.stats()
    assert [c.uid for c in eng_p.store.captures] == [
        c.uid for c in eng_s.store.captures]
    np.testing.assert_allclose(eng_p.store.camera.params,
                               eng_s.store.camera.params, rtol=1e-5)
    # the merge join stage was driven for EVERY capture
    assert len(pipe.merge.inner.published) == len(paths)
    # stages genuinely overlapped in wall time
    overlap = (pipe.timeline.overlap_s("ingest", "detect")
               + pipe.timeline.overlap_s("ingest", "solve")
               + pipe.timeline.overlap_s("detect", "solve"))
    assert overlap > 0.0, pipe.timeline.intervals
    # and overlapping must not be slower than strict sequential (generous
    # bound to keep CI robust; typical measured gain is the full decode +
    # detect time of all but the first batch)
    assert pipe_wall <= seq_wall * 1.15, (pipe_wall, seq_wall)


@pytest.mark.slow
def test_serve_artifact_stream_per_batch(tmp_path, monkeypatch):
    """arslam serve --artifacts writes one TF/CameraInfo/marker jsonl
    record per solved batch and --debug-images one annotated PNG per
    solved capture (≙ the per-batch publishes at ar_slam.cpp:133-155 and
    the per-solve displayDebug)."""
    import io

    art = tmp_path / "artifacts.jsonl"
    dbg = tmp_path / "debug"
    out = tmp_path / "map.yaml"
    monkeypatch.setattr(
        "sys.stdin", io.StringIO("\n".join(IMAGES[:3]) + "\n"))
    rc = cli_main([
        "serve", "--artifacts", str(art), "--debug-images", str(dbg),
        "-o", str(out),
    ])
    assert rc == 0
    recs = [json.loads(line) for line in open(art) if line.strip()]
    # stdin mode solves per line -> one record per image batch
    assert len(recs) == 3
    for rec in recs:
        assert rec["transforms"] and rec["camera_info"] and rec["markers"]
        assert rec["solved_uids"]
    pngs = sorted(os.listdir(dbg))
    assert len(pngs) == 3 and all(p.endswith("_annotated.png")
                                  for p in pngs)
    assert os.path.exists(out)


@pytest.mark.slow
def test_stream_pipeline_pub_period_paces_ingest():
    """PipelineConfig.pub_period throttles the ingest→detect handoff to one
    image per tick (≙ ImageLoader's pub_period timer publishing one image
    per tick, image_loader.cpp:92-102): 6 images at 0.1 s/image cannot
    finish faster than ~0.4 s (first batch releases immediately), and the
    default (0) applies no pacing."""
    import dataclasses
    import time

    from arslam.config import ArSlamConfig, PipelineConfig
    from arslam.pipeline.engine import ArSlamEngine
    from arslam.pipeline.stream import StreamPipeline

    period = 0.1
    cfg = dataclasses.replace(
        ArSlamConfig(),
        pipeline=PipelineConfig(batch_size=2, pub_period=period))
    paths = IMAGES[:3] * 2  # 6 images -> 3 batches of 2

    eng = ArSlamEngine(config=cfg)
    pipe = StreamPipeline(eng)
    assert pipe.pub_period == period
    t0 = time.time()
    pipe.submit(paths)
    pipe.drain()
    wall = time.time() - t0
    pipe.close()
    # batch 1 releases immediately; batches 2 and 3 wait for 2 and 4 ticks
    assert wall >= 4 * period * 0.9, wall
    assert len(eng.store.captures) == len(paths)


@pytest.mark.slow
def test_event_log_hermetic_replay(tmp_path):
    """With event_log_embed_images the log carries capture pixels, and
    ``arslam replay --redetect`` rebuilds the map WITHOUT the original
    image files (≙ the bag storing full Capture messages,
    bag_recorder.cpp:73-83)."""
    import json
    import shutil

    from arslam.config import ArSlamConfig, PipelineConfig
    from arslam.pipeline.engine import ArSlamEngine

    # record from COPIES of the demo images so deleting them proves
    # hermeticity
    imgdir = tmp_path / "imgs"
    imgdir.mkdir()
    copies = [str(shutil.copy(p, imgdir)) for p in IMAGES[:3]]
    log = tmp_path / "events.jsonl"
    cfg = ArSlamConfig(pipeline=PipelineConfig(
        event_log_path=str(log), event_log_embed_images=True))
    eng = ArSlamEngine(config=cfg)
    eng.add_images(copies)
    eng.solve()
    n_blocks = len(eng.store.blocks)
    eng.close()

    recs = [json.loads(line) for line in open(log) if line.strip()]
    assert all("image_png" in r for r in recs if r["kind"] == "capture")

    shutil.rmtree(imgdir)  # originals gone — replay must not need them
    out = tmp_path / "replayed.yaml"
    rc = cli_main(["replay", str(log), "--redetect", "-o", str(out)])
    assert rc == 0
    store = MapStore()
    load_yaml(store, str(out))
    assert len(store.captures) == 3
    assert len(store.blocks) == n_blocks


@pytest.mark.parametrize("env_dir", [True, False],
                         ids=["env_var", "checkout"])
def test_compile_cache_placement(env_dir, tmp_path, monkeypatch):
    """JAX_COMPILATION_CACHE_DIR wins when set; otherwise the cache sits at
    the fixed path inside the checkout."""
    import jax

    from arslam import cli

    before = jax.config.jax_compilation_cache_dir
    if env_dir:
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
        want = str(tmp_path)
    else:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        want = os.path.join(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))), ".jax_cache")
    try:
        assert cli._enable_compile_cache() == want
        assert jax.config.jax_compilation_cache_dir == want
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


def test_pgm_roundtrip_without_pillow(tmp_path, monkeypatch):
    """Binary PGM reads and writes with NumPy alone (header comments
    included) and agrees with PIL's decoder."""
    import sys

    from PIL import Image

    from arslam.pipeline.ingest import load_image, read_pgm, write_pgm

    img = np.random.default_rng(0).integers(0, 256, (37, 53)).astype(np.uint8)
    path = tmp_path / "a.pgm"
    write_pgm(str(path), img)
    np.testing.assert_array_equal(np.asarray(Image.open(path)), img)
    commented = tmp_path / "b.pgm"
    commented.write_bytes(b"P5\n# made by hand\n53 37\n# depth\n255\n"
                          + img.tobytes())
    monkeypatch.setitem(sys.modules, "PIL", None)
    np.testing.assert_array_equal(read_pgm(str(path)), img)
    np.testing.assert_array_equal(load_image(str(commented)), img)
    (tmp_path / "c.pgm").write_bytes(b"P2\n2 1\n255\n0 1\n")
    with pytest.raises(ValueError):
        read_pgm(str(tmp_path / "c.pgm"))
