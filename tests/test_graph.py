"""Graph store + YAML checkpoint tests, including round-trip through the
reference map.yaml schema (SURVEY.md §2.4) and the demo-detections fixture."""

import io
import os

import numpy as np
import pytest
import yaml

from arslam.graph import MapStore, export_arrays, load_yaml, save_yaml
from arslam.graph.arrays import bucket_size, write_back

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")


def load_fixture_store(images=("cap_0", "cap_1", "cap_2"), dicts=("4X4_50",)):
    with open(os.path.join(FIXTURES, "demo_detections.yaml")) as f:
        data = yaml.safe_load(f)
    store = MapStore()
    for cap in data["captures"]:
        if cap["uid"] not in images:
            continue
        dets = []
        for dict_name in dicts:
            for d in cap["detections"][dict_name]:
                dets.append((d["id"], np.array(d["corners"]).reshape(4, 2)))
        store.add_detections(
            cap["uid"], dets, (cap["width"], cap["height"]), cap["img_fn"]
        )
    return store


def test_demo_fixture_graph_shape():
    store = load_fixture_store()
    s = store.stats()
    assert s["captures"] == 3
    assert s["arucos"] == 6  # the README's 6-tag demo map
    assert s["blocks"] == 15  # 5 tags per demo image
    assert s["unsolved"] == 3


def test_duplicate_uid_warns_not_throws():
    store = MapStore()
    c = np.zeros((4, 2))
    store.add_detections("cap_a", [("t1", c)], (100, 80))
    idx = store.add_detections("cap_a", [("t1", c)], (100, 80))
    assert idx == 1  # still added, under a generated uid
    assert store.captures[1].uid != "cap_a"


def test_mismatched_size_dropped():
    store = MapStore()
    c = np.zeros((4, 2))
    store.add_detections("a", [("t1", c)], (100, 80))
    assert store.add_detections("b", [("t1", c)], (99, 80)) is None
    assert len(store.captures) == 1


def test_empty_detections_ignored():
    store = MapStore()
    assert store.add_detections("a", [], (100, 80)) is None


def test_check_image_size_rotation_gauge():
    store = MapStore()
    assert store.check_image_size((1020, 768)) == (1020, 768)
    # transposed size -> rotate
    assert store.check_image_size((768, 1020)) == (1020, 768)
    with pytest.raises(ValueError):
        store.check_image_size((640, 480))


def test_gen_unique_capture_uid():
    store = MapStore()
    assert store.gen_unique_capture_uid() == "cap_0"
    store.add_capture("cap_0")
    assert store.gen_unique_capture_uid() == "cap_1"
    store.add_capture("x")  # now len=2, "cap_2" free
    assert store.gen_unique_capture_uid() == "cap_2"
    store.add_capture("cap_3")  # occupy the name for len=3
    assert store.gen_unique_capture_uid() == "cap_3_0"


def test_yaml_roundtrip():
    store = load_fixture_store()
    rng = np.random.default_rng(0)
    for cap in store.captures:
        cap.inv_pose = rng.normal(size=6)
    for tag in store.arucos:
        tag.pose = rng.normal(size=6)
    store.camera.params[:] = [2987.5, 0.01, -0.02]

    buf = io.StringIO()
    save_yaml(store, buf)
    text = buf.getvalue()

    # parses as plain YAML with the reference schema keys
    doc = yaml.safe_load(text)
    assert set(doc.keys()) == {"blocks", "captures", "arucos", "camera"}
    assert doc["camera"]["width"] == 1020
    assert len(doc["blocks"]) == 15
    assert all(len(b["aruco_rect"]) == 8 for b in doc["blocks"])

    # round-trips losslessly
    store2 = MapStore()
    load_yaml(store2, io.StringIO(text))
    assert [c.uid for c in store2.captures] == [c.uid for c in store.captures]
    assert [t.id for t in store2.arucos] == [t.id for t in store.arucos]
    for a, b in zip(store.captures, store2.captures):
        np.testing.assert_allclose(a.inv_pose, b.inv_pose)
    for a, b in zip(store.arucos, store2.arucos):
        np.testing.assert_allclose(a.pose, b.pose)
    for a, b in zip(store.blocks, store2.blocks):
        assert (a.cap_idx, a.tag_idx) == (b.cap_idx, b.tag_idx)
        np.testing.assert_allclose(a.corners, b.corners)
    np.testing.assert_allclose(store2.camera.params, store.camera.params)


def test_yaml_additive_load_duplicate_raises():
    store = load_fixture_store()
    buf = io.StringIO()
    save_yaml(store, buf)
    store2 = MapStore()
    load_yaml(store2, io.StringIO(buf.getvalue()))
    with pytest.raises(ValueError, match="already exists"):
        load_yaml(store2, io.StringIO(buf.getvalue()))


def test_bfs_order_and_seed_choice():
    store = load_fixture_store()
    seed = store.capture_with_most_blocks()
    assert seed == 0  # all have 5 blocks; first wins
    order = store.connected_component(seed)
    assert sorted(order) == [0, 1, 2]
    assert order[0] == 0
    # every non-seed capture got an init_block that references it
    for idx in order[1:]:
        ib = store.captures[idx].init_block
        assert ib is not None and store.blocks[ib].cap_idx == idx


def test_export_arrays_padding_and_writeback():
    store = load_fixture_store()
    arrs = export_arrays(store)
    assert arrs.cap_poses.shape == (8, 6)
    assert arrs.tag_poses.shape == (8, 6)
    assert arrs.corners.shape == (16, 4, 2)
    assert arrs.block_mask.sum() == 15
    assert arrs.n_blocks == 15
    assert bucket_size(17) == 32 and bucket_size(3) == 8

    new_cam = arrs.camera + 1
    new_caps = arrs.cap_poses + 0.5
    new_tags = arrs.tag_poses - 0.5
    write_back(store, new_cam, new_caps, new_tags)
    np.testing.assert_allclose(store.captures[1].inv_pose, new_caps[1])
    np.testing.assert_allclose(store.arucos[2].pose, new_tags[2])
    assert store.camera.params[0] == new_cam[0]


def test_export_subset_by_cap_order():
    store = load_fixture_store()
    arrs = export_arrays(store, cap_order=[0, 1])
    assert arrs.block_mask.sum() == 10
    included_caps = set(arrs.cap_idx[arrs.block_mask].tolist())
    assert included_caps == {0, 1}


def test_yaml_fast_loader_matches_fallback():
    """The strict fast parser and the PyYAML fallback must build identical
    stores from the same machine-written text."""
    import arslam.graph.yamlio as yamlio

    store = load_fixture_store()
    rng = np.random.default_rng(3)
    for cap in store.captures:
        cap.inv_pose = rng.normal(size=6)
    for tag in store.arucos:
        tag.pose = rng.normal(size=6)
    buf = io.StringIO()
    save_yaml(store, buf)
    text = buf.getvalue()

    # the writer's own output must take the fast path
    assert yamlio._fast_parse(text) is not None

    fast, slow = MapStore(), MapStore()
    load_yaml(fast, io.StringIO(text))
    orig = yamlio._fast_parse
    yamlio._fast_parse = lambda t: (_ for _ in ()).throw(
        yamlio._FallbackToYaml())
    try:
        load_yaml(slow, io.StringIO(text))
    finally:
        yamlio._fast_parse = orig

    assert [c.uid for c in fast.captures] == [c.uid for c in slow.captures]
    assert [t.id for t in fast.arucos] == [t.id for t in slow.arucos]
    for a, b in zip(fast.captures, slow.captures):
        np.testing.assert_array_equal(a.inv_pose, b.inv_pose)
        assert a.img_fn == b.img_fn
    for a, b in zip(fast.blocks, slow.blocks):
        assert (a.cap_idx, a.tag_idx) == (b.cap_idx, b.tag_idx)
        np.testing.assert_array_equal(a.corners, b.corners)
    assert fast.camera.size == slow.camera.size
    np.testing.assert_array_equal(fast.camera.params, slow.camera.params)
    # adjacency lists must match too (bulk_add_blocks path)
    for a, b in zip(fast.captures, slow.captures):
        assert a.blocks == b.blocks
    for a, b in zip(fast.arucos, slow.arucos):
        assert a.blocks == b.blocks


def test_yaml_hand_edited_falls_back():
    """Reformatted (hand-edited / reference-written) YAML must still load —
    through the PyYAML fallback — with identical content."""
    import arslam.graph.yamlio as yamlio

    text = """\
# hand-edited checkpoint
blocks:
- capture: cap_0
  aruco: aruco_4X4_50_7
  aruco_rect: [1.0, 2.0, 3.0, 4.0, 5.0, 6.0, 7.0, 8.0]
captures:
  cap_0:
    inv_pose: [0.1, 0.2, 0.3, 0.0, 0.0, 0.0]
    img_fn: "img with space.jpg"
arucos:
  aruco_4X4_50_7:
    pose: [0, 0, 0, 0, 0, 0]
camera:
  params: [3000.0, 0.0, 0.0]
  width: 640
  height: 480
"""
    with pytest.raises(yamlio._FallbackToYaml):
        yamlio._fast_parse(text)
    store = MapStore()
    load_yaml(store, io.StringIO(text))
    assert [c.uid for c in store.captures] == ["cap_0"]
    assert store.captures[0].img_fn == "img with space.jpg"
    assert len(store.blocks) == 1
    np.testing.assert_array_equal(
        store.blocks[0].corners, np.arange(1.0, 9.0).reshape(4, 2))
    assert store.camera.size == (640, 480)


def test_bulk_add_blocks_matches_add_block():
    """bulk_add_blocks == repeated add_block, python AND native mirrors."""
    rng = np.random.default_rng(5)
    corners = rng.normal(size=(7, 4, 2))
    cap_idx = np.array([0, 0, 1, 1, 1, 0, 1], np.int32)
    tag_idx = np.array([0, 1, 0, 1, 2, 2, 1], np.int32)

    one, bulk = MapStore(), MapStore()
    for s in (one, bulk):
        for c in ("cap_0", "cap_1"):
            s.add_capture(c)
        for t in ("t0", "t1", "t2"):
            s.add_aruco(t)
    for k in range(7):
        one.add_block(corners[k], int(cap_idx[k]), int(tag_idx[k]))
    bulk.bulk_add_blocks(corners, cap_idx, tag_idx)

    for a, b in zip(one.blocks, bulk.blocks):
        assert (a.index, a.cap_idx, a.tag_idx) == (b.index, b.cap_idx,
                                                   b.tag_idx)
        np.testing.assert_array_equal(a.corners, b.corners)
    for a, b in zip(one.captures, bulk.captures):
        assert a.blocks == b.blocks
    for a, b in zip(one.arucos, bulk.arucos):
        assert a.blocks == b.blocks
    if one._native is not None:
        ea, eb = one._native.export_blocks(), bulk._native.export_blocks()
        for x, y in zip(ea, eb):
            np.testing.assert_array_equal(x, y)


def test_yaml_roundtrip_without_pyyaml(monkeypatch, tmp_path):
    """Machine-written maps save and load through the NumPy fast path with
    PyYAML unimportable."""
    import sys

    from arslam.utils.synthetic import make_synthetic_map

    store, _ = make_synthetic_map(n_tags=9, n_caps=5, seed=2)
    for i, cap in enumerate(store.captures):
        cap.inv_pose[:] = 0.1 * (i + 1)
    monkeypatch.setitem(sys.modules, "yaml", None)
    path = tmp_path / "map.yaml"
    save_yaml(store, str(path))
    back = MapStore()
    load_yaml(back, str(path))
    assert back.stats() == {**store.stats(), "unsolved": 0}
    for a, b in zip(store.captures, back.captures):
        assert a.uid == b.uid
        np.testing.assert_allclose(a.inv_pose, b.inv_pose)
    np.testing.assert_allclose(
        np.stack([b.corners for b in store.blocks]),
        np.stack([b.corners for b in back.blocks]))


def test_graph_imports_without_pyyaml():
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = ("import sys; sys.modules['yaml'] = None; "
            "import arslam.graph, arslam.pipeline.engine; print('ok')")
    out = subprocess.run([sys.executable, "-c", code], cwd=repo,
                         capture_output=True, text=True, timeout=120,
                         env={**os.environ, "JAX_PLATFORMS": "cpu"})
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
