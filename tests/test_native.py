"""Native C++ graph-core tests: semantic parity with the pure-Python store
and a topology micro-benchmark demonstrating its purpose."""

import time

import numpy as np
import pytest

from arslam.graph import MapStore, export_arrays
from arslam.graph.native import available
from arslam.utils.synthetic import make_synthetic_map

pytestmark = pytest.mark.skipif(not available(),
                                reason="native core not built")


def build_pair(n_tags=20, n_caps=10, seed=3):
    """Same synthetic observations into a python-only and a native store."""
    src, _ = make_synthetic_map(n_tags=n_tags, n_caps=n_caps, seed=seed)
    stores = []
    for native in (False, True):
        dst = MapStore(native=native)
        dst.camera.size = src.camera.size
        for cap in src.captures:
            dets = [
                (src.arucos[src.blocks[bh].tag_idx].id,
                 src.blocks[bh].corners)
                for bh in cap.blocks
            ]
            dst.add_detections(cap.uid, dets, src.camera.size)
        stores.append(dst)
    return stores


def test_native_store_parity_bfs_and_export():
    py, nat = build_pair()
    assert nat._native is not None and py._native is None

    seed_py = py.capture_with_most_blocks()
    seed_nat = nat.capture_with_most_blocks()
    assert seed_py == seed_nat

    order_py = py.connected_component(seed_py)
    order_nat = nat.connected_component(seed_nat)
    assert order_py == order_nat
    for a, b in zip(py.captures, nat.captures):
        assert (a.init_block or -1) == (b.init_block or -1) or (
            a.init_block is None and b.init_block is None
        )

    a1 = export_arrays(py)
    a2 = export_arrays(nat)
    np.testing.assert_array_equal(a1.cap_idx, a2.cap_idx)
    np.testing.assert_array_equal(a1.tag_idx, a2.tag_idx)
    np.testing.assert_allclose(a1.corners, a2.corners)
    np.testing.assert_array_equal(a1.block_mask, a2.block_mask)


def test_native_store_solves_demo():
    """End-to-end: solver runs identically on a native-backed store."""
    from arslam.config import ArSlamConfig
    from arslam.solve import solve_batch

    py, nat = build_pair(n_tags=9, n_caps=5, seed=4)
    s1 = solve_batch(py, ArSlamConfig())
    s2 = solve_batch(nat, ArSlamConfig())
    assert abs(s1["rmse"] - s2["rmse"]) < 1e-6


def test_native_topology_speed():
    """BFS + bulk export on a larger graph: the natively-served queries
    must beat the python path (the dual-write build cost is excluded — the
    win is in the query hot path used per solve wave)."""
    rng = np.random.default_rng(0)
    n_caps, n_tags, blocks_per_cap = 400, 800, 40

    def build(native):
        store = MapStore(native=native)
        store.camera.size = (100, 100)
        corners = rng.normal(size=(4, 2))
        for c in range(n_caps):
            dets = [
                (f"tag_{(c * 7 + i * 13) % n_tags}", corners)
                for i in range(blocks_per_cap)
            ]
            store.add_detections(f"cap_{c}", dets, (100, 100))
        return store

    def query_time(store, reps=5):
        t0 = time.time()
        for _ in range(reps):
            for cap in store.captures:
                cap.init_block = None
            store.connected_component(store.capture_with_most_blocks())
            export_arrays(store)
        return (time.time() - t0) / reps

    t_py = query_time(build(False))
    t_nat = query_time(build(True))
    assert t_nat < t_py, (t_py, t_nat)


def test_native_jpeg_decode_matches_pil():
    """Native libjpeg grayscale decode == PIL's L conversion (both use the
    ITU-R 601 luma; IDCT rounding may differ by ±1 count)."""
    import numpy as np
    import pytest

    from arslam.pipeline import fast_decode

    if not fast_decode.available():
        pytest.skip("libarslam_jpeg.so not built")
    from PIL import Image

    path = "/root/reference/ar_slam/resources/images/img1.jpg"
    if not __import__("os").path.exists(path):
        pytest.skip("demo image unavailable")
    native = fast_decode.decode_gray(path)
    pil = np.asarray(Image.open(path).convert("L"))
    assert native is not None and native.shape == pil.shape
    diff = np.abs(native.astype(int) - pil.astype(int))
    assert np.mean(diff) < 1.0 and np.percentile(diff, 99) <= 2, (
        diff.mean(), diff.max())


def test_native_jpeg_decode_bad_inputs(tmp_path):
    from arslam.pipeline import fast_decode
    import pytest

    if not fast_decode.available():
        pytest.skip("libarslam_jpeg.so not built")
    bad = tmp_path / "not_a.jpg"
    bad.write_bytes(b"definitely not jpeg data")
    assert fast_decode.decode_gray(str(bad)) is None
    assert fast_decode.decode_gray(str(tmp_path / "missing.jpg")) is None
    assert fast_decode.decode_gray("whatever.png") is None
