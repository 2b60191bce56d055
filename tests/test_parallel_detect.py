"""Sharded (data-parallel) detection: shard_map over the image axis must
match the single-device batched detector exactly (virtual 8-device CPU
mesh from conftest)."""

import jax
import numpy as np
import pytest

from arslam.detect.gen import render_marker
from arslam.detect.device_detect import DetectParams, detect_batch
from arslam.parallel.detect import detect_batch_sharded, image_mesh

from arslam.detect.gen import place_marker


def _render_batch(n):
    """n distinct frames, one 4X4_50 marker each at varying placements."""
    imgs = []
    rng = np.random.default_rng(3)
    for i in range(n):
        canvas = np.full((200, 240), 200, dtype=np.uint8)
        marker = render_marker("4X4_50", (i * 5) % 50, 96)
        x0 = 40 + int(rng.integers(0, 60))
        y0 = 30 + int(rng.integers(0, 40))
        s = 80 + int(rng.integers(0, 30))
        quad = np.array([[x0, y0], [x0 + s, y0],
                         [x0 + s, y0 + s], [x0, y0 + s]], float)
        place_marker(canvas, marker, quad)
        imgs.append(canvas)
    return np.stack(imgs)


@pytest.mark.parametrize("n_images", [8, 6])  # even split + padded split
@pytest.mark.slow
def test_sharded_matches_single(n_images):
    if len(jax.devices()) < 2:
        pytest.skip("needs a multi-device mesh")
    imgs = _render_batch(n_images)
    params = DetectParams(win_sizes=(23,), refine=False)
    ref = detect_batch(imgs, params=params, dict_names=("4X4_50",))
    mesh = image_mesh(8)
    out = detect_batch_sharded(imgs, mesh=mesh, params=params,
                               dict_names=("4X4_50",))
    ref = jax.tree.map(np.asarray, ref)
    out = jax.tree.map(np.asarray, out)
    # every image found its marker, and sharded == unsharded exactly
    d = out["4X4_50"]
    assert d["valid"].shape[0] == n_images
    assert d["valid"].any(axis=1).all()
    for k in ("ids", "valid"):
        np.testing.assert_array_equal(d[k], ref["4X4_50"][k])
    np.testing.assert_allclose(d["corners"], ref["4X4_50"]["corners"],
                               atol=1e-5)


def test_sharded_outputs_are_sharded():
    """The hot path must not gather: outputs stay image-sharded."""
    if len(jax.devices()) < 2:
        pytest.skip("needs a multi-device mesh")
    imgs = _render_batch(8)
    mesh = image_mesh(8)
    out = detect_batch_sharded(
        imgs, mesh=mesh, params=DetectParams(win_sizes=(23,), refine=False),
        dict_names=("4X4_50",))
    ids = out["4X4_50"]["ids"]
    assert not ids.sharding.is_fully_replicated
