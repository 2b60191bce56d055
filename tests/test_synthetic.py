"""The vectorized synthetic-map generator must be equivalent to the naive
per-(capture, tag) projection loop it replaced: identical visibility sets
(the RNG noise stream depends on them) and matching pixel coordinates."""

import numpy as np

from arslam.utils.synthetic import _project_np, make_synthetic_map

ARUCO_SIZE = 0.0635


def _naive_observations(truth, image_size, aruco_size, min_tags_per_cap):
    """Per-detection reference: dict cap_index -> [(tag_index, (4,2) uv)]."""
    half_w, half_h = image_size[0] / 2, image_size[1] / 2
    out = {}
    for k, inv_pose in enumerate(truth["cap_poses"]):
        dets = []
        for t, tag_pose in enumerate(truth["tag_poses"]):
            uv = _project_np(truth["camera"], inv_pose, tag_pose, aruco_size)
            if uv is None:
                continue
            if (np.all(np.abs(uv[:, 0]) <= half_w)
                    and np.all(np.abs(uv[:, 1]) <= half_h)):
                dets.append((t, uv))
        if len(dets) >= min_tags_per_cap:
            out[k] = dets
    return out


def test_batched_generator_matches_per_detection_loop():
    store, truth = make_synthetic_map(n_tags=30, n_caps=14, seed=11,
                                      noise_px=0.0)
    naive = _naive_observations(truth, (4000, 3000), ARUCO_SIZE, 2)

    got = {}
    for cap in store.captures:
        k = int(cap.uid.split("_")[1])
        dets = []
        for bh in cap.blocks:
            b = store.blocks[bh]
            t = int(store.arucos[b.tag_idx].id.split("_")[-1])
            dets.append((t, np.asarray(b.corners)))
        dets.sort(key=lambda d: d[0])
        got[k] = dets

    assert set(got) == set(naive)
    for k in naive:
        assert [t for t, _ in got[k]] == [t for t, _ in naive[k]]
        for (_, a), (_, b) in zip(got[k], naive[k]):
            # same math, different (batched) contraction order -> tiny float
            # differences only
            np.testing.assert_allclose(a, b, atol=1e-8, rtol=0)


def test_generator_is_deterministic_across_chunking():
    """Chunk boundaries must not affect output (chunk size is derived from
    n_tags; compare two scales sharing geometry via identical seeds)."""
    s1, t1 = make_synthetic_map(n_tags=30, n_caps=14, seed=5, noise_px=0.3)
    s2, t2 = make_synthetic_map(n_tags=30, n_caps=14, seed=5, noise_px=0.3)
    assert len(s1.blocks) == len(s2.blocks)
    for b1, b2 in zip(s1.blocks, s2.blocks):
        np.testing.assert_array_equal(b1.corners, b2.corners)
