"""Batched device detector tests: stage correctness against plain NumPy /
SciPy references, rendered-frame truth, demo-image parity and end-to-end
map quality from our own detections."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import yaml
from PIL import Image

from arslam.config import ArSlamConfig
from arslam.detect.gen import render_marker
from arslam.detect.device_detect import (
    DetectParams,
    adaptive_threshold,
    connected_components,
    detect_batch,
    otsu_batch,
)
from arslam.graph import MapStore
from arslam.solve import solve_batch

from arslam.detect.gen import place_marker

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")


def demo_images():
    with open(os.path.join(FIXTURES, "demo_detections.yaml")) as f:
        data = yaml.safe_load(f)
    imgs = np.stack([
        np.asarray(Image.open(c["img_fn"]).convert("L"))
        for c in data["captures"]
    ])
    return data, imgs


def test_connected_components_two_blobs():
    img = np.zeros((32, 32), bool)
    img[4:10, 4:10] = True
    img[20:28, 18:30] = True
    labels = np.asarray(connected_components(jnp.asarray(img), 8))
    l1 = labels[5, 5]
    l2 = labels[22, 22]
    assert l1 != l2
    assert (labels[4:10, 4:10] == l1).all()
    assert (labels[20:28, 18:30] == l2).all()
    assert (labels[img == 0] >= 2**30).all()


def test_connected_components_ring():
    """Hollow ring (what adaptive threshold makes of big markers) labels as
    one component."""
    img = np.zeros((64, 64), bool)
    img[10:50, 10:50] = True
    img[16:44, 16:44] = False
    labels = np.asarray(connected_components(jnp.asarray(img), 24))
    fg = labels[img]
    assert (fg == fg[0]).all()


def test_otsu_batch_bimodal():
    v = np.concatenate([np.full(100, 10.0), np.full(100, 250.0)])
    rows = np.stack([v, v + 2])
    t = np.asarray(otsu_batch(jnp.asarray(rows)))
    assert np.all((t > 10) & (t < 250))


def test_adaptive_threshold_matches_oracle():
    from arslam.detect.reference import adaptive_threshold as oracle_at

    rng = np.random.default_rng(0)
    img = rng.uniform(0, 255, size=(96, 128)).astype(np.float32)
    ours = np.asarray(adaptive_threshold(jnp.asarray(img), 23, 7.0))
    ref = oracle_at(img, 23, 7.0)
    assert (ours == ref).mean() > 0.999


def test_rendered_batch_detection():
    canvases = []
    expected = []
    rng = np.random.default_rng(1)
    for i in range(3):
        canvas = np.full((480, 640), 200, dtype=np.uint8)
        mid = int(rng.integers(0, 50))
        quad = np.array([[150, 100], [390, 120], [380, 350], [160, 330]],
                        float) + rng.uniform(-20, 20, size=(4, 2))
        place_marker(canvas, render_marker("4X4_50", mid, 168), quad)
        canvases.append(canvas)
        expected.append(mid)
    out = detect_batch(jnp.asarray(np.stack(canvases)),
                       dict_names=("4X4_50",))
    ids = np.asarray(out["4X4_50"]["ids"])
    valid = np.asarray(out["4X4_50"]["valid"])
    for i in range(3):
        got = ids[i][valid[i]]
        assert list(got) == [expected[i]], (i, got, expected[i])


def test_demo_batch_id_parity():
    data, imgs = demo_images()
    out = detect_batch(jnp.asarray(imgs))
    for name in ("4X4_50", "5X5_100"):
        ids = np.asarray(out[name]["ids"])
        valid = np.asarray(out[name]["valid"])
        for i, cap in enumerate(data["captures"]):
            got = sorted(int(x) for x in ids[i][valid[i]])
            oracle = sorted(int(d["id"].split("_")[-1])
                            for d in cap["detections"][name])
            assert got == oracle, (cap["uid"], name, got, oracle)


def test_multi_window_dedup():
    """Two threshold windows produce the same markers once (duplicate
    suppression keeps one instance per marker)."""
    data, imgs = demo_images()
    out = detect_batch(jnp.asarray(imgs[:1]),
                       params=DetectParams(win_sizes=(23, 13)),
                       dict_names=("4X4_50",))
    ids = np.asarray(out["4X4_50"]["ids"][0])
    valid = np.asarray(out["4X4_50"]["valid"][0])
    got = sorted(int(i) for i in ids[valid])
    assert got == [18, 20, 21, 22, 23], got  # each exactly once


def test_demo_own_detections_map_quality():
    """Full device front end + solver: map RMSE from OUR detections must
    be sub-0.4px (beats the cv2-fixture 0.46px)."""
    data, imgs = demo_images()
    h, w = imgs.shape[1:]
    out = detect_batch(jnp.asarray(imgs))
    store = MapStore()
    for i in range(3):
        dets = []
        for name in ("4X4_50", "5X5_100"):
            ids = np.asarray(out[name]["ids"][i])
            corners = np.asarray(out[name]["corners"][i])
            valid = np.asarray(out[name]["valid"][i])
            for k in np.nonzero(valid)[0]:
                dets.append((f"aruco_{name}_{int(ids[k])}",
                             corners[k] - np.array([w / 2, h / 2])))
        store.add_detections(f"cap_{i}", dets, (w, h))
    summary = solve_batch(store, ArSlamConfig(), dtype=np.float64)
    # chip (f32 — dtype=float64 downcasts without x64): the same solve
    # lands at ~0.45 px; still far inside the documented 0.32-0.55 band
    # and an order of magnitude under the reference's ~10 px basin
    import jax as _jax

    bound = 0.4 if _jax.config.jax_enable_x64 else 0.55
    assert summary["rmse"] < bound, summary


def test_rendered_batch_6x6():
    """The batched device detector decodes 6X6_250 markers (grid size and
    dictionary table are data, not code — same kernel)."""
    canvas = np.full((480, 640), 200, dtype=np.uint8)
    quad = np.array([[170, 110], [410, 140], [395, 355], [185, 335]], float)
    place_marker(canvas, render_marker("6X6_250", 201, 160), quad)
    out = detect_batch(jnp.asarray(canvas[None]), dict_names=("6X6_250",))
    ids = np.asarray(out["6X6_250"]["ids"][0])
    valid = np.asarray(out["6X6_250"]["valid"][0])
    assert list(ids[valid]) == [201]
    corners = np.asarray(out["6X6_250"]["corners"][0][valid][0])
    assert np.abs(corners - quad).max() < 2.5


def test_topk_min_pool_keeps_thin_rings():
    """A 1-px ring lying entirely on odd rows/columns must survive the
    subsampled top-k ranking (min-pooling, not plain striding — plain
    [::2, ::2] would drop it entirely)."""
    from arslam.detect.device_detect import _top_k_subsampled

    img = np.zeros((40, 160), bool)
    # 1-px ring with every pixel on an odd row or odd column
    img[5, 7:19] = True    # top edge: row 5 (odd)
    img[15, 7:19] = True   # bottom edge: row 15 (odd)
    img[5:16, 7] = True    # left edge: col 7 (odd)
    img[5:16, 17] = True   # right edge: col 17 (odd)
    labels = connected_components(jnp.asarray(img), 6)
    roots, areas = _top_k_subsampled(labels, 4, 2)
    roots = np.asarray(roots)
    true_root = int(np.asarray(labels)[img].min())
    assert true_root in roots[np.asarray(areas) > 0], (roots, areas)


def test_clutter_does_not_evict_markers():
    """A scene with MORE large filled distractor blobs than the candidate
    budget must still detect the markers: pure-area ranking would evict
    the hollow marker rings (a filled blob of the same footprint has far
    more pixels) — the ring-aware score (area x hollowness) plus the
    oversized-component demotion keep them in the top-k."""
    rng = np.random.default_rng(5)
    canvas = np.full((960, 1280), 200, np.uint8)
    # two markers, ~110 px
    q1 = np.array([[80, 80], [190, 84], [186, 192], [78, 188]], float)
    q2 = np.array([[1050, 700], [1160, 706], [1154, 812], [1046, 808]],
                  float)
    place_marker(canvas, render_marker("4X4_50", 7, 96), q1)
    place_marker(canvas, render_marker("4X4_50", 21, 96), q2)
    # 40 filled dark blobs, each with MORE pixels than a marker ring
    # (ring area of a 110 px marker ~ 4*110*18 ~ 8k px; blobs are 10k px)
    k_budget = 24  # fewer slots than distractors
    placed = 0
    for _ in range(400):
        if placed >= 40:
            break
        y = int(rng.integers(0, 860))
        x = int(rng.integers(0, 1180))
        h_, w_ = 100, 100
        # keep clear of the markers
        if (y < 260 and x < 260) or (y > 620 and x > 960):
            continue
        canvas[y:y + h_, x:x + w_] = 30
        placed += 1
    assert placed >= 40
    out = detect_batch(
        jnp.asarray(canvas[None]),
        params=DetectParams(max_candidates=k_budget),
        dict_names=("4X4_50",),
    )
    ids = np.asarray(out["4X4_50"]["ids"][0])
    valid = np.asarray(out["4X4_50"]["valid"][0])
    got = sorted(int(i) for i in ids[valid])
    assert got == [7, 21], got


def test_serpentine_ccl_converges_at_default_iters():
    """High-bend (serpentine) foreground converges within the DEFAULT
    ccl_iters bound — the early-exit fixpoint loop makes a generous bound
    free for typical images, so under-merging cannot happen silently."""
    img = np.zeros((96, 96), bool)
    # serpentine: horizontal bars connected alternately left/right
    for i, y in enumerate(range(4, 92, 6)):
        img[y, 4:92] = True
        if y + 6 < 92:
            if i % 2 == 0:
                img[y:y + 7, 90] = True
            else:
                img[y:y + 7, 4] = True
    labels = np.asarray(connected_components(
        jnp.asarray(img), DetectParams().ccl_iters))
    fg = labels[img]
    assert (fg == fg[0]).all(), "serpentine under-merged at default iters"


def test_noise_speckle_does_not_decode():
    """Precision guard (round-5 FP lab): pure pixel-noise patches must not
    decode as markers.  Otsu slicing a textureless patch yields ~random
    bits, and 16-bit hamming-0 chance matches are certain at corpus scale
    (~2^-16 x ids x rotations per candidate); the min_otsu_std=12 +
    min_cell_px gates exist exactly for this.  A real marker in the same
    noisy scene must still decode."""
    rng = np.random.default_rng(11)
    canvas = np.full((768, 1024), 190, np.float64)
    q = np.array([[460, 330], [570, 334], [566, 442], [458, 438]], float)
    canvas_u8 = canvas.astype(np.uint8)
    place_marker(canvas_u8, render_marker("4X4_50", 13, 96), q)
    noisy = np.clip(canvas_u8 + rng.normal(scale=10.0, size=canvas.shape),
                    0, 255).astype(np.uint8)
    out = detect_batch(
        jnp.asarray(noisy[None]),
        params=DetectParams(win_sizes=(3, 13, 23), max_candidates=64),
        dict_names=("4X4_50", "5X5_100"),
    )
    for name in ("4X4_50", "5X5_100"):
        ids = np.asarray(out[name]["ids"][0])
        valid = np.asarray(out[name]["valid"][0])
        got = sorted(int(i) for i in ids[valid])
        if name == "4X4_50":
            assert got == [13], got  # the real marker, nothing else
        else:
            assert got == [], got  # no chance-match on the noise field


# ---- plain references for the XLA stages ---------------------------------

def _serpentine_noise_batch():
    """Blobs, a ring, a serpentine (slow-converging) border and noise at a
    non-aligned size, plus an all-noise and an all-background frame."""
    rng = np.random.default_rng(0)
    h, w = 61, 150
    img = np.zeros((h, w), bool)
    img[5:20, 5:25] = True
    img[25:50, 30:60] = True
    img[30:45, 35:55] = False  # ring
    for i, r in enumerate(range(4, 52, 8)):  # serpentine
        img[r, 70:140] = True
        if r + 8 < 52:
            img[r:r + 9, 70 if i % 2 else 139] = True
    img |= rng.random((h, w)) < 0.08
    return np.stack([img, rng.random((h, w)) < 0.3, np.zeros((h, w), bool)])


def _ring():
    img = np.zeros((32, 128), bool)
    img[2:10, 4:16] = True
    img[12:30, 20:60] = True
    img[16:26, 24:56] = False  # ring
    img[4:8, 90:120] = True
    return img[None]


def _staircase():
    """W not a multiple of anything convenient; the diagonal staircase
    joins only through 8-connectivity."""
    img = np.zeros((33, 97), bool)
    img[4:20, 5:60] = True
    for i in range(10):
        img[22 + i % 8, 70 + i * 2: 72 + i * 2] = True
    return img[None]


@pytest.mark.parametrize("make", [_ring, _staircase, _serpentine_noise_batch],
                         ids=["ring", "staircase", "serpentine_noise_empty"])
def test_connected_components_matches_scipy_label(make):
    """Same partition of the foreground as scipy.ndimage.label with
    8-connectivity; background keeps the BIG sentinel."""
    import jax
    from scipy import ndimage

    batch = make()
    labels = np.asarray(jax.vmap(lambda b: connected_components(b, 64))(
        jnp.asarray(batch)))
    for img, lab in zip(batch, labels):
        ref, n = ndimage.label(img, structure=np.ones((3, 3), int))
        assert (lab[~img] >= 2**30).all()
        pairs = set(zip(lab[img].tolist(), ref[img].tolist()))
        assert len(pairs) == n == len(set(lab[img].tolist()))


def _box_mean_np(img, win):
    """Centered win x win mean with edge padding, from a float64 integral
    image."""
    pad = win // 2
    p = np.pad(img.astype(np.float64), pad, mode="edge")
    ii = np.zeros((p.shape[0] + 1, p.shape[1] + 1))
    ii[1:, 1:] = p.cumsum(0).cumsum(1)
    h, w = img.shape
    return (ii[win:win + h, win:win + w] - ii[:h, win:win + w]
            - ii[win:win + h, :w] + ii[:h, :w]) / (win * win)


@pytest.mark.parametrize("shape", [(37, 141), (101, 67)])
@pytest.mark.parametrize("win", [11, 23])
def test_box_mean_matches_integral_image(shape, win):
    from arslam.detect.device_detect import box_mean

    img = np.random.default_rng(3).uniform(0, 255, shape).astype(np.float32)
    got = np.asarray(box_mean(jnp.asarray(img), win))
    np.testing.assert_allclose(got, _box_mean_np(img, win), atol=1e-2)


def test_extreme_quads_match_brute_force():
    """Each candidate's [A, B, C, D] attains the brute-force NumPy extremes:
    A farthest from the centroid, C farthest from A, B / D the extreme
    signed distances either side of line AC — and all four are members."""
    from arslam.detect.device_detect import (_extreme_quads,
                                             _top_k_components)

    img = np.zeros((64, 160), bool)
    img[4:20, 8:40] = True
    img[8:16, 12:36] = False      # ring (marker-border-like)
    img[30:60, 60:120] = True
    img[36:54, 66:114] = False
    img[5:9, 130:150] = True      # small solid blob
    for i in range(12):           # a tilted bar
        img[40 + i, 130 + i: 136 + i] = True
    labels = np.asarray(connected_components(jnp.asarray(img), 16))
    roots, areas = _top_k_components(jnp.asarray(labels).reshape(-1), 8,
                                     img.shape[1])
    quads = np.asarray(_extreme_quads(jnp.asarray(labels).reshape(-1),
                                      roots, *img.shape))
    roots, areas = np.asarray(roots), np.asarray(areas)
    checked = 0
    for q, root, area in zip(quads, roots, areas):
        if area <= 0:
            continue
        ys, xs = np.nonzero(labels == root)
        pts = np.stack([xs, ys], axis=1).astype(np.float64)
        member = {tuple(p) for p in pts}
        assert all(tuple(v) in member for v in q)
        a, b, c, d = q.astype(np.float64)
        cen = pts.mean(axis=0)
        tol = 1e-3
        d_cen = ((pts - cen) ** 2).sum(1)
        assert ((a - cen) ** 2).sum() >= d_cen.max() * (1 - tol) - tol
        d_a = ((pts - a) ** 2).sum(1)
        assert ((c - a) ** 2).sum() >= d_a.max() * (1 - tol) - tol
        nrm = np.array([-(c[1] - a[1]), c[0] - a[0]])
        sd = (pts - a) @ nrm
        assert (b - a) @ nrm >= sd.max() - tol * max(1.0, abs(sd).max())
        assert (d - a) @ nrm <= sd.min() + tol * max(1.0, abs(sd).max())
        checked += 1
    assert checked >= 4


def test_detect_batch_rendered_frames_match_truth():
    """The production sweep on rendered 1020x768 frames (10-20 markers of
    40-200 px, both dictionaries): every marker found, no false ids,
    corners within 1.5 px of the renderer's."""
    from arslam.detect.device_detect import params_from_config
    from arslam.detect.gen import marker_frame

    rng = np.random.default_rng(5)
    frames = [marker_frame(rng, 768, 1020) for _ in range(2)]
    dicts = ("4X4_50", "5X5_100")
    out = detect_batch(jnp.asarray(np.stack([f[0] for f in frames])),
                       params=params_from_config(ArSlamConfig().detect),
                       dict_names=dicts)
    for i, (_, truth) in enumerate(frames):
        found = {}
        for name in dicts:
            valid = np.asarray(out[name]["valid"][i])
            ids = np.asarray(out[name]["ids"][i])[valid]
            corners = np.asarray(out[name]["corners"][i])[valid]
            found.update({(name, int(m)): c for m, c in zip(ids, corners)})
        want = {(n, m): q for n, m, q in truth}
        assert set(found) == set(want)
        for k, q in want.items():
            assert np.linalg.norm(found[k] - q, axis=1).max() < 1.5, k


@pytest.mark.gpu
def test_detect_batch_gpu_matches_cpu(gpu):
    """The GPU-compiled detector and the CPU backend agree on rendered
    frames: same ids, corners within reduction-order noise."""
    import jax

    from arslam.detect.device_detect import params_from_config
    from arslam.detect.gen import marker_frame

    rng = np.random.default_rng(9)
    batch = np.stack([marker_frame(rng, 768, 1020)[0] for _ in range(4)])
    params = params_from_config(ArSlamConfig().detect)
    outs = []
    for dev in (gpu, jax.devices("cpu")[0]):
        with jax.default_device(dev):
            outs.append(jax.device_get(detect_batch(
                jax.device_put(batch, dev), params=params)))
    for name in ("4X4_50", "5X5_100"):
        np.testing.assert_array_equal(outs[0][name]["ids"],
                                      outs[1][name]["ids"])
        valid = outs[0][name]["valid"]
        np.testing.assert_allclose(outs[0][name]["corners"][valid],
                                   outs[1][name]["corners"][valid], atol=0.5)


def _label_plane(h=540, w=960, seed=0):
    """int32 labels: a pixel's own index where set, BIG elsewhere."""
    rng = np.random.default_rng(seed)
    idx = np.arange(h * w, dtype=np.int32).reshape(h, w)
    return np.where(rng.random((h, w)) < 0.3, idx, 2**30).astype(np.int32)


def _min_pool_np(x, k, s, padding):
    if padding == "SAME":
        x = np.pad(x, k // 2, constant_values=2**30)
    oh, ow = (x.shape[0] - k) // s + 1, (x.shape[1] - k) // s + 1
    out = np.full((oh, ow), 2**30, np.int32)
    for i in range(k):
        for j in range(k):
            out = np.minimum(out, x[i:i + s * oh:s, j:j + s * ow:s])
    return out


@pytest.mark.gpu
@pytest.mark.parametrize("k,s,padding", [(2, 2, "VALID"), (3, 1, "SAME")])
def test_min_pool_matches_numpy_on_gpu(gpu, k, s, padding):
    """The detector's min-pools (ranking grid 2x2/2, CCL 3x3/1) as
    reduce_window(min) over int32 labels equal NumPy on the card."""
    import jax

    lab = _label_plane()
    got = jax.jit(lambda x: jax.lax.reduce_window(
        x, np.int32(2**30), jax.lax.min, (k, k), (s, s), padding))(
            jax.device_put(lab, gpu))
    np.testing.assert_array_equal(np.asarray(got),
                                  _min_pool_np(lab, k, s, padding))


@pytest.mark.gpu
def test_negated_max_pool_gpu_fault(gpu):
    """Why the detector min-pools directly: on the GPU, jax 0.9.0's XLA
    computes the strided 2x2 pool -reduce_window(-x, max) of positive int32
    labels wrongly — every cell comes back negative, and most also differ
    from the negated min-pool (the CPU backend and the 3x3/1 form are
    right).  When this fails, XLA computes that form correctly again."""
    import jax

    lab = _label_plane()
    got = np.asarray(jax.jit(lambda x: -jax.lax.reduce_window(
        -x, np.int32(-2**30), jax.lax.max, (2, 2), (2, 2), "VALID"))(
            jax.device_put(lab, gpu)))
    want = _min_pool_np(lab, 2, 2, "VALID")
    assert (want > 0).all() and (got < 0).all()
