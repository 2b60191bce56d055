"""Batched device Aruco detection — dense, fixed-budget re-cast of the oracle.

The reference runs cv::aruco::detectMarkers per image on CPU threads
(aruco_detector.cpp:93-135, two detector components in parallel).  Here the
whole batch of images goes through one jitted device program, and BOTH
dictionaries decode from one candidate extraction pass (the merge stage of
the reference collapses into this kernel).

Dense recasts of the sequential stages (SURVEY.md §7 "hard parts"):

- adaptive threshold: two cumsum-based box sums.
- connected components: iterative 3x3 min-label propagation + segmented
  min-scans along rows and columns — a few rounds per image, fully
  data-parallel (the contour-following replacement).
- quad corners: convex extreme points per component via masked segment
  reductions — A = farthest from centroid, C = farthest from A, B/D =
  extremes either side of line AC.  For a perspective-projected square
  these are exactly its corners; no contour walk needed.
- bit decode: per-candidate 8x8 homography solve, grid gather, per-candidate
  Otsu, and dictionary matching as one {0,1} matmul over all rotations
  of all markers.

Everything is shape-static: K candidate slots per image, padded outputs
with a valid mask.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from arslam.detect.dictionaries import get_dictionary

BIG = jnp.int32(2**30)


class DetectParams(NamedTuple):
    win: int = 23  # back-compat single window; win_sizes wins if set
    win_sizes: tuple = ()  # multi-scale thresholds (≙ cv2 win size sweep)
    thresh_c: float = 7.0
    max_candidates: int = 32
    # CCL round BOUND, not cost: the CCL loop exits early at fixpoint,
    # so typical images stop after a few rounds while high-bend
    # (serpentine) borders get the full budget (the ring stress test needs
    # 24; the round-1 default of 8 could under-merge silently)
    ccl_iters: int = 24
    min_perimeter_rate: float = 0.03
    max_perimeter_rate: float = 4.0
    min_corner_distance_rate: float = 0.1
    # cv2's minOtsuStdDev default is 5.0, but cv2 only decodes candidates
    # that survived contour + polygon approximation — a structural filter
    # the dense fixed-budget candidate stage here does not have.  At
    # sigma-10 pixel noise a bare noise speckle measures std ~6.5 after
    # the bilinear taps (4-tap averaging halves sigma) and chance-matches
    # a 16-bit word at corpus scale (all three round-5 stress-corpus
    # false positives were exactly this).  12 sits >3x above that floor
    # and >2x below any real printed marker's contrast (>=30 even under
    # the 0.55 illumination ramp + blur).
    min_otsu_std: float = 12.0
    # a cell must cover >= this many pixels of quad side to be decodable
    # at all (the sub-taps of smaller cells alias the same pixels); kills
    # sub-marker-scale speckle quads that no physical print could produce
    min_cell_px: float = 2.0
    # cv2 allows up to 35% erroneous border bits (maxErroneousBitsInBorderRate,
    # aruco detector defaults); requiring 85% dark border cost ~4 points of
    # 28-px stress recall (round-4 lab) with no measured precision change —
    # the hamming budget is the real precision gate
    border_frac: float = 0.65
    # bit decisiveness: 2*median|cell - 0.5| over the sampled grid — kills
    # blur-only regions; id discrimination comes from hamming matching.
    # 0.3 (not 0.6): heavy blur (sigma 2.2) legitimately halves the margin
    # on real 28-px markers (round-4 stress lab)
    min_bit_margin: float = 0.3
    # bilinear (not nearest) sampling of the bit grid: at 28-px markers a
    # cell is ~4.7 px and nearest-neighbor quantization noise flips bits
    # (+3 points of 28-px stress recall); 4 gathers instead of 1
    bilinear: bool = True
    # per-cell sampling margin (cv2 perspectiveRemoveIgnoredMarginPerCell
    # = 0.13): only the central band of each cell is sampled — boundary
    # pixels are blur-contaminated (stress corpus, docs/detection.md)
    cell_margin: float = 0.13
    sub: int = 3
    refine: bool = True
    refine_win: int = 5
    refine_iters: int = 4
    # OR-pool the binary planes d x d before CCL/ranking/extraction and map
    # the quads back to full-res (the subpixel refine recovers the <=(d-1)/2
    # px corner quantization).  CCL cost scales ~1/d^2 AND converges in
    # fewer rounds (component diameters shrink), which is where the
    # 3-window sweep's device time goes (53% at d=1, docs/detection.md).
    # Marker rings stay connected while quiet zones stay open down to
    # ~24-px markers at d=2 (ring ~2 decimated px, gap ~2).
    ccl_decimate: int = 2
    # top-k component ranking runs on a subsampled label grid (a quarter
    # of the sort's keys); areas rescale, candidate geometry stays
    # full-res.  1 = exact ranking.
    topk_subsample: int = 2
    # components covering more than this fraction of the image are DEMOTED
    # in the top-k ranking (scored below every plausible marker): a scene
    # whose large dark regions (shadows, furniture) outnumber
    # max_candidates must not evict marker-sized components.  cv2 has no
    # candidate budget to defend; this is the budget's guard rail.
    max_area_frac: float = 0.25
    # precision gate (round-5 FP lab): Otsu slicing a TEXTURELESS patch
    # (clutter + pixel noise) yields ~Bin(sub², ½) cell darknesses — almost
    # no cell is decisive — yet 16-bit hamming-0 chance matches happen at
    # corpus scale (~2^-16 × ids × rotations × candidates).  Real markers
    # are BIMODAL: even under σ2.2 blur at 28 px, ~half the cells sit hard
    # at 0/1 (the blur halves the MEDIAN margin, not the strong mass).
    # Require ≥ this fraction of cells with |darkness − ½| ≥ strong_cell_dev
    # (noise patches measure ~0.04 ± 0.03; worst real markers ~0.4).
    min_strong_cell_frac: float = 0.25
    strong_cell_dev: float = 0.35
    # keep only the best-analog-match dictionary when one candidate slot
    # passes in several (see per_image in detect_batch)
    cross_dict_arbitration: bool = True


def box_mean(img, win: int):
    """Windowed mean via padded cumsum (integral image), matching the
    oracle's box_mean."""
    pad = win // 2
    padded = jnp.pad(img, pad + 1, mode="edge").astype(jnp.float32)
    ii = jnp.cumsum(jnp.cumsum(padded, axis=0), axis=1)
    h, w = img.shape
    s = (
        ii[win:win + h, win:win + w]
        - ii[0:h, win:win + w]
        - ii[win:win + h, 0:w]
        + ii[0:h, 0:w]
    )
    return s / (win * win)


def adaptive_threshold(gray, win: int, c: float):
    return gray < box_mean(gray, win) - c


def _segmented_min_scan(labels, fg, axis, reverse):
    """Min-scan of ``labels`` along ``axis`` that resets at background
    pixels — a segmented scan via lax.associative_scan (log-depth, fully
    vectorized, no gathers)."""
    v = jnp.where(fg, labels, BIG)
    r = ~fg

    def combine(a, b):
        va, ra = a
        vb, rb = b
        return jnp.where(rb, vb, jnp.minimum(va, vb)), ra | rb

    out_v, _ = jax.lax.associative_scan(
        combine, (v, r), axis=axis, reverse=reverse
    )
    return jnp.where(fg, out_v, BIG)


def connected_components(binary, iters: int):
    """Label each foreground pixel with the min linear index of its
    8-connected component.  Background pixels get BIG.

    Dense recast of contour/union-find: each round propagates min labels
    across whole horizontal and vertical runs (4 segmented scans) plus one
    3x3 min-pool for diagonal links.  A round resolves one "bend" of a
    component, so ring-shaped marker borders converge in a few rounds —
    no 1-D gathers."""
    h, w = binary.shape
    idx = jnp.arange(h * w, dtype=jnp.int32).reshape(h, w)
    labels0 = jnp.where(binary, idx, BIG)

    def step(labels):
        # diagonal/8-connectivity links
        neigh = jax.lax.reduce_window(
            labels, np.int32(BIG), jax.lax.min, (3, 3), (1, 1), "SAME"
        )
        labels = jnp.where(binary, jnp.minimum(labels, neigh), BIG)
        # full-run propagation along rows then columns (both directions)
        labels = _segmented_min_scan(labels, binary, axis=1, reverse=False)
        labels = _segmented_min_scan(labels, binary, axis=1, reverse=True)
        labels = _segmented_min_scan(labels, binary, axis=0, reverse=False)
        labels = _segmented_min_scan(labels, binary, axis=0, reverse=True)
        return labels

    # fixpoint iteration with early exit: ``iters`` is an upper BOUND, so
    # it can be set high
    # enough for serpentine borders without taxing typical images, which
    # converge in a few rounds
    def cond(carry):
        i, _, changed = carry
        return (i < iters) & changed

    def body(carry):
        i, labels, _ = carry
        new = step(labels)
        return i + 1, new, jnp.any(new != labels)

    # initial `changed` is data-derived (all-background is already the
    # fixpoint) — also keeps the carry "varying" under shard_map, where a
    # constant True would mismatch the loop output's mesh-axis type
    _, labels, _ = jax.lax.while_loop(
        cond, body, (jnp.int32(0), labels0, jnp.any(binary)))
    return labels


def _top_k_components(labels_flat, k, grid_w: int,
                      max_area: float | None = None):
    """Top-k component root labels, scatter-free, RING-AWARE.

    One stable key/payload sort + scans:
    run lengths of the sorted label array give per-component areas, and the
    stable payload (grid position) gives each component's row span for
    free (ascending within a run, so run start/end positions are its
    top/bottom rows).

    Ranking score = area * (2 - fill), fill = area / row_span².  Marker
    borders are HOLLOW rings (area ≈ 4·L·t « L²), so pure-area ranking
    systematically favors filled clutter blobs of the same size; the
    hollowness boost (up to 2x) keeps marker-sized rings ahead of
    equal-footprint filled distractors.  Components larger than
    ``max_area`` grid cells are demoted below every plausibly marker-sized
    one (score in (0, 1)) so image-scale dark regions cannot evict markers
    from the fixed candidate budget at all; demoted slots fill only when
    nothing better exists and the downstream quad/decode filters reject
    them.  Returns (roots (k,) int32, areas (k,) float32 — RAW areas, not
    scores) with area 0 for empty slots (root BIG).
    """
    p = labels_flat.shape[0]
    pos = jnp.arange(p, dtype=jnp.int32)
    s, sp = jax.lax.sort((labels_flat, pos), num_keys=1, is_stable=True)
    is_start = jnp.concatenate([jnp.ones((1,), bool), s[1:] != s[:-1]])
    is_end = jnp.concatenate([s[1:] != s[:-1], jnp.ones((1,), bool)])
    # run start index at each position (cummax of start positions)
    start_pos = jax.lax.cummax(jnp.where(is_start, pos, -1))
    # at run ends, the full run length; 0 elsewhere / background
    cand_len = jnp.where(is_end & (s != BIG), pos - start_pos + 1, 0)
    # grid position of the run's first pixel, propagated to the run end
    first_gp = jax.lax.cummax(jnp.where(is_start, sp, -1))
    span = (sp // grid_w) - (first_gp // grid_w) + 1  # rows, valid at ends
    area_f = cand_len.astype(jnp.float32)
    fill = area_f / jnp.maximum(span * span, 1).astype(jnp.float32)
    score = area_f * (2.0 - jnp.minimum(fill, 1.0))
    if max_area is not None:
        score = jnp.where(area_f <= max_area, score,
                          0.5 + area_f / (2.0 * float(p) + 1.0))
    top_score, top_pos = jax.lax.top_k(score, k)
    top_area = jnp.where(top_score > 0, area_f[top_pos], 0.0)
    roots = jnp.where(top_score > 0, s[top_pos], BIG)
    return roots, top_area


def _extreme_quads(labels_flat, roots, h, w):
    """Per-candidate convex extreme points [A, B, C, D] — masked
    reductions over a (K, P) membership mask.

    The centroid uses the EXACT member count, not the possibly-subsampled
    ranking area estimate."""
    member = labels_flat[None, :] == roots[:, None]  # (K, P)

    ys, xs = jnp.meshgrid(jnp.arange(h, dtype=jnp.float32),
                          jnp.arange(w, dtype=jnp.float32), indexing="ij")
    xf = xs.reshape(-1)[None, :]
    yf = ys.reshape(-1)[None, :]

    area = member.astype(jnp.float32).sum(axis=1)
    area_safe = jnp.maximum(area, 1.0)[:, None]
    cx = jnp.where(member, xf, 0.0).sum(axis=1, keepdims=True) / area_safe
    cy = jnp.where(member, yf, 0.0).sum(axis=1, keepdims=True) / area_safe

    neg = jnp.float32(-3.0e38)

    def arg_extreme(score):
        """Per-candidate argmax over member pixels -> (K, 2) coords."""
        masked = jnp.where(member, score, neg)
        idx = jnp.argmax(masked, axis=1)  # (K,)
        return jnp.stack([xf[0, idx], yf[0, idx]], axis=-1)

    a = arg_extreme((xf - cx) ** 2 + (yf - cy) ** 2)
    c = arg_extreme((xf - a[:, 0:1]) ** 2 + (yf - a[:, 1:2]) ** 2)
    nx = -(c[:, 1:2] - a[:, 1:2])
    ny = c[:, 0:1] - a[:, 0:1]
    sdist = nx * (xf - a[:, 0:1]) + ny * (yf - a[:, 1:2])
    b = arg_extreme(sdist)
    d = arg_extreme(-sdist)
    return jnp.stack([a, b, c, d], axis=1)  # (K, 4, 2) around the hull


def _postprocess_quads(quad, top_area, h, w, params: DetectParams,
                       scale: int = 1):
    """Order/expand raw extreme-point quads and apply geometric filters.

    ``scale`` maps quads
    extracted on a ``ccl_decimate``-d plane back to full-res pixel coords
    (decimated cell (i, j) covers full pixels centered at
    d*i + (d-1)/2); ``h``/``w`` are always FULL-res.  Returns
    (quads (K, 4, 2) CW-from-topleft, areas (K,), valid (K,)).
    """
    if scale > 1:
        quad = quad * float(scale) + (scale - 1) / 2.0
        top_area = top_area * float(scale * scale)
    # order clockwise from top-left (like the oracle)
    center = quad.mean(axis=1, keepdims=True)
    ang = jnp.arctan2(quad[..., 1] - center[..., 1],
                      quad[..., 0] - center[..., 0])
    order = jnp.argsort(ang, axis=1)
    quad = jnp.take_along_axis(quad, order[..., None], axis=1)
    start = jnp.argmin(quad.sum(axis=-1), axis=1)
    roll_idx = (jnp.arange(4)[None, :] + start[:, None]) % 4
    quad = jnp.take_along_axis(quad, roll_idx[..., None], axis=1)

    # expand by half an ORIGINAL pixel to the cell edge.  On a decimated
    # plane the OR-pool's outward dilation already places the boundary
    # cell's center at the true edge in expectation — scaling the
    # expansion by d systematically overshoots (~0.7 px at d=2, enough to
    # shift 28-px markers' bit grids off their cells: recall 0.78 -> 0.40)
    centerq = quad.mean(axis=1, keepdims=True)
    d = quad - centerq
    norm = jnp.linalg.norm(d, axis=-1, keepdims=True)
    quad = quad + d / jnp.maximum(norm, 1e-9) * (0.5 * np.sqrt(2.0))

    k_area = top_area
    valid = k_area > 0

    # geometric filters
    edges = jnp.linalg.norm(quad - jnp.roll(quad, -1, axis=1), axis=-1)
    perimeter = edges.sum(axis=1)
    max_dim = float(max(h, w))
    valid &= perimeter >= 4 * params.min_perimeter_rate * max_dim * 0.5
    valid &= perimeter <= 4 * params.max_perimeter_rate * max_dim
    valid &= edges.min(axis=1) >= params.min_corner_distance_rate * perimeter
    # quad-ness: component area must cover a reasonable fraction of hull
    # boundary (ring components) — approximated by perimeter coverage
    valid &= k_area >= 0.5 * perimeter

    return quad, k_area, valid


def _top_k_subsampled(labels, k: int, subsample: int,
                      max_area_frac: float | None = None):
    """Top-k component roots ranked on a min-pooled label grid (areas
    rescaled by subsample²).

    Min-pooling (not plain striding) guarantees every component keeps at
    least one cell on the ranking grid — a 1-px ring on odd rows/cols
    cannot vanish.  At subsample=2, 8-connected components can never share
    a pooled cell (their pixels would be adjacent and thus merged), so
    each cell counts toward exactly its own component; the cell count
    upper-bounds area/subsample², erring permissive for the area filters.
    """
    s = max(int(subsample), 1)
    h, w = labels.shape
    max_area = (float(max_area_frac) * h * w
                if max_area_frac is not None else None)
    if s <= 1:
        return _top_k_components(labels.reshape(-1), k, w, max_area)
    hp, wp = -(-h // s) * s, -(-w // s) * s
    lab = labels
    if (hp, wp) != (h, w):
        lab = jnp.pad(labels, ((0, hp - h), (0, wp - w)),
                      constant_values=BIG)
    # a direct min-pool: XLA's GPU backend computes the equivalent strided
    # -max_pool(-labels) form wrongly (every cell comes back negative;
    # tests/test_device_detect.py::test_negated_max_pool_gpu_fault)
    pooled = jax.lax.reduce_window(
        lab, np.int32(BIG), jax.lax.min, (s, s), (s, s), "VALID"
    )
    roots, top_area = _top_k_components(
        pooled.reshape(-1), k, wp // s,
        max_area / (s * s) if max_area is not None else None)
    return roots, top_area * float(s * s)


def extract_candidates(labels, params: DetectParams, scale: int = 1,
                       full_hw=None):
    """Per-image candidate quads: no scatters, no per-label segment space.
    Top-K components come from one sort; all per-candidate stats are
    masked [K, P] reductions.

    ``labels`` may be a ``ccl_decimate``-d plane: pass the decimation as
    ``scale`` and the full-res image dims as ``full_hw`` so quads/filters
    come out in full-res pixels.

    Returns (quads (K, 4, 2) float32 ordered CW-from-topleft, areas (K,),
    valid (K,)).
    """
    h, w = labels.shape
    fh, fw = full_hw if full_hw is not None else (h * scale, w * scale)
    with jax.named_scope("detect_topk"):
        roots, top_area = _top_k_subsampled(
            labels, params.max_candidates, params.topk_subsample,
            params.max_area_frac)
    with jax.named_scope("detect_extract"):
        quad = _extreme_quads(labels.reshape(-1), roots, h, w)
        return _postprocess_quads(quad, top_area, fh, fw, params,
                                  scale=scale)


def homography_unit_square_batch(quads):
    """(K, 4, 2) quads -> (K, 3, 3) homographies (unit square -> quad)."""
    k = quads.shape[0]
    src = jnp.array([[0.0, 0], [1, 0], [1, 1], [0, 1]], dtype=quads.dtype)

    def one(quad):
        rows = []
        rhs = []
        for i in range(4):
            x, y = src[i, 0], src[i, 1]
            u, v = quad[i, 0], quad[i, 1]
            zero = jnp.zeros((), quads.dtype)
            one_ = jnp.ones((), quads.dtype)
            rows.append(jnp.stack([x, y, one_, zero, zero, zero,
                                   -u * x, -u * y]))
            rhs.append(u)
            rows.append(jnp.stack([zero, zero, zero, x, y, one_,
                                   -v * x, -v * y]))
            rhs.append(v)
        a = jnp.stack(rows)
        b = jnp.stack(rhs)
        h8 = jnp.linalg.solve(a, b)
        return jnp.concatenate([h8, jnp.ones((1,), quads.dtype)]).reshape(3, 3)

    return jax.vmap(one)(quads.astype(jnp.float32))


def otsu_batch(samples, bins: int = 32):
    """Per-row Otsu threshold.  samples (K, S) -> (K,) thresholds."""
    lo = samples.min(axis=1, keepdims=True)
    hi = samples.max(axis=1, keepdims=True)
    span = jnp.maximum(hi - lo, 1e-6)
    q = jnp.clip(((samples - lo) / span * bins).astype(jnp.int32), 0, bins - 1)
    hist = jax.nn.one_hot(q, bins, dtype=jnp.float32).sum(axis=1)  # (K, bins)
    centers = lo + (jnp.arange(bins, dtype=jnp.float32)[None, :] + 0.5) / bins * span
    w0 = jnp.cumsum(hist, axis=1)
    w1 = w0[:, -1:] - w0
    m0 = jnp.cumsum(hist * centers, axis=1)
    mt = m0[:, -1:]
    mu0 = m0 / jnp.maximum(w0, 1e-9)
    mu1 = (mt - m0) / jnp.maximum(w1, 1e-9)
    between = w0 * w1 * (mu0 - mu1) ** 2
    best = jnp.argmax(between, axis=1)
    return jnp.take_along_axis(centers, best[:, None], axis=1)[:, 0]


def _grid_points(n: int, sub: int, cm: float):
    """Unit-square sample points for an n×n cell grid, sub² taps per cell
    inside the central (1-2·cm) band.  Returns (P, 3) homogeneous points,
    row-major over (cell_v, tap_v, cell_u, tap_u) so ``samples.reshape(k,
    n, sub, n, sub)`` recovers the per-cell taps."""
    offs = cm + (jnp.arange(sub, dtype=jnp.float32) + 0.5) / sub * (
        1.0 - 2.0 * cm)
    cell = jnp.arange(n, dtype=jnp.float32)
    u = (cell[:, None] + offs[None, :]).reshape(-1) / n  # (n*sub,)
    uu, vv = jnp.meshgrid(u, u, indexing="xy")
    return jnp.stack(
        [uu, vv, jnp.ones_like(uu)], axis=-1).reshape(-1, 3)  # (P, 3)


def _bilinear_payload(gray):
    """(H*W, 4) stack of [g(y,x), g(y,x+1), g(y+1,x), g(y+1,x+1)] so all
    four bilinear corner fetches of a point ride ONE gathered row.

    Stacking the taps into the payload quarters the decode's
    gathered-index count vs stacking them on the offset axis, for one
    cheap elementwise pass building this array.  The rolls are safe
    because sampling clips x0 ≤ w-2, y0 ≤ h-2.
    """
    flat = gray.reshape(-1)
    w = gray.shape[1]
    return jnp.stack([
        flat,
        jnp.roll(flat, -1),
        jnp.roll(flat, -w),
        jnp.roll(flat, -(w + 1)),
    ], axis=-1)  # (H*W, 4)


def _project_points(quads, pts, h: int, w: int):
    """Project unit-square points through per-quad homographies to pixel
    coords.  quads (K, 4, 2), pts (P, 3) -> xy (K, P, 2) float32.

    Runs under float32 matmul precision: the homography solve and the
    projection einsum produce PIXEL COORDINATES (~1e2-1e3), where a
    reduced-precision product (bf16, TF32) carries ~1-2 px of noise —
    enough to flip bits of sub-5-px cells."""
    with jax.default_matmul_precision("float32"):
        hmat = homography_unit_square_batch(quads)  # (K, 3, 3)
        proj = jnp.einsum("kij,pj->kpi", hmat, pts,
                          precision=jax.lax.Precision.HIGHEST)
    xy = proj[..., :2] / jnp.maximum(jnp.abs(proj[..., 2:3]), 1e-9) * jnp.sign(
        proj[..., 2:3] + 1e-30
    )
    return xy


def _sample_points(gray, xy, params: DetectParams, payload4=None):
    """Sample the image at projected points.  xy (K, P, 2) -> (K, P).

    With ``params.bilinear``, pass ``payload4 = _bilinear_payload(gray)``
    (shared across dictionaries) to fetch all four taps per point in one
    gathered row; cv2's decode warps the patch (interpolating), and
    nearest-neighbor taps lose sub-5-px cells to quantization noise."""
    h, w = gray.shape
    if params.bilinear:
        xf = jnp.clip(xy[..., 0], 0.0, w - 1.0)
        yf = jnp.clip(xy[..., 1], 0.0, h - 1.0)
        x0 = jnp.clip(jnp.floor(xf).astype(jnp.int32), 0, w - 2)
        y0 = jnp.clip(jnp.floor(yf).astype(jnp.int32), 0, h - 2)
        fx = xf - x0.astype(xf.dtype)
        fy = yf - y0.astype(yf.dtype)
        lin = y0 * w + x0  # (K, P)
        if payload4 is None:
            payload4 = _bilinear_payload(gray)
        s4 = payload4[lin]  # (K, P, 4) — ONE gather, K*P indices
        w4 = jnp.stack([(1 - fx) * (1 - fy), fx * (1 - fy),
                        (1 - fx) * fy, fx * fy], axis=-1)
        return (s4 * w4).sum(axis=-1)
    xi = jnp.clip(jnp.round(xy[..., 0]).astype(jnp.int32), 0, w - 1)
    yi = jnp.clip(jnp.round(xy[..., 1]).astype(jnp.int32), 0, h - 1)
    return gray[yi, xi]  # (K, P)


def decode_candidates(gray, quads, valid, dict_name: str,
                      params: DetectParams, tables):
    """Decode candidate quads against one dictionary.

    Returns (marker_ids (K,), rot (K,), corners (K, 4, 2), ok (K,)).

    Single-dictionary convenience path (tests / oracle parity); the
    batched pipeline samples ALL dictionaries' grids through one shared
    projection + gather (see detect_batch) and decodes each from its
    slice with ``_decode_bits`` — identical math.
    """
    d_bits, _ = tables[dict_name]
    s = int(np.sqrt(d_bits.shape[2]))
    n = s + 2
    pts = _grid_points(n, params.sub, params.cell_margin)
    xy = _project_points(quads, pts, *gray.shape)
    samples = _sample_points(gray, xy, params)
    return _decode_bits(samples, quads, valid, dict_name, params,
                        tables)[:4]


def _decode_bits(samples, quads, valid, dict_name: str,
                 params: DetectParams, tables):
    """Threshold sampled grids and match against one dictionary.

    samples: (K, P) with P = (n·sub)² in _grid_points order."""
    d_bits, max_hamming = tables[dict_name]
    n_markers = d_bits.shape[1]
    s = int(np.sqrt(d_bits.shape[2]))
    b = 1
    n = s + 2 * b
    sub = params.sub

    k = quads.shape[0]
    flat = samples.reshape(k, -1)
    std_ok = flat.std(axis=1) >= params.min_otsu_std
    # min decodable cell size (see DetectParams.min_cell_px)
    edges = jnp.linalg.norm(quads - jnp.roll(quads, -1, axis=1), axis=-1)
    std_ok &= edges.min(axis=1) / n >= params.min_cell_px
    thresh = otsu_batch(flat)
    dark = flat < thresh[:, None]
    cells = dark.reshape(k, n, sub, n, sub).mean(axis=(2, 4))  # (K, n, n)
    grid_dark = cells > 0.5
    bit_margin = 2.0 * jnp.median(
        jnp.abs(cells - 0.5).reshape(k, -1), axis=1
    )
    margin_ok = bit_margin >= params.min_bit_margin
    # bimodality gate (see DetectParams.min_strong_cell_frac): texture-less
    # patches Otsu-sliced at their noise floor have almost no decisive cell
    strong_frac = jnp.mean(
        (jnp.abs(cells - 0.5) >= params.strong_cell_dev).astype(jnp.float32),
        axis=(1, 2))
    strong_ok = strong_frac >= params.min_strong_cell_frac

    border_mask = jnp.zeros((n, n), bool).at[:b, :].set(True)
    border_mask = border_mask.at[-b:, :].set(True)
    border_mask = border_mask.at[:, :b].set(True)
    border_mask = border_mask.at[:, -b:].set(True)
    border_frac = jnp.where(border_mask[None], grid_dark, False).sum(axis=(1, 2)) / border_mask.sum()
    border_ok = border_frac > params.border_frac

    inner = grid_dark[:, b:-b, b:-b]
    bits = (~inner).reshape(k, s * s).astype(jnp.float32)  # white = 1

    # hamming distance to all rotations of all markers via {0,1} matmuls
    t = d_bits.reshape(4 * n_markers, s * s).astype(jnp.float32)
    dist = bits @ (1.0 - t).T + (1.0 - bits) @ t.T  # (K, 4N)
    flat_idx = jnp.argmin(dist, axis=1)
    min_dist = jnp.take_along_axis(dist, flat_idx[:, None], axis=1)[:, 0]
    rot = flat_idx // n_markers
    marker_id = flat_idx % n_markers

    # ANALOG disagreement with the matched word (cross-dictionary
    # arbitration key): mean |whiteness − word_bit| over the inner grid.
    # An aligned true decode has cells hard at 0/1 (≈0.05-0.15); a
    # chance match on misaligned / textureless samples sits near 0.5
    # (≈0.3+) regardless of its (lucky) hamming distance.
    analog = 1.0 - cells[:, b:-b, b:-b].reshape(k, s * s)  # whiteness
    word = t[flat_idx]  # (K, s²)
    soft_dist = jnp.mean(jnp.abs(analog - word), axis=1)

    ok = (valid & std_ok & border_ok & margin_ok & strong_ok
          & (min_dist <= max_hamming))
    # canonicalize corner order: forward-roll by rot
    roll_idx = (jnp.arange(4)[None, :] - rot[:, None]) % 4
    corners = jnp.take_along_axis(quads, roll_idx[..., None], axis=1)
    return marker_id, rot, corners, ok, soft_dist


def refine_corners_batched(grays, corners, win: int, iters: int):
    """Gradient-based subpixel corner refinement (cornerSubPix-style normal
    equations on a (2*win+1)² window) for a whole batch.

    The window sums are precomputed ONCE as box-filtered field maps
    (integral images) — Σgx², Σgxgy, Σgy², Σ(gx²x+gxgy·y), Σ(gxgy·x+gy²y) —
    so each refinement iteration is 5 scalar reads per corner instead of a
    (2*win+1)² gather.

    Args:
      grays: (N, H, W) float32.
      corners: (N, K, 4, 2).
    """
    n, h, w = grays.shape
    gy, gx = jnp.gradient(grays, axis=(1, 2))
    x = jax.lax.broadcasted_iota(jnp.float32, (h, w), 1)[None]
    y = jax.lax.broadcasted_iota(jnp.float32, (h, w), 0)[None]
    gxx, gxy, gyy = gx * gx, gx * gy, gy * gy
    wsz = 2 * win + 1

    scale = float(wsz * wsz)

    def box(img_b):
        return jax.vmap(lambda im: box_mean(im, wsz) * scale)(img_b)

    fields = jnp.stack([
        box(gxx), box(gxy), box(gyy),
        box(gxx * x + gxy * y), box(gxy * x + gyy * y),
    ], axis=1)  # (N, 5, H, W)

    flat = corners.reshape(n, -1, 2)

    def step(i, c):
        cx, cy = c[..., 0], c[..., 1]  # (N, Kc)
        x0 = jnp.clip(jnp.round(cx).astype(jnp.int32), win + 1, w - win - 2)
        y0 = jnp.clip(jnp.round(cy).astype(jnp.int32), win + 1, h - win - 2)
        taps = jax.vmap(lambda f, yy, xx: f[:, yy, xx])(fields, y0, x0)
        a, b, d, bx, by = (taps[:, i] for i in range(5))  # (N, Kc) each
        det = a * d - b * b
        ok = jnp.abs(det) > 1e-6
        safe = jnp.where(ok, det, 1.0)
        nx = jnp.where(ok, (d * bx - b * by) / safe, cx)
        ny = jnp.where(ok, (a * by - b * bx) / safe, cy)
        # reject wild jumps (low-texture windows)
        jump = jnp.hypot(nx - cx, ny - cy)
        keep = ok & (jump < 2.0 * win)
        return jnp.stack([jnp.where(keep, nx, cx),
                          jnp.where(keep, ny, cy)], axis=-1)

    out = jax.lax.fori_loop(0, iters, step, flat)
    return out.reshape(corners.shape)


def refine_corners_batch(gray, corners, win: int, iters: int):
    """Single-image wrapper kept for tests/compat."""
    return refine_corners_batched(gray[None], corners[None], win, iters)[0]


def make_tables(dict_names, max_hamming=None):
    """Host-side: rotation-expanded dictionary tables as arrays."""
    out = {}
    from arslam.detect.reference import _default_hamming

    for name in dict_names:
        d = get_dictionary(name)
        mh = (max_hamming or {}).get(name, _default_hamming(d))
        out[name] = (jnp.asarray(d.rotations), float(mh))
    return out


def params_from_config(dcfg) -> DetectParams:
    """DetectParams for a ``config.DetectConfig`` (the production sweep)."""
    return DetectParams(
        win=dcfg.adaptive_thresh_win_sizes[0],
        win_sizes=tuple(dcfg.adaptive_thresh_win_sizes),
        thresh_c=dcfg.adaptive_thresh_constant,
        max_candidates=dcfg.max_candidates,
        min_corner_distance_rate=dcfg.min_corner_distance_rate,
        min_perimeter_rate=dcfg.min_marker_perimeter_rate,
        max_perimeter_rate=dcfg.max_marker_perimeter_rate,
    )


@partial(jax.jit, static_argnames=("params", "dict_names"))
def detect_batch(images, *, params: DetectParams = DetectParams(),
                 dict_names=("4X4_50", "5X5_100")):
    """Detect markers in a batch of grayscale images.

    Args:
      images: (N, H, W) uint8/float grayscale.

    Returns dict with, per dictionary name:
      ids (N, K) int32 marker ids (-1 invalid), corners (N, K, 4, 2)
      float32 pixel coords (canonical corner order), valid (N, K) bool.
    """
    tables = make_tables(dict_names)
    images = images.astype(jnp.float32)
    windows = tuple(params.win_sizes) or (params.win,)

    # Multi-window sweep: the per-window binarizations STACK ON THE BATCH
    # AXIS, so CCL/topk/extract compile and launch exactly once regardless
    # of sweep width (a serialized per-window loop multiplies both device
    # and compile time); candidates fold back to the per-image K axis and
    # duplicates suppress after decode.
    def threshold_batch(win):
        return jax.vmap(
            lambda g: adaptive_threshold(g, win, params.thresh_c)
        )(images)

    n, h, w = images.shape
    k = params.max_candidates
    nw = len(windows)
    with jax.named_scope("detect_threshold"):
        bins = [threshold_batch(win) for win in windows]
        binary_b = bins[0] if nw == 1 else jnp.concatenate(bins, axis=0)

    # decimate the binary planes for CCL/ranking/extraction (quads map back
    # to full-res below; the full-res subpixel refine absorbs the
    # quantization).  COUNT-pool (cell dark iff >= half its pixels are):
    # an OR-pool doubles isolated noise speckle and bridges quiet zones —
    # at sigma-10 pixel noise it destroyed EVERY 28-px candidate — while
    # the count pool is a fused mild opening: single-pixel speckle dies,
    # >= d-px structures (marker border rings) survive.
    d = max(int(params.ccl_decimate), 1)
    if d > 1:
        hd, wd = -(-h // d), -(-w // d)
        with jax.named_scope("detect_decimate"):
            bpad = binary_b
            if (hd * d, wd * d) != (h, w):
                bpad = jnp.pad(binary_b,
                               ((0, 0), (0, hd * d - h), (0, wd * d - w)))
            counts = bpad.reshape(
                binary_b.shape[0], hd, d, wd, d
            ).astype(jnp.int32).sum(axis=(2, 4))
            binary_b = counts >= (d * d + 1) // 2

    with jax.named_scope("detect_ccl"):
        labels_b = jax.vmap(
            lambda b: connected_components(b, params.ccl_iters)
        )(binary_b)

    # ranking subsample applies ON the (possibly decimated) plane: the
    # min-pool survival + no-shared-cell guarantees hold per plane (see
    # _top_k_subsampled)
    q, _, v = jax.vmap(
        lambda ll: extract_candidates(ll, params, scale=d, full_hw=(h, w))
    )(labels_b)

    # (nw*N, K, ...) -> (N, nw*K, ...): window-major stacks fold back to
    # the per-image candidate axis, then COMPACT to the K budget:
    # valid-first, larger-perimeter-first (the keep-the-bigger-candidate
    # convention).  The sweep's nw*K slots are mostly padding + cross-
    # window duplicates, and decode cost (the bilinear grid gathers)
    # scales with the slot count.
    if nw > 1:
        quads_b = q.reshape(nw, n, k, 4, 2).transpose(1, 0, 2, 3, 4)
        quads_b = quads_b.reshape(n, nw * k, 4, 2)
        valid_b = v.reshape(nw, n, k).transpose(1, 0, 2).reshape(n, nw * k)
        with jax.named_scope("detect_compact"):
            perim = jnp.linalg.norm(
                quads_b - jnp.roll(quads_b, -1, axis=2), axis=-1
            ).sum(axis=2)
            # cross-window dedup in the top-K RANKING: the same marker
            # detected in all nw windows is near-identical geometry
            # (centers within a couple px) and would otherwise occupy nw
            # of the K slots — scenes with > ~K/nw real markers would
            # evict small valid quads.  Duplicates are DEMOTED below every
            # non-duplicate, NOT invalidated: under heavy blur the
            # windows' quads of one marker differ enough that only one of
            # them decodes, and which one is unknowable before decode —
            # round-5 lab measured both a drop-the-duplicate version
            # (recall 0.928 -> 0.914: the kept quad sometimes fails
            # decode) and a loose-gate (1.5x-perimeter) version that ate
            # true quads in favor of CONCENTRIC junk components
            # (marker + quiet zone + clutter, ~1.4x perimeter; recall
            # 0.56).  Demoted duplicates still decode whenever the K
            # budget has room; _suppress_duplicates arbitrates after
            # decode as before.
            centers = quads_b.mean(axis=2)  # (N, M, 2)
            cdist = jnp.linalg.norm(
                centers[:, :, None] - centers[:, None, :], axis=-1)
            pmin = jnp.minimum(perim[:, :, None], perim[:, None, :])
            pmax = jnp.maximum(perim[:, :, None], perim[:, None, :])
            both = valid_b[:, :, None] & valid_b[:, None, :]
            m = perim.shape[1]
            dup = (both & (cdist < 0.1 * pmin / 4.0)
                   & (pmax < 1.1 * pmin)
                   & ~jnp.eye(m, dtype=bool)[None])
            beaten = (dup & (
                (perim[:, None, :] > perim[:, :, None])
                | ((perim[:, None, :] == perim[:, :, None])
                   & (jnp.arange(m)[None, None, :]
                      < jnp.arange(m)[None, :, None]))
            )).any(axis=2)
            # rank: non-duplicate valids first (perim + LARGE), duplicate
            # valids next (bare perim), invalid slots last.  The sweep
            # decodes 2K slots (not K): under pixel noise a threshold
            # plane grows >K valid speckle quads and a perimeter cut at K
            # evicts real small markers (round-5 lab: -4 hits in the
            # blur-2.2/noise-10 cells at K).
            key = jnp.where(valid_b, perim + jnp.where(beaten, 0.0, 1e6),
                            -1.0)
            kdec = min(2 * k, nw * k)
            order = jnp.argsort(-key, axis=1)[:, :kdec]  # (N, 2K)
            quads_b = jnp.take_along_axis(
                quads_b, order[..., None, None], axis=1)
            valid_b = jnp.take_along_axis(valid_b, order, axis=1)
    else:
        quads_b, valid_b = q, v

    # subpixel-refine once on the shared candidate quads (before decode:
    # better bit sampling, and not repeated per dictionary)
    if params.refine:
        with jax.named_scope("detect_refine"):
            quads_b = refine_corners_batched(
                images, quads_b, params.refine_win, params.refine_iters)

    # one point set for ALL dictionaries: their grids concatenate on the
    # point axis, so the homography solve, the projection einsum and the
    # bilinear gather run ONCE per image (the gather was 32.8% of device
    # time when each dictionary paid its own; cost scales with index count)
    grid_pts = []
    splits = [0]
    for name in dict_names:
        s_d = int(np.sqrt(tables[name][0].shape[2]))
        grid_pts.append(_grid_points(s_d + 2, params.sub, params.cell_margin))
        splits.append(splits[-1] + grid_pts[-1].shape[0])
    pts_all = jnp.concatenate(grid_pts, axis=0)  # (P_all, 3)

    def per_image(gray, quads, valid):
        with jax.named_scope("detect_decode_sample"):
            xy = _project_points(quads, pts_all, h, w)
            payload4 = _bilinear_payload(gray) if params.bilinear else None
            samples_all = _sample_points(gray, xy, params, payload4)
        decoded = []
        for i, name in enumerate(dict_names):
            with jax.named_scope(f"detect_decode_{name}"):
                decoded.append(_decode_bits(
                    samples_all[:, splits[i]:splits[i + 1]], quads, valid,
                    name, params, tables
                ))
        if len(dict_names) > 1 and params.cross_dict_arbitration:
            # cross-dictionary arbitration: a real marker of one
            # dictionary, re-sampled on another dictionary's cell
            # alignment, yields semi-random bits that chance-match a word
            # at corpus scale (a 16-bit hamming-0 match is ~2^-16 x ids x
            # rotations per candidate — round-5 FP lab caught exactly
            # this).  When the SAME candidate slot passes in several
            # dictionaries, keep the smallest ANALOG disagreement: the
            # aligned true decode is hard at 0/1, the chance match is not.
            # (Divergence from the reference, which runs detectors
            # independently and would add both landmarks; see README.)
            soft = jnp.stack([
                jnp.where(ok, sd, jnp.inf)
                for (_, _, _, ok, sd) in decoded
            ])  # (D, K)
            best = jnp.argmin(soft, axis=0)  # (K,)
            decoded = [
                (dmid, rot, crn, ok & (best == i), sd)
                for i, (dmid, rot, crn, ok, sd) in enumerate(decoded)
            ]
        out = {}
        for i, name in enumerate(dict_names):
            mid, rot, corners, ok, _ = decoded[i]
            if len(windows) > 1:
                ok = _suppress_duplicates(mid, corners, ok)
            out[name] = {
                "ids": jnp.where(ok, mid, -1),
                "corners": corners,
                "valid": ok,
            }
        return out

    return jax.vmap(per_image)(images, quads_b, valid_b)


def _suppress_duplicates(ids, corners, ok):
    """Drop repeated detections of the same marker from different threshold
    windows: keep the largest-perimeter instance (cv2 keeps the bigger
    candidate too)."""
    centers = corners.mean(axis=1)  # (K, 2)
    perim = jnp.linalg.norm(
        corners - jnp.roll(corners, -1, axis=1), axis=-1
    ).sum(axis=1)  # (K,)
    k = ids.shape[0]
    same = (ids[:, None] == ids[None, :]) & ok[:, None] & ok[None, :]
    dist = jnp.linalg.norm(centers[:, None] - centers[None, :], axis=-1)
    close = dist < 0.5 * jnp.minimum(perim[:, None], perim[None, :]) / 4.0
    dup = same & close & ~jnp.eye(k, dtype=bool)
    # j beats i if larger perimeter, or equal perimeter and lower index
    beats = dup & (
        (perim[None, :] > perim[:, None])
        | ((perim[None, :] == perim[:, None])
           & (jnp.arange(k)[None, :] < jnp.arange(k)[:, None]))
    )
    return ok & ~beats.any(axis=1)
