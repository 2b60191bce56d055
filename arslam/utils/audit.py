"""Per-block reprojection audit (≙ ``ArSlamSolver::compareProjections`` /
``compareProjection``, ar_slam_util.cpp:576-589 and :175-189).

The reference walks every block and prints the projected vs. detected corner
coordinates for eyeballing solver quality.  Here the projection of the whole
block table is ONE device call (the same vmapped residual kernel the solver
uses) and the audit returns structured rows — capture uid, tag id, per-corner
error, block RMSE — for logging, assertions, or the CLI table.
"""

from __future__ import annotations

import numpy as np

from arslam.graph.arrays import export_arrays
from arslam.graph.store import MapStore


def compare_projections(store: MapStore, aruco_size: float = 0.0635,
                        dtype=np.float64) -> list[dict]:
    """Return one audit row per block, ordered by descending block RMSE."""
    import jax.numpy as jnp

    from arslam.solve.residuals import residuals_only

    if not store.blocks:
        return []
    arrs = export_arrays(store, dtype=dtype)
    r = residuals_only(
        jnp.asarray(arrs.camera), jnp.asarray(arrs.cap_poses),
        jnp.asarray(arrs.tag_poses), jnp.asarray(arrs.cap_idx),
        jnp.asarray(arrs.tag_idx), jnp.asarray(arrs.corners),
        jnp.asarray(arrs.block_mask), aruco_size,
    )
    r = np.asarray(r)[: len(store.blocks)].reshape(-1, 4, 2)
    rows = []
    for bh, block in enumerate(store.blocks):
        err = r[bh]
        rows.append({
            "capture": store.captures[block.cap_idx].uid,
            "aruco": store.arucos[block.tag_idx].id,
            "corner_err_px": [float(np.hypot(*e)) for e in err],
            "rmse_px": float(np.sqrt(np.mean(err ** 2) * 2.0)),
            "observed": np.asarray(block.corners, dtype=float).tolist(),
            "projected": (np.asarray(block.corners, dtype=float)
                          + err).tolist(),
        })
    rows.sort(key=lambda d: -d["rmse_px"])
    return rows


def format_audit(rows: list[dict], limit: int = 0) -> str:
    """Human-readable audit table (worst blocks first)."""
    out = []
    shown = rows[:limit] if limit else rows
    for d in shown:
        corners = " ".join(f"{e:6.2f}" for e in d["corner_err_px"])
        out.append(
            f"{d['capture']:>12s} {d['aruco']:>18s}  rmse {d['rmse_px']:7.3f}"
            f" px  corners [{corners}]"
        )
    if limit and len(rows) > limit:
        out.append(f"... {len(rows) - limit} more blocks")
    return "\n".join(out)
