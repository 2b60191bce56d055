"""Host-side constraint-graph store.

The array-friendly decomposition of the reference's ``ArSlamSolver`` bookkeeping
(deques + uid→handle maps, ar_slam_util.hpp:419-492): a pure-Python
struct-of-records store holding the capture–tag bipartite graph, with
integer indices as handles and NumPy pose state.  Device-side solvers consume
padded array exports (see ``arslam.graph.arrays``); all stringly-keyed
bookkeeping stays on the host.

Behavioral parity notes:
- Capture uids are unique; ``gen_unique_capture_uid`` replicates
  ``genUniqueCaptureUid`` (ar_slam_util.cpp:288-301): ``cap_<n>``, then
  ``cap_<n>_<k>`` suffixes.
- ``add_detections`` replicates ``ArSlamSolver::addDetections``
  (ar_slam_util.cpp:591-627): empty detection list → ignored; mismatched
  image size → warn + drop; duplicate uid → warn (the reference builds an
  error message but does not throw) and the capture is still added; new
  captures enter the unsolved pool.
- An optional native C++ index backend accelerates uid interning for large
  maps (see ``arslam/native``); semantics are identical.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass, field

import numpy as np

logger = logging.getLogger(__name__)


def _native_default() -> bool:
    """Use the C++ topology core when built (override: AR_SLAM_NATIVE=0)."""
    import os

    if os.environ.get("AR_SLAM_NATIVE", "1") == "0":
        return False
    try:
        from arslam.graph import native

        return native.available()
    except Exception:  # noqa: BLE001
        return False


@dataclass
class Capture:
    """One camera capture (≙ reference Capture, ar_slam_util.hpp:192-225).

    ``inv_pose`` stores the INVERSE pose ``[t(3), axis-angle(3)]`` because
    the optimizer uses the inverse more often (ar_slam_util.hpp:204-208).
    """

    uid: str
    index: int
    img_fn: str = ""
    inv_pose: np.ndarray = field(default_factory=lambda: np.zeros(6))
    blocks: list[int] = field(default_factory=list)
    init_block: int | None = None


@dataclass
class Aruco:
    """One unique AR tag (≙ reference Aruco, ar_slam_util.hpp:229-240)."""

    id: str
    index: int
    pose: np.ndarray = field(default_factory=lambda: np.zeros(6))
    initialized: bool = False
    blocks: list[int] = field(default_factory=list)


@dataclass
class Block:
    """One observation: a tag's 4 detected corners in one capture
    (≙ reference Block, ar_slam_util.hpp:296-315).  ``corners`` are centered
    pixel coordinates, corner order TL, TR, BR, BL."""

    index: int
    cap_idx: int
    tag_idx: int
    corners: np.ndarray  # (4, 2)
    added: bool = False


@dataclass
class CameraState:
    """Shared intrinsics ``[focal, l1, l2]`` + expected image size
    (≙ CameraParams, ar_slam_util.hpp:64-76)."""

    params: np.ndarray = field(default_factory=lambda: np.array([3000.0, 0.0, 0.0]))
    size: tuple[int, int] | None = None  # (width, height)
    # True once the focal is trusted (loaded from a checkpoint or
    # self-calibrated) — prevents re-estimation on incremental extends.
    focal_calibrated: bool = False


class MapStore:
    """The capture–tag bipartite constraint graph.

    With ``native=True`` (default: auto-detect) the graph TOPOLOGY is
    mirrored into the C++ core (arslam.graph.native) and the heavy
    topology queries — BFS ordering, seed selection, bulk block export —
    are served natively; pose state stays in NumPy on the Python side.
    """

    def __init__(self, initial_focal: float = 3000.0,
                 native: bool | None = None):
        self.captures: list[Capture] = []
        self.arucos: list[Aruco] = []
        self.blocks: list[Block] = []
        self.capture_map: dict[str, int] = {}
        self.aruco_map: dict[str, int] = {}
        self.camera = CameraState(params=np.array([initial_focal, 0.0, 0.0]))
        self.unsolved_captures: set[int] = set()
        self._native = None
        if native is None:
            native = _native_default()
        if native:
            from arslam.graph.native import NativeGraph

            self._native = NativeGraph()

    # ---- mutation ---------------------------------------------------------

    def add_capture(self, uid: str, img_fn: str = "") -> Capture:
        if uid in self.capture_map:
            raise ValueError(f"capture with id {uid} already exists")
        cap = Capture(uid=uid, index=len(self.captures), img_fn=img_fn)
        self.captures.append(cap)
        self.capture_map[uid] = cap.index
        if self._native is not None:
            self._native.add_capture(uid, img_fn)
        return cap

    def add_aruco(self, tag_id: str) -> Aruco:
        if tag_id in self.aruco_map:
            raise ValueError(f"aruco with id {tag_id} already exists")
        tag = Aruco(id=tag_id, index=len(self.arucos))
        self.arucos.append(tag)
        self.aruco_map[tag_id] = tag.index
        if self._native is not None:
            self._native.get_or_add_aruco(tag_id)
        return tag

    def get_or_add_aruco(self, tag_id: str) -> Aruco:
        idx = self.aruco_map.get(tag_id)
        if idx is not None:
            return self.arucos[idx]
        return self.add_aruco(tag_id)

    def add_block(self, corners: np.ndarray, cap_idx: int, tag_idx: int) -> Block:
        corners = np.asarray(corners, dtype=float).reshape(4, 2)
        block = Block(
            index=len(self.blocks), cap_idx=cap_idx, tag_idx=tag_idx, corners=corners
        )
        self.blocks.append(block)
        self.captures[cap_idx].blocks.append(block.index)
        self.arucos[tag_idx].blocks.append(block.index)
        if self._native is not None:
            self._native.add_block(cap_idx, tag_idx, corners)
        return block

    def bulk_add_blocks(self, corners: np.ndarray, cap_idx: np.ndarray,
                        tag_idx: np.ndarray) -> None:
        """Append many blocks at once (checkpoint restore of large maps).

        Semantics identical to repeated ``add_block``; one native call and
        per-block corner VIEWS into a single parsed array instead of 263k
        ctypes round trips + array copies.
        """
        corners = np.ascontiguousarray(corners, dtype=float).reshape(-1, 4, 2)
        cap_idx = np.ascontiguousarray(cap_idx, dtype=np.int32)
        tag_idx = np.ascontiguousarray(tag_idx, dtype=np.int32)
        base = len(self.blocks)
        blocks = self.blocks
        captures, arucos = self.captures, self.arucos
        for k, (c, t) in enumerate(zip(cap_idx.tolist(), tag_idx.tolist())):
            idx = base + k
            blocks.append(Block(index=idx, cap_idx=c, tag_idx=t,
                                corners=corners[k]))
            captures[c].blocks.append(idx)
            arucos[t].blocks.append(idx)
        if self._native is not None:
            self._native.bulk_add_blocks(cap_idx, tag_idx, corners)

    def gen_unique_capture_uid(self) -> str:
        base = f"cap_{len(self.captures)}"
        if base not in self.capture_map:
            return base
        for idx in range(1000):
            uid = f"{base}_{idx}"
            if uid not in self.capture_map:
                return uid
        raise RuntimeError("cannot generate unique id")

    def add_detections(
        self,
        capture_uid: str,
        detections: list[tuple[str, np.ndarray]],
        image_size: tuple[int, int] | None = None,
        image_path: str = "",
    ) -> int | None:
        """Ingest one capture's merged detections.

        Args:
          capture_uid: uid for the new capture.
          detections: list of ``(tag_id, corners(4,2) centered coords)``.
          image_size: (width, height) of the source image.

        Returns the new capture index, or None if dropped.
        """
        if not detections:
            return None
        if image_size is not None:
            if self.camera.size is not None:
                if tuple(self.camera.size) != tuple(image_size):
                    logger.warning(
                        "Mismatched image size expected %s got %s",
                        self.camera.size,
                        image_size,
                    )
                    return None
            else:
                self.camera.size = tuple(image_size)
        if capture_uid in self.capture_map:
            # Reference builds an error string but does not throw
            # (ar_slam_util.cpp:612-616); mirror with a warning + unique uid.
            logger.warning("capture uid %s already exists", capture_uid)
            capture_uid = self.gen_unique_capture_uid()
        cap = self.add_capture(capture_uid, image_path)
        # intern tags first (same creation order as interleaved add_block),
        # then insert the capture's blocks in one bulk call
        tag_idx = np.fromiter(
            (self.get_or_add_aruco(tag_id).index for tag_id, _ in detections),
            np.int32, len(detections))
        corners = np.stack([np.asarray(c, dtype=float).reshape(4, 2)
                            for _, c in detections])
        self.bulk_add_blocks(
            corners, np.full(len(detections), cap.index, np.int32), tag_idx)
        self.unsolved_captures.add(cap.index)
        return cap.index

    # ---- queries ----------------------------------------------------------

    @property
    def next_capture_index(self) -> int:
        return len(self.captures)

    def check_image_size(self, size: tuple[int, int]) -> tuple[int, int] | str:
        """Size-gauge logic (≙ checkAndFixImageSize, ar_slam_util.cpp:219-245).

        Returns the (possibly 90°-rotated) size to use, or raises if the
        image cannot be reconciled.  Callers rotate the actual pixels.
        """
        if self.camera.size is None:
            self.camera.size = tuple(size)
            return tuple(size)
        cw, ch = self.camera.size
        w, h = size
        if (w, h) == (ch, cw):
            logger.warning(
                "some images are rotated relative to others; rotating 90 degrees"
            )
            return (cw, ch)
        if (w, h) != (cw, ch):
            raise ValueError(
                f"Loaded images should all be same size: expected {self.camera.size}"
                f" got {size}"
            )
        return (w, h)

    def connected_component(self, seed_cap: int) -> list[int]:
        """BFS capture order from a seed over shared tags, recording each
        capture's init_block exactly like addConnectedCaptures
        (ar_slam_util.cpp:869-885).  Served by the native core when built."""
        if self._native is not None:
            order, init_blocks = self._native.bfs_order(seed_cap)
            for idx, ib in zip(order.tolist(), init_blocks.tolist()):
                self.captures[idx].init_block = ib if ib >= 0 else -1
            return order.tolist()
        order = [seed_cap]
        self.captures[seed_cap].init_block = -1  # sentinel: seed has no init block
        queue = [seed_cap]
        while queue:
            cap = self.captures[queue.pop(0)]
            for bh in cap.blocks:
                tag = self.arucos[self.blocks[bh].tag_idx]
                for tbh in tag.blocks:
                    other = self.captures[self.blocks[tbh].cap_idx]
                    if other.init_block is None:
                        other.init_block = tbh
                        order.append(other.index)
                        queue.append(other.index)
        return order

    def capture_with_most_blocks(self) -> int:
        """Seed selection (≙ ar_slam_util.cpp:759-771): first capture with the
        max block count."""
        if self._native is not None:
            return self._native.capture_with_most_blocks()
        best, best_n = 0, len(self.captures[0].blocks)
        for idx in range(1, len(self.captures)):
            n = len(self.captures[idx].blocks)
            if n > best_n:
                best, best_n = idx, n
        return best

    def stats(self) -> dict:
        return {
            "captures": len(self.captures),
            "arucos": len(self.arucos),
            "blocks": len(self.blocks),
            "unsolved": len(self.unsolved_captures),
            "focal": float(self.camera.params[0]),
        }
