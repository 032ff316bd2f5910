"""Global (camera) motion compensation on the host: BoT-SORT's
``sparseOptFlow`` and StrongSORT's ``ecc``.

Counterpart of ``strongsort_yolo_tpu/track/gmc.py``, kept as this
package's own copy: numpy and OpenCV on the host, the same calls with the
same settings, so the two packages give the same (2, 3) warps on the
same frames. cv2 is imported where an estimate is made, so a machine
without it fails there with an ``ImportError`` (the ``"none"`` method
needs no cv2). The device estimator ``flow_tpu`` is
``track/gmc_flow.FlowGMC``.

The pipeline asks for one warp per frame before it dispatches the tick
(``Pipeline.track_async``, ``track_chunk``,
``BatchedPipeline.compute_warps``) and uploads it with the frames.
"""

from __future__ import annotations

import numpy as np

IDENTITY_WARP = np.array([[1.0, 0.0, 0.0], [0.0, 1.0, 0.0]], np.float32)
HOST_METHODS = ("sparseOptFlow", "ecc")


class SparseOptFlowGMC:
    """Frame-to-frame affine estimation on the host.

    method: "sparseOptFlow" (goodFeaturesToTrack + pyramidal LK +
    RANSAC partial-affine), "ecc" (ECC on the downscaled gray), or
    "none" (identity).
    """

    def __init__(self, method: str = "sparseOptFlow", downscale: int = 2):
        self.method = method
        self.downscale = max(1, int(downscale))
        self._prev_gray: np.ndarray | None = None

    def reset(self) -> None:
        self._prev_gray = None

    def apply(self, frame_bgr: np.ndarray) -> np.ndarray:
        """-> (2, 3) float32 affine warp mapping previous-frame coords to
        current-frame coords (identity on the first frame and on failure)."""
        if self.method == "none":
            return IDENTITY_WARP
        import cv2

        gray = cv2.cvtColor(frame_bgr, cv2.COLOR_BGR2GRAY)
        if self.downscale > 1:
            gray = cv2.resize(
                gray,
                (gray.shape[1] // self.downscale, gray.shape[0] // self.downscale),
            )
        warp = IDENTITY_WARP.copy()
        if self._prev_gray is not None:
            if self.method == "ecc":
                warp = self._ecc(self._prev_gray, gray)
            else:
                warp = self._sparse_flow(self._prev_gray, gray)
        self._prev_gray = gray
        return warp

    def _sparse_flow(self, prev: np.ndarray, cur: np.ndarray) -> np.ndarray:
        import cv2

        # ultralytics' sparseOptFlow feature settings; more than 4 points
        # tracked, or the identity
        pts = cv2.goodFeaturesToTrack(
            prev, maxCorners=1000, qualityLevel=0.01, minDistance=1,
            blockSize=3, useHarrisDetector=False, k=0.04,
        )
        if pts is None or len(pts) <= 4:
            return IDENTITY_WARP
        nxt, status, _ = cv2.calcOpticalFlowPyrLK(prev, cur, pts, None)
        ok = status.reshape(-1).astype(bool)
        if ok.sum() <= 4:
            return IDENTITY_WARP
        a, _ = cv2.estimateAffinePartial2D(pts[ok], nxt[ok], method=cv2.RANSAC)
        if a is None:
            return IDENTITY_WARP
        return self._upscale(a)

    def _ecc(self, prev: np.ndarray, cur: np.ndarray) -> np.ndarray:
        import cv2

        warp = np.eye(2, 3, dtype=np.float32)
        criteria = (cv2.TERM_CRITERIA_EPS | cv2.TERM_CRITERIA_COUNT, 100, 1e-5)
        try:
            _, warp = cv2.findTransformECC(
                prev, cur, warp, cv2.MOTION_EUCLIDEAN, criteria, None, 1
            )
        except cv2.error:
            return IDENTITY_WARP
        return self._upscale(warp)

    def _upscale(self, a: np.ndarray) -> np.ndarray:
        w = a.astype(np.float32).copy()
        if self.downscale > 1:
            w[:, 2] *= self.downscale
        return w


def make_gmc(method: str) -> SparseOptFlowGMC:
    """"sparseOptFlow" / "ecc" / "none" (or empty) -> its host estimator
    (the device estimator ``flow_tpu`` is ``gmc_flow.FlowGMC``)."""
    if method not in (*HOST_METHODS, "none", "", None):
        raise ValueError(f"no host GMC estimator {method!r}")
    return SparseOptFlowGMC(method=method or "none")
