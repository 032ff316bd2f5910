"""Streaming per-class unique-track counting (reference F7, fixed).

The reference's ``--count`` re-reads the entire label file with pandas
every frame and takes the per-track majority class
(``yolo_multi_model.py:284-309``), O(frames^2). This replacement keeps
a running per-track class histogram and per-class majority tally, so
each frame is O(active tracks) and the resulting dict is identical to
the pandas pipeline's output:

- per track id, the majority class over its lifetime (ties go to the
  smaller class id, as the reference's sorted list + ``Counter`` does);
- count of tracks per majority class, keyed by class NAME, sorted.

Also the directional line-cross tally (``--count-line``). Counterpart of
``strongsort_yolo_tpu/utils/counting.py``, kept as it is.
"""

from __future__ import annotations

from collections import defaultdict


class StreamingCounter:
    def __init__(self, names: dict[int, str]):
        self.names = names
        # track -> {cls: [count, first_seen_order]}
        self._hist: dict[int, dict[int, list[int]]] = defaultdict(dict)
        self._seen_order: dict[int, int] = defaultdict(int)

    def update(self, boxes) -> None:
        """boxes: pipeline.Boxes with .id (track mode)."""
        if boxes is None or boxes.id is None:
            return
        for i in range(len(boxes)):
            tid = int(boxes.id[i])
            cls = int(boxes.cls[i])
            h = self._hist[tid]
            if cls not in h:
                h[cls] = [0, self._seen_order[tid]]
                self._seen_order[tid] += 1
            h[cls][0] += 1

    def majority_class(self, tid: int) -> int:
        h = self._hist[tid]
        # max count; ties -> smaller class id (sorted() + Counter
        # behavior in the reference: list is sorted before counting,
        # so most_common ties resolve to the smaller class id)
        return min(h, key=lambda c: (-h[c][0], c))

    def counts(self) -> dict[str, int]:
        """{class_name: number of unique tracks}, name-sorted — the
        dict the reference renders at yolo_multi_model.py:304-305."""
        per_class: dict[int, int] = defaultdict(int)
        for tid in self._hist:
            per_class[self.majority_class(tid)] += 1
        named = {
            self.names.get(c, str(c)): n for c, n in per_class.items()
        }
        return dict(sorted(named.items()))


class LineCrossCounter:
    """Directional line-crossing tally (BASELINE.json configs[4]).

    The reference's ``--count`` overlay (yolo_multi_model.py:284-318)
    counts unique tracks per class; deployments additionally want
    "how many crossed THIS line, each way". This counter keeps one
    previous centroid per track and tests the segment between
    consecutive centroids against the (directed) count line — O(active
    tracks) per frame, O(1) memory per live track.

    Geometry: the line A->B splits the plane; ``side(P) =
    cross(B-A, P-A)``. A crossing is counted when the track's motion
    segment P->Q strictly straddles the infinite line AND the line
    segment A-B strictly straddles the motion segment (proper
    segment-segment intersection). Direction: ``in`` when the track
    ends on the positive side (left of A->B), ``out`` otherwise. A
    centroid landing exactly ON the line (side == 0) counts nothing
    that frame; the crossing is picked up when it comes off the line
    if the sides differ (the stored point is only advanced off-line).
    """

    def __init__(self, names: dict[int, str], line):
        self.names = names
        x1, y1, x2, y2 = (float(v) for v in line)
        self.a = (x1, y1)
        self.b = (x2, y2)
        self._prev: dict[int, tuple[float, float]] = {}
        self._last_seen: dict[int, int] = {}
        self._frame = 0
        self.in_counts: dict[int, int] = defaultdict(int)
        self.out_counts: dict[int, int] = defaultdict(int)

    def _side(self, p) -> float:
        (ax, ay), (bx, by) = self.a, self.b
        return (bx - ax) * (p[1] - ay) - (by - ay) * (p[0] - ax)

    @staticmethod
    def _cross(o, p, q) -> float:
        return (p[0] - o[0]) * (q[1] - o[1]) - (p[1] - o[1]) * (q[0] - o[0])

    def update(self, boxes) -> None:
        """boxes: pipeline.Boxes with .id (track mode)."""
        self._frame += 1
        if boxes is None or boxes.id is None:
            return
        for i in range(len(boxes)):
            tid = int(boxes.id[i])
            cls = int(boxes.cls[i])
            x1, y1, x2, y2 = (float(v) for v in boxes.xyxy[i])
            q = ((x1 + x2) / 2.0, (y1 + y2) / 2.0)
            p = self._prev.get(tid)
            self._last_seen[tid] = self._frame
            sq = self._side(q)
            if p is not None:
                sp = self._side(p)
                if sp * sq < 0 and (
                    self._cross(p, q, self.a) * self._cross(p, q, self.b) < 0
                ):
                    tally = self.in_counts if sq > 0 else self.out_counts
                    tally[cls] += 1
            if p is None or sq != 0.0:
                self._prev[tid] = q

    def prune(self, max_gap: int = 300) -> None:
        """Drop stored centroids of tracks unseen for ``max_gap``
        frames (id reuse across very long gaps must not count)."""
        dead = [t for t, f in self._last_seen.items()
                if self._frame - f > max_gap]
        for t in dead:
            self._prev.pop(t, None)
            self._last_seen.pop(t, None)

    def counts(self) -> dict[str, dict[str, int]]:
        """{"in": {class_name: n}, "out": {class_name: n}},
        name-sorted."""

        def named(tally):
            d = {self.names.get(c, str(c)): n for c, n in tally.items()}
            return dict(sorted(d.items()))

        return {"in": named(self.in_counts), "out": named(self.out_counts)}

    def totals(self) -> tuple[int, int]:
        return sum(self.in_counts.values()), sum(self.out_counts.values())
