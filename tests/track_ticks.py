"""Seeded synthetic tracker inputs, made on the CPU, for tests of the
tracker step (``Pipeline.associate``): S streams of objects that move at
constant velocity in a 1080p frame, detected with jitter and missed now
and then, with low-confidence clutter; rows sorted by confidence, as NMS
gives them, and zero past each frame's count; one unit ReID feature per
object with noise, zero past the count; near-identity camera warps."""

from __future__ import annotations

import torch

from strongsort_yolo_tpu_torch.ops.nms import Detections

H, W = 1080, 1920


def make_ticks(seed: int, streams: int, max_det: int, feat_dim: int,
               ticks: int, device="cpu", objects: int = 150):
    """-> ``ticks`` tuples (Detections, feats (S, max_det, D), warps (S, 2,
    3)) on ``device``. Stream s holds about ``objects`` * (s + 1) / S
    objects, so the busiest streams fill max_det and cut rows."""
    g = torch.Generator().manual_seed(seed)
    f32 = torch.float32
    counts = [max(1, objects * (s + 1) // streams) for s in range(streams)]
    m = max(counts)
    room = torch.tensor([W - 150.0, H - 250.0])

    def rand(*shape):
        return torch.rand(shape, generator=g)

    def unit(x):
        return torch.nn.functional.normalize(x, dim=-1)

    size = rand(streams, m, 2) * torch.tensor([100.0, 200.0]) + torch.tensor(
        [20.0, 40.0])
    start = rand(streams, m, 2) * room
    vel = (rand(streams, m, 2) - 0.5) * 16.0
    cls = torch.randint(0, 4, (streams, m), generator=g, dtype=torch.int32)
    app = unit(torch.randn((streams, m, feat_dim), generator=g))
    out = []
    for t in range(ticks):
        boxes = torch.zeros((streams, max_det, 4), dtype=f32)
        scores = torch.zeros((streams, max_det), dtype=f32)
        classes = torch.zeros((streams, max_det), dtype=torch.int32)
        valid = torch.zeros((streams, max_det), dtype=torch.bool)
        feats = torch.zeros((streams, max_det, feat_dim), dtype=f32)
        count = torch.zeros(streams, dtype=torch.int32)
        for s in range(streams):
            n = counts[s]
            xy = torch.remainder(start[s, :n] + vel[s, :n] * t, room)
            xy = xy + torch.randn((n, 2), generator=g) * 2.0
            seen = rand(n) > 0.1
            b = torch.cat([xy, xy + size[s, :n]], -1)[seen]
            sc = (0.3 + 0.7 * rand(n))[seen]
            c = cls[s, :n][seen]
            noise = torch.randn((int(seen.sum()), feat_dim), generator=g)
            f = unit(app[s, :n][seen] + 0.1 * noise)
            k = int(torch.randint(0, 16, (), generator=g))  # clutter
            cxy = rand(k, 2) * room
            b = torch.cat([b, torch.cat([cxy, cxy + 40.0 + 60.0 * rand(k, 2)],
                                        -1)])
            sc = torch.cat([sc, 0.1 + 0.4 * rand(k)])
            c = torch.cat([c, torch.randint(0, 4, (k,), generator=g,
                                            dtype=torch.int32)])
            f = torch.cat([f, unit(torch.randn((k, feat_dim), generator=g))])
            order = torch.argsort(sc, descending=True, stable=True)[:max_det]
            r = len(order)
            boxes[s, :r], scores[s, :r], classes[s, :r] = b[order], sc[order], c[order]
            feats[s, :r], valid[s, :r], count[s] = f[order], True, r
        warps = torch.eye(2, 3).repeat(streams, 1, 1)
        warps[:, :, :2] += (rand(streams, 2, 2) - 0.5) * 0.01
        warps[:, :, 2] = (rand(streams, 2) - 0.5) * 10.0
        index = torch.arange(max_det, dtype=torch.int32).expand(streams, -1)
        det = Detections(boxes, scores, classes, count, valid, index.contiguous())
        out.append((Detections(*(x.to(device) for x in det)), feats.to(device),
                    warps.to(device)))
    return out
