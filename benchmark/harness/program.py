"""The system under test, built from a configuration file: the port's
``Pipeline`` with the benchmark's weights, and a recorder of the
intermediate products the check compares (the tick's detections and
ReID embeddings), which keeps a reference to each and copies nothing."""

from __future__ import annotations


def build(cfg: dict, P_det: dict, P_reid: dict | None, device):
    from strongsort_yolo_tpu_torch.config import DetectorConfig
    from strongsort_yolo_tpu_torch.models.yolo import build_model
    from strongsort_yolo_tpu_torch.pipeline import Pipeline
    from strongsort_yolo_tpu_torch.track.bytetrack import ByteTrackConfig
    from strongsort_yolo_tpu_torch.track.strongsort import StrongSortConfig

    d = cfg["detector"]
    det_cfg = DetectorConfig(weights=d["model"], imgsz=d["imgsz"], conf=d["conf"],
                             iou=d["iou"], max_det=d["max_det"],
                             half=d["dtype"] == "bfloat16", fuse=True)
    t = dict(cfg["tracker"])
    kind = t.pop("tracker_type")
    tracker = (StrongSortConfig(**t) if kind == "strongsort"
               else ByteTrackConfig(tracker_type=kind, **t))
    reid = cfg.get("reid") or {}
    if P_reid is not None:  # the program folds the checkpoint's BNs on the host
        P_reid = {k: v.cpu() for k, v in P_reid.items()}
    return Pipeline(
        det_cfg, tracker, params=P_det, model_cfg=build_model(d["model"]),
        track_slots=cfg["track_slots"], reid_params=P_reid,
        reid_topk=reid.get("topk", 128), tracker_max_dets=cfg["tracker_max_dets"],
        reid_cadence=reid.get("cadence", 1), reid_fused=reid.get("fused", False),
        device=device)


class Recorder:
    """While entered, keeps the last tick's Detections, NMS candidates
    (their anchors, and which clear the threshold) and keep mask, and
    embeddings of ``pipe``; on exit the program is as it was."""

    def __init__(self, pipe):
        self.pipe = pipe
        self.det = self.feats = self.nms = self.anchors = None

    def __enter__(self):
        from strongsort_yolo_tpu_torch.ops import nms as nms_mod

        pipe, keep, cands = self.pipe, nms_mod.nms_keep, nms_mod._nms_on_candidates
        self._restore = (nms_mod, keep, cands)

        def keep_rec(boxes, conf, *, iou_thres, conf_thres):
            out = keep(boxes, conf, iou_thres=iou_thres, conf_thres=conf_thres)
            self.nms = (boxes, conf, out, iou_thres, conf_thres)
            return out

        def cands_rec(top_boxes, top_conf, top_cls, top_valid, **kw):
            self.anchors = (kw["row_ids"], top_valid)
            return cands(top_boxes, top_conf, top_cls, top_valid, **kw)

        nms_mod.nms_keep = keep_rec
        nms_mod._nms_on_candidates = cands_rec
        detect, finish = pipe.detect_with_extras, pipe.embed_finish

        def detect_rec(frames, extras_k):
            out = detect(frames, extras_k)
            self.det = out[0]
            return out

        def finish_rec(started, det, mask=None):
            self.feats = finish(started, det, mask)
            return self.feats

        pipe.detect_with_extras = detect_rec
        pipe.embed_finish = finish_rec
        return self

    def __exit__(self, *exc):
        nms_mod, keep, cands = self._restore
        nms_mod.nms_keep = keep
        nms_mod._nms_on_candidates = cands
        for name in ("detect_with_extras", "embed_finish"):
            self.pipe.__dict__.pop(name, None)
        self.det = self.feats = self.nms = self.anchors = None
        return False
