"""Detect -> NMS -> (ReID embed) -> track, for one stream or S in lockstep.

Counterpart of ``strongsort_yolo_tpu/pipeline.py`` for the YOLOv8 and
YOLO11 detect, pose and segment models and the YOLOv5 (classic and
``u``) and YOLOv7 detectors with ByteTrack, BoT-SORT (with or without
ReID) or StrongSORT. One tick of :class:`BatchedPipeline`
uploads the (S, H, W, 3) uint8 frames once, then runs the letterbox
(K1), the model as one batch-S forward, NMS of all S frames (one K2
launch), the rescale to frame coordinates, the task extras of the rows
that can reach the tracker (pose: keypoints decoded and mapped to the
frame; segment: masks from the prototypes, cropped to the frame boxes),
for ReID trackers the embed (pyramid, one K4 crop
launch, one OSNet forward over the real detections of all S frames),
and the tracker over all S streams (one K3 launch per association
stage). With ``conv_kernel`` the model computes the convs that the K7
rule picks with K7 (``ops/cuda/conv_kernel.py``). With ``reid_fused``
OSNet runs its three backbone stages as the fused stage kernel K6 (three
launches per embed; the CPU runs its plain version). With ``reid_cadence`` k > 1 a StrongSORT
:class:`BatchedPipeline` embeds stream s only on ticks where (s + tick)
% k == 0; the other streams associate by motion alone.

Camera-motion compensation on the device is ``gmc_method="flow_tpu"``
(``track/gmc_flow.py``): each tick takes the gray of every uploaded frame
and estimates all S warps against the stream's previous gray with one K5
launch, identity for a stream without a previous frame. BoT-SORT's
default ``"sparseOptFlow"`` and StrongSORT's ``"ecc"`` are the JAX
package's host OpenCV estimators (``track/gmc.py``, one per stream): a
step that is given no warps estimates them on the host from its frames
before it dispatches, as the JAX package does; warps passed by the
caller are taken as they are.
:meth:`Pipeline.track_chunk` runs T frames of one stream with the
semantics of T ``track`` calls: one detect batch, one embed batch, one
K5 launch over the T frame pairs, then the tracker frame by frame.

The asynchronous API is the JAX package's: :meth:`Pipeline.track_async`
and :meth:`BatchedPipeline.step_async` dispatch a tick and return a
:class:`TickHandle`; ``materialize`` waits for that tick alone, and
``track``/``step`` are ``materialize`` of the async call. On the card
the compute runs on the caller's current stream and the copies on side
streams (``utils/transfer.py``): frames through a ring of pinned slots,
outputs through pinned memory with an event per handle, the track rows'
task extras gathered after their own tick only. A tick synchronises no
stream; its one host wait is a ReID tracker's read of the detection
counts (:meth:`Pipeline.embed`).

A tick's host work is recorded in ``Pipeline.spans``
(``utils/profiling.StageTimers``), one span per layer, named
``ssyt.<layer>[.<part>]``: ``ssyt.tick`` around
:meth:`BatchedPipeline.step_async`, inside it ``ssyt.ring.wait`` and
``ssyt.ring.fill`` (the frame ring's slot), ``ssyt.gmc``,
``ssyt.detect.letterbox``, ``ssyt.detect.model``, ``ssyt.detect.nms``,
``ssyt.embed.start``, ``ssyt.embed.count_wait``, ``ssyt.embed.crop``,
``ssyt.embed.reid``, ``ssyt.track`` and ``ssyt.download``; and
``ssyt.materialize``. Under a ``torch.profiler`` each is also a range of
the trace, ``ssyt.tick`` and ``ssyt.materialize`` with the tick's number.
``Pipeline.crop_slots`` and ``crop_real`` count the packed embed's slots
and its real crops over every tick.

Over a mesh (``track_batch_prepare(mesh=...)``), :class:`ShardedBatchedPipeline`
steps each dp row's block of streams as a :class:`BatchedPipeline` on
that row's device, in one process: every block's work up to the count
wait is queued before any block waits.

``Results``/``Boxes``/``Masks``/``Keypoints`` mirror the ultralytics
result surface (``.boxes{.xyxy,.conf,.cls,.id}``, ``.masks.xy``,
``.keypoints.xy``, ``.names``). A track row takes the extras of the
detection that updated it (``TrackOutputs.det_index``), zeros where none
did. The mask polygons are traced on the host when ``.masks.xy`` is
first read, one mask at a time.
"""

from __future__ import annotations

import contextlib
import copy
import os
import time
from typing import NamedTuple

import numpy as np
import torch

from strongsort_yolo_tpu_torch.config import (
    DetectorConfig,
    TrackerConfig,
    load_tracker_config,
)
from strongsort_yolo_tpu_torch.models import common
from strongsort_yolo_tpu_torch.models.osnet import (
    VARIANTS,
    OsnetConfig,
    init_osnet,
    osnet_from_state_dict,
)
from strongsort_yolo_tpu_torch.models.porting import (
    ModelConfig,
    load_checkpoint,
    load_osnet_npz,
    load_reid_checkpoint,
    model_from_state_dict,
    osnet_params_from_jax,
    params_from_jax,
)
from strongsort_yolo_tpu_torch.models.yolo import (
    YoloConfig,
    build_model,
    detector_family,
    feat_hw,
    fuse_model,
)
from strongsort_yolo_tpu_torch.ops.boxes import scale_boxes
from strongsort_yolo_tpu_torch.ops.crops import (
    PyramidStack,
    banded_prep,
    pyramid_stack,
)
from strongsort_yolo_tpu_torch.ops.cuda.crop_kernel import banded_crop
from strongsort_yolo_tpu_torch.ops.cuda.resize_kernel import letterbox_u8
from strongsort_yolo_tpu_torch.ops.decode import anchors_from_indices
from strongsort_yolo_tpu_torch.ops.keypoints import decode_keypoints, scale_keypoints
from strongsort_yolo_tpu_torch.ops.letterbox import (
    LetterboxParams,
    ResizeTaps,
    letterbox_params,
    resize_taps,
)
from strongsort_yolo_tpu_torch.ops.masks import masks_to_polygons, process_masks
from strongsort_yolo_tpu_torch.ops.nms import (
    Detections,
    nms_from_logits,
    non_max_suppression,
)
from strongsort_yolo_tpu_torch.track.bytetrack import ByteTrackConfig, bytetrack_step
from strongsort_yolo_tpu_torch.track.gmc import HOST_METHODS, make_gmc
from strongsort_yolo_tpu_torch.track.gmc_flow import (
    BASE_H,
    BASE_W,
    FlowGMC,
    batched_warps,
    frame_to_gray,
)
from strongsort_yolo_tpu_torch.track.state import (
    TrackOutputs,
    TrackState,
    init_track_state,
)
from strongsort_yolo_tpu_torch.track.strongsort import (
    StrongSortConfig,
    strongsort_step,
)
from strongsort_yolo_tpu_torch.utils.coco_names import COCO_NAMES
from strongsort_yolo_tpu_torch.utils.profiling import StageTimers
from strongsort_yolo_tpu_torch.utils.transfer import (
    Copies,
    Download,
    to_device,
)

PACK_G = 8  # slot quantum of the packed embed: each stream's crop count
# rounds up to it, as the TPU kernel's crop blocks do
_DUMMY_BOX = (0.0, 0.0, 16.0, 32.0)  # crop box of a padding slot


class Boxes:
    """Rows of detections/tracks: .xyxy (n, 4), .conf (n,), .cls (n,),
    .id (n,) or None. Iterating yields single-row Boxes."""

    def __init__(self, xyxy, conf, cls, id=None):
        self.xyxy = np.asarray(xyxy, np.float32).reshape(-1, 4)
        self.conf = np.asarray(conf, np.float32).reshape(-1)
        self.cls = np.asarray(cls, np.float32).reshape(-1)
        self.id = None if id is None else np.asarray(id, np.float32).reshape(-1)

    def __len__(self):
        return len(self.conf)

    def __iter__(self):
        for i in range(len(self)):
            yield Boxes(
                self.xyxy[i : i + 1],
                self.conf[i : i + 1],
                self.cls[i : i + 1],
                None if self.id is None else self.id[i : i + 1],
            )


class Masks:
    """.data: (n, Hm, Wm) float32 masks on the prototype grid; .xy: one
    (P, 2) float32 polygon per mask in frame coordinates, the largest
    outer contour above 0.5 (``ops/masks.masks_to_polygons``), traced on
    the host when first read."""

    def __init__(self, data, lp: LetterboxParams, src_hw, input_hw):
        self.data = data
        self._geometry = (lp, tuple(src_hw), tuple(input_hw))
        self._xy = None

    @property
    def xy(self) -> list[np.ndarray]:
        if self._xy is None:
            lp, src_hw, input_hw = self._geometry
            self._xy = masks_to_polygons(self.data, len(self.data), lp.gain,
                                         (lp.pad_x, lp.pad_y), src_hw, input_hw)
        return self._xy

    def __len__(self):
        return len(self.data)


class Keypoints:
    """.xy (n, K, 2) and .conf (n, K) in frame coordinates; invisible
    keypoints are those with conf < 0.5 (the reference sees them as (0, 0),
    which ``xy_masked`` reproduces)."""

    def __init__(self, data):
        self.data = np.asarray(data, np.float32)  # (n, K, 3)

    @property
    def xy(self):
        return self.data[..., :2]

    @property
    def conf(self):
        return self.data[..., 2]

    @property
    def xy_masked(self):
        vis = self.data[..., 2:3] >= 0.5
        return np.where(vis, self.data[..., :2], 0.0)

    def __len__(self):
        return len(self.data)

    def __iter__(self):
        for i in range(len(self.data)):
            yield Keypoints(self.data[i : i + 1])


class Results:
    """One frame's results: .boxes, .masks, .keypoints, .names, .orig_img."""

    def __init__(self, boxes, names, masks=None, keypoints=None, orig_img=None):
        self.boxes = boxes
        self.masks = masks
        self.keypoints = keypoints
        self.names = names
        self.orig_img = orig_img

    def __len__(self):
        return 0 if self.boxes is None else len(self.boxes)


class _Geometry(NamedTuple):
    lp: LetterboxParams
    taps: ResizeTaps
    src_hw: tuple[int, int]
    pad: torch.Tensor  # (4,) float32 [pad_x, pad_y, pad_x, pad_y]


class TickHandle:
    """One dispatched tick (:meth:`Pipeline.track_async`,
    :meth:`BatchedPipeline.step_async`): its packed track outputs on their
    way to pinned host memory, fenced by one event, and the task extras
    still on the device until the first ``materialize`` copies the track
    rows' share of them (kept for later calls). ``tick``: the
    :class:`BatchedPipeline` tick's number (None for a single stream)."""

    __slots__ = ("packed", "extras", "src_hw", "orig_imgs", "host_extras",
                 "tick")

    def __init__(self, packed: Download, extras: dict, src_hw, orig_imgs=None,
                 tick: int | None = None):
        self.packed = packed
        self.extras = extras
        self.src_hw = tuple(src_hw)
        self.orig_imgs = orig_imgs
        self.host_extras: list[dict] | None = None
        self.tick = tick

    def query(self) -> bool:
        """Whether the tick's outputs have reached the host (never blocks)."""
        return self.packed.query()


def _reid_checkpoint(weights: str | None, params: dict | None, seed: int):
    """-> (OSNet checkpoint, OsnetConfig) from ``reid_params`` (variant
    read from the stem's width), a variant name (random from ``seed``), an
    ``.npz`` path of the JAX package or a torchreid ``.pt``/``.pth``."""
    if params is not None:
        if weights is not None:
            raise ValueError("pass reid_params or reid_weights, not both")
        c1 = params["stem.w"].shape[0]
        for variant in VARIANTS:
            cfg = OsnetConfig(variant=variant,
                              feat_dim=params["fc.lin.w"].shape[0])
            if cfg.channels[0] == c1:
                return params, cfg
        raise ValueError(f"reid_params: no OSNet variant has a {c1}-channel stem")
    weights = weights or "osnet_x0_25"
    if weights in VARIANTS:
        cfg = OsnetConfig(variant=weights)
        return init_osnet(cfg, torch.Generator().manual_seed(seed)), cfg
    if not os.path.isfile(weights):
        raise FileNotFoundError(
            f"reid_weights {weights!r} is neither an OSNet variant "
            f"{sorted(VARIANTS)} nor a file")
    if weights.endswith(".npz"):
        tree, cfg = load_osnet_npz(weights)
    else:
        tree, cfg = load_reid_checkpoint(weights)
    return osnet_params_from_jax(tree, cfg), cfg


class Pipeline:
    """Single-stream detect/track pipeline; also holds the models and the
    per-tick building blocks that :class:`BatchedPipeline` runs batched.

    ``params``: a state_dict of the port's model (for instance from
    :func:`~strongsort_yolo_tpu_torch.models.porting.params_from_jax`),
    fused or not. Without it the weights come from ``det_cfg.weights``:
    a file, an ``.npz`` checkpoint of the JAX package or an
    ultralytics-format ``.pt`` of YOLOv8 / YOLO11, YOLOv5 (classic or
    ``u``) or YOLOv7, or else a model name such as ``"yolov8n"``,
    ``"yolo11n-pose"``, ``"yolov8n-seg"``, ``"yolov5s"``, ``"yolov5su"`` or
    ``"yolov7"`` initialised at random from ``seed``. The anchor-based
    heads (v5 classic, v7) give decoded boxes, which ``ops/nms.
    non_max_suppression`` suppresses; the others logits, which
    ``nms_from_logits`` does. With ``det_cfg.fuse`` every BN is folded
    (v7: and its RepConvs reparameterized). Pose models give each result row its
    ``keypoints``, segment models its ``masks``: computed for the top
    ``max_det`` rows in ``predict`` and the top ``tracker_max_dets`` rows
    (those that can reach the tracker) when tracking.
    ``conv_kernel``: the fused model computes every conv whose input the
    K7 rule picks (``ops/cuda/conv_kernel.eligible``, the JAX package's
    rule for its ``conv_act`` entry point: stride-1 'same' convs, k 1 or
    3, on planes of 1600 pixels or more with at most 192 input channels)
    with K7, its bias added in float32 and the output rounded once; the
    CPU runs K7's plain version; v8 and v11 only (a ``ValueError`` for v5
    and v7). Off by default, as in the JAX package,
    whose product path leaves every conv to XLA; in bfloat16 its rounding
    differs from the default convs', so detections move slightly.
    ``det_cfg.quant="int8"``: the fused model's convs outside the heads
    and the first stages (the JAX package's set) in int8 mode, computed by
    K8 with a dynamic activation scale until :meth:`calibrate_int8` sets
    static ones; it needs ``fuse``, excludes ``conv_kernel`` and refuses
    a segment model, as the JAX package fails on one.
    ``tracker``: a built-in name or YAML path, or a config object;
    StrongSORT and BoT-SORT with ``with_reid`` embed detections with
    OSNet, whose weights come from ``reid_params`` (an OSNet checkpoint
    state_dict, :func:`~strongsort_yolo_tpu_torch.models.osnet.checkpoint_keys`,
    RGB convention) or ``reid_weights``: a variant name (default
    ``"osnet_x0_25"``) initialised at random from ``seed + 1``, or else
    the path of an OSNet ``.npz`` of the JAX package or of a torchreid
    ``.pt``/``.pth``. The top ``reid_topk`` detections of
    each frame that reach the tracker are embedded; the rest carry a
    zero feature. ``reid_cadence``: a :class:`BatchedPipeline` with a
    StrongSORT tracker embeds each stream on one tick in ``reid_cadence``
    (``track`` and ``track_chunk`` embed every frame). ``reid_fused``:
    OSNet's three backbone stages run as the fused stage kernel K6; None
    takes the JAX package's switch, ``SSYT_OSNET=fused`` in the
    environment when the pipeline is built.
    ``device``: where everything runs; CUDA launches the kernels, the
    CPU runs their plain versions (``device="cpu"``). Default: the
    current CUDA device; without one, a ``RuntimeError``.
    A BoT-SORT or StrongSORT tracker with ``gmc_method="flow_tpu"``
    estimates camera motion on the device from the stream's previous
    gray frame, which ``gmc`` (a :class:`FlowGMC`, else None) keeps; it
    takes no warps from the caller. With ``"sparseOptFlow"`` or ``"ecc"``
    the host estimator ``host_gmc`` (``track/gmc.SparseOptFlowGMC``, else
    None) gives each frame's warp where the caller passes none.
    """

    def __init__(
        self,
        det_cfg: DetectorConfig = DetectorConfig(),
        tracker: str | TrackerConfig = "botsort.yaml",
        *,
        params: dict[str, torch.Tensor] | None = None,
        model_cfg: ModelConfig | None = None,
        track_slots: int = 256,
        seed: int = 0,
        names: dict[int, str] | None = None,
        reid_weights: str | None = None,
        reid_params: dict[str, torch.Tensor] | None = None,
        reid_topk: int = 128,
        tracker_max_dets: int = 128,
        reid_cadence: int = 1,
        reid_fused: bool | None = None,
        conv_kernel: bool = False,
        device: torch.device | str | None = None,
    ):
        if device is None:
            if not torch.cuda.is_available():
                raise RuntimeError(
                    "Pipeline runs on the CUDA device by default and none "
                    "was found; pass device='cpu' to run the kernels' "
                    "plain versions on the CPU")
            device = "cuda"
        if reid_cadence < 1:
            raise ValueError(f"reid_cadence must be >= 1, got {reid_cadence}")
        self.reid_cadence = int(reid_cadence)
        self.device = torch.device(device)
        self.det_cfg = det_cfg
        if params is None and os.path.exists(det_cfg.weights):
            tree, model_cfg, names_loaded = load_checkpoint(det_cfg.weights)
            params = params_from_jax(tree, model_cfg)
            names = names or names_loaded
        self.model_cfg = model_cfg or build_model(det_cfg.weights)
        if conv_kernel and not isinstance(self.model_cfg, YoloConfig):
            raise ValueError(
                "conv_kernel=True takes a v8 or v11 model; K7's route is not "
                f"held for {type(self.model_cfg).__name__}")
        if params is None:
            model = detector_family(self.model_cfg)[1](
                self.model_cfg, torch.Generator().manual_seed(seed)
            )
        else:
            model = model_from_state_dict(params, self.model_cfg)
        if det_cfg.fuse:
            model = fuse_model(model)
        if det_cfg.quant == "int8":
            self._quantize(model, conv_kernel)
        elif det_cfg.quant is not None:
            raise ValueError(f"unknown quant mode {det_cfg.quant!r}")
        if conv_kernel:
            # K7 keeps its biases in float32: taken before the cast
            model.use_conv_kernel()
        self.compute_dtype = torch.bfloat16 if det_cfg.half else torch.float32
        self.model = model.to(self.device, self.compute_dtype).eval()
        self.names = names or dict(COCO_NAMES)
        self.tracker_cfg = (
            tracker if isinstance(tracker, (ByteTrackConfig, StrongSortConfig))
            else load_tracker_config(tracker)
        )
        self.is_strongsort = isinstance(self.tracker_cfg, StrongSortConfig)
        self.gmc_method = (
            self.tracker_cfg.gmc_method
            if self.is_strongsort or self.tracker_cfg.tracker_type == "botsort"
            else "none"
        )
        self.gmc = (FlowGMC(self.device) if self.gmc_method == "flow_tpu"
                    else None)
        self.host_gmc = (make_gmc(self.gmc_method)
                         if self.gmc_method in HOST_METHODS else None)
        self.reid = None
        self.feat_dim = 0
        if self.is_strongsort or self.tracker_cfg.with_reid:
            reid_params, reid_cfg = _reid_checkpoint(
                reid_weights, reid_params, seed + 1)
            # BN folded in float32 before the cast; the stem takes the
            # frames' BGR order
            reid = osnet_from_state_dict(reid_params, reid_cfg,
                                         channel_order="bgr")
            if reid_fused is None:
                reid_fused = os.environ.get("SSYT_OSNET") == "fused"
            if reid_fused:
                # K6's weights are packed from the float32 folded model
                reid.use_fused_stages(self.compute_dtype)
            self.reid = reid.to(self.device, self.compute_dtype).eval()
            self.feat_dim = reid_cfg.feat_dim
        self.reid_topk = reid_topk
        self.track_slots = track_slots
        self.tracker_max_dets = min(tracker_max_dets, det_cfg.max_det)
        self._class_filter = None
        if det_cfg.classes is not None:
            mask = torch.zeros(self.model_cfg.nc, dtype=torch.bool)
            mask[list(det_cfg.classes)] = True
            self._class_filter = mask.to(self.device)
        self._geoms: dict[tuple[int, int], _Geometry] = {}
        # the ticks' host spans (the module's docstring names them)
        self.spans = StageTimers()
        self._copies = Copies(self.device, self.spans)
        self._dummy_box = torch.tensor(_DUMMY_BOX, device=self.device)
        # the ReID count read, the tick's one host wait: how many, how long
        self.count_waits = 0
        self.count_wait_ms = 0.0
        # the packed embed's slots (padded G) and real crops, summed
        self.crop_slots = 0
        self.crop_real = 0
        self.track_state = self.init_states(1)

    def _quantize(self, model, conv_kernel: bool) -> None:
        """``quant="int8"``: the JAX package's checks, then
        ``models/common.quantize_model`` on the fused float32 model."""
        if not self.det_cfg.fuse:
            raise ValueError("quant='int8' requires fuse=True")
        if conv_kernel:
            raise ValueError(
                "quant='int8' and conv_kernel=True exclude each other: the "
                "JAX package has no int8 route through its conv kernel")
        if getattr(self.model_cfg, "task", "detect") == "segment":
            raise ValueError(
                "quant='int8' does not take a segment model: the JAX "
                "package's quantize_model quantizes its mask coefficient "
                "branches ('/mask/*', which no skip marker names), out "
                "layers included, and conv2d_bias_apply then fails on "
                "them with KeyError('w') at the first step")
        if common.quantize_model(model) == 0:
            raise ValueError("quant='int8' found no fused convs to quantize")

    def init_states(self, num_streams: int) -> TrackState:
        """Fresh tracker state of ``num_streams`` streams."""
        return init_track_state(num_streams, self.track_slots, self.device,
                                feat_dim=self.feat_dim)

    def on_device(self, device: torch.device | str) -> Pipeline:
        """This pipeline on ``device``: itself where it runs there already,
        else a copy with the same configuration whose detector and ReID
        models (with what they derived from their weights) are copied to
        ``device`` and whose per-device state (copy streams, geometry
        constants, GMC, tracker state) is made there anew."""
        device = torch.device(device)
        if _device_key(device) == _device_key(self.device):
            return self
        twin = copy.copy(self)
        twin.device = device
        with device_scope(device):
            twin.model = copy.deepcopy(self.model).to(device)
            if self.reid is not None:
                twin.reid = copy.deepcopy(self.reid).to(device)
            twin.gmc = FlowGMC(device) if self.gmc is not None else None
            twin.host_gmc = (make_gmc(self.gmc_method)
                             if self.host_gmc is not None else None)
            if self._class_filter is not None:
                twin._class_filter = self._class_filter.to(device)
            twin._geoms = {}
            twin.spans = StageTimers()
            twin._copies = Copies(device, twin.spans)
            twin._dummy_box = self._dummy_box.to(device)
            twin.count_waits, twin.count_wait_ms = 0, 0.0
            twin.crop_slots = twin.crop_real = 0
            twin.track_state = twin.init_states(1)
        return twin

    # -- per-tick building blocks ---------------------------------------

    def _geometry(self, src_hw: tuple[int, int]) -> _Geometry:
        src_hw = (int(src_hw[0]), int(src_hw[1]))
        if src_hw not in self._geoms:  # uploaded once per geometry
            lp = letterbox_params(*src_hw, self.det_cfg.imgsz)
            pad = torch.tensor([lp.pad_x, lp.pad_y] * 2, dtype=torch.float32,
                               device=self.device)
            self._geoms[src_hw] = _Geometry(
                lp, resize_taps(src_hw, lp, self.device), src_hw, pad
            )
        return self._geoms[src_hw]

    def detect(self, frames: torch.Tensor) -> Detections:
        """(B, H, W, 3) uint8 BGR on the pipeline's device -> confidence-
        sorted detections (B, max_det, ...) in frame coordinates."""
        return self.detect_with_extras(frames, 0)[0]

    @torch.no_grad()
    def detect_with_extras(
        self, frames: torch.Tensor, extras_k: int
    ) -> tuple[Detections, dict[str, torch.Tensor]]:
        """:meth:`detect` and the task extras of each frame's top
        ``extras_k`` rows, on the device: 'keypoints' (B, k, K, 3) in frame
        coordinates for a pose model, 'masks' (B, k, Hm, Wm) float32 for a
        segment model, each cropped to its clipped frame box mapped back
        to the model input; rows past the count are zero."""
        cfg, det_cfg = self.model_cfg, self.det_cfg
        geo = self._geometry(frames.shape[1:3])
        size = det_cfg.imgsz
        with self.spans.stage("ssyt.detect.letterbox"):
            img = letterbox_u8(frames, geo.lp, dtype=self.compute_dtype,
                               taps=geo.taps)
        with self.spans.stage("ssyt.detect.model"):
            out = self.model(img)
        nms = dict(conf_thres=det_cfg.conf, iou_thres=det_cfg.iou,
                   max_det=det_cfg.max_det, agnostic=det_cfg.agnostic_nms,
                   class_filter=self._class_filter)
        lp = geo.lp
        with self.spans.stage("ssyt.detect.nms"):  # and the rescale
            if "boxes" in out:  # anchor-based v5 / v7: decoded by the head
                det = non_max_suppression(out["boxes"], out["scores"], **nms)
            else:
                det = nms_from_logits(
                    out["box_logits"], out["cls_logits"],
                    feat_dims=feat_hw((size, size), cfg.strides),
                    level_strides=cfg.strides, reg_max=cfg.reg_max, **nms)
            boxes = scale_boxes(det.boxes, lp.gain, (lp.pad_x, lp.pad_y),
                                geo.src_hw)
            det = det._replace(boxes=torch.where(det.valid[..., None], boxes,
                                                 0.0))
        extras = {}
        k = min(extras_k, det_cfg.max_det)
        if k == 0 or cfg.task == "detect":
            return det, extras
        idx = det.index[:, :k].long()
        if cfg.task == "pose":
            rows = torch.gather(out["kpt_raw"], 1,
                                idx[..., None].expand(-1, -1, cfg.nk))
            anchors, strides = anchors_from_indices(
                idx, feat_hw((size, size), cfg.strides), cfg.strides)
            kpts = decode_keypoints(rows, anchors, strides, cfg.kpt[0])
            extras["keypoints"] = scale_keypoints(
                kpts, lp.gain, (lp.pad_x, lp.pad_y), geo.src_hw)
        else:
            coefs = torch.gather(out["mask_coef"], 1,
                                 idx[..., None].expand(-1, -1, cfg.nm))
            # crop to the clipped frame boxes mapped back to the model input
            crop = torch.where(det.valid[:, :k, None],
                               det.boxes[:, :k] * lp.gain + geo.pad, 0.0)
            extras["masks"] = process_masks(coefs, out["proto"], crop,
                                            (size, size))
        return det, extras

    def embed_slots(self, counts: np.ndarray,
                    mask: np.ndarray | None = None) -> np.ndarray:
        """The packed crop slots of one tick, from the (S,) real detection
        counts on the host: stream s gets min(count_s, cap) slots rounded
        up to ``PACK_G``, streams in order (cap = min(reid_topk,
        tracker_max_dets)), none where the (S,) bool ``mask`` is False.
        -> (3, G) int64 host array of [frame, row, real] per slot;
        padding slots have real = 0."""
        cap = min(self.reid_topk, self.tracker_max_dets)
        counts = np.minimum(np.asarray(counts).astype(np.int64), cap)
        if mask is not None:
            counts = counts * mask
        padded = -(-counts // PACK_G) * PACK_G
        frame = np.repeat(np.arange(len(counts)), padded)
        starts = np.repeat(np.cumsum(padded) - padded, padded)
        row = np.arange(len(frame)) - starts
        real = row < np.repeat(counts, padded)
        return np.stack([frame, row, real])

    def pyramid(self, frames: torch.Tensor) -> PyramidStack:
        """(S, H, W, 3) uint8 BGR frames on the device -> the crop pyramid
        of their [0, 1] planar images in the compute dtype."""
        dt = self.compute_dtype
        imgs = frames.permute(0, 3, 1, 2).to(dt) / torch.full(
            (), 255.0, dtype=dt, device=self.device
        )
        return pyramid_stack(imgs)

    def crop_params(self, pyr: PyramidStack, det: Detections,
                    slots: torch.Tensor):
        """The slots of :meth:`embed_slots`, as a (3, G) int64 tensor on
        the device -> K4's per-slot arguments (scal, ints, slot_frame);
        padding slots crop the dummy box."""
        frame, row, real = slots.unbind(0)
        boxes = det.boxes[frame, row.clamp(max=det.boxes.shape[1] - 1)]
        boxes = torch.where(real.bool()[:, None], boxes, self._dummy_box)
        scal, ints = banded_prep(boxes, pyr.src_hw, pyr.dims,
                                 self.reid.cfg.crop_hw)
        return scal, ints, frame.to(torch.int32)

    def _wait_counts(self, read: Download) -> np.ndarray:
        """The tick's one host wait: the (S,) detection counts that size
        the crop batch. Counted and timed (``count_waits``,
        ``count_wait_ms``)."""
        with self.spans.stage("ssyt.embed.count_wait"):
            t0 = time.perf_counter()
            counts = read.wait()
            self.count_wait_ms += (time.perf_counter() - t0) * 1e3
        self.count_waits += 1
        return counts

    @torch.no_grad()
    def embed(self, frames: torch.Tensor, det: Detections,
              mask: np.ndarray | None = None) -> torch.Tensor | None:
        """ReID features (S, tracker_max_dets, D) float32 of each frame's
        detections, or None for a tracker without ReID. One crop batch
        covers the real detections of all S frames (sized from the
        counts, so it grows with the load, not with S); rows past a
        frame's count, or past ``reid_topk``, and every row of a frame
        whose (S,) ``mask`` entry is False get a zero feature. The counts
        start for the host before the pyramid is queued and are waited
        for after it, so the device has the pyramid to run meanwhile.
        :meth:`embed_start` and :meth:`embed_finish` are its two halves:
        a caller may queue other work between them."""
        return self.embed_finish(self.embed_start(frames, det), det, mask)

    @torch.no_grad()
    def embed_start(self, frames: torch.Tensor, det: Detections):
        """The first half of :meth:`embed`: the counts' copy to the host
        and the pyramid, queued without a wait (None without ReID)."""
        if self.reid is None:
            return None
        with self.spans.stage("ssyt.embed.start"):
            read = Download(det.count)
            return read, self.pyramid(frames)

    @torch.no_grad()
    def embed_finish(self, started, det: Detections,
                     mask: np.ndarray | None = None) -> torch.Tensor | None:
        """The second half of :meth:`embed`: wait for the counts, then
        crop and embed; the slots and real crops are added to
        ``crop_slots`` and ``crop_real``."""
        if started is None:
            return None
        read, pyr = started
        counts = self._wait_counts(read)
        with self.spans.stage("ssyt.embed.crop"):
            s, t = det.count.shape[0], self.tracker_max_dets
            feats = torch.zeros((s, t, self.feat_dim), dtype=torch.float32,
                                device=self.device)
            slots = self.embed_slots(counts, mask)
            real = slots[2].astype(bool)
            g, n = slots.shape[1], int(real.sum())
            self.crop_slots += g
            self.crop_real += n
            if n == 0:
                return feats
            # the slots and the real slots' (index, frame, row): one copy
            idx = to_device(np.concatenate(
                [slots.ravel(), np.flatnonzero(real), slots[0, real],
                 slots[1, real]]), self.device)
            keep, frame, row = idx[3 * g:].view(3, n)
            crops = banded_crop(
                pyr, *self.crop_params(pyr, det, idx[:3 * g].view(3, g)),
                self.reid.cfg.crop_hw)  # (G, 3, 128, 64)
        with self.spans.stage("ssyt.embed.reid"):
            feats[frame, row] = self.reid(crops)[keep]
        return feats

    @torch.no_grad()
    def associate(
        self, states: TrackState, det: Detections,
        warps: torch.Tensor | None = None,
        feats: torch.Tensor | None = None,
        has_app: torch.Tensor | None = None,
    ) -> tuple[TrackState, TrackOutputs]:
        """The tracker tail of S streams: the top ``tracker_max_dets`` rows
        of each frame's detections (exact: rows are confidence-sorted)
        with their ReID ``feats`` (from :meth:`embed`), and the count of
        valid rows below that cut recorded. ``has_app`` (S,) bool, for
        StrongSORT: False where a stream's features were not computed."""
        if self.gmc_method != "none" and warps is None:
            raise ValueError(f"gmc_method={self.gmc_method!r} needs (S, 2, 3) "
                             "warps")
        t = self.tracker_max_dets
        warp = warps if self.gmc_method != "none" else None
        with self.spans.stage("ssyt.track"):
            rows = (det.boxes[:, :t], det.scores[:, :t], det.classes[:, :t],
                    det.valid[:, :t])
            if self.is_strongsort:
                states, out = strongsort_step(
                    states, *rows, feats, self.tracker_cfg, warp=warp,
                    has_app=has_app,
                )
            else:
                states, out = bytetrack_step(
                    states, *rows, self.tracker_cfg, det_feats=feats,
                    warp=warp
                )
            states = states._replace(
                truncated_dets=states.truncated_dets
                + det.valid[:, t:].sum(1, dtype=torch.int32)
            )
        return states, out

    def _warps(self, warps, n: int) -> torch.Tensor | None:
        if warps is None:
            return None
        if self.gmc is not None:
            raise ValueError(
                "explicit warps are not taken with gmc_method='flow_tpu' "
                "(the warp is estimated on the device from the previous "
                "frame); use another gmc_method to pass host warps"
            )
        w = np.asarray(warps, np.float32)
        if w.shape != (n, 2, 3):
            raise ValueError(f"warps must be ({n}, 2, 3), got {tuple(w.shape)}")
        return to_device(w, self.device)

    def _extras_rows(self, extras: dict, rows: list[np.ndarray],
                     after: torch.cuda.Event | None) -> list[dict]:
        """The extras of the given detection rows of each frame (``rows[f]``,
        -1 for none, which gets zeros) -> per frame, name -> host array.
        Only the selected rows leave the device, one pinned copy per name.
        On the card the gather and its copies run on the download stream
        once ``after`` (the event of the tick that made ``extras``; None
        on the CPU) has passed, so they wait for no later tick."""
        if not extras:
            return [{} for _ in rows]
        frame = np.repeat(np.arange(len(rows)), [len(r) for r in rows])
        flat = np.concatenate(rows).astype(np.int64)
        k = next(iter(extras.values())).shape[1]
        sel = np.stack([frame, np.clip(flat, 0, k - 1)])
        stream = self._copies.download  # None on the CPU: no stream switch
        if stream is not None:
            stream.wait_event(after)
            for value in extras.values():
                value.record_stream(stream)
        with torch.cuda.stream(stream):
            f, r = to_device(sel, self.device)
            downs = {name: Download(value[f, r])
                     for name, value in extras.items()}
        split = np.cumsum([len(r) for r in rows])[:-1]
        out = [{} for _ in rows]
        for name, down in downs.items():
            data = down.wait()
            data[flat < 0] = 0.0
            for f, part in enumerate(np.split(data, split)):
                out[f][name] = part
        return out

    def _results(self, boxes: Boxes, extras: dict, src_hw, orig_img=None) -> Results:
        masks = keypoints = None
        if "masks" in extras:
            size = self.det_cfg.imgsz
            masks = Masks(extras["masks"], self._geometry(src_hw).lp, src_hw,
                          (size, size))
        if "keypoints" in extras:
            keypoints = Keypoints(extras["keypoints"])
        return Results(boxes, self.names, masks=masks, keypoints=keypoints,
                       orig_img=orig_img)

    def _materialize(self, handle: TickHandle) -> list[Results]:
        """Results of each frame of a tick from its packed (K, 9) track
        outputs and the task extras of its detections
        (:meth:`detect_with_extras`); waits for this tick only."""
        with self.spans.stage("ssyt.materialize", handle.tick):
            packed = handle.packed.wait()
            active = [out[:, 7] > 0.5 for out in packed]
            if handle.host_extras is None:
                handle.host_extras = self._extras_rows(
                    handle.extras,
                    [out[a, 8].astype(np.int64)
                     for out, a in zip(packed, active)],
                    handle.packed.done)
                handle.extras = None
            orig = handle.orig_imgs
            return [
                self._results(
                    Boxes(out[a, :4], out[a, 5], out[a, 6], id=out[a, 4]), ex,
                    handle.src_hw, None if orig is None else orig[f])
                for f, (out, a, ex) in enumerate(
                    zip(packed, active, handle.host_extras))
            ]

    # -- host-facing API ------------------------------------------------

    @torch.no_grad()
    def calibrate_int8(self, frames) -> int:
        """Static activation scales for the int8 convs: the detect step
        over each of the given (H, W, 3) uint8 BGR frames, on this
        pipeline's device, records each int8 conv's input amax (with the
        scales the convs hold: dynamic until calibrated), then every such
        conv takes ``xscale = float32(max(amax, 1e-6) / 127)``, as the JAX
        ``calibrate_int8`` gives it. -> the number of calibrated convs."""
        with common.calibrating(self.model) as stats:
            for frame in frames:
                with self._copies.frames(np.asarray(frame)[None]) as dev:
                    self.detect(dev)
        return common.inject_scales(stats)

    def reset(self) -> None:
        """New stream: clear the tracker state and the GMC's kept frame."""
        self.track_state = self.init_states(1)
        for gmc in (self.gmc, self.host_gmc):
            if gmc is not None:
                gmc.reset()

    def predict(self, frame_bgr: np.ndarray) -> Results:
        """Detect without tracking; pose and segment extras for every row."""
        with self._copies.frames(frame_bgr[None]) as frames:
            det, extras = self.detect_with_extras(frames,
                                                  self.det_cfg.max_det)
        rows = Download(torch.cat([det.boxes[0], det.scores[0, :, None],
                                   det.classes[0, :, None].float()], -1))
        n = int(Download(det.count).wait()[0])
        out = rows.wait()
        boxes = Boxes(out[:n, :4], out[:n, 4], out[:n, 5])
        ex = self._extras_rows(extras, [np.arange(n)], rows.done)[0]
        return self._results(boxes, ex, frame_bgr.shape[:2], frame_bgr)

    def track_async(self, frame_bgr: np.ndarray, warp=None) -> TickHandle:
        """Dispatch one detect + track step of this pipeline's stream and
        return its handle without waiting for the device; ``warp`` (2, 3)
        in place of the host estimator's (``sparseOptFlow``, ``ecc``;
        refused with ``flow_tpu``). :meth:`materialize` turns the handle into
        Results. Handles may be materialized in any order, and more than
        once."""
        if warp is None and self.host_gmc is not None:
            warp = self.host_gmc.apply(frame_bgr)
        w = None if warp is None else self._warps(np.asarray(warp)[None], 1)
        with self._copies.frames(frame_bgr[None]) as frames:
            if self.gmc is not None:
                w = self.gmc.warps(frames)
            det, extras = self.detect_with_extras(frames,
                                                  self.tracker_max_dets)
            feats = self.embed(frames, det)
        self.track_state, out = self.associate(self.track_state, det, w, feats)
        return TickHandle(Download(_pack_outputs(out)), extras,
                          frame_bgr.shape[:2], [frame_bgr])

    def materialize(self, handle: TickHandle) -> Results:
        """Wait for a :meth:`track_async` handle (that tick only) -> its
        Results."""
        return self._materialize(handle)[0]

    def track(self, frame_bgr: np.ndarray, warp=None) -> Results:
        """Detect + track one frame of this pipeline's stream; ``warp``
        (2, 3) in place of the host estimator's."""
        return self.materialize(self.track_async(frame_bgr, warp))

    def __call__(self, frame_bgr: np.ndarray, track: bool = True) -> Results:
        return self.track(frame_bgr) if track else self.predict(frame_bgr)

    def track_chunk(self, frames_bgr: np.ndarray, warps=None) -> list[Results]:
        """T consecutive frames (T, H, W, 3) of this pipeline's stream ->
        T Results, the same as T :meth:`track` calls: the T frames are
        detected (and, for a ReID tracker, embedded) as one batch, the
        ``flow_tpu`` warps of all T frame pairs come from one K5 launch
        (otherwise ``warps`` (T, 2, 3) from the caller, else the host
        estimator's, frame by frame), and the tracker steps frame by
        frame."""
        t = len(frames_bgr)
        if warps is None and self.host_gmc is not None:
            warps = np.stack([self.host_gmc.apply(f) for f in frames_bgr])
        w = self._warps(warps, t)
        with self._copies.frames(frames_bgr) as frames:
            if self.gmc is not None:
                w = self.gmc.warps(frames)
            det, extras = self.detect_with_extras(frames,
                                                  self.tracker_max_dets)
            feats = self.embed(frames, det)
        outs = []
        for k in range(t):
            self.track_state, out = self.associate(
                self.track_state, Detections(*(x[k:k + 1] for x in det)),
                None if w is None else w[k:k + 1],
                None if feats is None else feats[k:k + 1],
            )
            outs.append(out)
        return self._materialize(TickHandle(
            Download(_pack_outputs(*outs)), extras, frames_bgr.shape[1:3],
            frames_bgr))

    def track_batch_prepare(self, num_streams: int, src_hw, *, mesh=None,
                            auto_topk: bool = False):
        """-> a :class:`BatchedPipeline` of ``num_streams`` streams of
        ``src_hw`` frames; with ``mesh`` (``parallel/mesh.make_mesh``) a
        :class:`ShardedBatchedPipeline`, whose streams split over the
        mesh's dp rows. ``auto_topk`` is taken and changes nothing: the
        JAX package uses it to pick a narrower ReID crop batch and replay a
        tick that overflows it, while the port sizes its crop batch from
        each tick's real detection counts, so either value gives the same
        results, which equal the JAX package's with either value."""
        if mesh is not None:
            return ShardedBatchedPipeline(self, num_streams, src_hw, mesh)
        return BatchedPipeline(self, num_streams, src_hw)


def _device_key(device: torch.device) -> torch.device:
    """``device`` with the current CUDA device's index where it has none."""
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def device_scope(device: torch.device):
    """The context in which work for ``device`` is queued: on a card that
    card as the current device (its current stream and events); nothing
    on the CPU."""
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


def _pack_outputs(*outs: TrackOutputs) -> torch.Tensor:
    """(sum S, K, 9) float32 [x1 y1 x2 y2 id score cls active det_index]
    of one or more steps' outputs, for one device-to-host copy (ids,
    classes and detection rows are exact in float32)."""
    return torch.cat([
        torch.cat(
            [
                out.boxes,
                out.track_id.float()[..., None],
                out.score[..., None],
                out.cls.float()[..., None],
                out.active.float()[..., None],
                out.det_index.float()[..., None],
            ],
            dim=-1,
        )
        for out in outs
    ])


class BatchedPipeline:
    """S same-resolution streams stepped together: one model forward,
    one NMS launch and one tracker step per tick for all S, each stream
    with the semantics of its own ``Pipeline.track`` calls. With
    ``flow_tpu`` it keeps each stream's previous gray frame
    (``prev_grays`` (S, BASE_H, BASE_W) and ``has_prev`` (S,) bool, both
    on the device and updated in place, so a tick copies nothing to the
    device for them); ``last_warps`` holds the (S, 2, 3) warps the last
    step applied. With the pipeline's ``reid_cadence`` k > 1 and a
    StrongSORT tracker, stream s embeds on ticks where (s + tick) % k ==
    0 (tick counting steps from 0), so each tick crops about S / k
    streams; ``last_embed_mask`` holds the last step's (S,) bool mask
    (None at cadence 1).

    :meth:`step_async` dispatches a tick and returns its handle without
    waiting for the device; :meth:`materialize` waits for that tick only.
    On the card the frames go through ``ring``, pinned host slots and
    device slots allocated here, and a tick waits on the host only for
    the ReID trackers' detection counts; on the CPU a tick is computed
    when it is dispatched."""

    def __init__(self, pipeline: Pipeline, num_streams: int, src_hw):
        self.pipeline = pipeline
        self.num_streams = num_streams
        self.src_hw = (int(src_hw[0]), int(src_hw[1]))
        pipeline._geometry(self.src_hw)  # its constants uploaded here
        self.ring = pipeline._copies.ring((num_streams, *self.src_hw, 3))
        self.states = pipeline.init_states(num_streams)
        self.flow = pipeline.gmc is not None
        # the host estimators, one per stream (sparseOptFlow, ecc)
        self.gmcs = (None if pipeline.host_gmc is None else
                     [make_gmc(pipeline.gmc_method) for _ in range(num_streams)])
        self.prev_grays = None
        if self.flow:
            self.prev_grays = torch.zeros(
                (num_streams, BASE_H, BASE_W), dtype=torch.float32,
                device=pipeline.device,
            )
        self.has_prev = torch.zeros(num_streams, dtype=torch.bool,
                                    device=pipeline.device)
        self.last_warps: torch.Tensor | None = None
        self.cadence = pipeline.reid_cadence if pipeline.reid is not None else 1
        if self.cadence > 1 and not pipeline.is_strongsort:
            raise ValueError(
                "reid_cadence > 1 needs a StrongSORT tracker (its stage-1 "
                "cost falls back to motion alone); BoT-SORT keeps cadence 1")
        self.tick = 0
        self.last_embed_mask: np.ndarray | None = None
        if self.cadence > 1:  # the (k, S) masks of one cycle, host and device
            cycle = np.arange(self.cadence)[:, None] + np.arange(num_streams)
            self._masks = cycle % self.cadence == 0
            self._has_app = torch.from_numpy(self._masks).to(pipeline.device)

    def reset_stream(self, i: int) -> None:
        """Reinitialise one stream's tracker state in place; its next
        warp is the identity. Ordered on the device after every tick
        dispatched before it, so pending handles keep their results."""
        fresh = self.pipeline.init_states(1)
        for batched, f in zip(self.states, fresh):
            batched[i] = f[0]
        self.has_prev[i] = False
        if self.gmcs is not None:
            self.gmcs[i].reset()

    def compute_warps(self, frames: np.ndarray) -> np.ndarray:
        """(S, 2, 3) float32 warps of the S streams' host estimators
        (``sparseOptFlow``, ``ecc``) on their next frames; what
        :meth:`step_async` computes when it is given no warps."""
        if self.gmcs is None:
            raise ValueError(
                f"compute_warps: gmc_method={self.pipeline.gmc_method!r} "
                "has no host estimator")
        return np.stack([g.apply(f) for g, f in zip(self.gmcs, frames)]
                        ).astype(np.float32)

    def step_async(self, frames: np.ndarray,
                   warps: np.ndarray | None = None) -> TickHandle:
        """Dispatch one tick of the S streams -> its handle, without
        waiting for the device. frames (S, H, W, 3) uint8 BGR, copied
        before this returns; warps (S, 2, 3) in place of the host
        estimators' (:meth:`compute_warps`; refused with ``flow_tpu``).
        Recorded as the span ``ssyt.tick`` with the tick's number."""
        with self.pipeline.spans.stage("ssyt.tick", self.tick):
            return self._finish(self._start(frames, warps))

    def _start(self, frames: np.ndarray, warps: np.ndarray | None):
        """The first half of a tick: everything queued before the ReID
        trackers' wait for their detection counts."""
        p = self.pipeline
        if tuple(frames.shape[:3]) != (self.num_streams, *self.src_hw):
            raise ValueError(
                f"frames must be ({self.num_streams}, {self.src_hw[0]}, "
                f"{self.src_hw[1]}, 3), got {tuple(frames.shape)}"
            )
        if warps is None and self.gmcs is not None:
            with p.spans.stage("ssyt.gmc"):
                warps = self.compute_warps(frames)
        w = p._warps(warps, self.num_streams)
        mask = has_app = grays = None
        tick = self.tick
        if self.cadence > 1:
            phase = tick % self.cadence
            mask, has_app = self._masks[phase], self._has_app[phase]
        self.tick += 1
        with p._copies.frames(frames, self.ring) as dev_frames:
            if self.flow:  # all S warps in one K5 launch
                with p.spans.stage("ssyt.gmc"):
                    grays = frame_to_gray(dev_frames)
                    w = batched_warps(self.prev_grays, grays, self.src_hw,
                                      self.has_prev)
            det, extras = p.detect_with_extras(dev_frames, p.tracker_max_dets)
            started = p.embed_start(dev_frames, det)
        return w, mask, has_app, grays, det, extras, started, tick

    def _finish(self, begun) -> TickHandle:
        """The second half of a tick (:meth:`_start`'s result): the ReID
        crops and the tracker step."""
        p = self.pipeline
        w, mask, has_app, grays, det, extras, started, tick = begun
        feats = p.embed_finish(started, det, mask)
        self.states, out = p.associate(self.states, det, w, feats, has_app)
        if self.flow:
            self.prev_grays = grays
            self.has_prev.fill_(True)
        self.last_warps = w
        self.last_embed_mask = mask
        with p.spans.stage("ssyt.download"):
            packed = Download(_pack_outputs(out))
        return TickHandle(packed, extras, self.src_hw, tick=tick)

    def materialize(self, handle: TickHandle) -> list[Results]:
        """Wait for a :meth:`step_async` handle (that tick only) -> list of
        S Results. Handles may be materialized in any order, and more
        than once; a later tick never changes an earlier tick's Results."""
        return self.pipeline._materialize(handle)

    def step(self, frames: np.ndarray, warps: np.ndarray | None = None):
        """frames (S, H, W, 3) uint8 BGR; warps (S, 2, 3) in place of the
        host estimators' -> list of S Results."""
        return self.materialize(self.step_async(frames, warps))

    def refresh_steps(self) -> None:
        """After the pipeline's weights changed out of band (for instance
        by ``Pipeline.calibrate_int8``): wait for the ticks dispatched so
        far, then drop what the convs derived from the weights (K7's and
        K8's packed copies)."""
        self.sync()
        for m in self.pipeline.model.modules():
            if isinstance(m, common.Conv):
                m.drop_caches()

    def sync(self) -> None:
        """Wait for every tick dispatched so far (and every
        ``reset_stream``) on the device: an event recorded now on the
        current stream."""
        if self.pipeline.device.type == "cuda":
            done = torch.cuda.Event()
            done.record()
            done.synchronize()


class ShardedHandle:
    """One dispatched tick of a :class:`ShardedBatchedPipeline`: its
    blocks' handles, in stream order."""

    __slots__ = ("handles",)

    def __init__(self, handles: list[TickHandle]):
        self.handles = handles

    def query(self) -> bool:
        return all(h.query() for h in self.handles)


class ShardedBatchedPipeline:
    """S streams split over a mesh's dp rows: block k steps streams [k S /
    dp, (k + 1) S / dp) as a :class:`BatchedPipeline` on the device of dp
    row k (its first tp column; the tp axis replicates, as in the JAX
    package). The streams are independent, so the blocks exchange
    nothing: one process queues every block's work, each on its own
    device. The models are copied to each distinct device once, here
    (``Pipeline.on_device``); blocks on a repeated device share one copy.

    The :class:`BatchedPipeline` surface, streams in their global order:
    :meth:`step_async` queues every block's detector, NMS and pyramid
    work before any block waits on its ReID detection counts (a wait in
    between would hold the other devices idle), then each block's crops
    and tracker step. ``states`` and ``last_warps`` gather the blocks'
    onto the first block's device."""

    def __init__(self, pipeline: Pipeline, num_streams: int, src_hw, mesh):
        dp = mesh.shape["dp"]
        if num_streams % dp:
            raise ValueError(f"{num_streams} streams do not split over "
                             f"dp={dp}")
        if pipeline.reid is not None and pipeline.reid_cadence > 1:
            raise ValueError(
                "reid_cadence > 1 takes no mesh (the JAX package embeds at a "
                "cadence only in its packed cross-stream path, without a "
                "mesh)")
        self.pipeline = pipeline
        self.mesh = mesh
        self.num_streams = num_streams
        self.src_hw = (int(src_hw[0]), int(src_hw[1]))
        self.per = num_streams // dp
        copies: dict[torch.device, Pipeline] = {}
        self.blocks: list[BatchedPipeline] = []
        for device in mesh.devices[:, 0]:
            key = _device_key(device)
            if key not in copies:
                copies[key] = pipeline.on_device(device)
            with device_scope(device):
                self.blocks.append(
                    BatchedPipeline(copies[key], self.per, self.src_hw))

    def _parts(self, array):
        if array is None:
            return [None] * len(self.blocks)
        return [array[k * self.per:(k + 1) * self.per]
                for k in range(len(self.blocks))]

    def step_async(self, frames: np.ndarray,
                   warps: np.ndarray | None = None) -> ShardedHandle:
        """Dispatch one tick of the S streams -> its handle (see
        :meth:`BatchedPipeline.step_async`)."""
        if tuple(frames.shape[:3]) != (self.num_streams, *self.src_hw):
            raise ValueError(
                f"frames must be ({self.num_streams}, {self.src_hw[0]}, "
                f"{self.src_hw[1]}, 3), got {tuple(frames.shape)}")
        if warps is not None:
            warps = np.asarray(warps, np.float32)
            if warps.shape != (self.num_streams, 2, 3):
                raise ValueError(f"warps must be ({self.num_streams}, 2, 3), "
                                 f"got {tuple(warps.shape)}")
        begun = []
        for b, f, w in zip(self.blocks, self._parts(frames), self._parts(warps)):
            with device_scope(b.pipeline.device):
                begun.append(b._start(f, w))
        handles = []
        for b, started in zip(self.blocks, begun):
            with device_scope(b.pipeline.device):
                handles.append(b._finish(started))
        return ShardedHandle(handles)

    def materialize(self, handle: ShardedHandle) -> list[Results]:
        """Wait for a :meth:`step_async` handle -> list of S Results."""
        out = []
        for b, h in zip(self.blocks, handle.handles):
            with device_scope(b.pipeline.device):
                out.extend(b.materialize(h))
        return out

    def step(self, frames: np.ndarray, warps: np.ndarray | None = None):
        """frames (S, H, W, 3) uint8 BGR -> list of S Results."""
        return self.materialize(self.step_async(frames, warps))

    def compute_warps(self, frames: np.ndarray) -> np.ndarray:
        """(S, 2, 3) warps of the streams' host estimators."""
        return np.concatenate([b.compute_warps(f) for b, f in
                               zip(self.blocks, self._parts(frames))])

    def reset_stream(self, i: int) -> None:
        b = self.blocks[i // self.per]
        with device_scope(b.pipeline.device):
            b.reset_stream(i % self.per)

    def sync(self) -> None:
        for b in self.blocks:
            with device_scope(b.pipeline.device):
                b.sync()

    def _gather(self, parts: list[torch.Tensor]) -> torch.Tensor:
        first = self.blocks[0].pipeline.device
        return torch.cat([t.to(first) for t in parts])

    @property
    def states(self) -> TrackState:
        """The S streams' tracker state (a copy on the first block's
        device)."""
        return TrackState(*(self._gather(list(fields)) for fields in
                            zip(*(b.states for b in self.blocks))))

    @property
    def last_warps(self) -> torch.Tensor | None:
        if self.blocks[0].last_warps is None:
            return None
        return self._gather([b.last_warps for b in self.blocks])
