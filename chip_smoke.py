#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (strongsort_yolo_tpu_torch) on one
NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing its results on lines of their own; any failure
raises and the process exits nonzero:

1. environment: the card's name and power limit (nvidia-smi), torch and
   CUDA versions, whether Triton is installed, and the kernel build time
   (the CUDA sources under strongsort_yolo_tpu_torch/csrc are compiled
   here, from the checkout, one nvcc per source, all at once);
2. each hand-written kernel against its plain PyTorch version on the
   card, at the shapes the main path gives it, with CUDA-event times of
   both sides (K1: bit-identical in float32 and bfloat16 at 1080x1920,
   720x1280, portrait 1920x1080 (a side bar of 140 columns), 481x853
   (rows of 2559 bytes) and 240x320, timed by CUDA-graph replay beside
   events, and the SASS of K1 and K4 free of 64-bit integer division
   (tools/sass.py); K2: its (8, 512) keep mask bit-identical, the size
   of its cluster of thread blocks per frame printed, timed by
   CUDA-graph replay beside events; K3: also (256, 256), (512, 250)
   and (1100, 300) problems, whose benefit block K3 holds in its global
   scratch,
   bit-identical, with the form each took, and in phase 3 the three
   calls of one steady BoT-SORT tick, captured on the main path,
   bit-identical and timed by CUDA-graph replay with their valid rows,
   columns and rounds; K4: bit-identical in float32 and bfloat16, on
   1080p and on 481x853 frames, in its fixed-width and its packed form;
   its times are taken in phase 3, on the StrongSORT path's own crop
   batch, by CUDA-graph replay beside events; K5: the LK params of S=8
   and of T=32 panned pyramid pairs, and of S=8 rotated and scaled
   pairs after one step per level, within 1e-4 base px and 1e-6, two launches bit-identical, each
   pair of the T=32 launch bit-identical to its N=1 launch, the size of
   its cluster of thread blocks per pair and the pairs the card holds at
   once printed, timed by CUDA-graph replay beside events (and at S=8 its
   C entry point alone), with the N=32 / N=8 ratio, and K5 with one
   level, the form of the TPU's lk_level_pallas, on S=8 180x320 pairs;
   K6: each of the three fused OSNet stages of the four
   released widths x0_25, x0_5, x0_75 and x1_0, on G=480 seeded crops
   for x0_25 and K6_G_WIDE for the others (x0_25 and the stages that
   bfloat16 splits over a cluster of blocks a crop also at G = 0, 1, 7),
   each in its form, HMMA instructions in every instance of both
   tensor-core kernels and no spill in the cluster form's, float32
   within 1e-4 and bfloat16 (the tensor-core forms) within the
   K6_BF16_MEAN bar, two launches
   bit-identical, then the trained OSNet's rank-1 >= 0.9 on its unseen
   identities, fused in bfloat16 (K6) and unfused; K7: HGMMA
   instructions in every mma and bfloat16 im2col kernel of the built
   library and no local-memory access (spill) in the CUDA-core kernel
   (cuobjdump -sass), then every conv shape that the K7 rule picks in
   yolo11n-pose and yolov8n at 640, S=8, NCHW, in every form (mma, the
   tensor-core form, in bfloat16; taps and im2col in both dtypes),
   float32 within 2e-5 x max(1, |ref|) and bfloat16 within one bf16 unit
   at 1.0 of the output scaled by max(1, |ref|), two launches
   bit-identical, the NHWC layout on four of them in both dtypes;
   device times (CUDA graph replay) in bfloat16 and in float32 beside the
   plain version's, cuDNN's F.silu(F.conv2d(x, w, b)) in the same dtype
   (two launches; float32 with TF32 off) and the bound, summed over the
   41 convs of a yolo11n-pose forward);
3. the main paths at full width: yolov8n (nc=80, imgsz 640, bf16,
   seeded random weights with the class-head bias calibrated to about
   120 candidates per frame), BatchedPipeline over S=8 streams of
   1080p frames, 10 ticks each: BoT-SORT without camera-motion
   compensation (K1-K3); StrongSORT with OSNet-x0_25 (random weights
   from a seed, 256 track slots, 128 tracker dets, reid_topk 128),
   which runs K1-K4, K4 once per tick, then K4 (bit-identical) and its
   plain version timed on the last tick's crop batch; the same with
   reid_fused=True (K1-K4 and K6, K6 three times per tick), its ms/tick beside the
   unfused path's and OSNet on one crop batch fused against unfused;
   the fused path with reid_cadence=2 (the embed masks alternate, the
   crop batch about halves); the fused path with OSNet-x1_0 (seeded
   random weights, WIDE_TICKS ticks, K6 three times per tick), K6 alone
   on its three stages at the G it took, and its
   float32 embeddings on the card against the CPU; ByteTrack with
   tracker_max_dets=256 on 256 slots (CROWD_TICKS ticks, K3 on 256 x 256
   problems in its global-scratch form); BoT-SORT with
   gmc_method="flow_tpu" on a smooth periodic scene that each stream
   pans by its own integer step per tick (K1-K3 and K5, K5 once per
   tick, each pan recovered within 2 frame px from tick 1 on), with its
   ms/tick beside the first path's and the split of its camera-motion
   estimate (K5 by events and by graph replay); the same scene under
   fractional pans, whose error is reported apart (within one gray
   pixel, 6 frame px: the 1080p ->
   180x320 gray aliases a hard edge panned by a fraction of that);
   then one stream's 10 frames through 10 Pipeline.track
   calls (K5 10 launches) and through one Pipeline.track_chunk (K5
   once), timed; yolo11n-pose with BoT-SORT (K1-K3, keypoints on every
   track row); the same with conv_kernel=True (K1-K3 and K7's mma form,
   K7 once per picked conv and tick), its ms/tick beside the route-off
   path's and the model forward with and without the route (CUDA
   events); and yolov8n-seg with BoT-SORT (K1-K3, a mask and a polygon
   per track row, the polygons traced on the host and timed apart from
   the tick); each path's launch counts are zeroed before it and must
   all have moved after it; every path steps through BatchedPipeline.step,
   which is materialize(step_async(...)): frames through a pinned ring,
   outputs through pinned, event-fenced copies; the task paths also time
   the track rows' extras to the host, pinned on the download stream
   against a pageable .cpu(); then the v5 and v7 detector paths (S=8
   1080p, imgsz 640, bf16, seeded random weights, the head's output rows
   spread and its objectness (u: class) biases calibrated to about 120
   candidates per frame): (f) yolov5s, classic anchor head, with
   StrongSORT + OSNet-x0_25 fused (K1-K4 and K6) and (g) yolov7, RepConv
   deployed and BN fused, with the same tracker, 10 ticks each; (f-u)
   yolov5su with BoT-SORT, gmc none (K1-K3), 4 ticks; each with its
   launch counts, ms/tick, the forward by CUDA events and the NMS
   (ranking, K2 and the selection, on 25 200 anchors for the anchor heads)
   on the last tick's model outputs; on f and g the crop batch G of
   each tick, and on the last tick's batch K4 bit-identical to its
   plain version and each K6 stage, on the inputs the OSNet feeds it,
   against its plain version within K6's bars;
3b. the asynchronous API on paths a, b-fused, c and e (S=8 1080p): the
   step loop and the overlapped loop (step_async t, then materialize
   t - 1, as the app runs) in turns, step, overlapped, overlapped, step,
   their Results bit-identical (cuDNN deterministic); ms per tick (median,
   p90) of both loops and step_async's host ms; the sync check: four
   overlapped ticks under torch.cuda.set_sync_debug_mode("warn") issue
   no synchronizing op, and the host waits only for each handle's event
   and, on the ReID path, once per tick for the detection counts (ms per
   tick printed); the device's busy share of both loops under
   torch.profiler; on path a the upload split (pageable .to() against
   the ring's fill of a pinned slot, PyTorch's threaded CPU copy, and
   that slot's copy by CUDA events);
4. the trained synth160 checkpoints on rendered frames, on the card with
   the kernels and on the CPU with the plain versions (float32, TF32
   off), for ByteTrack, for StrongSORT with the trained OSNet
   (assets/osnet_x0_25_synth.npz), unfused and fused, for StrongSORT
   with a seeded OSNet-x1_0, fused, for ByteTrack at 256 slots x 256
   tracker dets (K3's global-scratch form) and for BoT-SORT with
   flow_tpu on a panned copy of the frames: equal rows, boxes within
   1e-3 px, equal track ids (and flow warps within 2e-3); and the
   trained yolov8n-seg, yolov8n-pose and yolo11n-pose synth160 task
   checkpoints with ByteTrack, the K7 route off and on: equal rows and
   ids, boxes and keypoints within 1e-3 px, equal mask polygons; and
   ultralytics-format .pt files of a seeded yolov5s (StrongSORT + the
   trained OSNet, fused) and yolov7 (ByteTrack), written by
   save_ultralytics and loaded through Pipeline(weights=path) on both
   sides: equal rows and ids, boxes within 1e-3 px; and the four quality
   bars of tests/test_torch_tasks.py and tests/test_torch_quality.py on
   the card in their own configurations (float32, TF32 off), on the
   frames of the port's copies (media/video: ellipse_frame, dots_frame,
   BounceClip, SyntheticDetSource): the trained yolov8n-seg's mask IoU
   with the ellipse > 0.75 and above the box's, the trained yolov8n-pose
   and yolo11n-pose's mean keypoint error < 10 px and conf > 0.5, the
   trained detector's MOTA and IDF1 > 0.8 with no id switch, and
   StrongSORT + the trained OSNet through the occlusion bounce at IDF1 >
   0.73 with at most 3 id switches, each metric beside the CPU's in the
   same run and what the JAX test cites;
5. the app and CLI: a media probe (cv2 present or absent, the drawing
   shim built with its seconds or the compiler's error, the libav
   decoder and encoder loaded or the loader's error, and whether
   pkg-config and the headers of libavformat, libavcodec, libswscale and
   libavutil are there to build them); then the app at
   full width, S=8 streams of 1080p SyntheticSource frames (seeds 0-7,
   APP_FRAMES frames), yolov8n with the class bias calibrated as in
   phase 3 (written as an .npz checkpoint), imgsz 640, bf16, --track
   --count --count-line, --log-events, --checkpoint-every 5, run as
   cli.main runs it (parse_config, app.run, cli.report) on mp4 files
   (written by the native encoder, else cv2, and read back through the
   app's open_source), else on the in-memory sources with save off (the
   line says which); a BoT-SORT YAML with gmc_method flow_tpu (K1-K3
   and K5 launched), then a StrongSORT YAML with gmc_method flow_tpu
   (the host ECC of strongsort.yaml is timed in phase 8f) with the
   trained OSNet and SSYT_OSNET=fused (K1-K6, bf16; G per tick printed, and K4
   and K6 held against their plain versions on tick 1's crop batch, the
   trained weights in K6's tensor-core form: check_path_crops, its G
   equal to the app's); each on one pipeline built by
   app.make_pipeline, which serves a 2-frame warm-up run and then the
   measured run; per stream its fps, counts and StageTimers stages (means
   over all the measured run's ticks), every stream at
   APP_FRAMES frames without an error, the event log's kinds; the app
   on the card against the CPU (synth160, imgsz 160, float32, two
   SyntheticDetSource streams, bytetrack.yaml and botsort.yaml, the
   latter's sparseOptFlow on the host): equal
   counts, line counts and event kinds, the last checkpoints' track_id,
   status and next_id equal and their means within 1e-3, label files
   parsed (frame, class and id exact, conf within 1e-3, coordinates
   within 1 px); and a run killed after frame 3 and resumed on the card,
   sequential and batched (cuDNN deterministic), equal to the
   uninterrupted run: final checkpoints field for field and the label
   files byte for byte; then tools/make_demo's three images rendered on
   the card and on the CPU into a temporary directory, their decoded
   pixels equal;
6. offline tracking, the repo's tracking-quality tools on the card:
   (6a) ``tools/eval_mot --public`` on tests/fixtures/MOT-synth01 for
   bytetrack.yaml, botsort.yaml, strongsort.yaml (motion-only) and
   bytetrack.yaml with --strongsort-pp, without and with --aflink (K3),
   each row equal to BASELINE.md:148-152 to four places and its JSON line
   equal to the same run with --device cpu, one mid-sequence K3 call
   bit-identical to auction_plain; (6b) ``eval_mot`` with the detector on
   a MOT17-layout sequence of 60 rendered 1080p frames written as JPEG by
   cv2 (yolov8n 640 bf16, class bias calibrated, botsort.yaml with its
   host sparseOptFlow, as the JAX tool runs it: K1-K3), its row, launches and host ms per frame printed (random
   weights: no bar); (6c) ``tools/eval_sequence`` with the trained
   synth160 detector and OSNet-x0_25: --cycles 2 --cadence 1 2 (the
   strongsort, lambda-0 and StrongSORT++ rows, vis and occ, and the
   cadence rows, each printed beside BASELINE.md's), held to
   tests/test_sequence_quality.py's bars, cadence 1 equal to the classic
   arm; --cycles 1 --pan 10 --gmc flow_tpu held to the panning bar of
   tests/test_torch_quality.py (K5 too); the lambda-0.98 arm and its
   StrongSORT++ pass at cycles 1 on the card equal to the CPU's (metrics,
   ids, boxes within 1e-3 px); K4 bit-identical on a relay tick's crop
   batch; (6d) the shipped AFLink's logits on 800 fresh pairs within
   1e-5 x max(1, |logit|) of the CPU's, the same decisions, accuracy >=
   0.95, then ``tools/train_aflink`` for 200 steps on the card, the loss
   falling;
7. training on the card (float32, TF32 off): (7a) three
   ``make_train_step`` steps from assets/yolov8n_synth160.npz at imgsz
   160, batch 8, on the card and on the CPU on the same synthetic
   batches: losses within 1e-4 relative, num_fg equal and above 0, every
   tensor's first-step gradient (after the clip, the BN statistics
   included) within 1e-4 of the CPU's norm of it; (7b) the recipe of the
   shipped detector, ``tools/train --synthetic --steps 600 --imgsz 160
   --nc 3 --lr 1e-3``, on the card from the initial weights of seeds
   0-5, six trainers at once beside 7e's (first and last loss, median ms
   per step after 20 warm steps, seconds; the loss must fall), each
   result served through Pipeline as tests/test_trained_e2e.py
   configures it on 30 SyntheticDetSource frames (seed 1), printed beside
   the shipped checkpoint's: every draw passing the class test of
   test_trained_model_detects_classes, the mean MOTA and the mean IDF1
   above a bar taken from the JAX trainer's spread over its initial draw
   (``e2e_bar``: one run is one draw), K1-K3 launched, the CPU's Pipeline
   on the first file giving the same ids and boxes within 1e-3 px; (7c)
   yolov8n-seg and yolov8n-pose (5 keypoints), nc 3, 50 steps each at
   imgsz 160: the task terms finite, the loss falling, the saved file
   served with its task; (7d) the full-width step, yolov8n (nc 80)
   batch 16 and yolov8n-seg batch 4 at imgsz 640, 10 steps each: median
   ms per step and peak allocated memory, the losses finite, and the
   yolov8n run again in bfloat16 (make_train_step(compute_dtype=
   torch.bfloat16), float32 masters): ms per step, peak memory, the
   losses beside float32's; (7e) the
   OSNet trainer's own recipe, ``tools/train_osnet --steps 1200``: the
   loss falling, the unseen-id rank-1 at least 0.9, the file served by
   the StrongSORT Pipeline; then K7's gradient on the card
   (``conv_act_nchw``, float32, two of phase 2's shapes) against the
   plain version's autograd within 1e-5 x max(1, |g|);
8. int8 post-training quantization (``quant="int8"``, K8): (8b) yolov8n
   int8 at 640, bf16, BoT-SORT gmc none, S=8 1080p: 3 overlapped ticks
   with the dynamic scales under set_sync_debug_mode("error"), then
   calibrate_int8 on tick 0's first two frames (32 convs, the JAX count)
   and refresh_steps, as the batched app loop does, INT8_TICKS ticks with
   K1 1, K2 1, K3 3 and K8 32 launches a tick, 3 more overlapped ticks
   under the sync check, and ms per tick against the bf16 pipeline in
   turns (printed only); (8d) yolov5s int8 + StrongSORT + OSNet-x0_25
   fused (K1-K4, K6, K8; 42 convs), yolo11n-pose int8 (52, K8's
   depthwise form) and yolov7 int8 + ByteTrack (85, BN fused, RepConv
   deployed; K1-K3, K8 255 in 3 ticks), 3 ticks each, calibrated on
   tick 0's first two frames, one tick's K8 calls captured; then card
   against CPU at imgsz 160, f32, the card's calibrated scales shared:
   fabricated yolov5s and yolov7 .pt files by their detections (random
   weights whose head puts many scores near the threshold among
   overlapping boxes: rows matched within 1 px and 0.03, at least 90% of
   them, each unmatched row half of a class flip or of an NMS swap, near
   the threshold, or suppressed on the other side by an unmatched row
   of its class scoring more than 0.03 above it) and the trained
   yolo11n-pose asset by its
   tracks; every card run of these int8 comparisons (8c too) is made
   twice, with K8 and with conv_s8_plain on the same CUDA tensors, and
   the two must be equal bit for bit; (8a) IGMMA instructions (wgmma
   s8) in every instance of K8's tensor-core kernel and no 64-bit
   division in any of its kernels (the quantize pass, the implicit GEMM,
   the depthwise form), then K8 against conv_s8_plain on
   8b's 32 convs, 8d's stride-2, depthwise and act=False convs and one
   8d yolov7 conv of each class the other paths lack (1x1 with C_in 1024
   and 2048, 3x3 512 -> 1024, 1x1 1024 -> 1024, the widest plane, 3x3
   stride 2), in bf16 and f32, dynamic and calibrated
   scales: int32 sums and every output bit-identical; K8's
   device time per conv by graph replay (its quantize pass and its conv)
   beside its first form's time (tools/prof_s8.YOLOV8N_INT8), the plain
   version's, cuDNN's bf16 conv + SiLU of the dequantized weights (a
   different function) and the bound, and the sums per conv class; K8's
   bars there: the 32 convs no longer than cuDNN over them in the same
   run, each 3x3 conv on a 20 x 20 plane within 0.04 ms, no class slower
   than the first form; then K8's times over the 85 convs of one
   yolov7 tick (8d's) beside cuDNN's and the bound, printed beside
   yolov8n's, and over the 52 convs of one yolo11n-pose tick (8d's,
   the depthwise one included); (8c) tests/test_quant.py's guard
   on the card (synth160, 30 frames: int8 MOTA and IDF1 within 0.01 of
   float) and the int8 rows card against CPU, dynamic and calibrated;
   card against CPU on an int8 path means equal rows and ids and boxes
   within 1 px (a last-bit difference of a float layer moves a code on a
   rounding boundary, and the tracker's filter carries it on);
   (8e) cli.main --quant int8 on two 1080p mp4 files, sequential and
   batched, one calibration line per loop; (8f) the host GMC:
   botsort.yaml on two panned 1080p streams and strongsort.yaml on two
   panned 320 x 320 ones, the warps card == CPU bit for bit and the
   tracks equal, and the host ms of sparseOptFlow and ecc per 1080p
   frame; then the default tracker at full width (yolov8n 640 bf16, S=8
   panned 1080p streams): botsort.yaml's host sparseOptFlow and BoT-SORT
   with flow_tpu a tick each in turns, ms per tick of each and of
   compute_warps alone;
9. several devices, a dp=2 mesh (two cards where there are two, else
   cuda:0 named twice): (9a) S=8 1080p, yolov8n 640, ByteTrack, then
   StrongSORT + OSNet-x0_25 fused with flow_tpu on the panned scene, 10
   ticks each through track_batch_prepare(mesh=) and through the
   unsharded BatchedPipeline: in float32 (TF32 off) the same rows and
   ids, boxes within 1e-3 px, and each block's K1-K6 launches equal to
   the unsharded path's; in bf16 the ms per tick of both; (9b) which
   torch.distributed collectives the process group (gloo on one card,
   NCCL on two) completes on CUDA tensors, then tools/train --dp 2 (10
   steps) and, where the group gathers CUDA tensors, --tp 2 (3 steps),
   yolov8n 640 batch 16, the first loss within 1e-6 relative of 7d's
   one-process run, every loss printed beside it, ms per step.

The JSON line before the card's name is one object with one entry per
kernel: its launches (K1-K3 and K5 counted on the flow path, K4 on the
StrongSORT path, K6 on the fused one, K7 on yolo11n-pose with the
route, K8 on 8b's int8 path), its largest difference from its
plain version, its time (K1, K2, K4, K5, K6, K7: device time by
CUDA-graph replay; K3 CUDA events) and its plain version's, its
bound (the larger of its bytes, each input read once and each output
written once, over 3.35 TB/s, where K1 and K4 read only the 32-byte
sectors of their input that hold a pixel their taps weigh above zero,
and its operations over the peak for their type: 989 TFLOP/s in bf16,
67 TFLOP/s in float32 outside the tensor cores, 1,979 TOP/s in int8,
the H100 SXM's published rates) with what sets it, and
library_ms, the time of one PyTorch call computing the same function
(null where none does; K7's is cuDNN's conv with bias, then SiLU). K7's
times (its mma form, the route's in bfloat16, and cuDNN's, both device
times from CUDA graph replay) and bound are summed over the convs it
takes in one S=8 yolo11n-pose forward; K8's over the 32 int8 convs of
one yolov8n tick (its library_ms is cuDNN's bf16 conv + SiLU of the
dequantized weights, a different function). The last line is {"ok": true,
"device": {...}}.
Without a CUDA device the script exits nonzero before printing any
result.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
CKPT = os.path.join(ROOT, "assets", "yolov8n_synth160.npz")
TASK_CKPTS = {name: os.path.join(ROOT, "assets", name + ".npz") for name in (
    "yolov8n_seg_synth160", "yolov8n_pose_synth160", "yolo11n_pose_synth160")}
OSNET = os.path.join(ROOT, "assets", "osnet_x0_25_synth.npz")
TARGET_DETS = 120  # candidates per frame the class bias is set for
S_MAIN, TICKS = 8, 10
CROWD_TICKS, WIDE_TICKS = 6, 4  # ticks of the paths added for K3's and K6's
# large forms
HBM_BYTES_PER_MS = 3.35e9  # H100 SXM, 3.35 TB/s
# bf16 and int8: tensor cores, dense; f32: CUDA cores; tf32x3: the 3xTF32
# ceiling, the tensor cores' 495 TF32 TFLOP/s over three products
PEAK_OPS_PER_MS = {"bf16": 989e9, "f32": 67e9, "tf32x3": 495e9 / 3,
                   "int8": 1979e9}


T0 = time.perf_counter()


def log(msg: str) -> None:
    print(msg, flush=True)


def mark(phase: str) -> None:
    """A line with the seconds since the script started, before a phase."""
    log(f"[{time.perf_counter() - T0:.1f} s] {phase}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of one call of ``fn``, from CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(nbytes: int, ops: float, kind: str = "f32") -> tuple[float, str]:
    """The least time the card could take: the larger of ``nbytes`` over
    the memory rate and ``ops`` over the peak of their type."""
    t_bytes = nbytes / HBM_BYTES_PER_MS
    t_ops = ops / PEAK_OPS_PER_MS[kind]
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


SECTOR = 32  # bytes: the least the card's memory moves at once


def sector_bytes(touched, elem: int) -> int:
    """Bytes of the 32-byte sectors of a row-major buffer of ``elem``-byte
    elements that hold an element ``touched`` (bool, the buffer's shape,
    rows a whole number of sectors long) marks."""
    if touched.shape[-1] * elem % SECTOR:
        raise ValueError("rows must be a whole number of sectors long")
    return int(touched.reshape(-1, SECTOR // elem).any(-1).sum()) * SECTOR


def k1_bytes(frames, lp, taps, out) -> int:
    """Bytes K1 must move: the 32-byte sectors of each frame that hold a
    pixel some tap weighs above zero (1080p -> 360x640 weighs every third
    row and column; a row's weighed pixels lie closer than a sector, so
    those rows move whole), the tap tables and the output."""
    import torch

    s, h, w, c = frames.shape

    def weighed(cut):
        return taps.idx[:, cut].long()[taps.w[:, cut] != 0].unique()

    rows, cols = weighed(slice(0, lp.new_h)), weighed(slice(lp.new_h, None))
    touched = torch.zeros((h, w, c), dtype=torch.bool, device=frames.device)
    touched[rows[:, None], cols[None, :]] = True
    return (s * sector_bytes(touched.reshape(h, w * c), 1)
            + nbytes(taps.idx, taps.w, out))


def k4_bytes(pyr, scal, ints, slot_frame, crops) -> int:
    """Bytes K4 must move: the 32-byte sectors of the pyramid stack that
    hold a pixel some slot's taps weigh above zero (each read once,
    however many slots share it), the slot parameters and the crops."""
    import torch

    from strongsort_yolo_tpu_torch.ops.cuda.crop_kernel import _axis_taps

    s, c, sum_h, width = pyr.stack.shape
    oh, ow = crops.shape[-2:]
    dt = pyr.stack.dtype
    y_lo, y_hi, _, wy1 = _axis_taps(scal[:, 0], scal[:, 1], oh, scal[:, 4], dt)
    x_lo, x_hi, _, wx1 = _axis_taps(scal[:, 2], scal[:, 3], ow, scal[:, 5], dt)
    # a lo tap always weighs above zero: it stands in for a hi tap of 0
    rows = torch.cat([y_lo, torch.where(wy1 != 0, y_hi, y_lo)], 1)
    cols = torch.cat([x_lo, torch.where(wx1 != 0, x_hi, x_lo)], 1)
    rows = rows + pyr.row_off.long()[ints[:, 2].long()][:, None]
    touched = torch.zeros((s, sum_h, width), dtype=torch.bool,
                          device=crops.device)
    touched[slot_frame.long()[:, None, None], rows[:, :, None],
            cols[:, None, :]] = True
    # each channel's plane is read where the first one is
    return (c * sector_bytes(touched, pyr.stack.element_size())
            + nbytes(pyr.row_off, scal, ints, slot_frame, crops))


def make_frames(h: int, w: int, n: int = 8, seed: int = 0) -> list[np.ndarray]:
    """Dark noise with six bright moving rectangles per frame."""
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 60, (h, w, 3), dtype=np.uint8)
    pool = []
    for t in range(n):
        f = base.copy()
        for k in range(6):
            x = (100 + 211 * k + 9 * t) % (w - 200)
            y = (80 + 137 * k + 5 * t) % (h - 260)
            f[y : y + 240, x : x + 180] = (40 * k + 40) % 255
        pool.append(f)
    return pool


def render_synthetic(num_frames: int, size=(320, 320), num_objects: int = 3,
                     seed: int = 1) -> list[np.ndarray]:
    """Moving shaded rectangles on uniform noise: the video counterpart
    of the task the synth160 checkpoint was trained on (class =
    brightness bucket)."""
    h, w = size
    rng = np.random.default_rng(seed)
    objs = []
    for _ in range(num_objects):
        ow = float(rng.uniform(0.18, 0.35) * w)
        oh = float(rng.uniform(0.18, 0.35) * h)
        x = float(rng.uniform(0, w - ow - num_frames * 2.5))
        y = float(rng.uniform(0, h - oh - num_frames * 2.0))
        vx, vy = float(rng.uniform(0.8, 2.5)), float(rng.uniform(0.5, 2.0))
        objs.append((x, y, ow, oh, vx, vy, int(rng.integers(0, 3))))
    bg = np.random.default_rng(seed + 999)
    frames = []
    for t in range(num_frames):
        f = (bg.uniform(0.0, 0.3, (h, w, 3)) * 255).astype(np.uint8)
        for x, y, ow, oh, vx, vy, cls in objs:
            x1, y1 = x + vx * t, y + vy * t
            f[int(y1) : int(y1 + oh), int(x1) : int(x1 + ow)] = int(
                (0.5 + 0.16 * cls) * 255
            )
        frames.append(f)
    return frames


def phase_environment():
    import torch

    from strongsort_yolo_tpu_torch.ops.cuda import _build

    log(card_line())
    try:
        import triton

        triton_version = triton.__version__
    except ImportError:
        triton_version = None
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]} triton {triton_version}")
    t0 = time.perf_counter()
    _build.lib()
    log(f"kernel build: {time.perf_counter() - t0:.2f} s "
        f"(nvcc {_build.build_seconds} s; per source, in parallel: "
        + ", ".join(f"{k} {v:.1f} s" for k, v in
                    sorted(_build.compile_seconds.items())) + ")")


def phase_kernels(card: str) -> list[dict]:
    import torch

    from strongsort_yolo_tpu_torch.ops.assignment import solve_assignment_host
    from strongsort_yolo_tpu_torch.ops.cuda import _build
    from strongsort_yolo_tpu_torch.ops.cuda.auction_kernel import (
        auction, auction_plain,
    )
    from strongsort_yolo_tpu_torch.ops.cuda.nms_kernel import (
        nms_keep, nms_keep_plain,
    )
    from strongsort_yolo_tpu_torch.ops.cuda.resize_kernel import letterbox_u8
    from strongsort_yolo_tpu_torch.ops.letterbox import (
        letterbox, letterbox_params, resize_taps,
    )
    from strongsort_yolo_tpu_torch.tools.prof_conv import graph_ms

    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    report = []

    # K1 at the main path's shape, a portrait one (a side bar of 140
    # columns, not a multiple of 8), two two-tap (non-decimating) ones,
    # 481x853 with rows of 2559 bytes, and a small one
    k1_err, k1_times = 0.0, None
    for hw, size in (((1080, 1920), 640), ((720, 1280), 640),
                     ((1920, 1080), 640), ((481, 853), 640),
                     ((240, 320), 160)):
        frames = torch.from_numpy(
            rng.integers(0, 256, (8, *hw, 3), dtype=np.uint8)
        ).to(dev)
        lp = letterbox_params(*hw, size)
        taps = resize_taps(hw, lp, dev)
        for dt in (torch.float32, torch.bfloat16):
            got = letterbox_u8(frames, lp, dtype=dt, taps=taps)
            want = letterbox(frames, lp, dtype=dt, taps=taps)
            err = float((got.float() - want.float()).abs().max())
            if not torch.equal(got, want):
                raise AssertionError(f"K1 {dt} {hw}: differs from the plain "
                                     f"version, max |err| {err}")
            k1_err = max(k1_err, err)
            log(f"K1 letterbox (8,{hw[0]},{hw[1]},3)->{size} {dt}: "
                f"bit-identical (top {lp.top}, left {lp.left})")
        if hw == (1080, 1920):
            k1_times = (
                graph_ms(lambda: letterbox_u8(frames, lp, dtype=torch.bfloat16,
                                              taps=taps)),
                cuda_ms(lambda: letterbox(frames, lp, dtype=torch.bfloat16,
                                          taps=taps)),
                cuda_ms(lambda: letterbox_u8(frames, lp, dtype=torch.bfloat16,
                                             taps=taps)),
            )
    log(f"K1 time (8,1080,1920,3)->bf16 640: kernel {k1_times[0]:.4f} ms by "
        f"graph replay ({k1_times[2]:.4f} by events), plain "
        f"{k1_times[1]:.4f} ms [{card}]")
    check_no_div64(("letterbox_kernel", "banded_crop_kernel"))
    frames = torch.zeros((8, 1080, 1920, 3), dtype=torch.uint8, device=dev)
    lp = letterbox_params(1080, 1920, 640)
    taps = resize_taps((1080, 1920), lp, dev)
    out = letterbox_u8(frames, lp, dtype=torch.bfloat16, taps=taps)
    # about 4 operations per output value: the taps' weighted sum, /255
    k1_bound = bound(k1_bytes(frames, lp, taps, out), 4 * out.numel())
    report.append(dict(
        name="letterbox_u8", route="cuda",
        source="strongsort_yolo_tpu_torch/csrc/letterbox.cu",
        replaces="strongsort_yolo_tpu/ops/pallas/resize_kernel.py:198",
        max_abs_err=k1_err, ms=k1_times[0], plain_ms=k1_times[1],
        bound_ms=k1_bound[0], bound_by=k1_bound[1], library_ms=None,
    ))

    # K2: 8 frames of 512 score-sorted candidates, dense clusters
    S, K = 8, 512
    centers = rng.uniform(50, 600, (S, 8, 2))
    pick = rng.integers(0, 8, (S, K))
    cx = np.take_along_axis(centers[..., 0], pick, 1) + rng.normal(0, 15, (S, K))
    cy = np.take_along_axis(centers[..., 1], pick, 1) + rng.normal(0, 15, (S, K))
    wh = rng.uniform(20, 100, (S, K, 2))
    boxes = np.stack([cx - wh[..., 0] / 2, cy - wh[..., 1] / 2,
                      cx + wh[..., 0] / 2, cy + wh[..., 1] / 2], -1)
    cls_off = rng.integers(0, 3, (S, K, 1)) * 7680.0  # class offsets
    boxes = torch.from_numpy((boxes + cls_off).astype(np.float32)).to(dev)
    conf = torch.from_numpy(
        -np.sort(-rng.uniform(0, 1, (S, K)), 1).astype(np.float32)
    ).to(dev)
    got = nms_keep(boxes, conf, iou_thres=0.4, conf_thres=0.3)
    want = nms_keep_plain(boxes, conf, iou_thres=0.4, conf_thres=0.3)
    if not torch.equal(got, want):
        raise AssertionError("K2 keep mask differs from the plain version")
    k2_times = (
        graph_ms(lambda: nms_keep(boxes, conf, iou_thres=0.4, conf_thres=0.3)),
        cuda_ms(lambda: nms_keep_plain(boxes, conf, iou_thres=0.4,
                                       conf_thres=0.3), iters=5),
        cuda_ms(lambda: nms_keep(boxes, conf, iou_thres=0.4, conf_thres=0.3)),
    )
    log(f"K2 nms_keep (8,512): a cluster of "
        f"{_build.lib().ssyt_nms_keep_cluster()} thread blocks per frame "
        f"(cudaLaunchKernelEx); bit-identical, {int(got.sum())} kept; kernel "
        f"{k2_times[0]:.4f} ms by graph replay ({k2_times[2]:.4f} by events), "
        f"plain {k2_times[1]:.4f} ms [{card}]")
    # about 15 operations per candidate pair: the IoU and its comparison
    k2_bound = bound(nbytes(boxes, conf, got), 15 * S * K * (K - 1) / 2)
    report.append(dict(
        name="nms_keep", route="cuda",
        source="strongsort_yolo_tpu_torch/csrc/nms_keep.cu",
        replaces="strongsort_yolo_tpu/ops/pallas/nms_kernel.py:172",
        max_abs_err=0.0, ms=k2_times[0], plain_ms=k2_times[1],
        bound_ms=k2_bound[0], bound_by=k2_bound[1], library_ms=None,
    ))

    # K3: 24 problems of 256 slots x 128 detections
    P, R, C = 24, 256, 128
    cost = rng.uniform(0, 1, (P, R, C)).astype(np.float32)
    rv = rng.uniform(size=(P, R)) < 0.25
    cv = rng.uniform(size=(P, C)) < 0.5
    rv[0] = False  # empty problem
    cost[1] = np.round(cost[1] * 4) / 4  # tied costs
    for p in range(2, 6):  # tracker-like: a sparse set of good matches
        n = 40
        cost[p] = 1.0
        cost[p, np.arange(n), np.arange(n)] = rng.uniform(0.05, 0.4, n)
        rv[p, :] = np.arange(R) < n + 10
        cv[p, :] = np.arange(C) < n + 5
    th = torch.full((P,), 0.8, device=dev)
    args = (torch.from_numpy(cost).to(dev), th, torch.from_numpy(rv).to(dev),
            torch.from_numpy(cv).to(dev))
    got = auction(*args)
    want = auction_plain(*args)
    if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
        raise AssertionError("K3 assignment differs from the plain version")
    r2c = got[0].cpu().numpy()
    for p in range(2, 6):  # lapjv objective against the exact oracle
        valid = rv[p][:, None] & cv[p][None, :]
        h_r2c, _ = solve_assignment_host(np.where(valid, cost[p], 1e6), 0.8)
        mine, best = (
            sum(cost[p, i, j] for i, j in enumerate(m) if j >= 0)
            + 0.4 * (rv[p].sum() + cv[p].sum() - 2 * (m >= 0).sum())
            for m in (r2c[p], h_r2c)
        )
        if abs(mine - best) > 1e-2:
            raise AssertionError(f"K3 problem {p}: {mine} vs scipy {best}")
    k3_times = (
        cuda_ms(lambda: auction(*args)),
        cuda_ms(lambda: auction_plain(*args), iters=3, warmup=1),
    )
    log(f"K3 auction (24,256,128): identical r2c/c2r, {int((r2c >= 0).sum())} "
        f"matches, scipy objective agrees on 4; kernel {k3_times[0]:.4f} ms, "
        f"plain {k3_times[1]:.4f} ms [{card}]")
    # the bidding rounds depend on the costs; the least any solver needs
    # is one look at each cost
    k3_bound = bound(nbytes(*args, *got), P * R * C)
    report.append(dict(
        name="auction", route="cuda",
        source="strongsort_yolo_tpu_torch/csrc/auction.cu",
        replaces="strongsort_yolo_tpu/ops/pallas/auction_kernel.py:156",
        max_abs_err=0.0, ms=k3_times[0], plain_ms=k3_times[1],
        bound_ms=k3_bound[0], bound_by=k3_bound[1], library_ms=None,
    ))
    check_k3_large(card, np.random.default_rng(3))
    report.append(check_k4(rng))
    report.append(check_k5(card))
    report.append(check_k6(card))
    report.append(check_k7(card))
    return report


K3_LARGE = ((8, 256, 256), (8, 512, 250), (4, 1100, 300))


def check_k3_large(card: str, rng) -> None:
    """K3 at association sizes whose benefit block passes a block's shared
    memory (tracker_max_dets 256 on 256 slots, 250 dets on 512 slots, and
    1100 x 300): bit-identical to auction_plain, timed, with the form
    each took (the benefit block in shared memory or in the global
    scratch). Half the problems are tracker-like, half uniform costs with
    masked rows and columns."""
    import torch

    from strongsort_yolo_tpu_torch.ops.cuda.auction_kernel import (
        auction, auction_plain, shared_form,
    )

    dev = torch.device("cuda")
    for P, R, C in K3_LARGE:
        cost = rng.uniform(0, 1, (P, R, C)).astype(np.float32)
        rv = rng.uniform(size=(P, R)) < 0.5
        cv = rng.uniform(size=(P, C)) < 0.8
        for p in range(1, P, 2):  # tracker-like: a diagonal of good matches
            n = min(R, C) // 2
            cost[p] = 1.0
            cost[p, np.arange(n), np.arange(n)] = rng.uniform(0.05, 0.4, n)
        args = (torch.from_numpy(cost).to(dev), torch.full((P,), 0.8, device=dev),
                torch.from_numpy(rv).to(dev), torch.from_numpy(cv).to(dev))
        got, want = auction(*args), auction_plain(*args)
        if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
            raise AssertionError(f"K3 {(P, R, C)}: differs from the plain version")
        ms = cuda_ms(lambda: auction(*args), iters=5, warmup=1)
        plain = cuda_ms(lambda: auction_plain(*args), iters=1, warmup=0)
        form = ("shared memory" if shared_form(R, C)
                else f"global scratch ({P},{R},{C}) f32")
        log(f"K3 auction {(P, R, C)}: identical r2c/c2r, "
            f"{int((got[0] >= 0).sum())} matches; benefit block in {form}; "
            f"kernel {ms:.4f} ms, plain {plain:.4f} ms [{card}]")


def smooth_image(h: int, w: int, seed: int, moved=None) -> np.ndarray:
    """(h, w) float32 periodic sum of twelve sinusoids around 128 (whole
    periods over the frame, so np.roll is an exact translation). With
    ``moved`` = (th, scale, dx, dy), the image after a rotation by th and
    a scale about the centre and a pan by (dx, dy): the sinusoids
    evaluated at the moved coordinates, nothing resampled."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w].astype(np.float32)
    if moved is not None:  # cur(q) = prev(a^-1 q)
        th, sc, dx, dy = moved
        u, v = x - (w - 1) / 2 - dx, y - (h - 1) / 2 - dy
        x = ((np.cos(th) * u + np.sin(th) * v) / sc + (w - 1) / 2)
        y = ((-np.sin(th) * u + np.cos(th) * v) / sc + (h - 1) / 2)
    img = np.full((h, w), 128.0, np.float32)
    for _ in range(12):
        fy, fx = rng.integers(1, 6) / h, rng.integers(1, 6) / w
        ph = rng.uniform(0, 2 * np.pi)
        img += (rng.uniform(10, 40) * np.sin(2 * np.pi * (fx * x + fy * y)
                                             + ph)).astype(np.float32)
    return img


def check_k5(card: str) -> dict:
    """K5 against lk_pyramid_plain on the card, on the flow path's shapes:
    pyramids (180x320, 90x160, 45x80, blurred) of S=8 stream pairs and
    of a T=32 chunk, each pair panned by its own (dx, dy) and run to
    convergence (8, 5, 2 steps), and S=8 pairs rotated and scaled as
    well, after one step per level (far from converged, so each step's
    arithmetic shows); pair 3 of the panned cases is noisy so that the
    trimming threshold bites (far from convergence a noisy pair can put
    a pixel within one rounding of the threshold: the plain version
    alone moves by 2.6e-4 px under a one-ulp change of its input, so the
    unconverged pairs are clean). Tolerance: 1e-4 base px on the translation and 1e-6 on the
    linear part, the sums running in another order (a wrong damping
    constant moves the unconverged case by more than 3e-3 px, a step
    more or less by pixels); two launches must be bit-identical, and
    each pair of the T=32 launch bit-identical to that pair launched
    alone (N=1: a pair's cluster and bands do not depend on N). Times:
    CUDA-graph replay (device time; the wrapper's checks and allocation
    are host work), CUDA events around host launches, and at S=8 the C
    entry point alone, its arguments prepared once."""
    import ctypes

    import torch

    from strongsort_yolo_tpu_torch.ops.cuda import _build
    from strongsort_yolo_tpu_torch.ops.cuda.lk_kernel import (
        lk_pyramid, lk_pyramid_plain,
    )
    from strongsort_yolo_tpu_torch.tools.prof_conv import graph_ms
    from strongsort_yolo_tpu_torch.track.gmc_flow import (
        _ITERS_BY_LEVEL, BASE_H, BASE_W, _blur, _pool2,
    )

    dev = torch.device("cuda")
    rng = np.random.default_rng(5)
    max_err, times = 0.0, {}
    for n, affine in ((S_MAIN, False), (32, False), (S_MAIN, True)):
        iters = (1, 1, 1) if affine else _ITERS_BY_LEVEL
        prev, cur = [], []
        for k in range(n):
            img = smooth_image(BASE_H, BASE_W, seed=100 + k)
            dx, dy = (int(v) for v in rng.integers(-20, 21, 2))
            if affine:
                c = smooth_image(BASE_H, BASE_W, seed=100 + k, moved=(
                    rng.uniform(-0.03, 0.03), rng.uniform(0.97, 1.03), dx, dy))
            else:
                c = np.roll(img, (dy, dx), axis=(0, 1))
            if k == 3 and not affine:
                c = c + rng.normal(0, 20, c.shape).astype(np.float32)
            prev.append(img)
            cur.append(c)
        pyr = []
        for planes in (prev, cur):
            lv = [torch.from_numpy(np.stack(planes)).to(dev)]
            for _ in range(2):
                lv.append(_pool2(lv[-1]))
            pyr.append([_blur(x) for x in lv])
        params = torch.tensor([1.0, 0.0, 0.0, 0.0, 1.0, 0.0],
                              device=dev).repeat(n, 1)

        def run():
            return lk_pyramid(*pyr, params, iters)

        def run_plain():
            return lk_pyramid_plain(*pyr, params, iters)

        got, again, want = run(), run(), run_plain()
        torch.cuda.synchronize()
        case = (f"N={n} {'rotated/scaled' if affine else 'panned'} pairs, "
                f"iters {iters}")
        if not torch.equal(got, again):
            raise AssertionError(f"K5 {case}: two launches differ")
        d = (got - want).abs()
        trans_px = float(d[:, [2, 5]].max()) * BASE_W / 2
        lin = float(d[:, [0, 1, 3, 4]].max())
        if not (trans_px <= 1e-4 and lin <= 1e-6):
            raise AssertionError(f"K5 {case}: translation off by {trans_px} "
                                 f"base px, linear part by {lin}")
        max_err = max(max_err, float(d.max()))
        if n == 32:
            for k in range(n):
                one = lk_pyramid([x[k:k + 1] for x in pyr[0]],
                                 [x[k:k + 1] for x in pyr[1]],
                                 params[k:k + 1], iters)
                if not torch.equal(one[0], got[k]):
                    raise AssertionError(f"K5 {case}: pair {k} alone differs "
                                         "from its row of the N=32 launch")
            log(f"K5 {case}: every pair bit-identical to its N=1 launch")
        timing = ""
        if not affine:
            times[n] = (graph_ms(run), cuda_ms(run_plain, iters=3, warmup=1),
                        cuda_ms(run))
            if n == S_MAIN:
                alone = k5_alone_ms(pyr, params, iters)
                # about 90 operations per pixel and Gauss-Newton step (the
                # bilinear taps, gradients, residual, 27 products summed)
                steps = sum(lv.shape[1] * lv.shape[2] * it
                            for lv, it in zip(pyr[0], iters))
                k5_bound = bound(nbytes(*pyr[0], *pyr[1], params, got),
                                 90 * n * steps)
            timing = (f"; kernel {times[n][0]:.4f} ms by graph replay "
                      f"({times[n][2]:.4f} by events"
                      + (f", {alone:.4f} the kernel alone" if n == S_MAIN
                         else "")
                      + f"), plain {times[n][1]:.4f} ms [{card}]")
        log(f"K5 lk_pyramid {case}, 180x320/90x160/45x80: bit-identical "
            f"across launches; vs plain max |err| translation {trans_px:.3g} "
            f"base px, linear {lin:.3g}{timing}")
    dims = [d for x, it in zip(pyr[0], _ITERS_BY_LEVEL)
            for d in (x.shape[1], x.shape[2], it)]
    resident = _build.lib().ssyt_lk_pyramid_max_clusters(
        len(dims) // 3, (ctypes.c_int * len(dims))(*dims))
    log(f"K5 launches a cluster of {_build.lib().ssyt_lk_pyramid_cluster()} "
        f"thread blocks per pair (cudaLaunchKernelEx); the card holds "
        f"{resident} pairs' clusters at once; N=32 takes "
        f"{times[32][0] / times[S_MAIN][0]:.2f}x the N={S_MAIN} time by graph "
        f"replay [{card}]")
    check_k5_level(card, rng)
    return dict(
        name="lk_pyramid", route="cuda",
        source="strongsort_yolo_tpu_torch/csrc/lk_pyramid.cu",
        replaces="strongsort_yolo_tpu/ops/pallas/lk_kernel.py:225 and "
                 "strongsort_yolo_tpu/ops/pallas/lk_kernel.py:268",
        max_abs_err=max_err, ms=times[S_MAIN][0], plain_ms=times[S_MAIN][1],
        bound_ms=k5_bound[0], bound_by=k5_bound[1], library_ms=None,
    )


def k5_alone_ms(pyr, params, iters) -> float:
    """K5's device time by graph replay, its C entry point called on
    arguments prepared once, outside the timed calls (the wrapper's
    checks and allocation left out)."""
    import ctypes

    import torch

    from strongsort_yolo_tpu_torch.ops.cuda import _build
    from strongsort_yolo_tpu_torch.tools.prof_conv import graph_ms

    n, levels = params.shape[0], len(pyr[0])
    out = torch.empty_like(params)
    dims, strides = [], []
    for a, b, it in zip(*pyr, iters):
        dims += [a.shape[1], a.shape[2], int(it)]
        strides += [a.stride(0), a.stride(1), b.stride(0), b.stride(1)]
    args = (
        (ctypes.c_void_p * levels)(*(x.data_ptr() for x in pyr[0])),
        (ctypes.c_void_p * levels)(*(x.data_ptr() for x in pyr[1])),
        (ctypes.c_longlong * len(strides))(*strides),
        params.data_ptr(), out.data_ptr(), n, levels,
        (ctypes.c_int * len(dims))(*dims),
    )
    return graph_ms(lambda: _build.check(_build.lib().ssyt_lk_pyramid(
        *args, torch.cuda.current_stream().cuda_stream), "lk_pyramid"))


def check_k5_level(card: str, rng) -> None:
    """K5 with one level, the form of the TPU's lk_level_pallas, against
    lk_level_plain: S=8 clean 180x320 blurred pairs panned by up to 4 px,
    5 Gauss-Newton steps; the tolerance of check_k5, two launches
    bit-identical; time, plain time and bound logged (PERF.md row #9)."""
    import torch

    from strongsort_yolo_tpu_torch.ops.cuda.lk_kernel import (
        lk_level_plain, lk_pyramid,
    )
    from strongsort_yolo_tpu_torch.tools.prof_conv import graph_ms
    from strongsort_yolo_tpu_torch.track.gmc_flow import BASE_H, BASE_W, _blur

    dev = torch.device("cuda")
    prev, cur = [], []
    for k in range(S_MAIN):
        img = smooth_image(BASE_H, BASE_W, seed=200 + k)
        dx, dy = (int(v) for v in rng.integers(-4, 5, 2))
        prev.append(img)
        cur.append(np.roll(img, (dy, dx), axis=(0, 1)))
    p0, c0 = (_blur(torch.from_numpy(np.stack(v)).to(dev)) for v in (prev, cur))
    params = torch.tensor([1.0, 0.0, 0.0, 0.0, 1.0, 0.0],
                          device=dev).repeat(S_MAIN, 1)
    iters = 5

    def run():
        return lk_pyramid((p0,), (c0,), params, (iters,))

    def run_plain():
        return lk_level_plain(p0, c0, params, iters)

    got, again, want = run(), run(), run_plain()
    torch.cuda.synchronize()
    if not torch.equal(got, again):
        raise AssertionError("K5 one level: two launches differ")
    d = (got - want).abs()
    trans_px = float(d[:, [2, 5]].max()) * BASE_W / 2
    lin = float(d[:, [0, 1, 3, 4]].max())
    if not (trans_px <= 1e-4 and lin <= 1e-6):
        raise AssertionError(f"K5 one level: translation off by {trans_px} "
                             f"base px, linear part by {lin}")
    ms, ev = graph_ms(run), cuda_ms(run)
    plain = cuda_ms(run_plain, iters=3, warmup=1)
    b = bound(nbytes(p0, c0, params, got), 90 * S_MAIN * BASE_H * BASE_W * iters)
    log(f"K5 lk_level (one level, S={S_MAIN} 180x320 pairs, {iters} steps): "
        f"bit-identical across launches; vs plain max |err| translation "
        f"{trans_px:.3g} base px, linear {lin:.3g}; kernel {ms:.4f} ms by "
        f"graph replay ({ev:.4f} by events), plain {plain:.4f} ms, bound "
        f"{b[0]:.6f} ms ({b[1]}) [{card}]")


K6_WIDTHS = ("osnet_x0_25", "osnet_x0_5", "osnet_x0_75", "osnet_x1_0")
K6_G_WIDE = 96  # crops per stage call for the widths off the main path
# (variant, stage index) -> the bfloat16 columns form's ms at K6_G_WIDE
# (CUDA-graph replay, NVIDIA H100 80GB HBM3, 700.00 W), measured by
# check_k6 on the kernels before the cluster form took these stages; and
# the fused osnet_x1_0 path's median ms/tick then
K6_COLUMNS_MS = {("osnet_x0_5", 0): 1.7943, ("osnet_x0_75", 0): 3.8021,
                 ("osnet_x1_0", 0): 7.2474, ("osnet_x1_0", 1): 9.4510}
WIDE_TICK_COLUMNS_MS = 74.68
# (variant, stage index) -> the float32 first forms' ms (the register form
# for x0_25 at G=480, the columns form elsewhere at K6_G_WIDE), measured
# by CUDA-graph replay on the kernels before the 3xTF32 forms took every
# float32 stage (NVIDIA H100 80GB HBM3, 700.00 W); and the f32 b-x1_0
# path's median ms/tick then
K6_F32_FIRST_MS = {
    ("osnet_x0_25", 0): 1.5882, ("osnet_x0_25", 1): 1.1153,
    ("osnet_x0_25", 2): 1.9362, ("osnet_x0_5", 0): 2.0284,
    ("osnet_x0_5", 1): 2.6588, ("osnet_x0_5", 2): 4.6588,
    ("osnet_x0_75", 0): 4.4694, ("osnet_x0_75", 1): 6.6779,
    ("osnet_x0_75", 2): 9.9847, ("osnet_x1_0", 0): 8.1042,
    ("osnet_x1_0", 1): 14.5220, ("osnet_x1_0", 2): 16.1036}
WIDE_TICK_F32_FIRST_MS = 154.67


# K6's bfloat16 bar for its tensor-core forms, against os_stage_plain: the
# mean |err| within 2e-4 of the largest output, the repo's bar for bf16
# stages summed in another order (tests/test_torch_osnet_kernel.py). Any
# order of the sums, an exact one included, flips some bf16 roundings of
# a stage, and a flipped gate value moves a whole channel: the plain
# version with float64 sums differs from it by up to 0.115 x max(1,
# |ref|) (15 bf16 units at 1.0), in up to 8% of the elements, at a mean
# of up to 5e-5 of the largest output; tap weights rounded to bf16, a
# fault, give 5e-4 to 7e-4 (CPU, x0_25 and x0_5, G = 37 and 480).
K6_BF16_MEAN = 2e-4


def k6_exact(x, w, spec):
    """os_stage_plain with every 1x1 product summed exactly (float64) and
    rounded once to float32: the reference for how far any order of the
    sums moves a bf16 stage."""
    from strongsort_yolo_tpu_torch.ops.cuda import osnet_kernel

    pointwise = osnet_kernel._pointwise
    osnet_kernel._pointwise = lambda wt, a, b: (
        (wt.double() @ a.double()).float() + b[:, None])
    try:
        return osnet_kernel.os_stage_plain(x, w, spec)
    finally:
        osnet_kernel._pointwise = pointwise


def check_k6(card: str) -> dict:
    """K6 against os_stage_plain on the card: each of the three stages of
    the four released OSNet widths (random weights from seed 1, as the
    pipeline's) on seeded crops, G=480 for the main path's x0_25 and
    K6_G_WIDE for the others, each in the form it takes (stage_form),
    float32 within 1e-4 (the sums run in another order) and bfloat16
    in the tensor-core forms, one block or a cluster of blocks a crop,
    within the K6_BF16_MEAN bar (the tensor cores add a chunk's products
    in their own order, and a flipped rounding propagates), with the
    largest deviation and the share of differing elements; two launches
    bit-identical; x0_25 and the cluster forms' stages also at G = 0, 1
    and 7, each equal to those crops of the full launch; HMMA in every
    instance of the four tensor-core kernels (TF32 ones in the float32
    kernels) and no spill in the cluster and float32 ones; times (device
    time by CUDA-graph replay, and CUDA events around host launches, the
    earlier method) beside the bound, in both dtypes, with the plain
    version's for x0_25, the bf16 cluster form's stages beside the
    columns form's time before (K6_COLUMNS_MS), every float32 stage
    beside its first form's (K6_F32_FIRST_MS) and the bf16 time of the
    same stage. The entry is x0_25's three stages at G=480, the fused
    path's work, in bfloat16: the tensor-core form."""
    import torch

    from strongsort_yolo_tpu_torch.models.osnet import (
        OsnetConfig, init_osnet, osnet_from_state_dict,
    )
    from strongsort_yolo_tpu_torch.ops.cuda.osnet_kernel import (
        os_stage, os_stage_plain, stage_form, stage_specs, stage_weights,
    )
    from strongsort_yolo_tpu_torch.tools.prof_conv import graph_ms
    from strongsort_yolo_tpu_torch.tools.prof_k6 import stage_macs

    check_tensor_core_sass("os_stage_mma_kernel", "HMMA", "K6 tensor cores")
    check_tensor_core_sass("os_stage_cluster_kernel", "HMMA",
                           "K6 tensor cores, cluster form")
    check_no_spill("os_stage_cluster_kernel", "K6 tensor cores, cluster form")
    for kernel in ("os_stage_tf32_kernel", "os_stage_tf32_cluster_kernel"):
        check_tensor_core_sass(kernel, "F32.TF32", "K6 float32, 3xTF32")
        check_no_spill(kernel, "K6 float32, 3xTF32")
    dev = torch.device("cuda")
    rng = np.random.default_rng(6)
    max_err, total = 0.0, {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
                           "ops_ms": 0.0, "bytes_ms": 0.0}
    per_stage = []
    for variant in K6_WIDTHS:
        main = variant == "osnet_x0_25"
        g = 480 if main else K6_G_WIDE
        cfg = OsnetConfig(variant=variant)
        model = osnet_from_state_dict(
            init_osnet(cfg, torch.Generator().manual_seed(1)), cfg)
        width_ms = width_events = 0.0
        f32_ms = f32_first = 0.0
        for i, spec in enumerate(stage_specs(cfg.channels)):
            stage_ms = {}
            x32 = torch.from_numpy(rng.normal(
                0, 1, (g, spec.c_in, spec.h, spec.w)).astype(np.float32)).to(dev)
            for dt in (torch.float32, torch.bfloat16):
                w = stage_weights(model, i, dt).to(dev)
                x = x32.to(dt)
                form = stage_form(spec, dt)
                name = (f"K6 os_stage {variant} stage {i + 2} {tuple(x.shape)} "
                        f"{dt} ({form})")
                got, again = os_stage(x, w, spec), os_stage(x, w, spec)
                want = os_stage_plain(x, w, spec)
                torch.cuda.synchronize()
                if not torch.equal(got, again):
                    raise AssertionError(f"{name}: two launches differ")
                # a crop's output does not depend on the batch around it
                for n in ((0, 1, 7) if main or "cluster" in form else ()):
                    if not torch.equal(os_stage(x[:n], w, spec), got[:n]):
                        raise AssertionError(f"{name}: G={n} differs from "
                                             f"those crops at G={g}")
                err, scaled, share, mean = k6_error(name, got, want, form)
                max_err = max(max_err, err)
                kind = "bf16" if dt == torch.bfloat16 else "f32"
                name += (f": max |err| {err:.3g}, scaled {scaled:.3g}, "
                         f"mean {mean:.3g} of the largest output, {share:.3%} "
                         f"of elements differ")
                if kind == "bf16":
                    e = k6_stats(k6_exact(x, w, spec), want)
                    name += (f" (exact sums: scaled {e[1]:.3g}, mean {e[3]:.3g}, "
                             f"{e[2]:.3%} differ)")
                flops = 2 * stage_macs(spec) * g
                b = bound(nbytes(x, got, w.mats, w.vecs), flops, kind)
                ms = graph_ms(lambda: os_stage(x, w, spec), iters=20 if main else 3,
                              warmup=1)
                ms_events = cuda_ms(lambda: os_stage(x, w, spec),
                                    iters=20 if main else 3, warmup=1)
                plain = (cuda_ms(lambda: os_stage_plain(x, w, spec), iters=5)
                         if main else None)
                stage_ms[kind] = ms
                if kind == "bf16":
                    before = K6_COLUMNS_MS.get((variant, i))
                    then = "the columns form"
                else:
                    before = K6_F32_FIRST_MS[variant, i]
                    then = "the first form (CUDA cores)"
                if kind == "f32":
                    f32_ms += ms
                    f32_first += before
                ceiling = (f", {flops / (PEAK_OPS_PER_MS['tf32x3'] * ms):.1%} of "
                           f"the 3xTF32 ceiling" if kind == "f32" else "")
                log(f"{name}; kernel {ms:.4f} ms (CUDA-graph replay; "
                    f"{ms_events:.4f} by events around host launches), "
                    + (f"plain {plain:.4f} ms, " if main else "")
                    + f"bound {b[0]:.4f} ms ({b[1]}, {flops / 1e9:.2f} GFLOP), "
                    f"{b[0] / ms:.1%} of it{ceiling}, {flops / ms / 1e9:.2f} TFLOP/s"
                    + (f"; {then} took {before:.4f} ms before, "
                       f"{before / ms:.2f}x this" if before else "")
                    + (f"; f32 / bf16 of this stage {stage_ms['f32'] / ms:.2f}x"
                       if kind == "bf16" else "")
                    + f" [{card}]")
                if kind == "bf16":
                    width_ms += ms
                    width_events += ms_events
                if main and kind == "bf16":
                    per_stage.append(ms)
                    total["ms"] += ms
                    total["plain_ms"] += plain
                    total["bound_ms"] += b[0]
                    total["ops_ms"] += flops / PEAK_OPS_PER_MS[kind]
                    total["bytes_ms"] += nbytes(x, got, w.mats,
                                                w.vecs) / HBM_BYTES_PER_MS
        log(f"K6 {variant} three stages at G={g} bf16: kernel {width_ms:.4f} ms "
            f"(CUDA-graph replay; {width_events:.4f} by events); f32 "
            f"{f32_ms:.4f} ms (the first forms: {f32_first:.4f}, "
            f"{f32_first / f32_ms:.2f}x) [{card}]")
    log(f"K6 osnet_x0_25 three stages at G=480 bf16: kernel {total['ms']:.4f} "
        f"ms (per stage {[round(v, 4) for v in per_stage]}), plain "
        f"{total['plain_ms']:.4f} ms, bound {total['bound_ms']:.4f} ms [{card}]")
    check_reid_rank1(card)
    return dict(
        name="os_stage", route="cuda",
        source="strongsort_yolo_tpu_torch/csrc/os_stage_mma.cu",
        replaces="strongsort_yolo_tpu/ops/pallas/osnet_kernel.py:292",
        max_abs_err=max_err, ms=total["ms"], plain_ms=total["plain_ms"],
        bound_ms=total["bound_ms"],
        bound_by=("operations" if total["ops_ms"] >= total["bytes_ms"]
                  else "bytes"),
        library_ms=None,
    )


def k6_stats(got, want) -> tuple[float, float, float, float]:
    """(max |err|, max |err| / max(1, |ref|), share of elements that
    differ, mean |err| over the largest output) of a K6 output against
    its plain version."""
    diff = (got.float() - want.float()).abs()
    return (float(diff.max()),
            float((diff / want.float().abs().clamp(min=1.0)).max()),
            float((diff > 0).float().mean()),
            float(diff.mean() / want.float().abs().max().clamp(min=1e-30)))


def k6_error(name: str, got, want, form: str):
    """k6_stats of a K6 output in ``form``; raises past the bar: 1e-4 in
    float32; in bfloat16 (only the tensor-core forms, one block or a
    cluster of blocks a crop) the K6_BF16_MEAN bar."""
    import torch

    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(f"{name}: {got.shape} {got.dtype}, not "
                             f"{want.shape} {want.dtype}")
    err, scaled, share, mean = stats = k6_stats(got, want)
    if got.dtype == torch.float32 and not err <= 1e-4:
        raise AssertionError(f"{name}: max |err| {err} > 1e-4")
    if got.dtype == torch.bfloat16 and not form.startswith("tensor cores"):
        raise AssertionError(f"{name}: bfloat16 in the {form} form")
    if got.dtype == torch.bfloat16 and not mean <= K6_BF16_MEAN:
        raise AssertionError(f"{name}: mean |err| {mean:.3g} of the largest "
                             f"output, {share:.3%} differ, scaled max "
                             f"{scaled:.3g}")
    return stats


def check_reid_rank1(card: str) -> None:
    """The trained OSNet (assets/osnet_x0_25_synth.npz) on the card, fused
    in bfloat16 (K6's tensor-core form), unfused in bfloat16 and in
    float32: rank-1 >= 0.9 on the 16 unseen identities of its
    evaluation set (utils/reid_synth, the bar of
    tests/test_osnet_trained.py)."""
    import torch

    from strongsort_yolo_tpu_torch.models.osnet import osnet_from_state_dict
    from strongsort_yolo_tpu_torch.models.porting import (
        load_osnet_npz, osnet_params_from_jax,
    )
    from strongsort_yolo_tpu_torch.ops.cuda.osnet_kernel import os_stage
    from strongsort_yolo_tpu_torch.utils.reid_synth import make_dataset, rank1

    x, y, _ = make_dataset(np.random.default_rng(999), 16, 8)
    tree, cfg = load_osnet_npz(OSNET)
    scores = {}
    for route, dt in (("fused bf16", torch.bfloat16),
                      ("unfused bf16", torch.bfloat16),
                      ("unfused f32", torch.float32)):
        model = osnet_from_state_dict(osnet_params_from_jax(tree, cfg), cfg)
        if route.startswith("fused"):
            model.use_fused_stages(dt)
        model = model.to("cuda", dt).eval()
        before = os_stage.launches
        with torch.no_grad():
            emb = model(torch.from_numpy(x).permute(0, 3, 1, 2).contiguous()
                        .to("cuda", dt))
        if (os_stage.launches > before) != route.startswith("fused"):
            raise AssertionError(f"rank-1 {route}: K6 launches "
                                 f"{os_stage.launches - before}")
        scores[route] = rank1(emb.float().cpu().numpy(), y)
    log(f"trained OSNet-x0_25 rank-1 on 16 unseen identities x 8 views: "
        + ", ".join(f"{k} {v:.4f}" for k, v in scores.items()) + f" [{card}]")
    if min(scores.values()) < 0.9:
        raise AssertionError(f"trained OSNet rank-1 below 0.9: {scores}")


def k7_picks(name: str, imgsz: int = 640):
    """The convs that the K7 rule picks in the fused model ``name``."""
    from strongsort_yolo_tpu_torch.models.yolo import (
        YoloModel, build_model, kernel_picks,
    )

    return kernel_picks(YoloModel(build_model(name), fused=True),
                        (imgsz, imgsz))


K7_REQUIRED = {(80, 80, 32, 32, 3), (40, 40, 64, 64, 3), (40, 40, 192, 128, 1),
               (80, 80, 64, 51, 3)}


def check_tensor_core_sass(kernel: str, instruction: str, label: str) -> None:
    """The built library's tensor-core kernels run on the tensor cores:
    every instance of ``kernel`` in `cuobjdump -sass` of the .so under
    build/torch_kernels/ holds ``instruction`` (HGMMA for K7's wgmma,
    HMMA for K6's mma.sync, F32.TF32 for its float32 kernels' TF32
    HMMA)."""
    from strongsort_yolo_tpu_torch.ops.cuda import _build
    from strongsort_yolo_tpu_torch.tools.sass import functions

    path = _build.lib_path()
    counts = {fn: sum(instruction in ins for _, ins in lines)
              for fn, lines in functions(path, kernel).items()}
    if not counts or min(counts.values()) == 0:
        raise AssertionError(f"{label}: {instruction} instructions per {kernel} "
                             f"instance {counts}")
    log(f"{label}: {len(counts)} {kernel} instances in "
        f"{os.path.basename(path)}, {instruction} instructions in each "
        f"({min(counts.values())}-{max(counts.values())}; cuobjdump -sass)")


def check_no_spill(kernel: str, label: str) -> None:
    """No instance of ``kernel`` in the built library loads or stores
    local memory (LDL/STL in `cuobjdump -sass`: no register spilled)."""
    from strongsort_yolo_tpu_torch.ops.cuda import _build
    from strongsort_yolo_tpu_torch.tools.sass import local_accesses

    counts = local_accesses(_build.lib_path(), kernel)
    log(f"{label}: {len(counts)} {kernel} instances, local loads and "
        f"stores per instance {sorted(counts.values())} (cuobjdump -sass)")
    if not counts or max(counts.values()):
        raise AssertionError(f"{label}: {kernel} spills registers {counts}")


def check_no_div64(kernels) -> None:
    """No instance of ``kernels`` calls the 64-bit integer division routine
    or holds its conversion (tools/sass.py on cuobjdump -sass)."""
    from strongsort_yolo_tpu_torch.ops.cuda import _build
    from strongsort_yolo_tpu_torch.tools.sass import DIV64_MARK, report

    for kernel in kernels:
        counts, marks = report(_build.lib_path(), kernel)
        log(f"SASS {kernel}: 64-bit division calls per instance "
            f"{[c[0] for c in counts]}, calls of any routine "
            f"{[c[1] for c in counts]}, {DIV64_MARK} instructions {marks} "
            f"(cuobjdump -sass)")
        if marks or any(c[0] for c in counts):
            raise AssertionError(f"{kernel} divides 64-bit integers")


DT_NAME = {"torch.bfloat16": "bf16", "torch.float32": "f32"}


def k7_times(x, wt, b, k: int, act: bool) -> dict:
    """Device times (ms, CUDA-graph replay) of K7's forms on NCHW ``x`` in
    its dtype, of the plain version and of cuDNN's F.silu(F.conv2d(x, w,
    b)) in the same dtype (two launches; float32 with TF32 off), and the
    bound: x, the weights in x's dtype, the float32 bias and the output
    moved once, or the products over the peak of x's type (bf16 tensor
    cores, f32 CUDA cores). The tensor-core forms (mma, and im2col in
    bfloat16) run on weights packed once, as the route caches them."""
    import torch
    import torch.nn.functional as F

    from strongsort_yolo_tpu_torch.ops.cuda.conv_kernel import (
        conv_act_kernel, conv_act_plain, pack_im2col, pack_mma,
    )
    from strongsort_yolo_tpu_torch.tools.prof_conv import graph_ms

    torch.backends.cudnn.allow_tf32 = False
    s, c_in, h, w = x.shape
    c_out = wt.shape[1]
    half = x.dtype == torch.bfloat16
    forms = ("mma", "taps", "im2col") if half else ("taps", "im2col")
    packed = {"mma": pack_mma(wt, k), "im2col": pack_im2col(wt)} if half else {}
    row = {form: graph_ms(lambda f=form: conv_act_kernel(
        x, wt, b, k=k, act=act, layout="nchw", form=f,
        packed=packed.get(f))) for form in forms}
    row["plain"] = graph_ms(lambda: conv_act_plain(
        x, wt, b, k=k, act=act, layout="nchw"), iters=5)
    w4 = (wt.reshape(k, k, c_in, c_out).permute(3, 2, 0, 1).to(x.dtype)
          .contiguous())
    bx = b.to(x.dtype)
    row["library"] = graph_ms(
        (lambda: F.silu(F.conv2d(x, w4, bx, 1, k // 2))) if act
        else (lambda: F.conv2d(x, w4, bx, 1, k // 2)))
    flops = 2 * k * k * c_in * c_out * s * h * w
    moved = nbytes(x, b) + (x.numel() // c_in * c_out + wt.numel()) * x.element_size()
    row["bound"] = bound(moved, flops, "bf16" if half else "f32")
    return row


def check_k7(card: str) -> dict:
    """K7 against conv_act_plain on the card: every distinct conv that the
    K7 rule picks in yolo11n-pose and yolov8n at 640 (S=8, NCHW, seeded
    inputs and weights), in every form of each dtype (taps and im2col in
    both; mma, the bfloat16 default, in bfloat16), two launches
    bit-identical; float32 within 2e-5 x max(1, |ref|) and bfloat16
    within one bf16 unit at 1.0 of the output scaled by max(1, |ref|)
    (the plain version is cuDNN's float32 conv, TF32 off: another
    summation order); the NHWC layout on K7_REQUIRED in both dtypes.
    Times in both dtypes of the yolo11n-pose shapes (k7_times: each
    form, the plain version, cuDNN's conv + SiLU and the bound); the
    totals over the convs of one yolo11n-pose forward, the path that runs
    the route, in bfloat16 and in float32 (the route's float32 form is
    taps); then the SASS checks (HGMMA in the tensor-core kernels, no
    spill in the CUDA-core one); the entry reports the bfloat16 mma form,
    the route's default."""
    import torch

    from strongsort_yolo_tpu_torch.ops.cuda.conv_kernel import (
        FORMS, conv_act_kernel, conv_act_plain,
    )

    dev = torch.device("cuda")
    pose = k7_picks("yolo11n-pose")
    shapes = sorted({p[1:] for p in pose + k7_picks("yolov8n")})
    if not K7_REQUIRED <= {s[:5] for s in shapes}:
        raise AssertionError("K7 check: a required shape is not picked")
    rng = np.random.default_rng(7)
    max_err, rows = 0.0, {}
    for h, w, c_in, c_out, k, act in shapes:
        x32 = torch.from_numpy(rng.normal(0, 1, (S_MAIN, c_in, h, w))
                               .astype(np.float32)).to(dev)
        wt = torch.from_numpy((rng.normal(0, 1, (k * k * c_in, c_out))
                               * (2.0 / (k * k * c_in)) ** 0.5)
                              .astype(np.float32)).to(dev)
        b = torch.from_numpy(rng.normal(0, 0.3, c_out).astype(np.float32)).to(dev)
        shape = (h, w, c_in, c_out, k, act)
        for dt in (torch.float32, torch.bfloat16):
            tol = 2e-5 if dt == torch.float32 else 2.0 ** -7
            layouts = ("nchw", "nhwc") if shape[:5] in K7_REQUIRED else ("nchw",)
            forms = FORMS if dt == torch.bfloat16 else ("taps", "im2col")
            for layout in layouts:
                x = x32.to(dt)
                if layout == "nhwc":
                    x = x.permute(0, 2, 3, 1)
                want = conv_act_plain(x, wt, b, k=k, act=act, layout=layout)
                for form in forms:
                    got = conv_act_kernel(x, wt, b, k=k, act=act,
                                          layout=layout, form=form)
                    again = conv_act_kernel(x, wt, b, k=k, act=act,
                                            layout=layout, form=form)
                    torch.cuda.synchronize()
                    name = f"K7 conv_act {form} {layout} {shape} S={S_MAIN} {dt}"
                    if not torch.equal(got, again):
                        raise AssertionError(f"{name}: two launches differ")
                    diff = (got.float() - want.float()).abs()
                    scaled = float((diff / want.float().abs().clamp(min=1.0)).max())
                    if not scaled <= tol:
                        raise AssertionError(f"{name}: scaled |err| {scaled} "
                                             f"> {tol}")
                    max_err = max(max_err, float(diff.max()))
        if shape not in {p[1:] for p in pose}:
            log(f"K7 conv_act {h}x{w} {c_in}->{c_out} k{k} act={act} S={S_MAIN}:"
                f" every form within its bound (yolov8n only, not timed)")
            continue
        rows[shape] = {dt: k7_times(x32.to(dt), wt, b, k, act)
                       for dt in (torch.bfloat16, torch.float32)}
        flops = 2 * k * k * c_in * c_out * S_MAIN * h * w
        for dt, r in rows[shape].items():
            forms = "mma taps im2col" if dt == torch.bfloat16 else "taps im2col"
            log(f"K7 conv_act {h}x{w} {c_in}->{c_out} k{k} act={act} "
                f"S={S_MAIN} {DT_NAME[str(dt)]}: "
                + ", ".join(f"{f} {r[f]:.4f} ms" for f in forms.split())
                + f", plain {r['plain']:.4f} ms, cuDNN {r['library']:.4f} ms, "
                f"bound {r['bound'][0]:.6f} ms ({r['bound'][1]}, "
                f"{flops / 1e9:.3f} GFLOP); {forms.split()[0]} "
                f"{flops / r[forms.split()[0]] / 1e9:.2f} TFLOP/s, cuDNN "
                f"{flops / r['library'] / 1e9:.2f} [{card}]")
    totals = {}
    for dt in (torch.bfloat16, torch.float32):
        keys = ("mma", "taps", "im2col") if dt == torch.bfloat16 else (
            "taps", "im2col")
        tot = {key: sum(rows[p[1:]][dt][key] for p in pose)
               for key in (*keys, "plain", "library")}
        tot["bound"] = sum(rows[p[1:]][dt]["bound"][0] for p in pose)
        tot["by_ops"] = sum(rows[p[1:]][dt]["bound"][0] for p in pose
                            if rows[p[1:]][dt]["bound"][1] == "operations")
        totals[dt] = tot
        log(f"K7 over the {len(pose)} convs of one yolo11n-pose S={S_MAIN} "
            f"640 forward, {DT_NAME[str(dt)]}, device time (CUDA graph replay): "
            + ", ".join(f"{f} {tot[f]:.4f} ms" for f in keys)
            + f", plain {tot['plain']:.4f} ms, cuDNN conv + SiLU "
            f"{tot['library']:.4f} ms, bound {tot['bound']:.6f} ms "
            f"({tot['by_ops']:.6f} of it from convs bound by operations); "
            f"{keys[0]} / cuDNN {tot[keys[0]] / tot['library']:.3f}, "
            f"{keys[0]} at {tot['bound'] / tot[keys[0]]:.1%} of the bound "
            f"[{card}]")
    log(f"K7: {len(shapes)} shapes checked, every form, max |err| "
        f"{max_err:.3g} [{card}]")
    check_tensor_core_sass("conv_mma_kernel", "HGMMA", "K7 mma")
    check_tensor_core_sass("conv_im2col_mma_kernel", "HGMMA", "K7 im2col")
    check_no_spill("conv_act_kernel", "K7 taps and float32 im2col")
    total = totals[torch.bfloat16]
    t_bound, by_ops = total["bound"], total["by_ops"]
    return dict(
        name="conv_act", route="cuda",
        source="strongsort_yolo_tpu_torch/csrc/conv_mma.cuh",
        replaces="tools/prof/conv_kernel.py:164 pallas_conv_act and "
                 "tools/prof/_prof_conv2.py:145 call",
        max_abs_err=max_err, ms=total["mma"], plain_ms=total["plain"],
        bound_ms=t_bound,
        bound_by="operations" if by_ops >= t_bound / 2 else "bytes",
        library_ms=total["library"],
    )


def check_k4(rng) -> dict:
    """K4 against banded_crop_plain: S=8 1080p frames, 64 boxes each, and
    S=3 481x853 frames (level rows of 853 values, not 16-byte aligned),
    in the fixed-width form (slot b*64 + i from frame b) and the packed
    form (ragged per-frame counts padded to 8 with the dummy box)."""
    import torch

    from strongsort_yolo_tpu_torch.ops.crops import banded_prep, pyramid_stack
    from strongsort_yolo_tpu_torch.ops.cuda.crop_kernel import (
        banded_crop, banded_crop_frames, banded_crop_plain,
    )
    from strongsort_yolo_tpu_torch.tools.prof_resample import k4_boxes

    dev = torch.device("cuda")
    M, out_hw = 64, (128, 64)
    max_err = 0.0
    for (h, w), counts in (((1080, 1920), [64, 0, 37, 5, 64, 12, 1, 50]),
                           ((481, 853), [64, 9, 1])):
        S = len(counts)
        frames = torch.from_numpy(
            rng.integers(0, 256, (S, h, w, 3), dtype=np.uint8)).to(dev)
        boxes = np.stack([k4_boxes(rng, M, h, w) for _ in range(S)])
        packed, slot_frame = [], []
        for f, n in enumerate(counts):
            pad = -(-n // 8) * 8
            packed.append(np.concatenate(
                [boxes[f, :n], np.tile([[0, 0, 16, 32]], (pad - n, 1))]))
            slot_frame += [f] * pad
        packed = torch.from_numpy(
            np.concatenate(packed).astype(np.float32)).to(dev)
        slot_frame = torch.tensor(slot_frame, dtype=torch.int32, device=dev)
        boxes_t = torch.from_numpy(boxes).to(dev)
        fixed_frame = (torch.arange(S * M, device=dev) // M).to(torch.int32)
        for dt in (torch.float32, torch.bfloat16):
            imgs = frames.permute(0, 3, 1, 2).to(dt) / torch.full(
                (), 255.0, dtype=dt, device=dev)
            pyr = pyramid_stack(imgs)
            scal_f, ints_f = banded_prep(boxes_t.reshape(-1, 4), (h, w),
                                         pyr.dims, out_hw)
            scal_p, ints_p = banded_prep(packed, (h, w), pyr.dims, out_hw)
            if set(ints_f[:, 2].tolist()) != set(range(len(pyr.dims))):
                raise AssertionError("K4 check: the boxes miss a pyramid level")
            for form, got, want in (
                ("fixed-width", banded_crop_frames(imgs, boxes_t).reshape(
                    S * M, 3, *out_hw),
                 banded_crop_plain(pyr, scal_f, ints_f, fixed_frame)),
                ("packed", banded_crop(pyr, scal_p, ints_p, slot_frame),
                 banded_crop_plain(pyr, scal_p, ints_p, slot_frame)),
            ):
                err = float((got.float() - want.float()).abs().max())
                if not torch.equal(got, want):
                    raise AssertionError(f"K4 {form} {h}x{w} {dt}: differs "
                                         f"from the plain version, max |err| "
                                         f"{err}")
                max_err = max(max_err, err)
                log(f"K4 banded_crop {form} ({got.shape[0]} slots of {S} "
                    f"{h}x{w} frames) {dt}: bit-identical")
    return dict(
        name="banded_crop", route="cuda",
        source="strongsort_yolo_tpu_torch/csrc/banded_crop.cu",
        replaces="strongsort_yolo_tpu/ops/pallas/crop_kernel.py:147 and "
                 "strongsort_yolo_tpu/ops/pallas/crop_kernel.py:292",
        max_abs_err=max_err, library_ms=None,
    )


def to_card(frames: np.ndarray):
    """Host frames as a tensor on the card that the caller owns (the
    pipeline's own uploads go through its pinned ring)."""
    import torch

    return torch.from_numpy(np.ascontiguousarray(frames)).to("cuda")


def calibrate_candidates(pipe, frame: np.ndarray, conf: float, target: int):
    """Set the head of ``pipe.model`` so that about ``target`` anchors of
    ``frame`` clear ``conf`` (:func:`calibrate_head`)."""
    import torch

    from strongsort_yolo_tpu_torch.ops.letterbox import letterbox, letterbox_params

    lp = letterbox_params(*frame.shape[:2], pipe.det_cfg.imgsz)
    img = letterbox(torch.from_numpy(frame[None]).to(pipe.device), lp,
                    dtype=pipe.compute_dtype)
    calibrate_head(pipe.model, img, conf, target)


# the spread calibrate_head gives the raw outputs of a v5 or v7 head, per
# level and channel kind: a random network's are nearly constant (std
# 1e-4 to 2e-2), so that every anchor would score alike
HEAD_STD = {"xy": 0.5, "wh": 0.5, "obj": 1.5, "cls": 1.5, "box": 0.5}


def _head_raws(model, img, convs):
    """The raw outputs of ``convs`` in one forward of ``img``, float32."""
    import torch

    raws = []
    hooks = [c.register_forward_hook(lambda m, a, o: raws.append(o.float()))
             for c in convs]
    try:
        with torch.no_grad():
            model(img)
    finally:
        for h in hooks:
            h.remove()
    return raws


def _scale_rows(conv, rows, gain) -> None:
    import torch

    with torch.no_grad():
        conv.w[rows] *= gain
        conv.b[rows] *= gain


def calibrate_head(model, img, conf: float, target: int,
                   spread: dict | None = None) -> None:
    """Set the output biases of ``model``'s head so that about ``target``
    anchors of ``img`` (one letterboxed frame) clear ``conf``, with margin.

    A v8 / v11 model (the main path's) has only its class biases shifted.
    The v5 and v7 heads first have their output rows scaled per level to
    the spread of HEAD_STD (a random network's are nearly constant), then:
    the anchor-based head its objectness biases shifted (by bisection: its
    score is obj * cls), the u head its class biases. ``spread`` replaces
    HEAD_STD; a kind it lacks keeps its rows as they are."""
    import torch

    from strongsort_yolo_tpu_torch.models.yolo import YoloModel
    from strongsort_yolo_tpu_torch.models.yolov5 import AnchorHead

    head = model.detect
    spread = HEAD_STD if spread is None else spread
    logit_conf = math.log(conf / (1 - conf))
    if isinstance(head, AnchorHead):
        no = 5 + head.nc
        kinds = {"xy": [0, 1], "wh": [2, 3], "obj": [4],
                 "cls": list(range(5, no))}
        for conv, raw in zip(head.m, _head_raws(model, img, head.m)):
            raw = raw.view(raw.shape[0], head.na, no, -1)
            for kind, ch in kinds.items():
                if kind not in spread:
                    continue
                gain = spread[kind] / max(float(raw[:, :, ch].std()), 1e-12)
                rows = [a * no + c for a in range(head.na) for c in ch]
                _scale_rows(conv, rows, gain)
        obj, best = [], []
        for raw in _head_raws(model, img, head.m):
            raw = raw[0].view(head.na, no, -1)
            obj.append(raw[:, 4].reshape(-1))
            best.append(torch.sigmoid(raw[:, 5:]).amax(1).reshape(-1))
        obj, best = torch.cat(obj).cpu(), torch.cat(best).cpu()
        want = min(conf + 0.05, 0.5 * (conf + float(best.max())))
        lo, hi = -40.0, 40.0
        for _ in range(60):  # the target-th score rises with the offset
            mid = 0.5 * (lo + hi)
            kth = torch.topk(torch.sigmoid(obj + mid) * best, target).values[-1]
            lo, hi = (lo, mid) if float(kth) >= want else (mid, hi)
        with torch.no_grad():
            for conv in head.m:
                conv.b[4::no] += hi
        return
    if not isinstance(model, YoloModel):  # the u head of v5
        for convs, kind in ((head.cls, "cls"), (head.box, "box")):
            if kind not in spread:
                continue
            outs = [b.out for b in convs]
            for conv, raw in zip(outs, _head_raws(model, img, outs)):
                gain = spread[kind] / max(float(raw.std()), 1e-12)
                _scale_rows(conv, slice(None), gain)
    with torch.no_grad():
        cls = model(img)["cls_logits"]
    logits = cls[0].float().amax(-1).cpu().numpy()
    kth = np.partition(logits, -target)[-target]
    # land above the threshold with margin: bf16 logits tie heavily
    offset = float(logit_conf + 0.7 - kth)
    with torch.no_grad():
        for branch in head.cls:
            branch.out.b.add_(offset)


def _drive(bp, ticks, kernels, record=None):
    """Step ``bp`` through ``ticks`` with every launch count zeroed just
    before, calling ``record(bp, results)`` after each timed step; ->
    (counts read just after, ms per tick, last results)."""
    import torch

    for k in kernels:
        k.launches = 0
    times, results = [], None
    for frames in ticks:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        results = bp.step(frames)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        if record is not None:
            record(bp, results)
    counts = {k.__name__: k.launches for k in kernels}
    return counts, times, results


def _check_results(name: str, results) -> list[int]:
    for r in results:
        if not np.isfinite(r.boxes.xyxy).all():
            raise AssertionError(f"{name}: non-finite track boxes")
    tracks = [len(r) for r in results]
    if sum(tracks) == 0:
        raise AssertionError(f"{name}: no active tracks after {TICKS} ticks")
    return tracks


def _ms_line(times: list[float]) -> str:
    steady = sorted(times[2:])
    return (f"median {steady[len(steady) // 2]:.2f}, min {steady[0]:.2f}, "
            f"first {times[0]:.2f}; all {[round(x, 2) for x in times]}")


def _main_pipeline(tracker, pool, *, fused: bool = False, cadence: int = 1,
                   model: str = "yolov8n", conv_kernel: bool = False,
                   max_dets: int = 128, reid: str | None = None,
                   quant: str | None = None, half: bool = True):
    from strongsort_yolo_tpu_torch.config import DetectorConfig
    from strongsort_yolo_tpu_torch.pipeline import Pipeline

    pipe = Pipeline(
        DetectorConfig(weights=model, imgsz=640, half=half, max_det=1000,
                       quant=quant),
        tracker=tracker, track_slots=256, tracker_max_dets=max_dets,
        reid_weights=reid, reid_topk=128, reid_cadence=cadence,
        reid_fused=fused, conv_kernel=conv_kernel, seed=0, device="cuda",
    )
    calibrate_candidates(pipe, pool[0], pipe.det_cfg.conf, TARGET_DETS)
    return pipe


class capture_auction:
    """Within the block, every K3 call of the trackers (through
    ops.assignment) also keeps a copy of its arguments: a list of
    (cost, thresh, row_valid, col_valid) in call order."""

    def __enter__(self):
        from strongsort_yolo_tpu_torch.ops import assignment

        self.module, self.real, calls = assignment, assignment.auction, []

        def recording(*args):
            calls.append(tuple(a.clone() for a in args))
            return self.real(*args)

        assignment.auction = recording
        return calls

    def __exit__(self, *exc):
        self.module.auction = self.real


def check_k3_tick(card: str, calls,
                  label: str = "one steady BoT-SORT tick") -> None:
    """K3 on the tracker's own problems (by default the three calls of one
    steady BoT-SORT tick, S=8, 256 slots, 128 tracker dets), bit-identical
    to auction_plain, each replayed as a CUDA graph and timed, with the
    valid rows and columns and the bidding rounds (counted by the plain
    version) of each problem."""
    import torch

    from strongsort_yolo_tpu_torch.ops.cuda.auction_kernel import (
        auction, auction_rounds,
    )
    from strongsort_yolo_tpu_torch.tools.prof_conv import graph_ms

    total = 0.0
    for k, args in enumerate(calls):
        got = auction(*args)
        r2c, c2r, rounds = auction_rounds(*args)
        torch.cuda.synchronize()
        if not (torch.equal(got[0], r2c) and torch.equal(got[1], c2r)):
            raise AssertionError(f"K3 tick call {k}: differs from the plain "
                                 "version")
        ms = graph_ms(lambda a=args: auction(*a))
        total += ms
        log(f"K3 tick call {k + 1} {tuple(args[0].shape)}: identical r2c/c2r; "
            f"valid rows {args[2].sum(1).tolist()}, valid columns "
            f"{args[3].sum(1).tolist()}, rounds {rounds.tolist()}, matches "
            f"{(got[0] >= 0).sum(1).tolist()}; kernel {ms:.4f} ms (CUDA graph "
            f"replay) [{card}]")
    log(f"K3 on {label}, {len(calls)} calls: kernel {total:.4f} ms [{card}]")


def phase_main_path(card: str, kernels):
    """BoT-SORT (K1-K3) at full width, without camera-motion
    compensation. -> (launch counts, median ms/tick)."""
    import torch

    from strongsort_yolo_tpu_torch.pipeline import BatchedPipeline
    from strongsort_yolo_tpu_torch.track.bytetrack import ByteTrackConfig

    h, w = 1080, 1920
    pool = make_frames(h, w)
    pipe = _main_pipeline(
        ByteTrackConfig(tracker_type="botsort", gmc_method="none"), pool)
    ticks = [np.stack([pool[(s + t) % len(pool)] for s in range(S_MAIN)])
             for t in range(TICKS)]
    det = pipe.detect(torch.from_numpy(ticks[0]).to(pipe.device))
    dets = det.count.cpu().numpy()
    log(f"main path: yolov8n nc=80 imgsz 640 bf16, S={S_MAIN} 1080p, "
        f"botsort gmc none; detections per frame {dets.tolist()}")
    if not (dets > 0).all():
        raise AssertionError("main path: a frame without detections")
    with capture_auction() as captured:
        counts, times, results = _drive(
            BatchedPipeline(pipe, S_MAIN, (h, w)), ticks, kernels)
    log(f"main path launches over {TICKS} ticks: {counts}")
    if len(captured) != 3 * TICKS:
        raise AssertionError(f"main path: {len(captured)} K3 calls captured "
                             f"in {TICKS} ticks, not 3 per tick")
    check_k3_tick(card, captured[-3:])
    for name, n in counts.items():
        if n == 0:
            raise AssertionError(f"main path never launched {name}")
    tracks = _check_results("main path", results)
    log(f"main path active tracks per stream after {TICKS} ticks: {tracks}")
    log(f"main path ms/tick (S={S_MAIN}, 1080p, host clock, synchronized): "
        f"{_ms_line(times)} [{card}]")
    return counts, sorted(times[2:])[len(times[2:]) // 2]


def phase_crowd_path(card: str, kernels):
    """ByteTrack at full width with tracker_max_dets=256 on 256 slots (the
    reference's crowd setting): every association problem is 256 x 256,
    whose benefit block K3 holds in its global scratch. K1-K3; K3 must
    launch on every tick."""
    from strongsort_yolo_tpu_torch.ops.cuda.auction_kernel import shared_form
    from strongsort_yolo_tpu_torch.pipeline import BatchedPipeline
    from strongsort_yolo_tpu_torch.track.bytetrack import ByteTrackConfig

    h, w = 1080, 1920
    pool = make_frames(h, w, seed=3)
    pipe = _main_pipeline(
        ByteTrackConfig(tracker_type="bytetrack", gmc_method="none"), pool,
        max_dets=256)
    if shared_form(pipe.track_slots, pipe.tracker_max_dets):
        raise AssertionError("crowd path: K3 would hold a 256 x 256 block in "
                             "shared memory")
    ticks = [np.stack([pool[(s + t) % len(pool)] for s in range(S_MAIN)])
             for t in range(CROWD_TICKS)]
    counts, times, results = _drive(
        BatchedPipeline(pipe, S_MAIN, (h, w)), ticks, kernels)
    for name, n in counts.items():
        if n == 0:
            raise AssertionError(f"crowd path never launched {name}")
    if counts["auction"] < CROWD_TICKS:
        raise AssertionError(f"crowd path: K3 launched {counts['auction']} "
                             f"times in {CROWD_TICKS} ticks")
    tracks = _check_results("crowd path", results)
    log(f"crowd path: yolov8n 640 bf16, S={S_MAIN} 1080p, bytetrack, 256 "
        f"slots, tracker_max_dets 256 (K3 on (256, 256) problems, benefit "
        f"block in its global scratch); launches over {CROWD_TICKS} ticks: "
        f"{counts}; active tracks per stream {tracks}; ms/tick "
        f"{_ms_line(times)} [{card}]")


# per-stream camera pan of the flow path, frame px per tick (dx, dy): whole
# pixels of the 180x320 gray, which samples two of every six 1080p columns
# (a hard edge panned by a fraction of that aliases)
PANS = [(6, -6), (-12, 6), (12, 0), (0, -12), (-6, -18), (18, 12), (-18, 6),
        (24, -6)]
# fractional pans of the gray, as a real camera makes them
FRACTIONAL_PANS = [(5, -3), (7, 2), (-9, 4), (3, 8), (-1, -7), (10, -5),
                   (-4, 11), (1, 0)]


def panned_scene(h: int, w: int) -> np.ndarray:
    """(h, w, 3) uint8 BGR: the smooth periodic background with six
    bright rectangles drawn over it; np.roll of it is an exact pan."""
    bg = smooth_image(h, w, seed=7)
    scene = np.stack([bg - 10, bg, bg + 10], -1).clip(0, 255).astype(np.uint8)
    for k in range(6):
        x, y = (100 + 311 * k) % (w - 200), (80 + 157 * k) % (h - 260)
        scene[y:y + 240, x:x + 180] = (40 * k + 120) % 255
    return scene


def phase_flow_path(card: str, kernels):
    """BoT-SORT with gmc_method="flow_tpu" at full width (K1-K3 and K5):
    each stream pans its scene by its own PANS entry per tick; K5 must
    launch once per tick and recover every pan within 2 frame px from
    tick 1 on. -> (launch counts, median ms/tick)."""
    import torch

    from strongsort_yolo_tpu_torch.ops.cuda.lk_kernel import lk_pyramid
    from strongsort_yolo_tpu_torch.pipeline import BatchedPipeline
    from strongsort_yolo_tpu_torch.tools.prof_conv import graph_ms
    from strongsort_yolo_tpu_torch.track.bytetrack import ByteTrackConfig
    from strongsort_yolo_tpu_torch.track.gmc_flow import (
        _ITERS_BY_LEVEL, batched_warps, frame_to_gray, pyramid,
    )

    h, w = 1080, 1920
    scene = panned_scene(h, w)

    def panned(pans):
        return [np.stack([np.roll(scene, (t * dy, t * dx), axis=(0, 1))
                          for dx, dy in pans]) for t in range(TICKS)]

    ticks = panned(PANS)
    pipe = _main_pipeline(
        ByteTrackConfig(tracker_type="botsort", gmc_method="flow_tpu"),
        [scene])
    warps = []
    bp = BatchedPipeline(pipe, S_MAIN, (h, w))
    counts, times, results = _drive(
        bp, ticks, kernels,
        lambda b, _: warps.append(b.last_warps.cpu().numpy()))
    log(f"flow path: yolov8n 640 bf16, S={S_MAIN} 1080p, botsort gmc "
        f"flow_tpu, pans (frame px/tick) {PANS}; launches over {TICKS} "
        f"ticks: {counts}")
    for name, n in counts.items():
        if n == 0:
            raise AssertionError(f"flow path never launched {name}")
    if counts["lk_pyramid"] != TICKS:
        raise AssertionError(f"K5 launched {counts['lk_pyramid']} times in "
                             f"{TICKS} ticks, not once per tick")
    if not np.array_equal(warps[0], np.tile(np.eye(2, 3), (S_MAIN, 1, 1))):
        raise AssertionError("flow path: tick 0 warps are not the identity")
    pans = np.array(PANS, np.float32)
    err = np.abs(np.stack(warps[1:])[:, :, :, 2] - pans).max()
    lin = np.abs(np.stack(warps[1:])[:, :, :, :2] - np.eye(2)).max()
    log(f"flow path recovered pans, ticks 1-{TICKS - 1}: max |translation - "
        f"pan| {err:.4f} frame px, max |linear - I| {lin:.2e}")
    if not err <= 2.0:
        raise AssertionError(f"flow path: a pan recovered {err} px off")
    frac = BatchedPipeline(pipe, S_MAIN, (h, w))
    frac_warps = []
    for frames in panned(FRACTIONAL_PANS):
        frac.step(frames)
        frac_warps.append(frac.last_warps.cpu().numpy())
    frac_err = np.abs(np.stack(frac_warps[1:])[:, :, :, 2]
                      - np.array(FRACTIONAL_PANS, np.float32)).max((0, 2))
    log(f"flow path fractional pans {FRACTIONAL_PANS}: max |translation - "
        f"pan| per stream {[round(float(e), 4) for e in frac_err]} frame px, "
        f"ticks 1-{TICKS - 1}")
    if not frac_err.max() <= 6.0:
        raise AssertionError(f"flow path: a fractional pan recovered "
                             f"{frac_err.max()} px off, past one gray pixel")
    tracks = _check_results("flow path", results)
    log(f"flow path active tracks per stream after {TICKS} ticks: {tracks}")
    log(f"flow path ms/tick (S={S_MAIN}, 1080p, host clock, synchronized): "
        f"{_ms_line(times)} [{card}]")

    # the GMC share of a tick, on the last tick's frames (CUDA events)
    frames = to_card(ticks[-1])
    prev = frame_to_gray(to_card(ticks[-2]))
    gray = frame_to_gray(frames)
    pp, pc = pyramid(prev), pyramid(gray)
    params = torch.tensor([1.0, 0.0, 0.0, 0.0, 1.0, 0.0],
                          device=pipe.device).repeat(S_MAIN, 1)
    split = {
        "gray": cuda_ms(lambda: frame_to_gray(frames)),
        "pyramid (both)": cuda_ms(lambda: (pyramid(prev), pyramid(gray))),
        "K5": cuda_ms(lambda: lk_pyramid(pp, pc, params, _ITERS_BY_LEVEL)),
        "K5 by graph replay": graph_ms(
            lambda: lk_pyramid(pp, pc, params, _ITERS_BY_LEVEL)),
        "batched_warps": cuda_ms(lambda: batched_warps(
            prev, gray, (h, w), torch.ones(S_MAIN, dtype=torch.bool,
                                           device=pipe.device))),
    }
    median = sorted(times[2:])[len(times[2:]) // 2]
    share = (split["gray"] + split["batched_warps"]) / median
    log("flow path GMC split (mean of 20, ms): "
        + ", ".join(f"{k} {v:.3f}" for k, v in split.items())
        + f"; gray + batched_warps = {share:.1%} of the median tick [{card}]")

    # one stream's frames through T track calls and through one chunk
    one = [tick[0] for tick in ticks]
    runs = {}
    for name, run, launches in (
        ("track", lambda: [pipe.track(f) for f in one], TICKS),
        ("track_chunk", lambda: pipe.track_chunk(np.stack(one)), 1),
    ):
        ms = []
        for _ in range(2):  # the first pass meets the batch shape first
            pipe.reset()
            lk_pyramid.launches = 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            results = run()
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
        if lk_pyramid.launches != launches:
            raise AssertionError(f"{name}: K5 launched {lk_pyramid.launches} "
                                 f"times over {TICKS} frames, not {launches}")
        runs[name] = (ms, _check_results(name, results))
    (ms_t, rows_t), (ms_c, rows_c) = runs["track"], runs["track_chunk"]
    log(f"stream 0, {TICKS} 1080p frames, flow_tpu: {TICKS} track calls "
        f"{ms_t[1]:.2f} ms (first pass {ms_t[0]:.2f}), K5 {TICKS} launches; "
        f"one track_chunk {ms_c[1]:.2f} ms (first pass {ms_c[0]:.2f}), K5 1 "
        f"launch; tracks per frame {rows_t} vs {rows_c} [{card}]")
    return counts, median


def _record_slots(pipe) -> list[int]:
    """Note G, the crop slots, of every embed of ``pipe``."""
    slot_counts, embed_slots = [], pipe.embed_slots

    def recording(counts, mask=None):
        slots = embed_slots(counts, mask)
        slot_counts.append(slots.shape[1])
        return slots

    pipe.embed_slots = recording
    return slot_counts


def phase_strongsort_path(card: str, kernels):
    """StrongSORT + OSNet-x0_25 at full width: K1-K4. -> (launch counts,
    K4's entries, median ms/tick, the pipeline, the ticks, G per tick)."""
    import torch

    from strongsort_yolo_tpu_torch.tools.prof_conv import graph_ms

    from strongsort_yolo_tpu_torch.ops.cuda.crop_kernel import (
        banded_crop, banded_crop_plain,
    )
    from strongsort_yolo_tpu_torch.pipeline import BatchedPipeline
    from strongsort_yolo_tpu_torch.track.strongsort import StrongSortConfig
    from strongsort_yolo_tpu_torch.utils.transfer import to_device

    h, w = 1080, 1920
    pool = make_frames(h, w, seed=1)
    pipe = _main_pipeline(StrongSortConfig(gmc_method="none"), pool)
    ticks = [np.stack([pool[(s + t) % len(pool)] for s in range(S_MAIN)])
             for t in range(TICKS)]
    embed_slots = pipe.embed_slots
    slot_counts = _record_slots(pipe)
    counts, times, results = _drive(
        BatchedPipeline(pipe, S_MAIN, (h, w)), ticks, kernels)
    log(f"strongsort path: yolov8n 640 bf16 + osnet_x0_25 (feat 512, crops "
        f"128x64) bf16, S={S_MAIN} 1080p, 256 slots, 128 tracker dets, "
        f"reid_topk 128, gmc none; launches over {TICKS} ticks: {counts}")
    for name, n in counts.items():
        if n == 0:
            raise AssertionError(f"strongsort path never launched {name}")
    if counts["banded_crop"] != TICKS:
        raise AssertionError(f"K4 launched {counts['banded_crop']} times in "
                             f"{TICKS} ticks, not once per tick")
    log(f"strongsort path crop slots G per tick: {slot_counts}")
    tracks = _check_results("strongsort path", results)
    log(f"strongsort path active tracks per stream after {TICKS} ticks: "
        f"{tracks}")
    log(f"strongsort path ms/tick (S={S_MAIN}, 1080p, host clock, "
        f"synchronized): {_ms_line(times)} [{card}]")

    # the embed of the last tick, split with a synced host clock
    frames = to_card(ticks[-1])
    det = pipe.detect(frames)
    slots = embed_slots(det.count.cpu().numpy())
    split = {"pyramid": [], "slot upload + banded_prep": [], "K4": [],
             "OSNet": []}
    with torch.no_grad():
        for _ in range(5):
            stamps = []

            def stamp():
                torch.cuda.synchronize()
                stamps.append(time.perf_counter())

            stamp()
            pyr = pipe.pyramid(frames)
            stamp()
            params = pipe.crop_params(pyr, det,
                                      to_device(slots, pipe.device))
            stamp()
            crops = banded_crop(pyr, *params)
            stamp()
            feats = pipe.reid(crops)
            stamp()
            for key, a, b in zip(split, stamps, stamps[1:]):
                split[key].append((b - a) * 1e3)
    if not torch.isfinite(feats).all():
        raise AssertionError("strongsort path: non-finite embeddings")
    log(f"strongsort embed split at G={slots.shape[1]} (median of 5, ms): "
        + ", ".join(f"{k} {sorted(v)[2]:.3f}" for k, v in split.items())
        + f" [{card}]")
    if not torch.equal(crops, banded_crop_plain(pyr, *params)):
        raise AssertionError("K4 on the path's crop batch differs from its "
                             "plain version")
    k4_times = (graph_ms(lambda: banded_crop(pyr, *params)),
                cuda_ms(lambda: banded_crop_plain(pyr, *params), iters=5),
                cuda_ms(lambda: banded_crop(pyr, *params)))
    # about 7 operations per output value: two column taps, two row taps
    k4_bound = bound(k4_bytes(pyr, *params, crops), 7 * crops.numel())
    log(f"K4 time on the path's crop batch (G={slots.shape[1]} slots of "
        f"{S_MAIN} 1080p frames, bf16 -> (G,3,128,64), bit-identical): "
        f"kernel {k4_times[0]:.4f} ms by graph replay ({k4_times[2]:.4f} by "
        f"events), plain {k4_times[1]:.4f} ms, bound {k4_bound[0]:.4f} ms "
        f"({k4_bound[1]}), {100 * k4_bound[0] / k4_times[0]:.1f}% of it "
        f"[{card}]")
    k4 = dict(ms=k4_times[0], plain_ms=k4_times[1], bound_ms=k4_bound[0],
              bound_by=k4_bound[1])
    median = sorted(times[2:])[len(times[2:]) // 2]
    return counts, k4, median, pipe, ticks, slot_counts


def phase_fused_strongsort_path(card: str, kernels, unfused):
    """The StrongSORT path with the fused OSNet: K1-K4 and K6, K6 three
    times and K4 once per tick; its ms/tick beside the unfused path's,
    OSNet on one crop batch fused against unfused (CUDA events); then
    the fused path with reid_cadence=2. -> launch counts."""
    import torch

    from strongsort_yolo_tpu_torch.ops.cuda.crop_kernel import banded_crop
    from strongsort_yolo_tpu_torch.pipeline import BatchedPipeline
    from strongsort_yolo_tpu_torch.track.strongsort import StrongSortConfig

    unfused_ms, upipe, ticks, unfused_g = unfused
    h, w = 1080, 1920
    pool = make_frames(h, w, seed=1)
    pipe = _main_pipeline(StrongSortConfig(gmc_method="none"), pool,
                          fused=True)
    if pipe.reid._stages is None:
        raise AssertionError("reid_fused=True built an unfused OSNet")
    recorded = _record_slots(pipe)
    counts, times, results = _drive(
        BatchedPipeline(pipe, S_MAIN, (h, w)), ticks, kernels)
    slot_counts = list(recorded)
    log(f"fused strongsort path (reid_fused=True), otherwise as the "
        f"strongsort path; launches over {TICKS} ticks: {counts}")
    for name, n in counts.items():
        if n == 0:
            raise AssertionError(f"fused strongsort path never launched {name}")
    if counts["os_stage"] != 3 * TICKS or counts["banded_crop"] != TICKS:
        raise AssertionError(
            f"K6 launched {counts['os_stage']} and K4 {counts['banded_crop']} "
            f"times in {TICKS} ticks, not 3 and 1 per tick")
    tracks = _check_results("fused strongsort path", results)
    median = sorted(times[2:])[len(times[2:]) // 2]
    log(f"fused strongsort path G per tick {slot_counts} (unfused path "
        f"{unfused_g}); active tracks per stream {tracks}")
    log(f"strongsort ms/tick (S={S_MAIN}, 1080p, host clock, synchronized): "
        f"fused {_ms_line(times)}; median fused {median:.2f} vs unfused "
        f"{unfused_ms:.2f} [{card}]")

    # OSNet on the last tick's crop batch, fused against unfused
    frames = to_card(ticks[-1])
    det = pipe.detect(frames)
    slots = torch.from_numpy(pipe.embed_slots(det.count.cpu().numpy()))
    with torch.no_grad():
        pyr = pipe.pyramid(frames)
        crops = banded_crop(pyr, *pipe.crop_params(pyr, det,
                                                   slots.to(pipe.device)))
        f_fused, f_plain = pipe.reid(crops), upipe.reid(crops)
        cos = (f_fused * f_plain).sum(-1)
        if not (torch.isfinite(f_fused).all() and float(cos.mean()) >= 0.99):
            raise AssertionError(f"fused OSNet: cosine to the unfused "
                                 f"embedding {float(cos.mean())} on average")
        osnet_ms = (cuda_ms(lambda: pipe.reid(crops)),
                    cuda_ms(lambda: upipe.reid(crops)))
    log(f"OSNet-x0_25 bf16 on the last tick's crop batch (G={crops.shape[0]}):"
        f" fused (3 K6 launches) {osnet_ms[0]:.4f} ms, unfused "
        f"{osnet_ms[1]:.4f} ms (CUDA events, mean of 20); embedding cosine "
        f"fused vs unfused min {float(cos.min()):.5f}, mean "
        f"{float(cos.mean()):.5f} [{card}]")

    # cadence 2: each tick embeds the streams with (s + tick) % 2 == 0
    cpipe = _main_pipeline(StrongSortConfig(gmc_method="none"), pool,
                           fused=True, cadence=2)
    cad_g, masks = _record_slots(cpipe), []
    counts2, times2, results2 = _drive(
        BatchedPipeline(cpipe, S_MAIN, (h, w)), ticks, kernels,
        lambda b, _: masks.append(b.last_embed_mask))
    for t, m in enumerate(masks):
        if not np.array_equal(m, (np.arange(S_MAIN) + t) % 2 == 0):
            raise AssertionError(f"cadence 2: tick {t} embed mask {m}")
    ratio = sum(cad_g) / sum(slot_counts)
    if not 0.35 <= ratio <= 0.65:
        raise AssertionError(f"cadence 2 cropped {ratio:.2f} of cadence 1's "
                             "slots, not about half")
    _check_results("cadence 2 path", results2)
    log(f"cadence 2 (fused, S={S_MAIN}): embed masks alternate "
        f"({masks[0].astype(int).tolist()}, then its complement); G per tick "
        f"{cad_g} against {slot_counts} at cadence 1 ({ratio:.2f}); launches "
        f"{counts2}; ms/tick {_ms_line(times2)} [{card}]")
    return counts


def phase_wide_reid_path(card: str, kernels) -> None:
    """StrongSORT with the fused OSNet-x1_0 (seeded random weights) at
    full width, for WIDE_TICKS ticks: K6 three times per tick, in
    bfloat16 (stages 2 and 3 on the tensor cores in a cluster of blocks
    a crop, stage 4 in one block a crop), the median tick beside the
    columns form's (WIDE_TICK_COLUMNS_MS); then K6 alone on x1_0's three
    stages at each G the path took (tools/prof_k6, graph replay, held to
    the K6_BF16_MEAN bar, two launches bit-identical); then the same path
    in float32 (half=False: K6 in its 3xTF32 forms, stages 2 and 3 in a
    cluster of blocks a crop) for WIDE_TICKS ticks, the median tick beside
    the first forms' (WIDE_TICK_F32_FIRST_MS); then the same OSNet-x1_0
    weights in float32, fused, on the card (K6) and on the CPU (its plain
    version), on 64 crops: the embeddings within 1e-4."""
    import torch

    from strongsort_yolo_tpu_torch.models.osnet import (
        OsnetConfig, init_osnet, osnet_from_state_dict,
    )
    from strongsort_yolo_tpu_torch.ops.cuda.osnet_kernel import (
        stage_form, stage_specs,
    )
    from strongsort_yolo_tpu_torch.pipeline import BatchedPipeline
    from strongsort_yolo_tpu_torch.tools.prof_k6 import profile_stage
    from strongsort_yolo_tpu_torch.track.strongsort import StrongSortConfig

    h, w = 1080, 1920
    pool = make_frames(h, w, seed=1)
    pipe = _main_pipeline(StrongSortConfig(gmc_method="none"), pool,
                          fused=True, reid="osnet_x1_0")
    if pipe.reid._stages is None or pipe.feat_dim != 512:
        raise AssertionError("reid_fused=True built no fused OSNet-x1_0")
    slot_counts = _record_slots(pipe)
    ticks = [np.stack([pool[(s + t) % len(pool)] for s in range(S_MAIN)])
             for t in range(WIDE_TICKS)]
    counts, times, results = _drive(
        BatchedPipeline(pipe, S_MAIN, (h, w)), ticks, kernels)
    for name, n in counts.items():
        if n == 0:
            raise AssertionError(f"osnet_x1_0 path never launched {name}")
    if counts["os_stage"] != 3 * WIDE_TICKS:
        raise AssertionError(f"osnet_x1_0 path: K6 launched "
                             f"{counts['os_stage']} times in {WIDE_TICKS} ticks")
    tracks = _check_results("osnet_x1_0 path", results)
    cfg = OsnetConfig(variant="osnet_x1_0")
    specs = stage_specs(cfg.channels)
    forms = [stage_form(spec, torch.bfloat16) for spec in specs]
    log(f"fused strongsort path with osnet_x1_0 (seeded random weights, "
        f"reid_fused=True; K6 stages in bf16: {forms}), S={S_MAIN} 1080p; "
        f"launches over {WIDE_TICKS} ticks: {counts}; G per tick "
        f"{slot_counts}; active tracks per stream {tracks}; ms/tick "
        f"{_ms_line(times)}; the median with stages 2 and 3 in the columns "
        f"form was {WIDE_TICK_COLUMNS_MS:.2f} [{card}]")

    sd = init_osnet(cfg, torch.Generator().manual_seed(1))
    model = osnet_from_state_dict(sd, cfg)
    for g in sorted(set(slot_counts)):
        rows = [profile_stage(model, i, spec, g, seed=100 + i)
                for i, spec in enumerate(specs)]
        for i, r in enumerate(rows):
            if not (r["mean_err"] <= K6_BF16_MEAN and r["repeatable"]):
                raise AssertionError(f"osnet_x1_0 stage {i + 2} at G={g}: {r}")
        log(f"K6 osnet_x1_0 three stages at the path's G={g} bf16: "
            f"{sum(r['ms'] for r in rows):.4f} ms (graph replay; per stage "
            + ", ".join(f"{r['ms']:.4f} ({r['form']}, {r['share']:.2%} of "
                        f"its bound)" for r in rows) + f") [{card}]")
    pipe = _main_pipeline(StrongSortConfig(gmc_method="none"), pool,
                          fused=True, reid="osnet_x1_0", half=False)
    slot_counts = _record_slots(pipe)
    counts, times, results = _drive(
        BatchedPipeline(pipe, S_MAIN, (h, w)), ticks, kernels)
    if counts["os_stage"] != 3 * WIDE_TICKS:
        raise AssertionError(f"osnet_x1_0 f32 path: K6 launched "
                             f"{counts['os_stage']} times in {WIDE_TICKS} ticks")
    tracks = _check_results("osnet_x1_0 f32 path", results)
    forms = [stage_form(spec, torch.float32) for spec in specs]
    log(f"fused strongsort path with osnet_x1_0 in float32 (half=False; K6 "
        f"stages {forms}), S={S_MAIN} 1080p; launches over {WIDE_TICKS} "
        f"ticks: {counts}; G per tick {slot_counts}; active tracks per "
        f"stream {tracks}; ms/tick {_ms_line(times)}; the median with the "
        f"float32 first forms was {WIDE_TICK_F32_FIRST_MS:.2f} [{card}]")
    crops = torch.from_numpy(np.random.default_rng(8).integers(
        0, 256, (64, 3, 128, 64)).astype(np.float32) / np.float32(255.0))
    emb = {}
    for device in ("cuda", "cpu"):
        model = osnet_from_state_dict(sd, cfg)
        model.use_fused_stages(torch.float32)
        model = model.to(device).eval()
        with torch.no_grad():
            emb[device] = model(crops.to(device)).cpu()
    diff = float((emb["cuda"] - emb["cpu"]).abs().max())
    cos = (emb["cuda"] * emb["cpu"]).sum(-1)
    if not diff <= 1e-4:
        raise AssertionError(f"osnet_x1_0 fused: card vs CPU max |diff| {diff}")
    log(f"osnet_x1_0 fused, float32, 64 crops: card (K6) vs CPU (plain "
        f"version) max |diff| {diff:.3g}, least cosine {float(cos.min()):.7f}")


def _check_task_results(name: str, results, task: str) -> int:
    """Every track row carries its keypoints or mask, finite and shaped;
    -> the number of rows."""
    rows = 0
    for r in results:
        extra = r.keypoints if task == "pose" else r.masks
        if extra is None or len(extra) != len(r):
            raise AssertionError(f"{name}: a {task} result without one extra "
                                 "per track row")
        data = extra.data
        if not np.isfinite(data).all():
            raise AssertionError(f"{name}: non-finite {task} extras")
        if task == "pose" and data.shape[1:] != (17, 3):
            raise AssertionError(f"{name}: keypoints of shape {data.shape}")
        if task == "segment" and data.shape[1:] != (160, 160):
            raise AssertionError(f"{name}: masks of shape {data.shape}")
        rows += len(r)
    return rows


def _forward_ms(pipe, frames) -> tuple[float, float]:
    """The model's forward on one letterboxed S-frame batch: (CUDA events
    around 20 launches from the host, device time of a CUDA graph of
    them)."""
    import torch

    from strongsort_yolo_tpu_torch.ops.letterbox import letterbox, letterbox_params
    from strongsort_yolo_tpu_torch.tools.prof_conv import graph_ms

    lp = letterbox_params(*frames.shape[1:3], pipe.det_cfg.imgsz)
    img = letterbox(to_card(frames), lp, dtype=pipe.compute_dtype)
    with torch.no_grad():
        return cuda_ms(lambda: pipe.model(img)), graph_ms(lambda: pipe.model(img))


def _extras_split(label: str, pipe, frames, results, card: str) -> None:
    """The task extras' share of a tick: detect with and without the
    extras of the top tracker_max_dets rows (CUDA events), and the copy
    of the track rows' extras to the host (synchronized host clock), the
    pipeline's (gathered on its download stream into pinned memory)
    against a pageable .cpu() of the same rows."""
    import torch

    dev_frames = to_card(frames)
    k = pipe.tracker_max_dets
    det_ms = cuda_ms(lambda: pipe.detect(dev_frames))
    ext_ms = cuda_ms(lambda: pipe.detect_with_extras(dev_frames, k))
    _, extras = pipe.detect_with_extras(dev_frames, k)
    rows = [np.arange(len(r)) for r in results]
    sel = torch.from_numpy(np.stack([
        np.repeat(np.arange(len(rows)), [len(r) for r in rows]),
        np.concatenate(rows)])).to(pipe.device)
    size = sum(v[0, 0].numel() * v.element_size()
               for v in extras.values()) * sel.shape[1]
    copy_ms = {"pinned": [], "pageable": []}
    for _ in range(5):
        for how in copy_ms:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if how == "pinned":
                ready = torch.cuda.Event()
                ready.record()
                pipe._extras_rows(extras, rows, ready)
            else:
                [v[sel[0], sel[1]].cpu() for v in extras.values()]
            copy_ms[how].append((time.perf_counter() - t0) * 1e3)
    log(f"{label} extras split (S={S_MAIN}, last tick): detect {det_ms:.4f} ms, "
        f"with the extras of {k} rows per frame {ext_ms:.4f} ms (CUDA events, "
        f"mean of 20); copy of {sel.shape[1]} rows' extras "
        f"({size / 1e6:.1f} MB) to the host, median of 5: pinned, on the "
        f"download stream {float(np.median(copy_ms['pinned'])):.3f} ms, "
        f"pageable .cpu() {float(np.median(copy_ms['pageable'])):.3f} ms "
        f"[{card}]")


def phase_task_paths(card: str, kernels, conv_act) -> dict:
    """yolo11n-pose (K1-K3), yolo11n-pose with conv_kernel=True (K1-K3 and
    K7, once per picked conv and tick) and yolov8n-seg (K1-K3) with
    BoT-SORT at full width. -> the route's launch counts."""
    from strongsort_yolo_tpu_torch.pipeline import BatchedPipeline
    from strongsort_yolo_tpu_torch.track.bytetrack import ByteTrackConfig

    h, w = 1080, 1920
    pool = make_frames(h, w, seed=2)
    ticks = [np.stack([pool[(s + t) % len(pool)] for s in range(S_MAIN)])
             for t in range(TICKS)]
    tracker = ByteTrackConfig(tracker_type="botsort", gmc_method="none")
    runs = {}
    for label, model, route in (("yolo11n-pose", "yolo11n-pose", False),
                                ("yolo11n-pose conv_kernel", "yolo11n-pose", True),
                                ("yolov8n-seg", "yolov8n-seg", False)):
        task = "pose" if "pose" in model else "segment"
        pipe = _main_pipeline(tracker, pool, model=model, conv_kernel=route)
        polygon_ms, rows = [], []

        def record(bp, results):
            if task == "segment":
                t0 = time.perf_counter()
                polys = [r.masks.xy for r in results]
                polygon_ms.append((time.perf_counter() - t0) * 1e3)
                if any(len(p) != len(r) for p, r in zip(polys, results)):
                    raise AssertionError(f"{label}: a polygon list per mask")
                rows.append(sum(len(q) > 0 for p in polys for q in p))

        ks = kernels + ((conv_act,) if route else ())
        counts, times, results = _drive(BatchedPipeline(pipe, S_MAIN, (h, w)),
                                        ticks, ks, record)
        for name, n in counts.items():
            if n == 0:
                raise AssertionError(f"{label} path never launched {name}")
        picks = k7_picks(model)
        if route and counts["conv_act"] != len(picks) * TICKS:
            raise AssertionError(
                f"{label}: K7 launched {counts['conv_act']} times in {TICKS} "
                f"ticks, not {len(picks)} per tick")
        tracks = _check_results(label, results)
        n_rows = _check_task_results(label, results, task)
        median = sorted(times[2:])[len(times[2:]) // 2]
        runs[label] = (counts, median, pipe)
        log(f"{label} path: 640 bf16, S={S_MAIN} 1080p, botsort gmc none; "
            f"launches over {TICKS} ticks: {counts}"
            + (f" ({len(picks)} convs picked by the K7 rule per forward)"
               if route else "")
            + f"; active tracks per stream {tracks}, {n_rows} rows with "
            f"{'keypoints' if task == 'pose' else 'masks'} on the last tick")
        log(f"{label} ms/tick (S={S_MAIN}, 1080p, host clock, synchronized): "
            f"{_ms_line(times)} [{card}]")
        if not route:
            _extras_split(label, pipe, ticks[-1], results, card)
        if task == "segment":
            if sum(rows) == 0:
                raise AssertionError(f"{label}: no polygon traced")
            log(f"{label} host polygons (traced when .masks.xy is read, after "
                f"the tick): ms per tick {[round(v, 2) for v in polygon_ms]}, "
                f"median {sorted(polygon_ms)[len(polygon_ms) // 2]:.2f}; "
                f"nonempty polygons per tick {rows} [{card}]")
    off, on = runs["yolo11n-pose"], runs["yolo11n-pose conv_kernel"]
    fwd = (_forward_ms(off[2], ticks[-1]), _forward_ms(on[2], ticks[-1]))
    log(f"yolo11n-pose median ms/tick: route off {off[1]:.2f}, conv_kernel "
        f"{on[1]:.2f}; model forward on one S={S_MAIN} batch (CUDA events "
        f"around 20 host launches / device time of a CUDA graph of them): "
        f"cuDNN convs {fwd[0][0]:.4f} / {fwd[0][1]:.4f} ms, K7 route "
        f"{fwd[1][0]:.4f} / {fwd[1][1]:.4f} ms [{card}]")
    return on[0]


TASK_KPT_BGR = [(0, 0, 255), (0, 255, 0), (255, 0, 0), (0, 255, 255),
                (255, 0, 255)]


def render_task(task: str, num_frames: int, streams: int, seed: int) -> np.ndarray:
    """(T, S, 320, 320, 3) uint8 BGR: per stream two objects moving a few
    px per frame on noise; ellipses of the class-1 shade for a segment
    model, boxes of the class-0 shade with five coloured dots for a pose
    model, the scenes the synth160 task checkpoints were trained on."""
    rng = np.random.default_rng(seed)
    size = 320
    yy, xx = np.mgrid[0:size, 0:size]
    out = np.empty((num_frames, streams, size, size, 3), np.uint8)
    for s in range(streams):
        objs = [(rng.uniform(60, 110) + 140 * i, rng.uniform(60, 250),
                 rng.uniform(-4, 4), rng.uniform(-4, 4)) for i in range(2)]
        dots = rng.uniform(0.15, 0.85, (5, 2))
        for t in range(num_frames):
            f = (rng.uniform(0, 0.3, (size, size, 3)) * 255).astype(np.uint8)
            for cx, cy, vx, vy in objs:
                cx, cy = cx + vx * t, cy + vy * t
                if task == "segment":
                    f[((xx - cx) / 48) ** 2 + ((yy - cy) / 34) ** 2 <= 1] = 168
                else:
                    x1, y1 = int(cx - 50), int(cy - 40)
                    f[y1:y1 + 80, x1:x1 + 100] = 127
                    for (u, v), color in zip(dots, TASK_KPT_BGR):
                        ix, iy = int(x1 + u * 100), int(y1 + v * 80)
                        f[iy - 4:iy + 5, ix - 4:ix + 5] = color
            out[t, s] = f
    return out


def phase_trained_tasks(conv_act) -> None:
    """The trained task checkpoints through BatchedPipeline with ByteTrack,
    on the card with the kernels and on the CPU with the plain versions
    (float32, TF32 off), the K7 route off and on: equal rows and ids,
    boxes and keypoints within 1e-3 px, equal mask polygons."""
    from strongsort_yolo_tpu_torch.config import DetectorConfig
    from strongsort_yolo_tpu_torch.pipeline import BatchedPipeline, Pipeline

    S, T = 2, 10
    for name, path in TASK_CKPTS.items():
        task = "segment" if "seg" in name else "pose"
        clip = render_task(task, T, S, seed=len(name))
        for route in (False, True):
            outs = {}
            conv_act.launches = 0
            for device in ("cuda", "cpu"):
                pipe = Pipeline(
                    DetectorConfig(weights=path, imgsz=160, half=False,
                                   max_det=16),
                    tracker="bytetrack.yaml", track_slots=16,
                    tracker_max_dets=16, conv_kernel=route, device=device,
                )
                bp = BatchedPipeline(pipe, S, (320, 320))
                outs[device] = [bp.step(clip[t]) for t in range(T)]
            if (conv_act.launches > 0) != route:
                raise AssertionError(f"{name}: K7 launched {conv_act.launches} "
                                     f"times with conv_kernel={route}")
            rows = polys = 0
            for t in range(T):
                for s in range(S):
                    a, b = outs["cpu"][t][s], outs["cuda"][t][s]
                    what = f"{name} conv_kernel={route} t={t} s={s}"
                    if len(a) != len(b):
                        raise AssertionError(f"{what}: {len(b)} rows vs {len(a)}")
                    np.testing.assert_allclose(b.boxes.xyxy, a.boxes.xyxy,
                                               atol=1e-3, err_msg=what)
                    np.testing.assert_array_equal(b.boxes.id, a.boxes.id)
                    if task == "pose":
                        np.testing.assert_allclose(
                            b.keypoints.xy, a.keypoints.xy, atol=1e-3,
                            err_msg=what)
                    else:
                        for pa, pb in zip(a.masks.xy, b.masks.xy):
                            np.testing.assert_array_equal(pb, pa, err_msg=what)
                            polys += len(pa) > 0
                    rows += len(a)
            if rows < S * 2 * (T - 2) or (task == "segment" and polys == 0):
                raise AssertionError(f"{name}: only {rows} track rows")
            log(f"trained task checkpoint {name} (imgsz 160, f32, TF32 off, "
                f"conv_kernel={route}, K7 launches on the card "
                f"{conv_act.launches}): card == CPU on {S}x{T} frames, {rows} "
                f"track rows, same ids, boxes"
                + (" and keypoints" if task == "pose" else "")
                + " within 1e-3"
                + (f", {polys} polygons equal" if task == "segment" else ""))


# the values the JAX package's tests cite beside each bar of Queue C's
# four (its own measurement where the test states one, else the bar)
BAR_CITED = {
    "seg": "JAX test tests/test_trained_seg_pose.py: bar IoU > 0.75 and > "
           "the box's (no value cited)",
    "pose": "JAX test tests/test_trained_seg_pose.py: bar mean error < 10 "
            "px, mean conf > 0.5 (no value cited)",
    "e2e": "JAX test tests/test_trained_e2e.py: bar MOTA > 0.8, IDF1 > 0.8, "
           "0 id switches (no value cited)",
    "bounce": "JAX test tests/test_reid_quality.py: bar IDF1 > 0.73, id "
              "switches <= 3; motion-only IDF1 0.697, 4 id switches",
}


def phase_quality_bars(card: str) -> None:
    """Queue C's four quality bars on the card, each in its CPU test's
    configuration (device="cuda", float32, TF32 off), asserted as the CPU
    test asserts it, each metric printed beside the CPU's (the same
    configuration, device="cpu", in this run) and what the JAX test
    cites: the trained yolov8n-seg's mask on the ellipse frame (IoU with
    the ellipse > 0.75 and above the box's, the box's corner within 16
    px), the trained yolov8n-pose and yolo11n-pose on the dots frame
    (mean keypoint error < 10 px, mean keypoint conf > 0.5), the trained
    detector end to end on SyntheticDetSource (ByteTrack: MOTA > 0.8,
    IDF1 > 0.8, no id switch; three or more detections, classes 0-2) and
    StrongSORT + the trained OSNet through the occlusion bounce (IDF1 >
    0.73, at most 3 id switches). The frames are the port's copies
    (media/video: ellipse_frame, dots_frame, BounceClip,
    SyntheticDetSource)."""
    from strongsort_yolo_tpu_torch.config import DetectorConfig
    from strongsort_yolo_tpu_torch.media.video import (
        BounceClip, SyntheticDetSource, dots_frame, ellipse_frame,
    )
    from strongsort_yolo_tpu_torch.pipeline import Pipeline
    from strongsort_yolo_tpu_torch.track.strongsort import StrongSortConfig
    from strongsort_yolo_tpu_torch.utils.metrics import (
        pose_bar, seg_bar, track_clip,
    )

    det = dict(imgsz=160, conf=0.3, iou=0.4, half=False)

    def task_pipe(name, device):
        return Pipeline(DetectorConfig(weights=TASK_CKPTS[name], max_det=8,
                                       **det),
                        track_slots=8, tracker_max_dets=8, device=device)

    bad = []
    t0 = time.perf_counter()
    frame, ell, box = ellipse_frame()
    seg = {d: seg_bar(task_pipe("yolov8n_seg_synth160", d).predict(frame),
                      ell, box) for d in ("cuda", "cpu")}
    if not all(v["rows"] for v in seg.values()):
        raise AssertionError(f"bar seg: no detection {seg}")
    m = seg["cuda"]
    log(f"bar seg (yolov8n_seg_synth160, ellipse frame): card IoU with the "
        f"ellipse {m['iou_ell']:.4f}, with the box {m['iou_box']:.4f}, box "
        f"corner off by {m['box_err']:.2f} px; CPU {seg['cpu']['iou_ell']:.4f}"
        f", {seg['cpu']['iou_box']:.4f}, {seg['cpu']['box_err']:.2f}; "
        f"{BAR_CITED['seg']} [{card}]")
    if not (m["points"] >= 3 and m["iou_ell"] > 0.75
            and m["iou_ell"] > m["iou_box"] and m["box_err"] < 16):
        bad.append(f"seg {m}")
    frame, gt = dots_frame()
    for name in ("yolov8n_pose_synth160", "yolo11n_pose_synth160"):
        pose = {d: pose_bar(task_pipe(name, d).predict(frame), gt)
                for d in ("cuda", "cpu")}
        if not all(v["rows"] for v in pose.values()):
            raise AssertionError(f"bar pose {name}: no detection {pose}")
        m = pose["cuda"]
        log(f"bar pose ({name}, dots frame): card mean keypoint error "
            f"{m['err']:.4f} px, mean conf {m['conf']:.4f}; CPU "
            f"{pose['cpu']['err']:.4f}, {pose['cpu']['conf']:.4f}; "
            f"{BAR_CITED['pose']} [{card}]")
        if not (m["shape"] == (5, 2) and m["err"] < 10.0 and m["conf"] > 0.5):
            bad.append(f"pose {name} {m}")
    for label, tracker, reid, clip in (
        ("e2e", "bytetrack.yaml", None,
         lambda: SyntheticDetSource(num_frames=30, size=(320, 320),
                                    num_objects=3, seed=1)),
        ("bounce", StrongSortConfig(gmc_method="none", max_age=60), OSNET,
         BounceClip),
    ):
        out = {}
        for device in ("cuda", "cpu"):
            pipe = Pipeline(DetectorConfig(weights=CKPT, max_det=16, **det),
                            tracker=tracker, track_slots=16,
                            tracker_max_dets=16, reid_weights=reid,
                            device=device)
            out[device] = track_clip(pipe, clip())
            if label == "e2e":
                pred = pipe.predict(np.asarray(next(iter(clip()))))
                out[device]["dets"] = len(pred)
                out[device]["classes"] = sorted(
                    set(pred.boxes.cls.astype(int).tolist()))
        m, c = out["cuda"], out["cpu"]
        log(f"bar {label} (yolov8n_synth160"
            + (" + StrongSORT + trained OSNet, BounceClip" if reid else
               " + ByteTrack, SyntheticDetSource 30 frames")
            + f"): card MOTA {m['mota']:.4f} IDF1 {m['idf1']:.4f} id "
            f"switches {m['idsw']}"
            + (f", {m['dets']} detections of classes {m['classes']}"
               if label == "e2e" else "")
            + f"; CPU MOTA {c['mota']:.4f} IDF1 {c['idf1']:.4f} id switches "
            f"{c['idsw']}; {BAR_CITED[label]} [{card}]")
        if label == "e2e" and not (
                m["mota"] > 0.8 and m["idf1"] > 0.8 and m["idsw"] == 0
                and m["dets"] >= 3 and set(m["classes"]) <= {0, 1, 2}):
            bad.append(f"e2e {m}")
        if label == "bounce" and not (m["idf1"] > 0.73 and m["idsw"] <= 3):
            bad.append(f"bounce {m}")
    if bad:
        raise AssertionError("quality bars on the card: " + "; ".join(bad))
    log(f"Queue C's four bars met on the card ({time.perf_counter() - t0:.1f}"
        f" s, both devices)")


def phase_trained_checkpoint():
    from strongsort_yolo_tpu_torch.config import DetectorConfig
    from strongsort_yolo_tpu_torch.pipeline import BatchedPipeline, Pipeline
    from strongsort_yolo_tpu_torch.track.bytetrack import ByteTrackConfig
    from strongsort_yolo_tpu_torch.track.strongsort import StrongSortConfig

    S, T = 2, 20
    streams = [render_synthetic(T, seed=s + 1) for s in range(S)]
    frames = np.stack([np.stack(f) for f in streams], axis=1)  # (T, S, ...)
    # the same streams under a camera pan of (4, -3) and (-3, 2) px/frame
    panned = np.stack([
        np.stack([np.roll(frames[t, s], (t * dy, t * dx), axis=(0, 1))
                  for s, (dx, dy) in enumerate([(4, -3), (-3, 2)])])
        for t in range(T)])
    # StrongSORT confirms a track at its third hit, ByteTrack and BoT-SORT
    # at their second
    for name, tracker, reid, confirm, clip in (
        ("bytetrack", "bytetrack.yaml", None, 2, frames),
        ("strongsort + trained osnet", StrongSortConfig(gmc_method="none"),
         OSNET, 3, frames),
        ("strongsort + trained osnet, fused",
         StrongSortConfig(gmc_method="none"), OSNET, 3, frames),
        ("strongsort + osnet_x1_0 (seeded), fused",
         StrongSortConfig(gmc_method="none"), "osnet_x1_0", 3, frames),
        ("bytetrack, 256 slots x 256 tracker dets", "bytetrack.yaml", None, 2,
         frames),
        ("botsort flow_tpu, panned", ByteTrackConfig(
            tracker_type="botsort", gmc_method="flow_tpu"), None, 2, panned),
    ):
        outs, warps = {}, {}
        crowd = "256" in name  # K3's global-scratch form on the card
        for device in ("cuda", "cpu"):
            pipe = Pipeline(
                DetectorConfig(weights=CKPT, imgsz=160, half=False,
                               max_det=256 if crowd else 16),
                tracker=tracker, track_slots=256 if crowd else 16,
                tracker_max_dets=256 if crowd else 16,
                reid_weights=reid, reid_fused=name.endswith("fused"),
                device=device,
            )
            bp = BatchedPipeline(pipe, S, (320, 320))
            outs[device], warps[device] = [], []
            for t in range(T):
                outs[device].append(bp.step(clip[t]))
                if bp.last_warps is not None:
                    warps[device].append(bp.last_warps.cpu().numpy())
        if warps["cpu"]:  # the LK sums run in another order on the card
            np.testing.assert_allclose(warps["cuda"], warps["cpu"], atol=2e-3)
        rows = 0
        for t in range(T):
            for s in range(S):
                a, b = outs["cpu"][t][s].boxes, outs["cuda"][t][s].boxes
                if len(a) != len(b):
                    raise AssertionError(
                        f"{name} t={t} s={s}: {len(b)} rows vs {len(a)}")
                np.testing.assert_allclose(b.xyxy, a.xyxy, atol=1e-3)
                np.testing.assert_array_equal(b.id, a.id)
                rows += len(a)
        if rows < S * 3 * (T - confirm):
            raise AssertionError(f"{name}: only {rows} track rows")
        log(f"trained checkpoint, {name} (synth160, imgsz 160, f32, TF32 "
            f"off): card == CPU on {S}x{T} frames, {rows} track rows, same "
            f"ids, boxes within 1e-3"
            + (", warps within 2e-3" if warps["cpu"] else ""))


# ultralytics-format .pt files, written from the port's models

ULTRALYTICS_PATHS = ("ultralytics", "ultralytics.nn", "ultralytics.nn.tasks",
                     "ultralytics.nn.modules", "ultralytics.utils")
_CONV_LEAF = {"w": "conv.weight", "b": "conv.bias", "bn_scale": "bn.weight",
              "bn_bias": "bn.bias", "bn_mean": "bn.running_mean",
              "bn_var": "bn.running_var"}
_SEQ_LEAF = {"w": "0.weight", "bn_scale": "1.weight", "bn_bias": "1.bias",
             "bn_mean": "1.running_mean", "bn_var": "1.running_var"}
_BARE_LEAF = {"w": "weight", "b": "bias"}


def ultralytics_state_dict(model) -> dict[str, np.ndarray]:
    """The state of a port Yolov5Model or Yolov7Model (unfused) in the
    ultralytics key layout that ``models/porting.load_checkpoint`` reads
    (the inverse of its key maps), OIHW float32 arrays."""
    from strongsort_yolo_tpu_torch.models.porting import _V5_LAYOUT, _V7_IDX
    from strongsort_yolo_tpu_torch.models.yolov5 import Yolov5Model

    out = {}
    for key, value in model.state_dict().items():
        parts = key.split(".")
        top, leaf, mid = parts[0], parts[-1], parts[1:-1]
        if isinstance(model, Yolov5Model):
            base = f"model.{_V5_LAYOUT['head' if top == 'detect' else top]}"
            if top == "detect" and mid[0] == "m":  # bare Conv2d
                name = f"{base}.m.{mid[1]}.{_BARE_LEAF[leaf]}"
            elif top == "detect":  # u towers: box -> cv2, cls -> cv3
                tower = {"box": "cv2", "cls": "cv3"}[mid[0]]
                step = {"a": "0", "b": "1", "out": "2"}[mid[2]]
                sub = _BARE_LEAF if step == "2" else _CONV_LEAF
                name = f"{base}.{tower}.{mid[1]}.{step}.{sub[leaf]}"
            else:
                name = ".".join([base, *mid, _CONV_LEAF[leaf]])
        else:
            idx = _V7_IDX[top]
            if top == "detect":
                name = f"model.{idx}.m.{mid[1]}.{_BARE_LEAF[leaf]}"
            elif top.startswith("rep"):
                branch = {"dense": "rbr_dense", "one": "rbr_1x1"}[mid[0]]
                name = f"model.{idx}.{branch}.{_SEQ_LEAF[leaf]}"
            elif top.startswith("elan"):
                cv1, cv2, inner, merge = idx
                i = {"cv1": cv1, "cv2": cv2, "merge": merge}.get(mid[0])
                i = inner[int(mid[1])] if i is None else i
                name = f"model.{i}.{_CONV_LEAF[leaf]}"
            elif top.startswith("mp"):
                i = idx[("cv1", "cv2", "cv3").index(mid[0])]
                name = f"model.{i}.{_CONV_LEAF[leaf]}"
            elif top == "sppcspc":
                name = f"model.{idx}.{mid[0]}.{_CONV_LEAF[leaf]}"
            else:
                name = f"model.{idx}.{_CONV_LEAF[leaf]}"
        out[name] = value.detach().float().cpu().numpy()
    return out


def save_ultralytics(path: str, sd: dict, names: dict, *, half: bool = False,
                     args: bool = False) -> None:
    """``torch.save`` of {"model": a DetectionModel whose attribute tree
    spells the keys of ``sd`` (tensors, in half precision with ``half``),
    with ``names`` (and ``args``, an IterableSimpleNamespace, with
    ``args``), "epoch"}: the classes live in ultralytics.nn.tasks,
    ultralytics.nn.modules and ultralytics.utils, modules that exist in
    ``sys.modules`` only while the file is written."""
    import types

    import torch
    from torch import nn

    mods = {p: types.ModuleType(p) for p in ULTRALYTICS_PATHS}
    classes = {}
    for name, base, home in (
            ("DetectionModel", nn.Module, "ultralytics.nn.tasks"),
            ("Block", nn.Module, "ultralytics.nn.modules"),
            ("IterableSimpleNamespace", types.SimpleNamespace,
             "ultralytics.utils")):
        classes[name] = type(name, (base,), {"__module__": home})
        setattr(mods[home], name, classes[name])
    root = classes["DetectionModel"]()
    for key, arr in sd.items():
        *path_, leaf = key.split(".")
        node = root
        for part in path_:
            if part not in node._modules:
                node.add_module(part, classes["Block"]())
            node = node._modules[part]
        t = torch.from_numpy(np.array(arr, np.float32))
        t = t.half() if half else t
        if leaf.startswith("running_") or leaf == "anchor_grid":
            node.register_buffer(leaf, t)
        else:
            node.register_parameter(leaf, nn.Parameter(t, requires_grad=False))
    root.names = dict(names)
    if args:
        root.args = classes["IterableSimpleNamespace"](imgsz=640, task="detect")
    saved = {p: sys.modules.pop(p) for p in ULTRALYTICS_PATHS if p in sys.modules}
    sys.modules.update(mods)
    try:
        torch.save({"model": root, "epoch": -1}, path)
    finally:
        for p in ULTRALYTICS_PATHS:
            del sys.modules[p]
        sys.modules.update(saved)


# the parity runs' head spread: the scores only, a third of HEAD_STD (the
# gain magnifies the float32 differences of the features alike, and
# wh = (2 sig)^2 * anchor would carry them past 1e-3 px)
PARITY_SPREAD = {"obj": 0.5, "cls": 0.5}


def fabricated_checkpoint(name: str, frame: np.ndarray, out_dir: str,
                          seed: int = 0) -> str:
    """An ultralytics-format .pt of ``name`` (yolov5s, yolov7) with seeded
    random weights, its head calibrated on ``frame`` (imgsz 160, about 24
    candidates, PARITY_SPREAD), in ``out_dir``; -> its path."""
    import torch

    from strongsort_yolo_tpu_torch.models.yolo import build_model, detector_family
    from strongsort_yolo_tpu_torch.ops.letterbox import letterbox, letterbox_params

    cfg = build_model(name)
    model = detector_family(cfg)[1](cfg, torch.Generator().manual_seed(seed)).eval()
    lp = letterbox_params(*frame.shape[:2], 160)
    img = letterbox(torch.from_numpy(frame[None]), lp, dtype=torch.float32)
    calibrate_head(model, img, 0.3, 24, PARITY_SPREAD)
    path = os.path.join(out_dir, f"{name}.pt")
    save_ultralytics(path, ultralytics_state_dict(model),
                     {i: f"class{i}" for i in range(cfg.nc)})
    return path


def phase_fabricated_checkpoints() -> None:
    """The fabricated yolov5s and yolov7 .pt files (Pipeline(weights=path))
    on the card with the kernels and on the CPU with the plain versions,
    float32, TF32 off, as phase_trained_checkpoint holds the trained ones:
    equal rows, boxes within 1e-3 px, equal track ids."""
    from strongsort_yolo_tpu_torch.config import DetectorConfig
    from strongsort_yolo_tpu_torch.pipeline import BatchedPipeline, Pipeline
    from strongsort_yolo_tpu_torch.track.strongsort import StrongSortConfig

    S, T = 2, 12
    streams = [render_synthetic(T, seed=s + 1) for s in range(S)]
    frames = np.stack([np.stack(f) for f in streams], axis=1)  # (T, S, ...)
    for name, tracker, reid in (
        ("yolov5s", StrongSortConfig(gmc_method="none"), OSNET),
        ("yolov7", "bytetrack.yaml", None),
    ):
        outs = {}
        with tempfile.TemporaryDirectory() as tmp:
            path = fabricated_checkpoint(name, frames[0, 0], tmp)
            for device in ("cuda", "cpu"):
                pipe = Pipeline(
                    DetectorConfig(weights=path, imgsz=160, half=False,
                                   max_det=16),
                    tracker=tracker, track_slots=16, tracker_max_dets=16,
                    reid_weights=reid, reid_fused=reid is not None,
                    device=device)
                bp = BatchedPipeline(pipe, S, (320, 320))
                outs[device] = [bp.step(frames[t]) for t in range(T)]
        rows = 0
        for t in range(T):
            for s in range(S):
                a, b = outs["cpu"][t][s].boxes, outs["cuda"][t][s].boxes
                if len(a) != len(b):
                    raise AssertionError(
                        f"fabricated {name} t={t} s={s}: {len(b)} rows vs {len(a)}")
                np.testing.assert_allclose(b.xyxy, a.xyxy, atol=1e-3)
                np.testing.assert_array_equal(b.id, a.id)
                rows += len(a)
        if rows == 0:
            raise AssertionError(f"fabricated {name}: no track rows")
        log(f"fabricated {name}.pt (ultralytics format, seeded, head "
            f"calibrated; imgsz 160, f32, TF32 off"
            + (", StrongSORT + trained OSNet fused" if reid else ", ByteTrack")
            + f"): card == CPU on {S}x{T} frames, {rows} track rows, same ids, "
            "boxes within 1e-3")


# the detector paths of phase 3: (label, weights, tracker, fused OSNet, ticks)
DETECTOR_PATHS = (
    ("f", "yolov5s", "strongsort", True, 10),
    ("g", "yolov7", "strongsort", True, 10),
    ("f-u", "yolov5su", "botsort", False, 4),
)


def check_path_crops(label: str, pipe, frames, card: str) -> int:
    """K4 and K6 on one tick's crop batch of a ReID path, at the G that
    tick gives them: K4's crops bit-identical to banded_crop_plain, and,
    where the pipeline's OSNet is fused, each of the three K6 stages, on
    the inputs the OSNet feeds it (captured in one forward), against
    os_stage_plain under k6_error's bars. -> G."""
    import torch

    from strongsort_yolo_tpu_torch.models import osnet
    from strongsort_yolo_tpu_torch.ops.cuda.crop_kernel import (
        banded_crop, banded_crop_plain,
    )
    from strongsort_yolo_tpu_torch.ops.cuda.osnet_kernel import (
        os_stage_plain, stage_form,
    )

    det = pipe.detect(frames)
    # the class's embed_slots: the instance's may be _record_slots' recorder
    slots = type(pipe).embed_slots(pipe, det.count.cpu().numpy())
    calls, real = [], osnet.os_stage

    def recording(x, w, spec):
        out = real(x, w, spec)
        calls.append((x, w, spec, out))
        return out

    with torch.no_grad():
        pyr = pipe.pyramid(frames)
        params = pipe.crop_params(pyr, det,
                                  torch.from_numpy(slots).to(pipe.device))
        crops = banded_crop(pyr, *params)
        if not torch.equal(crops, banded_crop_plain(pyr, *params)):
            raise AssertionError(f"path {label}: K4 on the crop batch (G="
                                 f"{crops.shape[0]}) differs from its plain "
                                 "version")
        osnet.os_stage = recording
        try:
            feats = pipe.reid(crops)
        finally:
            osnet.os_stage = real
    fused = pipe.reid._stages is not None
    if len(calls) != 3 * fused or not torch.isfinite(feats).all():
        raise AssertionError(f"path {label}: {len(calls)} K6 stages, or "
                             "non-finite embeddings")
    g, parts = crops.shape[0], []
    if not fused:
        log(f"path {label}: K4 on one tick's crop batch (G={g}) "
            f"bit-identical to banded_crop_plain; OSNet unfused [{card}]")
        return g
    for i, (x, w, spec, got) in enumerate(calls):
        form = stage_form(spec, x.dtype)
        name = (f"path {label} K6 stage {i + 2} {tuple(x.shape)} {x.dtype} "
                f"({form})")
        err, scaled, share, mean = k6_error(name, got, os_stage_plain(x, w, spec),
                                            form)
        parts.append(f"stage {i + 2} ({form}) max |err| {err:.3g}, scaled "
                     f"{scaled:.3g}, mean {mean:.3g} of the largest output, "
                     f"{share:.3%} differ")
    log(f"path {label}: K4 on one tick's crop batch (G={g}) bit-identical to "
        f"banded_crop_plain; K6 against os_stage_plain: " + "; ".join(parts)
        + f" [{card}]")
    return g


def phase_detector_paths(card: str, kernels: dict) -> None:
    """The v5 and v7 detector paths at full width (S=8 1080p, imgsz 640,
    bf16, BN fused, v7 deployed): yolov5s (classic head) and yolov7 with
    StrongSORT + OSNet-x0_25 fused (K1-K4 and K6, K4 once and K6 three
    times per tick), yolov5su with BoT-SORT, gmc none (K1-K3); each with
    its launch counts, ms/tick, the forward by CUDA events and the NMS
    (ranking, K2's keep mask and the selection) on the last tick's model
    outputs; on f and g, G per tick, and K4 and K6 held against their
    plain versions on the last tick's crop batch (check_path_crops)."""
    import torch

    from strongsort_yolo_tpu_torch.models.yolo import feat_hw
    from strongsort_yolo_tpu_torch.ops.letterbox import letterbox, letterbox_params
    from strongsort_yolo_tpu_torch.ops.nms import nms_from_logits, non_max_suppression
    from strongsort_yolo_tpu_torch.pipeline import BatchedPipeline
    from strongsort_yolo_tpu_torch.track.bytetrack import ByteTrackConfig
    from strongsort_yolo_tpu_torch.track.strongsort import StrongSortConfig

    pool = make_frames(1080, 1920, seed=4)
    h, w = pool[0].shape[:2]
    for label, weights, kind, fused, n_ticks in DETECTOR_PATHS:
        reid = kind == "strongsort"
        tracker = (StrongSortConfig(gmc_method="none") if reid else
                   ByteTrackConfig(tracker_type="botsort", gmc_method="none"))
        path_kernels = [kernels[k] for k in ("letterbox_u8", "nms_keep", "auction")]
        if reid:
            path_kernels += [kernels["banded_crop"], kernels["os_stage"]]
        pipe = _main_pipeline(tracker, pool, fused=fused, model=weights)
        ticks = [np.stack([pool[(s + t) % len(pool)] for s in range(S_MAIN)])
                 for t in range(n_ticks)]
        dets = pipe.detect(to_card(ticks[0])).count.cpu().numpy()
        slot_counts = _record_slots(pipe) if reid else []
        counts, times, results = _drive(
            BatchedPipeline(pipe, S_MAIN, (h, w)), ticks, path_kernels)
        for name, n in counts.items():
            if n == 0:
                raise AssertionError(f"path {label} never launched {name}")
        if reid and (counts["os_stage"] != 3 * n_ticks
                     or counts["banded_crop"] != n_ticks):
            raise AssertionError(
                f"path {label}: K6 launched {counts['os_stage']} and K4 "
                f"{counts['banded_crop']} times in {n_ticks} ticks")
        tracks = _check_results(f"path {label}", results)
        if reid:
            g = check_path_crops(label, pipe, to_card(ticks[-1]), card)
            log(f"path {label} crop slots G per tick: {slot_counts}; the "
                f"last tick's batch held against the plain versions: G={g}")
        cfg, det_cfg = pipe.model_cfg, pipe.det_cfg
        lp = letterbox_params(h, w, det_cfg.imgsz)
        img = letterbox(to_card(ticks[-1]), lp, dtype=pipe.compute_dtype)
        nms_kw = dict(conf_thres=det_cfg.conf, iou_thres=det_cfg.iou,
                      max_det=det_cfg.max_det, agnostic=det_cfg.agnostic_nms)
        with torch.no_grad():
            out = pipe.model(img)
            forward_ms = cuda_ms(lambda: pipe.model(img))
            if "boxes" in out:
                def nms():
                    return non_max_suppression(out["boxes"], out["scores"],
                                               **nms_kw)
                anchors = out["boxes"].shape[1]
            else:
                size = det_cfg.imgsz
                def nms():
                    return nms_from_logits(
                        out["box_logits"], out["cls_logits"],
                        feat_dims=feat_hw((size, size), cfg.strides),
                        level_strides=cfg.strides, reg_max=cfg.reg_max,
                        **nms_kw)
                anchors = out["cls_logits"].shape[1]
            nms_ms = cuda_ms(nms)
        dtype = "bf16" if det_cfg.half else "f32"
        log(f"path {label}: {weights} {det_cfg.imgsz} {dtype} (BN fused"
            + (", RepConv deployed" if weights == "yolov7" else "")
            + f"), S={S_MAIN} {h}x{w}, "
            + ("strongsort + osnet_x0_25 fused" if reid else "botsort gmc none")
            + f"; detections per frame {dets.tolist()}; launches over "
            f"{n_ticks} ticks: {counts}; active tracks per stream {tracks}")
        log(f"path {label} ms/tick (S={S_MAIN}, {h}x{w}, host clock, "
            f"synchronized): {_ms_line(times)}; forward {forward_ms:.4f} ms, "
            f"NMS (ranking + K2 + select) on {anchors} anchors per frame "
            f"{nms_ms:.4f} ms (CUDA events, mean of 20) [{card}]")


def _stats(times: list[float]) -> tuple[float, float]:
    """(median, p90) of host ms per tick."""
    return float(np.median(times)), float(np.percentile(times, 90))


def _step_loop(bp, ticks, warps=None):
    """``step`` tick by tick: -> (host ms per tick, Results per tick)."""
    times, results = [], []
    for frames in ticks:
        t0 = time.perf_counter()
        results.append(bp.step(frames, warps))
        times.append((time.perf_counter() - t0) * 1e3)
    return times, results


def _overlapped_loop(bp, ticks, warps=None):
    """The app's loop: step_async(t), then materialize(t - 1). -> (host ms
    per turn of the loop, host ms of each step_async, host ms of each
    fill of the ring's host slot, Results per tick)."""
    times, dispatch, fills, results, pending = [], [], [], [], None
    for frames in ticks:
        t0 = time.perf_counter()
        handle = bp.step_async(frames, warps)
        dispatch.append((time.perf_counter() - t0) * 1e3)
        fills.append(bp.ring.fill_ms)
        if pending is not None:
            results.append(bp.materialize(pending))
        pending = handle
        times.append((time.perf_counter() - t0) * 1e3)
    results.append(bp.materialize(pending))
    return times, dispatch, fills, results


def _assert_identical(label: str, want, got) -> None:
    """Two runs' Results bit for bit: rows, boxes, scores, classes, ids,
    keypoints and masks."""
    for t, (w_t, g_t) in enumerate(zip(want, got)):
        for s, (a, b) in enumerate(zip(w_t, g_t)):
            what = f"{label} t={t} s={s}"
            if len(a) != len(b):
                raise AssertionError(f"{what}: {len(b)} rows against {len(a)}")
            for name in ("xyxy", "conf", "cls", "id"):
                if not np.array_equal(getattr(a.boxes, name),
                                      getattr(b.boxes, name)):
                    raise AssertionError(f"{what}: boxes.{name} differ")
            for name in ("keypoints", "masks"):
                x, y = getattr(a, name), getattr(b, name)
                if (x is None) != (y is None) or (
                        x is not None and not np.array_equal(x.data, y.data)):
                    raise AssertionError(f"{what}: {name} differ")


def busy_share(run) -> tuple[float, float] | None:
    """Run ``run()`` under torch.profiler -> (device busy ms, the loop's
    wall ms): the union of the kernels' and copies' spans on the card,
    all streams together; None where the profiler saw no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    if not spans:
        return None
    busy, end = 0.0, -math.inf
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy / 1e3, wall


def _upload_split(frames: np.ndarray, fill_ms: list[float], card: str) -> None:
    """One tick's frames: the old pageable copy (.to(), synchronized host
    clock, and CUDA events) against the ring's parts, the host's fill of
    a pinned slot (PyTorch's threaded CPU copy, measured in the
    overlapped loop; one thread's np.copyto beside it) and the pinned
    slot's copy to the card (CUDA events)."""
    import torch

    dev = torch.device("cuda")
    host = torch.from_numpy(frames)
    pageable = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        host.to(dev)
        torch.cuda.synchronize()
        pageable.append((time.perf_counter() - t0) * 1e3)
    pinned = torch.empty(host.shape, dtype=torch.uint8, pin_memory=True)
    one_thread = []
    for _ in range(5):
        t0 = time.perf_counter()
        np.copyto(pinned.numpy(), frames)
        one_thread.append((time.perf_counter() - t0) * 1e3)
    slot = torch.empty(host.shape, dtype=torch.uint8, device=dev)
    copy_ms = cuda_ms(lambda: slot.copy_(pinned, non_blocking=True), iters=10)
    mb = host.numel() / 1e6
    log(f"upload of {tuple(host.shape)} u8 ({mb:.1f} MB): pageable .to() "
        f"{float(np.median(pageable)):.3f} ms (synchronized host clock, "
        f"median of 5), {cuda_ms(lambda: host.to(dev), iters=5, warmup=1):.3f}"
        f" ms by events; the ring: the fill of a pinned slot "
        f"{float(np.median(fill_ms)):.3f} ms on the host ({torch.get_num_threads()}"
        f" threads, median over the overlapped loop; np.copyto on one "
        f"thread {float(np.median(one_thread)):.3f}), its copy to the card "
        f"{copy_ms:.3f} ms by events "
        f"({mb / copy_ms:.1f} GB/s), on the upload stream beside the previous "
        f"tick [{card}]")


def phase_async_paths(card: str) -> None:
    """The asynchronous API at full width, S=8 1080p, on paths a
    (BoT-SORT, gmc none), b-fused (StrongSORT + fused OSNet-x0_25), c
    (BoT-SORT flow_tpu, panned) and e (yolov8n-seg): the step loop and
    the overlapped loop (step_async t, then materialize t - 1) in turns
    (step, overlapped, overlapped, step), each from fresh streams, their
    Results bit-identical; ms per tick (median, p90) of both loops and
    the host ms of step_async; the sync check (no synchronizing op in the
    overlapped ticks; the ReID count read is the one host wait, counted
    and timed); the device's busy share under torch.profiler for both
    loops; and on path a the upload split."""
    import torch

    from strongsort_yolo_tpu_torch.pipeline import BatchedPipeline
    from strongsort_yolo_tpu_torch.tools.sync_count import count_syncs
    from strongsort_yolo_tpu_torch.track.bytetrack import ByteTrackConfig
    from strongsort_yolo_tpu_torch.track.strongsort import StrongSortConfig

    h, w = 1080, 1920
    botsort = ByteTrackConfig(tracker_type="botsort", gmc_method="none")
    scene = panned_scene(h, w)
    paths = (
        ("a", botsort, {}, make_frames(h, w)),
        ("b-fused", StrongSortConfig(gmc_method="none"), dict(fused=True),
         make_frames(h, w, seed=1)),
        ("c", ByteTrackConfig(tracker_type="botsort", gmc_method="flow_tpu"),
         {}, [scene]),
        ("e", botsort, dict(model="yolov8n-seg"), make_frames(h, w, seed=2)),
    )
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        for label, tracker, kw, pool in paths:
            pipe = _main_pipeline(tracker, pool, **kw)
            if label == "c":
                ticks = [np.stack([np.roll(scene, (t * dy, t * dx), axis=(0, 1))
                                   for dx, dy in PANS]) for t in range(TICKS)]
            else:
                ticks = [np.stack([pool[(s + t) % len(pool)]
                                   for s in range(S_MAIN)]) for t in range(TICKS)]
            step_ms, over_ms, dispatch, fill = [], [], [], []
            runs, waits, wait_ms, stalls = {}, 0, 0.0, 0
            for mode in ("step", "overlapped", "overlapped", "step"):
                bp = BatchedPipeline(pipe, S_MAIN, (h, w))
                if mode == "step":
                    times, results = _step_loop(bp, ticks)
                    step_ms += times[2:]
                else:
                    before = (pipe.count_waits, pipe.count_wait_ms)
                    times, disp, fills, results = _overlapped_loop(bp, ticks)
                    waits += pipe.count_waits - before[0]
                    wait_ms += pipe.count_wait_ms - before[1]
                    over_ms += times[2:]
                    dispatch += disp[2:]
                    fill += fills[2:]
                    stalls += bp.ring.stalls
                if mode in runs:
                    _assert_identical(f"async {label} {mode} rounds",
                                      runs[mode], results)
                else:
                    runs[mode] = results
            _assert_identical(f"async {label}: step loop against overlapped",
                              runs["step"], runs["overlapped"])
            _check_results(f"async {label}", runs["step"][-1])
            (sm, sp), (om, op) = _stats(step_ms), _stats(over_ms)
            dm = float(np.median(dispatch))
            log(f"async path {label} (S={S_MAIN} 1080p, {TICKS} ticks x 2 "
                f"rounds each, in turns): step loop ms/tick median {sm:.2f}, "
                f"p90 {sp:.2f}; overlapped loop median {om:.2f}, p90 "
                f"{op:.2f}; step_async's host ms median {dm:.2f}, the host "
                f"waited for a ring slot {stalls} times; Results "
                f"bit-identical across the four rounds; steady ticks, step "
                f"{[round(x, 2) for x in step_ms]}, overlapped "
                f"{[round(x, 2) for x in over_ms]} [{card}]")
            before = pipe.count_waits
            fresh = BatchedPipeline(pipe, S_MAIN, (h, w))
            sites = count_syncs(lambda: _overlapped_loop(fresh, ticks[:4]),
                                ROOT)
            n_waits = pipe.count_waits - before
            if sites:
                raise AssertionError(f"async path {label}: synchronizing ops "
                                     f"in the overlapped ticks: {dict(sites)}")
            if n_waits != 4 * (pipe.reid is not None):
                raise AssertionError(f"async path {label}: {n_waits} count "
                                     "waits in 4 ticks")
            msg = ""
            if pipe.reid is not None:
                msg = (f"; the ReID count read, the one host wait: "
                       f"{wait_ms / waits:.3f} ms per tick blocked, mean of "
                       f"the {waits} overlapped ticks")
            log(f"async path {label} sync check: no synchronizing op in 4 "
                f"overlapped ticks under set_sync_debug_mode('warn'), "
                f"{n_waits} count waits{msg} [{card}]")
            shares = {}
            for mode, loop in (("step", _step_loop),
                               ("overlapped", _overlapped_loop)):
                bp = BatchedPipeline(pipe, S_MAIN, (h, w))
                loop(bp, ticks[:2])  # the fresh ring's first copies
                shares[mode] = busy_share(lambda: loop(bp, ticks))
            if any(v is None for v in shares.values()):
                log(f"async path {label} device busy share: not measured (the "
                    "profiler recorded no device time)")
            else:
                log(f"async path {label} under torch.profiler, {TICKS} ticks: "
                    + "; ".join(
                        f"{m} loop device busy {b:.2f} of {wall:.2f} ms "
                        f"(share {b / wall:.3f}, idle {1 - b / wall:.3f}), "
                        f"{b / TICKS:.2f} ms of device time per tick"
                        for m, (b, wall) in shares.items())
                    + f"; step_async's host ms median {dm:.2f} [{card}]")
            if label == "a":
                _upload_split(ticks[-1], fill, card)
            del pipe, runs
            torch.cuda.empty_cache()
    finally:
        torch.backends.cudnn.deterministic = deterministic


# -- phase 5: the app and CLI ----------------------------------------------

APP_FRAMES = 12  # frames per stream of the full-width app runs
APP_LINE = "960,0,960,1080"  # the count line of the 1080p app runs


def app_checkpoint(frame: np.ndarray, out_dir: str) -> str:
    """yolov8n with seeded random weights, its class biases calibrated on
    ``frame`` (1080p, imgsz 640) to about TARGET_DETS candidates, as the
    phase 3 paths are, written as an ``.npz`` in ``out_dir``; -> its path."""
    import torch

    from strongsort_yolo_tpu_torch.models.porting import save_npz_checkpoint
    from strongsort_yolo_tpu_torch.models.yolo import build_model, detector_family
    from strongsort_yolo_tpu_torch.ops.letterbox import letterbox, letterbox_params

    cfg = build_model("yolov8n")
    model = detector_family(cfg)[1](
        cfg, torch.Generator().manual_seed(0)).eval().to("cuda")
    lp = letterbox_params(*frame.shape[:2], 640)
    img = letterbox(torch.from_numpy(frame[None]).to("cuda"), lp,
                    dtype=torch.float32)
    calibrate_head(model, img, 0.3, TARGET_DETS)
    path = os.path.join(out_dir, "yolov8n_calibrated.npz")
    save_npz_checkpoint(path, model.state_dict(), cfg)
    return path


def _event_kinds(path: str) -> list[str]:
    with open(path) as f:
        return [json.loads(line)["event"] for line in f]


def _stage_line(stats) -> str:
    st = stats.stage_times or {}
    return ", ".join(f"{k} {v['mean_ms']:.2f} ms x {v['count']}"
                     for k, v in st.items())


def _first_frames(sources) -> np.ndarray:
    """Frame 0 of each source as the app reads it (decoded, for files):
    the app's tick 1."""
    from strongsort_yolo_tpu_torch.app import open_source

    frames = []
    for src in sources:
        reader = open_source(src)[0]
        frames.append(next(iter(reader)))
        getattr(reader, "release", lambda: None)()
    return np.stack(frames)


def _app_path(card: str, label: str, argv: list[str], sources, kernels,
              out_dir: str, files: bool, crops: bool = False) -> list:
    """One full-width app run as ``cli.main`` runs it (``parse_config``,
    ``run``, ``report``): on mp4 files (``sources`` are paths; outputs
    written), else on the in-memory sources with save off. One pipeline,
    built by ``make_pipeline`` as ``run`` builds it, serves a warm-up run
    of 2 frames and then the measured run of APP_FRAMES, launch counts
    zeroed just before it and read just after; its stage means are over
    all its ticks, the first included. Every stream must reach APP_FRAMES
    frames without an error; the event log's kinds checked. With
    ``crops``, G is recorded per tick, and K4 and K6 are held against
    their plain versions on tick 1's crop batch (check_path_crops), whose
    G must be the app's."""
    from strongsort_yolo_tpu_torch import cli
    from strongsort_yolo_tpu_torch.app import make_pipeline, run

    events = os.path.join(out_dir, "events.jsonl")
    cfg = cli.parse_config(
        (["--source", *sources] if files else ["--no-save"]) + argv
        + ["--output", out_dir, "--log-events", events, "--checkpoint-every",
           "5", "--max-frames", str(APP_FRAMES)])
    srcs = None if files else sources
    pipe = make_pipeline(cfg)

    run(dataclasses.replace(cfg, output_dir=out_dir + "_warm",
                            log_events=None, max_frames=2), srcs, pipe)
    slots = _record_slots(pipe) if crops else []
    for k in kernels:
        k.launches = 0
    t0 = time.perf_counter()
    stats = run(cfg, srcs, pipe)
    wall = time.perf_counter() - t0
    counts = {k.__name__: k.launches for k in kernels}
    how = ("mp4 files, outputs written" if files else
           "in-memory SyntheticSource, save off")
    cli.report(stats)
    log(f"{label}: {how}; {len(stats)} streams x {APP_FRAMES} frames in "
        f"{wall:.2f} s; launches {counts}"
        + (f"; crop slots G per tick {slots}" if crops else "") + f" [{card}]")
    for name, n in counts.items():
        if n == 0:
            raise AssertionError(f"{label}: never launched {name}")
    for i, st in enumerate(stats):
        if st.failed is not None or st.errors or st.frames != APP_FRAMES:
            raise AssertionError(
                f"{label} stream {i}: frames {st.frames}, errors {st.errors}, "
                f"failed {st.failed}")
        log(f"{label} stream {i}: fps {st.mean_fps:.2f}, counts {st.counts}, "
            f"line_counts {st.line_counts}; stages (ms each; decode, stack, "
            f"dispatch, infer_track per tick of the group) {_stage_line(st)} "
            f"[{card}]")
    kinds = _event_kinds(events)
    n = len(stats)
    want = ["stream_start"] * n + ["checkpoint"] * (APP_FRAMES // 5) + [
        "stream_end"] * n
    if kinds != want:
        raise AssertionError(f"{label}: event kinds {kinds}, not {want}")
    log(f"{label}: event kinds {sorted(set(kinds))} as expected "
        f"({len(kinds)} events)")
    if files:
        for st in stats:
            if not os.path.getsize(st.output_video):
                raise AssertionError(f"{label}: empty {st.output_video}")
    if crops:
        g = check_path_crops(label, pipe, to_card(_first_frames(sources)),
                             card)
        if g != slots[0]:
            raise AssertionError(f"{label}: tick 1's crop batch G={g} here, "
                                 f"{slots[0]} in the app's run")
    return stats


def _write_sources(srcs, out_dir: str, num_frames: int = APP_FRAMES):
    """The app's sources (``num_frames`` each) as mp4 files, written by the
    native encoder where it loads, else by cv2, and read back through
    ``app.open_source`` -> (paths, how), or (None, why not)."""
    from strongsort_yolo_tpu_torch.app import open_source
    from strongsort_yolo_tpu_torch.media.native_decoder import (
        NativeVideoWriter,
        encoder_available,
    )
    from strongsort_yolo_tpu_torch.media.video import VideoWriter

    writer = NativeVideoWriter if encoder_available() else VideoWriter
    t0 = time.perf_counter()
    paths = []
    try:
        for s, src in enumerate(srcs):
            paths.append(os.path.join(out_dir, f"cam{s}.mp4"))
            w = writer(paths[-1], src.w, src.h, 30.0)
            for f in src:
                w.write(f)
            w.release()
        write_s = time.perf_counter() - t0
        reader, w, h = open_source(paths[0])
        n = 0 if reader is None else sum(1 for _ in reader)
    except (ImportError, OSError, RuntimeError) as e:
        return None, f"no video files ({type(e).__name__}: {e})"
    if (n, w, h) != (num_frames, srcs[0].w, srcs[0].h):
        return None, f"no video files (read back {n} frames of {w}x{h})"
    return paths, (f"{len(paths)} mp4 files written by "
                   f"{writer.__name__} in {write_s:.2f} s, read back by "
                   f"{type(reader).__name__}")


def _app_cpu_card(out_dir: str, tracker: str, device: str, save: bool,
                  **kw):
    from strongsort_yolo_tpu_torch.app import AppConfig, run
    from strongsort_yolo_tpu_torch.media.video import SyntheticDetSource

    cfg = AppConfig(
        track=True, count=True, weights=CKPT, imgsz=160, max_det=16,
        half=False, tracker=tracker, device=device, output_dir=out_dir,
        count_line=(120.0, 0.0, 120.0, 320.0), save=save,
        log_events=os.path.join(out_dir, "events.jsonl"), **kw)
    srcs = [SyntheticDetSource(num_frames=APP_FRAMES, size=(320, 320),
                               num_objects=3, seed=s) for s in range(2)]
    return run(cfg, sources=srcs)


def _labels_close(want: str, got: str) -> tuple[int, int]:
    """Label files parsed: frame, class and id exact, conf within 0.001,
    coordinates within 1 px -> (rows, fields that differ)."""
    with open(want) as f:
        a_rows = [line.split() for line in f]
    with open(got) as f:
        b_rows = [line.split() for line in f]
    if len(a_rows) != len(b_rows):
        raise AssertionError(f"{got}: {len(b_rows)} rows vs {len(a_rows)}")
    differ = 0
    for a, b in zip(a_rows, b_rows):
        if (a[:3] != b[:3] or abs(float(a[3]) - float(b[3])) > 1e-3 + 1e-9
                or any(abs(int(a[i]) - int(b[i])) > 1 for i in range(4, 8))):
            raise AssertionError(f"{got}: {b} vs {a}")
        differ += sum(x != y for x, y in zip(a[3:8], b[3:8]))
    return len(a_rows), differ


def _ckpt(out_dir: str, name: str):
    import torch

    return torch.load(os.path.join(out_dir, f"{name}_ckpt", "state.pt"),
                      weights_only=True)


LIBAV = {"libavformat": "avformat.h", "libavcodec": "avcodec.h",
         "libswscale": "swscale.h", "libavutil": "avutil.h"}
INCLUDE_DIRS = ("/usr/include", "/usr/local/include",
                "/usr/include/x86_64-linux-gnu")


def libav_probe() -> tuple[bool, str]:
    """Whether this machine could build the libav shims
    (native/video_{decoder,encoder}.cpp): pkg-config's version of each
    libav package and whether its header is in pkg-config's include
    directories or the system's. -> (all four there, the probe's line)."""
    import shutil

    if shutil.which("pkg-config") is None:
        return False, "pkg-config absent"

    def pkg_config(*args):
        return subprocess.run(["pkg-config", *args], capture_output=True,
                              text=True, timeout=30)

    parts, ok = [], True
    for pkg, header in LIBAV.items():
        ver = pkg_config("--modversion", pkg)
        dirs = [f[2:] for f in pkg_config("--cflags-only-I", pkg).stdout
                .split()] + list(INCLUDE_DIRS)
        found = next((d for d in dirs if os.path.exists(
            os.path.join(d, pkg, header))), None)
        ok = ok and ver.returncode == 0 and found is not None
        parts.append(f"{pkg} "
                     + (ver.stdout.strip() if ver.returncode == 0 else "absent")
                     + f", {pkg}/{header} "
                     + (f"in {found}" if found else "not found"))
    return ok, "; ".join(parts)


def phase_app(card: str, kernels: dict) -> None:
    """Phase 5: the media probe, the app and CLI at full width (BoT-SORT
    with flow_tpu, and StrongSORT with flow_tpu + the trained OSNet,
    fused), the app on the card against the CPU, and resume on the
    card."""
    import torch

    from strongsort_yolo_tpu_torch.media import media_status
    from strongsort_yolo_tpu_torch.media.video import SyntheticSource

    status = media_status()
    log(f"media probe: cv2 {status['cv2'] or 'absent'}; libmedia_shim.so "
        f"{status['shim']}; decoder {status['decoder']}; encoder "
        f"{status['encoder']}")
    libav, probe = libav_probe()
    log(f"libav probe (pkg-config, headers): {probe}; "
        + ("the shims could be built here" if libav else
           "the libav shims cannot be built here, files go through cv2"))
    # outputs need an encoder: the native one, else cv2's
    save = status["encoder"] == "loaded" or status["cv2"] is not None
    k = kernels
    with tempfile.TemporaryDirectory() as tmp:
        srcs = [SyntheticSource(num_frames=APP_FRAMES, size=(1080, 1920),
                                num_objects=6, seed=s) for s in range(S_MAIN)]
        weights = app_checkpoint(next(iter(srcs[0])), tmp)
        paths, how = _write_sources(srcs, tmp)
        log(f"app sources: {how}")
        files = paths is not None
        sources = paths if files else srcs
        base = ["--track", "--count", "--count-line", APP_LINE, "--weights",
                weights, "--imgsz", "640"]
        # K5's coverage: a BoT-SORT YAML whose gmc_method is flow_tpu
        flow_yaml = os.path.join(tmp, "botsort_flow_tpu.yaml")
        with open(flow_yaml, "w") as f:
            f.write("tracker_type: botsort\ngmc_method: flow_tpu\n")
        _app_path(card, "app botsort + flow_tpu (a YAML config)",
                  base + ["--tracker", flow_yaml],
                  sources, [k[n] for n in ("letterbox_u8", "nms_keep",
                                           "auction", "lk_pyramid")],
                  os.path.join(tmp, "default"), files)
        # StrongSORT with the fused OSNet and K5 together: a StrongSORT
        # YAML whose gmc_method is flow_tpu (strongsort.yaml's host ECC
        # takes most of a second per 1080p frame, 8 streams in series;
        # phase 8f times it)
        ss_yaml = os.path.join(tmp, "strongsort_flow_tpu.yaml")
        with open(ss_yaml, "w") as f:
            f.write("tracker_type: strongsort\ngmc_method: flow_tpu\n")
        os.environ["SSYT_OSNET"] = "fused"
        try:
            _app_path(card, "app StrongSORT + flow_tpu (a YAML config) + "
                      "trained OSNet, fused",
                      base + ["--tracker", ss_yaml, "--reid-weights", OSNET],
                      sources, list(k.values()),
                      os.path.join(tmp, "ss"), files, crops=True)
        finally:
            del os.environ["SSYT_OSNET"]

        # the app on the card against the CPU (float32, TF32 off)
        for tracker in ("bytetrack.yaml", "botsort.yaml"):
            runs = {}
            for device in ("cuda", "cpu"):
                out = os.path.join(tmp, f"parity_{tracker}_{device}")
                runs[device] = (out, _app_cpu_card(
                    out, tracker, device, save, checkpoint_every=4))
            (c_out, card_st), (p_out, cpu_st) = runs["cuda"], runs["cpu"]
            rows = differ = 0
            for a, b in zip(cpu_st, card_st):
                if (a.frames, a.counts, a.line_counts) != (
                        b.frames, b.counts, b.line_counts):
                    raise AssertionError(
                        f"app {tracker}: card {b.frames} {b.counts} "
                        f"{b.line_counts} vs CPU {a.frames} {a.counts} "
                        f"{a.line_counts}")
                if save:
                    r, d = _labels_close(a.labels_file, b.labels_file)
                    rows, differ = rows + r, differ + d
            if _event_kinds(os.path.join(c_out, "events.jsonl")) != \
                    _event_kinds(os.path.join(p_out, "events.jsonl")):
                raise AssertionError(f"app {tracker}: event kinds differ")
            for name in ("synthetic", "synthetic_1"):
                a, b = _ckpt(p_out, name), _ckpt(c_out, name)
                for field in ("track_id", "status", "next_id", "last_frame"):
                    if not torch.equal(a[field], b[field]):
                        raise AssertionError(f"app {tracker}: checkpoint "
                                             f"{name} {field} differs")
                err = float((a["mean"] - b["mean"]).abs().max())
                if err > 1e-3:
                    raise AssertionError(f"app {tracker}: checkpoint mean "
                                         f"off by {err}")
            log(f"app card == CPU, {tracker}"
                f"{' (host sparseOptFlow)' if tracker == 'botsort.yaml' else ''}"
                f" (synth160, imgsz 160, f32, 2 streams x {APP_FRAMES}): "
                f"counts {card_st[0].counts} / {card_st[1].counts}, line "
                f"counts, event kinds and the last checkpoints' ids, status "
                f"and next_id equal, mean within 1e-3; "
                + (f"labels {rows} rows, {differ} fields differ (conf 1e-3, "
                   "coordinates 1 px)" if save else "no labels (save off)"))

        # resume on the card: killed after frame 3, resumed
        deterministic = torch.backends.cudnn.deterministic
        torch.backends.cudnn.deterministic = True
        try:
            for mode in ("sequential", "batched"):
                full_out = os.path.join(tmp, f"full_{mode}")
                full = _app_cpu_card(full_out, "bytetrack.yaml", "cuda",
                                     save, multi_mode=mode,
                                     checkpoint_every=1)
                out = os.path.join(tmp, f"resumed_{mode}")
                first = _app_cpu_card(out, "bytetrack.yaml", "cuda", save,
                                      multi_mode=mode, checkpoint_every=1,
                                      max_frames=3)
                if [st.frames for st in first] != [3, 3]:
                    raise AssertionError(f"resume {mode}: first run "
                                         f"{[st.frames for st in first]}")
                resumed = _app_cpu_card(out, "bytetrack.yaml", "cuda",
                                        save, multi_mode=mode,
                                        resume=True, checkpoint_every=1)
                for a, b in zip(full, resumed):
                    if (a.frames, a.counts) != (b.frames, b.counts):
                        raise AssertionError(f"resume {mode}: {b.frames} "
                                             f"{b.counts} vs {a.frames} "
                                             f"{a.counts}")
                    if save:
                        with open(a.labels_file) as fa, open(b.labels_file) as fb:
                            if fa.read() != fb.read():
                                raise AssertionError(f"resume {mode}: labels "
                                                     "differ")
                for name in ("synthetic", "synthetic_1"):
                    a, b = _ckpt(full_out, name), _ckpt(out, name)
                    for field, value in a.items():
                        if not torch.equal(value, b[field]):
                            raise AssertionError(f"resume {mode}: final "
                                                 f"checkpoint {field} differs")
                log(f"resume on the card, {mode}: killed after frame 3, "
                    f"resumed to {APP_FRAMES}: final checkpoints equal field "
                    f"for field" + (", label files identical" if save
                                    else "") + " to the uninterrupted run")
        finally:
            torch.backends.cudnn.deterministic = deterministic


# -- phase 6: offline tracking ---------------------------------------------

MOT_FIXTURE = os.path.join(ROOT, "tests", "fixtures", "MOT-synth01")
# BASELINE.md:148-152, the public protocol on MOT-synth01:
# (MOTA, IDF1, FP, FN, IDsw) to four places
PUBLIC_ROWS = {
    "bytetrack.yaml": (0.9155, 0.9264, 0, 165, 1),
    "botsort.yaml": (0.9155, 0.9264, 0, 165, 1),
    "strongsort.yaml": (0.9089, 0.9233, 1, 177, 1),
    "bytetrack.yaml --strongsort-pp": (0.9913, 0.9612, 2, 14, 1),
    "bytetrack.yaml --strongsort-pp --aflink": (0.9913, 0.9612, 2, 14, 1),
}
# BASELINE.md:186-192 and 213-216, the JAX package's occlusion-relay rows
# at cycles=2 (MOTA, IDF1, IDsw), printed beside the card's
SEQUENCE_ROWS = {
    ("strongsort", "vis"): (0.735, 0.796, 8),
    ("strongsort_lambda0", "vis"): (0.720, 0.758, 16),
    ("strongsort_pp_aflink_gsi", "vis"): (0.690, 0.828, 1),
    ("strongsort_lambda0_pp_aflink_gsi", "vis"): (0.677, 0.779, 4),
    ("strongsort", "occ"): (0.519, 0.649, 8),
    ("strongsort_lambda0", "occ"): (0.509, 0.618, 16),
    ("strongsort_pp_aflink_gsi", "occ"): (0.487, 0.680, 1),
    ("strongsort_cadence1", "vis"): (0.735, 0.796, 8),
    ("strongsort_cadence2", "vis"): (0.719, 0.780, 17),
}
DETECTOR_SEQ_FRAMES = 60  # 1080p frames of the detector protocol's sequence


def _run_tool(main, argv: list[str]):
    """Call a tool's ``main(argv)`` with its standard output captured ->
    (its return value, the JSON objects it printed, seconds)."""
    import contextlib
    import io

    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        ret = main(argv)
    secs = time.perf_counter() - t0
    rows = [json.loads(line) for line in buf.getvalue().splitlines()
            if line.startswith("{")]
    return ret, rows, secs


def _zero(kernels) -> None:
    for k in kernels:
        k.launches = 0


def _counts(kernels) -> dict:
    return {k.__name__: k.launches for k in kernels}


def phase_public_protocol(card: str, kernels) -> None:
    """6a: ``eval_mot --public`` on MOT-synth01 for the five BASELINE.md
    rows on the card (K3 only: the protocol takes no frames), each
    equal to BASELINE.md to four places and its JSON line equal to the
    same run with ``--device cpu``; one mid-sequence ByteTrack K3 call
    held against auction_plain."""
    from strongsort_yolo_tpu_torch.tools import eval_mot

    for config, want in PUBLIC_ROWS.items():
        tracker, *flags = config.split()
        argv = [MOT_FIXTURE, "--public", "--tracker", tracker, *flags]
        _zero(kernels)
        with capture_auction() as calls:
            _, card_rows, secs = _run_tool(eval_mot.main,
                                           argv + ["--device", "cuda"])
        counts = _counts(kernels)
        _, cpu_rows, cpu_secs = _run_tool(eval_mot.main,
                                          argv + ["--device", "cpu"])
        m = card_rows[0]
        got = (round(m["mota"], 4), round(m["idf1"], 4), m["fp"], m["fn"],
               m["idsw"])
        log(f"eval_mot --public {config}: {json.dumps(m)}; launches "
            f"{counts}; host ms per frame {secs / 300 * 1e3:.2f} on the card "
            f"[{card}], {cpu_secs / 300 * 1e3:.2f} with --device cpu")
        if got != want:
            raise AssertionError(f"eval_mot --public {config}: (MOTA, IDF1, "
                                 f"FP, FN, IDsw) {got}, BASELINE.md {want}")
        if json.dumps(card_rows) != json.dumps(cpu_rows):
            raise AssertionError(f"eval_mot --public {config}: card "
                                 f"{card_rows} != CPU {cpu_rows}")
        if counts["auction"] != len(calls) or not calls:
            raise AssertionError(f"eval_mot --public {config}: K3 launched "
                                 f"{counts['auction']} times, {len(calls)} "
                                 "calls")
        if config == "bytetrack.yaml":
            check_k3_tick(card, [calls[len(calls) // 2]],
                          "MOT-synth01 frame 150 (ByteTrack, public protocol)")


def write_mot_sequence(src, seq_dir: str) -> None:
    """A MOT17-layout sequence of ``src``'s frames (img1/*.jpg, written by
    cv2) with its truth as gt/gt.txt."""
    from strongsort_yolo_tpu_torch.media.video import _cv2

    cv2 = _cv2()
    os.makedirs(os.path.join(seq_dir, "img1"))
    os.makedirs(os.path.join(seq_dir, "gt"))
    lines = []
    for t, frame in enumerate(src):
        if not cv2.imwrite(os.path.join(seq_dir, "img1", f"{t + 1:06d}.jpg"),
                           frame):
            raise AssertionError(f"cv2.imwrite failed on frame {t + 1}")
        lines += [f"{t + 1},{tid},{x1:.2f},{y1:.2f},{x2 - x1:.2f},"
                  f"{y2 - y1:.2f},1,1,1.0\n"
                  for tid, x1, y1, x2, y2 in src.truth(t)]
    with open(os.path.join(seq_dir, "gt", "gt.txt"), "w") as f:
        f.writelines(lines)
    with open(os.path.join(seq_dir, "seqinfo.ini"), "w") as f:
        f.write(f"[Sequence]\nname={os.path.basename(seq_dir)}\nimDir=img1\n"
                f"frameRate=30\nseqLength={src.num_frames}\nimWidth={src.w}\n"
                f"imHeight={src.h}\nimExt=.jpg\n")


def phase_detector_protocol(card: str, kernels) -> None:
    """6b: ``eval_mot`` with the detector on a rendered 1080p sequence:
    yolov8n at 640, bf16, the class bias calibrated (app_checkpoint),
    botsort.yaml, its sparseOptFlow on the host as the JAX tool runs it
    (K1-K3). Random weights: the metrics are printed, not held to a bar."""
    from strongsort_yolo_tpu_torch.media.video import SyntheticSource
    from strongsort_yolo_tpu_torch.tools import eval_mot

    with tempfile.TemporaryDirectory() as tmp:
        src = SyntheticSource(num_frames=DETECTOR_SEQ_FRAMES,
                              size=(1080, 1920), num_objects=6, seed=0)
        seq = os.path.join(tmp, "SYNTH-1080")
        t0 = time.perf_counter()
        write_mot_sequence(src, seq)
        write_s = time.perf_counter() - t0
        weights = app_checkpoint(next(iter(src)), tmp)
        _zero(kernels)
        _, rows, secs = _run_tool(eval_mot.main, [seq, "--weights", weights,
                                                  "--device", "cuda"])
        counts = _counts(kernels)
    n = DETECTOR_SEQ_FRAMES
    log(f"eval_mot detector protocol, {n} 1080p JPEG frames (written by cv2 "
        f"in {write_s:.2f} s), yolov8n 640 bf16 calibrated, botsort.yaml "
        f"(host sparseOptFlow): {json.dumps(rows[0])}; launches {counts}; host ms per "
        f"frame {secs / n * 1e3:.2f} (main's wall clock: pipeline build, "
        f"JPEG decode, track, metrics) [{card}]")
    for name, k in counts.items():
        if k == 0:
            raise AssertionError(f"detector protocol never launched {name}")
    if rows[0]["gt"] != sum(len(src.truth(t)) for t in range(n)):
        raise AssertionError(f"detector protocol: gt {rows[0]['gt']}")


def _same_records(label: str, got, want) -> None:
    if [r[:2] for r in got] != [r[:2] for r in want]:
        raise AssertionError(f"{label}: records' frames or ids differ")
    if got:
        err = float(np.abs(np.array([r[2:] for r in got])
                           - np.array([r[2:] for r in want])).max())
        if err > 1e-3:
            raise AssertionError(f"{label}: boxes differ by {err} px")


def phase_sequence_rows(card: str, kernels) -> None:
    """6c: ``eval_sequence`` on the card: the cycles=2 rows with the
    cadence arms, held to tests/test_sequence_quality.py's bars, cadence 1
    equal to the classic arm; the panning relay with flow_tpu held to
    tests/test_torch_quality.py's bar; the λ=0.98 arm and its StrongSORT++
    pass at cycles=1 equal to the CPU's; K4 on a relay tick's crop batch."""
    import torch

    from strongsort_yolo_tpu_torch.media.video import OcclusionRelayClip
    from strongsort_yolo_tpu_torch.tools import eval_sequence

    _zero(kernels)
    rows, _, secs = _run_tool(eval_sequence.main, [
        "--cycles", "2", "--json", "--cadence", "1", "2", "--device", "cuda"])
    counts = _counts(kernels)
    frames = 4 * OcclusionRelayClip(cycles=2).num_frames
    log(f"eval_sequence --cycles 2 --cadence 1 2: {frames} frames in "
        f"{secs:.2f} s, host ms per frame {secs / frames * 1e3:.2f}; launches "
        f"{counts} [{card}]")
    for name, row in rows.items():
        for proto, m in row.items():
            ref = SEQUENCE_ROWS.get((name, proto))
            log(f"  {name:34s} {proto}: MOTA {m['mota']:.4f} IDF1 "
                f"{m['idf1']:.4f} IDsw {m['idsw']}"
                + (f"  (BASELINE.md {ref[0]:.3f} {ref[1]:.3f} {ref[2]})"
                   if ref else ""))
    reid, lam0 = rows["strongsort"]["vis"], rows["strongsort_lambda0"]["vis"]
    pp = rows["strongsort_pp_aflink_gsi"]["vis"]
    bars = {
        "IDsw(reid) < IDsw(lambda0)": reid["idsw"] < lam0["idsw"],
        "IDF1(reid) > IDF1(lambda0) + 0.01": reid["idf1"] > lam0["idf1"] + 0.01,
        "MOTA(reid) > 0.6": reid["mota"] > 0.6,
        "IDF1(reid) > 0.65": reid["idf1"] > 0.65,
        "IDsw(reid_pp) <= IDsw(reid)": pp["idsw"] <= reid["idsw"],
        "IDF1(reid_pp) >= IDF1(reid) - 0.02": pp["idf1"] >= reid["idf1"] - 0.02,
        "cadence 1 == classic arm": rows["strongsort_cadence1"]
        == rows["strongsort"],
    }
    failed = [k for k, ok in bars.items() if not ok]
    if failed:
        raise AssertionError(f"relay rows miss the bars {failed}")
    for name in ("letterbox_u8", "nms_keep", "auction"):
        if counts[name] < frames:
            raise AssertionError(f"relay rows: {name} launched "
                                 f"{counts[name]} times in {frames} frames")
    if counts["banded_crop"] == 0:
        raise AssertionError("relay rows never launched banded_crop")
    log(f"relay rows hold {list(bars)}")

    _zero(kernels)
    pan_rows, _, secs = _run_tool(eval_sequence.main, [
        "--cycles", "1", "--pan", "10", "--gmc", "flow_tpu", "--json",
        "--device", "cuda"])
    counts = _counts(kernels)
    m = pan_rows["strongsort"]["vis"]
    log(f"eval_sequence --cycles 1 --pan 10 --gmc flow_tpu: strongsort vis "
        f"MOTA {m['mota']:.4f} IDF1 {m['idf1']:.4f} IDsw {m['idsw']} (the "
        f"JAX package on the CPU: 0.7261 0.6328 7); {secs:.2f} s; launches "
        f"{counts} [{card}]")
    if not (m["mota"] >= 0.715 and m["idf1"] >= 0.62 and m["idsw"] <= 7):
        raise AssertionError(f"panning relay misses its bar: {m}")
    if min(counts.values()) == 0:
        raise AssertionError(f"panning relay: a kernel never launched {counts}")

    out = {}
    for dev in ("cuda", "cpu"):
        t0 = time.perf_counter()
        m, records, (gt_vis, gt_occ, _) = eval_sequence.run_arm(
            OcclusionRelayClip(cycles=1), lam=0.98, device=dev)
        out[dev] = (m, records, eval_sequence.eval_pp(
            records, (gt_vis, gt_occ), device=dev),
            time.perf_counter() - t0)
    (cm, crec, cpp, csec), (pm, prec, ppp, psec) = out["cuda"], out["cpu"]
    _same_records("relay cycles=1, card against CPU", crec, prec)
    if cm != pm or cpp != ppp:
        raise AssertionError(f"relay cycles=1: card {cm} {cpp} != CPU {pm} "
                             f"{ppp}")
    log(f"relay cycles=1, lambda 0.98 and its StrongSORT++ pass: card == CPU "
        f"({len(crec)} records, boxes within 1e-3 px; vis MOTA "
        f"{cm['vis']['mota']:.4f} IDF1 {cm['vis']['idf1']:.4f} IDsw "
        f"{cm['vis']['idsw']}, pp IDsw {cpp['vis']['idsw']}); {csec:.2f} s "
        f"card [{card}], {psec:.2f} s CPU")

    pipe = eval_sequence.arm_pipeline(lam=0.98, device="cuda")
    frame = next(f for t, f in enumerate(OcclusionRelayClip(cycles=1))
                 if t == 10)
    with torch.no_grad():
        check_path_crops("relay", pipe, to_card(frame[None]), card)


def phase_aflink(card: str) -> None:
    """6d: the shipped AFLink's logits on the card against the CPU on 800
    fresh pairs (tests/test_aflink.py's draw) within 1e-5 x max(1,
    |logit|), the same decisions, pairwise accuracy >= 0.95; then 200
    training steps on the card, the loss falling."""
    from strongsort_yolo_tpu_torch.tools import train_aflink
    from strongsort_yolo_tpu_torch.track import aflink

    rng = np.random.default_rng(1234)
    fa, ma, fb, mb, y = train_aflink.make_pairs(
        rng, train_aflink.make_trajectories(rng, 30), 400, 400)
    want = aflink.aflink_logits(aflink.load_aflink(aflink.default_checkpoint(),
                                                   "cpu"), fa, ma, fb, mb)
    model = aflink.load_aflink(aflink.default_checkpoint(), "cuda")
    got = aflink.aflink_logits(model, fa, ma, fb, mb)
    err = float(np.max(np.abs(got - want) / np.maximum(1.0, np.abs(want))))
    acc = float(np.mean((got > 0) == (y > 0.5)))
    ms = cuda_ms(lambda: aflink.aflink_logits(model, fa, ma, fb, mb))
    log(f"AFLink on {len(y)} fresh pairs: card against CPU max |err| / "
        f"max(1, |logit|) {err:.3g}, accuracy {acc:.4f}; one forward with its "
        f"copies {ms:.3f} ms (CUDA events) [{card}]")
    if err > 1e-5 or not np.array_equal(got > 0, want > 0) or acc < 0.95:
        raise AssertionError(f"AFLink on the card: err {err}, accuracy {acc}")
    with tempfile.TemporaryDirectory() as tmp:
        res, _, _ = _run_tool(train_aflink.main, [
            "--steps", "200", "--device", "cuda", "--out",
            os.path.join(tmp, "aflink.npz")])
    (s0, l0), (s1, l1) = res["losses"][0], res["losses"][-1]
    log(f"train_aflink 200 steps on the card: loss {l0:.4f} at step {s0}, "
        f"{l1:.4f} at step {s1}, val accuracy {res['val_acc']:.4f}, "
        f"{res['seconds']:.2f} s [{card}]")
    if not l1 < l0:
        raise AssertionError(f"train_aflink: the loss did not fall ({l0} -> "
                             f"{l1})")


def phase_offline(card: str, kernels: dict) -> None:
    """Phase 6: the offline tracking tools on the card."""
    k = kernels
    mark("phase 6a: eval_mot --public on MOT-synth01")
    phase_public_protocol(card, [k["auction"]])
    mark("phase 6b: eval_mot with the detector, 1080p")
    phase_detector_protocol(card, [k[n] for n in (
        "letterbox_u8", "nms_keep", "auction")])
    mark("phase 6c: eval_sequence, the occlusion-relay rows")
    phase_sequence_rows(card, [k[n] for n in (
        "letterbox_u8", "nms_keep", "auction", "banded_crop", "lk_pyramid")])
    mark("phase 6d: AFLink inference and training")
    phase_aflink(card)


# -- phase 8: int8 post-training quantization --------------------------------

INT8_TICKS = 20  # ticks of the int8 main path after calibration


class capture_int8:
    """Within the block, every K8 call of the int8 convs (through
    ops.quant.conv_int8) keeps a copy of its input and its conv's
    arguments: a list of (x, conv) in call order, each conv a namespace
    with the attributes of an int8 ``Conv`` (wq, wscale, b, xscale,
    stride, pad, groups, act)."""

    def __enter__(self):
        from types import SimpleNamespace

        from strongsort_yolo_tpu_torch.ops import quant

        self.module, self.real, calls = quant, quant.conv_int8, []

        def recording(x, wq, wscale, b, xscale, *, packed=None, **kw):
            calls.append((x.detach().clone(), SimpleNamespace(
                wq=wq, wscale=wscale, b=b, xscale=xscale, **kw)))
            return self.real(x, wq, wscale, b, xscale, packed=packed, **kw)

        quant.conv_int8 = recording
        return calls

    def __exit__(self, *exc):
        self.module.conv_int8 = self.real


class plain_int8:
    """Within the block, the int8 convs compute with K8's plain version
    on their CUDA tensors in place of K8 (the witness of
    :func:`_witness_plain`; no launch counted)."""

    def __enter__(self):
        from strongsort_yolo_tpu_torch.ops import quant
        from strongsort_yolo_tpu_torch.ops.cuda.quant_kernel import (
            conv_s8_plain,
        )

        self.module, self.real = quant, quant.conv_s8
        quant.conv_s8 = lambda *a, packed=None, **kw: conv_s8_plain(*a, **kw)

    def __exit__(self, *exc):
        self.module.conv_s8 = self.real


def _conv_label(x, conv) -> str:
    c_out, _, k, _ = conv.wq.shape
    return (f"{tuple(x.shape[1:])}->{c_out} k{k} s{conv.stride} g{conv.groups}"
            f" act={conv.act}")


def check_k8_calls(calls, label: str) -> float:
    """K8 against conv_s8_plain on each captured call, in bfloat16 and
    float32, with the dynamic scale and with the conv's calibrated one
    (where it has one): the int32 sums and every output bit-identical
    (on the card both epilogues round alike: ops/cuda/quant_kernel.py).
    -> max |err|."""
    import torch

    from strongsort_yolo_tpu_torch.ops.cuda.quant_kernel import (
        conv_s8, conv_s8_plain,
    )
    from strongsort_yolo_tpu_torch.ops.quant import dynamic_scale

    max_abs, compared = 0.0, 0
    for x, conv in calls:
        kw = dict(stride=conv.stride, pad=conv.pad, groups=conv.groups,
                  act=conv.act)
        for dt in (torch.bfloat16, torch.float32):
            xx = x.to(dt)
            for xs in [dynamic_scale(xx)] + (
                    [conv.xscale] if conv.xscale is not None else []):
                args = (xx, conv.wq, conv.wscale, conv.b, xs)
                name = f"K8 {label} {_conv_label(x, conv)} {dt}"
                # float32 of a bf16 x gives the same codes, so the same sums
                if dt == torch.bfloat16 and not torch.equal(
                        conv_s8(*args, **kw, sums=True),
                        conv_s8_plain(*args, **kw, sums=True)):
                    raise AssertionError(f"{name}: int32 sums differ")
                got, want = conv_s8(*args, **kw), conv_s8_plain(*args, **kw)
                compared += got.numel()
                max_abs = max(max_abs, float((got.float() - want.float())
                                             .abs().max()))
                if not torch.equal(got, want):
                    raise AssertionError(f"{name}: {int((got != want).sum())} "
                                         f"outputs differ, max |err| {max_abs}")
    log(f"K8 {label}: {len(calls)} convs x (bf16, f32) x (dynamic, static) "
        f"scales: int32 sums and all {compared} outputs bit-identical to "
        f"conv_s8_plain")
    return max_abs


def time_k8(card: str, calls, label: str, first=None) -> dict:
    """K8 over one tick's convs in bfloat16 with their calibrated scales, as
    the path runs them: device time by CUDA-graph replay (the quantize
    pass and the conv, one wrapper call), the plain version's by events,
    cuDNN's bf16 conv + SiLU of the dequantized weights (a different
    function: bf16 products, no quantization) by graph replay, and the
    bound; each conv beside its time in K8's first form where
    ``first`` (tools/prof_s8.YOLOV8N_INT8, the same convs in the same
    order) is given, a depthwise conv beside K8_DW_FIRST_MS and cuDNN's
    bf16 depthwise conv + SiLU; then the sums over each conv class. -> the
    sums over all, and per class."""
    import torch
    import torch.nn.functional as F

    from strongsort_yolo_tpu_torch.ops.cuda.quant_kernel import (
        conv_s8, conv_s8_plain, pack_s8,
    )
    from strongsort_yolo_tpu_torch.tools.prof_conv import graph_ms
    from strongsort_yolo_tpu_torch.tools.prof_s8 import conv_class

    keys = ("ms", "plain", "library", "bound", "by_ops", "first", "silu")
    total = dict.fromkeys(keys, 0.0)
    classes = {}
    if first is not None and len(first) != len(calls):
        raise AssertionError(f"K8 {label}: {len(calls)} convs, the first "
                             f"form timed {len(first)}")
    for i, (x, conv) in enumerate(calls):
        x = x.to(torch.bfloat16)
        c_out, c_in, k, _ = conv.wq.shape
        shape = (x.shape[1], x.shape[2], x.shape[3], c_out, k, conv.stride)
        kw = dict(stride=conv.stride, pad=conv.pad, groups=conv.groups,
                  act=conv.act)
        args = (x, conv.wq, conv.wscale, conv.b, conv.xscale)
        packed = pack_s8(conv.wq, conv.groups)
        ms = graph_ms(lambda: conv_s8(*args, **kw, packed=packed))
        plain = cuda_ms(lambda: conv_s8_plain(*args, **kw), iters=1, warmup=1)
        w16 = (conv.wq.float() * conv.wscale[:, None, None, None]).to(
            torch.bfloat16)
        b16 = conv.b.to(torch.bfloat16)

        def lib():
            y = F.conv2d(x, w16, b16, conv.stride, conv.pad, 1, conv.groups)
            return F.silu(y) if conv.act else y

        library = graph_ms(lib)
        depthwise = conv.groups > 1
        silu = (graph_ms(lambda: F.silu(F.conv2d(x, w16, b16, conv.stride, conv.pad,
                                                 1, conv.groups)))
                if depthwise else 0.0)
        out = conv_s8(*args, **kw, packed=packed)
        macs = out.numel() * conv.wq[0].numel()
        t, by = bound(nbytes(x, conv.wq, conv.wscale, conv.b, out), 2 * macs,
                      "int8")
        then = ""
        row = dict(ms=ms, plain=plain, library=library, bound=t,
                   by_ops=t if by == "operations" else 0.0, first=0.0, silu=silu)
        if first is not None:
            if tuple(first[i][:6]) != shape:
                raise AssertionError(f"K8 {label}: conv {i} is {shape}, the "
                                     f"first form timed {first[i][:6]}")
            row["first"] = first[i][6]
            then = f" (first form: {first[i][6]:.4f} ms)"
        elif depthwise:
            row["first"] = K8_DW_FIRST_MS
            then = (f" (first form: {K8_DW_FIRST_MS:.4f} ms; cuDNN bf16 "
                    f"depthwise conv + SiLU {silu:.4f} ms)")
        for key in keys:
            total[key] += row[key]
        name = (conv_class(*shape) if conv.groups == 1
                else f"depthwise {k}x{k}")
        c = classes.setdefault(name, dict.fromkeys(("n", "max", *keys), 0.0))
        c["n"] += 1
        c["max"] = max(c["max"], ms)
        for key in keys:
            c[key] += row[key]
        log(f"K8 {_conv_label(x, conv)} S={x.shape[0]} bf16: kernel {ms:.4f} "
            f"ms{then}, plain {plain:.4f} ms, cuDNN bf16 conv"
            f"{' + SiLU' * conv.act} {library:.4f} ms, bound {t:.6f} ms "
            f"({by}, {2 * macs / 1e9:.3f} GOP) [{card}]")
    for name, c in classes.items():
        then = (f" (first form: {c['first']:.4f} ms)"
                if first is not None or c["first"] else "")
        if c["silu"]:
            then += f", cuDNN bf16 conv + SiLU {c['silu']:.4f} ms"
        log(f"K8 {label}, class {name}: {int(c['n'])} convs, kernel "
            f"{c['ms']:.4f} ms{then}, cuDNN bf16 {c['library']:.4f} ms, "
            f"bound {c['bound']:.6f} ms [{card}]")
    total["classes"] = classes
    return total


K8_20X20_MS = 0.04  # the bar of each 3x3 conv on a 20 x 20 plane
# K8's first depthwise form (the quantize pass, then a thread per output
# reading channel-minor codes) on yolo11n-pose's pe conv (S=8, 128 x 20 x
# 20, bf16), by CUDA-graph replay on the kernels before the one-launch
# form took it (NVIDIA H100 80GB HBM3, 700.00 W)
K8_DW_FIRST_MS = 0.0229


def check_k8_bars(total: dict) -> None:
    """K8's bars over yolov8n's 32 int8 convs (time_k8's sums, one run):
    no longer than cuDNN's bf16 conv + SiLU over the same convs, each 3x3
    conv on a 20 x 20 plane within K8_20X20_MS, and no conv class slower
    than in K8's first form."""
    bad = []
    if total["ms"] > total["library"]:
        bad.append(f"{total['ms']:.4f} ms over cuDNN's {total['library']:.4f}")
    for name, c in total["classes"].items():
        if c["ms"] > c["first"]:
            bad.append(f"class {name} {c['ms']:.4f} ms over the first "
                       f"form's {c['first']:.4f}")
        if name.startswith("3x3 s1") and name.endswith("20x20") and (
                c["max"] > K8_20X20_MS):
            bad.append(f"class {name} up to {c['max']:.4f} ms")
    if bad:
        raise AssertionError("K8 bars: " + "; ".join(bad))
    log(f"K8 bars met: {total['ms']:.4f} ms <= cuDNN's {total['library']:.4f}, "
        f"every 3x3 20x20 conv <= {K8_20X20_MS} ms, every class at or below "
        f"its first form's time")


def check_k8_dw_bar(total: dict) -> None:
    """K8's depthwise bar (time_k8's sums over yolo11n-pose's convs, one
    run): the depthwise class no slower than cuDNN's bf16 depthwise conv
    + SiLU of the same convs in the same run, and faster than the first
    form."""
    c = total["classes"].get("depthwise 3x3")
    if c is None:
        raise AssertionError("K8: yolo11n-pose ran no depthwise conv")
    if not (c["ms"] <= c["silu"] and c["ms"] < c["first"]):
        raise AssertionError(f"K8 depthwise {c['ms']:.4f} ms: cuDNN bf16 conv "
                             f"+ SiLU {c['silu']:.4f}, first form "
                             f"{c['first']:.4f}")
    log(f"K8 depthwise bar met: {c['ms']:.4f} ms <= cuDNN bf16 depthwise conv "
        f"+ SiLU {c['silu']:.4f} (conv alone {c['library']:.4f}), "
        f"{c['first'] / c['ms']:.2f}x the first form's {c['first']:.4f}")


def _int8_parity(label: str, cpu, card) -> int:
    """Card against CPU rows of an int8 path (lists of ticks of S
    Results): equal rows and ids, boxes within 1 px. An int8 path rounds
    every activation to a code step, so the last-bit differences of the
    float layers (cuDNN against the CPU) move a code where an activation
    lies on a rounding boundary (tests/test_torch_quant.py), and the
    tracker's filter carries a detection's difference into the later
    frames' boxes; the frames within 1e-3 px are counted. -> track
    rows."""
    rows, close, frames, worst = 0, 0, 0, 0.0
    for t, (a_tick, b_tick) in enumerate(zip(cpu, card)):
        for s, (a, b) in enumerate(zip(a_tick, b_tick)):
            a, b = a.boxes, b.boxes
            if len(a) != len(b) or not np.array_equal(a.id, b.id):
                raise AssertionError(f"{label} t={t} s={s}: rows/ids {b.id} "
                                     f"on the card, {a.id} on the CPU")
            err = float(np.abs(a.xyxy - b.xyxy).max(initial=0.0))
            worst = max(worst, err)
            close += err <= 1e-3
            frames += 1
            rows += len(a)
    if worst > 1.0:
        raise AssertionError(f"{label}: boxes {worst} px apart")
    log(f"{label}: card == CPU on {frames} frames, {rows} track rows, same "
        f"ids, boxes within {worst:.3g} px ({close} frames within 1e-3)")
    return rows


def _arrays(out) -> list[np.ndarray]:
    """Every array of a path's output (Boxes, Results, and lists, tuples
    and dicts of them or of numbers), in order."""
    if isinstance(out, (list, tuple)):
        return [a for o in out for a in _arrays(o)]
    if isinstance(out, dict):
        return [a for o in out.values() for a in _arrays(o)]
    if hasattr(out, "boxes"):
        kpts = getattr(out, "keypoints", None)
        return _arrays(out.boxes) + ([] if kpts is None else [kpts.data])
    if hasattr(out, "xyxy"):
        return [out.xyxy, out.conf, out.cls] + (
            [] if out.id is None else [out.id])
    return [np.asarray(out)]


def _witness_plain(label: str, run):
    """``run()`` on the card twice under cuDNN's deterministic mode: with
    K8, then with K8's plain version on the same CUDA tensors
    (plain_int8). The outputs must be equal array for array, bit for bit:
    then a gap between the card and the CPU comes from the float layers
    (cuDNN against the CPU's), not from K8. -> K8's output."""
    import torch

    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        got = run()
        with plain_int8():
            want = run()
    finally:
        torch.backends.cudnn.deterministic = deterministic
    a, b = _arrays(got), _arrays(want)
    if len(a) != len(b) or not all(
            x.shape == y.shape and np.array_equal(x, y) for x, y in zip(a, b)):
        raise AssertionError(f"{label}: the card's rows with K8 differ from "
                             f"its rows with conv_s8_plain")
    log(f"{label}: witness on the card, K8 swapped for conv_s8_plain: "
        f"{len(a)} arrays ({sum(x.size for x in a)} values) equal bit for bit")
    return got


def _box_iou(a: np.ndarray, b: np.ndarray) -> float:
    w = max(0.0, float(min(a[2], b[2]) - max(a[0], b[0])))
    h = max(0.0, float(min(a[3], b[3]) - max(a[1], b[1])))
    areas = float((a[2] - a[0]) * (a[3] - a[1]) + (b[2] - b[0]) * (b[3] - b[1]))
    return w * h / max(areas - w * h, 1e-9)


def _int8_det_parity(label: str, pipes, frames) -> None:
    """Card against CPU detections (``predict``) of an int8 model with
    random weights, whose head is set so that many scores sit near the
    confidence threshold among heavily overlapping boxes: a code moved by
    a float layer's last bit (see _int8_parity; _witness_plain shows that
    K8 is not where the card departs) moves a score by up to a few
    hundredths, across the threshold or across a neighbour in NMS, and a
    tracker then numbers every later track otherwise. So detections, not
    ids: each row matched by a row of the other side of its class with
    the box within 1 px and the confidence within 0.03, at least 90% of
    the rows of both sides matched, and every row left unmatched
    explained by an unmatched row of the other side with its score
    within 0.03: of another class with the box within 1 px (a class
    flip: the argmax of two class scores a code step apart), or of its
    class overlapping it above NMS's IoU (an NMS swap: the two kept each
    other's place); or its own score within 0.03 of the threshold (it
    crossed it); or else an unmatched row of the other side of its
    class, overlapping it above NMS's IoU and scoring more than 0.03
    above it (suppressed there: in a cluster a swap higher up moves
    which rows survive below it, and the row that suppresses this one's
    counterpart is itself a link of that chain, so unmatched; a matched
    row above would suppress it on this side too)."""
    conf, iou = pipes["cpu"].det_cfg.conf, pipes["cpu"].det_cfg.iou
    card = _witness_plain(label, lambda: [pipes["cuda"].predict(f).boxes
                                          for f in frames])
    rows, alone, worst, unexplained = 0, [], 0.0, []
    for t, frame in enumerate(frames):
        a, b = pipes["cpu"].predict(frame).boxes, card[t]
        free = list(range(len(b)))
        left = []
        for i in range(len(a)):
            near = [j for j in free if b.cls[j] == a.cls[i]
                    and np.abs(b.xyxy[j] - a.xyxy[i]).max() <= 1.0
                    and abs(b.conf[j] - a.conf[i]) <= 0.03]
            if near:
                j = min(near, key=lambda j: np.abs(b.xyxy[j] - a.xyxy[i]).max())
                worst = max(worst, float(np.abs(b.xyxy[j] - a.xyxy[i]).max()))
                free.remove(j)
            else:
                left.append(("cpu", a, i))
        left += [("card", b, j) for j in free]
        for side, boxes, i in left:
            score, cls = float(boxes.conf[i]), boxes.cls[i]
            flips, swaps, over = [], [], []
            for s, o, j in left:
                if s == side:
                    continue
                other = (int(o.cls[j]), round(float(o.conf[j]), 4))
                overlaps = _box_iou(boxes.xyxy[i], o.xyxy[j]) > iou
                if o.cls[j] == cls and overlaps and float(o.conf[j]) > score + 0.03:
                    over.append(other)
                elif abs(float(o.conf[j]) - score) > 0.03:
                    continue
                elif o.cls[j] != cls and np.abs(
                        o.xyxy[j] - boxes.xyxy[i]).max() <= 1.0:
                    flips.append(other)
                elif o.cls[j] == cls and overlaps:
                    swaps.append(other)
            why = (f"class flip with {flips[0]} (class, score)" if flips else
                   f"NMS swap with {swaps[0]} (class, score)" if swaps else
                   "threshold" if score - conf <= 0.03 else
                   f"suppressed there by {over[0]} (class, score)" if over
                   else None)
            alone.append(f"t={t} {side} {score:.4f} cls {int(cls)}: {why}")
            if why is None:
                unexplained.append(alone[-1])
        rows += len(a) + len(b)
    if rows == 0 or len(alone) > 0.1 * rows or unexplained:
        raise AssertionError(f"{label}: {len(alone)} of {rows} rows "
                             f"unmatched: {alone}; unexplained {unexplained}")
    log(f"{label}: card == CPU detections on {len(frames)} frames, {rows} "
        f"rows on both sides, {len(alone)} unmatched, each explained "
        f"({alone}), the matched boxes within {worst:.3g} px")


def _share_scales(src, dst) -> None:
    """The calibrated xscale of each int8 conv of pipeline ``src`` onto
    ``dst``'s (the same model on another device)."""
    from strongsort_yolo_tpu_torch.models.common import int8_convs

    for a, b in zip(int8_convs(src.model), int8_convs(dst.model)):
        b.xscale = a.xscale.to(b.wq.device)


def _no_sync_ticks(bp, ticks) -> None:
    """The overlapped loop (step_async t, materialize t - 1) over ``ticks``
    under set_sync_debug_mode("error"): any synchronizing op raises."""
    import torch

    torch.cuda.set_sync_debug_mode("error")
    try:
        pending = None
        for frames in ticks:
            handle = bp.step_async(frames)
            if pending is not None:
                bp.materialize(pending)
            pending = handle
        bp.materialize(pending)
    finally:
        torch.cuda.set_sync_debug_mode(0)


def phase_int8_path(card: str, kernels) -> tuple[dict, list]:
    """8b: yolov8n int8, imgsz 640, bf16, BoT-SORT gmc none, S=8 1080p (cell
    a's configuration): 3 ticks with the dynamic scales under the sync
    check, calibration on tick 0's first two frames as the batched app
    loop does, refresh_steps, then INT8_TICKS ticks with launches counted,
    3 more under the sync check, one tick's K8 calls captured, and ms per
    tick against the bf16 pipeline in turns. -> (counts, captured calls)."""
    import torch

    from strongsort_yolo_tpu_torch.models.common import int8_convs
    from strongsort_yolo_tpu_torch.pipeline import BatchedPipeline
    from strongsort_yolo_tpu_torch.track.bytetrack import ByteTrackConfig

    h, w = 1080, 1920
    pool = make_frames(h, w)
    tracker = ByteTrackConfig(tracker_type="botsort", gmc_method="none")
    pipe = _main_pipeline(tracker, pool, quant="int8")
    n_q = len(int8_convs(pipe.model))
    ticks = [np.stack([pool[(s + t) % len(pool)] for s in range(S_MAIN)])
             for t in range(INT8_TICKS)]
    bp = BatchedPipeline(pipe, S_MAIN, (h, w))
    bp.step(ticks[0])
    bp.step(ticks[1])
    _no_sync_ticks(bp, ticks[2:5])
    bp = BatchedPipeline(pipe, S_MAIN, (h, w))
    t0 = time.perf_counter()
    n = pipe.calibrate_int8(list(ticks[0][:2]))
    bp.refresh_steps()
    cal_s = time.perf_counter() - t0
    log(f"8b int8: calibrated {n} convs on tick 0's first two frames in "
        f"{cal_s:.3f} s; int8 convs in the model {n_q} (the JAX "
        f"quantize_model's count for yolov8n: 32)")
    if n != 32 or n_q != 32:
        raise AssertionError(f"8b: {n} calibrated, {n_q} int8 convs, not 32")
    counts, times, results = _drive(bp, ticks, kernels)
    want = {"letterbox_u8": 1, "nms_keep": 1, "auction": 3, "conv_s8": 32}
    per_tick = {k: v / INT8_TICKS for k, v in counts.items()}
    log(f"8b int8 path launches over {INT8_TICKS} ticks: {counts}; per tick "
        f"{per_tick}")
    if per_tick != want:
        raise AssertionError(f"8b: launches per tick {per_tick}, not {want}")
    tracks = _check_results("8b int8 path", results)
    log(f"8b int8 path active tracks per stream: {tracks}; ms/tick (host "
        f"clock, synchronized) {_ms_line(times)} [{card}]")
    _no_sync_ticks(bp, ticks[5:8])
    log("8b int8 path: 0 synchronizing ops in 3 + 3 overlapped ticks under "
        "set_sync_debug_mode('error'), dynamic scales and calibrated ones")
    with capture_int8() as calls:
        bp.step(ticks[0])
    if len(calls) != 32:
        raise AssertionError(f"8b: {len(calls)} K8 calls captured in a tick")
    ref = _main_pipeline(tracker, pool)
    rbp = BatchedPipeline(ref, S_MAIN, (h, w))
    rbp.step(ticks[0])
    mine, theirs = [], []
    for t in range(8):
        for b, out in ((bp, mine), (rbp, theirs)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            b.step(ticks[t])
            torch.cuda.synchronize()
            out.append((time.perf_counter() - t0) * 1e3)
    log(f"8b ms/tick in turns (host clock, synchronized, 8 ticks each): int8 "
        f"median {np.median(mine):.2f} ({[round(x, 2) for x in mine]}), bf16 "
        f"median {np.median(theirs):.2f} ({[round(x, 2) for x in theirs]}); "
        f"printed only [{card}]")
    return counts, calls


def phase_int8_guard(card: str) -> None:
    """8c: tests/test_quant.py's guard on the card (synth160, imgsz 160, f32,
    30 frames, ByteTrack, dynamic scales): int8 MOTA and IDF1 within 0.01
    of float; then the int8 rows card against CPU, with the dynamic scales
    and with scales calibrated on the card and shared."""
    from strongsort_yolo_tpu_torch.config import DetectorConfig
    from strongsort_yolo_tpu_torch.media.video import SyntheticDetSource
    from strongsort_yolo_tpu_torch.pipeline import Pipeline
    from strongsort_yolo_tpu_torch.utils.metrics import evaluate_mot

    src = SyntheticDetSource(num_frames=30, size=(320, 320), num_objects=3,
                             seed=1)
    frames = list(src)

    def pipe(quant, device):
        return Pipeline(DetectorConfig(weights=CKPT, imgsz=160, conf=0.3,
                                       iou=0.4, max_det=16, half=False,
                                       quant=quant),
                        tracker="bytetrack.yaml", track_slots=16,
                        tracker_max_dets=16, device=device)

    def mot(p):
        gt, hyp, res = [], [], []
        for t, frame in enumerate(frames):
            r = p.track(frame)
            res.append([r])
            gt.append([tuple(g) for g in src.truth(t)])
            hyp.append([(int(r.boxes.id[i]), *r.boxes.xyxy[i])
                        for i in range(len(r.boxes))])
        return evaluate_mot(gt, hyp), res

    mf, _ = mot(pipe(None, "cuda"))
    mq, card_rows = _witness_plain("8c int8 dynamic scales",
                                   lambda: mot(pipe("int8", "cuda")))
    log(f"8c guard on the card, 30 frames: float MOTA {mf['mota']:.4f} IDF1 "
        f"{mf['idf1']:.4f}, int8 MOTA {mq['mota']:.4f} IDF1 {mq['idf1']:.4f} "
        f"[{card}]")
    if mq["mota"] < mf["mota"] - 0.01 or mq["idf1"] < mf["idf1"] - 0.01:
        raise AssertionError(f"8c: int8 {mq} against float {mf}")
    _, cpu_rows = mot(pipe("int8", "cpu"))
    _int8_parity("8c int8 dynamic scales", cpu_rows, card_rows)
    card, cpu = pipe("int8", "cuda"), pipe("int8", "cpu")
    card.calibrate_int8(frames[:1])
    _share_scales(card, cpu)

    def card_rows():
        card.reset()
        return [[card.track(f)] for f in frames]

    _int8_parity("8c int8 calibrated scales", [[cpu.track(f)] for f in frames],
                 _witness_plain("8c int8 calibrated scales", card_rows))


def v7_classes(calls) -> list:
    """One captured K8 call of each yolov7 shape class that the yolov8n,
    yolov5s and yolo11n-pose paths lack: 1x1 with C_in 1024 (to fewer
    channels), 1x1 with C_in 2048 (SPPCSPC), 3x3 512 -> 1024 (K = 4608),
    1x1 1024 -> 1024 (C_out 1024), the first 3x3 stride-2 conv (the
    widest of them) and a 3x3 conv on the widest plane. -> [(x, conv)],
    one a class."""
    picks = {}
    for x, conv in calls:
        c_out, c_in, k, _ = conv.wq.shape
        for name, hit in (
                ("1x1 C_in 1024", k == 1 and c_in == 1024 and c_out < 1024),
                ("1x1 C_in 2048", k == 1 and c_in == 2048),
                ("3x3 512->1024", k == 3 and c_in == 512 and c_out == 1024),
                ("C_out 1024", k == 1 and c_in == c_out == 1024),
                ("3x3 s2", k == 3 and conv.stride == 2)):
            if hit:
                picks.setdefault(name, (x, conv))
    picks["widest plane"] = max(calls, key=lambda c: (
        c[0].shape[2] * c[0].shape[3], c[1].wq.shape[2]))
    if len(picks) != 6:
        raise AssertionError(f"8d yolov7: classes {sorted(picks)} of 6")
    return list(picks.values())


def phase_int8_families(card: str, kernels) -> tuple[int, list, list, list]:
    """8d: yolov5s int8 + StrongSORT + OSNet-x0_25 fused (K1-K4, K6, K8),
    yolo11n-pose int8 (K8's depthwise form) and yolov7 int8 + ByteTrack
    (BN fused, RepConv deployed) at full width, 3 ticks each, with their
    int8 counts; card against CPU, imgsz 160, f32, scales calibrated on
    the card and shared: the detections of fabricated yolov5s and yolov7
    .pt files (_int8_det_parity) and the tracks of the trained
    yolo11n-pose asset. ->
    (K8 launches, the captured K8 calls to check, the 52 K8 calls of one
    yolo11n-pose tick, the 85 of one yolov7 tick)."""
    from strongsort_yolo_tpu_torch.config import DetectorConfig
    from strongsort_yolo_tpu_torch.models.common import int8_convs
    from strongsort_yolo_tpu_torch.pipeline import BatchedPipeline, Pipeline
    from strongsort_yolo_tpu_torch.track.bytetrack import ByteTrackConfig
    from strongsort_yolo_tpu_torch.track.strongsort import StrongSortConfig

    h, w = 1080, 1920
    pool = make_frames(h, w)
    ticks = [np.stack([pool[(s + t) % len(pool)] for s in range(S_MAIN)])
             for t in range(3)]
    k8, checks, pose, v7 = 0, [], [], []
    for model, tracker, reid, want_n, want in (
        ("yolov5s", StrongSortConfig(gmc_method="none"), "osnet_x0_25", 42,
         ("letterbox_u8", "nms_keep", "auction", "banded_crop", "os_stage",
          "conv_s8")),
        ("yolo11n-pose", ByteTrackConfig(tracker_type="botsort",
                                         gmc_method="none"), None, 52,
         ("letterbox_u8", "nms_keep", "auction", "conv_s8")),
        ("yolov7", ByteTrackConfig(tracker_type="bytetrack"), None, 85,
         ("letterbox_u8", "nms_keep", "auction", "conv_s8")),
    ):
        t0 = time.perf_counter()
        pipe = _main_pipeline(tracker, pool, model=model, reid=reid,
                              fused=reid is not None, quant="int8")
        bp = BatchedPipeline(pipe, S_MAIN, (h, w))
        n = pipe.calibrate_int8(list(ticks[0][:2]))
        bp.refresh_steps()
        counts, times, results = _drive(
            bp, ticks, [k for k in kernels if k.__name__ in want])
        log(f"8d {model} int8 + {type(tracker).__name__}"
            f"{' + fused ' + reid if reid else ''}, S={S_MAIN} 1080p bf16: "
            f"{n} convs calibrated (JAX: {want_n}), launches over 3 ticks "
            f"{counts}, ms/tick {[round(x, 2) for x in times]} [{card}]")
        if n != want_n or len(int8_convs(pipe.model)) != want_n:
            raise AssertionError(f"8d {model}: {n} int8 convs, not {want_n}")
        if counts["conv_s8"] != 3 * want_n or min(counts.values()) == 0:
            raise AssertionError(f"8d {model}: launches {counts}")
        _check_results(f"8d {model}", results)
        k8 += counts["conv_s8"]
        with capture_int8() as calls:
            bp.step(ticks[0])
        # the shape classes the main path lacks: v5's stride 2 at its
        # widths, v11's depthwise conv and its act=False convs; v7's go
        # to their own check
        if model == "yolov5s":
            checks += [c for c in calls if c[1].stride == 2][:1]
        elif model == "yolo11n-pose":
            checks += [c for c in calls if c[1].groups > 1 or not c[1].act]
            pose = calls
        else:
            if len(calls) != want_n:
                raise AssertionError(f"8d {model}: {len(calls)} K8 calls "
                                     f"captured in a tick")
            v7 = calls
        log(f"8d {model} int8: {time.perf_counter() - t0:.1f} s (build, "
            f"calibration, 3 + 1 ticks)")
        del pipe, bp, calls
    S, T = 2, 6
    frames = np.stack([np.stack(render_synthetic(T, seed=s + 1))
                       for s in range(S)], axis=1)
    with tempfile.TemporaryDirectory() as tmp:
        v5 = fabricated_checkpoint("yolov5s", frames[0, 0], tmp)
        v7_pt = fabricated_checkpoint("yolov7", frames[0, 0], tmp)
        for label, weights, tracker, reid, clip in (
            ("8d fabricated yolov5s.pt int8 (detections)", v5, None, None,
             frames),
            ("8d fabricated yolov7.pt int8 (detections)", v7_pt, None, None,
             frames),
            ("8d trained yolo11n-pose int8, ByteTrack",
             TASK_CKPTS["yolo11n_pose_synth160"], "bytetrack.yaml", None,
             render_task("pose", T, S, seed=3)),
        ):
            pipes = {d: Pipeline(DetectorConfig(weights=weights, imgsz=160,
                                                half=False,
                                                max_det=16 if tracker else 300,
                                                quant="int8"),
                                 tracker=tracker or "bytetrack.yaml",
                                 track_slots=16, tracker_max_dets=16,
                                 reid_weights=reid, device=d)
                     for d in ("cuda", "cpu")}
            t0 = time.perf_counter()
            pipes["cuda"].calibrate_int8([clip[0, 0]])
            _share_scales(pipes["cuda"], pipes["cpu"])
            if tracker is None:
                _int8_det_parity(label, pipes, list(clip.reshape(
                    -1, *clip.shape[2:])))
                log(f"{label}: {time.perf_counter() - t0:.1f} s")
                continue
            def steps(p):
                bp = BatchedPipeline(p, S, clip.shape[2:4])
                return [bp.step(clip[t]) for t in range(T)]

            _int8_parity(label, steps(pipes["cpu"]), _witness_plain(
                label, lambda: steps(pipes["cuda"])))
    return k8, checks, pose, v7


def phase_int8_app(card: str, kernels) -> None:
    """8e: cli.main --quant int8 on two 1080p mp4 files (in memory where no
    encoder works), the sequential and the batched loop: the JAX app's
    calibration line once per stream's loop and once per batched group,
    K8 launched, every stream's frames processed."""
    import contextlib
    import io

    from strongsort_yolo_tpu_torch import cli
    from strongsort_yolo_tpu_torch.media.video import SyntheticSource

    n_frames = 4
    with tempfile.TemporaryDirectory() as tmp:
        srcs = [SyntheticSource(num_frames=n_frames, size=(1080, 1920),
                                num_objects=6, seed=s) for s in range(2)]
        weights = app_checkpoint(next(iter(srcs[0])), tmp)
        paths, how = _write_sources(srcs, tmp, n_frames)
        if paths is None:
            raise AssertionError(f"8e: {how}")
        for mode, lines in (("sequential", 2), ("batched", 1)):
            for k in kernels:
                k.launches = 0
            out = io.StringIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(out):
                rc = cli.main(["--source", *paths, "--track", "--weights",
                               weights, "--imgsz", "640", "--quant", "int8",
                               "--multi-mode", mode, "--output",
                               os.path.join(tmp, mode)])
            secs = time.perf_counter() - t0
            text = out.getvalue()
            counts = {k.__name__: k.launches for k in kernels}
            n_cal = text.count("[INFO] int8: calibrated 32 convs")
            log(f"8e cli.main --quant int8, {mode}, 2 x {n_frames} 1080p "
                f"frames ({how}): rc {rc}, calibration lines {n_cal}, "
                f"launches {counts}, {secs:.2f} s [{card}]")
            if rc != 0 or n_cal != lines or min(counts.values()) == 0:
                raise AssertionError(f"8e {mode}: rc {rc}, {n_cal} calibration "
                                     f"lines, launches {counts}:\n{text}")
            if text.count(f"frames={n_frames}") != 2:
                raise AssertionError(f"8e {mode}: streams did not finish:\n{text}")


def phase_host_gmc(card: str) -> None:
    """8f, the host GMC: BoT-SORT (botsort.yaml, sparseOptFlow) on two panned
    1080p streams and StrongSORT (strongsort.yaml, ecc, the trained OSNet)
    on two panned 320 x 320 ones, the trained synth160 detector (imgsz
    160, f32), card against CPU: the warps equal bit for bit (both come
    from OpenCV on this host) and the tracks equal; then the host ms per
    1080p frame of each estimator."""
    from strongsort_yolo_tpu_torch.config import DetectorConfig
    from strongsort_yolo_tpu_torch.pipeline import BatchedPipeline, Pipeline
    from strongsort_yolo_tpu_torch.track.gmc import SparseOptFlowGMC

    T = 6
    scene = panned_scene(1080, 1920)
    big = np.stack([np.stack([np.roll(scene, (t * dy, t * dx), axis=(0, 1))
                              for dx, dy in ((12, -6), (-6, 12))])
                    for t in range(T)])
    small = np.stack([np.stack([np.roll(f, (t * 3, -t * 2), axis=(0, 1))
                                for t, f in enumerate(
                                    render_synthetic(T, seed=s + 1))])
                      for s in range(2)], axis=1)
    for tracker, reid, frames in (("botsort.yaml", None, big),
                                  ("strongsort.yaml", OSNET, small)):
        outs, warps = {}, {}
        for device in ("cuda", "cpu"):
            pipe = Pipeline(DetectorConfig(weights=CKPT, imgsz=160, half=False,
                                           max_det=16),
                            tracker=tracker, track_slots=16,
                            tracker_max_dets=16, reid_weights=reid,
                            device=device)
            bp = BatchedPipeline(pipe, 2, frames.shape[2:4])
            outs[device], warps[device] = [], []
            for t in range(T):
                outs[device].append(bp.step(frames[t]))
                warps[device].append(bp.last_warps.cpu().numpy())
        if not np.array_equal(np.stack(warps["cuda"]), np.stack(warps["cpu"])):
            raise AssertionError(f"host GMC {tracker}: the warps differ")
        rows = 0
        for t in range(T):
            for s in range(2):
                a, b = outs["cpu"][t][s].boxes, outs["cuda"][t][s].boxes
                if len(a) != len(b) or not np.array_equal(a.id, b.id):
                    raise AssertionError(f"host GMC {tracker} t={t} s={s}")
                np.testing.assert_allclose(b.xyxy, a.xyxy, atol=1e-3)
                rows += len(a)
        shift = float(np.abs(np.stack(warps["cuda"])[..., 2]).max())
        if shift < 1.0:
            raise AssertionError(f"host GMC {tracker}: no pan estimated")
        log(f"host GMC {tracker}: 2 panned {frames.shape[2]}x"
            f"{frames.shape[3]} streams x {T} ticks, warps card == CPU bit "
            f"for bit (largest shift {shift:.2f} px), {rows} track rows, "
            f"same ids, boxes within 1e-3")
    for method, n in (("sparseOptFlow", T), ("ecc", 3)):
        gmc, times = SparseOptFlowGMC(method), []
        for t in range(n):
            t0 = time.perf_counter()
            gmc.apply(big[t, 0])
            times.append((time.perf_counter() - t0) * 1e3)
        log(f"host GMC {method} at 1080p on this host: "
            f"{[round(x, 2) for x in times]} ms per frame (the first has no "
            f"previous frame), median after it {np.median(times[1:]):.2f} "
            f"(host clock) [{card}]")


def host_gmc_full_width(card: str) -> None:
    """8f, the default tracker at full width: yolov8n 640 bf16, S=8 1080p,
    botsort.yaml (its sparseOptFlow on the host: compute_warps runs the S
    estimates one after another before each dispatch) and BoT-SORT with
    flow_tpu (K5) on the same panned ticks (PANS), a tick of each in
    turns: ms per tick (host clock, synchronized), K5 launched on the
    flow_tpu ticks only, and compute_warps alone on the same ticks."""
    import torch

    from strongsort_yolo_tpu_torch.ops.cuda.lk_kernel import lk_pyramid
    from strongsort_yolo_tpu_torch.pipeline import BatchedPipeline
    from strongsort_yolo_tpu_torch.track.bytetrack import ByteTrackConfig

    h, w = 1080, 1920
    scene = panned_scene(h, w)
    ticks = [np.stack([np.roll(scene, (t * dy, t * dx), axis=(0, 1))
                       for dx, dy in PANS]) for t in range(TICKS)]
    bps = {name: BatchedPipeline(_main_pipeline(tracker, [scene]), S_MAIN,
                                 (h, w))
           for name, tracker in (
               ("botsort.yaml (host sparseOptFlow)", "botsort.yaml"),
               ("botsort gmc flow_tpu", ByteTrackConfig(
                   tracker_type="botsort", gmc_method="flow_tpu")))}
    name_host, name_flow = bps
    times = {name: [] for name in bps}
    k5 = {name: 0 for name in bps}
    warps = []
    for frames in ticks:
        for name, bp in bps.items():
            lk_pyramid.launches = 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            results = bp.step(frames)
            torch.cuda.synchronize()
            times[name].append((time.perf_counter() - t0) * 1e3)
            k5[name] += lk_pyramid.launches
            _check_results(f"8f {name}", results)
            if name == name_host:
                warps.append(bp.last_warps.cpu().numpy())
    est = BatchedPipeline(bps[name_host].pipeline, S_MAIN, (h, w))
    alone = []
    for frames in ticks:
        t0 = time.perf_counter()
        est.compute_warps(frames)
        alone.append((time.perf_counter() - t0) * 1e3)
    err = np.abs(np.stack(warps[1:])[:, :, :, 2]
                 - np.array(PANS, np.float32)).max()
    log(f"8f default tracker at full width, yolov8n 640 bf16, S={S_MAIN} "
        f"1080p, pans {PANS}, {TICKS} ticks of each in turns; ms/tick (host "
        f"clock, synchronized): " + "; ".join(
            f"{name} {_ms_line(t)}" for name, t in times.items())
        + f"; compute_warps alone (S={S_MAIN} host estimates) {_ms_line(alone)}"
        f"; K5 launches {k5}; host warps' max |translation - pan| ticks "
        f"1-{TICKS - 1} {err:.4f} px [{card}]")
    if k5[name_host] != 0 or k5[name_flow] != TICKS:
        raise AssertionError(f"8f: K5 launches {k5}")


def phase_int8(card: str, kernels: dict) -> dict:
    """Phase 8: the int8 slice (8b, 8a, 8c, 8d, 8e) and the host GMC.
    -> K8's entry of the kernels line."""
    from strongsort_yolo_tpu_torch.ops.cuda.quant_kernel import conv_s8
    from strongsort_yolo_tpu_torch.tools.prof_s8 import YOLOV8N_INT8

    k = kernels
    mark("phase 8b: the int8 main path")
    counts, calls = phase_int8_path(card, [k[n] for n in (
        "letterbox_u8", "nms_keep", "auction")] + [conv_s8])
    mark("phase 8d: the other families in int8")
    _, more, pose, v7 = phase_int8_families(card, list(k.values()) + [conv_s8])
    mark("phase 8a: K8 against its plain version")
    check_tensor_core_sass("conv_s8_gemm_kernel", "IGMMA", "K8 wgmma")
    check_no_div64(["conv_s8_quant_kernel", "conv_s8_gemm_kernel",
                    "conv_s8_dw_kernel"])
    err = check_k8_calls(calls, "yolov8n 640 S=8 (8b's tick)")
    err2 = check_k8_calls(more, "yolov5s s2, yolo11n-pose depthwise "
                          "and act=False (8d's ticks)")
    t0 = time.perf_counter()
    err3 = check_k8_calls(v7_classes(v7), "yolov7's classes (8d's tick: "
                          "1x1 C_in 1024 and 2048, 3x3 512->1024, C_out "
                          "1024, the widest plane, 3x3 s2)")
    log(f"K8 on yolov7's classes: {time.perf_counter() - t0:.1f} s")
    total = time_k8(card, calls, f"yolov8n 640 S={S_MAIN}", YOLOV8N_INT8)
    log(f"K8 over the 32 int8 convs of one yolov8n S={S_MAIN} 640 tick, bf16, "
        f"calibrated scales, device time (CUDA graph replay): kernel "
        f"{total['ms']:.4f} ms (first form: {total['first']:.4f} ms), plain "
        f"{total['plain']:.4f} ms (events), cuDNN bf16 conv + SiLU of the "
        f"dequantized weights {total['library']:.4f} ms (another function), "
        f"bound {total['bound']:.6f} ms ({total['by_ops']:.6f} of it from "
        f"convs bound by operations); kernel / bound "
        f"{total['ms'] / total['bound']:.1f}x, kernel / cuDNN "
        f"{total['ms'] / total['library']:.2f}x [{card}]")
    check_k8_bars(total)
    t0 = time.perf_counter()
    v7_total = time_k8(card, v7, f"yolov7 640 S={S_MAIN}")
    log(f"K8 over the {len(v7)} int8 convs of one yolov7 S={S_MAIN} 640 tick "
        f"(1080p frames), bf16, calibrated scales, device "
        f"time (CUDA graph replay): kernel {v7_total['ms']:.4f} ms, plain "
        f"{v7_total['plain']:.4f} ms (events), cuDNN bf16 conv + SiLU of the "
        f"dequantized weights {v7_total['library']:.4f} ms (another "
        f"function), bound {v7_total['bound']:.6f} ms "
        f"({v7_total['by_ops']:.6f} of it from convs bound by operations); "
        f"kernel / bound {v7_total['ms'] / v7_total['bound']:.1f}x (share "
        f"{100 * v7_total['bound'] / v7_total['ms']:.1f}%), kernel / cuDNN "
        f"{v7_total['ms'] / v7_total['library']:.2f}x; beside yolov8n's 32: "
        f"kernel {total['ms']:.4f} ms, cuDNN {total['library']:.4f} ms, "
        f"bound {total['bound']:.6f} ms ({time.perf_counter() - t0:.1f} s) "
        f"[{card}]")
    pose_total = time_k8(card, pose, f"yolo11n-pose 640 S={S_MAIN}")
    log(f"K8 over the {len(pose)} int8 convs of one yolo11n-pose S={S_MAIN} "
        f"640 tick (the depthwise one included), bf16, calibrated scales, "
        f"graph replay: kernel {pose_total['ms']:.4f} ms, cuDNN bf16 "
        f"{pose_total['library']:.4f} ms, bound {pose_total['bound']:.6f} ms "
        f"[{card}]")
    check_k8_dw_bar(pose_total)
    mark("phase 8c: the int8 quality guard, card against CPU")
    phase_int8_guard(card)
    mark("phase 8e: the int8 app")
    phase_int8_app(card, [k["letterbox_u8"], conv_s8])
    mark("phase 8f: the host GMC")
    phase_host_gmc(card)
    host_gmc_full_width(card)
    return dict(
        name="conv_s8", route="cuda",
        source="strongsort_yolo_tpu_torch/csrc/conv_s8.cu",
        replaces="strongsort_yolo_tpu/ops/quant.py:41 conv_int8_apply (an "
                 "XLA int8 conv, not a Pallas kernel)",
        launches=counts["conv_s8"], max_abs_err=max(err, err2, err3),
        ms=total["ms"], plain_ms=total["plain"], bound_ms=total["bound"],
        bound_by="operations" if total["by_ops"] >= total["bound"] / 2
        else "bytes",
        library_ms=total["library"],
    )


# -- phase 7: training ------------------------------------------------------

TRAIN_IMGSZ, TRAIN_BATCH = 160, 8  # the shipped detector's recipe


def phase_train_parity(card: str) -> None:
    """7a: three train steps from the trained asset, card against CPU."""
    from strongsort_yolo_tpu_torch.models import porting
    from strongsort_yolo_tpu_torch.tools.train import synthetic_batch
    from strongsort_yolo_tpu_torch.train.trainer import (
        make_optimizer, make_train_step, train_state,
    )

    rng = np.random.default_rng(0)
    batches = [synthetic_batch(rng, TRAIN_BATCH, TRAIN_IMGSZ) for _ in range(3)]
    tree, cfg, _ = porting.load_npz_checkpoint(CKPT)
    tx = make_optimizer(1e-3)
    step = make_train_step(cfg, TRAIN_IMGSZ, tx)
    curves, grads = {}, {}
    for device in ("cuda", "cpu"):
        model = porting.model_from_state_dict(
            porting.params_from_jax(tree, cfg), cfg).to(device)
        state = train_state(model, tx)
        curves[device] = []
        t0 = time.perf_counter()
        for i, (images, targets) in enumerate(batches):
            state, m = step(state, images, targets)
            curves[device].append({k: float(v) for k, v in m.items()})
            if i == 0:
                grads[device] = {k: t.grad.detach().cpu() for k, t in (
                    *model.named_parameters(), *model.named_buffers())}
        secs = time.perf_counter() - t0
        log(f"7a {device}: 3 train steps (yolov8n synth160, imgsz "
            f"{TRAIN_IMGSZ}, batch {TRAIN_BATCH}) losses "
            + ", ".join(f"{c['loss']:.6f}" for c in curves[device])
            + f", num_fg {[c['num_fg'] for c in curves[device]]}, {secs:.2f} s"
            + (f" [{card}]" if device == "cuda" else ""))
    loss_err = max(abs(a["loss"] - b["loss"]) / abs(b["loss"])
                   for a, b in zip(curves["cuda"], curves["cpu"]))
    fg_ok = all(a["num_fg"] == b["num_fg"] > 0
                for a, b in zip(curves["cuda"], curves["cpu"]))
    worst, worst_key = 0.0, None
    for k, g in grads["cpu"].items():
        err = float((grads["cuda"][k] - g).norm() / g.norm().clamp(min=1e-30))
        if err > worst:
            worst, worst_key = err, k
    log(f"7a card against CPU: losses within {loss_err:.3g} relative, num_fg "
        f"equal {fg_ok}, {len(grads['cpu'])} first-step gradients (BN "
        f"statistics included) within {worst:.3g} of their norm (worst "
        f"{worst_key})")
    if loss_err > 1e-4 or not fg_ok or worst > 1e-4:
        raise AssertionError("7a: the train step on the card differs from the "
                             "CPU's")


def _loss_line(res: dict, keys=("loss",)) -> str:
    (s0, m0), (s1, m1) = res["losses"][0], res["losses"][-1]
    warm = res["step_ms"][20:] or res["step_ms"]
    return (", ".join(f"{k} {m0[k]:.4f} -> {m1[k]:.4f}" for k in keys)
            + f" (steps {s0} -> {s1}), {float(np.median(warm)):.2f} ms per "
            f"step (median after 20, CUDA events), {res['seconds']:.2f} s")


def _falls(label: str, res: dict, keys=("loss",)) -> None:
    m0, m1 = res["losses"][0][1], res["losses"][-1][1]
    if not all(np.isfinite(m[k]) for m in (m0, m1) for k in m):
        raise AssertionError(f"{label}: a non-finite loss term: {m0}, {m1}")
    if not m1["loss"] < m0["loss"]:
        raise AssertionError(f"{label}: the loss did not fall: {m0} -> {m1}")


# The bars of 7b come from the spread of the recipe over initial draws:
# one training run is one draw. MOTA and IDF1 on the e2e clip of the JAX
# trainer from PRNG keys 0-9 (tests/jax_trainer_spread.py, JAX on a CPU),
# and of the port's from ``init_model`` seeds 0-13 (``tools/eval_e2e
# --train-seeds 0 ... 13`` on the card; each draw repeats run to run under
# ``exact_step``, but another cuDNN may re-draw them). Both sets include
# draws at or below the 0.8 that the shipped detector clears.
E2E_SPREAD = {
    "jax": {"mota": (0.9667, 0.9667, 0.9556, 0.9889, 0.8667, 0.9444, 0.8000,
                     0.8000, 0.7667, 0.8889),
            "idf1": (0.9831, 0.9831, 0.9783, 0.9944, 0.9333, 0.9171, 0.9091,
                     0.9091, 0.8934, 0.9444)},
    "port": {"mota": (0.7222, 0.9000, 0.8556, 1.0000, 0.9222, 1.0000, 0.8667,
                      0.9000, 0.7444, 0.9444, 0.9889, 0.6889, 0.9778, 0.8111),
             "idf1": (0.8387, 0.9474, 0.8402, 1.0000, 0.9622, 1.0000, 0.9333,
                      0.9080, 0.8535, 0.9714, 0.9945, 0.8614, 0.9888, 0.8710)},
}
E2E_SEEDS = (0, 1, 2, 3, 4, 5)  # the draws 7b trains, all at once


def e2e_bar(metric: str, n: int) -> float:
    """The JAX trainer's mean of ``metric`` less three standard errors of
    the difference between it and a mean over n draws of the port's, each
    trainer's spread taken from E2E_SPREAD. From the port's spread, the
    mean of n re-drawn runs falls below it fewer than once in 200 times;
    a trainer worse by that margin fails."""
    j = np.asarray(E2E_SPREAD["jax"][metric])
    p = np.asarray(E2E_SPREAD["port"][metric])
    se = math.sqrt(p.var(ddof=1) / n + j.var(ddof=1) / len(j))
    return float(j.mean() - 3 * se)


def phase_train_recipe(card: str, kernels, runs: list) -> None:
    """7b: the shipped detector's recipe trained on the card from the
    initial weights of each of E2E_SEEDS (``runs``: (seed, path, result of
    ``eval_e2e.train_recipe``)), each result served as
    tests/test_trained_e2e.py serves the shipped one: the mean MOTA and
    the mean IDF1 above :func:`e2e_bar`, the class test passed by every
    draw, K1-K3 launched on every frame, and the CPU's Pipeline on the
    first draw's file giving its tracks."""
    from strongsort_yolo_tpu_torch.tools.eval_e2e import (
        class_test, e2e_pipeline, track_clip,
    )

    for seed, _, res in runs:
        log(f"7b tools/train 600 steps on the card, seed {seed} ("
            f"{len(runs)} trainers and the OSNet trainer sharing the card): "
            + _loss_line(res, ("loss", "box_loss", "cls_loss", "dfl_loss"))
            + f" [{card}]")
        _falls("7b", res)
    results = {}
    for seed, path in [*((s, p) for s, p, _ in runs), (None, CKPT)]:
        label = "shipped" if seed is None else f"trained on the card, seed {seed}"
        pipe = e2e_pipeline(path, "cuda")
        _zero(kernels)
        m, rows = track_clip(pipe)
        counts = _counts(kernels)
        ok, cls_msg = class_test(pipe)
        classes = sorted({int(c) for _, _, cls in rows for c in cls})
        results[seed] = (m, rows)
        log(f"7b {label} checkpoint served on the card, 30 SyntheticDetSource "
            f"frames: MOTA {m['mota']:.4f} IDF1 {m['idf1']:.4f} IDsw "
            f"{m['idsw']}, classes found {classes}; class test {ok} "
            f"({cls_msg}); launches {counts}")
        if min(counts.values()) < 30:
            raise AssertionError(f"7b: a kernel was not launched on every "
                                 f"frame: {counts}")
        if not ok:
            raise AssertionError(f"7b {label}: the class test failed: {cls_msg}")
    means = {k: float(np.mean([results[s][0][k] for s, _, _ in runs]))
             for k in ("mota", "idf1")}
    bars = {k: e2e_bar(k, len(runs)) for k in means}
    log(f"7b the trainer over seeds {E2E_SEEDS}: mean MOTA {means['mota']:.4f} "
        f"(bar {bars['mota']:.4f}), mean IDF1 {means['idf1']:.4f} (bar "
        f"{bars['idf1']:.4f}); the JAX trainer's means over keys 0-9: "
        + ", ".join(f"{k} {np.mean(E2E_SPREAD['jax'][k]):.4f}" for k in means))
    if not all(means[k] > bars[k] for k in means):
        raise AssertionError("7b: the detectors trained on the card fall "
                             "below the JAX trainer's spread")
    seed, path, _ = runs[0]
    rows = results[seed][1]
    _, cpu_rows = track_clip(e2e_pipeline(path, "cpu"))
    for t, ((ia, ba, _), (ib, bb, _)) in enumerate(zip(cpu_rows, rows)):
        if not np.array_equal(ia, ib):
            raise AssertionError(f"7b: frame {t}: ids {ib} on the card, {ia} "
                                 "on the CPU")
        np.testing.assert_allclose(bb, ba, atol=1e-3, err_msg=f"7b frame {t}")
    log(f"7b the seed-{seed} checkpoint on the CPU's Pipeline: the same "
        f"ids and boxes within 1e-3 px on 30 frames "
        f"({sum(len(i) for i, _, _ in rows)} track rows)")


def phase_train_tasks(card: str, tmp: str) -> None:
    """7c: segment and pose, 50 steps each (cut from 100 to keep phase 7
    near its time budget), then served with their task."""
    from strongsort_yolo_tpu_torch.config import DetectorConfig
    from strongsort_yolo_tpu_torch.pipeline import Pipeline
    from strongsort_yolo_tpu_torch.tools import train

    for model, extra, keys, task in (
        ("yolov8n-seg", [], ("loss", "seg_loss"), "segment"),
        ("yolov8n-pose", ["--kpt", "5"], ("loss", "kpt_loss", "kobj_loss"),
         "pose"),
    ):
        path = os.path.join(tmp, model + ".npz")
        res = train.main(["--synthetic", "--model", model, *extra, "--nc", "3",
                          "--steps", "50", "--imgsz", "160", "--save", path,
                          "--device", "cuda", "--log-every", "49"])
        log(f"7c {model} 50 steps on the card: " + _loss_line(res, keys)
            + f" [{card}]")
        _falls(f"7c {model}", res, keys)
        pipe = Pipeline(DetectorConfig(weights=path, imgsz=160, half=False,
                                       max_det=16),
                        tracker="bytetrack.yaml", track_slots=16,
                        tracker_max_dets=16, device="cuda")
        if pipe.model_cfg.task != task:
            raise AssertionError(f"7c {model}: served as {pipe.model_cfg.task}")
        frame = render_task(task, 1, 1, seed=3)[0, 0]
        r = pipe.track(frame)
        extra_rows = r.keypoints if task == "pose" else r.masks
        if extra_rows is None and len(r):
            raise AssertionError(f"7c {model}: no {task} extras")
        log(f"7c {model}: served as {task} on the card, {len(r)} rows on a "
            "rendered frame")


def phase_train_full_width(card: str) -> dict:
    """7d: the full-width step at imgsz 640, 10 steps each (cut from 20 to
    keep phase 7 near its time budget), and yolov8n's in bfloat16. ->
    the yolov8n float32 record."""
    import torch

    from strongsort_yolo_tpu_torch.tools import train

    out = None
    for model, batch in (("yolov8n", 16), ("yolov8n-seg", 4)):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        res = train.main(["--synthetic", "--model", model, "--steps", "10",
                          "--imgsz", "640", "--batch", str(batch), "--device",
                          "cuda", "--log-every", "1"])
        peak = torch.cuda.max_memory_allocated() / 2**30
        ms = res["step_ms"]
        log(f"7d {model} imgsz 640 batch {batch}, 10 steps: median "
            f"{float(np.median(ms[5:])):.2f} ms per step after 5 (first "
            f"{ms[0]:.1f}), peak allocated {peak:.2f} GiB, losses "
            + ", ".join(f"{m['loss']:.4f}" for _, m in res["losses"])
            + f" [{card}]")
        if not all(np.isfinite(v) for _, m in res["losses"] for v in m.values()):
            raise AssertionError(f"7d {model}: non-finite losses")
        out = out or res
    train_bf16(card, out)
    return out


def train_bf16(card: str, f32: dict) -> None:
    """7d in bfloat16: tools/train's yolov8n recipe of 7d (seed 0, the
    synthetic batches of data seed 0, batch 16, imgsz 640, 10 steps)
    through make_train_step(compute_dtype=torch.bfloat16), which the
    tool takes no flag for; ms per step by CUDA events, peak memory, the
    losses beside the float32 run's ``f32``."""
    import torch

    from strongsort_yolo_tpu_torch.models.yolo import build_model
    from strongsort_yolo_tpu_torch.tools.train import _StepTimer, synthetic_batch
    from strongsort_yolo_tpu_torch.train.trainer import (
        init_train_state, make_optimizer, make_train_step,
    )

    cfg = build_model("yolov8n")
    tx = make_optimizer(1e-3)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    state = init_train_state(0, cfg, tx, torch.device("cuda"))
    step = make_train_step(cfg, 640, tx, compute_dtype=torch.bfloat16)
    rng = np.random.default_rng(0)
    timer, losses = _StepTimer(torch.device("cuda")), []
    for _ in range(10):
        images, targets = synthetic_batch(rng, 16, 640)
        timer.start()
        state, metrics = step(state, images, targets)
        timer.stop()
        losses.append({k: float(v) for k, v in metrics.items()})
    ms = timer.ms()
    peak = torch.cuda.max_memory_allocated() / 2**30
    if not all(m["num_fg"] > 0 and all(np.isfinite(v) for v in m.values())
               for m in losses):
        raise AssertionError(f"7d bf16: losses {losses}")
    if any(t.dtype != torch.float32 for t in state.opt.param_groups[0]["params"]):
        raise AssertionError("7d bf16: a trained tensor left float32")
    f32_loss = [m["loss"] for _, m in f32["losses"]]
    log(f"7d yolov8n bf16 (compute_dtype=torch.bfloat16, float32 masters) "
        f"imgsz 640 batch 16, 10 steps: median {float(np.median(ms[5:])):.2f} "
        f"ms per step after 5 (first {ms[0]:.1f}; float32 "
        f"{float(np.median(f32['step_ms'][5:])):.2f}), peak allocated "
        f"{peak:.2f} GiB; losses "
        + ", ".join(f"{m['loss']:.4f}" for m in losses)
        + " (float32: " + ", ".join(f"{v:.4f}" for v in f32_loss)
        + f") [{card}]")


def phase_train_osnet(card: str, out: str, res: dict) -> None:
    """7e: the OSNet trainer's recipe trained on the card (``res``, its
    checkpoint ``out``), then K7's gradient."""
    import torch

    from strongsort_yolo_tpu_torch.config import DetectorConfig
    from strongsort_yolo_tpu_torch.ops.cuda.conv_kernel import (
        conv_act_nchw, conv_act_plain,
    )
    from strongsort_yolo_tpu_torch.pipeline import Pipeline
    from strongsort_yolo_tpu_torch.track.strongsort import StrongSortConfig

    log("7e tools/train_osnet 1200 steps on the card (beside 7b's "
        "trainers): random-init rank-1 "
        f"{res['rank1_init']:.4f}; " + ", ".join(
            f"step {s} loss {l:.4f} rank-1 {r:.4f}"
            for (s, l), (_, r) in zip(res["losses"], res["rank1"]))
        + f"; {res['seconds']:.2f} s [{card}]")
    final = res["rank1"][-1][1]
    if not res["losses"][-1][1] < res["losses"][0][1] or final < 0.9:
        raise AssertionError(f"7e: loss {res['losses']}, rank-1 {final}")
    pipe = Pipeline(DetectorConfig(weights=CKPT, imgsz=160, half=False,
                                   max_det=16),
                    tracker=StrongSortConfig(gmc_method="none"),
                    track_slots=16, tracker_max_dets=16, reid_topk=16,
                    reid_weights=out, device="cuda")
    r = [pipe.track(f) for f in render_synthetic(4)][-1]
    log(f"7e the card's OSNet served by the StrongSORT Pipeline: {len(r)} "
        "rows on the 4th rendered frame")
    dev = torch.device("cuda")
    rng = np.random.default_rng(8)
    for h, w, c_in, c_out, k in sorted(K7_REQUIRED)[:2]:
        x = torch.from_numpy(rng.normal(0, 1, (2, c_in, h, w)).astype(
            np.float32)).to(dev)
        wt = torch.from_numpy((rng.normal(0, 1, (k * k * c_in, c_out))
                               * (2.0 / (k * k * c_in)) ** 0.5).astype(
                                   np.float32)).to(dev)
        b = torch.from_numpy(rng.normal(0, 0.3, c_out).astype(np.float32)).to(dev)
        r_out = torch.from_numpy(rng.normal(0, 1, (2, c_out, h, w)).astype(
            np.float32)).to(dev)
        grads = []
        for fn in (conv_act_nchw, lambda *a, **kw: conv_act_plain(
                *a, layout="nchw", **kw)):
            leaves = [t.clone().requires_grad_() for t in (x, wt, b)]
            (fn(*leaves, k=k, act=True) * r_out).sum().backward()
            grads.append([t.grad for t in leaves])
        errs = [float(((g - p).abs() / p.abs().clamp(min=1.0)).max())
                for g, p in zip(*grads)]
        log(f"7e K7 gradient on the card, conv ({h}x{w}, {c_in}->{c_out}, "
            f"k={k}) float32, S=2: dx, dw, db within "
            + ", ".join(f"{e:.3g}" for e in errs)
            + " x max(1, |g|) of the plain version's autograd")
        if max(errs) > 1e-5:
            raise AssertionError(f"7e: K7's gradient differs: {errs}")


def phase_training(card: str, kernels: dict) -> dict:
    """Phase 7: training on the card. The trainers of 7b and 7e, each
    bound by its own host thread, run at once in processes of their own
    while 7a runs; 7c and 7d, which are timed, run after them. -> 7d's
    yolov8n float32 record (tools/train's)."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    from strongsort_yolo_tpu_torch.tools import eval_e2e, train_osnet

    with tempfile.TemporaryDirectory() as tmp:
        osnet_out = os.path.join(tmp, "osnet_card.npz")
        paths = [os.path.join(tmp, f"yolov8n_synth160_card{s}.npz")
                 for s in E2E_SEEDS]
        mark("phase 7b/7e: the trainers start, all at once")
        with ProcessPoolExecutor(len(E2E_SEEDS) + 1, multiprocessing.get_context(
                "spawn")) as pool:
            osnet_job = pool.submit(train_osnet.main, [
                "--steps", "1200", "--device", "cuda", "--out", osnet_out])
            det_jobs = [pool.submit(eval_e2e.train_recipe, s, p, "cuda")
                        for s, p in zip(E2E_SEEDS, paths)]
            mark("phase 7a: the train step, card against CPU")
            phase_train_parity(card)
            runs = [(s, p, j.result())
                    for s, p, j in zip(E2E_SEEDS, paths, det_jobs)]
            mark("phase 7b: the shipped detector's recipe on the card, served")
            phase_train_recipe(card, [kernels[n] for n in (
                "letterbox_u8", "nms_keep", "auction")], runs)
            osnet_res = osnet_job.result()
        mark("phase 7e: the OSNet trainer and K7's gradient")
        phase_train_osnet(card, osnet_out, osnet_res)
        mark("phase 7c: segment and pose training")
        phase_train_tasks(card, tmp)
        mark("phase 7d: the full-width step at 640")
        return phase_train_full_width(card)


def phase_demo(card: str) -> None:
    """5 (the demo tool): tools/make_demo's three images rendered on the
    card and on the CPU into a temporary directory; their decoded pixels
    must be equal (the Results drawn are phase 4's trained checkpoints,
    card == CPU)."""
    from strongsort_yolo_tpu_torch.media.video import _cv2
    from strongsort_yolo_tpu_torch.tools import make_demo

    cv2 = _cv2()
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        card_paths = make_demo.main([os.path.join(tmp, "card"), "--device",
                                     "cuda"])
        seconds = time.perf_counter() - t0
        cpu_paths = make_demo.main([os.path.join(tmp, "cpu"), "--device", "cpu"])
        for a, b in zip(card_paths, cpu_paths):
            got, want = cv2.imread(a), cv2.imread(b)
            differ = int((got != want).any(-1).sum())
            log(f"make_demo {os.path.basename(a)} {got.shape}: {differ} pixels "
                f"differ card vs CPU")
            if differ:
                raise AssertionError(f"make_demo {a}: card != CPU")
    log(f"make_demo on the card: 3 images in {seconds:.2f} s [{card}]")


def _mesh_devices(n: int) -> list[str]:
    """n mesh positions: distinct cards where there are n, else cuda:0
    named n times."""
    import torch

    if torch.cuda.device_count() >= n:
        return [f"cuda:{k}" for k in range(n)]
    return ["cuda:0"] * n


def _block_counts(sharded, kernels) -> list[dict]:
    """Per block of ``sharded``, the launches of each of ``kernels`` made
    inside that block's halves of a tick (the host queues the blocks one
    after another, so the count moved inside a call is that block's)."""
    per = [{k.__name__: 0 for k in kernels} for _ in sharded.blocks]
    for b, counts in zip(sharded.blocks, per):
        for name in ("_start", "_finish"):
            real = getattr(b, name)

            def counted(*a, real=real, counts=counts):
                before = {k.__name__: k.launches for k in kernels}
                try:
                    return real(*a)
                finally:
                    for k in kernels:
                        counts[k.__name__] += k.launches - before[k.__name__]

            setattr(b, name, counted)
    return per


def phase_mesh_serving(card: str, kernels) -> None:
    """9a: the S=8 1080p path over a dp=2 mesh (two cards where there are
    two, else cuda:0 twice), ByteTrack and StrongSORT with the fused
    OSNet and gmc flow_tpu (the panned scene), 10 ticks each: in float32
    without TF32, sharded against the unsharded BatchedPipeline (the same
    rows and ids, boxes within 1e-3 px); each block's K1-K6 launches
    equal to the unsharded path's; then both in bf16, ms per tick."""
    import torch

    from strongsort_yolo_tpu_torch.config import DetectorConfig
    from strongsort_yolo_tpu_torch.parallel.mesh import make_mesh
    from strongsort_yolo_tpu_torch.pipeline import BatchedPipeline, Pipeline
    from strongsort_yolo_tpu_torch.track.bytetrack import ByteTrackConfig
    from strongsort_yolo_tpu_torch.track.strongsort import StrongSortConfig

    h, w = 1080, 1920
    mesh = make_mesh(2, devices=_mesh_devices(2))
    pool = make_frames(h, w)
    scene = panned_scene(h, w)
    names = [k.__name__ for k in kernels]
    paths = (
        ("bytetrack", ByteTrackConfig(tracker_type="bytetrack"), False,
         [np.stack([pool[(s + t) % len(pool)] for s in range(S_MAIN)])
          for t in range(TICKS)], names[:3]),
        ("strongsort fused flow_tpu", StrongSortConfig(gmc_method="flow_tpu"),
         True, [np.stack([np.roll(scene, (t * dy, t * dx), axis=(0, 1))
                          for dx, dy in PANS]) for t in range(TICKS)], names),
    )
    for label, tracker, fused, ticks, needed in paths:
        for half in (False, True):
            pipe = Pipeline(
                DetectorConfig(weights="yolov8n", imgsz=640, half=half,
                               max_det=1000),
                tracker=tracker, track_slots=256, tracker_max_dets=128,
                reid_topk=128, reid_fused=fused, seed=0, device="cuda")
            calibrate_candidates(pipe, ticks[0][0], pipe.det_cfg.conf,
                                 TARGET_DETS)
            runs = {}
            for name in ("unsharded", "sharded"):
                bp = (BatchedPipeline(pipe, S_MAIN, (h, w)) if name ==
                      "unsharded" else pipe.track_batch_prepare(
                          S_MAIN, (h, w), mesh=mesh))
                per = _block_counts(bp, kernels) if name == "sharded" else None
                results = []
                counts, times, _ = _drive(
                    bp, ticks, kernels, lambda b, r: results.append(r))
                runs[name] = (counts, times, results, per)
            counts, times, results, _ = runs["unsharded"]
            _, s_times, s_results, per = runs["sharded"]
            dtype = "bf16" if half else "float32"
            if not half:
                rows = 0
                for t, (want, got) in enumerate(zip(results, s_results)):
                    for i, (a, b) in enumerate(zip(want, got)):
                        if len(a) != len(b) or not np.array_equal(
                                a.boxes.id, b.boxes.id) or not np.allclose(
                                    a.boxes.xyxy, b.boxes.xyxy, atol=1e-3):
                            raise AssertionError(
                                f"9a {label}: tick {t} stream {i} sharded != "
                                "unsharded")
                        rows += len(a)
                _check_results(f"9a {label}", results[-1])
                for k, c in enumerate(per):
                    if c != counts or not all(c[n] for n in needed):
                        raise AssertionError(
                            f"9a {label}: block {k} launched {c}, the "
                            f"unsharded path {counts}")
                log(f"9a {label}, S={S_MAIN} 1080p over dp=2 on {mesh.flat()} "
                    f"float32: {TICKS} ticks, {rows} rows, sharded == "
                    f"unsharded (ids equal, boxes within 1e-3 px); launches "
                    f"per block {per}, unsharded {counts}")
            else:
                log(f"9a {label} bf16 ms/tick: unsharded {_ms_line(times)}; "
                    f"sharded over dp=2 {_ms_line(s_times)} [{card}]")
            del pipe, runs


def probe_collectives(mesh) -> dict:
    """In each rank: which torch.distributed collectives this process
    group (gloo on a shared card, NCCL on distinct ones) completes on
    CUDA tensors. -> {name: "ok" or the error's first line}."""
    import torch
    import torch.distributed as dist

    dev = torch.device("cuda", torch.cuda.current_device())
    n, rank = dist.get_world_size(), dist.get_rank()
    x = torch.full((4,), float(rank + 1), device=dev)
    tries = {
        "all_reduce": lambda: dist.all_reduce(x.clone()),
        "broadcast": lambda: dist.broadcast(x.clone(), 0),
        "all_gather": lambda: dist.all_gather(
            [torch.empty_like(x) for _ in range(n)], x),
        "reduce_scatter": lambda: dist.reduce_scatter(
            torch.empty_like(x), [x.clone() for _ in range(n)]),
        "all_to_all": lambda: dist.all_to_all(
            [torch.empty_like(x) for _ in range(n)],
            [x.clone() for _ in range(n)]),
    }
    out = {}
    for name, run in tries.items():
        try:  # a probe: what fails is reported, and the ranks go on
            run()
            torch.cuda.synchronize()
            out[name] = "ok"
        except (RuntimeError, ValueError) as err:
            out[name] = str(err).splitlines()[0][:80]
        dist.barrier()
    return out


def phase_mesh_training(card: str, ref: dict) -> None:
    """9b: tools/train over dp=2 (two processes: gloo on one card, NCCL on
    two), yolov8n imgsz 640 batch 16 (8 a rank), 10 steps, against 7d's
    one-process run ``ref``: the first step's loss within 1e-6 relative
    (the CPU test's bar), every step's printed; ms per step. Then tp=2,
    three steps, where the group can gather CUDA tensors (NCCL on two
    cards; gloo on one, if its probe says all_gather runs). First, which
    collectives the process group takes on CUDA tensors."""
    import torch

    from strongsort_yolo_tpu_torch.parallel.mesh import make_mesh
    from strongsort_yolo_tpu_torch.parallel.ranks import backend_for, launch
    from strongsort_yolo_tpu_torch.tools import train

    mesh = make_mesh(2, devices=_mesh_devices(2))
    probe = launch(probe_collectives, mesh, timeout=300, pg_timeout=60)
    log(f"9b {backend_for(mesh)} on {mesh.flat()}, collectives on CUDA "
        f"tensors: {probe[0]}")
    if probe[0]["all_reduce"] != "ok":
        raise AssertionError("9b: the process group cannot all_reduce CUDA "
                             "tensors, which dp needs")
    base = ["--synthetic", "--model", "yolov8n", "--imgsz", "640", "--batch",
            "16", "--device", "cuda", "--log-every", "1"]
    want = [m["loss"] for _, m in ref["losses"]]
    layouts = [("dp=2", ["--dp", "2", "--steps", "10"])]
    if torch.cuda.device_count() >= 2 or probe[0]["all_gather"] == "ok":
        layouts.append(("tp=2", ["--dp", "1", "--tp", "2", "--steps", "3"]))
    else:
        log("9b tp: not held on the card (one card, whose gloo group cannot "
            "all_gather CUDA tensors)")
    for label, flags in layouts:
        t0 = time.perf_counter()
        res = train.main([*base, *flags])
        seconds = time.perf_counter() - t0
        got = [m["loss"] for _, m in res["losses"]]
        rel = [abs(g - w) / abs(w) for g, w in zip(got, want)]
        ms, warm = res["step_ms"], min(5, len(res["step_ms"]) - 1)
        log(f"9b {label} yolov8n 640 batch 16 on {_mesh_devices(2)}: losses "
            + ", ".join(f"{v:.6f}" for v in got) + " (one process: "
            + ", ".join(f"{v:.6f}" for v in want[:len(got)])
            + f"), relative differences {[f'{r:.1e}' for r in rel]}; median "
            f"{float(np.median(ms[warm:])):.2f} ms per step after {warm} "
            f"(rank 0, CUDA events; first {ms[0]:.1f}; one process "
            f"{float(np.median(ref['step_ms'][5:])):.2f} after 5); "
            f"{seconds:.1f} s with the ranks' start [{card}]")
        if not rel[0] <= 1e-6 or res["losses"][0][1]["num_fg"] <= 0:
            raise AssertionError(f"9b {label}: first loss {got[0]} vs {want[0]}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a GPU",
              file=sys.stderr)
        return 1
    if not os.path.isdir(os.path.join(ROOT, "strongsort_yolo_tpu_torch")):
        print("chip_smoke: strongsort_yolo_tpu_torch/ is not beside this "
              "script; run it from the root of a checkout", file=sys.stderr)
        return 1
    from strongsort_yolo_tpu_torch.ops.cuda.auction_kernel import auction
    from strongsort_yolo_tpu_torch.ops.cuda.conv_kernel import conv_act
    from strongsort_yolo_tpu_torch.ops.cuda.crop_kernel import banded_crop
    from strongsort_yolo_tpu_torch.ops.cuda.lk_kernel import lk_pyramid
    from strongsort_yolo_tpu_torch.ops.cuda.nms_kernel import nms_keep
    from strongsort_yolo_tpu_torch.ops.cuda.osnet_kernel import os_stage
    from strongsort_yolo_tpu_torch.ops.cuda.resize_kernel import letterbox_u8

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    card = card_line()
    mark("phase 1: environment and build")
    phase_environment()
    mark("phase 2: kernels against their plain versions")
    report = phase_kernels(card)
    mark("phase 3: main paths")
    _, none_ms = phase_main_path(card, (letterbox_u8, nms_keep, auction))
    ss_counts, k4, ss_ms, ss_pipe, ss_ticks, ss_g = phase_strongsort_path(
        card, (letterbox_u8, nms_keep, auction, banded_crop))
    fused_counts = phase_fused_strongsort_path(
        card, (letterbox_u8, nms_keep, auction, banded_crop, os_stage),
        (ss_ms, ss_pipe, ss_ticks, ss_g))
    del ss_pipe
    phase_wide_reid_path(
        card, (letterbox_u8, nms_keep, auction, banded_crop, os_stage))
    phase_crowd_path(card, (letterbox_u8, nms_keep, auction))
    counts, flow_ms = phase_flow_path(
        card, (letterbox_u8, nms_keep, auction, lk_pyramid))
    log(f"botsort median ms/tick, S={S_MAIN} 1080p: gmc none {none_ms:.2f}, "
        f"flow_tpu {flow_ms:.2f} [{card}]")
    task_counts = phase_task_paths(card, (letterbox_u8, nms_keep, auction),
                                   conv_act)
    mark("phase 3: the v5 and v7 detector paths")
    phase_detector_paths(card, {k.__name__: k for k in (
        letterbox_u8, nms_keep, auction, banded_crop, os_stage)})
    mark("phase 3b: the asynchronous API, step loop against overlapped loop")
    phase_async_paths(card)
    counts["banded_crop"] = ss_counts["banded_crop"]
    counts["os_stage"] = fused_counts["os_stage"]
    counts["conv_act"] = task_counts["conv_act"]
    for entry in report:
        entry["launches"] = counts[entry["name"]]
        if entry["name"] == "banded_crop":
            entry.update(k4)
    mark("phase 4: card against CPU on trained checkpoints")
    phase_trained_checkpoint()
    phase_trained_tasks(conv_act)
    mark("phase 4: Queue C's quality bars on the card")
    phase_quality_bars(card)
    phase_fabricated_checkpoints()
    mark("phase 5: the app and CLI")
    phase_app(card, {k.__name__: k for k in (
        letterbox_u8, nms_keep, auction, lk_pyramid, banded_crop, os_stage)})
    mark("phase 5: the demo tool")
    phase_demo(card)
    phase_offline(card, {k.__name__: k for k in (
        letterbox_u8, nms_keep, auction, lk_pyramid, banded_crop)})
    train_ref = phase_training(card, {k.__name__: k for k in (
        letterbox_u8, nms_keep, auction)})
    report.append(phase_int8(card, {k.__name__: k for k in (
        letterbox_u8, nms_keep, auction, banded_crop, os_stage)}))
    mark("phase 9a: serving over a dp=2 mesh")
    phase_mesh_serving(card, (letterbox_u8, nms_keep, auction, lk_pyramid,
                              banded_crop, os_stage))
    mark("phase 9b: training over dp=2")
    phase_mesh_training(card, train_ref)
    mark("done")
    log(json.dumps({"kernels": [
        {k: e[k] for k in ("name", "route", "source", "replaces", "launches",
                           "max_abs_err", "ms", "plain_ms", "bound_ms",
                           "bound_by", "library_ms")}
        for e in report
    ]}))
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
