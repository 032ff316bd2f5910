"""The port's ``.pt`` loading against the JAX package's, on real-format
files: ``torch.save`` of an ``nn.Module`` tree whose classes pickle under
``ultralytics.nn.tasks`` / ``ultralytics.nn.modules`` / ``ultralytics.utils``
(``chip_smoke.save_ultralytics``: the modules exist only while the file is
written), in the
ultralytics key layout (the inverse maps of tests/test_porting.py) of
yolov8n, yolo11n-pose, yolov5n, yolov5nu and yolov7 (RepConv in its
training and its deployed form, with and without IDetect's implicit
layers), and torchreid OSNet-x0_25 files (a bare state_dict,
``{"state_dict": ...}``, ``module.`` prefixes).

For each file: the port's tree equals the JAX loader's leaf for leaf, the
inferred configs agree, and the Pipeline takes the file as ``weights``
(or ``reid_weights``) on the CPU. The JAX loader's stub modules make a
submodule only when an attribute reaches it, which importing a pickled
class path does not; the test reaches the file's paths through the JAX
stub first (the port's loader needs no such step) and removes every
``ultralytics`` module afterwards. Each file is loaded by the port, then
by the JAX package, then by the port again, with the JAX stub installed.
"""

import os
import sys
import jax
import numpy as np
import pytest
import torch
from strongsort_yolo_tpu.models import porting as jporting
from strongsort_yolo_tpu.models import yolo as jyolo
from strongsort_yolo_tpu.models import yolov5 as jv5
from strongsort_yolo_tpu.models import yolov7 as jv7
from strongsort_yolo_tpu.models.osnet import OsnetConfig as JOsnetConfig
from strongsort_yolo_tpu.models.osnet import init_osnet as jinit_osnet
from strongsort_yolo_tpu_torch.config import DetectorConfig
from strongsort_yolo_tpu_torch.models import porting as tporting
from strongsort_yolo_tpu_torch.pipeline import Pipeline
from strongsort_yolo_tpu_torch.track.strongsort import StrongSortConfig

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import chip_smoke  # noqa: E402
from tests.test_porting import (  # noqa: E402
    _export_bottleneck,
    _export_branch,
    _export_conv,
    _export_conv2d,
    export_osnet_state_dict,
    export_state_dict,
    export_v7_state_dict,
)

NAMES = {i: f"class{i}" for i in range(80)}


@pytest.fixture(autouse=True)
def _clean_ultralytics():
    """No ultralytics module before or after a test."""
    def drop():
        for k in [k for k in sys.modules
                  if k == "ultralytics" or k.startswith("ultralytics.")]:
            del sys.modules[k]

    drop()
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
    drop()


def save_ultralytics(path, sd, **kw):
    chip_smoke.save_ultralytics(path, sd, NAMES, **kw)
    assert "ultralytics" not in sys.modules


def _flat(tree, prefix=""):
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}/"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_flat(v, f"{prefix}{i}/"))
    elif tree is not None:
        out[prefix[:-1]] = np.asarray(tree)
    return out


def assert_same_tree(got, want):
    got, want = _flat(got), _flat(want)
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == np.float32, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def jax_load(fn, path):
    """The JAX loader on ``path``, its stub modules reaching the file's
    class paths first."""
    jporting._install_ultralytics_stubs()
    stub = sys.modules["ultralytics"]
    stub.nn.tasks, stub.nn.modules, stub.utils  # noqa: B018
    return fn(path)


def load_both(path):
    """-> (port tree, port cfg, JAX cfg), after holding the port's tree
    against the JAX loader's and against the port's second load beside
    the JAX stub."""
    assert "ultralytics" not in sys.modules
    tree, cfg, names = tporting.load_checkpoint(path)
    assert "ultralytics" not in sys.modules  # the port installs nothing
    jtree, jcfg, jnames = jax_load(jporting.load_checkpoint, path)
    assert_same_tree(tree, jax.device_get(jtree))
    assert names == jnames == NAMES
    again = tporting.load_checkpoint(path)
    assert_same_tree(again[0], tree)
    assert again[1] == cfg
    return tree, cfg, jcfg


def _v5_state_dict(params, anchor_free):
    """Inverse of port_yolov5 (as tests/test_porting.py writes it)."""
    lay = jporting._V5_LAYOUT
    sd = {}
    for name in ("stem", "down1", "down2", "down3", "down4", "lat5", "lat4",
                 "bu1_conv", "bu2_conv"):
        _export_conv(sd, f"model.{lay[name]}", params[name])
    for name in ("stage1", "stage2", "stage3", "stage4", "td1", "td2", "bu1",
                 "bu2"):
        p = params[name]
        for k in ("cv1", "cv2", "cv3"):
            _export_conv(sd, f"model.{lay[name]}.{k}", p[k])
        for i, m in enumerate(p["m"]):
            _export_bottleneck(sd, f"model.{lay[name]}.m.{i}", m)
    for k in ("cv1", "cv2"):
        _export_conv(sd, f"model.{lay['sppf']}.{k}", params["sppf"][k])
    h = f"model.{lay['head']}"
    for i in range(3):
        if anchor_free:
            _export_branch(sd, f"{h}.cv2.{i}", params["detect"]["box"][i])
            _export_branch(sd, f"{h}.cv3.{i}", params["detect"]["cls"][i])
        else:
            _export_conv2d(sd, f"{h}.m.{i}", params["detect"]["m"][i])
    return sd


def run_pipeline(path, **kw):
    pipe = Pipeline(DetectorConfig(weights=path, imgsz=160, half=False,
                                   max_det=16), device="cpu",
                    track_slots=16, tracker_max_dets=16, **kw)
    frame = np.random.default_rng(0).integers(0, 255, (120, 200, 3), np.uint8)
    r = pipe.track(frame)
    assert np.isfinite(r.boxes.xyxy).all()
    return pipe


@pytest.mark.parametrize("name,cfg", [
    ("yolov8n", jyolo.YoloConfig(family="v8", scale="n")),
    ("yolo11n-pose", jyolo.YoloConfig(family="v11", scale="n", task="pose")),
])
def test_v8_v11(tmp_path, name, cfg):
    path = str(tmp_path / f"{name}.pt")
    params = jax.device_get(jyolo.init_model(jax.random.PRNGKey(0), cfg))
    save_ultralytics(path, export_state_dict(params, cfg), half=name == "yolov8n")
    tree, tcfg, jcfg = load_both(path)
    assert (tcfg.family, tcfg.scale, tcfg.task, tcfg.nc, tcfg.kpt) == (
        jcfg.family, jcfg.scale, jcfg.task, jcfg.nc, jcfg.kpt) == (
        cfg.family, "n", cfg.task, 80, (17, 3))
    pipe = run_pipeline(path, tracker="bytetrack.yaml")
    assert pipe.names == NAMES and pipe.model_cfg == tcfg


def test_training_args_namespace(tmp_path):
    """A model pickled with its ``args`` namespace (ultralytics'
    IterableSimpleNamespace) loads, the arguments as a dict. The JAX
    stub's namespace returns None for ``__setstate__``, which the C
    unpickler then calls: the JAX loader fails on such a file."""
    cfg = jyolo.YoloConfig(family="v8", scale="n")
    params = jax.device_get(jyolo.init_model(jax.random.PRNGKey(0), cfg))
    path = str(tmp_path / "yolov8n.pt")
    save_ultralytics(path, export_state_dict(params, cfg), args=True)
    state, meta = tporting.load_torch_checkpoint(path)
    assert meta["args"] == {"imgsz": 640, "task": "detect"}
    assert meta["names"] == NAMES
    assert_same_tree(tporting.load_checkpoint(path)[0],
                     tporting.port_yolo(state, cfg))
    assert "ultralytics" not in sys.modules
    with pytest.raises(TypeError):
        jax_load(jporting.load_torch_checkpoint, path)


@pytest.mark.parametrize("name", ["yolov5n", "yolov5nu"])
def test_v5(tmp_path, name):
    cfg = jv5.build_v5(name)
    params = jax.device_get(jv5.init_yolov5(jax.random.PRNGKey(1), cfg))
    path = str(tmp_path / f"{name}.pt")
    save_ultralytics(path, _v5_state_dict(params, cfg.anchor_free))
    tree, tcfg, jcfg = load_both(path)
    assert (tcfg.scale, tcfg.nc, tcfg.anchor_free) == (
        jcfg.scale, jcfg.nc, jcfg.anchor_free) == ("n", 80, cfg.anchor_free)
    assert_same_tree(tree, params)  # the exported weights, back
    pipe = run_pipeline(path, tracker="bytetrack.yaml")
    assert pipe.model_cfg == tcfg


@pytest.fixture(scope="module")
def v7_params():
    return jax.device_get(jv7.init_yolov7(jax.random.PRNGKey(7), jv7.Yolov7Config()))


@pytest.mark.parametrize("deployed", [False, True])
@pytest.mark.parametrize("implicit", [False, True])
def test_v7(tmp_path, v7_params, deployed, implicit):
    rng = np.random.default_rng(3)
    sd = export_v7_state_dict(v7_params, rng, with_implicit=implicit)
    if deployed:
        fused = jax.device_get(jv7.fuse_yolov7(v7_params))
        for name in ("rep3", "rep4", "rep5"):
            i = jporting._V7_IDX[name]
            for key in [k for k in sd if k.startswith(f"model.{i}.rbr_")]:
                del sd[key]
            sd[f"model.{i}.rbr_reparam.weight"] = np.transpose(
                fused[name]["fused"]["w"], (3, 2, 0, 1))
            sd[f"model.{i}.rbr_reparam.bias"] = fused[name]["fused"]["b"]
    path = str(tmp_path / "yolov7.pt")
    save_ultralytics(path, sd)
    tree, tcfg, jcfg = load_both(path)
    assert tcfg.nc == jcfg.nc == 80
    assert ("fused" in tree["rep3"]) == deployed
    assert tporting.infer_v5_config(tporting.load_torch_checkpoint(path)[0]) is None
    sdict = tporting.params_from_jax(tree, tcfg)
    model = tporting.model_from_state_dict(sdict, tcfg)
    assert model.rep_deploy == deployed and not model.fused
    pipe = run_pipeline(path, tracker="bytetrack.yaml")
    assert pipe.model.fused and pipe.model.rep_deploy


@pytest.mark.parametrize("form", ["bare", "state_dict", "module"])
def test_osnet(tmp_path, form):
    cfg = JOsnetConfig(variant="osnet_x0_25")
    params = jax.device_get(jinit_osnet(jax.random.PRNGKey(9), cfg))
    sd = {k: torch.from_numpy(np.array(v, np.float32))
          for k, v in export_osnet_state_dict(params).items()}
    if form == "module":
        sd = {"module." + k: v for k, v in sd.items()}
    path = str(tmp_path / "osnet.pth")
    torch.save(sd if form == "bare" else {"state_dict": sd, "epoch": 3}, path)
    tree, tcfg = tporting.load_reid_checkpoint(path)
    jtree, jcfg = jporting.load_reid_checkpoint(path)
    assert_same_tree(tree, jax.device_get(jtree))
    assert (tcfg.variant, tcfg.feat_dim) == (jcfg.variant, jcfg.feat_dim) == (
        "osnet_x0_25", 512)
    pipe = run_pipeline(os.path.join(os.path.dirname(__file__), "..", "assets",
                                     "yolov8n_synth160.npz"),
                        tracker=StrongSortConfig(gmc_method="none"),
                        reid_weights=path)
    assert pipe.feat_dim == 512


@pytest.mark.parametrize("name", ["yolov5n", "yolov5nu", "yolov7"])
def test_chip_smoke_fabricated_files(tmp_path, name):
    """chip_smoke's .pt writer (the port's model in the ultralytics layout,
    which the card run loads without JAX): both loaders read back the
    model's own weights."""
    from strongsort_yolo_tpu_torch.models.yolo import build_model
    from strongsort_yolo_tpu_torch.models.yolov5 import init_yolov5
    from strongsort_yolo_tpu_torch.models.yolov7 import init_yolov7

    cfg = build_model(name)
    init = init_yolov7 if name == "yolov7" else init_yolov5
    model = init(cfg, torch.Generator().manual_seed(0))
    path = str(tmp_path / f"{name}.pt")
    save_ultralytics(path, chip_smoke.ultralytics_state_dict(model))
    tree, tcfg, _ = load_both(path)
    assert tcfg == cfg
    got = tporting.params_from_jax(tree, tcfg)
    want = model.state_dict()
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k


def test_torch_layers_and_training_records(tmp_path):
    """A file as ultralytics writes it: torch layers (Conv2d, BatchNorm2d,
    SiLU, Sequential, ModuleList, MaxPool2d, Upsample) inside ultralytics
    classes, in half precision, beside numpy metrics, a path and a set:
    the port's loader (which allows only such globals) reads every
    tensor."""
    import pathlib
    import types

    from torch import nn

    mods = {p: types.ModuleType(p) for p in chip_smoke.ULTRALYTICS_PATHS}
    conv_cls = type("Conv", (nn.Module,), {"__module__": "ultralytics.nn.modules"})
    model_cls = type("DetectionModel", (nn.Module,),
                     {"__module__": "ultralytics.nn.tasks"})
    mods["ultralytics.nn.modules"].Conv = conv_cls
    mods["ultralytics.nn.tasks"].DetectionModel = model_cls
    conv = conv_cls()
    conv.conv = nn.Conv2d(3, 8, 3, bias=False)
    conv.bn = nn.BatchNorm2d(8)
    conv.act = nn.SiLU()
    root = model_cls()
    root.model = nn.Sequential(conv, nn.ModuleList([nn.MaxPool2d(2),
                                                    nn.Upsample(scale_factor=2)]))
    root.names = dict(NAMES)
    with torch.no_grad():
        for t in root.state_dict().values():
            t.copy_(torch.randn(t.shape, generator=torch.Generator().manual_seed(3)))
    root = root.half()
    path = str(tmp_path / "layers.pt")
    sys.modules.update(mods)
    try:
        torch.save({"model": root, "epoch": -1, "date": "2024-01-01",
                    "train_metrics": {"fitness": np.float64(0.25),
                                      "curve": np.arange(3.0)},
                    "train_args": {"save_dir": pathlib.PurePosixPath("runs/x"),
                                   "classes": {1, 2}}}, path)
    finally:
        for p in chip_smoke.ULTRALYTICS_PATHS:
            del sys.modules[p]
    state, meta = tporting.load_torch_checkpoint(path)
    want = root.state_dict()
    assert set(state) == set(want)
    for k, v in want.items():
        np.testing.assert_array_equal(state[k], v.float().numpy(), err_msg=k)
    assert meta["names"] == NAMES


class _Opener:
    """Pickles as a call of ``open`` that would write ``path``."""

    def __init__(self, path):
        self.path = path

    def __reduce__(self):
        return (open, (self.path, "w"))


@pytest.mark.parametrize("loader", ["load_checkpoint", "load_reid_checkpoint"])
def test_other_globals_refused(tmp_path, loader):
    """A file that names a callable no weights file needs (here ``open``)
    raises UnpicklingError before that callable runs."""
    import pickle

    marker = tmp_path / "written"
    path = str(tmp_path / "crafted.pt")
    torch.save({"model": _Opener(str(marker)),
                "state_dict": {"w": torch.zeros(1)}}, path)
    with pytest.raises(pickle.UnpicklingError, match="open"):
        getattr(tporting, loader)(path)
    assert not marker.exists()
