"""The port's demo tool (tools/make_demo.py) against the JAX package's
``tools/make_demo.py``: each of the three images rendered by both, on the
CPU in float32, into two temporary directories, decodes to equal pixels
(the same detections, ids, counts and keypoints drawn by the same
annotator, then the same JPEG encoder). ``assets/`` is never written.
"""

import importlib.util
import os

import numpy as np
import pytest
import torch

from strongsort_yolo_tpu_torch.tools import make_demo

ROOT = os.path.join(os.path.dirname(__file__), "..")


def jax_tool():
    spec = importlib.util.spec_from_file_location(
        "jax_make_demo", os.path.join(ROOT, "tools", "make_demo.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("demo", ["demo_track", "demo_seg", "demo_pose"])
def test_demo_image_equals_the_jax_tool(demo, tmp_path):
    import cv2

    (tmp_path / "jax").mkdir()
    (tmp_path / "port").mkdir()
    getattr(jax_tool(), demo)(str(tmp_path / "jax"))
    path = getattr(make_demo, demo)(str(tmp_path / "port"), device="cpu")
    assert os.path.dirname(path) == str(tmp_path / "port")
    name = os.path.basename(path)
    want = cv2.imread(str(tmp_path / "jax" / name))
    got = cv2.imread(path)
    assert want is not None and got is not None and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    # the frame carries drawings: it is not the bare input
    assert np.unique(got.reshape(-1, 3), axis=0).shape[0] > 50


def test_main_refuses_assets_and_needs_a_directory(tmp_path):
    before = {f: os.path.getmtime(os.path.join(make_demo.ASSETS, f))
              for f in os.listdir(make_demo.ASSETS) if f.endswith(".jpg")}
    with pytest.raises(ValueError, match="tracked demo images"):
        make_demo.main([make_demo.ASSETS, "--device", "cpu"])
    with pytest.raises(SystemExit):
        make_demo.main([])
    after = {f: os.path.getmtime(os.path.join(make_demo.ASSETS, f))
             for f in before}
    assert after == before and len(before) == 3
