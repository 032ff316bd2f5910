"""The trained OSNet's retrieval bar on the port: the rank-1 of
``tests/test_osnet_trained.py::test_unseen_identity_rank1`` (>= 0.9 on
16 identities never seen in training, 8 views each), through the port's
OSNet-x0_25 loaded from ``assets/osnet_x0_25_synth.npz``, unfused in
float32 and with the fused stages in bfloat16 (K6's plain version on the
CPU; chip_smoke.py holds the same bar on the card through K6). The set
comes from the port's copy of the generator, which must draw the arrays
that ``tools/train_osnet.make_dataset`` draws."""

import os
import sys

import numpy as np
import pytest
import torch

from strongsort_yolo_tpu_torch.models.osnet import osnet_from_state_dict
from strongsort_yolo_tpu_torch.models.porting import (
    load_osnet_npz,
    osnet_params_from_jax,
)
from strongsort_yolo_tpu_torch.utils import reid_synth

ROOT = os.path.join(os.path.dirname(__file__), "..")
NPZ = os.path.join(ROOT, "assets", "osnet_x0_25_synth.npz")


@pytest.fixture(scope="module")
def eval_set():
    return reid_synth.make_dataset(np.random.default_rng(999), 16, 8)


def test_copy_draws_the_tools_arrays(eval_set):
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    from train_osnet import make_dataset, rank1

    x, y, recipes = make_dataset(np.random.default_rng(999), 16, 8)
    np.testing.assert_array_equal(eval_set[0], x)
    np.testing.assert_array_equal(eval_set[1], y)
    for a, b in zip(eval_set[2], recipes):
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]))
    emb = np.random.default_rng(0).normal(size=(len(y), 8))
    emb /= np.linalg.norm(emb, axis=1, keepdims=True)
    assert reid_synth.rank1(emb, y) == rank1(emb, y)


@pytest.mark.parametrize("route", ["unfused-f32", "fused-bf16"])
def test_trained_osnet_rank1_on_the_port(eval_set, route):
    tree, cfg = load_osnet_npz(NPZ)
    model = osnet_from_state_dict(osnet_params_from_jax(tree, cfg), cfg)
    dtype = torch.float32
    if route == "fused-bf16":
        dtype = torch.bfloat16
        model.use_fused_stages(dtype)  # packed from float32, before the cast
    model = model.to(dtype=dtype).eval()
    x, y, _ = eval_set
    crops = torch.from_numpy(x).permute(0, 3, 1, 2).contiguous().to(dtype)
    with torch.no_grad():
        emb = torch.cat([model(crops[i:i + 32]) for i in range(0, len(x), 32)])
    emb = emb.float().numpy()
    np.testing.assert_allclose(np.linalg.norm(emb, axis=1), 1.0, atol=1e-2)
    assert reid_synth.rank1(emb, y) >= 0.9
