"""The one traffic generator: synthetic BGR camera frames from a seed and
a traffic mix's parameters (``benchmark/traffic/<mix>.json``).

Each stream is a camera over its own scene: a background (``"noise"``:
dark uniform noise; ``"smooth"``: a sum of low sinusoids periodic over
the frame, so that a pan by ``torch.roll`` is exact and Lucas-Kanade
has gradients to follow) with bright rectangles moving over it. A
``"fixed"`` camera shows its background still; a ``"pan"`` camera rolls
it by its own rate each tick. The mix fixes every size, rate and count;
the seed draws only positions, phases and which stream gets which of the
listed pans and speeds, so that every seed gives the same work in
another arrangement.

``ring`` tick arrays (S, H, W, 3) uint8 are rendered on the device at
set-up and kept on the host; :func:`order` walks them forwards then
backwards, so that objects and pans reverse instead of jumping."""

from __future__ import annotations

import math

import numpy as np
import torch


def order(k: int, ring: int) -> int:
    """Ring index of loop tick k: 0, 1, ..., ring - 1, ring - 2, ..., 1, 0, 1, ..."""
    if ring == 1:
        return 0
    m = k % (2 * ring - 2)
    return m if m < ring else 2 * ring - 2 - m


def _background(mix: dict, s: int, h: int, w: int, g: torch.Generator, dev):
    if mix["background"] == "noise":
        return torch.randint(0, 60, (s, h, w, 3), generator=g, device=dev,
                             dtype=torch.uint8)
    # smooth: a few sinusoids with whole periods over the frame
    yy = torch.arange(h, device=dev, dtype=torch.float32)[:, None]
    xx = torch.arange(w, device=dev, dtype=torch.float32)[None, :]
    out = torch.empty((s, h, w, 3), dtype=torch.uint8, device=dev)
    for i in range(s):
        phase = torch.rand(6, generator=g, device=dev) * 2 * math.pi
        img = 128.0
        for j, (ky, kx) in enumerate(((2, 3), (5, 1), (1, 7), (7, 4), (3, 9), (11, 6))):
            img = img + (28.0 / (1 + j)) * torch.sin(
                2 * math.pi * (ky * yy / h + kx * xx / w) + phase[j])
        base = img.clamp(0, 255)
        out[i] = torch.stack([base - 10, base, base + 10], -1).clamp(0, 255).to(torch.uint8)
    return out


def render(mix: dict, seed: int, device) -> list[np.ndarray]:
    """-> ``mix["ring"]`` host arrays (S, H, W, 3) uint8, ticks 0..ring-1."""
    s = int(mix["streams"])
    h, w = (int(v) for v in mix["frame_hw"])
    ring = int(mix["ring"])
    dev = torch.device(device)
    g = torch.Generator(device=dev)
    g.manual_seed(int(seed) % (2**63 - 1))
    rng = np.random.default_rng(int(seed) % 2**64)
    bg = _background(mix, s, h, w, g, dev)
    pans = np.asarray(mix.get("pans_px_per_tick", [[0.0, 0.0]]), np.float64)
    pan_of = pans[rng.permutation(np.arange(s) % len(pans))]
    obj = mix["objects"]
    n_obj = int(obj["per_frame"])
    sizes = np.asarray(obj["sizes_hw"], np.int64)
    speeds = np.asarray(obj["speeds_px_per_tick"], np.float64)
    size_of = sizes[rng.permutation(np.arange(s * n_obj) % len(sizes))].reshape(s, n_obj, 2)
    speed_of = speeds[rng.permutation(np.arange(s * n_obj) % len(speeds))].reshape(s, n_obj, 2)
    start = rng.uniform(0.0, 1.0, (s, n_obj, 2))
    shade = rng.integers(0, 8, (s, n_obj))
    ticks = []
    for t in range(ring):
        frame = bg.clone()
        for i in range(s):
            dy, dx = (int(round(v * t)) for v in pan_of[i][::-1])
            if dy or dx:
                frame[i] = torch.roll(bg[i], (dy, dx), (0, 1))
            for j in range(n_obj):
                oh, ow = (int(v) for v in size_of[i, j])
                y = int((start[i, j, 0] * (h - oh) + speed_of[i, j, 1] * t) % (h - oh))
                x = int((start[i, j, 1] * (w - ow) + speed_of[i, j, 0] * t) % (w - ow))
                frame[i, y:y + oh, x:x + ow] = 70 + 25 * int(shade[i, j])
        ticks.append(frame.cpu().numpy())
        del frame
    return ticks
