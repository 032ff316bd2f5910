"""Weights from the seed, made on the device in one normal draw per
model, in float32, under the key names the program's state dicts use.
The benchmark hands the same tensors to the program and the reference."""

from __future__ import annotations

import torch


def make(specs, g: torch.Generator, device) -> dict[str, torch.Tensor]:
    """Reference weight specs (``reference.nn.Spec``) -> {key: tensor}:
    one ``randn`` over every drawn weight, split and scaled; the rest
    filled."""
    specs = list(specs)
    drawn = [sp for sp in specs if sp.std > 0]
    sizes = [int(torch.Size(sp.shape).numel()) for sp in drawn]
    flat = torch.randn(sum(sizes), generator=g, device=device)
    out = {}
    for sp, part in zip(drawn, torch.split(flat, sizes)):
        out[sp.key] = part.view(sp.shape).mul_(sp.std)
    for sp in specs:
        if sp.std == 0:
            out[sp.key] = torch.full(sp.shape, sp.fill, device=device)
    return out


def generator(seed: int, device, salt: int) -> torch.Generator:
    g = torch.Generator(device=torch.device(device))
    g.manual_seed((int(seed) * 1000003 + salt) % (2**63 - 1))
    return g
