"""The benchmark's weights: drawn from ``--seed`` on the device, in float32
(the type the live engine serves), in a few large calls, and laid out as
the program's params tree, which both the program and the reference read:
the leaves that the reference's ``leaf_specs`` lists.

Every normal leaf is a view of one flat buffer filled by ``normal_`` in
chunks of ``CHUNK`` values and scaled by ``1 / sqrt(fan_in)``; the norms'
weights are ones.
"""
from __future__ import annotations

import math

import torch


CHUNK = 1 << 30


def make_weights(specs, seed: int, device) -> dict:
    """The params tree of ``specs`` ((path, shape, init, fan_in) a leaf)
    drawn from ``seed`` on ``device``."""
    device = torch.device(device)
    total = sum(math.prod(s) for _, s, init, _ in specs if init == "normal")
    flat = torch.empty(total, dtype=torch.float32, device=device)
    gen = torch.Generator(device=device).manual_seed(int(seed))
    for off in range(0, total, CHUNK):
        flat[off:off + CHUNK].normal_(generator=gen)
    tree: dict = {}
    off = 0
    for path, shape, init, fan_in in specs:
        if init == "normal":
            n = math.prod(shape)
            leaf = flat[off:off + n].view(shape)
            leaf.mul_(1.0 / math.sqrt(fan_in))
            off += n
        else:
            leaf = torch.ones(shape, dtype=torch.float32, device=device)
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = leaf
    return tree
