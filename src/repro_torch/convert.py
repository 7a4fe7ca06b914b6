"""Carry params, or a whole training state, from the JAX package into the
port.

``params_from_jax`` takes a JAX pytree as nested dicts of numpy arrays
(``jax.tree.map(np.asarray, tree)``) and returns the same keys, shapes and
layout (``wq (D,H,hd)``, ``wo (H,hd,D)``, stacked ``blocks`` on a leading
layer axis) as torch tensors: a params tree, or a training state
{"params", "opt": {"m", "v"}, "step"} with its 0-d int32 step. numpy has no
bfloat16 of its own: a leaf of ``ml_dtypes``' bfloat16 goes across by its
raw 2-byte words.
"""
from __future__ import annotations

import numpy as np
import torch


def _leaf(a, device) -> torch.Tensor:
    a = np.array(a, copy=True)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def params_from_jax(tree: dict, device="cuda") -> dict:
    return {k: params_from_jax(v, device) if isinstance(v, dict) else _leaf(v, device)
            for k, v in tree.items()}
