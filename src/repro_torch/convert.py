"""Carry params from the JAX package into the port.

``params_from_jax`` takes the JAX param pytree as nested dicts of numpy
arrays (``jax.tree.map(np.asarray, params)``) and returns the port's
params: the same keys, shapes and layout (``wq (D,H,hd)``, ``wo (H,hd,D)``,
stacked ``blocks`` on a leading layer axis), as torch tensors.
"""
from __future__ import annotations

import numpy as np
import torch


def params_from_jax(tree: dict, device="cuda") -> dict:
    return {k: params_from_jax(v, device) if isinstance(v, dict)
            else torch.from_numpy(np.array(v, copy=True)).to(device)
            for k, v in tree.items()}
