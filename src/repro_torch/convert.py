"""JAX-package parameters -> the port's parameters.

Input: the JAX package's parameter pytrees as nested dicts/lists of numpy
arrays (``jax.device_get`` of ``init_text_encoder_params`` /
``init_unet_params`` / ``init_vae_params``).  Output: the same nesting with
torch tensors on ``device``.  Layout changes:

* conv weights (every 4-D leaf): HWIO -> OIHW, for ``F.conv2d``;
* linear weights stay (in, out) and are applied as ``x @ w``;
* everything else (biases, norms, embeddings) is copied as is.

The text encoder has no conv weights, so its tree is copied unchanged.
"""
from __future__ import annotations

import numpy as np
import torch


def convert_tree(tree, device="cpu"):
    """One JAX parameter tree (numpy leaves) -> the port's tensors."""
    if isinstance(tree, dict):
        return {k: convert_tree(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [convert_tree(v, device) for v in tree]
    arr = np.asarray(tree)
    if arr.ndim == 4:                             # HWIO -> OIHW
        arr = arr.transpose(3, 2, 0, 1)
    return torch.from_numpy(np.array(arr, copy=True, order="C")).to(device)


def convert_params(text, unet, vae, device="cpu") -> dict:
    """The ``params`` dict ``DiffusionEngine`` / ``StableDiffusionPipeline``
    take, from the three JAX parameter trees."""
    return {"text": convert_tree(text, device),
            "unet": convert_tree(unet, device),
            "vae": convert_tree(vae, device)}
