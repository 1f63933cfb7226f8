"""JAX-package parameters -> the port's parameters.

Input: the JAX package's parameter pytrees as nested dicts/lists of numpy
arrays (``jax.device_get`` of ``init_text_encoder_params`` /
``init_unet_params`` / ``init_vae_params``).  Output: the same nesting with
torch tensors on ``device``.  Layout changes:

* conv weights (every 4-D leaf): HWIO -> OIHW, for ``F.conv2d``;
* linear weights stay (in, out) and are applied as ``x @ w``;
* everything else (biases, norms, embeddings) is copied as is.

The text encoder has no conv weights, so its tree is copied unchanged.

``convert_lm_params`` takes the language-model tree
(``jax.device_get(transformer.init_params(...))``) and changes no layout:
the same nesting, the leading L axis of the stacked layer leaves kept.

``convert_train_state`` takes a JAX training state ``(params, AdamWState,
residual)`` (``jax.device_get`` of the trainer's state) and returns the
port's, so that a run can continue in the port from a JAX state taken
mid-run.

bfloat16 leaves (numpy's ``bfloat16`` from ml_dtypes, which
``torch.from_numpy`` refuses) cross as their uint16 bits and are viewed
back as ``torch.bfloat16``: the values are carried bit for bit.
"""
from __future__ import annotations

import numpy as np
import torch


def _tensor(arr: np.ndarray, device) -> torch.Tensor:
    """One numpy array -> a tensor on ``device``, bfloat16 included."""
    arr = np.array(arr, copy=True, order="C")
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.uint16)).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(arr).to(device)


def convert_tree(tree, device="cpu"):
    """One JAX diffusion parameter tree (numpy leaves) -> the port's
    tensors."""
    if isinstance(tree, dict):
        return {k: convert_tree(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [convert_tree(v, device) for v in tree]
    arr = np.asarray(tree)
    if arr.ndim == 4:                             # HWIO -> OIHW
        arr = arr.transpose(3, 2, 0, 1)
    return _tensor(arr, device)


def convert_lm_params(tree, device="cpu"):
    """The JAX language-model parameter tree (numpy leaves) -> the port's
    tree for ``repro_torch.models.transformer``: same nesting, same
    shapes, same dtypes."""
    if isinstance(tree, dict):
        return {k: convert_lm_params(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [convert_lm_params(v, device) for v in tree]
    return _tensor(np.asarray(tree), device)


def convert_train_state(state, device="cpu"):
    """A JAX ``(params, AdamWState(step, m, v), residual)`` (numpy leaves)
    -> the port's ``(params, optim.AdamWState, residual)``; the residual
    is a tree like the parameters under gradient compression, else a
    scalar."""
    from repro_torch.optim.adamw import AdamWState
    params, opt, residual = state
    return (convert_lm_params(params, device),
            AdamWState(step=_tensor(np.asarray(opt.step), device),
                       m=convert_lm_params(opt.m, device),
                       v=convert_lm_params(opt.v, device)),
            convert_lm_params(residual, device))


def convert_params(text, unet, vae, device="cpu") -> dict:
    """The ``params`` dict ``DiffusionEngine`` / ``StableDiffusionPipeline``
    take, from the three JAX parameter trees."""
    return {"text": convert_tree(text, device),
            "unet": convert_tree(unet, device),
            "vae": convert_tree(vae, device)}
