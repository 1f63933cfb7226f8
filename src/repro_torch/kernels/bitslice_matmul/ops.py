"""Public op: float-in/float-out DBSC matmul (quantize -> kernel -> rescale).

The paper's full datapath: INT12 activation quantization on ONE per-tensor
scale (so TIPS rows can drop to the INT6 grid of the same scale), the
bit-slice split, the integer matmul, and the output rescale.  A CUDA tensor
goes through the hand-written kernel, a CPU tensor through the plain
version; ``quant_path="int8"`` runs the same integers as two int8 x int8 ->
int32 library products on either device.  The integers are identical on
every route.  Under an active mesh (``launch.mesh.use_mesh``) the scale's
amax is the data group's, so a rank's rows get the codes they get in the
whole batch.
"""
from __future__ import annotations

import torch

from repro_torch.core import quant
from repro_torch.kernels.bitslice_matmul.kernel import (DATAFLOWS,
                                                       bitslice_matmul_kernel)
from repro_torch.kernels.bitslice_matmul.ref import (bitslice_matmul_int8,
                                                     bitslice_matmul_ref)
from repro_torch.launch import mesh as mesh_mod

QUANT_PATHS = ("model", "int8")


def bitslice_integers(x: torch.Tensor, w: torch.Tensor,
                      important: torch.Tensor | None = None,
                      dataflow: str = "weight_stationary",
                      quant_path: str = "model"):
    """The integer half of :func:`bitslice_matmul`: ``(acc, scale)``, the
    (M, N) int32 accumulators of the quantized ``x @ w`` and the float32
    scale that turns them into the output (``acc * scale``)."""
    if dataflow not in DATAFLOWS:
        raise ValueError(f"bitslice_matmul: dataflow={dataflow!r}, "
                         f"expected one of {tuple(DATAFLOWS)}")
    if quant_path not in QUANT_PATHS:
        raise ValueError(f"bitslice_matmul: quant_path={quant_path!r}, "
                         f"expected one of {QUANT_PATHS}")
    m = x.shape[0]
    # ONE per-tensor scale over the batch: under a mesh, the data group's
    # (its rows are one matrix in the JAX package's sharded program)
    amax = mesh_mod.data_max(torch.clamp_min(x, 0.0).max())
    qx = quant.quantize_act(x, quant.ACT_BITS_HIGH, amax=amax)
    qw = quant.quantize_weight(w)
    if important is None:
        vals = qx.values
        prec = torch.ones((m, 1), dtype=torch.int32, device=x.device)
    else:
        vals = quant.mixed_precision_quantize(x, important, qx.scale).values
        prec = important.to(torch.int32)[:, None].contiguous()
    hi, lo = quant.bitslice_split(vals)
    if quant_path == "int8":
        acc = bitslice_matmul_int8(hi, lo, qw.values, prec)
    elif x.is_cuda:
        acc = bitslice_matmul_kernel(hi.contiguous(), lo.contiguous(),
                                     qw.values.contiguous(), prec,
                                     dataflow=dataflow)
    else:
        acc = bitslice_matmul_ref(hi, lo, qw.values, prec)
    return acc, qx.scale * qw.scale


def bitslice_matmul(x: torch.Tensor, w: torch.Tensor,
                    important: torch.Tensor | None = None,
                    dataflow: str = "weight_stationary",
                    quant_path: str = "model") -> torch.Tensor:
    """``x (M, K) @ w (K, N)`` through the DBSC integer datapath.

    ``important``: bool (M,) TIPS mask; None -> every row INT12.
    ``dataflow``: the DBSC stationary mode (the same integers either way).
    ``quant_path``: ``"model"`` runs the integer matmul as the model's
    datapath (the kernel on the card, its plain version on the CPU);
    ``"int8"`` as ``ref.bitslice_matmul_int8``.  The accumulators are
    bit-identical, so the float output is too.
    """
    acc, scale = bitslice_integers(x, w, important, dataflow, quant_path)
    return acc.to(torch.float32) * scale
