# SPDX-License-Identifier: Apache-2.0
"""Half-quadratic proximal solver for calibration-free weight quantization.

Mirrors `hqq_tpu.core.optimize` (the legacy solver, `shrink_lp` and
`optimize_weights_proximal`). It minimises ``|| W - dequant(quant(W)) ||_p^p``
(p < 1) over the zero-point with an alternating scheme:

    W_q  = round(W * scale + zero).clip(0, 2^n - 1)
    W_r  = (W_q - zero) / scale
    W_e  = shrink_lp(W - W_r, beta, p)
    zero = mean(W_q - (W - W_e) * scale, axis)
    beta = beta * kappa

The error of an iteration is measured before its zero update. Iteration
stops the first time the error fails to improve, and the zero that the
failing iteration produced is kept. The loop runs its full count of
iterations on the device without reading the error back to the host: a
``done`` flag freezes ``zero`` from the iteration after the failing one on.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

__all__ = ["shrink_lp", "optimize_weights_proximal", "DEFAULT_OPT_PARAMS"]

DEFAULT_OPT_PARAMS = dict(lp_norm=0.7, beta=1e1, kappa=1.01, iters=20)


def shrink_lp(x: torch.Tensor, beta: float, lp_norm: float) -> torch.Tensor:
    """Generalised soft-thresholding operator for the l_p (p <= 1) prior.

    p == 1:  sign(x) * relu(|x| - 1/beta)
    p  < 1:  sign(x) * relu(|x| - (1/beta) * |x|^(p-1))
    """
    ax = x.abs()
    if lp_norm == 1:
        thr = 1.0 / beta
    else:
        thr = (1.0 / beta) * ax.pow(lp_norm - 1)
    return x.sign() * (ax - thr).clamp_min(0.0)


def optimize_weights_proximal(
    tensor: torch.Tensor,
    scale: torch.Tensor,
    zero: torch.Tensor,
    min_max: tuple,
    axis: int = 0,
    opt_params: Optional[dict] = None,
    dtype=torch.float32,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The default HQQ solver.

    Args:
      tensor: grouped weight matrix W_f (float), groups along ``axis``.
      scale:  inverse scale (W_q ~ W*scale + zero), broadcastable over axis.
      zero:   initial zero-point, same shape as scale.
      min_max: (min_v, max_v) quantization code range.
      axis:   0 or 1, the grouping axis.
      opt_params: {lp_norm, beta, kappa, iters}.
      dtype:  solver precision (fp32).

    Returns:
      (W_q, scale, zero): integer codes (in ``dtype``), the unchanged scale,
      and the optimised zero-point.
    """
    p = dict(DEFAULT_OPT_PARAMS, **(opt_params or {}))
    min_v, max_v = float(min_max[0]), float(min_max[1])
    lp_norm, kappa = float(p["lp_norm"]), float(p["kappa"])

    w_f = tensor.to(dtype)
    scale = scale.to(dtype)
    zero = zero.to(dtype)

    # beta is carried in fp32, as the reference's loop state is
    beta = np.float32(p["beta"])
    best_error = torch.tensor(float("inf"), dtype=torch.float32, device=w_f.device)
    done = torch.zeros((), dtype=torch.bool, device=w_f.device)
    for _ in range(int(p["iters"])):
        w_q = torch.round(w_f * scale + zero).clamp(min_v, max_v)
        w_r = (w_q - zero) / scale
        err = (w_f - w_r).abs().mean()
        w_e = shrink_lp(w_f - w_r, float(beta), lp_norm)
        new_zero = torch.mean(w_q - (w_f - w_e) * scale, dim=axis, keepdim=True)
        # an iteration that starts after the stop changes nothing; the
        # failing iteration itself still takes its update
        zero = torch.where(done, zero, new_zero)
        done = done | ~(err < best_error)
        best_error = torch.minimum(err, best_error)
        beta = np.float32(beta * np.float32(kappa))

    w_q = torch.round(w_f * scale + zero).clamp(min_v, max_v)
    return w_q, scale, zero
