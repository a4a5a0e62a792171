"""Batched MatInspector (PWM) window scores for stage 4's branch-point
sweep, and the wrapper of their CUDA kernel (``csrc/pwm.cu``).

Counterpart of the JAX package's ``ops/pwm.py``.  A window of L bases
(codes 0..3 for A, C, G, T) scores

    (sum_l cv_l * pwm[base_l, l]) / (sum_l cv_l * max_l)

(reference: classify-intron.c:620-663).  The JAX op contracts a one-hot
encoding with the cv-weighted matrix at ``Precision.HIGHEST``; here the
numerator is a gather and an add per column, in float32, in column
order 0..L-1, with no matrix product: a TF32 product would break the
bound the exact finish relies on (the f32 score within 1e-5 of the
maximum, ``pintron_tpu_torch/factorize/classify.py``).  A code outside 0..3
adds nothing, as its all-zero one-hot row does in the JAX op.

  * ``pwm_scores`` is the plain PyTorch version;
  * ``pwm_scores_cuda`` runs it for a batch on the CPU and launches
    ``pwm_kernel`` for a batch on a CUDA device, or raises.  The kernel
    adds in the same order, so the two are bit-equal.

The host helpers (``pwm_tables``, ``encode_windows``, ``_BASE``) are
copies of the JAX module's, kept in ``factorize/pwm_data.py`` beside
the tables so that STEP 4's host side reads them without torch.
"""

from __future__ import annotations

import torch

from pintron_tpu_torch.factorize.pwm_data import (  # noqa: F401 - this
    _BASE, encode_windows, pwm_tables)             # module's names too
from pintron_tpu_torch.ops.kband import _count, _cuda_launch_context


def pwm_scores(base_idx: torch.Tensor, weighted_pwm: torch.Tensor,
               denominator: float) -> torch.Tensor:
    """Plain version: (B, L) integer codes, (4, L) float32 weights ->
    (B,) float32 scores."""
    B, L = base_idx.shape
    dev = base_idx.device
    w = torch.cat([weighted_pwm.to(torch.float32),
                   torch.zeros((1, L), dtype=torch.float32, device=dev)])
    codes = base_idx.long()
    codes = torch.where((codes >= 0) & (codes < 4), codes,
                        torch.full_like(codes, 4))
    acc = torch.zeros(B, dtype=torch.float32, device=dev)
    for col in range(L):
        acc = acc + w[:, col][codes[:, col]]
    # a 0-d tensor on the batch's device: a true division on every
    # device (a Python scalar lets CUDA multiply by its reciprocal)
    return acc / torch.tensor(denominator, dtype=torch.float32, device=dev)


def _check(base_idx, weighted_pwm) -> None:
    if base_idx.dtype != torch.int8 or base_idx.dim() != 2:
        raise ValueError(f"base_idx: expected 2-d int8, got "
                         f"{base_idx.dim()}-d {base_idx.dtype}")
    L = base_idx.shape[1]
    if weighted_pwm.dtype != torch.float32 or \
            tuple(weighted_pwm.shape) != (4, L):
        raise ValueError(f"weighted_pwm: expected (4, {L}) float32, got "
                         f"{tuple(weighted_pwm.shape)} {weighted_pwm.dtype}")
    if weighted_pwm.device != base_idx.device:
        raise ValueError(f"weighted_pwm is on {weighted_pwm.device}, "
                         f"base_idx on {base_idx.device}")
    if not (base_idx.is_contiguous() and weighted_pwm.is_contiguous()):
        raise ValueError("base_idx and weighted_pwm must be contiguous")
    if L < 1:
        raise ValueError("windows must be >= 1 base wide")


def pwm_scores_cuda(base_idx: torch.Tensor, weighted_pwm: torch.Tensor,
                    denominator: float) -> torch.Tensor:
    """PWM scores of int8 (B, L) codes; see ``pwm_scores``."""
    _check(base_idx, weighted_pwm)
    dev = base_idx.device
    if dev.type == "cpu":
        return pwm_scores(base_idx, weighted_pwm, denominator)
    B, L = base_idx.shape
    out = torch.empty(B, dtype=torch.float32, device=dev)
    if B == 0:
        return out
    lib, stream = _cuda_launch_context(dev, "PWM")
    with torch.cuda.device(dev):
        err = lib.pintron_pwm(base_idx.data_ptr(), L,
                              weighted_pwm.data_ptr(),
                              denominator, out.data_ptr(), B,
                              stream)
    if err:
        raise RuntimeError(f"pwm_kernel launch failed: cudaError {err}")
    _count("pwm")
    return out
