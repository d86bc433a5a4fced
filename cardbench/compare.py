"""The numbers that decide ``correct``, each computed against the plain
reference's float32 logits (``reference/dense.py``) and given in units of
their root mean square.

If every logit of a greedy step lies within e of the reference's, the token
it puts first lies at most 2 e below the reference's best: a cell that holds
``logit_err`` to a limit holds ``greedy_gap`` to twice that limit.
"""
from __future__ import annotations

import torch


def _rms(ref: torch.Tensor) -> torch.Tensor:
    return ref.square().mean(dtype=torch.float64).sqrt()


def greedy_gap(ref: torch.Tensor, tokens: torch.Tensor) -> float:
    """The widest gap by which a token's reference logit lies below the
    reference's best at its position: ref (..., V), tokens (...). Greedy
    tokens that agree with the reference give 0, or a rounding-sized gap
    where two logits nearly tie."""
    best = ref.max(-1).values
    got = ref.gather(-1, tokens[..., None].long())[..., 0]
    return float((best - got).max().double() / _rms(ref))


def logit_err(got: torch.Tensor, ref: torch.Tensor) -> float:
    """The largest distance of a logit from the reference's, in units of
    the reference logits' root mean square."""
    return float((got - ref).abs().max().double() / _rms(ref))
