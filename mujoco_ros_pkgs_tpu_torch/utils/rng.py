"""Normal draws of a batch that do not depend on how the batch is split.

A server's randomness (the control noise, the sensors plugin's noise) comes
from one torch.Generator a server, one draw of the whole batch's shape a
step. When the batch is split over ranks (parallel/multihost.py), each rank
holds rows [lo, hi) of a global batch of `nenv` envs and a `RowGenerator`
seeded as the single-process server's generator: `randn` draws the global
batch's tensor and keeps the rank's rows, so env i gets the same numbers
however many ranks share the batch (the JAX package's per-global-env keys,
parallel/multihost.py env_rng, give it the same property).
"""

from __future__ import annotations

from typing import Sequence

import torch


class RowGenerator(torch.Generator):
    """A torch.Generator that stands for rows [lo, hi) of a batch of nenv."""

    def __new__(cls, device, lo: int, hi: int, nenv: int):
        # torch.Generator takes its device in __new__
        return super().__new__(cls, device)

    def __init__(self, device, lo: int, hi: int, nenv: int):
        if not 0 <= lo < hi <= nenv:
            raise ValueError(f"rows [{lo}, {hi}) are not inside a batch of {nenv}")
        self.rows = (lo, hi, nenv)


def randn(shape: Sequence[int], generator: torch.Generator, dtype, device) -> torch.Tensor:
    """torch.randn(shape) from generator; for a RowGenerator, shape[0] is its
    row count and the draw is the global batch's, cut to its rows."""
    rows = getattr(generator, "rows", None)
    if rows is None:
        return torch.randn(tuple(shape), generator=generator, dtype=dtype, device=device)
    lo, hi, nenv = rows
    if shape[0] != hi - lo:
        raise ValueError(f"a draw of {shape[0]} rows from a generator of rows [{lo}, {hi})")
    full = torch.randn((nenv, *shape[1:]), generator=generator, dtype=dtype, device=device)
    return full[lo:hi]
