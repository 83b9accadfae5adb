"""One module a model configuration: its seeded weights, the program built
from them, its reference, and the counts its metrics need.

A module gives ``weight_shapes(model_cfg)``, ``build_program(program_cfg,
weights, device)``, ``reference`` (the module of ``benchmark/reference``),
``time_steps(program_cfg)`` (estimates a cascade that the loss reads),
``forward_flops(cfg, program_cfg)`` (model operations a slice) and
``kernel_bounds(cfg, program_cfg, batch)``.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch

from mribench.traffic import seed_stream

__all__ = ["Shape", "draw_weights"]

# (name, shape, how): how is ("normal", std), ("uniform", high) (from 0), ("zeros",) or ("ones",)
Shape = Tuple[str, Tuple[int, ...], tuple]


def draw_weights(shapes: List[Shape], seed: int, device) -> Dict[str, torch.Tensor]:
    """Float32 weights on ``device`` from the seed, in two draws: one normal
    and one uniform tensor, cut into the leaves and scaled."""
    g = torch.Generator(device=device)
    g.manual_seed(seed_stream(seed, 0))
    sizes = {kind: sum(int(torch.Size(s).numel()) for _, s, h in shapes if h[0] == kind) for kind in ("normal",
                                                                                                     "uniform")}
    pools = {"normal": torch.randn(sizes["normal"], generator=g, device=device),
             "uniform": torch.rand(sizes["uniform"], generator=g, device=device)}
    at = {"normal": 0, "uniform": 0}
    out = {}
    for name, shape, how in shapes:
        n = int(torch.Size(shape).numel())
        if how[0] in pools:
            flat = pools[how[0]][at[how[0]]:at[how[0]] + n]
            at[how[0]] += n
            out[name] = (flat * how[1]).reshape(shape).contiguous()
        else:
            out[name] = (torch.zeros if how[0] == "zeros" else torch.ones)(shape, device=device)
    return out
