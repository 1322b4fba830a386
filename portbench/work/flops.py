"""Model FLOPs of one train step, forward and backward with no
recomputation, counted by ``torch.utils.flop_counter.FlopCounterMode`` on a
reference model moved to the meta device, at a step's padded shapes
(nothing is computed, only shapes flow)."""

from __future__ import annotations

from torch.utils.flop_counter import FlopCounterMode


def step_flops(build, forward):
    """FLOPs of ``forward(model) -> tensor`` (inputs made on the meta device)
    and the backward of its sum, for the model ``build()`` makes, moved to
    the meta device."""
    model = build().to("meta")
    counter = FlopCounterMode(display=False)
    with counter:
        forward(model).sum().backward()
    return counter.get_total_flops()
