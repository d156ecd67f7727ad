"""Whole integration: the flops it needed at the card's f64/f32 peaks, over the window's wall, in %."""

from portbench.metrics import _layers


def read(trace):
    return _layers.step_mfu(trace)
