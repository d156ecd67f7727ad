"""The one route from the port to its hand-written CUDA kernels
(``linalg/csrc``): :func:`launch` for every launch, :func:`call` for the
kernels whose callers may take derivatives (K4, K5, K6), with the plain twin
on the CPU and, on the card, for the derivatives (:class:`_Bridge`)."""

from __future__ import annotations

import torch

from tpusysbio_torch import trace
from tpusysbio_torch.linalg import _build


def stream(device):
    """The handle of PyTorch's current stream on ``device``, read without
    building a ``Stream`` object: the stepper launches several kernels a
    trip, so its host cost counts."""
    return torch._C._cuda_getCurrentRawStream(device.index)


def launch(entry, *args, device, counter, known=()):
    """Call the library's ``entry`` with ``args`` and the current stream of
    ``device``, then count ``counter``. A non-zero code raises
    ``RuntimeError``, except a code in ``known`` (one the kernel defines
    for an input it refuses), which is returned uncounted for the caller
    to word; 0 is returned after a launch."""
    err = getattr(_build.load(), entry)(*args, stream(device))
    if err == 0:
        trace.count(counter)
    elif err not in known:
        raise RuntimeError(f"{counter} launch failed: cudaError {err}")
    return err


def _on_card(x) -> bool:
    """Whether ``x`` is on the card (the CPU tests take the card's route)."""
    return x.is_cuda


def call(launch_fn, twin_fn, xs, *, plain_counter, vmap_message, writes=0):
    """``twin_fn(*xs)`` on the CPU; on the card ``launch_fn(*xs)``, through
    :class:`_Bridge` inside a ``torch.func`` transform or where autograd
    has to differentiate the call. ``launch_fn`` may write its first
    ``writes`` inputs in place (through the bridge, copies of them); ``xs``
    may hold None and non-floating tensors."""
    if not _on_card(xs[0]):
        return twin_fn(*xs)
    if (torch._C._functorch.peek_interpreter_stack() is not None
            or (torch.is_grad_enabled() and any(
                x is not None and x.requires_grad for x in xs))):
        return _Bridge.apply(launch_fn, twin_fn, plain_counter,
                             vmap_message, writes, *xs)
    return launch_fn(*xs)


_STATIC = 5   # the bridge's inputs before ``xs``


class _Bridge(torch.autograd.Function):
    """The launch gives the value (on the tensors under any transform's
    wrappers); the twin gives gradients, over the inputs that need one
    and the outputs that have one, and tangents, with every floating input
    dual, those not varied at zero (a zero tangent meets an infinity of
    an input as NaN only where the value is NaN already); each such use
    counts ``plain_counter``. ``vmap`` raises ``vmap_message``."""

    @staticmethod
    def forward(launch_fn, twin_fn, counter, message, writes, *xs):
        return launch_fn(*(x.clone() for x in xs[:writes]), *xs[writes:])

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.twin, ctx.counter = inputs[1], inputs[2]
        ctx.xs = inputs[_STATIC:]
        ctx.save_for_backward(*ctx.xs)

    @staticmethod
    def backward(ctx, *grads):
        need = ctx.needs_input_grad[_STATIC:]
        trace.count(ctx.counter)
        with torch.enable_grad():
            xs = [None if x is None else x.detach().requires_grad_(w)
                  for x, w in zip(ctx.saved_tensors, need)]
            outs = ctx.twin(*xs)
            outs = outs if isinstance(outs, tuple) else (outs,)
            have = [(o, g) for o, g in zip(outs, grads) if o.requires_grad]
            got = iter(torch.autograd.grad(
                [o for o, _ in have], [x for x, w in zip(xs, need) if w],
                [g for _, g in have], allow_unused=True))
        return ((None,) * _STATIC
                + tuple(next(got) if w else None for w in need))

    @staticmethod
    def jvp(ctx, *tangents):
        trace.count(ctx.counter)
        tangents = tangents[_STATIC:]
        at = [i for i, x in enumerate(ctx.xs)
              if x is not None and x.is_floating_point()]

        def twin(*floats):
            xs = list(ctx.xs)
            for i, x in zip(at, floats):
                xs[i] = x
            return ctx.twin(*xs)

        outs, out_tangents = torch.func.jvp(
            twin, tuple(ctx.xs[i] for i in at), tuple(
                torch.zeros_like(ctx.xs[i]) if tangents[i] is None
                else tangents[i] for i in at))
        if not isinstance(outs, tuple):
            return out_tangents
        # an integer or bool output (a flag, a count) has no tangent
        return tuple(t if o.is_floating_point() else None
                     for o, t in zip(outs, out_tangents))

    @staticmethod
    def vmap(info, in_dims, launch_fn, twin_fn, counter, message, *rest):
        raise RuntimeError(message)
