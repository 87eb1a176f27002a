"""Remat's save-list for the fused edge kernels.

Counterpart of the JAX package's ``save_only_these_names("fused_edge_agg")``
policy (torchmdnet_tpu/models/et.py:406-416, the tags at et.py:240-250,
tensornet.py:410-413 and transformer.py:163-166).  Under ``remat`` a layer
is recomputed in the backward pass, but the outputs of its fused forward
kernel (ET's x_agg and vec_agg, the Transformer's aggregate, TensorNet's
messages) are kept from the original forward: the backward kernel rebuilds
its own internals, so launching the forward kernel again would only rebuild
these (N, F) aggregates.

``contexts`` is a ``context_fn`` for ``torch.utils.checkpoint`` (non
reentrant).  Its first context records, in call order, what each fused
Function's forward returns while the layer runs; its second, entered at each
recomputation of the layer (once per backward pass that reaches it: a force
loss differentiates twice), serves the recorded outputs again in the same
order.  A fused Function's forward asks ``fused_output`` for its outputs:
outside a remat'd layer it launches the kernel and nothing else happens, so
remat off costs one thread-local lookup.  The served outputs come from the
same Function, with the recomputed inputs saved, so its backward is the
fused op's own backward kernel.  (Selective checkpointing's op policies
cannot name these kernels: they are ctypes calls, not ``torch.ops``.)

``replays`` counts the outputs served by replay, by kernel name.
"""

import threading
from collections import Counter

_STATE = threading.local()

replays = Counter()


def _active():
    return getattr(_STATE, "frames", None)


def _detached(out):
    if isinstance(out, tuple):
        return tuple(t.detach() for t in out)
    return out.detach()


class _Scope:
    """Pushes itself onto this thread's stack of active frames while a
    remat'd call runs (``replay`` False: its forward; True: a
    recomputation); ``kept`` is the call's (name, outputs) in call order."""

    def __init__(self, kept, replay):
        self.kept, self.replay, self.cursor = kept, replay, 0

    def __enter__(self):
        self.cursor = 0
        if _active() is None:
            _STATE.frames = []
        _STATE.frames.append(self)
        return self

    def __exit__(self, *exc):
        _STATE.frames.pop()
        return False

    def output(self, name, launch):
        if not self.replay:
            out = launch()
            self.kept.append((name, _detached(out)))
            return out
        if self.cursor >= len(self.kept):
            raise RuntimeError(f"remat recomputed a fused call ({name}) that its forward did not make")
        kept_name, out = self.kept[self.cursor]
        if kept_name != name:
            raise RuntimeError(f"remat recomputed fused calls in another order: {name} where {kept_name} ran")
        self.cursor += 1
        replays[name] += 1
        return _detached(out)


def contexts():
    """A ``context_fn`` for ``torch.utils.checkpoint``: (the forward's
    recording context, the recomputations' replaying context)."""
    kept = []
    return _Scope(kept, replay=False), _Scope(kept, replay=True)


def fused_output(name, launch):
    """``launch()``, a fused forward kernel's outputs (a tensor or a tuple of
    them); inside a remat'd call, recorded in its forward and served from
    that record in its recomputations, which launch nothing."""
    frames = _active()
    if not frames:
        return launch()
    return frames[-1].output(name, launch)


def reset_replays():
    replays.clear()
