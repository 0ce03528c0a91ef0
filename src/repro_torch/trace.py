"""The port's spans and counters.

:func:`span` names a phase of the program.  While a ``torch.profiler``
session records, it is a ``torch.profiler.record_function`` range, kept
in the profiler's memory and written out with its trace: on the
profiler's clock, the one its device ops carry, so a device op's launch
and an idle gap of the device can be put down to the span the host was
in.  With no profiler recording it is one shared context that does
nothing (a few hundred ns to enter and leave), so the spans stay on the
training path.  There is no second span recorder.

The spans of the DIGEST epoch (``core/digest.py``), parents by nesting:

    digest.epoch          one global round (``make_epoch_fn``'s epoch_fn)
      digest.gather       two a round: the layer-0 halo feature gather
                          before the pull, the local one after it
      store.pull          a round that pulls: the slab pull (GAT: the
                          store's projection and the z slabs' pulls)
      digest.subgraph     one subgraph's loss and gradient, M a round
        gnn.forward       its halo tables, ``gnn_forward`` and the loss
        gnn.backward      its ``torch.autograd.grad``
      digest.update       two a round: the gradient mean (with a mesh its
                          all_reduce), then the optimizer's update
      store.probe         every round: the staleness probe
      store.push          a round that pushes: the push (error feedback,
                          the SAT pstore's push)

:data:`COUNTERS` counts whether or not a profiler records, each where the
work happens, from the shapes of the tensors the code writes:

    digest.epochs         epoch_fn calls
    store.pull_bytes      bytes of every slab tensor a pull writes, data
                          and scales (``pull_slab``, ``collective_pull``)
    store.push_bytes      bytes of the rows a push writes, in the store's
                          precision, sentinel rows and scales included
                          (``push``, ``shard_push``, ``owner_push``; the
                          SAT pstore's too)
"""
from __future__ import annotations

import collections

from torch.autograd import profiler

COUNTERS: collections.Counter = collections.Counter()


class _Off:
    """The span of an unrecorded run: enters and leaves, nothing more."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc) -> bool:
        return False


OFF = _Off()


def span(name: str):
    """A context naming a phase: a ``record_function`` range while a
    profiler records, else :data:`OFF`."""
    if profiler._is_profiler_enabled:
        return profiler.record_function(name)
    return OFF


def reset_counters() -> None:
    COUNTERS.clear()
