"""Named ranges of the port on the profiler's clock.

:func:`span` opens a profiler range only while a torch profiler is
recording.  Otherwise it returns one shared no-op context, so a span off
costs the profiler's gate and allocates nothing; :attr:`Span.opened`
counts the ranges opened, the witness that tracing off opens none (as
:attr:`service.telemetry.PhaseTimer.spans_entered` is the engine's).

A range is a host event of the profiler's trace, beside the launches and
the device work it encloses, and nothing else.  It is recorded as an
operator (``torch._C._profiler._RecordFunctionFast``), not as a
``torch.profiler.record_function`` user annotation: the profiler mirrors
every user annotation on the card's timeline as a device event, under an
id of the host's operators, which a reader that ties device work to its
launch by correlation id can take for a kernel.  That constructor is
private to torch; where it is missing the public ``record_function`` is
used, and ``tests/test_torch_spans.py`` fails to say so.  Once the
benchmark's trace keeps only kernels, copies and sets, the public range
will do everywhere.

The spans of the port:

* ``sa.level``: one temperature level of the ladder, sweep, exchange and
  best-so-far (``core/annealing.py::level_step``).
* ``sa.pack``: the copy of a strided sweep input into the contiguous one
  kernel B1 reads (``kernels/metropolis_sweep.py``); under V2 that is the
  champion broadcast to every chain.  It opens only where there is a copy,
  so each range launches exactly one.

This module imports nothing of the port, so ``core/`` and ``kernels/``
take it without loading the serving engine.
"""
from __future__ import annotations

import contextlib

from torch.autograd import _profiler_enabled

try:
    from torch._C._profiler import _RecordFunctionFast as _Range
except ImportError:
    from torch.profiler import record_function as _Range


class Span:
    """A profiler range that counts the ranges opened."""

    __slots__ = ("_range",)

    #: Class-wide count of ranges ever opened: with no profiler recording
    #: it must not move (tests assert it).
    opened = 0

    def __init__(self, name: str):
        self._range = _Range(name)

    def __enter__(self):
        Span.opened += 1
        self._range.__enter__()
        return self

    def __exit__(self, *exc):
        self._range.__exit__(*exc)
        return False


#: The span with no profiler recording: one shared no-op context.
NULL_SPAN = contextlib.nullcontext()


def span(name: str):
    """A range named ``name`` while a profiler records, else the no-op."""
    return Span(name) if _profiler_enabled() else NULL_SPAN
