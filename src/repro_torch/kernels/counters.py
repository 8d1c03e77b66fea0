"""The launch counters of the kernels the captured decode step runs.

K2 and its combine pass (``paged_decode_attention``,
``paged_decode_combine``) and K4 (``paged_decode_attention.k4_launches``)
count launches in attributes of their wrapper functions, one per Python
call that launches. A captured CUDA graph launches the same kernels at
every replay without calling a wrapper, so the graph runner
(``launch/engine/step_graph.py``) takes a ``snapshot`` before its
warm-up and another around its capture, keeps the capture's ``delta``,
puts the counters back where they were before the warm-up (``restore``:
neither the warm-up nor the capture is work anyone asked for) and
``add``s the delta once per replay. Then "one K2 and one combine launch
per layer per decode step" holds whether the step ran eagerly or by
replay. A kernel that a later captured graph launches gets its entry
here.
"""

from __future__ import annotations

from . import paged_attention as _pa

COUNTED = (
    (_pa.paged_decode_attention, "launches"),
    (_pa.paged_decode_attention, "k4_launches"),
    (_pa.paged_decode_combine, "launches"),
)


def snapshot() -> tuple:
    """Every counter's value, in ``COUNTED`` order."""
    return tuple(getattr(fn, name) for fn, name in COUNTED)


def delta(before: tuple, after: tuple) -> tuple:
    """``after - before``, counter by counter."""
    return tuple(a - b for b, a in zip(before, after))


def add(d: tuple):
    """Advance every counter by the delta ``d`` (one replay's launches)."""
    for (fn, name), v in zip(COUNTED, d):
        setattr(fn, name, getattr(fn, name) + v)


def restore(snap: tuple):
    """Set every counter back to the values of ``snap``."""
    for (fn, name), v in zip(COUNTED, snap):
        setattr(fn, name, v)
