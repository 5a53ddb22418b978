"""The program's own spans in the traced stretch, and the card's idle time
attributed to them.

The program names its spans in ``gan_tpu_torch.utils.profiling.SPANS``
(``torch.profiler.record_function`` ranges, opened on the main thread only
while the profiler records); they reach a reader as host events of
``Stretch.host`` whose names start with ``gan_tpu_torch.``. At each instant
the innermost open span decides: the latest-starting span that encloses it.
An idle gap of the card of at least ``trace.SHORT_GAP_US`` is split by that
rule; the part that no program span covers is the caller's, between passes
(``BETWEEN``). Gaps below ``SHORT_GAP_US`` are left out, as ``breakdown``
sums them under one label.

A program without the spans (``SPANS`` missing, or a name a reader asks for
not among them) gives every reader here nothing to read: ``name`` is None,
and so is the reader's value.
"""

from __future__ import annotations

import heapq

from portbench import trace

try:
    from gan_tpu_torch.utils.profiling import SPANS
except ImportError:   # a program that opens no spans
    SPANS = ()

PREFIX = "gan_tpu_torch."
BETWEEN = None   # the key of idle time outside every program span
# the spans of the epoch runner's own code, inside a pass
RUNNER = ("epoch", "epoch.plan", "epoch.fetch", "runner.prepare", "runner.replay",
          "runner.capture")


def name(short: str):
    """The program's span ``gan_tpu_torch.<short>``, or None where the
    program does not name it."""
    full = PREFIX + short
    return full if full in SPANS else None


def program(stretch: trace.Stretch) -> list[tuple[float, float, str]]:
    """(start µs, end µs, name) of the program's spans in the stretch, clipped to it."""
    return [(max(a, stretch.start), min(b, stretch.end), n) for a, b, n in stretch.host
            if n.startswith(PREFIX) and b > stretch.start and a < stretch.end]


def innermost(spans: list) -> list[tuple[float, float, str]]:
    """Disjoint (start, end, name) pieces of the time under ``spans``
    ((start, end, name) each), each named after the latest-starting span
    that encloses it (of two that start together, the shorter)."""
    ordered = sorted(spans)
    bounds = sorted({t for a, b, _ in spans for t in (a, b)})
    open_, i, out = [], 0, []
    for lo, hi in zip(bounds, bounds[1:]):
        while i < len(ordered) and ordered[i][0] <= lo:
            a, b, n = ordered[i]
            heapq.heappush(open_, (-a, b, n))
            i += 1
        while open_ and open_[0][1] <= lo:
            heapq.heappop(open_)
        if open_:
            if out and out[-1][2] == open_[0][2] and out[-1][1] == lo:
                out[-1] = (out[-1][0], hi, out[-1][2])
            else:
                out.append((lo, hi, open_[0][2]))
    return out


def idle_by_span(stretch: trace.Stretch) -> dict | None:
    """µs of the card's idle gaps of at least ``trace.SHORT_GAP_US``, by the
    innermost program span over each part of them (``BETWEEN``: under
    none); None where the stretch holds no device event or no program span."""
    spans = program(stretch)
    if not stretch.device or not spans:
        return None
    pieces = innermost(spans)
    out: dict = {}
    j = 0
    for a, b in stretch.idle_gaps():
        if b - a < trace.SHORT_GAP_US:
            continue
        covered = 0.0
        while j < len(pieces) and pieces[j][1] <= a:
            j += 1
        k = j
        while k < len(pieces) and pieces[k][0] < b:
            lo, hi = max(a, pieces[k][0]), min(b, pieces[k][1])
            if hi > lo:
                out[pieces[k][2]] = out.get(pieces[k][2], 0.0) + hi - lo
                covered += hi - lo
            k += 1
        out[BETWEEN] = out.get(BETWEEN, 0.0) + (b - a) - covered
    return out


def idle_pct(stretch: trace.Stretch, shorts) -> float | None:
    """The share of the stretch's span in which the card idled, in gaps of at
    least ``trace.SHORT_GAP_US``, under the program spans ``shorts``."""
    names = [name(s) for s in shorts]
    split = idle_by_span(stretch)
    if split is None or None in names:
        return None
    return 100.0 * sum(split.get(n, 0.0) for n in names) / (stretch.end - stretch.start)


def count(stretch: trace.Stretch, full: str) -> int:
    return sum(n == full for _a, _b, n in program(stretch))
