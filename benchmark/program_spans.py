"""The program's own spans inside a traced run's window.

The port records spans (`faststyle_tpu_torch.utils.profiling.span`: name,
id, parent, thread, start and end) while a torch profiler records, on
`time.time_ns()`'s clock, which is the clock of the profiler's events and
so of `run.trace`. A reader keeps the spans of one name that start inside
the traced window and reads their mean length, or the device's idle time
that they overlap. A program that records no spans (one without
`profiling.recorded`), or a window with none of the name, reads None.
"""

from __future__ import annotations


def recorded() -> list:
    """The program's recorded spans; [] for a program that keeps none."""
    from faststyle_tpu_torch.utils import profiling

    read = getattr(profiling, "recorded", None)
    return [] if read is None else list(read())


def in_window(trace, name: str) -> list[tuple[int, int]]:
    """(start_ns, end_ns) of the program's spans of `name` that start inside
    the trace's window."""
    if trace is None:
        return []
    return [(s.start_ns, s.end_ns) for s in recorded() if s.name == name and trace.start_ns <= s.start_ns < trace.end_ns]


def mean_ms(run, name: str) -> float | None:
    """Mean length in ms of the spans of `name` that start in the window."""
    spans = in_window(run.trace, name)
    return sum(e - s for s, e in spans) / len(spans) / 1e6 if spans else None


def idle_gaps(trace) -> list[tuple[int, int]]:
    """The window's stretches with no operation on the device."""
    gaps, last = [], trace.start_ns
    for s, e in trace.busy_intervals() + [(trace.end_ns, trace.end_ns)]:
        if s > last:
            gaps.append((last, s))
        last = max(last, e)
    return gaps


def idle_overlap_ns(trace, intervals: list[tuple[int, int]]) -> int:
    """Device-idle nanoseconds inside the union of `intervals`, each cut to
    the window."""
    merged: list[list[int]] = []
    for s, e in sorted((max(s, trace.start_ns), min(e, trace.end_ns)) for s, e in intervals):
        if e <= s:
            continue
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    total, i, gaps = 0, 0, idle_gaps(trace)
    for s, e in merged:
        while i < len(gaps) and gaps[i][1] <= s:
            i += 1
        j = i
        while j < len(gaps) and gaps[j][0] < e:
            total += min(e, gaps[j][1]) - max(s, gaps[j][0])
            j += 1
    return total


def idle_ms_per(run, name: str, per: str) -> float | None:
    """Device-idle ms overlapped by the spans of `name`, per span of `per`
    (both starting in the window)."""
    spans, count = in_window(run.trace, name), len(in_window(run.trace, per))
    if not spans or not count:
        return None
    return idle_overlap_ns(run.trace, spans) / count / 1e6
