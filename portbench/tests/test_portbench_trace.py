"""The traced timeline's reductions on a synthetic slice: busy time as the
union of device operations, the harness's host spans put on the device's
clock by the markers, and the idle gaps named by the span over them."""
import dataclasses
from typing import Optional

from portbench.harness.trace import Timeline, align

MS = 1_000_000
T0 = 1_760_000_000 * 1_000 * MS     # a Unix time in ns
OFFSET = 250_000                     # the device's timestamps 250 us after the host's


def test_spans_are_aligned_by_the_markers_and_name_the_gaps():
    marks = [T0 + 100 * MS, T0 + 900 * MS]
    markers = [m + OFFSET for m in marks]
    spans = [("submit", T0 + 200 * MS, T0 + 240 * MS), ("wait", T0 + 240 * MS, T0 + 300 * MS),
             ("embed", T0 + 500 * MS, T0 + 520 * MS)]
    on_device, offsets = align(markers, marks, spans)
    assert offsets == [OFFSET, OFFSET]
    assert on_device[0] == ("submit", T0 + 200 * MS + OFFSET, T0 + 240 * MS + OFFSET)
    d = T0 + OFFSET
    ops = [("k1", d + 150 * MS, d + 210 * MS),    # idle 210-250: submit's
           ("k2", d + 200 * MS, d + 210 * MS),    # inside k1: no gap
           ("k3", d + 250 * MS, d + 490 * MS),    # idle 490-530: embed's
           ("k4", d + 530 * MS, d + 600 * MS),    # idle 600-700: no span
           ("k4", d + 700 * MS, d + 710 * MS)]
    tl = Timeline(1.0, ops, on_device, offsets)
    assert abs(tl.busy_s() - (0.060 + 0.240 + 0.070 + 0.010)) < 1e-9
    assert tl.top_ops(2) == [["k3", 0.24], ["k4", 0.08]]
    gaps = dict((k, round(v, 6)) for k, v in tl.idle_gaps())
    assert gaps == {"submit": 0.04, "embed": 0.04, "no span": 0.1}


def test_a_lost_marker_is_paired_with_its_own_launch():
    """The profiler can lose a large slice's first events: the end marker
    alone still measures the offset; with none the offset is 0."""
    marks = [T0 + 100 * MS, T0 + 5_100 * MS]
    spans = [("submit", T0 + 200 * MS, T0 + 240 * MS)]
    on_device, offsets = align([marks[1] + OFFSET], marks, spans)
    assert offsets == [OFFSET] and on_device[0][1] == T0 + 200 * MS + OFFSET
    on_device, offsets = align([], marks, spans)
    assert offsets == [] and on_device == spans


@dataclasses.dataclass
class ProgramSpan:           # the fields of the program's spans that the timeline reads
    id: int
    name: str
    parent: Optional[int]
    thread: int
    start_ns: int
    end_ns: Optional[int]


def test_program_spans_name_each_idle_gap_by_the_flush_thread_first():
    """`program_idle_gaps` on a slice of two threads: a gap inside an open
    `flush` goes to the flush thread's innermost span even while the
    submitting thread is in `submit`, as `root/innermost`; a gap outside
    every flush goes to the innermost open program span; then to the
    harness's span; else `no_span`. `idle_gaps` is unchanged."""
    t0, main, flusher = T0, 1, 2
    program = [ProgramSpan(1, "submit", None, main, t0, t0 + 100 * MS),
               ProgramSpan(2, "encode_negative", 1, main, t0 + 10 * MS, t0 + 90 * MS),
               ProgramSpan(3, "flush", None, flusher, t0 + 50 * MS, t0 + 300 * MS),
               ProgramSpan(4, "tier", 3, flusher, t0 + 60 * MS, t0 + 250 * MS),
               ProgramSpan(5, "decode", 4, flusher, t0 + 70 * MS, t0 + 120 * MS),
               ProgramSpan(6, "to_host", 3, flusher, t0 + 250 * MS, t0 + 300 * MS),
               ProgramSpan(7, "submit", None, main, t0 + 400 * MS, t0 + 450 * MS)]
    ops = [("k", t0, t0 + 20 * MS),               # idle 20-30: submit/encode_negative
           ("k", t0 + 30 * MS, t0 + 75 * MS),     # idle 75-85: flush/decode, submit open too
           ("k", t0 + 85 * MS, t0 + 260 * MS),    # idle 260-270: flush/to_host
           ("k", t0 + 270 * MS, t0 + 410 * MS),   # idle 410-420: submit
           ("k", t0 + 420 * MS, t0 + 500 * MS),   # idle 500-520: the harness's wait
           ("k", t0 + 520 * MS, t0 + 600 * MS),   # idle 600-700: no span
           ("k", t0 + 700 * MS, t0 + 710 * MS)]
    harness_spans = [("wait", t0 + 490 * MS, t0 + 530 * MS)]
    tl = Timeline(1.0, ops, harness_spans, [], program)
    got = {k: round(v, 6) for k, v in tl.program_idle_gaps()}
    assert got == {"submit/encode_negative": 0.01, "flush/decode": 0.01, "flush/to_host": 0.01,
                   "submit": 0.01, "wait": 0.02, "no_span": 0.1}
    assert tl.idle_gaps() == Timeline(1.0, ops, harness_spans).idle_gaps()
