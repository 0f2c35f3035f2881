"""The traced timeline's reductions on a synthetic slice: busy time as the
union of device operations, the harness's host spans put on the device's
clock by the markers, and the idle gaps named by the span over them."""
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
