"""The trace's arithmetic on hand-made intervals."""
from portbench.trace import Trace


def make():
    # span 0..100 ns; kernels 10..30 and 20..40 overlap, a copy 60..70
    return Trace(units=2, t0=0, t1=100,
                 kernels=[("k1", 10, 30), ("k2", 20, 40), ("k1", 90, 120)],
                 copies=[("Memcpy HtoD", 60, 70)],
                 host=[("aten::mm", 35, 65), ("cudaLaunchKernel", 45, 50),
                       ("aten::item", 70, 95)])


def test_busy_union_clipped_to_the_span():
    t = make()
    assert t.busy_intervals() == [[10, 40], [60, 70], [90, 100]]
    assert t.busy_s == 50e-9 and t.window_s == 100e-9


def test_kernels_by_name():
    assert make().kernel_seconds(lambda n: n == "k1") == (2, 50e-9)


def test_idle_gaps_named_by_the_host():
    gaps = make().idle_gaps()
    # gaps: 0..10, 40..60, 70..90, longest first
    assert [g[1] for g in gaps] == [20e-9, 20e-9, 10e-9]
    assert gaps[0][0] == "aten::mm" and gaps[1][0] == "aten::item"
    assert gaps[2][0] == "host between operations"


def test_device_ops_summed_by_name():
    assert make().device_ops()[0] == ["k1", 50e-9]
