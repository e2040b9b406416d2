"""The end-to-end metrics' arithmetic, on hand-made stamps: tails over every
sample, requests with no first token in the TTFT tail, and a window rate
that a stall cannot hide."""
import numpy as np
import pytest

from portbench import harness, loop
from portbench.traffic import Due


def track(due_t, stamps):
    return loop.Track(Due(0, due_t, np.zeros(4, np.int32), 8), due_t, due_t,
                      list(stamps))


def served(tracks, open_t=10.0, seconds=10.0, end_t=None):
    close_t = open_t + seconds
    window_due = [t for t in tracks if open_t <= t.due_t < close_t]
    return loop.Served(tracks, [], open_t, close_t,
                       end_t if end_t is not None else close_t, window_due)


def read(name, s, **kw):
    return harness.read_metric(name, harness.Run(served=s, **kw))


def test_ttft_tail_over_every_request_due_in_the_window():
    tracks = [track(10.0 + i * 0.1, [10.0 + i * 0.1 + 0.01 * (i + 1)])
              for i in range(50)]
    tracks.append(track(5.0, [12.0]))            # due before the window
    ttfts = [0.01 * (i + 1) for i in range(50)]
    assert read("ttft_p90_s", served(tracks)) == pytest.approx(
        np.percentile(ttfts, 90))


def test_itl_mean_over_every_gap_in_the_window():
    # a gap counts where its later token falls in the window (10, 20]
    tracks = [track(9.0, [9.5, 10.5, 11.0, 21.0]),
              track(12.0, [12.2, 12.6])]
    assert read("itl_mean_ms", served(tracks)) == pytest.approx(
        1e3 * (1.0 + 0.5 + 0.4) / 3)
    assert read("itl_mean_ms", served([track(12.0, [12.5])])) is None


def test_ttft_counts_a_request_that_never_started():
    tracks = [track(10.0 + i * 0.1, [10.0 + i * 0.1 + 0.01])
              for i in range(9)]
    tracks.append(track(11.0, []))               # never got a token
    s = served(tracks, end_t=50.0)
    got = read("ttft_p90_s", s)
    want = np.percentile([0.01] * 9 + [50.0 - 11.0], 90)
    assert got == pytest.approx(want) and got > 3.0


def test_itl_tail_over_every_gap_in_the_window():
    # 80 gaps of 50 ms and 20 of 200 ms in the window; the gap into the
    # window counts, the one after the close does not
    st = [10.0 + 0.05 * i for i in range(1, 81)]
    st += [st[-1] + 0.2 * i for i in range(1, 21)]
    a = track(9.0, [9.5] + st)
    b = track(9.0, [9.6, 9.7, 14.0, 25.0])
    s = served([a, b])
    gaps = [10.05 - 9.5] + [0.05] * 79 + [0.2] * 20 + [14.0 - 9.7]
    assert read("itl_p90_ms", s) == pytest.approx(
        np.percentile(gaps, 90) * 1e3)


def test_window_rate_sees_a_stall():
    # 100 tokens/s for 5 s, then a 5 s stall: 50 tokens/s over the window
    steady = track(0.0, [10.0 + 0.01 * i for i in range(1, 501)])
    assert read("output_tokens_per_s", served([steady])) == \
        pytest.approx(50.0)


def test_joules_per_token_needs_the_counter():
    s = served([track(0.0, [10.5, 11.0, 12.0, 25.0])])
    assert read("joules_per_token", s, energy_j=30.0) == pytest.approx(10.0)
    assert read("joules_per_token", s, energy_j=None) is None


def test_trace_readers_give_nothing_without_a_trace():
    s = served([track(0.0, [10.5])])
    for name in ("prefill_share.latency", "prefill_mfu",
                 "decode_mfu.latency", "k3_roofline",
                 "device_idle_share.offline"):
        assert read(name, s, trace=None, traced_steps=[],
                    config={}) is None
