"""The port's RecoveringMuxer (librempeg_tpu_torch/sched/supervisor.py,
the fifo muxer's analog) against the JAX package's, on the CPU.

The same scripted failure schedules drive both wrappers: healthy,
transient failures, a packet past its retry budget, the blocking mode
and queue overflow. What reaches the sink, the stats, the queue and
whether the trailer is written or the error raised are equal.
"""
import pytest

from librempeg_tpu.core.packet import Packet as JPacket
from librempeg_tpu.core.packet import PktFlags as JFlags
from librempeg_tpu.core.rational import Rational as JR
from librempeg_tpu.sched.supervisor import RecoveringMuxer as JMux
from librempeg_tpu_torch.core.packet import Packet as TPacket
from librempeg_tpu_torch.core.packet import PktFlags as TFlags
from librempeg_tpu_torch.core.rational import Rational as TR
from librempeg_tpu_torch.sched.supervisor import RecoveringMuxer as TMux


class FlakySink:
    """A muxer stub whose write fails on a scripted schedule."""

    def __init__(self, fail_on=()):
        self.fail_on = set(fail_on)
        self.calls = 0
        self.written = []
        self.streams = []
        self.trailer = False

    def write_header(self):
        pass

    def write(self, pkt):
        self.calls += 1
        if self.calls in self.fail_on:
            raise OSError("simulated downstream failure")
        self.written.append((bytes(pkt.data), pkt.pts))

    def write_trailer(self):
        self.trailer = True


CASES = {
    "healthy": (set(), dict(), 5),
    "transient": ({2, 3}, dict(max_recovery_attempts=5), 4),
    "budget": (set(range(2, 11)), dict(max_recovery_attempts=3), 3),
    "blocking": (set(range(2, 50)), dict(max_recovery_attempts=2,
                                         drop_pkts_on_overflow=False), 2),
    "overflow": (set(range(2, 100)), dict(queue_size=2,
                                          max_recovery_attempts=99), 6),
    "overflow_blocking": ({1, 2}, dict(queue_size=1,
                                       max_recovery_attempts=4,
                                       drop_pkts_on_overflow=False), 5),
}


def _run(mux_cls, packet, flags, rat, fail_on, opts, n):
    sink = FlakySink(fail_on)
    m = mux_cls(sink, **opts)
    m.write_header()
    raised = None
    try:
        for i in range(n):
            m.write(packet(data=bytes([i]) * 4, pts=i, dts=i, duration=1,
                           flags=flags.KEY, time_base=rat(1, 25)))
        m.write_trailer()
    except OSError as e:
        raised = str(e)
    return (sink.written, sink.trailer, sink.calls, dict(m.stats),
            [p.pts for p in m.queue], raised)


@pytest.mark.parametrize("case", sorted(CASES))
def test_recovering_muxer_matches_jax(case):
    fail_on, opts, n = CASES[case]
    j = _run(JMux, JPacket, JFlags, JR, fail_on, opts, n)
    t = _run(TMux, TPacket, TFlags, TR, fail_on, opts, n)
    assert j == t
    written, trailer, _, stats, queue, raised = t
    if case == "healthy":
        assert len(written) == 5 and trailer and stats["dropped"] == 0
    elif case == "blocking":
        assert raised and not trailer
    elif case == "overflow":
        assert stats["dropped"] >= 3 and len(queue) <= 2
