"""Output recovery supervisor: the fifo-muxer analog.

Analog of libavformat/fifo.c: a wrapper muxer that
decouples the pipeline from a flaky downstream sink. Packets enter a
bounded queue; a drain step writes them to the inner muxer and, on
failure, retries with backoff and (optionally) drops queued packets
instead of stalling the pipeline — the reference's
attempt_recovery/fifo_consumer loop, single-threaded here to match the
framework's one-orchestrator design (threads add nothing: device work
is already async under dispatch).

A copy of librempeg_tpu/sched/supervisor.py (host code) with its imports
rewritten to the port's modules.
"""
from __future__ import annotations

import time
from collections import deque

from librempeg_tpu_torch.core.log import Logger
from librempeg_tpu_torch.core.packet import Packet

log = Logger("fifo")


class RecoveringMuxer:
    """Wrap a muxer; absorb write failures with retry + drop policy.

    Options mirror fifo.c: queue_size (max buffered packets),
    max_recovery_attempts, recovery_wait (seconds, linear backoff),
    drop_pkts_on_overflow.
    """

    def __init__(self, inner, queue_size: int = 64,
                 max_recovery_attempts: int = 3,
                 recovery_wait: float = 0.0,
                 drop_pkts_on_overflow: bool = True):
        self.inner = inner
        self.queue: deque[Packet] = deque()
        self.queue_size = queue_size
        self.max_attempts = max_recovery_attempts
        self.wait = recovery_wait
        self.drop_on_overflow = drop_pkts_on_overflow
        self.stats = {"written": 0, "dropped": 0, "recoveries": 0,
                      "failed_writes": 0}
        self._attempts = 0

    # muxer-compatible surface -----------------------------------------
    @property
    def streams(self):
        return self.inner.streams

    def add_stream(self, *a, **kw):
        return self.inner.add_stream(*a, **kw)

    def write_header(self):
        self.inner.write_header()

    def write(self, pkt: Packet) -> None:
        if len(self.queue) >= self.queue_size:
            if not self.drop_on_overflow:
                # blocking mode: force a drain (may raise after retries)
                self._drain(force=True)
            else:
                self.queue.popleft()
                self.stats["dropped"] += 1
                log.warning("queue overflow, dropped oldest packet "
                            "(%d dropped total)", self.stats["dropped"])
        self.queue.append(pkt)
        self._drain(force=False)

    def write_trailer(self) -> None:
        self._drain(force=True)
        self.inner.write_trailer()
        if self.stats["dropped"]:
            log.warning("finished with %d dropped packets",
                        self.stats["dropped"])

    # internals ----------------------------------------------------------
    def _drain(self, force: bool) -> None:
        while self.queue:
            pkt = self.queue[0]
            try:
                self.inner.write(pkt)
            except Exception as e:   # noqa: BLE001 — recovery boundary
                self.stats["failed_writes"] += 1
                self._attempts += 1
                if self._attempts > self.max_attempts:
                    if self.drop_on_overflow:
                        self.queue.popleft()
                        self.stats["dropped"] += 1
                        self._attempts = 0
                        log.warning("dropping packet after %d attempts: %s",
                                    self.max_attempts, e)
                        continue
                    raise
                if not force:
                    return           # leave queued; retry on next write
                if self.wait:
                    time.sleep(self.wait * self._attempts)
                continue
            else:
                self.queue.popleft()
                if self._attempts:
                    self.stats["recoveries"] += 1
                    log.info("recovered after %d failed attempts",
                             self._attempts)
                self._attempts = 0
                self.stats["written"] += 1
