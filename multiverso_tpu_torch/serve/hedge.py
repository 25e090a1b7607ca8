"""Hedged reads for the anonymous serve tier (docs/serving.md "tail").

The classic tail-at-scale remedy: issue the read on the PRIMARY
connection, and if no answer arrives within a delay derived from the
live latency histogram (observed p95, floored at ``-hedge_min_us``),
re-issue it against the hot-key replica — answered AT THE REACTOR
(``-replica_serve_reactor``), so it bypasses the actor mailbox a
straggling apply is clogging — or, when the replica does not hold the
rows, against a second connection.  The first answer wins; the loser is
cancelled with a fire-and-forget ``RequestCancel`` token that overtakes
the mailbox FIFO, so a still-queued loser is dropped at dequeue instead
of burning an apply slot (``serve.hedge.cancelled`` server-side).

Reads only, ever — hedging an add would duplicate its side effect; the
audit plane's zero-dup invariant is part of this module's
acceptance test.

Counters (client-side, mirrored into the metrics registry when one is
importable): ``serve.hedge.issued`` / ``won`` / ``wasted`` — the win
rate ``won / issued`` is the benchable health signal (``bench_tail``).
"""

from __future__ import annotations

import selectors
import socket
import time
from typing import Optional

import numpy as np

from .wire import (MSG, AnonServeClient, QOS_CLASSES, pack_frame,
                   unpack_frame)

__all__ = ["HedgedReader", "LatencyTracker"]


def _flag_us(value, name, fallback):
    """Config-flag lookup that stays importable without the package."""
    if value is not None:
        return float(value)
    try:
        from .. import config
        return float(config.get(name))
    except Exception:
        return float(fallback)


class LatencyTracker:
    """Bounded ring of observed read latencies; the hedge delay is the
    observed p95 floored at ``hedge_min_s`` — hedging earlier than the
    tail starts re-issues the bulk of healthy traffic for nothing."""

    def __init__(self, capacity: int = 256):
        self._ring = []
        self._cap = max(8, int(capacity))
        self.samples = 0

    def observe(self, seconds: float) -> None:
        self._ring.append(float(seconds))
        del self._ring[:-self._cap]
        self.samples += 1

    def quantile(self, q: float) -> Optional[float]:
        if not self._ring:
            return None
        vals = sorted(self._ring)
        idx = min(len(vals) - 1, int(q * len(vals)))
        return vals[idx]

    def hedge_delay(self, floor_s: float) -> float:
        p95 = self.quantile(0.95)
        return max(floor_s, p95) if p95 is not None else floor_s


class HedgedReader:
    """Hedged row reads against one server shard over two anonymous
    connections (gold tenant class by default — a hedger re-issuing
    bulk traffic would amplify exactly the herd QoS exists to shed).

    ``get_rows(ids)`` is the hedged entry point; ``enabled=False`` is
    the control arm (identical wire traffic, no hedge ever issued).
    Single-shard scope: the reader targets ONE endpoint, so callers
    aim it at the shard that owns their rows (the DLRM serve shape).
    """

    def __init__(self, endpoint: str, table_id: int, cols: int, *,
                 qos_class="gold", qos_classes=QOS_CLASSES,
                 hedge_min_us: Optional[float] = None,
                 enabled: bool = True,
                 timeout: Optional[float] = None,
                 backup_endpoint: Optional[str] = None,
                 backup_shard: int = -1):
        self.table_id = int(table_id)
        self.cols = int(cols)
        self.enabled = bool(enabled)
        self.hedge_min_s = _flag_us(hedge_min_us, "hedge_min_us",
                                    1000.0) * 1e-6
        self.primary = AnonServeClient(endpoint, timeout=timeout,
                                       timing=False, qos_class=qos_class,
                                       qos_classes=qos_classes)
        self.secondary = AnonServeClient(endpoint, timeout=timeout,
                                         timing=False, qos_class=qos_class,
                                         qos_classes=qos_classes)
        # True-backup hedge (docs/replication.md): with replication
        # armed, the shard has a REAL second copy — the backup rank's
        # serve port answers reads of `backup_shard` from its backed
        # instance (bounded behind the primary only by the forward
        # stream; exact under -repl_sync).  Unlike the hot-key replica
        # it holds EVERY row, so a hedge against it never falls back
        # to re-asking the straggling primary.  The shard hint routes
        # the read at a rank that serves two shards of the table.
        self.backup = None
        self.backup_shard = int(backup_shard)
        self.backup_wins = 0
        if backup_endpoint:
            self.backup = AnonServeClient(backup_endpoint, timeout=timeout,
                                          timing=False,
                                          qos_class=qos_class,
                                          qos_classes=qos_classes)
        self.tracker = LatencyTracker()
        # epoll-backed readiness (NOT select.select: at 10k-connection
        # scale this process's fds exceed FD_SETSIZE and select raises).
        self._psel = selectors.DefaultSelector()
        self._psel.register(self.primary.sock, selectors.EVENT_READ)
        self.issued = 0      # hedges fired
        self.won = 0         # hedge answered first
        self.wasted = 0      # hedge fired but the primary won anyway
        self.cancelled = 0   # cancel tokens sent
        # msg ids whose (late) primary replies must be discarded.
        self._stale = set()

    # ------------------------------------------------------------ plumbing
    def _send_get(self, client: AnonServeClient, ids: np.ndarray) -> int:
        mid = client._next_id()
        client.send_raw(pack_frame(MSG["RequestGet"], self.table_id, mid,
                                   blobs=[ids.tobytes()],
                                   qos=client._qos()))
        return mid

    def _poll_reply(self, client: AnonServeClient, want_mid: int,
                    wait_s: float) -> Optional[dict]:
        """Wait up to ``wait_s`` for ``want_mid``'s reply on ``client``;
        stale replies (cancelled losers) are discarded along the way.
        None on timeout — the socket stays healthy for later frames."""
        deadline = time.monotonic() + max(wait_s, 0.0)
        sock = client.sock
        while True:
            frame = client._decoder.next_frame()
            if frame is not None:
                reply = unpack_frame(frame)
                if reply["msg_id"] in self._stale:
                    self._stale.discard(reply["msg_id"])
                    continue
                if reply["msg_id"] == want_mid:
                    return reply
                continue  # unrelated (shouldn't happen): drop
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                return None
            if not self._psel.select(timeout=remaining):
                return None
            try:
                chunk = sock.recv(65536, socket.MSG_DONTWAIT)
            except (BlockingIOError, InterruptedError):
                continue
            if not chunk:
                raise ConnectionError("server closed the connection")
            client._decoder.feed(chunk)

    def _rows_from_reply(self, reply: dict, ids: np.ndarray) -> np.ndarray:
        out = np.frombuffer(reply["blobs"][0], dtype=np.float32)
        return out.reshape(ids.size, self.cols)

    def _note(self, name: str) -> None:
        try:
            from .. import metrics
            metrics.counter(name).inc()
        except Exception:
            pass

    # -------------------------------------------------------------- reads
    def get_rows(self, row_ids) -> np.ndarray:
        """Hedged read of ``row_ids`` (global ids owned by this shard).

        Primary RequestGet first; past the hedge delay, the hot-key
        replica is pulled on the second connection (reactor-served) and
        wins if it holds every requested row at least as fresh as the
        snapshot bound; otherwise a second full get races the primary.
        The loser is cancelled."""
        ids = np.ascontiguousarray(row_ids, dtype=np.int32)
        t0 = time.monotonic()
        mid = self._send_get(self.primary, ids)
        budget = self.primary.timeout or 30.0
        if not self.enabled:
            reply = self._poll_reply(self.primary, mid, budget)
            if reply is None:
                raise TimeoutError(f"primary read {mid} timed out")
            self.tracker.observe(time.monotonic() - t0)
            return self._rows_from_reply(reply, ids)

        delay = self.tracker.hedge_delay(self.hedge_min_s)
        reply = self._poll_reply(self.primary, mid, delay)
        if reply is not None:
            self.tracker.observe(time.monotonic() - t0)
            return self._rows_from_reply(reply, ids)

        # --- hedge: true backup shard first (docs/replication.md),
        # else the hot-key replica (reactor-served, mailbox-free) ------
        self.issued += 1
        self._note("serve.hedge.issued")
        hedge_rows = None
        hit_backup = False
        if self.backup is not None and ids.size:
            # The backup holds the WHOLE shard — a complete answer
            # regardless of key temperature, and a straggling primary's
            # clogged mailbox is not in its path at all.
            hedge_rows = self.backup.get_rows(self.table_id, ids,
                                              self.cols,
                                              shard=self.backup_shard)
            hit_backup = True
            self._note("serve.hedge.backup")
        if hedge_rows is None:
            replica = self.secondary.get_replica(self.table_id)
            if all(int(i) in replica for i in ids):
                hedge_rows = np.stack([replica[int(i)][1] for i in ids])
            elif ids.size:
                # Replica cold for these rows: second-connection hedge.
                hedge_rows = self.secondary.get_rows(self.table_id, ids,
                                                     self.cols)
        # First answer wins: one nonblocking look at the primary.
        late = self._poll_reply(self.primary, mid, 0.0)
        if late is not None:
            self.wasted += 1
            self._note("serve.hedge.wasted")
            self.tracker.observe(time.monotonic() - t0)
            return self._rows_from_reply(late, ids)
        self.won += 1
        self._note("serve.hedge.won")
        if hit_backup:
            self.backup_wins += 1
            self._note("serve.hedge.backup.won")
        # Cancel the loser: a fire-and-forget token that overtakes the
        # mailbox FIFO; its late reply (if the apply already ran) is
        # discarded via the stale set.
        self.primary.cancel(self.table_id, mid)
        self.cancelled += 1
        self._stale.add(mid)
        self.tracker.observe(time.monotonic() - t0)
        return hedge_rows

    def stats(self) -> dict:
        return {"issued": self.issued, "won": self.won,
                "wasted": self.wasted, "cancelled": self.cancelled,
                "backup_wins": self.backup_wins,
                "win_rate": self.won / self.issued if self.issued else 0.0,
                "samples": self.tracker.samples}

    def close(self) -> None:
        try:
            self._psel.unregister(self.primary.sock)
        except (KeyError, ValueError):
            pass
        self._psel.close()
        self.primary.close()
        self.secondary.close()
        if self.backup is not None:
            self.backup.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
