"""Zero-copy shared-memory staging ring for the multi-process host plane
(the port's copy of ``repro.serving.staging``).

The ingest pool (``serving/ingest_pool.py``) runs the preprocess hook —
tokenize, vocab lookup, histogram build — in N worker *processes*.  The
vectorized query histograms come back to the dispatcher through THIS ring:
a ``multiprocessing.shared_memory`` block laid out as ``nslots`` fixed-shape
slots, each holding one ``(h_max,)`` ids/weights row plus a seqlock-style
header.  The dispatcher maps the block once and reads query tensors as
``np.frombuffer`` views — no pickling, no per-query IPC allocation; the
only bytes that cross a pickled channel are the RAW payloads going out to
the workers (the pool refuses ndarray payloads structurally).

Layout (all offsets 8-byte aligned)::

    control: int64[2 + max_writers]
        [0] read_cursor   tickets < read_cursor are consumed; their slots
                          may be reused (single consumer writes this)
        [1] closing       nonzero once the pool is shutting down
        [2+w] claims[w]   ticket writer w is currently vectorizing
                          (-1 = idle) — the crash post-mortem record
    slot t % nslots: header int64[4] + error bytes + ids int32[h] + w f32[h]
        header = [seq, ticket, status, n]

Seqlock slot protocol (single consumer, one writer per slot at a time —
the ring's flow control guarantees writer exclusivity per slot):

* WRITER of ticket ``t``: wait until ``t - read_cursor < nslots`` (its
  slot's previous occupant was consumed), bump ``seq`` to ODD, write
  ticket/status/n/payload, bump ``seq`` back to EVEN.
* READER awaiting ticket ``t``: read ``seq`` (must be even), read the
  header; if ``ticket != t`` the write hasn't landed yet — retry; else
  read the payload and re-read ``seq`` — a changed ``seq`` means the read
  raced a writer (torn) and must retry.  Tickets per slot strictly
  increase, so there is no ABA ambiguity.

CPython cannot issue explicit memory barriers, but the protocol only needs
(a) aligned 8-byte stores for ``seq`` (numpy int64 scalar assignment) and
(b) store ordering, which x86-TSO and the interpreter's per-bytecode
memory operations provide.

Backpressure falls out of the flow control: when all ``nslots`` slots hold
unconsumed histograms, every writer blocks (polling, with a ``closing``
escape) until the dispatcher consumes — bounded memory no matter how far
ingest runs ahead of dispatch.
"""

from __future__ import annotations

import time
from multiprocessing import shared_memory

import numpy as np

#: Slot status codes (header field 2).
EMPTY, OK, ERROR = 0, 1, 2

#: Bytes reserved per slot for a utf-8 error message (preprocess failures
#: travel through the ring too, so error/data ordering is the slot order).
ERR_BYTES = 192

_HDR_FIELDS = 4  # seq, ticket, status, n
_CTRL_FIXED = 2  # read_cursor, closing


class StagingClosed(RuntimeError):
    """The ring was shut down while a writer/reader was blocked on it."""


def _slot_stride(h_max: int) -> int:
    raw = 8 * _HDR_FIELDS + ERR_BYTES + 4 * h_max + 4 * h_max
    return (raw + 63) // 64 * 64  # cache-line rounding; keeps 8-alignment


class StagingRing:
    """One shared-memory ring of fixed-shape query-histogram slots.

    Create with :meth:`create` in the parent (owner; unlinks on close) and
    :meth:`attach` in each worker process via the picklable :attr:`spec`.
    """

    def __init__(self, shm: shared_memory.SharedMemory, nslots: int,
                 h_max: int, max_writers: int, *, owner: bool):
        self._shm = shm
        self.nslots = int(nslots)
        self.h_max = int(h_max)
        self.max_writers = int(max_writers)
        self._owner = owner
        ctrl_n = _CTRL_FIXED + max_writers
        self._ctrl = np.frombuffer(shm.buf, np.int64, count=ctrl_n)
        self._stride = _slot_stride(h_max)
        self._base = 8 * ctrl_n
        # Per-slot views, built once: header, error bytes, ids, weights.
        self._hdr, self._err, self._ids, self._w = [], [], [], []
        for s in range(nslots):
            off = self._base + s * self._stride
            self._hdr.append(np.frombuffer(shm.buf, np.int64,
                                           count=_HDR_FIELDS, offset=off))
            off += 8 * _HDR_FIELDS
            self._err.append(np.frombuffer(shm.buf, np.uint8,
                                           count=ERR_BYTES, offset=off))
            off += ERR_BYTES
            self._ids.append(np.frombuffer(shm.buf, np.int32,
                                           count=h_max, offset=off))
            off += 4 * h_max
            self._w.append(np.frombuffer(shm.buf, np.float32,
                                         count=h_max, offset=off))

    # -- construction ------------------------------------------------------
    @classmethod
    def create(cls, nslots: int, h_max: int,
               max_writers: int = 1) -> "StagingRing":
        size = 8 * (_CTRL_FIXED + max_writers) + nslots * _slot_stride(h_max)
        shm = shared_memory.SharedMemory(create=True, size=size)
        ring = cls(shm, nslots, h_max, max_writers, owner=True)
        ring._ctrl[:] = 0
        ring._ctrl[_CTRL_FIXED:] = -1  # claims: idle
        for s in range(nslots):
            ring._hdr[s][:] = 0
        return ring

    @classmethod
    def attach(cls, spec: tuple) -> "StagingRing":
        name, nslots, h_max, max_writers = spec
        shm = shared_memory.SharedMemory(name=name)
        return cls(shm, nslots, h_max, max_writers, owner=False)

    @property
    def spec(self) -> tuple:
        """Picklable attach handle: ``(name, nslots, h_max, max_writers)``."""
        return (self._shm.name, self.nslots, self.h_max, self.max_writers)

    # -- control words -----------------------------------------------------
    @property
    def read_cursor(self) -> int:
        return int(self._ctrl[0])

    @property
    def closing(self) -> bool:
        return bool(self._ctrl[1])

    def close_ring(self) -> None:
        """Flag shutdown: blocked writers/readers raise StagingClosed."""
        self._ctrl[1] = 1

    def claim(self, writer: int, ticket: int) -> None:
        """Record that `writer` is now vectorizing `ticket` (crash forensics)."""
        self._ctrl[_CTRL_FIXED + writer] = ticket

    def clear_claim(self, writer: int) -> None:
        self._ctrl[_CTRL_FIXED + writer] = -1

    def claimed(self, writer: int) -> int:
        """Ticket `writer` was holding (-1 = idle)."""
        return int(self._ctrl[_CTRL_FIXED + writer])

    # -- writer side -------------------------------------------------------
    def _wait_slot_free(self, ticket: int, timeout: float | None) -> None:
        deadline = None if timeout is None else time.monotonic() + timeout
        delay = 50e-6
        while ticket - int(self._ctrl[0]) >= self.nslots:
            if self._ctrl[1]:
                raise StagingClosed("staging ring closed while waiting "
                                    f"for a free slot (ticket {ticket})")
            if deadline is not None and time.monotonic() > deadline:
                raise TimeoutError(
                    f"no free staging slot for ticket {ticket} within "
                    f"{timeout}s (dispatcher stalled?)")
            time.sleep(delay)
            delay = min(delay * 2, 1e-3)

    def _publish(self, ticket: int, status: int, n: int,
                 fill) -> None:
        s = ticket % self.nslots
        hdr = self._hdr[s]
        hdr[0] += 1          # seq -> odd: slot is being written
        hdr[1] = ticket
        hdr[2] = status
        hdr[3] = n
        fill(s)
        hdr[0] += 1          # seq -> even: slot is stable

    def write(self, ticket: int, ids: np.ndarray, weights: np.ndarray, *,
              timeout: float | None = None) -> None:
        """Publish one vectorized histogram; blocks while the ring is full."""
        ids = np.asarray(ids, np.int32).reshape(-1)
        weights = np.asarray(weights, np.float32).reshape(-1)
        n = min(len(ids), len(weights), self.h_max)
        self._wait_slot_free(ticket, timeout)

        def fill(s: int) -> None:
            self._ids[s][:n] = ids[:n]
            self._w[s][:n] = weights[:n]

        self._publish(ticket, OK, n, fill)

    def write_error(self, ticket: int, message: str, *,
                    timeout: float | None = None) -> None:
        """Publish a preprocess failure in the ticket's slot (keeps the
        error in the SAME delivery order as data)."""
        raw = message.encode("utf-8", "replace")[:ERR_BYTES]
        self._wait_slot_free(ticket, timeout)

        def fill(s: int) -> None:
            self._err[s][:len(raw)] = np.frombuffer(raw, np.uint8)

        self._publish(ticket, ERROR, len(raw), fill)

    # -- reader side (single consumer) -------------------------------------
    def poll(self, ticket: int):
        """One seqlock read attempt for `ticket`.

        Returns ``None`` when the write hasn't landed (or the read tore and
        should be retried), ``("ok", ids_view, w_view, n)`` with ZERO-COPY
        views into the shared block (valid until the slot is consumed and
        reused), or ``("error", message)``.
        """
        s = ticket % self.nslots
        hdr = self._hdr[s]
        seq0 = int(hdr[0])
        if seq0 & 1:
            return None                       # mid-write
        if int(hdr[1]) != ticket or int(hdr[2]) == EMPTY:
            return None                       # not written yet (or stale)
        status, n = int(hdr[2]), int(hdr[3])
        if status == OK:
            out = ("ok", self._ids[s][:n], self._w[s][:n], n)
        else:
            msg = bytes(self._err[s][:n]).decode("utf-8", "replace")
            out = ("error", msg)
        if int(hdr[0]) != seq0:
            return None                       # torn: a writer raced us
        return out

    def consume(self, upto_ticket: int) -> None:
        """Mark every ticket < `upto_ticket` consumed (slots reusable)."""
        if upto_ticket > int(self._ctrl[0]):
            self._ctrl[0] = upto_ticket

    def occupancy(self) -> int:
        """Slots holding a written-but-unconsumed histogram (gauge feed)."""
        cursor = int(self._ctrl[0])
        count = 0
        for s in range(self.nslots):
            hdr = self._hdr[s]
            if (not int(hdr[0]) & 1 and int(hdr[2]) != EMPTY
                    and int(hdr[1]) >= cursor):
                count += 1
        return count

    # -- lifecycle ---------------------------------------------------------
    def close(self) -> None:
        # Numpy views must be dropped before the mmap can close.  A caller
        # still holding poll() views makes close() raise BufferError — the
        # mapping then lives until those views die, but the segment must
        # STILL be unlinked (owner) or the /dev/shm file leaks.
        self._ctrl = self._hdr = self._err = self._ids = self._w = None
        try:
            self._shm.close()
        except BufferError:
            pass
        if self._owner:
            try:
                self._shm.unlink()
            except FileNotFoundError:
                pass


def pad_batch(qs, max_batch: int, h_max: int):
    """Host prep: pad ≤``max_batch`` ``(ids, weights)`` histograms to numpy
    ``(max_batch, h_max)`` arrays ``(ids int32, weights float32)``, the
    reference's padded batch bit for bit.

    Padding queries carry weight 0 everywhere; slots with zero weight get
    id 0 so they never gather an embedding.  Idempotent: feeding the padded
    rows back reproduces the same batch bit-for-bit — the zero-copy staging
    path relies on this (a histogram staged at ``h_max`` and re-padded must
    not drift).  That rules out unconditional L1 renormalization
    (``sum(w/s)`` re-rounds one ulp per pass): a row whose float32 sum is
    ALREADY 1 within the ``h_max``-addend accumulation tolerance passes
    through bit-unchanged.  Histograms longer than ``h_max`` are truncated.

    The serving core calls it with ``max_batch`` = the batch's real query
    count (the port's kernels take any batch, so no query row is padded)
    and builds the device ``DocSet`` from the arrays itself; this module
    stays numpy-only for the ingest workers.
    """
    ids = np.zeros((max_batch, h_max), np.int32)
    w = np.zeros((max_batch, h_max), np.float32)
    for i, (qi, qw) in enumerate(qs):
        n = min(len(qi), h_max)
        ids[i, :n] = qi[:n]
        w[i, :n] = qw[:n]
    w = np.where(ids >= 0, w, np.float32(0))   # id < 0 = padding convention
    norm = w.sum(axis=-1, keepdims=True)
    need = (norm > 0) & (np.abs(norm - np.float32(1)) > np.float32(1e-5))
    w = np.where(need, w / np.where(norm > 0, norm, np.float32(1)), w)
    ids = np.where(w > 0, np.maximum(ids, 0), 0)
    return ids.astype(np.int32), w.astype(np.float32)


__all__ = ["EMPTY", "ERROR", "ERR_BYTES", "OK", "StagingClosed",
           "StagingRing", "pad_batch"]
