"""Multi-process ingest pool: the host plane behind ``AsyncQueryServer``
(the port's copy of ``repro.serving.ingest_pool``).

The async server goes HOST-bound once per-batch vectorization (tokenize +
vocab lookup + histogram build) exceeds device-batch time, when the whole
ingest path runs on one GIL-bound worker thread.  This module scales it
out:

* ``ServerConfig(ingest_workers=N)`` spawns N :class:`IngestPool` worker
  PROCESSES (spawn context — the preprocess hook and any per-corpus
  vectorizers must be picklable; closures are not).
* Raw payloads go OUT over one small ``mp.Queue`` per worker (ticket
  ``t`` → worker ``t % N``, so fault attribution is deterministic);
  vectorized ``(ids, weights)`` histograms come BACK through the
  :class:`~repro_torch.serving.staging.StagingRing` — fixed-shape shared-memory
  slots the dispatcher reads as ``np.frombuffer`` views.  No query tensor
  is ever pickled: :meth:`IngestPool.submit` structurally REFUSES ndarray
  payloads, which is the zero-copy guarantee the tests pin down.
* Supervision folds into the serving plane's typed-error contract: a
  worker-process death fails ONLY the ticket it was vectorizing (recorded
  in the ring's claim word before any fault can fire) with
  :class:`~repro_torch.serving.errors.IngestCrashed` — queued tickets survive on
  the same queue, a replacement process is spawned (counted, capped at
  ``max_restarts``), and FIFO collection order is preserved because the
  consumer drains tickets strictly in order.

Import discipline: this module (and ``staging``/``errors``/``faults``) is
numpy-only at import time — spawned children re-import it without paying
the torch import (``repro_torch`` exports lazily), which is the difference
between a pool that amortizes and one that doesn't.
"""

from __future__ import annotations

import multiprocessing as mp
import os
import time

import numpy as np

from repro_torch.serving.errors import (
    IngestCrashed,
    PoisonQuery,
    QueryRejected,
    ServingError,
)
from repro_torch.serving.staging import StagingClosed, StagingRing

#: Exit code ingest-crash fault injection uses (``os._exit`` — no cleanup,
#: no atexit, exactly like a segfaulting vectorizer extension).
CRASH_EXIT_CODE = 17

#: Error types a worker may report that the parent reconstructs by name;
#: anything else is wrapped as PoisonQuery("preprocess failed: ...") to
#: match the in-thread prep contract.
_TYPED_ERRORS = {
    "PoisonQuery": PoisonQuery,
    "QueryRejected": QueryRejected,
    "ServingError": ServingError,
}


def _worker_main(widx: int, ring_spec: tuple, queue, default_vec,
                 vectorizers: dict, plan) -> None:
    """Ingest worker entry point (runs in a spawned child process).

    Protocol on ``queue``: ``("task", ticket, payload, corpus_id)`` |
    ``("vec", corpus_id, fn)`` | ``("stop",)``.  Results go to the ring;
    the claim word brackets each task so the parent can attribute a crash
    to its exact ticket.
    """
    ring = StagingRing.attach(ring_spec)
    vectorizers = dict(vectorizers)
    try:
        while True:
            msg = queue.get()
            kind = msg[0]
            if kind == "stop":
                return
            if kind == "vec":
                vectorizers[msg[1]] = msg[2]
                continue
            _, ticket, payload, cid = msg
            ring.claim(widx, ticket)
            try:
                if plan is not None and ticket in plan.ingest_crash:
                    # Injected process death: os._exit skips ALL cleanup
                    # (the claim word survives — that's the forensic record
                    # the parent reads), exactly like a native crash.
                    os._exit(CRASH_EXIT_CODE)
                if plan is not None and ticket in plan.preprocess_errors:
                    raise RuntimeError(
                        f"injected preprocess failure for query #{ticket}")
                vec = vectorizers.get(cid, default_vec)
                if vec is None:
                    raise RuntimeError(f"no vectorizer for corpus {cid!r}")
                ids, w = vec(payload)
                ring.write(ticket, ids, w)
            except StagingClosed:
                return
            except BaseException as e:  # noqa: BLE001 — ships to the parent
                try:
                    ring.write_error(ticket, f"{type(e).__name__}: {e}")
                except StagingClosed:
                    return
            finally:
                ring.clear_claim(widx)
    finally:
        ring.close()


class IngestPool:
    """N spawn-context vectorizer processes + one staging ring.

    Single-consumer contract: ``collect``/``skip``/``close`` are called
    from ONE thread (the server's pipeline worker) — the ring's read
    cursor and the restart bookkeeping rely on it.  ``submit`` may be
    called from producer threads but must be externally ordered (the
    async server assigns tickets under its queue lock, so queue order
    equals ticket order equals collection order).
    """

    def __init__(self, n_workers: int, h_max: int, *, slots: int,
                 default_preprocess=None, vectorizers: dict | None = None,
                 faults_plan=None, max_restarts: int = 3,
                 timeout_s: float = 30.0, obs=None):
        if n_workers < 1:
            raise ValueError("IngestPool needs n_workers >= 1")
        self.n_workers = int(n_workers)
        self.timeout_s = float(timeout_s)
        self.max_restarts = int(max_restarts)
        self._plan = faults_plan
        self._default_vec = default_preprocess
        self._vectorizers = dict(vectorizers or {})
        self._ctx = mp.get_context("spawn")
        self.ring = StagingRing.create(slots, h_max, max_writers=n_workers)
        self._queues = [self._ctx.Queue() for _ in range(n_workers)]
        self._workers: list = [None] * n_workers
        for w in range(n_workers):
            self._spawn(w)
        self._next_ticket = 0       # producer side (externally ordered)
        self._next_collect = 0      # consumer side (strictly in order)
        self._skipped: set[int] = set()
        self._failed: dict[int, BaseException] = {}
        self._restarts = 0
        self._dead: BaseException | None = None
        self._closed = False
        self._m = None
        if obs is not None and obs.metrics.enabled:
            m = obs.metrics
            self._m = dict(
                tasks=m.counter("ingest_pool_tasks_total",
                                "payloads handed to the ingest pool"),
                errors=m.counter("ingest_pool_errors_total",
                                 "pooled preprocess failures (typed)"),
                crashes=m.counter("ingest_pool_crashes_total",
                                  "ingest worker process deaths"),
                restarts=m.counter("ingest_pool_restarts_total",
                                   "replacement ingest workers spawned"),
                wait=m.histogram("ingest_pool_wait_seconds",
                                 "dispatcher wait per collected ticket"),
                occupancy=m.gauge("staging_ring_occupancy",
                                  "written-but-unconsumed staging slots"),
            )
        self._obs = obs

    def _spawn(self, widx: int) -> None:
        p = self._ctx.Process(
            target=_worker_main,
            args=(widx, self.ring.spec, self._queues[widx],
                  self._default_vec, self._vectorizers, self._plan),
            name=f"lcrwmd-ingest-{widx}", daemon=True)
        p.start()
        self._workers[widx] = p

    # -- producer side -----------------------------------------------------
    def submit(self, payload, corpus_id: str) -> int:
        """Queue one RAW payload for vectorization; returns its ticket.

        Structurally enforces the zero-copy contract: already-vectorized
        arrays must NOT ride the pickled task channel — they belong on the
        direct ``(ids, weights)`` submit path, or in the ring.
        """
        if isinstance(payload, np.ndarray) or (
                isinstance(payload, (tuple, list))
                and any(isinstance(x, np.ndarray) for x in payload)):
            raise TypeError(
                "IngestPool.submit carries raw payloads only; ndarray "
                "query tensors never cross the pickled task channel "
                "(zero-copy staging contract)")
        if self._dead is not None:
            raise self._dead
        t = self._next_ticket
        self._next_ticket = t + 1
        self._queues[t % self.n_workers].put(("task", t, payload, corpus_id))
        if self._m is not None:
            self._m["tasks"].inc()
        return t

    def add_vectorizer(self, corpus_id: str, fn) -> None:
        """Install a per-corpus vectorizer on every worker (picklable)."""
        self._vectorizers[corpus_id] = fn
        for q in self._queues:
            q.put(("vec", corpus_id, fn))

    # -- consumer side (single thread) -------------------------------------
    def _on_worker_death(self, widx: int) -> None:
        proc = self._workers[widx]
        proc.join()
        victim = self.ring.claimed(widx)
        if (victim >= self._next_collect and victim >= 0
                and self.ring.poll(victim) is None):
            err = IngestCrashed(
                f"ingest worker {widx} (pid {proc.pid}) died with exit code "
                f"{proc.exitcode} while vectorizing ticket #{victim}")
            self._failed[victim] = err
        self.ring.clear_claim(widx)
        self._restarts += 1
        if self._m is not None:
            self._m["crashes"].inc()
        if self._obs is not None:
            from repro_torch.obs import IngestCrash
            self._obs.events.append(IngestCrash(
                worker=widx, ticket=int(victim),
                exit_code=int(proc.exitcode or 0),
                restarts=self._restarts))
        if self._restarts > self.max_restarts:
            self._dead = IngestCrashed(
                f"ingest pool gave up after {self._restarts} worker "
                f"crashes (> max_restarts={self.max_restarts})")
            return
        # Replacement worker on the SAME queue: tickets still queued to
        # the dead worker are processed by its successor, so a crash costs
        # exactly the one claimed ticket.
        self._spawn(widx)
        if self._m is not None:
            self._m["restarts"].inc()

    def _await(self, ticket: int):
        """Block for one ticket: ("ok", ids, w, n) | ("error", msg) |
        ("crashed", exc).  The data views are only valid until consume."""
        deadline = time.monotonic() + self.timeout_s
        delay = 20e-6
        while True:
            if ticket in self._failed:
                return ("crashed", self._failed.pop(ticket))
            res = self.ring.poll(ticket)
            if res is not None:
                return res
            if self._dead is not None:
                return ("crashed", self._dead)
            proc = self._workers[ticket % self.n_workers]
            if proc is not None and not proc.is_alive():
                self._on_worker_death(ticket % self.n_workers)
                continue  # _failed may now hold this ticket — or the
                #           replacement will serve it from the queue
            if time.monotonic() > deadline:
                # Safety net for the un-attributable window (a worker dying
                # between queue.get and claim leaves no forensic record).
                return ("crashed", IngestCrashed(
                    f"ticket #{ticket} never reached the staging ring "
                    f"within {self.timeout_s}s"))
            time.sleep(delay)
            delay = min(delay * 2, 500e-6)

    def collect(self, ticket: int) -> tuple[np.ndarray, np.ndarray]:
        """Deliver one vectorized histogram, strictly in ticket order.

        Intermediate skipped tickets are drained (their slots freed) on
        the way.  Returns OWNED copies (a few hundred bytes — the slot is
        reused the moment the cursor passes, and validation retries may
        outlive it); raises the ticket's typed error on failure.
        """
        if ticket < self._next_collect:
            raise RuntimeError(
                f"ticket #{ticket} already collected (cursor at "
                f"{self._next_collect}) — single-consumer FIFO violated")
        t0 = time.perf_counter()
        out = None
        while self._next_collect <= ticket:
            t = self._next_collect
            res = self._await(t)
            if t == ticket:
                out = (res[0], None if res[0] != "ok" else
                       (np.array(res[1]), np.array(res[2])), res)
            self._next_collect = t + 1
            self._skipped.discard(t)
            self.ring.consume(t + 1)
        if self._m is not None:
            self._m["wait"].observe(time.perf_counter() - t0)
            self._m["occupancy"].set(self.ring.occupancy())
        kind, data, res = out
        if kind == "ok":
            return data
        if kind == "crashed":
            raise res[1]
        raise self._rebuild_error(res[1])

    @staticmethod
    def _rebuild_error(message: str) -> ServingError:
        type_name, _, msg = message.partition(": ")
        cls = _TYPED_ERRORS.get(type_name)
        if cls is not None:
            return cls(msg or message)
        return PoisonQuery(f"preprocess failed: {msg or message}")

    def skip(self, ticket: int) -> None:
        """Mark a ticket as never-to-be-collected (deadline sweep, failed
        dispatch).  Non-blocking: consecutive already-written skipped
        tickets at the cursor are drained immediately so their slots free
        up without waiting for the next collect."""
        self._skipped.add(ticket)
        while self._next_collect in self._skipped:
            t = self._next_collect
            if t in self._failed:
                self._failed.pop(t)
            elif self.ring.poll(t) is None:
                widx = t % self.n_workers
                proc = self._workers[widx]
                if proc is None or proc.is_alive() or self._dead is not None:
                    break  # still being written — next collect drains it
                self._on_worker_death(widx)
                continue
            self._skipped.discard(t)
            self._next_collect = t + 1
            self.ring.consume(t + 1)

    # -- health ------------------------------------------------------------
    def snapshot(self) -> dict:
        """Ingest-pool section of ``health()``: liveness + flow state."""
        return {
            "workers": self.n_workers,
            "alive": sum(1 for p in self._workers
                         if p is not None and p.is_alive()),
            "restarts": self._restarts,
            "dead": self._dead is not None,
            "submitted": self._next_ticket,
            "collected": self._next_collect,
            "ring_occupancy": self.ring.occupancy(),
            "ring_slots": self.ring.nslots,
        }

    # -- lifecycle ---------------------------------------------------------
    def close(self, timeout: float = 5.0) -> None:
        if self._closed:
            return
        self._closed = True
        self.ring.close_ring()   # unblocks writers stuck on a full ring
        for q in self._queues:
            try:
                q.put(("stop",))
            except (ValueError, OSError):
                pass
        for p in self._workers:
            if p is not None:
                p.join(timeout)
                if p.is_alive():
                    p.terminate()
                    p.join(1.0)
        for q in self._queues:
            q.close()
            q.cancel_join_thread()
        self.ring.close()


__all__ = ["CRASH_EXIT_CODE", "IngestPool"]
