"""Typed error hierarchy for the serving plane (the port's copy of
``repro.serving.errors``).

Every way a submitted query can fail maps to exactly one exception type, so
callers can route on ``except`` clauses instead of string-matching, and so
the serving contract — *every* :class:`~repro_torch.serving.ServeFuture` resolves
with either an answer or one of these — is checkable by type.

The hierarchy::

    ServingError                     every serve-plane failure
    ├── QueryRejected                admission control said no at submit()
    │   └── PoisonQuery              the query itself is malformed (zero
    │                                in-vocab words, all-zero/non-finite
    │                                weights, non-finite device result
    │                                isolated to this query by bisection)
    ├── DeadlineExceeded             (also a TimeoutError) the per-request
    │                                deadline passed before delivery
    ├── ServerClosed                 (also a RuntimeError) the server shut
    │                                down before this query was answered
    ├── MeshDivergence               the ranks of a mesh vectorized this
    │                                query's batch differently; no rank
    │                                served it
    └── WorkerCrashed                the serve worker died mid-batch; the
        │                            supervisor failed this future and
        │                            restarted the worker
        └── IngestCrashed            an ingest-pool worker PROCESS died
                                     while vectorizing this query; only
                                     this query fails, a replacement
                                     process takes over the queue

This module is intentionally dependency-free: lower layers (e.g.
``repro_torch.data.vectorizer``) may raise :class:`PoisonQuery` without importing
any serving machinery.
"""

from __future__ import annotations


class ServingError(Exception):
    """Base class for every typed serving-plane failure."""


class QueryRejected(ServingError):
    """Admission control rejected the query at submit time.

    Raised synchronously by ``submit()`` — the query never entered the
    pipeline — e.g. because its deadline already expired, or the pending
    queue could not accept it before the deadline.
    """


class PoisonQuery(QueryRejected):
    """The query itself is malformed and can never be served.

    Raised at submit time when detectable on the host (zero in-vocabulary
    words, all-zero or non-finite weight vector), or delivered through the
    future when the query is isolated by the batch-validation bisection
    (its device result was non-finite while its batch-mates' were not).
    """


class DeadlineExceeded(ServingError, TimeoutError):
    """The query's deadline passed before its answer could be delivered.

    Subclasses :class:`TimeoutError` so generic timeout handling catches it.
    """


class ServerClosed(ServingError, RuntimeError):
    """The server was closed before (or while) this query was served.

    Subclasses :class:`RuntimeError` for drop-in compatibility with the
    pre-typed ``submit() on a closed server`` behavior.
    """


class MeshDivergence(ServingError):
    """The ranks of a mesh prepared different batches from the entries rank
    0 named (a digest of the padded ids and weights differed from rank
    0's), so the batch failed on every rank before any rank served it.

    Port-only: the reference drives every device from one controller.
    """


class WorkerCrashed(ServingError):
    """The serve worker thread died while this query was in flight.

    The supervisor fails affected futures with this error, restarts the
    worker, and preserves submission order for still-queued requests.
    """


class IngestCrashed(WorkerCrashed):
    """An ingest-pool worker process died while vectorizing this query.

    Subclasses :class:`WorkerCrashed` so callers handling crash-class
    failures need no new clause.  The blast radius is ONE query: the
    crash is attributed through the staging ring's claim word, queued
    tickets survive on the dead worker's queue, and a replacement process
    resumes them in FIFO order.
    """
