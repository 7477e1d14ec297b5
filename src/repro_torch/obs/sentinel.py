"""Cold-start sentinel for the port's kernel libraries (the counterpart of
``repro.obs.sentinel``).

The reference meters jit trace caches: a re-trace on the serve path costs
~100 ms of host time and used to go unseen.  The eager port traces
nothing; its cold-start cost is a kernel library that ``nvcc`` builds, or
``ctypes`` loads, at the first launch of one of its kernels
(:func:`repro_torch.kernels._build.lib`).  Every such load is reported
here (:func:`note_load`), and callables wrapped with :func:`wrap` meter the
loads that happen inside them under their own key.

Two regimes, as in the reference:

* **Unarmed** (default, warm-up): a first load is legitimate (a new tier
  or path reaches a kernel for the first time).  Only a second load of the
  same library under the same key would be unexpected.
* **Armed** (:func:`arm`, after warm-up): ANY load is unexpected unless
  inside an :func:`expect` scope.  Tests warm a server, arm the sentinel,
  then assert the steady state loads nothing (a budget rebuild builds a
  new serve step inside ``expect("adaptive budget rebuild")``, which is
  fine).

``strict=True`` (or env ``LCRWMD_SENTINEL_STRICT=1``, read at import)
raises :class:`RetraceError` at the violating load; otherwise violations
accumulate in ``unexpected`` for :func:`check` / :func:`snapshot`.

The sentinel is a process-wide singleton because the library table it
watches is process-wide too.  Disabled cost: one attribute check per call.
"""

from __future__ import annotations

import contextlib
import os
import threading
from typing import Any, Callable, Iterator


class RetraceError(RuntimeError):
    """An unexpected kernel-library load was detected in strict mode (the
    name is the reference's: the port's cold start is a load, not a
    trace)."""


def _signature(args: tuple, kwargs: dict) -> tuple:
    """Hashable abstract signature of a call: (shape, dtype) for tensor and
    array arguments, (type, short repr) for everything else (one level of
    tuples and lists unpacked)."""
    leaves: list = []
    for x in list(args) + [kwargs[k] for k in sorted(kwargs)]:
        if isinstance(x, (tuple, list)):
            leaves.extend(x)
        else:
            leaves.append(x)
    sig = []
    for leaf in leaves:
        shape = getattr(leaf, "shape", None)
        dtype = getattr(leaf, "dtype", None)
        if shape is not None and dtype is not None:
            sig.append((tuple(shape), str(dtype)))
        else:
            sig.append((type(leaf).__name__, repr(leaf)[:64]))
    return tuple(sig)


class _Sentinel:
    def __init__(self):
        self._lock = threading.Lock()
        self.enabled = True
        self.strict = os.environ.get("LCRWMD_SENTINEL_STRICT", "") not in (
            "", "0", "false")
        self.armed = False
        #: key -> library loads observed under it
        self.counts: dict[str, int] = {}
        #: key -> set of signatures that have already loaded a library
        self.seen: dict[str, set] = {}
        #: libraries compiled by nvcc in this process (a subset of loads)
        self.builds = 0
        #: accumulated violations (dicts; see _flag)
        self.unexpected: list[dict] = []
        self._local = threading.local()

    # -- expectation scopes ------------------------------------------------
    @contextlib.contextmanager
    def expect(self, reason: str = "") -> Iterator[None]:
        """Mark a region where loads are legitimate even when armed."""
        depth = getattr(self._local, "depth", 0)
        self._local.depth = depth + 1
        try:
            yield
        finally:
            self._local.depth = depth

    def _expected(self) -> bool:
        return getattr(self._local, "depth", 0) > 0

    # -- lifecycle ---------------------------------------------------------
    def arm(self) -> None:
        """From now on any library load is a violation (outside ``expect``)."""
        with self._lock:
            self.armed = True

    def disarm(self) -> None:
        with self._lock:
            self.armed = False

    def reset(self) -> None:
        """Forget all observations (counts, signatures, violations) and
        disarm.  Tests call this to isolate from prior process state."""
        with self._lock:
            self.armed = False
            self.counts.clear()
            self.seen.clear()
            self.builds = 0
            self.unexpected.clear()

    # -- classification ----------------------------------------------------
    def _flag(self, key: str, kind: str, sig: tuple) -> None:
        record = {"key": key, "kind": kind,
                  "signature": repr(sig)[:256],
                  "armed": self.armed,
                  "count": self.counts.get(key, 0)}
        with self._lock:
            self.unexpected.append(record)
        if self.strict:
            raise RetraceError(
                f"unexpected kernel-library load: key={key!r} kind={kind} "
                f"(load #{record['count']} for this key). "
                f"Signature: {record['signature']}")

    def record(self, key: str, grew_by: int, sig: tuple) -> None:
        """Classify ``grew_by`` loads observed under ``key``."""
        with self._lock:
            self.counts[key] = self.counts.get(key, 0) + grew_by
            seen = self.seen.setdefault(key, set())
            was_seen = sig in seen
            seen.add(sig)
            armed = self.armed
        if armed and not self._expected():
            self._flag(key, "load-while-armed", sig)
        elif was_seen:
            self._flag(key, "reload-of-seen-signature", sig)

    def note_seen(self, key: str, sig: tuple) -> None:
        """Record a signature that ran without a load."""
        with self._lock:
            self.seen.setdefault(key, set()).add(sig)

    def note_load(self, library: str, built: bool) -> None:
        """One kernel library loaded (``built``: nvcc compiled it first)."""
        if not self.enabled:
            return
        with self._lock:
            self.builds += int(built)
        self.record(f"kernel_library.{library}", 1, (library,))

    def loads(self) -> int:
        """Library loads observed so far (all keys)."""
        with self._lock:
            return sum(n for k, n in self.counts.items()
                       if k.startswith("kernel_library."))

    # -- export ------------------------------------------------------------
    def check(self) -> None:
        """Raise if any violations accumulated."""
        with self._lock:
            bad = list(self.unexpected)
        if bad:
            raise RetraceError(
                f"{len(bad)} unexpected kernel-library load(s): "
                + "; ".join(f"{b['key']}[{b['kind']}]" for b in bad[:8]))

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "enabled": self.enabled,
                "strict": self.strict,
                "armed": self.armed,
                "loads": dict(self.counts),
                "builds": self.builds,
                "signatures": {k: len(v) for k, v in self.seen.items()},
                "unexpected": [dict(u) for u in self.unexpected],
            }


#: Process-wide singleton — mirrors the process-wide library table.
_SENTINEL = _Sentinel()


def get_sentinel() -> _Sentinel:
    return _SENTINEL


def arm() -> None:
    _SENTINEL.arm()


def disarm() -> None:
    _SENTINEL.disarm()


def reset() -> None:
    _SENTINEL.reset()


def check() -> None:
    _SENTINEL.check()


def expect(reason: str = ""):
    return _SENTINEL.expect(reason)


def snapshot() -> dict:
    return _SENTINEL.snapshot()


def note_load(library: str, built: bool = False) -> None:
    _SENTINEL.note_load(library, built)


class _Watched:
    """Callable proxy that meters the library loads made inside each call
    under its key.  Attribute access falls through to the wrapped
    callable."""

    __slots__ = ("_fn", "_key")

    def __init__(self, fn: Callable, key: str):
        self._fn = fn
        self._key = key

    def __call__(self, *args, **kwargs) -> Any:
        s = _SENTINEL
        if not s.enabled:
            return self._fn(*args, **kwargs)
        before = s.loads()
        out = self._fn(*args, **kwargs)
        grew = s.loads() - before
        sig = _signature(args, kwargs)
        if grew > 0:
            with s._lock:
                s.counts[self._key] = s.counts.get(self._key, 0) + grew
                s.seen.setdefault(self._key, set()).add(sig)
        else:
            s.note_seen(self._key, sig)
        return out

    def __getattr__(self, name: str) -> Any:
        return getattr(self._fn, name)

    @property
    def __wrapped__(self) -> Callable:
        return self._fn


def wrap(key: str, fn: Callable) -> Callable:
    """Wrap a callable so every call meters the library loads inside it
    under ``key``.  Idempotent: wrapping a ``_Watched`` returns it."""
    if isinstance(fn, _Watched):
        return fn
    return _Watched(fn, key)


__all__ = ["RetraceError", "arm", "check", "disarm", "expect",
           "get_sentinel", "note_load", "reset", "snapshot", "wrap"]
