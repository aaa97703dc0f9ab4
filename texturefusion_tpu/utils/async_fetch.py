"""Background device→host fetch helper.

Host decisions read small device results (per-frame stats, mesh counts,
discovery ids). A blocking `device_get` waits for the producing program
plus the readback, while `copy_to_host_async` starts the copy early so
that a later `device_get` of the same array returns at once.

`fetch_async` therefore just starts the async copies and hands back a
lightweight handle; `result()`/`resolve()` return the host copy — free
when it has landed, and blocking exactly as long as the producing
program plus the readback when it has not. Every fetch gets its own
waiter thread: an earlier shared executor made one slow fetch
head-of-line block every queued consumer.

(The reference reads everything from CPU RAM for free — Threading.h
parallel_for world; this helper makes the same host-side orchestration
tolerant of device readback latency, which on the card is still to be
measured.)
"""

from __future__ import annotations

import threading
from typing import Any

import jax


class DeviceFetch:
    """Handle for an in-flight device→host copy of a pytree.

    background=True (the DEFAULT): a waiter thread device_gets the
    tree, so done() means the bytes LANDED. `is_ready()` alone only
    means computed, and every done()-gated consumer (ready-only flushes,
    pipeline riding, grace windows) needs the host copy itself.

    defer=True queues the fetch in the module-level TRANSFER WINDOW
    instead of starting it: flush_fetches() launches every queued copy
    in one combined get, so co-issued transfers share one readback
    instead of one per call site. result() on an unflushed handle
    self-flushes, so correctness never depends on the flush cadence."""

    __slots__ = ("tree", "_event", "_result", "_launched", "t_created",
                 "t_started", "t_landed")

    def __init__(self, tree: Any, background: bool = True,
                 defer: bool = False):
        self.tree = tree
        self._event = threading.Event() if (background or defer) else None
        self._result = None
        self._launched = False
        import time as _time
        self.t_created = _time.perf_counter()
        self.t_started = None
        self.t_landed = None
        if defer:
            with _WINDOW_LOCK:
                _WINDOW.append(self)
            return
        self._launch(background)

    def _launch(self, background: bool = True) -> None:
        if self._launched:
            return
        self._launched = True
        try:
            for leaf in jax.tree.leaves(self.tree):
                copy = getattr(leaf, "copy_to_host_async", None)
                if copy is not None:
                    copy()
        except Exception:
            pass  # backends without async copies fall back to plain get
        if self._event is not None:
            # a waiter thread device_gets into the handle, so done()
            # means LANDED (is_ready only means computed — the host copy
            # of a large payload arrives one transfer later, and a
            # consumer polling is_ready could still stall on resolve).
            # One short-lived thread per fetch: no shared queue, so a
            # slow fetch can never head-of-line block another.
            t = threading.Thread(target=self._bg_fetch, daemon=True)
            t.start()

    def _bg_fetch(self) -> None:
        import time as _time
        self.t_started = _time.perf_counter()
        try:
            self._result = jax.device_get(self.tree)
        finally:
            self.t_landed = _time.perf_counter()
            self._event.set()

    def result(self) -> Any:
        if self._event is not None:
            if not self._launched:
                # self-flush: launch the whole pending window so the
                # stall is still shared with any co-queued fetches
                flush_fetches()
            self._event.wait()
            return self._result
        return jax.device_get(self.tree)

    def done(self) -> bool:
        """True when the value is available cheaply: background fetches
        report the host copy LANDED; plain fetches report every leaf
        computed (the copy is then landed or one readback away).
        Consumers that can tolerate one more cycle of staleness use this
        to skip resolving fetches that would stall. Deferred fetches
        report not-done until flushed AND landed (the per-frame flush
        bounds the wait to one frame)."""
        if self._event is not None:
            return self._event.is_set()
        try:
            return all(leaf.is_ready() if hasattr(leaf, "is_ready") else True
                       for leaf in jax.tree.leaves(self.tree))
        except Exception:
            return True


_WINDOW: list = []
_WINDOW_LOCK = threading.Lock()


def flush_fetches() -> int:
    """Launch every deferred fetch as ONE combined device_get in ONE
    waiter thread, so N queued fetches cost one readback instead of N.
    Called once per frame from the tracking loop; any thread may call it (result() self-flushes). A handle is
    marked launched under the lock, so a concurrent result() between
    flush and thread start just waits on the event."""
    with _WINDOW_LOCK:
        batch, _WINDOW[:] = _WINDOW[:], []
        for f in batch:
            f._launched = True
    if not batch:
        return 0
    try:
        for f in batch:
            for leaf in jax.tree.leaves(f.tree):
                copy = getattr(leaf, "copy_to_host_async", None)
                if copy is not None:
                    copy()
    except Exception:
        pass

    def _get_all():
        import time as _time
        t0 = _time.perf_counter()
        try:
            results = jax.device_get([f.tree for f in batch])
        except Exception:
            results = None
        t1 = _time.perf_counter()
        for i, f in enumerate(batch):
            f.t_started = t0
            if results is not None:
                f._result = results[i]
            else:
                # combined get failed: fall back per-handle
                try:
                    f._result = jax.device_get(f.tree)
                except Exception:
                    f._result = None
            f.t_landed = t1
            f._event.set()

    threading.Thread(target=_get_all, daemon=True).start()
    return len(batch)


def fetch_async(tree: Any, background: bool = True,
                defer: bool = False) -> DeviceFetch:
    """Start (or, with defer=True, queue into the per-frame transfer
    window) the device→host copies for a pytree; returns a handle whose
    result() is the device_get'd host pytree (near-free once landed).
    A waiter thread makes done() mean LANDED (see DeviceFetch)."""
    return DeviceFetch(tree, background=background, defer=defer)


def resolve(maybe_future: Any) -> Any:
    """Fetch handle → result; anything else → device_get (sync fallback)."""
    if hasattr(maybe_future, "result"):
        return maybe_future.result()
    return jax.device_get(maybe_future)
