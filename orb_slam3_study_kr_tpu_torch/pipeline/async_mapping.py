"""Background mapping/loop worker (the reference's LocalMapping and
LoopClosing threads).

Counterpart of ``orb_slam3_study_kr_tpu/pipeline/async_mapping.py``: one
worker thread drains a queue of keyframe tasks in order (mapping, then the
loop cascade), so the frame path never waits for triangulation, local BA or
loop work.  The tracker blocks only when ``max_pending`` tasks are queued.

Consistency: every host section that reads or mutates the shared map, in
either thread, runs under the map's re-entrant ``map.lock``.  Effects on
tracker state (the velocity reset after a loop correction) are posted as
events and applied by the tracker thread at the next frame boundary
(``SlamSystem._drain_async_events``).

On CUDA the worker runs every task under a stream of its own, on the
session's device; the kernel wrappers launch on the current stream, so the
mapper's K2 and the loop closer's K3 launches follow it.  The worker
synchronises that stream before a task ends, so everything a task leaves
behind on the device is complete before the tracker can see the task as
done (and code that publishes a device tensor earlier, such as a freshly
trained vocabulary, synchronises it first).
"""

import contextlib
import logging
import queue
import threading

import torch

from orb_slam3_study_kr_tpu_torch.utils import resolve_device

log = logging.getLogger(__name__)


class AsyncMapping:
    """Single worker thread processing keyframe tasks in order, on
    ``device`` ("cuda" by default; raises without a card)."""

    def __init__(self, max_pending: int = 3, device="cuda"):
        self.device = resolve_device(device, "AsyncMapping(device)")
        # The worker's own stream; entering it also selects its card.
        self._stream = (torch.cuda.Stream(device=self.device)
                        if self.device.type == "cuda" else None)
        self.max_pending = max_pending
        self._q = queue.Queue()
        self._events = []                  # ("loop", payload)
        self._events_lock = threading.Lock()
        self._idle = threading.Event()
        self._idle.set()
        self._pending = 0
        self._pending_cv = threading.Condition()
        self._errors = []                  # every worker exception, in order
        self._errors_lock = threading.Lock()
        self.stats = {"n_processed": 0, "n_waits": 0, "n_errors": 0}
        self._thread = threading.Thread(target=self._run, name="slam-mapping",
                                        daemon=True)
        self._thread.start()

    # -- tracker side --------------------------------------------------
    def submit(self, fn):
        """Queue one keyframe task (a zero-argument callable); blocks while
        ``max_pending`` tasks are already queued."""
        with self._pending_cv:
            while self._pending >= self.max_pending:
                self.stats["n_waits"] += 1
                self._pending_cv.wait(timeout=30.0)
            self._pending += 1
            self._idle.clear()
        self._q.put(fn)

    @property
    def busy(self) -> bool:
        """The worker has queued or running tasks (LocalMapping not idle)."""
        return not self._idle.is_set()

    def post_event(self, kind, payload=None):
        with self._events_lock:
            self._events.append((kind, payload))

    def drain_events(self):
        with self._events_lock:
            ev, self._events = self._events, []
        return ev

    def pop_errors(self):
        """Worker exceptions since the last call (each already logged)."""
        with self._errors_lock:
            errs, self._errors = self._errors, []
        return errs

    def flush(self, timeout: float = 300.0):
        """Block until every queued task has completed; re-raise the first
        worker exception."""
        if not self._idle.wait(timeout=timeout):
            raise TimeoutError("async mapping worker did not drain")
        errs = self.pop_errors()
        if errs:
            raise errs[0]

    def shutdown(self):
        self._q.put(None)
        self._thread.join(timeout=30.0)
        if self._thread.is_alive():
            raise TimeoutError("async mapping worker did not stop")

    # -- worker side ---------------------------------------------------
    def _run(self):
        stream = self._stream
        while True:
            fn = self._q.get()
            if fn is None:
                break
            try:
                with (torch.cuda.stream(stream) if stream is not None
                      else contextlib.nullcontext()):
                    fn()
                    if stream is not None:
                        stream.synchronize()
            except Exception as e:     # noqa: BLE001 — surfaced at the next
                # frame boundary (pop_errors) or at flush()
                log.exception("async mapping task failed")
                with self._errors_lock:
                    self._errors.append(e)
                self.stats["n_errors"] += 1
            finally:
                self.stats["n_processed"] += 1
                with self._pending_cv:
                    self._pending -= 1
                    self._pending_cv.notify_all()
                    if self._pending == 0:
                        self._idle.set()
