"""One-in-flight background execution for checkpoint writes (a copy of
text_to_video_finetuning_tpu/utils/background.py).

The reference's `save_pipe` (reference train.py:395-449) runs inline and
stalls the train loop for the full state_dict serialization.  Here the
periodic diffusers-layout save runs on a background thread: the engine
snapshots the trainable tensors first (a copy on the host, taken between
steps), so the thread only does file IO while training continues.

At most one task is in flight: `submit()` joins the previous task first, so
a slow disk degrades to the old synchronous behavior instead of queueing
unbounded host copies.  Exceptions raised in the thread re-raise at the
next `submit()`/`join()`: fail-fast, no swallow-and-continue.
"""

from __future__ import annotations

import threading


class OneInFlight:
    """Run at most one background task at a time; join re-raises errors."""

    def __init__(self, name: str = "t2v-background-save"):
        self._name = name
        self._thread = None
        self._exc = None

    def submit(self, fn, *args, context: str = None, **kwargs):
        """`context` labels the task (e.g. "checkpoint-500 pipeline save"):
        because a failure only re-raises at the NEXT submit()/join() -- up to
        one checkpoint interval later -- the note pins the traceback to the
        step whose write actually failed."""
        self.join()

        def _run():
            try:
                fn(*args, **kwargs)
            except BaseException as e:  # re-raised on the caller thread
                # capture FIRST: labeling must never lose the failure
                self._exc = e
                if context and hasattr(e, "add_note"):  # 3.11+; 3.10 skips
                    e.add_note(f"(background task: {context})")

        self._thread = threading.Thread(target=_run, name=self._name)
        self._thread.start()

    def join(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
            if self._exc is not None:
                exc, self._exc = self._exc, None
                raise exc
