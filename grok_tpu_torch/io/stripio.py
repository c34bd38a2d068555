"""Asynchronous strip-streamed image output.

Parity: the reference's FileUringIO async strip writes (SURVEY.md §2.2
"Image formats": io_uring strip writes on Linux) + StripCache streaming
(§2.3): the decoder produces strips while a background writer thread
serializes and writes the previous strips, so file I/O and pixel
serialization overlap decode instead of following it.

Supports binary PNM (P5 gray / P6 RGB, 8- and 16-bit big-endian) — the
formats whose layout permits append-only row streaming.  Everything else
goes through the whole-image writers in io/formats.py.
"""

from __future__ import annotations

import queue
import threading

import numpy as np


class AsyncStripWriter:
    """Writes (y0, {compno: rows}) strips to a PNM file through a bounded
    queue + writer thread (double-buffer overlap)."""

    def __init__(self, path: str, width: int, height: int, ncomp: int,
                 prec: int, queue_depth: int = 2) -> None:
        if ncomp not in (1, 3):
            raise ValueError("PNM streaming supports 1 or 3 components")
        if prec > 16:
            raise ValueError("PNM supports at most 16-bit samples")
        self.width = width
        self.height = height
        self.ncomp = ncomp
        self.prec = prec
        self._rows_written = 0
        self._q: queue.Queue = queue.Queue(maxsize=queue_depth)
        self._err: list[BaseException] = []
        self._f = open(path, "wb")
        magic = b"P5" if ncomp == 1 else b"P6"
        maxval = (1 << prec) - 1
        self._f.write(magic + b"\n%d %d\n%d\n" % (width, height, maxval))
        self._thread = threading.Thread(target=self._writer, daemon=True)
        self._thread.start()

    # ------------------------------------------------------------ producer

    def _put(self, item) -> None:
        # bounded put that stays responsive to a dead writer: a writer
        # that errored drains the queue, but guard with a timeout loop so
        # an I/O failure can never deadlock the producer
        while True:
            if self._err:
                raise self._err[0]
            try:
                self._q.put(item, timeout=0.1)
                return
            except queue.Full:
                continue

    def write_strip(self, comps: dict[int, np.ndarray]) -> None:
        """Enqueue one strip ({compno: (rows, width) int arrays}); blocks
        when the writer is more than queue_depth strips behind."""
        self._put(comps)

    def close(self) -> None:
        try:
            self._put(None)
        finally:
            # always reap the thread and release the handle, even when
            # _put re-raised a writer error: a leaked open handle with a
            # buffered tail could flush into a later rewrite of the
            # same path (an errored writer drains the queue and exits,
            # so the join cannot hang)
            self._thread.join()
            self._f.close()
        if self._err:
            raise self._err[0]
        if self._rows_written != self.height:
            raise IOError(
                f"strip stream ended at row {self._rows_written}, "
                f"expected {self.height}")

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        if exc_type is None:
            self.close()
        else:  # error upstream: stop the writer, leave the partial file
            while self._thread.is_alive():
                try:
                    self._q.put(None, timeout=0.1)
                    break
                except queue.Full:
                    continue  # writer still draining; retry
            self._thread.join()
            self._f.close()
        return False

    # ------------------------------------------------------------- writer

    def _writer(self) -> None:
        try:
            dtype = np.dtype(">u2") if self.prec > 8 else np.dtype("u1")
            while True:
                item = self._q.get()
                if item is None:
                    return
                planes = [np.asarray(item[c]) for c in range(self.ncomp)]
                if any(p.shape[1] != self.width for p in planes):
                    raise IOError(
                        f"strip width {planes[0].shape[1]} != PNM header "
                        f"width {self.width}")
                if self.ncomp == 1:
                    block = planes[0].astype(dtype)
                else:
                    block = np.stack(planes, axis=-1).astype(dtype)
                self._rows_written += planes[0].shape[0]
                self._f.write(block.tobytes())
        except BaseException as e:
            self._err.append(e)
            # drain so a blocked producer wakes up and sees the error
            while True:
                try:
                    if self._q.get_nowait() is None:
                        return
                except queue.Empty:
                    return
