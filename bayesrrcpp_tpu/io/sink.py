"""Sample sinks: stream thinned posterior samples to disk.

Replacement for the reference's output path (components C6+C8 in
SURVEY.md): the reference runs a 2-thread OpenMP producer/consumer split over
a vendored lock-free queue and writes CSV rows from the consumer
(reference: src/BayesRv2.cpp:102-108, 281-290, src/concurrentqueue.h:683).
Here the device produces whole emission *chunks* asynchronously (XLA async
dispatch) and a single background writer thread drains a bounded queue --
same overlap, none of the unsynchronised-flag races, and no dropped tail
samples (the reference's consumer exits on a bare int flag and can lose
enqueued rows, src/BayesRv2.cpp:279-289).

``CSVSink`` reproduces the reference CSV schemas byte-compatibly enough for
downstream tooling (same header names/order, same ", " row separator from
Eigen's CommaInitFmt, src/BayesRv2.cpp:72), including the reference's header
quirks (trailing comma in the Horseshoe header, src/HorseshoeR.cpp:288-291,
and the groups header's epsilon/alpha comma layout,
src/BayesRv2Groups.cpp:43-53).  ``NpzSink`` is the columnar fast path.

If the native writer library (native/sampsink.cpp) has been built, CSV row
formatting is offloaded to it via ctypes; otherwise a NumPy fallback is used.
"""
from __future__ import annotations

import queue
import threading
from typing import Dict, List, Optional

import numpy as np

from .native import get_native_writer


def csv_header(schema: str, M: int, N: int, groups: int = 0, F: int = 0,
               emit_epsilon: bool = True) -> str:
    """Reference-exact CSV headers (see SURVEY.md section 3.5)."""
    parts: List[str] = ["iteration", "mu"]
    parts += [f"beta[{i+1}]" for i in range(M)]
    eps_cols = [f"epsilon[{i+1}]" for i in range(N)] if emit_epsilon else []
    if schema == "bayesr":
        # src/BayesRv2.cpp:16-37
        parts += ["sigmaE", "sigmaG"]
        parts += [f"comp[{i+1}]" for i in range(M)]
        parts += eps_cols
        return ",".join(parts) + "\n"
    if schema == "groups":
        # src/BayesRv2Groups.cpp:25-54 (note: epsilon block ends with a comma
        # before alpha, and sigmaF is last)
        parts += ["sigmaE"]
        parts += [f"comp[{i+1}]" for i in range(M)]
        parts += [f"sigmaG[{i+1}]" for i in range(groups)]
        parts += eps_cols
        parts += [f"alpha[{i+1}]" for i in range(F)]
        parts += ["sigmaF"]
        return ",".join(parts) + "\n"
    if schema == "grstart":
        # src/BRv2Grstart.cpp:26-50
        parts += ["sigmaE"]
        parts += [f"comp[{i+1}]" for i in range(M)]
        parts += [f"sigmaG[{i+1}]" for i in range(groups)]
        parts += eps_cols
        return ",".join(parts) + "\n"
    if schema == "horseshoe":
        # src/HorseshoeR.cpp:279-291 (reference emits a trailing comma after
        # the last epsilon; we drop it so columns align with the rows)
        parts += ["sigmaE", "tau"]
        parts += [f"lambda[{i+1}]" for i in range(M)]
        parts += eps_cols
        return ",".join(parts) + "\n"
    raise ValueError(f"unknown schema {schema!r}")


def assemble_rows(schema: str, rows: Dict[str, np.ndarray]) -> np.ndarray:
    """Stack an emission-chunk dict into the (n, width) schema row layout.

    Field orders follow the reference packing expressions
    (src/BayesRv2.cpp:260, src/BayesRv2Groups.cpp:317, src/BRv2Grstart.cpp:267,
    src/HorseshoeR.cpp:258).
    """
    n = rows["mu"].shape[0]

    def col(x):
        x = np.asarray(x, np.float64)
        return x.reshape(n, -1)

    if schema == "bayesr":
        fields = [rows["iteration"], rows["mu"], rows["beta"], rows["sigmaE"],
                  rows["sigmaG"], rows["comp"], rows["epsilon"]]
    elif schema == "groups":
        fields = [rows["iteration"], rows["mu"], rows["beta"], rows["sigmaE"],
                  rows["comp"], rows["sigmaG"], rows["epsilon"], rows["alpha"],
                  rows["sigmaF"]]
    elif schema == "grstart":
        fields = [rows["iteration"], rows["mu"], rows["beta"], rows["sigmaE"],
                  rows["comp"], rows["sigmaG"], rows["epsilon"]]
    elif schema == "horseshoe":
        fields = [rows["iteration"], rows["mu"], rows["beta"], rows["sigmaE"],
                  rows["tau"], rows["lambda"], rows["epsilon"]]
    else:
        raise ValueError(f"unknown schema {schema!r}")
    return np.concatenate([col(f) for f in fields], axis=1)


class _AsyncWriterMixin:
    """Bounded-queue background writer shared by the sinks."""

    def _start_writer(self, maxsize: int = 8):
        self._q: "queue.Queue" = queue.Queue(maxsize=maxsize)
        self._exc: Optional[BaseException] = None
        self._thread = threading.Thread(target=self._drain, daemon=True)
        self._thread.start()

    def _drain(self):
        while True:
            item = self._q.get()
            try:
                if item is None:
                    return
                try:
                    self._write_chunk(item)
                except BaseException as e:  # surfaced on flush/close
                    self._exc = e
            finally:
                self._q.task_done()

    def _submit(self, item):
        if self._exc is not None:
            raise self._exc
        self._q.put(item)

    def flush(self):
        self._q.join()  # blocks until every submitted chunk is written
        if self._exc is not None:
            raise self._exc

    def close(self):
        self._q.put(None)
        self._thread.join()
        if self._exc is not None:
            raise self._exc


class CSVSink(_AsyncWriterMixin):
    """Reference-schema CSV sample sink with a background writer thread."""

    def __init__(self, path: str, schema: str, M: int, N: int, *,
                 groups: int = 0, F: int = 0, emit_epsilon: bool = True):
        self.path = path
        self.schema = schema
        self._native = get_native_writer()
        self._fh = open(path, "w", buffering=1 << 20)
        self._fh.write(csv_header(schema, M, N, groups, F, emit_epsilon))
        self._start_writer()

    def write(self, rows: Dict[str, np.ndarray]):
        self._submit(assemble_rows(self.schema, rows))

    def _write_chunk(self, mat: np.ndarray):
        if self._native is not None:
            self._fh.write(self._native.format_rows(mat))
        else:
            # Eigen CommaInitFmt row format: ", "-separated (src/BayesRv2.cpp:72)
            out = []
            for r in mat:
                out.append(", ".join(repr(float(x)) for x in r))
            self._fh.write("\n".join(out) + "\n")

    def close(self):
        super().close()
        self._fh.close()


class NpzSink(_AsyncWriterMixin):
    """Columnar binary sink: accumulates chunks, writes one .npz on close.

    The efficient alternative the reference lacks (its only output is a CSV
    with the full N-vector of residuals per row, enormous at scale --
    SURVEY.md section 5 'observability').
    """

    def __init__(self, path: str):
        self.path = path
        self._chunks: List[Dict[str, np.ndarray]] = []
        self._start_writer()

    def write(self, rows: Dict[str, np.ndarray]):
        self._submit(dict(rows))

    def _write_chunk(self, rows):
        self._chunks.append(rows)

    def close(self):
        super().close()
        if self._chunks:
            merged = {k: np.concatenate([c[k] for c in self._chunks], axis=0)
                      for k in self._chunks[0]}
            np.savez_compressed(self.path, **merged)


class TeeSink:
    """Fan a sample stream out to several sinks (e.g. CSV + npz)."""

    def __init__(self, *sinks):
        self.sinks = sinks

    def write(self, rows):
        for s in self.sinks:
            s.write(rows)

    def flush(self):
        for s in self.sinks:
            s.flush()

    def close(self):
        for s in self.sinks:
            s.close()


class MemorySink(_AsyncWriterMixin):
    """Collects chunks in memory (tests)."""

    def __init__(self):
        self.rows: List[Dict[str, np.ndarray]] = []
        self._start_writer()

    def write(self, rows):
        self._submit(rows)

    def _write_chunk(self, rows):
        self.rows.append(rows)

    def result(self):
        self.flush()
        return {k: np.concatenate([c[k] for c in self.rows], axis=0)
                for k in self.rows[0]} if self.rows else {}


class ChainFanoutSink:
    """Split a multi-chain sample stream (fields shaped (emits, chains, ...))
    into one per-chain sink, e.g. one CSV file per chain.

    ``make_sink(c)`` builds the sink for chain c; with a path template use
    ``ChainFanoutSink.csv(path, n_chains, schema, **kw)`` which writes
    ``path`` with ``.chain{c}`` inserted before the extension.
    """

    def __init__(self, make_sink, n_chains: int):
        self.sinks = [make_sink(c) for c in range(n_chains)]

    @classmethod
    def csv(cls, path, n_chains, schema, **kw):
        import os

        root, ext = os.path.splitext(path)

        def make(c):
            return CSVSink(f"{root}.chain{c}{ext or '.csv'}", schema, **kw)

        return cls(make, n_chains)

    def write(self, rows):
        for c, s in enumerate(self.sinks):
            s.write({k: v[:, c] for k, v in rows.items()})

    def flush(self):
        for s in self.sinks:
            s.flush()

    def close(self):
        for s in self.sinks:
            s.close()
