"""Engine flight recorder: a bounded ring of per-step structured records (a
copy of ``dynamo_tpu/observability/flight.py``, less the record kinds of
unported planes).

The last step's composition and the cumulative counters are enough for
dashboards, useless for postmortems: by the time a stall or crash is
noticed, the interesting steps are gone. The flight recorder keeps the last
N steps verbatim, the way an aircraft FDR does:

- ``step`` records — one per ``EngineCore.step()``: step kind (mixed /
  prefill / decode / drain), decode rows, prefill chunk rows/tokens, queues,
  pool free pages, cumulative preemptions/rejections, step wall time and
  in-step runner dispatch time, the overlapped-execution fields ``gap_ms``
  (host gap since the previous step completed) and ``overlap_mode`` /
  ``barrier_reason``, speculative counts, the attention dispatch, the
  admission plane's fields and the onboard stall.
- ``crash`` records — appended by ``EngineCore.step()`` when a step raises,
  capturing the failing step's context before the exception propagates, and
  by the service's loop (``where="engine_loop"``) before it fails the
  streams.

The JAX build's ``compile`` and ``anomaly`` records come from its compile
tracker and anomaly sentinel, which are not ported, nor is the
``/debug/flight/{worker}`` route that serves the ring remotely. The ring is
dumped to a JSONL file on an engine-step failure (``engine/service.py``
calls :meth:`FlightRecorder.dump_jsonl`), so a dead worker still leaves its
last seconds on disk.
"""

from __future__ import annotations

import json
import os
import tempfile
import threading
import time
from collections import deque
from typing import Any

#: Record kinds written into the ring.
STEP = "step"
CRASH = "crash"

_DEFAULT_CAPACITY = 2048
_DUMP_DIR_ENV = "DYN_FLIGHT_DUMP_DIR"
_CAPACITY_ENV = "DYN_FLIGHT_BUFFER"


def _default_capacity() -> int:
    try:
        return int(os.environ.get(_CAPACITY_ENV, str(_DEFAULT_CAPACITY)))
    except ValueError:
        return _DEFAULT_CAPACITY


class FlightRecorder:
    """Thread-safe bounded ring of structured engine records.

    Records are plain dicts carrying a monotonically increasing ``seq`` (so
    consumers can detect ring wrap: a gap in seq means records were lost),
    a wall-clock ``ts``, and a ``kind``. The recorder never raises into the
    engine — it is observability, not control flow.
    """

    def __init__(self, capacity: int | None = None) -> None:
        cap = capacity if capacity is not None else _default_capacity()
        self._records: deque[dict] = deque(maxlen=max(1, cap))
        self._lock = threading.Lock()
        self._seq = 0

    def record(self, kind: str, **fields: Any) -> dict:
        doc = {"seq": self._seq, "ts": time.time(), "kind": kind, **fields}
        with self._lock:
            doc["seq"] = self._seq
            self._seq += 1
            self._records.append(doc)
        return doc

    def snapshot(self, *, last: int | None = None, kind: str | None = None) -> list[dict]:
        """Ordered (oldest-first) copy of the ring, optionally filtered."""
        with self._lock:
            records = list(self._records)
        if kind is not None:
            records = [r for r in records if r.get("kind") == kind]
        if last is not None and last >= 0:
            records = records[-last:]
        return records

    def __len__(self) -> int:
        with self._lock:
            return len(self._records)

    def clear(self) -> None:
        with self._lock:
            self._records.clear()

    # -- crash dump --------------------------------------------------------

    def dump_jsonl(self, path: str | None = None, *, reason: str = "manual") -> str:
        """Write the ring to a JSONL file (one record per line, preceded by
        a header line identifying the dump); returns the path written.

        Default location: ``$DYN_FLIGHT_DUMP_DIR``, else ``dynamo-flight``
        under the temporary directory (the JAX build: ``/tmp/dynamo-flight``),
        ``flight-<pid>-<unix ms>.jsonl`` — unique enough that successive
        crashes never clobber each other.
        """
        if path is None:
            d = os.environ.get(_DUMP_DIR_ENV) or os.path.join(tempfile.gettempdir(), "dynamo-flight")
            os.makedirs(d, exist_ok=True)
            path = os.path.join(d, f"flight-{os.getpid()}-{int(time.time() * 1e3)}.jsonl")
        records = self.snapshot()
        header = {
            "kind": "dump_header",
            "reason": reason,
            "pid": os.getpid(),
            "ts": time.time(),
            "records": len(records),
        }
        with open(path, "w") as f:
            f.write(json.dumps(header, default=str) + "\n")
            for r in records:
                f.write(json.dumps(r, default=str) + "\n")
        return path
