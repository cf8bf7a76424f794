"""Retriable per-shot work units (SURVEY §5.3).

A copy of :mod:`pyfft_tpu.utils.workunits` (pure Python; the port keeps
its own).

The reference has no failure story (single process, one shot at a time).
For long multi-shot batch runs the survey prescribes per-shot work units
that fail independently and retry: a host-side orchestration shell around
the device pipelines.

- :class:`WorkQueue`: run ``fn(item)`` over many items with per-item retry,
  failure isolation, and a JSON-lines manifest on disk, so an interrupted
  batch resumes exactly where it stopped.
"""
from __future__ import annotations

import json
import os
import time
import traceback

__all__ = ["WorkQueue"]


class WorkQueue:
    """Resumable, retriable batch runner.

    >>> q = WorkQueue("run_manifest.jsonl", retries=2)
    >>> results = q.run(shots, analyze_one)     # skips already-done items

    Items are identified by ``key(item)`` (default ``str``).  The manifest
    records one JSON line per attempt; ``status`` in {'done', 'failed'}.
    Items already 'done' in the manifest are skipped on re-run.
    """

    def __init__(self, manifest_path, retries=1, key=str,
                 retry_delay_s=0.0):
        self.manifest_path = os.fspath(manifest_path)
        self.retries = int(retries)
        self.key = key
        self.retry_delay_s = float(retry_delay_s)

    # -- manifest ------------------------------------------------------------

    def _load_done(self):
        done = set()
        if os.path.exists(self.manifest_path):
            with open(self.manifest_path) as f:
                for line in f:
                    try:
                        rec = json.loads(line)
                    except json.JSONDecodeError:
                        continue
                    if rec.get("status") == "done":
                        done.add(rec["key"])
        return done

    def _append(self, rec):
        with open(self.manifest_path, "a") as f:
            f.write(json.dumps(rec) + "\n")

    # -- execution -----------------------------------------------------------

    def run(self, items, fn, on_result=None):
        """Process ``items`` with ``fn``; returns ``{key: result}`` for the
        items completed *in this call*.  Failed items (after retries) are
        recorded and skipped, never fatal."""
        done = self._load_done()
        results = {}
        for item in items:
            k = self.key(item)
            if k in done:
                continue
            err = None
            for attempt in range(self.retries + 1):
                try:
                    out = fn(item)
                    self._append({"key": k, "status": "done",
                                  "attempt": attempt, "ts": time.time()})
                    results[k] = out
                    if on_result is not None:
                        on_result(k, out)
                    err = None
                    break
                except Exception as e:   # noqa: BLE001 - isolation is the point
                    err = e
                    self._append({
                        "key": k, "status": "failed", "attempt": attempt,
                        "ts": time.time(), "error": repr(e),
                        "traceback": traceback.format_exc(limit=5)})
                    if attempt < self.retries and self.retry_delay_s:
                        time.sleep(self.retry_delay_s)
            # err left set => permanently failed; recorded above
        return results

    def failed(self):
        """Keys whose *last* attempt failed (and never succeeded)."""
        last = {}
        if os.path.exists(self.manifest_path):
            with open(self.manifest_path) as f:
                for line in f:
                    try:
                        rec = json.loads(line)
                    except json.JSONDecodeError:
                        continue
                    last[rec["key"]] = rec.get("status")
        return {k for k, s in last.items() if s == "failed"}
