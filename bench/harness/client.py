"""Open-loop HTTP client: sends a schedule of requests at their due
times and reports each answer.

Runs as a process of its own (``python3 client.py``), so that the
client's Python never competes with the gateway's threads for one
interpreter lock.  Standard library only.  Reads one JSON object on
standard input::

    {"address": "127.0.0.1:8080", "token": "...", "workers": 64,
     "poll_s": 0.01, "grace_s": 60, "trace": false,
     "requests": [{"due": 0.12, "method": "GET", "path": "/v1/topk?k=10"},
                  {"due": 0.30, "method": "POST", "path": "/v1/jobs",
                   "body": {...}, "job": true}, ...]}

``due`` is in seconds from the moment the schedule starts.  A request is
handed to a worker at its due time whether or not earlier ones have been
answered (an open loop); a ``job`` request is a submission followed by
polls of ``/v1/jobs/{id}/result`` until it is no longer 202.  Writes one
JSON line a request to standard output, in schedule order:
``{"i", "due", "start", "end", "status", "body", "trace_id"}``, times
in seconds from the schedule's start, ``end`` the time its final answer
arrived.  A request not answered ``grace_s`` after the last due time is
reported with status 0.
"""
from __future__ import annotations

import http.client
import json
import os
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor


def _connection(local, address: str):
    conn = getattr(local, "conn", None)
    if conn is None:
        host, port = address.rsplit(":", 1)
        conn = http.client.HTTPConnection(host, int(port), timeout=120)
        local.conn = conn
    return conn


def _call(local, address, token, method, path, body=None):
    """(status, parsed body, trace id) of one request; reconnects once
    when the kept-alive connection was closed under it."""
    data = None if body is None else json.dumps(body).encode()
    headers = {"Authorization": f"Bearer {token}"}
    if data is not None:
        headers["Content-Type"] = "application/json"
    for attempt in (0, 1):
        conn = _connection(local, address)
        try:
            conn.request(method, path, body=data, headers=headers)
            resp = conn.getresponse()
            raw = resp.read()
            break
        except (ConnectionError, http.client.HTTPException, OSError):
            conn.close()
            local.conn = None
            if attempt:
                raise
    try:
        parsed = json.loads(raw) if raw else None
    except json.JSONDecodeError:
        parsed = None
    return resp.status, parsed, resp.getheader("X-Trace-Id")


def main() -> None:
    spec = json.load(sys.stdin)
    address, token = spec["address"], spec["token"]
    reqs = spec["requests"]
    poll_s = float(spec.get("poll_s", 0.01))
    suffix = "trace=1" if spec.get("trace") else None
    local = threading.local()
    out = [None] * len(reqs)

    def with_trace(path: str) -> str:
        if suffix is None:
            return path
        return path + ("&" if "?" in path else "?") + suffix

    def run(i: int, r: dict, t0: float) -> None:
        start = time.perf_counter() - t0
        status, body, tid = 0, None, None
        try:
            status, body, tid = _call(local, address, token, r["method"],
                                      with_trace(r["path"]), r.get("body"))
            if r.get("job") and status == 200 and isinstance(body, dict):
                path = f"/v1/jobs/{body.get('job')}/result"
                while True:
                    status, body, _ = _call(local, address, token, "GET",
                                            path)
                    if status != 202:
                        break
                    time.sleep(poll_s)
        except Exception as e:     # reported as a failed request
            status, body = 0, {"error": f"{type(e).__name__}: {e}"}
        out[i] = {"i": i, "due": r["due"], "start": start,
                  "end": time.perf_counter() - t0, "status": status,
                  "body": body, "trace_id": tid}

    pool = ThreadPoolExecutor(max_workers=int(spec.get("workers", 64)))
    futures = []
    t0 = time.perf_counter()
    for i, r in enumerate(reqs):
        wait = r["due"] - (time.perf_counter() - t0)
        if wait > 0:
            time.sleep(wait)
        futures.append(pool.submit(run, i, r, t0))
    deadline = time.perf_counter() + float(spec.get("grace_s", 60.0))
    for f in futures:
        try:
            f.result(timeout=max(deadline - time.perf_counter(), 0.001))
        except Exception:          # late or lost: left as status 0 below
            pass
    for i, r in enumerate(reqs):
        line = out[i] or {"i": i, "due": r["due"], "start": None,
                          "end": None, "status": 0, "body": None,
                          "trace_id": None}
        sys.stdout.write(json.dumps(line) + "\n")
    sys.stdout.flush()
    # a request still open past the grace period must not hold the exit
    os._exit(0)


if __name__ == "__main__":
    main()
