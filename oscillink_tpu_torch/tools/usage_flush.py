"""Usage JSONL flusher: tail the usage log, batch to a report endpoint with
HMAC signing and exponential backoff (reference tools/usage_flush.py:12-60).

The port's own copy of ``oscillink_tpu/tools/usage_flush.py``: host-only, it
imports neither torch nor JAX.
"""

from __future__ import annotations

import argparse
import hashlib
import hmac
import json
import os
import sys
import time
import urllib.request
from typing import Optional

__all__ = ["flush_once", "main"]


def _sign(body: bytes, secret: str) -> str:
    return hmac.new(secret.encode(), body, hashlib.sha256).hexdigest()


def read_new_lines(path: str, offset_path: str) -> tuple[list[dict], int]:
    """Read usage records after the persisted byte offset."""
    try:
        with open(offset_path, encoding="utf-8") as f:
            offset = int(f.read().strip() or 0)
    except Exception:
        offset = 0
    records: list[dict] = []
    try:
        size = os.path.getsize(path)
        if offset > size:
            # rotation/truncation: a stale larger offset would read nothing
            # forever (and then resume mid-stream once the file regrew)
            offset = 0
        with open(path, "rb") as f:
            f.seek(offset)
            chunk = f.read()
        # only consume up to the last COMPLETE line: the writer may be
        # mid-append, and advancing past a half-written record loses it
        # (its tail would fail to parse next cycle too)
        cut = chunk.rfind(b"\n")
        if cut < 0:
            return [], offset
        chunk = chunk[: cut + 1]
        new_offset = offset + len(chunk)
        for line in chunk.decode("utf-8", errors="replace").splitlines():
            line = line.strip()
            if line:
                try:
                    records.append(json.loads(line))
                except Exception:
                    pass
    except FileNotFoundError:
        return [], offset
    return records, new_offset


def _persist_offset(offset_path: str, offset: int) -> None:
    try:
        with open(offset_path, "w", encoding="utf-8") as f:
            f.write(str(offset))
    except Exception:
        pass


def flush_once(
    log_path: str,
    url: str,
    secret: Optional[str] = None,
    offset_path: Optional[str] = None,
    max_retries: int = 5,
) -> int:
    """Send one batch; returns number of records flushed (0 when none)."""
    offset_path = offset_path or log_path + ".offset"
    records, new_offset = read_new_lines(log_path, offset_path)
    if not records:
        return 0
    body = json.dumps({"records": records}).encode("utf-8")
    headers = {"Content-Type": "application/json"}
    if secret:
        headers["X-Usage-Signature"] = _sign(body, secret)
    delay = 1.0
    for attempt in range(max_retries):
        try:
            req = urllib.request.Request(url, data=body, headers=headers, method="POST")
            with urllib.request.urlopen(req, timeout=30) as resp:
                if 200 <= resp.status < 300:
                    _persist_offset(offset_path, new_offset)
                    return len(records)
        except Exception:
            pass
        if attempt < max_retries - 1:  # no pointless sleep after last try
            time.sleep(delay)
            delay = min(delay * 2, 60.0)
    return -1  # gave up; offset not advanced, will retry next cycle


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description="flush usage JSONL to report endpoint")
    parser.add_argument("--log", default=os.getenv("OSCILLINK_USAGE_LOG"))
    parser.add_argument("--url", default=os.getenv("OSCILLINK_USAGE_FLUSH_URL"))
    parser.add_argument("--secret", default=os.getenv("OSCILLINK_USAGE_SIGNING_SECRET"))
    parser.add_argument("--interval", type=float, default=float(os.getenv("OSCILLINK_USAGE_FLUSH_INTERVAL", "60")))
    parser.add_argument("--once", action="store_true")
    args = parser.parse_args(argv)
    if not args.log or not args.url:
        print("usage log path and flush URL required", file=sys.stderr)
        return 2
    while True:
        n = flush_once(args.log, args.url, args.secret)
        if n > 0:
            print(f"flushed {n} records")
        if args.once:
            return 0 if n >= 0 else 1
        time.sleep(args.interval)


if __name__ == "__main__":  # pragma: no cover
    sys.exit(main())
