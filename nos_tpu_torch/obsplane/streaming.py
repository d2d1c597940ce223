"""Cursor paging and JSONL lines: counterpart of
``nos_tpu/obsplane/streaming.py``.

Items are ordered by a stable string key; the cursor is the last key of
the previous page, and a page is the first ``limit`` items after it
(plain string order, so zero-padded names page in order). An empty
``next_cursor`` means the listing is done.
"""
from __future__ import annotations

import bisect
import json
from typing import Dict, Iterable, Iterator, List, Sequence, Tuple


def paginate(keys: Sequence[str], limit: int = 0, cursor: str = "") -> Tuple[List[str], str]:
    """(page, next_cursor) of the sorted ``keys``; ``limit`` <= 0 is the
    whole rest."""
    start = bisect.bisect_right(keys, cursor) if cursor else 0
    if limit and limit > 0:
        page = list(keys[start:start + limit])
        more = start + limit < len(keys)
        return page, (page[-1] if page and more else "")
    return list(keys[start:]), ""


def page_params(query: Dict[str, str], default_limit: int = 0) -> dict:
    """``?pool=`` / ``?limit=`` / ``?cursor=`` / ``?format=`` as keyword
    arguments; a bad limit raises ValueError (an HTTP 400)."""
    limit = default_limit
    if "limit" in query:
        limit = int(query["limit"])
        if limit < 0:
            raise ValueError("limit must be >= 0")
    return {"pool": query.get("pool", ""), "limit": limit, "cursor": query.get("cursor", ""),
            "jsonl": query.get("format", "") == "jsonl"}


def jsonl_lines(records: Iterable[dict]) -> Iterator[bytes]:
    """One encoded line a record, as the chunked writer consumes them."""
    for record in records:
        yield (json.dumps(record, sort_keys=True) + "\n").encode()
