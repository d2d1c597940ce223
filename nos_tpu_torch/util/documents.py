"""Configuration documents read JSON-first.

A component's config and a kubeconfig are YAML in the reference
(``yaml.safe_load``). JSON is YAML, so a document that parses as JSON is
read with the standard library and gives the same result; only another
document imports PyYAML, which the card's machine does not promise, and
its absence is then a clear error.
"""
from __future__ import annotations

import json
from typing import Any


def load_document(path: str) -> Any:
    """The parsed document at ``path`` (None for an empty one)."""
    with open(path) as f:
        text = f.read()
    try:
        return json.loads(text) if text.strip() else None
    except ValueError:
        pass
    try:
        import yaml
    except ImportError as e:
        raise RuntimeError(f"{path} is not JSON, and reading YAML needs the PyYAML "
                           "package; install it or write the document as JSON") from e
    return yaml.safe_load(text)
