"""The planner's warm state on disk, and the frames of the pool workers'
pipe.

Counterpart of ``nos_tpu/partitioning/core/snapcodec.py``: the frames
(``encode_frame`` / ``decode_frame``, ``FrameError``: a magic, the codec
version and the payload's length before one canonical JSON document),
``node_state_signature``, ``AdoptReport`` and ``WarmStateCodec``
(``save``, ``save_entries``, ``load``, ``adopt``, ``due``).

No node state is ever read from disk: the store is the only source of
it. What is saved, per node, is a SHA-256 signature of every input the
planner's memos read of the node (labels, taints, cordon, capacity,
allocatable, product through its label, geometry, the placed pods'
requests, the frozen flag, and the geometries the node's MIG agent
refused), beside the memo entries derived from that state
(``Planner.export_warm_state``). On adoption the signature is taken
again from the freshly built snapshot, and only a node whose signature
matches has its entries re-keyed at its live version; every other node
is reported unmatched, and the caller plans it as dirty. So a warm plan
equals a cold one.

F4's refusals (``partitioning/mig.py``) are part of a MIG node's state:
they change which geometries a GPU may take, so two nodes equal but for
one refusal sign apart, and neither adopts the other's entries.

``SNAPSHOT_CODEC_VERSION`` and the slice codec's class name gate the
whole file: a mismatch, a corrupt file or an absent one makes ``load``
return None and the caller takes the cold path, never a crash. A save
is atomic (a temporary file renamed over the old one) and rate-limited:
``save_interval_seconds`` on the codec's ``clock`` (the controller's,
virtual under ``SimCluster``); the first save is always due.

The file is pool-agnostic: entries are keyed by node name, and a sharded
controller hands each pool's planner the entries of its nodes.
"""
from __future__ import annotations

import hashlib
import json
import logging
import os
import struct
import tempfile
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, Optional, Set

from nos_tpu_torch.partitioning.core.snapshot import ClusterSnapshot, SnapshotNode
from nos_tpu_torch.util import resources as res

log = logging.getLogger("nos_tpu_torch.partitioner")

SNAPSHOT_CODEC_VERSION = 1

FRAME_MAGIC = b"NOSW"
_FRAME_HEADER = struct.Struct(">4sII")  # magic, codec version, payload length


class FrameError(ValueError):
    """A frame that cannot be trusted: bad magic, another codec version, a
    truncated or short frame, or a payload that is not one JSON object."""


def encode_frame(doc: dict) -> bytes:
    payload = json.dumps(doc, separators=(",", ":"), sort_keys=True).encode("utf-8")
    return _FRAME_HEADER.pack(FRAME_MAGIC, SNAPSHOT_CODEC_VERSION, len(payload)) + payload


def decode_frame(data: bytes) -> dict:
    """One frame's document; the header is checked before the payload."""
    if len(data) < _FRAME_HEADER.size:
        raise FrameError(f"short frame: {len(data)} bytes")
    magic, version, length = _FRAME_HEADER.unpack_from(data)
    if magic != FRAME_MAGIC:
        raise FrameError(f"bad frame magic {magic!r}")
    if version != SNAPSHOT_CODEC_VERSION:
        raise FrameError(f"frame codec version {version} != {SNAPSHOT_CODEC_VERSION}")
    payload = data[_FRAME_HEADER.size:]
    if len(payload) != length:
        raise FrameError(f"truncated frame: header says {length} bytes, got {len(payload)}")
    try:
        doc = json.loads(payload.decode("utf-8"))
    except (UnicodeDecodeError, ValueError) as exc:
        raise FrameError(f"unparseable frame payload: {exc}") from exc
    if not isinstance(doc, dict):
        raise FrameError(f"frame payload is {type(doc).__name__}, not object")
    return doc


def _canon(mapping) -> list:
    """Sorted items, a float that is a whole number written as an int."""
    return [[k, int(v) if isinstance(v, float) and v.is_integer() else v]
            for k, v in sorted(mapping.items())]


def node_refusals(snap_node: SnapshotNode) -> Dict[int, list]:
    """GPU index → the geometries its agent refused (sorted item lists),
    for the GPUs that have any (F4; a MIG node's only)."""
    return {gpu.index: sorted(sorted([list(i) for i in g]) for g in gpu.refused)
            for gpu in getattr(snap_node.partitionable, "gpus", ())
            if getattr(gpu, "refused", None)}


def node_state_signature(snap_node: SnapshotNode) -> str:
    """SHA-256 of every node input the planner's memos were derived from:
    two nodes with equal signatures plan alike."""
    node = snap_node.node
    doc = {
        "frozen": snap_node.frozen,
        "labels": sorted(node.labels.items()),
        "taints": sorted((t.key, t.value, t.effect) for t in node.taints),
        "unschedulable": bool(node.unschedulable),
        "capacity": _canon(node.capacity),
        "allocatable": _canon(node.allocatable),
        "geometry": [[index, _canon(geometry)]
                     for index, geometry in sorted(snap_node.partitionable.geometry().items())],
        "refused": sorted([index, geometries]
                          for index, geometries in node_refusals(snap_node).items()),
        "pods": sorted([p.namespace, p.name, str(p.uid), _canon(res.compute_pod_request(p))]
                       for p in snap_node.pods),
    }
    return hashlib.sha256(json.dumps(doc, sort_keys=True, default=str).encode()).hexdigest()


@dataclass
class AdoptReport:
    """What an adoption covered: nodes matched, the unmatched ones (the
    caller plans them as dirty) and the entries adopted."""

    matched: int = 0
    unmatched: Set[str] = field(default_factory=set)
    adopted_entries: int = 0

    def outcome(self) -> str:
        """``adopted`` (every node matched), ``partial`` or ``cold``."""
        if self.matched and not self.unmatched:
            return "adopted"
        return "partial" if self.matched else "cold"


class WarmStateCodec:
    """Save, load and adopt one partitioning mode's warm state; signatures
    are memoized per (node, version), so a save hashes only nodes that
    changed."""

    def __init__(self, path: str, save_interval_seconds: float = 30.0,
                 clock: Callable[[], float] = time.monotonic) -> None:
        self.path = path
        self.save_interval_seconds = save_interval_seconds
        self.clock = clock
        self._last_save: Optional[float] = None
        self._sig_cache: Dict[str, tuple] = {}

    def signature(self, name: str, snap_node: SnapshotNode) -> str:
        cached = self._sig_cache.get(name)
        if cached is not None and cached[0] == snap_node.version and cached[1] is snap_node:
            return cached[2]
        signature = node_state_signature(snap_node)
        self._sig_cache[name] = (snap_node.version, snap_node, signature)
        return signature

    # ------------------------------------------------------------ save

    def due(self, now: Optional[float] = None) -> bool:
        """Whether the rate limit admits a save now."""
        now = self.clock() if now is None else now
        return self._last_save is None or now - self._last_save >= self.save_interval_seconds

    def save(self, snapshot: ClusterSnapshot, planner, now: Optional[float] = None,
             force: bool = False) -> bool:
        """The planner's exportable memos, signed with ``snapshot``'s nodes;
        False when the rate limit refused."""
        now = self.clock() if now is None else now
        if not force and not self.due(now):
            return False
        return self.save_entries(snapshot, planner.export_warm_state(snapshot), now=now,
                                 force=True)

    def save_entries(self, snapshot: ClusterSnapshot, entries: Dict[str, dict],
                     now: Optional[float] = None, force: bool = False,
                     nodes: Optional[Dict[str, SnapshotNode]] = None,
                     signatures: Optional[Dict[str, str]] = None) -> bool:
        """Exported entries against node signatures: taken from ``nodes``
        (default: the snapshot's), or given whole in ``signatures`` (a
        pool worker signs its own nodes)."""
        now = self.clock() if now is None else now
        if not force and not self.due(now):
            return False
        if signatures is None:
            nodes = snapshot.get_nodes() if nodes is None else nodes
            signatures = {name: self.signature(name, n) for name, n in nodes.items()}
        doc = {
            "codec_version": SNAPSHOT_CODEC_VERSION,
            "slice_codec": type(snapshot.codec).__name__,
            "saved_at": now,
            "nodes": {name: {"signature": signature,
                             "futility": entries.get(name, {}).get("futility", []),
                             "verdicts": entries.get(name, {}).get("verdicts", [])}
                      for name, signature in signatures.items()},
        }
        directory = os.path.dirname(os.path.abspath(self.path))
        os.makedirs(directory, exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=directory, prefix=".warm-state-")
        try:
            with os.fdopen(fd, "w") as handle:
                json.dump(doc, handle, separators=(",", ":"))
            os.replace(tmp, self.path)
        except OSError:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise
        self._last_save = now
        return True

    # ------------------------------------------------------------ load

    def load(self, expected_codec: str) -> Optional[dict]:
        """The saved document, or None for any reason not to trust it."""
        try:
            with open(self.path) as handle:
                doc = json.load(handle)
        except (OSError, ValueError):
            return None
        if not isinstance(doc, dict):
            return None
        if doc.get("codec_version") != SNAPSHOT_CODEC_VERSION:
            log.info("warm state %s: codec version %r != %d; cold", self.path,
                     doc.get("codec_version"), SNAPSHOT_CODEC_VERSION)
            return None
        if doc.get("slice_codec") != expected_codec:
            log.info("warm state %s: slice codec %r != %r; cold", self.path,
                     doc.get("slice_codec"), expected_codec)
            return None
        return doc if isinstance(doc.get("nodes"), dict) else None

    # ----------------------------------------------------------- adopt

    def adopt(self, snapshot: ClusterSnapshot, planner, doc: Optional[dict] = None
              ) -> AdoptReport:
        """Re-key the saved entries of every node whose signature matches
        onto ``snapshot`` (loading the file when ``doc`` is None); an
        untrusted file adopts nothing and leaves every node unmatched."""
        if doc is None:
            doc = self.load(type(snapshot.codec).__name__)
        report = AdoptReport()
        live = snapshot.get_nodes()
        if doc is None:
            report.unmatched = set(live)
            return report
        matched: Dict[str, dict] = {}
        for name, snap_node in live.items():
            saved = doc["nodes"].get(name)
            if isinstance(saved, dict) and saved.get("signature") == self.signature(
                    name, snap_node):
                matched[name] = saved
                report.matched += 1
            else:
                report.unmatched.add(name)
        if matched:
            report.adopted_entries = planner.adopt_warm_state(snapshot, matched)
        return report
