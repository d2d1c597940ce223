"""The node-annotation codec: desired (spec) and reported (status) slices.

A trimmed counterpart of ``nos_tpu/api/v1alpha1/annotations.py:40-69``
with the reference nos's own keys (pkg/gpu/annotation.go:29-101, SURVEY
§2.5): the control plane writes spec annotations giving the geometry each
GPU should have, the node's agent writes status annotations saying what
exists and whether it is free or used.

  nos.nebuly.com/spec-gpu-<index>-<profile> = "<quantity>"
  nos.nebuly.com/status-gpu-<index>-<profile>-<free|used> = "<quantity>"
  nos.nebuly.com/spec-partitioning-plan   = "<plan-id>"
  nos.nebuly.com/status-partitioning-plan = "<plan-id>"

Profiles are MIG names ("3g.40gb") or MPS memory slices ("20gb"). The
MIG agent's reporter and the MPS agent's share the status keys, so each
owns only its own profiles' (``is_mig_status_key`` /
``is_mps_status_key``, the counterpart of ``is_sharing_status_key``).
"""
from __future__ import annotations

import json
import re
from collections import defaultdict
from dataclasses import dataclass
from typing import Dict, List, Mapping, Optional, Tuple

PREFIX = "nos.nebuly.com/"
SPEC_PARTITIONING_PLAN = PREFIX + "spec-partitioning-plan"
STATUS_PARTITIONING_PLAN = PREFIX + "status-partitioning-plan"
# the model autoscaler's cold-start grace holds on the nodes a scale to
# zero vacated (``nos_tpu/api/v1alpha1/annotations.py:28-34``): one hold a
# vacated replica, each with its holder, its slices and its own expiry,
# as JSON under AUTOSCALER_HOLDS; AUTOSCALER_RESERVED names the holders
# (comma-joined) and AUTOSCALER_RESERVED_UNTIL the latest expiry, which
# for one hold are the reference's two annotations as it writes them
AUTOSCALER_RESERVED = PREFIX + "autoscaler-reserved"
AUTOSCALER_RESERVED_UNTIL = PREFIX + "autoscaler-reserved-until"
AUTOSCALER_HOLDS = PREFIX + "autoscaler-holds"

MIG_PROFILE_RE = re.compile(r"^\d+g\.\d+gb$")
MPS_PROFILE_RE = re.compile(r"^\d+gb$")
_PROFILE = r"(\d+g\.\d+gb|\d+gb)"
_SPEC_RE = re.compile(r"^nos\.nebuly\.com/spec-gpu-(\d+)-" + _PROFILE + r"$")
_STATUS_RE = re.compile(r"^nos\.nebuly\.com/status-gpu-(\d+)-" + _PROFILE + r"-(free|used)$")

STATUS_FREE = "free"
STATUS_USED = "used"


@dataclass(frozen=True)
class SpecAnnotation:
    gpu_index: int
    profile: str
    quantity: int

    @property
    def key(self) -> str:
        return f"{PREFIX}spec-gpu-{self.gpu_index}-{self.profile}"


@dataclass(frozen=True)
class StatusAnnotation:
    gpu_index: int
    profile: str
    status: str  # free | used
    quantity: int

    @property
    def key(self) -> str:
        return f"{PREFIX}status-gpu-{self.gpu_index}-{self.profile}-{self.status}"


def parse_node_annotations(
    annotations: Mapping[str, str],
) -> Tuple[List[SpecAnnotation], List[StatusAnnotation]]:
    """The spec and status annotations of a node's annotation map.

    Malformed quantities are skipped (an API server cannot enforce the
    value format), as the reference parses (pkg/gpu/annotation.go:29-101).
    """
    spec: List[SpecAnnotation] = []
    status: List[StatusAnnotation] = []
    for key, value in annotations.items():
        m = _SPEC_RE.match(key)
        if m:
            qty = _parse_quantity(value)
            if qty is not None:
                spec.append(SpecAnnotation(int(m.group(1)), m.group(2), qty))
            continue
        m = _STATUS_RE.match(key)
        if m:
            qty = _parse_quantity(value)
            if qty is not None:
                status.append(StatusAnnotation(int(m.group(1)), m.group(2), m.group(3), qty))
    return spec, status


def status_key_profile(key: str):
    """The profile of a status annotation key ("3g.40gb", "20gb"), else
    None."""
    m = _STATUS_RE.match(key)
    return m.group(2) if m else None


def is_mig_status_key(key: str) -> bool:
    profile = status_key_profile(key)
    return profile is not None and bool(MIG_PROFILE_RE.match(profile))


def is_mps_status_key(key: str) -> bool:
    profile = status_key_profile(key)
    return profile is not None and bool(MPS_PROFILE_RE.match(profile))


def _parse_quantity(value: str):
    """Counts must be positive integers; anything else is malformed."""
    try:
        qty = int(value)
    except ValueError:
        return None
    return qty if qty > 0 else None


def spec_from_geometries(geometries: Mapping[int, Mapping[str, int]]) -> Dict[str, str]:
    """GPU index → geometry, rendered as spec annotations."""
    return {
        SpecAnnotation(gpu, profile, qty).key: str(qty)
        for gpu, geometry in geometries.items()
        for profile, qty in geometry.items() if qty > 0
    }


def status_from_devices(
    free: Mapping[int, Mapping[str, int]], used: Mapping[int, Mapping[str, int]]
) -> Dict[str, str]:
    """Free and used geometries by GPU index, rendered as status annotations."""
    out: Dict[str, str] = {}
    for source, label in ((free, STATUS_FREE), (used, STATUS_USED)):
        for gpu, geometry in source.items():
            for profile, qty in geometry.items():
                if qty > 0:
                    out[StatusAnnotation(gpu, profile, label, qty).key] = str(qty)
    return out


def _aggregate(entries) -> Dict[int, Dict[str, int]]:
    out: Dict[int, Dict[str, int]] = defaultdict(dict)
    for s in entries:
        out[s.gpu_index][s.profile] = out[s.gpu_index].get(s.profile, 0) + s.quantity
    return dict(out)


def spec_geometries(spec: List[SpecAnnotation]) -> Dict[int, Dict[str, int]]:
    """The geometry each GPU should have (the agent's plan input)."""
    return _aggregate(spec)


def status_geometries(status: List[StatusAnnotation]) -> Dict[int, Dict[str, int]]:
    """Total (free + used) geometry per GPU from status annotations."""
    return _aggregate(status)


def strip_spec_annotations(annotations: Mapping[str, str]) -> Dict[str, None]:
    """The patch that removes every spec geometry annotation."""
    return {k: None for k in annotations if _SPEC_RE.match(k)}


@dataclass(frozen=True)
class GraceHold:
    """One cold-start grace hold: the replica a scale to zero vacated was
    ``holder``'s (its serving key), it held ``slices`` memory slices (its
    profile's), and the hold lasts until ``until`` (the reconciler's
    clock)."""

    holder: str
    slices: int
    until: float


def grace_holds(annotations: Mapping[str, str], node_slices: int) -> List[GraceHold]:
    """The node's grace holds. A node carrying only the two summary
    annotations (written by a writer that records no slices) holds all
    its ``node_slices`` for one holder."""
    raw = annotations.get(AUTOSCALER_HOLDS)
    if raw is not None:
        try:
            return [GraceHold(str(h["holder"]), int(h["slices"]), float(h["until"]))
                    for h in json.loads(raw)]
        except (ValueError, TypeError, KeyError):
            return []
    holder = annotations.get(AUTOSCALER_RESERVED, "")
    if not holder:
        return []
    try:
        until = float(annotations.get(AUTOSCALER_RESERVED_UNTIL, "0"))
    except ValueError:
        until = 0.0
    return [GraceHold(holder, node_slices, until)]


def grace_hold_patch(holds: List[GraceHold]) -> Dict[str, Optional[str]]:
    """The annotation patch that makes ``holds`` the node's holds (none:
    every grace annotation removed)."""
    if not holds:
        return {AUTOSCALER_HOLDS: None, AUTOSCALER_RESERVED: None,
                AUTOSCALER_RESERVED_UNTIL: None}
    ordered = sorted(holds, key=lambda h: (h.until, h.holder, h.slices))
    return {AUTOSCALER_HOLDS: json.dumps([{"holder": h.holder, "slices": h.slices,
                                           "until": h.until} for h in ordered]),
            AUTOSCALER_RESERVED: ",".join(sorted({h.holder for h in holds})),
            AUTOSCALER_RESERVED_UNTIL: f"{max(h.until for h in holds):.6f}"}
