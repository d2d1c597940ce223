"""Watch event predicates: counterpart of ``nos_tpu/util/predicates.py``
(reference pkg/util/predicate/predicates.go)."""
from __future__ import annotations

from nos_tpu_torch.kube.store import DELETED, WatchEvent


def matching_name(name: str):
    def predicate(event: WatchEvent) -> bool:
        return event.object.name == name

    return predicate


def exclude_delete(event: WatchEvent) -> bool:
    return event.type != DELETED


def annotations_changed_or_added(event: WatchEvent) -> bool:
    """A coarse AnnotationsChangedPredicate: an event carries no old
    object, so every ADDED / MODIFIED passes (reconcilers are
    level-triggered)."""
    return event.type != DELETED


def and_(*predicates):
    def predicate(event: WatchEvent) -> bool:
        return all(p(event) for p in predicates)

    return predicate
