"""Lease-based leader election over the store: counterpart of
``nos_tpu/kube/leaderelection.py`` (``:43-232``).

client-go's resourcelock over a ConfigMap: the lock's annotations carry
the holder (``HOLDER_ANNOTATION``) and a renew stamp
(``RENEW_ANNOTATION``); acquiring and renewing are read-modify-write
patches, so over the API-backed store (``kube/apistore.py``) they are a
resource-version race on the API server, and a writer that loses it
(``ConflictError``) observes the winner. A challenger times the lease on
its own monotonic clock from the moment it first sees a given (holder,
stamp) pair, so a skewed wall clock cannot steal a live lease (the stamp
is read only for change); a leader that cannot renew steps down once a
lease duration has passed since its last good renewal. ``release``
demotes first, then clears the holder, so two leaders never overlap.
``step()`` is one attempt and the transition it justifies; ``run()``
loops it (every ``renew_period_s`` while leading, twice as often while
not) until stopped and releases on the way out; ``start`` / ``stop`` run
it on a thread; ``wait_for_leadership`` waits on a deadline. Both clocks
are injected (``monotonic``, ``wall_clock``), ``time``'s by default.
"""
from __future__ import annotations

import logging
import threading
import time
from typing import Callable, Optional

from nos_tpu_torch.kube.objects import ConfigMap
from nos_tpu_torch.kube.store import AlreadyExistsError, ConflictError, NotFoundError
from nos_tpu_torch.util import metrics

log = logging.getLogger("nos_tpu_torch.leaderelection")

HOLDER_ANNOTATION = "nos.nebuly.com/leader-holder"
RENEW_ANNOTATION = "nos.nebuly.com/leader-renew-time"


class _HeldByOther(Exception):
    def __init__(self, holder: str) -> None:
        super().__init__(f"lease held by {holder}")
        self.holder = holder


class LeaderElector:
    def __init__(self, store, name: str, identity: str, namespace: str = "nos-system",
                 lease_duration_s: float = 15.0, renew_period_s: float = 5.0,
                 on_started_leading: Optional[Callable[[], None]] = None,
                 on_stopped_leading: Optional[Callable[[], None]] = None,
                 monotonic: Callable[[], float] = time.monotonic,
                 wall_clock: Callable[[], float] = time.time) -> None:
        self.store = store
        self.name = name
        self.identity = identity
        self.namespace = namespace
        self.lease_duration_s = lease_duration_s
        self.renew_period_s = renew_period_s
        self.on_started_leading = on_started_leading
        self.on_stopped_leading = on_stopped_leading
        self.monotonic = monotonic
        self.wall_clock = wall_clock
        self.is_leader = False
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # one attempt and its transition against a release from another
        # thread (a release landing mid-renew would re-promote after it)
        self._lease_lock = threading.Lock()
        # (holder, stamp, when first seen on our clock): the skew-free age
        self._observed: Optional[tuple] = None
        self._last_renew_ok = 0.0

    # -------------------------------------------------------------- lease

    def _try_acquire_or_renew(self) -> bool:
        now = self.monotonic()

        def mutate(cm: ConfigMap) -> None:
            holder = cm.annotations.get(HOLDER_ANNOTATION, "")
            renew = cm.annotations.get(RENEW_ANNOTATION, "")
            if holder and holder != self.identity:
                observed = self._observed
                if observed is None or observed[0] != holder or observed[1] != renew:
                    self._observed = (holder, renew, now)  # fresh activity
                    raise _HeldByOther(holder)
                if now - observed[2] < self.lease_duration_s:
                    raise _HeldByOther(holder)
                # no renewal for a whole lease on our clock: expired
            cm.annotations[HOLDER_ANNOTATION] = self.identity
            cm.annotations[RENEW_ANNOTATION] = str(self.wall_clock())

        try:
            self.store.patch_merge("ConfigMap", self.name, self.namespace, mutate)
            return True
        except _HeldByOther as e:
            log.debug("lease %s held by %s", self.name, e.holder)
            return False
        except ConflictError:
            return False
        except NotFoundError:
            pass
        try:
            self.store.create(ConfigMap(self.name, self.namespace, annotations={
                HOLDER_ANNOTATION: self.identity, RENEW_ANNOTATION: str(self.wall_clock())}))
            return True
        except AlreadyExistsError:
            return False

    def release(self) -> None:
        """Drop the lease: demote, then clear the holder so the next
        challenger acquires at once."""
        def mutate(cm: ConfigMap) -> None:
            if cm.annotations.get(HOLDER_ANNOTATION) != self.identity:
                raise _HeldByOther(cm.annotations.get(HOLDER_ANNOTATION, ""))
            cm.annotations[HOLDER_ANNOTATION] = ""
            cm.annotations[RENEW_ANNOTATION] = "0"

        with self._lease_lock:
            if self.is_leader:
                self.is_leader = False
                log.info("lease %s: %s released leadership", self.name, self.identity)
                if self.on_stopped_leading:
                    self.on_stopped_leading()
            try:
                self.store.patch_merge("ConfigMap", self.name, self.namespace, mutate)
            except (_HeldByOther, NotFoundError, ConflictError):
                pass
            except Exception as e:  # noqa: BLE001 - a release never raises
                log.warning("lease %s: release failed: %s", self.name, e)

    # --------------------------------------------------------------- loop

    def step(self) -> bool:
        """One attempt and the transition it justifies; is_leader after."""
        with self._lease_lock:
            try:
                got = self._try_acquire_or_renew()
            except Exception as e:  # noqa: BLE001 - the elector survives the store
                log.warning("lease %s: renew attempt failed: %s: %s", self.name,
                            type(e).__name__, e)
                got = (self.is_leader
                       and self.monotonic() - self._last_renew_ok < self.lease_duration_s)
            else:
                if got:
                    self._last_renew_ok = self.monotonic()
            if got and not self.is_leader:
                # the count first: a waiter never sees is_leader without it
                metrics.LEADER_TRANSITIONS.inc()
                self.is_leader = True
                log.info("lease %s: %s became leader", self.name, self.identity)
                if self.on_started_leading:
                    self.on_started_leading()
            elif not got and self.is_leader:
                self.is_leader = False
                log.warning("lease %s: %s lost leadership", self.name, self.identity)
                if self.on_stopped_leading:
                    self.on_stopped_leading()
            return self.is_leader

    def run(self, stop: Optional[threading.Event] = None) -> None:
        stop = stop or self._stop
        while not stop.is_set():
            self.step()
            stop.wait(self.renew_period_s if self.is_leader else self.renew_period_s / 2)
        if self.is_leader:
            self.release()

    def start(self) -> None:
        self._thread = threading.Thread(target=self.run, name=f"leader-elector-{self.name}",
                                        daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=2.0)

    def wait_for_leadership(self, timeout: float = 60.0) -> bool:
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            if self.is_leader:
                return True
            time.sleep(0.02)
        return self.is_leader
