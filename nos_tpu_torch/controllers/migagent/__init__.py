"""The MIG node agent: counterpart of ``nos_tpu/controllers/tpuagent``
and ``nos_tpu/cmd/tpuagent.py:27`` (``build_tpuagent``; reference
cmd/migagent/migagent.go:56-199).

``MigReporter`` publishes the node's MIG devices as status annotations;
``MigActuator`` turns spec annotations into instances destroyed and
created through ``GpuClient`` and restarts the device plugin; they meet
in ``SharedState``. The port has no controller manager and no watches,
so ``MigAgent`` polls: each ``step()`` reports, then actuates, and an
apply listener reports at once after every apply, so a plan's ack lands
in the same step. ``start()`` runs the steps every ``interval`` seconds
on a thread of its own until ``stop()``.

``build_migagent`` refuses a GPU whose MIG mode is off
(``NvmlMigClient.require_mig_enabled``): NVML answers its MIG queries
with "Not Supported", and no report may read that as a GPU without
instances (the reference's agent likewise checks for a MIG GPU at
start, migagent.go:165-199).
"""
from __future__ import annotations

import logging
import threading
from typing import Optional

from nos_tpu_torch.controllers.migagent.actuator import MigActuator
from nos_tpu_torch.controllers.migagent.reporter import MigReporter
from nos_tpu_torch.controllers.migagent.shared import SharedState
from nos_tpu_torch.device.client import GpuClient
from nos_tpu_torch.kube.store import NodeStore

log = logging.getLogger("nos_tpu_torch.migagent")


class MigAgent:
    """One node's reporter and actuator, polled."""

    def __init__(self, shared: SharedState, reporter: MigReporter, actuator: MigActuator,
                 interval: float) -> None:
        self.shared = shared
        self.reporter = reporter
        self.actuator = actuator
        self.interval = interval
        self.error: Optional[BaseException] = None
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def step(self) -> None:
        self.reporter.reconcile()
        self.actuator.reconcile()

    def _loop(self) -> None:
        while not self._stop.is_set():
            try:
                self.step()
            except Exception as e:  # the loop goes on; the caller reads .error
                log.exception("migagent step failed")
                self.error = e
            self._stop.wait(self.interval)

    def start(self) -> None:
        self._stop.clear()
        self._thread = threading.Thread(target=self._loop, name="migagent", daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join()
            self._thread = None


def build_migagent(store: NodeStore, node_name: str, client: GpuClient, device_plugin,
                   interval: float = 10.0) -> MigAgent:
    """The agent of ``node_name`` over ``client`` (NVML's or the sim's)
    and ``device_plugin`` (``restart(node)``). Raises
    ``MigModeDisabledError`` when a GPU of an NVML client has MIG off."""
    require = getattr(client.device_client, "require_mig_enabled", None)
    if require is not None:
        require()
    shared = SharedState()
    reporter = MigReporter(store, client, node_name, shared)
    actuator = MigActuator(store, client, device_plugin, node_name, shared)
    shared.add_apply_listener(lambda _plan_id: reporter.reconcile())
    return MigAgent(shared, reporter, actuator, interval)


__all__ = ["MigActuator", "MigAgent", "MigReporter", "SharedState", "build_migagent"]
