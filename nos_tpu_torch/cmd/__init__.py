"""The components: counterpart of ``nos_tpu/cmd/``.

Each ``build_*`` wires one component's controllers onto a ``Manager``
with the reference's watches, as each reference binary's ``main()``
does (SURVEY.md §2.1): ``scheduler``, ``operator``, ``partitioner``,
``autoscaler``, ``migagent`` and ``mpsagent`` (the reference's
``tpuagent`` and ``sharingagent``). ``_component.run_component`` runs one
as a process (``python -m nos_tpu_torch <component> --config <file>``):
its store, its health server, leader election, until SIGTERM.
``cluster.build_cluster`` runs them all threaded on one store, and
``run.main`` is ``python -m nos_tpu_torch run``. Nothing here imports
torch. ``SimCluster`` (``nos_tpu_torch/cluster.py``) keeps its polled
loop beside them.
"""
