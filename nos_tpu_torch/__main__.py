"""``python -m nos_tpu_torch <command> [args]``: counterpart of
``nos_tpu/__main__.py``.

The reference's binaries (SURVEY.md §2.1) in H100 terms: ``run`` starts
the whole suite in one process; ``operator``, ``partitioner``,
``scheduler``, ``autoscaler``, ``migagent`` and ``mpsagent`` each run one
component (``--config <file>``); ``export-metrics`` is the one-shot
telemetry job; ``replay`` re-runs a flight-recorder log
(``cmd/replay.py``); ``bench`` runs ``nos_tpu_torch/bench.py``. The
reference's ``chaos`` comes with item 18b.3.
"""
import importlib
import sys

COMMANDS = {
    "run": "the whole suite in one process (operator, partitioner, scheduler, agents)",
    "operator": "the ElasticQuota / CompositeElasticQuota controllers and their webhooks",
    "partitioner": "the MIG and MPS dynamic partitioner",
    "scheduler": "the quota-, gang- and topology-aware scheduler",
    "autoscaler": "the SLO-driven ModelServing replica controller",
    "migagent": "a MIG node's reporter and actuator (NODE_NAME)",
    "mpsagent": "an MPS node's reporter (NODE_NAME)",
    "export-metrics": "the one-shot installation telemetry snapshot",
    "replay": "re-run a flight-recorder log and diff its decisions",
    "bench": "the model and control-plane benchmark (nos_tpu_torch/bench.py)",
}
MODULES = {"run": "run", "operator": "operator", "partitioner": "partitioner",
           "scheduler": "scheduler", "autoscaler": "autoscaler", "migagent": "migagent",
           "mpsagent": "mpsagent", "export-metrics": "metricsexporter", "replay": "replay"}


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    if not argv or argv[0] in ("-h", "--help"):
        print("usage: python -m nos_tpu_torch <command> [args]\n\ncommands:")
        for name, text in COMMANDS.items():
            print(f"  {name:16s} {text}")
        return 0 if argv else 2
    command, rest = argv[0], argv[1:]
    if command in MODULES:
        module = importlib.import_module(f"nos_tpu_torch.cmd.{MODULES[command]}")
        return module.main(rest)
    if command == "bench":
        from nos_tpu_torch import bench

        return bench.main(rest)
    print(f"unknown command {command!r}; see --help", file=sys.stderr)
    return 2


if __name__ == "__main__":
    sys.exit(main())
