"""``python -m nos_tpu_torch replay <record.jsonl>``: offline replay.

Counterpart of ``nos_tpu/cmd/replay.py``. Loads a flight-recorder JSONL
export (``run --record``'s, or ``/debug/record?format=jsonl``), rebuilds
the cluster from the recorded writes, re-runs every scheduler cycle,
plan and ledger observation on the state it saw, audits every replayed
plan exhaustively (``record/replay.py``), prints the report and the
replay's host seconds. Exit 0: no drift and no audit violation; 1
otherwise (the report names each); 2: the file could not be read, holds
no record, or its ring wrapped (it lost its session header: "log wrapped
at seq N").
"""
from __future__ import annotations

import argparse
import logging
import sys


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="python -m nos_tpu_torch replay",
                                     description="replay a flight-recorder log and diff "
                                                 "its decisions")
    parser.add_argument("record", help="the JSONL flight-recorder export")
    parser.add_argument("-v", "--verbose", action="count", default=0)
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.DEBUG if args.verbose else logging.WARNING,
                        format="%(asctime)s %(name)s %(levelname)s %(message)s")

    from nos_tpu_torch.record import ReplaySession, drift_exit_code, load_jsonl
    from nos_tpu_torch.record.replay import LogWrapped

    try:
        records = load_jsonl(args.record)
    except OSError as exc:
        print(f"cannot read {args.record}: {exc}", file=sys.stderr)
        return 2
    if not records:
        print(f"{args.record}: no records", file=sys.stderr)
        return 2
    try:
        session = ReplaySession(records)
    except LogWrapped as exc:
        print(f"{args.record}: {exc}", file=sys.stderr)
        return 2
    report = session.run()
    print(report.render())
    print(f"replay took {report.seconds:.3f} s on the host, {report.audit_seconds:.3f} s of "
          "it auditing")
    return drift_exit_code(report)


if __name__ == "__main__":
    sys.exit(main())
