#!/usr/bin/env python3
"""The wall time of the CPU test suite under `pytest -n 6 --dist load`,
replayed from one run's per-test durations on another collection.

pytest-xdist's `load` scheduler (3.8, `xdist/scheduler/load.py`) hands
each worker a first chunk of len(collection) // (4 * workers) consecutive
tests, then refills a worker whose queue runs short with up to
len(pending) // (2 * workers) more, in collection order, and never moves
a queued test to an idle worker.  So the number of tests collected decides
which long reference tests share one worker's queue: a few tests more or
less can move the suite's wall by hundreds of seconds.  This replays that
rule, test by test, with the durations of a junit XML:

    PYTHONPATH=src python -m pytest --collect-only -q -p no:randomly \\
        | grep :: > ids.txt
    python3 tools/xdist_schedule.py ids.txt run.xml [run2.xml ...]

It prints, for each XML, the replayed wall and each worker's end (s).  A
test the XML lacks takes DEFAULT_S.  Fixture set-up is charged to the test
that ran it in the XML's run, and a crashed worker is not replayed.
"""
from __future__ import annotations

import heapq
import sys
import xml.etree.ElementTree as ET

WORKERS = 6
DEFAULT_S = 0.5


def durations(xml_path: str) -> dict:
    """Node id -> seconds (set-up, call and teardown) from a junit XML."""
    out = {}
    for case in ET.parse(xml_path).getroot().iter("testcase"):
        module = case.get("classname").replace(".", "/") + ".py"
        out[f"{module}::{case.get('name')}"] = float(case.get("time", 0))
    return out


def replay(ids: list, secs: dict, workers: int = WORKERS) -> list:
    """Each worker's end time under the `load` scheduler's rule."""
    cost = [secs.get(i, DEFAULT_S) for i in ids]
    pending = list(range(len(ids)))
    queues = [[] for _ in range(workers)]
    first = max(len(ids) // workers // 4, 2)
    for q in queues:
        q += pending[:first]
        del pending[:first]
    events = [(cost[q[0]], w) for w, q in enumerate(queues) if q]
    heapq.heapify(events)
    ends = [0.0] * workers
    while events:
        now, w = heapq.heappop(events)
        done = queues[w].pop(0)
        ends[w] = now
        if pending:
            low = max(2, len(pending) // workers // 4)
            high = max(2, len(pending) // workers // 2)
            q = queues[w]
            # a worker busy with long tests keeps its queue (xdist's rule)
            if len(q) < low and not (cost[done] >= 0.1 and len(q) >= 2):
                n = high - len(q)
                q += pending[:n]
                del pending[:n]
        if queues[w]:
            heapq.heappush(events, (now + cost[queues[w][0]], w))
    return ends


def main(argv: list) -> None:
    ids = [line.strip() for line in open(argv[0]) if "::" in line]
    for xml_path in argv[1:]:
        ends = replay(ids, durations(xml_path))
        print(f"{xml_path}: {len(ids)} tests, wall {max(ends):.1f} s, workers "
              f"{[round(e, 1) for e in ends]}")


if __name__ == "__main__":
    main(sys.argv[1:])
