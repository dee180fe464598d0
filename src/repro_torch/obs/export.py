"""Event-stream exporters: JSONL metrics sink + Chrome trace-event JSON
(port of `repro.obs.export`, unchanged: json only).

Two output shapes, one event schema:

- **JSONL** (`JsonlSink`, `write_events_jsonl` / `read_events_jsonl`):
  one `Event.to_dict()` row per line.  Lossless — `read_events_jsonl`
  reconstructs the typed events via `event_from_dict`, so any analysis
  that runs on a live `StepTracer` runs identically on a saved trace.
  The same sink class carries the trainer's per-step RL metrics stream
  (plain dicts: loss/clip-fraction/ESS/per-version mismatch-KL rows).

- **Chrome trace-event** (`chrome_trace`): the Perfetto-loadable
  ``{"traceEvents": [...]}`` format.  The token-unit clock maps to
  microseconds (`ts`/`dur`); pid = replica, tid = slot.  Work items
  (prefill / verify / decode) are ``"X"`` complete events spanning their
  step, lifecycle markers (submit / admit / swap / weights / finish) are
  ``"i"`` instants, and pool gauges are ``"C"`` counter tracks.
"""
from __future__ import annotations

import json
from typing import IO, Iterable, List, Optional, Union

from repro_torch.obs import events as ev


class JsonlSink:
    """Append-only JSONL metrics sink (one JSON object per line).

    Accepts a path (opened lazily, closed by `close()`/context exit) or
    an already-open file object (left open — caller owns it).

    `run_id` (optional) is stamped onto every row as a top-level
    ``run_id`` key: launching the trainer's metrics sink and the serving
    fleet's event sink with the SAME id makes a trainer step joinable to
    the serving steps that produced its rollout batch by one equality on
    the two streams.  Rows that already carry a ``run_id`` keep theirs
    (merged logs stay faithful); `obs.events.event_from_dict` drops the
    key as envelope, like ``replica``.
    """

    def __init__(self, path_or_file: Union[str, IO],
                 run_id: Optional[str] = None):
        if hasattr(path_or_file, "write"):
            self._f: Optional[IO] = path_or_file
            self._owns = False
        else:
            self._f = open(path_or_file, "w")
            self._owns = True
        self.run_id = run_id
        self.rows = 0

    def write(self, row: dict) -> None:
        assert self._f is not None, "sink is closed"
        if self.run_id is not None and "run_id" not in row:
            row = dict(row, run_id=self.run_id)
        self._f.write(json.dumps(row) + "\n")
        self.rows += 1

    def close(self) -> None:
        if self._owns and self._f is not None:
            self._f.close()
        self._f = None

    def __enter__(self) -> "JsonlSink":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def write_events_jsonl(events: Iterable[ev.Event], path: str) -> int:
    """Dump typed events to a JSONL file; returns the row count."""
    with JsonlSink(path) as sink:
        for e in events:
            sink.write(e.to_dict())
        return sink.rows


def read_events_jsonl(path: str) -> List[ev.Event]:
    """Load a JSONL event file back into typed events (exact inverse of
    `write_events_jsonl` for every kind in `obs.events.EVENT_KINDS`)."""
    out: List[ev.Event] = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                out.append(ev.event_from_dict(json.loads(line)))
    return out


def read_metrics_jsonl(path: str) -> List[dict]:
    """Load a plain metrics JSONL stream (trainer sink) as dicts."""
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


def _span(name: str, cat: str, pid: int, tid: int, ts: float, dur: float,
          args: dict) -> dict:
    return {"name": name, "cat": cat, "ph": "X", "pid": pid, "tid": tid,
            "ts": float(ts), "dur": float(max(dur, 0.001)), "args": args}


def _instant(name: str, cat: str, pid: int, tid: int, ts: float,
             args: dict) -> dict:
    return {"name": name, "cat": cat, "ph": "i", "s": "t", "pid": pid,
            "tid": tid, "ts": float(ts), "args": args}


def chrome_trace(events: List[ev.Event], replica: int = 0) -> dict:
    """Render an event stream as Chrome trace-event JSON.

    One token-clock unit = 1 us.  Work spans cover their whole step (the
    fused trace retires at once); per-kind args carry the token/byte
    accounting so Perfetto's slice pane shows the decision numbers.
    """
    step_start = {e.step: e.clock_before for e in events
                  if isinstance(e, ev.StepEvent)}
    step_dur = {e.step: e.cost_tokens for e in events
                if isinstance(e, ev.StepEvent)}

    def ts(step: int) -> float:
        return step_start.get(step, float(step))

    def dur(step: int) -> float:
        return step_dur.get(step, 1.0)

    pid = replica
    rows: List[dict] = [
        {"name": "process_name", "ph": "M", "pid": pid,
         "args": {"name": f"replica {replica}"}},
    ]
    for e in events:
        if isinstance(e, ev.PrefillEvent):
            rows.append(_span(
                f"prefill[{e.start}:{e.end}] r{e.rid}", "prefill", pid,
                e.slot, ts(e.step), dur(e.step),
                {"rid": e.rid, "cost_tokens": e.cost_tokens,
                 "hbm_bytes": e.hbm_bytes, "last": e.last,
                 "version": e.version}))
        elif isinstance(e, ev.VerifyEvent):
            rows.append(_span(
                f"verify k={e.k} r{e.rid}", "spec", pid, e.slot,
                ts(e.step), dur(e.step),
                {"rid": e.rid, "accepted": e.accepted,
                 "committed": e.committed, "cost_tokens": e.cost_tokens,
                 "hbm_bytes": e.hbm_bytes}))
        elif isinstance(e, ev.DraftEvent):
            rows.append(_instant(f"draft k={e.k} r{e.rid}", "spec", pid,
                                 e.slot, ts(e.step), {"rid": e.rid}))
        elif isinstance(e, ev.DecodeEvent):
            for slot, rid, ctx in zip(e.slots, e.rids, e.contexts):
                rows.append(_span(
                    f"decode r{rid}", "decode", pid, slot, ts(e.step),
                    dur(e.step),
                    {"rid": rid, "context": ctx, "version": e.version}))
        elif isinstance(e, ev.SubmitEvent):
            rows.append(_instant(f"submit r{e.rid}", "lifecycle", pid, 0,
                                 e.clock, {"rid": e.rid,
                                           "prompt_len": e.prompt_len}))
        elif isinstance(e, ev.AdmitEvent):
            name = "swap_in" if e.swap_in else "admit"
            rows.append(_instant(
                f"{name} r{e.rid}", "lifecycle", pid, e.slot, ts(e.step),
                {"rid": e.rid, "n_blocks": e.n_blocks,
                 "n_shared": e.n_shared,
                 "restored_tokens": e.restored_tokens}))
        elif isinstance(e, ev.SwapOutEvent):
            rows.append(_instant(
                f"swap_out r{e.rid}", "lifecycle", pid, e.slot,
                ts(e.step),
                {"rid": e.rid, "tokens_moved": e.tokens_moved}))
        elif isinstance(e, ev.FinishEvent):
            rows.append(_instant(
                f"finish r{e.rid}", "lifecycle", pid, 0, ts(e.step),
                {"rid": e.rid, "n_tokens": e.n_tokens}))
        elif isinstance(e, ev.WeightsEvent):
            rows.append(_instant(
                f"weights v{e.version}" + (" staged" if e.staged else ""),
                "weights", pid, 0, e.clock,
                {"version": e.version, "staged": e.staged}))
        elif isinstance(e, ev.ReplicaDownEvent):
            rows.append(_instant(
                f"replica_down r{e.replica} ({e.reason})", "fault",
                e.replica, 0, e.clock,
                {"replica": e.replica, "transient": e.transient,
                 "reason": e.reason}))
        elif isinstance(e, ev.ReplicaUpEvent):
            rows.append(_instant(
                f"replica_up r{e.replica} v{e.version}", "fault",
                e.replica, 0, e.clock,
                {"replica": e.replica, "version": e.version}))
        elif isinstance(e, ev.RedispatchEvent):
            rows.append(_instant(
                f"redispatch r{e.rid} {e.src_replica}->{e.dst_replica}",
                "fault", e.dst_replica, 0, e.clock,
                {"rid": e.rid, "src": e.src_replica, "dst": e.dst_replica,
                 "replayed_tokens": e.replayed_tokens}))
        elif isinstance(e, ev.PushRetryEvent):
            rows.append(_instant(
                f"push_retry r{e.replica} v{e.version} #{e.attempt}",
                "fault", e.replica, 0, e.clock,
                {"replica": e.replica, "version": e.version,
                 "attempt": e.attempt}))
        elif isinstance(e, ev.QuarantineEvent):
            rows.append(_instant(
                f"quarantine r{e.replica} v{e.version}", "fault",
                e.replica, 0, e.clock,
                {"replica": e.replica, "version": e.version}))
        elif isinstance(e, ev.AbortEvent):
            rows.append(_instant(
                f"abort r{e.rid} ({e.reason})", "fault", e.replica, 0,
                e.clock,
                {"rid": e.rid, "reason": e.reason,
                 "n_tokens": e.n_tokens}))
        elif isinstance(e, ev.FleetGaugeEvent):
            rows.append({"name": "fleet health", "ph": "C", "pid": pid,
                         "ts": float(e.clock),
                         "args": {"healthy": e.healthy_replicas,
                                  "quarantined": e.quarantined}})
            rows.append({"name": "failover", "ph": "C", "pid": pid,
                         "ts": float(e.clock),
                         "args": {"redispatches": e.redispatches,
                                  "replayed_tokens": e.replayed_tokens,
                                  "aborted": e.aborted}})
        elif isinstance(e, ev.GaugeEvent):
            rows.append({"name": "kv blocks", "ph": "C", "pid": pid,
                         "ts": float(e.clock),
                         "args": {"in_use": e.blocks_in_use,
                                  "free": e.blocks_free,
                                  "cached": e.blocks_cached,
                                  "state": e.state_block_equiv}})
            rows.append({"name": "pressure", "ph": "C", "pid": pid,
                         "ts": float(e.clock),
                         "args": {"kv_pressure": e.kv_pressure,
                                  "queue": e.queue_len}})
    return {"traceEvents": rows,
            "displayTimeUnit": "ms",
            "otherData": {"clock": "token-units (1 unit = 1us)"}}
