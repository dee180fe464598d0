"""The port's observability (`obs.{events, tracer, timeline, export}`, the
engine's tracer hooks, the fleet's recovery events, `roofline.kv_bytes`)
vs the JAX reference.

Both sides serve the same traces with the same parameters (the
reference's `init_params` on `tiny_serving_config()`, bridged), under
`PrecisionConfig()` (W8A8 linears, an FP8 KV cache), greedy with
`eos_id=None`, so every event is a function of the schedule alone and
the event streams must be equal, field for field (modeled HBM bytes
included):

* one engine on a KV-starved ondemand trace (swap-outs, swap-ins, a host
  tier, chunked prefill);
* a fleet of three traced replicas with a fleet tracer: a weight push
  that one replica can never install (three retries, then quarantine and
  failover), a transient crash and rejoin, and a deadline abort.

On the port's runs: every step's event sums reconcile with its
`ScheduleDecision.accounting()`, `NULL_TRACER` and `StepTracer` give the
same tokens and stats bit for bit, timelines and their percentiles equal
the reference's and numpy's (linear interpolation, within 1e-9
relative), Chrome traces equal the reference's and keep its schema, and
events survive a JSON / JSONL round trip.  Last, the launchers' flags:
`launch.train --metrics-out / --run-id` and `launch.serve`'s fleet,
trace and chaos flags, with per-token version attribution read back from
the event log.

The reference's model calls run jitted, as in test_torch_fleet.py.
"""
import json
import re
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")
# tiny tensors: one intra-op thread, so torch's thread pool does not
# spin on the cores that the other test workers use (and the port's CPU
# runs stay bit-exact against themselves)
torch.set_num_threads(1)

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro import obs as jobs  # noqa: E402
from repro import serving as jserving  # noqa: E402
from repro.core import precision as jp  # noqa: E402
from repro.data import tasks as jtasks  # noqa: E402
from repro.models import init_params  # noqa: E402
from repro.rl import weight_sync as jws  # noqa: E402
from repro.serving import engine as jengine_mod  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import obs as tobs  # noqa: E402
from repro_torch import serving as tserving  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.core import precision as tp  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.launch import train as tlaunch  # noqa: E402
from repro_torch.roofline import kv_bytes  # noqa: E402
from repro_torch.rl import weight_sync as tws  # noqa: E402

jax.config.update("jax_platform_name", "cpu")

PRECISION = (jp.PrecisionConfig(), tp.PrecisionConfig())
PCT_RTOL = 1e-9
FLEET_KINDS = {"replica_down", "replica_up", "redispatch", "push_retry", "quarantine",
               "abort", "fleet_gauge"}


@pytest.fixture(scope="module")
def jit_reference():
    """The reference engine's `decode_step` and `prefill_chunk` jitted for
    this module (undone after it)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jengine_mod, "decode_step", jax.jit(
            jengine_mod.decode_step, static_argnums=(3, 4),
            static_argnames=("want_routing", "use_kernel")))
        mp.setattr(jengine_mod, "prefill_chunk", jax.jit(
            jengine_mod.prefill_chunk, static_argnums=(5, 6),
            static_argnames=("use_kernel", "want_all_logits")))
        yield


@pytest.fixture(scope="module")
def setup(jit_reference):
    jcfg, tcfg = jconfigs.tiny_serving_config(), tconfigs.tiny_serving_config()
    params = init_params(jcfg, jax.random.key(0))
    rolls = []
    for scale in (1.0, 1.1):
        p = params if scale == 1.0 else jax.tree.map(lambda x: x * scale, params)
        rolls.append((jws.sync_policy_weights(p, PRECISION[0])[0],
                      tws.sync_policy_weights(params_from_numpy(
                          jax.tree.map(np.asarray, p), "cpu"), PRECISION[1])[0]))
    return jcfg, tcfg, rolls


def _side(setup, side):
    jcfg, tcfg, rolls = setup
    port = side == "port"
    return dict(mod=tserving if port else jserving, obs=tobs if port else jobs,
                cfg=tcfg if port else jcfg, rolls=[r[port] for r in rolls],
                prec=PRECISION[port], extra={"device": "cpu"} if port else {})


def _ledger(eng, log):
    step = eng.step

    def wrapped():
        decision = step()
        log.append(decision.accounting())
        return decision

    eng.step = wrapped


def _engine_run(setup, side, tracer="step"):
    """One engine, KV-starved: ondemand admission, lru eviction, a host
    tier, 8-token chunks (the fleet's engine shapes: one compile of the
    reference's steps for the module)."""
    s = _side(setup, side)
    per = s["mod"].kv_bytes_per_token(s["cfg"], s["prec"])
    tr = s["obs"].StepTracer() if tracer == "step" else s["obs"].NULL_TRACER
    eng = s["mod"].ServingEngine(
        s["rolls"][0], s["cfg"], s["prec"], max_slots=2, max_seq_len=48,
        kv_budget_bytes=per * 4 * 6, admission="ondemand", eviction="lru",
        host_kv_blocks=4, prefill_chunk=8, eos_id=None, kernel_config="all",
        tracer=tr, **s["extra"])
    log = []
    _ledger(eng, log)
    for i in range(5):
        eng.submit(jtasks.random_prompt(i, 5 + 2 * i), max_new=5, rid=i)
    while eng.queue or any(r is not None for r in eng.slot_req):
        eng.step()
    report = eng.run()
    return dict(eng=eng, tracer=tr, ledgers=[log], report=report,
                tokens={r.rid: list(map(int, r.generated)) for r in eng.done})


def _fleet_run(setup, side, tight=False):
    """Three traced replicas and a fleet tracer: replica 2 can never take
    version 1 (3 attempts, then quarantine), replica 1 crashes at its step
    1 and rejoins 2 fleet steps later, rid 6's deadline passes.  `tight`:
    the engine run's KV budget and ondemand admission, so replicas swap."""
    s = _side(setup, side)
    mod = s["mod"]
    inj = mod.FaultInjector(mod.FaultPlan(
        crashes=(mod.CrashFault(replica=1, step=1, transient=True, down_steps=2),),
        installs=(mod.InstallFault(replica=2, version=1, times=-1),)))
    budget = None if not tight else \
        mod.kv_bytes_per_token(s["cfg"], s["prec"]) * 4 * 6
    engines = [mod.ServingEngine(
        s["rolls"][0], s["cfg"], s["prec"], max_slots=2, max_seq_len=48,
        kv_budget_bytes=budget, admission="ondemand" if tight else "reserve",
        prefill_chunk=8, eos_id=None, kernel_config="all", temperature=0.0, seed=i,
        faults=inj, tracer=s["obs"].StepTracer(replica=i), **s["extra"])
        for i in range(3)]
    ledgers = [[] for _ in engines]
    for eng, log in zip(engines, ledgers):
        _ledger(eng, log)
    fe = mod.ServingFrontend(engines, tracer=s["obs"].StepTracer(replica=-1))
    for i in range(6):
        fe.submit(jtasks.random_prompt(i, 6 + i % 3), max_new=6, rid=i)
    fe.submit(jtasks.random_prompt(6, 6), max_new=30, rid=6, deadline_tokens=24)
    for _ in range(3):
        fe.step()
    fe.update_weights(s["rolls"][1], 1)
    while fe.has_work():
        fe.step()
    report = fe.run()
    return dict(fe=fe, ledgers=ledgers, report=report)


@pytest.fixture(scope="module")
def engine_runs(setup):
    return {side: _engine_run(setup, side) for side in ("ref", "port")}


@pytest.fixture(scope="module")
def fleet_runs(setup):
    return {side: _fleet_run(setup, side) for side in ("ref", "port")}


@pytest.fixture
def runs(engine_runs, fleet_runs):
    return {side: dict(engine=engine_runs[side], fleet=fleet_runs[side])
            for side in ("ref", "port")}


def _dicts(events):
    return [e.to_dict() for e in events]


def _all_events(run):
    if "fe" in run:
        return [e for eng in run["fe"].engines for e in eng.tracer.events] \
            + list(run["fe"].tracer.events)
    return list(run["tracer"].events)


# ---------------------------------------------------------------------------
# event streams vs the reference
# ---------------------------------------------------------------------------

def test_engine_events_match_reference_on_preemption_trace(engine_runs):
    ref, port = engine_runs["ref"], engine_runs["port"]
    assert _dicts(port["tracer"].events) == _dicts(ref["tracer"].events)
    assert port["ledgers"] == ref["ledgers"]
    kinds = {e.kind for e in port["tracer"].events}
    assert {"swap_out", "admit", "prefill", "decode", "grow", "finish"} <= kinds
    assert port["report"].latency == ref["report"].latency
    assert port["eng"].stats["swap_outs"] >= 1 and port["eng"].stats["swap_ins"] >= 1


def test_fleet_events_match_reference(fleet_runs):
    ref, port = fleet_runs["ref"], fleet_runs["port"]
    for te, je in zip(port["fe"].engines, ref["fe"].engines):
        assert _dicts(te.tracer.events) == _dicts(je.tracer.events)
    assert _dicts(port["fe"].tracer.events) == _dicts(ref["fe"].tracer.events)
    assert port["ledgers"] == ref["ledgers"]
    assert FLEET_KINDS <= {e.kind for e in port["fe"].tracer.events}
    rep, jrep = port["report"], ref["report"]
    assert rep.latency == jrep.latency and rep.replica_latency == jrep.replica_latency
    assert rep.push_retries == 3 and rep.quarantined_replicas == 1 and rep.aborted == 1
    assert rep.healthy_replicas == 2 and rep.redispatches >= 1
    red = [e for e in port["fe"].tracer.events if e.kind == "redispatch"]
    assert len(red) == rep.redispatches
    assert sum(e.replayed_tokens for e in red) == rep.replayed_tokens
    ups = [e for e in port["fe"].tracer.events if e.kind == "replica_up"]
    assert [(e.replica, e.version) for e in ups] == [(1, 1)]   # rejoined at v1


def test_growth_of_a_slot_swapped_out_in_the_same_plan(setup):
    """A fault of the reference's tracer the port repairs: a plan that
    grows a slot and then picks it as the swap-out victim leaves the slot
    empty when the growth executes (the scheduler moved its request at
    plan time), and the reference's `record_grow` reads the request's rid
    from it.  The port records no event for that void growth; its events
    still reconcile."""
    with pytest.raises(AttributeError, match="rid"):
        _fleet_run(setup, "ref", tight=True)
    run = _fleet_run(setup, "port", tight=True)
    assert sum(eng.stats["swap_outs"] for eng in run["fe"].engines) >= 1
    assert len(run["report"].outputs) == 7 and not run["report"].stalled
    for eng, ledger in zip(run["fe"].engines, run["ledgers"]):
        steps = [e for e in eng.tracer.events if e.kind == "step"]
        assert [{k: getattr(e, k) for k in acct} for e, acct in zip(steps, ledger)] \
            == ledger


def test_event_sums_reconcile_with_accounting(runs):
    """Per step of every port engine: the StepEvent is the decision's
    accounting, and its prefill/decode/swap events sum to it."""
    port = runs["port"]
    tracers = [port["engine"]["tracer"]] + [e.tracer for e in port["fleet"]["fe"].engines]
    ledgers = port["engine"]["ledgers"] + port["fleet"]["ledgers"]
    for tracer, ledger in zip(tracers, ledgers):
        steps = [e for e in tracer.events if e.kind == "step"]
        assert len(steps) == len(ledger)
        by_step = {}
        for e in tracer.events:
            by_step.setdefault(e.step, []).append(e)
        clock = 0.0
        for i, (se, acct) in enumerate(zip(steps, ledger)):
            assert se.clock_before == clock
            clock += se.cost_tokens
            assert {k: getattr(se, k) for k in acct} == acct
            evs = by_step[i]
            assert sum(e.cost_tokens for e in evs if e.kind == "prefill") \
                == acct["prefill_tokens"]
            assert sum(e.cost_tokens for e in evs if e.kind == "decode") \
                == acct["decode_tokens"]
            moved = sum(e.tokens_moved for e in evs if e.kind == "swap_out") \
                + sum(e.restored_tokens for e in evs if e.kind == "admit")
            assert moved == acct["swap_tokens"]
            assert sum(e.kind == "gauge" for e in evs) == 1
        assert tracer.clock == clock


def test_null_tracer_bit_exact_on_preemption_trace(setup, runs):
    traced = runs["port"]["engine"]
    plain = _engine_run(setup, "port", tracer="null")
    assert plain["eng"].tracer is tobs.NULL_TRACER
    assert plain["tokens"] == traced["tokens"]
    assert plain["eng"].stats == traced["eng"].stats
    assert traced["eng"].stats["preemptions"] >= 1
    assert plain["report"].latency is None
    assert traced["report"].latency["requests"] == 5
    assert traced["report"].latency["preempted_requests"] >= 1


def test_kv_geometry_and_bytes(runs):
    """The byte model on the engine's own layout: FP8 KV, one row a token,
    2 layers of 2 KV heads x 16."""
    eng = runs["port"]["engine"]["eng"]
    geo = kv_bytes.KVGeometry.from_engine(eng)
    assert geo == kv_bytes.KVGeometry(n_kv_heads=2, d_head=16, block_size=eng.block_size,
                                      table_width=eng.cache["block_tables"].shape[1],
                                      kv_elem_bytes=1, n_attn_layers=2)
    per = geo.token_payload_bytes * geo.n_attn_layers
    assert kv_bytes.decode_hbm_bytes(geo, 1) == geo.block_size * per
    assert kv_bytes.decode_hbm_bytes(geo, 10**6) == geo.table_width * geo.block_size * per
    assert kv_bytes.verify_hbm_bytes(geo, 5, 2) == kv_bytes.decode_hbm_bytes(geo, 8)
    # the gather path: the pool read, a contiguous copy written and read,
    # and a bf16 dequantized copy written and read
    tokens = geo.live_blocks(9) * geo.block_size
    assert kv_bytes.decode_hbm_bytes(geo, 9, mode="gather") == tokens * geo.n_attn_layers \
        * (3 * geo.token_payload_bytes + 2 * geo.token_bf16_bytes)


# ---------------------------------------------------------------------------
# schema, timelines, exports
# ---------------------------------------------------------------------------

def test_event_schema_roundtrip(runs):
    events = _all_events(runs["port"]["fleet"]) + _all_events(runs["port"]["engine"])
    assert tobs.EVENT_KINDS == jobs.EVENT_KINDS
    assert {e.kind for e in events} == set(tobs.EVENT_KINDS) - {"cow", "draft", "verify"}
    for e in events:
        assert tobs.event_from_dict(json.loads(json.dumps(e.to_dict()))) == e
    with pytest.raises(ValueError, match="unknown event kind"):
        tobs.event_from_dict({"kind": "nope", "step": 0})
    sub = next(e for e in events if e.kind == "step")
    row = dict(sub.to_dict(), replica=3, run_id="r")
    assert tobs.event_from_dict(row) == sub          # envelopes dropped


def test_percentile_matches_numpy():
    rng = np.random.default_rng(0)
    for seed in range(40):
        xs = rng.uniform(-1e6, 1e6, size=int(rng.integers(1, 41))).tolist()
        for q in (0.0, 12.5, 50.0, 95.0, 99.0, 100.0, float(rng.uniform(0, 100))):
            want = float(np.percentile(xs, q))
            assert tobs.percentile(xs, q) == pytest.approx(want, rel=PCT_RTOL, abs=1e-6)
            assert tobs.percentile(xs, q) == jobs.percentile(xs, q)
    assert np.isnan(tobs.percentile([], 50))
    assert tobs.percentile([7.0], 99) == 7.0


def test_timelines_match_reference_and_numpy(runs):
    for kind in ("engine", "fleet"):
        tev, jev = _all_events(runs["port"][kind]), _all_events(runs["ref"][kind])
        ttl, jtl = tobs.build_timelines(tev), jobs.build_timelines(jev)
        assert sorted(ttl) == sorted(jtl)
        for rid, t in ttl.items():
            j = jtl[rid]
            assert (t.queue_wait, t.ttft, t.tpot, t.preemptions, t.version_spans) \
                == (j.queue_wait, j.ttft, j.tpot, j.preemptions, j.version_spans)
        summary = tobs.summarize_timelines(ttl)
        assert summary == jobs.summarize_timelines(jtl)
        ttfts = [t.ttft for t in ttl.values() if t.ttft is not None]
        assert summary["ttft"]["p95"] == pytest.approx(np.percentile(ttfts, 95), rel=PCT_RTOL)
        tpots = [x for t in ttl.values() for x in t.tpot]
        assert summary["tpot"]["p50"] == pytest.approx(np.percentile(tpots, 50), rel=PCT_RTOL)
    spans = [t.version_spans for t in tobs.build_timelines(
        _all_events(runs["port"]["fleet"])).values()]
    assert any(len(s) == 2 for s in spans)           # a request spans versions


def test_chrome_trace_matches_reference_and_schema(runs):
    for i, (te, je) in enumerate(zip(runs["port"]["fleet"]["fe"].engines,
                                     runs["ref"]["fleet"]["fe"].engines)):
        doc = tobs.chrome_trace(te.tracer.events, replica=i)
        assert doc == jobs.chrome_trace(je.tracer.events, replica=i)
        rows = doc["traceEvents"]
        assert rows and {r["ph"] for r in rows} <= {"M", "X", "i", "C"}
        for r in rows:
            assert r["pid"] == i
            if r["ph"] == "X":
                assert r["dur"] >= 0 and "ts" in r and r["name"]
            elif r["ph"] == "C":
                assert isinstance(r["args"], dict) and r["args"]
        names = {r["name"] for r in rows}
        assert any(n.startswith("prefill") for n in names) and "kv blocks" in names
    json.dumps(runs["port"]["engine"]["tracer"].chrome_trace())


def test_jsonl_sink_and_event_log_roundtrip(runs, tmp_path):
    events = _all_events(runs["port"]["fleet"])
    path = tmp_path / "events.jsonl"
    assert tobs.write_events_jsonl(events, str(path)) == len(events)
    assert tobs.read_events_jsonl(str(path)) == events
    mpath = tmp_path / "metrics.jsonl"
    with tobs.JsonlSink(str(mpath), run_id="run-7") as sink:
        sink.write({"step": 1, "loss": 0.5})
        sink.write({"step": 2, "run_id": "kept"})
        assert sink.rows == 2
    assert tobs.read_metrics_jsonl(str(mpath)) == [
        {"step": 1, "loss": 0.5, "run_id": "run-7"}, {"step": 2, "run_id": "kept"}]


# ---------------------------------------------------------------------------
# the launchers' flags
# ---------------------------------------------------------------------------

def test_launch_train_metrics_out_and_run_id(tmp_path):
    path = tmp_path / "metrics.jsonl"
    rows = tlaunch.main(["--reduced", "--device", "cpu", "--steps", "1",
                         "--precision", "fp8-linear", "--prompt-batch", "2",
                         "--n-per-prompt", "2", "--max-new-tokens", "4",
                         "--metrics-out", str(path), "--run-id", "job-3"])
    got = tobs.read_metrics_jsonl(str(path))
    assert [r["step"] for r in got] == [1] and got[0]["run_id"] == "job-3"
    assert got[0]["loss"] == rows[0]["loss"] and "corr_weight_ess" in got[0]


def _token_versions_from_events(events):
    """rid -> versions of its tokens as the events saw them produced, and
    whether each token's version is the last one its replica installed."""
    installed, out, ok = {}, {}, True
    for e in sorted(events, key=lambda e: (e["replica"], e["step"])):
        rep = e["replica"]
        if e["kind"] == "weights" and not e["staged"]:
            installed[rep] = e["version"]
        elif e["kind"] == "prefill" and e["last"] or e["kind"] == "decode":
            rids = [e["rid"]] if e["kind"] == "prefill" else e["rids"]
            for rid in rids:
                out.setdefault(rid, []).append(e["version"])
            ok &= e["version"] == installed.get(rep, 0)
    return out, ok


def test_launch_serve_fleet_trace_and_chaos_flags(tmp_path):
    ev, tr = tmp_path / "events.jsonl", tmp_path / "trace.json"
    base = ["--reduced", "--device", "cpu", "--prefill-chunk", "4", "--requests", "6",
            "--max-new", "8", "--slots", "3", "--replicas", "2"]
    out = tserve.run(base + ["--update-every", "3", "--events-out", str(ev),
                             "--trace-out", str(tr), "--run-id", "serve-1"])
    assert out["completed"] == 6 and not out["stalled"]
    rows = [json.loads(line) for line in ev.read_text().splitlines()]
    assert all(r["run_id"] == "serve-1" for r in rows)
    versions, ok = _token_versions_from_events(rows)
    assert ok                                        # exact attribution
    assert any(len(set(v)) >= 2 for v in versions.values())
    assert sorted({x for v in versions.values() for x in v}) == out["versions_seen"]
    assert out["weight_version"] == max(out["versions_seen"]) >= 2
    assert {r["pid"] for r in json.loads(tr.read_text())["traceEvents"]} == {0, 1}

    crash = tserve.run(base + ["--crash-replica", "0", "--crash-step", "2"])
    chaos = crash["chaos"]
    assert chaos["injected"]["crashes"] == 1 and chaos["redispatches"] >= 1
    assert chaos["healthy_replicas"] == 1 and crash["completed"] == 6
    seeded = tserve.run(base + ["--chaos-seed", "3", "--crash-down-steps", "1"])
    assert seeded["chaos"]["injected"]["crashes"] == 1 and seeded["completed"] == 6

    for bad in (["--chaos-seed", "1", "--crash-replica", "0"],
                ["--replicas", "1", "--crash-replica", "0"],
                ["--shrink-at", "2"], ["--crash-replica", "2"]):
        with pytest.raises(SystemExit):
            tserve.run(base + bad)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tserve.run(["--reduced", "--replicas", "2"])


def test_port_and_chip_smoke_import_no_jax_and_nothing_of_repro():
    """Every module of the port and `chip_smoke.py` (read as text): no
    import of `jax` or of the JAX package `repro`."""
    root = Path(__file__).resolve().parents[1]
    files = sorted((root / "src" / "repro_torch").rglob("*.py")) + [root / "chip_smoke.py"]
    pattern = re.compile(r"^\s*(?:import|from)\s+(?:jax|jaxlib|repro)(?:\.|\s|$)", re.M)
    assert len(files) > 40
    bad = {str(f.relative_to(root)): pattern.findall(f.read_text()) for f in files}
    assert not {k: v for k, v in bad.items() if v}
