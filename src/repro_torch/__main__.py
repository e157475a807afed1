"""``python -m repro_torch`` — the ported scheduling stack from the command
line, every subcommand of ``python -m repro`` with the same output.

Subcommands (all built on :mod:`repro_torch.api`; those that simulate take
``--device {cuda,cpu}``, default ``cuda``: the §4.6 reallocations run on
the card, and without one the command exits non-zero):

* ``policies``    — the policy surface: Table-1 grammar strings, registered
  component compositions, the component registry, the §6.1 space size.
* ``workloads``   — the registered workload kinds (the Trace-IR registry)
  with their knob contracts.
* ``scenarios``   — the named cluster-scenario transforms (composable with
  the ``+`` chain grammar).
* ``simulate``    — one (workload × policy × scenario) cell; prints the
  headline metrics (optionally against the Theorem-1 bound).
* ``sweep``       — a (workload × policy × period × scenario) grid across
  worker processes, with optional resumable on-disk record caching.
* ``session``     — a *streaming* simulation: drive an open
  :class:`repro_torch.sched.session.SimSession` from a JSONL event script
  (online submits, ``step_until``/``step``, live fail/join/period
  injection, snapshots) and stream per-step JSONL metrics out.  With
  ``--restore`` the session resumes from a saved snapshot bit-identically.
* ``tune``        — an *autotuned* session end to end: attach the
  fork-race-promote :class:`repro_torch.tune.AutoTuner` (periodically fork the
  live session, race a policy/period portfolio over a bounded sim-time
  horizon with successive halving, hot-swap the winner), optionally with
  a chaos narrator and a scripted rack failure; prints every decision.
  The ``session`` subcommand grows the same tuner via ``--autotune`` and
  a manual ``{"op": "tune"}`` trigger.
* ``trace-smoke`` — materialize every registered workload kind × every
  scenario at a small size and emit the content fingerprints (CI runs it
  in two processes and diffs the output).
* ``serve``       — the scheduler-as-a-service server: a long-lived
  multi-tenant :class:`SimSession` host (JSONL over TCP, stdlib only)
  with credit-based admission, weighted-DRF tenant fairness,
  snapshot-backed eviction and ``kill -9`` crash recovery (``--store``).
* ``client``      — drive named sessions on a running server from a JSONL
  script (the remote sibling of ``session``): ops carry a ``session``
  name, mutating ops are seq-stamped so re-driving a script after a
  server crash dedupes instead of double-applying.

The ``--workload`` argument accepts any registered kind, including the
``kind:<arg>`` spelling (``swf:<path>`` = a real Parallel Workloads Archive
log); ``--scenarios`` accepts ``+``-composed chains.

Examples::

    python -m repro_torch policies
    python -m repro_torch workloads
    python -m repro_torch simulate --policy "GreedyPM */per/OPT=MIN/MINVT=600" \\
        --workload lublin --jobs 100 --nodes 32 --load 0.7 --bound
    python -m repro_torch simulate --policy EASY --workload swf:tests/data/mini.swf \\
        --nodes 128 --scenario rack_failure+arrival_burst
    python -m repro_torch sweep --policies "FCFS,EASY,EASY+OPT=MIN" \\
        --workload lublin --jobs 60 --nodes 16 --seeds 0,1 \\
        --scenarios baseline,rack_failure+arrival_burst --workers 4 \\
        --out sweep.json --cache cache.json
    printf '%s\\n' \\
        '{"op": "submit", "workload": "lublin", "jobs": 50}' \\
        '{"op": "step_until", "t": 3600}' \\
        '{"op": "inject", "kind": "fail", "t": 4000, "nodes": [0, 1]}' \\
        '{"op": "snapshot", "path": "snap.json"}' \\
        '{"op": "run"}' '{"op": "result"}' \\
        | python -m repro_torch session --script - \\
              --policy "GreedyP */OPT=MIN" --nodes 32
    # chaos: seeded breakdown/cancel/noise streams, bit-reproducible
    printf '%s\\n' '{"op": "submit", "workload": "lublin", "jobs": 200}' \\
        '{"op": "run"}' '{"op": "result"}' \\
        | python -m repro_torch session --script - --policy "GreedyP */OPT=MIN" \\
              --nodes 32 --narrator "breakdown(mtbf=2e4,repair=2e3)+noise" \\
              --narrator-seed 7
    python -m repro_torch sweep --table1 --workload lublin --jobs 100 --nodes 32 \\
        --timeout 300 --retries 1   # hung cells quarantined, sweep completes
    # scheduler-as-a-service: server + two tenants
    python -m repro_torch serve --store var/serve --port-file /tmp/port &
    printf '%s\\n' \\
        '{"op": "open", "session": "s0", "policy": "EASY", "nodes": 32}' \\
        '{"op": "submit", "session": "s0", "workload": "lublin", "jobs": 50}' \\
        '{"op": "run", "session": "s0"}' '{"op": "result", "session": "s0"}' \\
        | python -m repro_torch client --port $(cat /tmp/port) --tenant acme \\
              --script -
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import List, Optional

from .device import BackendFault

_METRICS = [
    ("max_stretch", "max bounded stretch", "{:.2f}"),
    ("mean_stretch", "mean bounded stretch", "{:.2f}"),
    ("makespan", "makespan (s)", "{:.1f}"),
    ("underutilization", "normalized underutilization", "{:.4f}"),
    ("pmtn_per_job", "preemptions / job", "{:.3f}"),
    ("mig_per_job", "migrations / job", "{:.3f}"),
    ("bandwidth_gbps", "pmtn/mig bandwidth (GB/s)", "{:.4f}"),
    ("events", "engine events", "{:d}"),
]


def _workloads_from_args(args: argparse.Namespace) -> List["api.WorkloadSpec"]:
    from . import api
    try:
        seeds = [int(s) for s in str(args.seeds).split(",") if s.strip() != ""]
        if not seeds:
            raise ValueError("no seeds given (use --seeds 0,1,...)")
        loads: List[Optional[float]] = (
            [float(x) for x in args.loads.split(",") if x.strip() != ""]
            if args.loads else []) or [None]
        return [
            api.parse_workload(args.workload, n_jobs=args.jobs,
                               n_nodes=args.nodes, seed=seed, load=load)
            for seed in seeds for load in loads
        ]
    except ValueError as e:
        # covers malformed --seeds/--loads values and WorkloadSpec's own
        # validation (e.g. load scaling on kinds that ignore it, unknown
        # kinds, missing kind params like swf's path)
        print(f"invalid workload arguments: {e}", file=sys.stderr)
        raise SystemExit(2)


def _csv(text: str) -> List[str]:
    return [p.strip() for p in text.split(",") if p.strip()]


def _cmd_policies(args: argparse.Namespace) -> int:
    from . import api
    info = api.list_policies(include_paper_space=args.all)
    if args.json:
        print(json.dumps(info, indent=1))
        return 0
    print("Table-1 policies (canonical grammar strings):")
    for name in info["table1"]:
        print(f"  {name}")
    print(f"\nfull §6.1 policy space: {info['n_paper_space']} combinations"
          + ("" if args.all else "  (--all to list)"))
    if args.all:
        for name in info["paper_space"]:
            print(f"  {name}")
    print("\nregistered compositions (beyond the grammar):")
    if not info["registered"]:
        print("  (none)")
    for name, desc in info["registered"].items():
        print(f"  {name}")
        if desc:
            print(f"      {desc}")
    print("\ncomponent registry (kind: names):")
    for kind, names in info["components"].items():
        print(f"  {kind:9s} {', '.join(names)}")
    return 0


def _cmd_scenarios(args: argparse.Namespace) -> int:
    from . import api
    docs = api.scenario_docs()
    reactive = api.reactive_docs()
    if args.json:
        print(json.dumps({"trace": docs, "reactive": reactive}, indent=1))
        return 0
    width = max(len(n) for n in list(docs) + list(reactive))
    for name, doc in docs.items():
        print(f"{name:{width}s}  {doc}")
    print("\nscenarios compose with '+': e.g. rack_failure+arrival_burst "
          "(applied left to right, cluster scripts concatenated)")
    print("\nreactive scenarios (api.run_reactive over a live session):")
    for name, doc in reactive.items():
        print(f"{name:{width}s}  {doc}")
    return 0


def _cmd_workloads(args: argparse.Namespace) -> int:
    from . import api
    kinds = {}
    for name in api.list_workloads():
        wk = api.workload_kind(name)
        kinds[name] = {
            "doc": wk.doc,
            "supports_load": wk.supports_load,
            "params": list(wk.params),
            "required": list(wk.required),
            "cli": f"{name}:<{wk.path_param}>" if wk.path_param else name,
        }
    if args.json:
        print(json.dumps(kinds, indent=1))
        return 0
    width = max(len(v["cli"]) for v in kinds.values())
    for name, info in kinds.items():
        flags = []
        if info["supports_load"]:
            flags.append("load=")
        flags += [f"params[{p}]=" for p in info["params"]]
        suffix = f"  ({', '.join(flags)})" if flags else ""
        print(f"{info['cli']:{width}s}  {info['doc']}{suffix}")
    return 0


def _cmd_trace_smoke(args: argparse.Namespace) -> int:
    """Materialize every registered workload kind × every scenario at a
    small size; emit {cell: fingerprint} JSON (stable across processes) to
    stdout and the materialization wall time to stderr."""
    import time

    from . import api

    workloads, skipped = [], []
    for kind in api.list_workloads():
        wk = api.workload_kind(kind)
        if wk.required:
            if kind == "swf" and args.swf:
                workloads.append(api.parse_workload(
                    f"swf:{args.swf}", n_jobs=args.jobs, n_nodes=args.nodes))
            else:
                # required-param kinds cannot be materialized blind — say
                # so instead of silently shrinking the smoke matrix
                skipped.append(f"{kind} (requires params "
                               f"{list(wk.required)})")
            continue
        workloads.append(api.WorkloadSpec(kind, n_jobs=args.jobs,
                                          n_nodes=args.nodes, seed=0))
    if skipped:
        print(f"skipped kinds: {', '.join(skipped)}", file=sys.stderr)
    scenarios = api.list_scenarios() + [args.chain]
    fingerprints = {}
    t0 = time.perf_counter()
    for w in workloads:
        base = api.make_trace_ir(w)
        fingerprints[f"{w.name} × (workload)"] = base.fingerprint
        for sc in scenarios:
            tr, _events = api.apply_scenario_trace(sc, base, w.n_nodes,
                                                   seed=w.seed)
            fingerprints[f"{w.name} × {sc}"] = tr.fingerprint
    wall = time.perf_counter() - t0
    print(json.dumps(fingerprints, indent=1))
    print(f"{len(fingerprints)} traces ({len(workloads)} workloads x "
          f"{len(scenarios)} scenarios) materialized in {wall:.2f}s",
          file=sys.stderr)
    return 0


def _cmd_simulate(args: argparse.Namespace) -> int:
    from . import api
    workloads = _workloads_from_args(args)
    if len(workloads) > 1:
        print("simulate runs one cell — pass a single --seeds/--loads value "
              "(use the sweep subcommand for grids)", file=sys.stderr)
        return 2
    workload = workloads[0]
    overrides = {}
    if args.period is not None:
        overrides["period"] = args.period
    if args.penalty is not None:
        overrides["penalty"] = args.penalty
    r = api.simulate(workload, args.policy, scenario=args.scenario,
                     device=args.device, **overrides)
    if args.json:
        import dataclasses
        print(json.dumps(dataclasses.asdict(r), indent=1))
        return 0
    scen = f" × {args.scenario}" if args.scenario else ""
    print(f"cell: {workload.name} × {r.policy}{scen}")
    for key, label, fmt in _METRICS:
        print(f"  {label:28s} {fmt.format(getattr(r, key))}")
    if args.bound:
        specs = api.make_trace(workload)
        if args.scenario:
            specs, _ = api.apply_scenario(args.scenario, specs,
                                          workload.n_nodes,
                                          seed=workload.seed)
        bound = api.max_stretch_lower_bound(specs, workload.n_nodes)
        deg = r.max_stretch / bound if bound > 0 else float("inf")
        print(f"  {'Theorem-1 lower bound':28s} {bound:.2f}")
        print(f"  {'degradation from bound':28s} {deg:.2f}")
    return 0


def _session_submit(ses, ev: dict):
    """Materialize a session-script submit op into submittable jobs."""
    from . import api
    if "specs" in ev:
        return [api.JobSpec(**s) for s in ev["specs"]]
    return api.parse_workload(
        ev["workload"],
        n_jobs=int(ev.get("jobs", 100)),
        n_nodes=int(ev.get("nodes", ses.engine.params.n_nodes)),
        seed=int(ev.get("seed", 0)),
        load=ev.get("load"),
    )


def _cmd_session(args: argparse.Namespace) -> int:
    """Drive a streaming SimSession from a JSONL event script.

    Script ops (one JSON object per line; blank lines and ``#`` comments
    skipped): ``open`` (when no --policy/--restore was given), ``submit``
    (a registered workload or inline ``specs``, optional ``shift``),
    ``stream`` (a workload fed chunk-wise via ``stream_trace`` — pair
    with ``--compact-interval`` for bounded-memory million-job runs),
    ``step_until``/``step``/``run``, ``inject`` (fail/join/period),
    ``compact``, ``snapshot`` and ``result`` (``"light": true`` skips the
    per-job dicts).  Every op streams one JSONL metrics line (``kind``:
    submit/step/inject/compact/snapshot/result) to stdout or
    ``--metrics``.
    """
    import dataclasses

    from . import api

    out = open(args.metrics, "w") if args.metrics else sys.stdout

    def emit(obj: dict) -> None:
        print(json.dumps(obj), file=out, flush=True)

    def attach_narrator(ses) -> None:
        if args.narrator:
            ses.attach_narrator(api.parse_narrator(args.narrator,
                                                   seed=args.narrator_seed))

    def attach_tuner(ses) -> None:
        if args.autotune:
            api.autotune(ses, args.autotune, seed=args.autotune_seed,
                         log_path=args.decision_log)

    ses = None
    if args.restore:
        # a snapshot carries its narrator and autotuner (RNG state and
        # all); --narrator/--autotune on top of --restore would replace
        # them mid-stream, so refuse
        if args.narrator:
            print("--narrator cannot be combined with --restore (the "
                  "snapshot already carries the narrator state)",
                  file=sys.stderr)
            return 2
        if args.autotune:
            print("--autotune cannot be combined with --restore (the "
                  "snapshot already carries the autotuner state)",
                  file=sys.stderr)
            return 2
        ses = api.SimSession.restore(args.restore, device=args.device)
        # the JSONL sink path is process-local (not snapshot state):
        # --decision-log re-attaches it to a restored tuner
        if args.decision_log and ses.autotuner is not None:
            ses.autotuner.log_path = args.decision_log
    elif args.policy:
        overrides = {}
        if args.period is not None:
            overrides["period"] = args.period
        if args.penalty is not None:
            overrides["penalty"] = args.penalty
        if args.compact_interval is not None:
            overrides["compact_interval"] = args.compact_interval
        ses = api.open_session(args.nodes, args.policy, device=args.device,
                               **overrides)
        attach_narrator(ses)
        attach_tuner(ses)

    script = sys.stdin if args.script == "-" else open(args.script)
    try:
        for lineno, raw in enumerate(script, start=1):
            raw = raw.strip()
            if not raw or raw.startswith("#"):
                continue
            try:
                ev = json.loads(raw)
                op = ev.get("op")
                if op == "open":
                    if ses is not None:
                        raise ValueError("session already open")
                    ses = api.open_session(
                        int(ev.get("nodes", args.nodes)), ev["policy"],
                        device=args.device,
                        **{k: ev[k] for k in ("period", "penalty",
                                              "compact_interval")
                           if k in ev})
                    attach_narrator(ses)
                    attach_tuner(ses)
                    emit({"kind": "open", "policy": ses.policy_name,
                          **ses.observe()})
                    continue
                if ses is None:
                    raise ValueError("no session open (pass --policy or "
                                     "--restore, or start with an "
                                     "{\"op\": \"open\"} line)")
                if op == "submit":
                    idx = ses.submit(_session_submit(ses, ev),
                                     shift=ev.get("shift"))
                    emit({"kind": "submit", "n_submitted": len(idx),
                          **ses.observe()})
                elif op == "stream":
                    wspec = api.parse_workload(
                        ev["workload"],
                        n_jobs=int(ev.get("jobs", 0)),
                        n_nodes=int(ev.get("nodes",
                                           ses.engine.params.n_nodes)),
                        seed=int(ev.get("seed", 0)),
                        load=ev.get("load"))
                    window = ev.get("window")
                    ses.stream(api.stream_trace(
                        wspec, None if window is None else float(window)),
                        run_to_exhaustion=bool(ev.get("run", True)))
                    emit({"kind": "step", **ses.observe()})
                elif op == "compact":
                    n = ses.compact()
                    emit({"kind": "compact", "evicted": n,
                          **ses.observe()})
                elif op == "step_until":
                    ses.step_until(float(ev["t"]))
                    emit({"kind": "step", **ses.observe()})
                elif op == "step":
                    n = ses.step(int(ev.get("n", 1)))
                    emit({"kind": "step", "steps": n, **ses.observe()})
                elif op == "run":
                    ses.run_to_exhaustion()
                    emit({"kind": "step", **ses.observe()})
                elif op == "inject":
                    ses.inject({k: v for k, v in ev.items() if k != "op"})
                    emit({"kind": "inject", **ses.observe()})
                elif op == "period":
                    ses.set_period(float(ev["period"]))
                    emit({"kind": "inject", **ses.observe()})
                elif op == "tune":
                    tun = ses.autotuner
                    if tun is None:
                        raise ValueError("no autotuner attached (pass "
                                         "--autotune SPEC)")
                    swapped = tun.fire(ses, now=True)
                    d = tun.decisions[-1]
                    emit({"kind": "tune", "swapped": swapped,
                          "reason": d["reason"],
                          "decisions": len(tun.decisions),
                          "policy": ses.policy_name, **ses.observe()})
                elif op == "snapshot":
                    snap = ses.snapshot()
                    snap.save(ev["path"])
                    emit({"kind": "snapshot", "path": ev["path"],
                          "fingerprint": snap.fingerprint, "t": snap.time})
                elif op == "result":
                    r = ses.result(light=bool(ev.get("light", False)))
                    emit({"kind": "result", "partial": not ses.exhausted,
                          **dataclasses.asdict(r)})
                else:
                    raise ValueError(f"unknown op {op!r}")
            except (KeyError, TypeError, ValueError) as e:
                print(f"{args.script}:{lineno}: {e}", file=sys.stderr)
                return 2
    finally:
        if script is not sys.stdin:
            script.close()
        if out is not sys.stdout:
            out.close()
    return 0


def _cmd_tune(args: argparse.Namespace) -> int:
    """Run one autotuned session end to end: open, attach the
    fork-race-promote tuner (and optionally a chaos narrator and a
    scripted rack failure), run to exhaustion, report every tuning
    decision plus the final metrics."""
    import dataclasses

    from . import api

    workloads = _workloads_from_args(args)
    if len(workloads) > 1:
        print("tune runs one session — pass a single --seeds/--loads "
              "value", file=sys.stderr)
        return 2
    workload = workloads[0]
    overrides = {}
    if args.period is not None:
        overrides["period"] = args.period
    if args.penalty is not None:
        overrides["penalty"] = args.penalty
    try:
        ses = api.open_session(args.nodes, args.policy, device=args.device,
                               **overrides)
        if args.narrator:
            ses.attach_narrator(api.parse_narrator(args.narrator,
                                                   seed=args.narrator_seed))
        tuner = api.autotune(ses, args.spec, seed=args.seed,
                             log_path=args.decision_log)
        ses.submit(api.make_trace(workload))
        if args.fail_at is not None:
            nodes = list(range(min(args.fail_nodes, args.nodes)))
            ses.inject({"kind": "fail", "t": args.fail_at, "nodes": nodes})
            if args.join_at is not None:
                ses.inject({"kind": "join", "t": args.join_at,
                            "nodes": nodes})
        ses.run_to_exhaustion()
    except ValueError as e:
        print(f"tune: {e}", file=sys.stderr)
        return 2
    r = ses.result()
    if args.json:
        print(json.dumps({"decisions": tuner.decisions,
                          "final_policy": ses.policy_name,
                          "result": dataclasses.asdict(r)}, indent=1))
        return 0
    swaps = [d for d in tuner.decisions if d["swapped"]]
    print(f"tuned session: {workload.name} × {args.policy} "
          f"(spec: {args.spec})")
    for d in tuner.decisions:
        line = (f"  t={d['t']:.0f}  {d['reason']:14s} "
                f"win={d.get('winner_score', float('nan')):.2f} "
                f"inc={d.get('incumbent_score', float('nan')):.2f}")
        if d["swapped"]:
            line += f"  -> {d['winner']['policy']}"
        print(line)
    print(f"{len(tuner.decisions)} decision(s), {len(swaps)} swap(s); "
          f"final policy: {ses.policy_name}")
    for key, label, fmt in _METRICS:
        print(f"  {label:28s} {fmt.format(getattr(r, key))}")
    return 0


def _cmd_serve(args: argparse.Namespace) -> int:
    """Run the multi-tenant session server until shutdown/SIGTERM."""
    from .serve.admission import CreditParams
    from .serve.server import ServeConfig, run_server

    credit = CreditParams(alpha=args.alpha, beta=args.beta,
                          gamma=args.gamma, budget=args.budget,
                          max_pending=args.max_pending)

    def announce(server) -> None:
        line = {"event": "listening", "host": args.host,
                "port": server.port, "store": args.store,
                "recovered": server.n_recovered}
        print(json.dumps(line), flush=True)
        if args.port_file:
            # atomic: watchers polling the file never read a torn port
            from .core.ioutil import atomic_write_text
            atomic_write_text(args.port_file, str(server.port))

    try:
        run_server(ServeConfig(
            host=args.host, port=args.port, store=args.store,
            max_live=args.max_live, idle_evict_s=args.idle_evict,
            checkpoint_every=args.checkpoint_every, credit=credit,
            fsync=not args.no_fsync, device=args.device), announce=announce)
    except KeyboardInterrupt:
        pass
    return 0


def _cmd_client(args: argparse.Namespace) -> int:
    """Drive named server sessions from a JSONL script.

    Each line is one op object with a ``session`` field (except
    ``stats``/``ping``); responses stream out as JSONL.  Mutating ops are
    seq-stamped by the client, so re-running a script against a server
    that crashed mid-way dedupes the already-applied prefix and finishes
    the rest — the recovery drill CI exercises.
    """
    from .serve.client import Client, ServeError

    out = open(args.metrics, "w") if args.metrics else sys.stdout

    def emit(obj: dict) -> None:
        print(json.dumps(obj), file=out, flush=True)

    cli = Client(args.host, args.port, tenant=args.tenant,
                 retry_for=args.retry_for)
    script = sys.stdin if args.script == "-" else open(args.script)
    try:
        for lineno, raw in enumerate(script, start=1):
            raw = raw.strip()
            if not raw or raw.startswith("#"):
                continue
            try:
                ev = json.loads(raw)
                op = ev.pop("op")
                session = ev.pop("session", args.session)
                resp = cli.call(op, session=session, **ev)
                resp.pop("id", None)
                emit({"kind": op, **resp})
            except ServeError as e:
                if args.keep_going:
                    emit({"kind": "error", "code": e.code, "error": str(e)})
                    continue
                print(f"{args.script}:{lineno}: {e}", file=sys.stderr)
                return 2
            except (KeyError, TypeError, ValueError) as e:
                print(f"{args.script}:{lineno}: {e}", file=sys.stderr)
                return 2
    finally:
        if script is not sys.stdin:
            script.close()
        if out is not sys.stdout:
            out.close()
        cli.close()
    return 0


def _cmd_sweep(args: argparse.Namespace) -> int:
    from . import api
    workloads = _workloads_from_args(args)
    policies = _csv(args.policies)
    if args.table1:
        policies = [api.parse_policy(p).name
                    for p in api.TABLE1_POLICIES] + policies
    if not policies:
        print("no policies selected (use --policies and/or --table1)",
              file=sys.stderr)
        return 2
    scenarios = _csv(args.scenarios)
    periods = [float(p) for p in _csv(args.periods)]
    res = api.sweep(workloads, policies, scenarios, periods=periods,
                    n_workers=args.workers, compute_bound=args.bound,
                    cache_path=args.cache, json_path=args.out,
                    timeout_s=args.timeout, retries=args.retries,
                    backend=args.backend, device=args.device)
    print(f"{res.n_cells} cells in {res.wall_s:.1f}s "
          f"({res.cells_per_sec:.2f} cells/s, {res.n_workers} workers)")
    summary = res.summary(by=args.by)
    if summary:
        width = max(len(g) for g in summary)
        print(f"{'group':{width}s}  {'cells':>5s}  {'mean stretch':>12s}  "
              f"{'max stretch':>11s}")
        for group, agg in summary.items():
            print(f"{group:{width}s}  {agg['n_cells']:5d}  "
                  f"{agg['mean_mean_stretch']:12.2f}  {agg['max_max_stretch']:11.2f}")
    # quarantined cells are reported, not fatal: the sweep completed and
    # every healthy record is valid (exit code stays 0)
    for rec in res.quarantined:
        print(f"quarantined: {rec['workload']} x {rec['policy']} x "
              f"{rec['scenario']} after {rec['attempts']} attempt(s): "
              f"{rec['error']}", file=sys.stderr)
    if res.n_quarantined:
        print(f"{res.n_quarantined} cell(s) quarantined "
              f"(see stderr; re-run to retry)", file=sys.stderr)
    if args.out:
        print(f"artifact: {args.out}")
    if args.cache:
        print(f"record cache: {args.cache}")
    return 0


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch",
        description="DFRS vs batch scheduling on the card: policies, "
                    "cells, sweeps, sessions, the session server.")
    sub = ap.add_subparsers(dest="cmd", required=True)

    def add_device_arg(p: argparse.ArgumentParser):
        p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                       help="where the §4.6 reallocations run (default: "
                            "cuda; it must be present)")

    p = sub.add_parser("policies", help="list the policy surface")
    p.add_argument("--all", action="store_true",
                   help="expand the full 116-combination §6.1 space")
    p.add_argument("--json", action="store_true", help="machine-readable")
    p.set_defaults(fn=_cmd_policies)

    p = sub.add_parser("scenarios", help="list named cluster scenarios")
    p.add_argument("--json", action="store_true", help="machine-readable")
    p.set_defaults(fn=_cmd_scenarios)

    p = sub.add_parser("workloads", help="list registered workload kinds")
    p.add_argument("--json", action="store_true", help="machine-readable")
    p.set_defaults(fn=_cmd_workloads)

    p = sub.add_parser(
        "trace-smoke",
        help="materialize every workload kind x scenario; print fingerprints")
    p.add_argument("--jobs", type=int, default=25, help="jobs per trace")
    p.add_argument("--nodes", type=int, default=16, help="cluster nodes")
    p.add_argument("--swf", default=None, metavar="PATH",
                   help="also smoke the swf kind against this log")
    p.add_argument("--chain", default="rack_failure+arrival_burst",
                   help="composed scenario chain to include")
    p.set_defaults(fn=_cmd_trace_smoke)

    def add_workload_args(p: argparse.ArgumentParser, seeds_default: str):
        p.add_argument("--workload", default="lublin",
                       help="registered workload kind, optionally with a "
                            "kind:<arg> payload (e.g. swf:<path>); see "
                            "`python -m repro_torch workloads`")
        p.add_argument("--jobs", type=int, default=100, help="jobs per trace")
        p.add_argument("--nodes", type=int, default=32, help="cluster nodes")
        p.add_argument("--seeds", default=seeds_default,
                       help="comma-separated trace seeds")
        p.add_argument("--loads", default="",
                       help="comma-separated target loads (lublin only)")

    p = sub.add_parser("simulate", help="run one simulation cell")
    p.add_argument("--policy", required=True,
                   help="grammar string or registered composition name")
    add_workload_args(p, seeds_default="0")
    p.add_argument("--scenario", default=None,
                   help="named cluster scenario, composable with '+' "
                        "(e.g. rack_failure+arrival_burst)")
    p.add_argument("--period", type=float, default=None,
                   help="periodic-pass period (s)")
    p.add_argument("--penalty", type=float, default=None,
                   help="rescheduling penalty (s)")
    p.add_argument("--bound", action="store_true",
                   help="also compute the Theorem-1 lower bound")
    p.add_argument("--json", action="store_true", help="full SimResult JSON")
    add_device_arg(p)
    p.set_defaults(fn=_cmd_simulate)

    p = sub.add_parser(
        "session",
        help="drive a streaming SimSession from a JSONL event script")
    p.add_argument("--script", required=True, metavar="PATH",
                   help="JSONL event script ('-' for stdin); ops: open, "
                        "submit, stream, step_until, step, run, inject, "
                        "compact, snapshot, result")
    p.add_argument("--policy", default=None,
                   help="open the session with this policy (grammar string "
                        "or registered composition name)")
    p.add_argument("--nodes", type=int, default=64, help="cluster nodes")
    p.add_argument("--period", type=float, default=None,
                   help="periodic-pass period (s)")
    p.add_argument("--penalty", type=float, default=None,
                   help="rescheduling penalty (s)")
    p.add_argument("--compact-interval", type=int, default=None,
                   metavar="N",
                   help="auto-compact retired engine rows every N "
                        "retirements (0/absent: never); keeps long "
                        "streaming runs O(active jobs) in memory")
    p.add_argument("--restore", default=None, metavar="PATH",
                   help="resume from a saved session snapshot instead of "
                        "opening a fresh session")
    p.add_argument("--narrator", default=None, metavar="SPEC",
                   help="attach a seeded chaos narrator, e.g. "
                        "'breakdown(mtbf=2e4,repair=2e3)+cancel+noise'; "
                        "rides along in snapshots (not valid with "
                        "--restore)")
    p.add_argument("--narrator-seed", type=int, default=0,
                   help="narrator RNG seed (default: 0)")
    p.add_argument("--autotune", default=None, metavar="SPEC",
                   help="attach the fork-race-promote autotuner, e.g. "
                        "'every=5000;policies=GreedyP */OPT=MIN|GreedyPM "
                        "*/per/OPT=MIN/MINVT=600'; rides along in "
                        "snapshots (not valid with --restore); the "
                        "{\"op\": \"tune\"} script op forces a race now")
    p.add_argument("--autotune-seed", type=int, default=0,
                   help="autotuner RNG seed (default: 0)")
    p.add_argument("--decision-log", default=None, metavar="PATH",
                   help="append one JSONL line per autotune decision here "
                        "(process-local; also re-attachable on --restore)")
    p.add_argument("--metrics", default=None, metavar="PATH",
                   help="write the JSONL metrics stream here (default: "
                        "stdout)")
    add_device_arg(p)
    p.set_defaults(fn=_cmd_session)

    p = sub.add_parser(
        "tune",
        help="run an autotuned session (fork-race-promote) end to end")
    p.add_argument("--policy", required=True,
                   help="starting (incumbent) policy")
    p.add_argument("--spec", required=True, metavar="SPEC",
                   help="autotune spec, e.g. 'every=5000;margin=0.02;"
                        "policies=GreedyP */OPT=MIN|GreedyPM "
                        "*/per/OPT=MIN/MINVT=600'")
    add_workload_args(p, seeds_default="0")
    p.add_argument("--seed", type=int, default=0,
                   help="autotuner RNG seed (default: 0)")
    p.add_argument("--period", type=float, default=None,
                   help="periodic-pass period (s)")
    p.add_argument("--penalty", type=float, default=None,
                   help="rescheduling penalty (s)")
    p.add_argument("--narrator", default=None, metavar="SPEC",
                   help="attach a seeded chaos narrator")
    p.add_argument("--narrator-seed", type=int, default=0,
                   help="narrator RNG seed (default: 0)")
    p.add_argument("--fail-at", type=float, default=None, metavar="T",
                   help="inject a rack failure at this sim time")
    p.add_argument("--fail-nodes", type=int, default=8,
                   help="nodes in the failing rack (default: 8)")
    p.add_argument("--join-at", type=float, default=None, metavar="T",
                   help="rejoin the failed rack at this sim time")
    p.add_argument("--decision-log", default=None, metavar="PATH",
                   help="append one JSONL line per tuning decision")
    p.add_argument("--json", action="store_true",
                   help="decisions + full SimResult as JSON")
    add_device_arg(p)
    p.set_defaults(fn=_cmd_tune)

    p = sub.add_parser(
        "serve",
        help="run the multi-tenant session server (JSONL over TCP)")
    p.add_argument("--host", default="127.0.0.1", help="bind address")
    p.add_argument("--port", type=int, default=0,
                   help="TCP port (default: 0 = OS-assigned; the chosen "
                        "port is announced on stdout and via --port-file)")
    p.add_argument("--store", default=None, metavar="DIR",
                   help="durable snapshot + journal store; enables "
                        "eviction and kill -9 crash recovery")
    p.add_argument("--max-live", type=int, default=256,
                   help="live sessions kept in memory before LRU eviction "
                        "to the store (default: 256)")
    p.add_argument("--idle-evict", type=float, default=None, metavar="S",
                   help="evict sessions idle longer than this (s)")
    p.add_argument("--checkpoint-every", type=int, default=0, metavar="N",
                   help="auto-snapshot a session every N journaled ops "
                        "(bounds replay length; default: 0 = off)")
    p.add_argument("--port-file", default=None, metavar="PATH",
                   help="write the bound port here (atomically) once "
                        "listening — for shell scripts and CI")
    p.add_argument("--no-fsync", action="store_true",
                   help="skip fsync on journal appends (faster, loses the "
                        "crash-durability guarantee; for benchmarks)")
    p.add_argument("--alpha", type=float, default=0.5,
                   help="credit weight on budget use (default: 0.5)")
    p.add_argument("--beta", type=float, default=0.3,
                   help="credit weight on violations (default: 0.3)")
    p.add_argument("--gamma", type=float, default=0.2,
                   help="credit weight on tail latency (default: 0.2)")
    p.add_argument("--budget", type=float, default=500.0,
                   help="per-tenant cost budget per decay window "
                        "(default: 500)")
    p.add_argument("--max-pending", type=int, default=64,
                   help="per-tenant pending-op cap before admission "
                        "refuses (default: 64)")
    add_device_arg(p)
    p.set_defaults(fn=_cmd_serve)

    p = sub.add_parser(
        "client",
        help="drive named sessions on a running server from a JSONL script")
    p.add_argument("--host", default="127.0.0.1", help="server address")
    p.add_argument("--port", type=int, required=True, help="server port")
    p.add_argument("--tenant", default="default", help="tenant name")
    p.add_argument("--script", required=True, metavar="PATH",
                   help="JSONL op script ('-' for stdin); each line is an "
                        "op object, e.g. {\"op\": \"open\", \"session\": "
                        "\"s0\", \"policy\": \"EASY\", \"nodes\": 32}")
    p.add_argument("--session", default=None,
                   help="default session name for lines that omit one")
    p.add_argument("--retry-for", type=float, default=0.0, metavar="S",
                   help="on connection loss, reconnect and resend (same "
                        "seq, deduped server-side) for up to this long — "
                        "rides through a server restart (default: 0)")
    p.add_argument("--keep-going", action="store_true",
                   help="emit server-refused ops as error lines and "
                        "continue instead of aborting")
    p.add_argument("--metrics", default=None, metavar="PATH",
                   help="write the JSONL response stream here (default: "
                        "stdout)")
    p.set_defaults(fn=_cmd_client)

    p = sub.add_parser("sweep", help="run a policy × workload × scenario grid")
    p.add_argument("--policies", default="",
                   help="comma-separated policy strings / composition names")
    p.add_argument("--table1", action="store_true",
                   help="include all 14 Table-1 policies")
    add_workload_args(p, seeds_default="0")
    p.add_argument("--scenarios", default="baseline",
                   help="comma-separated scenario names; each may be a "
                        "'+' chain (e.g. rack_failure+arrival_burst)")
    p.add_argument("--periods", default="600",
                   help="comma-separated periodic-pass periods (s)")
    p.add_argument("--workers", type=int, default=1, help="worker processes")
    p.add_argument("--timeout", type=float, default=None, metavar="S",
                   help="per-cell wall-clock budget (s); cells over budget "
                        "are retried then quarantined, the sweep completes")
    p.add_argument("--retries", type=int, default=0,
                   help="retries per failing/hung cell on a fresh worker "
                        "before quarantine (default: 0)")
    p.add_argument("--bound", action="store_true",
                   help="compute per-cell Theorem-1 bounds")
    p.add_argument("--by", default="policy",
                   help="summary grouping key (default: policy)")
    p.add_argument("--out", default=None, metavar="PATH",
                   help="write the repro.sweep/v1 JSON artifact")
    p.add_argument("--cache", default=None, metavar="PATH",
                   help="resumable on-disk record cache (JSON)")
    p.add_argument("--backend", choices=("torch", "numpy"), default="torch",
                   help="torch: the misses in lockstep on --device; numpy: "
                        "the host process pool of --workers (default: "
                        "torch)")
    add_device_arg(p)
    p.set_defaults(fn=_cmd_sweep)
    return ap


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    try:
        return args.fn(args)
    except BackendFault as exc:
        # no card where one was asked for, or the device failed: no result
        print(f"python -m repro_torch {args.cmd}: {exc}", file=sys.stderr)
        return 1


if __name__ == "__main__":
    sys.exit(main())
