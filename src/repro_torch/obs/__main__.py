"""CLI: ``python -m repro_torch.obs``: export timelines, dump metrics, trace
a load run.

    # virtual-time Perfetto timeline of one zoo network's simulation
    PYTHONPATH=src python -m repro_torch.obs export --net resnet18 \
        --controller active --out trace.json

    # process metrics after a small planning workload
    PYTHONPATH=src python -m repro_torch.obs metrics --prometheus

    # host-time span trace of a planner-service load run
    PYTHONPATH=src python -m repro_torch.obs trace-load --smoke --out spans.json

``export`` and ``trace-load`` write Chrome trace-event JSON (open it in
https://ui.perfetto.dev or chrome://tracing). ``export`` plans the network,
simulates the plan on the modelled SoC (``NetPlan.simulate``), lays the
phases out with one track per bottleneck resource and an ``interconnect
GB/s`` counter track, and checks the timeline (per-track cycles ==
``SimReport.cycles``, counter words == ``interconnect_words``) before it
writes.
"""

from __future__ import annotations

import argparse
import json
from typing import Any, Optional

from repro_torch.obs import export as _export
from repro_torch.obs import metrics as _metrics
from repro_torch.obs import trace as _trace


def _cmd_export(args: argparse.Namespace) -> int:
    from repro_torch.plan.netplan import plan_graph
    netp = plan_graph(args.net, strategy=args.strategy,
                      controller=args.controller)
    report = netp.simulate()
    events = _export.simreport_to_trace(report)
    pins = _export.verify_sim_trace(report, events)
    out = args.out or f"trace_{args.net}_{args.controller}.json"
    with open(out, "w") as fp:
        _export.write_trace(events, fp)
    print(f"wrote {out}: {len(events)} events, "
          f"{report.cycles:.3e} cycles of the modelled SoC over "
          f"{len(_export.RESOURCE_TRACKS)} resource tracks")
    per_track = {k: v for k, v in pins.items() if k != "interconnect_words"}
    print("  cycles by bound:  "
          + "  ".join(f"{k}={v:.3e}" for k, v in sorted(per_track.items())
                      if v))
    print(f"  counter words:    {pins['interconnect_words']:.6e} "
          f"(== report.interconnect_words)")
    return 0


def _cmd_metrics(args: argparse.Namespace) -> int:
    if args.warm:
        # A small representative workload so the dump is not empty: plan two
        # zoo networks (one repeat for cache hits) through the service path.
        from repro_torch.launch.planserve import PlanRequest, PlanServer
        server = PlanServer()
        reqs = [PlanRequest(graph=n, controller=c)
                for n in ("alexnet", "resnet18") for c in ("passive",
                                                           "active")]
        server.serve(reqs)
        server.serve(reqs[:2])       # repeats: exercise the plan LRUs
    if args.prometheus:
        print(_metrics.REGISTRY.render_prometheus(), end="")
    else:
        print(json.dumps(_metrics.REGISTRY.snapshot(), indent=2,
                         sort_keys=True, default=str))
    return 0


def _cmd_trace_load(args: argparse.Namespace) -> int:
    from repro_torch.launch.planserve import run_load
    with _trace.tracing() as tr:
        report = run_load(requests=args.requests, smoke=args.smoke)
    events = _export.spans_to_trace(tr, process_name="planserve")
    out = args.out or "trace_planserve.json"
    with open(out, "w") as fp:
        _export.write_trace(events, fp)
    print(f"wrote {out}: {len(tr)} spans from {report['requests']} requests "
          f"in {report['batches']} batches "
          f"(p50={report['p50_ms']:.2f}ms p99={report['p99_ms']:.2f}ms)")
    return 0


def main(argv: Optional[list[str]] = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.obs",
                                 description=__doc__.split("\n", 1)[0])
    sub = ap.add_subparsers(dest="cmd", required=True)

    ex = sub.add_parser("export",
                        help="virtual-time Perfetto timeline of a sim run")
    ex.add_argument("--net", default="resnet18")
    ex.add_argument("--controller", default="passive",
                    choices=("passive", "active"))
    ex.add_argument("--strategy", default="exact_opt")
    ex.add_argument("--out", default=None)
    ex.set_defaults(fn=_cmd_export)

    me = sub.add_parser("metrics", help="dump the obs metric registry")
    me.add_argument("--prometheus", action="store_true",
                    help="text exposition instead of JSON")
    me.add_argument("--no-warm", dest="warm", action="store_false",
                    help="dump without running the warm-up workload")
    me.set_defaults(fn=_cmd_metrics)

    tl = sub.add_parser("trace-load",
                        help="span trace of a planserve load run")
    tl.add_argument("--requests", type=int, default=64)
    tl.add_argument("--smoke", action="store_true")
    tl.add_argument("--out", default=None)
    tl.set_defaults(fn=_cmd_trace_load)

    args = ap.parse_args(argv)
    fn: Any = args.fn
    return int(fn(args))


if __name__ == "__main__":
    raise SystemExit(main())
