"""The ESCG scenario-serving entry point of the port (port of
``repro.launch.serve``, DESIGN.md §12).

Replay a JSONL request trace (or a synthetic smoke mix) through an
in-process :class:`~repro_torch.serve.server.ScenarioServer` on the card
and emit the throughput/latency report, or expose the same server over
the stdlib HTTP adapter with ``--http``. ``--device`` is the server's:
the card by default, ``cpu``, or a comma-separated list for a pod or a
mesh (``cuda:0,cuda:0,cuda:0,cuda:0``).

Examples::

    python -m repro_torch.launch.serve --synthetic 10 --waves 2 \
        --report report.json
    python -m repro_torch.launch.serve \
        --trace examples/traces/smoke.jsonl --check
    python -m repro_torch.launch.serve --http --port 8787
"""
from __future__ import annotations

import argparse
import json
import sys

from .escg_run import parse_device


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="repro_torch.launch.serve",
        description="ESCG scenario server: replay request traces against "
                    "the continuously-batched in-process server, or "
                    "serve HTTP (DESIGN.md §12)")
    src = ap.add_mutually_exclusive_group()
    src.add_argument("--trace", type=str, default=None,
                     help="JSONL trace of SimRequest wire objects")
    src.add_argument("--synthetic", type=int, default=None, metavar="N",
                     help="generate an N-request synthetic smoke trace")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed for --synthetic (default 0)")
    ap.add_argument("--waves", type=int, default=2,
                    help="trace replay waves; later waves exercise the "
                         "built-engine cache-hit path (default 2)")
    ap.add_argument("--maxBatchTrials", type=int, default=64,
                    help="trials packed per device batch (default 64)")
    ap.add_argument("--cacheEntries", type=int, default=8,
                    help="LRU built-engine cache entries (default 8)")
    ap.add_argument("--maxResponses", type=int, default=4096,
                    help="answered responses retained before oldest-first "
                         "eviction; clients can POST /ack to release "
                         "eagerly (default 4096)")
    ap.add_argument("--report", type=str, default=None,
                    help="write the replay report JSON here")
    ap.add_argument("--check", action="store_true",
                    help="exit non-zero unless the report passes the "
                         "acceptance checks (zero dropped, zero errors, "
                         ">=1 cache hit)")
    ap.add_argument("--emitTrace", type=str, default=None, metavar="PATH",
                    help="write the (synthetic) trace to PATH and exit")
    ap.add_argument("--http", action="store_true",
                    help="serve the HTTP adapter instead of replaying")
    ap.add_argument("--host", type=str, default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8787)
    ap.add_argument("--device", type=parse_device, default=None,
                    help="the server's devices: the card (default), "
                         "'cpu', or a comma-separated list")
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    from ..serve import loadgen
    from ..serve.server import ScenarioServer

    if args.emitTrace is not None:
        reqs = loadgen.synthetic_trace(args.synthetic or 10, args.seed)
        loadgen.write_trace(args.emitTrace, reqs)
        print(f"wrote {len(reqs)} requests to {args.emitTrace}")
        return 0

    try:
        server = ScenarioServer(max_batch_trials=args.maxBatchTrials,
                                cache_entries=args.cacheEntries,
                                max_responses=args.maxResponses,
                                device=args.device)
    except (RuntimeError, ValueError) as e:   # no card, and no --device cpu
        raise SystemExit(f"escg_serve: {e}")

    if args.http:
        from ..serve.httpd import serve_http
        print(f"escg_serve: HTTP on {args.host}:{args.port} "
              "(POST /submit, /drain; GET /response, /accounting)")
        serve_http(server, args.host, args.port)
        return 0

    if args.trace is not None:
        reqs = loadgen.read_trace(args.trace)
    else:
        reqs = loadgen.synthetic_trace(args.synthetic or 10, args.seed)
    report = loadgen.replay(server, reqs, waves=args.waves)
    out = json.dumps(report, indent=2, default=str)
    if args.report:
        with open(args.report, "w", encoding="utf-8") as f:
            f.write(out + "\n")
    print(f"escg_serve: {report['n_requests']} requests "
          f"({report['waves']} waves) in {report['wall_s']:.2f}s — "
          f"{report['requests_per_s']:.2f} req/s, "
          f"{report['updates_per_s'] / 1e6:.3f} Mupd/s; cache "
          f"{report['cache']['hits']}H/{report['cache']['misses']}M, "
          f"dropped={report['dropped']}")
    if not args.report:
        print(out)
    if args.check:
        problems = loadgen.check_report(report)
        for p in problems:
            print(f"escg_serve: CHECK FAILED: {p}", file=sys.stderr)
        return 1 if problems else 0
    return 0


if __name__ == "__main__":
    sys.exit(main())
