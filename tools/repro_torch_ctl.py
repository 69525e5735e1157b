"""Operator CLI of the PyTorch port's design service: telemetry, cache
and drain over `repro_torch`.

The four command families of `tools/repro_ctl.py`, over
`repro_torch.telemetry`, `repro_torch.api.artifact_cache` and
`repro_torch.serve.design_service`; the port writes the reference's
schemas, so either CLI reads either package's files.

  * `metrics PATH` — inspect a metrics snapshot dumped by
    `repro_torch.telemetry.export.write_metrics_json` (or by `drain`):
    non-zero counters, live gauges, histogram summaries; `--prometheus`
    renders the same snapshot as text exposition format instead.
  * `gantt PATH` — inspect a span trace dumped by `TraceExport.to_json`
    (Chrome-trace JSON): per-batch stage rows, `--ascii` draws the stage
    Gantt as terminal bars, `--stage-totals` prints the per-stage span
    sums.
  * `cache DIR stats|prune|clear|warm` — artifact-cache maintenance:
    entry count / size, an eviction pass with `--ttl-s` /
    `--max-entries`, a full clear, and a warm pass that runs a service
    over a requests file (on `--device`, default `cuda`).  With
    `--remote URI` the same actions run over the two-tier fleet cache
    (`TieredArtifactCache`), `--tier l1|l2|all` filtering what
    `prune` / `clear` touch.
  * `drain REQUESTS_FILE` — run a telemetry-instrumented service on
    `--device` (default `cuda`) over a JSON file of
    `DesignRequest.to_dict()` entries until every ticket lands, then dump
    the span trace, the per-batch Gantt and the metrics snapshot
    (`--out-dir`) and print the summary counters.

  PYTHONPATH=src python tools/repro_torch_ctl.py metrics service_metrics.json
  PYTHONPATH=src python tools/repro_torch_ctl.py gantt service_trace.json --ascii
  PYTHONPATH=src python tools/repro_torch_ctl.py cache /var/acim-cache stats
  PYTHONPATH=src python tools/repro_torch_ctl.py drain requests.json --out-dir tel/
"""
from __future__ import annotations

import argparse
import json
import pathlib
import sys

REPO = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO / "src"))

from repro_torch.telemetry import (TraceExport, atomic_write_json,  # noqa: E402
                             load_snapshot, render_prometheus,
                             write_metrics_json)


# -- metrics ---------------------------------------------------------------

def cmd_metrics(args) -> int:
    snap = load_snapshot(args.path)
    if args.prometheus:
        print(render_prometheus(snap), end="")
        return 0
    print(f"# metrics snapshot schema={snap['schema']} "
          f"time_unix_s={snap['time_unix_s']:.3f}")
    for name in sorted(snap["metrics"]):
        for s in snap["metrics"][name]:
            labels = ",".join(f"{k}={v}" for k, v in
                              sorted(s.get("labels", {}).items()))
            tag = f"{name}{{{labels}}}" if labels else name
            if s["type"] in ("counter", "gauge"):
                if s["value"] or args.all:
                    print(f"{s['type']:9s} {tag} = {s['value']:g}")
            else:
                m = s["summary"]
                if not m["count"] and not args.all:
                    continue
                q = (f" p50={m['p50']:.4g}s p95={m['p95']:.4g}s "
                     f"p99={m['p99']:.4g}s min={m['min']:.4g}s "
                     f"max={m['max']:.4g}s" if m["count"] else "")
                print(f"histogram {tag}: count={m['count']} "
                      f"sum={m['sum']:.4g}s{q}")
    return 0


# -- gantt -----------------------------------------------------------------

def _bar(t0, t1, span, width) -> str:
    if span <= 0:
        return " " * width
    a = int(round(t0 / span * (width - 1)))
    b = max(a + 1, int(round(t1 / span * (width - 1))))
    return " " * a + "#" * (b - a) + " " * (width - b)


def cmd_gantt(args) -> int:
    trace = TraceExport.from_json(args.path)
    if args.stage_totals:
        for stage, total in sorted(trace.stage_totals().items()):
            print(f"{stage:10s} {total:.6f}s")
        return 0
    g = trace.gantt()
    batches = {int(k): v for k, v in g["batches"].items()} \
        if all(isinstance(k, str) for k in g["batches"]) else g["batches"]
    keys = sorted(batches)
    if args.batch is not None:
        keys = [k for k in keys if k == args.batch]
    ends = [r["t1_s"] for rows in batches.values() for r in rows
            if r["t1_s"] is not None]
    span = max(ends) if ends else 0.0
    for k in keys:
        label = "unbatched" if k < 0 else f"batch {k}"
        print(f"-- {label} --")
        for r in batches[k]:
            if r["cat"] == "control" and not args.control:
                continue
            t0 = r["t0_s"]
            t1 = t0 if r["t1_s"] is None else r["t1_s"]
            who = r["worker"] or r["cat"]
            extra = f" bucket={r['bucket']}" if r["bucket"] else ""
            if args.ascii:
                print(f"{r['name']:>14s} |{_bar(t0, t1, span, args.width)}| "
                      f"{t1 - t0:8.4f}s {who}{extra}")
            else:
                print(f"{r['name']:>14s} [{t0:10.4f}, {t1:10.4f}] "
                      f"{t1 - t0:8.4f}s {who}{extra}")
    return 0


# -- cache -----------------------------------------------------------------

def _dir_stats(root: pathlib.Path) -> tuple[int, int]:
    entries = sorted(root.glob("*.json"))
    return len(entries), sum(p.stat().st_size for p in entries)


def cmd_cache(args) -> int:
    from repro_torch.api import ArtifactCache, TieredArtifactCache
    root = pathlib.Path(args.root)
    tiered = args.remote is not None
    if args.action == "stats":
        n1, b1 = _dir_stats(root)
        if not tiered:
            print(f"{root}: {n1} entries, {b1 / 1e6:.2f} MB")
            return 0
        cache = TieredArtifactCache(root, args.remote)
        n2 = len(cache.remote.list())
        b2 = cache.remote.size_bytes()
        print(f"l1 {root}: {n1} entries, {b1 / 1e6:.2f} MB")
        print(f"l2 {cache.remote.uri}: {n2} entries, {b2 / 1e6:.2f} MB")
        # lifetime counters live in session metrics exports; a fresh CLI
        # cache object only sees this invocation's traffic
        for k in ("l1_hits", "l1_misses", "l2_hits", "l2_misses",
                  "promotions", "l2_writes", "l2_rejects", "l2_evictions"):
            print(f"  {k} = {cache.stats[k]}")
        return 0
    if args.action == "prune":
        if tiered:
            cache = TieredArtifactCache(root, args.remote,
                                        max_entries=args.max_entries,
                                        ttl_s=args.ttl_s)
            removed = 0
            for tier in (("l1", "l2") if args.tier == "all"
                         else (args.tier,)):
                removed += cache.prune(tier=tier,
                                       max_entries=args.max_entries,
                                       ttl_s=args.ttl_s)
            sizes = cache.lengths()
            print(f"pruned {removed} entries (tier={args.tier}); now "
                  f"l1={sizes['l1']} l2={sizes['l2']} "
                  f"(l2 evictions {cache.stats['l2_evictions']})")
            return 0
        cache = ArtifactCache(root, max_entries=args.max_entries,
                              ttl_s=args.ttl_s)
        before = len(cache)
        cache._prune()
        print(f"pruned {before - len(cache)} of {before} entries "
              f"(ttl evictions {cache.stats['ttl_evictions']}, "
              f"lru evictions {cache.stats['lru_evictions']})")
        return 0
    if args.action == "clear":
        if tiered:
            cache = TieredArtifactCache(root, args.remote)
            n = cache.clear(tier=args.tier)
            print(f"cleared {n} entries (tier={args.tier})")
            return 0
        n = 0
        for p in root.glob("*.json"):
            p.unlink()
            n += 1
        print(f"cleared {n} entries from {root}")
        return 0
    # warm: run a service over the cache so a fresh fleet boots hot
    from repro_torch.api import DesignSession
    from repro_torch.serve.design_service import DesignService
    reqs = _load_requests(args.requests)
    store = (TieredArtifactCache(root, args.remote) if tiered else root)
    svc = DesignService(DesignSession(artifact_cache=store,
                                      device=args.device),
                        max_coalesce=len(reqs))
    tickets = [svc.submit(r) for r in reqs]
    done = svc.run()
    ok = sum(1 for t in tickets if done[t].ok)
    s = svc.stats()
    print(f"warmed {root}: {ok}/{len(reqs)} ok "
          f"({s['artifact_cache_hits']} already cached, "
          f"{s['artifact_cache_writes']} written)")
    return 0 if ok == len(reqs) else 1


def _load_requests(path):
    from repro_torch.api import DesignRequest
    with open(path) as f:
        payload = json.load(f)
    if isinstance(payload, dict):
        payload = payload["requests"]
    return [DesignRequest.from_dict(d) for d in payload]


# -- drain -----------------------------------------------------------------

def cmd_drain(args) -> int:
    from repro_torch.api import DesignSession
    from repro_torch.serve.design_service import DesignService
    from repro_torch.telemetry import ControllerConfig, Telemetry
    reqs = _load_requests(args.requests)
    controller = None
    if args.adaptive:
        controller = ControllerConfig(max_workers=max(args.layout_workers,
                                                      1))
    svc = DesignService(DesignSession(artifact_cache=args.cache_dir,
                                      device=args.device),
                        max_coalesce=args.max_coalesce,
                        layout_workers=args.layout_workers,
                        telemetry=Telemetry(), controller=controller)
    with svc.serve():
        tickets = [svc.submit(r) for r in reqs]
        arts = [svc.collect(t, timeout=args.timeout_s) for t in tickets]
    ok = sum(1 for a in arts if a.ok)
    out = pathlib.Path(args.out_dir)
    out.mkdir(parents=True, exist_ok=True)
    trace = svc.trace()
    trace.to_json(out / "service_trace.json")
    atomic_write_json(trace.gantt(), out / "service_gantt.json")
    write_metrics_json(svc.metrics(), out / "service_metrics.json")
    s = svc.stats()
    print(f"drained {ok}/{len(reqs)} ok -> {out} | "
          f"{s['service_batches']} batch(es), "
          f"{s['explorer_dispatches']} explorer dispatch(es), "
          f"{s['layout_dispatches']} layout bucket(s), "
          f"window now {svc.coalesce_window_s:.3f}s, "
          f"pool now {svc.layout_workers}")
    return 0 if ok == len(reqs) else 1


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="repro_torch_ctl",
                                 description=__doc__.splitlines()[0])
    sub = ap.add_subparsers(dest="cmd", required=True)

    m = sub.add_parser("metrics", help="inspect a metrics snapshot")
    m.add_argument("path")
    m.add_argument("--prometheus", action="store_true",
                   help="render text exposition format instead")
    m.add_argument("--all", action="store_true",
                   help="include zero-valued series")
    m.set_defaults(fn=cmd_metrics)

    g = sub.add_parser("gantt", help="inspect a span trace")
    g.add_argument("path")
    g.add_argument("--batch", type=int, default=None,
                   help="only this batch sequence number")
    g.add_argument("--ascii", action="store_true",
                   help="draw terminal Gantt bars")
    g.add_argument("--width", type=int, default=60)
    g.add_argument("--stage-totals", action="store_true",
                   help="print per-stage span sums instead of rows")
    g.add_argument("--control", action="store_true",
                   help="include controller decision instants")
    g.set_defaults(fn=cmd_gantt)

    c = sub.add_parser("cache", help="artifact-cache maintenance")
    c.add_argument("root", help="L1 cache directory")
    c.add_argument("action", choices=("stats", "prune", "clear", "warm"))
    c.add_argument("--remote", default=None,
                   help="shared L2 URI (file://... or path): operate on "
                        "the two-tier fleet cache")
    c.add_argument("--tier", choices=("l1", "l2", "all"), default="all",
                   help="which tier prune/clear touch (with --remote)")
    c.add_argument("--ttl-s", type=float, default=None)
    c.add_argument("--max-entries", type=int, default=None)
    c.add_argument("--requests", default=None,
                   help="requests JSON file (for `warm`)")
    c.add_argument("--device", default="cuda",
                   help="where `warm` explores and lays out (default cuda)")
    c.set_defaults(fn=cmd_cache)

    d = sub.add_parser("drain", help="serve a requests file, dump telemetry")
    d.add_argument("requests", help="JSON file of DesignRequest dicts")
    d.add_argument("--out-dir", default="telemetry")
    d.add_argument("--cache-dir", default=None)
    d.add_argument("--max-coalesce", type=int, default=16)
    d.add_argument("--layout-workers", type=int, default=1)
    d.add_argument("--adaptive", action="store_true",
                   help="attach the feedback controller")
    d.add_argument("--timeout-s", type=float, default=600.0)
    d.add_argument("--device", default="cuda",
                   help="where the service explores and lays out "
                        "(default cuda)")
    d.set_defaults(fn=cmd_drain)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    try:
        sys.exit(main())
    except BrokenPipeError:
        sys.exit(0)
