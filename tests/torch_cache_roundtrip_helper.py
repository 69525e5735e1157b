"""Subprocess half of the port's cross-process artifact-cache round trip.

Run as `python tests/torch_cache_roundtrip_helper.py <cache_dir>
<request_json> [--remote URI]` (with `PYTHONPATH=src`): opens a *fresh*
`repro_torch` `DesignSession(device="cpu")` over the given persistent
cache — a plain `ArtifactCache` on `<cache_dir>`, or, with `--remote`, a
`TieredArtifactCache` (`<cache_dir>` the worker-local L1, the URI the
shared L2) — runs the request, and prints a JSON report the parent
asserts on (`tests/test_torch_artifact_cache.py`): a repeat request is
served from disk with zero explorer and layout dispatches.
"""
import argparse
import json
import sys


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("cache_dir")
    ap.add_argument("request_json")
    ap.add_argument("--remote", default=None,
                    help="shared L2 URI: run over a TieredArtifactCache")
    args = ap.parse_args()
    import torch

    from repro_torch.api import (DesignRequest, DesignSession,
                                 TieredArtifactCache)
    from repro_torch.kernels import LAUNCHES

    torch.set_num_threads(1)
    cache = (args.cache_dir if args.remote is None
             else TieredArtifactCache(args.cache_dir, args.remote))
    session = DesignSession(artifact_cache=cache, device="cpu")
    artifact = session.run(DesignRequest.from_json(args.request_json))
    json.dump({
        "explorer_dispatches": int(session.stats["explorer_dispatches"]),
        "layout_dispatches": int(session.stats["layout_dispatches"]),
        "artifact_cache_hits": int(session.stats["artifact_cache_hits"]),
        "served_from": artifact.provenance.served_from,
        "ok": artifact.ok,
        "summary": artifact.summary(),
        "launches": sum(LAUNCHES.values()),
        "tier_stats": {k: int(session.stats[k]) for k in (
            "artifact_cache_l1_hits", "artifact_cache_l2_hits",
            "artifact_cache_promotions")},
    }, sys.stdout)


if __name__ == "__main__":
    main()
