"""EasyACIM quickstart on the PyTorch port: one declarative request
through the unified API.

A `DesignRequest` captures the whole query — array size, MOGA budget,
application requirements, layout options — and `DesignSession.run`
answers it end to end (paper Fig. 4): MOGA exploration, agile
distillation, batched layout of the surviving Pareto set.  The port's
counterpart of `examples/quickstart.py`, with the same output.

  PYTHONPATH=src python examples/torch/quickstart.py [--device cpu] [--smoke]

`--device` is where explore and layout run (default `cuda`); `--smoke`
takes a 4 kb array at pop 48 x 10 generations, small enough for the
CPU.
"""
import argparse
import pathlib

from repro_torch.api import DesignRequest, DesignSession, Requirements

OUT = pathlib.Path("runs/quickstart_torch")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--smoke", action="store_true",
                    help="a 4 kb array at a small budget")
    args = ap.parse_args(argv)
    OUT.mkdir(parents=True, exist_ok=True)

    if args.smoke:
        size, reqs = 4096, Requirements(min_tops=0.3, min_snr_db=25.0)
        req = DesignRequest(array_size=size, pop_size=48, generations=10,
                            requirements=reqs)
    else:
        size, reqs = 16384, Requirements(min_tops=1.4, min_snr_db=20.0)
        req = DesignRequest(array_size=size, pop_size=192, generations=60,
                            requirements=reqs)
    print(f"== request {req.sha()}: {size // 1024} kb array, >= "
          f"{reqs.min_tops:g} TOPS, >= {reqs.min_snr_db:g} dB SNR ==")
    session = DesignSession(device=args.device)
    art = session.run(req)

    print("\n== 1. MOGA design-space exploration ==")
    full = session.fronts_for([req])[req]
    print(f"Pareto-frontier set: {len(full)} solutions")
    for row in sorted(full.to_rows(), key=lambda r: -r["tops"])[:5]:
        print(f"  H={row['h']:4d} W={row['w']:4d} L={row['l']:2d} "
              f"B={row['b_adc']} | {row['tops']:.3f} TOPS, "
              f"{row['tops_per_w']:.0f} TOPS/W, "
              f"{row['area_f2_per_bit']:.0f} F^2/bit, "
              f"SNR {row['snr_db']:.1f} dB")

    print(f"\n== 2. Agile user distillation (>= {reqs.min_tops:g} TOPS, "
          f">= {reqs.min_snr_db:g} dB) ==")
    print(f"{len(art.pareto)} solutions survive")
    spec = art.pareto.best("tops_per_w")
    print(f"most efficient survivor: {spec}")

    print("\n== 3. Batched layout of the whole distilled set ==")
    for m in art.layout_rows:
        print(f"  H={m['h']:4d} W={m['w']:4d}: "
              f"{m['layout_area_f2_per_bit']:.0f} F^2/bit "
              f"(model {m['estimator_area_f2_per_bit']:.0f}), "
              f"{m['routed_nets']} nets routed "
              f"({100 * m['route_success']:.0f}%), "
              f"DRC clean={m['drc_clean']}")
    p = art.provenance
    print(f"\nprovenance: explore {p.explore_s:.1f}s "
          f"(+{p.new_traces} traces), layout {p.layout_s:.1f}s")
    art.to_json(OUT / "artifact.json")
    art.pareto.to_json(OUT / "pareto.json")
    print(f"artifacts in {OUT}/")


if __name__ == "__main__":
    main()
