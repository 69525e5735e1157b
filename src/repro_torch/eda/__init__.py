"""Automated layout generation for the synthesizable ACIM architecture
(paper Sec. 3.3 and the right half of Fig. 4), in PyTorch.

A `repro_torch.core.acim_spec.MacroSpec` design point, typically
distilled from the explorer's Pareto set, flows through:

  `netlist`      template-based netlist generation (+ closed-form stats)
  `placer`       data-oriented hierarchical template expansion
  `router`       Lee-wavefront grid routing (kernels.maze_route)
  `flow`         single-spec orchestration: `generate_layout(spec)`
  `batched_flow` the whole spec batch, every stage over the batch:
                 `generate_layouts(specs)`
  `cells`        the customized cell library (calibrated footprints)

The sequential and batched paths share the same placement and the same
wavefront/backtrace semantics, so per-spec results agree exactly
(tests/test_torch_flow.py).

The front door is `repro_torch.api` (`DesignSession` / `DesignService`):
it chains exploration into `batched_flow` and buckets multi-tenant spec
batches by routing-grid shape before dispatch.
"""
