"""The paper's result drivers on the port: one module per table or
figure of the source paper, each the counterpart of the reference's
driver of the same name under `benchmarks/`, with its names and its
printed lines.

  fig8_layouts       Fig. 8: three 16 kb layouts against the paper's TOPS
                     and F^2/bit (the sequential layout flow)
  fig9_design_space  Fig. 9: the explored fronts at 4 / 16 / 64 kb and
                     the eight monotone trends of the estimator
  fig10_sota         Fig. 10: the pooled front's energy-efficiency and
                     area span against three SOTA macros
  table2_flow        Table 2: explore and layout wall-clock
  snr_mc             the Monte-Carlo check of the Eq. 2-6 SNR model
  roofline           the dry-run's roofline table (`runs/dryrun_torch`)
  run                every section in turn: `python -m repro_torch.paper.run`

Each runs on `cuda` unless given `device=` (`--device`); with no CUDA
device and none given it raises.
"""
