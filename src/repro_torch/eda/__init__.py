"""Automated layout generation (paper Sec. 3.3, right half of Fig. 4) in
PyTorch: netlist stats, the data-oriented template placer, and the
batched place / DRC / net / route flow (`batched_flow`)."""
