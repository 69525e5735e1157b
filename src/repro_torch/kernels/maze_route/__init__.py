from repro_torch.kernels.maze_route.ops import (INF, pad_blocked,
                                                wavefront_distance)
from repro_torch.kernels.maze_route.oracle import wavefront_distance_bfs
from repro_torch.kernels.maze_route.ref import (trace_paths_ref,
                                                wavefront_distance_ref)

__all__ = ["INF", "pad_blocked", "wavefront_distance",
           "wavefront_distance_bfs", "wavefront_distance_ref",
           "trace_paths_ref"]
