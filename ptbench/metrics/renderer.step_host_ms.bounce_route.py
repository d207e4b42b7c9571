"""renderer.step_host_ms.frame_path's reading (the host's ms in Renderer.step) in the per-bounce
route's cells: a metric of its own, so that each route's cells are held
to the bound their own spread sets (PERF.md section 2)."""
from ptbench.bench import metric_reader

read = metric_reader("renderer.step_host_ms.frame_path")
