"""samples_per_s.frame_path's reading (pixel samples a second of the window) in the per-bounce
route's cells: a metric of its own, so that each route's cells are held
to the bound their own spread sets (PERF.md section 2)."""
from ptbench.bench import metric_reader

read = metric_reader("samples_per_s.frame_path")
