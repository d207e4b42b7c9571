"""device.idle_share.frame_path's reading (the device's idle share of the traced stretch) in the per-bounce
route's cells: a metric of its own, so that each route's cells are held
to the bound their own spread sets (PERF.md section 2)."""
from ptbench.bench import metric_reader

read = metric_reader("device.idle_share.frame_path")
