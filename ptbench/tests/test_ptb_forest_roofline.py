"""The forest walk's frozen floor, worked by hand, and its reader."""
import types

from ptbench import bench, forest_roofline, roofline


def test_traverse_kernel_count_by_hand():
    # 1,000 live queries: 1,000 x (28 + 16) = 44,000 bytes at 3.35 TB/s
    assert forest_roofline.traverse_kernel_s(queries=1000) == 44000 / 3.35e12


def test_no_queries_no_floor():
    assert forest_roofline.traverse_kernel_s(queries=0) == 0.0


def _record(device):
    return {"trace": None if device is None else {"device": device},
            "record": types.SimpleNamespace(queries=480000)}


def test_reader_sums_the_kernel_over_the_trace():
    read = bench.metric_reader("traverse_kernel_roofline")
    dev = [("traverse_kernel", 1.0, 1.5), ("bounce_kernel", 1.5, 2.0),
           ("traverse_kernel", 2.0, 2.25)]
    floor = roofline.least_s(480000 * 44)
    assert read(_record(dev)) == 100.0 * floor / 0.75


def test_reader_finds_nothing_without_the_kernel():
    read = bench.metric_reader("traverse_kernel_roofline")
    assert read(_record(None)) is None
    assert read(_record([("streamed_kernel", 1.0, 1.5)])) is None
