"""The device's idle share of the traced batches, in % (as
device_idle.single, read in the batch cells)."""
import os

from harness.core import load_module

_single = load_module(os.path.join(os.path.dirname(__file__),
                                   "device_idle.single.py"),
                      "bench_metric_device_idle_single")


def read(run):
    return _single.read(run)
