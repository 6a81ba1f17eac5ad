"""AdamW's device time a step: the median over the window's train steps
of the ``train.optimizer_update`` span's device time (CUDA events on
the step's stream around ``optimizer.update``)."""

from benchmark.spans import median_step_device_ms


def read(rec):
    return median_step_device_ms(rec, "train.optimizer_update")
