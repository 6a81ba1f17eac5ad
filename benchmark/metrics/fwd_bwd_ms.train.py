"""The forward and backward's device time a step: the median over the
window's train steps of the summed device time of a step's
``train.loss_and_grads`` spans (one a microbatch)."""

from benchmark.spans import median_step_device_ms


def read(rec):
    return median_step_device_ms(rec, "train.loss_and_grads")
