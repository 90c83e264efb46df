"""Device milliseconds a step of the forward passes: the device's work
between each ``train.forward`` span's marks (every microbatch's loss), less
the prefetch thread's decodes' own operations (``_spans``), over the
window's steps."""

from metrics._spans import spans


def read(run):
    found = spans(run)
    return None if found is None else found.work_ms("train.forward")
