"""Device milliseconds a step of the backward passes: the device's work
between each ``train.backward`` span's marks (``torch.autograd.grad``, the
layers' recomputation included), less the decodes' own operations, over
the window's steps (``_spans``)."""

from metrics._spans import spans


def read(run):
    found = spans(run)
    return None if found is None else found.work_ms("train.backward")
