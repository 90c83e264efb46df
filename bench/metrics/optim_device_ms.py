"""Device milliseconds a step of AdamW: the device's work between the
``train.optimizer`` span's marks (the clipping norm and every leaf's update),
less the decodes' own operations, over the window's steps
(``_spans``)."""

from metrics._spans import spans


def read(run):
    found = spans(run)
    return None if found is None else found.work_ms("train.optimizer")
