"""Milliseconds a step in which the device ran nothing between the
``train.backward`` span's marks: where the backward phase leaves the device idle
(waiting on the host, an allocation or a synchronization), over the
window's steps (``_spans``)."""

from metrics._spans import spans


def read(run):
    found = spans(run)
    return None if found is None else found.idle_ms("train.backward")
