"""Device milliseconds a step of the output head and the loss: the logits
(``model.head``), the cross-entropy (``model.xent``) and their ``.bwd``
intervals, less the decodes' own operations and any recomputed layer
inside (``Spans.own_work_ms``), over the window's steps (``_spans``)."""

from metrics._spans import spans


def read(run):
    found = spans(run)
    if found is None:
        return None
    return found.own_work_ms("model.head", "model.xent", "model.head.bwd", "model.xent.bwd")
