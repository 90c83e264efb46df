"""Device milliseconds a step of the token embedding: its gather
(``model.embed``) and the gather's backward (``model.embed.bwd``, an index
put summing each row's gradient), less the decodes' own operations
and any recomputed layer inside (``Spans.own_work_ms``), over the
window's steps (``_spans``)."""

from metrics._spans import spans


def read(run):
    found = spans(run)
    return None if found is None else found.own_work_ms("model.embed", "model.embed.bwd")
