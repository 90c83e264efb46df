"""Device milliseconds a step of the MoE layers: the device's work in the
``moe.route``, ``moe.dispatch``, ``moe.experts``, ``moe.combine`` and
``moe.shared`` spans (forward and recomputation) and their ``.bwd``
intervals (``moe.shared`` where the model has shared experts), less the
decodes' own operations and the recomputed layers that the ``.bwd``
intervals hold (``Spans.own_work_ms``), over the window's steps
(``_spans``)."""

from metrics._spans import program_trace, spans


def read(run):
    found = spans(run)
    if found is None:
        return None
    names = found.present(n for n in program_trace().MARKED if n.startswith("moe."))
    if not {"moe.route", "moe.route.bwd"} <= set(names):
        return None
    return found.own_work_ms(*names)
