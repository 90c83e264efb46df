"""Device milliseconds a step of recomputation: the device's work in the
model's forward spans (``model.block`` and those inside it) that lie inside
a ``train.backward`` span, where the per-layer checkpoints run each layer's
forward again, less the decodes' own operations, over the window's
steps (``_spans``)."""

from metrics._spans import program_trace, spans


def read(run):
    found = spans(run)
    if found is None:
        return None
    again = found.inside(found.present(program_trace().MODEL), "train.backward")
    if not again:
        return None
    return found.per_step_ms(found.work_s(again))
