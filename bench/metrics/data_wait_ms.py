"""Host milliseconds a step of the window waited for its batch (the data
plane: the pipeline's paid ``get_many``, Clay decode and Merkle checks,
prefetched in a thread), summed over the window and divided by its steps:
the timer of ``Trainer.run``'s ``data_s``."""


def read(run):
    if not run.steps:
        return None
    return 1e3 * sum(s.data_s for s in run.steps) / len(run.steps)
