"""Host milliseconds a step that the data pipeline's prefetch thread spent
making batches (the paid ``get_many``: fetches, Merkle checks, Clay decode,
the bytes' assembly): the counter ``data.batch_s`` that
``BlobTokenDataset._next_batch`` keeps of its own wall time while a
profiler records, over the steps the program counted meanwhile
(``train.steps``)."""

from metrics._spans import counters


def read(run):
    found = counters(run)
    if found is None or "data.batch_s" not in found:
        return None
    return 1e3 * found["data.batch_s"] / found["train.steps"]
