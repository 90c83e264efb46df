"""Training over a corpus held in Shelby: the driver of the ``train`` mixes.

Set-up, as ``launch/train.py`` builds it but at the production deployment
(``configs/shelby.py``: Clay (10,6), 10 MiB chunksets, 24 SPs in 5 DCs x 4
racks, an RPC node with a hot cache of 32 chunksets): the mix's corpus of
Zipf-drawn token ids is written through the paying ``ShelbyClient``
(``data/pipeline.py::write_token_corpus``); the weights are drawn from the
seed on the device (``inputs.make_weights``, the reference's parameter
table, which must equal the program's); one ``Trainer`` with its AdamW
state; the pipeline's own prefetching read (``BlobTokenDataset.batches(...,
background=True)``).  The first ``check_steps`` steps run through the same
call and feed as the window (:func:`_step`) and are the check's; they and
``warm_steps`` more warm every shape the window uses.

The window steps ``Trainer.step_fn`` and reads each step's loss, as
``Trainer.run`` does, until ``seconds`` have passed.  Afterwards the
program's state is freed and the check runs (``checks.py``): the tokens
every step received against the corpus at the dataset's offsets, and the
reference's first steps against the program's.
"""
from __future__ import annotations

import dataclasses
import gc
import math
import time

import numpy as np
import torch

import checks
from inputs import derived_seed, make_leaf, make_weights, zipf_corpus
from torch.profiler import record_function

from tracing import Tracer, breakdown

FEED_BATCHES = 1 << 20  # the feed's length: more than any window takes
TRACE_TRIES = 2  # a profiler trace now and then comes back without the card's events


@dataclasses.dataclass
class Step:
    x: np.ndarray
    y: np.ndarray
    loss: float
    data_s: float
    step_s: float


@dataclasses.dataclass
class Run:
    """What the per-layer readers read."""

    model: object  # the reference's model: shapes and FLOP counts
    traffic: dict
    steps: list[Step]  # the window's
    window_s: float
    trace: object = None  # tracing.Trace of the window, or None


@dataclasses.dataclass
class Outcome:
    end_to_end: dict[str, float]
    run: Run
    checks: list[checks.Check]
    attempted: int
    failed: int
    memory_peak_bytes: int
    breakdown: dict | None = None
    notes: dict = dataclasses.field(default_factory=dict)


def port_config(config: dict):
    """The program's ``ArchConfig`` of a configuration file: the registered
    architecture ``port.arch`` with ``port.replace`` applied, every
    ``port.expect`` field (dotted for nested ones) equal to its value."""
    from repro_torch.configs import get

    port = config["port"]
    arch = dataclasses.replace(get(port["arch"]), **port.get("replace", {}))
    for key, want in port.get("expect", {}).items():
        have = arch
        for part in key.split("."):
            have = getattr(have, part)
        if have != want:
            raise ValueError(f"{port['arch']}: the program's {key} is {have!r}, the "
                             f"configuration states {want!r}")
    return arch


def _alloc_retries(dev: torch.device) -> int:
    return torch.cuda.memory_stats(dev).get("num_alloc_retries", 0) if dev.type == "cuda" else 0


def _synchronize(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _step(trainer, state, feed, log: list[Step]):
    """One step as ``Trainer.run`` takes it: wait for the batch, step, read
    the loss (which waits for the step's kernels)."""
    t0 = time.perf_counter()
    with record_function("bench.data_wait"):
        x, y = next(feed)
    batch = trainer._to_batch(x, y)
    t1 = time.perf_counter()
    with record_function("bench.step"):
        state, metrics = trainer.step_fn(state, batch)
    with record_function("bench.loss_read"):
        loss = float(metrics["loss"])
    log.append(Step(x, y, loss, t1 - t0, time.perf_counter() - t1))
    return state, metrics


def run(cell, seed: int, seconds: float, trace: bool, *, t_start: float, device: str = "cuda",
        layout=None) -> Outcome:
    """One run of ``cell``; ``layout`` replaces the deployment's blob layout
    (the CPU tests' smaller chunksets)."""
    from repro_torch.configs.shelby import CONFIG
    from repro_torch.data.pipeline import BlobTokenDataset, write_token_corpus
    from repro_torch.launch.cluster import build_cluster
    from repro_torch.models.model import build
    from repro_torch.train import optimizer as opt_mod
    from repro_torch.train.loop import Trainer

    dev = torch.device(device)
    tr = cell.traffic
    model = cell.reference.Model(cell.config)
    table = model.param_table()
    arch = port_config(cell.config)
    specs = build(arch).param_specs()
    theirs = {k: tuple(s.shape) for k, s in specs.items()}
    ours = {k: tuple(leaf.shape) for k, leaf in table.items()}
    if theirs != ours:
        raise ValueError(f"the program's parameters differ from the reference's: "
                         f"{sorted(set(theirs.items()) ^ set(ours.items()))[:6]}")
    batch, seq, n_mb, n_check = tr["batch"], tr["seq"], tr["microbatches"], tr["check_steps"]

    # -- the deployment and the corpus ----------------------------------------------------------
    contract, sps, rpc, client = build_cluster(
        num_sps=CONFIG.num_sps, layout=layout or CONFIG.layout, device=dev,
        num_dcs=CONFIG.num_dcs, racks_per_dc=CONFIG.racks_per_dc)
    n_tokens = tr["corpus_bytes"] // 4
    corpus = zipf_corpus(n_tokens, model.v, tr["zipf_exponent"], seed, dev).cpu().numpy()
    t = time.perf_counter()
    blob = write_token_corpus(client, corpus)
    put_s = time.perf_counter() - t
    order_seed = derived_seed(seed, "order")
    ds = BlobTokenDataset(client, blob, batch=batch, seq_len=seq, seed=order_seed,
                          prefetch=tr["prefetch"])

    # -- the trainer, from the seed's weights --------------------------------------------------
    adamw = opt_mod.AdamWConfig(**tr["optimizer"])
    trainer = Trainer(arch, adamw=adamw, num_microbatches=n_mb, device=dev)
    state = opt_mod.init_state(make_weights(table, seed, dev))
    feed = ds.batches(FEED_BATCHES, background=True)
    prog: dict = {"loss": [], "grad_norm": []}
    first: list[Step] = []
    try:
        for i in range(n_check):
            state, metrics = _step(trainer, state, feed, first)
            prog["loss"].append(first[-1].loss)
            prog["grad_norm"].append(float(metrics["grad_norm"]))
            if i == 0:  # the gradient as AdamW received it: m after one step / (1 - b1)
                prog["leaf_grad_norms"] = {k: float(torch.linalg.vector_norm(m)) / (1 - adamw.b1)
                                           for k, m in state["m"].items()}
        prog["leaf_change_norms"] = {
            k: float(torch.linalg.vector_norm(p - make_leaf(table[k], k, seed, dev)))
            for k, p in state["params"].items()}
        # the set-up's own temporaries (corpus, first weights) leave the caching
        # allocator's reserve fragmented: hand it back, then let a step settle it
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        for _ in range(tr["warm_steps"]):
            state, _ = _step(trainer, state, feed, first)
        _synchronize(dev)
        setup_s = time.perf_counter() - t_start

        # -- the window --------------------------------------------------------------------------
        retries0 = _alloc_retries(dev)
        for _ in range(TRACE_TRIES):
            window: list[Step] = []
            with Tracer(trace) as tracer:
                tw = time.perf_counter()
                while True:
                    state, _ = _step(trainer, state, feed, window)
                    if time.perf_counter() - tw >= seconds:
                        break
                _synchronize(dev)
                window_s = time.perf_counter() - tw
            if tracer.trace is None or tracer.trace.kernels or dev.type != "cuda":
                break
            first += window  # an empty trace's window: its steps' tokens are still checked
    finally:
        feed.close()  # stops the pipeline's thread and waits for it
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    notes = {"corpus_put_s": put_s, "rpc_cache_hits": rpc.stats.cache_hits,
             "losses": [s.loss for s in window], "step_s": [s.step_s for s in window],
             "data_s": [s.data_s for s in window],
             "alloc_retries_window": _alloc_retries(dev) - retries0}
    if dev.type == "cuda":
        stats = torch.cuda.memory_stats(dev)
        notes.update({k: stats.get(k) for k in ("num_alloc_retries", "num_device_alloc",
                                                "num_device_free", "reserved_bytes.all.peak")})
    del state, trainer, feed, ds, client, rpc, sps, contract
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    # -- the check -------------------------------------------------------------------------------
    t = time.perf_counter()
    found = [checks.tokens_wrong(first + window, corpus, batch, seq, order_seed)]
    offsets = checks.example_offsets(order_seed, n_tokens, batch, seq, n_check)
    compared, detail = checks.training(cell, model, table, corpus, offsets, seq, prog, seed, dev)
    found += compared
    notes.update(detail)
    notes["check_s"] = time.perf_counter() - t

    tokens = batch * seq
    end_to_end = {"train_tokens_per_s": len(window) * tokens / window_s,
                  "peak_mem_GB": peak / 1e9, "setup_s": setup_s}
    result = Run(model, tr, window, window_s, tracer.trace)
    failed = sum(1 for s in window if not math.isfinite(s.loss))
    return Outcome(end_to_end, result, found, len(window), failed, peak,
                   breakdown(tracer.trace) if tracer.trace is not None else None, notes)
