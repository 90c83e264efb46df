#!/usr/bin/env python3
"""Splits one traced window of a benchmark cell by the program's spans.

    python scripts/trace_split.py --workload deepseek-v2-lite-16b.train_4k --seed 7 \
        --seconds 51 [--out chiprun_out/split_4k.json]

Runs the cell once through its driver with the trace on (as
``bench/run.py --trace 1`` does), keeping beside each device event its
stream and the host thread that launched it.  Prints one JSON object:

* ``metrics``: every per-layer metric of the cell, as the result line has them;
* ``streams``: device ms by stream, and the marks' stream;
* ``coverage``: device time inside ``train.step`` and ``rpc.decode`` marks
  over the window's busy time; the four phases' work (forward, backward,
  optimizer, accumulate) over the work inside ``train.step``; the model
  spans' own work (``Spans.own_work_ms``) against the forward and backward;
* ``decode``: what the ``rpc.decode`` intervals hold, by launching thread
  and by whether the readers count it as the decode's own;
* ``kernel_by_span``: each named kernel's device ms a step by the innermost
  marked span around it (``--kernels``, by default the index-put backward
  and the f32 elementwise kernels), and ``idle_by_phase``: the idle gaps'
  ms a step by phase and by the host call over them;
* ``marks``: launches and device time of the marks against all kernels;
* ``counters``: the program's counters;
* ``out_of_order``: the device events whose timestamps put them before an
  event launched earlier on their stream (by correlation id), which is why
  ``_spans`` pairs marks per span and not like brackets;
* with ``--pipeline-batches N``, ``pipeline_alone``: afterwards, N batches
  of the cell's data plane read and profiled with no training beside them,
  on the profiled thread, so that the host spans of its Merkle checks
  (``rpc.verify``) and decodes (``rpc.decode``) are in the trace.

Needs one NVIDIA GPU, like the benchmark.
"""
from __future__ import annotations

import argparse
import json
import os
import pathlib
import sys
import time

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "bench"), str(ROOT / "src")]

from metrics import _spans  # noqa: E402

PHASES = ("train.forward", "train.backward", "train.optimizer", "train.accumulate")
LABELLED_GAPS = 2000  # the longest idle gaps, each named by the host call over it
KERNELS = ("indexing_backward_kernel", "vectorized_elementwise_kernel",
           "elementwise_kernel<128", "direct_copy_kernel")


def capture_streams(tracing):
    """Wraps ``tracing.read_trace`` so that each trace keeps, per device
    event (in its order), its stream, the launching host thread, its start
    in ns and its launch's correlation id."""
    from torch.autograd import DeviceType

    plain = tracing.read_trace
    kept = {}

    def read_trace(prof):
        out = plain(prof)
        launches, extra = {}, []
        events = list(prof.profiler.kineto_results.events())
        for e in events:
            if e.device_type() == DeviceType.CPU and e.name().startswith("cu"):
                launches[e.correlation_id()] = e.start_thread_id()
        for e in events:
            if e.device_type() == DeviceType.CUDA and not e.is_user_annotation():
                extra.append((e.device_resource_id(), launches.get(e.correlation_id()),
                              e.start_ns(), e.correlation_id()))
        kept[id(out)] = extra
        return out

    tracing.read_trace = read_trace
    return kept


def innermost(spans, names):
    """A function t -> the name of the innermost of ``names``' intervals
    holding t (None outside them all): the intervals painted over the
    window's cut points, longest first, so that an inner one paints last."""
    ivs = [(a, b, n) for n in names for a, b in spans.spans.get(n, [])]
    cuts = np.unique(np.array([x for a, b, _ in ivs for x in (a, b)], dtype=np.float64))
    owner = np.full(len(cuts), -1)
    labels: list[str] = []
    for a, b, n in sorted(ivs, key=lambda iv: iv[0] - iv[1]):
        owner[np.searchsorted(cuts, a):np.searchsorted(cuts, b)] = len(labels)
        labels.append(n)

    def at(t):
        k = int(np.searchsorted(cuts, t, side="right")) - 1
        return None if k < 0 or owner[k] < 0 else labels[owner[k]]

    return at


def split(trace, extra, spans, program, kernels) -> dict:
    """The window's split by span (the keys after ``metrics`` in the module
    docstring); ``extra`` is :func:`capture_streams`' (stream, launching
    thread, start ns, correlation id) of each device event.  The profiler gives the runtime calls of a
    thread it does not record (the prefetch thread) the main thread's id, so
    a launch is told apart only as the autograd thread's (the backward's) or
    the main and prefetch threads'."""
    result: dict = {}
    steps = spans.steps
    per_step = 1e3 / steps
    mark = _spans.MARK

    # streams, and which thread launched what
    by_stream: dict = {}
    mark_streams = set()
    for (cat, name, a, b), (stream, _, _, _) in zip(trace.device, extra):
        by_stream[stream] = by_stream.get(stream, 0.0) + (b - a)
        if mark.search(name):
            mark_streams.add(stream)
    result["streams"] = {"device_ms_by_stream": {str(k): 1e3 * v for k, v in by_stream.items()},
                         "mark_streams": sorted(mark_streams)}

    # coverage
    step_iv = spans.get("train.step")
    decode_iv = spans.spans.get("rpc.decode", [])
    covered = _spans.Union(step_iv + decode_iv)
    held = sum(spans.activity.measure(a, b) for a, b in covered.intervals())
    step_work = spans.work_s(step_iv)
    phase_work = {n: spans.work_s(spans.get(n) or []) for n in PHASES}
    model = spans.present(program.MODEL + program.BACKWARD)
    groups = {"moe": [n for n in model if n.startswith("moe.")],
              "embed": [n for n in model if n.startswith("model.embed")],
              "head": [n for n in model if n.startswith(("model.head", "model.xent"))]}
    result["coverage"] = {
        "step_and_decode_over_busy": held / trace.busy_s(),
        "phases_over_step_work": sum(phase_work.values()) / step_work,
        "phase_ms": {n: per_step * v for n, v in phase_work.items()},
        "step_work_ms": per_step * step_work,
        "group_ms": {g: spans.own_work_ms(*ns) for g, ns in groups.items()},
    }

    # what the decode intervals hold, by the thread that launched it
    decoders = {tid for (c, n, _, _), (_, tid, _, _) in zip(trace.device, extra)
                if (m := mark.search(n)) and program.mark_name(int(m.group(1)))[0] == "rpc.decode"}

    def who(tid):
        return "main or prefetch" if tid in decoders else "autograd" if tid is not None else "?"

    decode = _spans.Union(decode_iv)
    held_by: dict = {}
    for (cat, name, a, b), (_, tid, _, _) in zip(trace.device, extra):
        inside = decode.measure(a, b)
        if inside > 0 and not mark.search(name):
            key = f"{who(tid)} / {'own' if _spans.DATA_PLANE.search(name) else 'other'}"
            held_by[key] = held_by.get(key, 0.0) + inside
    result["decode"] = {"intervals": len(decode_iv), "own_ms": per_step * sum(
                            b - a for a, b in spans.decode_own.intervals()),
                        "held_ms_by_thread": {k: per_step * v for k, v in held_by.items()}}

    # kernels by innermost span; idle gaps by phase and host call
    at = innermost(spans, [n for n in program.MARKED if n in spans.spans])
    split: dict = {}
    for cat, name, a, b in trace.device:
        for want in kernels:
            if want in name:
                key = (want, at(a) or "(no span)")
                split[key] = split.get(key, 0.0) + (b - a)
    result["kernel_by_span"] = {f"{k} @ {s}": per_step * v
                                for (k, s), v in sorted(split.items(), key=lambda kv: -kv[1])}
    phase_at = innermost(spans, PHASES + ("rpc.decode",))
    gaps = sorted(trace.idle_gaps(), key=lambda g: g[0] - g[1])
    named = gaps[:LABELLED_GAPS]
    doing = trace.host_doing(named) + ["(a shorter gap)"] * (len(gaps) - len(named))
    idle: dict = {}
    for (a, b), what in zip(gaps, doing):
        key = f"{phase_at(0.5 * (a + b)) or '(between phases)'} / {what}"
        idle[key] = idle.get(key, 0.0) + (b - a)
    result["idle_by_phase"] = {k: per_step * v for k, v in
                               sorted(idle.items(), key=lambda kv: -kv[1])[:24]}

    step_union = _spans.Union(step_iv)
    copies: dict = {}
    for (cat, name, a, b), (_, tid, _, _) in zip(trace.device, extra):
        if cat != "kernel":
            key = f"{name.split(' (')[0]} / {who(tid)}"
            copies[key] = copies.get(key, 0.0) + step_union.measure(a, b)
    result["copies_in_steps_ms"] = {k: per_step * v for k, v in copies.items()}
    host: dict = {}
    for name, tid, a, b in trace.host:
        if name in program.NUMBER or name.startswith(("data.", "bench.")):
            host[name] = host.get(name, 0.0) + (b - a)
    result["host_span_ms"] = {k: per_step * v for k, v in host.items()}
    acc_idle = [0.0] * 8
    for i, (a, b) in enumerate(sorted(spans.get("train.accumulate") or [])):
        acc_idle[min(i % (len(spans.spans["train.accumulate"]) // steps), 7)] += \
            (b - a) - spans.activity.measure(a, b)
    result["accumulate_idle_by_place"] = [per_step * x for x in acc_idle if x]

    marks = [(b - a) for cat, name, a, b in trace.device if mark.search(name)]
    launched = sum(1 for cat, *_ in trace.device if cat == "kernel")
    result["marks"] = {"launches": len(marks), "kernels": launched,
                       "share_of_launches": len(marks) / max(launched, 1),
                       "device_ms_per_step": per_step * sum(marks),
                       "share_of_busy": sum(marks) / trace.busy_s()}
    return result


def out_of_order(trace, extra) -> dict:
    """How far the trace's timestamps depart from launch order on a stream:
    the device events stamped before one launched earlier on their stream
    (a lower correlation id than the highest seen before them), the marks
    among them, and the longest such stretch (us) between an event's stamp
    and the start of the later-launched event stamped first."""
    seen: dict = {}
    early = marks = 0
    longest = 0.0
    for i in sorted(range(len(trace.device)), key=lambda i: trace.device[i][2]):
        _, name, a, _ = trace.device[i]
        stream, corr = extra[i][0], extra[i][3]
        top = seen.get(stream)
        if top is not None and corr < top[0]:
            early += 1
            marks += bool(_spans.MARK.search(name))
            longest = max(longest, 1e6 * (a - top[1]))
        else:
            seen[stream] = (corr, a)
    return {"events": len(trace.device), "stamped_before_an_earlier_launch": early,
            "marks_among_them": marks, "longest_us": longest}


def pipeline_alone(cell, seed: int, batches: int) -> dict:
    """The data plane's own device work a batch, with no training beside it:
    the cell's deployment, corpus and batch order (as the driver builds
    them), ``batches`` batches read on this thread after as many unprofiled
    ones, every device operation then the pipeline's."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from inputs import derived_seed, zipf_corpus
    from repro_torch.configs.shelby import CONFIG
    from repro_torch.data.pipeline import BlobTokenDataset, write_token_corpus
    from repro_torch import trace as program
    from repro_torch.launch.cluster import build_cluster
    from tracing import read_trace

    tr = cell.traffic
    _, _, rpc, client = build_cluster(num_sps=CONFIG.num_sps, layout=CONFIG.layout,
                                      device="cuda", num_dcs=CONFIG.num_dcs,
                                      racks_per_dc=CONFIG.racks_per_dc)
    vocab = cell.reference.Model(cell.config).v
    corpus = zipf_corpus(tr["corpus_bytes"] // 4, vocab, tr["zipf_exponent"], seed, "cuda")
    blob = write_token_corpus(client, corpus.cpu().numpy())
    ds = BlobTokenDataset(client, blob, batch=tr["batch"], seq_len=tr["seq"],
                          seed=derived_seed(seed, "order"), prefetch=tr["prefetch"])
    feed = ds.batches(2 * batches, background=False)
    for _ in range(batches):
        next(feed)
    torch.cuda.synchronize()
    hits0 = rpc.stats.cache_hits
    busy0 = program.counters().get("data.batch_s", 0.0)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(batches):
            next(feed)
        torch.cuda.synchronize()
    busy = program.counters().get("data.batch_s", 0.0) - busy0
    traced = read_trace(prof)
    host: dict = {}
    for name, _, a, b in traced.host:
        if name in ("rpc.verify", "rpc.decode"):
            host[name] = host.get(name, 0.0) + (b - a)
    by: dict = {}
    for cat, name, a, b in traced.device:
        key = ("own" if _spans.DATA_PLANE.search(name) else "mark" if _spans.MARK.search(name)
               else "other")
        by[key] = by.get(key, 0.0) + (b - a)
    return {"batches": batches, "cache_hits": rpc.stats.cache_hits - hits0,
            "device_ms_per_batch": {k: 1e3 * v / batches for k, v in by.items()},
            "host_ms_per_batch": {"data.batch_s": 1e3 * busy / batches,
                                  **{k: 1e3 * v / batches for k, v in host.items()}}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--kernels", nargs="*", default=list(KERNELS))
    ap.add_argument("--pipeline-batches", type=int, default=0,
                    help="then read this many batches with no training, profiled")
    ap.add_argument("--out", default=None, help="also write the object to this file")
    args = ap.parse_args(argv)
    t_start = time.perf_counter()
    import run as bench_run  # the benchmark's settings: build paths, sys.path
    from cells import load_cell

    cell = load_cell(args.workload)
    os.environ["PYTORCH_CUDA_ALLOC_CONF"] = cell.config["allocator"]
    import torch

    import tracing

    if not torch.cuda.is_available():
        print("needs an NVIDIA GPU", file=sys.stderr)
        return 2
    kept = capture_streams(tracing)
    out = cell.driver.run(cell, args.seed, args.seconds, True, t_start=t_start)
    trace = out.run.trace
    device = {"kind": torch.cuda.get_device_name(0), "busy_s": trace.busy_s(),
              "window_s": out.run.window_s}
    line = bench_run.result_line(cell, out, True, device)
    spans = _spans.spans(out.run)
    program = _spans.program_trace()
    result = {"workload": args.workload, "seed": args.seed, "device": device,
              "correct": line["correct"], "steps": len(out.run.steps),
              "tokens_per_s": out.end_to_end["train_tokens_per_s"],
              "metrics": {k: v["value"] for k, v in line["metrics"].items()},
              "counters": program.counters()}
    result["out_of_order"] = out_of_order(trace, kept[id(trace)])
    if spans is None:
        result["error"] = "no paired train.step marks in the window"
        print(json.dumps(result))
        return 1
    result.update(split(trace, kept[id(trace)], spans, program, args.kernels))
    if args.pipeline_batches:
        import gc

        del out
        gc.collect()
        torch.cuda.empty_cache()
        result["pipeline_alone"] = pipeline_alone(cell, args.seed, args.pipeline_batches)
    text = json.dumps(result)
    if args.out:
        pathlib.Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        pathlib.Path(args.out).write_text(text + "\n")
    print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
