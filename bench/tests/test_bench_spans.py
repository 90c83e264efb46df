"""The span readers (``bench/metrics/_spans.py`` and the metrics on it) on
synthetic traces, and on the card a mark's kernel in a real trace."""
from __future__ import annotations

import dataclasses

import pytest
import smoke_cell  # noqa: F401
import torch
from cells import metric_reader
from metrics import _spans

from repro_torch import trace as program
from tracing import Trace, read_trace

US = 1e-6


def mark(name: str, end: bool, t: float):
    """A mark's kernel as the trace holds it: 1 us long, from ``t``."""
    number = 2 * program.NUMBER[name] + int(end)
    return ("kernel", f"void trace_mark_kernel<{number}>()", t, t + US)


def span(name: str, a: float, b: float):
    """``name``'s two marks: its interval is [a, b]."""
    return [mark(name, False, a - US), mark(name, True, b)]


def work(a: float, b: float, name: str = "void gemm_kernel()"):
    return ("kernel", name, a, b)


@dataclasses.dataclass
class Run:
    trace: Trace | None
    steps: list = dataclasses.field(default_factory=list)


def step(t: float, decode=None):
    """A step of 10 s from ``t``: a forward with 2 s of work, a backward of
    3 s with a recomputed block of 1 s, the MoE's forward (1 s), its
    recomputation (0.5 s) and its backward interval (0.5 s), AdamW of 0.5 s;
    ``decode`` (a, b) adds the prefetch thread's decode marks and 0.5 s of
    its work from a."""
    dev = [*span("train.step", t, t + 10),
           *span("train.forward", t + 1, t + 4), work(t + 1.5, t + 3.5),
           *span("moe.route", t + 2, t + 3),
           *span("train.backward", t + 4.5, t + 8), work(t + 4.5, t + 7.5),
           *span("model.block", t + 5, t + 6), *span("moe.route", t + 5, t + 5.5),
           *span("moe.route.bwd", t + 6.5, t + 7),
           *span("train.optimizer", t + 8.2, t + 9.5), work(t + 8.5, t + 9)]
    if decode:
        a, b = decode
        dev += [*span("rpc.decode", a, b), work(a, a + 0.5, "void gf_matmul_kernel()")]
    return dev


def run_of(device) -> Run:
    return Run(Trace(device, [], 0))


def read(name: str, run) -> float | None:
    return metric_reader(name)(run)


@pytest.mark.parametrize("name, want", [
    ("fwd_device_ms", 2000.0), ("bwd_device_ms", 3000.0), ("optim_device_ms", 500.0),
    ("recompute_device_ms", 1000.0), ("moe_device_ms", 2000.0),
    ("fwd_idle_ms", 1000.0), ("bwd_idle_ms", 500.0), ("optim_idle_ms", 800.0),
])
def test_phases_per_step_over_two_steps(name, want):
    run = run_of(step(0.0) + step(20.0))
    assert read(name, run) == pytest.approx(want, abs=0.01)


def recomputed_inside_a_backward_interval(t: float):
    """A step of 10 s from ``t`` in which the MoE layer's recomputation
    starts after ``moe.shared.bwd``'s begin mark, as a checkpointed block's
    does when that mark's node runs before the first saved tensor is
    unpacked: the whole recomputed block (1 s, its attention 0.5 s, its
    ``moe.route`` 0.25 s) lies inside ``moe.shared.bwd`` (2 s)."""
    return [*span("train.step", t, t + 10),
            *span("train.forward", t + 1, t + 4), work(t + 1, t + 4),
            *span("moe.route", t + 2, t + 2.5), *span("model.embed", t + 1, t + 1.2),
            *span("model.head", t + 3.5, t + 3.8), *span("model.xent", t + 3.8, t + 4),
            *span("train.backward", t + 4.5, t + 9), work(t + 4.5, t + 9),
            *span("model.xent.bwd", t + 4.5, t + 4.6), *span("model.head.bwd", t + 4.6, t + 4.8),
            *span("moe.shared.bwd", t + 5, t + 7),
            *span("model.block", t + 5.5, t + 6.5), *span("attn.mla", t + 5.5, t + 6),
            *span("moe.route", t + 6.1, t + 6.35),
            *span("moe.route.bwd", t + 7.5, t + 8),
            *span("model.embed.bwd", t + 8.5, t + 8.7)]


@pytest.mark.parametrize("name, want", [
    # route 0.5 + shared.bwd's own 2 - 1 + the recomputed route 0.25 + route.bwd 0.5
    ("moe_device_ms", 2250.0),
    ("embed_device_ms", 400.0), ("head_device_ms", 800.0),
    ("recompute_device_ms", 1000.0), ("bwd_device_ms", 4500.0),
])
def test_a_recomputed_block_inside_a_backward_interval_is_not_that_layers_work(name, want):
    run = run_of(recomputed_inside_a_backward_interval(0.0)
                 + recomputed_inside_a_backward_interval(20.0))
    assert read(name, run) == pytest.approx(want, abs=0.01)


def stamped_out_of_order(t: float):
    """A step of 10 s from ``t`` whose trace stamps a run of kernels before
    kernels launched earlier on the same stream, as a traced window on the
    H100 showed: ``moe.shared``'s end and ``model.block``'s end read before
    ``moe.combine``'s end and ``moe.shared``'s begin."""
    return [*span("train.step", t, t + 10),
            *span("train.forward", t + 1, t + 4), work(t + 1, t + 4),
            mark("model.block", False, t + 1.2 - US), *span("moe.route", t + 1.5, t + 1.8),
            mark("moe.combine", False, t + 2.0 - US),
            mark("moe.shared", True, t + 2.6), mark("model.block", True, t + 2.62),
            mark("moe.combine", True, t + 2.7), mark("moe.shared", False, t + 2.72 - US),
            *span("train.backward", t + 4.5, t + 8), work(t + 4.5, t + 8),
            *span("moe.route.bwd", t + 5, t + 5.5),
            *span("train.optimizer", t + 8.2, t + 9.5), work(t + 8.5, t + 9)]


@pytest.mark.parametrize("name, want", [
    # route 0.3 + combine 0.7 + route.bwd 0.5; the shared span's stamps
    # invert it, so it holds nothing
    ("moe_device_ms", 1500.0), ("fwd_device_ms", 3000.0), ("optim_device_ms", 500.0),
])
def test_marks_stamped_out_of_launch_order_still_pair_per_span(name, want):
    run = run_of(stamped_out_of_order(0.0) + stamped_out_of_order(20.0))
    assert read(name, run) == pytest.approx(want, abs=0.01)
    found = _spans.spans(run)
    assert found.spans["model.block"] == [(1.2, 2.62), (21.2, 22.62)]
    assert not found.unpaired


def test_a_decode_begun_before_the_window_is_left_out():
    dev = step(0.0, decode=(3.5, 5.0)) + [mark("rpc.decode", True, -0.5)]
    found = _spans.spans(run_of(dev))
    assert found.spans["rpc.decode"] == [(3.5, 5.0)] and not found.unpaired


@pytest.mark.parametrize("name, want", [
    ("fwd_device_ms", 1500.0), ("bwd_device_ms", 1000.0), ("fwd_idle_ms", 1000.0),
])
def test_decode_marks_of_another_thread_are_taken_out_of_the_phase_they_land_in(name, want):
    # the stream runs the prefetch thread's decode between two pieces of the
    # forward: its copy and GF products are not the forward's, nor idle; the
    # forward's kernel that ran inside the decode's marks stays the forward's
    dev = [*span("train.step", 0, 10), *span("train.forward", 1, 4), work(1.5, 2.0),
           *span("rpc.decode", 2.0, 2.6), work(2.0, 2.3, "void gf_matmul_kernel()"),
           ("memcpy", "Memcpy HtoD (Pageable -> Device)", 2.3, 2.5),
           work(2.5, 3.5), *span("train.backward", 4.5, 8), work(5, 6),
           *span("train.optimizer", 8.2, 9.5), work(8.5, 9)]
    assert read(name, run_of(dev)) == pytest.approx(want, abs=0.01)


def test_a_decode_left_open_by_the_window_lasts_to_its_end():
    dev = step(0.0) + [mark("rpc.decode", False, 9.0), work(9.1, 9.2, "void gf_matmul_kernel()")]
    run = run_of(dev)
    assert read("optim_device_ms", run) == pytest.approx(500.0, abs=0.01)
    assert read("fwd_device_ms", run) == pytest.approx(2000.0, abs=0.01)
    found = _spans.spans(run)
    assert found.spans["rpc.decode"] == [(9.0 + US, 10.0 + US)]


@pytest.mark.parametrize("broken, name", [
    ([mark("train.forward", False, 30.0)], "fwd_device_ms"),  # a begin with no end
    ([mark("train.backward", True, 30.0)], "bwd_device_ms"),  # an end with no begin
    ([mark("moe.route.bwd", False, 30.0)], "moe_device_ms"),
])
def test_an_unpaired_mark_gives_nothing_for_its_span_only(broken, name):
    run = run_of(step(0.0) + broken)
    assert read(name, run) is None
    assert read("optim_device_ms", run) == pytest.approx(500.0, abs=0.01)


@pytest.mark.parametrize("name", ["fwd_device_ms", "recompute_device_ms", "moe_device_ms",
                                  "embed_device_ms", "head_device_ms", "bwd_idle_ms"])
def test_a_trace_without_marks_gives_nothing(name):
    assert read(name, run_of([work(0.0, 1.0)])) is None
    assert read(name, Run(None)) is None


def test_the_marks_of_two_threads_interleaved_pair_by_name():
    # the decode begins inside the forward and ends inside the backward; the
    # backward's own kernels that the stream ran inside it stay the backward's
    dev = step(0.0, decode=(3.5, 5.0))
    found = _spans.spans(run_of(sorted(dev, key=lambda d: d[2])))
    assert found.spans["rpc.decode"] == [(3.5, 5.0)]
    assert found.spans["train.forward"] == [(1.0, 4.0)]
    assert read("fwd_device_ms", run_of(dev)) == pytest.approx(2000.0, abs=0.01)
    assert read("bwd_device_ms", run_of(dev)) == pytest.approx(3000.0, abs=0.01)


@pytest.mark.parametrize("name, counts, want", [
    ("moe_drop_pct", {"moe.assignments": 200.0, "moe.dropped": 30.0}, 15.0),
    ("moe_pad_pct", {"moe.slots": 400.0, "moe.slots_filled": 300.0}, 25.0),
    ("prefetch_busy_ms", {"data.batch_s": 0.5}, 250.0),
    ("moe_drop_pct", {}, None),
])
def test_counter_readers_divide_by_the_programs_own_counts(monkeypatch, name, counts, want):
    monkeypatch.setattr(program, "counters", lambda: {"train.steps": 2.0, **counts})
    got = read(name, run_of(step(0.0)))
    assert got == (None if want is None else pytest.approx(want))
    assert read(name, Run(None)) is None


@pytest.mark.cuda
def test_a_marks_kernel_appears_in_a_real_trace_under_its_number():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the marks are CUDA kernels")
    from torch.profiler import ProfilerActivity, profile

    x = torch.ones(1024, device="cuda")
    program.mark_library()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with program.span("train.step", x):
            with program.span("train.forward", x):
                y = x * 2
        torch.cuda.synchronize()
    traced = read_trace(prof)
    names = [n for c, n, _, _ in traced.device if "trace_mark_kernel" in n]
    number = 2 * program.NUMBER["train.forward"]
    assert any(f"trace_mark_kernel<{number}>" in n for n in names), names
    found = _spans.Spans(traced, program.MARKED)
    (a, b), = found.spans["train.forward"]
    assert found.work.measure(a, b) > 0 and float(y.sum()) == 2048.0
