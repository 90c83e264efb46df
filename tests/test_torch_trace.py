"""The port's spans, device marks and counters (``repro_torch/trace.py``) on
the CPU, in a small deepseek-shaped model: MLA, a leading dense layer and a
MoE layer, trained in 2 microbatches.

On the CPU a mark launches nothing, so the mark tests stand a recorder in
for the launcher and let every tensor count as on the card: the order of the
recorded numbers is the order a stream would run them in, since the CPU's
autograd runs on the calling thread.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from repro_torch import trace
from repro_torch.configs import get_smoke
from repro_torch.data.pipeline import BlobTokenDataset, write_token_corpus
from repro_torch.launch.cluster import build_cluster
from repro_torch.models import moe as moe_mod
from repro_torch.models.model import build
from repro_torch.sharding import init_params
from repro_torch.storage.blob import BlobLayout
from repro_torch.train import optimizer as opt
from repro_torch.train.step import make_train_step


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


CFG = dataclasses.replace(get_smoke("deepseek-v2-lite-16b"), num_layers=2)  # 1 dense + 1 MoE
MICROBATCHES = 2


def _state(seed: int = 0) -> dict:
    gen = torch.Generator().manual_seed(seed)
    return opt.init_state(init_params(build(CFG).param_specs(), gen, device="cpu"))


def _batch(seed: int) -> dict:
    gen = torch.Generator().manual_seed(1000 + seed)
    toks = torch.randint(0, CFG.vocab, (4, 17), generator=gen)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def _steps(n: int, traced: bool):
    """``n`` train steps from the same state and batches, under a CPU
    profiler when ``traced``: (loss, state, the profiler or None)."""
    step = make_train_step(CFG, num_microbatches=MICROBATCHES)
    state = _state()
    prof = profile(activities=[ProfilerActivity.CPU]) if traced else None
    if prof is not None:
        prof.__enter__()
    try:
        for i in range(n):
            state, metrics = step(state, _batch(i))
    finally:
        if prof is not None:
            prof.__exit__(None, None, None)
    return metrics["loss"], state, prof


@pytest.fixture
def marks(monkeypatch):
    """Every tensor counts as on the card; each mark's number is recorded."""
    seen: list[int] = []
    monkeypatch.setattr(trace, "_cuda_index", lambda on: None if on is None else 0)
    monkeypatch.setattr(trace, "_launch_mark", lambda number, index: seen.append(number))
    return seen


def _spans(prof) -> dict[str, list[tuple[float, float]]]:
    out: dict[str, list[tuple[float, float]]] = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CPU and e.name() in trace.MARKED + ("rpc.verify",):
            s = e.start_ns()
            out.setdefault(e.name(), []).append((s, s + e.duration_ns()))
    return out


def _pairs(seen: list[int]) -> dict[str, list[tuple[int, int]]]:
    """Each span's (begin, end) positions in the mark sequence, paired like
    brackets; fails on a mark left unpaired."""
    open_: dict[str, list[int]] = {}
    out: dict[str, list[tuple[int, int]]] = {}
    for pos, number in enumerate(seen):
        name, end = trace.mark_name(number)
        if end:
            out.setdefault(name, []).append((open_[name].pop(), pos))
        else:
            open_.setdefault(name, []).append(pos)
    assert not any(open_.values()), open_
    return out


def test_without_a_profiler_a_span_is_the_shared_noop_and_nothing_is_loaded(monkeypatch):
    def refuse(*args):
        raise AssertionError("a mark launched with no profiler")

    monkeypatch.setattr(trace, "_launch_mark", refuse)
    monkeypatch.setattr(trace, "_cuda_index", lambda on: 0)
    trace.mark_library.cache_clear()
    before = trace.counters()
    assert trace.span("train.step", torch.zeros(1)) is trace.NOOP
    assert trace.span("rpc.verify") is trace.NOOP
    x = torch.ones(2, requires_grad=True)
    with trace.span("moe.route", x) as sp:
        assert sp.inputs(x) is x and sp.outputs(x, x) == (x, x)
    _steps(1, traced=False)
    assert trace.mark_library.cache_info().currsize == 0
    assert trace.counters() == before


@pytest.fixture(scope="module")
def traced_spans():
    _, _, prof = _steps(1, traced=True)
    return _spans(prof)


def _inside(inner, outer) -> bool:
    return outer[0] <= inner[0] and inner[1] <= outer[1]


@pytest.mark.parametrize("outer, inner", [
    ("train.step", "train.forward"),
    ("train.forward", "moe.dispatch"),
    ("train.forward", "model.embed"),
    ("train.forward", "model.xent"),
    ("attn.mla", "attn.kernel"),
    ("model.block", "moe.combine"),
    ("train.step", "train.optimizer"),
    ("train.step", "train.accumulate"),
    # recomputation: the forward's model spans again, inside the backward
    ("train.backward", "moe.dispatch"),
    ("train.backward", "model.block"),
    ("train.backward", "attn.kernel"),
])
def test_spans_nest_under_a_cpu_profiler(traced_spans, outer, inner):
    assert traced_spans[inner] and traced_spans[outer]
    assert any(_inside(i, o) for i in traced_spans[inner] for o in traced_spans[outer])


@pytest.mark.parametrize("name, per_step", [
    ("train.step", 1), ("train.forward", MICROBATCHES), ("train.backward", MICROBATCHES),
    ("train.optimizer", 1), ("train.accumulate", MICROBATCHES + 2),
    ("model.embed", MICROBATCHES), ("model.head", MICROBATCHES),
    # each layer in the forward and again in its recomputation
    ("model.block", 2 * 2 * MICROBATCHES), ("moe.route", 2 * MICROBATCHES),
])
def test_each_span_appears_as_often_as_the_step_runs_it(traced_spans, name, per_step):
    assert len(traced_spans[name]) == per_step
    if name.startswith(("model.", "moe.")) and name != "model.block":
        forward = traced_spans["train.forward"]
        # a recomputed span lies in the backward, never in the forward
        in_forward = sum(any(_inside(s, f) for f in forward) for s in traced_spans[name])
        assert in_forward == MICROBATCHES


@pytest.fixture
def step_marks(marks):
    _steps(1, traced=True)
    return _pairs(marks)


@pytest.mark.parametrize("name", [n for n in trace.MARKED if n != "rpc.decode"])
def test_every_marked_span_of_the_step_pairs_its_marks(step_marks, name):
    assert step_marks[name]


@pytest.mark.parametrize("name, per_microbatch", [
    ("model.embed.bwd", 1), ("moe.dispatch.bwd", 1), ("moe.combine.bwd", 1),
    ("attn.kernel.bwd", CFG.num_layers), ("mlp.bwd", 1), ("model.head.bwd", 1)])
def test_backward_intervals_lie_inside_the_backward(step_marks, name, per_microbatch):
    backward = step_marks["train.backward"]
    assert len(step_marks[name]) == per_microbatch * MICROBATCHES
    assert all(any(_inside(s, b) for b in backward) for s in step_marks[name])


def test_backward_intervals_run_in_reverse_forward_order(step_marks):
    order = ["moe.shared.bwd", "moe.combine.bwd", "moe.experts.bwd", "moe.dispatch.bwd",
             "moe.route.bwd"]
    firsts = [step_marks[n][0] for n in order]
    assert all(a[1] < b[0] for a, b in zip(firsts, firsts[1:])), firsts
    head, xent = step_marks["model.head.bwd"][0], step_marks["model.xent.bwd"][0]
    assert xent[1] < head[0]


@pytest.mark.parametrize("traced_steps", [1, 2])
def test_marked_steps_equal_unmarked_ones_bit_for_bit(marks, traced_steps):
    """Loss and the whole state after the steps, with marks and backward
    intervals, against a step with no profiler."""
    loss0, state0, _ = _steps(traced_steps, traced=False)
    loss1, state1, _ = _steps(traced_steps, traced=True)
    assert marks  # the traced run marked
    assert torch.equal(loss0, loss1)
    for part in ("params", "m", "v"):
        for k in state0[part]:
            assert torch.equal(state0[part][k], state1[part][k]), (part, k)


def test_the_step_counts_itself_only_while_traced():
    before = trace.counters().get("train.steps", 0.0)
    _steps(1, traced=False)
    assert trace.counters().get("train.steps", 0.0) == before
    _steps(2, traced=True)
    assert trace.counters()["train.steps"] == before + 2


@pytest.mark.parametrize("capacity_factor, drops", [(0.5, True), (1.25, None), (8.0, False)])
def test_moe_counters_equal_a_numpy_recount_of_the_routing(capacity_factor, drops):
    cfg = dataclasses.replace(CFG, moe=dataclasses.replace(CFG.moe,
                                                           capacity_factor=capacity_factor))
    gen = torch.Generator().manual_seed(7)
    params = init_params(moe_mod.moe_specs(cfg, 1), gen, device="cpu")
    layer = {k: v[0] for k, v in params.items()}
    x = torch.randn(2, 24, cfg.d_model, generator=gen).to(torch.bfloat16)
    x_flat = x.reshape(-1, cfg.d_model)
    idx, _, _, _ = moe_mod._route(x_flat, layer["router"], cfg.moe.top_k)
    capacity = moe_mod.capacity_of(x_flat.shape[0], cfg)
    per_expert = np.bincount(idx.numpy().ravel(), minlength=cfg.moe.num_experts)
    want = {"moe.assignments": per_expert.sum(),
            "moe.dropped": np.maximum(per_expert - capacity, 0).sum(),
            "moe.slots_filled": np.minimum(per_expert, capacity).sum(),
            "moe.slots": cfg.moe.num_experts * capacity}
    if drops is not None:
        assert (want["moe.dropped"] > 0) == drops
    before = trace.counters()
    with profile(activities=[ProfilerActivity.CPU]):
        out, _ = moe_mod.apply_moe(layer, x, cfg)
    after = trace.counters()
    assert {k: after[k] - before.get(k, 0.0) for k in want} == want
    assert torch.equal(out, moe_mod.apply_moe(layer, x, cfg)[0])


def _dataset(background: bool):
    layout = BlobLayout(k=4, m=2, chunkset_bytes_target=64 * 1024)
    _, _, _, client = build_cluster(num_sps=8, layout=layout, device="cpu")
    corpus = np.random.default_rng(3).integers(0, 256, 64 * 1024, dtype=np.int32)
    blob = write_token_corpus(client, corpus)
    ds = BlobTokenDataset(client, blob, batch=2, seq_len=31, seed=5, prefetch=1)
    return ds.batches(8, background=background)


def _profiled_reads(feed, n: int):
    """``n`` batches of ``feed`` under a CPU profiler: (the counters that
    grew, by how much; the names of the host events it recorded)."""
    next(feed)
    before = trace.counters()
    try:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            for _ in range(n):
                next(feed)
    finally:
        feed.close()
    after = trace.counters()
    grew = {k: after[k] - before.get(k, 0.0) for k in after if after[k] > before.get(k, 0.0)}
    return grew, {e.name() for e in prof.profiler.kineto_results.events()}


def test_the_prefetch_thread_times_its_spans_into_counters():
    """The prefetch thread starts before the profiler, which then records
    none of its host events: the pipeline counts its batches' host seconds
    itself, and no span adds a counter."""
    grew, names = _profiled_reads(_dataset(background=True), 4)
    assert set(grew) == {"data.batch_s"} and grew["data.batch_s"] > 0
    assert not {n for n in names if n.startswith(("data.", "rpc."))}


def test_a_read_on_the_profiled_thread_records_its_merkle_checks_as_spans():
    grew, names = _profiled_reads(_dataset(background=False), 4)
    assert set(grew) == {"data.batch_s"}
    assert "rpc.verify" in names and "rpc.fetch" not in names


class _FakeNvcc:
    """Stands in for ``nvcc``: writes the output file (or fails, for the
    kernels in ``failing``) and records each kernel it was started on."""

    def __init__(self, tmp_path, failing=()):
        self.log = tmp_path / "started"
        self.path = tmp_path / "nvcc"
        fail = " ".join(failing)
        self.path.write_text(
            "#!/bin/sh\n"
            'for a; do out_next=$prev; prev=$a; [ "$out_next" = "-o" ] && out=$a; done\n'
            'src=$(basename "$prev" .cu); echo "$src" >> ' + str(self.log) + "\n"
            f'for f in {fail}; do [ "$f" = "$src" ] && echo "error" && exit 1; done\n'
            'echo built > "$out"\n')
        self.path.chmod(0o755)

    def started(self) -> list[str]:
        return self.log.read_text().split() if self.log.exists() else []


@pytest.mark.parametrize("built, failing, want_started, loads", [
    ((), (), ["flash_attention", "trace_mark"], True),  # the marks beside the first kernel
    (("flash_attention",), (), [], True),  # a built kernel starts no build
    (("trace_mark",), (), ["flash_attention"], True),
    ((), ("trace_mark",), ["flash_attention", "trace_mark"], True),  # the kernel loads anyway
    ((), ("flash_attention",), ["flash_attention", "trace_mark"], False),
])
def test_a_kernel_build_builds_the_marks_beside_it(monkeypatch, tmp_path, built, failing,
                                                   want_started, loads):
    from repro_torch.kernels import _build

    csrc, out = tmp_path / "csrc", tmp_path / "build"
    csrc.mkdir()
    for name in ("flash_attention", "trace_mark"):
        (csrc / f"{name}.cu").write_text(f"// {name}\n")
    fake = _FakeNvcc(tmp_path, failing)
    monkeypatch.setattr(_build, "CSRC", csrc)
    monkeypatch.setattr(_build, "BUILD_DIR", out)
    monkeypatch.setattr(_build, "nvcc", lambda: str(fake.path))
    monkeypatch.setattr(_build.ctypes, "CDLL", lambda path: path)
    out.mkdir()
    for name in built:
        _build.library_path(name).write_text("built")
    if loads:
        assert _build.load("flash_attention") == str(_build.library_path("flash_attention"))
    else:
        with pytest.raises(RuntimeError, match="kernel build failed: flash_attention"):
            _build.load("flash_attention")
    assert sorted(fake.started()) == want_started
    marks_built = "trace_mark" in built or ("trace_mark" in want_started
                                            and "trace_mark" not in failing)
    assert _build.library_path("trace_mark").exists() == marks_built
    assert not list(out.glob("tmp*"))  # no build left half written
