"""The comparison that decides ``correct``.

Each number compared has a limit of its own, set from two readings on the
chip (``PERF.md`` gives them): sound runs of the program against the
reference (the lower) and the control or a planted fault against the
reference (the upper).  A cell's limits are ``bench/limits/<cell>.json``,
which names the numbers it compares; a number with no upper reading is read
and recorded but not compared.

* ``tokens_wrong``: tokens of every step's batch (the check's steps and the
  window's) that differ from the corpus at the dataset's offsets; exact,
  limit 0.  The offsets are worked out again from the dataset's order rule
  (``np.random.default_rng(seed).permutation`` of the examples, read in
  turn, a new permutation each epoch).
* The first ``check_steps`` steps of the program against the reference's, on
  the same weights and batches (taken from the corpus here):

  - ``loss_gap``: the largest gap of a step's loss (nats); ``first_loss_gap``
    the first step's alone (where the later steps' losses swing from seed to
    seed);
  - ``grad_norm_gap``: the largest gap of a step's global gradient norm,
    relative to the reference's;
  - ``grad_leaf_gap``: leaf by leaf, the gap between the norms of the first
    step's gradient as AdamW received it (clipped; the program's worked out
    from its first moment, m / (1 - b1)), relative to the reference's leaf
    norm or to the median leaf's, whichever is larger; every leaf but the
    token embedding, whose gradient the program sums by token id in bfloat16
    and which reads its own gap, ``embed_grad_gap`` (recorded, not compared:
    ``PERF.md`` gives why);
  - ``change_leaf_gap``: the same of each leaf's change over the steps,
    leaving out leaves whose reference gradient is under a thousandth of the
    median leaf's (AdamW moves those by rounding alone);
  - ``grad_median_leaf_gap``, ``change_median_leaf_gap``: the median leaf's
    gap instead of the worst's, steady where one leaf or the later steps
    swing.
"""
from __future__ import annotations

import dataclasses
import json
import pathlib
import statistics

import numpy as np
import torch

from inputs import make_leaf, make_weights

LIMITS = pathlib.Path(__file__).resolve().parent / "limits"
QUIET_LEAF = 1e-3  # a leaf whose reference gradient is under this share of the median's
GATHERED = "embed"  # the token embedding: its gradient is summed by token id


@dataclasses.dataclass
class Check:
    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return self.value <= self.limit


def _examples(order_seed: int, n_examples: int):
    """The dataset's example indices, in the order it reads them."""
    rng = np.random.default_rng(order_seed)
    while True:
        yield from rng.permutation(n_examples)


def example_offsets(order_seed: int, n_tokens: int, batch: int, seq: int,
                    steps: int) -> list[list[int]]:
    """The first token of each example of each of the first ``steps`` batches."""
    ex = _examples(order_seed, n_tokens // (seq + 1))
    return [[int(next(ex)) * (seq + 1) for _ in range(batch)] for _ in range(steps)]


def tokens_wrong(steps, corpus: np.ndarray, batch: int, seq: int, order_seed: int) -> Check:
    offsets = example_offsets(order_seed, corpus.size, batch, seq, len(steps))
    wrong = 0
    for step, offs in zip(steps, offsets):
        want = np.stack([corpus[o:o + seq + 1] for o in offs])
        x, y = np.asarray(step.x), np.asarray(step.y)
        if x.shape != (batch, seq) or y.shape != (batch, seq):
            wrong += batch * seq
            continue
        wrong += int((x != want[:, :-1]).sum() + (y != want[:, 1:]).sum())
    return Check("tokens_wrong", float(wrong), 0.0)


def _leaf_gaps(a: dict, r: dict, keys) -> dict[str, float]:
    keys = list(keys)
    floor = statistics.median(r[k] for k in keys)
    return {k: abs(a[k] - r[k]) / max(r[k], floor, 1e-30) for k in keys}


def _moving(ref: dict) -> list[str]:
    g = ref["leaf_grad_norms"]
    median = statistics.median(g.values())
    return [k for k in g if g[k] >= QUIET_LEAF * median]


def worst_leaves(prog: dict, ref: dict, top: int = 3) -> dict[str, list]:
    """The leaves with the largest gaps, for the record."""
    out = {}
    for name, key, keys in (("grad", "leaf_grad_norms", ref["leaf_grad_norms"]),
                            ("change", "leaf_change_norms", _moving(ref))):
        gaps = _leaf_gaps(prog[key], ref[key], keys)
        out[name] = sorted(([k, v, prog[key][k], ref[key][k]] for k, v in gaps.items()),
                           key=lambda row: -row[1])[:top]
    return out


def readings(prog: dict, ref: dict) -> dict[str, float]:
    """The numbers compared, of ``prog`` against ``ref``: each a dict of
    ``loss`` and ``grad_norm`` (lists by step), ``leaf_grad_norms`` and
    ``leaf_change_norms`` (by leaf)."""
    g = ref["leaf_grad_norms"]
    grad = _leaf_gaps(prog["leaf_grad_norms"], g, g)
    change = _leaf_gaps(prog["leaf_change_norms"], ref["leaf_change_norms"], _moving(ref))
    return {
        "loss_gap": max(abs(a - b) for a, b in zip(prog["loss"], ref["loss"])),
        "first_loss_gap": abs(prog["loss"][0] - ref["loss"][0]),
        "grad_norm_gap": max(abs(a - b) / b for a, b in zip(prog["grad_norm"], ref["grad_norm"])),
        "grad_leaf_gap": max(v for k, v in grad.items() if k != GATHERED),
        "embed_grad_gap": grad[GATHERED],
        "grad_median_leaf_gap": statistics.median(grad.values()),
        "change_leaf_gap": max(change.values()),
        "change_median_leaf_gap": statistics.median(change.values()),
    }


def reference_steps(cell, model, table, corpus: np.ndarray, offsets, seq: int, seed: int,
                    dev, precision: str = "f32", half: bool = False) -> dict:
    """The reference's first steps from the seed's weights on the corpus's
    batches at ``offsets``.  Float32 with TF32 off, or the control's fp8;
    ``half``: the first half of each batch's rows alone, in microbatches of
    the same size (a planted fault)."""
    from reference.common import AdamW, Precision, leaf_norm, strict_f32, train_steps

    strict_f32()
    tr = cell.traffic
    params = make_weights(table, seed, dev)
    batches = []
    for offs in offsets:
        toks = torch.as_tensor(np.stack([corpus[o:o + seq + 1] for o in offs]), device=dev)
        x, y = toks[:, :-1].long(), toks[:, 1:].long()
        if half:
            x, y = x[:x.shape[0] // 2], y[:y.shape[0] // 2]
        batches.append((x, y))
    microbatches = max(tr["microbatches"] // 2, 1) if half else tr["microbatches"]
    recs = train_steps(model, params, batches, AdamW(**tr["optimizer"]), microbatches,
                       Precision(precision))
    change = {k: leaf_norm(p - make_leaf(table[k], k, seed, dev)) for k, p in params.items()}
    del params
    return {"loss": [r["loss"] for r in recs], "grad_norm": [r["grad_norm"] for r in recs],
            "leaf_grad_norms": recs[0]["leaf_grad_norms"], "leaf_change_norms": change}


def limits(cell_name: str) -> dict[str, float]:
    return json.loads((LIMITS / f"{cell_name}.json").read_text())


def judge(got: dict[str, float], lim: dict[str, float]) -> list[Check]:
    """The numbers of ``got`` that ``lim`` compares, each with its limit."""
    return [Check(name, got[name], limit) for name, limit in lim.items()]


def training(cell, model, table, corpus, offsets, seq, prog, seed, dev):
    """(the checks of the program's first steps, what they read for the record)."""
    ref = reference_steps(cell, model, table, corpus, offsets, seq, seed, dev)
    lim = limits(cell.name)
    got = readings(prog, ref)
    detail = {"worst_leaves": worst_leaves(prog, ref),
              "not_compared": {k: v for k, v in got.items() if k not in lim},
              **{f"{side}_{k}": v[k] for side, v in (("prog", prog), ("ref", ref))
                 for k in ("loss", "grad_norm")}}
    return judge(got, lim), detail
