"""The collectives of the port's mesh (``repro_torch/distributed.py``), its
launcher (``launch/mesh.py``), the rank shards of ``sharding.py`` and the
table of collectives around each product, on the CPU.

One 2 x 2 ``("data", "model")`` world of four Gloo processes (a module
fixture) checks, on each rank, against sums written out from every rank's
inputs (each rank can make all of them from their ranks):

* ``all_reduce`` (sum, max), ``all_gather`` and ``reduce_scatter`` along a
  middle dim, over each axis, by both routes: the native one Gloo takes on
  the CPU and the one built from ``all_reduce`` that a card tensor takes
  (``ROUTES`` patched inside the rank), bf16 and signed zeros included;
* ``all_reduce`` of inputs whose strides differ between ranks, and
  ``broadcast``, which refuses a tensor that is not contiguous;
* the autograd pairs: the forward value and the gradient of
  ``sum(u_r * y_r)`` with a different ``u_r`` on every rank, for
  ``fsdp_gather``, ``reduce_g``, ``copy_f``, ``gather_out`` and ``pmean``;
* ``shard_params`` then ``unshard`` gives every leaf back whole, under
  ``TRAIN_RULES`` and ``DECODE_RULES``, with each shard the slice its
  coordinates name.

Without a world: ``product_plans`` for granite-smoke on a 2 x 2 mesh under
both rule tables (the Megatron layout in training, row-parallel decode), and
the launcher fails with a rank's traceback, or on its time limit, instead
of waiting.
"""
import time

import numpy as np
import pytest
import torch

from repro_torch import distributed as D
from repro_torch.configs import get_smoke
from repro_torch.launch.mesh import launch, make_local_mesh
from repro_torch.models.model import build
from repro_torch.sharding import (DECODE_RULES, TRAIN_RULES, ProductPlan, product_plans,
                                  shard_params, unshard)

DTYPES = (torch.float32, torch.bfloat16)


def _x(rank: int, dtype=torch.float32) -> torch.Tensor:
    """Rank ``rank``'s input (3, 4, 5), with a -0.0 in it."""
    gen = torch.Generator().manual_seed(100 + rank)
    x = torch.randn((3, 4, 5), generator=gen)
    x[0, 0, 0] = -0.0
    return x.to(dtype)


def _u(rank: int, shape) -> torch.Tensor:
    """Rank ``rank``'s upstream gradient."""
    return torch.randn(shape, generator=torch.Generator().manual_seed(200 + rank))


def _members(mesh, axis) -> list[int]:
    """The world ranks on ``axis`` with this rank, in the axis's order."""
    data, model = mesh.coords["data"], mesh.coords["model"]
    if axis.name == "data":
        return [d * mesh.shape["model"] + model for d in range(mesh.shape["data"])]
    return [data * mesh.shape["model"] + m for m in range(mesh.shape["model"])]


def _grad(fn, x, u):
    x = x.detach().float().requires_grad_(True)
    y = fn(x)
    (gx,) = torch.autograd.grad((y * u).sum(), [x])
    return y.detach(), gx


def _rank(mesh) -> dict:
    errs: dict[str, float] = {}

    def check(key, got, want):
        same = got.dtype == want.dtype and got.shape == want.shape
        errs[key] = float((got.float() - want.float()).abs().max()) if same else float("inf")

    for route in ("native", "all_reduce"):
        D.ROUTES[("gloo", "cpu")] = route
        for name in ("data", "model"):
            ax = mesh.axis(name)
            ranks = _members(mesh, ax)
            for dtype in DTYPES:
                xs = [_x(r, dtype) for r in ranks]
                key = f"{route}.{name}.{dtype}"
                gathered = D.all_gather(xs[ax.index], ax, 1)
                check(f"{key}.all_gather", gathered, torch.cat(xs, 1))
                errs[f"{key}.all_gather.signbit"] = float(
                    (torch.signbit(gathered) != torch.signbit(torch.cat(xs, 1))).sum())
                total = sum(x.float() for x in xs)
                want = total.to(dtype).narrow(1, ax.index * 2, 2)
                check(f"{key}.reduce_scatter", D.reduce_scatter(xs[ax.index], ax, 1), want)
                check(f"{key}.sum", D.all_reduce(xs[ax.index], ax), total.to(dtype))
                check(f"{key}.max", D.all_reduce(xs[ax.index], ax, "max"),
                      torch.stack(xs).amax(0))
    D.ROUTES[("gloo", "cpu")] = "native"
    for name in ("data", "model"):
        ax = mesh.axis(name)
        ranks = _members(mesh, ax)
        xs = [_x(r) for r in ranks]
        mine = xs[ax.index]
        cat = torch.cat(xs, 1)
        us = [_u(r, cat.shape) for r in ranks]
        y, g = _grad(lambda x: D.fsdp_gather(x, ax, 1), mine, us[ax.index])
        check(f"fsdp_gather.{name}.y", y, cat)
        check(f"fsdp_gather.{name}.grad", g, sum(us).narrow(1, ax.index * 4, 4))
        us = [_u(r, mine.shape) for r in ranks]
        y, g = _grad(lambda x: D.reduce_g(x, ax), mine, us[ax.index])
        check(f"reduce_g.{name}.y", y, sum(xs))
        check(f"reduce_g.{name}.grad", g, us[ax.index])
        y, g = _grad(lambda x: D.copy_f(x, ax), mine, us[ax.index])
        check(f"copy_f.{name}.y", y, mine)
        check(f"copy_f.{name}.grad", g, sum(us))
        y, g = _grad(lambda x: D.pmean(x, ax), mine, us[ax.index])
        check(f"pmean.{name}.y", y, sum(xs) / len(xs))
        check(f"pmean.{name}.grad", g, us[ax.index])
        us = [_u(r, cat.shape) for r in ranks]
        y, g = _grad(lambda x: D.gather_out(x, ax, 1), mine, us[ax.index])
        check(f"gather_out.{name}.y", y, cat)
        check(f"gather_out.{name}.grad", g, us[ax.index].narrow(1, ax.index * 4, 4))
    # layouts: all_reduce sums each rank's values in their logical order though the
    # ranks' strides differ (the first rank's input a transposed view); broadcast,
    # in place, refuses a tensor that is not contiguous
    ax = mesh.axis("model")
    xs = [_x(r) for r in _members(mesh, ax)]
    mine = xs[ax.index].transpose(0, 2).contiguous().transpose(0, 2) if ax.index == 0 \
        else xs[ax.index]
    check("all_reduce.strides", D.all_reduce(mine, ax), sum(xs))
    t = xs[ax.index].clone()
    D.broadcast(t, ax, 0)
    check("broadcast", t, xs[0])
    try:
        D.broadcast(mine.transpose(0, 1), ax, 0)
        errs["broadcast.non_contiguous_refused"] = 1.0
    except ValueError:
        errs["broadcast.non_contiguous_refused"] = 0.0
    # shard_params / unshard
    model = build(get_smoke("granite-8b"))
    specs = {**model.param_specs(), **{f"cache.{k}": s for k, s in model.cache_specs(4, 16).items()}}
    gen = torch.Generator().manual_seed(7)
    full = {k: torch.randn(s.shape, generator=gen) for k, s in specs.items()}
    for rules, tag in ((TRAIN_RULES, "train"), (DECODE_RULES, "decode")):
        shards = shard_params(full, specs, rules, mesh, mesh.coords)
        back = unshard(shards, specs, rules, mesh)
        errs[f"roundtrip.{tag}"] = max(float((back[k] - full[k]).abs().max()) for k in full)
        errs[f"shard_bytes.{tag}"] = sum(t.numel() for t in shards.values())
    return errs


@pytest.fixture(scope="module")
def world():
    return launch(_rank, data=2, model=2, device="cpu", timeout=300)


def test_collectives_and_their_autograd_pairs(world):
    for rank, errs in enumerate(world):
        bad = {k: v for k, v in errs.items() if not k.startswith("shard_bytes") and v != 0.0}
        assert not bad, (rank, bad)


def test_each_rank_holds_its_share_of_the_leaves(world):
    """Under TRAIN_RULES every leaf but the norms splits over both axes or one
    of them; under DECODE_RULES over model only: each rank's element counts."""
    model = build(get_smoke("granite-8b"))
    specs = {**model.param_specs(), **{f"cache.{k}": s for k, s in model.cache_specs(4, 16).items()}}
    mesh = make_local_mesh(2, 2)
    from repro_torch.sharding import local_shape, logical_to_spec

    for tag, rules in (("train", TRAIN_RULES), ("decode", DECODE_RULES)):
        want = sum(int(np.prod(local_shape(s.shape, logical_to_spec(s.axes, s.shape, rules, mesh),
                                           mesh))) for s in specs.values())
        assert [errs[f"shard_bytes.{tag}"] for errs in world] == [want] * 4


def test_product_plans_follow_the_rules():
    specs = build(get_smoke("granite-8b")).param_specs()
    mesh = make_local_mesh(2, 2)
    f, g, cut, gather = (ProductPlan(True, False, False, False), ProductPlan(False, False, True, False),
                         ProductPlan(True, True, True, False), ProductPlan(True, False, False, True))
    train = product_plans(specs, TRAIN_RULES, mesh)
    assert train == {"wq": f, "wk": f, "wv": f, "wo": g, "gate": f, "up": f, "down": g,
                     "lm_head": f, "embed": f}
    decode = product_plans(specs, DECODE_RULES, mesh)
    assert decode == {"wq": cut, "wk": cut, "wv": cut, "wo": gather, "gate": cut, "up": cut,
                      "down": gather, "lm_head": f, "embed": f}


def _fails(mesh, hang: bool):
    if mesh.rank == 1:
        if hang:
            time.sleep(120)
        raise ValueError("rank one gives up")
    return mesh.rank


def test_launch_fails_with_the_rank_traceback():
    with pytest.raises(RuntimeError, match="rank 1 of 2 failed(.|\n)*rank one gives up"):
        launch(_fails, False, data=1, model=2, device="cpu", timeout=120)


def test_launch_stops_a_world_that_outlives_its_time_limit():
    t = time.monotonic()
    with pytest.raises(TimeoutError, match="did not finish in 8 s"):
        launch(_fails, True, data=1, model=2, device="cpu", timeout=8)
    assert time.monotonic() - t < 40
