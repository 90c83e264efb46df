"""Input records for every (arch x shape) cell, as ``repro/launch/shapes.py``.

Where the JAX package builds sharded ``ShapeDtypeStruct``s, these return
:class:`Input` records: the global shape, the dtype and the partition
(``sharding.logical_to_spec``'s tuple) of each input of a step.  Nothing is
allocated.  ``[audio]``/``[vlm]`` archs receive precomputed frame/patch
embeddings (the modality frontend is a stub).
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.configs.base import ArchConfig, ShapeCell
from repro_torch.models.model import build
from repro_torch.sharding import ParamSpec, local_shape, logical_to_spec

# microbatch counts for train_4k (activation-memory control), the JAX package's
TRAIN_MICROBATCHES = {
    "command-r-plus-104b": "max",  # one sample per device per microbatch
    "yi-9b": 8,
    "granite-8b": 8,
    "falcon-mamba-7b": 8,
    "starcoder2-3b": 4,
    "phi-3-vision-4.2b": 4,
    "qwen3-moe-30b-a3b": 4,
    "deepseek-v2-lite-16b": 4,
    "hymba-1.5b": 4,
    "whisper-tiny": 1,
}


@dataclasses.dataclass(frozen=True)
class Input:
    """One input of a step: global shape, dtype, logical axes and partition."""

    shape: tuple[int, ...]
    dtype: torch.dtype
    axes: tuple[str | None, ...]
    spec: tuple

    def local(self, mesh) -> tuple[int, ...]:
        """One device's shard of the input."""
        return local_shape(self.shape, self.spec, mesh)

    def local_bytes(self, mesh) -> int:
        n = self.dtype.itemsize
        for d in self.local(mesh):
            n *= d
        return n


def _input(shape, dtype, axes, rules, mesh) -> Input:
    shape = tuple(shape)
    return Input(shape, dtype, tuple(axes), logical_to_spec(axes, shape, rules, mesh))


def num_microbatches(cfg: ArchConfig, shape: ShapeCell, mesh) -> int:
    if shape.kind != "train":
        return 1
    dp = 1
    for a in ("pod", "data"):
        if a in mesh.shape:
            dp *= mesh.shape[a]
    req = TRAIN_MICROBATCHES.get(cfg.name, 1)
    cap = max(shape.global_batch // dp, 1)
    return cap if req == "max" else min(req, cap)


def batch_specs(cfg: ArchConfig, shape: ShapeCell, rules, mesh) -> dict[str, Input]:
    """The data-batch inputs of a train or prefill cell (decode: :func:`decode_specs`)."""
    gb, s = shape.global_batch, shape.seq_len

    def tok():
        return _input((gb, s), torch.int32, ("batch", "seq"), rules, mesh)

    def emb():
        return _input((gb, s, cfg.d_model), torch.bfloat16, ("batch", "seq", "embed_act"),
                      rules, mesh)

    if shape.kind == "train":
        if cfg.is_encdec:
            frames = _input((gb, cfg.enc_seq, cfg.d_model), torch.bfloat16,
                            ("batch", "frames", "embed_act"), rules, mesh)
            return {"frames": frames, "tokens": tok(), "labels": tok()}
        if cfg.input_mode == "embeddings":
            return {"embeddings": emb(), "labels": tok()}
        return {"tokens": tok(), "labels": tok()}
    if shape.kind == "prefill":
        if cfg.is_encdec:  # prefill = encoder pass over `seq_len` frames
            return {"frames": _input((gb, s, cfg.d_model), torch.bfloat16,
                                     ("batch", "frames", "embed_act"), rules, mesh)}
        if cfg.input_mode == "embeddings":
            return {"embeddings": emb()}
        return {"tokens": tok()}
    raise ValueError(shape.kind)


def decode_specs(cfg: ArchConfig, shape: ShapeCell, rules, mesh, *, long_mode: bool):
    """(cache inputs, token input, position input) of a decode cell."""
    cache = {name: _input(sp.shape, sp.dtype, sp.axes, rules, mesh)
             for name, sp in build(cfg).cache_specs(shape.global_batch, shape.seq_len,
                                                    long_mode=long_mode).items()}
    tokens = _input((shape.global_batch, 1), torch.int32, ("batch", None), rules, mesh)
    pos = Input((), torch.int32, (), ())
    return cache, tokens, pos


def serve_param_specs(model) -> dict[str, ParamSpec]:
    """bf16 inference weights (no optimizer, no master copies)."""
    return {k: dataclasses.replace(sp, dtype=torch.bfloat16)
            for k, sp in model.param_specs().items()}
