"""Cell builder: (arch x input shape x mesh) -> step function + abstract
inputs; the counterpart of the JAX package's ``launch/cells.py``.

A *cell* is one dry-run unit: the step (``make_train_step`` /
``prefill_step`` / ``decode_step``) under the planner's activation rules,
and stand-ins for every input that allocate nothing.  With an abstract
mesh (:func:`repro_torch.launch.mesh.make_production_mesh`,
:class:`repro_torch.launch.mesh.Mesh`) the inputs are ``meta`` tensors;
with a ``torch.distributed`` ``DeviceMesh`` they are DTensors with the
planner's placements, whose local shards are ``meta`` tensors, or fake
ones when built under ``FakeTensorMode`` (the dry run).  ``Cell.specs``
holds every input's spec, in the structure of ``Cell.args``;
:func:`materialize` puts values behind a cell's inputs.  The step runs
under ``implicit_replication``, so plain tensors it makes (positions,
constants) count as replicated.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
from typing import Callable

import torch

from ..configs.base import SHAPES, ModelConfig
from ..models import transformer as tf
from ..sharding import specs
from ..sharding.activation import activation_sharding
from ..training.optimizer import OptState
from ..training.train_loop import (TrainConfig, make_serve_steps,
                                   make_train_step)


@dataclasses.dataclass(frozen=True)
class Cell:
    name: str
    fn: Callable
    args: tuple
    kind: str
    donate: tuple = ()   # arg indices donated (params/opt for train, cache)
    specs: tuple = ()    # every input's spec, in the structure of args


def _is_device_mesh(mesh) -> bool:
    return hasattr(mesh, "mesh_dim_names") and callable(
        getattr(mesh, "size", None))


def _stand_in(mesh, shape, dtype, spec):
    """A meta tensor, or on a ``DeviceMesh`` a DTensor with ``spec``'s
    placements over a local shard made in the current mode (``meta``
    outside ``FakeTensorMode``)."""
    shape = tuple(int(n) for n in shape)
    if not _is_device_mesh(mesh):
        return torch.empty(shape, dtype=dtype, device="meta")
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import DTensor
    from torch.utils._python_dispatch import _get_current_dispatch_mode
    local = specs.local_shape(mesh, shape, spec)
    fake = isinstance(_get_current_dispatch_mode(), FakeTensorMode)
    loc = torch.empty(local, dtype=dtype,
                      device=mesh.device_type if fake else "meta")
    return DTensor.from_local(loc, mesh, specs.placements(mesh, spec),
                              run_check=False, shape=torch.Size(shape),
                              stride=_contiguous_stride(shape))


def _contiguous_stride(shape) -> tuple:
    stride, acc = [], 1
    for n in reversed(shape):
        stride.append(acc)
        acc *= max(n, 1)
    return tuple(reversed(stride))


def _stand_ins(mesh, tree, spec_tree):
    """Stand-ins for a tree of shape-and-dtype leaves (tensors)."""
    if isinstance(tree, dict):
        return {k: _stand_ins(mesh, v, spec_tree[k]) for k, v in tree.items()}
    if hasattr(tree, "_fields"):
        return type(tree)(*(_stand_ins(mesh, getattr(tree, k),
                                       getattr(spec_tree, k))
                            for k in tree._fields))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_stand_ins(mesh, v, s)
                          for v, s in zip(tree, spec_tree))
    return _stand_in(mesh, tree.shape, tree.dtype, spec_tree)


def _meta(shape, dtype):
    return torch.empty(shape, dtype=dtype, device="meta")


def _abstract_cache(cfg: ModelConfig, batch: int, capacity: int) -> list:
    from torch._subclasses.fake_tensor import FakeTensorMode
    from ..training.optimizer import tree_map
    with FakeTensorMode():
        fake = tf.init_cache(cfg, batch, capacity, device="cpu")
    return tree_map(lambda x: _meta(x.shape, x.dtype), fake)


def _batch(cfg: ModelConfig, b: int, s: int, labels: bool) -> dict:
    out = {"labels": _meta((b, s), torch.int32)} if labels else {}
    if cfg.frontend == "none":
        out["tokens"] = _meta((b, s), torch.int32)
    else:
        out["embeds"] = _meta((b, s, cfg.d_model), cfg.torch_dtype)
    return out


def _opt_specs(pspecs) -> OptState:
    """Optimizer state shards exactly like its parameter (ZeRO-3)."""
    return OptState(pspecs, pspecs, pspecs, specs.P())


def _opt_abstract(params) -> OptState:
    from ..training.optimizer import tree_map
    f32 = lambda p: _meta(p.shape, torch.float32)
    return OptState(tree_map(f32, params), tree_map(f32, params),
                    tree_map(f32, params), _meta((), torch.int32))


def input_specs(cfg: ModelConfig, shape_name: str, mesh,
                tcfg: TrainConfig | None = None,
                seq_shard: bool | None = None, layout: str = "tp_fsdp",
                *, global_batch: int | None = None) -> Cell:
    """The cell of one (arch, shape) on ``mesh``; ``global_batch`` cuts the
    shape's batch.  layout='fsdp': pure data/FSDP parallelism, no TP.

    ``seq_shard`` defaults to off, where the JAX cell turns it on for a
    train shape under TP: DTensor sizes a sequence-sharded residual that a
    product flattens into rows as a strided shard, and plans every move of
    one by a graph search (a 2-layer smoke train step took 27 s on a 4x4
    fake mesh against 5.6 s without, and over 240 s against 18 s on a
    2x2x2 one).  ``seq_shard=True`` runs it."""
    shape = SHAPES[shape_name]
    tcfg = tcfg or TrainConfig()
    tp = layout != "fsdp"
    if seq_shard is None:
        seq_shard = False
    rules = specs.activation_rules(mesh, seq_shard=seq_shard, tp=tp)
    dmesh = mesh if _is_device_mesh(mesh) else None

    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kw):
            ctx = contextlib.nullcontext()
            if dmesh is not None:
                from torch.distributed.tensor.experimental import \
                    implicit_replication
                ctx = implicit_replication()
            with activation_sharding(dmesh, rules), ctx:
                return fn(*args, **kw)
        return inner

    aparams = tf.abstract_params(cfg)
    pspecs = specs.tree_specs(mesh, aparams, tp=tp)
    name = f"{cfg.name}@{shape_name}"
    b = global_batch or shape.global_batch
    s = shape.seq_len

    if shape.kind == "train":
        batch = _batch(cfg, b, s, labels=True)
        tree = (aparams, _opt_abstract(aparams), batch)
        st = (pspecs, _opt_specs(pspecs), specs.batch_specs(mesh, batch,
                                                             tp=tp))
        return Cell(name, wrap(make_train_step(cfg, tcfg)),
                    _stand_ins(mesh, tree, st), "train", donate=(0, 1),
                    specs=st)

    prefill_step, decode_step = make_serve_steps(cfg)
    if shape.kind == "prefill":
        cache = _abstract_cache(cfg, b, cfg.meta_tokens + s + 1)
        batch = _batch(cfg, b, s, labels=False)
        tree = (aparams, cache, batch)
        st = (pspecs, specs.cache_specs(mesh, cache),
              specs.batch_specs(mesh, batch))
        return Cell(name, wrap(prefill_step), _stand_ins(mesh, tree, st),
                    "prefill", donate=(1,), specs=st)

    # decode: one new token against a cache of seq_len positions
    cache = _abstract_cache(cfg, b, cfg.meta_tokens + s)
    if cfg.frontend == "none":
        tok = _meta((b, 1), torch.int32)
        fn = wrap(lambda p, c, t, q: decode_step(p, c, tokens=t, pos0=q))
    else:
        tok = _meta((b, 1, cfg.d_model), cfg.torch_dtype)
        fn = wrap(lambda p, c, e, q: decode_step(p, c, embeds=e, pos0=q))
    pos0 = _meta((), torch.int32)
    tree = (aparams, cache, tok, pos0)
    st = (pspecs, specs.cache_specs(mesh, cache),
          specs.batch_specs(mesh, tok), specs.P())
    return Cell(name, fn, _stand_ins(mesh, tree, st), "decode", donate=(1,),
                specs=st)


def materialize(cell: Cell, values: tuple) -> tuple:
    """``values`` (plain tensors in the structure of ``cell.args``, on the
    mesh's device) as the cell's inputs: on a ``DeviceMesh`` each is
    distributed with its input's placements (on a one-rank mesh the DTensor
    shares the value's storage), otherwise returned as is."""
    from torch.distributed.tensor import DTensor, distribute_tensor

    def one(stand_in, value):
        if isinstance(stand_in, DTensor):
            if tuple(value.shape) != tuple(stand_in.shape) or \
                    value.dtype != stand_in.dtype:
                raise ValueError(f"a value of {tuple(value.shape)} "
                                 f"{value.dtype} for an input of "
                                 f"{tuple(stand_in.shape)} {stand_in.dtype}")
            mesh = stand_in.device_mesh
            if mesh.size() == 1:
                return DTensor.from_local(value, mesh, stand_in.placements,
                                          run_check=False)
            return distribute_tensor(value, mesh, stand_in.placements)
        return value

    def walk(a, v):
        if isinstance(a, dict):
            return {k: walk(a[k], v[k]) for k in a}
        if hasattr(a, "_fields"):
            return type(a)(*(walk(getattr(a, k), getattr(v, k))
                             for k in a._fields))
        if isinstance(a, (list, tuple)):
            return type(a)(walk(x, y) for x, y in zip(a, v))
        return one(a, v)

    return walk(cell.args, values)
