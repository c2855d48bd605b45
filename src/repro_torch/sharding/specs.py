"""Parameter, input and cache partition specs: the counterpart of the JAX
package's ``sharding/specs.py``.

Strategy (DESIGN.md §6): tensor parallelism over the ``model`` axis for
the contracting/output feature dims (Megatron col->row pairs), FSDP
(ZeRO-3) over (``pod``, ``data``) for whatever large dim remains, expert
parallelism over ``model`` when the expert count divides it.  Every rule
is divisibility-checked against the actual shape; non-divisible dims fall
back down a preference list, ending at replication.

A spec is a :class:`P`, a tuple with one entry a dim: ``None``, a mesh
axis name, or a tuple of axis names (that dim split over those axes, the
first outermost; an empty tuple is ``None`` and a one-name tuple that
name, as JAX canonicalises them), so that it compares with a JAX
``PartitionSpec`` entry for entry.  The planner reads only ``mesh.shape`` (axis name -> size): a
:class:`repro_torch.launch.mesh.AbstractMesh`, a
:class:`repro_torch.launch.mesh.Mesh` or, through :func:`mesh_shape`, a
``torch.distributed`` ``DeviceMesh``.  :func:`placements` turns a spec
into DTensor placements on a ``DeviceMesh``.

The port keeps its layers as a list of per-layer dicts
(``params["layers"][i]``), where the JAX model stacks them with a leading
L dim and its rules shift every dim by one under ``/layers/``.  A port
leaf ``/layers/3/attn/wq`` of shape ``(d, h*dh)`` therefore gets the JAX
spec of ``/layers/attn/wq`` ``(L, d, h*dh)`` with the leading ``None``
dropped: the rules below index the per-layer leaf directly, and a cache
leaf ``k`` is ``(B, Sc, KV, dh)`` here, ``(L, B, Sc, KV, dh)`` there.
"""
from __future__ import annotations

from typing import Any, Sequence

TP = "model"


def _canon(entry):
    """An entry as JAX's ``PartitionSpec`` keeps it: ``()`` is ``None`` and
    a one-name tuple that name."""
    if isinstance(entry, tuple):
        if not entry:
            return None
        if len(entry) == 1:
            return entry[0]
    return entry


class P(tuple):
    """A partition spec: ``P(("pod", "data"), None, "model")``."""

    def __new__(cls, *entries):
        return super().__new__(cls, (_canon(e) for e in entries))

    def __repr__(self):
        return f"P{tuple.__repr__(self)}"


def mesh_shape(mesh) -> dict:
    """Axis name -> size of an abstract mesh, a :class:`Mesh` or a
    ``DeviceMesh``."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None and hasattr(mesh, "size") and callable(mesh.size):
        return {n: mesh.size(i) for i, n in enumerate(names)}
    return dict(mesh.shape)


def dp_axes(mesh) -> tuple:
    shape = mesh_shape(mesh)
    return tuple(a for a in ("pod", "data") if a in shape)


def _size(shape: dict, axes) -> int:
    if axes is None:
        return 1
    n = 1
    for a in (axes if isinstance(axes, tuple) else (axes,)):
        n *= shape[a]
    return n


def best_spec(mesh, shape: Sequence[int],
              prefs: Sequence[Sequence[tuple[int, Any]]]) -> P:
    """Greedy first-fit: ``prefs`` is a list of preference chains, one a
    logical role, each [(dim, axes), ...] tried in order.  A (dim, axes)
    binds iff the dim is unbound, the axes are unused, and the shape
    divides."""
    ms = mesh_shape(mesh)
    bound: dict[int, Any] = {}
    used: set = set()
    for chain in prefs:
        for dim, axes in chain:
            if dim >= len(shape) or dim in bound:
                continue
            alist = axes if isinstance(axes, tuple) else (axes,)
            if any(a in used for a in alist):
                continue
            if shape[dim] % _size(ms, axes) == 0 and shape[dim] > 0:
                bound[dim] = axes
                used.update(alist)
                break
    return P(*[bound.get(i) for i in range(len(shape))])


def param_spec(mesh, path: str, shape: Sequence[int], fsdp: bool = True,
               tp: bool = True) -> P:
    """The spec of one parameter; ``path`` is its '/'-joined key path.
    A per-layer leaf (under ``/layers/<i>/``) has no L dim here, so the
    JAX rules' ``off`` is 0 for every leaf.

    tp=False: pure-FSDP layout, every tensor sharded over ALL mesh axes
    (data+model as one big FSDP axis), no tensor parallelism."""
    fa = dp_axes(mesh)
    if not tp:
        fa = fa + (TP,)
    if not fsdp:
        fa = ()
    name = path.split("/")[-1]
    nd = len(shape)

    def S(*prefs):
        if not tp:
            prefs = [[(d, a) for (d, a) in chain if a != TP]
                     for chain in prefs]
            prefs = [c for c in prefs if c]
        return best_spec(mesh, shape, prefs)

    if nd <= 1:                                  # norms, scalars, biases
        return P(*([None] * nd))
    if name == "embed":                          # (V, d)
        return S([(0, TP)], [(1, fa)])
    if name == "lm_head":                        # (d, V*out_heads)
        return S([(1, TP)], [(0, fa)])
    if name == "meta":
        return P(*([None] * nd))
    if "/experts/" in f"/{path}/":               # (E, d, f) / (E, f, d)
        if name in ("w_gate", "w_up"):
            return S([(0, TP), (2, TP)], [(1, fa)], [(2, fa)])
        return S([(0, TP), (1, TP)], [(2, fa)], [(1, fa)])
    if name in ("wq", "wk", "wv", "w_gate", "w_up", "w_in", "w_bc"):
        return S([(1, TP)], [(0, fa)])           # column-parallel
    if name in ("wo", "w_down", "w_out"):
        return S([(0, TP)], [(1, fa)])           # row-parallel
    if name in ("w_gates", "w_dt", "router"):
        return S([(0, fa)])
    if name == "conv":                           # (K, channels)
        return S([(1, TP)])
    order = sorted(range(nd), key=lambda i: -shape[i])
    return S([(i, fa) for i in order])


def _walk(tree: Any, fn, path: str = ""):
    if isinstance(tree, dict):
        return {k: _walk(v, fn, f"{path}/{k}") for k, v in tree.items()}
    if hasattr(tree, "_fields"):                 # NamedTuple
        return type(tree)(*(_walk(getattr(tree, k), fn, f"{path}/{k}")
                            for k in tree._fields))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_walk(v, fn, f"{path}/{i}")
                          for i, v in enumerate(tree))
    return fn(path, tree)


def tree_specs(mesh, tree: Any, fsdp: bool = True, tp: bool = True) -> Any:
    """A parameter tree's specs, path-aware, in the tree's structure."""
    return _walk(tree, lambda path, x: param_spec(mesh, path, x.shape,
                                                  fsdp, tp))


def activation_rules(mesh, *, seq_shard: bool = False,
                     tp: bool = True) -> dict:
    """Logical-activation name -> spec (installed by
    :func:`repro_torch.sharding.activation.activation_sharding`).

    seq_shard=True also shards the residual's sequence dim over the TP
    axis (Megatron sequence parallelism)."""
    dp = dp_axes(mesh)
    if not tp:
        dp = dp + (TP,)
        return {"residual": P(dp, None, None), "logits": P(dp, None, None)}
    return {
        "residual": P(dp, TP, None) if seq_shard else P(dp, None, None),
        "act_ffn": P(dp, None, TP),
        "act_heads": P(dp, None, TP, None),
        "logits": P(dp, None, TP),
        # MoE buffers (G, E, cap, d): groups over DP, experts over TP
        "moe_experts": P(dp, TP, None, None),
    }


def batch_specs(mesh, batch: Any, tp: bool = True) -> Any:
    """Every batch leaf's leading (batch) dim over the DP axes (all axes
    under the pure-FSDP layout), when it divides."""
    dp = dp_axes(mesh)
    if not tp:
        dp = dp + (TP,)
    n = _size(mesh_shape(mesh), dp)

    def one(_, x):
        shape = tuple(x.shape)
        if len(shape) == 0:
            return P()
        if shape[0] % n == 0:
            return P(dp, *([None] * (len(shape) - 1)))
        return P(*([None] * len(shape)))

    return _walk(batch, one)


def cache_spec(mesh, path: str, shape: Sequence[int]) -> P:
    """A per-layer cache leaf's spec: batch over DP, then heads or feature
    dims over TP, divisibility-checked (the JAX rule's dims less one)."""
    dp = dp_axes(mesh)
    name = path.split("/")[-1]
    nd = len(shape)
    if name == "kpos":
        return P(*([None] * nd))
    if name in ("k", "v"):        # (B, Sc, KV, dh)
        return best_spec(mesh, shape, [[(0, dp)], [(2, TP), (3, TP)]])
    if name == "S":               # (B, H, dk, dv)
        return best_spec(mesh, shape,
                         [[(0, dp)], [(2, TP), (3, TP), (1, TP)]])
    if name == "n":               # (B, H, dk)
        return best_spec(mesh, shape, [[(0, dp)], [(2, TP), (1, TP)]])
    if name == "conv":            # (B, K-1, di)
        return best_spec(mesh, shape, [[(0, dp)], [(2, TP)]])
    order = sorted(range(nd), key=lambda i: -shape[i])
    return best_spec(mesh, shape, [[(0, dp)]] + [[(i, TP)] for i in order])


def cache_specs(mesh, cache: Any) -> Any:
    """The specs of a cache tree (the port's list of per-layer dicts)."""
    return _walk(cache, lambda path, x: cache_spec(mesh, path, x.shape))


def placements(mesh, spec: Sequence) -> tuple:
    """DTensor placements of ``spec`` on the ``DeviceMesh`` ``mesh``: each
    mesh dim bound to a tensor dim becomes ``Shard(dim)``, the others
    ``Replicate()``.  A dim split over several axes (``("pod", "data")``)
    shards over each of them, outermost first, which DTensor's
    left-to-right order reproduces only when they come in mesh order."""
    from torch.distributed.tensor import Replicate, Shard
    names = list(mesh.mesh_dim_names)
    out = [Replicate() for _ in names]
    for dim, axes in enumerate(spec):
        if axes is None:
            continue
        axes = axes if isinstance(axes, tuple) else (axes,)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"spec {spec}: axes {axes} are not in the "
                             f"mesh's order {tuple(names)}")
        for i in idx:
            out[i] = Shard(dim)
    return tuple(out)


def local_shape(mesh, shape: Sequence[int], spec: Sequence) -> tuple:
    """The shape of one device's shard of a ``shape`` tensor under
    ``spec`` (the dims divide: the planner binds only those)."""
    ms = mesh_shape(mesh)
    return tuple(n // _size(ms, axes) for n, axes in
                 zip(shape, tuple(spec) + (None,) * (len(shape) - len(spec))))
