"""Random weights from the seed, made on the device in the tree the
program's ``models/transformer.forward`` reads, with the laws of its
``init_params`` (N(0, d_in^-1/2) matrices, N(0, 0.02) embedding, unit norm
weights) but in a few large calls: one ``normal_`` into one flat buffer a
block (and one for the outer leaves), each block from a seed of its own,
so that the reference can make any block again alone and get the same
numbers.

The tree is the configuration's family's (``reference/<family>.py``:
``outer_leaves``, ``layer_leaves``): every leaf a contiguous view of its
block's buffer, a leaf of another type than the served one (a router
kept in float32) of a buffer of its own.
"""
from __future__ import annotations

import torch

from .yardstick import derive, family


def served_dtype(cfg: dict) -> torch.dtype:
    """The type a configuration file says the program runs in."""
    return getattr(torch, cfg["as_run"]["dtype"])


def _fill(seed: int, specs: list, device, dtype) -> list:
    """Views of one buffer, filled N(0, 1) from ``seed``, then scaled (a
    scale of None sets the leaf to ones)."""
    sizes = [int(torch.Size(shape).numel()) for shape, _ in specs]
    buf = torch.empty(sum(sizes), dtype=dtype, device=device)
    g = torch.Generator(device=buf.device).manual_seed(seed)
    buf.normal_(generator=g)
    out, at = [], 0
    for (shape, scale), n in zip(specs, sizes):
        leaf = buf[at:at + n].view(shape)
        at += n
        if scale is None:
            leaf.fill_(1.0)
        else:
            leaf.mul_(scale)
        out.append(leaf)
    return out


def _leaves(specs: list, seed: int, device, dtype) -> dict:
    """``{path: leaf}`` of ``(path, shape, scale, type)`` specs, in their
    order; the leaves of the type ``dtype`` (all those whose type is None)
    share one buffer from ``seed``, each other type one of its own."""
    by_type: dict = {}
    for path, shape, scale, dt in specs:
        dt = dtype if dt is None else getattr(torch, dt)
        by_type.setdefault(dt, []).append((path, shape, scale))
    made = {}
    for dt, group in by_type.items():
        s = seed if dt == dtype else derive(seed, str(dt))
        views = _fill(s, [(shape, scale) for _, shape, scale in group],
                      device, dt)
        made.update(zip((p for p, _, _ in group), views))
    return {path: made[path] for path, *_ in specs}


def _nest(flat: dict) -> dict:
    """Dotted paths as nested dicts, in order."""
    tree: dict = {}
    for path, leaf in flat.items():
        *parents, last = path.split(".")
        node = tree
        for k in parents:
            node = node.setdefault(k, {})
        node[last] = leaf
    return tree


def make_layer(cfg: dict, seed: int, layer: int, device,
               dtype=None) -> dict:
    """Block ``layer``'s weights, in ``dtype`` or the served type."""
    return _nest(_leaves(family(cfg).layer_leaves(cfg),
                         derive(seed, "layer", layer), device,
                         dtype or served_dtype(cfg)))


def make_outer(cfg: dict, seed: int, device, dtype=None) -> dict:
    """The leaves outside the blocks (the embedding, the final norm, the
    head), by path."""
    fam = family(cfg)
    specs = [s for s in fam.outer_leaves(cfg) if s[0] != fam.LAYERS]
    return _leaves(specs, derive(seed, "outer"), device,
                   dtype or served_dtype(cfg))


def make(cfg: dict, seed: int, device, dtype=None) -> dict:
    """The whole tree, in the program's key order."""
    fam = family(cfg)
    outer = make_outer(cfg, seed, device, dtype)
    flat = {}
    for path, *_ in fam.outer_leaves(cfg):
        flat[path] = ([make_layer(cfg, seed, i, device, dtype)
                       for i in range(cfg["num_hidden_layers"])]
                      if path == fam.LAYERS else outer[path])
    return _nest(flat)


def initial_leaves(cfg: dict, seed: int, device):
    """The tree's leaves in the order of :func:`leaf_paths`, made again a
    block at a time, so that one block is held at a time."""
    fam = family(cfg)
    outer = make_outer(cfg, seed, device)
    for path, *_ in fam.outer_leaves(cfg):
        if path != fam.LAYERS:
            yield outer[path]
            continue
        for li in range(cfg["num_hidden_layers"]):
            yield from (w for _, w in leaf_paths(
                make_layer(cfg, seed, li, device)))


def leaf_paths(tree, prefix: str = "") -> list:
    """``(path, leaf)`` pairs in the order of the program's
    ``tree_leaves`` (dict insertion order, lists by index)."""
    if isinstance(tree, dict):
        return [pl for k, v in tree.items()
                for pl in leaf_paths(v, f"{prefix}{k}.")]
    if isinstance(tree, (list, tuple)):
        return [pl for i, v in enumerate(tree)
                for pl in leaf_paths(v, f"{prefix}{i}.")]
    return [(prefix[:-1], tree)]


def tree_map(fn, tree):
    """``fn`` over the leaves of a tree of dicts and lists."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, v) for v in tree]
    return fn(tree)
