"""Parameter spec system, mirroring ``src/repro/models/params.py``.

Modules declare parameters as ``Spec`` leaves in nested dicts and lists.
From the same tree come real initialized parameters (``init_params``),
shape-only ones on the ``meta`` device (``abstract_params``), their
shardings under the active logical-axis rules (``param_shardings``) and the
count (``count_params``). Parameter trees keep the reference's layouts,
per-layer stack dimension included, so its weights carry across one to one
(``core.formats.params_from_numpy``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Optional, Tuple

import torch

Tree = Dict[str, Any]

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "float16": torch.float16}


def torch_dtype(name) -> torch.dtype:
    """A config's dtype name (``"bfloat16"``) as a torch dtype."""
    return name if isinstance(name, torch.dtype) else DTYPES[str(name)]


@dataclasses.dataclass(frozen=True)
class Spec:
    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]          # logical axes, len == len(shape)
    init: str = "normal"                     # normal | zeros | ones
    scale: Optional[float] = None            # None -> 1/sqrt(fan_in)

    def __post_init__(self):
        assert len(self.shape) == len(self.axes), (self.shape, self.axes)


def is_spec(x) -> bool:
    return isinstance(x, Spec)


def tree_map(fn: Callable, tree, is_leaf: Callable = None):
    """``fn`` on every leaf of nested dicts, lists and tuples; ``is_leaf``
    stops the descent early."""
    if is_leaf is not None and is_leaf(tree):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, is_leaf) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, is_leaf) for v in tree)
    return fn(tree)


def tree_leaves(tree, is_leaf: Callable = None) -> list:
    out = []
    tree_map(out.append, tree, is_leaf)
    return out


def tree_unflatten(tree, leaves) -> Tree:
    """``tree``'s structure with its leaves replaced, in ``tree_leaves``
    order, by ``leaves``."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), tree)


def tree_items(tree, sort: bool = False, prefix: str = "") -> list:
    """``(path, leaf)`` pairs, the path the dict keys and list indices down
    to the leaf joined by ``/`` (``segments/0/u0/attn/wq``). In
    ``tree_map``'s order, or with ``sort`` in the reference's: dict keys
    sorted (the order ``jax.tree.leaves`` gives), lists in order."""
    if isinstance(tree, dict):
        keys = sorted(tree) if sort else tree
        return [it for k in keys
                for it in tree_items(tree[k], sort, f"{prefix}{k}/")]
    if isinstance(tree, (list, tuple)):
        return [it for i, v in enumerate(tree)
                for it in tree_items(v, sort, f"{prefix}{i}/")]
    return [(prefix[:-1], tree)]


def sorted_leaves(tree) -> list:
    """Leaves in the reference's order (``tree_items(tree, sort=True)``)."""
    return [x for _, x in tree_items(tree, sort=True)]


def stack(spec_tree: Tree, n: int, axis_name: Optional[str] = None) -> Tree:
    """Prepend a layer-stack dimension to every Spec."""
    return tree_map(
        lambda s: Spec((n,) + s.shape, (axis_name,) + s.axes, s.init, s.scale),
        spec_tree, is_spec)


def _fan_in(shape: Tuple[int, ...]) -> int:
    if len(shape) == 1:
        return shape[0]
    return int(math.prod(shape[:-1]))


def _normal(shape, scale: float, generator: torch.Generator, dtype,
            device) -> torch.Tensor:
    """float32 normals times ``scale``, cast to ``dtype``; a leaf of three or
    more dims is drawn one slice of its first dim at a time, so the float32
    temporary is one slice (a stacked expert weight whole would be 19 GB at
    deepseek-v2-lite)."""
    if len(shape) < 3:
        return (torch.randn(shape, generator=generator, dtype=torch.float32,
                            device=device) * scale).to(dtype)
    out = torch.empty(shape, dtype=dtype, device=device)
    for i in range(shape[0]):
        out[i] = _normal(shape[1:], scale, generator, dtype, device)
    return out


def _same_device(a: torch.device, b: torch.device) -> bool:
    """``a`` and ``b`` name one device (an index left out is the current
    device of that type)."""
    def key(d):
        d = torch.device(d)
        if d.type == "cuda" and d.index is None:
            return d.type, torch.cuda.current_device()
        return d.type, d.index
    return key(a) == key(b)


def init_params(spec_tree: Tree, generator: Optional[torch.Generator] = None,
                dtype=torch.float32, device=None) -> Tree:
    """Real parameters: zeros, ones, or normals times ``scale`` (default
    ``fan_in ** -0.5`` of the leaf's whole shape, stack dim included, as the
    reference computes it), drawn in float32 from ``generator`` and cast to
    ``dtype``. The leaves are drawn in tree order from one generator, so a
    seed fixes every weight. ``device`` alone decides where they are drawn
    and kept (the card unless the caller asks for another); a generator on
    another device raises ``ValueError``."""
    from ..core.formats import resolve_device
    dtype = torch_dtype(dtype)
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev)
    elif not _same_device(generator.device, dev):
        raise ValueError(f"the generator is on {generator.device} but the "
                         f"parameters go to {dev}; make the generator on "
                         f"{dev} or pass device={str(generator.device)!r}")

    def mk(spec: Spec):
        if spec.init == "zeros":
            return torch.zeros(spec.shape, dtype=dtype, device=dev)
        if spec.init == "ones":
            return torch.ones(spec.shape, dtype=dtype, device=dev)
        scale = spec.scale if spec.scale is not None \
            else _fan_in(spec.shape) ** -0.5
        return _normal(spec.shape, scale, generator, dtype, dev)
    return tree_map(mk, spec_tree, is_spec)


def meta_tensor(shape, dtype, sharding=None) -> torch.Tensor:
    """An empty tensor on the ``meta`` device carrying ``sharding`` (a
    ``parallel.sharding.NamedSharding`` or None) as its ``sharding``
    attribute, the counterpart of a ``jax.ShapeDtypeStruct``'s: a meta
    tensor has no layout of its own."""
    t = torch.empty(tuple(shape), dtype=torch_dtype(dtype), device="meta")
    t.sharding = sharding
    return t


def abstract_params(spec_tree: Tree, dtype=torch.float32) -> Tree:
    """The tree as tensors on the ``meta`` device: shapes and dtypes, no
    allocation. Under ``sharding_rules`` each leaf's ``sharding`` is its
    resolved layout (``meta_tensor``; None without a mesh), the same as
    ``param_shardings`` gives beside the tree."""
    from ..parallel.sharding import named_sharding
    return tree_map(lambda s: meta_tensor(s.shape, dtype,
                                          named_sharding(s.axes, s.shape)),
                    spec_tree, is_spec)


def param_shardings(spec_tree: Tree) -> Tree:
    """The ``NamedSharding`` tree of ``spec_tree`` under the active rules
    (``sharding_rules(mesh)`` must be set)."""
    from ..parallel.sharding import NamedSharding, mesh_rules
    rules = mesh_rules()
    return tree_map(lambda s: NamedSharding(rules.mesh,
                                            rules.resolve(s.axes, s.shape)),
                    spec_tree, is_spec)


def count_params(spec_tree: Tree) -> int:
    return sum(int(math.prod(s.shape))
               for s in tree_leaves(spec_tree, is_spec))
