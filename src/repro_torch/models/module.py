"""Parameter specs: declarative shapes and logical axes, as in the
reference package's ``models/module.py``.

Every model declares its parameters as a nested dict of ``ParamSpec``
(shape, logical axis names, init).  From that one declaration come the
initialised tensors (``init_params`` on a device from a
``torch.Generator``; ``init_params_numpy`` as seeded numpy arrays), the
abstract stand-ins of tracing (``abstract_params``: ``meta`` tensors, no
storage), the parameter count and bytes, the batch axis of every
decode-state leaf (the serving engine reads ``"batch"`` in ``logical``)
and the logical-axis tree (``logical_axes``) that ``sharding.rules`` maps
to mesh axes.  The trees keep the reference's keys and stacked ``(L,
...)`` layouts, so weights and decode state carry across one to one
(``params_from_numpy``).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable, Optional, Tuple

import numpy as np
import torch


@dataclass(frozen=True)
class ParamSpec:
    shape: Tuple[int, ...]
    logical: Tuple[Optional[str], ...]      # logical axis name per dim
    init: str = "normal"                    # normal|zeros|ones
    scale: float = 1.0
    dtype: torch.dtype = torch.float32

    def __post_init__(self):
        if len(self.shape) != len(self.logical):
            raise ValueError(f"shape {self.shape} and logical axes "
                             f"{self.logical} differ in rank")

    @property
    def std(self) -> float:
        """The normal init's standard deviation: ``scale / sqrt(fan_in)``,
        with the fan-in the second-to-last dimension (the last for a
        vector)."""
        fan_in = self.shape[-2] if len(self.shape) >= 2 else self.shape[-1]
        return self.scale / math.sqrt(max(fan_in, 1))


def tree_map(fn: Callable, tree, *rest):
    """Map ``fn`` over the leaves of nested dicts (``rest`` are trees of
    the same structure, matched by key).  A leaf is anything that is not a
    dict."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    """The leaves of nested dicts, in the tree's order."""
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in tree_leaves(v)]
    return [tree]


def tree_leaves_sorted(tree) -> list:
    """The leaves of nested dicts with every dict's keys in sorted order:
    the reference's ``jax.tree_util.tree_leaves`` order."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree)
                for leaf in tree_leaves_sorted(tree[k])]
    return [tree]


def value_and_grad(fn: Callable) -> Callable:
    """``fn(params, *rest) -> (value, grads)``, the reference's
    ``jax.value_and_grad`` over a parameter tree: ``torch.autograd.grad``
    of the scalar ``fn`` over detached copies of ``params``' leaves, a
    leaf that the value does not reach getting zeros.  Plain autograd,
    not a torch.func transform: the rematerialised blocks
    (``remat.py``) recompute under autograd only, and functorch's grad
    would keep every intermediate of the backward alive until the
    gradient returns."""
    def run(params, *rest):
        with torch.enable_grad():
            q = tree_map(lambda x: x.detach().requires_grad_(), params)
            value = fn(q, *rest)
            grads = iter(torch.autograd.grad(value, tree_leaves(q),
                                             materialize_grads=True))
        return value.detach(), tree_map(lambda _: next(grads), params)
    return run


def _numpy_dtype(dtype: torch.dtype):
    if dtype == torch.float32:
        return np.float32
    raise ValueError(f"numpy init supports float32 parameters, got {dtype}")


def init_params(specs, generator: torch.Generator,
                device: Optional[torch.device] = None):
    """Materialize a tree of ``ParamSpec`` on ``device`` (the generator's
    device by default): zeros, ones, or a standard normal times ``std``,
    drawn in float32 and cast to the spec's dtype, leaf by leaf from
    ``generator`` in the tree's order."""
    device = torch.device(device) if device is not None else generator.device

    def one(s: ParamSpec) -> torch.Tensor:
        if s.init == "zeros":
            return torch.zeros(s.shape, dtype=s.dtype, device=device)
        if s.init == "ones":
            return torch.ones(s.shape, dtype=s.dtype, device=device)
        x = torch.randn(s.shape, generator=generator, dtype=torch.float32,
                        device=device)
        return x.mul_(s.std).to(s.dtype)

    return tree_map(one, specs)


def init_params_numpy(specs, seed: int):
    """Seeded numpy weights (float32) with ``init_params``'s distribution:
    one ``numpy.random.default_rng(seed)`` drawn leaf by leaf in the tree's
    order.  Both packages can load them, which is what the card fixture
    (``tools/serve_expected.py``) needs."""
    rng = np.random.default_rng(seed)

    def one(s: ParamSpec) -> np.ndarray:
        dt = _numpy_dtype(s.dtype)
        if s.init == "zeros":
            return np.zeros(s.shape, dt)
        if s.init == "ones":
            return np.ones(s.shape, dt)
        return (rng.standard_normal(s.shape, dtype=np.float32)
                * np.float32(s.std)).astype(dt)

    return tree_map(one, specs)


def abstract_params(specs):
    """A tree of ``meta`` tensors of each spec's shape and dtype: the
    stand-in of tracing (``models/tracing.py``), which allocates
    nothing."""
    return tree_map(lambda s: torch.empty(s.shape, dtype=s.dtype,
                                          device="meta"), specs)


def logical_axes(specs):
    """The tree of logical-axis tuples parallel to the parameters."""
    return tree_map(lambda s: s.logical, specs)


def params_from_numpy(tree, device=None):
    """Carry a tree of arrays (numpy, or anything ``np.asarray`` takes,
    such as the reference package's parameters or decode state) across as
    tensors on ``device``, keeping each leaf's dtype.  bfloat16 leaves,
    which numpy does not know, arrive as float32 and are cast back."""
    def one(x: Any) -> Optional[torch.Tensor]:
        if x is None:
            return None
        name = str(getattr(x, "dtype", ""))
        a = np.array(x.astype(np.float32) if name == "bfloat16" else x)
        t = torch.from_numpy(a).to(device)
        return t.to(torch.bfloat16) if name == "bfloat16" else t
    return tree_map(one, tree)


def param_count(specs) -> int:
    return int(sum(math.prod(s.shape) for s in tree_leaves(specs)))


def param_bytes(specs) -> int:
    return int(sum(math.prod(s.shape) * s.dtype.itemsize
                   for s in tree_leaves(specs)))
