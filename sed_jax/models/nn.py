"""The subset of ``flax.linen`` the model zoo uses, with flax's interface.

``Module`` subclasses are frozen dataclasses whose ``@compact``
``__call__`` creates submodules and variables inline.
``Module.init(rngs, *args, **kw)`` returns the variables dict
(``{'params': ..., 'batch_stats': ...}``) and
``Module.apply(variables, *args, rngs=None, mutable=False, **kw)``
runs the forward, returning ``(out, mutated)`` when ``mutable`` names
collections.  Variable trees match flax's exactly: the same collection,
module, automatic (``Dense_0``) and leaf names, the same shapes.  So
variables saved from the flax models (``tools/bench_checkpoint.npz``)
load unchanged, and the torch ``.pth`` mapping in ``sed_jax.compat``
targets the same paths.

Random keys are derived from the variable's or module's path (a stable
hash folded into the stream's key), not from flax's split order, so a
seed initialises to different values than flax did.
"""

from __future__ import annotations

import copy
import dataclasses
import functools
import threading
import zlib
from typing import Any, Callable, Optional, Sequence, Tuple, Union

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

initializers = jax.nn.initializers
relu = jax.nn.relu
sigmoid = jax.nn.sigmoid
leaky_relu = jax.nn.leaky_relu
softmax = jax.nn.softmax

_local = threading.local()


def _module_stack() -> list:
    """Modules whose compact method is running in this thread (innermost
    last): a module constructed meanwhile becomes a child of the top."""
    if not hasattr(_local, 'stack'):
        _local.stack = []
    return _local.stack


def _stable_hash(text: str) -> int:
    return zlib.crc32(text.encode()) & 0x7FFFFFFF


class _Run:
    """Variables, rng streams and mutability of one init or apply call."""

    def __init__(self, variables: dict, rngs: dict, mutable,
                 initializing: bool):
        self.initializing = initializing
        self.mutable = mutable
        self.rngs = rngs
        self.rng_counts: dict = {}
        # copy the dict spine of mutable collections so writes never
        # reach the caller's tree
        self.variables = {
            col: (_copy_spine(tree) if self.is_mutable(col) else tree)
            for col, tree in variables.items()}

    def is_mutable(self, col: str) -> bool:
        return self.initializing or self.mutable is True or \
            col in self.mutable

    def node(self, col: str, path: Tuple[str, ...], create: bool):
        node = self.variables.get(col)
        if node is None:
            if not create:
                return None
            node = self.variables[col] = {}
        for part in path:
            child = node.get(part)
            if child is None:
                if not create:
                    return None
                child = node[part] = {}
            node = child
        return node

    def get(self, col: str, path: Tuple[str, ...], name: str,
            init: Callable[[], Any]):
        node = self.node(col, path, create=False)
        if node is not None and name in node:
            return node[name]
        if not self.is_mutable(col):
            raise KeyError(f'variable {col}/{"/".join(path + (name,))} '
                           'is missing from the given variables')
        value = init()
        self.node(col, path, create=True)[name] = value
        return value

    def put(self, col: str, path: Tuple[str, ...], name: str, value):
        if not self.is_mutable(col):
            raise ValueError(f'collection {col!r} is not mutable here; '
                             f'pass mutable=[{col!r}] to apply')
        self.node(col, path, create=True)[name] = value

    def key(self, stream: str, path: Tuple[str, ...], tag: str):
        if stream not in self.rngs:
            raise ValueError(f'no {stream!r} rng was given to init/apply')
        return jax.random.fold_in(self.rngs[stream],
                                  _stable_hash('/'.join(path + (tag,))))

    def next_key(self, stream: str, path: Tuple[str, ...]):
        n = self.rng_counts.get((stream, path), 0)
        self.rng_counts[(stream, path)] = n + 1
        return self.key(stream, path, f'#{n}')


def _copy_spine(tree):
    if isinstance(tree, dict):
        return {k: _copy_spine(v) for k, v in tree.items()}
    return tree


class Variable:
    """Handle on one variable; assigning ``value`` writes it back."""

    def __init__(self, run: _Run, col: str, path, name: str, init):
        self._run, self._col, self._path, self._name = run, col, path, name
        run.get(col, path, name, init)

    @property
    def value(self):
        return self._run.node(self._col, self._path, False)[self._name]

    @value.setter
    def value(self, v):
        self._run.put(self._col, self._path, self._name, v)


@dataclasses.dataclass(frozen=True, eq=False)
class Module:
    """Base class: subclasses are frozen dataclasses of their settings."""

    name: Optional[str] = dataclasses.field(default=None, kw_only=True)

    _run = None     # set when bound: the init/apply call it belongs to
    _path = ()      # its module names from the root

    def __init_subclass__(cls, **kwargs):
        super().__init_subclass__(**kwargs)
        dataclasses.dataclass(frozen=True, eq=False)(cls)

    def __post_init__(self):
        stack = _module_stack()
        if not stack:
            return
        parent = stack[-1]
        name = self.name
        if name is None:
            prefix = type(self).__name__
            n = parent._autonames.get(prefix, 0)
            parent._autonames[prefix] = n + 1
            name = f'{prefix}_{n}'
            object.__setattr__(self, 'name', name)
        self._bind(parent._run, parent._path + (name,))

    def _bind(self, run: _Run, path: Tuple[str, ...]):
        object.__setattr__(self, '_run', run)
        object.__setattr__(self, '_path', path)
        object.__setattr__(self, '_autonames', {})

    def _bound_copy(self, run: _Run) -> 'Module':
        module = copy.copy(self)
        module._bind(run, ())
        return module

    # -- inside a compact method ------------------------------------------

    def _require_bound(self):
        if self._run is None:
            raise ValueError(f'{type(self).__name__} is not bound: call it '
                             'through init() or apply()')

    def param(self, name: str, init_fn: Callable, *init_args):
        self._require_bound()
        return self._run.get(
            'params', self._path, name,
            lambda: init_fn(self._run.key('params', self._path, name),
                            *init_args))

    def variable(self, col: str, name: str, init_fn: Callable,
                 *init_args) -> Variable:
        self._require_bound()
        return Variable(self._run, col, self._path, name,
                        lambda: init_fn(*init_args))

    def make_rng(self, stream: str):
        self._require_bound()
        return self._run.next_key(stream, self._path)

    def is_initializing(self) -> bool:
        self._require_bound()
        return self._run.initializing

    # -- entry points -----------------------------------------------------

    def init(self, rngs, *args, **kwargs) -> dict:
        """Run ``__call__`` creating every variable; returns them all."""
        if not isinstance(rngs, dict):
            rngs = {'params': rngs}
        run = _Run({}, rngs, mutable=True, initializing=True)
        self._bound_copy(run)(*args, **kwargs)
        return run.variables

    def apply(self, variables: dict, *args, rngs: Optional[dict] = None,
              mutable: Union[bool, str, Sequence[str]] = False, **kwargs):
        """Run ``__call__`` on ``variables``.  With ``mutable`` naming
        collections (or True for all) returns ``(out, mutated)``."""
        if isinstance(mutable, str):
            mutable = (mutable,)
        run = _Run(dict(variables), dict(rngs or {}),
                   mutable=mutable if mutable is True else
                   frozenset(mutable or ()),
                   initializing=False)
        out = self._bound_copy(run)(*args, **kwargs)
        if not mutable:
            return out
        return out, {col: tree for col, tree in run.variables.items()
                     if run.is_mutable(col)}


def compact(method):
    """Decorate the method that builds submodules and variables inline."""

    @functools.wraps(method)
    def wrapper(self, *args, **kwargs):
        self._require_bound()
        self._autonames.clear()
        stack = _module_stack()
        stack.append(self)
        try:
            return method(self, *args, **kwargs)
        finally:
            stack.pop()

    return wrapper


# ---------------------------------------------------------------------------
# Layers
# ---------------------------------------------------------------------------


def _promote(*arrays, dtype=None):
    """flax's ``promote_dtype``: cast all to ``dtype`` (default: their
    common type), passing ``None`` through."""
    if dtype is None:
        dtype = jnp.result_type(*[a for a in arrays if a is not None])
    return [None if a is None else jnp.asarray(a, dtype) for a in arrays]


class Dense(Module):
    features: int
    use_bias: bool = True
    kernel_init: Callable = initializers.lecun_normal()

    @compact
    def __call__(self, x):
        kernel = self.param('kernel', self.kernel_init,
                            (x.shape[-1], self.features), jnp.float32)
        bias = (self.param('bias', initializers.zeros, (self.features,),
                           jnp.float32) if self.use_bias else None)
        x, kernel, bias = _promote(x, kernel, bias)
        y = lax.dot_general(x, kernel, (((x.ndim - 1,), (0,)), ((), ())))
        return y if bias is None else y + bias


class Conv(Module):
    """N-d convolution over channels-last input (batch, *spatial, C)."""

    features: int
    kernel_size: Sequence[int]
    strides: Union[int, Sequence[int]] = 1
    padding: Any = 'SAME'
    feature_group_count: int = 1
    use_bias: bool = True
    dtype: Optional[Any] = None
    kernel_init: Callable = initializers.lecun_normal()

    @compact
    def __call__(self, x):
        ks = tuple(self.kernel_size)
        strides = ((self.strides,) * len(ks) if isinstance(self.strides, int)
                   else tuple(self.strides))
        padding = (self.padding if isinstance(self.padding, str)
                   else tuple(tuple(p) for p in self.padding))
        kernel = self.param(
            'kernel', self.kernel_init,
            ks + (x.shape[-1] // self.feature_group_count, self.features),
            jnp.float32)
        bias = (self.param('bias', initializers.zeros, (self.features,),
                           jnp.float32) if self.use_bias else None)
        x, kernel, bias = _promote(x, kernel, bias, dtype=self.dtype)
        sp = 'HWD'[:len(ks)]
        dn = lax.conv_dimension_numbers(
            x.shape, kernel.shape, ('N' + sp + 'C', sp + 'IO', 'N' + sp + 'C'))
        y = lax.conv_general_dilated(
            x, kernel, strides, padding, dimension_numbers=dn,
            feature_group_count=self.feature_group_count)
        return y if bias is None else y + bias


def _moments(x, axes, axis_name):
    """Mean and biased variance over ``axes`` in at least float32, as
    E[x^2] - E[x]^2 clipped at 0 (flax's fast variance); ``axis_name``
    averages them across a mapped axis."""
    x = x.astype(jnp.promote_types(x.dtype, jnp.float32))
    mean, mean2 = x.mean(axes), lax.square(x).mean(axes)
    if axis_name is not None:
        mean, mean2 = lax.pmean(jnp.stack([mean, mean2]), axis_name)
    return mean, jnp.maximum(0.0, mean2 - lax.square(mean))


def _normalize(module, x, mean, var, axes, feature_axis, dtype, epsilon):
    """(x - mean) / sqrt(var + epsilon) * scale + bias, with the learned
    ``scale`` (init 1) and ``bias`` (init 0) over the feature axis."""
    shape = [1] * x.ndim
    shape[feature_axis] = x.shape[feature_axis]
    feature_shape = (x.shape[feature_axis],)
    scale = module.param('scale', initializers.ones, feature_shape,
                         jnp.float32).reshape(shape)
    bias = module.param('bias', initializers.zeros, feature_shape,
                        jnp.float32).reshape(shape)
    y = x - jnp.expand_dims(mean, axes)
    y = y * (lax.rsqrt(jnp.expand_dims(var, axes) + epsilon) * scale) + bias
    return jnp.asarray(y, dtype or jnp.result_type(x, scale, bias))


class BatchNorm(Module):
    """Batch statistics in train mode (updating the running ones in the
    ``batch_stats`` collection, ``new = momentum * old + (1 - momentum)
    * batch``), running statistics when ``use_running_average``."""

    use_running_average: Optional[bool] = None
    axis: int = -1
    momentum: float = 0.99
    epsilon: float = 1e-5
    dtype: Optional[Any] = None
    axis_name: Optional[str] = None

    @compact
    def __call__(self, x):
        axis = self.axis % x.ndim
        axes = tuple(i for i in range(x.ndim) if i != axis)
        shape = (x.shape[axis],)
        ra_mean = self.variable('batch_stats', 'mean',
                                lambda: jnp.zeros(shape, jnp.float32))
        ra_var = self.variable('batch_stats', 'var',
                               lambda: jnp.ones(shape, jnp.float32))
        if self.use_running_average:
            mean, var = ra_mean.value, ra_var.value
        else:
            mean, var = _moments(x, axes, self.axis_name)
            if not self.is_initializing():
                m = self.momentum
                ra_mean.value = m * ra_mean.value + (1 - m) * mean
                ra_var.value = m * ra_var.value + (1 - m) * var
        return _normalize(self, x, mean, var, axes, axis, self.dtype,
                          self.epsilon)


class LayerNorm(Module):
    epsilon: float = 1e-6

    @compact
    def __call__(self, x):
        mean, var = _moments(x, (x.ndim - 1,), None)
        return _normalize(self, x, mean, var, (x.ndim - 1,), x.ndim - 1,
                          None, self.epsilon)


class Dropout(Module):
    """Zero each element with probability ``rate`` and scale the rest by
    1/(1 - rate), drawing from the ``dropout`` rng stream."""

    rate: float
    deterministic: bool = False

    @compact
    def __call__(self, x):
        if self.deterministic or self.rate == 0.0:
            return x
        if self.rate == 1.0:
            return jnp.zeros_like(x)
        keep = 1.0 - self.rate
        mask = jax.random.bernoulli(self.make_rng('dropout'), keep, x.shape)
        return lax.select(mask, x / keep, jnp.zeros_like(x))


def _pool(x, init, op, window_shape, strides, padding):
    window_shape = tuple(window_shape)
    strides = tuple(strides) if strides else (1,) * len(window_shape)
    if not isinstance(padding, str):
        padding = ((0, 0),) + tuple(tuple(p) for p in padding) + ((0, 0),)
    # a Python-scalar init lets lax pick its differentiable sum/max
    # window reductions
    return lax.reduce_window(x, init, op, (1,) + window_shape + (1,),
                             (1,) + strides + (1,), padding)


def avg_pool(x, window_shape, strides=None, padding='VALID'):
    """Mean over windows of (batch, *spatial, C); padding counts as
    zeros in the mean."""
    y = _pool(x, 0.0, lax.add, window_shape, strides, padding)
    return y / np.prod(window_shape)


def max_pool(x, window_shape, strides=None, padding='VALID'):
    return _pool(x, -jnp.inf, lax.max, window_shape, strides, padding)
