"""Structured profiling: the on-device version of the reference's per-run
``profile`` dict + SpLuOperator.count (SURVEY.md §5.1).

``FactorCounter`` wraps any factor and counts applies as a device-side scalar
(no host sync until read). ``Profile`` collects phase wall times and solver
metadata, and can emit a JSON report. jax.profiler traces can be captured
around any phase for deep dives.
"""

from __future__ import annotations

import contextlib
import json
import time
from typing import Any, Dict

import jax
import jax.numpy as jnp


@jax.tree_util.register_pytree_node_class
class FactorCounter:
    """Wraps a factor; counts matvec applications (columns count per the
    reference's convention, eigenvector_derivatives.py:18-22)."""

    def __init__(self, factor, count=None):
        self.factor = factor
        self.count = jnp.zeros((), jnp.int64) if count is None else count

    @property
    def shape(self):
        return self.factor.shape

    @property
    def dtype(self):
        return self.factor.dtype

    def mv(self, x):
        ncols = 1 if x.ndim == 1 else x.shape[1]
        self.count = self.count + ncols
        return self.factor.mv(x)

    def __call__(self, x):
        return self.mv(x)

    def reset(self):
        self.count = jnp.zeros((), jnp.int64)

    def tree_flatten(self):
        return (self.factor, self.count), None

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children)


class Profile:
    """Phase-timed structured metrics."""

    def __init__(self, **static_info):
        self.data: Dict[str, Any] = dict(static_info)

    @contextlib.contextmanager
    def phase(self, name):
        t0 = time.perf_counter()
        yield
        self.data[f"{name} time"] = time.perf_counter() - t0

    @contextlib.contextmanager
    def trace(self, logdir):
        """Capture a jax.profiler device trace around a phase."""
        jax.profiler.start_trace(logdir)
        try:
            yield
        finally:
            jax.profiler.stop_trace()

    def record(self, name, value):
        if hasattr(value, "tolist"):
            value = value.tolist()
        self.data[name] = value

    def to_json(self):
        def clean(v):
            try:
                json.dumps(v)
                return v
            except TypeError:
                return str(v)

        return json.dumps({k: clean(v) for k, v in self.data.items()},
                          indent=2)

    def __getitem__(self, k):
        return self.data[k]

    def __setitem__(self, k, v):
        self.data[k] = v

    def __contains__(self, k):
        return k in self.data
