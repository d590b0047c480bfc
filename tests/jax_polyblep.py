"""The JAX package's oscillators with the standard polyBLEP residual, for
the port's parity tests.

The port's ``ops/osc._polyblep`` is the standard two-sample residual: over
the sample step before a wrap it rises from 0 to 1.  The JAX package's
adds 1 to its variable there, so it runs from 1 to 4 (a known deviation,
stated in the port's ``ops/osc.py``).  A parity test renders the JAX
package inside ``standard_polyblep()``, so every other operation of its
oscillators is still held against the port's.  The JAX program has to be
built and traced inside the block: a function traced before it keeps the
JAX package's residual.  Where the JAX package's output is stored (the
examples' goldens), the port renders inside ``jax_polyblep()`` instead.
"""

import contextlib

import jax.numpy as jnp
import torch

import phonic_tpu.ops.osc as josc
import phonic_tpu_torch.ops.osc as posc


def polyblep(t, dt):
    """``phonic_tpu.ops.osc._polyblep`` with the standard branch before
    the wrap: ``b * b + 2b + 1`` at ``b = (t - 1) / dt``."""
    dt = jnp.maximum(dt, 1e-9)
    a = t / dt
    b = (t - 1.0) / dt
    up = 2.0 * a - a * a - 1.0  # t < dt
    down = b * b + 2.0 * b + 1.0  # t > 1 - dt
    return jnp.where(t < dt, up, jnp.where(t > 1.0 - dt, down, 0.0))


@contextlib.contextmanager
def standard_polyblep():
    """The JAX package's oscillators take ``polyblep`` inside the block."""
    saved = josc._polyblep
    josc._polyblep = polyblep
    try:
        yield
    finally:
        josc._polyblep = saved


def polyblep_as_jax(t, dt):
    """The port's ``_polyblep`` with the JAX package's branch before the
    wrap: ``b * b + 2b + 1`` at ``b = (t - 1) / dt + 1``."""
    dt = torch.clamp(dt, min=1e-9)
    a = t / dt
    b = (t - 1.0) / dt + 1.0
    up = 2.0 * a - a * a - 1.0  # t < dt
    down = b * b + 2.0 * b + 1.0  # t > 1 - dt
    return torch.where(t < dt, up, torch.where(t > 1.0 - dt, down, 0.0))


@contextlib.contextmanager
def jax_polyblep():
    """The port's oscillators take ``polyblep_as_jax`` inside the block."""
    saved = posc._polyblep
    posc._polyblep = polyblep_as_jax
    try:
        yield
    finally:
        posc._polyblep = saved
