"""Varying-manual-axes (vma) helpers for shard_map-safe custom VJPs.

Under ``jax.shard_map`` with vma tracking, a ``jax.custom_vjp`` bwd rule
must produce cotangents whose varying manual axes exactly match the primal
inputs'. The rasterizer's absgrad *sink* is created as plain zeros — an
unvarying value — but its cotangent is derived from device-varying image
losses, so strict-vma JAX rejects the backward pass unless the sink primal
is declared varying first (``jax.lax.pcast(..., to="varying")``). These
helpers promote a value's vma to the join of reference values' vma; they
are exact no-ops outside shard_map.
"""

from __future__ import annotations

import jax


def vma_of(x) -> frozenset:
    """The set of manual mesh axes ``x`` is varying over (empty outside
    shard_map)."""
    return frozenset(getattr(jax.typeof(x), "vma", None) or ())


def match_vma(x, *refs):
    """Promote ``x`` to vary over every manual axis any of ``refs`` varies
    over. Use on custom-VJP primal inputs (e.g. gradient sinks) whose
    cotangent will inherit the refs' varying axes."""
    want = frozenset().union(*(vma_of(r) for r in refs)) - vma_of(x)
    if not want:
        return x
    return jax.lax.pcast(x, tuple(sorted(want, key=str)), to="varying")


def shard_map(f, *, mesh, in_specs, out_specs, backend: str):
    """``jax.shard_map`` with varying-manual-axes checking on, except for
    the ``interpret`` render backend.

    Strict vma typing is the trace-time defense against per-device partial
    grads being psum'd as if they were the true reduction (or not psum'd
    at all). The XLA compositors and the compiled Pallas pair compositor,
    whose ``out_struct`` outputs declare their vma, trace to vma-clean
    jaxprs. The Pallas interpreter does not: its discharge rules combine
    the kernel's varying operands with fresh unvarying constants and grid
    indices (``pad``/``dynamic_slice`` vma mismatches in JAX 0.9), so the
    interpreted kernels run unchecked. Unchecked, grads w.r.t. replicated
    inputs stay per-device partials and the callers' explicit psums are the
    single reduction — the same numbers, pinned by tests/test_vma.py and
    tests/test_train_sharded.py.
    """
    return jax.shard_map(f, mesh=mesh, in_specs=in_specs,
                         out_specs=out_specs,
                         check_vma=backend != "interpret")


def out_struct(shape, dtype, *refs):
    """``jax.ShapeDtypeStruct`` for a pallas_call output whose vma joins the
    refs' — required when the kernel runs under strict-vma shard_map (the
    out aval must declare its varying axes); a plain struct otherwise."""
    v = frozenset().union(*(vma_of(r) for r in refs))
    if not v:
        return jax.ShapeDtypeStruct(shape, dtype)
    return jax.ShapeDtypeStruct(shape, dtype, vma=v)
