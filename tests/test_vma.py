"""Strict-vma regression tests for the absgrad sink under shard_map.

A custom VJP that produces a 'views'-varying dsink cotangent for an
unvarying sink primal is rejected by strict varying-manual-axes JAX. The
sink is declared varying (ops.vma.match_vma) at the grad-argument creation
site — OUTSIDE the differentiated function, so the pcast does not
transpose into a psum — and the rasterizer makes its render data vary
wherever the sink does. These tests pin both the mechanism and the
numerics.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh, PartitionSpec as P

from edgegaussians_tpu.ops import vma

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 8, reason="needs 8 virtual devices")


def _mesh(n=8, axis="views"):
    return Mesh(np.array(jax.devices()[:n]), (axis,))


def test_match_vma_promotes_to_ref_axes():
    mesh = _mesh()
    seen = {}

    def f(xs, sink):
        sink2 = vma.match_vma(sink, xs)
        seen["sink"] = vma.vma_of(sink)
        seen["sink2"] = vma.vma_of(sink2)
        seen["xs"] = vma.vma_of(xs)
        return (jnp.sum(sink2) + jnp.sum(xs))[None]

    sh = jax.shard_map(f, mesh=mesh, in_specs=(P("views"), P()),
                       out_specs=P("views"))
    jax.jit(sh)(jnp.ones((8, 2)), jnp.zeros((3,)))
    assert seen["xs"] == frozenset({"views"})
    assert seen["sink"] == frozenset()
    assert seen["sink2"] == frozenset({"views"})


def test_match_vma_is_noop_when_already_varying():
    mesh = _mesh()

    def f(xs):
        # double-promotion must not raise (pvary errors on present axes)
        y = vma.match_vma(xs, xs)
        return jnp.sum(y)[None]

    sh = jax.shard_map(f, mesh=mesh, in_specs=(P("views"),),
                       out_specs=P("views"))
    out = jax.jit(sh)(jnp.arange(8.0))
    assert out.shape == (8,)


def test_match_vma_noop_outside_shard_map():
    x = jnp.zeros((4,))
    y = vma.match_vma(x, jnp.ones((4,)))
    assert y is x


def test_sink_grad_stays_per_device():
    """The pvary'd sink's cotangent must remain the device-local value
    (NOT a cross-device psum): pvary placed outside the grad."""
    mesh = _mesh()

    def f(xs, sink):
        sink = vma.match_vma(sink, xs)  # outside the grad closure

        def loss(s):
            return jnp.sum(jnp.abs(xs + s))

        g = jax.grad(loss)(sink)
        return g[None]  # per-device |xs| sign, varying

    sh = jax.shard_map(f, mesh=mesh, in_specs=(P("views"), P()),
                       out_specs=P("views"))
    xs = jnp.asarray(np.linspace(-1, 1, 8), jnp.float32)
    g = jax.jit(sh)(xs, jnp.zeros(()))
    # per-device cotangent = sign(xs_local): both signs present — a psum'd
    # (summed) cotangent would be a constant replicated across devices
    np.testing.assert_allclose(np.array(g), np.sign(np.array(xs)))


def test_tile_render_grad_under_shard_map_views():
    """End-to-end: render under a views-sharded shard_map, grads for params
    AND the absgrad sink; per-device absgrads must match the single-device
    per-view values (reference absgrad semantics: edge_gs.py:607-613)."""
    from edgegaussians_tpu.models.gaussians import render_view
    from edgegaussians_tpu.config import FrameworkConfig
    from edgegaussians_tpu.train import trainer

    r = np.random.default_rng(3)
    n, W, H, nv = 32, 32, 32, 8
    seeds = r.uniform(-0.4, 0.4, (n, 3)).astype(np.float32)
    seeds[:, 2] += 2.0
    cfg = FrameworkConfig()
    cfg.model.max_num_gaussians = n
    cfg.model.tile_gaussian_capacity = 16
    ts = trainer.init_train_state(seeds, cfg)
    params, alive = ts.gaussians.params, ts.gaussians.alive

    f = 30.0
    K = jnp.array([[f, 0, W / 2], [0, f, H / 2], [0, 0, 1]], jnp.float32)
    vm = jnp.eye(4, dtype=jnp.float32)
    images = jnp.asarray(r.random((nv, H, W)), jnp.float32)

    def per_view(img, sink):
        def loss(p, s):
            out = render_view(p, alive, vm, K, W, H, capacity=16,
                              backend="jax", absgrad_sink=s)
            return jnp.mean(jnp.abs(jnp.clip(out.image, 0, 1) - img))

        l, (g, gs) = jax.value_and_grad(
            loss, argnums=(0, 1))(params, sink)
        return l, jnp.linalg.norm(gs, axis=-1)

    mesh = _mesh()

    def sharded(images):
        sink = vma.match_vma(jnp.zeros((n, 2), jnp.float32), images)
        l, a = per_view(images[0], sink)
        return l[None], a[None]

    sh = jax.shard_map(sharded, mesh=mesh, in_specs=(P("views"),),
                       out_specs=(P("views"), P("views")))
    ls, absg = jax.jit(sh)(images)

    for v in range(nv):
        l_ref, a_ref = per_view(images[v],
                                jnp.zeros((n, 2), jnp.float32))
        assert np.isclose(float(ls[v]), float(l_ref), rtol=1e-5)
        np.testing.assert_allclose(np.array(absg[v]), np.array(a_ref),
                                   rtol=1e-4, atol=1e-8)


def test_checked_mode_sharded_proj_grad_equivalence():
    """The production tile-band proj-grad runs under check_vma=True
    (ops.vma.shard_map) and matches the single-device values — the strict
    type system that catches psum double-reduction bugs at trace time is
    live on every render path."""
    from edgegaussians_tpu.config import FrameworkConfig
    from edgegaussians_tpu.parallel import train_sharded
    from edgegaussians_tpu.train import trainer

    r = np.random.default_rng(5)
    n, W, H = 64, 64, 64
    seeds = r.uniform(-0.4, 0.4, (n, 3)).astype(np.float32)
    seeds[:, 2] += 2.0
    cfg = FrameworkConfig()
    cfg.model.max_num_gaussians = n
    cfg.model.tile_gaussian_capacity = 32
    ts = trainer.init_train_state(seeds, cfg)
    params, alive = ts.gaussians.params, ts.gaussians.alive

    f = 60.0
    K = jnp.array([[f, 0, W / 2], [0, f, H / 2], [0, 0, 1]], jnp.float32)
    vm = jnp.eye(4, dtype=jnp.float32)
    gt = jnp.asarray(r.random((H, W)), jnp.float32)
    em = gt > 0.5
    key = jax.random.PRNGKey(0)

    mesh = Mesh(np.array(jax.devices()[:4]), ("tiles",))
    # the builder must install a CHECKED shard_map for backend='jax'
    sharded = train_sharded.make_sharded_proj_grad_fn(cfg, W, H, "jax",
                                                      mesh)
    single = trainer.make_proj_grad_fn(cfg, W, H, "jax")

    for sidx in (0, 1, 2):
        l_s, st_s, g_s, a_s = jax.jit(sharded)(
            params, alive, vm, K, gt, em, jnp.int32(sidx),
            jnp.float32(1.0), key)
        l_r, st_r, g_r, a_r = jax.jit(single)(
            params, alive, vm, K, gt, em, jnp.int32(sidx),
            jnp.float32(1.0), key)
        assert np.isclose(float(l_s), float(l_r), rtol=1e-5), sidx
        np.testing.assert_allclose(np.array(g_s.means),
                                   np.array(g_r.means), atol=1e-6)
        np.testing.assert_allclose(np.array(a_s), np.array(a_r), atol=1e-6)


def test_seg_kernel_grads_under_checked_shard_map():
    """The Pallas seg compositor under a views-sharded ops.vma.shard_map:
    per-device loss and absgrad equal the single-device values. The
    interpreted kernels run with vma checking off (ops.vma.shard_map), so
    the replicated means' gradient stays each device's partial — the
    value the callers' explicit psum reduces."""
    from edgegaussians_tpu.ops.rasterize import rasterize

    r = np.random.default_rng(4)
    n, W, H, nv = 120, 48, 32, 4
    means = r.uniform(-0.4, 0.4, (n, 3)).astype(np.float32)
    means[:, 2] += 2.0
    quats = jnp.asarray(r.normal(size=(n, 4)), jnp.float32)
    scales = jnp.asarray(np.exp(r.uniform(-4.5, -3.0, (n, 3))), jnp.float32)
    opac = jnp.asarray(r.uniform(0.2, 0.9, n), jnp.float32)
    means = jnp.asarray(means)
    K = jnp.array([[40.0, 0, W / 2], [0, 40.0, H / 2], [0, 0, 1]],
                  jnp.float32)
    vm = jnp.eye(4, dtype=jnp.float32)
    images = jnp.asarray(r.random((nv, H, W)), jnp.float32)

    def per_view(img, sink):
        def loss(m, s):
            out = rasterize(m, quats, scales, opac, vm, K, W, H,
                            tile_size=16, capacity=64, pair_budget=4096,
                            pair_kernel="seg", backend="interpret",
                            absgrad_sink=s)
            return jnp.mean(jnp.abs(jnp.clip(out.image, 0, 1) - img))
        l, (gm, gs) = jax.value_and_grad(loss, argnums=(0, 1))(means, sink)
        return l, gm, jnp.linalg.norm(gs, axis=-1)

    def sharded(imgs):
        sink = vma.match_vma(jnp.zeros((n, 2), jnp.float32), imgs)
        l, gm, a = per_view(imgs[0], sink)
        return l[None], gm[None], a[None]

    sh = vma.shard_map(sharded, mesh=_mesh(nv), in_specs=(P("views"),),
                       out_specs=(P("views"), P("views"), P("views")),
                       backend="interpret")
    ls, gm, absg = jax.jit(sh)(images)
    refs = [per_view(images[v], jnp.zeros((n, 2), jnp.float32))
            for v in range(nv)]
    for v, (l_ref, g_ref, a_ref) in enumerate(refs):
        assert np.isclose(float(ls[v]), float(l_ref), rtol=1e-5)
        np.testing.assert_allclose(np.asarray(absg[v]), np.asarray(a_ref),
                                   rtol=1e-4, atol=1e-8)
        # the sharded program is compiled (fused) separately from the
        # single-device one: near-zero entries carry ~1e-7 f32 rounding
        np.testing.assert_allclose(np.asarray(gm[v]), np.asarray(g_ref),
                                   rtol=1e-4, atol=1e-6)
