"""Differentiation rules for the Pallas casts.

A closest-hit query is piecewise-constant in its inputs almost everywhere: the
*identity* of the hit triangle only changes at visibility discontinuities.
The kernels have no autodiff rule of their own, so each is wrapped in a
``jax.custom_vjp`` whose backward is analytic:

* ``pallas_cast_detached`` — detached visibility: discrete outputs (hit id,
  material, validity) are constants, the hit TIME gets its true local
  derivative.  On the hit plane with unit normal n, ``t(o, d) = n.(a - o) /
  n.d``, so ``dt/do = -n / (n.d)`` and ``dt/dd = -t n / (n.d)``, applied from
  the already computed hit normal.  This carries camera-pose and hit-position
  gradients exactly wherever the hit plane is locally smooth (for faceted
  box meshes the shading normal IS the plane normal).
* ``pallas_cast_reparam`` — the vertex-gradient configuration: every
  continuous output (t, uv, normal) gets its exact local derivative with
  respect to the ray AND the hit triangle's vertices, re-derived in closed
  form at the hit (``_recon_plane_hit``) and pulled back with ``jax.vjp``,
  so it is definitionally consistent with the jnp oracle cast's autodiff.
* ``pallas_occlude_detached`` / ``pallas_occlude2_detached`` — any-hit
  booleans are autodiff constants.

The rules are defined ONCE at module scope; everything traced (rays, the
prepare_pallas_cast aux pytree, geometry arrays) enters as explicit
custom_vjp arguments and the static RenderConfig rides nondiff_argnums.
Per-call custom_vjp closures over the kernel tables leak tracers across the
remat re-trace of a ``jax.checkpoint``-ed sample (UnexpectedTracerError /
"No constant handler for DynamicJaxprTracer")."""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np


def _zeros_cot(tree):
    """Zero cotangents for an arbitrary pytree (float0 for int/bool leaves,
    as custom_vjp requires for non-differentiable dtypes)."""

    def z(x):
        if x is None:
            return None
        dt = jnp.asarray(x).dtype
        if jnp.issubdtype(dt, jnp.floating) or jnp.issubdtype(
                dt, jnp.complexfloating):
            return jnp.zeros_like(x)
        return np.zeros(jnp.shape(x), jax.dtypes.float0)

    return jax.tree_util.tree_map(z, tree)


def _meta_of(tree):
    """Shape/dtype-only skeleton of a pytree — residual metadata for
    backward rules that emit pure-zero cotangents.  Saving the arrays
    themselves would keep frame-sized ray batches and the whole scene-table/
    LBVH pytree alive as residuals for no purpose (ADVICE r4)."""
    return jax.tree_util.tree_map(
        lambda x: jax.ShapeDtypeStruct(jnp.shape(x), jnp.result_type(x)),
        tree)


def _zeros_from_meta(meta):
    """Zero cotangents from a ``_meta_of`` skeleton (float0 for int/bool)."""

    def z(s):
        if jnp.issubdtype(s.dtype, jnp.floating) or jnp.issubdtype(
                s.dtype, jnp.complexfloating):
            return jnp.zeros(s.shape, s.dtype)
        return np.zeros(s.shape, jax.dtypes.float0)

    return jax.tree_util.tree_map(z, meta)


def _kernel_cast(cfg, aux):
    from .pallas_engine import make_pallas_cast

    return make_pallas_cast(None, None, cfg, aux=aux)


def _pallas_cast(cfg, ro, rd, aux):
    # One launch over all rays: a 1080p frame's rays and hits are ~100 MB,
    # far inside the card's memory, so no ray chunking is needed.
    return _kernel_cast(cfg, aux)(ro, rd)


@functools.partial(jax.custom_vjp, nondiff_argnums=(0,))
def pallas_cast_detached(cfg, ro, rd, aux):
    """Pallas closest-hit cast under the detached-visibility rule with the
    analytic t-VJP (see the module docstring for the math)."""
    return _pallas_cast(cfg, ro, rd, aux)


def _detached_fwd(cfg, ro, rd, aux):
    hit = _pallas_cast(cfg, ro, rd, aux)
    n = hit.normal if hit.normal is not None else jnp.zeros_like(ro)
    return hit, (rd, hit.valid, jnp.where(hit.valid, hit.t, 0.0), n, aux)


def _detached_bwd(cfg, res, g):
    rd, valid, t, n, aux = res
    g_t = getattr(g, "t", None)
    if g_t is None:  # pragma: no cover — Hit always carries t
        return jnp.zeros_like(rd), jnp.zeros_like(rd), _zeros_cot(aux)
    nd = jnp.sum(n * rd, axis=-1)
    ok = valid & (jnp.abs(nd) >= 1e-5)
    inv = jnp.where(ok, 1.0 / jnp.where(ok, nd, 1.0), 0.0)
    scale = jnp.where(ok, g_t, 0.0) * inv
    go = -scale[..., None] * n
    gd = -(scale * t)[..., None] * n
    return go, gd, _zeros_cot(aux)


pallas_cast_detached.defvjp(_detached_fwd, _detached_bwd)


@functools.partial(jax.custom_vjp, nondiff_argnums=(0,))
def pallas_occlude_detached(cfg, ro, rd, max_t, aux):
    """Any-hit occlusion query as an autodiff constant (a piecewise-constant
    boolean; without the rule, jvp tracing would still visit the
    pallas_call, which has no jvp rule)."""
    return _kernel_cast(cfg, aux).occlude(ro, rd, max_t)


def _occlude_fwd(cfg, ro, rd, max_t, aux):
    return (_kernel_cast(cfg, aux).occlude(ro, rd, max_t),
            _meta_of((ro, rd, max_t, aux)))


def _occlude_bwd(cfg, res, _g):
    return _zeros_from_meta(res)


pallas_occlude_detached.defvjp(_occlude_fwd, _occlude_bwd)


def _recon_plane_hit(ro, rd, va, vb, vc, na, nb, nc):
    """Closed-form (t, uv, normal) of the plane hit — all inputs [R,3]; the
    reparam rule's backward differentiates it."""
    from .. import raymath as _rm

    n = jnp.cross(vb - va, vc - va)
    nd = jnp.sum(n * rd, axis=-1)
    denom = jnp.where(jnp.abs(nd) > 0, nd, 1.0)
    t = jnp.sum(n * (va - ro), axis=-1) / denom
    p = ro + t[..., None] * rd
    nn2 = jnp.maximum(jnp.sum(n * n, axis=-1), 1e-30)
    u = jnp.sum(jnp.cross(p - va, vc - va) * n, axis=-1) / nn2
    v = jnp.sum(jnp.cross(vb - va, p - va) * n, axis=-1) / nn2
    uv = jnp.stack([u, v], axis=-1)
    sn = (1.0 - u - v)[..., None] * na + u[..., None] * nb + v[..., None] * nc
    return t, uv, _rm.normalize(sn)


@functools.partial(jax.custom_vjp, nondiff_argnums=(0,))
def pallas_occlude2_detached(cfg, o1, d1, mt1, o2, d2, mt2, aux):
    """Fused dual any-hit query as an autodiff constant."""
    return _kernel_cast(cfg, aux).occlude2(o1, d1, mt1, o2, d2, mt2)


def _occlude2_fwd(cfg, o1, d1, mt1, o2, d2, mt2, aux):
    out = _kernel_cast(cfg, aux).occlude2(o1, d1, mt1, o2, d2, mt2)
    return out, _meta_of((o1, d1, mt1, o2, d2, mt2, aux))


def _occlude2_bwd(cfg, res, _g):
    return _zeros_from_meta(res)


pallas_occlude2_detached.defvjp(_occlude2_fwd, _occlude2_bwd)


@functools.partial(jax.custom_vjp, nondiff_argnums=(0,))
def pallas_cast_reparam(cfg, ro, rd, aux, geo):
    """Pallas cast with the full analytic (t, uv, normal)-VJP including
    cotangents back to the triangle arrays (the vertex-gradient
    configuration; see the module docstring for the math).

    ``geo`` is the PACKED per-world-triangle geometry matrix [W, 18]
    (columns a | b | c | na | nb | nc, built by ``pack_reparam_geo``): one
    matrix means the fwd pays ONE [R]-row gather and the bwd ONE [W]-row
    scatter-add instead of six of each."""
    return _pallas_cast(cfg, ro, rd, aux)


def pack_reparam_geo(geom):
    """[W, 18] packed (a, b, c, na, nb, nc) for pallas_cast_reparam; a plain
    differentiable concat, so cotangents flow back to the geom arrays."""
    zeros = jnp.zeros_like(geom.a)
    return jnp.concatenate(
        [geom.a, geom.b, geom.c,
         geom.na if geom.na is not None else zeros,
         geom.nb if geom.nb is not None else zeros,
         geom.nc if geom.nc is not None else zeros], axis=1)


def _reparam_fwd(cfg, ro, rd, aux, geo):
    hit = _pallas_cast(cfg, ro, rd, aux)
    res = (ro, rd, hit.valid, hit.wtri, geo[hit.wtri], aux,
           jnp.zeros_like(geo))  # [W,18] zeros template for the scatter
    return hit, res


def _reparam_bwd(cfg, res, g):
    from .. import raymath as _rm

    ro, rd, valid, w, rows, aux, geo_template = res
    va, vb, vc = rows[..., 0:3], rows[..., 3:6], rows[..., 6:9]
    na, nb, nc = rows[..., 9:12], rows[..., 12:15], rows[..., 15:18]
    n = jnp.cross(vb - va, vc - va)
    nd = jnp.sum(n * rd, axis=-1)
    nn2 = jnp.sum(n * n, axis=-1)
    ok = valid & (jnp.abs(nd) >= _rm.THRESHOLD) & (nn2 > 1e-20)
    okv = ok[..., None]
    ro_s = jnp.where(okv, ro, jnp.array([0.0, 0.0, -1.0]))
    rd_s = jnp.where(okv, rd, jnp.array([0.0, 0.0, 1.0]))
    va_s = jnp.where(okv, va, jnp.array([-1.0, -1.0, 0.0]))
    vb_s = jnp.where(okv, vb, jnp.array([3.0, -1.0, 0.0]))
    vc_s = jnp.where(okv, vc, jnp.array([-1.0, 3.0, 0.0]))
    z_up = jnp.array([0.0, 0.0, 1.0])
    na_s = jnp.where(okv, na, z_up)
    nb_s = jnp.where(okv, nb, z_up)
    nc_s = jnp.where(okv, nc, z_up)

    def _cot(x, shape):
        if x is None or getattr(x, "dtype", None) is None \
                or x.dtype == jax.dtypes.float0:
            return jnp.zeros(shape, jnp.float32)
        return x

    g_t = jnp.where(ok, _cot(getattr(g, "t", None), ok.shape), 0.0)
    g_uv = jnp.where(okv, _cot(getattr(g, "uv", None), ok.shape + (2,)), 0.0)
    g_n = jnp.where(okv, _cot(getattr(g, "normal", None),
                              ok.shape + (3,)), 0.0)

    _, pull = jax.vjp(_recon_plane_hit, ro_s, rd_s, va_s, vb_s, vc_s,
                      na_s, nb_s, nc_s)
    d_ro, d_rd, d_va, d_vb, d_vc, d_na, d_nb, d_nc = pull((g_t, g_uv, g_n))

    d_rows = jnp.where(
        okv, jnp.concatenate([d_va, d_vb, d_vc, d_na, d_nb, d_nc], -1), 0.0
    )
    d_geo = geo_template.at[w].add(d_rows)  # ONE [W,18] scatter-add
    return d_ro, d_rd, _zeros_cot(aux), d_geo


pallas_cast_reparam.defvjp(_reparam_fwd, _reparam_bwd)
