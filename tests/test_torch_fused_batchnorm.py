"""The port's fused train-mode BatchNorm against the JAX package's, on
the CPU (the kernels K5 and K6 run their plain versions here; the JAX
kernel runs through ``impl="pallas-interpret"``).

- the plain K5 against JAX's interpreted kernel over
  ``tests/test_fused_batchnorm.py``'s shapes and every relu x residual
  combination: float32 atol 1e-5 on y, mean and var (the same float32
  arithmetic summed in another order); bf16 y within one bf16 ulp
  (floored at the ulp of 1/16), which the cast-then-add order of the
  xla composition does not meet, and the float32 moments 1e-5;
- the plain K6, and the autograd Function, against ``jax.grad`` through
  the interpreted kernel: atol 1e-5 on dx, dgamma, dbeta and dres;
- the ReLU kink (zero gradient at y == 0);
- the stock composition (``models/resnet.stock_batchnorm``) against
  ``impl="xla"`` and ``flax.linen.BatchNorm``: float32 atol 1e-6 (the
  same op order; reductions in another order), bf16 y within one ulp;
- the input validation, the dispatch and the counters.
"""

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tf_operator_tpu.ops.fused_batchnorm import fused_batchnorm as j_fused_batchnorm

from tf_operator_tpu_torch.models.resnet import stock_batchnorm
from tf_operator_tpu_torch.ops import _build
from tf_operator_tpu_torch.ops import fused_batchnorm as fb

torch.set_num_threads(2)

#: tests/test_fused_batchnorm.py:30
SHAPES = [(2, 3, 3, 5), (2, 4, 4, 128), (3, 5, 5, 192), (34, 1, 1, 7), (1, 9, 5, 130)]
COMBOS = [(False, False), (True, False), (False, True), (True, True)]


def _inputs(shape, seed=0):
    r = np.random.RandomState(seed)
    c = shape[-1]
    return ((r.randn(*shape) * 2 + 0.3).astype(np.float32), r.randn(c).astype(np.float32),
            r.randn(c).astype(np.float32), r.randn(*shape).astype(np.float32))


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.asarray(a, np.float32)).to(dtype)


def _np(t):
    return t.detach().float().numpy()


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_plain_forward_matches_interpreted_kernel(shape):
    x, gamma, beta, res = _inputs(shape)
    for relu, use_res in COMBOS:
        j = jax.jit(lambda x, g, b, r, relu=relu, use_res=use_res: j_fused_batchnorm(
            x, g, b, relu=relu, residual=r if use_res else None, impl="pallas-interpret"))
        y_ref, m_ref, v_ref = j(x, gamma, beta, res)
        y, m, v = fb.fused_batchnorm(_t(x), _t(gamma), _t(beta), relu=relu,
                                     residual=_t(res) if use_res else None)
        assert y.shape == shape and y.dtype == torch.float32 and m.shape == (shape[-1],)
        for got, want in ((y, y_ref), (m, m_ref), (v, v_ref)):
            np.testing.assert_allclose(_np(got), np.asarray(want), atol=1e-5,
                                       err_msg=f"relu={relu} residual={use_res}")


def _bf16_ulps(got, want):
    """Largest |got - want| in bf16 ulps of ``want``, the ulp floored at
    that of |want| = 1/16 (an output that cancels to near zero is held
    to the ulp of 1/16, not to its own)."""

    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    ulp = np.exp2(np.floor(np.log2(np.maximum(np.abs(want), 2.0 ** -4))) - 7)
    return float(np.max(np.abs(got - want) / ulp))


def _bf16_case(relu, use_res):
    x, gamma, beta, res = _inputs((3, 5, 5, 192))
    xb, rb = jnp.asarray(x, jnp.bfloat16), jnp.asarray(res, jnp.bfloat16)
    y_ref, m_ref, v_ref = j_fused_batchnorm(xb, gamma, beta, relu=relu,
                                            residual=rb if use_res else None,
                                            impl="pallas-interpret")
    return xb, rb, gamma, beta, y_ref, m_ref, v_ref


def test_plain_forward_bf16_matches_interpreted_kernel():
    """bf16 y within one bf16 ulp of the kernel's: both round the same
    float32 value once (K5 adds the residual in float32, then casts), so
    they differ only where float32 sums in another order cross a
    rounding boundary.  The float32 moments within 1e-5."""

    for relu, use_res in COMBOS:
        xb, rb, gamma, beta, y_ref, m_ref, v_ref = _bf16_case(relu, use_res)
        y, m, v = fb.fused_batchnorm(
            _t(np.asarray(xb, np.float32), torch.bfloat16), _t(gamma), _t(beta), relu=relu,
            residual=_t(np.asarray(rb, np.float32), torch.bfloat16) if use_res else None)
        assert y.dtype == torch.bfloat16 and m.dtype == torch.float32 and v.dtype == torch.float32
        ulps = _bf16_ulps(_np(y), y_ref)
        assert ulps <= 1.0, f"relu={relu} residual={use_res}: {ulps} bf16 ulps"
        np.testing.assert_allclose(_np(m), np.asarray(m_ref), atol=1e-5)
        np.testing.assert_allclose(_np(v), np.asarray(v_ref), atol=1e-5)


@pytest.mark.parametrize("relu", [False, True])
def test_cast_then_add_order_breaks_the_one_ulp_bound(relu):
    """The bound above tells the two rounding points apart: the xla
    composition (JAX ``impl="xla"``, and the port's stock graph) casts
    the normalised value to bf16 before it adds the residual, and lands
    many ulps off the kernel where the sum cancels."""

    xb, rb, gamma, beta, y_ref, _, _ = _bf16_case(relu, True)
    y_xla, _, _ = j_fused_batchnorm(xb, gamma, beta, relu=relu, residual=rb, impl="xla")
    y_stock, _, _ = stock_batchnorm(_t(np.asarray(xb, np.float32), torch.bfloat16), _t(gamma),
                                    _t(beta), 1e-5, relu,
                                    _t(np.asarray(rb, np.float32), torch.bfloat16))
    assert _bf16_ulps(y_xla, y_ref) > 1.0
    assert _bf16_ulps(_np(y_stock), y_ref) > 1.0


@pytest.mark.parametrize("relu,use_res", COMBOS)
def test_plain_backward_and_function_match_jax_grad(relu, use_res):
    x, gamma, beta, res = _inputs((3, 3, 3, 7), seed=3)
    w = np.random.RandomState(9).randn(*x.shape).astype(np.float32)

    def loss(x, g, b, r):
        y, _, _ = j_fused_batchnorm(x, g, b, relu=relu, residual=r if use_res else None,
                                    impl="pallas-interpret")
        return jnp.sum(y * w)

    want = jax.grad(loss, argnums=(0, 1, 2, 3))(x, gamma, beta, res)

    # the autograd Function (plain K5 forward, plain K6 backward)
    xs = [_t(a).requires_grad_() for a in (x, gamma, beta, res)]
    y, mean, var = fb.fused_batchnorm(xs[0], xs[1], xs[2], relu=relu,
                                      residual=xs[3] if use_res else None)
    assert not mean.requires_grad and not var.requires_grad
    (y * _t(w)).sum().backward()
    got = [t.grad if t.grad is not None else torch.zeros_like(t) for t in xs]
    for name, a, b in zip(("dx", "dgamma", "dbeta", "dres"), got, want):
        np.testing.assert_allclose(_np(a), np.asarray(b), atol=1e-5, err_msg=name)

    # the plain K6 on its own, from the plain K5's saved outputs
    x2, res2 = _t(x).reshape(-1, 7), _t(res).reshape(-1, 7)
    y2, m, v = fb.fused_batchnorm_fwd_plain(x2, _t(gamma), _t(beta), 1e-5, relu,
                                            res2 if use_res else None)
    dx, dg, db, dres = fb.fused_batchnorm_bwd_plain(_t(w).reshape(-1, 7), x2, _t(gamma), y2, m,
                                                    v, 1e-5, relu, use_res)
    np.testing.assert_allclose(_np(dx).reshape(x.shape), np.asarray(want[0]), atol=1e-5)
    np.testing.assert_allclose(_np(dg), np.asarray(want[1]), atol=1e-5)
    np.testing.assert_allclose(_np(db), np.asarray(want[2]), atol=1e-5)
    if use_res:
        np.testing.assert_allclose(_np(dres).reshape(x.shape), np.asarray(want[3]), atol=1e-5)
        assert np.any(_np(dres) != 0)
    else:
        assert dres is None and not np.any(np.asarray(want[3]))


def test_relu_kink_has_zero_gradient():
    """Constant columns: var = 0, y = beta = 0 everywhere, at the kink;
    the mask ``y > 0`` gives 0 there, as jax.nn.relu does."""

    x = np.asarray([[0.0, -1.0, 2.0, 0.0]] * 8, np.float32)
    gamma, beta = np.ones(4, np.float32), np.zeros(4, np.float32)
    j = jax.grad(lambda x: jnp.sum(j_fused_batchnorm(x, gamma, beta, relu=True,
                                                     impl="pallas-interpret")[0]))(x)
    assert not np.any(np.asarray(j))
    xt = _t(x).requires_grad_()
    fb.fused_batchnorm(xt, _t(gamma), _t(beta), relu=True)[0].sum().backward()
    assert not torch.any(xt.grad != 0)


@pytest.mark.parametrize("relu,use_res", COMBOS)
def test_stock_composition_matches_xla_impl(relu, use_res):
    x, gamma, beta, res = _inputs((2, 4, 4, 6), seed=1)
    w = np.random.RandomState(2).randn(*x.shape).astype(np.float32)

    def loss(x, g, b, r):
        y, _, _ = j_fused_batchnorm(x, g, b, relu=relu, residual=r if use_res else None,
                                    impl="xla")
        return jnp.sum(y * w)

    y_ref, m_ref, v_ref = j_fused_batchnorm(x, gamma, beta, relu=relu,
                                            residual=res if use_res else None, impl="xla")
    want = jax.grad(loss, argnums=(0, 1, 2, 3))(x, gamma, beta, res)
    xs = [_t(a).requires_grad_() for a in (x, gamma, beta, res)]
    y, m, v = stock_batchnorm(xs[0], xs[1], xs[2], 1e-5, relu, xs[3] if use_res else None)
    for got, ref in ((y, y_ref), (m, m_ref), (v, v_ref)):
        np.testing.assert_allclose(_np(got), np.asarray(ref), atol=1e-6)
    (y * _t(w)).sum().backward()
    for t, ref in zip(xs, want):
        g = t.grad if t.grad is not None else torch.zeros_like(t)
        np.testing.assert_allclose(_np(g), np.asarray(ref), atol=1e-5)


def test_stock_composition_matches_flax_batchnorm_bf16():
    """bf16 activations, float32 parameters: y within one bf16 ulp of
    flax's, and flax's running-statistics update from the moments."""

    x, gamma, beta, _ = _inputs((2, 4, 4, 5))
    xb = jnp.asarray(x, jnp.bfloat16)
    bn = nn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5,
                      dtype=jnp.bfloat16, param_dtype=jnp.float32)
    v0 = bn.init(jax.random.PRNGKey(0), xb)
    v = {"params": {"scale": gamma, "bias": beta}, "batch_stats": v0["batch_stats"]}
    y_ref, upd = bn.apply(v, xb, mutable=["batch_stats"])
    y, m, var = stock_batchnorm(_t(np.asarray(xb, np.float32), torch.bfloat16), _t(gamma),
                                _t(beta))
    assert y.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(y), np.asarray(y_ref, np.float32), atol=2 ** -6, rtol=2 ** -8)
    np.testing.assert_allclose(0.9 * 0 + (1 - 0.9) * _np(m),
                               np.asarray(upd["batch_stats"]["mean"]), atol=1e-6)
    np.testing.assert_allclose(0.9 * 1 + (1 - 0.9) * _np(var),
                               np.asarray(upd["batch_stats"]["var"]), atol=1e-6)


@pytest.mark.parametrize("case", ["impl_xla", "impl_cuda", "ndim1", "gamma_shape", "beta_shape",
                                  "residual_shape"])
def test_input_validation(case):
    x = torch.zeros(4, 3, 5)
    g, b = torch.ones(5), torch.zeros(5)
    kw = {}
    if case == "impl_xla":
        kw["impl"] = "xla"
    elif case == "impl_cuda":
        kw["impl"] = "cuda"  # no third dispatch setting
    elif case == "ndim1":
        x = torch.zeros(5)
    elif case == "gamma_shape":
        g = torch.ones(4)
    elif case == "beta_shape":
        b = torch.zeros(1, 5)
    else:
        kw["residual"] = torch.zeros(4, 5)
    with pytest.raises(ValueError):
        fb.fused_batchnorm(x, g, b, **kw)


def test_kernel_wrappers_refuse_cpu_tensors():
    x2 = torch.zeros(4, 5)
    with pytest.raises(ValueError, match="not on a CUDA device"):
        fb.fused_batchnorm_fwd_cuda(x2, torch.ones(5), torch.zeros(5), 1e-5, False, None)
    with pytest.raises(ValueError, match="not on a CUDA device"):
        fb.fused_batchnorm_bwd_cuda(x2, x2, torch.ones(5), None, torch.zeros(5), torch.ones(5),
                                    1e-5, False, False)


@pytest.mark.parametrize("impl", [None, "plain"])
def test_cpu_runs_the_plain_versions_and_counts_them(impl):
    fb.plain_calls.clear()
    _build.launches.clear()
    x = torch.randn(2, 3, 3, 8, requires_grad=True)
    y, _, _ = fb.fused_batchnorm(x, torch.ones(8), torch.zeros(8), relu=True, impl=impl)
    y.sum().backward()
    assert dict(fb.plain_calls) == {fb.KERNEL_FWD: 1, fb.KERNEL_BWD: 1}
    assert not _build.launches


@pytest.mark.parametrize("r,c,chunks", [(802816, 64, 264), (3136, 2048, 9), (200704, 256, 66),
                                        (18, 5, 1), (50176, 512, 33)])
def test_row_split_covers_every_row(r, c, chunks):
    n, rows = fb.chunk_rows(r, c)
    assert n == chunks
    assert (n - 1) * rows < r <= n * rows


#: an H100's K6 resources at two CTAs an SM: 264 CTAs, 111,616 bytes of
#: rows a CTA
H100_CTAS, H100_HOLD = 264, 111616


@pytest.mark.parametrize("elem", [2, 4], ids=["bf16", "f32"])
@pytest.mark.parametrize("r,c", [(802816, 64), (200704, 256), (50176, 128), (12544, 1024),
                                 (3136, 2048), (3136, 512), (18, 5), (45, 130), (7, 20000)])
def test_bwd_plan_covers_every_row_and_holds_what_fits(r, c, elem):
    chunks, rows, hold_rows = fb.bwd_plan(r, c, H100_CTAS, H100_HOLD, elem)
    tiles = -(-c // fb.TILE_C)
    assert (chunks - 1) * rows < r <= chunks * rows
    assert chunks == 1 or tiles * chunks <= H100_CTAS
    assert rows >= min(r, fb.ROW_LANES)
    assert hold_rows == min(rows, H100_HOLD // (2 * fb.TILE_C * elem))
    held = fb.bwd_held_bytes(r, c, H100_CTAS, H100_HOLD, elem)
    whole = 2 * elem * r * c
    if tiles <= H100_CTAS:  # one item a CTA: each chunk keeps its last hold_rows rows
        assert held == 2 * elem * c * sum(min(hold_rows, r - k * rows) for k in range(chunks))
    assert 0 < held <= whole
    assert (held == whole) == (hold_rows == rows and tiles <= H100_CTAS)


def test_bwd_plan_keeps_the_small_resnet_layers_whole_on_chip():
    """At batch 64 in bf16, every [3136, C] layer, [12544, 256], [12544,
    512] and [50176, 128] fit the grid's shared memory whole; the stem
    and [12544, 1024] do not."""

    for r, c in ((3136, 512), (3136, 2048), (12544, 256), (12544, 512), (50176, 128)):
        assert fb.bwd_held_bytes(r, c, H100_CTAS, H100_HOLD, 2) == 4 * r * c, (r, c)
    for r, c in ((802816, 64), (12544, 1024)):
        assert fb.bwd_held_bytes(r, c, H100_CTAS, H100_HOLD, 2) < 4 * r * c, (r, c)
