"""``bench/attr_iter.py``'s components on the CPU at 16³ (p = 3, 2 levels):
each computes what the production step computes, the double-word ones held
against the JAX package's functions on the same words.

Tolerances: the double-word residual and A·p against the JAX package's
``residual_kron_df`` 1e-13 of max|r| in the merged f64 value (the port's
plain version adds in its own order); the norm 1e-14 relative (the orders
of addition differ); a step against a direct call of the solver's step:
bit-equal (the same calls); the x/r update against α·p and b − α·A·p in
f64, 1e-13 of max|α·p| and of max|b| (r cancels most of b).
"""
import numpy as np
import pytest
import torch

from poms_tpu_torch.bench import attr_iter
from poms_tpu_torch.ops.twofloat import merge_f64

torch.set_num_threads(1)

N_EL = 16


@pytest.fixture(scope="module", params=["dc", "pcg"])
def built(request):
    return (request.param,) + attr_iter.components(N_EL, 3, request.param,
                                                   device="cpu")


def _jax_residual(mg, bh, bl, xh, xl):
    import jax.numpy as jnp

    from poms_tpu.ops.twofloat import residual_kron_df

    terms = [[tuple(jnp.asarray(w.numpy()) for w in pair) for pair in term]
             for term in mg._terms_df]
    rh, rl = residual_kron_df(terms, *(jnp.asarray(t.numpy())
                                       for t in (bh, bl, xh, xl)),
                              mg.problem.space.pads, labels=mg._labels)
    return np.asarray(rh, np.float64) + np.asarray(rl, np.float64)


def test_component_names(built):
    what, _, fns = built
    assert set(fns) == set(attr_iter.STEP_PARTS[what]) | {"step"}


def test_components_compute_the_step_parts(built):
    from poms_tpu_torch.ops.twofloat import dw_dot, dw_norm2, split_f64

    what, mg, fns = built
    bh, bl = split_f64(mg.problem.b.interior)
    zero = torch.zeros_like(bh)
    cyc = fns["cycle"]()
    assert cyc.shape == bh.shape and torch.isfinite(cyc).all()
    if what == "dc":
        rh, rl = fns["resid"]()
        want = _jax_residual(mg, bh, bl, bh, zero)
        got = merge_f64(rh, rl).numpy()
        assert np.abs(got - want).max() <= 1e-13 * np.abs(want).max()
        n = float(fns["norm"]())
        ref = float(torch.linalg.vector_norm(mg.problem.b.interior))
        assert abs(n - ref) <= 1e-14 * ref
        rn = dw_norm2(bh, bl)
        step = fns["step"]()
        direct = mg._step_tf(zero, zero, bh, bl, rn, bh, bl)
    else:
        p = mg._precond_dw(bh, bl, dw_norm2(bh, bl))
        aph, apl = fns["dw_ap"]()
        want = -_jax_residual(mg, zero, zero, p, zero)
        got = merge_f64(aph, apl).numpy()
        assert np.abs(got - want).max() <= 1e-13 * np.abs(want).max()
        pap = float(fns["dw_dot"]())
        ref = float(np.dot(p.double().numpy().ravel(), got.ravel()))
        assert abs(pap - ref) <= 1e-12 * abs(ref)
        xh, xl, rh, rl, _, _ = fns["axpy"]()
        rz = dw_dot(p, None, bh, bl)
        alpha = float(rz) / pap
        x_want = alpha * p.double().numpy()
        assert np.abs(merge_f64(xh, xl).numpy() - x_want).max() \
            <= 1e-13 * np.abs(x_want).max()
        b = mg.problem.b.interior.numpy()
        r_want = b - alpha * got      # cancels: hold it to b's scale
        assert np.abs(merge_f64(rh, rl).numpy() - r_want).max() \
            <= 1e-13 * np.abs(b).max()
        step = fns["step"]()
        direct = mg._step_dw(zero, zero, bh, bl, p, p, rz)
    for a, b in zip(step, direct):
        assert torch.equal(a, b)


def test_run_reports_the_jax_keys_and_the_split():
    out = attr_iter.run(N_EL, 3, "dc", device="cpu", reps=1)
    for key in ("cycle_s", "resid_s", "norm_s", "step_s"):
        assert out[key] > 0
    parts = 1e3 * (out["cycle_s"] + out["resid_s"] + out["norm_s"])
    assert abs(out["parts_ms"] - parts) <= 1e-9 * parts
    assert out["step_over_parts"] == pytest.approx(
        out["step_s"] * 1e3 / parts)
    assert out["levels"] == 2 and out["device"] == "cpu"
    with pytest.raises(ValueError):
        attr_iter.components(8, 3, "gmres", device="cpu")
