"""Quality certificate of the port's FISTA solvers: ``tests/test_cs_quality.py``'s
checks (written for ``mridc_tpu.nn.cs_solvers``) run against
``mridc_tpu_torch.nn.cs_solvers`` on the CPU.

The reference PICS is BART's ``pics -R W`` (l1-wavelet SENSE), which cannot
run here; what is certified is that the port's FISTA solves the shared
convex objective

    F(x) = 1/2 ||M F S x - y||^2 + lam * ||Psi_detail x||_1

to optimality, against ``tests/test_cs_quality.py``'s independent numpy
oracle (numpy FFT, a numpy Haar lifted from the pyramid definition, complex
arithmetic; none of the port's ops) and its SENSE problem:
  1. the oracle's Haar and the solver's are the same orthogonal transform;
  2. KKT residuals at the returned solution: the approximation band (never
     thresholded) stationary, detail support at g = -lam sign(w), the detail
     zero set within |g| <= lam;
  3. the objective no higher than an independent 6000-iteration numpy ISTA's;
  4. at lam = 0 the data term at the numpy CG least-squares optimum (1%).
The limits are ``tests/test_cs_quality.py``'s. The solves
flush float32 denormals to zero, as XLA's CPU backend does for the JAX
package's solver: FISTA's momentum on converged iterates makes denormals,
which the CPU otherwise computes several times slower.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from mridc_tpu_torch.nn.cs_solvers import fista_l1_wavelet, haar_dwt2, haar_idwt2

from test_cs_quality import H, LEVELS, W, _e, _eh, _haar_fwd, _haar_inv, _objective, _problem


@pytest.fixture(autouse=True, scope="module")
def _one_thread_flushing_denormals():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    torch.set_flush_denormal(True)
    yield
    torch.set_flush_denormal(False)
    torch.set_num_threads(n)


def _rv(x):
    return torch.from_numpy(np.stack([x.real, x.imag], -1).astype(np.float32))


def _solve(y, sens, mask, lam, iters):
    out = fista_l1_wavelet(_rv(y)[None], _rv(sens)[None], torch.from_numpy(mask.astype(np.float32))[None, None],
                           reg_wt=lam, num_iters=iters, levels=LEVELS, fft_centered=True, fft_normalization="ortho")
    out = out[0].double().numpy()
    return out[..., 0] + 1j * out[..., 1]


def test_haar_oracle_matches_solver_transform():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, H, W)).astype(np.float32)
    ll_t, bands_t = haar_dwt2(torch.from_numpy(x), LEVELS)
    ll_n, bands_n = _haar_fwd(x.astype(np.float64))
    np.testing.assert_allclose(ll_t.numpy(), ll_n, atol=1e-4)
    for (at, bt, ct), (an, bn, cn) in zip(bands_t, bands_n):
        np.testing.assert_allclose(at.numpy(), an, atol=1e-4)
        np.testing.assert_allclose(bt.numpy(), bn, atol=1e-4)
        np.testing.assert_allclose(ct.numpy(), cn, atol=1e-4)
    np.testing.assert_allclose(haar_idwt2(ll_t, bands_t).numpy(), x, atol=1e-4)


def test_pics_kkt_optimality():
    _, sens, mask, y = _problem()
    lam = 0.01
    x = _solve(y, sens, mask, lam, iters=800)
    grad = _eh(_e(x, sens, mask) - y, sens, mask)
    gw_ll, gw_bands = _haar_fwd(np.stack([grad.real, grad.imag]))
    _, w_bands = _haar_fwd(np.stack([x.real, x.imag]))
    assert np.abs(gw_ll).max() < 0.02 * lam
    for gl, wl in zip(gw_bands, w_bands):
        for g, w in zip(gl, wl):
            on = np.abs(w) > 1e-3
            if on.any():
                assert np.abs(g[on] + lam * np.sign(w[on])).max() < 0.05 * lam
            if (~on).any():
                assert np.abs(g[~on]).max() < lam * 1.1


def test_pics_objective_matches_independent_ista():
    _, sens, mask, y = _problem()
    lam = 0.01
    x_fista = _solve(y, sens, mask, lam, iters=800)
    x = _eh(y, sens, mask)
    for _ in range(6000):
        z = x - _eh(_e(x, sens, mask) - y, sens, mask)
        ll, bands = _haar_fwd(np.stack([z.real, z.imag]))
        bands = [tuple(np.sign(b) * np.maximum(np.abs(b) - lam, 0.0) for b in lvl) for lvl in bands]
        rec = _haar_inv(ll, bands)
        x = rec[0] + 1j * rec[1]
    f_fista = _objective(x_fista, y, sens, mask, lam)
    f_ista = _objective(x, y, sens, mask, lam)
    assert f_fista <= f_ista * (1 + 1e-4), (f_fista, f_ista)
    assert f_fista < 0.9 * _objective(_eh(y, sens, mask), y, sens, mask, lam)


def test_pics_lam0_limit_matches_cg_least_squares():
    _, sens, mask, y = _problem()
    x_fista = _solve(y, sens, mask, 0.0, iters=1200)
    b = _eh(y, sens, mask)
    x = np.zeros_like(b)
    r = b.copy()
    p = r.copy()
    rs = (np.abs(r) ** 2).sum()
    for _ in range(400):
        ap = _eh(_e(p, sens, mask), sens, mask)
        alpha = rs / np.real(np.vdot(p, ap))
        x += alpha * p
        r -= alpha * ap
        rs_new = (np.abs(r) ** 2).sum()
        if rs_new < 1e-24:
            break
        p = r + (rs_new / rs) * p
        rs = rs_new
    f_fista = 0.5 * (np.abs(_e(x_fista, sens, mask) - y) ** 2).sum()
    f_cg = 0.5 * (np.abs(_e(x, sens, mask) - y) ** 2).sum()
    assert f_fista <= f_cg * 1.01 + 1e-12, (f_fista, f_cg)
