"""K3 (the IndRNN cell) on the CPU: the port's cell against flax at the widths
``projects/`` uses, and the accuracy argument of the float32 kernel's 3xTF32
product, emulated in torch.

The kernel itself runs only on the card (``chip_smoke.py`` holds it against its
plain version there). What can be checked here is that its arithmetic keeps
float32 accuracy: each operand split into a TF32 hi part (float32 rounded to
10 mantissa bits, to nearest with ties away from zero, as ``cvt.rna.tf32.f32``
does) and a TF32 lo part (the remainder, rounded the same way), and each
product taken as hi*hi + hi*lo + lo*hi.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mridc_tpu_torch.nn import rnn_cells as tcells
from mridc_tpu_torch.utils.params import hwio_to_oihw

jcells = importlib.import_module("mridc_tpu.nn.rnn_cells")

# the kernel's limit against its plain version (chip_smoke.py)
KERNEL_RTOL, KERNEL_ATOL = 1e-4, 1e-4


def _nhwc(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("cin,f", [(64, 64), (64, 128), (128, 128)])
def test_indrnn_cell_matches_flax_at_project_widths(cin, f):
    """The IndRNN cell at the recurrent widths of projects/ (64 and 128
    filters), over 2 x 7 x 9 pixels, a count that no kernel tile divides.
    Tolerance as in test_torch_port_cells.py: rtol 1e-5 / atol 1e-6 of the
    output's largest magnitude (float32 sums in different orders)."""
    b, h, w = 2, 7, 9
    x, hid = _nhwc((b, h, w, cin), 2), np.abs(_nhwc((b, h, w, f), 3))
    jmod = jcells.make_cell("IndRNN", f, 1, 1, True)
    params = jmod.init(jax.random.PRNGKey(1), jnp.asarray(x), jnp.asarray(hid))["params"]
    params = jax.tree_util.tree_map(lambda a: np.asarray(a) * 10.0, params)  # well away from relu's kink
    want = np.asarray(jmod.apply({"params": params}, jnp.asarray(x), jnp.asarray(hid)))

    tmod = tcells.make_cell("IndRNN", cin, f, 1, 1, True)
    with torch.no_grad():
        tmod.ih.weight.copy_(torch.from_numpy(hwio_to_oihw(np.array(params["Conv_0"]["kernel"]))))
        tmod.ih.bias.copy_(torch.from_numpy(np.array(params["Conv_0"]["bias"])))
        tmod.hh.copy_(torch.from_numpy(np.transpose(np.array(params["hh"]), (0, 3, 1, 2))))
    to_port = lambda a: torch.from_numpy(a).permute(0, 3, 1, 2)  # noqa: E731  (channels_last NCHW view)
    got = tmod(to_port(x), to_port(hid)).detach().permute(0, 2, 3, 1).numpy()
    assert got.shape == want.shape == (b, h, w, f)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6 * max(1.0, float(np.abs(want).max())))


def to_tf32(a: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32's 10 mantissa bits, to nearest with ties away
    from zero (``cvt.rna.tf32.f32``): add half of the 13 dropped bits' range to
    the magnitude and drop them."""
    bits = a.contiguous().view(torch.int32)
    sign = bits & -(2**31)
    mag = ((bits & 0x7FFFFFFF) + 0x1000) & ~0x1FFF
    return (sign | mag).view(torch.float32)


def split(a: torch.Tensor):
    hi = to_tf32(a)
    return hi, to_tf32(a - hi)


def test_tf32_rounding_is_rna():
    x = torch.randn(4096, generator=torch.Generator().manual_seed(0))
    hi = to_tf32(x)
    assert not bool((hi.view(torch.int32) & 0x1FFF).any())  # 13 low mantissa bits dropped
    assert bool(((x - hi).abs() <= x.abs() * 2.0**-11).all())  # within half a TF32 ulp
    tie = torch.tensor([1 + 2.0**-11, -(1 + 2.0**-11), 1 + 3 * 2.0**-11, 1 + 2.0**-12])
    want = torch.tensor([1 + 2.0**-10, -(1 + 2.0**-10), 1 + 2 * 2.0**-10, 1.0])
    assert torch.equal(to_tf32(tie), want)  # halfway cases go away from zero
    hi, lo = split(x)
    assert bool(((x - hi - lo).abs() <= x.abs() * 2.0**-21).all())  # hi + lo keeps ~21 bits


@pytest.mark.parametrize("ci", [64, 128])
def test_3xtf32_product_keeps_float32_accuracy(ci):
    """hi*hi + hi*lo + lo*hi, each product of TF32 operands summed in float32,
    matches the float64 product within the kernel's tolerance; one TF32 product
    (hi*hi alone) does not, so the test can tell the two apart."""
    gen = torch.Generator().manual_seed(ci)
    x = torch.randn(4096, ci, generator=gen)
    w = torch.randn(64, ci, generator=gen) / ci**0.5
    want = x.double() @ w.double().T
    (xh, xl), (wh, wl) = split(x), split(w)
    got = xh @ wl.T + xl @ wh.T + xh @ wh.T
    atol = KERNEL_ATOL * float(want.abs().max())
    assert torch.allclose(got.double(), want, rtol=KERNEL_RTOL, atol=atol)
    assert not torch.allclose((xh @ wh.T).double(), want, rtol=KERNEL_RTOL, atol=atol)
