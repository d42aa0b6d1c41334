"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU and nvcc and skips without them. This
file imports neither JAX nor the JAX package, so it also runs where JAX is
not installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from sipmask_tpu_torch.ops import deform_sample, gn_relu

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (torch.cuda.is_available() is False)")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _offsets(rng, b, n_off, ho, wo, far):
    off = rng.randn(b, n_off, ho, wo).astype(np.float32) * 2.0
    if far:   # a third of the pixels +-300 px out, where an unchecked
        # gather would read outside the feature map
        third = (ho * wo) // 3
        flat = off.reshape(b, n_off, ho * wo)
        flat[:, :, :third] *= 150.0
    return off


@pytest.mark.parametrize("b,c,g,h,w,stride,dil,far", [
    (2, 256, 4, 100, 168, 1, 1, True),    # FeatureAlign at P3, 800x1344
    (2, 256, 4, 7, 11, 1, 1, False),      # P7
    (1, 20, 4, 13, 9, 2, 1, True),        # Cg = 5: a ragged channel chunk
    (2, 32, 1, 17, 15, 1, 2, True),
])
def test_deform_im2col_kernel_matches_plain(dev, b, c, g, h, w, stride, dil,
                                            far):
    rng = np.random.RandomState(0)
    pad = dil
    ho, wo = deform_sample.out_size(h, w, 3, 3, stride, pad, dil)
    x = torch.from_numpy(rng.randn(b, c, h, w).astype(np.float32)).to(dev)
    off = torch.from_numpy(_offsets(rng, b, g * 18, ho, wo, far)).to(dev)
    before = deform_sample.deform_im2col.launches
    got = deform_sample.deform_im2col(x, off, (3, 3), stride, pad, dil, g)
    torch.cuda.synchronize()
    assert deform_sample.deform_im2col.launches == before + 1
    want = deform_sample.deform_im2col_plain(x, off, (3, 3), stride, pad, dil,
                                             g)
    # the same four f32 products; the kernel may fuse them into FMAs
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("act", [True, False])
@pytest.mark.parametrize("shape", [(2, 256, 100, 168), (2, 256, 25, 42),
                                   (1, 64, 7, 11)])
def test_gn_relu_kernel_matches_plain(dev, shape, act):
    rng = np.random.RandomState(1)
    c = shape[1]
    x = torch.from_numpy((rng.randn(*shape) * 3 + 1).astype(np.float32)
                         ).to(dev)
    wt = torch.from_numpy((rng.rand(c) + 0.5).astype(np.float32)).to(dev)
    bs = torch.from_numpy((rng.randn(c) * 0.2).astype(np.float32)).to(dev)
    before = gn_relu.gn_relu.launches
    got = gn_relu.gn_relu(x, wt, bs, 32, 1e-5, act)
    again = gn_relu.gn_relu(x, wt, bs, 32, 1e-5, act)
    torch.cuda.synchronize()
    assert gn_relu.gn_relu.launches == before + 2
    assert torch.equal(got, again)       # fixed reduction order, no atomics
    want = gn_relu.gn_relu_plain(x, wt, bs, 32, 1e-5, act)
    # f32 sums over up to 134400 elements per group, in another order
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


def test_kernel_wrappers_refuse_what_the_kernels_do_not_take(dev):
    x = torch.zeros((1, 8, 6, 6), device=dev)
    off = torch.zeros((1, 36, 6, 6), device=dev)
    with pytest.raises(TypeError):
        deform_sample.deform_im2col(x.double(), off.double(), (3, 3), 1, 1, 1,
                                    2)
    with pytest.raises(ValueError, match="contiguous"):
        deform_sample.deform_im2col(x.transpose(2, 3), off, (3, 3), 1, 1, 1,
                                    2)
    w, b = torch.ones(8, device=dev), torch.zeros(8, device=dev)
    with pytest.raises(TypeError):
        gn_relu.gn_relu(x.half(), w, b, 4)
    with pytest.raises(ValueError, match="contiguous"):
        gn_relu.gn_relu(x.transpose(2, 3), w, b, 4)
