"""Tests that need the card: the CUDA kernel against its plain version, and
the port's extractor on the card against the same extractor on the CPU
(whose plain path the other tests hold against the JAX package).

They import no JAX, so they run where JAX is not installed; there the JAX
conftest is skipped: ``python -m pytest --noconftest tests/test_torch_cuda.py``.
Without a card they skip.
"""
import numpy as np
import pytest
import torch

from se2lam_tpu_torch.entry import default_cfg
from se2lam_tpu_torch.frontend import fast_nms as K1
from se2lam_tpu_torch.frontend.orb import OrbExtractor
from se2lam_tpu_torch.io.synthetic import SyntheticWorld

BENCH_LEVELS = [(480, 640), (400, 533), (333, 444), (278, 370), (231, 309)]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


def sprinkled_image(rng, H, W):
    img = rng.uniform(0, 255, (H, W)).astype(np.float32)
    for _ in range(30):
        y, x = rng.integers(20, H - 20), rng.integers(20, W - 20)
        img[y - 1: y + 2, x - 1: x + 2] = 250.0
    return img


@pytest.mark.cuda
@pytest.mark.parametrize("shape", BENCH_LEVELS + [(17, 33), (8, 8)])
def test_kernel_matches_plain_on_card(card, shape):
    """Bitwise over the whole map, the image border and ragged tiles too."""
    img = torch.from_numpy(sprinkled_image(np.random.default_rng(2), *shape)
                           if min(shape) > 40 else
                           np.random.default_rng(2).uniform(0, 255, shape).astype(np.float32))
    img = img.to(card)
    before = K1.fast_nms.launches
    got = K1.fast_nms(img, 20.0, 7.0)
    torch.cuda.synchronize()
    assert K1.fast_nms.launches == before + 1
    for g, w in zip(got, K1.fast_nms_plain(img, 20.0, 7.0)):
        assert torch.equal(g, w)


@pytest.mark.cuda
def test_kernel_rejects_what_it_does_not_take(card):
    with pytest.raises(ValueError):
        K1.fast_nms(torch.zeros((64, 64), dtype=torch.float64, device=card), 20.0, 7.0)
    with pytest.raises(ValueError):
        K1.fast_nms(torch.zeros((64, 128), device=card)[:, ::2], 20.0, 7.0)


@pytest.mark.cuda
def test_extractor_on_card_matches_cpu(card):
    cfg, oc = default_cfg()
    world = SyntheticWorld(cfg, n_landmarks=500, seed=0)
    img = torch.from_numpy(world.render(world.circle_trajectory(352, radius=2.5)[5]))
    fc = OrbExtractor(oc, device="cpu")(img)
    fg = OrbExtractor(oc, device=card)(img.to(card))
    v = fc.valid
    assert torch.equal(fg.valid.cpu(), v) and torch.equal(fg.octave.cpu(), fc.octave)
    torch.testing.assert_close(fg.xy.cpu()[v], fc.xy[v], rtol=0, atol=1e-3)
    same = (fg.desc_bits.cpu().view(torch.int32) == fc.desc_bits.view(torch.int32)).all(1)
    assert same[v].float().mean() > 0.99
