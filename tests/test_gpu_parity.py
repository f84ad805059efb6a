"""Card-only checks: the device search programs on the GPU against the CPU
device (svt_av1_psy_tpu/utils/parity.py) — the integer programs bit for
bit, the temporal filter and the Wiener LR search within their stated
tolerances. chip_smoke.py runs the same checks at 1080p.

Run on the card with `JAX_PLATFORMS=cuda,cpu python -m pytest -m gpu
tests/`; elsewhere the `gpu_device` fixture skips them.
"""

import jax
import pytest

from svt_av1_psy_tpu.utils import parity

pytestmark = pytest.mark.gpu

H, W = 256, 384


@pytest.fixture
def cpu_device():
    return jax.devices("cpu")[0]


@pytest.mark.parametrize("bd", [8, 10])
def test_intra_decide_bit_exact(gpu_device, cpu_device, bd):
    parity.check_intra_decide(gpu_device, cpu_device, H, W, bd)


def test_hme_bit_exact(gpu_device, cpu_device):
    parity.check_hme(gpu_device, cpu_device, H, W)


def test_gop_search_bit_exact(gpu_device, cpu_device):
    parity.check_gop_search(gpu_device, cpu_device, H, W)


def test_gop_search_tf(gpu_device, cpu_device):
    parity.check_gop_search_tf(gpu_device, cpu_device, H, W)


def test_tf_filter_within_tolerance(gpu_device, cpu_device):
    parity.check_tf_filter(gpu_device, cpu_device, H, W)


def test_block_mode_costs_bit_exact(gpu_device, cpu_device):
    parity.check_block_mode_costs(gpu_device, cpu_device, H, W)


def test_lr_search_within_tolerance(gpu_device):
    parity.check_lr(gpu_device, H, W)
