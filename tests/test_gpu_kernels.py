"""The compiled kernels against their XLA references, and the train
step's gradient against finite differences, on the card.

These need a GPU (marker ``gpu``; the ``gpu_device`` fixture skips them
elsewhere). Run them on the card with
``SRT_TEST_GPU=1 python -m pytest tests -m gpu``. They reuse
``chip_smoke.py``'s checks at a moderate size, with the card's tolerances.
"""
import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke as cs  # noqa: E402


@pytest.mark.gpu
def test_bounce_kernel_on_gpu(gpu_device):
    assert cs.check_bounce(cs.Log(gpu_device.device_kind), "gpu", side=64,
                           bounces=3) == []


@pytest.mark.gpu
def test_traversal_kernel_on_gpu(gpu_device):
    assert cs.check_traversal(cs.Log(gpu_device.device_kind), "gpu",
                              divs=20, side=64) == []


@pytest.mark.gpu
def test_train_gradient_on_gpu(gpu_device):
    assert cs.check_backward(cs.Log(gpu_device.device_kind), "gpu") == []
