"""chip_smoke.py's phases at a tiny size on the CPU, kernels interpreted.

The script itself refuses to run without a GPU; its phase functions take
their sizes and the kernel mode as arguments, so the same code paths and
checks run here at toy widths (the tolerances are the card's; at these
sizes every check must still pass).
"""
import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke as cs  # noqa: E402


@pytest.fixture
def log(capsys):
    return cs.Log("cpu-test")


def test_phase_kernels_tiny(log):
    # On the CPU the interpreted kernel and the XLA bounce are two jitted
    # graphs whose fma contraction differs; grazing-angle VNDF lanes keep
    # ~1e-3 of beta jitter on a few % of lanes (the bound of
    # tests/test_fused_bounce.py), so the close fraction is the CPU's.
    assert cs.phase_kernels(log, "interpret", side=16, bounces=2, divs=4,
                            bwd_side=4, close_frac=0.95) == []
    rec = log.records["kernels"]
    assert rec["bounce0_alive_depth_agree"] >= cs.BOUNCE_ALIVE_AGREE
    assert rec["tri_primary_id_agree"] >= cs.TRI_ID_AGREE
    assert "bounce_kernel_memory" in rec


def test_phase_forward_tiny(log):
    assert cs.phase_forward(log, "interpret", width=8, spp=2, depth=3,
                            ref_spp=2) == []
    assert log.records["forward"]["kernel_nan"] == 0


def test_phase_mesh_tiny(log):
    assert cs.phase_mesh(log, "interpret", divs=4, width=8, spp=1,
                         depth=3) == []


def test_phase_train_tiny(log):
    assert cs.phase_train(log, "interpret", width=4, spp=1, depth=3,
                          steps=2, fog_width=4,
                          train_kw=dict(wavefront=32, depth_budget=3.0,
                                        drain=2, unroll=1)) == []
    assert len(log.records["train"]["fog_mat_params_losses"]) == 2


def test_phase_cli_tiny(log, tmp_path):
    assert cs.phase_cli(log, width=8, spp=2, out_dir=str(tmp_path)) == []
    assert (tmp_path / "chip_smoke_cornell_boxes.png").stat().st_size > 0


def test_phase_four_tiny(log, eight_devices):
    # four of the eight virtual CPU devices stand in for the four cards
    assert cs.phase_four(log, "interpret", n_dev=4, width=16, spp=2,
                         depth=3, train_width=8, train_spp=1,
                         train_depth=3) == []
    rec = log.records["four"]
    assert rec["bit_identical"] and rec["shard_devices"] == 4
    assert rec["one_queue_mean_rel_diff"] <= cs.SHARD_MEAN_RTOL


def test_z_test_edges():
    import numpy as np
    img = np.ones((4, 4, 3), np.float32)
    assert cs._z_test(img, img) == (0.0, 0.0, 0.0)
    assert cs._z_test(img + 1.0, img)[2] == float("inf")


def test_script_refuses_cpu(monkeypatch, capsys):
    """With a card line but a CPU backend the script exits non-zero and
    prints no result line."""
    import srt.utils.device as device
    monkeypatch.setattr(device, "card_line", lambda: "test card, 700 W")
    assert cs.main([]) == 2
    out = capsys.readouterr().out
    assert '"ok"' not in out


def test_script_refuses_without_card(monkeypatch, capsys):
    import srt.utils.device as device
    monkeypatch.setattr(device, "card_line", lambda: None)
    assert cs.main([]) == 2
    assert '"ok"' not in capsys.readouterr().out
