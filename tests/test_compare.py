"""PSNR / golden-comparison utilities."""
import numpy as np

from srt.utils.compare import box_downsample, golden_psnr, psnr


def test_psnr_basics():
    a = np.full((8, 8, 3), 100.0)
    assert psnr(a, a) == float("inf")
    b = a + 1.0  # MSE 1 -> 10*log10(255^2) = 48.13 dB
    assert abs(psnr(a, b) - 48.13) < 0.01
    # Known MSE: half the pixels off by 2 -> MSE 2 -> -3dB vs MSE 1.
    c = a.copy()
    c[::2] += 2.0
    assert abs(psnr(a, c) - (48.13 - 3.01)) < 0.02


def test_box_downsample_averages():
    img = np.zeros((4, 4, 1))
    img[0, 0] = 4.0
    ds = box_downsample(img, 2)
    assert ds.shape == (2, 2, 1)
    assert ds[0, 0, 0] == 1.0  # 4 / (2*2)


def test_golden_psnr_downsampling_suppresses_noise():
    """Independent zero-mean noise on both sides: 4x box filtering must
    raise PSNR by ~10*log10(16) ~= 12 dB."""
    rng = np.random.default_rng(0)
    base = rng.uniform(0.2, 0.8, (64, 64, 3))
    ours01 = np.clip(base + rng.normal(0, 0.05, base.shape), 0, 1)
    gold = np.clip(base * 255.99, 0, 255).astype(np.uint8)
    r = golden_psnr(ours01, gold, downsample=4)
    assert r["psnr_ds_db"] > r["psnr_db"] + 8.0


def test_bench_smoke():
    """bench.py end-to-end on CPU at a tiny config: must print exactly one
    valid JSON line with the headline fields (the driver's BENCH artifact
    depends on this surface)."""
    import json
    import os
    import subprocess
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {**os.environ, "JAX_PLATFORMS": "cpu",
           "SRT_NO_COMPILE_CACHE": "1"}
    out = subprocess.run(
        [sys.executable, "bench.py", "--scene", "cornell_boxes",
         "--width", "16", "--spp", "2", "--max-depth", "3",
         "--min-seconds", "0.1", "--sample-chunk", "2"],
        capture_output=True, text=True, timeout=900, env=env, cwd=root)
    assert out.returncode == 0, out.stderr[-2000:]
    lines = [l for l in out.stdout.strip().splitlines() if l.strip()]
    assert len(lines) == 1, lines
    d = json.loads(lines[0])
    for key in ("metric", "value", "unit", "vs_baseline", "engine",
                "warmup_s", "nan_pixels"):
        assert key in d, key
    assert d["value"] > 0 and d["nan_pixels"] == 0
