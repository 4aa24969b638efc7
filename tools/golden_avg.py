"""Average parity render chunks and PSNR them against a fresh C++ golden.

BASELINE row 2 wants PSNR >= 40 dB at equal spp. The reference's
checked-in goldens are noise-bound (GOLDEN.md: their own MC noise caps
the comparison near 35 dB), so the 40 dB proof uses a *fresh* low-noise
golden rendered with the locally-built reference C++
(``tools/cpp_baseline.py``) at high spp. Our side accumulates as N
seed-chunks (``tools/golden.py --spp S --seed k``); this tool averages the
chunks in
LINEAR radiance (decoding the sqrt-gamma PPMs — averaging gamma values
would bias the mean) and reports PSNR vs the golden.

Usage:
    python tools/golden_avg.py --chunks 'goldens/ball_parity_256_s*.ppm' \
        --golden /tmp/refbuild/run/golden_ball_512_4096.ppm
"""
from __future__ import annotations

import argparse
import glob
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--chunks", required=True,
                    help="glob of tonemapped chunk PPMs")
    ap.add_argument("--golden", required=True)
    ap.add_argument("--out", default=None,
                    help="write the averaged tonemapped PPM here")
    ap.add_argument("--downsample", type=int, default=4)
    args = ap.parse_args()

    import numpy as np

    from srt.io.image import read_ppm, write_ppm
    from srt.utils.compare import golden_psnr

    paths = sorted(glob.glob(args.chunks))
    if not paths:
        raise SystemExit(f"no chunks match {args.chunks}")
    acc = None
    for p in paths:
        u8 = read_ppm(p).astype(np.float64) / 255.0
        lin = u8 * u8            # invert the sqrt gamma -> linear radiance
        acc = lin if acc is None else acc + lin
    mean_lin = acc / len(paths)
    tm = np.sqrt(np.clip(mean_lin, 0.0, 1.0))   # back to the golden's space

    if args.out:
        write_ppm(args.out, tm.astype(np.float32))

    gold = read_ppm(args.golden)
    result = {"n_chunks": len(paths), "golden": args.golden,
              "chunks": args.chunks}
    result.update(golden_psnr(tm, gold, downsample=args.downsample))
    print(json.dumps(result))


if __name__ == "__main__":
    main()
