"""Multi-host entry: the same pjit program over DCN-connected hosts.

SURVEY §2.3/§5: the reference has no cross-process story at all; srt's
is deliberately thin because XLA does the heavy lifting — the identical
``shard_map``/pjit render and train-step programs run unchanged on a
multi-host pod slice once ``jax.distributed.initialize`` has stitched the
processes together. The only DCN traffic is image-sized (tile assembly)
and gradient-sized (psum) reductions; scene broadcast happens once.

Typical launch (one process per host, e.g. under a pod scheduler)::

    python -m srt.dist.multihost --coordinator 10.0.0.1:9999 \
        --num-processes 4 --process-id $WORKER_ID --scene cornell --spp 256

Each process renders its pixel shard; process 0 assembles and writes the
image. On a single host this degenerates to ``render_sharded`` over the
local mesh (which is how CI exercises the code path — the virtual-device
strategy of tests/conftest.py).
"""
from __future__ import annotations

import argparse
import sys


def init_multihost(coordinator: str | None, num_processes: int,
                   process_id: int) -> None:
    """``jax.distributed.initialize`` wrapper; no-op for 1 process."""
    if num_processes <= 1:
        return
    import jax
    jax.distributed.initialize(coordinator_address=coordinator,
                               num_processes=num_processes,
                               process_id=process_id)


def global_mesh(axis: str = "rays"):
    """1-D mesh over every device of every participating process."""
    import jax
    import numpy as np
    from jax.sharding import Mesh
    return Mesh(np.array(jax.devices()), (axis,))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="srt.dist.multihost")
    ap.add_argument("--coordinator", default=None,
                    help="host:port of process 0")
    ap.add_argument("--num-processes", type=int, default=1)
    ap.add_argument("--process-id", type=int, default=0)
    ap.add_argument("--scene", default="cornell_boxes")
    ap.add_argument("--width", type=int, default=512)
    ap.add_argument("--spp", type=int, default=64)
    ap.add_argument("--max-depth", type=int, default=16)
    ap.add_argument("--out", default="out.png")
    args = ap.parse_args(argv)

    init_multihost(args.coordinator, args.num_processes, args.process_id)

    import jax
    import numpy as np

    from srt.dist.sharding import render_sharded
    from srt.io.image import write_png, write_ppm
    from srt.render import film
    from srt.render.api import RenderConfig
    from srt.scene.library import get_scene

    mesh = global_mesh()
    scene, camera, _ = get_scene(args.scene, aspect=1.0)  # height == width
    config = RenderConfig(width=args.width, height=args.width, spp=args.spp,
                          max_depth=args.max_depth)
    img = render_sharded(scene, camera, config, mesh)

    if jax.process_index() == 0:
        tm = np.asarray(film.tonemap(img))
        if args.out.lower().endswith(".ppm"):
            write_ppm(args.out, tm)
        else:
            write_png(args.out, tm)
        print(f"wrote {args.out} from {jax.process_count()} process(es), "
              f"{len(jax.devices())} device(s)", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
