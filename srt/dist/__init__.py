from srt.dist.sharding import (  # noqa: F401
    make_mesh, render_sharded, replicate_scene)
