from srt.accel.bvh import build_bvh, FlatBVH  # noqa: F401
