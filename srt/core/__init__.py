from srt.core.vecmath import (  # noqa: F401
    dot, cross, normalize, length, length_sq, vec3, reflect, refract_dir,
)
from srt.core.onb import OrthonormalBasis  # noqa: F401
from srt.core.ray import Ray  # noqa: F401
from srt.core.rng import RaySampler  # noqa: F401
