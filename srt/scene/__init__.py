from srt.scene.ir import Scene, MaterialType, TextureType  # noqa: F401
from srt.scene.build import SceneBuilder  # noqa: F401
