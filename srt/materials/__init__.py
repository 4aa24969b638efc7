from srt.materials.textures import texture_value  # noqa: F401
